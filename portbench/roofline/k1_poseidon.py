"""K1, the Poseidon permutation kernel: what one call needs.

Operations are 32-bit integer operations, two to a multiply-add, on W-word
elements: a product of two elements is 2 W^2 word multiply-adds (low and
high halves), a square W (W + 1), a Montgomery reduction 2 W^2 + W.  Every
S-box product takes one reduction.  A linear layer takes one product per
matrix entry it applies and one reduction per output: t^2 and t in a dense
round, 2 t - 1 and t in a sparse one.  The schedule is the least the
permutation needs: the full rounds and the first partial round dense, every
later partial round sparse (the Poseidon paper, ePrint 2019/458, appendix
B).  At t = 3, W = 8, alpha = 17, 8 + 31 rounds that is 211,520 operations.
Bytes: each state read and written once, the round constants and the MDS
matrix read once a call.
"""

from portbench.roofline.peaks import least_seconds

# substrings of the kernel's name in the profiler's trace
KERNEL_NAMES = ("permute_kernel",)


def ops_per_permutation(t: int, num_words: int, alpha: int, full_rounds: int, partial_rounds: int) -> int:
    W = num_words
    n_sparse = max(partial_rounds - 1, 0)
    dense = full_rounds + partial_rounds - n_sparse
    sboxes = full_rounds * t + partial_rounds
    squares = sboxes * (alpha.bit_length() - 1)
    sbox_mults = sboxes * (bin(alpha).count("1") - 1)
    mults = sbox_mults + dense * t * t + n_sparse * (2 * t - 1)
    reductions = squares + sbox_mults + (dense + n_sparse) * t
    return 2 * (squares * W * (W + 1) + mults * 2 * W * W + reductions * (2 * W * W + W))


def work(batch: int, t: int, num_words: int, alpha: int, full_rounds: int, partial_rounds: int) -> tuple:
    """(bytes, operations) of one call on ``batch`` states."""
    rounds = full_rounds + partial_rounds
    nbytes = 2 * batch * t * num_words * 4 + (rounds * t + t * t) * num_words * 4
    return nbytes, batch * ops_per_permutation(t, num_words, alpha, full_rounds, partial_rounds)


def least(**call) -> float:
    return least_seconds(*work(**call))
