"""K4, the twisted-Edwards grouped MSM kernel: what one call on ``batch``
rows of ``groups`` groups of 2^w table points needs.

Each row and group is one mixed addition (add-2008-hwcd, a = -1, the table's
third coordinate d x y): 8 Montgomery products of W-word elements, each
2 W^2 word multiply-adds for the product and 2 W^2 + W for its reduction, two
operations a multiply-add, so 2 (4 W^2 + W) operations a product (528 at
W = 8); the additions and subtractions are not counted, as in
``k1_poseidon``.  Bytes: the indices, the table and the extended output,
once each.  At 2^16 rows x 342 groups, W = 8 that is 9.47e10 operations, a
least time of 1.413 ms, operations-bound.
"""

from portbench.roofline.peaks import least_seconds

KERNEL_NAMES = ("msm_te_kernel",)

PRODUCTS_PER_ADD = 8


def ops_per_row_group(num_words: int) -> int:
    W = num_words
    return PRODUCTS_PER_ADD * 2 * (4 * W * W + W)


def work(batch: int, groups: int, w: int, num_words: int) -> tuple:
    """(bytes, operations) of one call."""
    nbytes = 4 * (batch * groups + groups * (1 << w) * 3 * num_words + batch * 4 * num_words)
    return nbytes, batch * groups * ops_per_row_group(num_words)


def least(**call) -> float:
    return least_seconds(*work(**call))
