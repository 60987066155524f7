"""K3, the SHA-256 kernel: what one call on ``batch`` messages of
``msg_bytes`` bytes needs.

A 64-byte block is 2,232 operations: 48 schedule words at 13, 64 rounds at
25 (a rotation is one funnel shift), 8 final additions.  The padding block
that ends a message of a multiple of 64 bytes is the same for every message
of that length, so its schedule is a constant and each round adds one
precomputed K[r] + W[r]: 64 rounds at 24 and the 8 additions, 1,544.
Bytes: each message read once, each 32-byte digest written once.
"""

from portbench.roofline.peaks import least_seconds

KERNEL_NAMES = ("digest_kernel", "compress_kernel")

OPS_PER_BLOCK = 48 * 13 + 64 * 25 + 8
OPS_PADDING_BLOCK = 64 * 24 + 8


def ops_per_message(msg_bytes: int) -> int:
    if msg_bytes % 64 == 0:
        return msg_bytes // 64 * OPS_PER_BLOCK + OPS_PADDING_BLOCK
    return (msg_bytes + 9 + 63) // 64 * OPS_PER_BLOCK


def work(batch: int, msg_bytes: int) -> tuple:
    return batch * (msg_bytes + 32), batch * ops_per_message(msg_bytes)


def least(**call) -> float:
    return least_seconds(*work(**call))
