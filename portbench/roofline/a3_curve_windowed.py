"""A3, the twisted-Edwards windowed variable-base product: the least work of
one call on ``rows`` points times scalars of ``scalar_bits`` bits in windows
of ``w`` bits, whatever implements it.

The schedule is the 2^w - 2 additions that build each point's multiples,
then G - 1 windows below the top one (G = ceil(scalar_bits / w)), each w
doublings and one addition.  An addition is counted as ``k4_msm_te`` counts
one, 8 Montgomery products; a doubling as dbl-2008-hwcd, 3 products and 4
squarings, fewer than the complete addition that the port doubles with (11
products), so the count is a lower bound for any design.  A product is
2 (4 W^2 + W) operations (``k4_msm_te``), a squaring 2 (3 W^2 + 2 W): its
W (W + 1) / 2 word products, doubled as multiply-adds of both halves, and
the reduction's 2 W^2 + W, rounded up.  The additions and subtractions are
not counted.  Bytes: each point, its scalar's bits packed and its result,
once each.  At 2^16 rows of 251 bits, w = 4, W = 8 (the configuration
``schnorr_ed377_blake2s``): 76 additions and 248 doublings, 1,126,528
operations a row, 7.38e10 in all, a least time of 1.102 ms, operations-bound
(the 18.9 MB take 5.6 us).
"""

from portbench.harness import loader
from portbench.roofline.k4_msm_te import PRODUCTS_PER_ADD
from portbench.roofline.peaks import least_seconds

KERNEL_NAMES = ("curve_windowed_kernel",)
CONFIG = "schnorr_ed377_blake2s"
PRODUCTS_PER_DOUBLING = 3
SQUARES_PER_DOUBLING = 4


def product_ops(num_words: int) -> int:
    W = num_words
    return 2 * (4 * W * W + W)


def square_ops(num_words: int) -> int:
    W = num_words
    return 2 * (3 * W * W + 2 * W)


def ops_per_row(scalar_bits: int, w: int, num_words: int) -> int:
    G = -(-scalar_bits // w)
    additions = (1 << w) - 2 + G - 1
    doublings = w * (G - 1)
    product, square = product_ops(num_words), square_ops(num_words)
    return additions * PRODUCTS_PER_ADD * product + doublings * (PRODUCTS_PER_DOUBLING * product
                                                                 + SQUARES_PER_DOUBLING * square)


def work(rows: int, scalar_bits: int, w: int, num_words: int) -> tuple:
    """(bytes, operations) of one call."""
    nbytes = rows * (2 * 4 * 4 * num_words + -(-scalar_bits // 8))
    return nbytes, rows * ops_per_row(scalar_bits, w, num_words)


def least(**call) -> float:
    return least_seconds(*work(**call))


def call(rows: int) -> dict:
    """The shape of a call on ``rows`` points at the configuration's scalar
    bits, window and word count."""
    cfg = loader.data("configs", CONFIG)
    return {"rows": rows, "scalar_bits": cfg["scalar_bits"], "w": cfg["window_w"], "num_words": cfg["num_words"]}
