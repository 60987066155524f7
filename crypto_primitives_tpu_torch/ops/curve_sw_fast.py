"""Grouped subset-sum MSMs on a short-Weierstrass curve: the SW twin of
``curve_fast.py``.

Twin of the grouped part of ``crypto_primitives_tpu/ops/curve_sw_rns.py``, on
Montgomery words instead of RNS residues.  Table entries stay projective
(X : Y : Z): the SW identity (0 : 1 : 0), which pads the last group and is
every group's entry 0, has no affine form.  ``subset_groups`` is shared with
the TE tier, so the port's table and the JAX package's agree entry for entry,
and so is ``conditional_sum_grouped_auto``, which picks the kernel from the
curve model.
"""

from __future__ import annotations

import numpy as np
import torch

from crypto_primitives_tpu_torch.ops import msm_sw_kernel
from crypto_primitives_tpu_torch.ops.curve_fast import (
    conditional_sum_grouped_auto,
    device_table,
    grouped_sum,
    subset_groups,
    window_indices,
)
from crypto_primitives_tpu_torch.ops.curve_sw import sw_add as add
from crypto_primitives_tpu_torch.ops.curve_sw import sw_to_affine as to_affine

__all__ = [
    "add", "conditional_sum_grouped_auto", "device_table", "pack_table_grouped",
    "subset_groups", "sw_conditional_sum_grouped", "to_affine", "window_indices",
]


def pack_table_grouped(curve, pts, w: int = 3) -> np.ndarray:
    """Host points -> the (G, 2^w, 3, W) int32 word table of projective
    subset sums (Z = 1, or the identity (0 : 1 : 0))."""
    flat = [pt for grp in subset_groups(curve, pts, w) for pt in grp]
    words = curve.pack_points(flat)
    return words.reshape(-1, 1 << w, 3, words.shape[-1])


def sw_conditional_sum_grouped(curve, table: torch.Tensor, bits: torch.Tensor, w: int = 3) -> torch.Tensor:
    """The plain grouped sum: bits (..., N) -> projective (..., 3, W)."""
    return grouped_sum(msm_sw_kernel.grouped_msm_plain, curve, table, bits, w)
