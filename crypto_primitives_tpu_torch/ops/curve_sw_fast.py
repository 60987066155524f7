"""The fast curve tier on a short-Weierstrass curve: the SW twin of
``curve_fast.py``.

Twin of ``crypto_primitives_tpu/ops/curve_sw_rns.py``, on Montgomery words
instead of RNS residues.  Table entries stay projective (X : Y : Z): the SW
identity (0 : 1 : 0), which pads the last group and is every group's entry
0, has no affine form.  ``subset_groups`` is shared with the TE tier, so the
port's table and the JAX package's agree entry for entry, and so are
``conditional_sum_grouped_auto`` and ``msm_many``, which pick the kernel from
the curve model.  The fixed-base product runs through kernel ``msm_sw`` at
its build's row split; the windowed variable-base product is plain PyTorch.
Host points are affine tuples, with ``None`` for the identity, which
``pack_points`` and ``pack_points_device`` take and ``unpack_affine``
returns; ``pack_points_device`` is the host pack and its upload (the TE
tier's device pack builds the extended form, which this tier does not use).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops import msm_sw_kernel
from crypto_primitives_tpu_torch.ops.curve_fast import (
    affine_host,
    combo_width,
    conditional_sum_grouped_auto,
    device_table,
    fixed_base_powers,
    fixed_base_sum,
    grouped_sum,
    msm_many,
    pack_points,
    scalars_to_bits,
    subset_groups,
    window_indices,
    windowed_digits,
)
from crypto_primitives_tpu_torch.ops.curve_sw import sw_add, sw_add_digits, sw_neg, sw_sum, sw_to_affine

__all__ = [
    "add", "conditional_sum_grouped_auto", "device_table", "fixed_base_grouped_table", "fixed_base_mul",
    "msm_many", "neg", "pack_combos", "pack_points", "pack_points_device", "pack_table_grouped",
    "scalar_mul_bits_windowed", "scalars_to_bits", "subset_groups", "sum", "sw_conditional_sum_grouped",
    "sw_fixed_base_mul", "sw_scalar_mul_bits_windowed", "to_affine", "unpack_affine", "window_indices",
]


def pack_combos(curve, groups) -> np.ndarray:
    """Per-group host point lists (``None`` for the identity) -> the
    (G, E, 3, W) int32 word table of projective entries (Z = 1, or the
    identity (0 : 1 : 0)): groups[g][e] is the point that window value e
    selects in group g, E the same power of two for every group."""
    E = combo_width(groups)
    words = curve.pack_points([pt for grp in groups for pt in grp])
    return words.reshape(-1, E, 3, words.shape[-1])


def pack_table_grouped(curve, pts, w: int = 3) -> np.ndarray:
    """Host points -> the (G, 2^w, 3, W) :func:`pack_combos` table of their
    subset sums."""
    return pack_combos(curve, subset_groups(curve, pts, w))


def sw_conditional_sum_grouped(curve, table: torch.Tensor, bits: torch.Tensor, w: int = 3) -> torch.Tensor:
    """The plain grouped sum: bits (..., N) -> projective (..., 3, W)."""
    return grouped_sum(msm_sw_kernel.grouped_msm_plain, curve, table, bits, w)


@functools.lru_cache(maxsize=64)
def fixed_base_grouped_table(curve, pt: tuple, nbits: int, w: int = 3) -> np.ndarray:
    """The grouped table of pt's doubling powers (``curve_fast``'s twin)."""
    return pack_table_grouped(curve, list(fixed_base_powers(curve, pt, nbits)), w)


def sw_fixed_base_mul(curve, pt, bits: torch.Tensor, w: int = 3) -> torch.Tensor:
    """pt (a host affine tuple) times scalars given as bits (..., nbits),
    least significant first -> projective (..., 3, W): kernel ``msm_sw`` (at
    the build's row split, ``msm_sw_kernel.SPLIT``) for CUDA bits, its plain
    version for CPU bits."""
    return fixed_base_sum(msm_sw_kernel.grouped_msm, fixed_base_grouped_table, curve, pt, bits, w)


def sw_scalar_mul_bits_windowed(curve, base: torch.Tensor, bits: torch.Tensor, w: int = 4) -> torch.Tensor:
    """base (..., 3, W) projective points times scalars given as bits
    (..., nbits), least significant first (``curve_fast.windowed_digits``,
    plain PyTorch on any device)."""
    ident = curve._consts(base.device)["identity"]
    return ff.from_digits(windowed_digits(lambda a, b: sw_add_digits(curve, a, b), ident,
                                          ff.to_digits(base), bits, w))


def pack_points_device(curve, pts, device) -> torch.Tensor:
    """Host affine point(s), ``None`` for the identity -> their projective
    words (:func:`pack_points`) on ``device``."""
    return torch.from_numpy(pack_points(curve, pts)).to(device)


def unpack_affine(curve, pts: torch.Tensor):
    """Projective points (..., 3, W) -> host affine (x, y) int tuples, made
    affine on the device; the identity, which the Fermat inversion maps to
    (0, 0), comes back as ``None``.  That reading needs b != 0, so that (0, 0)
    is on no curve it serves."""
    if curve.b == 0:
        raise ValueError(f"{curve.name}: reading (0, 0) as the identity needs b != 0")
    return affine_host(curve, sw_to_affine(curve, pts))


# Curve-model-agnostic names, shared with ``curve_fast``
add = sw_add
neg = sw_neg
sum = sw_sum
to_affine = sw_to_affine
fixed_base_mul = sw_fixed_base_mul
scalar_mul_bits_windowed = sw_scalar_mul_bits_windowed
