"""Grouped subset-sum MSMs on a twisted-Edwards curve: tables, the plain
grouped sum, the kernel dispatch and the device table cache.

Twin of the grouped part of ``crypto_primitives_tpu/ops/curve_rns.py``.  The
JAX package runs this tier on RNS residues because the TPU has no wide
integer multiply; the port has no RNS tier and runs it on the Montgomery
words of ``ops/field.py``, hence the name.

A grouped table turns w conditional additions into one 2^w-way select: the
fixed points are cut into groups of w (the last padded with the identity),
and group g holds all 2^w subset sums, table[g][e] = sum over i with bit i of
e set of pts[g*w + i].  :func:`subset_groups` selects the same points as the
JAX package's, so the two tables agree entry for entry.  A TE table entry is
affine (x, y, d*x*y), the way the TPU kernel's table folds d into T
(``msm_rns_pallas.pack_combos_from_subsets``); the identity (0, 1) is affine
on a TE curve.  Fixed-base and windowed variable-base scalar
multiplications and ``msm_many`` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from crypto_primitives_tpu_torch.ops import msm_kernel, msm_sw_kernel
from crypto_primitives_tpu_torch.ops.curve import te_add as add
from crypto_primitives_tpu_torch.ops.curve import te_to_affine as to_affine
from crypto_primitives_tpu_torch.ops.curve_sw import SWCurveSpec

__all__ = [
    "add", "conditional_sum_grouped_auto", "device_table", "grouped_operands", "grouped_sum", "pack_table_grouped",
    "subset_groups", "te_conditional_sum_grouped", "to_affine", "window_indices",
]


def subset_groups(curve, pts, w: int):
    """Group pts into w-point groups (identity-padded) and tabulate all 2^w
    subset sums: groups[g][e] = sum_{i: e>>i & 1} pts[g*w + i], in the JAX
    package's order (e = previous | 1 << i)."""
    pts = list(pts)
    ident = curve.zero_host()
    while len(pts) % w:
        pts.append(ident)
    groups = []
    for g in range(len(pts) // w):
        grp = pts[g * w:(g + 1) * w]
        subset = [ident]
        for i in range(w):
            subset += [curve.add_host(s, grp[i]) for s in subset]
        groups.append(subset)
    return groups


def pack_table_grouped(curve, pts, w: int = 3) -> np.ndarray:
    """Host points -> the (G, 2^w, 3, W) int32 word table of affine
    (x, y, d*x*y) subset sums (curve a = -1, as the kernel needs)."""
    msm_kernel._check_curve(curve)
    p, d = curve.base.p, curve.d
    rows = [[x, y, d * x % p * y % p] for grp in subset_groups(curve, pts, w) for x, y in grp]
    words = curve.base.pack(np.asarray(rows, dtype=object).reshape(len(rows), 3))
    return words.reshape(-1, 1 << w, 3, words.shape[-1])


def window_indices(bits: torch.Tensor, groups: int, w: int) -> torch.Tensor:
    """bits (B, N) of 0/1, zero-padded to groups * w -> (B, groups) int32
    window values, bit i of group g weighing 2^i."""
    n = bits.shape[-1]
    if n > groups * w:
        raise ValueError(f"{n} bits do not fit {groups} groups of {w}")
    b = F.pad(bits.to(torch.int32), (0, groups * w - n))
    weights = 1 << torch.arange(w, dtype=torch.int32, device=bits.device)
    return (b.reshape(b.shape[0], groups, w) * weights).sum(-1, dtype=torch.int32)


def grouped_operands(table: torch.Tensor, bits: torch.Tensor, w: int):
    """bits (B, N) -> (table[:G], idx (B, G)) with G = ceil(N / w): the
    groups that the bits reach and their window indices.  The groups past
    them would add only the identity, so the MSM does not run them."""
    groups = -(-bits.shape[-1] // w)
    if groups > table.shape[0]:
        raise ValueError(f"{bits.shape[-1]} bits do not fit {table.shape[0]} groups of {w}")
    return table[:groups], window_indices(bits, groups, w)


def grouped_sum(msm, curve, table: torch.Tensor, bits: torch.Tensor, w: int) -> torch.Tensor:
    """bits (..., N) -> :func:`grouped_operands` ->
    ``msm(curve, table[:G], idx)`` -> points (..., coords, W)."""
    out = msm(curve, *grouped_operands(table, bits.reshape(-1, bits.shape[-1]), w))
    return out.reshape(bits.shape[:-1] + out.shape[1:])


def te_conditional_sum_grouped(curve, table: torch.Tensor, bits: torch.Tensor, w: int = 3) -> torch.Tensor:
    """The plain grouped sum: sum_j bits[..., j] * pts[j] over a
    :func:`pack_table_grouped` table; bits (..., N) -> extended (..., 4, W)."""
    return grouped_sum(msm_kernel.grouped_msm_plain, curve, table, bits, w)


def device_table(params_like, w: int, device: torch.device) -> torch.Tensor:
    """The grouped table of ``params_like`` (anything with
    ``packed_grouped(w)``) on ``device``, uploaded once per (params, w,
    device) and kept on the parameters object, so repeated calls do not
    upload it again."""
    cache = params_like.__dict__.setdefault("_device_tables", {})
    key = (w, str(device))
    table = cache.get(key)
    if table is None:
        table = cache[key] = torch.from_numpy(params_like.packed_grouped(w)).to(device)
    return table


def conditional_sum_grouped_auto(curve, params_like, bits: torch.Tensor, w: int) -> torch.Tensor:
    """The grouped sum over ``params_like``'s table on ``bits``' device, for
    either curve model: the CUDA kernel (``ops/msm_kernel.py`` on a TE curve,
    ``ops/msm_sw_kernel.py`` on an SW one) for CUDA bits, its plain version
    for CPU bits.  bits (..., N) -> extended (..., 4, W) or projective
    (..., 3, W)."""
    msm = msm_sw_kernel if isinstance(curve, SWCurveSpec) else msm_kernel
    return grouped_sum(msm.grouped_msm, curve, device_table(params_like, w, bits.device), bits, w)
