"""Sharded fixed-base multi-scalar multiplication.

Twin of ``crypto_primitives_tpu/parallel/msm.py``.  The Pedersen window sums
(src/crh/pedersen/mod.rs:113-124, rayon over windows) become: the N fixed
points and the matching columns of the bits are split across the mesh,
each rank computes its partial sum with the grouped MSM (kernel ``msm_te``
or ``msm_sw`` for CUDA bits, its plain version for CPU bits) over a grouped
table of its own N/D points, built once per (points, w, device) and kept
on its device, and the D partial points ride one all-gather and are folded
with the log-depth complete addition (``te_sum`` / ``sw_sum``) on every
rank.  The group law is no ``all_reduce`` sum, hence the gather and fold.

The JAX package has three entry points (limbs, RNS, SW RNS); the port has
one representation, so one entry point per curve model.  The partial sums
are grouped differently from a single-device sum, so the projective
coordinates may differ from it: compare affine points.

SPMD form: every rank passes the same host ``points`` (the parameters,
which every rank holds) and the same ``bits`` (..., N) on its device, and
takes its own N/D of each; the result (..., C, W) is replicated.
"""

from __future__ import annotations

import functools

import torch

from crypto_primitives_tpu_torch.ops import curve_fast, curve_sw_fast, msm_kernel, msm_sw_kernel
from crypto_primitives_tpu_torch.ops.curve import te_sum
from crypto_primitives_tpu_torch.ops.curve_sw import sw_sum
from crypto_primitives_tpu_torch.parallel.mesh import all_gather, shard_of


@functools.lru_cache(maxsize=32)
def _local_table(pack_table_grouped, curve, points: tuple, w: int, device: str) -> torch.Tensor:
    """This rank's grouped table of ``points`` on ``device``, built and
    uploaded once; every caller gets the same tensor and must not write to
    it."""
    return torch.from_numpy(pack_table_grouped(curve, list(points), w)).to(device)


def _sharded_sum(pack_table_grouped, msm, sum_fn, curve, points, bits: torch.Tensor, mesh, axis_name: str,
                 w: int) -> torch.Tensor:
    rank, size, _ = shard_of(mesh, axis_name)
    n = len(points)
    if bits.shape[-1] != n:
        raise ValueError(f"bits (..., {bits.shape[-1]}) do not match {n} points")
    if n % size:
        raise ValueError(f"{n} points do not split over {size} ranks")
    n_local = n // size
    lo = rank * n_local
    table = _local_table(pack_table_grouped, curve, tuple(points[lo:lo + n_local]), w, str(bits.device))
    partial = curve_fast.grouped_sum(msm.grouped_msm, curve, table, bits[..., lo:lo + n_local], w)
    return sum_fn(curve, all_gather(partial, mesh, axis_name).movedim(0, -3))


def sharded_fixed_base_msm(curve, points, bits: torch.Tensor, mesh, axis_name: str = "data",
                           w: int = 3) -> torch.Tensor:
    """sum_j bits[..., j] * points[j] on a twisted-Edwards curve (a = -1),
    the points split over the mesh: ``points`` N host affine tuples,
    ``bits`` (..., N) of 0/1, N divisible by the mesh size.  Returns
    extended points (..., 4, W), replicated."""
    return _sharded_sum(curve_fast.pack_table_grouped, msm_kernel, te_sum, curve, points, bits, mesh,
                        axis_name, w)


def sharded_fixed_base_msm_sw(curve, points, bits: torch.Tensor, mesh, axis_name: str = "data",
                              w: int = 3) -> torch.Tensor:
    """The short-Weierstrass twin of :func:`sharded_fixed_base_msm`:
    projective points (..., 3, W), replicated (the multi-device shape of
    BLS12-381 G1 Pedersen and fixed-base work)."""
    return _sharded_sum(curve_sw_fast.pack_table_grouped, msm_sw_kernel, sw_sum, curve, points, bits, mesh,
                        axis_name, w)
