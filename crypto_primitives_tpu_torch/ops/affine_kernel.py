"""The curve tier's affine step as one kernel, and its plain PyTorch version.

``to_affine`` takes projective points (..., C, W), Z last (C = 4:
twisted-Edwards extended (X, Y, T, Z); C = 3: short-Weierstrass projective
(X, Y, Z)), and returns (X / Z, Y / Z) as (..., 2, W) Montgomery words, Z
inverted by Fermat, Z^(p-2); Z = 0 maps to (0, 0).  The JAX package does this
step in plain XLA (``ops/curve.py`` ``te_to_affine``, ``ops/curve_sw.py``
``sw_to_affine``); no TPU kernel computes it.  On a CUDA tensor it launches
``csrc/curve_affine.cu`` (one thread a point: Z^(p-2) by square-and-multiply
on ``field.cuh``, then the two products); on a CPU tensor it runs
:func:`to_affine_plain`, the plain-torch chain of Montgomery products.  Both
give the fully reduced inverse, so they agree word for word.  There is no
fallback between them.  Span ``kernel.affine`` covers both branches; it
carries ``rows`` (the points) only where the kernel takes them, so a trace
tells a launched step from the plain one.
"""

from __future__ import annotations

import torch

from crypto_primitives_tpu_torch.native import build
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.utils import profiling

# Kernel launches in this process.
launches = 0


def to_affine_plain(curve, pts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (..., C, W) -> (..., 2, W), Z^(p-2) by
    :func:`field.pow_const_digits`, then X zi and Y zi."""
    q = curve.base
    d = ff.to_digits(pts)
    zi = ff.pow_const_digits(q, d[..., -1, :], q.p - 2)
    return ff.from_digits(ff.mont_mul_digits(q, d[..., 0:2, :], zi.unsqueeze(-2)))


def to_affine(curve, pts: torch.Tensor) -> torch.Tensor:
    """(X / Z, Y / Z) of (..., C, W) points with C = ``curve.coords``: the
    CUDA kernel for CUDA tensors (int32, contiguous), :func:`to_affine_plain`
    for CPU ones.  Coordinates must be canonical (below p), as every curve
    operation leaves them; nothing checks it."""
    global launches
    q = curve.base
    W, C = q.num_words, curve.coords
    if pts.dim() < 2 or tuple(pts.shape[-2:]) != (C, W):
        raise ValueError(f"{curve.name}: points must be (..., {C}, {W}), got {tuple(pts.shape)}")
    lead = pts.shape[:-2]
    B = lead.numel()
    if pts.device.type == "cpu":
        with profiling.annotate("kernel.affine"):
            return to_affine_plain(curve, pts)
    if pts.device.type != "cuda":
        raise ValueError(f"to_affine runs on CUDA or CPU tensors, not {pts.device}")
    if pts.dtype != torch.int32:
        raise ValueError(f"points must be int32, got {pts.dtype}")
    if not pts.is_contiguous():
        raise ValueError("points must be contiguous")
    with profiling.annotate("kernel.affine", B):
        out = torch.empty(lead + (2, W), dtype=torch.int32, device=pts.device)
        if B == 0:
            return out
        e = q.p - 2
        consts = ff.host_words(q, [q.p, e])
        lib = build.load("curve_affine")
        err = lib.curve_affine(
            pts.data_ptr(), out.data_ptr(), consts.ctypes.data, q.n0_word, e.bit_length(), B, C, W,
            pts.device.index or 0, torch.cuda.current_stream(pts.device).cuda_stream,
        )
        build.check(lib, err, "curve_affine")
        launches += 1
        return out
