"""The curve tier's extended Montgomery words from canonical coordinates as one kernel, and its plain PyTorch version.

``te_pack`` takes (..., 2, W) canonical standard-form words (x, y) of affine
twisted-Edwards points and returns the (..., 4, W) extended Montgomery words
(X, Y, T, Z) = (x R, y R, x y R, R) mod p, what ``TECurveSpec.pack_points``
builds on the host.  The JAX package builds them on the host; no TPU kernel
computes them.  On CUDA tensors it launches A4, ``csrc/curve_pack.cu`` (one
thread a point: three Montgomery products on ``field.cuh``); on CPU tensors
it runs :func:`te_pack_plain` (``ops.field.to_mont`` and ``mont_mul``).  Both
give fully reduced coordinates, so they agree word for word.  There is no
fallback between them.  Span ``kernel.pack`` covers both branches; it
carries ``rows`` (the points) only where the kernel takes them, so a trace
tells a launched pack from the plain one.
"""

from __future__ import annotations

import torch

from crypto_primitives_tpu_torch.native import build
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.utils import profiling

# Kernel launches in this process.
launches = 0


def te_pack_plain(curve, xy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x and y to Montgomery form, T their product,
    Z the field's Montgomery one."""
    q = curve.base
    x, y = ff.to_mont(q, xy[..., 0, :]), ff.to_mont(q, xy[..., 1, :])
    return torch.stack([x, y, ff.mont_mul(q, x, y), ff.ones(q, x.shape[:-1], x.device)], dim=-2)


def te_pack(curve, xy: torch.Tensor) -> torch.Tensor:
    """(..., 2, W) int32 canonical words (x, y) -> (..., 4, W) extended
    Montgomery words: the CUDA kernel for CUDA tensors, :func:`te_pack_plain`
    for CPU ones.  Coordinates must be below p, as the host's ``% p`` leaves
    them; nothing checks it."""
    global launches
    q = curve.base
    W = q.num_words
    if xy.dim() < 2 or tuple(xy.shape[-2:]) != (2, W):
        raise ValueError(f"{curve.name}: coordinates must be (..., 2, {W}), got {tuple(xy.shape)}")
    if xy.dtype != torch.int32:
        raise ValueError(f"coordinates must be int32, got {xy.dtype}")
    if xy.device.type == "cpu":
        with profiling.annotate("kernel.pack"):
            return te_pack_plain(curve, xy)
    if xy.device.type != "cuda":
        raise ValueError(f"te_pack runs on CUDA or CPU tensors, not {xy.device}")
    # the kernel reads and writes 16-byte vectors: a view that starts off a
    # 16-byte boundary is copied to a fresh allocation, which starts on one
    xy = xy.contiguous()
    xy = xy if xy.data_ptr() % 16 == 0 else xy.clone()
    lead = xy.shape[:-2]
    B = lead.numel()
    with profiling.annotate("kernel.pack", B):
        out = torch.empty(lead + (4, W), dtype=torch.int32, device=xy.device)
        if B == 0:
            return out
        consts = ff.host_words(q, [q.p, q.R2_mod_p, q.R_mod_p])
        lib = build.load("curve_pack")
        err = lib.curve_pack(
            xy.data_ptr(), out.data_ptr(), consts.ctypes.data, q.n0_word, B, W, xy.device.index or 0,
            torch.cuda.current_stream(xy.device).cuda_stream,
        )
        build.check(lib, err, "curve_pack")
        launches += 1
        return out
