"""The curve tier's complete addition as one kernel, and its plain PyTorch version.

``te_add`` adds two batches of twisted-Edwards points in extended
coordinates (..., 4, W) (X, Y, T, Z) by the unified add-2008-hwcd law, the
two broadcast against each other, and returns (..., 4, W) Montgomery words.
The JAX package adds in plain XLA (``ops/curve.py`` ``te_add``); no TPU
kernel computes it.  On CUDA tensors it launches ``csrc/curve_add.cu`` (one
thread a pair: the 11 Montgomery products on ``field.cuh``); on CPU tensors
it runs :func:`te_add_plain`, the plain-torch digit chain
(``ops.curve.te_add_digits``).  Both give fully reduced coordinates, so they
agree word for word.  There is no fallback between them.  Span
``kernel.add`` covers both branches; it carries ``rows`` (the pairs) only
where the kernel takes them, so a trace tells a launched addition from the
plain one.
"""

from __future__ import annotations

import torch

from crypto_primitives_tpu_torch.native import build
from crypto_primitives_tpu_torch.ops import curve as te
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.utils import profiling

# Kernel launches in this process.
launches = 0


def te_add_plain(curve, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: :func:`ops.curve.te_add_digits` on the words'
    16-bit digits."""
    return ff.from_digits(te.te_add_digits(curve, ff.to_digits(p1), ff.to_digits(p2)))


def te_add(curve, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """p1 + p2 for (..., 4, W) int32 points, broadcast against each other:
    the CUDA kernel for CUDA tensors, :func:`te_add_plain` for CPU ones.
    Coordinates must be canonical (below p), as every curve operation leaves
    them; nothing checks it."""
    global launches
    q = curve.base
    W = q.num_words
    for pt in (p1, p2):
        if pt.dim() < 2 or tuple(pt.shape[-2:]) != (4, W):
            raise ValueError(f"{curve.name}: points must be (..., 4, {W}), got {tuple(pt.shape)}")
        if pt.dtype != torch.int32:
            raise ValueError(f"points must be int32, got {pt.dtype}")
    if p1.device != p2.device:
        raise ValueError(f"points on two devices: {p1.device} and {p2.device}")
    if p1.device.type == "cpu":
        with profiling.annotate("kernel.add"):
            return te_add_plain(curve, p1, p2)
    if p1.device.type != "cuda":
        raise ValueError(f"te_add runs on CUDA or CPU tensors, not {p1.device}")
    # the kernel reads and writes 16-byte vectors: a view that starts off a
    # 16-byte boundary is copied to a fresh allocation, which starts on one
    p1, p2 = (pt.contiguous() for pt in torch.broadcast_tensors(p1, p2))
    p1, p2 = (pt if pt.data_ptr() % 16 == 0 else pt.clone() for pt in (p1, p2))
    lead = p1.shape[:-2]
    B = lead.numel()
    with profiling.annotate("kernel.add", B):
        out = torch.empty(lead + (4, W), dtype=torch.int32, device=p1.device)
        if B == 0:
            return out
        consts = ff.host_words(q, [q.p, q.to_mont(curve.d), q.to_mont(curve.a)])
        lib = build.load("curve_add")
        err = lib.curve_add(
            p1.data_ptr(), p2.data_ptr(), out.data_ptr(), consts.ctypes.data, q.n0_word, B, W,
            p1.device.index or 0, torch.cuda.current_stream(p1.device).cuda_stream,
        )
        build.check(lib, err, "curve_add")
        launches += 1
        return out
