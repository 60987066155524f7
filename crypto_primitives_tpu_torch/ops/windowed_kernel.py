"""The curve tier's windowed variable-base product as one kernel, and its plain PyTorch version.

``te_windowed`` multiplies twisted-Edwards points in extended coordinates
(..., 4, W) by scalars given as bits (..., nbits), least significant first,
the two batch shapes broadcast against each other (one key for many scalars,
one scalar for many points, or a point a scalar), and returns (..., 4, W)
Montgomery words.  The JAX package runs the product in plain XLA
(``ops/curve_rns.py`` ``te_scalar_mul_bits_windowed_rns``); no TPU kernel
computes it.  On CUDA tensors it launches A3, ``csrc/curve_windowed.cu`` (one
thread a row: the 2^w multiples of its point in a scratch table, then w
doublings and one addition a window, every step the complete addition on
``field.cuh``), built for W = 8 and w = 4; on CPU tensors it runs
:func:`te_windowed_plain`, ``ops.curve_fast.windowed_digits`` with the digit
chain ``ops.curve.te_add_digits``.  Both take the same steps and give fully
reduced coordinates, so they agree word for word.  There is no fallback
between them.  Span ``kernel.windowed`` covers both branches; it carries
``rows`` (the broadcast points) only where the kernel takes them, so a trace
tells a launched product from the plain one.
"""

from __future__ import annotations

import torch

from crypto_primitives_tpu_torch.native import build
from crypto_primitives_tpu_torch.ops import curve as te
from crypto_primitives_tpu_torch.ops import curve_fast
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.utils import profiling

# The window width the kernel is built for.
KERNEL_W = 4

# Kernel launches in this process.
launches = 0


def te_windowed_plain(curve, base: torch.Tensor, bits: torch.Tensor, w: int) -> torch.Tensor:
    """Plain PyTorch version: :func:`ops.curve_fast.windowed_digits` with
    :func:`ops.curve.te_add_digits` on the words' 16-bit digits."""
    ident = curve._consts(base.device)["identity"]
    return ff.from_digits(curve_fast.windowed_digits(lambda a, b: te.te_add_digits(curve, a, b), ident,
                                                     ff.to_digits(base), bits, w))


def te_windowed(curve, base: torch.Tensor, bits: torch.Tensor, w: int = KERNEL_W) -> torch.Tensor:
    """base (..., 4, W) int32 points times scalars given as bits (..., nbits)
    uint8 of 0 or 1, least significant first, in windows of w bits, the
    batch shapes broadcast: the CUDA kernel for CUDA tensors (w = 4 only),
    :func:`te_windowed_plain` for CPU ones.  Coordinates must be canonical
    (below p), as every curve operation leaves them; nothing checks it."""
    global launches
    q = curve.base
    W = q.num_words
    if base.dim() < 2 or tuple(base.shape[-2:]) != (4, W):
        raise ValueError(f"{curve.name}: points must be (..., 4, {W}), got {tuple(base.shape)}")
    if base.dtype != torch.int32:
        raise ValueError(f"points must be int32, got {base.dtype}")
    if bits.dim() < 1 or bits.shape[-1] < 1:
        raise ValueError(f"bits must be (..., nbits) with nbits >= 1, got {tuple(bits.shape)}")
    if bits.dtype != torch.uint8:
        raise ValueError(f"bits must be uint8, got {bits.dtype}")
    if base.device != bits.device:
        raise ValueError(f"points and bits on two devices: {base.device} and {bits.device}")
    if base.device.type == "cpu":
        with profiling.annotate("kernel.windowed"):
            return te_windowed_plain(curve, base, bits, w)
    if base.device.type != "cuda":
        raise ValueError(f"te_windowed runs on CUDA or CPU tensors, not {base.device}")
    if w != KERNEL_W:
        raise ValueError(f"the kernel takes windows of {KERNEL_W} bits, not {w}")
    nbits = bits.shape[-1]
    lead = torch.broadcast_shapes(bits.shape[:-1], base.shape[:-2])
    # one row a broadcast point; the kernel reads and writes 16-byte vectors,
    # so a view that starts off a 16-byte boundary is copied to a fresh
    # allocation, which starts on one
    base, bits = base.expand(lead + (4, W)).contiguous(), bits.expand(lead + (nbits,)).contiguous()
    base, bits = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (base, bits))
    B = lead.numel()
    with profiling.annotate("kernel.windowed", B):
        out = torch.empty(lead + (4, W), dtype=torch.int32, device=base.device)
        if B == 0:
            return out
        table = torch.empty(((1 << w) * 4 * W * B,), dtype=torch.int32, device=base.device)
        consts = ff.host_words(q, [q.p, q.to_mont(curve.d), q.to_mont(curve.a), q.to_mont(1)])
        lib = build.load("curve_windowed")
        err = lib.curve_windowed(
            base.data_ptr(), bits.data_ptr(), table.data_ptr(), out.data_ptr(), consts.ctypes.data, q.n0_word, B,
            nbits, W, w, base.device.index or 0, torch.cuda.current_stream(base.device).cuda_stream,
        )
        build.check(lib, err, "curve_windowed")
        launches += 1
        return out
