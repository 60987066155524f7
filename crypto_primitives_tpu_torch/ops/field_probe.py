"""Elementwise access to the CUDA field arithmetic, for tests.

``field_ops`` launches ``csrc/field_probe.cu``, which applies one routine of
``csrc/field.cuh`` (the carry-chain product, the lazy sums of products with
one reduction, add, sub) to each pair of elements; ``field_ops_plain`` is the
same function on the plain field tier.  No path of the port runs it: the
card tests (``tests/test_torch_cuda.py``) hold the two equal on edge values
(``edge_values``), where a broken carry chain would show.  Its two chain ops (``iters``
dependent products per element) time the product alone
(``native/kernel_times.py``).
"""

from __future__ import annotations

import torch

from crypto_primitives_tpu_torch.native import build
from crypto_primitives_tpu_torch.ops import field as ff

# op codes of field_probe.cu
OPS = ("mont_mul", "dot3", "dot9", "sparse_row", "add", "sub", "mont_sqr", "mul_chain", "sqr_chain")


def edge_values(spec) -> list:
    """Word values (below p) that carry through every word: 0, 1, p - 1,
    p - 2, R mod p (the Montgomery one), every word 0xFFFFFFFF under a top
    word one below p's, p's top word over zero words, and all-ones words
    under a zero top word.  Pack them with ``mont=False``: the kernel takes
    the words as they are."""
    W = spec.num_words
    R = 1 << (32 * W)
    top = spec.p >> (32 * (W - 1))
    ones_below = ((top - 1) << (32 * (W - 1))) | ((1 << (32 * (W - 1))) - 1)
    vals = [0, 1, spec.p - 1, spec.p - 2, R % spec.p, ones_below, top << (32 * (W - 1)),
            (1 << (32 * (W - 1))) - 1]
    return sorted({v % spec.p for v in vals})


def field_ops_plain(spec, op: str, a: torch.Tensor, b: torch.Tensor, iters: int = 1) -> torch.Tensor:
    """The plain field tier's value of ``op`` on Montgomery words ``(n, W)``;
    the chains take ``iters`` dependent products: a b^iters, a^(2^iters)."""
    if op in ("mul_chain", "sqr_chain"):
        for _ in range(iters):
            a = ff.mont_mul(spec, a, b if op == "mul_chain" else a)
        return a
    if op == "add":
        return ff.add(spec, a, b)
    if op == "sub":
        return ff.sub(spec, a, b)
    if op == "mont_sqr":
        return ff.mont_mul(spec, a, a)
    ab = ff.mont_mul(spec, a, b)
    if op == "mont_mul":
        return ab
    if op == "sparse_row":
        return ff.add(spec, ff.add(spec, ab, a), b)
    return ff.add(spec, ff.mul_small(spec, ab, 3 if op == "dot3" else 9), a)


def field_ops(spec, op: str, a: torch.Tensor, b: torch.Tensor, iters: int = 1) -> torch.Tensor:
    """``op`` on CUDA Montgomery words ``(n, W)`` int32, through the kernel."""
    W = spec.num_words
    for x in (a, b):
        if x.device.type != "cuda" or x.dtype != torch.int32 or tuple(x.shape[1:]) != (W,) or not x.is_contiguous():
            raise ValueError(f"field_ops takes contiguous int32 (n, {W}) CUDA tensors")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b must have one shape and one device")
    out = torch.empty_like(a)
    p_words = ff.host_words(spec, [spec.p])
    lib = build.load("field_probe")
    err = lib.field_ops(
        OPS.index(op), a.data_ptr(), b.data_ptr(), out.data_ptr(), p_words.ctypes.data,
        spec.n0_word, a.shape[0], iters, W, a.device.index or 0, torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check(lib, err, "field_ops")
    return out
