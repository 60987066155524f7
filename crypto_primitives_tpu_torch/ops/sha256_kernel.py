"""The SHA-256 kernel's two entry points and their plain PyTorch versions.

Both are counterparts of the JAX package's TPU kernel ``sha256_state_pallas``
(``ops/sha256_pallas.py``) and launch ``csrc/sha256_compress.cu`` (one thread
per message, one copy of the rounds) on a CUDA tensor:

  * ``digest``: a ``(B, n)`` uint8 batch of n-byte messages -> ``(B, 32)``
    uint8 digests, FIPS 180-4 padding and byte order included, in one
    launch; its plain version :func:`digest_plain` pads with ``torch.cat``
    and runs :func:`compress_plain` between the two byte-order passes;
  * ``compress``: pre-padded big-endian words ``(B, nblocks, 16)``, chained
    over the blocks from the initial state, -> ``(B, 8)`` state words (the
    TPU kernel's own contract); its plain version is :func:`compress_plain`,
    the JAX XLA path's arithmetic (``ops/sha256.py:_compress``) in int64.

Words are int32 tensors holding uint32 bit patterns.  A CPU tensor runs the
plain version; there is no fallback between the two.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from crypto_primitives_tpu_torch.native import build
from crypto_primitives_tpu_torch.utils import profiling

K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

H0 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

M32 = 0xFFFFFFFF

# Kernel launches in this process; the benchmark's programs and the card
# tests read it.
launches = 0


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _schedule(w: list) -> list:
    """A block's 16 words (Python ints or int64 tensors below 2^32) -> its
    64-word message schedule."""
    w = list(w)
    for i in range(16, 64):
        w15, w2 = w[i - 15], w[i - 2]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & M32)
    return w


def pad_length(n: int) -> int:
    """Padded length of an n-byte message: n + 0x80 + zeros + 8-byte length,
    rounded up to whole 64-byte blocks."""
    return ((n + 1 + 8 + 63) // 64) * 64


def padding(n: int) -> np.ndarray:
    """The pad bytes that follow every n-byte message."""
    pad = np.zeros((pad_length(n) - n,), dtype=np.uint8)
    pad[0] = 0x80
    pad[-8:] = np.frombuffer((8 * n).to_bytes(8, "big"), dtype=np.uint8)
    return pad


def bytes_to_words(data: torch.Tensor) -> torch.Tensor:
    """``(B, 64 k)`` uint8 -> ``(B, k, 16)`` big-endian words (int32 bit
    patterns)."""
    b = data.shape[0]
    by = data.reshape(b, -1, 4).flip(-1).contiguous()  # big- to little-endian
    return by.view(torch.int32).reshape(b, -1, 16)


def words_to_bytes(state: torch.Tensor) -> torch.Tensor:
    """``(B, 8)`` state words -> ``(B, 32)`` big-endian digest bytes."""
    b = state.shape[0]
    return state.contiguous().view(torch.uint8).reshape(b, 8, 4).flip(-1).reshape(b, 32)


@functools.lru_cache(maxsize=64)
def padding_block_kw(n: int) -> np.ndarray:
    """K[r] + W[r] (mod 2^32) for r < 64 over the fixed padding block of an
    n-byte message (0x80, zeros, the bit length; the last block when
    n % 64 == 0): the kernel runs that block's rounds from these constants
    instead of expanding its schedule."""
    nbits = 8 * n
    w = _schedule([0x80000000] + [0] * 13 + [(nbits >> 32) & M32, nbits & M32])
    return np.array([(k + x) & M32 for k, x in zip(K, w)], dtype=np.uint32)


def compress_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch compression: ``(B, nblocks, 16)`` -> ``(B, 8)`` int32.
    Values are carried in int64 below 2^32 so shifts are logical."""
    w_all = words.to(torch.int64) & M32
    batch = words.shape[0]
    state = [torch.full((batch,), h, dtype=torch.int64, device=words.device) for h in H0]
    for blk in range(words.shape[1]):
        w = _schedule(w_all[:, blk].unbind(-1))
        a, b, c, d, e, f, g, h = state
        for i in range(64):
            s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ (~e & M32 & g)
            t1 = h + s1 + ch + K[i] + w[i]
            s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            a, b, c, d, e, f, g, h = (t1 + s0 + maj) & M32, a, b, c, (d + t1) & M32, e, f, g
        state = [(x + y) & M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]
    v = torch.stack(state, dim=-1)
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32)


def digest_plain(msgs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SHA-256: ``(B, n)`` uint8 -> ``(B, 32)`` uint8 digests."""
    pad = torch.from_numpy(padding(msgs.shape[1])).to(msgs.device)
    padded = torch.cat([msgs, pad.expand(msgs.shape[0], -1)], dim=1)
    return words_to_bytes(compress_plain(bytes_to_words(padded)))


def digest(msgs: torch.Tensor) -> torch.Tensor:
    """SHA-256 of a ``(B, n)`` uint8 batch of n-byte messages -> ``(B, 32)``
    uint8: one kernel launch for a CUDA tensor (16-byte loads where n is a
    multiple of 16 and the batch starts on a 16-byte boundary, byte loads
    otherwise), :func:`digest_plain` for a CPU one.
    Span ``kernel.k3`` (``rows``: the messages), on both branches."""
    global launches
    shape = msgs.shape  # read once, for the span and the launch
    with profiling.annotate("kernel.k3", shape[0]):
        if msgs.device.type == "cpu":
            return digest_plain(msgs)
        if msgs.device.type != "cuda":
            raise ValueError(f"sha256_digest runs on CUDA or CPU tensors, not {msgs.device}")
        if msgs.dtype != torch.uint8 or len(shape) != 2:
            raise ValueError(f"messages must be uint8 (B, n), got {msgs.dtype} {tuple(shape)}")
        if not msgs.is_contiguous():
            raise ValueError("messages must be contiguous")
        B, n = shape
        out = torch.empty((B, 32), dtype=torch.uint8, device=msgs.device)
        if B == 0:
            return out
        kw = padding_block_kw(n)
        lib = build.load("sha256_compress")
        err = lib.sha256_digest(
            msgs.data_ptr(), out.data_ptr(), B, n, kw.ctypes.data,
            msgs.device.index or 0, torch.cuda.current_stream(msgs.device).cuda_stream,
        )
        build.check(lib, err, "sha256_digest")
        launches += 1
        return out


def compress(words: torch.Tensor) -> torch.Tensor:
    """SHA-256 compression of ``(B, nblocks, 16)`` int32 words -> ``(B, 8)``:
    the CUDA kernel for a CUDA tensor, :func:`compress_plain` for a CPU one.
    Span ``kernel.k3`` (``rows``: the messages), on both branches."""
    global launches
    shape = words.shape  # read once, for the span and the launch
    with profiling.annotate("kernel.k3", shape[0]):
        if words.device.type == "cpu":
            return compress_plain(words)
        if words.device.type != "cuda":
            raise ValueError(f"sha256_compress runs on CUDA or CPU tensors, not {words.device}")
        if words.dtype != torch.int32 or len(shape) != 3 or shape[2] != 16:
            raise ValueError(f"words must be int32 (B, nblocks, 16), got {words.dtype} {tuple(shape)}")
        if not words.is_contiguous() or words.data_ptr() % 16:
            raise ValueError("words must be contiguous and 16-byte aligned")
        out = torch.empty((shape[0], 8), dtype=torch.int32, device=words.device)
        if shape[0] == 0:
            return out
        lib = build.load("sha256_compress")
        err = lib.sha256_compress(
            words.data_ptr(), out.data_ptr(), shape[0], shape[1],
            words.device.index or 0, torch.cuda.current_stream(words.device).cuda_stream,
        )
        build.check(lib, err, "sha256_compress")
        launches += 1
        return out
