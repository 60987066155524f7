"""Batched SHA-256 of fixed-length messages.

Twin of ``crypto_primitives_tpu/ops/sha256.py``: messages are a
``(..., N)`` uint8 tensor with one length N, so padding and the block count
are fixed per call.  Padding and the byte <-> big-endian word conversion are
plain PyTorch; the compression is ``ops/sha256_kernel.compress`` (the CUDA
kernel on a CUDA tensor, its plain version on a CPU tensor).  FIPS 180-4
semantics; the oracle is ``hashlib.sha256``.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.ops import sha256_kernel


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


def sha256(data, device=None) -> torch.Tensor:
    """SHA-256 of a ``(..., N)`` uint8 batch; returns ``(..., 32)`` uint8 on
    ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    data = torch.as_tensor(data, dtype=torch.uint8, device=dev)
    batch = data.shape[:-1]
    n = data.shape[-1]
    flat = data.reshape(math.prod(batch), n)
    pad = torch.from_numpy(padding(n)).to(dev)
    padded = torch.cat([flat, pad.expand(flat.shape[0], -1)], dim=1)
    state = sha256_kernel.compress(bytes_to_words(padded))
    return words_to_bytes(state).reshape(batch + (32,))


def sha256_host(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()
