"""Batched SHA-256 of fixed-length messages.

Twin of ``crypto_primitives_tpu/ops/sha256.py``: messages are a
``(..., N)`` uint8 tensor with one length N, so padding and the block count
are fixed per call.  A CUDA batch is one launch of ``sha256_kernel.digest``
(padding, byte order and compression in the kernel); a CPU batch runs its
plain version (padding with ``torch.cat``, big-endian words, the plain
compression).  FIPS 180-4 semantics; the oracle is ``hashlib.sha256``.
"""

from __future__ import annotations

import hashlib
import math

import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.ops import sha256_kernel
from crypto_primitives_tpu_torch.ops.sha256_kernel import bytes_to_words, pad_length, padding, words_to_bytes

__all__ = ["bytes_to_words", "pad_length", "padding", "sha256", "sha256_host", "words_to_bytes"]


def sha256(data, device=None) -> torch.Tensor:
    """SHA-256 of a ``(..., N)`` uint8 batch; returns ``(..., 32)`` uint8 on
    ``device`` (``None`` means CUDA).  A contiguous batch is hashed in place,
    with no copy."""
    data = torch.as_tensor(data, dtype=torch.uint8, device=resolve_device(device))
    batch, n = data.shape[:-1], data.shape[-1]
    out = sha256_kernel.digest(data.reshape(math.prod(batch), n).contiguous())
    return out.reshape(batch + (32,))


def sha256_host(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()
