"""Batched BLAKE2s (RFC 7693) over a ``(..., N)`` uint8 tensor.

Twin of ``crypto_primitives_tpu/ops/blake2s.py`` (the reference delegates to
RustCrypto's ``blake2``, src/prf/blake2s/mod.rs:18-49, including the
parameterised ``Blake2sWithParameterBlock`` with salt and personalisation).
The JAX package computes it in XLA, with no Pallas kernel, so here it is
plain PyTorch on any device: the message length is static, so the block
schedule and every byte counter are Python ints.

Words follow the port's SHA-256 convention (``ops/sha256_kernel.py``): the
message is read as int32 words, and the arithmetic runs on int64 values
below 2^32, masked after every addition, so that ``>>`` is a logical shift.
Each round runs its four column G calls as one step on ``(B, 4)`` rows, then
its four diagonal calls the same way after rotating rows b, c and d by 1, 2
and 3 lanes: 2 steps a round rather than 8.  The oracle is
``hashlib.blake2s``.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device

_IV = np.array(
    [
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    ],
    dtype=np.uint32,
)

_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

M32 = 0xFFFFFFFF


def _rotr(x, n: int):
    """Rotate right by n; x is int64 in [0, 2^32)."""
    return ((x >> n) | (x << (32 - n))) & M32


def _g(a, b, c, d, x, y):
    """The mixing function on ``(B, 4)`` rows (rotations 16, 12, 8, 7)."""
    a = (a + b + x) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + y) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def _compress(h, m, t: int, last: bool):
    """One compression: h ``(B, 8)`` and m ``(B, 16)`` int64 words below
    2^32; t is the byte counter."""
    iv = torch.from_numpy(_IV.astype(np.int64)).to(h.device)
    low = iv[4:].clone()
    low[0] ^= t & M32
    low[1] ^= (t >> 32) & M32
    if last:
        low[2] ^= M32
    a, b = h[:, :4], h[:, 4:]
    c, d = iv[:4].expand_as(a), low.expand_as(a)
    for s in _SIGMA:
        a, b, c, d = _g(a, b, c, d, m[:, s[0:8:2]], m[:, s[1:8:2]])
        b, c, d = b.roll(-1, -1), c.roll(-2, -1), d.roll(-3, -1)
        a, b, c, d = _g(a, b, c, d, m[:, s[8:16:2]], m[:, s[9:16:2]])
        b, c, d = b.roll(1, -1), c.roll(2, -1), d.roll(3, -1)
    return h ^ torch.cat([a ^ c, b ^ d], dim=-1)


def blake2s(data, digest_size: int = 32, key: bytes = b"", salt: bytes = b"", person: bytes = b"",
            device=None) -> torch.Tensor:
    """BLAKE2s of a ``(..., N)`` uint8 batch; returns ``(..., digest_size)``
    uint8 on ``device`` (``None`` means CUDA)."""
    data = torch.as_tensor(data, dtype=torch.uint8, device=resolve_device(device))
    key, salt, person = bytes(key), bytes(salt or b""), bytes(person or b"")
    if not 1 <= digest_size <= 32 or len(key) > 32 or len(salt) > 8 or len(person) > 8:
        raise ValueError("BLAKE2s takes digest_size 1-32, a key of at most 32 bytes, and salt and "
                         "person of at most 8 bytes")
    salt, person = salt.ljust(8, b"\0"), person.ljust(8, b"\0")
    batch, n = data.shape[:-1], data.shape[-1]
    rows = data.reshape(math.prod(batch), n)

    # parameter block word 0: digest_len | key_len << 8 | fanout << 16 | depth << 24
    h = [int(v) for v in _IV]
    h[0] ^= digest_size | (len(key) << 8) | (1 << 16) | (1 << 24)
    h[4] ^= int.from_bytes(salt[0:4], "little")
    h[5] ^= int.from_bytes(salt[4:8], "little")
    h[6] ^= int.from_bytes(person[0:4], "little")
    h[7] ^= int.from_bytes(person[4:8], "little")
    state = torch.tensor(h, dtype=torch.int64, device=data.device).expand(rows.shape[0], 8)

    # the message: an optional key block, then the data, zero-padded to whole blocks
    parts = [rows]
    if key:
        block = torch.zeros(64, dtype=torch.uint8)
        block[: len(key)] = torch.tensor(list(key), dtype=torch.uint8)
        parts.insert(0, block.to(data.device).expand(rows.shape[0], 64))
    n_total = n + (64 if key else 0)
    nblocks = max(1, -(-n_total // 64))
    parts.append(rows.new_zeros((rows.shape[0], nblocks * 64 - n_total)))
    padded = torch.cat(parts, dim=1).contiguous()
    # little-endian words, as int32 bit patterns, then int64 below 2^32
    words = padded.view(torch.int32).to(torch.int64) & M32
    words = words.reshape(rows.shape[0], nblocks, 16)

    for i in range(nblocks):
        # the byte counter: bytes fed including this block; a keyed empty
        # message's counter stays at the key block
        t = 64 if key and n == 0 else min((i + 1) * 64, n_total)
        state = _compress(state, words[:, i], t, i == nblocks - 1)

    out = torch.stack([(state >> (8 * k)) & 0xFF for k in range(4)], dim=-1).to(torch.uint8)
    return out.reshape(batch + (32,))[..., :digest_size]


def blake2s_host(data: bytes, digest_size: int = 32, key: bytes = b"", salt: bytes = b"",
                 person: bytes = b"") -> bytes:
    return hashlib.blake2s(data, digest_size=digest_size, key=key, salt=salt, person=person).digest()
