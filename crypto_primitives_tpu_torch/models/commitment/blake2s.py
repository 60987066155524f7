"""Blake2s commitment: ``Com(m; r) = Blake2s256(m || r)``, r 32 bytes.

Twin of ``crypto_primitives_tpu/models/commitment/blake2s.py`` (the
reference's src/commitment/blake2s/mod.rs:20-31).  The batched tier runs
``ops.blake2s`` on ``device`` (``None`` means CUDA).
"""

from __future__ import annotations

import hashlib

import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.models.commitment import CommitmentScheme
from crypto_primitives_tpu_torch.ops.blake2s import blake2s


class Blake2sCommitment(CommitmentScheme):
    RANDOMNESS_BYTES = 32

    def setup(self, rng):
        return None

    def rand_randomness(self, rng) -> bytes:
        return bytes(rng.randrange(256) for _ in range(32))

    def commit(self, params, input_: bytes, randomness: bytes) -> bytes:
        if len(randomness) != 32:
            raise ValueError("the Blake2s commitment takes 32 bytes of randomness")
        return hashlib.blake2s(bytes(input_) + bytes(randomness)).digest()

    def commit_batch(self, params, inputs, randomness, device=None) -> torch.Tensor:
        """inputs ``(..., N)`` uint8, randomness ``(..., 32)`` uint8 -> ``(..., 32)``."""
        dev = resolve_device(device)
        inputs = torch.as_tensor(inputs, dtype=torch.uint8, device=dev)
        randomness = torch.as_tensor(randomness, dtype=torch.uint8, device=dev)
        return blake2s(torch.cat([inputs, randomness], dim=-1), device=dev)
