"""SHA-256 CRH.

Twin of ``crypto_primitives_tpu/models/crh/sha256.py`` (the reference's
src/crh/sha256/mod.rs:17-78): no parameters; ``evaluate`` = SHA256(input);
two-to-one = SHA256(left || right); ``compress`` hashes prior 32-byte digests
directly.  The host tier uses hashlib; the batched tier uses ``ops/sha256.py``.
"""

from __future__ import annotations

import hashlib

import torch

from crypto_primitives_tpu_torch.models.crh import CRHScheme, TwoToOneCRHScheme
from crypto_primitives_tpu_torch.ops.sha256 import sha256


class Sha256CRH(CRHScheme):
    DIGEST_WIDTH = 32

    def setup(self, rng):
        return None

    def evaluate(self, params, input_: bytes) -> bytes:
        return hashlib.sha256(bytes(input_)).digest()

    def evaluate_batch(self, params, inputs, device=None) -> torch.Tensor:
        """inputs ``(..., N)`` uint8 -> ``(..., 32)`` uint8."""
        return sha256(inputs, device=device)


class Sha256TwoToOneCRH(TwoToOneCRHScheme):
    DIGEST_WIDTH = 32

    def setup(self, rng):
        return None

    def evaluate(self, params, left: bytes, right: bytes) -> bytes:
        return hashlib.sha256(bytes(left) + bytes(right)).digest()

    def compress(self, params, left: bytes, right: bytes) -> bytes:
        return self.evaluate(params, left, right)

    def evaluate_batch(self, params, left, right, device=None) -> torch.Tensor:
        left, right = torch.as_tensor(left), torch.as_tensor(right)
        return sha256(torch.cat([left, right.to(left.device)], dim=-1), device=device)

    compress_batch = evaluate_batch
