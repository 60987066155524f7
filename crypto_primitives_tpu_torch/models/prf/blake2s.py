"""Blake2s PRF.

Twin of ``crypto_primitives_tpu/models/prf/blake2s.py`` (the reference's
src/prf/blake2s/mod.rs): ``evaluate(seed, input) = Blake2s256(seed || input)``
with fixed 32-byte seed, input and output (mod.rs:13-28), and
``Blake2sWithParameterBlock``, a keyless Blake2s with salt and
personalisation (mod.rs:30-49; as in the reference, its ``output_size`` and
``key_size`` fields are stored and its ``evaluate`` always uses a 32-byte
output and an empty key).  The batched tier runs ``ops.blake2s`` on
``device`` (``None`` means CUDA).
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.ops.blake2s import blake2s


class Blake2sPRF:
    SEED_BYTES = 32
    INPUT_BYTES = 32
    OUTPUT_BYTES = 32

    @staticmethod
    def evaluate(seed: bytes, input_: bytes) -> bytes:
        if len(seed) != 32 or len(input_) != 32:
            raise ValueError("the Blake2s PRF takes a 32-byte seed and a 32-byte input")
        return hashlib.blake2s(bytes(seed) + bytes(input_)).digest()

    @staticmethod
    def evaluate_batch(seeds, inputs, device=None) -> torch.Tensor:
        """seeds, inputs ``(..., 32)`` uint8 -> ``(..., 32)`` uint8."""
        dev = resolve_device(device)
        seeds = torch.as_tensor(seeds, dtype=torch.uint8, device=dev)
        inputs = torch.as_tensor(inputs, dtype=torch.uint8, device=dev)
        return blake2s(torch.cat([seeds, inputs], dim=-1), device=dev)


@dataclasses.dataclass
class Blake2sWithParameterBlock:
    output_size: int = 32
    key_size: int = 0
    salt: bytes = b"\x00" * 8
    personalization: bytes = b"\x00" * 8

    def evaluate(self, input_: bytes) -> bytes:
        return hashlib.blake2s(bytes(input_), salt=bytes(self.salt), person=bytes(self.personalization)).digest()

    def evaluate_batch(self, inputs, device=None) -> torch.Tensor:
        """inputs ``(..., N)`` uint8 -> ``(..., 32)`` uint8."""
        return blake2s(inputs, salt=bytes(self.salt), person=bytes(self.personalization), device=device)
