"""Poseidon CRH: thin wrappers over the duplex sponge.

Twin of ``crypto_primitives_tpu/models/crh/poseidon.py`` (the reference's
src/crh/poseidon/mod.rs):
  * ``PoseidonCRH.evaluate`` absorbs a fixed-length field-element input and
    squeezes one element (mod.rs:30-41);
  * ``PoseidonTwoToOneCRH.evaluate``/``compress`` absorb left then right
    (mod.rs:58-79);
  * ``setup`` is unimplemented: parameters must be supplied (mod.rs:24-28).
"""

from __future__ import annotations

import torch

from crypto_primitives_tpu_torch.models.crh import CRHScheme, TwoToOneCRHScheme
from crypto_primitives_tpu_torch.models.sponge.poseidon import (
    PoseidonConfig,
    PoseidonSponge,
    PoseidonSpongeBatch,
)
from crypto_primitives_tpu_torch.ops.field import FieldSpec


class PoseidonCRH(CRHScheme):
    """Input: a list of field elements (host) or ``(..., k, W)`` Montgomery
    words (batched)."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def setup(self, rng):
        raise NotImplementedError("Poseidon parameters must be supplied explicitly")

    def evaluate(self, params: PoseidonConfig, input_) -> int:
        sponge = PoseidonSponge(params)
        sponge.absorb_elements([int(v) for v in input_])
        return sponge.squeeze_native_field_elements(1)[0]

    def evaluate_batch(self, params: PoseidonConfig, inputs, device=None) -> torch.Tensor:
        """inputs ``(..., k, W)`` Montgomery words -> digests ``(..., W)``."""
        inputs = torch.as_tensor(inputs)
        sponge = PoseidonSpongeBatch(params, batch_shape=inputs.shape[:-2], device=device)
        sponge.absorb(inputs)
        return sponge.squeeze_native_field_elements(1)[..., 0, :]


class PoseidonTwoToOneCRH(TwoToOneCRHScheme):
    """Input and output: single field elements."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def setup(self, rng):
        raise NotImplementedError("Poseidon parameters must be supplied explicitly")

    def evaluate(self, params: PoseidonConfig, left: int, right: int) -> int:
        return self.compress(params, left, right)

    def compress(self, params: PoseidonConfig, left: int, right: int) -> int:
        sponge = PoseidonSponge(params)
        sponge.absorb_elements([int(left)])
        sponge.absorb_elements([int(right)])
        return sponge.squeeze_native_field_elements(1)[0]

    def evaluate_batch(self, params: PoseidonConfig, left, right, device=None) -> torch.Tensor:
        """left/right ``(..., W)`` Montgomery words -> ``(..., W)``."""
        left, right = torch.as_tensor(left), torch.as_tensor(right)
        sponge = PoseidonSpongeBatch(params, batch_shape=left.shape[:-1], device=device)
        sponge.absorb(left.unsqueeze(-2))
        sponge.absorb(right.unsqueeze(-2))
        return sponge.squeeze_native_field_elements(1)[..., 0, :]

    compress_batch = evaluate_batch
