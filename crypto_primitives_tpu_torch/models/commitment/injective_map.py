"""Injective-map commitment: a Pedersen commitment, then the TE x-coordinate.

Twin of ``crypto_primitives_tpu/models/commitment/injective_map.py`` (the
reference's src/commitment/injective_map/mod.rs:12-44).  ``commit_batch``
maps the Pedersen commitment's affine word rows (two grouped MSMs, kernel
``msm_te`` on the card).
"""

from __future__ import annotations

import torch

from crypto_primitives_tpu_torch.models.commitment import CommitmentScheme
from crypto_primitives_tpu_torch.models.commitment.pedersen import PedersenCommitment
from crypto_primitives_tpu_torch.models.crh.injective_map import TECompressor
from crypto_primitives_tpu_torch.models.crh.pedersen import Window


class PedersenCommitmentCompressor(CommitmentScheme):
    def __init__(self, curve, window: Window, compressor=TECompressor):
        self.inner = PedersenCommitment(curve, window)
        self.compressor = compressor

    def setup(self, rng):
        return self.inner.setup(rng)

    def rand_randomness(self, rng):
        return self.inner.rand_randomness(rng)

    def commit(self, params, input_: bytes, randomness: int) -> int:
        return self.compressor.injective_map(self.inner.commit(params, input_, randomness))

    def commit_batch(self, params, inputs, randomness, device=None) -> torch.Tensor:
        """inputs (..., nbytes) uint8, randomness (..., nbits) bits ->
        (..., W) Montgomery words."""
        return self.compressor.injective_map_batch(
            self.inner.commit_batch(params, inputs, randomness, device=device))
