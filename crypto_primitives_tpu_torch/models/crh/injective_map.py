"""Injective-map CRH compressors.

Twin of ``crypto_primitives_tpu/models/crh/injective_map.py`` (the
reference's src/crh/injective_map/mod.rs): a Pedersen CRH post-composed with
an injective map that shrinks the digest.  :class:`TECompressor` keeps the
x-coordinate of a twisted-Edwards point (mod.rs:22-31).  The batched tier
maps the Pedersen CRH's affine word rows (kernel ``msm_te`` on the card).
"""

from __future__ import annotations

from typing import Tuple

import torch

from crypto_primitives_tpu_torch.models.crh import CRHScheme, TwoToOneCRHScheme
from crypto_primitives_tpu_torch.models.crh.pedersen import PedersenCRH, PedersenTwoToOneCRH, Window


class TECompressor:
    """The x-coordinate of a TE affine point (injective on the prime-order
    subgroup up to sign, mod.rs:24-31)."""

    @staticmethod
    def injective_map(pt: Tuple[int, int]) -> int:
        return pt[0]

    @staticmethod
    def injective_map_batch(aff: torch.Tensor) -> torch.Tensor:
        """(..., 2, W) affine words -> (..., W) x-coordinates."""
        return aff[..., 0, :]


class PedersenCRHCompressor(CRHScheme):
    """mod.rs:33-62."""

    def __init__(self, curve, window: Window, compressor=TECompressor):
        self.crh = PedersenCRH(curve, window)
        self.compressor = compressor

    def setup(self, rng):
        return self.crh.setup(rng)

    def evaluate(self, params, input_: bytes) -> int:
        return self.compressor.injective_map(self.crh.evaluate(params, input_))

    def evaluate_batch(self, params, inputs, device=None) -> torch.Tensor:
        """inputs (..., nbytes) uint8 -> (..., W) Montgomery words."""
        return self.compressor.injective_map_batch(self.crh.evaluate_batch(params, inputs, device=device))


class PedersenTwoToOneCRHCompressor(TwoToOneCRHScheme):
    """mod.rs:64-108; ``compress`` turns prior compressed digests (field
    elements) into bytes."""

    def __init__(self, curve, window: Window, compressor=TECompressor):
        self.curve = curve
        self.two = PedersenTwoToOneCRH(curve, window)
        self.compressor = compressor

    def setup(self, rng):
        return self.two.setup(rng)

    def evaluate(self, params, left: bytes, right: bytes) -> int:
        return self.compressor.injective_map(self.two.evaluate(params, left, right))

    def compress(self, params, left: int, right: int) -> int:
        return self.evaluate(params, self.curve.base.to_bytes_le(int(left)),
                             self.curve.base.to_bytes_le(int(right)))
