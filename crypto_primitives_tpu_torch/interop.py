"""Carry the JAX package's data across to the port.

The JAX package and the port hold the same field elements in the same
Montgomery form (R = 2^(16 L)); they differ only in how the digits are laid
out, so a JAX limb array (a field element, or a curve point in the same
coordinate order) becomes port words without arithmetic.  These functions
take the JAX package's data as numpy arrays and Python ints, never JAX
objects, so the port imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np

from crypto_primitives_tpu_torch.models.commitment.pedersen import PedersenCommitmentParameters
from crypto_primitives_tpu_torch.models.crh.pedersen import PedersenParameters
from crypto_primitives_tpu_torch.models.sponge.poseidon import PoseidonConfig
from crypto_primitives_tpu_torch.ops.field import FieldSpec
from crypto_primitives_tpu_torch.ops.fields_known import ALL_FIELDS, BLS12_381_FQ


def field_for_modulus(modulus: int) -> FieldSpec:
    """The port's known FieldSpec with this modulus, or a new one."""
    for spec in ALL_FIELDS + [BLS12_381_FQ]:
        if spec.p == int(modulus):
            return spec
    return FieldSpec(f"custom_{int(modulus).bit_length()}_bit", int(modulus))


def _points(pts):
    return [None if pt is None else (int(pt[0]), int(pt[1])) for pt in pts]


def pedersen_parameters(curve, generators) -> PedersenParameters:
    """The JAX package's Pedersen CRH generators (a list of windows, each a
    list of host (x, y) int tuples) -> the port's PedersenParameters."""
    return PedersenParameters(curve, [_points(win) for win in generators])


def commitment_parameters(curve, randomness_generator, generators) -> PedersenCommitmentParameters:
    """The JAX package's Pedersen commitment parameters (blinding powers and
    window generators, host int tuples) -> the port's."""
    return PedersenCommitmentParameters(curve, _points(randomness_generator),
                                        [_points(win) for win in generators])


def words_from_limbs(limbs) -> np.ndarray:
    """JAX Montgomery limbs ``(..., L)`` of 16-bit digits (uint32) -> the
    port's ``(..., L/2)`` int32 words."""
    d = np.asarray(limbs).astype(np.uint32)
    if d.shape[-1] % 2:
        raise ValueError(f"an odd digit count ({d.shape[-1]}) does not pair into 32-bit words")
    if (d >> 16).any():
        raise ValueError("limbs must be 16-bit digits")
    pairs = d.reshape(d.shape[:-1] + (d.shape[-1] // 2, 2))
    return (pairs[..., 0] | (pairs[..., 1] << 16)).astype(np.uint32).view(np.int32)


def limbs_from_words(words) -> np.ndarray:
    """The port's ``(..., W)`` int32 words -> JAX limbs ``(..., 2W)`` of
    16-bit digits (uint32)."""
    w = np.ascontiguousarray(np.asarray(words, dtype=np.int32)).view(np.uint32)
    d = np.stack([w & 0xFFFF, w >> 16], axis=-1)
    return d.reshape(w.shape[:-1] + (2 * w.shape[-1],)).astype(np.uint32)


def poseidon_config(modulus: int, ark, mds, full_rounds: int, partial_rounds: int,
                    alpha: int, rate: int, capacity: int) -> PoseidonConfig:
    """A JAX Poseidon configuration, given as its modulus and its tables of
    canonical ints, -> the port's PoseidonConfig."""
    return PoseidonConfig(
        field=field_for_modulus(modulus),
        full_rounds=int(full_rounds),
        partial_rounds=int(partial_rounds),
        alpha=int(alpha),
        ark=[[int(v) for v in row] for row in ark],
        mds=[[int(v) for v in row] for row in mds],
        rate=int(rate),
        capacity=int(capacity),
    )
