"""Carry the JAX package's data across to the port.

For every field whose JAX digit count L is even, the JAX package and the
port hold the same field elements in the same Montgomery form
(R = 2^(16 L) = 2^(32 W)); they differ only in how the digits are laid out, so
a JAX limb array (a field element, or a curve point in the same coordinate
order) becomes port words without arithmetic.  Where L is odd (P-256:
R = 2^272 in the JAX package, 2^288 in the port) the conversion also
multiplies each Montgomery form by 2^(32 W - 16 L) mod p, or divides it back.
These functions take the JAX package's data as numpy arrays and Python ints,
never JAX objects, so the port imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np

from crypto_primitives_tpu_torch.models.commitment.pedersen import PedersenCommitmentParameters
from crypto_primitives_tpu_torch.models.crh.bowe_hopwood import BoweHopwoodParameters
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


def bowe_hopwood_parameters(curve, generators) -> BoweHopwoodParameters:
    """The JAX package's Bowe-Hopwood generators (a list of windows, each a
    list of host (x, y) int tuples) -> the port's BoweHopwoodParameters."""
    return BoweHopwoodParameters(curve, [_points(win) for win in generators])


def commitment_parameters(curve, randomness_generator, generators) -> PedersenCommitmentParameters:
    """The JAX package's Pedersen commitment parameters (blinding powers and
    window generators, host int tuples) -> the port's."""
    return PedersenCommitmentParameters(curve, _points(randomness_generator),
                                        [_points(win) for win in generators])


def _remap(x: np.ndarray, bits: int, n: int, factor: int, p: int) -> np.ndarray:
    """``(..., m)`` little-endian digits of ``bits`` bits, a value v per row,
    -> ``(..., n)`` 16-bit digits of v * factor mod p."""
    out = []
    for row in x.reshape(-1, x.shape[-1]).tolist():
        v = sum(int(d) << (bits * k) for k, d in enumerate(row)) * factor % p
        out.append([(v >> (16 * k)) & 0xFFFF for k in range(n)])
    return np.asarray(out, dtype=np.uint32).reshape(x.shape[:-1] + (n,))


def _rescaled(spec: FieldSpec | None) -> bool:
    """Whether the field's R differs between the two packages (L odd)."""
    return spec is not None and spec.num_digits != spec.num_limbs


def words_from_limbs(limbs, spec: FieldSpec | None = None, mont: bool = True) -> np.ndarray:
    """JAX limbs ``(..., L)`` of 16-bit digits (uint32) -> the port's
    ``(..., W)`` int32 words.  Pass the field's ``spec`` for a field whose L is
    odd: its values are re-laid on 2W digits, and Montgomery forms
    (``mont=True``) are multiplied by 2^(32 W - 16 L) mod p."""
    d = np.asarray(limbs).astype(np.uint32)
    if (d >> 16).any():
        raise ValueError("limbs must be 16-bit digits")
    if _rescaled(spec):
        if d.shape[-1] != spec.num_limbs:
            raise ValueError(f"expected {spec.num_limbs} limbs in the last axis, got {d.shape}")
        factor = pow(2, 16 * (spec.num_digits - spec.num_limbs), spec.p) if mont else 1
        d = _remap(d, 16, spec.num_digits, factor, spec.p)
    if d.shape[-1] % 2:
        raise ValueError(f"an odd digit count ({d.shape[-1]}) does not pair into 32-bit words")
    pairs = d.reshape(d.shape[:-1] + (d.shape[-1] // 2, 2))
    return (pairs[..., 0] | (pairs[..., 1] << 16)).astype(np.uint32).view(np.int32)


def limbs_from_words(words, spec: FieldSpec | None = None, mont: bool = True) -> np.ndarray:
    """The port's ``(..., W)`` int32 words -> JAX limbs ``(..., 2W)`` of
    16-bit digits (uint32); for a field whose L is odd, given its ``spec``,
    ``(..., L)`` limbs with Montgomery forms divided by 2^(32 W - 16 L)."""
    w = np.ascontiguousarray(np.asarray(words, dtype=np.int32)).view(np.uint32)
    if _rescaled(spec):
        factor = pow(2, -16 * (spec.num_digits - spec.num_limbs), spec.p) if mont else 1
        return _remap(w, 32, spec.num_limbs, factor, spec.p)
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
