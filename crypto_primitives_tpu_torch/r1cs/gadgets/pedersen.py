"""Pedersen CRH / commitment gadgets and the Bowe-Hopwood gadget.

Twin of ``crypto_primitives_tpu/r1cs/gadgets/pedersen.py``, itself the twin
of the reference's:
  * src/crh/pedersen/constraints.rs (CRHGadget via
    precomputed_base_multiscalar_mul_le over the same window tables;
    parameters allocated as constants — no constraints);
  * src/commitment/pedersen/constraints.rs (message MSM + blinding term
    over randomness bits; RandomnessVar = serialized scalar bytes);
  * src/crh/bowe_hopwood/constraints.rs (3-bit signed-digit chunks via
    TwoBitLookup + ThreeBitCondNegLookup; returns only x; input-size
    guard panics, :56-64);
  * src/crh/injective_map/constraints.rs (TECompressorGadget returns .x).
"""

from __future__ import annotations

from typing import List, Sequence

from crypto_primitives_tpu_torch.models.crh.bowe_hopwood import CHUNK_SIZE, BoweHopwoodParameters
from crypto_primitives_tpu_torch.models.crh.pedersen import PedersenParameters, Window
from crypto_primitives_tpu_torch.ops.curve import TECurveSpec
from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem
from crypto_primitives_tpu_torch.r1cs.gadgets.curve import (
    TEAffineVar,
    fpvar_to_bytes_le,
    precomputed_base_multiscalar_mul_le,
    three_bit_cond_neg_lookup,
    two_bit_lookup,
)
from crypto_primitives_tpu_torch.r1cs.vars import Boolean, FpVar, UInt8, uint8s_to_bits_le


def _pad_input_bytes(cs: ConstraintSystem, input_: List[UInt8], nbytes: int) -> List[UInt8]:
    if len(input_) > nbytes:
        raise ValueError(f"{len(input_)} input bytes for a {nbytes}-byte window")
    return list(input_) + [UInt8.constant(cs, 0)] * (nbytes - len(input_))


class PedersenCRHGadget:
    def __init__(self, curve: TECurveSpec, window: Window):
        self.curve = curve
        self.window = window
        self.input_size_bits = window.window_size * window.num_windows

    def evaluate(self, cs: ConstraintSystem, params: PedersenParameters,
                 input_: List[UInt8]) -> TEAffineVar:
        """pedersen/constraints.rs:48-76."""
        if len(input_) * 8 > self.input_size_bits:
            raise ValueError("incorrect input length")
        padded = _pad_input_bytes(cs, input_, self.input_size_bits // 8)
        bits = uint8s_to_bits_le(padded)
        return precomputed_base_multiscalar_mul_le(
            cs, self.curve, params.generators, bits
        )


class PedersenTwoToOneCRHGadget:
    """pedersen/constraints.rs:91-130."""

    def __init__(self, curve: TECurveSpec, window: Window):
        self.curve = curve
        self.window = window
        self.crh = PedersenCRHGadget(curve, window)
        self.half_input_bytes = self.crh.input_size_bits // 16

    def evaluate(self, cs, params, left: List[UInt8], right: List[UInt8]) -> TEAffineVar:
        if len(left) != len(right):
            raise ValueError("left and right inputs must have the same length")
        if len(left) * 8 > self.crh.input_size_bits // 2:
            raise ValueError("incorrect input length")
        # halves are concatenated contiguously; zero-padding only at the end
        # (matches the native buffer layout, crh/pedersen/mod.rs:174-181)
        return self.crh.evaluate(cs, params, list(left) + list(right))

    def compress(self, cs, params, left: TEAffineVar, right: TEAffineVar) -> TEAffineVar:
        """Prior digests -> uncompressed x||y bytes in-circuit."""
        nb = self.curve.base.bigint_bytes
        lb = fpvar_to_bytes_le(left.x, nb) + fpvar_to_bytes_le(left.y, nb)
        rb = fpvar_to_bytes_le(right.x, nb) + fpvar_to_bytes_le(right.y, nb)
        return self.evaluate(cs, params, lb, rb)


class PedersenCommitmentGadget:
    """commitment/pedersen/constraints.rs:56-95."""

    def __init__(self, curve: TECurveSpec, window: Window):
        self.curve = curve
        self.window = window
        self.crh = PedersenCRHGadget(curve, window)

    def randomness_bits(self, cs: ConstraintSystem, randomness: int) -> List[Boolean]:
        """RandomnessVar = serialized scalar bytes -> bits (:117-139)."""
        nbytes = self.curve.scalar.compressed_bytes
        data = int(randomness).to_bytes(nbytes, "little")
        bits: List[Boolean] = []
        for byte in data:
            for i in range(8):
                bits.append(Boolean.new_witness(cs, bool((byte >> i) & 1)))
        return bits

    def commit(self, cs, params, input_: List[UInt8], randomness_bits: Sequence[Boolean]) -> TEAffineVar:
        crh_params = PedersenParameters(self.curve, params.generators)
        msg = self.crh.evaluate(cs, crh_params, input_)
        acc = msg
        for bit, power in zip(randomness_bits, params.randomness_generator):
            acc = acc.conditional_add_constant(bit, power)
        return acc


class BoweHopwoodCRHGadget:
    """bowe_hopwood/constraints.rs:51-94; output = x-coordinate only."""

    def __init__(self, curve: TECurveSpec, window: Window):
        self.curve = curve
        self.window = window
        self.input_size_bits = window.window_size * window.num_windows * CHUNK_SIZE

    def evaluate(self, cs: ConstraintSystem, params: BoweHopwoodParameters,
                 input_: List[UInt8]) -> FpVar:
        if len(input_) * 8 > self.input_size_bits:
            raise ValueError(
                f"incorrect input bitlength {len(input_) * 8} for window params "
                f"{self.window.window_size}x{self.window.num_windows}x{CHUNK_SIZE}"
            )
        bits = uint8s_to_bits_le(input_)
        if len(bits) % CHUNK_SIZE != 0:
            bits += [Boolean.constant(cs, False)] * (CHUNK_SIZE - len(bits) % CHUNK_SIZE)
        acc = None  # accumulate points via full adds
        seg_bits = self.window.window_size * CHUNK_SIZE
        for w in range(0, len(bits), seg_bits):
            segment = bits[w : w + seg_bits]
            for j in range(0, len(segment), CHUNK_SIZE):
                chunk = segment[j : j + CHUNK_SIZE]
                gen = params.generators[w // seg_bits][j // CHUNK_SIZE]
                # tables of 1g..4g
                g2 = self.curve.double_host(gen)
                g3 = self.curve.add_host(g2, gen)
                g4 = self.curve.double_host(g2)
                xs = [gen[0], g2[0], g3[0], g4[0]]
                ys = [gen[1], g2[1], g3[1], g4[1]]
                # TE negation flips x and keeps y: the sign bit cond-negates
                # the x lookup, y is a plain 2-bit lookup
                x = three_bit_cond_neg_lookup(cs, chunk[0], chunk[1], chunk[2], xs)
                y = two_bit_lookup(cs, chunk[0], chunk[1], ys)
                pt = TEAffineVar(self.curve, x, y)
                acc = pt if acc is None else acc.add(pt)
        return acc.x


class BoweHopwoodTwoToOneCRHGadget:
    """bowe_hopwood/constraints.rs TwoToOneCRHGadget twin: halves concatenated
    then hashed; compress serializes the prior x-coordinates in-circuit."""

    def __init__(self, curve: TECurveSpec, window: Window):
        self.curve = curve
        self.crh = BoweHopwoodCRHGadget(curve, window)

    def evaluate(self, cs, params, left: List[UInt8], right: List[UInt8]) -> FpVar:
        if len(left) != len(right):
            raise ValueError("left and right inputs must have the same length")
        # the native two-to-one fills a FULL-capacity zero buffer
        # (bowe_hopwood/mod.rs:219-226), so trailing zero chunks are present
        combined = _pad_input_bytes(
            cs, list(left) + list(right), self.crh.input_size_bits // 8
        )
        return self.crh.evaluate(cs, params, combined)

    def compress(self, cs, params, left: FpVar, right: FpVar) -> FpVar:
        nb = self.curve.base.bigint_bytes
        return self.evaluate(
            cs, params, fpvar_to_bytes_le(left, nb), fpvar_to_bytes_le(right, nb)
        )


class PedersenCommitmentCompressorGadget:
    """commitment/injective_map/constraints.rs:20-58 twin."""

    def __init__(self, curve: TECurveSpec, window: Window):
        self.inner = PedersenCommitmentGadget(curve, window)

    def randomness_bits(self, cs, randomness):
        return self.inner.randomness_bits(cs, randomness)

    def commit(self, cs, params, input_, randomness_bits) -> FpVar:
        return self.inner.commit(cs, params, input_, randomness_bits).x


class TECompressorGadget:
    """injective_map/constraints.rs:22-51: x-coordinate of a point var."""

    @staticmethod
    def injective_map(pt: TEAffineVar) -> FpVar:
        return pt.x


class PedersenCRHCompressorGadget:
    """injective_map/constraints.rs:53-159."""

    def __init__(self, curve: TECurveSpec, window: Window):
        self.crh = PedersenCRHGadget(curve, window)

    def evaluate(self, cs, params, input_: List[UInt8]) -> FpVar:
        return TECompressorGadget.injective_map(self.crh.evaluate(cs, params, input_))
