"""SNARK verifier-gadget layer: cross-field public-input packing.

Twin of ``crypto_primitives_tpu/r1cs/snark.py``, itself the twin of the reference's src/snark/constraints.rs.  The
reference defines the `SNARKGadget` trait (verify a SNARK inside another
circuit) plus two concrete input-conversion strategies; the conversions are
the concrete machinery (the trait itself carries no implementation):

  * `BooleanInputVar` (Groth16/GM17 style, :119-373): decompose F-elements
    into big-endian bit chunks, repack into CF-elements with capacity
    CF_bits or CF_bits-1 depending on the modulus comparison, allocate the
    CF elements as circuit inputs, unpack back to per-F bit vectors.
  * `EmulatedFieldInputVar` (Marlin style, :378-656): allocate inputs as
    base-2^b limb variables plus a Boolean decomposition, with one linear
    consistency constraint per limb.
"""

from __future__ import annotations

from typing import List

from crypto_primitives_tpu_torch.ops.field import FieldSpec
from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem, LinearCombination
from crypto_primitives_tpu_torch.r1cs.vars import Boolean, FpVar


def _capacity(cf: FieldSpec, f: FieldSpec, cf_side: bool = True) -> int:
    """Packing capacity rule (constraints.rs:206-232 / :282-307)."""
    big, small = (cf, f) if cf_side else (f, cf)
    if cf.nbits == f.nbits:
        return big.nbits if big.p >= small.p else big.nbits - 1
    return big.nbits - 1


def _elem_bits_be(value: int, nbits: int) -> List[bool]:
    bits = [bool((value >> i) & 1) for i in range(nbits)]  # LE
    bits.reverse()
    return bits


def repack_input(src: List[int], f: FieldSpec, cf: FieldSpec) -> List[int]:
    """Host-side `repack_input` (constraints.rs:266-318): F elements ->
    CF elements via big-endian bit chunks of the capacity."""
    src_bits: List[bool] = []
    for v in src:
        src_bits.extend(_elem_bits_be(int(v), f.nbits))
    cap = _capacity(cf, f, cf_side=True)
    out = []
    for i in range(0, len(src_bits), cap):
        chunk = src_bits[i : i + cap]
        val = 0
        for b in chunk:  # big-endian
            val = (val << 1) | int(b)
        out.append(val)
    return out


class BooleanInputVar:
    """val: per-F-element little-endian Boolean vectors."""

    def __init__(self, val: List[List[Boolean]], f: FieldSpec):
        self.val = val
        self.f = f

    @classmethod
    def new_witness(cls, cs: ConstraintSystem, values: List[int], f: FieldSpec) -> "BooleanInputVar":
        """constraints.rs:144-178: direct per-element bit allocation."""
        res = []
        for v in values:
            res.append(
                [Boolean.new_witness(cs, bool((int(v) >> i) & 1)) for i in range(f.nbits)]
            )
        return cls(res, f)

    @classmethod
    def new_input(cls, cs: ConstraintSystem, values: List[int], f: FieldSpec) -> "BooleanInputVar":
        """constraints.rs:180-263: allocate packed CF elements as *inputs*,
        decompose in-circuit, unpack to per-F bit vectors."""
        cf = cs.field
        src_bits: List[bool] = []
        for v in values:
            src_bits.extend(_elem_bits_be(int(v), f.nbits))
        cap = _capacity(cf, f, cf_side=True)
        src_booleans: List[Boolean] = []
        for i in range(0, len(src_bits), cap):
            chunk = src_bits[i : i + cap]
            val = 0
            for b in chunk:
                val = (val << 1) | int(b)
            elem = FpVar.new_input(cs, val)
            booleans = elem.to_bits_le(cf.nbits)
            booleans = booleans[: len(chunk)]
            booleans.reverse()
            src_booleans.extend(booleans)
        res = []
        for i in range(0, len(src_booleans), f.nbits):
            chunk = list(src_booleans[i : i + f.nbits])
            chunk.reverse()
            res.append(chunk)
        return cls(res, f)

    @classmethod
    def from_field_elements(cls, src: List[FpVar], f: FieldSpec) -> "BooleanInputVar":
        """constraints.rs:320-373: CF field vars -> per-F bit groups."""
        cs = src[0].cs
        cf = cs.field
        src_booleans: List[Boolean] = []
        for elem in src:
            bits = elem.to_bits_le(cf.nbits)
            bits.reverse()
            src_booleans.extend(bits)
        cap = _capacity(cf, f, cf_side=False)
        res = []
        for i in range(0, len(src_booleans), cap):
            chunk = list(src_booleans[i : i + cap])
            chunk.reverse()
            res.append(chunk)
        return cls(res, f)

    def values(self) -> List[int]:
        return [
            sum(int(b.value) << i for i, b in enumerate(bits)) for bits in self.val
        ]


class EmulatedFpVar:
    """An F element emulated in a CF circuit as base-2^limb_bits limbs
    (simplified ark EmulatedFpVar twin: value semantics + the limb/bit
    consistency constraints the reference's input allocation adds,
    constraints.rs:420-538)."""

    LIMB_BITS = 64

    def __init__(self, cs: ConstraintSystem, f: FieldSpec, limbs: List[FpVar]):
        self.cs = cs
        self.f = f
        self.limbs = limbs  # little-endian

    @property
    def value(self) -> int:
        v = 0
        for i, l in enumerate(self.limbs):
            v |= l.value << (self.LIMB_BITS * i)
        return v % self.f.p

    @classmethod
    def new_input_with_bit_consistency(cls, cs: ConstraintSystem, value: int,
                                       f: FieldSpec) -> "EmulatedFpVar":
        """Allocate limbs as inputs, a Boolean decomposition as witness, and
        one linear consistency constraint per limb (constraints.rs:420-538)."""
        nlimbs = -(-f.nbits // cls.LIMB_BITS)
        limbs = []
        p_cf = cs.field.p
        for i in range(nlimbs):
            limb_val = (int(value) >> (cls.LIMB_BITS * i)) & ((1 << cls.LIMB_BITS) - 1)
            limb = FpVar.new_input(cs, limb_val)
            bits = [
                Boolean.new_witness(cs, bool((limb_val >> j) & 1))
                for j in range(min(cls.LIMB_BITS, f.nbits - cls.LIMB_BITS * i))
            ]
            acc = LinearCombination()
            for j, b in enumerate(bits):
                acc = acc.add(b.fp.lc.scale(1 << j, p_cf), p_cf)
            cs.enforce(acc, LinearCombination.constant(1, p_cf), limb.lc)
            limbs.append(limb)
        return cls(cs, f, limbs)


class EmulatedFieldInputVar:
    """Marlin-style input allocation (constraints.rs:378-656)."""

    def __init__(self, val: List[EmulatedFpVar]):
        self.val = val

    @classmethod
    def new_input(cls, cs: ConstraintSystem, values: List[int], f: FieldSpec) -> "EmulatedFieldInputVar":
        return cls([EmulatedFpVar.new_input_with_bit_consistency(cs, v, f) for v in values])

    def values(self) -> List[int]:
        return [v.value for v in self.val]
