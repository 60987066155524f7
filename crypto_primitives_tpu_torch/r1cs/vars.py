"""Gadget variables: FpVar, Boolean, UInt8, UInt32.

Twin of ``crypto_primitives_tpu/r1cs/vars.py``: behavioral twins of the
ark-r1cs-std types every reference constraints.rs builds on, with matching constraint-count decompositions:

  * linear ops (add/sub/scale/constant ops) are free;
  * a nonlinear mul of two non-constant FpVars costs 1 constraint;
  * allocating a Boolean costs 1 booleanity constraint;
  * Boolean xor of two variables costs 1 constraint; with a constant, 0;
  * UIntN addmany converts to the field, adds linearly, and bit-decomposes
    the result to N + ceil(log2(k)) bits (1 booleanity each + 1 packing
    constraint) — the decomposition whose counts reproduce the reference's
    pinned 21792-constraint Blake2s block
    (the reference's src/prf/blake2s/constraints.rs:416).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem, LinearCombination


class FpVar:
    """A field element in the circuit: constant or linear combination."""

    __slots__ = ("cs", "lc", "value", "const")

    def __init__(self, cs: Optional[ConstraintSystem], lc: Optional[LinearCombination],
                 value: int, const: bool):
        self.cs = cs
        self.lc = lc
        self.value = value
        self.const = const

    # -- constructors --

    @classmethod
    def constant(cls, cs: ConstraintSystem, value: int) -> "FpVar":
        value %= cs.field.p
        return cls(cs, LinearCombination.constant(value, cs.field.p), value, True)

    @classmethod
    def new_input(cls, cs: ConstraintSystem, value) -> "FpVar":
        idx = cs.new_input(value)
        return cls(cs, LinearCombination.single(idx), cs.assignments[idx], False)

    @classmethod
    def new_witness(cls, cs: ConstraintSystem, value) -> "FpVar":
        idx = cs.new_witness(value)
        return cls(cs, LinearCombination.single(idx), cs.assignments[idx], False)

    # -- linear ops (free) --

    def __add__(self, other: "FpVar") -> "FpVar":
        p = self.cs.field.p
        return FpVar(
            self.cs,
            self.lc.add(other.lc, p),
            self.cs.v_add(self.value, other.value),
            self.const and other.const,
        )

    def __sub__(self, other: "FpVar") -> "FpVar":
        p = self.cs.field.p
        return self + other.scale(p - 1)

    def __neg__(self) -> "FpVar":
        return self.scale(self.cs.field.p - 1)

    def scale(self, c: int) -> "FpVar":
        p = self.cs.field.p
        return FpVar(self.cs, self.lc.scale(c, p), self.cs.v_scale(self.value, c), self.const)

    def add_constant(self, c: int) -> "FpVar":
        return self + FpVar.constant(self.cs, c)

    # -- nonlinear --

    def __mul__(self, other: "FpVar") -> "FpVar":
        cs, p = self.cs, self.cs.field.p
        if self.const:
            return other.scale(self.value)
        if other.const:
            return self.scale(other.value)
        return self._product(other, cs.v_mul(self.value, other.value))

    def _product(self, other: "FpVar", value) -> "FpVar":
        """self * other for variable operands, whose product's value is
        ``value``: one witness, one constraint."""
        out = FpVar.new_witness(self.cs, value)
        self.cs.enforce(self.lc, other.lc, out.lc)
        return out

    def square(self) -> "FpVar":
        return self * self

    def pow_by_constant(self, e: int) -> "FpVar":
        """Square-and-multiply (ark FpVar::pow_by_constant); the s-box path
        in the Poseidon gadget (src/sponge/poseidon/constraints.rs:66-80)."""
        return FpVar.pow_by_constant_many([self], e)[0]

    @staticmethod
    def pow_by_constant_many(xs: Sequence["FpVar"], e: int) -> List["FpVar"]:
        """``[x.pow_by_constant(e) for x in xs]``, each square-and-multiply
        step's values computed for every variable x at once
        (``cs.v_mul_many``): per variable x, one witness and one constraint
        a step, in chain order; a constant x stays constant."""
        if e < 1:
            raise ValueError("exponent must be >= 1")
        bits = bin(e)[3:]
        var = [x for x in xs if not x.const]
        steps = []  # the values of every product of the chain, for every variable x
        if var:
            cs = var[0].cs
            base = acc = [x.value for x in var]
            for b in bits:
                acc = cs.v_mul_many(acc, acc)
                steps.append(acc)
                if b == "1":
                    acc = cs.v_mul_many(acc, base)
                    steps.append(acc)
        out, k = [], 0
        for x in xs:
            cur = x
            if x.const:
                for b in bits:
                    cur = cur * cur
                    if b == "1":
                        cur = cur * x
            else:
                vals = iter(step[k] for step in steps)
                for b in bits:
                    cur = cur._product(cur, next(vals))
                    if b == "1":
                        cur = cur._product(x, next(vals))
                k += 1
            out.append(cur)
        return out

    def inverse(self) -> "FpVar":
        cs, p = self.cs, self.cs.field.p
        if self.const:
            return FpVar.constant(cs, pow(self.value, -1, p))
        out = FpVar.new_witness(cs, cs.v_inv0(self.value))
        cs.enforce(self.lc, out.lc, LinearCombination.constant(1, p))
        return out

    def mul_by_inverse(self, other: "FpVar") -> "FpVar":
        """self / other, one constraint: out * other = self."""
        cs, p = self.cs, self.cs.field.p
        if other.const:
            return self.scale(pow(other.value, -1, p))
        q = cs.v_mul(self.value, cs.v_inv0(other.value))
        out = FpVar.new_witness(cs, q)
        cs.enforce(out.lc, other.lc, self.lc)
        return out

    # -- comparisons / selection --

    def enforce_equal(self, other: "FpVar"):
        p = self.cs.field.p
        self.cs.enforce(
            (self - other).lc,
            LinearCombination.constant(1, p),
            LinearCombination.constant(0, p),
        )

    def is_eq(self, other: "FpVar") -> "Boolean":
        """ark EqGadget::is_eq: allocate is_eq bit + inverse witness."""
        cs, p = self.cs, self.cs.field.p
        d = self - other
        if d.const:
            return Boolean.constant(cs, d.value == 0)
        eq = cs.v_is_zero(d.value)
        b = Boolean.new_witness(cs, eq)
        # d * b == 0 ; d * inv + b == 1  (inv arbitrary when d == 0; the
        # witness convention is inverse-or-zero, batch-identical)
        iv = FpVar.new_witness(cs, cs.v_inv0(d.value))
        cs.enforce(d.lc, b.fp.lc, LinearCombination.constant(0, p))
        cs.enforce(d.lc, iv.lc, (FpVar.constant(cs, 1) - b.fp).lc)
        return b

    @staticmethod
    def select(cond: "Boolean", a: "FpVar", b: "FpVar") -> "FpVar":
        """cond ? a : b = b + cond*(a-b): 1 constraint (0 if cond const)."""
        if cond.const:
            return a if cond.value else b
        return b + cond.fp * (a - b)

    # -- bit decomposition --

    def to_bits_le(self, nbits: Optional[int] = None) -> List["Boolean"]:
        """Allocate the LE bit decomposition: 1 booleanity per bit + 1
        packing constraint (ark to_bits_le shape)."""
        cs, p = self.cs, self.cs.field.p
        if nbits is None:
            nbits = cs.field.nbits
        if self.const:
            return [Boolean.constant(cs, bool((self.value >> i) & 1)) for i in range(nbits)]
        bits = [Boolean.new_witness(cs, b) for b in cs.v_bits(self.value, nbits)]
        acc = LinearCombination()
        for i, b in enumerate(bits):
            acc = acc.add(b.fp.lc.scale(1 << i, p), p)
        cs.enforce(acc, LinearCombination.constant(1, p), self.lc)
        return bits


class Boolean:
    """A 0/1 circuit value (ark Boolean twin)."""

    __slots__ = ("cs", "fp", "value", "const")

    def __init__(self, cs: ConstraintSystem, fp: FpVar, value, const: bool):
        self.cs = cs
        self.fp = fp
        self.value = cs.v_bool(value)
        self.const = const

    @classmethod
    def constant(cls, cs: ConstraintSystem, value: bool) -> "Boolean":
        return cls(cs, FpVar.constant(cs, int(bool(value))), value, True)

    @classmethod
    def new_witness(cls, cs: ConstraintSystem, value) -> "Boolean":
        fp = FpVar.new_witness(cs, cs.v_from_bool(value))
        one = FpVar.constant(cs, 1)
        cs.enforce(fp.lc, (one - fp).lc, LinearCombination.constant(0, cs.field.p))
        return cls(cs, fp, value, False)

    @classmethod
    def new_input(cls, cs: ConstraintSystem, value) -> "Boolean":
        fp = FpVar.new_input(cs, cs.v_from_bool(value))
        one = FpVar.constant(cs, 1)
        cs.enforce(fp.lc, (one - fp).lc, LinearCombination.constant(0, cs.field.p))
        return cls(cs, fp, value, False)

    def not_(self) -> "Boolean":
        one = FpVar.constant(self.cs, 1)
        return Boolean(self.cs, one - self.fp, self.cs.v_not(self.value), self.const)

    def __and__(self, other: "Boolean") -> "Boolean":
        if self.const:
            return other if self.value else Boolean.constant(self.cs, False)
        if other.const:
            return self if other.value else Boolean.constant(self.cs, False)
        fp = self.fp * other.fp
        return Boolean(self.cs, fp, self.cs.v_and(self.value, other.value), False)

    def __or__(self, other: "Boolean") -> "Boolean":
        return (self.not_() & other.not_()).not_()

    def __xor__(self, other: "Boolean") -> "Boolean":
        """var^var: 1 constraint; anything with a constant: free
        (ark Boolean::xor semantics — the count that matters for the
        Blake2s 21792 regression)."""
        cs = self.cs
        if self.const:
            return other.not_() if self.value else other
        if other.const:
            return self.not_() if other.value else self
        out = cs.v_xor(self.value, other.value)
        # result needs NO booleanity constraint: a+b-2ab of booleans is
        # boolean by construction (1 constraint total, matching ark)
        fp = FpVar.new_witness(cs, cs.v_from_bool(out))
        cs.enforce(
            self.fp.scale(2).lc,
            other.fp.lc,
            (self.fp + other.fp - fp).lc,
        )
        return Boolean(cs, fp, out, False)

    @staticmethod
    def select(cond: "Boolean", a: "Boolean", b: "Boolean") -> "Boolean":
        fp = FpVar.select(cond, a.fp, b.fp)
        val = cond.cs.v_select(cond.value, a.value, b.value)
        return Boolean(cond.cs, fp, val, fp.const)


def _bits_value(bits: Sequence[Boolean]) -> int:
    return sum(int(b.value) << i for i, b in enumerate(bits))


class UIntN:
    """N-bit word as LE Booleans (ark UInt8/UInt32 twin).

    Values may be python ints (scalar tier) or (batch,) arrays
    (BatchConstraintSystem byte-circuit tier): allocation, packing, and
    selection all route through the ``v_word_*``/``v_select`` hooks."""

    N = 0

    def __init__(self, cs: ConstraintSystem, bits: List[Boolean]):
        if len(bits) != self.N:
            raise ValueError(f"a UInt{self.N} takes {self.N} bits")
        self.cs = cs
        self.bits = bits

    @property
    def value(self):
        return self.cs.v_pack_word([b.value for b in self.bits])

    @classmethod
    def constant(cls, cs: ConstraintSystem, value: int):
        return cls(cs, [Boolean.constant(cs, bool((value >> i) & 1)) for i in range(cls.N)])

    @classmethod
    def new_witness(cls, cs: ConstraintSystem, value):
        return cls(cs, [Boolean.new_witness(cs, b) for b in cs.v_word_bits(value, cls.N)])

    @classmethod
    def new_input(cls, cs: ConstraintSystem, value):
        return cls(cs, [Boolean.new_input(cs, b) for b in cs.v_word_bits(value, cls.N)])

    def __xor__(self, other):
        return type(self)(self.cs, [a ^ b for a, b in zip(self.bits, other.bits)])

    def __and__(self, other):
        return type(self)(self.cs, [a & b for a, b in zip(self.bits, other.bits)])

    def not_(self):
        return type(self)(self.cs, [b.not_() for b in self.bits])

    def rotr(self, n: int):
        """Rotate right by n: free (bit relabeling)."""
        n %= self.N
        return type(self)(self.cs, self.bits[n:] + self.bits[:n])

    def shr(self, n: int):
        """Logical shift right: free; fills with constant 0 bits."""
        zero = Boolean.constant(self.cs, False)
        return type(self)(self.cs, self.bits[n:] + [zero] * min(n, self.N))

    def to_fp(self) -> FpVar:
        """Linear recomposition (free)."""
        p = self.cs.field.p
        acc = LinearCombination()
        const = True
        for i, b in enumerate(self.bits):
            acc = acc.add(b.fp.lc.scale(1 << i, p), p)
            const = const and b.const
        val = self.cs.v_word_to_field(
            self.cs.v_pack_word([b.value for b in self.bits])
        )
        return FpVar(self.cs, acc, val, const)

    @classmethod
    def addmany(cls, operands: Sequence["UIntN"]):
        """Modular addition of k words: linear field sum + (N + log2(k))-bit
        decomposition (ark UInt::addmany shape: 1 booleanity per result bit
        + 1 packing constraint)."""
        cs = operands[0].cs
        p = cs.field.p
        k = len(operands)
        if k < 1:
            raise ValueError("addmany takes at least one operand")
        total_fp = operands[0].to_fp()
        for op in operands[1:]:
            total_fp = total_fp + op.to_fp()
        nbits = cls.N + max(1, math.ceil(math.log2(k))) if k > 1 else cls.N
        if total_fp.const:
            return cls.constant(cs, total_fp.value % (1 << cls.N))
        bits = total_fp.to_bits_le(nbits)
        return cls(cs, bits[: cls.N])

    @staticmethod
    def select(cond: Boolean, a: "UIntN", b: "UIntN"):
        return type(a)(a.cs, [Boolean.select(cond, x, y) for x, y in zip(a.bits, b.bits)])


class UInt8(UIntN):
    N = 8


class UInt32(UIntN):
    N = 32


def bytes_to_uint8s(cs: ConstraintSystem, data, mode: str = "witness") -> List[UInt8]:
    """``data``: python bytes (scalar tier) or a (batch, n_bytes) uint8
    array (batched tier — column j becomes one UInt8 whose per-instance
    values are the column)."""
    ctor = {"witness": UInt8.new_witness, "input": UInt8.new_input, "constant": UInt8.constant}[mode]
    if not isinstance(data, (bytes, bytearray)):
        import numpy as _np

        arr = _np.asarray(data)
        if arr.ndim != 2:
            raise ValueError(f"batched bytes are (batch, n_bytes), got {arr.shape}")
        return [ctor(cs, arr[:, j]) for j in range(arr.shape[1])]
    return [ctor(cs, b) for b in data]


def uint8s_to_bits_le(bytes_: Sequence[UInt8]) -> List[Boolean]:
    """Concatenated LE bits (pedersen input convention,
    src/crh/pedersen/mod.rs:200-209)."""
    out = []
    for b in bytes_:
        out.extend(b.bits)
    return out
