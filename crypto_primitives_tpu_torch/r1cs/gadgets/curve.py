"""In-circuit twisted-Edwards and short-Weierstrass arithmetic.

Twin of ``crypto_primitives_tpu/r1cs/gadgets/curve.py``.  Replaces what
the reference's gadgets get from ark-r1cs-std's curve vars
(AffineVar with complete TE addition, scalar_mul_le,
precomputed_base_multiscalar_mul_le, TwoBit/ThreeBitCondNeg lookups —
used by src/crh/pedersen/constraints.rs:48-76, bowe_hopwood/constraints.rs:51-94,
signature/schnorr/constraints.rs:60-77, encryption/elgamal/constraints.rs:206-237).

Decomposition costs (documented deltas where we chose differently):
  * variable+variable complete addition: 6 constraints
    (u=x1x2, v=y1y2, w=uv, x3(1+dw)=s-u-v, y3(1-dw)=v-au with s free);
  * variable+constant addition: 3 (u, v become linear);
  * conditional constant add: 3 + 2 selects = 5 per bit;
  * 2-bit lookup: 1 constraint (ark: 2); 3-bit cond-neg lookup: +1.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from crypto_primitives_tpu_torch.ops.curve import TECurveSpec
from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem
from crypto_primitives_tpu_torch.r1cs.vars import Boolean, FpVar, UInt8


class TEAffineVar:
    """An affine TE point in the circuit (coordinates over the base field,
    which must equal the constraint field)."""

    def __init__(self, curve: TECurveSpec, x: FpVar, y: FpVar):
        self.curve = curve
        self.x = x
        self.y = y

    @property
    def value(self) -> Tuple[int, int]:
        return (self.x.value, self.y.value)

    @property
    def cs(self) -> ConstraintSystem:
        return self.x.cs

    @classmethod
    def constant(cls, cs: ConstraintSystem, curve: TECurveSpec, pt) -> "TEAffineVar":
        return cls(curve, FpVar.constant(cs, pt[0]), FpVar.constant(cs, pt[1]))

    @classmethod
    def new_witness(cls, cs: ConstraintSystem, curve: TECurveSpec, pt) -> "TEAffineVar":
        return cls(curve, FpVar.new_witness(cs, pt[0]), FpVar.new_witness(cs, pt[1]))

    @classmethod
    def new_input(cls, cs: ConstraintSystem, curve: TECurveSpec, pt) -> "TEAffineVar":
        return cls(curve, FpVar.new_input(cs, pt[0]), FpVar.new_input(cs, pt[1]))

    @classmethod
    def identity(cls, cs: ConstraintSystem, curve: TECurveSpec) -> "TEAffineVar":
        return cls.constant(cs, curve, (0, 1))

    def negate(self) -> "TEAffineVar":
        return TEAffineVar(self.curve, -self.x, self.y)

    def add(self, other: "TEAffineVar") -> "TEAffineVar":
        """Complete TE addition (6 constraints; 3 if either side constant)."""
        cs, curve = self.cs, self.curve
        u = self.x * other.x
        v = self.y * other.y
        w = u * v  # x1 x2 y1 y2
        s = (self.x + self.y) * (other.x + other.y) if not (
            self.x.const and self.y.const or other.x.const and other.y.const
        ) else None
        if s is None:
            # one side fully constant: x1y2+x2y1 is linear
            if other.x.const and other.y.const:
                num = self.x.scale(other.y.value) + self.y.scale(other.x.value)
            else:
                num = other.x.scale(self.y.value) + other.y.scale(self.x.value)
        else:
            num = s - u - v
        one = FpVar.constant(cs, 1)
        denom_x = one + w.scale(curve.d)
        denom_y = one - w.scale(curve.d)
        x3 = num.mul_by_inverse(denom_x)
        y3 = (v - u.scale(curve.a)).mul_by_inverse(denom_y)
        return TEAffineVar(curve, x3, y3)

    def double(self) -> "TEAffineVar":
        return self.add(self)

    @staticmethod
    def select(cond: Boolean, a: "TEAffineVar", b: "TEAffineVar") -> "TEAffineVar":
        return TEAffineVar(
            a.curve, FpVar.select(cond, a.x, b.x), FpVar.select(cond, a.y, b.y)
        )

    def conditional_add_constant(self, bit: Boolean, pt) -> "TEAffineVar":
        """self + bit * constant-point (5 constraints)."""
        added = self.add(TEAffineVar.constant(self.cs, self.curve, pt))
        return TEAffineVar.select(bit, added, self)

    def scalar_mul_le(self, bits: Sequence[Boolean]) -> "TEAffineVar":
        """Variable-base double-and-add over LSB-first bits (ark
        scalar_mul_le shape)."""
        cs, curve = self.cs, self.curve
        acc = TEAffineVar.identity(cs, curve)
        base = self
        for i, bit in enumerate(bits):
            acc = TEAffineVar.select(bit, acc.add(base), acc)
            if i + 1 < len(bits):
                base = base.double()
        return acc

    def enforce_equal(self, other: "TEAffineVar"):
        self.x.enforce_equal(other.x)
        self.y.enforce_equal(other.y)

    def is_eq(self, other: "TEAffineVar") -> Boolean:
        return self.x.is_eq(other.x) & self.y.is_eq(other.y)


class SWAffineVar:
    """In-circuit short-Weierstrass affine point {x, y, infinity} — twin of
    ark-r1cs-std short_weierstrass::AffineVar as consumed by the reference's
    SW absorb gadget (sponge/constraints/absorb.rs:118-141): sponge encoding
    is [x, y, infinity-as-field]."""

    def __init__(self, curve, x: FpVar, y: FpVar, infinity: Boolean):
        self.curve = curve
        self.x = x
        self.y = y
        self.infinity = infinity

    @property
    def value(self):
        """Host representation: affine (x, y) tuple, None at infinity."""
        return None if self.infinity.value else (self.x.value, self.y.value)

    @property
    def cs(self) -> ConstraintSystem:
        return self.x.cs


class SWProjectiveVar:
    """In-circuit SW point, projective (X:Y:Z) with the complete
    Renes-Costello-Batina addition law — twin of ark-r1cs-std
    short_weierstrass::ProjectiveVar (reference absorb impl:
    sponge/constraints/absorb.rs:142-166).  Same algebra as the batched
    device kernel (ops/curve_sw.py sw_add); 12 multiplicative constraints
    per variable+variable add (the a/3b/a^2 const-muls are free scales)."""

    def __init__(self, curve, X: FpVar, Y: FpVar, Z: FpVar):
        self.curve = curve
        self.X = X
        self.Y = Y
        self.Z = Z

    @property
    def cs(self) -> ConstraintSystem:
        return self.X.cs

    @classmethod
    def constant(cls, cs: ConstraintSystem, curve, pt) -> "SWProjectiveVar":
        x, y, z = (0, 1, 0) if pt is None else (pt[0], pt[1], 1)
        return cls(curve, FpVar.constant(cs, x), FpVar.constant(cs, y),
                   FpVar.constant(cs, z))

    @classmethod
    def new_witness(cls, cs: ConstraintSystem, curve, pt) -> "SWProjectiveVar":
        x, y, z = (0, 1, 0) if pt is None else (pt[0], pt[1], 1)
        return cls(curve, FpVar.new_witness(cs, x), FpVar.new_witness(cs, y),
                   FpVar.new_witness(cs, z))

    @classmethod
    def identity(cls, cs: ConstraintSystem, curve) -> "SWProjectiveVar":
        return cls.constant(cs, curve, None)

    @property
    def value(self):
        """Affine host value ((x, y) tuple, None at infinity)."""
        p = self.cs.field.p
        if self.Z.value == 0:
            return None
        zinv = pow(self.Z.value, -1, p)
        return (self.X.value * zinv % p, self.Y.value * zinv % p)

    def negate(self) -> "SWProjectiveVar":
        return SWProjectiveVar(self.curve, self.X, -self.Y, self.Z)

    def add(self, other: "SWProjectiveVar") -> "SWProjectiveVar":
        """Complete RCB Algorithm 1 (arbitrary a), valid for identity and
        doubling inputs alike."""
        curve = self.curve
        p = curve.base.p
        a = curve.a
        b3 = 3 * curve.b % p
        a2 = a * a % p
        X1, Y1, Z1 = self.X, self.Y, self.Z
        X2, Y2, Z2 = other.X, other.Y, other.Z
        m0 = X1 * X2
        m1 = Y1 * Y2
        m2 = Z1 * Z2
        s_xy = (X1 + Y1) * (X2 + Y2) - m0 - m1  # X1Y2 + X2Y1
        s_xz = (X1 + Z1) * (X2 + Z2) - m0 - m2  # X1Z2 + X2Z1
        s_yz = (Y1 + Z1) * (Y2 + Z2) - m1 - m2  # Y1Z2 + Y2Z1
        zp = m2.scale(b3) + s_xz.scale(a)  # b3*t2 + a*t4
        u = m1 - zp
        v = m1 + zp
        t1p = m0.scale(3) + m2.scale(a)  # 3*t0 + a*t2
        t4p = s_xz.scale(b3) + m0.scale(a) - m2.scale(a2)  # b3*t4 + a*(t0-a*t2)
        y3 = u * v + t1p * t4p
        x3 = s_xy * u - s_yz * t4p
        z3 = s_yz * v + s_xy * t1p
        return SWProjectiveVar(curve, x3, y3, z3)

    def double(self) -> "SWProjectiveVar":
        return self.add(self)

    @staticmethod
    def select(cond: Boolean, a: "SWProjectiveVar", b: "SWProjectiveVar") -> "SWProjectiveVar":
        return SWProjectiveVar(
            a.curve,
            FpVar.select(cond, a.X, b.X),
            FpVar.select(cond, a.Y, b.Y),
            FpVar.select(cond, a.Z, b.Z),
        )

    def conditional_add_constant(self, bit: Boolean, pt) -> "SWProjectiveVar":
        added = self.add(SWProjectiveVar.constant(self.cs, self.curve, pt))
        return SWProjectiveVar.select(bit, added, self)

    def scalar_mul_le(self, bits: Sequence[Boolean]) -> "SWProjectiveVar":
        cs, curve = self.cs, self.curve
        acc = SWProjectiveVar.identity(cs, curve)
        base = self
        for i, bit in enumerate(bits):
            acc = SWProjectiveVar.select(bit, acc.add(base), acc)
            if i + 1 < len(bits):
                base = base.double()
        return acc

    def to_affine(self) -> SWAffineVar:
        """ark-r1cs-std ProjectiveVar::to_affine semantics: the infinity
        representative is (x, y) = (0, 1) with the infinity Boolean set
        (upstream uses (zero, one) there, NOT the native Affine identity's
        (0, 0) — the reference never pins identity absorb parity either,
        its consistency test only absorbs random non-identity points,
        sponge/constraints/absorb.rs:270-311)."""
        cs = self.cs
        p = cs.field.p
        inf = self.Z.is_eq(FpVar.constant(cs, 0))
        if self.Z.const:
            if self.Z.value == 0:
                return SWAffineVar(
                    self.curve, FpVar.constant(cs, 0), FpVar.constant(cs, 1), inf
                )
            zinv = FpVar.constant(cs, pow(self.Z.value, -1, p))
            return SWAffineVar(self.curve, self.X * zinv, self.Y * zinv, inf)
        # witness z^-1 (0 at infinity); enforce Z * zinv == 1 - infinity
        zinv_val = pow(self.Z.value, -1, p) if self.Z.value else 0
        zinv = FpVar.new_witness(cs, zinv_val)
        cs.enforce(self.Z.lc, zinv.lc, (FpVar.constant(cs, 1) - inf.fp).lc)
        x = FpVar.select(inf, FpVar.constant(cs, 0), self.X * zinv)
        y = FpVar.select(inf, FpVar.constant(cs, 1), self.Y * zinv)
        return SWAffineVar(self.curve, x, y, inf)

    def enforce_equal(self, other: "SWProjectiveVar"):
        """Projective equality: cross-multiplied coordinates match."""
        (self.X * other.Z).enforce_equal(other.X * self.Z)
        (self.Y * other.Z).enforce_equal(other.Y * self.Z)


def precomputed_base_multiscalar_mul_le(
    cs: ConstraintSystem, curve, tables, bits: Sequence[Boolean]
):
    """sum over windows/powers of bit-conditional constant adds — the ark
    precomputed_base_multiscalar_mul_le twin used by the Pedersen gadget
    (crh/pedersen/constraints.rs:48-76).  `tables` = generators[w][j] host
    points, flattened window-major alongside the bit order.  Generic over
    the curve family (TE affine vars / SW projective vars), mirroring the
    reference gadget's genericity over CurveVar."""
    flat = [g for win in tables for g in win]
    if len(bits) > len(flat):
        raise ValueError(f"{len(bits)} bits for {len(flat)} generators")
    if isinstance(curve, TECurveSpec):
        acc = TEAffineVar.identity(cs, curve)
    else:
        acc = SWProjectiveVar.identity(cs, curve)
    for bit, pt in zip(bits, flat):
        acc = acc.conditional_add_constant(bit, pt)
    return acc


def two_bit_lookup(cs: ConstraintSystem, b0: Boolean, b1: Boolean, consts: List[int]) -> FpVar:
    """c[b0 + 2*b1] via one multiplicative constraint (ark TwoBitLookupGadget
    twin; our decomposition costs 1 vs ark's 2)."""
    c0, c1, c2, c3 = [c % cs.field.p for c in consts]
    t = (b0 & b1).fp  # 1 constraint (free if either const)
    out = (
        FpVar.constant(cs, c0)
        + b0.fp.scale(c1 - c0)
        + b1.fp.scale(c2 - c0)
        + t.scale(c3 - c2 - c1 + c0)
    )
    return out


def three_bit_cond_neg_lookup(
    cs: ConstraintSystem, b0: Boolean, b1: Boolean, b2: Boolean, consts: List[int]
) -> FpVar:
    """lookup(b0,b1) * (1 - 2*b2) (ark ThreeBitCondNegLookupGadget twin)."""
    y = two_bit_lookup(cs, b0, b1, consts)
    return y - (b2.fp * y).scale(2)


def fpvar_to_bytes_le(v: FpVar, nbytes: int) -> List[UInt8]:
    """In-circuit `to_bytes` of a field element: full bit decomposition
    packed into UInt8s (the ToBytesGadget path that pedersen's compress
    uses, crh/pedersen/constraints.rs:91-130)."""
    cs = v.cs
    nbits = cs.field.nbits
    if 8 * nbytes < nbits:
        raise ValueError(f"a {nbits}-bit field element does not fit {nbytes} bytes")
    bits = v.to_bits_le(nbits)
    bits = bits + [Boolean.constant(cs, False)] * (8 * nbytes - nbits)
    return [UInt8(cs, bits[8 * i : 8 * i + 8]) for i in range(nbytes)]
