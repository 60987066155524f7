"""Short-Weierstrass curve arithmetic: the host oracle and the batched PyTorch tier.

Twin of ``crypto_primitives_tpu/ops/curve_sw.py``.

  * Host tier: exact Python-int affine arithmetic, the identity as ``None``,
    with the JAX package's random-number consumption in ``rand_point`` and
    ark-serialize's SWFlags in the byte encodings (PointAtInfinity = 1 << 6,
    YIsNegative = 1 << 7 on the final byte).
  * Batched tier: homogeneous projective points (X, Y, Z) stacked as
    ``(..., 3, W)`` int32 Montgomery words; the identity is (0 : 1 : 0).
    Addition is the complete Renes-Costello-Batina law for any a (eprint
    2015/1060, Algorithm 1): identity, doubling and inverse pairs take the
    same steps.  Its 12 variable products run as two stacked Montgomery
    products of 6, plus one stacked product by the constants (a, 3b, a^2),
    with a*(t0 - a*t2) flattened to a*t0 - a^2*t2, as in the JAX package.
    Doubling, double-and-add scalar multiplication, the per-bit conditional
    sum and projective equality (infinity on either side included) are
    built on that one law, with the ``dev_*`` methods of the TE tier.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.ops import affine_kernel
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops.curve import (
    conditional_sum_digits,
    scalar_mul_bits_digits,
    tonelli,
    tree_sum_digits,
)
from crypto_primitives_tpu_torch.ops.field import FieldSpec


class SWCurveSpec:
    """y^2 = x^3 + a*x + b over the base field; prime-order subgroup of the
    scalar field's order.  Host points are affine (x, y) int tuples and the
    identity is None."""

    coords = 3

    def __init__(self, name: str, base: FieldSpec, scalar: FieldSpec, a: int, b: int,
                 cofactor: int, generator: Optional[Tuple[int, int]] = None):
        self.name = name
        self.base = base
        self.scalar = scalar
        self.a = a % base.p
        self.b = b % base.p
        self.cofactor = cofactor
        self.generator = generator
        self._tensors: dict = {}

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return f"SWCurveSpec({self.name})"

    # ------------- host tier (Python ints, affine; None = infinity) -----

    def zero_host(self):
        return None

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        p = self.base.p
        return y * y % p == (x * x % p * x + self.a * x + self.b) % p

    def add_host(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        p = self.base.p
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = (3 * x1 * x1 + self.a) * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return (x3, y3)

    def double_host(self, p1):
        return self.add_host(p1, p1)

    def neg_host(self, p1):
        if p1 is None:
            return None
        return (p1[0], (-p1[1]) % self.base.p)

    def scalar_mul_host(self, pt, k: int):
        """Scalar multiplication by k mod r."""
        return self.scalar_mul_host_any(pt, int(k) % self.scalar.p)

    def scalar_mul_host_any(self, pt, k: int):
        """Double-and-add by an arbitrary non-negative int (no reduction)."""
        acc, base = None, pt
        k = int(k)
        while k:
            if k & 1:
                acc = self.add_host(acc, base)
            base = self.double_host(base)
            k >>= 1
        return acc

    def sqrt_host(self, n: int) -> Optional[int]:
        return tonelli(n, self.base.p)

    def rand_point(self, rng):
        """A uniform point of the prime-order subgroup (random x, solve for
        y, clear the cofactor): the ``C::rand`` twin."""
        p = self.base.p
        while True:
            x = rng.randrange(p)
            rhs = (x * x % p * x + self.a * x + self.b) % p
            y = self.sqrt_host(rhs)
            if y is None:
                continue
            if rng.randrange(2):
                y = (-y) % p
            pt = self.scalar_mul_host_any((x, y), self.cofactor)
            if pt is not None:
                return pt

    # ------------- serialization (ark-serialize SWFlags) -------------

    @property
    def swflag_bytes(self) -> int:
        """buffer_byte_size(MODULUS_BIT_SIZE + 2): the flags take the top two
        bits of the last byte, so a 255-bit field serializes into 33 bytes."""
        return (self.base.nbits + 2 + 7) // 8

    def _field_with_flags(self, v: int, flags: int) -> bytes:
        data = bytearray(int(v).to_bytes(self.swflag_bytes, "little"))
        data[-1] |= flags
        return bytes(data)

    def to_uncompressed_bytes(self, pt) -> bytes:
        """x bigint bytes, then y with SWFlags on its final byte (infinity is
        (0, 0) with the 1 << 6 flag)."""
        if pt is None:
            return bytes(self.base.bigint_bytes) + self._field_with_flags(0, 0x40)
        flag = 0x80 if pt[1] > self.base.p - pt[1] else 0
        return self.base.to_bytes_le(pt[0]) + self._field_with_flags(pt[1], flag)

    def serialize_compressed(self, pt) -> bytes:
        """x bytes with SWFlags: 1 << 6 for infinity, 1 << 7 if y > -y."""
        if pt is None:
            return self._field_with_flags(0, 0x40)
        x, y = pt
        flag = 0x80 if y > self.base.p - y else 0
        return self._field_with_flags(x, flag)

    def deserialize_compressed(self, data: bytes):
        """Inverse of :meth:`serialize_compressed`, checking the curve."""
        if len(data) != self.swflag_bytes:
            raise ValueError("bad SW compressed length")
        buf = bytearray(data)
        flags = buf[-1] & 0xC0
        buf[-1] &= 0x3F
        x = int.from_bytes(bytes(buf), "little")
        if flags & 0x40:
            if x != 0 or flags & 0x80:
                raise ValueError("bad infinity encoding")
            return None
        if x >= self.base.p:
            raise ValueError("x out of range")
        p = self.base.p
        y = self.sqrt_host((x * x % p * x + self.a * x + self.b) % p)
        if y is None:
            raise ValueError("x not on curve")
        if bool(flags & 0x80) != (y > p - y):
            y = (p - y) % p
        return (x, y)

    # ------------- host <-> words -------------

    def pack_points(self, pts) -> np.ndarray:
        """Affine host point(s), None for infinity -> projective int32 words:
        ``(3, W)`` for one point, ``(N, 3, W)`` for a list."""
        single = pts is None or (isinstance(pts, tuple) and len(pts) == 2 and isinstance(pts[0], int))
        if single:
            pts = [pts]
        rows = [[0, 1, 0] if pt is None else [int(pt[0]), int(pt[1]), 1] for pt in pts]
        out = self.base.pack(np.asarray(rows, dtype=object).reshape(len(rows), 3))
        return out[0] if single else out

    def unpack_points(self, arr):
        """``(..., 3, W)`` projective words -> host affine points (None for
        infinity): a list, or one point for a single row."""
        a = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
        vals = self.base.unpack(a.reshape(-1, 3, a.shape[-1]))
        p = self.base.p
        out = []
        for x, y, z in vals:
            x, y, z = int(x), int(y), int(z)
            if z == 0:
                out.append(None)
            else:
                zi = pow(z, -1, p)
                out.append((x * zi % p, y * zi % p))
        return out if a.ndim > 2 else out[0]

    # ------------- per-device constants (16-bit digits) -------------

    def _consts(self, device: torch.device) -> dict:
        key = str(device)
        c = self._tensors.get(key)
        if c is None:
            q = self.base
            digits = lambda v: ff.to_digits(torch.from_numpy(q.pack([v])[0]).to(device))
            a, b3, a2 = digits(self.a), digits(3 * self.b), digits(self.a * self.a)
            zero, one = digits(0), digits(1)
            c = {
                # multipliers of round 2: a s_xz, 3b t2, a t2, 3b s_xz, a t0, a^2 t2
                "round2": torch.stack([a, b3, a, b3, a, a2]),  # (6, L)
                "identity": torch.stack([zero, one, zero]),  # (3, L)
            }
            self._tensors[key] = c
        return c

    # ------------- generic batched ops (the JAX package's device shims) -----
    # The tensors' device is the caller's; ``dev_identity`` takes one, None
    # meaning CUDA.

    def dev_identity(self, shape=(), device=None):
        return identity(self, shape, resolve_device(device))

    def dev_conditional_sum(self, table, bits):
        return sw_conditional_sum(self, table, bits)

    def dev_to_affine(self, pts):
        return sw_to_affine(self, pts)

    def dev_add(self, p1, p2):
        return sw_add(self, p1, p2)

    def dev_neg(self, pts):
        return sw_neg(self, pts)

    def dev_scalar_mul_bits(self, base_pts, bits):
        return sw_scalar_mul_bits(self, base_pts, bits)


# ----------------------------------------------------------------------
# Batched tier on 16-bit digits (..., 3, L); the public functions take and
# return int32 words (..., 3, W)
# ----------------------------------------------------------------------


def sw_add_digits(curve: SWCurveSpec, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Complete projective RCB addition (Algorithm 1, any a) on digit points."""
    q = curve.base
    p1, p2 = torch.broadcast_tensors(p1, p2)
    X1, Y1, Z1 = p1.unbind(-2)
    X2, Y2, Z2 = p2.unbind(-2)
    # X1+Y1, Y1+Z1, X1+Z1 and the same for p2, in one stacked addition
    sums = ff.add_digits(q, torch.stack([X1, Y1, X1, X2, Y2, X2], dim=-2),
                         torch.stack([Y1, Z1, Z1, Y2, Z2, Z2], dim=-2))
    # round 1: t0 = X1X2, t1 = Y1Y2, t2 = Z1Z2, (X1+Y1)(X2+Y2), (X1+Z1)(X2+Z2), (Y1+Z1)(Y2+Z2)
    r1 = ff.mont_mul_digits(q, torch.cat([p1, sums[..., [0, 2, 1], :]], dim=-2),
                            torch.cat([p2, sums[..., [3, 5, 4], :]], dim=-2))
    m0, m1, m2 = r1[..., 0, :], r1[..., 1, :], r1[..., 2, :]
    # X1Y2 + X2Y1, X1Z2 + X2Z1, Y1Z2 + Y2Z1
    cross = ff.sub_digits(q, ff.sub_digits(q, r1[..., 3:6, :], torch.stack([m0, m0, m1], dim=-2)),
                          torch.stack([m1, m2, m2], dim=-2))
    s_xy, s_xz, s_yz = cross.unbind(-2)
    # round 2 (constants): a s_xz, 3b t2, a t2, 3b s_xz, a t0, a^2 t2
    r2 = ff.mont_mul_digits(q, torch.stack([s_xz, m2, m2, s_xz, m0, m2], dim=-2),
                            curve._consts(p1.device)["round2"])
    a_sxz, b3_m2, a_m2, b3_sxz, a_m0, a2_m2 = r2.unbind(-2)
    Zp = ff.add_digits(q, b3_m2, a_sxz)  # 3b t2 + a t4
    U = ff.sub_digits(q, m1, Zp)
    V = ff.add_digits(q, m1, Zp)
    t1p = ff.add_digits(q, ff.add_digits(q, ff.add_digits(q, m0, m0), m0), a_m2)  # 3 t0 + a t2
    t4p = ff.add_digits(q, b3_sxz, ff.sub_digits(q, a_m0, a2_m2))  # 3b t4 + a (t0 - a t2)
    # round 3: Y3 = U V + t1' t4'; X3 = s_xy U - s_yz t4'; Z3 = s_yz V + s_xy t1'
    r3 = ff.mont_mul_digits(q, torch.stack([U, t1p, s_xy, s_yz, s_yz, s_xy], dim=-2),
                            torch.stack([V, t4p, U, t4p, V, t1p], dim=-2))
    Y3 = ff.add_digits(q, r3[..., 0, :], r3[..., 1, :])
    X3 = ff.sub_digits(q, r3[..., 2, :], r3[..., 3, :])
    Z3 = ff.add_digits(q, r3[..., 4, :], r3[..., 5, :])
    return torch.stack([X3, Y3, Z3], dim=-2)


def identity(curve: SWCurveSpec, shape, device) -> torch.Tensor:
    """(0 : 1 : 0) in Montgomery words, shape (..., 3, W)."""
    ident = ff.from_digits(curve._consts(torch.device(device))["identity"])
    return ident.expand(tuple(shape) + ident.shape).clone()


def sw_add(curve: SWCurveSpec, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Complete projective addition of (..., 3, W) points."""
    return ff.from_digits(sw_add_digits(curve, ff.to_digits(p1), ff.to_digits(p2)))


def sw_neg(curve: SWCurveSpec, p1: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z) -> (X, -Y, Z)."""
    X, Y, Z = p1.unbind(-2)
    return torch.stack([X, ff.neg(curve.base, Y), Z], dim=-2)


def sw_select(mask: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """mask (...,) ? p1 : p2 over (..., 3, W) points."""
    return torch.where(mask[..., None, None], p1, p2)


def sw_sum(curve: SWCurveSpec, pts: torch.Tensor) -> torch.Tensor:
    """Sum (..., N, 3, W) points along N by log-depth pairwise addition."""
    ident = curve._consts(pts.device)["identity"]
    return ff.from_digits(tree_sum_digits(lambda a, b: sw_add_digits(curve, a, b), ident, ff.to_digits(pts)))


def sw_to_affine(curve: SWCurveSpec, pts: torch.Tensor) -> torch.Tensor:
    """(..., 3, W) projective -> (..., 2, W) affine Montgomery words; the
    identity maps to (0, 0).  Z is inverted by Fermat
    (:func:`affine_kernel.to_affine`)."""
    return affine_kernel.to_affine(curve, pts.contiguous())


def sw_double(curve: SWCurveSpec, p1: torch.Tensor) -> torch.Tensor:
    return sw_add(curve, p1, p1)


def sw_scalar_mul_bits(curve: SWCurveSpec, base_pt: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """base_pt (..., 3, W) times scalars given as bits (..., N), least
    significant first (``curve.scalar_mul_bits_digits``)."""
    ident = curve._consts(base_pt.device)["identity"]
    return ff.from_digits(scalar_mul_bits_digits(lambda a, b: sw_add_digits(curve, a, b), ident,
                                                 ff.to_digits(base_pt), bits))


def sw_conditional_sum(curve: SWCurveSpec, table: torch.Tensor, bits: torch.Tensor,
                       chunk: int = 256) -> torch.Tensor:
    """sum_j bits[..., j] * table[j] (``curve.conditional_sum_digits``).
    table (N, 3, W), bits (..., N); returns (..., 3, W)."""
    ident = curve._consts(table.device)["identity"]
    return ff.from_digits(conditional_sum_digits(lambda a, b: sw_add_digits(curve, a, b), ident,
                                                 ff.to_digits(table), bits, chunk))


def sw_eq(curve: SWCurveSpec, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Projective equality of (..., 3, W) points: X1 Z2 == X2 Z1 and
    Y1 Z2 == Y2 Z1 when neither is infinity; two infinities (Z = 0) are
    equal, and infinity equals no finite point."""
    q = curve.base
    lhs = ff.mont_mul(q, p1[..., 0:2, :], p2[..., 2:3, :])
    rhs = ff.mont_mul(q, p2[..., 0:2, :], p1[..., 2:3, :])
    cross = (lhs == rhs).all(-1).all(-1)
    z1, z2 = ff.is_zero(q, p1[..., 2, :]), ff.is_zero(q, p2[..., 2, :])
    return (z1 & z2) | (cross & ~(z1 ^ z2))
