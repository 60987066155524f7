"""Twisted-Edwards curve arithmetic: the host oracle and the batched PyTorch tier.

Twin of ``crypto_primitives_tpu/ops/curve.py`` (what the reference imports
from ``ark-ec`` for twisted-Edwards groups).

  * Host tier: exact Python-int affine arithmetic (the oracle), Tonelli-Shanks
    square roots and point sampling, with the same random-number consumption
    as the JAX package, so ``rand_point(random.Random(s))`` gives the same
    point in both packages.
  * Batched tier: points are extended coordinates (X, Y, T, Z) stacked as
    ``(..., 4, W)`` int32 Montgomery words, the JAX limb tier's order.  The
    unified add-2008-hwcd law is used for every addition, doubling and the
    identity included: it is complete for a = -1 (a square) and d a
    non-square, so there are no branches.  The 11 products of one addition
    run as 3 stacked Montgomery products, as in the JAX package
    (``te_add_digits``); ``te_add`` on CUDA tensors is one kernel launch
    (``ops.add_kernel``).  Every coordinate is fully reduced, so results
    agree word for word with any other computation that takes the same
    steps.  Doubling, double-and-add scalar multiplication, conditional
    sums and projective equality are built on that one law; the ``dev_*``
    methods give the curve models one surface.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.ops import add_kernel, affine_kernel
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops.field import FieldSpec


def tonelli(n: int, p: int) -> Optional[int]:
    """Tonelli-Shanks square root mod p; None for a non-residue."""
    n %= p
    if n == 0:
        return 0
    if pow(n, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(n, q, p), pow(n, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r


class TECurveSpec:
    """a*x^2 + y^2 = 1 + d*x^2*y^2 over the base field; prime-order subgroup
    of the scalar field's order.  Hashable by identity, as in the JAX
    package."""

    coords = 4

    def __init__(self, name: str, base: FieldSpec, scalar: FieldSpec, a: int, d: int,
                 cofactor: int, generator: Optional[Tuple[int, int]] = None):
        self.name = name
        self.base = base
        self.scalar = scalar
        self.a = a % base.p
        self.d = d % base.p
        self.cofactor = cofactor
        self.generator = generator
        self._tensors: dict = {}

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return f"TECurveSpec({self.name})"

    # ------------- host tier (Python ints, affine) -------------

    def zero_host(self):
        return (0, 1)

    def is_on_curve(self, pt) -> bool:
        x, y = pt
        p = self.base.p
        return (self.a * x * x + y * y) % p == (1 + self.d * x * x * y * y) % p

    def add_host(self, p1, p2):
        x1, y1 = p1
        x2, y2 = p2
        p = self.base.p
        dxy = self.d * x1 * x2 % p * y1 % p * y2 % p
        x3 = (x1 * y2 + y1 * x2) * pow(1 + dxy, -1, p) % p
        y3 = (y1 * y2 - self.a * x1 * x2) * pow(1 - dxy, -1, p) % p
        return (x3, y3)

    def double_host(self, p1):
        return self.add_host(p1, p1)

    def neg_host(self, p1):
        return ((-p1[0]) % self.base.p, p1[1])

    def scalar_mul_host(self, pt, k: int):
        """Double-and-add in Python ints (k >= 0, not reduced)."""
        k = int(k)
        if k < 0:
            raise ValueError("scalar must be non-negative")
        acc, base = (0, 1), pt
        while k > 0:
            if k & 1:
                acc = self.add_host(acc, base)
            base = self.double_host(base)
            k >>= 1
        return acc

    def sqrt_host(self, n: int) -> Optional[int]:
        return tonelli(n, self.base.p)

    def rand_point(self, rng):
        """A uniform point of the prime-order subgroup (the twin of arkworks
        ``C::rand``: random x, solve for y, clear the cofactor)."""
        p = self.base.p
        while True:
            x = rng.randrange(p)
            # y^2 = (1 - a x^2) / (1 - d x^2)
            denom = (1 - self.d * x * x) % p
            if denom == 0:
                continue
            y2 = (1 - self.a * x * x) * pow(denom, -1, p) % p
            y = self.sqrt_host(y2)
            if y is None:
                continue
            if rng.random() < 0.5:
                y = (-y) % p
            pt = self.scalar_mul_host((x, y), self.cofactor)
            if pt != (0, 1):
                return pt

    # ------------- serialization (ark-serialize twins) -------------

    def to_uncompressed_bytes(self, pt) -> bytes:
        """x || y, bigint little-endian bytes, no flags."""
        return self.base.to_bytes_le(pt[0]) + self.base.to_bytes_le(pt[1])

    def serialize_compressed(self, pt) -> bytes:
        """y with the top bit set iff x > -x (TEFlags::XIsNegative)."""
        x, y = pt
        data = bytearray(self.base.serialize_compressed(y))
        if x > self.base.p - x:
            data[-1] |= 0x80
        return bytes(data)

    # ------------- host <-> words -------------

    def pack_points(self, pts) -> np.ndarray:
        """Affine host point(s) -> extended int32 words: ``(4, W)`` for one
        ``(x, y)`` tuple, ``(N, 4, W)`` for a list."""
        single = isinstance(pts, tuple)
        if single:
            pts = [pts]
        p = self.base.p
        rows = [[int(x) % p, int(y) % p, int(x) * int(y) % p, 1] for x, y in pts]
        out = self.base.pack(np.asarray(rows, dtype=object).reshape(len(rows), 4))
        return out[0] if single else out

    def unpack_points(self, arr):
        """``(..., 4, W)`` extended words -> host affine tuples (an object
        array, or one tuple for a single point)."""
        a = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
        vals = self.base.unpack(a.reshape(-1, 4, a.shape[-1]))
        p = self.base.p
        out = np.empty((vals.shape[0],), dtype=object)
        for i, (x, y, _, z) in enumerate(vals):
            zi = pow(int(z), -1, p)
            out[i] = (int(x) * zi % p, int(y) * zi % p)
        return out[0] if a.ndim == 2 else out.reshape(a.shape[:-2])

    # ------------- per-device constants (16-bit digits) -------------

    def _consts(self, device: torch.device) -> dict:
        key = str(device)
        c = self._tensors.get(key)
        if c is None:
            q = self.base
            digits = lambda v: ff.to_digits(torch.from_numpy(q.pack([v])[0]).to(device))
            zero, one = digits(0), digits(1)
            c = {
                "da": torch.stack([digits(self.d), digits(self.a)]),  # (2, L)
                "identity": torch.stack([zero, one, zero, one]),  # (4, L)
            }
            self._tensors[key] = c
        return c

    # ------------- generic batched ops (the JAX package's device shims) -----
    # The tensors' device is the caller's; ``dev_identity`` takes one, None
    # meaning CUDA.

    def dev_identity(self, shape=(), device=None):
        return identity(self, shape, resolve_device(device))

    def dev_conditional_sum(self, table, bits):
        return te_conditional_sum(self, table, bits)

    def dev_to_affine(self, pts):
        return te_to_affine(self, pts)

    def dev_add(self, p1, p2):
        return te_add(self, p1, p2)

    def dev_neg(self, pts):
        return te_neg(self, pts)

    def dev_scalar_mul_bits(self, base_pts, bits):
        return te_scalar_mul_bits(self, base_pts, bits)


def affine_to_uncompressed_bytes(curve, aff: torch.Tensor) -> torch.Tensor:
    """(..., 2, W) Montgomery affine -> (..., 2 * bigint_bytes) uint8: x || y
    as bigint little-endian bytes, no flags.  The batched twin of
    :meth:`TECurveSpec.to_uncompressed_bytes` (the JAX package's batched
    encoding), for either curve model."""
    return ff.to_bytes_le(curve.base, aff).flatten(-2)


# ----------------------------------------------------------------------
# Batched tier on 16-bit digits (..., 4, L); the public functions take and
# return int32 words (..., 4, W)
# ----------------------------------------------------------------------


def te_add_digits(curve: TECurveSpec, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """add-2008-hwcd on digit points: A = X1 X2, B = Y1 Y2, C = d T1 T2,
    D = Z1 Z2, E = (X1+Y1)(X2+Y2) - A - B, F = D - C, G = D + C,
    H = B - a A; X3 = E F, Y3 = G H, T3 = E H, Z3 = F G."""
    q = curve.base
    p1, p2 = torch.broadcast_tensors(p1, p2)
    s = ff.add_digits(q, torch.stack([p1[..., 0, :], p2[..., 0, :]]), torch.stack([p1[..., 1, :], p2[..., 1, :]]))
    r1 = ff.mont_mul_digits(q, torch.cat([p1, s[0].unsqueeze(-2)], dim=-2),
                            torch.cat([p2, s[1].unsqueeze(-2)], dim=-2))
    A, B, TT, D, S = r1.unbind(-2)
    r2 = ff.mont_mul_digits(q, torch.stack([TT, A], dim=-2), curve._consts(p1.device)["da"])
    C, aA = r2.unbind(-2)
    diff = ff.sub_digits(q, torch.stack([S, D, B]), torch.stack([A, C, aA]))
    E = ff.sub_digits(q, diff[0], B)
    F, H = diff[1], diff[2]
    G = ff.add_digits(q, D, C)
    return ff.mont_mul_digits(q, torch.stack([E, G, E, F], dim=-2), torch.stack([F, H, H, G], dim=-2))


def identity(curve: TECurveSpec, shape, device) -> torch.Tensor:
    """(0 : 1 : 0 : 1) in Montgomery words, shape (..., 4, W)."""
    ident = ff.from_digits(curve._consts(torch.device(device))["identity"])
    return ident.expand(tuple(shape) + ident.shape).clone()


def te_add(curve: TECurveSpec, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Complete extended-coordinate addition of (..., 4, W) points
    (:func:`add_kernel.te_add`)."""
    return add_kernel.te_add(curve, p1, p2)


def te_neg(curve: TECurveSpec, p1: torch.Tensor) -> torch.Tensor:
    """(X, Y, T, Z) -> (-X, Y, -T, Z)."""
    X, Y, T, Z = p1.unbind(-2)
    return torch.stack([ff.neg(curve.base, X), Y, ff.neg(curve.base, T), Z], dim=-2)


def te_select(mask: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """mask (...,) ? p1 : p2 over (..., 4, W) points."""
    return torch.where(mask[..., None, None], p1, p2)


def tree_sum_digits(add_digits, ident: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Pairwise tree reduction of digit points along axis -3, padding an odd
    level with the identity (the JAX package's ``te_sum`` order)."""
    pts = pts.movedim(-3, 0)
    while pts.shape[0] > 1:
        if pts.shape[0] % 2:
            pts = torch.cat([pts, ident.expand((1,) + pts.shape[1:])], dim=0)
        pts = add_digits(pts[0::2], pts[1::2])
    return pts[0]


def te_sum(curve: TECurveSpec, pts: torch.Tensor) -> torch.Tensor:
    """Sum (..., N, 4, W) points along N by log-depth pairwise addition."""
    d = ff.to_digits(pts)
    ident = curve._consts(pts.device)["identity"]
    return ff.from_digits(tree_sum_digits(lambda a, b: te_add_digits(curve, a, b), ident, d))


def te_to_affine(curve: TECurveSpec, pts: torch.Tensor) -> torch.Tensor:
    """(..., 4, W) extended -> (..., 2, W) affine (x, y) Montgomery words, Z
    inverted by Fermat (:func:`affine_kernel.to_affine`)."""
    return affine_kernel.to_affine(curve, pts.contiguous())


def te_double(curve: TECurveSpec, p1: torch.Tensor) -> torch.Tensor:
    return te_add(curve, p1, p1)


def scalar_mul_bits_digits(add_digits, ident: torch.Tensor, base: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Double-and-add on digit points, least significant bit first: at each
    bit the sum acc + base is selected in where the bit is set, then base is
    doubled (no branch on the bits).  base (..., C, L), bits (..., N)."""
    acc = ident.expand(bits.shape[:-1] + ident.shape)
    for j in range(bits.shape[-1]):
        acc = torch.where((bits[..., j] != 0)[..., None, None], add_digits(acc, base), acc)
        base = add_digits(base, base)
    return acc


def te_scalar_mul_bits(curve: TECurveSpec, base_pt: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """base_pt (..., 4, W) times scalars given as bits (..., N), least
    significant first, by :func:`scalar_mul_bits_digits`."""
    return ff.from_digits(scalar_mul_bits_digits(lambda a, b: te_add_digits(curve, a, b),
                                                 curve._consts(base_pt.device)["identity"],
                                                 ff.to_digits(base_pt), bits))


def conditional_sum_digits(add_digits, ident: torch.Tensor, table: torch.Tensor, bits: torch.Tensor,
                           chunk: int) -> torch.Tensor:
    """sum_j bits[..., j] * table[j] on digit points: a per-bit select
    against the identity, then a tree sum, ``chunk`` table entries at a
    time.  table (N, C, L), bits (..., N); returns (..., C, L)."""
    batch = tuple(bits.shape[:-1])
    acc = ident.expand(batch + ident.shape)
    for start in range(0, table.shape[0], chunk):
        tb = table[start:start + chunk]
        sel = torch.where((bits[..., start:start + chunk] != 0)[..., None, None], tb.expand(batch + tb.shape), ident)
        acc = add_digits(acc, tree_sum_digits(add_digits, ident, sel))
    return acc


def te_conditional_sum(curve: TECurveSpec, table: torch.Tensor, bits: torch.Tensor,
                       chunk: int = 256) -> torch.Tensor:
    """sum_j bits[..., j] * table[j] (:func:`conditional_sum_digits`).
    table (N, 4, W), bits (..., N); returns (..., 4, W)."""
    return ff.from_digits(conditional_sum_digits(lambda a, b: te_add_digits(curve, a, b),
                                                 curve._consts(table.device)["identity"],
                                                 ff.to_digits(table), bits, chunk))


def te_eq(curve: TECurveSpec, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Projective equality of (..., 4, W) points: X1 Z2 == X2 Z1 and
    Y1 Z2 == Y2 Z1."""
    q = curve.base
    lhs = ff.mont_mul(q, p1[..., 0:2, :], p2[..., 3:4, :])
    rhs = ff.mont_mul(q, p2[..., 0:2, :], p1[..., 3:4, :])
    return (lhs == rhs).all(-1).all(-1)
