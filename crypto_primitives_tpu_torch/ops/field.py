"""Prime-field arithmetic: host constants and the batched PyTorch tier.

Twin of ``crypto_primitives_tpu/ops/field.py``.  The JAX package keeps an
element as L little-endian 16-bit digits in uint32 lanes, in Montgomery form
with R = 2^(16 L), L = ceil(nbits / 16) plus a spare digit when p fills its
digits.  The port keeps W little-endian 32-bit words, W = ceil(nbits / 32)
plus a spare word when p fills its words, in Montgomery form with
R = 2^(32 W).  For every field whose L is even (every known field but P-256's
two) 2W = L, the two R agree and a port element is the JAX element with
``word[k] = digit[2k] | digit[2k+1] << 16``.  A 256-bit prime (P-256) has
L = 17 (R = 2^272) in the JAX package and W = 9 (R = 2^288) here; its
Montgomery forms differ by the factor 2^16, which ``interop`` converts.  Either
way p < 2^(32 W - 1), the spare bit the kernels' lazy reductions need
(``csrc/field.cuh``).  Words are stored as ``torch.int32`` holding uint32 bit
patterns: PyTorch on the CPU has no uint32 add, shift or compare.

Two tiers:
  * host tier: Python-int helpers on :class:`FieldSpec` (exact), with the same
    constants as the JAX ``FieldSpec`` where the two R agree;
  * batched tier: ``zeros``, ``ones``, ``add``, ``sub``, ``neg``,
    ``mont_mul``, ``mont_sqr``, ``mul_small``, ``pow_const``,
    ``pow_dynamic``, ``inv``, ``batch_inv``, ``to_mont``, ``from_mont``,
    ``eq``, ``is_zero`` and ``select`` on ``(..., W)`` int32 tensors, on any
    device.  These are
    the plain versions: they compute on 2W 16-bit digits held in int64, so
    that schoolbook column sums never overflow.  The CUDA kernels do the same
    arithmetic on 32-bit words (``csrc/field.cuh``).  Callers that chain many
    operations (the curve tier) stay on digits between them with the
    ``*_digits`` functions and convert once at each end.
Every batched result is fully reduced (< p), as in the JAX package, so the two
packages agree word for word and not only modulo p.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
WORD_BITS = 32
WORD_MASK = (1 << WORD_BITS) - 1


def _int_to_limbs(x: int, num_limbs: int, bits: int = LIMB_BITS) -> np.ndarray:
    if x >> (bits * num_limbs):
        raise ValueError("integer does not fit in limbs")
    mask = (1 << bits) - 1
    return np.array([(x >> (bits * i)) & mask for i in range(num_limbs)], dtype=np.uint32)


def _limbs_to_int(limbs: Sequence[int], bits: int = LIMB_BITS) -> int:
    x = 0
    for i, limb in enumerate(limbs):
        x |= int(limb) << (bits * i)
    return x


class FieldSpec:
    """A prime field F_p with the port's 32-bit word layout and Montgomery
    constants, and the JAX package's digit count (``num_limbs``, which sets
    the arkworks byte widths).

    Hashable by identity, as in the JAX package."""

    def __init__(self, name: str, modulus: int, generator: int | None = None):
        self.name = name
        self.p = modulus
        self.generator = generator
        self.nbits = modulus.bit_length()
        # The JAX package's rule: ceil(nbits / 16) digits, plus one spare
        # digit when the modulus fills its digits exactly.
        self.num_limbs = -(-self.nbits // LIMB_BITS) + (self.nbits % LIMB_BITS == 0)
        # The port's rule, the same on 32-bit words; the plain tier computes
        # on the words' 2W digits.
        self.num_words = -(-self.nbits // WORD_BITS) + (self.nbits % WORD_BITS == 0)
        self.num_digits = 2 * self.num_words
        D = self.num_digits
        self.R = 1 << (LIMB_BITS * D)
        self.R_mod_p = self.R % modulus
        self.R2_mod_p = (self.R * self.R) % modulus
        self.R_inv = pow(self.R, -1, modulus)
        self.n0 = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.n_prime = (-pow(modulus, -1, self.R)) % self.R
        self.bigint_bytes = (self.num_limbs * LIMB_BITS) // 8
        self.compressed_bytes = -(-self.nbits // 8)
        self.p_limbs = _int_to_limbs(modulus, D)
        self.r_limbs = _int_to_limbs(self.R_mod_p, D)
        self.r2_limbs = _int_to_limbs(self.R2_mod_p, D)
        self.n_prime_limbs = _int_to_limbs(self.n_prime, D)
        self.n0_word = (-pow(modulus, -1, 1 << WORD_BITS)) % (1 << WORD_BITS)
        self._tensors: dict = {}

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return f"FieldSpec({self.name}, {self.nbits} bits, {self.num_words} words)"

    # ---------------- host (python-int) tier ----------------

    def to_mont(self, x: int) -> int:
        return (x * self.R) % self.p

    def from_mont(self, x: int) -> int:
        return (x * self.R_inv) % self.p

    def inv(self, x: int) -> int:
        return pow(x, -1, self.p)

    def from_le_bytes_mod_order(self, b: bytes) -> int:
        """arkworks ``F::from_le_bytes_mod_order``."""
        return int.from_bytes(b, "little") % self.p

    def from_random_bytes(self, b: bytes):
        """arkworks ``F::from_random_bytes`` (EmptyFlags path): mask to
        MODULUS_BIT_SIZE bits, then reject values >= p."""
        limbs64 = -(-self.nbits // 64)
        if len(b) > 8 * limbs64 + 1:
            b = b[: 8 * limbs64 + 1]
        v = int.from_bytes(b, "little") & ((1 << self.nbits) - 1)
        return v if v < self.p else None

    def to_bytes_le(self, x: int) -> bytes:
        """arkworks ``into_bigint().to_bytes_le()``: full limb width."""
        return int(x).to_bytes(self.bigint_bytes, "little")

    def serialize_compressed(self, x: int) -> bytes:
        """arkworks ``CanonicalSerialize::serialize_compressed`` for Fp."""
        return int(x).to_bytes(self.compressed_bytes, "little")

    # ---------------- packing: host <-> words ----------------

    def pack(self, values, mont: bool = True) -> np.ndarray:
        """Python ints (nested lists allowed) -> int32 words ``(..., W)``,
        in Montgomery form unless ``mont=False``."""
        W = self.num_words
        arr = np.asarray(values, dtype=object)
        flat = arr.reshape(-1)
        out = np.zeros((flat.shape[0], W), dtype=np.uint32)
        for i, v in enumerate(flat):
            v = int(v) % self.p
            if mont:
                v = self.to_mont(v)
            out[i] = _int_to_limbs(v, W, WORD_BITS)
        return out.view(np.int32).reshape(arr.shape + (W,))

    def unpack(self, words, mont: bool = True):
        """Inverse of :meth:`pack`: Python ints (an object ndarray, or an
        int for a single element)."""
        W = self.num_words
        if isinstance(words, torch.Tensor):
            words = words.cpu().numpy()
        arr = np.asarray(words)
        if arr.shape[-1] != W:
            raise ValueError(f"expected {W} words in the last axis, got {arr.shape}")
        flat = arr.astype(np.int64).reshape(-1, W) & WORD_MASK
        out = np.empty((flat.shape[0],), dtype=object)
        for i in range(flat.shape[0]):
            v = _limbs_to_int(flat[i], WORD_BITS)
            out[i] = self.from_mont(v) if mont else v
        if arr.ndim == 1:
            return out[0]
        return out.reshape(arr.shape[:-1])

    # ---------------- per-device constants ----------------

    def _consts(self, device: torch.device) -> dict:
        key = str(device)
        c = self._tensors.get(key)
        if c is None:
            L = self.num_digits

            def digits(x, n=L):
                return torch.tensor(_int_to_limbs(x, n).astype(np.int64), device=device)

            i, j = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
            c = {
                "p": digits(self.p),
                "p_ext": digits(self.p, L + 1),
                "r2": digits(self.R2_mod_p),
                "one_std": digits(1),
                "one": digits(self.R_mod_p),  # 1 in Montgomery form
                # column of each schoolbook partial product a[i] * b[j]
                "diag": torch.tensor((i + j).reshape(-1), dtype=torch.int64, device=device),
            }
            self._tensors[key] = c
        return c


def host_words(spec: FieldSpec, values) -> np.ndarray:
    """Python ints, as they are (no Montgomery conversion), -> one flat
    uint32 array of W words each: the constants a kernel takes by value."""
    W = spec.num_words
    return np.frombuffer(b"".join(int(v).to_bytes(4 * W, "little") for v in values), dtype="<u4").copy()


# ======================================================================
# Word <-> digit conversion
# ======================================================================


def to_digits(words: torch.Tensor) -> torch.Tensor:
    """int32 words ``(..., W)`` -> int64 16-bit digits ``(..., 2W)``."""
    v = words.to(torch.int64) & WORD_MASK
    d = torch.stack([v & LIMB_MASK, v >> LIMB_BITS], dim=-1)
    return d.reshape(words.shape[:-1] + (2 * words.shape[-1],))


def from_digits(digits: torch.Tensor) -> torch.Tensor:
    """Canonical int64 16-bit digits ``(..., L)`` -> int32 words ``(..., L/2)``."""
    d = digits.reshape(digits.shape[:-1] + (digits.shape[-1] // 2, 2))
    v = d[..., 0] | (d[..., 1] << LIMB_BITS)
    # uint32 value -> the int32 with the same bit pattern
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32)


# ======================================================================
# Digit-level plain arithmetic (int64 digits, values < p unless noted)
# ======================================================================


def _carry(x: torch.Tensor):
    """Normalize relaxed (possibly negative) digits; returns (digits in
    [0, 2^16), signed carry out of the top digit)."""
    out = []
    c = None
    for col in x.unbind(-1):
        v = col if c is None else col + c
        out.append(v & LIMB_MASK)
        c = v >> LIMB_BITS  # arithmetic shift: floor division
    return torch.stack(out, dim=-1), c


def _reduce(u: torch.Tensor, m: torch.Tensor, max_mult: int) -> torch.Tensor:
    """The canonical digits of u mod m, for relaxed digits u with
    0 <= u < (max_mult + 1) m: every candidate u - j m (j = 0..max_mult) is
    normalized in one carry pass, and the last non-negative one is kept."""
    mults = torch.arange(max_mult + 1, dtype=torch.int64, device=u.device)
    mults = mults.reshape((-1,) + (1,) * u.dim())
    cands, borrow = _carry(u.unsqueeze(0) - mults * m)
    j = (borrow >= 0).sum(0) - 1  # candidates stay non-negative up to j
    idx = j.unsqueeze(0).unsqueeze(-1).expand((1,) + tuple(u.shape))
    return cands.gather(0, idx).squeeze(0)


def add_digits(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # a + b < 2p < R (every supported modulus has a spare bit)
    return _reduce(a + b, spec._consts(a.device)["p"], 1)


def sub_digits(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # a - b + p lies in [1, 2p): reduce it once
    p = spec._consts(a.device)["p"]
    return _reduce(a - b + p, p, 1)


def neg_digits(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    # p - a lies in [1, p]: reduce it once (0 maps to 0)
    p = spec._consts(a.device)["p"]
    return _reduce(p - a, p, 1)


def _redc(spec: FieldSpec, t: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction of relaxed column sums ``t`` (..., 2L+1), in
    place, digit by digit (REDC with the 16-bit factor n0).  Returns relaxed
    digits (..., L+1) of (T + m p) / R."""
    L = spec.num_digits
    P = spec._consts(t.device)["p"]
    cols = t.unbind(-1)  # views: in-place updates land in t
    for i in range(L):
        m = (cols[i] & LIMB_MASK).mul_(spec.n0).bitwise_and_(LIMB_MASK)
        t[..., i : i + L].addcmul_(m.unsqueeze(-1), P)
        cols[i + 1].add_(cols[i] >> LIMB_BITS)  # cols[i] is now 0 mod 2^16
    return t[..., L:]


def _columns(spec: FieldSpec, prod: torch.Tensor, terms: int = 1) -> torch.Tensor:
    """Schoolbook column sums of ``prod`` (..., terms * L * L) partial
    products a[i] * b[j] into (..., 2L+1) columns."""
    L = spec.num_digits
    c = spec._consts(prod.device)
    index = c["diag"] if terms == 1 else c["diag"].repeat(terms)
    t = prod.new_zeros(prod.shape[:-1] + (2 * L + 1,))
    return t.index_add_(t.dim() - 1, index, prod)  # columns < terms * L * 2^32


def mont_mul_digits(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p: schoolbook columns, then REDC (result < 2p before
    the final subtraction)."""
    a, b = torch.broadcast_tensors(a, b)
    t = _columns(spec, (a.unsqueeze(-1) * b.unsqueeze(-2)).flatten(-2))
    return _reduce(_redc(spec, t), spec._consts(a.device)["p_ext"], 1)[..., : spec.num_digits]


def mont_dot_digits(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k, :] * b[..., k, :] * R^-1 mod p with one reduction for
    the whole sum (the JAX package's ``mont_dot``, used for the MDS matrix)."""
    a, b = torch.broadcast_tensors(a, b)
    K = a.shape[-2]
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)  # (..., K, L, L)
    t = _columns(spec, prod.flatten(-3), terms=K)
    # T < K p^2, so (T + m p) / R < (K p / R + 1) p
    max_mult = (K * spec.p) // spec.R + 1
    return _reduce(_redc(spec, t), spec._consts(a.device)["p_ext"], max_mult)[..., : spec.num_digits]


def pow_const_digits(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a constant e >= 1, square-and-multiply from the top bit."""
    if e < 1:
        raise ValueError("exponent must be >= 1")
    acc = a
    for bit in bin(e)[3:]:
        acc = mont_mul_digits(spec, acc, acc)
        if bit == "1":
            acc = mont_mul_digits(spec, acc, a)
    return acc


# ======================================================================
# Public batched tier on int32 words (..., W)
# ======================================================================


def zeros(spec: FieldSpec, shape=(), device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape) + (spec.num_words,), dtype=torch.int32, device=device)


def ones(spec: FieldSpec, shape=(), device=None) -> torch.Tensor:
    """1 in Montgomery form (R mod p), shape (..., W)."""
    one = torch.as_tensor(spec.pack([1])[0], device=device)
    return one.expand(tuple(shape) + one.shape).clone()


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modular addition (the same in Montgomery and standard form)."""
    return from_digits(add_digits(spec, to_digits(a), to_digits(b)))


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return from_digits(sub_digits(spec, to_digits(a), to_digits(b)))


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * R^-1 mod p."""
    return from_digits(mont_mul_digits(spec, to_digits(a), to_digits(b)))


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, a)


def pow_const(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a constant exponent (the Poseidon S-box x^alpha)."""
    return from_digits(pow_const_digits(spec, to_digits(a), e))


def to_mont(spec: FieldSpec, a_std: torch.Tensor) -> torch.Tensor:
    """Standard form -> Montgomery form (a Montgomery product with R^2)."""
    d = to_digits(a_std)
    return from_digits(mont_mul_digits(spec, d, spec._consts(d.device)["r2"]))


def from_mont(spec: FieldSpec, a_mont: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> standard form (a Montgomery product with 1)."""
    d = to_digits(a_mont)
    return from_digits(mont_mul_digits(spec, d, spec._consts(d.device)["one_std"]))


def to_bytes_le(spec: FieldSpec, a_mont: torch.Tensor) -> torch.Tensor:
    """``(..., W)`` Montgomery words -> ``(..., bigint_bytes)`` uint8: the
    little-endian bytes of each standard value (``FieldSpec.to_bytes_le``)."""
    std = from_mont(spec, a_mont).to(torch.int64) & WORD_MASK
    by = torch.stack([(std >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1)
    return by.flatten(-2)[..., : spec.bigint_bytes].to(torch.uint8)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """-a mod p (0 stays 0)."""
    return from_digits(neg_digits(spec, to_digits(a)))


def mul_small(spec: FieldSpec, a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c for a constant integer c (a Montgomery product with c R)."""
    const = torch.from_numpy(spec.pack([c])[0]).to(a.device)
    return mont_mul(spec, a, const)


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p-2), as the JAX package computes it; 0 maps to 0."""
    return pow_const(spec, a, spec.p - 2)


def pow_dynamic(spec: FieldSpec, base: torch.Tensor, exp_words: torch.Tensor) -> torch.Tensor:
    """base^e with a per-element exponent given as standard-form words
    ``(..., W)`` (not Montgomery form): the least-significant-first ladder
    over all 32 W exponent bits, a square every bit and a product selected in
    where the bit is set, as the JAX package runs it over its 16 L bits."""
    e = exp_words.to(torch.int64) & WORD_MASK
    b = to_digits(base)
    shape = torch.broadcast_shapes(b.shape[:-1], e.shape[:-1])
    one = spec._consts(b.device)["one"]
    acc = one.expand(shape + one.shape)
    for k in range(WORD_BITS * spec.num_words):
        bit = ((e[..., k // WORD_BITS] >> (k % WORD_BITS)) & 1).bool()
        acc = torch.where(bit.unsqueeze(-1), mont_mul_digits(spec, acc, b), acc)
        b = mont_mul_digits(spec, b, b)
    return from_digits(acc)


def batch_inv(spec: FieldSpec, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Montgomery's batch inversion along ``axis``: the running products,
    one Fermat inverse of their total, then 2 products an element on the way
    back, in the JAX package's order.  As there, a zero anywhere in the batch
    makes the total 0, whose inverse is 0, so every output is 0."""
    d = to_digits(a).movedim(axis, 0)
    one = spec._consts(d.device)["one"]
    run = one.expand(d.shape[1:])
    prefixes = []
    for x in d:
        prefixes.append(run)  # the product of the elements before x
        run = mont_mul_digits(spec, run, x)
    carry = pow_const_digits(spec, run, spec.p - 2)
    outs = [None] * d.shape[0]
    for i in reversed(range(d.shape[0])):
        outs[i] = mont_mul_digits(spec, carry, prefixes[i])
        carry = mont_mul_digits(spec, carry, d[i])
    return from_digits(torch.stack(outs).movedim(0, axis)) if outs else a.clone()


def eq(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise equality over the word axis (values are canonical)."""
    a, b = torch.broadcast_tensors(a, b)
    return (a == b).all(dim=-1)


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask ? a : b, with mask shaped (...,) broadcast over the word axis."""
    return torch.where(mask.unsqueeze(-1), a, b)
