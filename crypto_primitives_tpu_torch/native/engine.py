"""The compiled host engine (``native/cpmont.cpp``), bound with ctypes.

Twin of ``NativeField``, ``NativeTECurve``, ``NativeSWCurve``,
``NativePoseidon``, ``curve_engine`` and ``poseidon_engine`` in
``crypto_primitives_tpu/native/__init__.py``, on the port's ``FieldSpec`` and
curve specs: Montgomery field products and inverses, twisted-Edwards and
short-Weierstrass additions, scalar products and bit-table MSMs, the Poseidon
permutation, two-to-one compression and Merkle builds, on the host's CPU.

The engine is called only by name: the port's host paths stay on the
python-int tier, and nothing falls back to the engine or from it.  The
library builds at first use (never at import) with
``g++ -O3 -march=native -shared -fPIC`` into ``native/build/`` (listed in
``.gitignore``), under a name that carries a hash of the source and the
flags; it is written under a temporary name and renamed into place, so
processes building at once never load a half-written library.  A failed
build raises with g++'s output.

Codec.  The port's Montgomery words have R = 2^(32 W); the engine's limbs
have R = 2^(64 N).  For W = 8 and W = 12 (N = 4 and 6) the two R agree, so a
row of W words is the engine's N u64 limbs by pairing adjacent words, with
no rescaling.  Any other W (P-256's W = 9, R = 2^288) raises ``ValueError``.
The inverse maps 0 to 0, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from crypto_primitives_tpu_torch.ops.curve import TECurveSpec
from crypto_primitives_tpu_torch.ops.curve_sw import SWCurveSpec
from crypto_primitives_tpu_torch.ops.field import FieldSpec, host_words

SRC = Path(__file__).resolve().parent / "cpmont.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_u64p = ctypes.POINTER(ctypes.c_uint64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i = ctypes.c_int
_l = ctypes.c_long
_vp = ctypes.c_void_p
_u64 = ctypes.c_uint64

SIGNATURES = {
    "cpm_field_new": (_vp, [_i, _u64p, _u64p, _u64]),
    "cpm_mont_mul_batch": (None, [_vp, _i, _u64p, _u64p, _u64p, _l]),
    "cpm_add_batch": (None, [_vp, _i, _u64p, _u64p, _u64p, _l]),
    "cpm_inv_batch": (None, [_vp, _i, _u64p, _u64p, _l]),
    "cpm_te_new": (_vp, [_i, _u64p, _u64p, _u64, _u64p, _u64p]),
    "cpm_te_add_batch": (None, [_vp, _i, _u64p, _u64p, _u64p, _l]),
    "cpm_te_scalar_mul_batch": (None, [_vp, _i, _u64p, _u8p, _l, _u64p, _l]),
    "cpm_te_msm_bits_batch": (None, [_vp, _i, _u64p, _u8p, _l, _u64p, _l]),
    "cpm_te_to_affine_batch": (None, [_vp, _i, _u64p, _u64p, _l]),
    "cpm_sw_new": (_vp, [_i, _u64p, _u64p, _u64, _u64p, _u64p, _u64p]),
    "cpm_sw_add_batch": (None, [_vp, _i, _u64p, _u64p, _u64p, _l]),
    "cpm_sw_scalar_mul_batch": (None, [_vp, _i, _u64p, _u8p, _l, _u64p, _l]),
    "cpm_sw_msm_bits_batch": (None, [_vp, _i, _u64p, _u8p, _l, _u64p, _l]),
    "cpm_sw_to_affine_batch": (None, [_vp, _i, _u64p, _u64p, _u8p, _l]),
    "cpm_poseidon_new": (_vp, [_i, _u64p, _u64p, _u64, _i, _u64, _i, _i, _u64p, _u64p]),
    "cpm_poseidon_permute": (None, [_vp, _u64p, _l]),
    "cpm_poseidon_two_to_one": (None, [_vp, _u64p, _u64p, _u64p, _l]),
    "cpm_merkle_build": (None, [_vp, _u64p, _l, _u64p]),
}


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libcpmont-{digest}.so"


@functools.cache
def load() -> ctypes.CDLL:
    """The engine's library, built first if needed; raises with g++'s
    output when the build fails."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC.name} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
    lib = ctypes.CDLL(str(path))
    for name, (res, args) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p if arr.dtype == np.uint8 else _u64p)


class Codec:
    """Port words <-> the engine's (n, N) uint64 Montgomery limbs for one
    ``FieldSpec`` with W = 8 or 12."""

    def __init__(self, spec: FieldSpec):
        if spec.num_words not in (8, 12):
            raise ValueError(f"{spec.name}: the engine takes W = 8 or 12 words (R = 2^256 or 2^384), "
                             f"not W = {spec.num_words} (R = 2^{32 * spec.num_words})")
        self.spec = spec
        self.nl = spec.num_words // 2

    def from_words(self, words) -> np.ndarray:
        """(..., W) int32 words (array or tensor) -> (n, N) limbs."""
        if isinstance(words, torch.Tensor):
            words = words.cpu().numpy()
        arr = np.ascontiguousarray(np.asarray(words, dtype=np.int32).reshape(-1, self.spec.num_words))
        return arr.view(np.uint64)

    def to_words(self, limbs: np.ndarray) -> np.ndarray:
        """(n, N) limbs -> (n, W) int32 words."""
        return np.ascontiguousarray(limbs).view(np.int32).reshape(-1, self.spec.num_words)

    def limbs(self, values, mont: bool = True) -> np.ndarray:
        """Python ints -> (n, N) limbs, in Montgomery form unless ``mont=False``
        (then the values are taken as they are, p itself included)."""
        if mont:
            return self.from_words(self.spec.pack([int(v) for v in values]))
        return host_words(self.spec, [int(v) for v in values]).view(np.uint64).reshape(-1, self.nl)

    def ints(self, limbs: np.ndarray) -> List[int]:
        """(n, N) Montgomery limbs -> canonical Python ints."""
        return [int(v) for v in self.spec.unpack(self.to_words(limbs)).reshape(-1)]

    def n0(self) -> int:
        return (-pow(self.spec.p, -1, 1 << 64)) % (1 << 64)

    def field_args(self) -> tuple:
        """(N, p, one, n0) as ``cpm_*_new`` take them (the contexts copy
        what they are given)."""
        return self.nl, _ptr(self.limbs([self.spec.p], mont=False)), _ptr(self.limbs([1])), self.n0()

    def rows(self, arr, width: int) -> np.ndarray:
        """``arr`` as contiguous (n, width) uint64 rows; anything else raises
        before a pointer is passed."""
        arr = np.ascontiguousarray(arr)
        if arr.dtype != np.uint64 or arr.ndim != 2 or arr.shape[1] != width:
            raise ValueError(f"expected (n, {width}) uint64 limb rows, got {arr.dtype} {arr.shape}")
        return arr


class NativeField:
    """Montgomery products and inverses of ints on the engine."""

    def __init__(self, spec: FieldSpec):
        self.spec, self.codec = spec, Codec(spec)
        self.nl = self.codec.nl
        self.lib = load()
        self.ctx = self.lib.cpm_field_new(*self.codec.field_args())

    def mont_mul_batch(self, xs, ys) -> List[int]:
        a, b = self.codec.limbs(xs), self.codec.limbs(ys)
        if a.shape != b.shape:
            raise ValueError(f"{len(a)} and {len(b)} operands")
        out = np.zeros_like(a)
        self.lib.cpm_mont_mul_batch(self.ctx, self.nl, _ptr(a), _ptr(b), _ptr(out), len(a))
        return self.codec.ints(out)

    def inv_batch(self, xs) -> List[int]:
        a = self.codec.limbs(xs)
        out = np.zeros_like(a)
        self.lib.cpm_inv_batch(self.ctx, self.nl, _ptr(a), _ptr(out), len(a))
        return self.codec.ints(out)


def _int_bits(ks) -> Tuple[np.ndarray, int]:
    """Nonnegative ints -> ((n, nbits) uint8 bits, least significant first;
    nbits): the longest operand's bit length (callers may pass k > r, as the
    Schnorr randomizer does, mod.rs:187-194)."""
    nbits = max((int(k).bit_length() for k in ks), default=0) or 1
    nbytes = -(-nbits // 8)
    buf = b"".join(int(k).to_bytes(nbytes, "little") for k in ks)
    bits = np.unpackbits(np.frombuffer(buf, np.uint8).reshape(len(ks), nbytes), axis=1, bitorder="little")
    return np.ascontiguousarray(bits[:, :nbits]), nbits


class _NativeCurve:
    """What the two curve models share: affine tuples in and out, points as
    (n, C * N) limb rows."""

    coords = 0
    prefix = ""

    def __init__(self, curve):
        self.curve, self.codec = curve, Codec(curve.base)
        self.nl = self.codec.nl
        self.lib = load()
        self.ctx = self._new()

    def _call(self, name: str, *args):
        return getattr(self.lib, f"cpm_{self.prefix}_{name}")(self.ctx, self.nl, *args)

    def add(self, p1, p2):
        a, b = self.pack([p1]), self.pack([p2])
        out = np.zeros_like(a)
        self._call("add_batch", _ptr(a), _ptr(b), _ptr(out), 1)
        return self.to_affine(out)[0]

    def scalar_mul(self, pt, k: int):
        return self.scalar_mul_batch([pt], [int(k)])[0]

    def scalar_mul_batch(self, pts, ks) -> list:
        if len(pts) != len(ks):
            raise ValueError(f"{len(pts)} points and {len(ks)} scalars")
        bases = self.pack(pts)
        bits, nbits = _int_bits(ks)
        out = np.zeros_like(bases)
        self._call("scalar_mul_batch", _ptr(bases), _ptr(bits), nbits, _ptr(out), len(ks))
        return self.to_affine(out)

    def pack_table(self, pts) -> np.ndarray:
        """An MSM table of host points (keep it for repeated calls)."""
        return self.pack(pts)

    def msm_bits(self, table: np.ndarray, bits) -> list:
        """table (T, C * N) from :meth:`pack_table`; bits (n, T) of 0/1 ->
        n affine points, out[i] = sum_j bits[i, j] * table[j]."""
        if isinstance(bits, torch.Tensor):
            bits = bits.cpu().numpy()
        bits = np.ascontiguousarray(bits, dtype=np.uint8)
        n, T = bits.shape
        table = self.codec.rows(table, self.coords * self.nl)
        if table.shape[0] != T:
            raise ValueError(f"bits (n, {T}) do not match a table of {table.shape[0]} points")
        out = np.zeros((n, self.coords * self.nl), dtype=np.uint64)
        self._call("msm_bits_batch", _ptr(table), _ptr(bits), T, _ptr(out), n)
        return self.to_affine(out)


class NativeTECurve(_NativeCurve):
    """The engine on a twisted-Edwards curve: extended (X, Y, T, Z) rows."""

    coords, prefix = 4, "te"

    def _new(self):
        c = self.curve
        return self.lib.cpm_te_new(*self.codec.field_args(), _ptr(self.codec.limbs([c.a])),
                                   _ptr(self.codec.limbs([c.d])))

    def pack(self, pts) -> np.ndarray:
        p = self.curve.base.p
        vals = []
        for x, y in pts:
            x, y = int(x) % p, int(y) % p
            vals += [x, y, x * y % p, 1]
        return np.ascontiguousarray(self.codec.limbs(vals).reshape(len(pts), 4 * self.nl))

    def to_affine(self, ext: np.ndarray) -> list:
        """(n, 4 N) extended rows -> n affine (x, y) tuples."""
        ext = self.codec.rows(ext, 4 * self.nl)
        n = ext.shape[0]
        xy = np.zeros((n, 2 * self.nl), dtype=np.uint64)
        self._call("to_affine_batch", _ptr(ext), _ptr(xy), n)
        flat = self.codec.ints(xy.reshape(-1, self.nl))
        return [(flat[2 * i], flat[2 * i + 1]) for i in range(n)]


class NativeSWCurve(_NativeCurve):
    """The engine on a short-Weierstrass curve: projective (X, Y, Z) rows,
    ``None`` for the identity."""

    coords, prefix = 3, "sw"

    def _new(self):
        c, p = self.curve, self.curve.base.p
        consts = (self.codec.limbs([v]) for v in (c.a, 3 * c.b % p, c.a * c.a % p))
        return self.lib.cpm_sw_new(*self.codec.field_args(), *(_ptr(x) for x in consts))

    def pack(self, pts) -> np.ndarray:
        vals = []
        for pt in pts:
            vals += [0, 1, 0] if pt is None else [int(pt[0]), int(pt[1]), 1]
        return np.ascontiguousarray(self.codec.limbs(vals).reshape(len(pts), 3 * self.nl))

    def to_affine(self, proj: np.ndarray) -> list:
        """(n, 3 N) projective rows -> n affine (x, y) tuples or ``None``."""
        proj = self.codec.rows(proj, 3 * self.nl)
        n = proj.shape[0]
        xy = np.zeros((n, 2 * self.nl), dtype=np.uint64)
        inf = np.zeros((n,), dtype=np.uint8)
        self._call("to_affine_batch", _ptr(proj), _ptr(xy), _ptr(inf), n)
        flat = self.codec.ints(xy.reshape(-1, self.nl))
        return [None if inf[i] else (flat[2 * i], flat[2 * i + 1]) for i in range(n)]


@functools.cache
def curve_engine(curve):
    """The engine for a TE or SW curve spec, made once per curve; raises
    ``ValueError`` for a base field it does not take."""
    if isinstance(curve, TECurveSpec):
        return NativeTECurve(curve)
    if isinstance(curve, SWCurveSpec):
        return NativeSWCurve(curve)
    raise TypeError(f"not a curve spec: {curve!r}")


class NativePoseidon:
    """The Poseidon permutation over a ``PoseidonConfig`` on the engine."""

    def __init__(self, config):
        self.config, self.codec = config, Codec(config.field)
        self.lib = load()
        tables = [self.codec.limbs([v for row in m for v in row]) for m in (config.ark, config.mds)]
        nl, p, one, n0 = self.codec.field_args()
        self.ctx = self.lib.cpm_poseidon_new(nl, p, one, n0, config.t, config.alpha, config.full_rounds,
                                             config.partial_rounds, *(_ptr(x) for x in tables))

    def _check_duplex(self) -> None:
        if self.config.capacity != 1 or self.config.rate < 2:
            raise ValueError("two-to-one compression needs capacity 1 and rate >= 2")

    def permute(self, states) -> List[List[int]]:
        t = self.config.t
        arr = self.codec.limbs([v for st in states for v in st])
        self.lib.cpm_poseidon_permute(self.ctx, _ptr(arr), len(states))
        flat = self.codec.ints(arr)
        return [flat[i * t:(i + 1) * t] for i in range(len(states))]

    def two_to_one_words(self, left, right) -> np.ndarray:
        """left, right (n, W) Montgomery words -> (n, W): ``permute([0, l,
        r])[1]``, the duplex compression, on word rows."""
        self._check_duplex()
        a, b = self.codec.from_words(left), self.codec.from_words(right)
        if a.shape != b.shape:
            raise ValueError(f"left and right hold {len(a)} and {len(b)} rows")
        out = np.zeros_like(a)
        self.lib.cpm_poseidon_two_to_one(self.ctx, _ptr(a), _ptr(b), _ptr(out), len(a))
        return self.codec.to_words(out)

    def two_to_one(self, left, right) -> List[int]:
        """The batched compression of ints (capacity 1, rate >= 2)."""
        words = self.two_to_one_words(self.codec.to_words(self.codec.limbs(left)),
                                      self.codec.to_words(self.codec.limbs(right)))
        return self.codec.ints(self.codec.from_words(words))

    def merkle_non_leaf(self, leaf_digests) -> List[int]:
        """Level-order non-leaf digests (root first), laid out as
        ``MerkleTree.non_leaf_nodes``."""
        n = len(leaf_digests)
        if n < 2 or n & (n - 1):
            raise ValueError("the leaf count must be a power of two, at least 2")
        self._check_duplex()
        leaves = self.codec.limbs(leaf_digests)
        out = np.zeros((n - 1, self.codec.nl), dtype=np.uint64)
        self.lib.cpm_merkle_build(self.ctx, _ptr(leaves), n, _ptr(out))
        return self.codec.ints(out)


@functools.cache
def poseidon_engine(config) -> NativePoseidon:
    """The engine's Poseidon for a config, made once per config; raises
    ``ValueError`` for a field it does not take."""
    return NativePoseidon(config)
