"""The port's curve tier against crypto_primitives_tpu.ops.curve / curve_sw.

Host ops (affine arithmetic, scalar multiplication, square roots, point
sampling from one ``random.Random`` seed, serialization) are compared as
Python ints and bytes.  Batched ops (complete additions with doubling,
identity and inverse pairs; negation; sums; the affine step) take the same
points, made from a seed, through the JAX limb tier and the port's plain
PyTorch tier on the CPU; they take the same steps, so the outputs are
compared word for word after ``interop.words_from_limbs``, and as affine
points.  Tolerance: exact equality throughout (integer outputs).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_primitives_tpu.ops import curve as jcv
from crypto_primitives_tpu.ops import curve_sw as jsw
from crypto_primitives_tpu.ops import curves_known as jck
from crypto_primitives_tpu.ops import field as jff
from crypto_primitives_tpu.ops.curve_sw import SWCurveSpec as JSWCurveSpec
from crypto_primitives_tpu.ops.fields_known import BLS12_381_FR as JFR
from crypto_primitives_tpu_torch import interop
from crypto_primitives_tpu_torch.ops import curve as tcv
from crypto_primitives_tpu_torch.ops import curve_sw as tsw
from crypto_primitives_tpu_torch.ops import curves_known as tck
from crypto_primitives_tpu_torch.ops import field as tff
from crypto_primitives_tpu_torch.ops.curve_sw import SWCurveSpec
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR

torch.set_num_threads(1)

TE_NAMES = ["JUBJUB", "ED_ON_BLS12_377", "ED25519"]
SW_NAMES = ["PALLAS", "BLS12_381_G1", "SECP256R1"]


def general_a_pair():
    """y^2 = x^3 - 3x + 1 over BLS12-381 Fr, on both sides from the same
    constants: a curve with a != 0 over a field with 32-bit words (x^3 - 3x + 1
    has no root in Fr, so there is no point of order 2 and the RCB law is
    complete).  Its order is not computed; only the group law is used."""
    j = JSWCurveSpec("test_a3", JFR, JFR, -3, 1, 1, (0, 1))
    t = SWCurveSpec("test_a3", BLS12_381_FR, BLS12_381_FR, -3, 1, 1, (0, 1))
    return j, t


def _pair(name):
    if name == "A3":
        return general_a_pair()
    return getattr(jck, name), getattr(tck, name)


@pytest.mark.parametrize("name", TE_NAMES + SW_NAMES)
def test_known_curves_identical(name):
    j, t = _pair(name)
    assert (t.name, t.base.p, t.scalar.p, t.a, t.cofactor, t.generator) == \
        (j.name, j.base.p, j.scalar.p, j.a, j.cofactor, j.generator)
    coeff = "d" if name in TE_NAMES else "b"
    assert getattr(t, coeff) == getattr(j, coeff)


@pytest.mark.parametrize("name", TE_NAMES + SW_NAMES + ["A3"])
def test_host_ops_and_sampling_match_jax(name):
    j, t = _pair(name)
    # the same Random seed gives the same points, and leaves the same state
    rj, rt = random.Random(11), random.Random(11)
    pts = [t.rand_point(rt) for _ in range(3)]
    assert pts == [j.rand_point(rj) for _ in range(3)]
    assert rj.random() == rt.random()
    P, Q, R = pts
    assert t.is_on_curve(P) and t.is_on_curve(Q)
    assert t.add_host(P, Q) == j.add_host(P, Q)
    assert t.double_host(R) == j.double_host(R)
    assert t.neg_host(P) == j.neg_host(P)
    assert t.add_host(P, t.neg_host(P)) == t.zero_host() == j.zero_host()
    assert t.add_host(P, t.zero_host()) == P
    k = 0x1234567890ABCDEF1234567
    assert t.scalar_mul_host(Q, k) == j._scalar_mul_py(Q, k)
    for n in (0, 2, 3, 5, 1234567, t.base.p - 1):
        assert t.sqrt_host(n) == j.sqrt_host(n)
    for pt in (P, Q, t.zero_host()):
        assert t.to_uncompressed_bytes(pt) == j.to_uncompressed_bytes(pt)
        assert t.serialize_compressed(pt) == j.serialize_compressed(pt)
    if name not in TE_NAMES:
        for pt in (P, Q, None):
            assert t.deserialize_compressed(t.serialize_compressed(pt)) == pt


@pytest.mark.parametrize("name", TE_NAMES[:2])
def test_deterministic_generators_match(name):
    j, t = _pair(name)
    assert tck.deterministic_generator(t) == jck.deterministic_generator(j)


def _points(j, t, seed, n):
    """n points from one seed: random points, a doubling pair, the identity
    on either side, an inverse pair."""
    rng = random.Random(seed)
    base = [t.rand_point(rng) for _ in range(n)]
    lhs = base + [base[0], t.zero_host(), base[1], base[2]]
    rhs = base[::-1] + [base[0], base[3], t.zero_host(), t.neg_host(base[2])]
    return lhs, rhs


@pytest.mark.parametrize("name", TE_NAMES + SW_NAMES + ["A3"])
def test_batched_add_neg_affine_match_jax_words(name):
    j, t = _pair(name)
    lhs, rhs = _points(j, t, 5, 4)
    jl, jr = j.pack_points(lhs), j.pack_points(rhs)
    tl, tr = torch.from_numpy(t.pack_points(lhs)), torch.from_numpy(t.pack_points(rhs))
    q = t.base  # P-256's Montgomery forms are rescaled across (R = 2^272 in JAX, 2^288 here)
    assert np.array_equal(interop.words_from_limbs(jl, q), tl.numpy())
    if name in TE_NAMES:
        jadd, tadd, jneg, tneg, jaff, taff = jcv.te_add, tcv.te_add, jcv.te_neg, tcv.te_neg, jcv.te_to_affine, tcv.te_to_affine
    else:
        jadd, tadd, jneg, tneg, jaff, taff = jsw.sw_add, tsw.sw_add, jsw.sw_neg, tsw.sw_neg, jsw.sw_to_affine, tsw.sw_to_affine
    jsum = np.asarray(jadd(j, jnp.asarray(jl), jnp.asarray(jr)))
    tsum = tadd(t, tl, tr)
    assert np.array_equal(interop.words_from_limbs(jsum, q), tsum.numpy())  # word for word
    want = [t.add_host(a, b) for a, b in zip(lhs, rhs)]
    assert list(t.unpack_points(tsum)) == want
    assert np.array_equal(interop.words_from_limbs(np.asarray(jneg(j, jnp.asarray(jl))), q), tneg(t, tl).numpy())
    # the affine step: Fermat inversion; an SW identity maps to (0, 0)
    jxy = np.asarray(jaff(j, jnp.asarray(jsum)))
    txy = taff(t, tsum)
    assert np.array_equal(interop.words_from_limbs(jxy, q), txy.numpy())
    host = [(0, 0) if pt is None else pt for pt in want]
    assert [tuple(int(v) for v in row) for row in t.base.unpack(txy)] == host


@pytest.mark.parametrize("name", ["JUBJUB", "PALLAS"])
def test_batched_sums_match_host(name):
    j, t = _pair(name)
    rng = random.Random(8)
    pts = [t.rand_point(rng) for _ in range(7)]
    table = torch.from_numpy(t.pack_points(pts))
    total = t.zero_host()
    for pt in pts:
        total = t.add_host(total, pt)
    tsum, ident = (tcv.te_sum, tcv.identity) if name == "JUBJUB" else (tsw.sw_sum, tsw.identity)
    assert t.unpack_points(tsum(t, table)) == total
    assert list(t.unpack_points(ident(t, (2,), "cpu"))) == [t.zero_host()] * 2
    if name == "JUBJUB":  # the per-bit conditional sum, over three chunks
        bits = np.random.default_rng(3).integers(0, 2, (4, 7), dtype=np.uint8)
        bits[0], bits[1] = 0, 1
        got = t.unpack_points(tcv.te_conditional_sum(t, table, torch.from_numpy(bits), chunk=3))
        for b in range(4):
            want = t.zero_host()
            for i in range(7):
                if bits[b, i]:
                    want = t.add_host(want, pts[i])
            assert got[b] == want


def test_p256_points_pack_and_unpack_match_jax():
    """P-256 on the batched tier: packed points (the identity among them)
    equal the JAX package's after interop's rescaling, both ways, and unpack
    to the same host points; the projective sum of a doubling pair equals
    JAX's ``sw_add`` after canonicalising."""
    j, t = _pair("SECP256R1")
    rng = random.Random(12)
    pts = [t.rand_point(rng) for _ in range(5)] + [None, t.generator]
    jl, tw = j.pack_points(pts), t.pack_points(pts)
    assert tw.shape == (7, 3, 9) and jl.shape == (7, 3, 17)
    assert np.array_equal(interop.words_from_limbs(jl, t.base), tw)
    assert np.array_equal(interop.limbs_from_words(tw, t.base), jl)
    assert t.unpack_points(tw) == j.unpack_points(jl) == pts
    doubled = tsw.sw_add(t, torch.from_numpy(tw), torch.from_numpy(tw))
    jdoubled = np.asarray(jsw.sw_add(j, jnp.asarray(jl), jnp.asarray(jl)))
    assert t.unpack_points(doubled) == j.unpack_points(jdoubled) == [t.double_host(pt) for pt in pts]


@pytest.mark.parametrize("fname", ["BLS12_381_FR", "BLS12_381_FQ"])
def test_new_field_ops_match_jax(fname):
    from crypto_primitives_tpu.ops import fields_known as jfk
    from crypto_primitives_tpu_torch.ops import fields_known as tfk

    js, ts = getattr(jfk, fname), getattr(tfk, fname)
    rng = np.random.default_rng(4)
    vals = [int.from_bytes(rng.bytes(56), "little") % ts.p for _ in range(13)] + [0, 1, ts.p - 1]
    jl, tw = jnp.asarray(js.pack(vals)), torch.from_numpy(ts.pack(vals))
    for jop, top in ((lambda a: jff.neg(js, a), lambda a: tff.neg(ts, a)),
                     (lambda a: jff.inv(js, a), lambda a: tff.inv(ts, a)),
                     (lambda a: jff.mul_small(js, a, 12345), lambda a: tff.mul_small(ts, a, 12345))):
        assert np.array_equal(interop.words_from_limbs(np.asarray(jop(jl))), top(tw).numpy())
    inv = ts.unpack(tff.inv(ts, tw))
    assert [int(v) for v in inv] == [pow(v, -1, ts.p) if v else 0 for v in vals]
    other = torch.flip(tw, [0])
    assert torch.equal(tff.eq(ts, tw, other), torch.from_numpy(np.array(jff.eq(js, jl, jl[::-1]))))
    assert tff.is_zero(ts, tw).tolist() == [v == 0 for v in vals]
    mask = torch.from_numpy(rng.integers(0, 2, len(vals)).astype(bool))
    assert torch.equal(tff.select(mask, tw, other), torch.where(mask[:, None], tw, other))
