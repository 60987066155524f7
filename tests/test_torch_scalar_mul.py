"""The port's scalar multiplications and the field and curve ops under them,
against crypto_primitives_tpu.

Field ``ones``, ``mont_sqr``, ``pow_dynamic`` and ``batch_inv`` (a zero in
the batch included) and the limb-tier curve ops (doubling, double-and-add,
projective equality with SW infinity on either or both sides, the SW
conditional sum) take the same inputs through the JAX limb tier and the
port's plain PyTorch tier on the CPU; where both take the same steps they
are compared word for word after ``interop.words_from_limbs``, else as
affine points.  The fixed-base tables equal the JAX package's on values;
the fixed-base and windowed products equal JAX's RNS tier on JubJub and the
host oracle on every known curve, for scalars 0, 1, r - 1 and random ones at
251-256 bits; ``msm_many`` equals its single calls and JAX's.  Inputs come
from numpy and ``random.Random`` seeds; tolerance: exact equality (integer
outputs).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_primitives_tpu.models.crh.pedersen import PedersenCRH as JCRH
from crypto_primitives_tpu.models.crh.pedersen import Window as JWindow
from crypto_primitives_tpu.ops import curve as jcv
from crypto_primitives_tpu.ops import curve_rns as jcr
from crypto_primitives_tpu.ops import curve_sw as jsw
from crypto_primitives_tpu.ops import curve_sw_rns as jsr
from crypto_primitives_tpu.ops import curves_known as jck
from crypto_primitives_tpu.ops import field as jff
from crypto_primitives_tpu.ops import fields_known as jfk
from crypto_primitives_tpu_torch import interop
from crypto_primitives_tpu_torch.models.crh import PedersenCRH, Window
from crypto_primitives_tpu_torch.ops import curve as tcv
from crypto_primitives_tpu_torch.ops import curve_fast, curve_sw_fast
from crypto_primitives_tpu_torch.ops import curve_sw as tsw
from crypto_primitives_tpu_torch.ops import curves_known as tck
from crypto_primitives_tpu_torch.ops import field as tff
from crypto_primitives_tpu_torch.ops import fields_known as tfk
from crypto_primitives_tpu_torch.ops.curve import TECurveSpec
from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod
from crypto_primitives_tpu_torch.ops.curve_sw import SWCurveSpec

torch.set_num_threads(1)


def _values(p, seed, n=13):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(56), "little") % p for _ in range(n)] + [1, p - 1]


def _words(jarr, spec=None):
    return torch.from_numpy(interop.words_from_limbs(np.asarray(jarr), spec))


def _bits(ks, nbits):
    """Scalars (each < 2^nbits) -> (n, nbits) uint8 bits, least significant first."""
    return np.asarray([[(k >> i) & 1 for i in range(nbits)] for k in ks], dtype=np.uint8)


# ---------------------------------------------------------------- field


@pytest.mark.parametrize("fname", ["BLS12_381_FR", "BLS12_381_FQ"])
def test_field_ones_sqr_pow_dynamic_match_jax(fname):
    js, ts = getattr(jfk, fname), getattr(tfk, fname)
    vals = _values(ts.p, 1) + [0]
    jl = jnp.asarray(js.pack(vals))
    tw = torch.from_numpy(ts.pack(vals))
    assert torch.equal(tff.ones(ts, (2, 3)), _words(jff.ones(js, (2, 3))))
    assert ts.unpack(tff.ones(ts)) == 1
    assert torch.equal(tff.mont_sqr(ts, tw), _words(jff.mont_sqr(js, jl)))
    # per-element exponents, standard form: random ones, 0, 1 and p - 1
    exps = _values(ts.p, 2, n=len(vals) - 5) + [0, 1, ts.p - 1]
    got = tff.pow_dynamic(ts, tw, torch.from_numpy(ts.pack(exps, mont=False)))
    want = jff.pow_dynamic(js, jl, jnp.asarray(js.pack(exps, mont=False)))
    assert torch.equal(got, _words(want))
    assert list(ts.unpack(got)) == [pow(v, e, ts.p) for v, e in zip(vals, exps)]


def test_batch_inv_matches_jax_and_zeroes_a_batch_holding_zero():
    """Without a zero, every element's inverse, word for word with JAX, along
    axis 0 and axis 1; with a zero anywhere in the batch, every output is 0 in
    both packages (the inverse of the batch's product is 0)."""
    js, ts = jfk.BLS12_381_FR, tfk.BLS12_381_FR
    vals = _values(ts.p, 3, n=6)  # 8 nonzero values
    jl, tw = js.pack(vals), torch.from_numpy(ts.pack(vals))
    got = tff.batch_inv(ts, tw)
    assert torch.equal(got, _words(jff.batch_inv(js, jnp.asarray(jl))))
    assert list(ts.unpack(got)) == [pow(v, -1, ts.p) for v in vals]
    grid = tw.reshape(2, 4, -1)
    got = tff.batch_inv(ts, grid, axis=1)
    assert torch.equal(got, _words(jff.batch_inv(js, jnp.asarray(jl.reshape(2, 4, -1)), axis=1)))
    assert torch.equal(got.reshape(8, -1), tff.batch_inv(ts, tw))
    with_zero = vals[:3] + [0] + vals[3:]
    jz = jff.batch_inv(js, jnp.asarray(js.pack(with_zero)))
    tz = tff.batch_inv(ts, torch.from_numpy(ts.pack(with_zero)))
    assert torch.equal(tz, _words(jz))
    assert list(ts.unpack(tz)) == [0] * len(with_zero)


# ---------------------------------------------------------------- limb-tier curve ops


def _rescaled(t, pts, lam):
    """(N, C, W) points with every coordinate times lam: the same projective points."""
    return tff.mul_small(t.base, pts, lam)


def test_te_double_scalar_mul_eq_match_jax():
    j, t = jck.JUBJUB, tck.JUBJUB
    rng = random.Random(5)
    pts = [t.rand_point(rng) for _ in range(3)] + [t.zero_host()]
    r = t.scalar.p
    ks = [0, 1, r - 1, rng.randrange(r)]
    jp, tp = jnp.asarray(j.pack_points(pts)), torch.from_numpy(t.pack_points(pts))
    assert torch.equal(tcv.te_double(t, tp), _words(jcv.te_double(j, jp)))
    bits = _bits(ks, t.scalar.nbits)
    got = tcv.te_scalar_mul_bits(t, tp, torch.from_numpy(bits))
    assert torch.equal(got, _words(jcv.te_scalar_mul_bits(j, jp, jnp.asarray(bits))))
    assert list(t.unpack_points(got)) == [t.scalar_mul_host(p, k) for p, k in zip(pts, ks)]
    # equal points in other projective forms; distinct points
    other = _rescaled(t, tp, 7)
    shifted = torch.roll(tp, 1, 0)
    for a, b in ((tp, other), (tp, shifted), (tcv.te_double(t, tp), tcv.te_add(t, tp, other))):
        want = np.asarray(jcv.te_eq(j, jnp.asarray(interop.limbs_from_words(a.numpy())),
                                    jnp.asarray(interop.limbs_from_words(b.numpy()))))
        assert tcv.te_eq(t, a, b).tolist() == want.tolist()
    assert tcv.te_eq(t, tp, other).all() and not tcv.te_eq(t, tp, shifted).any()


def _eq_operands(t, tp):
    """Pairs of (P, Q, inf) rows: equal points in other projective forms,
    infinity on either or both sides."""
    a = torch.cat([tp, tp[2:], tp[:1], _rescaled(t, tp[2:], 3)])  # P, Q, inf, inf, P, inf'
    b = torch.cat([_rescaled(t, tp, 9), tp[:1], tp[2:], tp[2:]])  # P', Q', inf', P, inf, inf
    return a, b


EQ_WANT = [True, True, True, False, False, True]


def test_sw_double_scalar_mul_eq_match_jax():
    """Pallas through the JAX limb tier (its SW ops run eagerly there and
    take seconds each to compile, so one curve)."""
    j, t = jck.PALLAS, tck.PALLAS
    rng = random.Random(6)
    pts = [t.rand_point(rng) for _ in range(2)] + [None]
    r = t.scalar.p
    ks = [rng.randrange(r), r - 1, 5]
    jp, tp = jnp.asarray(j.pack_points(pts)), torch.from_numpy(t.pack_points(pts))
    bits = _bits(ks, t.scalar.nbits)
    got = tsw.sw_scalar_mul_bits(t, tp, torch.from_numpy(bits))
    assert torch.equal(got, _words(jsw.sw_scalar_mul_bits(j, jp, jnp.asarray(bits))))
    assert t.unpack_points(got) == [t.scalar_mul_host(p, k) for p, k in zip(pts, ks)]
    assert t.unpack_points(tsw.sw_double(t, tp)) == [t.double_host(p) for p in pts]
    a, b = _eq_operands(t, tp)
    want = np.asarray(jsw.sw_eq(j, jnp.asarray(interop.limbs_from_words(a.numpy())),
                                jnp.asarray(interop.limbs_from_words(b.numpy()))))
    assert tsw.sw_eq(t, a, b).tolist() == want.tolist() == EQ_WANT


@pytest.mark.parametrize("name", ["BLS12_381_G1", "SECP256R1"])
def test_sw_double_scalar_mul_eq_conditional_sum_match_host(name):
    t = getattr(tck, name)
    rng = random.Random(6)
    pts = [t.rand_point(rng) for _ in range(2)] + [None]
    ks = [rng.randrange(1 << 64), (1 << 64) - 1, 5]
    tp = torch.from_numpy(t.pack_points(pts))
    assert t.unpack_points(tsw.sw_double(t, tp)) == [t.double_host(p) for p in pts]
    got = tsw.sw_scalar_mul_bits(t, tp, torch.from_numpy(_bits(ks, 64)))
    assert t.unpack_points(got) == [t.scalar_mul_host(p, k) for p, k in zip(pts, ks)]
    assert tsw.sw_eq(t, *_eq_operands(t, tp)).tolist() == EQ_WANT
    # the per-bit conditional sum, over two chunks
    table = [t.rand_point(rng) for _ in range(5)]
    sel = np.random.default_rng(6).integers(0, 2, (3, 5), dtype=np.uint8)
    sel[0] = 0
    got = tsw.sw_conditional_sum(t, torch.from_numpy(t.pack_points(table)), torch.from_numpy(sel), chunk=3)
    host = []
    for row in sel:
        acc = None
        for bit, pt in zip(row, table):
            acc = t.add_host(acc, pt) if bit else acc
        host.append(acc)
    assert t.unpack_points(got) == host


@pytest.mark.parametrize("name", ["JUBJUB", "PALLAS"])
def test_dev_methods_are_the_batched_ops(name):
    t = getattr(tck, name)
    rng = random.Random(7)
    pts = torch.from_numpy(t.pack_points([t.rand_point(rng) for _ in range(3)]))
    bits = torch.from_numpy(_bits([3, 0, 11], 4))
    mod = tcv if isinstance(t, TECurveSpec) else tsw
    pre = "te" if isinstance(t, TECurveSpec) else "sw"
    assert torch.equal(t.dev_identity((3,), device="cpu"), mod.identity(t, (3,), "cpu"))
    assert torch.equal(t.dev_add(pts, pts), getattr(mod, f"{pre}_add")(t, pts, pts))
    assert torch.equal(t.dev_neg(pts), getattr(mod, f"{pre}_neg")(t, pts))
    assert torch.equal(t.dev_to_affine(pts), getattr(mod, f"{pre}_to_affine")(t, pts))
    assert torch.equal(t.dev_scalar_mul_bits(pts, bits), getattr(mod, f"{pre}_scalar_mul_bits")(t, pts, bits))
    assert torch.equal(t.dev_conditional_sum(pts, bits[:, :3]),
                       getattr(mod, f"{pre}_conditional_sum")(t, pts, bits[:, :3]))


# ---------------------------------------------------------------- fixed-base tables


@pytest.mark.parametrize("name", ["JUBJUB", "ED_ON_BLS12_377", "BLS12_381_G1", "SECP256R1"])
def test_fixed_base_tables_match_jax(name):
    j, t = getattr(jck, name), getattr(tck, name)
    nbits = t.scalar.nbits
    jmod = jcr if isinstance(t, TECurveSpec) else jsr
    jtab = jmod.fixed_base_grouped_table(j, t.generator, nbits, 3)
    ttab = fast_mod(t).fixed_base_grouped_table(t, t.generator, nbits, 3)
    G = -(-nbits // 3)
    assert ttab.shape[:2] == jtab.shape[:2] == (G, 8)
    jentries = list(np.asarray(jmod.unpack_points_rns(j, jtab)).reshape(-1))
    if isinstance(t, TECurveSpec):
        flat = t.base.unpack(ttab.reshape(-1, 3, ttab.shape[-1]))
        tentries = [(int(x), int(y)) for x, y, _ in flat]
    else:
        tentries = t.unpack_points(ttab.reshape(-1, 3, ttab.shape[-1]))
    assert tentries == jentries
    # group g (a whole one), entry e: the sum of 2^(3g + i) G over the set bits i of e
    g, e = G - 2, 5
    want = t.add_host(t.scalar_mul_host(t.generator, 1 << (3 * g)), t.scalar_mul_host(t.generator, 1 << (3 * g + 2)))
    assert tentries[8 * g + e] == want


# ---------------------------------------------------------------- fixed-base and windowed products


def _scalars(t, nbits, seed):
    top = min(t.scalar.p - 1, (1 << nbits) - 1)
    rng = random.Random(seed)
    return [0, 1, top, rng.randrange(1 << nbits), rng.randrange(t.scalar.p) % (1 << nbits)]


def test_fixed_base_and_windowed_match_jax_rns_on_jubjub():
    j, t = jck.JUBJUB, tck.JUBJUB
    nbits = t.scalar.nbits
    ks = _scalars(t, nbits, 8)
    bits = _bits(ks, nbits)
    want = list(jcr.unpack_affine_rns(j, jcr.te_fixed_base_mul_rns(j, j.generator, jnp.asarray(bits))))
    got = curve_fast.unpack_affine(t, curve_fast.te_fixed_base_mul(t, t.generator, torch.from_numpy(bits)))
    assert list(got) == want == [t.scalar_mul_host(t.generator, k) for k in ks]
    rng = random.Random(9)
    base = [t.rand_point(rng) for _ in ks]
    jwin = jcr.te_scalar_mul_bits_windowed_rns(j, jnp.asarray(jcr.pack_points_rns(j, base)), jnp.asarray(bits))
    twin = curve_fast.te_scalar_mul_bits_windowed(t, torch.from_numpy(t.pack_points(base)), torch.from_numpy(bits))
    assert list(curve_fast.unpack_affine(t, twin)) == list(jcr.unpack_affine_rns(j, jwin)) == \
        [t.scalar_mul_host(p, k) for p, k in zip(base, ks)]
    # one base, broadcast over the batch
    one = curve_fast.te_scalar_mul_bits_windowed(t, torch.from_numpy(t.pack_points(base[0])), torch.from_numpy(bits))
    assert list(curve_fast.unpack_affine(t, one)) == [t.scalar_mul_host(base[0], k) for k in ks]


@pytest.mark.parametrize("name,nbits", [("JUBJUB", 252), ("JUBJUB", 256), ("ED_ON_BLS12_377", 251), ("ED25519", 253),
                                        ("BLS12_381_G1", 255), ("PALLAS", 254), ("SECP256R1", 256)])
def test_fixed_base_and_windowed_match_host(name, nbits):
    """nbits = 252, 251, 253, 255 or 254 (the scalar field's) and 256: G =
    84-86 groups of 3.  The windowed product takes a base per row (the SW
    identity among them) at w = 3."""
    t = getattr(tck, name)
    mod = fast_mod(t)
    ks = _scalars(t, nbits, nbits)
    bits = torch.from_numpy(_bits(ks, nbits))
    got = mod.unpack_affine(t, mod.fixed_base_mul(t, t.generator, bits))
    assert list(got) == [t.scalar_mul_host(t.generator, k) for k in ks]
    rng = random.Random(nbits)
    base = [t.rand_point(rng) for _ in ks]
    if isinstance(t, SWCurveSpec):
        base[2] = None
    win = mod.scalar_mul_bits_windowed(t, torch.from_numpy(mod.pack_points(t, base)), bits, w=3)
    assert list(mod.unpack_affine(t, win)) == [t.scalar_mul_host(p, k) for p, k in zip(base, ks)]


def test_scalars_to_bits_reduce_mod_r_and_unpack_single_points():
    t = tck.BLS12_381_G1
    r = t.scalar.p
    bits = curve_sw_fast.scalars_to_bits(t, [r + 5, 2 ** 254])
    assert bits.shape == (2, 255)
    assert [sum(int(b) << i for i, b in enumerate(row)) for row in bits] == [5, 2 ** 254]
    # a single point in, a single point (or None) out
    assert curve_sw_fast.unpack_affine(t, torch.from_numpy(curve_sw_fast.pack_points(t, t.generator))) == t.generator
    assert curve_sw_fast.unpack_affine(t, torch.from_numpy(curve_sw_fast.pack_points(t, None))) is None
    te = tck.JUBJUB
    assert curve_fast.unpack_affine(te, torch.from_numpy(curve_fast.pack_points(te, te.generator))) == te.generator
    # (0, 0) is read as the identity only where it is on no curve (b != 0)
    b0 = SWCurveSpec("b0", t.base, t.scalar, 1, 0, 1)
    with pytest.raises(ValueError):
        curve_sw_fast.unpack_affine(b0, torch.from_numpy(b0.pack_points([None])))


# ---------------------------------------------------------------- msm_many


def test_msm_many_matches_single_calls_and_jax():
    """Two Pedersen parameter sets with their own tables, input lengths and
    batch sizes:
    ``msm_many`` (through ``evaluate_batch_many``) equals the single calls
    word for word, and JAX's ``evaluate_batch_rns_many`` as affine points."""
    j, t = jck.JUBJUB, tck.JUBJUB
    jcrh, tcrh = JCRH(j, JWindow(6, 8)), PedersenCRH(t, Window(6, 8))
    jparams, tparams, inputs = [], [], []
    for seed, (nbytes, rows) in enumerate([(5, 3), (3, 5)]):
        jparams.append(jcrh.setup(random.Random(seed)))
        tparams.append(tcrh.setup(random.Random(seed)))
        inputs.append(np.random.default_rng(seed).integers(0, 256, (rows, nbytes), dtype=np.uint8))
    got = tcrh.evaluate_batch_many(tparams, inputs, device="cpu")
    singles = [tcrh.evaluate_batch_projective(p, x, device="cpu") for p, x in zip(tparams, inputs)]
    assert all(torch.equal(a, b) for a, b in zip(got, singles))
    want = jcrh.evaluate_batch_rns_many(jparams, [jnp.asarray(x) for x in inputs])
    for g, w, p, x in zip(got, want, tparams, inputs):
        host = [tcrh.evaluate(p, bytes(row)) for row in x]
        assert list(curve_fast.unpack_affine(t, g)) == list(jcr.unpack_affine_rns(j, w)) == host
    # the SW model takes the same route
    s = tck.PALLAS
    scrh = PedersenCRH(s, Window(6, 8))
    sp = [scrh.setup(random.Random(5)), scrh.setup(random.Random(6))]
    sx = [inputs[0], inputs[0][:2]]
    got = curve_sw_fast.msm_many(s, sp, [torch.from_numpy(np.unpackbits(x, axis=1, bitorder="little")) for x in sx])
    assert [s.unpack_points(g) for g in got] == [[scrh.evaluate(p, bytes(row)) for row in x] for p, x in zip(sp, sx)]
