"""The port's compiled host engine (``native/engine.py`` over
``native/cpmont.cpp``) held three ways, as tests/test_native.py holds the JAX
package's: the port's python-int host tier, the engine, and the port's
batched tier on the CPU (the kernels' plain versions); and once each against
the JAX package's python-int results from the same seed.  Montgomery
products and inverses (0 included), the Poseidon permutation, two-to-one
compression and Merkle build, and TE and SW scalar products, bit-table MSMs
and the affine step on ed-on-bls12-377, Pallas and BLS12-381 G1 (the
six-limb case).  Tolerance: exact equality.
"""

import random

import numpy as np
import pytest
import torch

from crypto_primitives_tpu_torch.native import engine
from crypto_primitives_tpu_torch.ops import curve_fast, curve_fast_any, curve_sw_fast
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops.curves_known import BLS12_381_G1, ED_ON_BLS12_377, PALLAS, SECP256R1
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FQ, BLS12_381_FR

torch.set_num_threads(1)

SEED = 20261017


def _fq_config():
    from crypto_primitives_tpu_torch.models.sponge import PoseidonConfig, find_poseidon_ark_and_mds

    ark, mds = find_poseidon_ark_and_mds(BLS12_381_FQ, 2, 8, 60, 0)
    return PoseidonConfig(BLS12_381_FQ, 8, 60, 5, ark, mds, 2, 1)


def _fr_config():
    from crypto_primitives_tpu_torch.models.sponge import get_default_poseidon_parameters

    return get_default_poseidon_parameters(BLS12_381_FR, 2, False)


@pytest.mark.parametrize("spec", [BLS12_381_FR, BLS12_381_FQ], ids=lambda s: s.name)
def test_mont_mul_and_inverse_three_ways(spec):
    rng = random.Random(SEED)
    xs = [rng.randrange(spec.p) for _ in range(20)] + [0, 1, spec.p - 1]
    ys = [rng.randrange(spec.p) for _ in range(20)] + [spec.p - 1] * 3
    eng = engine.NativeField(spec)
    host = [x * y % spec.p for x, y in zip(xs, ys)]
    assert eng.mont_mul_batch(xs, ys) == host
    batched = ff.mont_mul(spec, torch.from_numpy(spec.pack(xs)), torch.from_numpy(spec.pack(ys)))
    assert [int(v) for v in spec.unpack(batched)] == host
    inv_host = [pow(x, -1, spec.p) if x else 0 for x in xs]  # 0 maps to 0
    assert eng.inv_batch(xs) == inv_host
    assert [int(v) for v in spec.unpack(ff.inv(spec, torch.from_numpy(spec.pack(xs))))] == inv_host


@pytest.mark.parametrize("which", ["fr", "fq"])
def test_poseidon_three_ways(which):
    from crypto_primitives_tpu_torch.models.crh import PoseidonCRH, PoseidonTwoToOneCRH
    from crypto_primitives_tpu_torch.models.merkle_tree import (
        FieldDigestDomain,
        IdentityDigestConverter,
        MerkleTree,
        MerkleTreeConfig,
    )
    from crypto_primitives_tpu_torch.models.sponge import PoseidonSponge, permute

    cfg = _fr_config() if which == "fr" else _fq_config()
    spec = cfg.field
    rng = random.Random(SEED)
    eng = engine.poseidon_engine(cfg)
    assert engine.poseidon_engine(cfg) is eng
    states = [[rng.randrange(spec.p) for _ in range(3)] for _ in range(5)] + [[0, 0, 0]]
    got = eng.permute(states)
    for st, g in zip(states, got):
        oracle = PoseidonSponge(cfg)
        oracle.state = list(st)
        oracle.permute()
        assert g == oracle.state
    batched = permute(cfg, torch.from_numpy(spec.pack(states)))
    assert [[int(v) for v in row] for row in spec.unpack(batched)] == got

    # two-to-one, on ints and on word rows, against the host CRH
    left = [rng.randrange(spec.p) for _ in range(4)]
    right = [rng.randrange(spec.p) for _ in range(4)]
    two = PoseidonTwoToOneCRH(spec)
    want = [two.compress(cfg, a, b) for a, b in zip(left, right)]
    assert eng.two_to_one(left, right) == want
    words = eng.two_to_one_words(spec.pack(left), torch.from_numpy(spec.pack(right)))
    assert [int(v) for v in spec.unpack(words)] == want
    batched = two.compress_batch(cfg, torch.from_numpy(spec.pack(left)), torch.from_numpy(spec.pack(right)),
                                 device="cpu")
    assert torch.equal(batched, torch.from_numpy(words))

    # the dense Merkle build against the generic tree's non-leaf nodes
    leaves = [[rng.randrange(spec.p)] for _ in range(8)]
    mc = MerkleTreeConfig(PoseidonCRH(spec), PoseidonTwoToOneCRH(spec), FieldDigestDomain(spec),
                          FieldDigestDomain(spec), IdentityDigestConverter())
    tree = MerkleTree.new(mc, cfg, cfg, torch.from_numpy(spec.pack(leaves)), device="cpu")
    digests = [int(v) for v in spec.unpack(tree.leaf_nodes)]
    assert eng.merkle_non_leaf(digests) == [int(v) for v in spec.unpack(tree.non_leaf_nodes)]
    with pytest.raises(ValueError):
        eng.merkle_non_leaf(digests[:6])


def test_poseidon_against_jax_python_int():
    from crypto_primitives_tpu.models.sponge import PoseidonSponge as JSponge
    from crypto_primitives_tpu.models.sponge import get_default_poseidon_parameters as jparams
    from crypto_primitives_tpu.ops.fields_known import BLS12_381_FR as JFR

    rng = random.Random(SEED)
    states = [[rng.randrange(JFR.p) for _ in range(3)] for _ in range(4)]
    want = []
    for st in states:
        oracle = JSponge(jparams(JFR, 2, False))
        oracle.state = list(st)
        oracle._permute_python()
        want.append(oracle.state)
    assert engine.poseidon_engine(_fr_config()).permute(states) == want


CURVES = [ED_ON_BLS12_377, PALLAS, BLS12_381_G1]


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_curve_three_ways(curve):
    from crypto_primitives_tpu_torch.ops.curve_fast import scalars_to_bits

    rng = random.Random(SEED)
    eng = engine.curve_engine(curve)
    assert engine.curve_engine(curve) is eng
    assert eng.nl == curve.base.num_words // 2
    mod = curve_fast_any.fast_mod(curve)
    pts = [curve.rand_point(rng) for _ in range(3)]
    ks = [rng.randrange(curve.scalar.p) for _ in range(3)] + [0]
    pts.append(pts[0])

    # scalar products: host, engine, the batched windowed product (plain)
    host = [curve.scalar_mul_host(p, k) for p, k in zip(pts, ks)]
    assert eng.scalar_mul_batch(pts, ks) == host
    bits = torch.from_numpy(scalars_to_bits(curve, ks))
    batched = mod.scalar_mul_bits_windowed(curve, torch.from_numpy(mod.pack_points(curve, pts)), bits)
    ident = (0, 1) if curve.coords == 4 else None
    assert list(mod.unpack_affine(curve, batched)) == [ident if h is None else h for h in host]
    assert eng.add(pts[0], pts[1]) == curve.add_host(pts[0], pts[1])

    # bit-table MSMs: host sums, engine, the grouped sum (plain)
    table_pts = [curve.rand_point(rng) for _ in range(10)]
    msm_bits = np.random.default_rng(SEED).integers(0, 2, (5, 10), dtype=np.uint8)
    msm_bits[0], msm_bits[1] = 0, 1
    want = []
    for row in msm_bits:
        acc = curve.zero_host()
        for b, p in zip(row, table_pts):
            if b:
                acc = curve.add_host(acc, p)
        want.append(acc)
    assert eng.msm_bits(eng.pack_table(table_pts), msm_bits) == want
    table = torch.from_numpy(mod.pack_table_grouped(curve, table_pts, 3))
    grouped = curve_fast.te_conditional_sum_grouped if curve.coords == 4 else curve_sw_fast.sw_conditional_sum_grouped
    sums = grouped(curve, table, torch.from_numpy(msm_bits), 3)
    assert list(mod.unpack_affine(curve, sums)) == want

    # the affine step: the engine's on the batched tier's projective rows
    rows = sums.numpy().reshape(len(want), curve.coords, -1)
    limbs = np.concatenate([eng.codec.from_words(rows[:, c]) for c in range(curve.coords)], axis=1)
    assert eng.to_affine(limbs) == want


@pytest.mark.parametrize("name", ["ED_ON_BLS12_377", "BLS12_381_G1"])
def test_curve_against_jax_python_int(name, monkeypatch):
    from crypto_primitives_tpu.ops import curves_known as jck

    monkeypatch.setenv("CPT_NATIVE", "0")  # JAX's python-int tier, not its own engine
    jcurve = getattr(jck, name)
    curve = ED_ON_BLS12_377 if name == "ED_ON_BLS12_377" else BLS12_381_G1
    rng = random.Random(SEED)
    pts = [curve.rand_point(rng) for _ in range(2)]
    ks = [rng.randrange(curve.scalar.p) for _ in range(2)]
    assert engine.curve_engine(curve).scalar_mul_batch(pts, ks) == [jcurve.scalar_mul_host(p, k)
                                                                    for p, k in zip(pts, ks)]


def test_p256_and_odd_word_counts_raise():
    with pytest.raises(ValueError, match="W = 9"):
        engine.curve_engine(SECP256R1)
    with pytest.raises(ValueError, match="W = 9"):
        engine.NativeField(SECP256R1.base)


def test_build_is_named_by_its_source_and_raises_on_failure(tmp_path, monkeypatch):
    path = engine.library_path()
    assert path.parent == engine.BUILD_DIR and path.name.startswith("libcpmont-")
    assert engine.load() is engine.load()
    assert path.exists() and not list(engine.BUILD_DIR.glob(f"{path.name}.*.tmp"))
    assert not hasattr(engine, "available") and not hasattr(engine, "enabled")  # no probe, no switch
    bad = tmp_path / "cpmont.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(engine, "SRC", bad)
    monkeypatch.setattr(engine, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        engine.load.__wrapped__()
