"""The port's grouped subset-sum MSMs against the JAX package's.

``curve_fast`` / ``curve_sw_fast`` (the plain PyTorch versions of the
``msm_te`` / ``msm_sw`` kernels, on the CPU) against the JAX package's
``te_conditional_sum_grouped_rns`` / ``sw_conditional_sum_grouped_rns``,
unpacked with JAX's own ``unpack_affine_rns``; the grouped tables against
the JAX package's, entry for entry; the edge rows (all-zero and all-one
bits, a point count that fills no whole group, a single row, rows past a
64-row block) against the host oracle.  Inputs are made from a seed;
tolerance: exact equality (integer outputs, compared as affine points).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_primitives_tpu.ops import curve_rns as jcr
from crypto_primitives_tpu.ops import curve_sw_rns as jsr
from crypto_primitives_tpu.ops import curves_known as jck
from crypto_primitives_tpu.ops.curve_sw import SWCurveSpec as JSWCurveSpec
from crypto_primitives_tpu.ops.fields_known import BLS12_381_FR as JFR
from crypto_primitives_tpu_torch.ops import curve_fast, curve_sw_fast, msm_kernel, msm_sw_kernel
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops import curves_known as tck
from crypto_primitives_tpu_torch.ops.curve import TECurveSpec
from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod
from crypto_primitives_tpu_torch.ops.curve_sw import SWCurveSpec
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR

torch.set_num_threads(1)

NPTS = 13  # fills no whole group for w = 2, 3 or 4
ROWS = 6


def _pair(name):
    if name == "A3":  # y^2 = x^3 - 3x + 1 over BLS12-381 Fr: a != 0 (see test_torch_curve.py)
        return (JSWCurveSpec("test_a3", JFR, JFR, -3, 1, 1, (0, 1)),
                SWCurveSpec("test_a3", BLS12_381_FR, BLS12_381_FR, -3, 1, 1, (0, 1)))
    return getattr(jck, name), getattr(tck, name)


def _setup(t, seed, n=NPTS):
    rng = random.Random(seed)
    pts = [t.rand_point(rng)]
    for _ in range(n - 1):
        pts.append(t.add_host(pts[-1], t.rand_point(rng)))
    return pts


def _bits(n, rows, seed):
    bits = np.random.default_rng(seed).integers(0, 2, (rows, n), dtype=np.uint8)
    bits[0], bits[1] = 0, 1  # the identity; every point
    return bits


def _host_sum(t, pts, row):
    acc = t.zero_host()
    for bit, pt in zip(row, pts):
        if bit:
            acc = t.add_host(acc, pt)
    return acc


def _affine(t, aff_words):
    """(n, 2, W) affine words -> host points, (0, 0) read as the SW identity."""
    out = [(int(x), int(y)) for x, y in t.base.unpack(aff_words)]
    return [None if isinstance(t, SWCurveSpec) and pt == (0, 0) else pt for pt in out]


@pytest.mark.parametrize("name,w", [("JUBJUB", 2), ("JUBJUB", 3), ("JUBJUB", 4), ("ED_ON_BLS12_377", 3),
                                    ("PALLAS", 3), ("BLS12_381_G1", 3), ("A3", 3), ("SECP256R1", 3)])
def test_grouped_sum_matches_jax(name, w):
    j, t = _pair(name)
    pts = _setup(t, 100 + w)
    bits = _bits(NPTS, ROWS, w)
    jmod = jcr if isinstance(t, TECurveSpec) else jsr
    mod = fast_mod(t)
    # the tables hold the same points, entry for entry
    jtab = jmod.pack_table_grouped(j, pts, w)
    ttab = mod.pack_table_grouped(t, pts, w)
    assert ttab.shape[:2] == jtab.shape[:2] == (-(-NPTS // w), 1 << w)
    jentries = list(np.asarray(jmod.unpack_points_rns(j, jtab)).reshape(-1))
    if isinstance(t, TECurveSpec):
        flat = t.base.unpack(ttab.reshape(-1, 3, ttab.shape[-1]))
        tentries = [(int(x), int(y)) for x, y, _ in flat]
        assert all(int(dxy) == t.d * int(x) * int(y) % t.base.p for x, y, dxy in flat)
    else:
        tentries = t.unpack_points(ttab.reshape(-1, 3, ttab.shape[-1]))
    assert tentries == jentries
    # the grouped sums, as affine points
    if isinstance(t, TECurveSpec):
        jout = jcr.te_conditional_sum_grouped_rns(j, jnp.asarray(jtab), jnp.asarray(bits), w)
        tout = curve_fast.te_conditional_sum_grouped(t, torch.from_numpy(ttab), torch.from_numpy(bits), w)
    else:
        jout = jsr.sw_conditional_sum_grouped_rns(j, jnp.asarray(jtab), jnp.asarray(bits), w)
        tout = curve_sw_fast.sw_conditional_sum_grouped(t, torch.from_numpy(ttab), torch.from_numpy(bits), w)
    want = list(jmod.unpack_affine_rns(j, np.asarray(jout)))
    assert _affine(t, mod.to_affine(t, tout)) == want
    assert want == [_host_sum(t, pts, row) for row in bits]


@pytest.mark.parametrize("name", ["JUBJUB", "PALLAS", "BLS12_381_G1"])
def test_edge_rows_match_host(name):
    """A single row, and 70 rows (past a 64-row block), with a point count
    that fills no whole group; the kernel wrapper on CPU tensors runs the
    plain version and launches nothing."""
    _, t = _pair(name)
    pts = _setup(t, 7, n=8)
    mod, kern = fast_mod(t), (msm_kernel if isinstance(t, TECurveSpec) else msm_sw_kernel)
    table = torch.from_numpy(mod.pack_table_grouped(t, pts, 3))
    for rows in (1, 70):
        bits = _bits(8, rows, rows) if rows > 1 else np.ones((1, 8), dtype=np.uint8)
        idx = mod.window_indices(torch.from_numpy(bits), table.shape[0], 3)
        before = kern.launches
        out = kern.grouped_msm(t, table, idx)
        assert kern.launches == before
        assert torch.equal(out, kern.grouped_msm_plain(t, table, idx))
        got = t.unpack_points(out)
        got = [got] if rows == 1 and not isinstance(got, (list, np.ndarray)) else list(got)
        assert got == [_host_sum(t, pts, row) for row in bits]


def test_window_indices_and_table_cache():
    t = tck.JUBJUB
    bits = torch.tensor([[1, 0, 1, 1, 1, 0, 0, 0]], dtype=torch.uint8)
    assert curve_fast.window_indices(bits, 3, 3).tolist() == [[5, 3, 0]]
    with pytest.raises(ValueError):
        curve_fast.window_indices(bits, 2, 3)

    class Params:
        calls = 0

        def packed_grouped(self, w):
            Params.calls += 1
            return curve_fast.pack_table_grouped(t, _setup(t, 3, n=6), w)

    params = Params()
    first = curve_fast.device_table(params, 3, torch.device("cpu"))
    assert curve_fast.device_table(params, 3, torch.device("cpu")) is first
    assert Params.calls == 1
    out = curve_fast.conditional_sum_grouped_auto(t, params, bits[:, :6].repeat(2, 1), 3)
    assert out.shape == (2, 4, 8)
    assert torch.equal(out, curve_fast.te_conditional_sum_grouped(t, first, bits[:, :6].repeat(2, 1), 3))


def test_te_grouped_tier_needs_a_minus_one():
    t = tck.JUBJUB
    other = TECurveSpec("a2", t.base, t.scalar, 2, t.d, 1)
    with pytest.raises(ValueError):
        curve_fast.pack_table_grouped(other, [t.generator], 3)
    table = torch.from_numpy(curve_fast.pack_table_grouped(t, [t.generator], 3))
    with pytest.raises(ValueError):
        msm_kernel.grouped_msm(other, table, torch.zeros((1, 1), dtype=torch.int32))


@pytest.mark.parametrize("name", ["JUBJUB", "PALLAS"])
def test_grouped_sum_runs_only_the_groups_the_bits_reach(name):
    """7 bits over a 13-point table: the MSM gets the first ceil(7 / 3) = 3
    of the 5 groups, and the affine sum equals the one over the whole table
    with the bits zero-padded; more bits than the table holds raise.  The
    dispatcher picks the curve model's kernel module."""
    _, t = _pair(name)
    pts = _setup(t, 11)
    mod, kern = fast_mod(t), (msm_kernel if isinstance(t, TECurveSpec) else msm_sw_kernel)
    table = torch.from_numpy(mod.pack_table_grouped(t, pts, 3))
    bits = torch.from_numpy(_bits(7, ROWS, 12))
    tab, idx = curve_fast.grouped_operands(table, bits, 3)
    assert tab.shape[0] == 3 and idx.shape == (ROWS, 3) and tab.is_contiguous()
    assert torch.equal(tab, table[:3])
    padded = torch.nn.functional.pad(bits, (0, 15 - 7))
    full = kern.grouped_msm_plain(t, table, curve_fast.window_indices(padded, 5, 3))

    class Params:
        def packed_grouped(self, w):
            return table.numpy()

    short = mod.conditional_sum_grouped_auto(t, Params(), bits, 3)
    assert _affine(t, mod.to_affine(t, short)) == _affine(t, mod.to_affine(t, full))
    assert _affine(t, mod.to_affine(t, short)) == [_host_sum(t, pts, row) for row in bits.numpy()]
    with pytest.raises(ValueError):
        curve_fast.grouped_operands(table, torch.zeros((1, 16), dtype=torch.uint8), 3)


def test_p256_grouped_msm_matches_jax_with_identity_padding():
    """P-256 (a = -3, W = 9): 7 points at w = 3 leave the last group two
    identity entries; the all-zero row sums to the identity.  The port's
    grouped sum equals JAX's ``sw_conditional_sum_grouped_rns`` and the host
    oracle, as affine points."""
    j, t = _pair("SECP256R1")
    rng = random.Random(21)
    pts = [t.rand_point(rng) for _ in range(7)]
    bits = np.asarray([[rng.randrange(2) for _ in range(7)] for _ in range(4)], dtype=np.uint8)
    bits[0] = 0
    table = curve_sw_fast.pack_table_grouped(t, pts, 3)
    assert table.shape == (3, 8, 3, 9)
    jout = jsr.sw_conditional_sum_grouped_rns(j, jnp.asarray(jsr.pack_table_grouped(j, pts, 3)), jnp.asarray(bits), 3)
    tout = curve_sw_fast.sw_conditional_sum_grouped(t, torch.from_numpy(table), torch.from_numpy(bits), 3)
    want = list(jsr.unpack_affine_rns(j, np.asarray(jout)))
    assert want[0] is None
    assert _affine(t, curve_sw_fast.to_affine(t, tout)) == want == [_host_sum(t, pts, row) for row in bits]


_BUILDS = {(8, True): "PALLAS", (8, False): "A3", (9, False): "SECP256R1", (12, True): "BLS12_381_G1"}


def test_split_table_names_every_build():
    """One k per kernel build, one the kernel takes (1, 2, 3, 4 or 8); a
    curve with no build takes 1."""
    assert set(msm_sw_kernel.SPLIT) == set(_BUILDS)
    assert set(msm_sw_kernel.SPLIT.values()) <= {1, 2, 3, 4, 8}
    for key, name in _BUILDS.items():
        assert msm_sw_kernel.split_of(_pair(name)[1]) == msm_sw_kernel.SPLIT[key]
    from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FQ

    assert msm_sw_kernel.split_of(SWCurveSpec("g1_a1", BLS12_381_FQ, BLS12_381_FR, 1, 4, 1)) == 1


@pytest.mark.parametrize("key", sorted(_BUILDS))
@pytest.mark.parametrize("case", ["G_not_divisible_by_k", "G_below_k"])
def test_split_plain_sum_matches_unsplit_and_jax(key, case):
    """The plain version at each build's k: its projective words may differ
    from the unsplit in-order sum's (another order of additions), but the
    affine sums equal the unsplit sum's, JAX's and the host oracle's, with
    G not a multiple of k, or G < k (threads with no group merge the
    identity)."""
    j, t = _pair(_BUILDS[key])
    k = msm_sw_kernel.SPLIT[key]
    groups = k + 1 if case == "G_not_divisible_by_k" else max(k - 1, 1)
    n = 3 * groups - 1  # the last group holds an identity entry
    pts = _setup(t, 30 + groups, n=n)
    bits = _bits(n, ROWS, groups)
    table = torch.from_numpy(curve_sw_fast.pack_table_grouped(t, pts, 3))
    idx = curve_fast.window_indices(torch.from_numpy(bits), groups, 3)
    split = msm_sw_kernel.grouped_msm_plain(t, table, idx)
    unsplit = ff.from_digits(msm_sw_kernel.split_sum_digits(t, ff.to_digits(table), idx, 1))
    got = _affine(t, curve_sw_fast.to_affine(t, split))
    assert got == _affine(t, curve_sw_fast.to_affine(t, unsplit))
    jout = jsr.sw_conditional_sum_grouped_rns(j, jnp.asarray(jsr.pack_table_grouped(j, pts, 3)), jnp.asarray(bits), 3)
    assert got == list(jsr.unpack_affine_rns(j, np.asarray(jout))) == [_host_sum(t, pts, row) for row in bits]


@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_split_sum_at_every_k_tried(k):
    """The split sum at each k > 1 the kernel takes: 13 groups over k ranges,
    and 2 groups with k - 2 empty ranges, equal the unsplit sum as affine
    points."""
    _, t = _pair("PALLAS")
    pts = _setup(t, 40 + k, n=39)
    bits = _bits(39, ROWS, k)
    table = ff.to_digits(torch.from_numpy(curve_sw_fast.pack_table_grouped(t, pts, 3)))
    idx = curve_fast.window_indices(torch.from_numpy(bits), 13, 3)
    for G in (13, 2):
        got = ff.from_digits(msm_sw_kernel.split_sum_digits(t, table[:G], idx[:, :G].contiguous(), k))
        want = ff.from_digits(msm_sw_kernel.split_sum_digits(t, table[:G], idx[:, :G].contiguous(), 1))
        assert _affine(t, curve_sw_fast.to_affine(t, got)) == _affine(t, curve_sw_fast.to_affine(t, want))
