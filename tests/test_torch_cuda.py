"""The CUDA kernels against their plain PyTorch versions, on the card:
the Poseidon permutation, SHA-256 (both entry points), both grouped MSMs on
every curve they are built for (``msm_sw`` also at every row split it takes;
both at the fixed-base shapes of 20 and 84-86 groups, and under
``msm_many``), and the field arithmetic they share (through the test-only
field probe); the windowed product and the Schnorr and ElGamal batch entry
points on CUDA tensors against the same on CPU tensors; the keys' pack A4
against the host pack on every twisted-Edwards curve; ``msm_te`` on
Bowe-Hopwood's signed-digit table; Bowe-Hopwood, the injective-map
compressors, the fold argument and the IPA prover on the card against the
CPU; the sumcheck prover's CUDA graph against the eager prover; Blake2s
(the PRFs and the commitment) and the R1CS checks (``check_satisfied_device``,
the batched small-domain and Montgomery checks, ``which_unsatisfied``) on
the card against the CPU, tampered and not; the Merkle path circuits and
``parallel/`` over NCCL at world size 1; the pinned Poseidon sponge vector,
the Pedersen commitment, a Pedersen tree and an ElGamal circuit over
BLS12-377 Fr on the card; for each public path, the kernels it launches
there (``test_path_launches_its_kernels``); and the device trees' proof and
verify calls replayed from CUDA graphs against their eager path.

Every test here needs a CUDA device and skips without one.  On a machine with
a card (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import hashlib

import numpy as np
import pytest
import torch

from crypto_primitives_tpu_torch.models.sponge import (
    PoseidonConfig,
    find_poseidon_ark_and_mds,
    get_default_poseidon_parameters,
)
from crypto_primitives_tpu_torch.ops import poseidon_kernel, sha256_kernel
from crypto_primitives_tpu_torch.ops.fields_known import (
    BLS12_377_FR,
    BLS12_381_FQ,
    BLS12_381_FR,
    ED_ON_BLS12_377_FR,
    JUBJUB_FR,
)
from crypto_primitives_tpu_torch.ops.sha256 import sha256

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _states(spec, rows, t, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(56), "little") % spec.p for _ in range(rows * t)]
    vals[: t] = [spec.p - 1] * t
    return torch.from_numpy(spec.pack(np.asarray(vals, dtype=object).reshape(rows, t)))


def _config(spec, rate, full, partial, alpha):
    ark, mds = find_poseidon_ark_and_mds(spec, rate, full, partial, 0)
    return PoseidonConfig(spec, full, partial, alpha, ark, mds, rate, 1)


def _singular_config():
    """An MDS whose lower-right block is singular: the kernel runs the trivial
    (all dense) schedule."""
    base = get_default_poseidon_parameters(BLS12_381_FR, 2)
    return PoseidonConfig(BLS12_381_FR, 8, 31, 17, base.ark, [[2, 3, 5], [7, 1, 1], [11, 1, 1]], 2, 1)


def _wide_states(spec, rows, t, seed):
    """rows x t canonical states of random words (the top word below p's),
    the first state all p - 1."""
    g = torch.Generator().manual_seed(seed)
    W = spec.num_words
    w = torch.randint(-(1 << 31), 1 << 31, (rows, t, W), dtype=torch.int64, generator=g)
    w[..., W - 1] = torch.randint(0, spec.p >> (32 * (W - 1)), (rows, t), dtype=torch.int64, generator=g)
    w[0] = _states(spec, 1, t, seed)[0].to(torch.int64)
    return w.to(torch.int32)


def _lanes_a_state(cfg, batch, device):
    """The G the wrapper takes for ``batch`` states of ``cfg`` on ``device``."""
    from crypto_primitives_tpu_torch.native import build

    W, t = cfg.field.num_words, cfg.t
    crossover = poseidon_kernel.CROSSOVER.get(W, ()) if t <= 3 else ()
    if not crossover:
        return 1, None
    sms, blocks = poseidon_kernel._card(build.load("poseidon_permute"), device.index or 0, W, t)
    return poseidon_kernel.choose_group(batch, sms, blocks, crossover), sms * blocks * poseidon_kernel.THREADS


_POSEIDON_CONFIGS = {
    "fr_rate2": lambda: get_default_poseidon_parameters(BLS12_381_FR, 2),
    "fr_rate4": lambda: get_default_poseidon_parameters(BLS12_381_FR, 4),
    "fr_rate8": lambda: get_default_poseidon_parameters(BLS12_381_FR, 8, True),
    "fr_rate8_constraints": lambda: get_default_poseidon_parameters(BLS12_381_FR, 8),
    "singular": _singular_config,
    "jubjub_rate2": lambda: _config(JUBJUB_FR, 2, 8, 31, 17),
    "fq_rate2": lambda: _config(BLS12_381_FQ, 2, 8, 60, 5),
    "fr_rate1": lambda: _config(BLS12_381_FR, 1, 8, 31, 17),
    "bls12_377_fr_rate2": lambda: _config(BLS12_377_FR, 2, 8, 31, 17),
    "ed377_fr_rate2": lambda: _config(ED_ON_BLS12_377_FR, 2, 8, 31, 17),
}


def _permute_at(cfg, states, group):
    """The C entry point at a given lanes-a-state: (its return code, the output)."""
    from crypto_primitives_tpu_torch.native import build

    lib = build.load("poseidon_permute")
    n_sparse, image = cfg.schedule_tables(states.device)
    out = torch.empty_like(states)
    err = lib.poseidon_permute(
        states.data_ptr(), out.data_ptr(), image.data_ptr(), image.numel(), states.shape[0], cfg.field.num_words,
        cfg.t, cfg.alpha, cfg.full_rounds, cfg.partial_rounds, n_sparse, group, states.device.index or 0,
        torch.cuda.current_stream(states.device).cuda_stream)
    return err, out


@pytest.mark.parametrize("batch", [1, 31, 300, 4097, 8191, 2**17 + 3])
@pytest.mark.parametrize("which", ["fr_rate2", "fr_rate4", "fr_rate8", "jubjub_rate2", "fq_rate2", "fr_rate1",
                                   "fr_rate8_constraints", "singular", "bls12_377_fr_rate2", "ed377_fr_rate2"])
def test_poseidon_kernel_matches_plain(cuda, which, batch):
    """Every lanes-a-state the wrapper takes (G = 4 below the crossover at
    t <= 3, with a ragged last warp at the odd batches, and G = 1 above a
    wave and for wider states) bit for bit against the plain version."""
    cfg = _POSEIDON_CONFIGS[which]()
    make = _states if batch <= 4097 else _wide_states
    states = make(cfg.field, batch, cfg.t, 1).to(cuda)
    group, wave = _lanes_a_state(cfg, batch, cuda)
    if cfg.t <= 3:
        assert (group > 1) == (batch < wave)
    before = (poseidon_kernel.launches, poseidon_kernel.group_launches)
    got = poseidon_kernel.permute(cfg, states)
    assert (poseidon_kernel.launches, poseidon_kernel.group_launches) == (before[0] + 1, before[1] + (group > 1))
    want = poseidon_kernel.permute_plain(cfg, states)
    assert torch.equal(got, want)


@pytest.mark.parametrize("which", ["fr_rate2", "jubjub_rate2", "fr_rate1", "singular", "fq_rate2"])
def test_poseidon_kernel_every_group_matches_plain(cuda, which):
    """Every G the kernel is built for at t <= 3, through the C entry point,
    on a ragged batch; a G it is not built for is refused."""
    cfg = _POSEIDON_CONFIGS[which]()
    states = _states(cfg.field, 300, cfg.t, 3).to(cuda)
    want = poseidon_kernel.permute_plain(cfg, states)
    for group in poseidon_kernel.GROUPS:
        err, got = _permute_at(cfg, states, group)
        assert err == 0 and torch.equal(got, want), group
    for group in (0, 2, 3, 8, 16):
        assert _permute_at(cfg, states, group)[0] != 0, group


def test_poseidon_group_kernel_replays_from_a_cuda_graph(cuda):
    """A group launch captured into a CUDA graph (the bank's load, its event
    and the kernel) replays on new states equal to the plain version."""
    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2)
    first, second = (_states(BLS12_381_FR, 4096, 3, seed).to(cuda) for seed in (5, 6))
    assert _lanes_a_state(cfg, 4096, cuda)[0] > 1
    static = first.clone()
    poseidon_kernel.permute(cfg, static)  # the image and the card's shape, before the capture
    graph = torch.cuda.CUDAGraph()
    before = poseidon_kernel.group_launches
    with torch.cuda.graph(graph):
        out = poseidon_kernel.permute(cfg, static)
    assert poseidon_kernel.group_launches == before + 1
    for states in (second, first):
        static.copy_(states)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, poseidon_kernel.permute_plain(cfg, states))


def test_poseidon_kernel_refuses_what_it_does_not_take(cuda):
    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2)
    states = _states(BLS12_381_FR, 8, 3, 2).to(cuda)
    with pytest.raises(ValueError):
        poseidon_kernel.permute(cfg, states.transpose(0, 1))  # wrong shape
    with pytest.raises(ValueError):
        poseidon_kernel.permute(cfg, states[::2])  # not contiguous
    # a (W, t) with no instantiation: the C entry point refuses it, and its
    # cudaErrorInvalidValue raises through build.check
    with pytest.raises(RuntimeError, match="invalid argument"):
        poseidon_kernel.permute(_config(BLS12_381_FQ, 4, 8, 60, 5), _states(BLS12_381_FQ, 4, 5, 3).to(cuda))
    # the t <= 9 build runs one thread a state only
    wide = get_default_poseidon_parameters(BLS12_381_FR, 4)
    assert _permute_at(wide, _states(BLS12_381_FR, 8, wide.t, 4).to(cuda), 4)[0] != 0


@pytest.mark.parametrize("nblocks", [1, 2, 3, 5])
def test_sha256_kernel_matches_plain(cuda, nblocks):
    g = torch.Generator(device="cuda").manual_seed(nblocks)
    words = torch.randint(-(1 << 31), 1 << 31, (1000, nblocks, 16), dtype=torch.int64,
                          device=cuda, generator=g).to(torch.int32)
    before = sha256_kernel.launches
    got = sha256_kernel.compress(words)
    assert sha256_kernel.launches == before + 1
    assert torch.equal(got, sha256_kernel.compress_plain(words))


@pytest.mark.parametrize("n", [0, 55, 56, 64, 119, 120, 200])
def test_sha256_on_the_card_matches_hashlib(cuda, n):
    rng = np.random.default_rng(n)
    msgs = rng.integers(0, 256, (5, n), dtype=np.uint8)
    got = sha256(torch.from_numpy(msgs).to(cuda)).cpu().numpy()
    for row, digest in zip(msgs, got):
        assert bytes(digest) == hashlib.sha256(row.tobytes()).digest()


@pytest.mark.parametrize("n", [0, 32, 55, 56, 64, 80, 119, 128])
@pytest.mark.parametrize("aligned", [True, False])
def test_sha256_digest_kernel_matches_plain(cuda, n, aligned):
    """The byte-row entry point: one launch per batch, equal to the plain
    version; a batch that starts off a 16-byte boundary takes byte loads."""
    g = torch.Generator(device="cuda").manual_seed(n)
    rows = 1000
    flat = torch.randint(0, 256, (rows * n + 1,), dtype=torch.uint8, device=cuda, generator=g)
    msgs = (flat[: rows * n] if aligned else flat[1:]).view(rows, n)
    before = sha256_kernel.launches
    got = sha256(msgs)
    assert sha256_kernel.launches == before + 1
    assert torch.equal(got, sha256_kernel.digest_plain(msgs))
    assert bytes(got[0].cpu().numpy()) == hashlib.sha256(msgs[0].cpu().numpy().tobytes()).digest()


def _a3_curve():
    """y^2 = x^3 - 3x + 1 over BLS12-381 Fr (a != 0; see test_torch_curve.py)."""
    from crypto_primitives_tpu_torch.ops.curve_sw import SWCurveSpec

    return SWCurveSpec("test_a3", BLS12_381_FR, BLS12_381_FR, -3, 1, 1, (0, 1))


@pytest.mark.parametrize("name", ["JUBJUB", "ED_ON_BLS12_377", "ED25519", "PALLAS", "BLS12_381_G1", "A3", "SECP256R1"])
@pytest.mark.parametrize("w", [2, 3])
@pytest.mark.parametrize("npts", [20, 100])
def test_msm_kernels_match_plain(cuda, name, w, npts):
    import random

    from crypto_primitives_tpu_torch.ops import curves_known, msm_kernel, msm_sw_kernel
    from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod

    curve = _a3_curve() if name == "A3" else getattr(curves_known, name)
    kern = msm_kernel if curve.coords == 4 else msm_sw_kernel
    rng = random.Random(w)
    # 20 and 100 fill no whole group of 3; 100 makes 34 or 50 groups, past
    # msm_te's index tile of 32 groups
    pts = [curve.rand_point(rng) for _ in range(npts)]
    table = torch.from_numpy(fast_mod(curve).pack_table_grouped(curve, pts, w)).to(cuda)
    g = torch.Generator(device="cuda").manual_seed(w)
    for rows in (1, 65, 129, 1000):
        idx = torch.randint(0, 1 << w, (rows, table.shape[0]), dtype=torch.int32, device=cuda, generator=g)
        if rows > 2:
            idx[0], idx[1] = 0, (1 << w) - 1
        before = kern.launches
        got = kern.grouped_msm(curve, table, idx)
        assert kern.launches == before + 1
        assert torch.equal(got, kern.grouped_msm_plain(curve, table, idx))


@pytest.mark.parametrize("name", ["BLS12_381_G1", "SECP256R1"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_msm_sw_kernel_matches_plain_at_every_split(cuda, monkeypatch, name, k):
    """msm_sw with each row split over k threads (shuffles where k divides
    32, shared memory otherwise), against the plain version at the same k:
    40 groups (not a multiple of 3 or 8), and 2 groups (fewer than k)."""
    import random

    from crypto_primitives_tpu_torch.ops import curve_sw_fast, curves_known, msm_sw_kernel

    curve = getattr(curves_known, name)
    monkeypatch.setitem(msm_sw_kernel.SPLIT, (curve.base.num_words, curve.a == 0), k)
    assert msm_sw_kernel.split_of(curve) == k
    rng = random.Random(k)
    pts = [curve.rand_point(rng) for _ in range(120)]
    table = torch.from_numpy(curve_sw_fast.pack_table_grouped(curve, pts, 3)).to(cuda)
    g = torch.Generator(device="cuda").manual_seed(k)
    for groups in (40, 2):
        tab = table[:groups].contiguous()
        idx = torch.randint(0, 8, (300, groups), dtype=torch.int32, device=cuda, generator=g)
        idx[0], idx[1] = 0, 7
        assert torch.equal(msm_sw_kernel.grouped_msm(curve, tab, idx), msm_sw_kernel.grouped_msm_plain(curve, tab, idx))


def test_msm_kernels_refuse_what_they_do_not_take(cuda):
    from crypto_primitives_tpu_torch.ops import curves_known, msm_kernel, msm_sw_kernel
    from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod

    te = curves_known.JUBJUB
    table = torch.from_numpy(fast_mod(te).pack_table_grouped(te, [te.generator] * 6, 3)).to(cuda)
    idx = torch.zeros((4, table.shape[0]), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        msm_kernel.grouped_msm(te, table, idx.to(torch.int64))  # wrong index type
    with pytest.raises(ValueError):
        msm_kernel.grouped_msm(te, table, idx[:, :1].contiguous())  # wrong group count
    with pytest.raises(ValueError):
        msm_kernel.grouped_msm(te, table[:, :, :2].contiguous(), idx)  # not 3 coordinates
    with pytest.raises(ValueError):
        msm_kernel.grouped_msm(te, table, idx.cpu())  # two devices
    # a row split the kernel does not take (k = 5 needs blocks of 160
    # threads): the C entry point refuses it
    from crypto_primitives_tpu_torch.ops import curve_sw_fast

    g1 = curves_known.BLS12_381_G1
    g1_table = torch.from_numpy(curve_sw_fast.pack_table_grouped(g1, [g1.generator] * 6, 3)).to(cuda)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(msm_sw_kernel.SPLIT, (12, True), 5)
        with pytest.raises(RuntimeError, match="invalid argument"):
            msm_sw_kernel.grouped_msm(g1, g1_table, torch.zeros((4, 2), dtype=torch.int32, device=cuda))
    # a W = 12 curve with a != 0 has no instantiation: the C entry point refuses it
    from crypto_primitives_tpu_torch.ops.curve_sw import SWCurveSpec
    from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FQ

    g1a = SWCurveSpec("g1_a1", BLS12_381_FQ, BLS12_381_FR, 1, 4, 1)
    sw_table = torch.zeros((2, 8, 3, 12), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        msm_sw_kernel.grouped_msm(g1a, sw_table, torch.zeros((4, 2), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("field", ["BLS12_381_FR", "BLS12_377_FR", "BLS12_381_FQ"])
@pytest.mark.parametrize("op", ["mont_mul", "dot3", "dot9", "sparse_row", "add", "sub", "mont_sqr", "mul_chain",
                                "sqr_chain"])
def test_field_probe_matches_plain_on_edge_values(cuda, field, op):
    """field.cuh's carry chains against the plain field tier, on every pair
    of edge words and on 4096 random pairs (BLS12-377 Fr is the base field of
    ed-on-bls12-377)."""
    import itertools

    from crypto_primitives_tpu_torch.ops import field_probe, fields_known

    spec = getattr(fields_known, field)
    pairs = list(itertools.product(field_probe.edge_values(spec), repeat=2))
    rng = np.random.default_rng(7)
    nbytes = 4 * spec.num_words + 8
    pairs += [tuple(int.from_bytes(rng.bytes(nbytes), "little") % spec.p for _ in range(2)) for _ in range(4096)]
    a = torch.from_numpy(spec.pack([x for x, _ in pairs], mont=False)).to(cuda)
    b = torch.from_numpy(spec.pack([y for _, y in pairs], mont=False)).to(cuda)
    got = field_probe.field_ops(spec, op, a, b, iters=3)
    assert torch.equal(got, field_probe.field_ops_plain(spec, op, a, b, iters=3))


@pytest.mark.parametrize("name", ["JUBJUB", "ED_ON_BLS12_377", "BLS12_381_G1", "SECP256R1"])
@pytest.mark.parametrize("nbits", [60, 252, 255, 256])
def test_fixed_base_mul_kernel_matches_plain(cuda, name, nbits):
    """The fixed-base product on the card (one launch of msm_te or msm_sw
    over the doubling-power table) equals its plain version word for word,
    at G = 20 (below msm_te's 32-group index tile), 84, 85 and 86 groups of 3
    (G mod 3 = 0, 1, 2: msm_sw's k = 3 ranges of unequal length)."""
    from crypto_primitives_tpu_torch.ops import curves_known, msm_kernel, msm_sw_kernel
    from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod

    curve = getattr(curves_known, name)
    mod, kern = fast_mod(curve), (msm_kernel if curve.coords == 4 else msm_sw_kernel)
    g = torch.Generator(device="cuda").manual_seed(nbits)
    bits = torch.randint(0, 2, (1000, nbits), dtype=torch.uint8, device=cuda, generator=g)
    bits[0], bits[1] = 0, 1
    before = kern.launches
    got = mod.fixed_base_mul(curve, curve.generator, bits)
    assert kern.launches == before + 1
    assert torch.equal(got.cpu(), mod.fixed_base_mul(curve, curve.generator, bits.cpu()))


def test_msm_many_on_the_card_matches_single_calls(cuda):
    import random

    from crypto_primitives_tpu_torch.models.crh import PedersenCRH, Window
    from crypto_primitives_tpu_torch.ops import curves_known

    for curve in (curves_known.JUBJUB, curves_known.BLS12_381_G1):
        crh = PedersenCRH(curve, Window(6, 40))
        params = [crh.setup(random.Random(s)) for s in (1, 2)]
        g = torch.Generator(device="cuda").manual_seed(3)
        inputs = [torch.randint(0, 256, (rows, 30), dtype=torch.uint8, device=cuda, generator=g) for rows in (500, 70)]
        many = crh.evaluate_batch_many(params, inputs, device=cuda)
        for out, p, x in zip(many, params, inputs):
            assert torch.equal(out, crh.evaluate_batch_projective(p, x, device=cuda))
            assert torch.equal(out.cpu(), crh.evaluate_batch_projective(p, x.cpu(), device="cpu"))


@pytest.mark.parametrize("name", ["JUBJUB", "BLS12_381_G1", "SECP256R1"])
def test_windowed_mul_on_cuda_tensors_matches_cpu(cuda, name):
    import random

    from crypto_primitives_tpu_torch.ops import curves_known
    from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod

    curve = getattr(curves_known, name)
    mod = fast_mod(curve)
    rng = random.Random(4)
    base = torch.from_numpy(mod.pack_points(curve, [curve.rand_point(rng) for _ in range(300)]))
    bits = torch.from_numpy(mod.scalars_to_bits(curve, [rng.randrange(curve.scalar.p) for _ in range(300)]))
    got = mod.scalar_mul_bits_windowed(curve, base.to(cuda), bits.to(cuda))
    assert torch.equal(got.cpu(), mod.scalar_mul_bits_windowed(curve, base, bits))


@pytest.mark.parametrize("name", ["JUBJUB", "ED_ON_BLS12_377", "ED25519"])
def test_pack_kernel_equals_the_host_pack(cuda, name):
    """A4 through ``pack_points_device`` gives the host pack's extended
    Montgomery words bit for bit on 2^16 + 1 random coordinate pairs (the
    arithmetic does not ask for curve points), the identity and coordinates
    at 0, p - 1, p + v and -v among them, in one launch whose span carries
    the points as ``rows``."""
    import random

    from torch.profiler import ProfilerActivity, profile

    from crypto_primitives_tpu_torch.ops import curve_fast, curves_known, pack_kernel
    from crypto_primitives_tpu_torch.utils import profiling

    curve = getattr(curves_known, name)
    p = curve.base.p
    rng = random.Random(61)
    pts = [(rng.randrange(p), rng.randrange(p)) for _ in range((1 << 16) - 4)]
    pts += [(0, 1), (p - 1, 0), (p + 12345, -(p - 1)), (-7, 2 * p + 3), (rng.randrange(p), p - 1)]
    n0 = pack_kernel.launches
    with profile(activities=[ProfilerActivity.CPU]):
        got = curve_fast.pack_points_device(curve, pts, cuda)
    assert pack_kernel.launches == n0 + 1
    assert [(s.name, s.rows) for s in profiling.spans()] == [("curve.pack", len(pts)), ("kernel.pack", len(pts))]
    assert got.shape == (len(pts), 4, curve.base.num_words) and got.device.type == "cuda"
    assert torch.equal(got.cpu(), torch.from_numpy(curve.pack_points(pts)))
    assert torch.equal(curve_fast.pack_points_device(curve, pts[-4], cuda).cpu(),
                       torch.from_numpy(curve.pack_points(pts[-4])))


@pytest.mark.parametrize("name", ["ED_ON_BLS12_377", "BLS12_381_G1"])
def test_schnorr_and_elgamal_on_the_card_match_cpu(cuda, name):
    """The batch entry points give the same results on the card as on the CPU
    from the same seed, and launch their kernels (decrypt_batch none)."""
    import random

    from crypto_primitives_tpu_torch.models.encryption import ElGamal
    from crypto_primitives_tpu_torch.models.signature import Schnorr
    from crypto_primitives_tpu_torch.ops import curves_known, msm_kernel, msm_sw_kernel

    curve = getattr(curves_known, name)
    kern = msm_kernel if curve.coords == 4 else msm_sw_kernel
    msgs = [bytes([i]) * 5 for i in range(40)]

    def run(device):
        rng = random.Random(5)
        s = Schnorr(curve)
        params = s.setup(rng)
        keys = s.keygen_batch(params, rng, 40, device=device)
        sigs = s.sign_batch(params, [sk for _, sk in keys], msgs, rng, device=device)
        pks = [pk for pk, _ in keys]
        ok = s.verify_batch(params, pks, msgs[:39] + [b"x"], sigs, device=device)
        e = ElGamal(curve)
        eparams = e.setup(rng)
        pk, sk = e.keygen(eparams, rng)
        pts = [curve.rand_point(rng) for _ in range(40)]
        rs = [e.rand_randomness(rng) for _ in range(40)]
        cts = e.encrypt_batch(eparams, pk, pts, rs, device=device) + e.encrypt_batch(eparams, pk, pts[:5], rs[:5],
                                                                                    device=device)
        before = kern.launches
        dec = e.decrypt_batch(eparams, sk, cts, device=device)
        assert kern.launches == before
        assert dec == pts + pts[:5]
        return keys, [(x.prover_response, x.verifier_challenge) for x in sigs], ok, cts

    before = kern.launches
    on_card = run(cuda)
    assert kern.launches >= before + 5
    assert on_card == run("cpu")
    assert on_card[2] == [True] * 39 + [False]


@pytest.mark.parametrize("groups", [20, 341, 342])
def test_msm_te_on_the_signed_combos_table_matches_plain(cuda, groups):
    """K4 on Bowe-Hopwood's signed-digit table (negated points, identity rows
    past n_real) at ed-on-bls12-377's window 63 x 6: 342 groups is what
    128-byte inputs reach; 20 and 341 leave a partial 32-group index tile."""
    import random

    from crypto_primitives_tpu_torch.models.crh import Window
    from crypto_primitives_tpu_torch.models.crh.bowe_hopwood import BoweHopwoodCRH
    from crypto_primitives_tpu_torch.ops import curve_fast, curves_known, msm_kernel

    curve = curves_known.ED_ON_BLS12_377
    params = BoweHopwoodCRH(curve, Window(63, 6)).setup(random.Random(9))
    table = params.device_signed_table(groups, cuda)
    g = torch.Generator(device="cuda").manual_seed(groups)
    bits = torch.randint(0, 2, (4096, 3 * groups), dtype=torch.uint8, device=cuda, generator=g)
    bits[0], bits[1] = 0, 1
    table, idx = curve_fast.grouped_operands(table, bits, 3)
    assert table.shape[0] == groups
    before = msm_kernel.launches
    got = msm_kernel.grouped_msm(curve, table, idx)
    assert msm_kernel.launches == before + 1
    assert torch.equal(got, msm_kernel.grouped_msm_plain(curve, table, idx))


def test_bowe_hopwood_and_compressors_on_the_card_match_cpu(cuda):
    import random

    from crypto_primitives_tpu_torch.models.commitment import PedersenCommitmentCompressor
    from crypto_primitives_tpu_torch.models.crh import Window
    from crypto_primitives_tpu_torch.models.crh.bowe_hopwood import BoweHopwoodCRH
    from crypto_primitives_tpu_torch.models.crh.injective_map import PedersenCRHCompressor
    from crypto_primitives_tpu_torch.ops import curves_known, msm_kernel

    curve = curves_known.ED_ON_BLS12_377
    g = torch.Generator().manual_seed(10)
    inputs = torch.randint(0, 256, (300, 128), dtype=torch.uint8, generator=g)
    bh = BoweHopwoodCRH(curve, Window(63, 6))
    params = bh.setup(random.Random(10))
    before = msm_kernel.launches
    got = bh.evaluate_batch(params, inputs.to(cuda), device=cuda)
    assert msm_kernel.launches == before + 1
    assert torch.equal(got.cpu(), bh.evaluate_batch(params, inputs, device="cpu"))
    assert [int(v) for v in curve.base.unpack(got[:3].cpu())] == [bh.evaluate(params, bytes(r.numpy()))
                                                                  for r in inputs[:3]]
    crh = PedersenCRHCompressor(curve, Window(250, 8))
    cparams = crh.setup(random.Random(11))
    assert torch.equal(crh.evaluate_batch(cparams, inputs.to(cuda), device=cuda).cpu(),
                       crh.evaluate_batch(cparams, inputs, device="cpu"))
    com = PedersenCommitmentCompressor(curve, Window(250, 8))
    mparams = com.setup(random.Random(12))
    rbits = torch.from_numpy(com.inner.randomness_to_bits([com.rand_randomness(random.Random(i)) for i in range(300)]))
    assert torch.equal(com.commit_batch(mparams, inputs.to(cuda), rbits.to(cuda), device=cuda).cpu(),
                       com.commit_batch(mparams, inputs, rbits, device="cpu"))


def _fr_rows(shape, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % BLS12_381_FR.p for _ in range(int(np.prod(shape)))]
    return torch.from_numpy(BLS12_381_FR.pack(np.asarray(vals, dtype=object).reshape(shape)))


def test_sumcheck_graph_replays_equal_the_eager_prover(cuda):
    """The CUDA graph of the whole prover equals the eager prover on the card
    (and on the CPU), for its first table and for a second table replayed
    through the same graph."""
    from crypto_primitives_tpu_torch.models.protocols.sumcheck import sumcheck_prove, sumcheck_prover_compiled

    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2)
    fn = sumcheck_prover_compiled(cfg)

    def flat(out):
        s, rounds, fin = out
        return torch.stack([s] + [x for pair in rounds for x in pair] + [fin]).cpu()

    first, second = _fr_rows((64, 32), 1), _fr_rows((64, 32), 2)
    before = poseidon_kernel.launches
    got1 = flat(fn(first.to(cuda)))
    captured = fn.captured_launches[((64, 32, 8), str(first.to(cuda).device))]
    assert captured == 6  # m + 1 permutations at m = 5
    assert poseidon_kernel.launches == before + 2 * captured  # the warm-up, then the capture
    assert len(fn.graphs) == 1
    want1 = flat(sumcheck_prove(cfg, first.to(cuda), device=cuda))
    assert torch.equal(got1, want1)
    assert torch.equal(want1, flat(sumcheck_prove(cfg, first, device="cpu")))
    before = poseidon_kernel.launches
    got2 = flat(fn(second.to(cuda)))
    assert poseidon_kernel.launches == before  # a replay does not pass through the wrapper
    assert len(fn.graphs) == 1
    assert torch.equal(got2, flat(sumcheck_prove(cfg, second.to(cuda), device=cuda)))
    assert not torch.equal(got1, got2)


def test_fold_argument_and_ipa_on_the_card_match_cpu(cuda):
    import random

    from crypto_primitives_tpu_torch.models.protocols.ipa_fold import ipa_fold_prove
    from crypto_primitives_tpu_torch.models.sponge.fiat_shamir import fold_argument
    from crypto_primitives_tpu_torch.ops import curves_known

    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2)
    rng = random.Random(13)
    coms = [[rng.randrange(BLS12_381_FR.p) for _ in range(5)] for _ in range(100)]
    before = poseidon_kernel.launches
    tag, z = fold_argument(cfg, coms, device=cuda)
    assert poseidon_kernel.launches == before + 6
    tag_cpu, z_cpu = fold_argument(cfg, coms, device="cpu")
    assert torch.equal(tag.cpu(), tag_cpu) and torch.equal(z.cpu(), z_cpu)
    curve = curves_known.JUBJUB
    gens = [curve.rand_point(rng) for _ in range(4)]
    scalars = [[rng.randrange(curve.scalar.p) for _ in range(4)] for _ in range(6)]
    before = poseidon_kernel.launches
    on_card = ipa_fold_prove(curve, cfg, gens, scalars, device=cuda)
    assert poseidon_kernel.launches > before
    on_cpu = ipa_fold_prove(curve, cfg, gens, scalars, device="cpu")
    assert on_card["a_star"] == on_cpu["a_star"]
    assert (on_card["challenges"] == on_cpu["challenges"]).all()
    assert list(on_card["commitment"]) == list(on_cpu["commitment"])
    assert [(list(L), list(R)) for L, R in on_card["rounds"]] == [(list(L), list(R)) for L, R in on_cpu["rounds"]]


def test_blake2s_on_the_card_matches_cpu(cuda):
    from crypto_primitives_tpu_torch.models.commitment import Blake2sCommitment
    from crypto_primitives_tpu_torch.models.prf import Blake2sPRF, Blake2sWithParameterBlock
    from crypto_primitives_tpu_torch.ops.blake2s import blake2s

    rng = np.random.default_rng(14)
    for n in (0, 1, 63, 64, 65, 128, 129):
        msgs = torch.from_numpy(rng.integers(0, 256, (300, n), dtype=np.uint8))
        for key, size, salt, person in ((b"", 32, b"", b""), (b"key", 16, b"salt", b"person")):
            got = blake2s(msgs.to(cuda), size, key, salt, person, device=cuda)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), blake2s(msgs, size, key, salt, person, device="cpu"))
        assert bytes(got[0].cpu().numpy()) == hashlib.blake2s(msgs[0].numpy().tobytes(), digest_size=16, key=b"key",
                                                               salt=b"salt", person=b"person").digest()
    seeds, inputs = (torch.from_numpy(rng.integers(0, 256, (300, 32), dtype=np.uint8)) for _ in range(2))
    assert torch.equal(Blake2sPRF.evaluate_batch(seeds.to(cuda), inputs.to(cuda), device=cuda).cpu(),
                       Blake2sPRF.evaluate_batch(seeds, inputs, device="cpu"))
    prf = Blake2sWithParameterBlock(salt=b"saltsalt", personalization=b"personal")
    assert torch.equal(prf.evaluate_batch(seeds.to(cuda), device=cuda).cpu(), prf.evaluate_batch(seeds, device="cpu"))
    com = Blake2sCommitment()
    assert torch.equal(com.commit_batch(None, inputs.to(cuda), seeds.to(cuda), device=cuda).cpu(),
                       com.commit_batch(None, inputs, seeds, device="cpu"))


def _byte_circuits(device, seed):
    """A batched Blake2s PRF circuit and a batched SHA-256 CRH circuit over 6
    instances, each with the variable of its first digest bit."""
    from crypto_primitives_tpu_torch.r1cs.batch import BatchConstraintSystem
    from crypto_primitives_tpu_torch.r1cs.gadgets.blake2s import Blake2sPRFGadget
    from crypto_primitives_tpu_torch.r1cs.gadgets.sha256 import Sha256CRHGadget
    from crypto_primitives_tpu_torch.r1cs.vars import bytes_to_uint8s

    rng = np.random.default_rng(seed)
    seeds, msgs = rng.integers(0, 256, (2, 6, 32), dtype=np.uint8)
    data = rng.integers(0, 256, (6, 55), dtype=np.uint8)
    prf = BatchConstraintSystem(BLS12_381_FR, 6, device=device)
    out = Blake2sPRFGadget.evaluate(prf, Blake2sPRFGadget.new_seed(prf, seeds), bytes_to_uint8s(prf, msgs))
    sha = BatchConstraintSystem(BLS12_381_FR, 6, device=device)
    dig = Sha256CRHGadget().evaluate(sha, bytes_to_uint8s(sha, data))
    return [(prf, list(out.bytes[0].bits[0].fp.lc.terms)[0]), (sha, list(dig.bytes[0].bits[0].fp.lc.terms)[0])]


def test_r1cs_checks_on_the_card_match_cpu(cuda):
    """check_satisfied_device and both batched checks (the int64 small-domain
    check with which_unsatisfied, and the Montgomery check at a chunk smaller
    than the batch) on the card equal the same on the CPU, before and after a
    tamper."""
    from crypto_primitives_tpu_torch.r1cs import ConstraintSystem, FpVar
    from crypto_primitives_tpu_torch.r1cs.batch import BatchConstraintSystem
    from crypto_primitives_tpu_torch.r1cs.device_check import check_satisfied_device
    from crypto_primitives_tpu_torch.r1cs.gadgets.blake2s import Blake2sPRFGadget
    from crypto_primitives_tpu_torch.r1cs.gadgets.poseidon import PoseidonTwoToOneCRHGadget
    from crypto_primitives_tpu_torch.r1cs.vars import bytes_to_uint8s

    cs = ConstraintSystem(BLS12_381_FR)
    out = Blake2sPRFGadget.evaluate(cs, Blake2sPRFGadget.new_seed(cs, bytes(range(32))),
                                    bytes_to_uint8s(cs, bytes(range(32, 64))))
    assert check_satisfied_device(cs, device=cuda) is check_satisfied_device(cs, device="cpu") is True
    cs.assignments[list(out.bytes[3].bits[2].fp.lc.terms)[0]] ^= 1
    assert check_satisfied_device(cs, device=cuda) is check_satisfied_device(cs, device="cpu") is False

    for (card, k), (host, k2) in zip(_byte_circuits(cuda, 15), _byte_circuits("cpu", 15)):
        assert k == k2
        assert card.satisfied_per_instance().tolist() == host.satisfied_per_instance().tolist() == [True] * 6
        card.assignments[k].v[4] ^= 1
        host.assignments[k].v[4] ^= 1
        ok = card.satisfied_per_instance()
        assert ok.device.type == "cuda" and ok.tolist() == host.satisfied_per_instance().tolist()
        assert ok.tolist() == [i != 4 for i in range(6)]
        first = card.which_unsatisfied()
        assert first.device.type == "cuda" and first.tolist() == host.which_unsatisfied().tolist()
        assert first[4] >= 0

    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2)
    left, right = _fr_rows((6,), 16), _fr_rows((6,), 17)
    results = []
    for dev in (cuda, "cpu"):
        bcs = BatchConstraintSystem(BLS12_381_FR, 6, device=dev)
        o = PoseidonTwoToOneCRHGadget(cfg).compress(bcs, FpVar.new_witness(bcs, left), FpVar.new_witness(bcs, right))
        before = bcs.satisfied_per_instance(chunk=4).tolist()
        k = list(o.lc.terms)[0]
        bcs.assignments[k] = bcs.assignments[k].clone()
        bcs.assignments[k][3] = left[0].to(bcs.device)
        results.append((o.value.cpu(), before, bcs.satisfied_per_instance(chunk=4).tolist(),
                        bcs.satisfied_per_instance().tolist()))
    (a_out, *a_checks), (b_out, *b_checks) = results
    assert torch.equal(a_out, b_out) and a_checks == b_checks
    assert a_checks == [[True] * 6, [i != 3 for i in range(6)], [i != 3 for i in range(6)]]

    # host rows (a UInt32 word, negative centered values) in the Montgomery check
    from crypto_primitives_tpu_torch.r1cs import UInt32
    from crypto_primitives_tpu_torch.r1cs.batch import SmallWord

    results = []
    for dev in (cuda, "cpu"):
        bcs = BatchConstraintSystem(BLS12_381_FR, 6, device=dev)
        x = FpVar.new_witness(bcs, left)
        w = UInt32.new_witness(bcs, np.arange(6, dtype=np.uint64) * 0x2FFFFFFF).to_fp()
        n = FpVar.new_witness(bcs, SmallWord(np.asarray([-3, 5, -(2 ** 40), 0, 1, -1], np.int64), 2 ** 40))
        out = (x * w) * n
        ok = bcs.satisfied_per_instance(chunk=4).tolist()
        bcs.assignments[list(n.lc.terms)[0]].v[2] += 1
        results.append((out.value.cpu(), ok, bcs.satisfied_per_instance().tolist()))
    assert torch.equal(results[0][0], results[1][0]) and results[0][1:] == results[1][1:]
    assert results[0][1:] == ([True] * 6, [i != 2 for i in range(6)])


def test_curve_gadget_circuit_checked_on_the_card(cuda):
    """An ElGamal encryption circuit over ed-on-bls12-377 (constraint field
    BLS12-377 Fr), synthesised on the host and equal to the native encrypt:
    check_satisfied_device on the card agrees with the CPU, true, then false
    once the message's x witness is changed."""
    import random

    from crypto_primitives_tpu_torch.models.encryption import ElGamal
    from crypto_primitives_tpu_torch.ops.curves_known import ED_ON_BLS12_377 as ed
    from crypto_primitives_tpu_torch.r1cs import ConstraintSystem
    from crypto_primitives_tpu_torch.r1cs.device_check import check_satisfied_device
    from crypto_primitives_tpu_torch.r1cs.gadgets.curve import TEAffineVar
    from crypto_primitives_tpu_torch.r1cs.gadgets.elgamal import ElGamalEncGadget

    scheme = ElGamal(ed)
    rng = random.Random(39)
    params = scheme.setup(rng)
    pk, _ = scheme.keygen(params, rng)
    msg, r = ed.rand_point(rng), scheme.rand_randomness(rng)
    cs = ConstraintSystem(ed.base)
    g = ElGamalEncGadget(ed)
    out = g.encrypt(cs, params, TEAffineVar.new_witness(cs, ed, msg), g.randomness_bits(cs, r),
                    TEAffineVar.new_witness(cs, ed, pk))
    assert out.value == scheme.encrypt(params, pk, msg, r)
    assert check_satisfied_device(cs, device=cuda) is check_satisfied_device(cs, device="cpu") is True
    cs.assignments[1] = (cs.assignments[1] + 1) % ed.base.p  # the first witness: the message's x
    assert check_satisfied_device(cs, device=cuda) is check_satisfied_device(cs, device="cpu") is False


def test_merkle_path_circuits_on_the_card_match_cpu(cuda):
    """The batched Merkle membership circuits: PathVar (N = 8, a 16-leaf
    Poseidon tree; the Montgomery check) and BytePathVar (N = 4, a 4-leaf
    SHA-256 tree; the int64 small-domain check), each with one instance
    against a wrong root, give on the card the ok values, per-instance
    verdicts and first failing constraints they give on the CPU, before and
    after ok is enforced."""
    from crypto_primitives_tpu_torch.models.merkle_tree.device import poseidon_device_tree, sha256_device_tree
    from crypto_primitives_tpu_torch.r1cs import FpVar
    from crypto_primitives_tpu_torch.r1cs.batch import BatchConstraintSystem
    from crypto_primitives_tpu_torch.r1cs.gadgets.merkle import BytePathVar, PathVar
    from crypto_primitives_tpu_torch.r1cs.gadgets.poseidon import PoseidonCRHGadget, PoseidonTwoToOneCRHGadget
    from crypto_primitives_tpu_torch.r1cs.gadgets.sha256 import DigestVar, Sha256CRHGadget, Sha256TwoToOneCRHGadget
    from crypto_primitives_tpu_torch.r1cs.vars import bytes_to_uint8s

    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2)
    leaves = _fr_rows((16,), 18)
    ptree = poseidon_device_tree(BLS12_381_FR, cfg, leaves, device="cpu")
    idx = [0, 3, 5, 6, 9, 10, 12, 15]
    roots = [ptree.root()] * 8
    roots[5] = (roots[5] + 1) % BLS12_381_FR.p
    sleaves = np.random.default_rng(19).integers(0, 256, (4, 32), dtype=np.uint8)
    stree = sha256_device_tree(sleaves, device="cpu")
    sroots = np.frombuffer(stree.root() * 4, dtype=np.uint8).reshape(4, 32).copy()
    sroots[1, 7] ^= 1

    def run(dev, byte):
        if byte:
            bcs = BatchConstraintSystem(BLS12_381_FR, 4, device=dev)
            pv = BytePathVar.new_witness_batch(bcs, [stree.generate_proof(i) for i in range(4)])
            ok = pv.verify_membership(Sha256CRHGadget(), Sha256TwoToOneCRHGadget(),
                                      DigestVar(bcs, bytes_to_uint8s(bcs, sroots, "input")),
                                      bytes_to_uint8s(bcs, sleaves, "witness"))
        else:
            bcs = BatchConstraintSystem(BLS12_381_FR, 8, device=dev)
            pv = PathVar.new_witness_batch(bcs, [ptree.generate_proof(i) for i in idx])
            ok = pv.verify_membership(PoseidonCRHGadget(cfg), PoseidonTwoToOneCRHGadget(cfg),
                                      FpVar.new_input(bcs, torch.from_numpy(BLS12_381_FR.pack(roots))),
                                      [FpVar.new_witness(bcs, leaves[idx])])
        before = bcs.satisfied_per_instance()
        ok.fp.enforce_equal(FpVar.constant(bcs, 1))
        after, first = bcs.satisfied_per_instance(), bcs.which_unsatisfied()
        assert after.device.type == first.device.type == bcs.device.type
        return [np.asarray(ok.value.cpu() if isinstance(ok.value, torch.Tensor) else ok.value).tolist(),
                before.tolist(), after.tolist(), first.tolist()]

    for byte, n, bad in ((False, 8, 5), (True, 4, 1)):
        card, host = run(cuda, byte), run("cpu", byte)
        assert card == host
        assert card[0] == card[2] == [i != bad for i in range(n)] and card[1] == [True] * n
        assert [f >= 0 for f in card[3]] == [i == bad for i in range(n)]


def test_parallel_over_nccl_at_world_size_1(cuda):
    """``parallel/`` on the card over NCCL at world size 1 (one card): the
    sharded SHA-256 tree (K3), its proofs, updates, verify and multipath, the
    sharded permute (K1) and both sharded MSMs (K4, K5) against the
    single-device paths on the same inputs, each launching its kernel."""
    import os
    import random

    import torch.distributed as dist

    from crypto_primitives_tpu_torch.models.merkle_tree.device import sha256_device_tree, sha256_tree_fns
    from crypto_primitives_tpu_torch.ops import curve_fast, curve_sw_fast, msm_kernel, msm_sw_kernel, poseidon_kernel
    from crypto_primitives_tpu_torch.ops.curves_known import BLS12_381_G1, ED_ON_BLS12_377
    from crypto_primitives_tpu_torch.parallel import (
        make_mesh,
        sharded_fixed_base_msm,
        sharded_fixed_base_msm_sw,
        sharded_merkle_build_prove_all,
        sharded_merkle_tree,
        sharded_multipath_verify_rows,
        sharded_permute_batch,
    )

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=dev)
    try:
        mesh = make_mesh(1)
        gen = torch.Generator(device=dev).manual_seed(21)
        leaves = torch.randint(0, 256, (1024, 32), dtype=torch.uint8, device=dev, generator=gen)
        leaf_hash, compress, level, convert = sha256_tree_fns()
        before = sha256_kernel.launches
        root, sib, auth = sharded_merkle_build_prove_all(leaf_hash, compress, leaves, mesh, leaf_convert=convert,
                                                         compress_level_batch=level)
        assert sha256_kernel.launches > before
        single = sha256_device_tree(leaves, device=dev)
        idx = torch.arange(1024, device=dev)
        sib1, auth1 = single.proof_rows(idx)
        assert torch.equal(root, single.root_row()) and torch.equal(sib, sib1) and torch.equal(auth, auth1)
        tree = sharded_merkle_tree(leaf_hash, compress, leaves, mesh, leaf_convert=convert, compress_level_batch=level)
        new = leaf_hash(leaves[:4].flip(1).contiguous())
        tree.update_batch([0, 9, 500, 1023], new)
        single.update_batch([0, 9, 500, 1023], new)
        assert torch.equal(tree.root_row, single.root_row())
        s, a = tree.proof_rows(idx)
        assert bool(tree.verify_rows_batch(tree.root_row, tree.leaf_digests, idx, s, a).all())
        sel = [3, 4, 5, 100, 1000]
        ms, ma = tree.proof_rows(sel)
        assert bool(sharded_multipath_verify_rows(compress, convert, tree.root_row, tree.leaf_digests[sel], sel,
                                                  ms, ma, mesh))

        cfg = get_default_poseidon_parameters(BLS12_381_FR, 2)
        states = _states(BLS12_381_FR, 512, 3, 22).to(dev)
        before = poseidon_kernel.launches
        got = sharded_permute_batch(cfg, states, mesh)
        assert poseidon_kernel.launches > before
        assert torch.equal(got, poseidon_kernel.permute(cfg, states))

        rng = random.Random(23)
        bits = torch.randint(0, 2, (256, 30), dtype=torch.uint8, device=dev, generator=gen)
        for curve, fn, mod, kern in ((ED_ON_BLS12_377, sharded_fixed_base_msm, curve_fast, msm_kernel),
                                     (BLS12_381_G1, sharded_fixed_base_msm_sw, curve_sw_fast, msm_sw_kernel)):
            pts = [curve.rand_point(rng) for _ in range(30)]
            table = torch.from_numpy(mod.pack_table_grouped(curve, pts, 3)).to(dev)
            before = kern.launches
            got = fn(curve, pts, bits, mesh)
            assert kern.launches > before
            want = curve_fast.grouped_sum(kern.grouped_msm, curve, table, bits, 3)
            assert torch.equal(mod.to_affine(curve, got), mod.to_affine(curve, want))
    finally:
        dist.destroy_process_group()


# The BLS12-381 Fr sponge's pinned output: absorb [0, 1, 2], squeeze 3
# (tests/test_poseidon.py:121-129; the reference's src/sponge/poseidon/mod.rs:381-404).
_POSEIDON_PINNED = [
    40442793463571304028337753002242186710310163897048962278675457993207843616876,
    2664374461699898000291153145224099287711224021716202960480903840045233645301,
    50191078828066923662070228256530692951801504043422844038937334196346054068797,
]


def test_pinned_poseidon_sponge_vector_on_the_card(cuda):
    """The pinned vector on every row of a sponge batch on the card (K1)."""
    from crypto_primitives_tpu_torch.models.sponge import PoseidonSpongeBatch

    sponge = PoseidonSpongeBatch(get_default_poseidon_parameters(BLS12_381_FR, 2), batch_shape=(4,), device=cuda)
    before = poseidon_kernel.launches
    sponge.absorb(torch.from_numpy(BLS12_381_FR.pack([[0, 1, 2]] * 4)).to(cuda))
    out = sponge.squeeze_native_field_elements(3)
    assert poseidon_kernel.launches > before and out.device.type == "cuda"
    assert [[int(v) for v in row] for row in BLS12_381_FR.unpack(out.cpu())] == [_POSEIDON_PINNED] * 4


@pytest.mark.parametrize("name", ["ED_ON_BLS12_377", "BLS12_381_G1"])
def test_pedersen_commitment_on_the_card_matches_cpu(cuda, name):
    """commit_batch on the card (two grouped MSMs and the affine step) equals
    the same on the CPU on every row, and the host commit on three; zero and
    p - 1 randomness included."""
    import random

    from crypto_primitives_tpu_torch.models.commitment import PedersenCommitment
    from crypto_primitives_tpu_torch.models.crh import Window
    from crypto_primitives_tpu_torch.ops import curves_known

    curve = getattr(curves_known, name)
    com = PedersenCommitment(curve, Window(6, 40))
    params = com.setup(random.Random(24))
    rng = random.Random(25)
    scalars = [com.rand_randomness(rng) for _ in range(298)] + [0, curve.scalar.p - 1]
    bits = torch.from_numpy(com.randomness_to_bits(scalars))
    inputs = torch.randint(0, 256, (300, 30), dtype=torch.uint8, generator=torch.Generator().manual_seed(25))
    got = com.commit_batch(params, inputs.to(cuda), bits.to(cuda), device=cuda)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), com.commit_batch(params, inputs, bits, device="cpu"))
    assert [tuple(int(v) for v in r) for r in curve.base.unpack(got[:3].cpu())] == \
        [com.commit(params, bytes(inputs[i].numpy()), scalars[i]) for i in range(3)]


def _pedersen_tree(leaves, device):
    """A Pedersen tree over JubJub (tests/test_merkle_pedersen.py:28-43: leaf
    window 4 x 16 on 8-byte leaves, two-to-one window 4 x 256), with the
    config and parameters that verify its host paths."""
    import random

    from crypto_primitives_tpu_torch.models.crh import PedersenCRH, PedersenTwoToOneCRH, Window
    from crypto_primitives_tpu_torch.models.merkle_tree import (
        MerkleTreeConfig,
        PointDigestDomain,
        PointToBytesDigestConverter,
    )
    from crypto_primitives_tpu_torch.models.merkle_tree.device import pedersen_device_tree
    from crypto_primitives_tpu_torch.ops.curves_known import JUBJUB

    leaf_crh, two = PedersenCRH(JUBJUB, Window(4, 16)), PedersenTwoToOneCRH(JUBJUB, Window(4, 256))
    rng = random.Random(77)
    lp, tp = leaf_crh.setup(rng), two.setup(rng)
    tree = pedersen_device_tree(JUBJUB, lp, tp, Window(4, 16), Window(4, 256), leaves, device=device)
    config = MerkleTreeConfig(leaf_crh, two, PointDigestDomain(JUBJUB), PointDigestDomain(JUBJUB),
                              PointToBytesDigestConverter(JUBJUB))
    return tree, config, lp, tp


def test_pedersen_tree_on_the_card_matches_cpu(cuda):
    """A 32-leaf Pedersen tree built on the card (K4, the affine step) equals
    the CPU's level for level; every path verifies on the card, a wrong root
    does not, and a host path reaches the root."""
    from crypto_primitives_tpu_torch.ops import msm_kernel

    leaves = torch.randint(0, 256, (32, 8), dtype=torch.uint8, generator=torch.Generator().manual_seed(27))
    before = msm_kernel.launches
    tree, config, lp, tp = _pedersen_tree(leaves.to(cuda), cuda)
    assert msm_kernel.launches > before
    host = _pedersen_tree(leaves, "cpu")[0]
    assert tree.root() == host.root()
    assert torch.equal(tree.leaf_digests.cpu(), host.leaf_digests)
    assert len(tree.inner_levels) == len(host.inner_levels)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(tree.inner_levels, host.inner_levels))
    idx = torch.arange(32, device=cuda)
    sib, auth = tree.proof_rows(idx)
    assert bool(tree.verify_rows_batch(tree.root_row(), tree.leaf_digests, idx, sib, auth).all())
    wrong = tree.root_row().clone()
    wrong[0] ^= 1
    assert not bool(tree.verify_rows_batch(wrong, tree.leaf_digests, idx, sib, auth).any())
    assert tree.generate_proof(5).verify(config, lp, tp, tree.root(), bytes(leaves[5].numpy()))


# The public paths on the card, for test_path_launches_its_kernels: each
# entry makes its inputs (not counted) and returns the call that is counted.

def _sha256_tree_path(op):
    def prepare(dev):
        from crypto_primitives_tpu_torch.models.merkle_tree.device import sha256_device_tree

        g = torch.Generator(device=dev).manual_seed(28)
        leaves = torch.randint(0, 256, (1024, 32), dtype=torch.uint8, device=dev, generator=g)
        if op == "build":
            return lambda: sha256_device_tree(leaves, device=dev)
        tree = sha256_device_tree(leaves, device=dev)
        idx = torch.arange(0, 1024, 7, device=dev)

        def verify():
            sib, auth = tree.proof_rows(idx)
            assert bool(tree.verify_rows_batch(tree.root_row(), tree.leaf_digests[idx], idx, sib, auth).all())
            assert bool(tree.multipath_verify_rows(tree.root_row(), tree.leaf_digests[idx], idx.tolist(), sib,
                                                   auth))
        return verify
    return prepare


def _poseidon_tree_path(op):
    def prepare(dev):
        from crypto_primitives_tpu_torch.models.merkle_tree.device import poseidon_device_tree

        cfg = get_default_poseidon_parameters(BLS12_381_FR, 2)
        leaves = _fr_rows((1024,), 29).to(dev)
        if op == "build":
            return lambda: poseidon_device_tree(BLS12_381_FR, cfg, leaves, device=dev)
        tree = poseidon_device_tree(BLS12_381_FR, cfg, leaves, device=dev)
        idx = torch.arange(0, 1024, 7, device=dev)

        def verify():
            sib, auth = tree.proof_rows(idx)
            assert bool(tree.verify_rows_batch(tree.root_row(), tree.leaf_digests[idx], idx, sib, auth).all())
        return verify
    return prepare


def _pedersen_tree_path(op):
    def prepare(dev):
        leaves = torch.randint(0, 256, (32, 8), dtype=torch.uint8, generator=torch.Generator().manual_seed(30))
        if op == "build":
            return lambda: _pedersen_tree(leaves.to(dev), dev)
        tree = _pedersen_tree(leaves.to(dev), dev)[0]
        idx = torch.arange(32, device=dev)

        def verify():
            sib, auth = tree.proof_rows(idx)
            assert bool(tree.verify_rows_batch(tree.root_row(), tree.leaf_digests, idx, sib, auth).all())
        return verify
    return prepare


def _sha256_path(dev):
    msgs = torch.randint(0, 256, (1024, 55), dtype=torch.uint8, generator=torch.Generator().manual_seed(31)).to(dev)
    return lambda: sha256(msgs, device=dev)


def _poseidon_two_to_one_path(dev):
    from crypto_primitives_tpu_torch.models.crh import PoseidonTwoToOneCRH

    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2)
    left, right = _fr_rows((256,), 32).to(dev), _fr_rows((256,), 33).to(dev)
    return lambda: PoseidonTwoToOneCRH(BLS12_381_FR).evaluate_batch(cfg, left, right, device=dev)


def _pedersen_path(curve_name, op):
    def prepare(dev):
        import random

        from crypto_primitives_tpu_torch.models.commitment import PedersenCommitment, PedersenCommitmentCompressor
        from crypto_primitives_tpu_torch.models.crh import PedersenCRH, Window
        from crypto_primitives_tpu_torch.models.crh.bowe_hopwood import BoweHopwoodCRH
        from crypto_primitives_tpu_torch.models.crh.injective_map import PedersenCRHCompressor
        from crypto_primitives_tpu_torch.ops import curves_known

        curve = getattr(curves_known, curve_name)
        rng = random.Random(34)
        inputs = torch.randint(0, 256, (64, 30), dtype=torch.uint8,
                               generator=torch.Generator().manual_seed(34)).to(dev)
        if op in ("crh", "crh_compressor", "bowe_hopwood"):
            crh = {"crh": PedersenCRH, "crh_compressor": PedersenCRHCompressor,
                   "bowe_hopwood": BoweHopwoodCRH}[op](curve, Window(6, 40))
            params = crh.setup(rng)
            return lambda: crh.evaluate_batch(params, inputs, device=dev)
        com = (PedersenCommitment if op == "commitment" else PedersenCommitmentCompressor)(curve, Window(6, 40))
        params = com.setup(rng)
        inner = com if op == "commitment" else com.inner
        bits = torch.from_numpy(inner.randomness_to_bits([com.rand_randomness(rng) for _ in range(64)])).to(dev)
        return lambda: com.commit_batch(params, inputs, bits, device=dev)
    return prepare


def _schnorr_path(curve_name, op):
    def prepare(dev):
        import random

        from crypto_primitives_tpu_torch.models.signature import Schnorr
        from crypto_primitives_tpu_torch.ops import curves_known

        scheme = Schnorr(getattr(curves_known, curve_name))
        rng = random.Random(35)
        params = scheme.setup(rng)
        if op == "keygen":
            return lambda: scheme.keygen_batch(params, rng, 40, device=dev)
        keys = scheme.keygen_batch(params, rng, 40, device=dev)
        msgs = [bytes([i]) * 5 for i in range(40)]
        if op == "sign":
            return lambda: scheme.sign_batch(params, [sk for _, sk in keys], msgs, rng, device=dev)
        sigs = scheme.sign_batch(params, [sk for _, sk in keys], msgs, rng, device=dev)
        return lambda: scheme.verify_batch(params, [pk for pk, _ in keys], msgs, sigs, device=dev)
    return prepare


def _elgamal_path(curve_name, op):
    def prepare(dev):
        import random

        from crypto_primitives_tpu_torch.models.encryption import ElGamal
        from crypto_primitives_tpu_torch.ops import curves_known

        curve = getattr(curves_known, curve_name)
        scheme = ElGamal(curve)
        rng = random.Random(36)
        params = scheme.setup(rng)
        pk, sk = scheme.keygen(params, rng)
        # 40 messages take r pk's fixed-base route, 5 (below 32) the windowed one
        n = 5 if op == "encrypt_windowed" else 40
        msgs = [curve.rand_point(rng) for _ in range(n)]
        rs = [scheme.rand_randomness(rng) for _ in range(n)]
        if op != "decrypt":
            return lambda: scheme.encrypt_batch(params, pk, msgs, rs, device=dev)
        cts = scheme.encrypt_batch(params, pk, msgs, rs, device=dev)
        return lambda: scheme.decrypt_batch(params, sk, cts, device=dev)
    return prepare


def _protocol_path(op):
    def prepare(dev):
        import random

        from crypto_primitives_tpu_torch.models.protocols.ipa_fold import ipa_fold_prove
        from crypto_primitives_tpu_torch.models.protocols.sumcheck import sumcheck_prove
        from crypto_primitives_tpu_torch.models.sponge.fiat_shamir import fold_argument
        from crypto_primitives_tpu_torch.ops.curves_known import JUBJUB

        cfg = get_default_poseidon_parameters(BLS12_381_FR, 2)
        rng = random.Random(37)
        if op == "fold_argument":
            coms = [[rng.randrange(BLS12_381_FR.p) for _ in range(5)] for _ in range(100)]
            return lambda: fold_argument(cfg, coms, device=dev)
        if op == "sumcheck":
            table = _fr_rows((64, 32), 37).to(dev)
            return lambda: sumcheck_prove(cfg, table, device=dev)
        gens = [JUBJUB.rand_point(rng) for _ in range(4)]
        scalars = [[rng.randrange(JUBJUB.scalar.p) for _ in range(4)] for _ in range(6)]
        return lambda: ipa_fold_prove(JUBJUB, cfg, gens, scalars, device=dev)
    return prepare


def _blake2s_prf_path(dev):
    from crypto_primitives_tpu_torch.models.prf import Blake2sPRF

    g = torch.Generator().manual_seed(38)
    seeds, inputs = (torch.randint(0, 256, (256, 32), dtype=torch.uint8, generator=g).to(dev) for _ in range(2))
    return lambda: Blake2sPRF.evaluate_batch(seeds, inputs, device=dev)


# (name, tag, its MSM wrapper) of the two curves the curve paths run on
_CURVES = (("ED_ON_BLS12_377", "ed377", "msm_kernel"), ("BLS12_381_G1", "g1", "msm_sw_kernel"))

_PATHS = {
    "sha256_tree.build": _sha256_tree_path("build"),
    "sha256_tree.verify": _sha256_tree_path("verify"),
    "poseidon_tree.build": _poseidon_tree_path("build"),
    "poseidon_tree.verify": _poseidon_tree_path("verify"),
    "pedersen_tree.build": _pedersen_tree_path("build"),
    "pedersen_tree.verify": _pedersen_tree_path("verify"),
    "ops.sha256": _sha256_path,
    "PoseidonTwoToOneCRH.evaluate_batch": _poseidon_two_to_one_path,
    "fold_argument": _protocol_path("fold_argument"),
    "sumcheck_prove": _protocol_path("sumcheck"),
    "ipa_fold_prove": _protocol_path("ipa"),
    "Blake2sPRF.evaluate_batch": _blake2s_prf_path,
    **{f"pedersen.{op}.ed377": _pedersen_path("ED_ON_BLS12_377", op)
       for op in ("crh_compressor", "commitment_compressor", "bowe_hopwood")},
    **{f"pedersen.{op}.{tag}": _pedersen_path(curve, op) for curve, tag, _ in _CURVES for op in ("crh", "commitment")},
    **{f"schnorr.{op}.{tag}": _schnorr_path(curve, op) for curve, tag, _ in _CURVES
       for op in ("keygen", "sign", "verify")},
    **{f"elgamal.{op}.{tag}": _elgamal_path(curve, op) for curve, tag, _ in _CURVES
       for op in ("encrypt", "encrypt_windowed", "decrypt")},
}

# (path, {wrapper module: launches}): an exact count where the path's shape
# fixes it (0: none), None for at least one; an empty dict for a path that
# launches no kernel at all.  1024 leaves: the leaf hash and 10 levels.
_PATH_LAUNCHES = [
    ("sha256_tree.build", {"sha256_kernel": 11}),
    ("sha256_tree.verify", {"sha256_kernel": None}),
    ("poseidon_tree.build", {"poseidon_kernel": 11}),
    ("poseidon_tree.verify", {"poseidon_kernel": None}),
    ("pedersen_tree.build", {"msm_kernel": None, "affine_kernel": None}),
    ("pedersen_tree.verify", {"msm_kernel": None}),
    ("ops.sha256", {"sha256_kernel": 1}),
    ("PoseidonTwoToOneCRH.evaluate_batch", {"poseidon_kernel": 1}),
    ("pedersen.crh_compressor.ed377", {"msm_kernel": 1}),
    ("pedersen.commitment_compressor.ed377", {"msm_kernel": 2, "add_kernel": 1}),
    ("pedersen.bowe_hopwood.ed377", {"msm_kernel": 1}),
    ("fold_argument", {"poseidon_kernel": None}),
    ("sumcheck_prove", {"poseidon_kernel": None}),
    ("ipa_fold_prove", {"poseidon_kernel": None, "add_kernel": None, "windowed_kernel": None, "pack_kernel": 1}),
    ("Blake2sPRF.evaluate_batch", {}),
]
for _, _tag, _msm in _CURVES:
    # the complete-addition, windowed-product and pack kernels run on the TE curve; G1 runs the first two in
    # plain torch and packs on the host
    _add = int(_msm == "msm_kernel")
    _PATH_LAUNCHES += [
        (f"pedersen.crh.{_tag}", {_msm: 1, "affine_kernel": 1, "add_kernel": 0}),
        (f"pedersen.commitment.{_tag}", {_msm: 2, "affine_kernel": 1, "add_kernel": _add}),
        *((f"schnorr.{op}.{_tag}", {_msm: None, "add_kernel": 0, "windowed_kernel": 0, "pack_kernel": 0})
          for op in ("keygen", "sign")),
        (f"schnorr.verify.{_tag}", {_msm: None, "add_kernel": _add, "windowed_kernel": _add, "pack_kernel": _add}),
        (f"elgamal.encrypt.{_tag}", {_msm: None, "add_kernel": _add, "windowed_kernel": 0, "pack_kernel": _add}),
        (f"elgamal.encrypt_windowed.{_tag}",
         {_msm: None, "add_kernel": _add, "windowed_kernel": _add, "pack_kernel": _add}),
        (f"elgamal.decrypt.{_tag}",
         {_msm: 0, "affine_kernel": None, "add_kernel": _add, "windowed_kernel": _add, "pack_kernel": _add}),
    ]


@pytest.mark.parametrize("path,needs", _PATH_LAUNCHES, ids=[p for p, _ in _PATH_LAUNCHES])
def test_path_launches_its_kernels(cuda, path, needs):
    """Each public path run on the card launches the kernels it must, read
    from the wrappers' ``launches`` counters around the call.  decrypt_batch
    (windowed products, as in the JAX package) launches no MSM kernel, only
    the affine step, the addition and, on a TE curve, the windowed product;
    on a TE curve each Schnorr verify, ElGamal batch and IPA fold packs its
    host points in one launch of A4; Blake2s launches no kernel at all."""
    from crypto_primitives_tpu_torch.ops import (
        add_kernel,
        affine_kernel,
        msm_kernel,
        msm_sw_kernel,
        pack_kernel,
        windowed_kernel,
    )

    wrappers = {"poseidon_kernel": poseidon_kernel, "sha256_kernel": sha256_kernel, "msm_kernel": msm_kernel,
                "msm_sw_kernel": msm_sw_kernel, "affine_kernel": affine_kernel, "add_kernel": add_kernel,
                "windowed_kernel": windowed_kernel, "pack_kernel": pack_kernel}
    run = _PATHS[path](cuda)
    before = {name: mod.launches for name, mod in wrappers.items()}
    run()
    torch.cuda.synchronize()
    launched = {name: mod.launches - before[name] for name, mod in wrappers.items()}
    for name, count in needs.items():
        assert launched[name] > 0 if count is None else launched[name] == count, launched
    if not needs:
        assert not any(launched.values()), launched


# The device trees' paths as CUDA graph replays (models/merkle_tree/device.py:
# GraphCache, _Graph): 1024-leaf SHA-256 and Poseidon trees, the 32-leaf
# Pedersen tree, each with its batch.
_GRAPH_TREES = ("sha256", "poseidon", "pedersen")


def _graph_tree(kind, dev):
    from crypto_primitives_tpu_torch.models.merkle_tree.device import poseidon_device_tree, sha256_device_tree

    if kind == "sha256":
        g = torch.Generator(device=dev).manual_seed(40)
        leaves = torch.randint(0, 256, (1024, 32), dtype=torch.uint8, device=dev, generator=g)
        return sha256_device_tree(leaves, device=dev), 256
    if kind == "poseidon":
        cfg = get_default_poseidon_parameters(BLS12_381_FR, 2)
        return poseidon_device_tree(BLS12_381_FR, cfg, _fr_rows((1024,), 41).to(dev), device=dev), 256
    leaves = torch.randint(0, 256, (32, 8), dtype=torch.uint8, generator=torch.Generator().manual_seed(42))
    return _pedersen_tree(leaves.to(dev), dev)[0], 16


def _graph_job(tree, batch, seed):
    """(idx, leaf digests) of one job: ``batch`` indexes drawn with
    replacement, every 16th leaf swapped for the leaf half the tree away."""
    n = tree.leaf_digests.shape[0]
    g = torch.Generator(device=tree.device).manual_seed(seed)
    idx = torch.randint(0, n, (batch,), device=tree.device, generator=g)
    src = idx.clone()
    src[::16] = (idx[::16] + n // 2) % n
    return idx, tree.leaf_digests.index_select(0, src)


def _paths(tree, idx, digests):
    sib, auth = tree.proof_rows(idx)
    return sib, auth, tree.verify_rows_batch(tree.root_row(), digests, idx, sib, auth)


def _eager_paths(tree, idx, digests):
    sib, auth = tree._gather(idx)
    return sib, auth, tree._verify(tree.root_row(), digests, idx, sib, auth)[0]


@pytest.mark.parametrize("kind", _GRAPH_TREES)
def test_tree_paths_replays_equal_the_eager_path(cuda, kind):
    """Four calls at one key, with other indexes each time: the first runs
    eagerly, the second captures, all equal the eager path bit for bit, the
    tampered proofs alone fail, and what a call handed out stays as it was
    after the later calls."""
    tree, batch = _graph_tree(kind, cuda)
    handed, copies = [], []
    for call in range(4):
        idx, digests = _graph_job(tree, batch, 50 + call)
        got = _paths(tree, idx, digests)
        assert len(tree.graphs.entries) == (0 if call == 0 else 2)
        want = _eager_paths(tree, idx, digests)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert got[2].tolist() == [i % 16 != 0 for i in range(batch)]
        handed.append(got)
        copies.append([x.clone() for x in got])
    for got, copy in zip(handed, copies):
        assert all(torch.equal(a, b) for a, b in zip(got, copy))


@pytest.mark.parametrize("kind", _GRAPH_TREES)
def test_a_replay_after_update_batch_reads_the_new_digests(cuda, kind):
    """update_batch writes the levels in place, so the graphs captured before
    it gather the new siblings and verify against the new root."""
    tree, batch = _graph_tree(kind, cuda)
    n = tree.leaf_digests.shape[0]
    idx, digests = _graph_job(tree, batch, 60)
    for _ in range(2):
        _paths(tree, idx, digests)
    graphs = dict(tree.graphs.entries)
    assert len(graphs) == 2
    old_root = tree.root_row().clone()
    moved = [3, n // 2 + 1, n - 2]
    tree.update_batch(moved, tree.leaf_digests[[(i + 5) % n for i in moved]].clone())
    assert not torch.equal(tree.root_row(), old_root)
    idx2 = idx.clone()
    idx2[1:4] = torch.tensor(moved, device=cuda)
    digests2 = tree.leaf_digests.index_select(0, idx2)
    got = _paths(tree, idx2, digests2)
    assert dict(tree.graphs.entries) == graphs  # replayed, not captured again
    assert all(torch.equal(a, b) for a, b in zip(got, _eager_paths(tree, idx2, digests2)))
    assert bool(got[2].all())


def test_a_new_batch_captures_a_new_graph_within_the_bound(cuda):
    """Each batch seen twice takes a graph of its own; the tree keeps
    GRAPH_KEYS of them, the least recently used going first; a batch seen
    once takes none."""
    from crypto_primitives_tpu_torch.models.merkle_tree.device import GRAPH_KEYS

    tree, _ = _graph_tree("sha256", cuda)
    sizes = [8 * (k + 1) for k in range(GRAPH_KEYS + 2)]
    for k, batch in enumerate(sizes):
        idx = torch.arange(batch, device=cuda) * 3
        want = tree._gather(idx)
        for _ in range(2):
            assert all(torch.equal(a, b) for a, b in zip(tree.proof_rows(idx), want))
        keys = [key[1][0][0] for key in tree.graphs.entries]
        assert keys == sizes[max(0, k + 1 - GRAPH_KEYS): k + 1]
    tree.proof_rows(torch.arange(5, device=cuda))
    assert len(tree.graphs.entries) == GRAPH_KEYS and 5 not in [key[1][0][0] for key in tree.graphs.entries]


@pytest.mark.parametrize("kind", _GRAPH_TREES)
def test_replays_raise_the_launch_counters_by_the_captured_launches(cuda, kind):
    """Every verify call, eager, capturing or replayed, raises the kernel
    wrappers' counters by the launches of one level loop: one a level (K4 and
    the affine step a level on the Pedersen tree); a gather raises none."""
    from crypto_primitives_tpu_torch.ops import affine_kernel, msm_kernel

    tree, batch = _graph_tree(kind, cuda)
    levels = tree.height - 1
    want = {"sha256": {sha256_kernel: levels}, "poseidon": {poseidon_kernel: levels},
            "pedersen": {msm_kernel: levels, affine_kernel: levels}}[kind]
    idx, digests = _graph_job(tree, batch, 70)
    for call in range(4):
        before = {mod: mod.launches for mod in want}
        sib, auth = tree.proof_rows(idx)
        assert {mod: mod.launches - before[mod] for mod in want} == {mod: 0 for mod in want}
        tree.verify_rows_batch(tree.root_row(), digests, idx, sib, auth)
        assert {mod: mod.launches - before[mod] for mod in want} == want, call
    verify = [g for key, g in tree.graphs.entries.items() if key[0] == "verify_rows_batch"]
    assert sum(verify[0].launched) == sum(want.values()) + (levels if kind == "poseidon" else 0)  # K1 in groups


def test_a_replay_is_one_kernel_graph_span_whose_kernels_the_profiler_sees(cuda):
    """Under torch.profiler a replayed verify is the root ``tree.verify_paths``
    holding one ``kernel.graph`` span of B x (height - 1) rows and none of
    the eager loop's spans, and the profiler's trace holds the K3 launches
    the graph runs."""
    from torch.profiler import ProfilerActivity, profile

    from crypto_primitives_tpu_torch.utils import profiling

    tree, batch = _graph_tree("sha256", cuda)
    idx, digests = _graph_job(tree, batch, 80)
    for _ in range(2):
        sib, auth = tree.proof_rows(idx)
        tree.verify_rows_batch(tree.root_row(), digests, idx, sib, auth)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tree.verify_rows_batch(tree.root_row(), digests, idx, sib, auth)
        torch.cuda.synchronize()
    spans = profiling.spans()
    assert [(s.name, s.rows) for s in spans] == [("tree.verify_paths", None), ("kernel.graph", batch * 10)]
    assert spans[1].parent == spans[0].id
    events = prof.profiler.kineto_results.events()
    k3 = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA and "digest_kernel" in e.name()]
    assert len(k3) == tree.height - 1, sorted({e.name() for e in events})
