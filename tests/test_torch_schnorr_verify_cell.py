"""The port's Schnorr verification at upstream's ``benches/signature.rs``
deployment (ed-on-bls12-377, Blake2s-256, 128-byte messages) against the
benchmark's plain reference (``portbench/reference/schnorr_ref.py``), on the
CPU: a seeded pool of 20 signed rows, rows made to verify with s = 0, with
s = r - 1 and with an e of the full 251 bits, and one row of each of the
traffic's three tamperings; the port's batch verdicts against the
reference's, the reference's against the intent and against the port's host
``verify``; the reference's refusal of a bad key or generator; the
configuration's pool and job draws from the seed; the challenge's three
passes against the per-row challenge, a digest that maps to no scalar
included, and the verdicts with spans on and off; the ``sig.*`` and
``curve.*`` spans under ``torch.profiler`` and the benchmark's readers of
them.  On the card (marked ``cuda``, skipped without one): the
configuration's program against the reference, through three launches."""

import dataclasses
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crypto_primitives_tpu_torch.models.signature import Schnorr, SchnorrSignature
from crypto_primitives_tpu_torch.ops import curve_sw_fast
from crypto_primitives_tpu_torch.ops.curves_known import ED_ON_BLS12_377, PALLAS
from crypto_primitives_tpu_torch.utils import profiling
from portbench.harness import loader
from portbench.harness.spans import Spans

torch.set_num_threads(1)
CFG = loader.data("configs", "schnorr_ed377_blake2s")
CFGMOD = loader.module("configs", "schnorr_ed377_blake2s")
MIX = loader.data("traffic", "sig_verify")
KIND = loader.module("kinds", "sig_verify")
CURVE = ED_ON_BLS12_377
P = CURVE.base.p
ORDER = CURVE.scalar.p


def _crafted(params, ref, rng, message, s=None, full_e=False):
    """A key and a signature (s, e) that verifies on ``message``, with s
    given, or with e >= 2^250: k first, then e from k G, then the key
    sk = (k - s) / e, so that s G + e pk = k G."""
    while True:
        k = rng.randrange(1, ORDER)
        e = ref.challenge(params.salt, CURVE.scalar_mul_host(params.generator, k), message)
        if e is None or e == 0 or (full_e and e < 1 << 250):
            continue
        s_ = rng.randrange(ORDER) if s is None else s
        sk = (k - s_) * pow(e, -1, ORDER) % ORDER
        return CURVE.scalar_mul_host(params.generator, sk), SchnorrSignature(prover_response=s_, verifier_challenge=e)


@pytest.fixture(scope="module")
def pool():
    """(scheme, params, ref, keys, messages, signatures, intent): 20 rows
    signed by ``sign_batch``, three crafted (s = 0, s = r - 1, e of 251
    bits), then a changed message byte, s + 1 mod r on the s = r - 1 row
    (it wraps to 0), and another row's key."""
    scheme = Schnorr(CURVE, digest=CFGMOD.blake2s_256)
    rng = random.Random(2**31 + 41)
    params = scheme.setup(rng)
    ref = CFGMOD.Reference(CFG, "cpu")
    messages = [rng.randbytes(CFG["message_bytes"]) for _ in range(23)]
    pairs = scheme.keygen_batch(params, rng, 20, device="cpu")
    sigs = scheme.sign_batch(params, [sk for _, sk in pairs], messages[:20], rng, device="cpu")
    pks = [pk for pk, _ in pairs]
    for m, kw in zip(messages[20:], [{"s": 0}, {"s": ORDER - 1}, {"full_e": True}]):
        pk, sig = _crafted(params, ref, rng, m, **kw)
        pks.append(pk)
        sigs.append(sig)
    changed = bytearray(messages[0])
    changed[77] ^= 0x10
    pks += [pks[0], pks[21], pks[3]]
    messages += [bytes(changed), messages[21], messages[2]]
    sigs += [sigs[0], dataclasses.replace(sigs[21], prover_response=(sigs[21].prover_response + 1) % ORDER), sigs[2]]
    intent = np.array([True] * 23 + [False] * 3)
    return scheme, params, ref, pks, messages, sigs, intent


def test_the_pool_has_its_edge_rows(pool):
    _, _, _, pks, _, sigs, _ = pool
    assert [g.prover_response for g in sigs[20:22]] == [0, ORDER - 1] and sigs[24].prover_response == 0
    assert sigs[22].verifier_challenge >= 1 << 250
    assert pks[25] != pks[2]


def test_verify_batch_equals_the_reference_and_the_intent(pool):
    scheme, params, ref, pks, messages, sigs, intent = pool
    got = scheme.verify_batch(params, pks, messages, sigs, device="cpu")
    want = ref.verdicts((params.generator, params.salt), (pks, messages, sigs))
    assert got == want.tolist()
    assert np.array_equal(want, intent)


def test_reference_equals_the_host_verify(pool):
    scheme, params, ref, pks, messages, sigs, intent = pool
    host = [scheme.verify(params, pk, m, g) for pk, m, g in zip(pks, messages, sigs)]
    assert host == ref.verdicts((params.generator, params.salt), (pks, messages, sigs)).tolist() == intent.tolist()


@pytest.mark.parametrize("bad", ["key_off_curve", "generator_off_curve", "generator_outside_subgroup"])
def test_reference_refuses_a_bad_point(pool, bad):
    _, params, ref, pks, messages, sigs, _ = pool
    (gx, gy), keys = params.generator, list(pks[:2])
    generator = params.generator
    if bad == "key_off_curve":
        keys[1], match = (keys[1][0], (keys[1][1] + 1) % P), "key 1 is not on the curve"
    elif bad == "generator_off_curve":
        generator, match = (gx, (gy + 1) % P), "generator is not on the curve"
    else:  # G + (0, -1), the point of order 2 added
        generator, match = ((-gx) % P, (-gy) % P), "generator is not in the subgroup"
    with pytest.raises(ValueError, match=match):
        ref.verdicts((generator, params.salt), (keys, messages[:2], sigs[:2]))


def _traffic(seed, batch):
    program = CFGMOD.Program(CFG, "cpu")
    traffic = KIND.Traffic(MIX, CFG, CFGMOD, program, seed, "cpu", {"batch": batch})
    traffic.setup(Spans())
    return traffic


def test_pool_and_job_draws_repeat_from_the_seed():
    a, b = _traffic(2**40 + 3, 48), _traffic(2**40 + 3, 48)
    assert a.pool == 48 and a.tampered == 3
    assert a.public == b.public and a.messages == b.messages and a.pks == b.pks
    assert [(g.prover_response, g.verifier_challenge) for g in a.sigs] == \
           [(g.prover_response, g.verifier_challenge) for g in b.sigs]
    assert len(set(a.pks)) == 48 and all(len(m) == CFG["message_bytes"] for m in a.messages)
    ka, kb, kc = a.inputs(3), b.inputs(3), a.inputs(4)
    assert ka == kb and ka != kc
    pks, messages, sigs, tampered = ka
    assert len(pks) == len(messages) == len(sigs) == 48 and len(tampered) == 3
    # the three forms in turn: a message byte, s + 1, another row's key
    m_row, s_row, k_row = tampered
    assert messages[m_row] not in a.messages
    assert any(sum(x != y for x, y in zip(messages[m_row], m)) == 1 for m in a.messages)
    assert all(messages[i] in a.messages for i in range(48) if i != m_row)
    s_pairs = {(g.prover_response, g.verifier_challenge) for g in a.sigs}
    assert (sigs[s_row].prover_response - 1) % ORDER in {s for s, e in s_pairs if e == sigs[s_row].verifier_challenge}
    assert pks[k_row] in a.pks and a.pks.index(pks[k_row]) != a.sigs.index(sigs[k_row])
    other = _traffic(2**40 + 4, 48)
    assert other.messages != a.messages and other.pks != a.pks


def test_spans_of_a_verify(pool):
    scheme, params, _, pks, messages, sigs, _ = pool
    B = 4
    with profile(activities=[ProfilerActivity.CPU]):
        out = scheme.verify_batch(params, pks[:B], messages[:B], sigs[:B], device="cpu")
    spans = profiling.spans()
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in spans)
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["sig.verify"]
    children = [s for s in spans if s.parent == roots[0].id]
    assert [c.name for c in children] == ["sig.bits", "sig.pack", "sig.fixed", "sig.windowed", "sig.add",
                                          "sig.affine", "sig.challenge"]
    assert all(c.rows is None for c in children)
    inner = {c.name: [(s.name, s.rows) for s in spans if s.parent == c.id] for c in children}
    assert inner == {"sig.bits": [("curve.bits", B), ("curve.bits", B)],
                     "sig.pack": [("curve.pack", B), ("kernel.pack", None)], "sig.fixed": [("kernel.k4", B)],
                     # the plain pack, product, addition and affine step give no rows
                     "sig.windowed": [("kernel.windowed", None)], "sig.add": [("kernel.add", None)],
                     "sig.affine": [("kernel.affine", None), ("curve.to_host", B), ("curve.host_ints", B)],
                     "sig.challenge": [("sig.serialize", B), ("sig.digest", B), ("sig.to_scalar", B)]}
    # nothing below those: the root, its 7 stages and the 13 spans inside them
    assert len(spans) == 1 + 7 + 13 and "curve.windowed" not in {s.name for s in spans}
    assert out == scheme.verify_batch(params, pks[:B], messages[:B], sigs[:B], device="cpu")


def test_curve_tier_spans_on_a_sw_curve():
    """The short-Weierstrass tier shares the TE tier's moves between host and
    device, and their spans: ``curve.pack`` and ``curve.bits`` with the
    points and scalars as ``rows`` (one point counts one), ``curve.to_host``
    and ``curve.host_ints`` with the points read back."""
    rng = random.Random(3)
    pts = [PALLAS.rand_point(rng) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU]):
        one = curve_sw_fast.pack_points(PALLAS, pts[0])
        words = torch.from_numpy(curve_sw_fast.pack_points(PALLAS, pts))
        bits = curve_sw_fast.scalars_to_bits(PALLAS, [5, 200])
        back = curve_sw_fast.unpack_affine(PALLAS, words)
    assert one.shape == (3, PALLAS.base.num_words) and bits.shape == (2, PALLAS.scalar.nbits)
    assert list(back) == pts
    named = [(s.name, s.parent, s.rows) for s in profiling.spans() if s.name.startswith("curve.")]
    assert named == [("curve.pack", None, 1), ("curve.pack", None, 3), ("curve.bits", None, 2),
                     ("curve.to_host", None, 3), ("curve.host_ints", None, 3)]


def _per_row(scheme, params, pks, messages, sigs):
    """The verdicts of the per-row loop the three passes replace: ``verify``'s
    r' on the host, then ``_challenge`` a row and the comparison."""
    out = []
    for pk, m, g in zip(pks, messages, sigs):
        r = scheme.curve.scalar.p
        r_prime = scheme.curve.add_host(scheme.curve.scalar_mul_host(params.generator, g.prover_response % r),
                                        scheme.curve.scalar_mul_host(pk, g.verifier_challenge % r))
        e = scheme._challenge(params, r_prime, m)
        out.append(e is not None and e == g.verifier_challenge)
    return out


def test_challenge_passes_equal_the_per_row_challenge(pool):
    """The challenge's three passes give the per-row loop's verdicts, row for
    row, where a row's digest maps to no scalar: a stand-in digest gives 32
    bytes 0xFF (2^251 - 1 once masked to r's 251 bits, at least r) on
    messages whose last byte is odd, and that row reads False."""
    scheme, params, _, pks, messages, sigs, intent = pool

    def digest(data):
        return b"\xff" * 32 if data[-1] & 1 else CFGMOD.blake2s_256(data)

    assert scheme._from_random_bytes(b"\xff" * 32) is None
    stand_in = Schnorr(CURVE, digest=digest)
    got = stand_in.verify_batch(params, pks, messages, sigs, device="cpu")
    assert got == _per_row(stand_in, params, pks, messages, sigs)
    odd = np.array([m[-1] & 1 for m in messages], dtype=bool)
    assert odd.any() and (intent & ~odd).any()
    assert not np.array(got)[odd].any()
    assert np.array_equal(np.array(got)[~odd], intent[~odd])


def test_verdicts_equal_with_spans_on_and_off(pool):
    scheme, params, ref, pks, messages, sigs, intent = pool
    before = profiling.spans()
    off = scheme.verify_batch(params, pks, messages, sigs, device="cpu")
    assert profiling.spans() == before
    with profile(activities=[ProfilerActivity.CPU]):
        on = scheme.verify_batch(params, pks, messages, sigs, device="cpu")
    assert [s.rows for s in profiling.spans() if s.name == "sig.digest"] == [len(sigs)]
    assert on == off == intent.tolist()


def _read(metric, run):
    return loader.module("metrics", metric).read(run)


def test_readers_of_the_verify_spans():
    """``sig_windowed_ms`` reads the ``sig.windowed`` spans inside the
    ``sig.verify`` roots and ``sig_host_ms`` the ``sig.bits``, ``sig.pack``
    and ``sig.challenge`` ones, a job each; None without a trace or where no
    root is ``sig.verify``, as on a program whose verify keeps no spans."""
    traced = SimpleNamespace(trace=object())
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.annotate("sig.verify"):
                for name in ("sig.bits", "sig.pack", "sig.fixed"):
                    with profiling.annotate(name):
                        pass
                with profiling.annotate("sig.windowed"), profiling.annotate("kernel.windowed", 8):
                    sum(range(1000))
                with profiling.annotate("sig.challenge"):
                    pass
    ms = {}
    for s in profiling.spans():
        ms[s.name] = ms.get(s.name, 0) + (s.end_ns - s.start_ns) * 1e-6 / 2
    assert _read("sig_windowed_ms", traced) == pytest.approx(ms["sig.windowed"])
    assert _read("sig_host_ms", traced) == pytest.approx(ms["sig.bits"] + ms["sig.pack"] + ms["sig.challenge"])
    assert _read("sig_windowed_ms", SimpleNamespace(trace=None)) is None
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("kernel.windowed", 8):
            pass
    assert _read("sig_windowed_ms", traced) is None and _read("sig_host_ms", traced) is None


# each reader of a verify's host stages and the spans it sums
STAGES = {"sig_pack_ms": ("curve.pack",), "sig_bits_ms": ("curve.bits",), "sig_unpack_ms": ("curve.host_ints",),
          "sig_wait_ms": ("curve.to_host",), "sig_digest_ms": ("sig.digest",),
          "sig_encode_ms": ("sig.serialize", "sig.to_scalar")}
# a verify job's span tree, as ``verify_batch`` opens it: (stage, the spans inside it)
JOB = [("sig.bits", ("curve.bits", "curve.bits")), ("sig.pack", ("curve.pack", "kernel.pack")),
       ("sig.fixed", ("kernel.k4",)),
       ("sig.windowed", ("kernel.windowed",)), ("sig.add", ("kernel.add",)),
       ("sig.affine", ("kernel.affine", "curve.to_host", "curve.host_ints")),
       ("sig.challenge", ("sig.serialize", "sig.digest", "sig.to_scalar"))]


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_readers_of_the_host_stages(metric):
    """Each reads its spans inside the ``sig.verify`` roots, ms a job, and not
    a span of its name outside them (set-up's keys); None without a trace,
    where no root is ``sig.verify``, or where the verify keeps no such span,
    as on a program whose stages have no spans inside them."""
    traced = SimpleNamespace(trace=object())
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("curve.pack", 16), profiling.annotate("curve.bits", 16):
            sum(range(1000))
        for _ in range(2):
            with profiling.annotate("sig.verify"):
                for stage, names in JOB:
                    with profiling.annotate(stage):
                        for name in names:
                            with profiling.annotate(name, 8):
                                sum(range(1000))
    spans = profiling.spans()
    roots = {s.id for s in spans if s.name == "sig.verify"}
    by_id = {s.id: s for s in spans}
    want = sum(s.end_ns - s.start_ns for s in spans
               if s.name in STAGES[metric] and s.parent is not None and by_id[s.parent].parent in roots)
    assert want > 0
    assert _read(metric, traced) == pytest.approx(want * 1e-6 / 2)
    assert _read(metric, SimpleNamespace(trace=None)) is None
    with profile(activities=[ProfilerActivity.CPU]):
        for name in STAGES[metric]:
            with profiling.annotate(name, 8):
                pass
    assert _read(metric, traced) is None
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("sig.verify"):
            for stage, _ in JOB:
                with profiling.annotate(stage):
                    pass
    assert _read(metric, traced) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_program_on_the_card_equals_the_reference(cuda):
    """The configuration's program on a 256-row pool and job on the card:
    verdicts the reference's and the intent, through one K4, one A2 and one
    A1 launch."""
    program = CFGMOD.Program(CFG, cuda)
    traffic = KIND.Traffic(MIX, CFG, CFGMOD, program, 2**31 + 31, cuda, {"batch": 256})
    traffic.setup(Spans())
    pks, messages, sigs, tampered = traffic.inputs(0)
    before = program.launches()
    got = program.verify((pks, messages, sigs))
    after = program.launches()
    assert {k: after[k] - before[k] for k in after} == {"crypto_primitives_tpu_torch.ops.msm_kernel": 1,
                                                        "crypto_primitives_tpu_torch.ops.add_kernel": 1,
                                                        "crypto_primitives_tpu_torch.ops.affine_kernel": 1}
    want = CFGMOD.Reference(CFG, cuda).verdicts(traffic.public, (pks, messages, sigs))
    assert got == want.tolist()
    assert sorted(np.flatnonzero(~want).tolist()) == tampered
