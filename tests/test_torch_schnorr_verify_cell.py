"""The port's Schnorr verification at upstream's ``benches/signature.rs``
deployment (ed-on-bls12-377, Blake2s-256, 128-byte messages) against the
benchmark's plain reference (``portbench/reference/schnorr_ref.py``), on the
CPU: a seeded pool of 20 signed rows, rows made to verify with s = 0, with
s = r - 1 and with an e of the full 251 bits, and one row of each of the
traffic's three tamperings; the port's batch verdicts against the
reference's, the reference's against the intent and against the port's host
``verify``; the reference's refusal of a bad key or generator; the
configuration's pool and job draws from the seed; the ``sig.*`` and
``curve.windowed`` spans under ``torch.profiler`` and the benchmark's readers
of them.  On the card (marked ``cuda``, skipped without one): the
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
    with profile(activities=[ProfilerActivity.CPU]):
        out = scheme.verify_batch(params, pks[:4], messages[:4], sigs[:4], device="cpu")
    spans = profiling.spans()
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in spans)
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["sig.verify"]
    children = [s for s in spans if s.parent == roots[0].id]
    assert [c.name for c in children] == ["sig.bits", "sig.pack", "sig.fixed", "sig.windowed", "sig.add",
                                          "sig.affine", "sig.challenge"]
    inner = [(s.name, s.parent, s.rows) for s in spans if s.name.startswith(("kernel.", "curve."))]
    windowed = next(s for s in spans if s.name == "curve.windowed")
    assert inner == [("kernel.k4", children[2].id, 4), ("curve.windowed", children[3].id, 4),
                     # the plain product, addition and affine step give no rows
                     ("kernel.windowed", windowed.id, None), ("kernel.add", children[4].id, None),
                     ("kernel.affine", children[5].id, None)]
    assert out == scheme.verify_batch(params, pks[:4], messages[:4], sigs[:4], device="cpu")


def test_sw_windowed_product_span_counts_broadcast_points():
    base = torch.from_numpy(curve_sw_fast.pack_points(PALLAS, PALLAS.rand_point(random.Random(3))))
    bits = torch.from_numpy(curve_sw_fast.scalars_to_bits(PALLAS, [5, 200]))[:, :8]  # two windows
    with profile(activities=[ProfilerActivity.CPU]):
        out = curve_sw_fast.scalar_mul_bits_windowed(PALLAS, base, bits)
    assert out.shape == (2, 3, PALLAS.base.num_words)
    assert [(s.name, s.parent, s.rows) for s in profiling.spans()] == [("curve.windowed", None, 2)]


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
                with profiling.annotate("sig.windowed"), profiling.annotate("curve.windowed", 8):
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
        with profiling.annotate("curve.windowed", 8):
            pass
    assert _read("sig_windowed_ms", traced) is None and _read("sig_host_ms", traced) is None


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
