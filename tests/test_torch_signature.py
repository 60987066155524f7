"""The port's Schnorr signatures against crypto_primitives_tpu's.

Both packages draw from ``random.Random`` seeds, so the same seed gives the
same parameters, keys and signatures.  The host tier is compared as Python
ints and booleans (rerandomization included); the batch tier (the port's
plain PyTorch versions on the CPU, 3-4 rows a call) against JAX's batch tier
on JubJub and ed-on-bls12-377, including ``candidates=1`` runs whose seeds
reach a retry pass and the host tail; on BLS12-381 G1, where the JAX
package's own batch tests are slow, against JAX's host tier.  Tolerance:
exact equality (integer outputs).
"""

import random

import pytest
import torch

from crypto_primitives_tpu.models.signature import Schnorr as JSchnorr
from crypto_primitives_tpu.models.signature.schnorr import _randomness_multiplier as j_multiplier
from crypto_primitives_tpu.ops import curves_known as jck
from crypto_primitives_tpu_torch.errors import DeviceUnavailable
from crypto_primitives_tpu_torch.models.signature import Schnorr, SchnorrSignature
from crypto_primitives_tpu_torch.models.signature.schnorr import _randomness_multiplier
from crypto_primitives_tpu_torch.ops import curve_fast
from crypto_primitives_tpu_torch.ops import curves_known as tck

torch.set_num_threads(1)
CPU = "cpu"
MESSAGES = [b"m0", b"m1", b"m2"]


def _sig(s):
    return (s.prover_response, s.verifier_challenge)


@pytest.mark.parametrize("name", ["JUBJUB", "ED_ON_BLS12_377", "BLS12_381_G1"])
def test_host_tier_matches_jax(name):
    j, t = JSchnorr(getattr(jck, name)), Schnorr(getattr(tck, name))
    rj, rt = random.Random(1), random.Random(1)
    pj, pt = j.setup(rj), t.setup(rt)
    assert (pt.generator, pt.salt) == (pj.generator, pj.salt)
    (pkj, skj), (pkt, skt) = j.keygen(pj, rj), t.keygen(pt, rt)
    assert (pkt, skt) == (pkj, skj)
    sj, st = j.sign(pj, skj, b"message", rj), t.sign(pt, skt, b"message", rt)
    assert _sig(st) == _sig(sj)
    assert rj.random() == rt.random()
    assert t.verify(pt, pkt, b"message", st) and j.verify(pj, pkj, b"message", st)
    assert not t.verify(pt, pkt, b"massage", st)
    randomness = bytes(range(7, 39))
    assert _randomness_multiplier(randomness) == j_multiplier(randomness)
    rpk = t.randomize_public_key(pt, pkt, randomness)
    rsig = t.randomize_signature(pt, st, randomness)
    assert rpk == j.randomize_public_key(pj, pkj, randomness)
    assert _sig(rsig) == _sig(j.randomize_signature(pj, sj, randomness))
    assert t.verify(pt, rpk, b"message", rsig)


def _batch_run(scheme, seed, candidates, **device):
    rng = random.Random(seed)
    params = scheme.setup(rng)
    keys = scheme.keygen_batch(params, rng, 3, **device)
    sigs = scheme.sign_batch(params, [sk for _, sk in keys], MESSAGES, rng, candidates=candidates, **device)
    return rng, params, keys, sigs


@pytest.mark.parametrize("name,seed,candidates,passes_tail", [
    ("JUBJUB", 4, 4, (2, 0)), ("ED_ON_BLS12_377", 4, 4, (3, 0)), ("JUBJUB", 58, 1, (3, 0)), ("ED_ON_BLS12_377", 25, 1, (2, 2)),
])
def test_batch_tier_matches_jax(name, seed, candidates, passes_tail, monkeypatch):
    """keygen_batch and sign_batch from one seed equal JAX's, and leave the
    generator in the same state; verify_batch gives JAX's verdicts on true
    signatures, an altered message and swapped keys (one call of 9 rows).
    The fixed-base passes (keygen's, the first signing pass, retry passes)
    and the host-tail signatures are counted on the port's side: two seeds
    reach a retry pass, seed 25 (at candidates = 1, two of three messages
    rejected twice, more than the rows allow to retry) the host tail."""
    j, t = JSchnorr(getattr(jck, name)), Schnorr(getattr(tck, name))
    passes, tail = [], []
    fixed_base_mul, sign = curve_fast.fixed_base_mul, Schnorr.sign
    monkeypatch.setattr(curve_fast, "fixed_base_mul", lambda *a, **k: passes.append(1) or fixed_base_mul(*a, **k))
    monkeypatch.setattr(Schnorr, "sign", lambda self, *a: tail.append(1) or sign(self, *a))
    rt, pt, keys_t, sigs_t = _batch_run(t, seed, candidates, device=CPU)
    rj, pj, keys_j, sigs_j = _batch_run(j, seed, candidates)
    assert keys_t == keys_j
    assert [_sig(s) for s in sigs_t] == [_sig(s) for s in sigs_j]
    assert rt.random() == rj.random()
    assert (len(passes), len(tail)) == passes_tail
    pks = [pk for pk, _ in keys_t]
    rows_pk = pks + pks + [pks[1], pks[0], pks[2]]
    rows_m = MESSAGES + MESSAGES[:2] + [b"altered"] + MESSAGES
    got = t.verify_batch(pt, rows_pk, rows_m, sigs_t * 3, device=CPU)
    assert got == j.verify_batch(pj, rows_pk, rows_m, sigs_j * 3)
    assert got == [True] * 3 + [True, True, False] + [False, False, True]


def test_g1_batches_against_jax_host_tier():
    """BLS12-381 G1: keygen_batch equals n JAX host keygens from the same
    seed; JAX's host verify accepts every signature of sign_batch; the port's
    verify_batch gives JAX's host verdicts on true, altered-message and
    swapped-key rows (one call of 9 rows)."""
    jc, tc = jck.BLS12_381_G1, tck.BLS12_381_G1
    j, t = JSchnorr(jc), Schnorr(tc)
    rng = random.Random(9)
    params = t.setup(rng)
    keys = t.keygen_batch(params, rng, 3, device=CPU)
    rj = random.Random(9)
    pj = j.setup(rj)
    assert keys == [j.keygen(pj, rj) for _ in range(3)]
    sigs = t.sign_batch(params, [sk for _, sk in keys], MESSAGES, rng, device=CPU)
    pks = [pk for pk, _ in keys]
    assert all(j.verify(pj, pk, m, s) for pk, m, s in zip(pks, MESSAGES, sigs))
    rows_pk = pks + pks + [pks[1], pks[2], pks[0]]
    rows_m = MESSAGES + [b"x", MESSAGES[1], MESSAGES[2]] + MESSAGES
    got = t.verify_batch(params, rows_pk, rows_m, sigs * 3, device=CPU)
    assert got == [j.verify(pj, pk, m, s) for pk, m, s in zip(rows_pk, rows_m, sigs * 3)]
    assert got == [True] * 3 + [False, True, True] + [False] * 3


def test_batch_entry_points_need_cuda_or_cpu():
    """Without device='cpu' the batch entry points raise DeviceUnavailable
    (where no card is present), before drawing from the generator."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    t = Schnorr(tck.JUBJUB)
    rng = random.Random(2)
    params = t.setup(rng)
    state = rng.getstate()
    sig = SchnorrSignature(1, 1)
    for call in (lambda: t.keygen_batch(params, rng, 2),
                 lambda: t.sign_batch(params, [1], [b"m"], rng),
                 lambda: t.verify_batch(params, [params.generator], [b"m"], [sig])):
        with pytest.raises(DeviceUnavailable):
            call()
    assert rng.getstate() == state
    with pytest.raises(ValueError):
        t.sign_batch(params, [1, 2], [b"m"], rng, device=CPU)
