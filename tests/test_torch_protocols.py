"""The port's Fiat-Shamir transcript, fold argument, multilinear sumcheck and
IPA folding argument against the JAX package's.

The batched provers run on the CPU (the plain version of the permutation
kernel) and are held against the JAX package's host oracles
(``fold_argument_host``, ``sumcheck_prove_host``, ``ipa_fold_prove_host``)
and, at n = 2, against its device IPA prover itself (``ipa_fold_prove_rns``,
as its own non-slow test runs it).  The port's host oracles and verifiers
are held against JAX's, and both packages' verifiers must accept the port's
transcripts and reject the same forgeries.  Inputs are made from seeds
(numpy, ``random.Random``).  Tolerance: exact equality throughout.
"""

import random

import numpy as np
import pytest
import torch

from crypto_primitives_tpu.models.protocols import sumcheck_prove_host as j_sumcheck_host
from crypto_primitives_tpu.models.protocols import sumcheck_verify_host as j_sumcheck_verify
from crypto_primitives_tpu.models.protocols.ipa_fold import ipa_fold_prove_host as j_ipa_host
from crypto_primitives_tpu.models.protocols.ipa_fold import ipa_fold_prove_rns as j_ipa_prove
from crypto_primitives_tpu.models.protocols.ipa_fold import ipa_fold_verify_host as j_ipa_verify
from crypto_primitives_tpu.models.sponge import get_default_poseidon_parameters as j_params
from crypto_primitives_tpu.models.sponge.fiat_shamir import fold_argument_host as j_fold_host
from crypto_primitives_tpu.ops import curves_known as jck
from crypto_primitives_tpu.ops.fields_known import BLS12_381_FR as JFR
from crypto_primitives_tpu_torch.models.protocols import sumcheck_prove, sumcheck_prove_host, sumcheck_verify_host
from crypto_primitives_tpu_torch.models.protocols.ipa_fold import (
    ipa_fold_prove,
    ipa_fold_prove_host,
    ipa_fold_verify_host,
)
from crypto_primitives_tpu_torch.models.protocols.sumcheck import sumcheck_prover_compiled
from crypto_primitives_tpu_torch.models.sponge import PoseidonSponge, get_default_poseidon_parameters
from crypto_primitives_tpu_torch.models.sponge.fiat_shamir import FiatShamir, fold_argument, fold_argument_host
from crypto_primitives_tpu_torch.ops import curves_known as tck
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR

torch.set_num_threads(1)
CPU = "cpu"
CFG = get_default_poseidon_parameters(FR, 2, False)
JCFG = j_params(JFR, 2, False)


def _elements(p, shape, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % p for _ in range(int(np.prod(shape)))]
    return np.asarray(vals, dtype=object).reshape(shape)


def _ints(words):
    return [int(v) for v in np.atleast_1d(FR.unpack(words))]


def test_fold_argument_matches_jax_host():
    coms = _elements(FR.p, (8, 4), 1)
    coms[0, 1] = 0
    tag, z = fold_argument(CFG, coms, device=CPU)
    assert tag.shape == (8, 1, FR.num_words) and z.shape == (8, FR.num_words)
    tags, zs = j_fold_host(JCFG, coms)
    assert _ints(tag[:, 0]) == tags
    assert _ints(z) == zs
    assert fold_argument_host(CFG, coms) == (tags, zs)


def test_transcript_challenges_match_host_sponge():
    vals = _elements(FR.p, (4,), 2)
    t = FiatShamir(CFG, batch_shape=(4,), device=CPU)
    t.absorb(torch.from_numpy(FR.pack(vals))[:, None, :])
    c1 = t.challenge()
    t.absorb(c1[:, None, :])
    c23 = t.challenges(2)
    fin = t.finalize(1)
    for b in range(4):
        s = PoseidonSponge(CFG)
        s.absorb_elements([int(vals[b])])
        w1 = s.squeeze_native_field_elements(1)[0]
        s.absorb_elements([w1])
        w23 = s.squeeze_native_field_elements(2)
        assert _ints(c1)[b] == w1
        assert [_ints(c23[:, k])[b] for k in range(2)] == w23
        assert _ints(fin[:, 0])[b] == s.squeeze_native_field_elements(1)[0]


def _sumcheck_table(B, m, seed):
    return _elements(FR.p, (B, 1 << m), seed)


def test_sumcheck_matches_jax_host_and_both_verifiers_accept():
    B, m = 4, 4
    table = _sumcheck_table(B, m, 3)
    table[0, :] = 0
    s_row, rounds, final_row = sumcheck_prove(CFG, torch.from_numpy(FR.pack(table)), device=CPU)
    sums, rounds_h, chals, finals = j_sumcheck_host(JCFG, table)
    assert (sums, rounds_h, chals, finals) == sumcheck_prove_host(CFG, table)
    assert _ints(s_row) == sums
    assert _ints(final_row) == finals
    assert len(rounds) == m
    for b in range(B):
        got = [(_ints(p0)[b], _ints(p1)[b]) for p0, p1 in rounds]
        assert got == rounds_h[b]
        assert j_sumcheck_verify(JCFG, sums[b], got, finals[b])
        assert sumcheck_verify_host(CFG, sums[b], got, finals[b])


@pytest.mark.parametrize("verify", ["port", "jax"])
def test_sumcheck_verifiers_reject_forgeries(verify):
    fn, cfg = (sumcheck_verify_host, CFG) if verify == "port" else (j_sumcheck_verify, JCFG)
    table = _sumcheck_table(1, 4, 4)
    s_row, rounds, final_row = sumcheck_prove(CFG, torch.from_numpy(FR.pack(table)), device=CPU)
    S, g_r = _ints(s_row)[0], _ints(final_row)[0]
    good = [(_ints(p0)[0], _ints(p1)[0]) for p0, p1 in rounds]
    assert fn(cfg, S, good, g_r)
    assert not fn(cfg, (S + 1) % FR.p, good, g_r)
    bad = list(good)
    bad[1] = ((bad[1][0] + 1) % FR.p, bad[1][1])
    assert not fn(cfg, S, bad, g_r)
    assert not fn(cfg, S, good, (g_r + 1) % FR.p)


def test_compiled_prover_on_the_cpu_is_the_eager_prover():
    table = torch.from_numpy(FR.pack(_sumcheck_table(2, 3, 5)))
    fn = sumcheck_prover_compiled(CFG)
    assert fn is sumcheck_prover_compiled(CFG)
    s1, r1, f1 = fn(table)
    s2, r2, f2 = sumcheck_prove(CFG, table, device=CPU)
    assert torch.equal(s1, s2) and torch.equal(f1, f2)
    assert all(torch.equal(a, b) and torch.equal(c, d) for (a, c), (b, d) in zip(r1, r2))
    assert not fn.graphs
    with pytest.raises(ValueError):
        sumcheck_prove(CFG, table[:, :3], device=CPU)


def _ipa_instance(n, B, seed):
    rng = random.Random(seed)
    gens = [tck.JUBJUB.rand_point(rng) for _ in range(n)]
    scalars = [[rng.randrange(tck.JUBJUB.scalar.p) for _ in range(n)] for _ in range(B)]
    scalars[0][0] = 0
    return gens, scalars


def _rounds_of(proof, b):
    return [(tuple(proof["rounds"][j][0][b]), tuple(proof["rounds"][j][1][b])) for j in range(len(proof["rounds"]))]


def test_ipa_fold_matches_jax_host_and_both_verifiers():
    J, T = jck.JUBJUB, tck.JUBJUB
    B, n = 2, 8
    gens, scalars = _ipa_instance(n, B, 6)
    proof = ipa_fold_prove(T, CFG, gens, scalars, device=CPU)
    hosts = j_ipa_host(J, JCFG, gens, scalars)
    assert ipa_fold_prove_host(T, CFG, gens, scalars) == hosts
    p_s = T.scalar.p
    for b in range(B):
        assert tuple(proof["commitment"][b]) == hosts[b]["commitment"]
        assert len(proof["rounds"]) == 3
        for j, (L, R) in enumerate(hosts[b]["rounds"]):
            assert tuple(proof["rounds"][j][0][b]) == L, (b, j)
            assert tuple(proof["rounds"][j][1][b]) == R, (b, j)
        assert proof["a_star"][b] == hosts[b]["a_star"]
        rounds_b, C_b, a_b = _rounds_of(proof, b), proof["commitment"][b], proof["a_star"][b]
        # the challenges are the host transcript's, mod the scalar field
        sp = PoseidonSponge(CFG)
        sp.absorb_elements(list(C_b))
        for j, (L, R) in enumerate(rounds_b):
            sp.absorb_elements(list(L) + list(R))
            assert proof["challenges"][b, j] == sp.squeeze_native_field_elements(1)[0] % p_s
        for verify, curve, cfg in ((j_ipa_verify, J, JCFG), (ipa_fold_verify_host, T, CFG)):
            assert verify(curve, cfg, gens, C_b, rounds_b, a_b)
    # the forgeries of the JAX package's test: a folded scalar, a round
    # message and a commitment, each altered
    rounds_0, C_0, a_0 = _rounds_of(proof, 0), proof["commitment"][0], proof["a_star"][0]
    bad_round = [list(r) for r in rounds_0]
    bad_round[0][0] = J.add_host(bad_round[0][0], J.generator)
    bad_round = [tuple(r) for r in bad_round]
    C_bad = J.add_host(tuple(C_0), J.generator)
    for verify, curve, cfg in ((j_ipa_verify, J, JCFG), (ipa_fold_verify_host, T, CFG)):
        assert not verify(curve, cfg, gens, C_0, rounds_0, (a_0 + 1) % p_s)
        assert not verify(curve, cfg, gens, C_0, bad_round, a_0)
        assert not verify(curve, cfg, gens, C_bad, rounds_0, a_0)


def test_ipa_fold_single_round_matches_jax_prover():
    """n = 2, one round: the port's prover against the JAX package's RNS
    prover, as the JAX package's own non-slow test runs it."""
    gens, scalars = _ipa_instance(2, 1, 7)
    want = j_ipa_prove(jck.JUBJUB, JCFG, gens, scalars)
    got = ipa_fold_prove(tck.JUBJUB, CFG, gens, scalars, device=CPU)
    assert tuple(got["commitment"][0]) == tuple(int(v) for v in want["commitment"][0])
    assert _rounds_of(got, 0) == [(tuple(int(v) for v in want["rounds"][0][0][0]),
                                   tuple(int(v) for v in want["rounds"][0][1][0]))]
    assert got["a_star"] == [int(v) for v in want["a_star"]]
    assert [int(v) for v in got["challenges"][0]] == [int(v) for v in want["challenges"][0]]
    assert j_ipa_verify(jck.JUBJUB, JCFG, gens, got["commitment"][0], _rounds_of(got, 0), got["a_star"][0])


def test_ipa_zero_challenge_raises(monkeypatch):
    gens, scalars = _ipa_instance(2, 2, 8)
    monkeypatch.setattr(FiatShamir, "challenge", lambda self: torch.zeros((2, FR.num_words), dtype=torch.int32))
    with pytest.raises(ValueError, match="no inverse"):
        ipa_fold_prove(tck.JUBJUB, CFG, gens, scalars, device=CPU)


def test_ipa_base_field_not_the_sponge_field_raises():
    curve = tck.ED_ON_BLS12_377  # base field BLS12-377 Fr, not BLS12-381 Fr
    gens = [curve.generator, curve.double_host(curve.generator)]
    with pytest.raises(ValueError, match="sponge's field"):
        ipa_fold_prove(curve, CFG, gens, [[1, 2]], device=CPU)
