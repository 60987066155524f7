"""The port's ElGamal encryption against crypto_primitives_tpu's.

Parameters, keys and randomness come from ``random.Random`` seeds, the same
on both sides.  The host tier is compared as Python ints; ``encrypt_batch``
(the port's plain PyTorch versions on the CPU) on both of its routes (r pk
windowed below 32 messages, fixed-base from 32 on) against JAX's
``encrypt_batch`` and host ``encrypt`` on JubJub and ed-on-bls12-377, and
against the host on BLS12-381 G1, with the identity as a message and zero
randomness; ``decrypt_batch`` round trips on both curve models.  Tolerance:
exact equality (integer outputs).
"""

import random

import pytest
import torch

from crypto_primitives_tpu.models.encryption import ElGamal as JElGamal
from crypto_primitives_tpu.ops import curves_known as jck
from crypto_primitives_tpu_torch.errors import DeviceUnavailable
from crypto_primitives_tpu_torch.models.encryption import ElGamal
from crypto_primitives_tpu_torch.models.encryption.elgamal import FIXED_BASE_PK_ROWS
from crypto_primitives_tpu_torch.ops import curve_fast
from crypto_primitives_tpu_torch.ops import curves_known as tck

torch.set_num_threads(1)
CPU = "cpu"


def _setup(scheme, seed, n):
    rng = random.Random(seed)
    params = scheme.setup(rng)
    pk, sk = scheme.keygen(params, rng)
    msgs = [scheme.curve.rand_point(rng) for _ in range(n)]
    rs = [scheme.rand_randomness(rng) for _ in range(n)]
    return params, pk, sk, msgs, rs


@pytest.mark.parametrize("name", ["JUBJUB", "ED_ON_BLS12_377", "BLS12_381_G1"])
def test_host_tier_matches_jax(name):
    j, t = JElGamal(getattr(jck, name)), ElGamal(getattr(tck, name))
    jp, jpk, jsk, jm, jr = _setup(j, 3, 2)
    tp, tpk, tsk, tm, tr = _setup(t, 3, 2)
    assert (tp.generator, tpk, tsk, tm, tr) == (jp.generator, jpk, jsk, jm, jr)
    for m, r in zip(tm, tr):
        c = t.encrypt(tp, tpk, m, r)
        assert c == j.encrypt(jp, jpk, m, r)
        assert t.decrypt(tp, tsk, c) == j.decrypt(jp, jsk, c) == m


@pytest.mark.parametrize("name,rows", [("JUBJUB", 3), ("JUBJUB", FIXED_BASE_PK_ROWS), ("ED_ON_BLS12_377", 3)])
def test_batches_match_jax(name, rows, monkeypatch):
    """B = 3 takes the windowed route for r pk, B = 32 the fixed-base one
    (counted on the port's side); ciphertexts equal JAX's encrypt_batch and
    the host encrypt; decrypt_batch equals JAX's and gives the messages."""
    j, t = JElGamal(getattr(jck, name)), ElGamal(getattr(tck, name))
    params, pk, sk, msgs, rs = _setup(t, rows, rows)
    jparams = j.setup(random.Random(rows))
    assert jparams.generator == params.generator
    fixed = []
    fixed_base_mul = curve_fast.fixed_base_mul
    monkeypatch.setattr(curve_fast, "fixed_base_mul", lambda c, pt, *a: fixed.append(pt) or fixed_base_mul(c, pt, *a))
    got = t.encrypt_batch(params, pk, msgs, rs, device=CPU)
    assert fixed == ([params.generator, pk] if rows >= FIXED_BASE_PK_ROWS else [params.generator])
    assert got == j.encrypt_batch(jparams, pk, msgs, rs) == [t.encrypt(params, pk, m, r) for m, r in zip(msgs, rs)]
    dec = t.decrypt_batch(params, sk, got, device=CPU)
    assert dec == j.decrypt_batch(jparams, sk, got) == msgs


def test_g1_batches_against_host():
    """BLS12-381 G1 on both routes (3 and 32 messages), with the identity
    (None) as the first message and zero randomness in the second row (c1 is
    then the identity): encrypt_batch equals the host encrypt, and one
    decrypt_batch over both batches gives the messages back."""
    t = ElGamal(tck.BLS12_381_G1)
    all_ciphers, all_msgs = [], []
    for rows in (3, FIXED_BASE_PK_ROWS):
        params, pk, sk, msgs, rs = _setup(t, 7, rows)
        msgs[0], rs[1] = None, 0
        got = t.encrypt_batch(params, pk, msgs, rs, device=CPU)
        assert got == [t.encrypt(params, pk, m, r) for m, r in zip(msgs, rs)]
        assert got[1][0] is None and got[0][1] is not None
        all_ciphers += got
        all_msgs += msgs
    assert t.decrypt_batch(params, sk, all_ciphers, device=CPU) == all_msgs


def test_batch_entry_points_need_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    t = ElGamal(tck.JUBJUB)
    params, pk, sk, msgs, rs = _setup(t, 1, 2)
    with pytest.raises(DeviceUnavailable):
        t.encrypt_batch(params, pk, msgs, rs)
    with pytest.raises(DeviceUnavailable):
        t.decrypt_batch(params, sk, [(pk, pk)])
