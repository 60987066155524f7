"""The port's BLAKE2s, Blake2s PRF and Blake2s commitment against hashlib and
the JAX package, host and batch tiers, on the CPU."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_primitives_tpu.models.commitment.blake2s import Blake2sCommitment as JaxCommitment
from crypto_primitives_tpu.models.prf.blake2s import Blake2sPRF as JaxPRF
from crypto_primitives_tpu.models.prf.blake2s import Blake2sWithParameterBlock as JaxParameterBlock
from crypto_primitives_tpu.ops.blake2s import blake2s as jax_blake2s
from crypto_primitives_tpu_torch.errors import DeviceUnavailable
from crypto_primitives_tpu_torch.models.commitment import Blake2sCommitment
from crypto_primitives_tpu_torch.models.prf import Blake2sPRF, Blake2sWithParameterBlock
from crypto_primitives_tpu_torch.ops.blake2s import blake2s, blake2s_host

torch.set_num_threads(1)

KEY32 = bytes(range(100, 132))


def _rows(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_every_length_to_129_matches_hashlib():
    """Lengths 0-129 (every padding and block edge of one and two blocks
    and the third's first byte), unkeyed and keyed."""
    for n in range(130):
        msgs = _rows(n, (2, n))
        for key in (b"", b"k3y"):
            got = blake2s(msgs, key=key, device="cpu").numpy()
            for row, digest in zip(msgs, got):
                assert bytes(digest) == hashlib.blake2s(row.tobytes(), key=key).digest(), (n, key)


@pytest.mark.parametrize(
    "n, digest_size, key, salt, person",
    [
        (0, 32, b"", b"", b""),
        (0, 32, KEY32, b"", b""),  # keyed empty message: the counter stays at 64
        (1, 16, b"", b"", b""),
        (63, 32, b"abc", b"salt", b""),
        (64, 32, b"", b"", b"persona!"),
        (65, 20, KEY32, b"saltsalt", b"person"),
        (128, 32, b"", b"s", b"p"),
        (129, 1, b"key", b"", b""),
    ],
)
def test_matches_jax_and_hashlib(n, digest_size, key, salt, person):
    msgs = _rows(1000 + n, (3, n))
    got = blake2s(torch.from_numpy(msgs), digest_size, key, salt, person, device="cpu").numpy()
    want = np.asarray(jax_blake2s(jnp.asarray(msgs), digest_size, key, salt, person))
    assert got.shape == (3, digest_size) and np.array_equal(got, want)
    for row, digest in zip(msgs, got):
        assert bytes(digest) == blake2s_host(row.tobytes(), digest_size, key, salt, person)


def test_leading_axes_are_kept_and_parameters_checked():
    msgs = _rows(5, (2, 3, 40))
    got = blake2s(msgs, device="cpu")
    assert got.shape == (2, 3, 32)
    assert bytes(got[1, 2].numpy()) == hashlib.blake2s(msgs[1, 2].tobytes()).digest()
    for kwargs in ({"digest_size": 0}, {"digest_size": 33}, {"key": bytes(33)}, {"salt": bytes(9)},
                   {"person": bytes(9)}):
        with pytest.raises(ValueError):
            blake2s(msgs, device="cpu", **kwargs)


def test_prf_host_and_batch_match_jax():
    seeds, inputs = _rows(11, (6, 32)), _rows(12, (6, 32))
    got = Blake2sPRF.evaluate_batch(seeds, inputs, device="cpu").numpy()
    want = np.asarray(JaxPRF.evaluate_batch(jnp.asarray(seeds), jnp.asarray(inputs)))
    assert np.array_equal(got, want)
    for s, i, digest in zip(seeds, inputs, got):
        assert Blake2sPRF.evaluate(s.tobytes(), i.tobytes()) == JaxPRF.evaluate(s.tobytes(), i.tobytes())
        assert Blake2sPRF.evaluate(s.tobytes(), i.tobytes()) == bytes(digest)
    with pytest.raises(ValueError):
        Blake2sPRF.evaluate(bytes(31), bytes(32))


def test_parameter_block_prf_matches_jax():
    prf = Blake2sWithParameterBlock(salt=b"saltsalt", personalization=b"personal")
    jprf = JaxParameterBlock(salt=b"saltsalt", personalization=b"personal")
    inputs = _rows(13, (4, 32))
    got = prf.evaluate_batch(torch.from_numpy(inputs), device="cpu").numpy()
    assert np.array_equal(got, np.asarray(jprf.evaluate_batch(jnp.asarray(inputs))))
    for row, digest in zip(inputs, got):
        assert prf.evaluate(row.tobytes()) == jprf.evaluate(row.tobytes()) == bytes(digest)


def test_commitment_host_and_batch_match_jax():
    inputs, randomness = _rows(14, (5, 128)), _rows(15, (5, 32))
    com, jcom = Blake2sCommitment(), JaxCommitment()
    got = com.commit_batch(None, inputs, randomness, device="cpu").numpy()
    assert np.array_equal(got, np.asarray(jcom.commit_batch(None, jnp.asarray(inputs), jnp.asarray(randomness))))
    for m, r, digest in zip(inputs, randomness, got):
        assert com.commit(None, m.tobytes(), r.tobytes()) == jcom.commit(None, m.tobytes(), r.tobytes())
        assert com.commit(None, m.tobytes(), r.tobytes()) == bytes(digest)
    with pytest.raises(ValueError):
        com.commit(None, b"m", bytes(31))


def test_batch_entry_points_need_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    msgs = _rows(16, (2, 32))
    for call in (
        lambda: blake2s(msgs),
        lambda: Blake2sPRF.evaluate_batch(msgs, msgs),
        lambda: Blake2sWithParameterBlock().evaluate_batch(msgs),
        lambda: Blake2sCommitment().commit_batch(None, msgs, msgs),
    ):
        with pytest.raises(DeviceUnavailable):
            call()
