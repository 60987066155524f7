"""The port's SHA-256 (padding, word layout, plain compression) against hashlib
and the JAX package's sha256."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_primitives_tpu.ops.sha256 import sha256 as jax_sha256
from crypto_primitives_tpu_torch.ops import sha256 as tsha
from crypto_primitives_tpu_torch.ops import sha256_kernel

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [0, 32, 55, 56, 64, 80, 119, 120, 128, 200])
def test_padding_edges_match_hashlib_and_jax(n):
    rng = np.random.default_rng(100 + n)
    msgs = rng.integers(0, 256, (3, n), dtype=np.uint8)
    assert tsha.pad_length(n) % 64 == 0 and tsha.pad_length(n) >= n + 9
    got = tsha.sha256(torch.from_numpy(msgs), device="cpu").numpy()
    want = np.asarray(jax_sha256(jnp.asarray(msgs)))
    assert np.array_equal(got, want)
    for row, digest in zip(msgs, got):
        assert bytes(digest) == hashlib.sha256(row.tobytes()).digest()


def test_batch_shape_is_kept():
    rng = np.random.default_rng(7)
    msgs = rng.integers(0, 256, (2, 3, 40), dtype=np.uint8)
    got = tsha.sha256(msgs, device="cpu")
    assert got.shape == (2, 3, 32)
    assert bytes(got[1, 2].numpy()) == hashlib.sha256(msgs[1, 2].tobytes()).digest()


def test_word_layout_is_big_endian():
    data = torch.arange(128, dtype=torch.uint8).reshape(2, 64)
    words = tsha.bytes_to_words(data)
    assert words.shape == (2, 1, 16) and words.dtype == torch.int32
    assert int(words[0, 0, 0]) == 0x00010203
    assert int(words[1, 0, 15]) & 0xFFFFFFFF == 0x7C7D7E7F
    state = torch.tensor([[0x01020304, -1, 0, 0, 0, 0, 0, 0x7F000080]], dtype=torch.int32)
    out = tsha.words_to_bytes(state)
    assert out[0, :8].tolist() == [1, 2, 3, 4, 255, 255, 255, 255]
    assert out[0, 28:].tolist() == [0x7F, 0, 0, 0x80]


def test_plain_compression_chains_blocks():
    """compress_plain over k blocks equals hashlib over the k-block message
    it came from."""
    rng = np.random.default_rng(9)
    n = 3 * 64 - 9  # exactly three blocks once padded
    msgs = rng.integers(0, 256, (4, n), dtype=np.uint8)
    padded = np.concatenate([msgs, np.broadcast_to(tsha.padding(n), (4, 64 * 3 - n))], axis=1)
    state = sha256_kernel.compress_plain(tsha.bytes_to_words(torch.from_numpy(padded)))
    digests = tsha.words_to_bytes(state).numpy()
    for row, digest in zip(msgs, digests):
        assert bytes(digest) == hashlib.sha256(row.tobytes()).digest()


def test_entry_point_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    from crypto_primitives_tpu_torch.errors import DeviceUnavailable

    with pytest.raises(DeviceUnavailable):
        tsha.sha256(np.zeros((1, 4), dtype=np.uint8))


@pytest.mark.parametrize("n", [0, 64, 128])
def test_padding_block_constants_give_the_digest(n):
    """The kernel runs the fixed padding block of an n-byte message
    (n % 64 == 0) from the 64 sums K[r] + W[r] of ``padding_block_kw``,
    without its schedule: the same rounds in Python ints, from the state
    after the message's own blocks, give hashlib's digest."""
    M = 0xFFFFFFFF

    def rotr(x, r):
        return ((x >> r) | (x << (32 - r))) & M

    msg = np.random.default_rng(n).integers(0, 256, (1, n), dtype=np.uint8)
    if n:
        state = [int(v) & M for v in sha256_kernel.compress_plain(tsha.bytes_to_words(torch.from_numpy(msg)))[0]]
    else:
        state = list(sha256_kernel.H0)
    kw = sha256_kernel.padding_block_kw(n)
    assert kw.shape == (64,) and kw.dtype == np.uint32
    a, b, c, d, e, f, g, h = state
    for r in range(64):
        t1 = (h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & M & g)) + int(kw[r])) & M
        t2 = ((rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))) & M
        a, b, c, d, e, f, g, h = (t1 + t2) & M, a, b, c, (d + t1) & M, e, f, g
    out = b"".join(((x + y) & M).to_bytes(4, "big") for x, y in zip(state, (a, b, c, d, e, f, g, h)))
    assert out == hashlib.sha256(msg.tobytes()).digest()


def test_digest_wrapper_on_cpu_is_the_plain_version():
    """``digest`` on a CPU tensor runs ``digest_plain`` and launches nothing;
    a view that is not contiguous is copied by ``sha256`` and refused by
    ``digest`` only on a CUDA tensor."""
    rng = np.random.default_rng(5)
    msgs = torch.from_numpy(rng.integers(0, 256, (6, 80), dtype=np.uint8))
    before = sha256_kernel.launches
    got = sha256_kernel.digest(msgs)
    assert sha256_kernel.launches == before
    assert torch.equal(got, sha256_kernel.digest_plain(msgs))
    cols = msgs[:, ::2]
    assert torch.equal(tsha.sha256(cols, device="cpu"), sha256_kernel.digest_plain(cols.contiguous()))
