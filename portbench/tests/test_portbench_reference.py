"""The plain reference against known values: SHA-256's FIPS 180-4 vectors,
the Poseidon sponge vector pinned in the port's tests, and the batched
float64 permutation against the Python-int one."""

import hashlib
import random

import numpy as np
import pytest
import torch

from portbench.reference import merkle_ref
from portbench.reference.grain import ark_and_mds
from portbench.reference.poseidon_ref import NDIG, Field64, Poseidon64, permute_int

P = 52435875175126190479447740508185965837690552500527637822603658699938581184513
# absorb 0, 1, 2 and squeeze 3 with get_default_poseidon_parameters(BLS12_381_FR, 2, False)
# (tests/test_torch_poseidon.py, PINNED)
PINNED = [
    40442793463571304028337753002242186710310163897048962278675457993207843616876,
    2664374461699898000291153145224099287711224021716202960480903840045233645301,
    50191078828066923662070228256530692951801504043422844038937334196346054068797,
]


@pytest.fixture(scope="module")
def params():
    return ark_and_mds(P, 3, 8, 31, 0)


@pytest.mark.parametrize("msg, digest", [
    (b"", "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    (b"abc", "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad"),
    (b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
     "248d6a61d20638b8e5c026930c3e6039a33ce45964ff2167f6ecedd419db06c1"),
])
def test_sha256_vectors(msg, digest):
    rows = np.frombuffer(msg, dtype=np.uint8).reshape(1, -1)
    assert bytes(merkle_ref.Sha256Scheme._hash_rows(rows)[0]).hex() == digest


def _sponge(permute, absorb, squeeze):
    """The reference's duplex schedule at rate 2 for absorbing three elements
    and squeezing three (src/sponge/poseidon/mod.rs:124-186)."""
    s = [0, absorb[0], absorb[1]]
    s = permute(s)
    s[1] = (s[1] + absorb[2]) % P
    s = permute(s)
    out = [s[1], s[2]]
    s = permute(s)
    return out + [s[1]]


def test_poseidon_pinned_vector(params):
    ark, mds = params
    assert _sponge(lambda s: permute_int(P, 17, 8, 31, ark, mds, s), [0, 1, 2], 3) == PINNED
    f = Field64(P, "cpu")
    perm = Poseidon64(f, 17, 8, 31, ark, mds)

    def batched(s):
        return f.to_ints(perm(f.from_ints(s).unsqueeze(0))[0])

    assert _sponge(batched, [0, 1, 2], 3) == PINNED


def test_float64_permutation_equals_int_permutation(params):
    ark, mds = params
    f = Field64(P, "cpu")
    perm = Poseidon64(f, 17, 8, 31, ark, mds)
    rng = random.Random(3)
    states = [[rng.randrange(P) for _ in range(3)] for _ in range(24)] + [[P - 1] * 3, [0] * 3, [1, P - 1, 2]]
    got = perm(torch.stack([f.from_ints(s) for s in states]))
    assert [f.to_ints(got[i]) for i in range(len(states))] == [permute_int(P, 17, 8, 31, ark, mds, s) for s in states]
    # redundant inputs: digits up to 2^20, values past p
    redundant = torch.randint(0, 1 << 20, (8, 3, NDIG), generator=torch.Generator().manual_seed(1)).double()
    values = [f.to_ints(redundant[i]) for i in range(8)]
    got = perm(redundant)
    assert [f.to_ints(got[i]) for i in range(8)] == [permute_int(P, 17, 8, 31, ark, mds, v) for v in values]


def test_float64_products_stay_exact():
    """The widest inputs a product takes (digits just below 2^20) give digits
    below 2^17.1, and the same value as Python ints."""
    f = Field64(P, "cpu")
    x = torch.full((2, NDIG), float((1 << 20) - 1), dtype=torch.float64)
    x[1, ::2] = 0
    y = f.mul(x, x.flip(0))
    assert float(y.max()) < 2 ** 17.1
    xs = [sum(int(d) << (16 * j) for j, d in enumerate(row.tolist())) for row in x]
    assert f.to_ints(y) == [xs[0] * xs[1] % P] * 2


def test_sha256_tree_by_hand():
    leaves = np.arange(4 * 32, dtype=np.uint8).reshape(4, 32)
    h = [hashlib.sha256(row.tobytes()).digest() for row in leaves]
    pre = (32).to_bytes(8, "little")
    n0 = hashlib.sha256(pre + h[0] + pre + h[1]).digest()
    n1 = hashlib.sha256(pre + h[2] + pre + h[3]).digest()
    root = hashlib.sha256(n0 + n1).digest()
    levels = merkle_ref.build(merkle_ref.Sha256Scheme(), leaves)
    assert bytes(levels[-1][0]) == root
    raw = leaves[[0, 3, 2, 1]].copy()
    assert merkle_ref.verify(merkle_ref.Sha256Scheme(), levels, raw, np.array([0, 3, 1, 2])).tolist() == \
        [True, True, False, False]


def test_poseidon_tree_by_hand(params):
    ark, mds = params
    f = Field64(P, "cpu")
    scheme = merkle_ref.PoseidonScheme(Poseidon64(f, 17, 8, 31, ark, mds), block=3)
    vals = [5, 7, P - 1, 11]

    def H(*xs):
        return permute_int(P, 17, 8, 31, ark, mds, [0, *xs] + [0] * (2 - len(xs)))[1]

    h = [H(v) for v in vals]
    root = H(H(h[0], h[1]), H(h[2], h[3]))
    levels = merkle_ref.build(scheme, f.from_ints(vals))
    assert f.to_ints(levels[-1]) == [root]
    ok = merkle_ref.verify(scheme, levels, f.from_ints([5, 7, 11, 12]), np.array([0, 1, 3, 3]))
    assert ok.tolist() == [True, True, True, False]
