"""The port's Pedersen CRH, two-to-one CRH, commitment and Pedersen Merkle
tree against the JAX package's, on the same parameters.

Parameters come from one ``random.Random`` seed on both sides (and are also
carried across with ``interop``); inputs are made from a seed with numpy.
Host results are compared as Python ints; batched results (the port's plain
PyTorch versions on the CPU) word for word after ``interop.words_from_limbs``
or as affine points.  The device tree is held against a JAX host
``MerkleTree`` with ``PointDigestDomain``, built by the JAX host tier (blank
tree and leaf updates; JAX's batched build compiles for minutes on the CPU).
Tolerance: exact equality throughout.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_primitives_tpu.models import merkle_tree as jmt
from crypto_primitives_tpu.models.commitment import PedersenCommitment as JCommitment
from crypto_primitives_tpu.models.crh.pedersen import PedersenCRH as JCRH
from crypto_primitives_tpu.models.crh.pedersen import PedersenTwoToOneCRH as JTwo
from crypto_primitives_tpu.models.crh.pedersen import Window as JWindow
from crypto_primitives_tpu.ops import curves_known as jck
from crypto_primitives_tpu_torch import interop
from crypto_primitives_tpu_torch.models import merkle_tree as tmt
from crypto_primitives_tpu_torch.models.commitment import PedersenCommitment
from crypto_primitives_tpu_torch.models.crh import PedersenCRH, PedersenTwoToOneCRH, Window
from crypto_primitives_tpu_torch.models.merkle_tree.device import pedersen_device_tree
from crypto_primitives_tpu_torch.ops import curves_known as tck

torch.set_num_threads(1)
CPU = "cpu"


def _inputs(rows, nbytes, seed):
    return np.random.default_rng(seed).integers(0, 256, (rows, nbytes), dtype=np.uint8)


@pytest.mark.parametrize("name", ["JUBJUB", "PALLAS"])
def test_crh_host_and_setup_match_jax(name):
    j, t = getattr(jck, name), getattr(tck, name)
    jcrh, tcrh = JCRH(j, JWindow(8, 6)), PedersenCRH(t, Window(8, 6))
    jp, tp = jcrh.setup(random.Random(3)), tcrh.setup(random.Random(3))
    assert tp.generators == jp.generators
    carried = interop.pedersen_parameters(t, jp.generators)
    for data in (b"", b"\x01", bytes(range(6))):
        want = jcrh.evaluate(jp, data)
        assert tcrh.evaluate(tp, data) == want
        assert tcrh.evaluate(carried, data) == want
    with pytest.raises(ValueError):
        tcrh.evaluate(tp, bytes(7))


def test_crh_batch_matches_jax_batch():
    j, t = jck.JUBJUB, tck.JUBJUB
    jcrh, tcrh = JCRH(j, JWindow(6, 8)), PedersenCRH(t, Window(6, 8))
    jp = jcrh.setup(random.Random(4))
    tp = interop.pedersen_parameters(t, jp.generators)
    data = _inputs(5, 6, 1)
    data[0] = 0
    jout = np.asarray(jcrh.evaluate_batch(jp, jnp.asarray(data)))
    tout = tcrh.evaluate_batch(tp, data, device=CPU)
    assert np.array_equal(interop.words_from_limbs(jout), tout.numpy())
    # fewer bytes than the window holds are zero-padded, as on the host
    short = tcrh.evaluate_batch(tp, data[:, :4], device=CPU)
    assert [tuple(int(v) for v in r) for r in t.base.unpack(short)] == \
        [jcrh.evaluate(jp, bytes(r)) for r in data[:, :4]]
    with pytest.raises(ValueError):
        tcrh.evaluate_batch(tp, _inputs(2, 7, 2), device=CPU)


@pytest.mark.parametrize("name", ["JUBJUB", "BLS12_381_G1"])
def test_two_to_one_matches_jax(name):
    j, t = getattr(jck, name), getattr(tck, name)
    jtwo, ttwo = JTwo(j, JWindow(4, 2 * 8 * 2 * j.base.bigint_bytes // 4)), \
        PedersenTwoToOneCRH(t, Window(4, 2 * 8 * 2 * t.base.bigint_bytes // 4))
    jp = jtwo.setup(random.Random(5))
    tp = interop.pedersen_parameters(t, jp.generators)
    left, right = _inputs(3, 4, 6), _inputs(3, 4, 7)
    for lv, rv in zip(left, right):
        assert ttwo.evaluate(tp, bytes(lv), bytes(rv)) == jtwo.evaluate(jp, bytes(lv), bytes(rv))
    with pytest.raises(ValueError):
        ttwo.evaluate(tp, b"ab", b"a")
    lp = [t.rand_point(random.Random(i)) for i in range(2)]
    rp = [t.rand_point(random.Random(10 + i)) for i in range(2)]
    want = [jtwo.compress(jp, a, b) for a, b in zip(lp, rp)]
    assert [ttwo.compress(tp, a, b) for a, b in zip(lp, rp)] == want
    if name == "JUBJUB":  # batched compress of affine digest rows (TE digests carry no flags)
        aff = lambda pts: torch.from_numpy(t.base.pack([[x, y] for x, y in pts]))
        got = ttwo.compress_batch(tp, aff(lp), aff(rp), device=CPU)
        assert [tuple(int(v) for v in r) for r in t.base.unpack(got)] == want


@pytest.mark.parametrize("name", ["JUBJUB", "PALLAS"])
def test_commitment_matches_jax(name):
    j, t = getattr(jck, name), getattr(tck, name)
    jcom, tcom = JCommitment(j, JWindow(8, 4)), PedersenCommitment(t, Window(8, 4))
    jp, tp = jcom.setup(random.Random(8)), tcom.setup(random.Random(8))
    assert tp.randomness_generator == jp.randomness_generator and tp.generators == jp.generators
    carried = interop.commitment_parameters(t, jp.randomness_generator, jp.generators)
    rng = random.Random(9)
    scalars = [tcom.rand_randomness(rng) for _ in range(3)] + [0, t.scalar.p - 1]
    assert scalars[:3] == [jcom.rand_randomness(r) for r in [random.Random(9)] for _ in range(3)]
    bits = tcom.randomness_to_bits(scalars)
    assert np.array_equal(bits, jcom.randomness_to_bits(scalars))
    data = _inputs(len(scalars), 4, 10)
    want = [jcom.commit(jp, bytes(d), r) for d, r in zip(data, scalars)]
    assert [tcom.commit(tp, bytes(d), r) for d, r in zip(data, scalars)] == want
    got = tcom.commit_batch(carried, data, bits, device=CPU)
    assert [tuple(int(v) for v in r) for r in t.base.unpack(got)] == want
    if name == "JUBJUB":
        jout = np.asarray(jcom.commit_batch(jp, jnp.asarray(data), jnp.asarray(bits)))
        assert np.array_equal(interop.words_from_limbs(jout), got.numpy())


def test_pedersen_device_tree_matches_jax_host_tree():
    """tests/test_merkle_pedersen.py's configuration: JubJub, leaf window
    4 x 16 on 8-byte leaves, two-to-one window 4 x 256; 2^5 leaves."""
    n = 1 << 5
    j, t = jck.JUBJUB, tck.JUBJUB
    jleaf, jtwo = JCRH(j, JWindow(4, 16)), JTwo(j, JWindow(4, 256))
    rng = random.Random(77)
    jlp, jtp = jleaf.setup(rng), jtwo.setup(rng)
    jcfg = jmt.MerkleTreeConfig(jleaf, jtwo, jmt.PointDigestDomain(j), jmt.PointDigestDomain(j),
                                jmt.PointToBytesDigestConverter(j))
    leaves = _inputs(n, 8, 11)
    jtree = jmt.MerkleTree.blank(jcfg, jlp, jtp, 6)
    for i in range(n):
        jtree.update(i, bytes(leaves[i]))

    lp, tp = interop.pedersen_parameters(t, jlp.generators), interop.pedersen_parameters(t, jtp.generators)
    tree = pedersen_device_tree(t, lp, tp, Window(4, 16), Window(4, 256), leaves, device=CPU)
    root = tree.root()
    assert root == jtree.root()
    tcfg = tmt.MerkleTreeConfig(PedersenCRH(t, Window(4, 16)), PedersenTwoToOneCRH(t, Window(4, 256)),
                                tmt.PointDigestDomain(t), tmt.PointDigestDomain(t),
                                tmt.PointToBytesDigestConverter(t))
    bad = (root[0], (root[1] + 1) % t.base.p)
    for i in range(n):
        proof = tree.generate_proof(i)
        jproof = jtree.generate_proof(i)
        assert proof.leaf_sibling_hash == jproof.leaf_sibling_hash
        assert proof.auth_path == jproof.auth_path
        assert jproof.verify(jcfg, jlp, jtp, root, bytes(leaves[i]))
        assert proof.verify(tcfg, lp, tp, root, bytes(leaves[i]))
        assert not jproof.verify(jcfg, jlp, jtp, bad, bytes(leaves[i]))
        assert not proof.verify(tcfg, lp, tp, bad, bytes(leaves[i]))
    # batched verification on the device tree, and a wrong root
    idx = torch.arange(n)
    leaf_sib, auth = tree.proof_rows(idx)
    assert bool(tree.verify_rows_batch(tree.root_row(), tree.leaf_digests, idx, leaf_sib, auth).all())
    wrong = tree.root_row().clone()
    wrong[0] ^= 1
    assert not bool(tree.verify_rows_batch(wrong, tree.leaf_digests[:2], idx[:2], leaf_sib[:2], auth[:2]).any())
