"""The port's Merkle trees against the JAX package's, at 2^8 leaves.

SHA-256 and Poseidon device trees are held against the JAX host MerkleTree
with the same CRHs (and the SHA-256 tree against JAX's sha256_device_tree
too): roots, every auth path, batch and multipath verification, updates.
Inputs are made from a seed with numpy; digests are compared as bytes or ints.
"""

import copy
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_primitives_tpu.models import merkle_tree as jmt
from crypto_primitives_tpu.models.crh import (
    PoseidonCRH as JPoseidonCRH,
    PoseidonTwoToOneCRH as JPoseidonTwoToOneCRH,
    Sha256CRH as JSha256CRH,
    Sha256TwoToOneCRH as JSha256TwoToOneCRH,
)
from crypto_primitives_tpu.models.merkle_tree import device as jdev
from crypto_primitives_tpu.models.sponge import get_default_poseidon_parameters as jparams
from crypto_primitives_tpu.ops import fields_known as jfk
from crypto_primitives_tpu_torch.models import merkle_tree as tmt
from crypto_primitives_tpu_torch.models.crh import (
    PoseidonCRH,
    PoseidonTwoToOneCRH,
    Sha256CRH,
    Sha256TwoToOneCRH,
)
from crypto_primitives_tpu_torch.models.merkle_tree import device as tdev
from crypto_primitives_tpu_torch.models.sponge import get_default_poseidon_parameters as tparams
from crypto_primitives_tpu_torch.ops import fields_known as tfk
from crypto_primitives_tpu_torch.ops.sha256 import sha256 as tsha256

torch.set_num_threads(1)

N = 1 << 8
CPU = "cpu"


def _sha_configs():
    j = jmt.MerkleTreeConfig(JSha256CRH(), JSha256TwoToOneCRH(), jmt.ByteDigestDomain(32),
                             jmt.ByteDigestDomain(32), jmt.ByteDigestConverter(32))
    t = tmt.MerkleTreeConfig(Sha256CRH(), Sha256TwoToOneCRH(), tmt.ByteDigestDomain(32),
                             tmt.ByteDigestDomain(32), tmt.ByteDigestConverter(32))
    return j, t


def _poseidon_configs():
    j = jmt.MerkleTreeConfig(JPoseidonCRH(jfk.BLS12_381_FR), JPoseidonTwoToOneCRH(jfk.BLS12_381_FR),
                             jmt.FieldDigestDomain(jfk.BLS12_381_FR), jmt.FieldDigestDomain(jfk.BLS12_381_FR),
                             jmt.IdentityDigestConverter())
    t = tmt.MerkleTreeConfig(PoseidonCRH(tfk.BLS12_381_FR), PoseidonTwoToOneCRH(tfk.BLS12_381_FR),
                             tmt.FieldDigestDomain(tfk.BLS12_381_FR), tmt.FieldDigestDomain(tfk.BLS12_381_FR),
                             tmt.IdentityDigestConverter())
    return j, t


def _field_values(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % tfk.BLS12_381_FR.p for _ in range(n)]


@pytest.fixture(scope="module")
def sha():
    leaves = np.random.default_rng(5).integers(0, 256, (N, 32), dtype=np.uint8)
    jcfg, tcfg = _sha_configs()
    return {
        "leaves": leaves,
        "jcfg": jcfg,
        "tcfg": tcfg,
        "jhost": jmt.MerkleTree.new(jcfg, None, None, jnp.asarray(leaves)),
        "jdev": jdev.sha256_device_tree(jnp.asarray(leaves)),
        "tdev": tdev.sha256_device_tree(leaves, device=CPU),
    }


@pytest.fixture(scope="module")
def pos():
    """The JAX host tree is built from its host CRHs (blank tree, then every
    leaf updated), which gives the same tree as MerkleTree.new without
    compiling the batched sponge for nine level widths."""
    leaves = _field_values(N, 6)
    jcfg, tcfg = _poseidon_configs()
    jp, tp = jparams(jfk.BLS12_381_FR, 2, False), tparams(tfk.BLS12_381_FR, 2, False)
    jhost = jmt.MerkleTree.blank(jcfg, jp, jp, height=9)
    for i, v in enumerate(leaves):
        jhost.update(i, [v])
    return {
        "leaves": leaves, "jcfg": jcfg, "tcfg": tcfg, "jp": jp, "tp": tp, "jhost": jhost,
        "tdev": tdev.poseidon_device_tree(tfk.BLS12_381_FR, tp, leaves, device=CPU),
    }


# ---------------------------------------------------------------- SHA-256


def test_sha_root_matches_jax(sha):
    assert sha["tdev"].root() == sha["jhost"].root() == sha["jdev"].root()


def test_sha_every_auth_path_matches_jax(sha):
    idx = np.arange(N)
    t_sib, t_auth = sha["tdev"].proof_rows(idx)
    j_sib, j_auth = sha["jdev"].proof_rows(jnp.asarray(idx))
    assert np.array_equal(t_sib.numpy(), np.asarray(j_sib))
    assert np.array_equal(t_auth.numpy(), np.asarray(j_auth))
    for i in range(N):
        tp, jp = sha["tdev"].generate_proof(i), sha["jhost"].generate_proof(i)
        assert (tp.leaf_sibling_hash, tp.auth_path, tp.leaf_index) == (
            jp.leaf_sibling_hash, jp.auth_path, jp.leaf_index)
    # the port's host Path verifies against the port's host config
    assert tp.verify(sha["tcfg"], None, None, sha["tdev"].root(), bytes(sha["leaves"][N - 1]))


def test_sha_root_matches_hashlib(sha):
    conv = (32).to_bytes(8, "little")
    level = [hashlib.sha256(row.tobytes()).digest() for row in sha["leaves"]]
    level = [hashlib.sha256(conv + level[2 * i] + conv + level[2 * i + 1]).digest()
             for i in range(N // 2)]
    while len(level) > 1:
        level = [hashlib.sha256(level[2 * i] + level[2 * i + 1]).digest() for i in range(len(level) // 2)]
    assert sha["tdev"].root() == level[0]


def test_sha_batch_verify_matches_jax(sha):
    t, jhost = sha["tdev"], sha["jhost"]
    idx = np.arange(N)
    t_sib, t_auth = t.proof_rows(idx)
    t_sib[5, 0] ^= 1  # one tampered sibling
    leaf_dig = tsha256(sha["leaves"], device=CPU)
    got = t.verify_rows_batch(t.root_row(), leaf_dig, idx, t_sib, t_auth).numpy()
    assert got.sum() == N - 1 and not got[5]
    # the JAX host Path verify gives the same verdicts on the same rows
    for i in (4, 5, 200):
        path = jmt.Path(bytes(t_sib[i].numpy()), [bytes(r) for r in t_auth[i].numpy()], i)
        assert path.verify(sha["jcfg"], None, None, jhost.root(), bytes(sha["leaves"][i])) == bool(got[i])
    # a wrong root rejects every path
    bad = t.verify_rows_batch(torch.zeros_like(t.root_row()), leaf_dig, idx, t_sib, t_auth)
    assert not bad.any()
    # the host module's batched Path verify agrees
    ok = tmt.verify_paths_batch(sha["tcfg"], None, None, t.root(), sha["leaves"], idx,
                                t_sib.numpy(), t_auth.numpy(), device=CPU).numpy()
    assert np.array_equal(ok, got)


def test_sha_multipath_verify_matches_jax(sha):
    t, jhost = sha["tdev"], sha["jhost"]
    sel = [1, 2, 3, 40, 41, 130, 255]
    t_sib, t_auth = t.proof_rows(sel)
    leaf_dig = t.leaf_digests[sel]
    assert bool(t.multipath_verify_rows(t.root_row(), leaf_dig, sel, t_sib, t_auth))
    jm = jhost.generate_multi_proof(sel)
    assert jm.verify(sha["jcfg"], None, None, jhost.root(), [bytes(sha["leaves"][i]) for i in sel])
    bad_dig = leaf_dig.clone()
    bad_dig[0, 3] ^= 0x40
    assert not bool(t.multipath_verify_rows(t.root_row(), bad_dig, sel, t_sib, t_auth))
    assert not bool(t.multipath_verify_rows(torch.zeros_like(t.root_row()), leaf_dig, sel, t_sib, t_auth))


def test_sha_update_batch_matches_jax(sha):
    t, jhost = copy.deepcopy(sha["tdev"]), copy.deepcopy(sha["jhost"])
    idx = [3, 4, 77, 200]
    new_leaves = np.random.default_rng(8).integers(0, 256, (len(idx), 32), dtype=np.uint8)
    t.update_batch(idx, tsha256(new_leaves, device=CPU))
    for i, leaf in zip(idx, new_leaves):
        jhost.update(i, bytes(leaf))
    assert t.root() == jhost.root()
    levels = torch.cat(t.inner_levels, dim=0).numpy()
    assert np.array_equal(levels, jhost.non_leaf_nodes)
    assert np.array_equal(t.leaf_digests.numpy(), jhost.leaf_nodes)


def test_multipath_prefix_encoding_pinned():
    """The reference's pinned front-incremental encoding for an all-leaves
    proof of an 8-leaf tree (tests/mod.rs:164-181), on the port's host tree,
    field for field equal to JAX's."""
    leaves = np.random.default_rng(12).integers(0, 256, (8, 20), dtype=np.uint8)
    jcfg, tcfg = _sha_configs()
    t = tmt.MerkleTree.new(tcfg, None, None, leaves, device=CPU)
    j = jmt.MerkleTree.new(jcfg, None, None, jnp.asarray(leaves))
    tm, jm = t.generate_multi_proof(range(8)), j.generate_multi_proof(range(8))
    assert tm.auth_paths_prefix_lenghts == [0, 2, 1, 2, 0, 2, 1, 2]
    assert (tm.leaf_siblings_hashes, tm.auth_paths_prefix_lenghts, tm.auth_paths_suffixes,
            tm.leaf_indexes) == (jm.leaf_siblings_hashes, jm.auth_paths_prefix_lenghts,
                                 jm.auth_paths_suffixes, jm.leaf_indexes)
    assert tm.verify(tcfg, None, None, t.root(), [bytes(r) for r in leaves])
    bad = [bytes(r) for r in leaves]
    bad[0] = b"tampered"
    assert not tm.verify(tcfg, None, None, t.root(), bad)
    # check_update refuses a wrong asserted root and leaves the tree alone
    root = t.root()
    assert not t.check_update(2, b"new leaf", b"\x00" * 32)
    assert t.root() == root
    j.update(2, b"new leaf")
    assert t.check_update(2, b"new leaf", j.root()) and t.root() == j.root()


# ---------------------------------------------------------------- Poseidon


def test_poseidon_root_and_every_auth_path_match_jax(pos):
    t, j = pos["tdev"], pos["jhost"]
    assert t.root() == j.root()
    for i in range(N):
        tp, jp = t.generate_proof(i), j.generate_proof(i)
        assert (tp.leaf_sibling_hash, tp.auth_path, tp.leaf_index) == (
            jp.leaf_sibling_hash, jp.auth_path, jp.leaf_index)
    assert tp.verify(pos["tcfg"], pos["tp"], pos["tp"], t.root(), [pos["leaves"][N - 1]])
    assert not tp.verify(pos["tcfg"], pos["tp"], pos["tp"], t.root() ^ 1, [pos["leaves"][N - 1]])


def test_poseidon_batch_and_multipath_verify(pos):
    t = pos["tdev"]
    idx = np.arange(0, N, 4)
    sib, auth = t.proof_rows(idx)
    sib[7, 2] ^= 1  # one tampered sibling
    got = t.verify_rows_batch(t.root_row(), t.leaf_digests[idx], idx, sib, auth)
    assert got.sum() == len(idx) - 1 and not got[7]
    sel = [0, 1, 9, 100, 101, 254]
    m_sib, m_auth = t.proof_rows(sel)
    assert bool(t.multipath_verify_rows(t.root_row(), t.leaf_digests[sel], sel, m_sib, m_auth))


def test_poseidon_update_batch_matches_jax(pos):
    t, j = copy.deepcopy(pos["tdev"]), copy.deepcopy(pos["jhost"])
    idx = [0, 1, 130]
    new_vals = _field_values(len(idx), 13)
    new_dig = PoseidonCRH(tfk.BLS12_381_FR).evaluate_batch(
        pos["tp"], torch.from_numpy(tfk.BLS12_381_FR.pack([[v] for v in new_vals])), device=CPU)
    t.update_batch(idx, new_dig)
    for i, v in zip(idx, new_vals):
        j.update(i, [v])
    assert t.root() == j.root()
    for i in idx:
        assert t.generate_proof(i).auth_path == j.generate_proof(i).auth_path


# ---------------------------------------------------------------- the JAX verify API


SMALL = 16  # leaves of the trees below (the JAX RNS tree runs interpreted here)


@pytest.fixture(scope="module")
def small_trees():
    """One SHA-256 and one Poseidon device tree in each package, on the same
    seeded leaves, each with its proof rows for the same indexes."""
    idx = [0, 5, 11]
    sha_leaves = np.random.default_rng(21).integers(0, 256, (SMALL, 32), dtype=np.uint8)
    jsha = jdev.sha256_device_tree(jnp.asarray(sha_leaves))
    tsha = tdev.sha256_device_tree(sha_leaves, device=CPU)
    vals = _field_values(SMALL, 22)
    jpos = jdev.poseidon_rns_device_tree(jfk.BLS12_381_FR, jparams(jfk.BLS12_381_FR, 2, False), vals)
    tpos = tdev.poseidon_device_tree(tfk.BLS12_381_FR, tparams(tfk.BLS12_381_FR, 2, False), vals, device=CPU)
    out = {}
    for kind, j, t in (("sha", jsha, tsha), ("poseidon", jpos, tpos)):
        jsib, jauth = j.proof_rows(jnp.asarray(idx, dtype=jnp.int32))
        tsib, tauth = t.proof_rows(idx)
        out[kind] = {
            "idx": idx,
            "j": (j, jnp.take(j.leaf_digests, jnp.asarray(idx), axis=0), jsib, jauth),
            "t": (t, t.leaf_digests[idx], tsib, tauth),
        }
    return out


def _canonical_root(kind, pkg, tree):
    """A canonical root row as a comparable value: bytes, or the field int."""
    row = np.asarray(tree.canonical_root_row())
    if kind == "sha":
        return bytes(row.astype(np.uint8))
    spec = jfk.BLS12_381_FR if pkg == "j" else tfk.BLS12_381_FR
    return int(spec.unpack(row))


def _root_rows(kind, pkg, root):
    """(the true root, a wrong root) as canonical rows of package ``pkg``,
    as a root arriving from another process would be packed."""
    if kind == "sha":
        good, bad = np.frombuffer(root, dtype=np.uint8), np.frombuffer(bytes([root[0] ^ 1]) + root[1:], dtype=np.uint8)
        rows = (good.copy(), bad.copy())
    else:
        spec = jfk.BLS12_381_FR if pkg == "j" else tfk.BLS12_381_FR
        rows = tuple(np.asarray(spec.pack([v]))[0] for v in (root, (root + 1) % spec.p))
    return tuple(jnp.asarray(r) if pkg == "j" else torch.from_numpy(r) for r in rows)


@pytest.mark.parametrize("kind", ["sha", "poseidon"])
def test_canonical_root_row_matches_jax(small_trees, kind):
    trees = small_trees[kind]
    jroot = _canonical_root(kind, "j", trees["j"][0])
    assert jroot == _canonical_root(kind, "t", trees["t"][0]) == trees["t"][0].root()


@pytest.mark.parametrize("kind", ["sha", "poseidon"])
def test_verify_rows_batch_root_canonical_matches_jax(small_trees, kind):
    """The JAX call shape, with a true and a wrong canonical root, each with
    root_canonical True; and the tree's own root row with the default."""
    trees = small_trees[kind]
    root = trees["t"][0].root()
    verdicts = {}
    for pkg in ("j", "t"):
        tree, ld, sib, auth = trees[pkg]
        idx = jnp.asarray(trees["idx"], dtype=jnp.int32) if pkg == "j" else trees["idx"]
        good, bad = _root_rows(kind, pkg, root)
        verdicts[pkg] = [
            np.asarray(tree.verify_rows_batch(r, ld, idx, sib, auth, root_canonical=True)).tolist()
            for r in (good, bad)
        ] + [np.asarray(tree.verify_rows_batch(tree.root_row(), ld, idx, sib, auth)).tolist()]
    assert verdicts["t"] == verdicts["j"] == [[True] * 3, [False] * 3, [True] * 3]


@pytest.mark.parametrize("kind", ["sha", "poseidon"])
def test_verify_rows_batch_refuses_a_root_of_the_wrong_shape(small_trees, kind):
    for pkg in ("j", "t"):
        tree, ld, sib, auth = small_trees[kind][pkg]
        idx = jnp.asarray(small_trees[kind]["idx"], dtype=jnp.int32) if pkg == "j" else small_trees[kind]["idx"]
        wrong = tree.root_row()[None]  # (1, D) where one row (D,) is expected
        with pytest.raises(ValueError, match="canonical_root_row"):
            tree.verify_rows_batch(wrong, ld, idx, sib, auth, root_canonical=True)


@pytest.mark.parametrize("index", [8, 100, -1, -8])
@pytest.mark.parametrize("method", ["update", "check_update"])
def test_update_out_of_range_raises_index_error(method, index):
    """The port refuses a leaf index outside [0, n), negative ones included,
    and leaves the tree alone.  (The JAX package asserts index < n, which lets
    a negative index through and vanishes under python -O; the reference's
    usize index cannot be negative.)"""
    leaves = np.random.default_rng(23).integers(0, 256, (8, 20), dtype=np.uint8)
    _, tcfg = _sha_configs()
    t = tmt.MerkleTree.new(tcfg, None, None, leaves, device=CPU)
    root = t.root()
    args = (index, b"new leaf") + ((root,) if method == "check_update" else ())
    with pytest.raises(IndexError, match="out of range"):
        getattr(t, method)(*args)
    assert t.root() == root
