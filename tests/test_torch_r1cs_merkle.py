"""The port's Merkle path gadgets against the JAX package's, on the CPU.

Every circuit is built by one helper, once in each package, from the same
native path: the port's device trees (on the CPU) give the paths, and JAX's
``Path`` is rebuilt from the same fields.  The circuits must have equal
constraint and witness counts, assignments, COO matrices and outputs, and
the outputs must equal the native tree's.  ``PathVar`` (scalar and batched,
with ``update_leaf`` / ``update_and_check``), ``BytePathVar`` (scalar and
batched, SHA-256 trees of 4 and 8 leaves, the shapes of
tests/test_r1cs_byte_merkle.py) and ``PointPathVar`` (a 4-leaf Pedersen
tree over JubJub, tests/test_merkle_pedersen.py's configuration); each with
a wrong root or a wrong leaf."""

import functools
import random

import numpy as np
import pytest
import torch

from crypto_primitives_tpu_torch.models.crh import PedersenCRH, PedersenTwoToOneCRH, Window
from crypto_primitives_tpu_torch.models.merkle_tree.device import (
    pedersen_device_tree,
    poseidon_device_tree,
    sha256_device_tree,
)
from crypto_primitives_tpu_torch.ops.curves_known import JUBJUB
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR
from crypto_primitives_tpu_torch.r1cs import FpVar
from crypto_primitives_tpu_torch.r1cs.batch import BatchConstraintSystem
from crypto_primitives_tpu_torch.r1cs.gadgets.merkle import BytePathVar, PathVar
from crypto_primitives_tpu_torch.r1cs.gadgets.poseidon import PoseidonCRHGadget, PoseidonTwoToOneCRHGadget
from crypto_primitives_tpu_torch.r1cs.gadgets.sha256 import DigestVar, Sha256CRHGadget, Sha256TwoToOneCRHGadget
from crypto_primitives_tpu_torch.r1cs.vars import bytes_to_uint8s

from test_torch_r1cs import JAX, PORT, assert_same_circuit, fr, mod, poseidon_cfg

torch.set_num_threads(1)

CFG = poseidon_cfg(PORT)
_RNG = random.Random(31)
POSEIDON_LEAVES = [_RNG.randrange(FR.p) for _ in range(16)]
LEAF_WINDOW, TWO_WINDOW = Window(4, 16), Window(4, 256)  # tests/test_merkle_pedersen.py:37-38


def _sha_leaves(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 32), dtype=np.uint8)


POSEIDON_TREE = poseidon_device_tree(FR, CFG, POSEIDON_LEAVES, device="cpu")
SHA_LEAVES = {n: _sha_leaves(n, 40 + n) for n in (4, 8)}
SHA_TREES = {n: sha256_device_tree(SHA_LEAVES[n], device="cpu") for n in (4, 8)}


def jax_path(port_path):
    """JAX's Path from the port's fields (models/merkle_tree/__init__.py:256-266)."""
    return mod(JAX, "models.merkle_tree").Path(port_path.leaf_sibling_hash, list(port_path.auth_path),
                                                port_path.leaf_index)


def _path(pkg, port_path):
    return port_path if pkg == PORT else jax_path(port_path)


# ---- field digests: PathVar -------------------------------------------------------


def poseidon_membership(pkg, path, leaf, root, enforce=True):
    m, r = mod(pkg, "r1cs.gadgets.merkle"), mod(pkg, "r1cs")
    g = mod(pkg, "r1cs.gadgets.poseidon")
    cfg = poseidon_cfg(pkg)
    cs = r.ConstraintSystem(fr(pkg))
    pv = m.PathVar.new_witness(cs, _path(pkg, path))
    ok = pv.verify_membership(g.PoseidonCRHGadget(cfg), g.PoseidonTwoToOneCRHGadget(cfg),
                              r.FpVar.new_input(cs, root), [r.FpVar.new_witness(cs, leaf)])
    if enforce:
        ok.fp.enforce_equal(r.FpVar.constant(cs, 1))
    return cs, [ok.value]


def poseidon_update(pkg, path, old_leaf, new_leaf, old_root, new_root):
    m, r = mod(pkg, "r1cs.gadgets.merkle"), mod(pkg, "r1cs")
    g = mod(pkg, "r1cs.gadgets.poseidon")
    cfg = poseidon_cfg(pkg)
    leaf_g, two_g = g.PoseidonCRHGadget(cfg), g.PoseidonTwoToOneCRHGadget(cfg)
    cs = r.ConstraintSystem(fr(pkg))
    pv = m.PathVar.new_witness(cs, _path(pkg, path))
    old = r.FpVar.new_input(cs, old_root)
    updated = pv.update_leaf(leaf_g, two_g, old, [r.FpVar.new_witness(cs, old_leaf)],
                             [r.FpVar.new_witness(cs, new_leaf)])
    ok = pv.update_and_check(leaf_g, two_g, old, r.FpVar.new_input(cs, new_root),
                             [r.FpVar.new_witness(cs, old_leaf)], [r.FpVar.new_witness(cs, new_leaf)])
    return cs, [updated.value, ok.value]


@pytest.mark.parametrize("index", [0, 3, 7, 14])
def test_path_var_matches_jax_and_the_native_root(index):
    root = POSEIDON_TREE.root()
    path = POSEIDON_TREE.generate_proof(index)
    _, outs, first = assert_same_circuit(lambda pkg: poseidon_membership(pkg, path, POSEIDON_LEAVES[index], root))
    assert outs == [True] and first is None


@pytest.mark.parametrize("wrong", ["root", "leaf"])
def test_path_var_wrong_root_or_leaf_is_false_and_fails_once_enforced(wrong):
    root, index = POSEIDON_TREE.root(), 2
    path = POSEIDON_TREE.generate_proof(index)
    leaf = POSEIDON_LEAVES[index]
    if wrong == "root":
        root = (root + 1) % FR.p
    else:
        leaf = POSEIDON_LEAVES[index + 1]
    # Ok(false): satisfied while not enforced
    _, outs, first = assert_same_circuit(lambda pkg: poseidon_membership(pkg, path, leaf, root, enforce=False))
    assert outs == [False] and first is None
    cs, outs, first = assert_same_circuit(lambda pkg: poseidon_membership(pkg, path, leaf, root))
    assert outs == [False] and first == cs.num_constraints - 1


def test_path_var_update_and_check_matches_jax():
    index, new_leaf = 5, random.Random(32).randrange(FR.p)
    leaves = list(POSEIDON_LEAVES)
    leaves[index] = new_leaf
    new_root = poseidon_device_tree(FR, CFG, leaves, device="cpu").root()
    path = POSEIDON_TREE.generate_proof(index)
    build = lambda pkg: poseidon_update(pkg, path, POSEIDON_LEAVES[index], new_leaf,  # noqa: E731
                                        POSEIDON_TREE.root(), new_root)
    _, outs, first = assert_same_circuit(build)
    assert outs == [new_root, True] and first is None


def _batched_poseidon(indexes, roots, leaves):
    bcs = BatchConstraintSystem(FR, len(indexes), device="cpu")
    pv = PathVar.new_witness_batch(bcs, [POSEIDON_TREE.generate_proof(i) for i in indexes])
    ok = pv.verify_membership(PoseidonCRHGadget(CFG), PoseidonTwoToOneCRHGadget(CFG),
                              FpVar.new_input(bcs, torch.from_numpy(FR.pack(roots))),
                              [FpVar.new_witness(bcs, torch.from_numpy(FR.pack(leaves)))])
    return bcs, ok


def test_batched_path_var_matches_scalar_tier_and_jax():
    """N = 6 paths of a 16-leaf tree (tests/test_r1cs_batch.py:95-140): one
    instance against a wrong root, another with a wrong leaf; Ok(false) keeps
    the system satisfied, and with ok enforced exactly those two fail, at
    the constraint the scalar tiers of both packages name."""
    indexes = [0, 3, 7, 8, 12, 15]
    n, bad_root, bad_leaf = len(indexes), 2, 4
    roots = [POSEIDON_TREE.root()] * n
    roots[bad_root] = (roots[bad_root] + 1) % FR.p
    leaves = [POSEIDON_LEAVES[i] for i in indexes]
    leaves[bad_leaf] = POSEIDON_LEAVES[0]
    bcs, ok = _batched_poseidon(indexes, roots, leaves)
    assert ok.value.tolist() == [i not in (bad_root, bad_leaf) for i in range(n)]
    assert bcs.satisfied_per_instance().tolist() == [True] * n
    ok.fp.enforce_equal(FpVar.constant(bcs, 1))
    want = [i not in (bad_root, bad_leaf) for i in range(n)]
    assert bcs.satisfied_per_instance().tolist() == want
    assert bcs.satisfied_per_instance(chunk=4).tolist() == want
    first = bcs.which_unsatisfied()
    for i in range(n):
        path = POSEIDON_TREE.generate_proof(indexes[i])
        cs, outs = poseidon_membership(PORT, path, leaves[i], roots[i])
        assert (bcs.num_constraints, bcs.num_witness, bcs.num_instance) == (
            cs.num_constraints, cs.num_witness, cs.num_instance)
        assert [bcs.value_host(v, i) for v in bcs.assignments] == cs.assignments
        assert outs == [bool(ok.value[i])]
        if i in (0, bad_root):
            jcs, _ = poseidon_membership(JAX, path, leaves[i], roots[i])
            assert jcs.assignments == cs.assignments and jcs.which_unsatisfied() == cs.which_unsatisfied()
        assert int(first[i]) == (-1 if cs.which_unsatisfied() is None else cs.which_unsatisfied())


def test_batched_path_var_refuses_paths_of_unequal_height():
    bcs = BatchConstraintSystem(FR, 2, device="cpu")
    short = poseidon_device_tree(FR, CFG, POSEIDON_LEAVES[:4], device="cpu").generate_proof(1)
    with pytest.raises(ValueError):
        PathVar.new_witness_batch(bcs, [POSEIDON_TREE.generate_proof(1), short])
    with pytest.raises(ValueError):
        BytePathVar.new_witness_batch(bcs, [SHA_TREES[8].generate_proof(1), SHA_TREES[4].generate_proof(1)])


# ---- byte digests: BytePathVar ----------------------------------------------------


def sha256_membership(pkg, path, leaf, root):
    m, r = mod(pkg, "r1cs.gadgets.merkle"), mod(pkg, "r1cs")
    g, v = mod(pkg, "r1cs.gadgets.sha256"), mod(pkg, "r1cs.vars")
    cs = r.ConstraintSystem(fr(pkg))
    pv = m.BytePathVar.new_witness(cs, _path(pkg, path))
    ok = pv.verify_membership(g.Sha256CRHGadget(), g.Sha256TwoToOneCRHGadget(),
                              g.DigestVar(cs, v.bytes_to_uint8s(cs, root, "input")),
                              v.bytes_to_uint8s(cs, leaf, "witness"))
    ok.fp.enforce_equal(r.FpVar.constant(cs, 1))
    return cs, [ok.value]


@functools.lru_cache(maxsize=None)
def byte_circuit(leaves, index, wrong_root):
    """The port's and JAX's circuit of one byte path against the tree's root
    or an all-zero one, checked equal once and shared by the tests below
    (none of them changes it)."""
    tree = SHA_TREES[leaves]
    root = bytes(32) if wrong_root else tree.root()
    path = tree.generate_proof(index)
    return assert_same_circuit(lambda pkg: sha256_membership(pkg, path, SHA_LEAVES[leaves][index].tobytes(), root))


@pytest.mark.parametrize("leaves,index,wrong_root", [(8, 5, False), (4, 2, True)])
def test_byte_path_var_matches_jax(leaves, index, wrong_root):
    """tests/test_r1cs_byte_merkle.py:35-73: the 8-leaf path verifies, a
    4-leaf path against an all-zero root is false and fails once enforced;
    the 8-byte length prefix of the leaf level costs no constraint."""
    cs, outs, first = byte_circuit(leaves, index, wrong_root)
    assert outs == [not wrong_root] and first == (cs.num_constraints - 1 if wrong_root else None)


def test_batched_byte_path_var_matches_scalar_tier_and_jax():
    """tests/test_r1cs_byte_merkle.py:106-158 at N = 4, on the 4-leaf tree:
    instance 2 gets an all-zero root (Ok(false), the system stays satisfied
    under the int64 small-domain check); with ok enforced it alone fails, at
    the constraint the scalar tiers of both packages name, and its column of
    the witness is the scalar tier's."""
    tree, leaves = SHA_TREES[4], SHA_LEAVES[4]
    n, bad = 4, 2
    roots = np.frombuffer(tree.root() * n, dtype=np.uint8).reshape(n, 32).copy()
    roots[bad] = 0
    bcs = BatchConstraintSystem(FR, n, device="cpu")
    pv = BytePathVar.new_witness_batch(bcs, [tree.generate_proof(i) for i in range(n)])
    ok = pv.verify_membership(Sha256CRHGadget(), Sha256TwoToOneCRHGadget(),
                              DigestVar(bcs, bytes_to_uint8s(bcs, roots, "input")),
                              bytes_to_uint8s(bcs, leaves, "witness"))
    assert np.asarray(ok.value).tolist() == [i != bad for i in range(n)]
    assert bcs.satisfied_per_instance().tolist() == [True] * n
    ok.fp.enforce_equal(FpVar.constant(bcs, 1))
    cs, outs, first = byte_circuit(4, bad, True)
    assert (bcs.num_constraints, bcs.num_witness, bcs.num_instance) == (
        cs.num_constraints, cs.num_witness, cs.num_instance)
    assert [bcs.value_host(v, bad) for v in bcs.assignments] == cs.assignments
    assert bcs.which_unsatisfied().tolist() == [-1 if i != bad else first for i in range(n)]


# ---- point digests: PointPathVar --------------------------------------------------


def _pedersen_tree():
    rng = random.Random(77)  # tests/test_merkle_pedersen.py:36
    leaf_params = PedersenCRH(JUBJUB, LEAF_WINDOW).setup(rng)
    two_params = PedersenTwoToOneCRH(JUBJUB, TWO_WINDOW).setup(rng)
    leaves = np.random.default_rng(78).integers(0, 256, (4, 8), dtype=np.uint8)
    tree = pedersen_device_tree(JUBJUB, leaf_params, two_params, LEAF_WINDOW, TWO_WINDOW, leaves, device="cpu")
    return tree, leaves


def point_membership(pkg, path, leaf, root):
    m, r = mod(pkg, "r1cs.gadgets.merkle"), mod(pkg, "r1cs")
    c, g = mod(pkg, "r1cs.gadgets.curve"), mod(pkg, "r1cs.gadgets.pedersen")
    ped, v = mod(pkg, "models.crh.pedersen"), mod(pkg, "r1cs.vars")
    jubjub = mod(pkg, "ops.curves_known").JUBJUB
    rng = random.Random(77)
    leaf_window, two_window = ped.Window(4, 16), ped.Window(4, 256)
    leaf_params = ped.PedersenCRH(jubjub, leaf_window).setup(rng)
    two_params = ped.PedersenTwoToOneCRH(jubjub, two_window).setup(rng)
    cs = r.ConstraintSystem(fr(pkg))
    pv = m.PointPathVar.new_witness(cs, jubjub, _path(pkg, path))
    ok = pv.verify_membership(leaf_params, two_params, g.PedersenCRHGadget(jubjub, leaf_window),
                              g.PedersenTwoToOneCRHGadget(jubjub, two_window),
                              c.TEAffineVar.new_input(cs, jubjub, root), v.bytes_to_uint8s(cs, leaf, "witness"))
    ok.fp.enforce_equal(r.FpVar.constant(cs, 1))
    return cs, [ok.value]


def test_point_path_var_matches_jax():
    """tests/test_merkle_pedersen.py:143-200: one path of a 4-leaf JubJub
    tree verifies and the circuit is satisfied; changing the root input's
    y by one makes it unsatisfied."""
    tree, leaves = _pedersen_tree()
    root, index = tree.root(), 3
    cs, outs, first = assert_same_circuit(lambda pkg: point_membership(pkg, tree.generate_proof(index),
                                                                       leaves[index].tobytes(), root))
    assert outs == [True] and first is None
    y_input = cs._instance_vars[1]  # the root input's x, then its y
    assert cs.assignments[y_input] == root[1]
    cs.assignments[y_input] = (root[1] + 1) % FR.p
    assert not cs.is_satisfied()
