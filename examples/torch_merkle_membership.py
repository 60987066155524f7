"""Merkle trees on the PyTorch port: host tier, device tier, and the
membership gadget.

The twin of ``merkle_membership.py`` (the reference's ``merkle_tree``
module, src/merkle_tree/mod.rs and constraints.rs): build a SHA-256 tree,
prove and verify membership, update a leaf, then prove membership in zero
knowledge by synthesizing the Poseidon ``PathVar`` circuit and checking it
on the device.  The device tree (``sha256_device_tree``) hashes each level
with one launch of the ``sha256_compress`` kernel; its root and proofs equal
the host tree's.

Run: python examples/torch_merkle_membership.py [--device cpu]
"""

import argparse
import os
import random
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.models.crh.poseidon import PoseidonCRH, PoseidonTwoToOneCRH
from crypto_primitives_tpu_torch.models.crh.sha256 import Sha256CRH, Sha256TwoToOneCRH
from crypto_primitives_tpu_torch.models.merkle_tree import (
    ByteDigestConverter,
    ByteDigestDomain,
    FieldDigestDomain,
    IdentityDigestConverter,
    MerkleTree,
    MerkleTreeConfig,
)
from crypto_primitives_tpu_torch.models.merkle_tree.device import sha256_device_tree
from crypto_primitives_tpu_torch.models.sponge import get_default_poseidon_parameters
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR
from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem
from crypto_primitives_tpu_torch.r1cs.device_check import check_satisfied_device
from crypto_primitives_tpu_torch.r1cs.gadgets.merkle import PathVar
from crypto_primitives_tpu_torch.r1cs.gadgets.poseidon import PoseidonCRHGadget, PoseidonTwoToOneCRHGadget
from crypto_primitives_tpu_torch.r1cs.vars import FpVar


def sha256_host_and_device(device):
    rng = random.Random(7)
    n = 16
    leaves = np.frombuffer(bytes(rng.randrange(256) for _ in range(n * 17)), dtype=np.uint8).reshape(n, 17).copy()

    config = MerkleTreeConfig(
        leaf_hash=Sha256CRH(),
        two_to_one_hash=Sha256TwoToOneCRH(),
        leaf_domain=ByteDigestDomain(32),
        inner_domain=ByteDigestDomain(32),
        leaf_inner_converter=ByteDigestConverter(32),
    )
    tree = MerkleTree.new(config, None, None, torch.from_numpy(leaves), device=device)
    proof = tree.generate_proof(5)
    assert proof.verify(config, None, None, tree.root(), bytes(leaves[5]))
    assert not proof.verify(config, None, None, tree.root(), bytes(leaves[6]))
    print(f"sha256 host tree: root {tree.root().hex()[:16]}..., proof verifies")

    dev = sha256_device_tree(leaves, device=device)
    assert dev.root() == tree.root()
    assert dev.generate_proof(5).auth_path == proof.auth_path
    print(f"sha256 device tree on {device}: root and proofs bit-equal to the host tier")

    new_leaf = bytes(rng.randrange(256) for _ in range(17))
    tree.update(5, new_leaf)
    assert tree.generate_proof(5).verify(config, None, None, tree.root(), new_leaf)
    print("leaf 5 updated; fresh proof verifies against the new root")


def poseidon_membership_circuit(device):
    rng = random.Random(11)
    pcfg = get_default_poseidon_parameters(FR, 2, False)
    config = MerkleTreeConfig(
        leaf_hash=PoseidonCRH(FR),
        two_to_one_hash=PoseidonTwoToOneCRH(FR),
        leaf_domain=FieldDigestDomain(FR),
        inner_domain=FieldDigestDomain(FR),
        leaf_inner_converter=IdentityDigestConverter(),
    )
    leaves = [[rng.randrange(FR.p)] for _ in range(8)]
    tree = MerkleTree.new(config, pcfg, pcfg, torch.from_numpy(FR.pack(leaves)), device=device)
    proof = tree.generate_proof(3)

    # the reference's verify_membership circuit (constraints.rs:96-140)
    cs = ConstraintSystem(FR)
    pv = PathVar.new_witness(cs, proof)
    root_var = FpVar.new_input(cs, tree.root())
    leaf_vars = [FpVar.new_witness(cs, v) for v in leaves[3]]
    ok = pv.verify_membership(PoseidonCRHGadget(pcfg), PoseidonTwoToOneCRHGadget(pcfg), root_var, leaf_vars)
    ok.fp.enforce_equal(FpVar.constant(cs, 1))
    assert cs.is_satisfied()  # exact python-int evaluation
    assert check_satisfied_device(cs, device=device)  # every constraint at once on the device
    print(f"poseidon membership circuit: {cs.num_constraints} constraints, satisfied on the host and on {device}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Merkle trees and the membership gadget on the PyTorch port.")
    ap.add_argument("--device", default=None, help="the device to run on (default: cuda)")
    device = resolve_device(ap.parse_args().device)
    sha256_host_and_device(device)
    poseidon_membership_circuit(device)
    print(f"{os.path.basename(__file__)}: {time.perf_counter() - T0:.2f} s on {device}")
