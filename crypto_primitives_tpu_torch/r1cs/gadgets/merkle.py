"""Merkle path verification gadgets.

Twin of ``crypto_primitives_tpu/r1cs/gadgets/merkle.py``, itself the twin of
the reference's src/merkle_tree/constraints.rs: `PathVar{path (position
bits), auth_path, leaf_sibling, leaf_is_right_child}` (:85-94);
`calculate_root` folds CondSelect + compress bottom-up (:182-223);
`verify_membership` = calculate_root().is_eq(root) (:228-237); `update_leaf`
/ `update_and_check` for in-circuit updates (:239-272).

Three configurations: field digests (Poseidon leaf + two-to-one, identity
digest converter: :class:`PathVar`), byte digests (SHA-256:
:class:`BytePathVar`) and point digests (Pedersen over a TE curve:
:class:`PointPathVar`).  On a ``BatchConstraintSystem`` the field path's
digests are ``(N, W)`` Montgomery words on ``cs.device`` and its position
bits ``(N,)`` bool tensors there; the byte path's bits and bytes stay host
numpy, as in ``r1cs/batch.py``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem
from crypto_primitives_tpu_torch.r1cs.gadgets.curve import TEAffineVar
from crypto_primitives_tpu_torch.r1cs.gadgets.sha256 import DigestVar
from crypto_primitives_tpu_torch.r1cs.vars import Boolean, FpVar, UInt8


def _height(native_paths) -> int:
    """The common auth-path length of a batch of paths."""
    h = len(native_paths[0].auth_path)
    if any(len(p.auth_path) != h for p in native_paths):
        raise ValueError("every path of a batch must have the same height")
    return h


class BytePathVar:
    """Byte-digest Merkle path variable (SHA-256 config twin).

    The `ConfigGadget` byte instantiation (constraints.rs:40-70 with
    `BytesVarDigestConverter`): digests are `DigestVar`s (32 UInt8s),
    the leaf->inner conversion prepends the constant u64 length prefix
    (the `to_uncompressed_bytes!` layout of a Vec<u8>), and upper levels
    compress raw digests.
    """

    def __init__(self, cs, path, auth_path, leaf_sibling, leaf_is_right_child):
        self.cs = cs
        self.path = path  # Booleans, top-down
        self.auth_path = auth_path  # DigestVars, root->leaf
        self.leaf_sibling = leaf_sibling  # DigestVar
        self.leaf_is_right_child = leaf_is_right_child

    @classmethod
    def new_witness(cls, cs, native_path) -> "BytePathVar":
        pos = native_path.position_list()
        path_bits = [Boolean.new_witness(cs, b) for b in pos[:-1]]
        leaf_is_right = Boolean.new_witness(cs, pos[-1])
        auth = [
            DigestVar(cs, [UInt8.new_witness(cs, b) for b in d])
            for d in native_path.auth_path
        ]
        sib = DigestVar(
            cs, [UInt8.new_witness(cs, b) for b in native_path.leaf_sibling_hash]
        )
        return cls(cs, path_bits, auth, sib, leaf_is_right)

    @classmethod
    def new_witness_batch(cls, cs, native_paths) -> "BytePathVar":
        """Allocate N same-height byte Paths as one vectorized BytePathVar
        on a BatchConstraintSystem: position bits become (N,) numpy bool
        arrays and every digest byte an (N,)-valued UInt8 (the byte-circuit
        plane of r1cs/batch.py); the structure is new_witness's."""
        h = _height(native_paths)
        pos = np.asarray([p.position_list() for p in native_paths], bool)
        path_bits = [
            Boolean.new_witness(cs, pos[:, i]) for i in range(pos.shape[1] - 1)
        ]
        leaf_is_right = Boolean.new_witness(cs, pos[:, -1])

        def digest_var(rows):
            rows = np.asarray(rows, np.uint8)  # (N, 32)
            return DigestVar(
                cs,
                [
                    UInt8.new_witness(cs, rows[:, j])
                    for j in range(rows.shape[1])
                ],
            )

        auth = [
            digest_var([list(p.auth_path[lvl]) for p in native_paths])
            for lvl in range(h)
        ]
        sib = digest_var([list(p.leaf_sibling_hash) for p in native_paths])
        return cls(cs, path_bits, auth, sib, leaf_is_right)

    @staticmethod
    def _convert(cs, digest):
        """ByteDigestConverter twin: u64 LE length prefix (constant) || bytes."""
        prefix = [UInt8.constant(cs, b) for b in len(digest.bytes).to_bytes(8, "little")]
        return prefix + digest.bytes

    def calculate_root(self, leaf_hash_gadget, two_to_one_gadget, leaf_bytes):
        cs = self.cs
        claimed = leaf_hash_gadget.evaluate(cs, leaf_bytes)
        left = DigestVar.select(self.leaf_is_right_child, self.leaf_sibling, claimed)
        right = DigestVar.select(self.leaf_is_right_child, claimed, self.leaf_sibling)
        curr = two_to_one_gadget.evaluate(
            cs, self._convert(cs, left), self._convert(cs, right)
        )
        for level in range(len(self.auth_path) - 1, -1, -1):
            bit = self.path[level]
            sibling = self.auth_path[level]
            left = DigestVar.select(bit, sibling, curr)
            right = DigestVar.select(bit, curr, sibling)
            curr = two_to_one_gadget.compress(cs, left, right)
        return curr

    def verify_membership(self, leaf_hash_gadget, two_to_one_gadget, root, leaf_bytes) -> Boolean:
        return self.calculate_root(leaf_hash_gadget, two_to_one_gadget, leaf_bytes).is_eq(root)


class PathVar:
    """Field-native Merkle path variable.

    * ``path``: position Booleans, top-down (True = the on-path node is the
      right child), matching `Path::position_list` big-endian order
      (src/merkle_tree/mod.rs:160-165).
    * ``auth_path``: sibling digests, root->leaf order.
    * ``leaf_sibling`` and ``leaf_is_right_child`` for the leaf layer.
    """

    def __init__(self, cs: ConstraintSystem, path: List[Boolean],
                 auth_path: List[FpVar], leaf_sibling: FpVar,
                 leaf_is_right_child: Boolean):
        self.cs = cs
        self.path = path
        self.auth_path = auth_path
        self.leaf_sibling = leaf_sibling
        self.leaf_is_right_child = leaf_is_right_child

    @classmethod
    def new_witness(cls, cs: ConstraintSystem, native_path) -> "PathVar":
        """Allocate from a native `Path` (constraints.rs:96-140 shape)."""
        pos = native_path.position_list()  # top-down bools
        path_bits = [Boolean.new_witness(cs, b) for b in pos[:-1]]
        leaf_is_right = Boolean.new_witness(cs, pos[-1])
        auth = [FpVar.new_witness(cs, d) for d in native_path.auth_path]
        sib = FpVar.new_witness(cs, native_path.leaf_sibling_hash)
        return cls(cs, path_bits, auth, sib, leaf_is_right)

    @classmethod
    def new_witness_batch(cls, cs, native_paths) -> "PathVar":
        """Allocate N same-height Paths as one vectorized PathVar on a
        BatchConstraintSystem (r1cs/batch.py): each position bit becomes an
        (N,) bool tensor and each digest an (N, W) Montgomery word tensor,
        both on ``cs.device``; the synthesized structure is new_witness's
        per instance."""
        spec, dev = cs.field, cs.device
        h = _height(native_paths)
        pos = torch.from_numpy(
            np.asarray([p.position_list() for p in native_paths], bool)
        ).to(dev)
        path_bits = [Boolean.new_witness(cs, pos[:, i]) for i in range(pos.shape[1] - 1)]
        leaf_is_right = Boolean.new_witness(cs, pos[:, -1])
        auth_cols = torch.from_numpy(
            spec.pack([[int(d) for d in p.auth_path] for p in native_paths])
        ).to(dev)  # (N, h, W)
        auth = [FpVar.new_witness(cs, auth_cols[:, i]) for i in range(h)]
        sib = FpVar.new_witness(
            cs,
            torch.from_numpy(spec.pack([int(p.leaf_sibling_hash) for p in native_paths])).to(dev),
        )
        return cls(cs, path_bits, auth, sib, leaf_is_right)

    def calculate_root(self, leaf_hash_gadget, two_to_one_gadget, leaf: List[FpVar]) -> FpVar:
        """constraints.rs:182-223."""
        cs = self.cs
        claimed_leaf_hash = leaf_hash_gadget.evaluate(cs, leaf)
        # select left/right at the leaf layer
        left = FpVar.select(self.leaf_is_right_child, self.leaf_sibling, claimed_leaf_hash)
        right = FpVar.select(self.leaf_is_right_child, claimed_leaf_hash, self.leaf_sibling)
        curr = two_to_one_gadget.evaluate(cs, left, right)
        # levels bottom-up; path bits are stored top-down
        for level in range(len(self.auth_path) - 1, -1, -1):
            bit = self.path[level]
            sibling = self.auth_path[level]
            left = FpVar.select(bit, sibling, curr)
            right = FpVar.select(bit, curr, sibling)
            curr = two_to_one_gadget.compress(cs, left, right)
        return curr

    def verify_membership(self, leaf_hash_gadget, two_to_one_gadget,
                          root: FpVar, leaf: List[FpVar]) -> Boolean:
        """constraints.rs:228-237: Boolean result, no hard failure."""
        return self.calculate_root(leaf_hash_gadget, two_to_one_gadget, leaf).is_eq(root)

    def update_leaf(self, leaf_hash_gadget, two_to_one_gadget, old_root: FpVar,
                    old_leaf: List[FpVar], new_leaf: List[FpVar]) -> FpVar:
        """constraints.rs:239-256: check the old leaf is in the tree, then
        return the updated root."""
        ok = self.verify_membership(leaf_hash_gadget, two_to_one_gadget, old_root, old_leaf)
        one = FpVar.constant(self.cs, 1)
        ok.fp.enforce_equal(one)
        return self.calculate_root(leaf_hash_gadget, two_to_one_gadget, new_leaf)

    def update_and_check(self, leaf_hash_gadget, two_to_one_gadget, old_root: FpVar,
                         new_root: FpVar, old_leaf: List[FpVar],
                         new_leaf: List[FpVar]) -> Boolean:
        """constraints.rs:259-272."""
        updated = self.update_leaf(
            leaf_hash_gadget, two_to_one_gadget, old_root, old_leaf, new_leaf
        )
        return updated.is_eq(new_root)


class PointPathVar:
    """Point-digest Merkle path variable: the reference's primary Merkle
    constraint configuration (src/merkle_tree/tests/constraints.rs:17-54:
    Pedersen leaf + two-to-one gadgets over JubJub, digests are TE affine
    vars, leaf->inner conversion serializes coordinates to bytes, which
    `PedersenTwoToOneCRHGadget.compress` performs in-circuit)."""

    def __init__(self, cs, path, auth_path, leaf_sibling, leaf_is_right_child):
        self.cs = cs
        self.path = path  # Booleans, top-down
        self.auth_path = auth_path  # TEAffineVars, root->leaf
        self.leaf_sibling = leaf_sibling  # TEAffineVar
        self.leaf_is_right_child = leaf_is_right_child

    @classmethod
    def new_witness(cls, cs, curve, native_path) -> "PointPathVar":
        pos = native_path.position_list()
        path_bits = [Boolean.new_witness(cs, b) for b in pos[:-1]]
        leaf_is_right = Boolean.new_witness(cs, pos[-1])
        auth = [
            TEAffineVar.new_witness(cs, curve, d) for d in native_path.auth_path
        ]
        sib = TEAffineVar.new_witness(cs, curve, native_path.leaf_sibling_hash)
        return cls(cs, path_bits, auth, sib, leaf_is_right)

    def calculate_root(self, leaf_params, two_params, leaf_hash_gadget,
                       two_to_one_gadget, leaf_bytes):
        """constraints.rs:182-223 over point digests; `compress` converts
        digests to x||y bytes in-circuit (the PointToBytes converter)."""
        cs = self.cs
        claimed = leaf_hash_gadget.evaluate(cs, leaf_params, leaf_bytes)
        left = TEAffineVar.select(self.leaf_is_right_child, self.leaf_sibling, claimed)
        right = TEAffineVar.select(self.leaf_is_right_child, claimed, self.leaf_sibling)
        curr = two_to_one_gadget.compress(cs, two_params, left, right)
        for level in range(len(self.auth_path) - 1, -1, -1):
            bit = self.path[level]
            sibling = self.auth_path[level]
            left = TEAffineVar.select(bit, sibling, curr)
            right = TEAffineVar.select(bit, curr, sibling)
            curr = two_to_one_gadget.compress(cs, two_params, left, right)
        return curr

    def verify_membership(self, leaf_params, two_params, leaf_hash_gadget,
                          two_to_one_gadget, root, leaf_bytes) -> Boolean:
        got = self.calculate_root(
            leaf_params, two_params, leaf_hash_gadget, two_to_one_gadget, leaf_bytes
        )
        return got.is_eq(root)

    def update_leaf(self, leaf_params, two_params, leaf_hash_gadget,
                    two_to_one_gadget, old_root, old_leaf_bytes, new_leaf_bytes):
        """constraints.rs:239-256: enforce the old leaf's membership, then
        return the updated root."""
        ok = self.verify_membership(
            leaf_params, two_params, leaf_hash_gadget, two_to_one_gadget,
            old_root, old_leaf_bytes,
        )
        one = FpVar.constant(self.cs, 1)
        ok.fp.enforce_equal(one)
        return self.calculate_root(
            leaf_params, two_params, leaf_hash_gadget, two_to_one_gadget,
            new_leaf_bytes,
        )

    def update_and_check(self, leaf_params, two_params, leaf_hash_gadget,
                         two_to_one_gadget, old_root, new_root,
                         old_leaf_bytes, new_leaf_bytes) -> Boolean:
        """constraints.rs:259-272."""
        updated = self.update_leaf(
            leaf_params, two_params, leaf_hash_gadget, two_to_one_gadget,
            old_root, old_leaf_bytes, new_leaf_bytes,
        )
        return updated.is_eq(new_root)
