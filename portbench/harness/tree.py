"""The calls that the tree kinds make into the program under test.

A configuration's ``Program`` derives from :class:`TreeProgram`: its
``__init__`` sets ``_build`` (raw leaves -> the program's
``DeviceMerkleTree``), ``_leaf_hash`` (the tree's leaf hash on a batch of raw
leaves) and ``_kernel`` (the kernel wrapper module whose ``launches`` it
counts)."""

from __future__ import annotations

import numpy as np


class TreeProgram:
    def build(self, raw):
        return self._build(raw)

    def root(self, tree) -> np.ndarray:
        return tree.root_row().cpu().numpy()

    def leaf_hash(self, tree, raw):
        return self._leaf_hash(raw)

    def proof_rows(self, tree, idx):
        return tree.proof_rows(idx)

    def verify(self, tree, digests, idx, sib, auth):
        return tree.verify_rows_batch(tree.root_row(), digests, idx, sib, auth)

    def to_host(self, x) -> np.ndarray:
        return x.cpu().numpy()

    def launches(self) -> dict:
        return {self._kernel.__name__: self._kernel.launches}
