"""A plain Merkle tree over a hashing scheme, with the reference's layout and
path check (arkworks crypto-primitives ``src/merkle_tree/mod.rs``): leaves
are hashed with the leaf hash, the bottom inner level hashes the converted
leaf digests in pairs, every further level the digests below it in pairs, and
a path is verified by hashing up from the leaf with the siblings the
reference's own tree holds and comparing with its root.

A scheme gives ``leaf_hash(raw)``, ``compress(left, right, bottom)``,
``take(digests, idx)``, ``select(is_left, a, b)`` and ``equal(digests,
root)``.  Its ``skip_leaf_hash`` breaks the guarantee that every leaf is
hashed (raw leaves stand for their own digests): that is the control that
has to come out as not correct.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from portbench.reference.poseidon_ref import NDIG, Field64, Poseidon64


def build(scheme, leaves) -> list:
    """levels[0] the leaf digests ... levels[-1] the root (one row)."""
    levels = [scheme.leaf_hash(leaves)]
    bottom = True
    while len(levels[-1]) > 1:
        cur = levels[-1]
        levels.append(scheme.compress(cur[0::2], cur[1::2], bottom))
        bottom = False
    return levels


def verify(scheme, levels: list, raw, idx: np.ndarray) -> np.ndarray:
    """(B,) bool: does each raw leaf, hashed up its index's path, reach the
    root?"""
    return verify_digests(scheme, levels, scheme.leaf_hash(raw), idx)


def verify_digests(scheme, levels: list, cur, idx: np.ndarray) -> np.ndarray:
    """:func:`verify` from leaf digests already hashed."""
    node = np.asarray(idx, dtype=np.int64)
    for depth, level in enumerate(levels[:-1]):
        sib = scheme.take(level, node ^ 1)
        left = (node & 1) == 0
        cur = scheme.compress(scheme.select(left, cur, sib), scheme.select(left, sib, cur), depth == 0)
        node = node >> 1
    return scheme.equal(cur, levels[-1])


class Sha256Scheme:
    """Sha256CRH leaves, Sha256TwoToOneCRH nodes and the byte digest
    converter: a 32-byte digest enters the bottom inner hash as its 8-byte
    little-endian length and its bytes (``to_uncompressed_bytes!`` of a
    ``Vec<u8>``).  Digests are ``(B, 32)`` uint8 numpy rows; every hash is
    ``hashlib``'s."""

    PREFIX = np.frombuffer((32).to_bytes(8, "little"), dtype=np.uint8)

    def __init__(self, skip_leaf_hash: bool = False):
        self.skip_leaf_hash = skip_leaf_hash

    @staticmethod
    def _hash_rows(rows: np.ndarray) -> np.ndarray:
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        n = rows.shape[1]
        buf = rows.tobytes()
        out = b"".join(hashlib.sha256(buf[i * n:(i + 1) * n]).digest() for i in range(rows.shape[0]))
        return np.frombuffer(out, dtype=np.uint8).reshape(rows.shape[0], 32)

    def leaf_hash(self, raw) -> np.ndarray:
        raw = np.asarray(raw, dtype=np.uint8)
        return raw.copy() if self.skip_leaf_hash else self._hash_rows(raw)

    def compress(self, left, right, bottom: bool) -> np.ndarray:
        if bottom:
            pre = np.broadcast_to(self.PREFIX, (left.shape[0], 8))
            return self._hash_rows(np.concatenate([pre, left, pre, right], axis=1))
        return self._hash_rows(np.concatenate([left, right], axis=1))

    def take(self, digests, idx):
        return digests[idx]

    def select(self, is_left, a, b):
        return np.where(is_left[:, None], a, b)

    def equal(self, digests, root) -> np.ndarray:
        return (digests == root[0]).all(axis=1)


class PoseidonScheme:
    """PoseidonCRH leaves of one element and PoseidonTwoToOneCRH nodes
    (``src/crh/poseidon/mod.rs:58-79``): a zeroed state with the inputs in
    rate slots 1.., one permutation, slot 1 out.  Digests are ``(B, 18)``
    float64 digit rows (:class:`Field64`); a level is hashed in blocks of
    ``block`` rows."""

    def __init__(self, perm: Poseidon64, skip_leaf_hash: bool = False, block: int = 1 << 18):
        self.perm, self.f = perm, perm.f
        self.skip_leaf_hash = skip_leaf_hash
        self.block = block

    def _hash(self, inputs: list) -> torch.Tensor:
        b = inputs[0].shape[0]
        outs = []
        for lo in range(0, b, self.block):
            rows = [x[lo:lo + self.block] for x in inputs]
            zero = torch.zeros_like(rows[0])
            pad = [zero] * (self.perm.t - 1 - len(rows))
            outs.append(self.perm(torch.stack([zero, *rows, *pad], dim=1))[:, 1])
        return torch.cat(outs)

    def leaf_hash(self, raw: torch.Tensor) -> torch.Tensor:
        return raw.clone() if self.skip_leaf_hash else self._hash([raw])

    def compress(self, left, right, bottom: bool) -> torch.Tensor:
        return self._hash([left, right])

    def take(self, digests, idx):
        return digests.index_select(0, torch.as_tensor(idx, device=digests.device))

    def select(self, is_left, a, b):
        return torch.where(torch.as_tensor(is_left, device=a.device).unsqueeze(-1), a, b)

    def equal(self, digests, root) -> np.ndarray:
        want = self.f.to_ints(root)[0]
        return np.array([v == want for v in self.f.to_ints(digests)], dtype=bool)


__all__ = ["build", "verify", "verify_digests", "Sha256Scheme", "PoseidonScheme", "Field64", "Poseidon64", "NDIG"]
