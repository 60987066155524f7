"""Merkle tree with Path / MultiPath proofs.

Twin of ``crypto_primitives_tpu/models/merkle_tree/__init__.py`` (the
reference's src/merkle_tree/mod.rs).  Layout and index math match the
reference exactly: a dense array of non-leaf nodes in level order (root at 0,
children of i at 2i+1 / 2i+2, mod.rs:383-395), leaf digests left to right, a
power-of-two leaf count (mod.rs:429-433).

Construction is one batched leaf-hash call plus one batched two-to-one call
per level, on ``device``; the levels are then kept as numpy arrays, and proof
generation, verification and updates run on the host over them, mirroring the
reference's control flow.  ``verify_paths_batch`` verifies many proofs in one
batched pass.  Digests are field elements, byte strings or affine curve
points (``PointDigestDomain``, with ``PointToBytesDigestConverter`` for the
reference's Pedersen byte tree).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops.curve import affine_to_uncompressed_bytes
from crypto_primitives_tpu_torch.ops.field import FieldSpec


# ----------------------------------------------------------------------
# Digest domains: how a digest type is stored as array rows + host values
# ----------------------------------------------------------------------


class FieldDigestDomain:
    """Digests are field elements: rows (W,) int32 Montgomery words; host = int."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def default_host(self):
        return 0  # P::InnerDigest::default() == F::zero()

    def zeros(self, n: int) -> np.ndarray:
        return np.zeros((n, self.spec.num_words), dtype=np.int32)

    def to_host(self, row: np.ndarray):
        return self.spec.unpack(np.asarray(row))

    def from_host(self, value) -> np.ndarray:
        return self.spec.pack([int(value)])[0]

    def eq_host(self, a, b) -> bool:
        return int(a) == int(b)


class PointDigestDomain:
    """Digests are affine curve points (the reference's primary byte-tree
    config, src/merkle_tree/tests/mod.rs:5-50: Pedersen leaf and inner hashes
    over JubJub): rows (2, W) int32 Montgomery words (x, y); host = (x, y)."""

    def __init__(self, curve):
        self.curve = curve

    def default_host(self):
        return self.curve.zero_host()  # Affine::default() is the identity

    def zeros(self, n: int) -> np.ndarray:
        return np.broadcast_to(self.from_host(self.default_host()), (n, 2, self.curve.base.num_words)).copy()

    def to_host(self, row: np.ndarray):
        x, y = self.curve.base.unpack(np.asarray(row))
        return (int(x), int(y))

    def from_host(self, value) -> np.ndarray:
        return self.curve.base.pack([int(value[0]), int(value[1])])

    def eq_host(self, a, b) -> bool:
        return tuple(int(v) for v in a) == tuple(int(v) for v in b)


class ByteDigestDomain:
    """Digests are fixed-width byte strings: rows (width,) uint8; host = bytes."""

    def __init__(self, width: int):
        self.width = width

    def default_host(self):
        return b""  # Vec<u8>::default() is the empty vector (ark semantics)

    def zeros(self, n: int) -> np.ndarray:
        return np.zeros((n, self.width), dtype=np.uint8)

    def to_host(self, row: np.ndarray) -> bytes:
        return bytes(np.asarray(row).astype(np.uint8))

    def from_host(self, value: bytes) -> np.ndarray:
        return np.frombuffer(bytes(value), dtype=np.uint8).copy()

    def eq_host(self, a, b) -> bool:
        return bytes(a) == bytes(b)


# ----------------------------------------------------------------------
# Digest converters (DigestConverter twins, mod.rs:48-78)
# ----------------------------------------------------------------------


class IdentityDigestConverter:
    def convert(self, host_digest):
        return host_digest

    def convert_batch(self, arr: torch.Tensor) -> torch.Tensor:
        return arr


class ByteDigestConverter:
    """``to_uncompressed_bytes!`` of the previous digest (mod.rs:67-78).

    arkworks serializes a ``Vec<u8>`` digest as an 8-byte LE length prefix
    followed by the bytes, so a 32-byte SHA-256 digest becomes a 40-byte
    inner-hash input (what the reference's SHA-256 bench tree hashes,
    benches/merkle_tree.rs:24-33).  The prefix is copied to a device once and
    kept there, so a batch conversion touches no host memory (a CUDA graph
    can capture it).
    """

    def __init__(self, width: int):
        self.width = width
        self._prefixes = {"cpu": torch.tensor(list(int(width).to_bytes(8, "little")), dtype=torch.uint8)}

    def convert(self, host_digest: bytes) -> bytes:
        return len(host_digest).to_bytes(8, "little") + bytes(host_digest)

    def convert_batch(self, arr: torch.Tensor) -> torch.Tensor:
        key = str(arr.device)
        if key not in self._prefixes:
            self._prefixes[key] = self._prefixes["cpu"].to(arr.device)
        return torch.cat([self._prefixes[key].expand(arr.shape[:-1] + (8,)), arr], dim=-1)


class PointToBytesDigestConverter:
    """``to_uncompressed_bytes!`` of an affine point digest: x || y bigint
    little-endian bytes, no flags (src/merkle_tree/tests/mod.rs:30-38 over
    src/merkle_tree/mod.rs:67-78)."""

    def __init__(self, curve):
        self.curve = curve

    def convert(self, host_digest) -> bytes:
        return self.curve.to_uncompressed_bytes(host_digest)

    def convert_batch(self, rows: torch.Tensor) -> torch.Tensor:
        """(..., 2, W) Montgomery affine -> (..., 2 * bigint_bytes) uint8."""
        return affine_to_uncompressed_bytes(self.curve, rows)


class FieldToBytesDigestConverter:
    """``to_uncompressed_bytes!`` of a field element: bigint LE bytes."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def convert(self, host_digest: int) -> bytes:
        return self.spec.to_bytes_le(int(host_digest))

    def convert_batch(self, arr: torch.Tensor) -> torch.Tensor:
        return ff.to_bytes_le(self.spec, arr)


@dataclasses.dataclass
class MerkleTreeConfig:
    """``Config`` twin (mod.rs:83-122)."""

    leaf_hash: Any
    two_to_one_hash: Any
    leaf_domain: Any
    inner_domain: Any
    leaf_inner_converter: Any


# ----------------------------------------------------------------------
# Index helpers (exact mirrors of mod.rs:728-786)
# ----------------------------------------------------------------------


def tree_height(num_leaves: int) -> int:
    """mod.rs:730-736 (power-of-two leaf counts): log2(n) + 1."""
    return 1 if num_leaves == 1 else num_leaves.bit_length() - 1 + 1


def _is_root(index: int) -> bool:
    return index == 0


def _left_child(index: int) -> int:
    return 2 * index + 1


def _right_child(index: int) -> int:
    return 2 * index + 2


def _sibling(index: int) -> Optional[int]:
    if index == 0:
        return None
    return index + 1 if _is_left_child(index) else index - 1


def _is_left_child(index: int) -> bool:
    return index % 2 == 1


def _parent(index: int) -> Optional[int]:
    return (index - 1) >> 1 if index > 0 else None


def _convert_index_to_last_level(index: int, height: int) -> int:
    return index + (1 << (height - 1)) - 1


def _select_left_right(index: int, computed, sibling):
    """mod.rs:360-372: even index -> computed is left."""
    return (computed, sibling) if index & 1 == 0 else (sibling, computed)


def _prefix_encode_path(prev_path, path, eq):
    prefix_length = 0
    for a, b in zip(prev_path, path):
        if not eq(a, b):
            break
        prefix_length += 1
    return prefix_length, list(path[prefix_length:])


def _prefix_decode_path(prev_path, prefix_len, suffix):
    if prefix_len == 0:
        return list(suffix)
    return list(prev_path[:prefix_len]) + list(suffix)


# ----------------------------------------------------------------------
# Proof objects
# ----------------------------------------------------------------------


@dataclasses.dataclass
class Path:
    """`Path` twin (mod.rs:146-165): auth_path ordered root->leaf."""

    leaf_sibling_hash: Any
    auth_path: List[Any]
    leaf_index: int

    def position_list(self) -> List[bool]:
        """mod.rs:160-165: leaf_index bits, big-endian."""
        n = len(self.auth_path) + 1
        return [bool((self.leaf_index >> i) & 1) for i in range(n)][::-1]

    def verify(self, config: MerkleTreeConfig, leaf_hash_params, two_to_one_params,
               root_hash, leaf) -> bool:
        """mod.rs:172-212; returns False (never raises) on mismatch."""
        claimed = config.leaf_hash.evaluate(leaf_hash_params, leaf)
        left, right = _select_left_right(self.leaf_index, claimed, self.leaf_sibling_hash)
        conv = config.leaf_inner_converter
        curr = config.two_to_one_hash.evaluate(
            two_to_one_params, conv.convert(left), conv.convert(right)
        )
        index = self.leaf_index >> 1
        for level in range(len(self.auth_path) - 1, -1, -1):
            left, right = _select_left_right(index, curr, self.auth_path[level])
            curr = config.two_to_one_hash.compress(two_to_one_params, left, right)
            index >>= 1
        return config.inner_domain.eq_host(curr, root_hash)


@dataclasses.dataclass
class MultiPath:
    """`MultiPath` twin with front incremental encoding (mod.rs:245-254)."""

    leaf_siblings_hashes: List[Any]
    auth_paths_prefix_lenghts: List[int]
    auth_paths_suffixes: List[List[Any]]
    leaf_indexes: List[int]

    def position_list(self) -> List[List[bool]]:
        path_len = len(self.auth_paths_suffixes[0])
        return [
            [bool((i >> j) & 1) for j in range(path_len + 1)][::-1]
            for i in self.leaf_indexes
        ]

    def verify(self, config: MerkleTreeConfig, leaf_hash_params, two_to_one_params,
               root_hash, leaves: Sequence) -> bool:
        """mod.rs:262-331: incremental decode + memoized inner hashes."""
        tree_h = len(self.auth_paths_suffixes[0]) + 2
        hash_lut = {}
        prev_path = list(self.auth_paths_suffixes[0])
        conv = config.leaf_inner_converter
        leaves = list(leaves)
        for i, leaf_index in enumerate(self.leaf_indexes):
            leaf = leaves[i]
            leaf_sibling = self.leaf_siblings_hashes[i]
            auth_path = _prefix_decode_path(
                prev_path, self.auth_paths_prefix_lenghts[i], self.auth_paths_suffixes[i]
            )
            prev_path = list(auth_path)
            claimed = config.leaf_hash.evaluate(leaf_hash_params, leaf)
            left, right = _select_left_right(leaf_index, claimed, leaf_sibling)
            index = leaf_index >> 1
            index_in_tree = _parent(_convert_index_to_last_level(leaf_index, tree_h))
            if index_in_tree not in hash_lut:
                hash_lut[index_in_tree] = config.two_to_one_hash.evaluate(
                    two_to_one_params, conv.convert(left), conv.convert(right)
                )
            curr = hash_lut[index_in_tree]
            for level in range(len(auth_path) - 1, -1, -1):
                left, right = _select_left_right(index, curr, auth_path[level])
                index >>= 1
                index_in_tree = _parent(index_in_tree)
                if index_in_tree not in hash_lut:
                    hash_lut[index_in_tree] = config.two_to_one_hash.compress(
                        two_to_one_params, left, right
                    )
                curr = hash_lut[index_in_tree]
            if not config.inner_domain.eq_host(curr, root_hash):
                return False
        return True


# ----------------------------------------------------------------------
# The tree
# ----------------------------------------------------------------------


class MerkleTree:
    """`MerkleTree` twin (mod.rs:383-726) with array-level storage."""

    def __init__(self, config: MerkleTreeConfig, leaf_hash_param, two_to_one_param,
                 non_leaf_nodes: np.ndarray, leaf_nodes: np.ndarray, height: int):
        self.config = config
        self.leaf_hash_param = leaf_hash_param
        self.two_to_one_hash_param = two_to_one_param
        self.non_leaf_nodes = non_leaf_nodes  # (N-1, D) level order, root first
        self.leaf_nodes = leaf_nodes  # (N, D)
        self.height = height
        # blank byte trees: untouched leaf digests are the EMPTY vector
        # (Vec<u8>::default()); mask rows read back as b"" until updated
        self._leaf_is_blank = None

    # -- construction --

    @classmethod
    def new(cls, config: MerkleTreeConfig, leaf_hash_param, two_to_one_param,
            leaves, device=None) -> "MerkleTree":
        """Batched leaf hash + level-by-level build (mod.rs:411-422), on
        ``device`` (``None`` means CUDA)."""
        leaf_digests = config.leaf_hash.evaluate_batch(leaf_hash_param, leaves, device=device)
        return cls.new_with_leaf_digest(
            config, leaf_hash_param, two_to_one_param, leaf_digests, device=device
        )

    @classmethod
    def new_with_leaf_digest(cls, config: MerkleTreeConfig, leaf_hash_param,
                             two_to_one_param, leaf_digests, device=None) -> "MerkleTree":
        leaf_digests = torch.as_tensor(leaf_digests, device=resolve_device(device))
        n = int(leaf_digests.shape[0])
        if n < 2 or n & (n - 1):
            raise ValueError("leaves.len() should be power of two and greater than one")
        height = n.bit_length() - 1 + 1  # log2(n) + 1

        conv = config.leaf_inner_converter
        two = config.two_to_one_hash
        dev = leaf_digests.device
        # bottom non-leaf layer from leaf digests (mod.rs:454-483)
        cur = two.evaluate_batch(
            two_to_one_param,
            conv.convert_batch(leaf_digests[0::2]),
            conv.convert_batch(leaf_digests[1::2]),
            device=dev,
        )
        levels = [cur]
        # upper levels: one batched call per level
        while cur.shape[0] > 1:
            cur = two.compress_batch(two_to_one_param, cur[0::2], cur[1::2], device=dev)
            levels.append(cur)
        levels.reverse()  # root level first -> level order
        non_leaf = torch.cat(levels, dim=0).cpu().numpy()
        return cls(config, leaf_hash_param, two_to_one_param, non_leaf,
                   leaf_digests.cpu().numpy(), height)

    @classmethod
    def blank(cls, config: MerkleTreeConfig, leaf_hash_param, two_to_one_param,
              height: int) -> "MerkleTree":
        """mod.rs:400-408 (leaves = default digests).

        Byte domains: the reference's default `Vec<u8>` digest is the
        *empty* vector, so the bottom inner level hashes converted empty
        digests and reads of untouched leaf digests return b"".  Since all
        leaves are identical, each level holds one repeated value — built
        host-side in O(height) instead of O(n) hashes.
        """
        n = 1 << (height - 1)
        dom = config.leaf_domain
        blank_leaf = dom.default_host()
        conv = config.leaf_inner_converter
        cur = config.two_to_one_hash.evaluate(
            two_to_one_param, conv.convert(blank_leaf), conv.convert(blank_leaf)
        )
        levels = [np.stack([config.inner_domain.from_host(cur)] * (n // 2))]
        while levels[-1].shape[0] > 1:
            cur = config.two_to_one_hash.compress(two_to_one_param, cur, cur)
            levels.append(
                np.stack(
                    [config.inner_domain.from_host(cur)]
                    * (levels[-1].shape[0] // 2)
                )
            )
        levels.reverse()
        non_leaf = np.concatenate(levels, axis=0)
        tree = cls(config, leaf_hash_param, two_to_one_param, non_leaf,
                   np.asarray(dom.zeros(n)), height)
        if isinstance(blank_leaf, (bytes, bytearray)) and len(blank_leaf) == 0:
            # untouched leaf digests read back as the empty vector
            tree._leaf_is_blank = np.ones(n, dtype=bool)
        return tree

    # -- accessors --

    def root(self):
        return self.config.inner_domain.to_host(self.non_leaf_nodes[0])

    def get_leaf_sibling_hash(self, index: int):
        j = index + 1 if index & 1 == 0 else index - 1
        if self._leaf_is_blank is not None and self._leaf_is_blank[j]:
            return self.config.leaf_domain.default_host()
        return self.config.leaf_domain.to_host(self.leaf_nodes[j])

    def _compute_auth_path(self, index: int) -> List[Any]:
        """mod.rs:547-569: sibling digests bottom-up, then reversed."""
        path = []
        current = _parent(_convert_index_to_last_level(index, self.height))
        while not _is_root(current):
            path.append(self.config.inner_domain.to_host(
                self.non_leaf_nodes[_sibling(current)]))
            current = _parent(current)
        path.reverse()
        return path

    def generate_proof(self, index: int) -> Path:
        return Path(
            leaf_sibling_hash=self.get_leaf_sibling_hash(index),
            auth_path=self._compute_auth_path(index),
            leaf_index=index,
        )

    def generate_multi_proof(self, indexes) -> MultiPath:
        """mod.rs:592-625: sorted/deduped indexes, prefix-encoded paths."""
        idxs = sorted(set(int(i) for i in indexes))
        eq = self.config.inner_domain.eq_host
        prefix_lengths, suffixes, sib_hashes = [], [], []
        prev_path: List[Any] = []
        for index in idxs:
            sib_hashes.append(self.get_leaf_sibling_hash(index))
            path = self._compute_auth_path(index)
            plen, suffix = _prefix_encode_path(prev_path, path, eq)
            prefix_lengths.append(plen)
            suffixes.append(suffix)
            prev_path = path
        return MultiPath(
            leaf_siblings_hashes=sib_hashes,
            auth_paths_prefix_lenghts=prefix_lengths,
            auth_paths_suffixes=suffixes,
            leaf_indexes=idxs,
        )

    # -- updates (host tier; mod.rs:629-725) --

    def _updated_path(self, index: int, new_leaf):
        cfg = self.config
        new_leaf_hash = cfg.leaf_hash.evaluate(self.leaf_hash_param, new_leaf)
        if index & 1 == 0:
            leaf_left, leaf_right = new_leaf_hash, self.get_leaf_sibling_hash(index)
        else:
            leaf_left, leaf_right = self.get_leaf_sibling_hash(index), new_leaf_hash
        conv = cfg.leaf_inner_converter
        path_bottom_to_top = [
            cfg.two_to_one_hash.evaluate(
                self.two_to_one_hash_param, conv.convert(leaf_left), conv.convert(leaf_right)
            )
        ]
        prev_index = _parent(_convert_index_to_last_level(index, self.height))
        while not _is_root(prev_index):
            sib = cfg.inner_domain.to_host(self.non_leaf_nodes[_sibling(prev_index)])
            if _is_left_child(prev_index):
                left, right = path_bottom_to_top[-1], sib
            else:
                left, right = sib, path_bottom_to_top[-1]
            path_bottom_to_top.append(
                cfg.two_to_one_hash.compress(self.two_to_one_hash_param, left, right)
            )
            prev_index = _parent(prev_index)
        return new_leaf_hash, path_bottom_to_top[::-1]  # root-first

    def _apply_update(self, index, new_leaf_hash, updated_path_root_first):
        self.leaf_nodes[index] = self.config.leaf_domain.from_host(new_leaf_hash)
        if self._leaf_is_blank is not None:
            self._leaf_is_blank[index] = False
        path = list(updated_path_root_first)
        curr = _convert_index_to_last_level(index, self.height)
        for _ in range(self.height - 1):
            curr = _parent(curr)
            self.non_leaf_nodes[curr] = self.config.inner_domain.from_host(path.pop())

    def _check_index(self, index: int) -> None:
        if not 0 <= index < self.leaf_nodes.shape[0]:
            raise IndexError(f"leaf index {index} out of range")

    def update(self, index: int, new_leaf) -> None:
        self._check_index(index)
        h, path = self._updated_path(index, new_leaf)
        self._apply_update(index, h, path)

    def check_update(self, index: int, new_leaf, asserted_new_root) -> bool:
        """Refuses to mutate on root mismatch (mod.rs:707-725)."""
        self._check_index(index)
        h, path = self._updated_path(index, new_leaf)
        if not self.config.inner_domain.eq_host(path[0], asserted_new_root):
            return False
        self._apply_update(index, h, path)
        return True


def verify_paths_batch(config: MerkleTreeConfig, leaf_hash_param, two_to_one_param,
                       root_hash, leaves, leaf_indexes, leaf_sibling_rows,
                       auth_path_rows, device=None) -> torch.Tensor:
    """Batched verification of many Paths at once on ``device``.

    leaves: (B, ...) leaf-hash inputs; leaf_indexes (B,); leaf_sibling_rows
    (B, D_leaf); auth_path_rows (B, height-2, D_inner) in root-to-leaf order.
    Returns (B,) bool.
    """
    dev = resolve_device(device)
    cfg = config
    claimed = cfg.leaf_hash.evaluate_batch(leaf_hash_param, leaves, device=dev)
    idx = torch.as_tensor(leaf_indexes, dtype=torch.int64, device=dev)
    sib_rows = torch.as_tensor(leaf_sibling_rows, device=dev)
    auth = torch.as_tensor(auth_path_rows, device=dev)

    def pick(cond, a, b):
        return torch.where(cond.unsqueeze(-1), a, b)

    is_left = (idx & 1) == 0
    conv = cfg.leaf_inner_converter
    curr = cfg.two_to_one_hash.evaluate_batch(
        two_to_one_param,
        conv.convert_batch(pick(is_left, claimed, sib_rows)),
        conv.convert_batch(pick(is_left, sib_rows, claimed)),
        device=dev,
    )
    index = idx >> 1
    for level in range(auth.shape[1] - 1, -1, -1):
        sib = auth[:, level]
        is_left = (index & 1) == 0
        curr = cfg.two_to_one_hash.compress_batch(
            two_to_one_param, pick(is_left, curr, sib), pick(is_left, sib, curr), device=dev
        )
        index = index >> 1
    root_row = torch.as_tensor(cfg.inner_domain.from_host(root_hash), device=dev)
    return (curr == root_row).all(dim=-1)
