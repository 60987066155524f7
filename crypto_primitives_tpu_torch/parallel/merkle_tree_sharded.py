"""Sharded Merkle trees: build, every leaf's proof, updates and verification
over a mesh, and the data-parallel Poseidon permutation.

Twin of ``crypto_primitives_tpu/parallel/merkle_tree_sharded.py`` (the
reference's flagship workload, benches/merkle_tree.rs:36-209: create, prove
and verify at 2^20 leaves).  The leaves are sharded across the mesh: rank r
holds leaves ``[r * n_local, (r + 1) * n_local)`` and builds their subtree
with the port's own level compressor, as ``DeviceMerkleTree.build`` does
(one kernel launch per level, the children of a node being adjacent rows);
the D subtree roots ride one all-gather, and every rank folds the top
log2(D) levels the same way.

SPMD form.  JAX's ``shard_map`` is single-controller: one process passes the
global leaves and gets global results.  Here every rank calls each function
with its own shard and gets back the replicated results (the root, the top
levels) whole, and the per-leaf results (leaf siblings, auth paths, verify
booleans) for the rows it passed.  Calls that take global leaf indexes
(``ShardedMerkleTree.proof_rows``, ``update_batch``) take them replicated,
the same on every rank, as JAX does.  The values equal the single-device
tree's; only the form of the API differs.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from crypto_primitives_tpu_torch.models.merkle_tree.device import DeviceMerkleTree, _multipath_schedule
from crypto_primitives_tpu_torch.models.sponge.poseidon import permute
from crypto_primitives_tpu_torch.parallel.mesh import all_gather, all_reduce_sum, shard_of


def _identity(x):
    return x


def _halves(cur: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The left and right children of every node: the adjacent rows 2i and
    2i + 1, taken as views."""
    pairs = cur.unflatten(0, (-1, 2))
    return pairs[:, 0], pairs[:, 1]


def _pairwise_level(compress_batch: Callable) -> Callable:
    """A whole-level compressor from a pairwise one."""
    return lambda cur: compress_batch(*_halves(cur))


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _check_shards(n_local: int, size: int) -> None:
    if n_local < 2 or n_local & (n_local - 1):
        raise ValueError(f"each rank needs a power of two of leaves, at least 2 (got {n_local})")
    if size & (size - 1):
        raise ValueError(f"the mesh axis must hold a power of two of ranks (got {size})")


def _fold_top(compress_level: Callable, roots: torch.Tensor) -> list:
    """[(D, ...), (D/2, ...), ..., (1, ...)]: the top levels over the D
    gathered subtree roots, the same on every rank."""
    levels = [roots]
    while levels[-1].shape[0] > 1:
        levels.append(compress_level(levels[-1]))
    return levels


class ShardedMerkleTree:
    """The sharded twin of ``DeviceMerkleTree`` (reference mutation sites:
    src/merkle_tree/mod.rs:629-680 update, :252-294 verify).

    ``local`` is this rank's subtree, a ``DeviceMerkleTree`` over its
    ``n_local`` leaves (``leaf_digests`` and ``local_levels`` are its
    tensors); ``top_levels`` are the replicated top log2(D) + 1 levels, from
    the D subtree roots up to the root."""

    def __init__(self, mesh, axis_name: str, local: DeviceMerkleTree, top_levels: list, compress_level: Callable):
        self.mesh = mesh
        self.axis_name = axis_name
        self.local = local
        self.top_levels = top_levels
        self.compress_level = compress_level
        self.rank, self.size, _ = shard_of(mesh, axis_name)

    @property
    def leaf_digests(self) -> torch.Tensor:
        return self.local.leaf_digests

    @property
    def local_levels(self) -> list:
        """The subtree's inner levels, its root (1 row) first."""
        return self.local.inner_levels

    @property
    def n_local(self) -> int:
        return int(self.local.leaf_digests.shape[0])

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def root_row(self) -> torch.Tensor:
        return self.top_levels[-1][0]

    def _refold(self) -> None:
        roots = all_gather(self.local.root_row(), self.mesh, self.axis_name)
        self.top_levels = _fold_top(self.compress_level, roots)

    def _top_columns(self, auth: torch.Tensor, owner: torch.Tensor) -> None:
        """Fill auth's top log2(D) columns (root first) with the siblings on
        the path of each row's owner subtree through the top tree."""
        n_top = len(self.top_levels) - 1
        node = owner
        for j, level in enumerate(self.top_levels[:-1]):  # bottom of the top tree ... level 1
            auth[:, n_top - 1 - j] = level.index_select(0, node ^ 1)
            node = node >> 1

    def local_proof_rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(leaf_sib (n_local, D), auth (n_local, height-2, D) root first) for
        every leaf of this rank's shard, written into one buffer per
        output; no collective."""
        local, n = self.local, self.n_local
        idx = torch.arange(n, device=self.device)
        leaf_sib = local.leaf_digests.index_select(0, idx ^ 1)
        n_top, n_loc = len(self.top_levels) - 1, len(local.inner_levels) - 1
        auth = leaf_sib.new_empty((n, n_top + n_loc) + tuple(leaf_sib.shape[1:]))
        self._top_columns(auth, torch.full((n,), self.rank, dtype=torch.int64, device=self.device))
        node = idx >> 1
        for j, level in enumerate(local.inner_levels[:0:-1]):  # bottom ... subtree level 1
            auth[:, n_top + n_loc - 1 - j] = level.index_select(0, node ^ 1)
            node = node >> 1
        return leaf_sib, auth

    def proof_rows(self, indexes) -> Tuple[torch.Tensor, torch.Tensor]:
        """Auth paths for global leaf indexes, replicated: every rank passes
        the same indexes and gets every requested row, equal to the
        single-device ``proof_rows``.  Each rank fills the rows whose leaf
        lies in its shard, and one all-reduce assembles them; the top
        columns are filled on every rank from the replicated top levels."""
        dev = self.device
        idx = torch.as_tensor(indexes, dtype=torch.int64, device=dev).reshape(-1)
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= self.n_local * self.size):
            raise IndexError(f"leaf indexes must lie in [0, {self.n_local * self.size})")
        owner = idx >> _log2(self.n_local)
        n_top, n_loc = len(self.top_levels) - 1, len(self.local.inner_levels) - 1
        d = tuple(self.leaf_digests.shape[1:])
        rows = self.leaf_digests.new_zeros((idx.shape[0], 1 + n_top + n_loc) + d)
        mine = (owner == self.rank).nonzero().reshape(-1)
        if mine.numel():
            sib, auth = self.local.proof_rows(idx[mine] & (self.n_local - 1))
            rows[mine, 0] = sib
            rows[mine, 1 + n_top:] = auth
        all_reduce_sum(rows, self.mesh, self.axis_name)
        self._top_columns(rows[:, 1:], owner)
        return rows[:, 0], rows[:, 1:]

    def update_batch(self, indexes: Sequence[int], new_leaf_digests) -> None:
        """Write new leaf digests and recompute the touched ancestors.  The
        update list is replicated: each rank writes the updates that fall in
        its shard in place and recomputes their ancestors in its subtree
        (``DeviceMerkleTree.update_batch``, whose semantics a repeated index
        follows), then the top is refolded through one all-gather."""
        idx = [int(i) for i in indexes]
        n_all = self.n_local * self.size
        if any(i < 0 or i >= n_all for i in idx):
            raise IndexError(f"leaf indexes must lie in [0, {n_all})")
        shift = _log2(self.n_local)
        picks = [k for k, i in enumerate(idx) if i >> shift == self.rank]
        if picks:
            rows = torch.as_tensor(new_leaf_digests, device=self.device)
            sel = torch.tensor(picks, dtype=torch.int64, device=self.device)
            self.local.update_batch([idx[k] & (self.n_local - 1) for k in picks], rows.index_select(0, sel))
        self._refold()

    def verify_rows_batch(self, root_row, leaf_digests, indexes, leaf_sib, auth) -> torch.Tensor:
        """Data-parallel verification of the proof rows this rank passes
        (global ``indexes``, the replicated root), with no collective: the
        rank's verdicts, bit-equal to ``DeviceMerkleTree.verify_rows_batch``."""
        return self.local.verify_rows_batch(root_row, leaf_digests, indexes, leaf_sib, auth)


def sharded_merkle_tree(
    leaf_hash_batch: Callable,
    compress_batch: Callable,
    leaves: torch.Tensor,
    mesh,
    axis_name: str = "data",
    leaf_convert: Callable = _identity,
    compress_level_batch: Callable | None = None,
) -> ShardedMerkleTree:
    """Build a tree that keeps every level, from this rank's shard
    ``leaves`` (n_local, ...) on its device; n_local is a power of two >= 2,
    the same on every rank.  ``compress_level_batch`` compresses a whole
    level from its contiguous pair layout (``DeviceMerkleTree.build``);
    ``None`` pairs the rows of ``compress_batch`` as views."""
    rank, size, _ = shard_of(mesh, axis_name)
    _check_shards(int(leaves.shape[0]), size)
    level = compress_level_batch or _pairwise_level(compress_batch)
    local = DeviceMerkleTree.build(leaf_hash_batch, compress_batch, leaves, to_host=None,
                                   compress_level_batch=level, leaf_convert=leaf_convert)
    roots = all_gather(local.root_row(), mesh, axis_name)
    return ShardedMerkleTree(mesh, axis_name, local, _fold_top(level, roots), level)


def sharded_merkle_build_prove_all(
    leaf_hash_batch: Callable,
    compress_batch: Callable,
    leaves: torch.Tensor,
    mesh,
    axis_name: str = "data",
    leaf_convert: Callable = _identity,
    compress_level_batch: Callable | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Build the tree from this rank's shard and produce the auth path of
    every leaf in it.  Returns (root, leaf_sib, auth): the root row,
    replicated and bit-equal to the single-device ``DeviceMerkleTree``
    build; leaf_sib (n_local, D) and auth (n_local, height-2, D, root first)
    for this rank's leaves, equal to the single-device ``proof_rows`` of
    leaves ``[r * n_local, (r + 1) * n_local)``."""
    tree = sharded_merkle_tree(leaf_hash_batch, compress_batch, leaves, mesh, axis_name,
                               leaf_convert, compress_level_batch)
    return (tree.root_row, *tree.local_proof_rows())


def sharded_permute_batch(config, states: torch.Tensor, mesh, axis_name: str = "data") -> torch.Tensor:
    """Data-parallel Poseidon permutation of this rank's independent states
    (B_local, t, W) with no communication (the multi-device twin of the
    headline bench.py workload): kernel ``poseidon_permute`` on CUDA
    states, its plain version on CPU ones.  The JAX twin takes the
    permutation as a callable for its representation; the port has one."""
    shard_of(mesh, axis_name)
    return permute(config, states)


def sharded_multipath_verify_rows(
    compress_batch: Callable,
    leaf_convert: Callable,
    root_row: torch.Tensor,
    leaf_digests: torch.Tensor,
    indexes,
    leaf_sib: torch.Tensor,
    auth: torch.Tensor,
    mesh,
    axis_name: str = "data",
) -> torch.Tensor:
    """Sharded twin of ``DeviceMerkleTree.multipath_verify_rows`` (the
    deduplicated MultiPath verify, reference mod.rs:272-330).  Every input
    is replicated, as in JAX: each rank passes the same rows and distinct
    host ``indexes``.  The host plan of each level is the single-device
    one; the level's distinct compressions are split into D equal chunks
    (the last padded with copies of the first pair), each rank compresses
    its chunk, and one all-gather re-replicates them.  Returns the verdict,
    a scalar bool tensor, on every rank."""
    rank, size, _ = shard_of(mesh, axis_name)
    dev = leaf_digests.device
    auth = torch.as_tensor(auth, device=dev)
    n_levels = int(auth.shape[1])
    schedule = _multipath_schedule(tuple(int(i) for i in indexes), n_levels)
    cur = leaf_convert(leaf_digests)
    sib0 = leaf_convert(torch.as_tensor(leaf_sib, device=dev))
    for li, (k_prev, src) in enumerate(schedule):
        rows = sib0 if li == 0 else auth[:, n_levels - li]
        both = torch.cat([cur[:k_prev], rows], dim=0).index_select(0, torch.from_numpy(src).to(dev))
        k = src.shape[0] // 2
        chunk = -(-k // size)
        lo, hi = rank * chunk, min((rank + 1) * chunk, k)
        # a rank past the last pair compresses copies of the first one, so
        # that every rank sends a chunk of the same size
        pick = torch.arange(lo, lo + chunk, device=dev)
        pick = torch.where(pick < hi, pick, 0)
        part = compress_batch(both[:k].index_select(0, pick), both[k:].index_select(0, pick))
        cur = all_gather(part, mesh, axis_name).flatten(0, 1)[:k]
    return (cur[0] == torch.as_tensor(root_row, device=dev)).all()
