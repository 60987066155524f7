"""The sharded Merkle root over any ``MerkleTreeConfig``.

Twin of ``crypto_primitives_tpu/parallel/merkle.py``.  The reference builds
each level with rayon across one host's cores
(src/merkle_tree/mod.rs:441-515); here the leaves are sharded across the
mesh, every rank builds its subtree root with no communication, the D
subtree roots ride one all-gather, and every rank folds the top log2(D)
levels the same way.  The scheme is taken through the config's interface
(``leaf_hash.evaluate_batch``, ``two_to_one_hash.evaluate_batch`` and
``compress_batch``, ``leaf_inner_converter.convert_batch``), in the digest
chain of ``MerkleTree.new``, so the root is bit-equal to it.

SPMD form: each rank passes its shard of the leaves, rows
``[r * n_local, (r + 1) * n_local)``, and gets the root, replicated.
"""

from __future__ import annotations

import torch

from crypto_primitives_tpu_torch.parallel.merkle_tree_sharded import _check_shards, _halves
from crypto_primitives_tpu_torch.parallel.mesh import all_gather, shard_of


def sharded_merkle_root(config, leaf_hash_param, two_to_one_param, leaves: torch.Tensor, mesh,
                        axis_name: str = "data") -> torch.Tensor:
    """The root digest row of the tree over every rank's ``leaves`` (this
    rank's shard: (n_local, ...) leaf-hash inputs on its device, n_local a
    power of two >= 2, the same on every rank); replicated."""
    _, size, _ = shard_of(mesh, axis_name)
    _check_shards(int(leaves.shape[0]), size)
    two, conv, dev = config.two_to_one_hash, config.leaf_inner_converter, leaves.device
    digests = config.leaf_hash.evaluate_batch(leaf_hash_param, leaves, device=dev)
    left, right = _halves(digests)
    cur = two.evaluate_batch(two_to_one_param, conv.convert_batch(left), conv.convert_batch(right), device=dev)
    while cur.shape[0] > 1:
        cur = two.compress_batch(two_to_one_param, *_halves(cur), device=dev)
    roots = all_gather(cur[0], mesh, axis_name)
    while roots.shape[0] > 1:
        roots = two.compress_batch(two_to_one_param, *_halves(roots), device=dev)
    return roots[0]
