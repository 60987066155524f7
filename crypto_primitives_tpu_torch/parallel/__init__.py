"""Multi-device parallelism over ``torch.distributed``: the mesh, sharded
Merkle trees, the data-parallel permutation and the sharded fixed-base MSM.

Twin of ``crypto_primitives_tpu/parallel``.  The reference's only
parallelism is rayon on one host (SURVEY.md §2.10); the JAX package shards
with ``shard_map`` over a device mesh, one controller for every device.  The
port runs one process per device (SPMD): each rank passes its own shard and
gets back the replicated results whole and its own rows of the per-row
ones, with NCCL between cards and gloo between CPU processes.
"""

from crypto_primitives_tpu_torch.parallel.merkle import sharded_merkle_root
from crypto_primitives_tpu_torch.parallel.merkle_tree_sharded import (
    ShardedMerkleTree,
    sharded_merkle_build_prove_all,
    sharded_merkle_tree,
    sharded_multipath_verify_rows,
    sharded_permute_batch,
)
from crypto_primitives_tpu_torch.parallel.mesh import make_mesh
from crypto_primitives_tpu_torch.parallel.msm import sharded_fixed_base_msm, sharded_fixed_base_msm_sw

__all__ = [
    "ShardedMerkleTree", "make_mesh", "sharded_fixed_base_msm", "sharded_fixed_base_msm_sw",
    "sharded_merkle_build_prove_all", "sharded_merkle_root", "sharded_merkle_tree",
    "sharded_multipath_verify_rows", "sharded_permute_batch",
]
