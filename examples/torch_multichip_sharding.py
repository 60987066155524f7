"""Multi-device scaling on the PyTorch port: a Merkle build and every
leaf's proof over ``torch.distributed``.

The twin of ``multichip_sharding.py``.  The reference parallelises tree
builds with rayon threads (src/merkle_tree/mod.rs:441-515); the JAX package
shards one program over a device mesh.  Here one process per device (SPMD)
hashes its N/D leaves, builds its subtree (one ``sha256_compress`` launch a
level on a card), and exchanges exactly D digest rows (one all-gather) to
fold the top.  Every rank holds the root and its own leaves' auth paths
against the single-device ``sha256_device_tree``, so the run checks the
root and every path.

``--world-size`` ranks are spawned: over gloo on the CPU, or over NCCL with
one rank per visible card (the default on CUDA is every visible card).

Run: python examples/torch_multichip_sharding.py [--device cpu] [--world-size D]
"""

import argparse
import os
import sys
import time
import tempfile

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.models.merkle_tree.device import sha256_device_tree, sha256_tree_fns
from crypto_primitives_tpu_torch.parallel import make_mesh, sharded_merkle_build_prove_all

N_LEAVES = 128


def rank_main(rank, world, device_type, store):
    if device_type == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: the ranks meet on loopback
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank, world_size=world,
                                device_id=dev)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        leaves = np.random.default_rng(5).integers(0, 256, size=(N_LEAVES, 16), dtype=np.uint8)
        n_local = N_LEAVES // world
        mine = slice(rank * n_local, (rank + 1) * n_local)
        mesh = make_mesh(world, device_type=device_type)  # a 1-D "data" axis over every rank
        leaf_hash, compress, level, convert = sha256_tree_fns()
        root, leaf_sib, auth = sharded_merkle_build_prove_all(
            leaf_hash, compress, torch.from_numpy(leaves[mine]).to(dev), mesh, leaf_convert=convert,
            compress_level_batch=level)

        # bit-equality against the single-device tree: the root, and the
        # auth path of every leaf of this rank's shard
        single = sha256_device_tree(leaves, device=dev)
        sib1, auth1 = single.proof_rows(torch.arange(N_LEAVES, device=dev)[mine])
        assert bytes(root.cpu().numpy()) == single.root()
        assert torch.equal(leaf_sib, sib1) and torch.equal(auth, auth1)
        if rank == 0:
            print(f"built a 2^{N_LEAVES.bit_length() - 1}-leaf tree over {world} {device_type} ranks; "
                  f"root {bytes(root.cpu().numpy()).hex()[:16]}...", flush=True)
    finally:
        dist.destroy_process_group()


def main(device, world):
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"{world} ranks need {world} cards, {torch.cuda.device_count()} are visible")
    if N_LEAVES % world or N_LEAVES // world < 2:
        raise ValueError(f"{N_LEAVES} leaves do not split over {world} ranks")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(world, device.type, os.path.join(tmp, "store")), nprocs=world)
    print(f"sharded root + all {N_LEAVES} auth paths bit-equal to the single-device tree")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="A sharded Merkle tree on the PyTorch port.")
    ap.add_argument("--device", default=None, help="the device type to run on (default: cuda)")
    ap.add_argument("--world-size", type=int, default=None,
                    help="ranks to spawn (default: every visible card on CUDA, 4 on the CPU)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    main(device, args.world_size or (torch.cuda.device_count() if device.type == "cuda" else 4))
    print(f"{os.path.basename(__file__)}: {time.perf_counter() - T0:.2f} s on {device}")
