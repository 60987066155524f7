"""``sha256_merkle_2p20``: the program's SHA-256 byte tree and the plain
reference beside it.

``Program`` drives the port's public entry points (``sha256_device_tree``,
``sha256_tree_fns``, ``DeviceMerkleTree.proof_rows`` and
``verify_rows_batch``); ``Reference`` hashes with ``hashlib``.  Leaves are
the benchmark's: uniform bytes made on the device from a seed.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness.tree import TreeProgram
from portbench.reference import merkle_ref


def make_leaves(cfg: dict, seed: int, n: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n, cfg["leaf_bytes"]), dtype=torch.uint8, device=device, generator=g)


def kernel_calls(cfg: dict, op: str, rows: int) -> list:
    """The kernel calls that hashing ``rows`` rows of ``op`` (``leaf``,
    ``node_bottom``, ``node``) makes, with the shapes their least times need."""
    digest = cfg["digest_bytes"]
    msg = {"leaf": cfg["leaf_bytes"], "node_bottom": 2 * (8 + digest), "node": 2 * digest}[op]
    return [("k3_sha256", {"batch": rows, "msg_bytes": msg})]


class Program(TreeProgram):
    def __init__(self, cfg: dict, device):
        from crypto_primitives_tpu_torch.models.merkle_tree.device import sha256_device_tree, sha256_tree_fns
        from crypto_primitives_tpu_torch.ops import sha256_kernel

        device = torch.device(device)
        self._build = lambda raw: sha256_device_tree(raw, device=device)
        self._leaf_hash = sha256_tree_fns()[0]
        self._kernel = sha256_kernel


class Reference:
    """``control`` breaks the guarantee that every leaf is hashed."""

    def __init__(self, cfg: dict, device, control: bool = False):
        self.scheme = merkle_ref.Sha256Scheme(skip_leaf_hash=control)

    def inputs(self, raw: torch.Tensor) -> np.ndarray:
        return raw.cpu().numpy()

    def root_value(self, levels) -> bytes:
        return bytes(levels[-1][0])

    def row_value(self, row) -> bytes:
        return bytes(np.asarray(row, dtype=np.uint8))

    def value_row(self, value: bytes) -> np.ndarray:
        return np.frombuffer(value, dtype=np.uint8).copy()
