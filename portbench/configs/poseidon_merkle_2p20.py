"""``poseidon_merkle_2p20``: the program's Poseidon field tree and the plain
reference beside it.

``Program`` drives the port's public entry points (``poseidon_device_tree``,
``poseidon_tree_fns``, ``DeviceMerkleTree.proof_rows`` and
``verify_rows_batch``) with ``get_default_poseidon_parameters``.
``Reference`` derives the round constants and the MDS matrix again from the
file's parameters and hashes in float64 digits (``reference/poseidon_ref``).
Leaves are the benchmark's: uniform 32-bit words made on the device from a
seed, the top word below the modulus's, read as Montgomery words (value
times 2^(32 W) mod p) as the program takes them.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness.tree import TreeProgram
from portbench.reference import grain, merkle_ref
from portbench.reference.poseidon_ref import Field64, Poseidon64


def make_leaves(cfg: dict, seed: int, n: int, device) -> torch.Tensor:
    W, p = cfg["num_words"], int(cfg["modulus"])
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randint(-(1 << 31), 1 << 31, (n, W), dtype=torch.int64, device=device, generator=g)
    top = p >> (32 * (W - 1))
    w[:, W - 1] = torch.randint(0, top, (n,), dtype=torch.int64, device=device, generator=g)
    return w.to(torch.int32)


def kernel_calls(cfg: dict, op: str, rows: int) -> list:
    """Every hash of the tree (leaf or node) is one permutation."""
    shape = {k: cfg[k] for k in ("num_words", "alpha", "full_rounds", "partial_rounds")}
    return [("k1_poseidon", {"batch": rows, "t": cfg["rate"] + cfg["capacity"], **shape})]


class Program(TreeProgram):
    def __init__(self, cfg: dict, device):
        from crypto_primitives_tpu_torch.models.merkle_tree.device import poseidon_device_tree, poseidon_tree_fns
        from crypto_primitives_tpu_torch.models.sponge.poseidon import get_default_poseidon_parameters
        from crypto_primitives_tpu_torch.ops import fields_known, poseidon_kernel

        spec = getattr(fields_known, cfg["field"].upper())
        pcfg = get_default_poseidon_parameters(spec, cfg["rate"], cfg["optimized_for_weights"])
        stated = (int(cfg["modulus"]), cfg["num_words"], cfg["capacity"], cfg["alpha"], cfg["full_rounds"],
                  cfg["partial_rounds"])
        got = (spec.p, spec.num_words, pcfg.capacity, pcfg.alpha, pcfg.full_rounds, pcfg.partial_rounds)
        if got != stated:
            raise ValueError(f"the program's default parameters {got} are not the configuration's {stated}")
        device = torch.device(device)
        self._build = lambda raw: poseidon_device_tree(spec, pcfg, raw, device=device)
        self._leaf_hash = poseidon_tree_fns(pcfg)[0]
        self._kernel = poseidon_kernel


class Reference:
    """``control`` breaks the guarantee that every leaf is hashed."""

    def __init__(self, cfg: dict, device, control: bool = False):
        p, t = int(cfg["modulus"]), cfg["rate"] + cfg["capacity"]
        ark, mds = grain.ark_and_mds(p, t, cfg["full_rounds"], cfg["partial_rounds"], cfg["skip_matrices"])
        self.p, self.W = p, cfg["num_words"]
        self.R = 1 << (32 * self.W)
        self.f = Field64(p, device)
        perm = Poseidon64(self.f, cfg["alpha"], cfg["full_rounds"], cfg["partial_rounds"], ark, mds)
        self.scheme = merkle_ref.PoseidonScheme(perm, skip_leaf_hash=control)
        self._r_inv = self.f.from_ints([pow(self.R, -1, p)])

    def inputs(self, raw: torch.Tensor) -> torch.Tensor:
        """Montgomery words -> the reference's digits of their values."""
        return self.f.mul(self.f.from_words(raw.to(self.f.device)), self._r_inv)

    def root_value(self, levels) -> int:
        return self.f.to_ints(levels[-1])[0]

    def row_value(self, row):
        """The value of a canonical Montgomery row; None for a row that is
        not canonical (its words at or above p)."""
        w = sum((int(x) & 0xFFFFFFFF) << (32 * j) for j, x in enumerate(np.asarray(row).reshape(-1)))
        return w * pow(self.R, -1, self.p) % self.p if w < self.p else None

    def value_row(self, value: int) -> np.ndarray:
        w = value * self.R % self.p
        return np.array([(w >> (32 * j)) & 0xFFFFFFFF for j in range(self.W)], dtype=np.uint32).view(np.int32)
