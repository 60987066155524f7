"""``tree_commit``: a prover commits to fresh leaves, one tree after another.

A closed loop with one caller.  Each job takes ``num_leaves`` fresh leaves,
made on the device from (seed, job index), builds the program's tree over
them and reads its root to the host.  Its result is the root row; after the
window a sample of the jobs, drawn from the seed, is built again by the
plain reference from the same leaves, and every root must equal its
reference's bit for bit.
"""

from __future__ import annotations

import random

import torch

from portbench.harness.seeds import derive
from portbench.reference import merkle_ref

UNIT = "leaves"


class Traffic:
    def __init__(self, mix: dict, cfg: dict, cfgmod, program, seed: int, device, scale: dict):
        self.cfg, self.cfgmod, self.program = cfg, cfgmod, program
        self.seed, self.device = seed, torch.device(device)
        self.n = scale.get("num_leaves", cfg["num_leaves"])
        self.check_jobs = scale.get("check_jobs", mix["check_jobs"])
        self.units_per_job = self.n

    def setup(self, spans) -> None:
        pass

    def inputs(self, i: int):
        return self.cfgmod.make_leaves(self.cfg, derive(self.seed, "commit", i), self.n, self.device)

    def job(self, leaves, spans):
        with spans("tree.build"):
            tree = self.program.build(leaves)
        with spans("host.root"):
            return self.program.root(tree)

    def ops_per_job(self) -> list:
        """(op, rows) of every hashed level of one job."""
        ops, rows = [("leaf", self.n)], self.n // 2
        ops.append(("node_bottom", rows))
        while rows > 1:
            rows //= 2
            ops.append(("node", rows))
        return ops

    def release(self) -> None:
        pass

    def check(self, results: dict, reference) -> dict:
        """{name: (value, limit)}: roots that differ from the reference's."""
        done = sorted(results)
        sample = random.Random(derive(self.seed, "check")).sample(done, min(self.check_jobs, len(done)))
        wrong = 0
        for i in sample:
            levels = merkle_ref.build(reference.scheme, reference.inputs(self.inputs(i)))
            wrong += reference.row_value(results[i]) != reference.root_value(levels)
            del levels
        return {"roots_wrong": (wrong, 0), "roots_checked": (len(sample), None)}
