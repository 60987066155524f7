"""``tree_paths``: a verifier checks batches of membership proofs against a
committed root.

Set-up builds the program's tree over ``num_leaves`` leaves made from the
seed.  A closed loop with one caller: each job draws ``batch`` leaf indexes
uniformly with replacement from (seed, job index), takes their raw leaves
and, for ``batch / tamper_every`` of them drawn the same way, the leaf half
the tree away instead; it hashes them with the tree's leaf hash, gathers
their proofs (``proof_rows``), verifies them against the root
(``verify_rows_batch``) and reads the verdicts to the host.  A tampered
proof must come back false.  After the window the plain reference builds its
own tree over the same leaves, whose root must equal the program's, and
verifies a sample of the jobs, drawn from the seed, from the same indexes and
leaves: every verdict must equal its reference's.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from portbench.harness.seeds import derive
from portbench.reference import merkle_ref

UNIT = "proofs"


class Traffic:
    def __init__(self, mix: dict, cfg: dict, cfgmod, program, seed: int, device, scale: dict):
        self.cfg, self.cfgmod, self.program = cfg, cfgmod, program
        self.seed, self.device = seed, torch.device(device)
        self.n = scale.get("num_leaves", cfg["num_leaves"])
        self.batch = scale.get("batch", mix["batch"])
        self.tampered = self.batch // mix["tamper_every"]
        self.check_jobs = scale.get("check_jobs", mix["check_jobs"])
        self.units_per_job = self.batch
        self.height = self.n.bit_length()  # levels with the leaves and the root

    def setup(self, spans) -> None:
        self.leaves = self.cfgmod.make_leaves(self.cfg, derive(self.seed, "tree"), self.n, self.device)
        with spans("tree.build"):
            self.tree = self.program.build(self.leaves)
        with spans("host.root"):
            self.root_row = self.program.root(self.tree)

    def inputs(self, i: int):
        g = torch.Generator(device=self.device).manual_seed(derive(self.seed, "paths", i))
        idx = torch.randint(0, self.n, (self.batch,), dtype=torch.int64, device=self.device, generator=g)
        swap = torch.randperm(self.batch, device=self.device, generator=g)[: self.tampered]
        src = idx.clone()
        src[swap] = (idx[swap] + self.n // 2) % self.n
        return idx, self.leaves.index_select(0, src)

    def job(self, inputs, spans):
        idx, raw = inputs
        with spans("tree.leaf_hash"):
            digests = self.program.leaf_hash(self.tree, raw)
        with spans("tree.proof_rows"):
            sib, auth = self.program.proof_rows(self.tree, idx)
        with spans("tree.verify"):
            ok = self.program.verify(self.tree, digests, idx, sib, auth)
        with spans("host.verdicts"):
            return self.program.to_host(ok)

    def ops_per_job(self) -> list:
        """(op, rows): the leaf hash, then one compression a level."""
        return [("leaf", self.batch), ("node_bottom", self.batch)] + [("node", self.batch)] * (self.height - 2)

    def release(self) -> None:
        del self.tree

    def check(self, results: dict, reference) -> dict:
        """{name: (value, limit)}: the set-up root against the reference's,
        and the sampled jobs' verdicts against the reference's."""
        levels = merkle_ref.build(reference.scheme, reference.inputs(self.leaves))
        roots_wrong = int(reference.row_value(self.root_row) != reference.root_value(levels))
        done = sorted(results)
        sample = random.Random(derive(self.seed, "check")).sample(done, min(self.check_jobs, len(done)))
        idx, raw = zip(*(self.inputs(i) for i in sample))
        want = merkle_ref.verify(reference.scheme, levels, reference.inputs(torch.cat(raw)),
                                 torch.cat(idx).cpu().numpy())
        got = np.concatenate([np.asarray(results[i], dtype=bool) for i in sample])
        return {"roots_wrong": (roots_wrong, 0), "verdicts_wrong": (int((got != want).sum()), 0),
                "verdicts_checked": (int(got.size), None), "rejections_expected": (int((~want).sum()), None)}
