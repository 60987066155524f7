"""``batch_hash``: a prover or indexer hashes batches of fresh records into
digests, one batch after another.

Set-up runs the program's ``setup`` from the seed.  A closed loop with one
caller: each job takes ``batch`` fresh records of the configuration's
``input_bytes`` uniform bytes, made on the device from (seed, job index),
hashes them with the program and reads the (batch, 2, W) digests to the
host.  After the window ``check_jobs`` jobs, drawn from the seed, are hashed
again by the plain reference from the program's window bases and the same
inputs: every digest must equal its reference's, bit for bit.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from portbench.harness.seeds import derive

UNIT = "hashes"


class Traffic:
    def __init__(self, mix: dict, cfg: dict, cfgmod, program, seed: int, device, scale: dict):
        self.cfg, self.cfgmod, self.program = cfg, cfgmod, program
        self.seed, self.device = seed, torch.device(device)
        self.batch = scale.get("batch", mix["batch"])
        self.check_jobs = scale.get("check_jobs", mix["check_jobs"])
        self.units_per_job = self.batch

    def setup(self, spans) -> None:
        self.program.setup(derive(self.seed, "params"))
        self.bases = self.program.bases()

    def inputs(self, i: int):
        return self.cfgmod.make_inputs(self.cfg, derive(self.seed, "inputs", i), self.batch, self.device)

    def job(self, inputs, spans):
        digests = self.program.hash(inputs)
        with spans("host.digests"):
            return self.program.to_host(digests)

    def ops_per_job(self) -> list:
        return [("hash", self.batch)]

    def release(self) -> None:
        self.program.release()

    def check(self, results: dict, reference) -> dict:
        """{name: (value, limit)}: digests of the sampled jobs that differ
        from the reference's in any word."""
        done = sorted(results)
        sample = random.Random(derive(self.seed, "check")).sample(done, min(self.check_jobs, len(done)))
        wrong = checked = 0
        for i in sample:
            want = reference.digests(self.bases, self.inputs(i))
            got = np.asarray(results[i])
            if got.shape == want.shape:
                wrong += int((got != want).reshape(len(want), -1).any(axis=1).sum())
            else:
                wrong += len(want)
            checked += len(want)
        return {"digests_wrong": (wrong, 0), "digests_checked": (checked, None)}
