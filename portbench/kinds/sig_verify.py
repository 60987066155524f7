"""``sig_verify``: a verifier checks batches of signatures on messages, each
under its signer's key.

Set-up runs the program's ``setup`` from the seed, then builds a pool of
``pool`` keypairs, one uniform message of the configuration's
``message_bytes`` each (from the seed), and signs every message under its
key (``keys_and_signatures``).  A closed loop with one caller: each job
draws ``batch`` pool rows uniformly with replacement from (seed, job index)
and tampers with a seeded ``batch / tamper_every`` of them, in turn one
message byte changed, s replaced by s + 1 mod r, and the key of another
pool row; the program verifies the batch and hands the verdicts to the host.
A tampered row must come back false and every other row true.  After the
window ``check_jobs`` jobs, drawn from the seed, are verified again by the
plain reference from the same generator, salt and rows: every verdict must
equal the reference's, and the reference's must be the traffic's intent,
so a fault in signing cannot hide.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

from portbench.harness.seeds import derive

UNIT = "signatures"


class Traffic:
    def __init__(self, mix: dict, cfg: dict, cfgmod, program, seed: int, device, scale: dict):
        self.cfg, self.cfgmod, self.program = cfg, cfgmod, program
        self.seed, self.device = seed, torch.device(device)
        self.batch = scale.get("batch", mix["batch"])
        self.pool = mix["pool"] * self.batch // mix["batch"]  # a smaller batch, a pool as much smaller
        if self.pool < 2:
            raise ValueError(f"a pool of {self.pool} rows has no other row's key to tamper with")
        self.tampered = self.batch // mix["tamper_every"]
        self.check_jobs = scale.get("check_jobs", mix["check_jobs"])
        self.units_per_job = self.batch
        self.r = int(cfg["subgroup_order"])

    def setup(self, spans) -> None:
        self.program.setup(derive(self.seed, "params"))
        self.public = self.program.public()
        n = self.cfg["message_bytes"]
        raw = random.Random(derive(self.seed, "messages")).randbytes(self.pool * n)
        self.messages = [raw[k * n:(k + 1) * n] for k in range(self.pool)]
        with spans("traffic.pool"):
            self.pks, self.sigs = self.program.keys_and_signatures(derive(self.seed, "keys"), self.messages)

    def inputs(self, i: int):
        """(keys, messages, signatures, the tampered rows in order)."""
        rng = random.Random(derive(self.seed, "rows", i))
        idx = rng.choices(range(self.pool), k=self.batch)
        tampered = sorted(rng.sample(range(self.batch), self.tampered))
        pks = [self.pks[j] for j in idx]
        messages = [self.messages[j] for j in idx]
        sigs = [self.sigs[j] for j in idx]
        for k, row in enumerate(tampered):
            if k % 3 == 0:
                m = bytearray(messages[row])
                m[rng.randrange(len(m))] ^= rng.randrange(1, 256)
                messages[row] = bytes(m)
            elif k % 3 == 1:
                s = sigs[row].prover_response
                sigs[row] = dataclasses.replace(sigs[row], prover_response=(s + 1) % self.r)
            else:
                pks[row] = self.pks[(idx[row] + rng.randrange(1, self.pool)) % self.pool]
        return pks, messages, sigs, tampered

    def job(self, inputs, spans):
        pks, messages, sigs, _ = inputs
        with spans("host.verdicts"):
            return self.program.verify((pks, messages, sigs))

    def ops_per_job(self) -> list:
        return [("verify", self.batch)]

    def release(self) -> None:
        self.program.release()

    def check(self, results: dict, reference) -> dict:
        """{name: (value, limit)}: the sampled jobs' verdicts against the
        reference's, and the reference's against the traffic's intent."""
        done = sorted(results)
        sample = random.Random(derive(self.seed, "check")).sample(done, min(self.check_jobs, len(done)))
        wrong = intent_wrong = checked = 0
        for i in sample:
            pks, messages, sigs, tampered = self.inputs(i)
            want = reference.verdicts(self.public, (pks, messages, sigs))
            got = np.asarray(results[i], dtype=bool)
            wrong += int((got != want).sum()) if got.shape == want.shape else len(want)
            intent = np.ones(len(want), dtype=bool)
            intent[tampered] = False
            intent_wrong += int((want != intent).sum())
            checked += len(want)
        return {"verdicts_wrong": (wrong, 0), "intent_wrong": (intent_wrong, 0), "verdicts_checked": (checked, None)}
