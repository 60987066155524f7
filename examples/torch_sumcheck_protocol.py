"""A full interactive-oracle protocol on the PyTorch port: sumcheck.

The twin of ``sumcheck_protocol.py`` (what the sponge module exists for
downstream: the reference's ``CryptographicSponge`` powers Fiat-Shamir,
src/sponge/mod.rs:101-154): a batched multilinear sumcheck whose prover runs
on the device on Montgomery words, with a Poseidon transcript (each
challenge one launch of the ``poseidon_permute`` kernel): claimed sums
absorbed, challenges squeezed, rounds folded.  Its transcript equals the
exact python-int host prover's, the host verifier accepts it, and rejects a
forged claimed sum.  (The JAX twin keeps its transcript on RNS residues; the
port has one representation, words.)

Run: python examples/torch_sumcheck_protocol.py [--device cpu]
"""

import argparse
import os
import random
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.models.protocols.sumcheck import (
    sumcheck_prove,
    sumcheck_prove_host,
    sumcheck_verify_host,
)
from crypto_primitives_tpu_torch.models.sponge import get_default_poseidon_parameters
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR


def ints(rows):
    return [int(v) for v in FR.unpack(rows.cpu())]


def main(device):
    rng = random.Random(3)
    cfg = get_default_poseidon_parameters(FR, 2, False)
    B, m = 2, 3  # two instances over {0,1}^3, proven in parallel

    table = np.asarray([[rng.randrange(FR.p) for _ in range(1 << m)] for _ in range(B)], dtype=object)

    # device prover: the transcript stays on the device, in words
    s_row, rounds, final_row = sumcheck_prove(cfg, torch.from_numpy(FR.pack(table)), device=device)

    # host oracle twin: exact ints, the same transcript schedule
    sums, rounds_h, chals, finals = sumcheck_prove_host(cfg, table)

    s_dev, fin_dev = ints(s_row), ints(final_row)
    assert s_dev == list(sums) and fin_dev == list(finals)
    print(f"claimed sums match across tiers: {[s % 10**8 for s in s_dev]}...")

    # the host verifier accepts the device prover's transcript...
    per_instance_msgs = []
    for b in range(B):
        msgs = [(ints(p0)[b], ints(p1)[b]) for p0, p1 in rounds]
        per_instance_msgs.append(msgs)
        assert sumcheck_verify_host(cfg, s_dev[b], msgs, fin_dev[b])
    # ...and rejects a forged claimed sum against that same instance's own
    # round messages and final value (soundness via Fiat-Shamir)
    assert not sumcheck_verify_host(cfg, (s_dev[0] + 1) % FR.p, per_instance_msgs[0], fin_dev[0])
    print(f"{B} sumcheck transcripts from {device} verified; forged claim rejected")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="The sumcheck protocol on the PyTorch port.")
    ap.add_argument("--device", default=None, help="the device to run on (default: cuda)")
    device = resolve_device(ap.parse_args().device)
    main(device)
    print(f"{os.path.basename(__file__)}: {time.perf_counter() - T0:.2f} s on {device}")
