"""Quickstart on the PyTorch port: the Poseidon sponge, host tier and
batched tier.

The twin of ``quickstart_sponge.py``.  The host ``PoseidonSponge`` is the
exact python-int oracle (the reference's ``PoseidonSponge<F>``,
src/sponge/poseidon/mod.rs:124-186); ``PoseidonSpongeBatch`` runs B
independent sponges on the card, each permutation one launch of the
``poseidon_permute`` kernel (its plain PyTorch version on the CPU).  Every
lane's squeezes equal its own host oracle's.

Run: python examples/torch_quickstart_sponge.py [--device cpu]
"""

import argparse
import os
import random
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.models.sponge import (
    PoseidonSponge,
    PoseidonSpongeBatch,
    get_default_poseidon_parameters,
)
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR


def main(device):
    rng = random.Random(0)
    cfg = get_default_poseidon_parameters(FR, 2, False)  # rate 2, x^17 S-box

    # -- host tier: one sponge, exact ints ------------------------------
    s = PoseidonSponge(cfg)
    s.absorb_elements([rng.randrange(FR.p) for _ in range(4)])
    fields = s.squeeze_native_field_elements(2)
    tail = s.squeeze_bytes(16)
    print(f"host squeeze: {fields[0] % 10**8:08d}... + {tail.hex()[:16]}...")

    # -- batched tier: B sponges on the device --------------------------
    B = 4
    rows = [[rng.randrange(FR.p) for _ in range(4)] for _ in range(B)]
    dev = PoseidonSpongeBatch(cfg, batch_shape=(B,), device=device)
    dev.absorb(torch.from_numpy(FR.pack(rows)).to(device))
    dev_fields = dev.squeeze_native_field_elements(2)  # (B, 2, W) Montgomery words
    dev_bytes = dev.squeeze_bytes(16).cpu().numpy()  # (B, 16) uint8

    # parity: every lane equals its own host oracle
    for i in range(B):
        h = PoseidonSponge(cfg)
        h.absorb_elements(rows[i])
        want = h.squeeze_native_field_elements(2)
        got = [int(v) for v in FR.unpack(dev_fields[i].cpu())]
        assert got == want, (i, got, want)
        assert bytes(dev_bytes[i]) == h.squeeze_bytes(16)
    print(f"batched tier on {device}: {B} lanes bit-equal to the host oracle")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="The Poseidon sponge on the PyTorch port.")
    ap.add_argument("--device", default=None, help="the device to run on (default: cuda)")
    device = resolve_device(ap.parse_args().device)
    main(device)
    print(f"{os.path.basename(__file__)}: {time.perf_counter() - T0:.2f} s on {device}")
