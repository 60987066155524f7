"""Signatures, encryption, commitments and the PRF on the PyTorch port.

The twin of ``sign_encrypt_commit.py``: one tour through the reference's
``signature``, ``encryption``, ``commitment`` and ``prf`` modules
(src/signature/schnorr/mod.rs, src/encryption/elgamal/mod.rs,
src/commitment/pedersen/mod.rs, src/prf/blake2s/mod.rs) on the JubJub
curve.  Single-op calls run on the exact python-int host tier; each scheme's
batched twin then runs the same call on the device (the grouped-MSM kernel
``msm_te`` under the curve paths) and must agree with it.

Run: python examples/torch_sign_encrypt_commit.py [--device cpu]
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
from crypto_primitives_tpu_torch.models.commitment.pedersen import PedersenCommitment
from crypto_primitives_tpu_torch.models.crh.pedersen import Window
from crypto_primitives_tpu_torch.models.encryption.elgamal import ElGamal
from crypto_primitives_tpu_torch.models.prf.blake2s import Blake2sPRF
from crypto_primitives_tpu_torch.models.signature.schnorr import Schnorr
from crypto_primitives_tpu_torch.ops.curves_known import JUBJUB


def main(device):
    rng = random.Random(42)

    # -- Schnorr signatures (randomizable, like the reference's) --------
    sch = Schnorr(JUBJUB)
    params = sch.setup(rng)
    pk, sk = sch.keygen(params, rng)
    msg = b"hello tpu"
    sig = sch.sign(params, sk, msg, rng)
    assert sch.verify(params, pk, msg, sig)
    assert not sch.verify(params, pk, b"tampered", sig)
    rand = rng.randbytes(32)
    pk_r = sch.randomize_public_key(params, pk, rand)
    sig_r = sch.randomize_signature(params, sig, rand)
    assert sch.verify(params, pk_r, msg, sig_r)
    assert sch.verify_batch(params, [pk, pk, pk_r], [msg, b"tampered", msg], [sig, sig, sig_r],
                            device=device) == [True, False, True]
    print(f"schnorr: sign/verify ok, tamper rejected, randomization verifies; verify_batch on {device} agrees")

    # -- ElGamal encryption over curve points ---------------------------
    eg = ElGamal(JUBJUB)
    eparams = eg.setup(rng)
    epk, esk = eg.keygen(eparams, rng)
    message = JUBJUB.scalar_mul_host(JUBJUB.generator, rng.randrange(1, JUBJUB.scalar.p))
    r = eg.rand_randomness(rng)
    ct = eg.encrypt(eparams, epk, message, r)
    assert eg.decrypt(eparams, esk, ct) == message
    assert eg.encrypt_batch(eparams, epk, [message], [r], device=device) == [ct]
    print(f"elgamal: point message round-trips through encrypt/decrypt; encrypt_batch on {device} agrees")

    # -- Pedersen commitment (binding + hiding) --------------------------
    pc = PedersenCommitment(JUBJUB, Window(4, 192))  # up to 96-byte input
    cparams = pc.setup(rng)
    data = b"commit to this"
    r = pc.rand_randomness(rng)
    c = pc.commit(cparams, data, r)
    assert pc.commit(cparams, data, r) == c  # deterministic reopen
    assert pc.commit(cparams, data, pc.rand_randomness(rng)) != c  # hiding
    rows = pc.commit_batch(cparams, torch.tensor([list(data)], dtype=torch.uint8, device=device),
                           torch.from_numpy(pc.randomness_to_bits([r])).to(device), device=device)
    x, y = JUBJUB.base.unpack(rows[0].cpu())
    assert (int(x), int(y)) == c
    print(f"pedersen commitment: ({c[0] % 10**8:08d}..., ...) reopens correctly; commit_batch on {device} agrees")

    # -- Blake2s PRF -----------------------------------------------------
    out = Blake2sPRF.evaluate(bytes(32), b"\x01" * 32)
    batch = Blake2sPRF.evaluate_batch(np.zeros((1, 32), np.uint8), np.ones((1, 32), np.uint8), device=device)
    assert bytes(batch[0].cpu().numpy()) == out
    print(f"blake2s prf: {out.hex()[:16]}...; evaluate_batch on {device} agrees")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="The scheme families on the PyTorch port.")
    ap.add_argument("--device", default=None, help="the device to run on (default: cuda)")
    device = resolve_device(ap.parse_args().device)
    main(device)
    print(f"{os.path.basename(__file__)}: {time.perf_counter() - T0:.2f} s on {device}")
