"""A log-round folding argument on the PyTorch port's curve tier: an
IPA-style Pedersen opening proof.

The twin of ``ipa_folding.py``.  The reference ships vector Pedersen
commitments (src/commitment/pedersen/mod.rs:62-105) and the sponge and
Fiat-Shamir layer (src/sponge/mod.rs:101-154) but no protocol composing
them; this runs the composition end to end: B instances of ``C = <a, G>``
proven on the device (the cross commitments L and R as grouped MSMs,
kernel ``msm_te``; challenges from the Poseidon transcript, kernel
``poseidon_permute``; scalar and generator tables folded on the device),
then checked by the independent python-int verifier, which also rejects a
forged folded scalar.

Run: python examples/torch_ipa_folding.py [--device cpu]
"""

import argparse
import os
import random
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.models.protocols.ipa_fold import ipa_fold_prove, ipa_fold_verify_host
from crypto_primitives_tpu_torch.models.sponge import get_default_poseidon_parameters
from crypto_primitives_tpu_torch.ops.curves_known import JUBJUB
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR


def main(device):
    rng = random.Random(7)
    cfg = get_default_poseidon_parameters(FR, 2, False)
    B, n = 2, 4  # two instances over 4 generators (2 folding rounds)
    gens = [JUBJUB.rand_point(rng) for _ in range(n)]
    scalars = [[rng.randrange(JUBJUB.scalar.p) for _ in range(n)] for _ in range(B)]

    proof = ipa_fold_prove(JUBJUB, cfg, gens, scalars, device=device)
    print(f"proved {B} openings of <a, G> over {n} generators ({n.bit_length() - 1} folding rounds) on {device}")

    p_s = JUBJUB.scalar.p
    for b in range(B):
        rounds_b = [(tuple(int(v) for v in proof["rounds"][j][0][b]), tuple(int(v) for v in proof["rounds"][j][1][b]))
                    for j in range(len(proof["rounds"]))]
        C_b, a_b = proof["commitment"][b], proof["a_star"][b]
        assert ipa_fold_verify_host(JUBJUB, cfg, gens, C_b, rounds_b, a_b)
        assert not ipa_fold_verify_host(JUBJUB, cfg, gens, C_b, rounds_b, (a_b + 1) % p_s)
    print(f"host verifier accepted all {B} transcripts; forged folded scalars rejected")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="The IPA folding argument on the PyTorch port.")
    ap.add_argument("--device", default=None, help="the device to run on (default: cuda)")
    device = resolve_device(ap.parse_args().device)
    main(device)
    print(f"{os.path.basename(__file__)}: {time.perf_counter() - T0:.2f} s on {device}")
