"""ElGamal encryption of curve points.

Twin of ``crypto_primitives_tpu/models/encryption/elgamal.py`` (the
reference's src/encryption/elgamal/mod.rs): pk = sk G;
Enc(m; r) = (r G, m + r pk) (mod.rs:65-81); Dec(c1, c2) = c2 - sk c1
(mod.rs:83-99).  The plaintext is a curve point (``None``, the identity, on a
short-Weierstrass curve).

Two tiers:
  * host: the scheme in Python ints, the oracle;
  * batched: ``encrypt_batch`` / ``decrypt_batch`` on ``device`` (``None``
    means CUDA), with the JAX package's dispatch: r G is always a fixed-base
    product (kernel ``msm_te`` or ``msm_sw`` on the card); r pk is one too
    from 32 messages up, where the recipient's table pays for its host
    precomputation, and the windowed variable-base product below (on a TE
    curve on the card one launch of A3, ``ops.windowed_kernel``; plain
    PyTorch otherwise); sk c1 is always windowed.  Each call takes its host
    points to the device in one pack (``pack_points_device``: on a TE curve
    on the card one launch of A4, ``ops.pack_kernel``).  Results are made
    affine on the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod

FIXED_BASE_PK_ROWS = 32  # from this batch size on, r pk takes a fixed-base table


@dataclasses.dataclass
class ElGamalParameters:
    generator: Tuple[int, int]


class ElGamal:
    def __init__(self, curve):
        # curve: a TECurveSpec or an SWCurveSpec
        self.curve = curve

    def setup(self, rng) -> ElGamalParameters:
        return ElGamalParameters(generator=self.curve.rand_point(rng))

    def keygen(self, params: ElGamalParameters, rng):
        sk = rng.randrange(self.curve.scalar.p)
        return self.curve.scalar_mul_host(params.generator, sk), sk

    def rand_randomness(self, rng) -> int:
        return rng.randrange(self.curve.scalar.p)

    def encrypt(self, params: ElGamalParameters, pk, message, randomness: int):
        s = self.curve.scalar_mul_host(pk, randomness)
        c1 = self.curve.scalar_mul_host(params.generator, randomness)
        return (c1, self.curve.add_host(message, s))

    def decrypt(self, params: ElGamalParameters, sk: int, ciphertext):
        c1, c2 = ciphertext
        return self.curve.add_host(c2, self.curve.neg_host(self.curve.scalar_mul_host(c1, sk)))

    # -- batched tier --

    def _points(self, pts, device: torch.device) -> torch.Tensor:
        return fast_mod(self.curve).pack_points_device(self.curve, pts, device)

    def encrypt_batch(self, params: ElGamalParameters, pk, messages: List, randomness: List[int],
                      device=None) -> List[Tuple]:
        """``encrypt`` for every (message, randomness) under one pk; returns
        the ciphertexts (c1, c2) as host points."""
        dev = resolve_device(device)
        mod = fast_mod(self.curve)
        B = len(messages)
        rbits = torch.from_numpy(mod.scalars_to_bits(self.curve, randomness)).to(dev)
        c1 = mod.fixed_base_mul(self.curve, params.generator, rbits)
        if B >= FIXED_BASE_PK_ROWS:
            s = mod.fixed_base_mul(self.curve, pk, rbits)
            msgs = self._points(list(messages), dev)
        else:
            # pk and the messages in one pack
            pts = self._points([tuple(pk)] + list(messages), dev)
            s = mod.scalar_mul_bits_windowed(self.curve, pts[0], rbits)
            msgs = pts[1:]
        c2 = mod.add(self.curve, msgs, s)
        both = mod.unpack_affine(self.curve, torch.stack([c1, c2], dim=1))
        return [(both[i, 0], both[i, 1]) for i in range(B)]

    def decrypt_batch(self, params: ElGamalParameters, sk: int, ciphertexts: List, device=None) -> List:
        """``decrypt`` for every ciphertext, as host points; sk c1 is the
        windowed product, so no MSM kernel runs."""
        dev = resolve_device(device)
        mod = fast_mod(self.curve)
        sk_bits = torch.from_numpy(mod.scalars_to_bits(self.curve, [sk] * len(ciphertexts))).to(dev)
        n = len(ciphertexts)
        pts = self._points([c[0] for c in ciphertexts] + [c[1] for c in ciphertexts], dev)  # c1s, then c2s
        s = mod.scalar_mul_bits_windowed(self.curve, pts[:n], sk_bits)
        return list(mod.unpack_affine(self.curve, mod.add(self.curve, pts[n:], mod.neg(self.curve, s))))
