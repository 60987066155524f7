"""Batched Fiat-Shamir transcripts over the Poseidon sponge.

Twin of ``crypto_primitives_tpu/models/sponge/fiat_shamir.py``: the
sponge-driven challenge flow that downstream protocols build on (the
reference's src/sponge/mod.rs:101-154: absorb public values, squeeze
challenges, repeat).  The JAX package keeps its transcript in RNS residues
(``FiatShamirRns``) so as not to convert at every absorb and squeeze; the port
has no RNS tier, and its sponge state is already the Montgomery words that the
field tier and the permutation kernel (``poseidon_permute``) work on, so
:class:`FiatShamir` absorbs and squeezes words with no conversion and no bound
bookkeeping.  Every permutation is one launch of the kernel on the card.

:func:`fold_argument` and :func:`fold_argument_host` are twin
implementations of an R-round random-linear-combination argument: per round
the prover absorbs a public commitment, squeezes a challenge c_r and folds
z <- z c_r + com_r; the final response is absorbed and a tag squeezed.  The
absorb and squeeze schedule is the JAX package's, so the challenges, tags and
responses equal the host oracle's.
"""

from __future__ import annotations

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.models.sponge.poseidon import PoseidonConfig, PoseidonSponge, PoseidonSpongeBatch
from crypto_primitives_tpu_torch.ops import field as ff


class FiatShamir:
    """A batch of transcripts (the twin of ``FiatShamirRns``): rows and
    challenges are ``(..., W)`` Montgomery words of the sponge's field, on
    ``device`` (``None`` means CUDA)."""

    def __init__(self, config: PoseidonConfig, batch_shape=(), device=None):
        self.sponge = PoseidonSpongeBatch(config, batch_shape, device=device)
        self.field = config.field

    def absorb(self, rows: torch.Tensor) -> None:
        """rows: (..., k, W) words."""
        self.sponge.absorb(rows)

    def challenge(self) -> torch.Tensor:
        """One squeezed challenge per transcript, (..., W)."""
        return self.sponge.squeeze_native_field_elements(1)[..., 0, :]

    def challenges(self, n: int) -> torch.Tensor:
        """(..., n, W)."""
        return self.sponge.squeeze_native_field_elements(n)

    def finalize(self, n: int = 1) -> torch.Tensor:
        """The closing squeeze, (..., n, W) (the JAX package returns limbs
        here, leaving its RNS tier; the port's words need no conversion)."""
        return self.sponge.squeeze_native_field_elements(n)


def fold_argument(config: PoseidonConfig, coms, device=None):
    """The R-round folding transcript (the twin of ``fold_argument_rns``).

    ``coms``: (B, R) ints, the public commitment columns.  Returns
    ``(tag, z)``: the transcript tags as (B, 1, W) and the folded responses
    as (B, W) Montgomery words."""
    coms = np.asarray(coms, dtype=object)
    B, R = coms.shape
    dev = resolve_device(device)
    spec = config.field
    t = FiatShamir(config, batch_shape=(B,), device=dev)
    com_rows = torch.from_numpy(spec.pack(coms)).to(dev)  # (B, R, W)
    z = None
    for r in range(R):
        row = com_rows[:, r]
        t.absorb(row[:, None, :])
        c = t.challenge()
        z = row if r == 0 else ff.add(spec, ff.mont_mul(spec, z, c), row)
    t.absorb(z[:, None, :])
    return t.finalize(1), z


def fold_argument_host(config: PoseidonConfig, coms):
    """The host oracle of :func:`fold_argument` (Python ints).  Returns
    ``(tags, zs)``, one int each per instance."""
    p = config.field.p
    coms = np.asarray(coms, dtype=object)
    B, R = coms.shape
    tags, zs = [], []
    for b in range(B):
        s = PoseidonSponge(config)
        z = 0
        for r in range(R):
            com = int(coms[b, r])
            s.absorb_elements([com])
            c = s.squeeze_native_field_elements(1)[0]
            z = com if r == 0 else (z * c + com) % p
        s.absorb_elements([z])
        tags.append(s.squeeze_native_field_elements(1)[0])
        zs.append(z)
    return tags, zs
