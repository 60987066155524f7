"""Batched IPA-style Pedersen-opening folding argument.

Twin of ``crypto_primitives_tpu/models/protocols/ipa_fold.py``: a log-round
Bulletproofs-style argument that the prover knows the opening of a vector
Pedersen commitment C = sum_i a_i G_i (the commitment shape of the
reference's src/commitment/pedersen/mod.rs:62-105, on the transcript flow of
src/sponge/mod.rs:101-154).  Each round the prover sends the cross
commitments

    L = <a_lo, G_hi>,   R = <a_hi, G_lo>,

the transcript absorbs their affine coordinates and squeezes a challenge e
(a base-field element; the scalar c = e mod p_s and its inverse are formed on
the host, one small read a round, as in the JAX package), and both tables
fold:

    a' = c a_lo + c^-1 a_hi          (scalar-field words, ``ops/field.py``)
    G' = c^-1 G_lo + c G_hi          (windowed products, ``ops/curve_fast*``)

which keeps <a', G'> = C + c^2 L + c^-2 R.  After m = log2 n rounds the
prover reveals the folded scalar a*; the host verifier replays the
transcript, folds the generators, forms C' = C + sum_j (c_j^2 L_j + c_j^-2
R_j) and accepts iff C' == a* G*.

B instances run as one batch; the curve work is the generators' pack
(kernel ``curve_pack`` on a TE curve on the card, the host pack otherwise),
the windowed variable-base product (kernel ``curve_windowed`` on a TE curve
on the card, plain PyTorch otherwise) and the affine step (kernel
``curve_affine`` on the card; the JAX package has no TPU kernel for any of
the three), and the transcript's permutations run kernel
``poseidon_permute``.  The products of one round that
do not depend on each other (L with R, and the two halves of G') go through
one windowed call on the stacked points, which gives the same points as two
calls.
"""

from __future__ import annotations

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.models.sponge.fiat_shamir import FiatShamir
from crypto_primitives_tpu_torch.models.sponge.poseidon import PoseidonConfig, PoseidonSponge
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops.curve_fast import affine_host
from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod


def _scalar_bits(fs, rows: torch.Tensor) -> torch.Tensor:
    """Scalar-field Montgomery words (..., W_s) -> (..., nbits) uint8 bits of
    their standard values, least significant first, on the rows' device."""
    std = ff.from_mont(fs, rows).to(torch.int64) & ff.WORD_MASK
    shifts = torch.arange(ff.WORD_BITS, dtype=torch.int64, device=rows.device)
    bits = (std.unsqueeze(-1) >> shifts) & 1
    return bits.flatten(-2)[..., :fs.nbits].to(torch.uint8)


def _msm_rows(curve, mod, pts: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """sum_i bits_i * P_i with per-instance points: (..., n, C, W) points x
    (..., n, nbits) bits -> (..., C, W)."""
    return mod.sum(curve, mod.scalar_mul_bits_windowed(curve, pts, bits))


def _absorb_affine(t: FiatShamir, mod, curve, pts: torch.Tensor):
    """Make (..., B, C, W) points affine, absorb each (B, 2, W) block of
    (x, y) rows in order, and return the host tuples."""
    aff = mod.to_affine(curve, pts)
    for block in aff.reshape((-1,) + tuple(aff.shape[-3:])):
        t.absorb(block)
    return affine_host(curve, aff)


def ipa_fold_prove(curve, config: PoseidonConfig, gens, scalars_host, device=None):
    """The prover (the twin of ``ipa_fold_prove_rns``).  ``gens``: n host
    affine generators (n = 2^m, shared by every instance); ``scalars_host``:
    (B, n) ints mod the curve's scalar field; ``device``: ``None`` means
    CUDA.  Returns the JAX package's host-verifiable proof dict:

      * ``commitment``: (B,) affine int tuples, C_b = <a_b, G>;
      * ``rounds``: m pairs ((B,) L tuples, (B,) R tuples);
      * ``a_star``: (B,) ints, the folded scalars;
      * ``challenges``: (B, m) ints (the verifier recomputes them).

    The transcript absorbs the points' coordinates as elements of the
    sponge's field, so the curve's base field must be that field: another
    raises ``ValueError``.  A challenge that is 0 mod p_s has no inverse and
    raises ``ValueError``, as the JAX package's ``pow(0, -1, p_s)`` does."""
    if curve.base.p != config.field.p:
        raise ValueError(f"{curve.name}'s base field is not the sponge's field: the transcript absorbs "
                         "the points' coordinates as sponge-field elements")
    dev = resolve_device(device)
    mod = fast_mod(curve)
    fs = curve.scalar
    p_s = fs.p
    B, n = len(scalars_host), len(scalars_host[0])
    m = n.bit_length() - 1
    if n != 1 << m or m < 1:
        raise ValueError(f"the generators must number 2^m >= 2, got {n}")

    a_rows = torch.from_numpy(fs.pack(np.asarray(scalars_host, dtype=object))).to(dev)  # (B, n, W_s)
    packed_g = mod.pack_points_device(curve, list(gens), dev)
    G_pts = packed_g.expand((B,) + tuple(packed_g.shape))  # (B, n, C, W)
    t = FiatShamir(config, batch_shape=(B,), device=dev)

    C_host = _absorb_affine(t, mod, curve, _msm_rows(curve, mod, G_pts, _scalar_bits(fs, a_rows)))
    rounds = []
    chals = np.empty((B, m), dtype=object)
    for j in range(m):
        half = a_rows.shape[1] // 2
        a_lo, a_hi = a_rows[:, :half], a_rows[:, half:]
        G_lo, G_hi = G_pts[:, :half], G_pts[:, half:]
        bits = _scalar_bits(fs, a_rows)
        # L = <a_lo, G_hi> and R = <a_hi, G_lo> in one windowed call
        LR = _msm_rows(curve, mod, torch.stack([G_hi, G_lo]), torch.stack([bits[:, :half], bits[:, half:]]))
        L_host, R_host = _absorb_affine(t, mod, curve, LR)
        rounds.append((L_host, R_host))
        e_host = config.field.unpack(t.challenge())
        c_host = [int(v) % p_s for v in np.atleast_1d(e_host)]
        if 0 in c_host:
            raise ValueError(f"a challenge of round {j} is 0 mod the scalar field: it has no inverse")
        cinv_host = [pow(c, -1, p_s) for c in c_host]
        chals[:, j] = c_host
        c_rows = torch.from_numpy(fs.pack(c_host)).to(dev)[:, None, :]  # (B, 1, W_s)
        cinv_rows = torch.from_numpy(fs.pack(cinv_host)).to(dev)[:, None, :]
        a_rows = ff.add(fs, ff.mont_mul(fs, a_lo, c_rows), ff.mont_mul(fs, a_hi, cinv_rows))
        # G' = cinv G_lo + c G_hi: one scalar per instance, broadcast over its points
        sbits = torch.from_numpy(np.stack([mod.scalars_to_bits(curve, cinv_host),
                                           mod.scalars_to_bits(curve, c_host)])).to(dev)[:, :, None, :]
        P = mod.scalar_mul_bits_windowed(curve, torch.stack([G_lo, G_hi]), sbits)
        G_pts = mod.add(curve, P[0], P[1])

    a_star = [int(v) % p_s for v in np.atleast_1d(fs.unpack(a_rows[:, 0, :]))]
    return {"commitment": C_host, "rounds": rounds, "a_star": a_star, "challenges": chals}


def _host_transcript_challenges(curve, config: PoseidonConfig, commitment, rounds) -> list:
    """Replay the transcript on the host sponge: absorb C, then each
    round's (L, R), squeezing one challenge a round."""
    sp = PoseidonSponge(config)
    cx, cy = commitment
    sp.absorb_elements([int(cx), int(cy)])
    es = []
    for L, R in rounds:
        sp.absorb_elements([int(L[0]), int(L[1]), int(R[0]), int(R[1])])
        es.append(sp.squeeze_native_field_elements(1)[0])
    return es


def ipa_fold_verify_host(curve, config: PoseidonConfig, gens, commitment, rounds, a_star: int) -> bool:
    """The host verifier (Python ints, independent of the batched tier):
    replays the transcript, folds the generators with c^-1 and c, forms
    C' = C + sum_j (c_j^2 L_j + c_j^-2 R_j), and accepts iff
    C' == a_star G_fold."""
    p_s = curve.scalar.p
    es = _host_transcript_challenges(curve, config, commitment, rounds)
    G = list(gens)
    acc = tuple(int(v) for v in commitment)
    for (L, R), e in zip(rounds, es):
        c = int(e) % p_s
        if c == 0:
            return False
        cinv = pow(c, -1, p_s)
        lterm = curve.scalar_mul_host(tuple(int(v) for v in L), c * c % p_s)
        rterm = curve.scalar_mul_host(tuple(int(v) for v in R), cinv * cinv % p_s)
        acc = curve.add_host(curve.add_host(acc, lterm), rterm)
        half = len(G) // 2
        G = [curve.add_host(curve.scalar_mul_host(G[i], cinv), curve.scalar_mul_host(G[half + i], c))
             for i in range(half)]
    return acc == curve.scalar_mul_host(G[0], int(a_star) % p_s)


def ipa_fold_prove_host(curve, config: PoseidonConfig, gens, scalars_host):
    """The host oracle of the prover (Python ints end to end), on the same
    transcript schedule."""
    p_s = curve.scalar.p
    proofs = []
    for scalars in scalars_host:
        a = [int(v) % p_s for v in scalars]
        G = list(gens)
        C = None
        for ai, Gi in zip(a, G):
            term = curve.scalar_mul_host(Gi, ai)
            C = term if C is None else curve.add_host(C, term)
        sp = PoseidonSponge(config)
        sp.absorb_elements([int(C[0]), int(C[1])])
        rounds = []
        while len(a) > 1:
            half = len(a) // 2
            L = R = None
            for i in range(half):
                lt = curve.scalar_mul_host(G[half + i], a[i])
                rt = curve.scalar_mul_host(G[i], a[half + i])
                L = lt if L is None else curve.add_host(L, lt)
                R = rt if R is None else curve.add_host(R, rt)
            sp.absorb_elements([int(L[0]), int(L[1]), int(R[0]), int(R[1])])
            rounds.append((L, R))
            c = int(sp.squeeze_native_field_elements(1)[0]) % p_s
            cinv = pow(c, -1, p_s)
            a = [(c * a[i] + cinv * a[half + i]) % p_s for i in range(half)]
            G = [curve.add_host(curve.scalar_mul_host(G[i], cinv), curve.scalar_mul_host(G[half + i], c))
                 for i in range(half)]
        proofs.append({"commitment": C, "rounds": rounds, "a_star": a[0]})
    return proofs
