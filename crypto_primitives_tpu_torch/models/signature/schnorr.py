"""Schnorr signatures over any curve group (TE or SW) with a byte digest.

Twin of ``crypto_primitives_tpu/models/signature/schnorr.py`` (the
reference's src/signature/schnorr/mod.rs, generic over ark-ec's
``CurveGroup`` the same way):
  * setup: 32 random salt bytes and a random generator (mod.rs:49-62);
  * sign: draw k, r = k G, e = H(salt || ser(r) || ser(msg)) mapped into the
    scalar field by ``from_random_bytes``, drawing again while that is None;
    s = k - e sk (mod.rs:77-115);
  * verify: r' = s G + e pk, then e again (mod.rs:117-148);
  * randomize_public_key: pk + m G; randomize_signature: s - e m, with m
    read from the randomness bytes' most-significant-first bit stream at
    weight 2^position (mod.rs:150-214).
The hash input (ark-serialize): the salt as 32 raw bytes, r compressed (TE:
y with the x-sign flag; SW: x with SWFlags), the message with a u64
little-endian length prefix.

Two tiers:
  * host: the scheme in Python ints, the oracle;
  * batched: ``keygen_batch``, ``sign_batch``, ``verify_batch`` on ``device``
    (``None`` means CUDA).  sk G, k G and s G are fixed-base products, one
    grouped MSM over the generator's doubling-power table each (kernel
    ``msm_te`` or ``msm_sw`` on the card); e pk is the windowed
    variable-base product (on a TE curve one launch of A3,
    ``ops.windowed_kernel``; plain PyTorch otherwise); s G + e pk is one
    complete addition (on a TE curve one launch of the addition kernel A2,
    ``ops.add_kernel``); points are made affine on the device (the affine
    kernel A1, ``ops.affine_kernel``) and hashed on the host.  Drawing from
    ``rng`` in the JAX package's order, they return what its batch tier
    returns.

``verify_batch`` opens span ``sig.verify``, with these inside it, in order:
  * ``sig.bits``: s's and e's bits (two ``curve.bits``) and their upload;
  * ``sig.pack``: the keys' canonical words (``curve.pack``), their upload
    and, on a TE curve, their extended Montgomery form (``kernel.pack``);
  * ``sig.fixed``: s G, K4's ``kernel.k4`` on a TE curve;
  * ``sig.windowed``: e pk, A3's ``kernel.windowed`` on a TE curve;
  * ``sig.add``: s G + e pk, ``kernel.add``;
  * ``sig.affine``: the affine step's ``kernel.affine``, the read to the host
    (``curve.to_host``, which waits for every kernel queued before it) and
    the host ints (``curve.host_ints``);
  * ``sig.challenge``: the challenge in three passes over the batch,
    ``sig.serialize`` (the hash input a row), ``sig.digest`` (the digest a
    row) and ``sig.to_scalar`` (``from_random_bytes`` a row and the
    comparison with e).
The ``curve.*`` and ``sig.serialize``/``sig.digest``/``sig.to_scalar``
spans carry ``rows``: the points, scalars or rows they handle.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, List, Optional, Tuple

import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod
from crypto_primitives_tpu_torch.utils import profiling


@dataclasses.dataclass
class SchnorrParameters:
    generator: Tuple[int, int]
    salt: bytes  # 32 bytes


@dataclasses.dataclass
class SchnorrSignature:
    prover_response: int  # s
    verifier_challenge: int  # e


def _randomness_multiplier(randomness: bytes) -> int:
    """The sum over the most-significant-first bit stream of the bytes at
    weight 2^position (mod.rs:187-194, and the reversed double-and-add of
    mod.rs:160-169, which computes the same integer)."""
    m = 0
    pos = 0
    for byte in randomness:
        for i in range(8):
            m += ((byte >> (7 - i)) & 1) << pos
            pos += 1
    return m


class Schnorr:
    def __init__(self, curve, digest: Optional[Callable[[bytes], bytes]] = None):
        # curve: a TECurveSpec or an SWCurveSpec
        self.curve = curve
        self.digest = digest or (lambda b: hashlib.sha256(b).digest())

    # -- the scheme, host tier --

    def setup(self, rng) -> SchnorrParameters:
        salt = bytes(rng.randrange(256) for _ in range(32))
        return SchnorrParameters(generator=self.curve.rand_point(rng), salt=salt)

    def keygen(self, params: SchnorrParameters, rng):
        sk = rng.randrange(self.curve.scalar.p)
        return self.curve.scalar_mul_host(params.generator, sk), sk

    def _hash_input(self, params: SchnorrParameters, commitment, message: bytes) -> bytes:
        return (params.salt + self.curve.serialize_compressed(commitment)
                + len(message).to_bytes(8, "little") + bytes(message))

    def _from_random_bytes(self, digest: bytes):
        """arkworks ``F::from_random_bytes``: the little-endian integer
        masked to MODULUS_BIT_SIZE bits, None if it is >= r."""
        return self.curve.scalar.from_random_bytes(digest)

    def _challenge(self, params: SchnorrParameters, commitment, message: bytes):
        return self._from_random_bytes(self.digest(self._hash_input(params, commitment, message)))

    def sign(self, params: SchnorrParameters, sk: int, message: bytes, rng) -> SchnorrSignature:
        r_order = self.curve.scalar.p
        while True:
            k = rng.randrange(r_order)
            e = self._challenge(params, self.curve.scalar_mul_host(params.generator, k), message)
            if e is not None:
                return SchnorrSignature(prover_response=(k - e * sk) % r_order, verifier_challenge=e)

    def verify(self, params: SchnorrParameters, pk, message: bytes, sig: SchnorrSignature) -> bool:
        r = self.curve.scalar.p
        r_prime = self.curve.add_host(self.curve.scalar_mul_host(params.generator, sig.prover_response % r),
                                      self.curve.scalar_mul_host(pk, sig.verifier_challenge % r))
        e = self._challenge(params, r_prime, message)
        return e is not None and e == sig.verifier_challenge

    # -- rerandomization (mod.rs:150-202) --

    def randomize_public_key(self, params: SchnorrParameters, public_key, randomness: bytes):
        m = _randomness_multiplier(randomness)
        return self.curve.add_host(self.curve.scalar_mul_host(params.generator, m), public_key)

    def randomize_signature(self, params: SchnorrParameters, sig: SchnorrSignature,
                            randomness: bytes) -> SchnorrSignature:
        r = self.curve.scalar.p
        m = _randomness_multiplier(randomness) % r
        return SchnorrSignature(prover_response=(sig.prover_response - sig.verifier_challenge * m) % r,
                                verifier_challenge=sig.verifier_challenge)

    # -- batched tier --

    def _bits(self, scalars, device: torch.device) -> torch.Tensor:
        return torch.from_numpy(fast_mod(self.curve).scalars_to_bits(self.curve, scalars)).to(device)

    def keygen_batch(self, params: SchnorrParameters, rng, n: int, device=None):
        """n keypairs (pk, sk), the twin of n ``keygen`` calls (mod.rs:64-75):
        the same sk draws, the pks as one fixed-base product."""
        dev = resolve_device(device)
        mod = fast_mod(self.curve)
        sks = [rng.randrange(self.curve.scalar.p) for _ in range(n)]
        pts = mod.fixed_base_mul(self.curve, params.generator, self._bits(sks, dev))
        return list(zip(mod.unpack_affine(self.curve, pts), sks))

    def sign_batch(self, params: SchnorrParameters, sks: List[int], messages: List[bytes], rng,
                   candidates: int = 4, device=None) -> List[SchnorrSignature]:
        """One signature per (sk, message), as ``sign`` makes it: each message
        keeps the first of its k draws whose challenge maps into the scalar
        field.  The draws are those of the JAX package: C = max(2,
        candidates) k's per message up front, one fixed-base product over
        all B C of them; then, for the messages whose C candidates all
        rejected, retry passes of 2C draws each, at most 4, while they fit
        the first pass's B C rows; then ``sign`` on the host for any message
        still unsigned (the rare tail of rejections, not a route around the
        device).  The JAX package pads every pass to B C rows so as to reuse
        one compiled program; the port has none to reuse, so a retry pass
        computes only its own candidates."""
        dev = resolve_device(device)
        mod = fast_mod(self.curve)
        B = len(sks)
        if len(messages) != B:
            raise ValueError(f"{B} keys but {len(messages)} messages")
        r_order = self.curve.scalar.p
        out: List[Optional[SchnorrSignature]] = [None] * B

        def device_round(idxs, C):
            """C candidates for each message in idxs; returns the messages
            whose candidates all rejected."""
            ks = [[rng.randrange(r_order) for _ in range(C)] for _ in idxs]
            pts = mod.fixed_base_mul(self.curve, params.generator, self._bits([k for row in ks for k in row], dev))
            commits = mod.unpack_affine(self.curve, pts)
            still = []
            for row, i in enumerate(idxs):
                for c in range(C):
                    e = self._challenge(params, commits[row * C + c], messages[i])
                    if e is not None:
                        out[i] = SchnorrSignature(prover_response=(ks[row][c] - e * sks[i]) % r_order,
                                                  verifier_challenge=e)
                        break
                else:
                    still.append(i)
            return still

        if B:
            C = max(2, candidates)
            rows = B * C
            still = device_round(list(range(B)), C)
            retries = 0
            while still and len(still) * 2 * C <= rows and retries < 4:
                still = device_round(still, 2 * C)
                retries += 1
        for i in range(B):
            if out[i] is None:
                out[i] = self.sign(params, sks[i], messages[i], rng)
        return out

    def verify_batch(self, params: SchnorrParameters, pks, messages: List[bytes],
                     sigs: List[SchnorrSignature], device=None) -> List[bool]:
        """``verify`` for every row: s G as a fixed-base product, e pk as the
        windowed variable-base one, their sum (one A2 launch on a TE curve)
        made affine on the device (one A1 launch), the challenge hashed on
        the host in three passes: every hash input, every digest, then
        every scalar and verdict.  Spans: ``sig.verify`` over ``sig.bits``,
        ``sig.pack``, ``sig.fixed``, ``sig.windowed``, ``sig.add``,
        ``sig.affine`` and ``sig.challenge``, one a stage; the module's
        docstring lists the spans inside them."""
        dev = resolve_device(device)
        mod = fast_mod(self.curve)
        B = len(sigs)
        if len(pks) != B or len(messages) != B:
            raise ValueError(f"{B} signatures but {len(pks)} keys and {len(messages)} messages")
        with profiling.annotate("sig.verify"):
            with profiling.annotate("sig.bits"):
                s_bits = self._bits([s.prover_response for s in sigs], dev)
                e_bits = self._bits([s.verifier_challenge for s in sigs], dev)
            with profiling.annotate("sig.pack"):
                pks_dev = mod.pack_points_device(self.curve, list(pks), dev)
            with profiling.annotate("sig.fixed"):
                sg = mod.fixed_base_mul(self.curve, params.generator, s_bits)
            with profiling.annotate("sig.windowed"):
                epk = mod.scalar_mul_bits_windowed(self.curve, pks_dev, e_bits)
            with profiling.annotate("sig.add"):
                r_sum = mod.add(self.curve, sg, epk)
            with profiling.annotate("sig.affine"):
                r_primes = mod.unpack_affine(self.curve, r_sum)
            with profiling.annotate("sig.challenge"):
                with profiling.annotate("sig.serialize", B):
                    inputs = [self._hash_input(params, r, m) for r, m in zip(r_primes, messages)]
                with profiling.annotate("sig.digest", B):
                    digests = list(map(self.digest, inputs))
                with profiling.annotate("sig.to_scalar", B):
                    out = []
                    for d, sig in zip(digests, sigs):
                        e = self._from_random_bytes(d)
                        out.append(e is not None and e == sig.verifier_challenge)
        return out
