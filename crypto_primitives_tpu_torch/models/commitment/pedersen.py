"""Pedersen commitment: Com(m; r) = PedersenCRH(m) + sum_j r_bits[j] * 2^j * h.

Twin of ``crypto_primitives_tpu/models/commitment/pedersen.py`` (the
reference's src/commitment/pedersen/mod.rs): the parameters are the powers of
a blinding base h and the CRH's window tables (mod.rs:17-21); ``setup``
samples MODULUS_BIT_SIZE powers of h, then the window generators
(mod.rs:44-60); ``commit`` hashes the message with the CRH and adds the
blinding term over the randomness bits, little-endian (mod.rs:62-105).  Both
curve models work.  ``commit_batch`` runs two grouped MSMs (message and
blinding) and one complete addition, then the affine step.

``commit_batch`` opens span ``comm.pedersen``, with the CRH's ``crh.bits``
and ``crh.msm`` (``PedersenCRH.evaluate_batch_projective``), ``comm.blind``
(the opening's bits, their window indices and the blinding table's grouped
MSM, K4's ``kernel.k4`` on a TE curve), ``comm.add`` (the complete addition
of the two sums, ``ops.curve.te_add``: on a TE curve one launch of the
addition kernel, ``kernel.add``) and ``comm.affine`` (the affine kernel's
``kernel.affine``) inside it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.models.commitment import CommitmentScheme
from crypto_primitives_tpu_torch.models.crh.pedersen import GROUP_W, PedersenCRH, PedersenParameters, Window
from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod
from crypto_primitives_tpu_torch.utils import profiling


@dataclasses.dataclass(eq=False)
class PedersenCommitmentParameters:
    curve: object
    randomness_generator: List[Tuple[int, int]]
    generators: List[List[Tuple[int, int]]]

    def packed_grouped(self, w: int = GROUP_W) -> np.ndarray:
        """The grouped table of the blinding powers, so that the grouped MSM
        treats these parameters like a CRH's."""
        tables = self.__dict__.setdefault("_tables", {})
        if w not in tables:
            tables[w] = fast_mod(self.curve).pack_table_grouped(self.curve, self.randomness_generator, w)
        return tables[w]

    def crh_params(self) -> PedersenParameters:
        if "_crh_params" not in self.__dict__:
            self._crh_params = PedersenParameters(self.curve, self.generators)
        return self._crh_params


class PedersenCommitment(CommitmentScheme):
    def __init__(self, curve, window: Window):
        self.curve = curve
        self.window = window
        self.crh = PedersenCRH(curve, window)

    def setup(self, rng) -> PedersenCommitmentParameters:
        num_powers = self.curve.scalar.nbits  # MODULUS_BIT_SIZE (mod.rs:51)
        randomness_generator = self.crh.generator_powers(num_powers, rng)
        generators = self.crh.create_generators(rng)
        return PedersenCommitmentParameters(self.curve, randomness_generator, generators)

    def rand_randomness(self, rng) -> int:
        return rng.randrange(self.curve.scalar.p)

    def commit(self, params: PedersenCommitmentParameters, input_: bytes, randomness: int):
        """Host tier (mod.rs:62-105)."""
        if len(input_) > self.window.window_size * self.window.num_windows:
            raise ValueError(f"incorrect input length: {len(input_)}")
        result = self.crh.evaluate(params.crh_params(), bytes(input_))
        r = int(randomness)
        for power in params.randomness_generator:
            if r == 0:
                break
            if r & 1:
                result = self.curve.add_host(result, power)
            r >>= 1
        return result

    def commit_batch(self, params: PedersenCommitmentParameters, inputs, randomness, device=None) -> torch.Tensor:
        """inputs (..., nbytes) uint8; randomness (..., nbits) bits, little
        endian (see :meth:`randomness_to_bits`).  Returns affine commitments
        (..., 2, W) Montgomery words."""
        dev = resolve_device(device)
        mod = fast_mod(self.curve)
        with profiling.annotate("comm.pedersen"):
            msg = self.crh.evaluate_batch_projective(params.crh_params(), inputs, device=dev)
            with profiling.annotate("comm.blind"):
                bits = torch.as_tensor(randomness, dtype=torch.uint8, device=dev)
                blind = mod.conditional_sum_grouped_auto(self.curve, params, bits, GROUP_W)
            with profiling.annotate("comm.add"):
                acc = mod.add(self.curve, msg, blind)
            with profiling.annotate("comm.affine"):
                return mod.to_affine(self.curve, acc)

    def randomness_to_bits(self, randomness) -> np.ndarray:
        """Host scalars -> (..., nbits) little-endian uint8 bits."""
        arr = np.asarray(randomness, dtype=object)
        nbits = self.curve.scalar.nbits
        nbytes = -(-nbits // 8)
        raw = b"".join(int(v).to_bytes(nbytes, "little") for v in arr.reshape(-1))
        bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8).reshape(-1, nbytes), axis=-1, bitorder="little")
        return bits[:, :nbits].reshape(arr.shape + (nbits,))
