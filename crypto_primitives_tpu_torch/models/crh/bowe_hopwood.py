"""Bowe-Hopwood-Pedersen CRH (Zcash §5.4.1.7) on a twisted-Edwards curve.

Twin of ``crypto_primitives_tpu/models/crh/bowe_hopwood.py`` (the reference's
src/crh/bowe_hopwood/mod.rs): the input is cut into 3-bit chunks
(CHUNK_SIZE = 3, mod.rs:31); chunk (c0, c1, c2) scales its generator by
(1 + c0 + 2 c1) (1 - 2 c2), a signed digit (mod.rs:161-181); generators
within a segment are spaced by 2^4 (four doublings a step, mod.rs:44-59);
``setup`` refuses a window whose segment scalars could reach (p - 1) / 2
(mod.rs:82-101).  The output is only the x-coordinate of the sum
(mod.rs:185).

Two tiers:
  * host: ``evaluate`` / ``compress`` in Python ints, the oracle;
  * batched: ``evaluate_batch`` on ``device`` (``None`` means CUDA).  Each
    3-bit chunk is an 8-way lookup of its signed digit times its generator,
    so the whole hash is one grouped MSM over a table of those signed combos
    (``BoweHopwoodParameters._signed_combos``): kernel ``msm_te`` for CUDA
    inputs, its plain version for CPU inputs.  The x-coordinates come back
    as ``(..., W)`` Montgomery words, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.models.crh import CRHScheme, TwoToOneCRHScheme
from crypto_primitives_tpu_torch.models.crh.pedersen import Window, bytes_to_bits, bytes_to_bits_batch
from crypto_primitives_tpu_torch.ops import curve_fast, msm_kernel
from crypto_primitives_tpu_torch.ops.curve import te_to_affine

CHUNK_SIZE = 3


@dataclasses.dataclass(eq=False)
class BoweHopwoodParameters:
    """``Parameters{generators}``: generators[w][j] are host affine points,
    spaced by 2^4 within window w."""

    curve: object
    generators: List[List[Tuple[int, int]]]

    def _signed_combos(self, n_real: int) -> list:
        """Per-chunk 8-way signed-digit lookup points: combos[j][e] =
        (1 + c0 + 2 c1) (1 - 2 c2) g_j for e = c0 + 2 c1 + 4 c2 (the chunk
        encoding of mod.rs:161-181 as a grouped table); chunks j >= n_real,
        absent from the reference's input, select the identity.  Equal to
        the JAX package's ``_signed_combos`` entry for entry."""
        curve = self.curve
        combos = []
        for j, g in enumerate(g for win in self.generators for g in win):
            if j >= n_real:
                combos.append([curve.zero_host()] * 8)
                continue
            row = []
            for e in range(8):
                pt = curve.scalar_mul_host(g, 1 + (e & 1) + 2 * ((e >> 1) & 1))
                row.append(curve.neg_host(pt) if e >> 2 else pt)
            combos.append(row)
        return combos

    def packed_signed_grouped(self, n_real: int) -> np.ndarray:
        """The (chunks, 8, 3, W) ``pack_combos`` word table of
        :meth:`_signed_combos`, made once per n_real and kept."""
        tables = self.__dict__.setdefault("_signed_tables", {})
        if n_real not in tables:
            tables[n_real] = curve_fast.pack_combos(self.curve, self._signed_combos(n_real))
        return tables[n_real]

    def device_signed_table(self, n_real: int, device: torch.device) -> torch.Tensor:
        """:meth:`packed_signed_grouped` on ``device``, uploaded once per
        (n_real, device) and kept on the parameters object."""
        cache = self.__dict__.setdefault("_device_signed_tables", {})
        key = (n_real, str(device))
        if key not in cache:
            cache[key] = torch.from_numpy(self.packed_signed_grouped(n_real)).to(device)
        return cache[key]


def max_chunks_per_segment(scalar_p: int) -> int:
    """calculate_num_chunks_in_segment (mod.rs:82-92)."""
    upper_limit = (scalar_p - 1) // 2
    c = 0
    rng = 2
    while rng < upper_limit:
        rng <<= 4
        c += 1
    return c


class BoweHopwoodCRH(CRHScheme):
    def __init__(self, curve, window: Window):
        self.curve = curve
        self.window = window
        self.input_size_bits = window.window_size * window.num_windows * CHUNK_SIZE

    def create_generators(self, rng) -> List[List[Tuple[int, int]]]:
        gens = []
        for _ in range(self.window.num_windows):
            seg = []
            base = self.curve.rand_point(rng)
            for _ in range(self.window.window_size):
                seg.append(base)
                for _ in range(4):
                    base = self.curve.double_host(base)
            gens.append(seg)
        return gens

    def setup(self, rng) -> BoweHopwoodParameters:
        maxc = max_chunks_per_segment(self.curve.scalar.p)
        if self.window.window_size > maxc:
            raise ValueError(
                "Bowe-Hopwood-PedersenCRH hash must have a window size resulting in "
                f"scalars < (p-1)/2, maximum segment size is {maxc}"
            )
        return BoweHopwoodParameters(self.curve, self.create_generators(rng))

    def _check_length(self, nbytes: int) -> None:
        if nbytes * 8 > self.input_size_bits:
            raise ValueError(
                f"incorrect input bitlength {nbytes * 8} for window params "
                f"{self.window.window_size}x{self.window.num_windows}x{CHUNK_SIZE}"
            )

    def evaluate(self, params: BoweHopwoodParameters, input_: bytes) -> int:
        """Host tier; returns the x-coordinate (mod.rs:114-186).  The input
        bits are padded only to a multiple of CHUNK_SIZE (mod.rs:131-140)."""
        data = bytes(input_)
        self._check_length(len(data))
        bits = bytes_to_bits(data)
        bits += [False] * (-len(bits) % CHUNK_SIZE)
        curve = self.curve
        acc = curve.zero_host()
        seg_bits = self.window.window_size * CHUNK_SIZE
        for w in range(0, len(bits), seg_bits):
            segment = bits[w:w + seg_bits]
            for j in range(0, len(segment), CHUNK_SIZE):
                c0, c1, c2 = segment[j:j + CHUNK_SIZE]
                gen = params.generators[w // seg_bits][j // CHUNK_SIZE]
                enc = gen
                if c0:
                    enc = curve.add_host(enc, gen)
                if c1:
                    enc = curve.add_host(enc, curve.double_host(gen))
                if c2:
                    enc = curve.neg_host(enc)
                acc = curve.add_host(acc, enc)
        return acc[0]

    def evaluate_batch(self, params: BoweHopwoodParameters, inputs, device=None) -> torch.Tensor:
        """inputs (..., nbytes) uint8 -> x-coordinates (..., W) Montgomery
        words: one grouped MSM over the signed-combos table (``msm_te`` for
        CUDA inputs, ``msm_kernel.grouped_msm_plain`` for CPU inputs), then
        the affine step.  Only the first n_real = ceil(8 nbytes / 3) groups
        run: the groups past them are identity rows selected by zero bits,
        so they would add only the identity."""
        inputs = torch.as_tensor(inputs, dtype=torch.uint8, device=resolve_device(device))
        nbytes = inputs.shape[-1]
        self._check_length(nbytes)
        n_real = -(-(8 * nbytes) // CHUNK_SIZE)
        table = params.device_signed_table(n_real, inputs.device)
        acc = curve_fast.grouped_sum(msm_kernel.grouped_msm, self.curve, table, bytes_to_bits_batch(inputs),
                                     CHUNK_SIZE)
        return te_to_affine(self.curve, acc)[..., 0, :]


class BoweHopwoodTwoToOneCRH(TwoToOneCRHScheme):
    """mod.rs:189-240; ``compress`` feeds the bytes of prior x-coordinates."""

    def __init__(self, curve, window: Window):
        self.curve = curve
        self.window = window
        self.crh = BoweHopwoodCRH(curve, window)
        self.input_size_bits = self.crh.input_size_bits
        self.half_input_size_bits = self.input_size_bits // 2

    def setup(self, rng) -> BoweHopwoodParameters:
        return self.crh.setup(rng)

    def evaluate(self, params: BoweHopwoodParameters, left: bytes, right: bytes) -> int:
        if len(left) != len(right):
            raise ValueError("left and right input should be of equal length")
        if len(left) * 8 > self.half_input_size_bits:
            raise ValueError(f"incorrect input length {len(left)} for each half")
        buffer = bytearray(self.input_size_bits // 8)
        combined = bytes(left) + bytes(right)
        buffer[:len(combined)] = combined
        return self.crh.evaluate(params, bytes(buffer))

    def compress(self, params: BoweHopwoodParameters, left: int, right: int) -> int:
        return self.evaluate(params, self.curve.base.to_bytes_le(int(left)),
                             self.curve.base.to_bytes_le(int(right)))
