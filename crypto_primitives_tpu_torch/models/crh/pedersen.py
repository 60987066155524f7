"""Pedersen CRH over a twisted-Edwards or short-Weierstrass group.

Twin of ``crypto_primitives_tpu/models/crh/pedersen.py`` (the reference's
src/crh/pedersen/mod.rs): H(m) = sum over windows w and bits j of
bit(w, j) * 2^j * g_w, from precomputed per-window doubling tables
``generators[w][j] = 2^j g_w`` (mod.rs:48-56).  The input is bytes, bits
little-endian within each byte (mod.rs:200-209); the output is an affine
point.  The two-to-one CRH concatenates two equal halves into one buffer
(mod.rs:158-182), and ``compress`` serialises the previous digests as
uncompressed x || y bytes first (mod.rs:187-198).

Two tiers:
  * host: ``evaluate``/``compress`` in Python ints, the oracle;
  * batched: ``evaluate_batch``/``compress_batch`` on ``device`` (``None``
    means CUDA): the bits go through one grouped subset-sum MSM over the
    flattened window table (kernel ``msm_te`` or ``msm_sw`` on the card) and
    the sums are made affine by a Fermat inversion (kernel ``curve_affine``
    on the card, ``ops/affine_kernel.py``).  Digests are ``(..., 2, W)``
    Montgomery words (x, y).  ``evaluate_batch_many`` runs N such MSMs, with
    their own parameters, in one call.

``evaluate_batch`` opens span ``crh.pedersen``, with ``crh.bits``,
``crh.msm`` (the window indices and K4's ``kernel.k4``) and ``crh.affine``
(the affine kernel's ``kernel.affine``) inside it.  The set-up counters
``setup_seconds`` (``setup``'s generator powers on the host) and
``table_seconds`` (``packed_grouped``, and the first upload of the grouped
table to each device by ``PedersenParameters.upload``) add up this process's
seconds.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.models.crh import CRHScheme, TwoToOneCRHScheme
from crypto_primitives_tpu_torch.ops.curve import affine_to_uncompressed_bytes
from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod
from crypto_primitives_tpu_torch.utils import profiling

GROUP_W = 3  # window width of the grouped subset-sum tables

# Set-up seconds in this process (read by the benchmark's ``crh_setup_s``)
setup_seconds = 0.0
table_seconds = 0.0


@dataclasses.dataclass(frozen=True)
class Window:
    """``pedersen::Window`` twin (mod.rs:23-26)."""

    window_size: int
    num_windows: int


@dataclasses.dataclass(eq=False)
class PedersenParameters:
    """``Parameters{generators}`` (mod.rs:28-31); generators[w][j] are host
    affine points.  The grouped tables are made once per width and kept."""

    curve: object
    generators: List[List[Tuple[int, int]]]

    def packed_grouped(self, w: int = GROUP_W) -> np.ndarray:
        """The (G, 2^w, 3, W) grouped word table of the flattened generators
        (window-major), for the curve's model."""
        global table_seconds
        tables = self.__dict__.setdefault("_tables", {})
        if w not in tables:
            t0 = time.perf_counter()
            flat = [g for win in self.generators for g in win]
            tables[w] = fast_mod(self.curve).pack_table_grouped(self.curve, flat, w)
            table_seconds += time.perf_counter() - t0
        return tables[w]

    def upload(self, device: torch.device) -> None:
        """Put the grouped table on ``device`` ahead of the sum (the curve
        tier's ``device_table`` keeps it there), its first upload to a device
        timed into ``table_seconds``."""
        global table_seconds
        uploaded = self.__dict__.setdefault("_uploaded", set())
        if str(device) not in uploaded:
            self.packed_grouped(GROUP_W)
            t0 = time.perf_counter()
            fast_mod(self.curve).device_table(self, GROUP_W, device)
            table_seconds += time.perf_counter() - t0
            uploaded.add(str(device))


def bytes_to_bits(data: bytes) -> List[bool]:
    """Little-endian bit order within each byte (mod.rs:200-209)."""
    return [bool((byte >> i) & 1) for byte in data for i in range(8)]


def bytes_to_bits_batch(data: torch.Tensor, nbits: int = 0) -> torch.Tensor:
    """(..., nbytes) uint8 -> (..., max(8 * nbytes, nbits)) uint8 bits,
    little-endian within each byte, zero-padded to nbits."""
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((data.to(torch.uint8).unsqueeze(-1) >> shifts) & 1).flatten(-2)
    if bits.shape[-1] < nbits:
        bits = torch.nn.functional.pad(bits, (0, nbits - bits.shape[-1]))
    return bits


class PedersenCRH(CRHScheme):
    def __init__(self, curve, window: Window):
        self.curve = curve
        self.window = window
        self.input_size_bits = window.window_size * window.num_windows

    # -- setup (mod.rs:40-74) --

    def generator_powers(self, num_powers: int, rng) -> List[Tuple[int, int]]:
        base = self.curve.rand_point(rng)
        powers = []
        for _ in range(num_powers):
            powers.append(base)
            base = self.curve.double_host(base)
        return powers

    def create_generators(self, rng) -> List[List[Tuple[int, int]]]:
        return [self.generator_powers(self.window.window_size, rng) for _ in range(self.window.num_windows)]

    def setup(self, rng) -> PedersenParameters:
        global setup_seconds
        t0 = time.perf_counter()
        params = PedersenParameters(self.curve, self.create_generators(rng))
        setup_seconds += time.perf_counter() - t0
        return params

    # -- evaluation --

    def _check_length(self, nbytes: int) -> None:
        if nbytes * 8 > self.input_size_bits:
            raise ValueError(
                f"incorrect input length {nbytes} for window params "
                f"{self.window.window_size}x{self.window.num_windows}"
            )

    def evaluate(self, params: PedersenParameters, input_: bytes):
        """Host tier, the exact mirror of mod.rs:76-129."""
        data = bytes(input_)
        self._check_length(len(data))
        bits = bytes_to_bits(data + b"\x00" * (self.input_size_bits // 8 - len(data)))
        acc = self.curve.zero_host()
        size = self.window.window_size
        for w in range(self.window.num_windows):
            for bit, base in zip(bits[w * size:(w + 1) * size], params.generators[w]):
                if bit:
                    acc = self.curve.add_host(acc, base)
        return acc

    def evaluate_batch_projective(self, params: PedersenParameters, inputs, device=None) -> torch.Tensor:
        """inputs (..., nbytes) uint8 -> the sums before the affine step:
        extended (..., 4, W) on a TE curve, projective (..., 3, W) on an SW
        one.  The bits are not padded to the window's size: the grouped sum
        runs over the groups the 8 * nbytes input bits reach, since the
        zero bits past them would add only the identity."""
        inputs = torch.as_tensor(inputs, dtype=torch.uint8, device=resolve_device(device))
        self._check_length(inputs.shape[-1])
        with profiling.annotate("crh.bits"):
            bits = bytes_to_bits_batch(inputs)
        with profiling.annotate("crh.msm"):
            params.upload(bits.device)
            return fast_mod(self.curve).conditional_sum_grouped_auto(self.curve, params, bits, GROUP_W)

    def evaluate_batch_many(self, params_list, inputs_list, device=None) -> List[torch.Tensor]:
        """N independent evaluations (their own parameters and batch shapes)
        -> the N sums of :meth:`evaluate_batch_projective`, run by
        ``msm_many``: the twin of the JAX package's
        ``evaluate_batch_rns_many``."""
        dev = resolve_device(device)
        bits_list = []
        for inputs in inputs_list:
            inputs = torch.as_tensor(inputs, dtype=torch.uint8, device=dev)
            self._check_length(inputs.shape[-1])
            bits_list.append(bytes_to_bits_batch(inputs))
        return fast_mod(self.curve).msm_many(self.curve, params_list, bits_list, GROUP_W)

    def evaluate_batch(self, params: PedersenParameters, inputs, device=None) -> torch.Tensor:
        """inputs (..., nbytes) uint8 -> affine digests (..., 2, W) Montgomery."""
        with profiling.annotate("crh.pedersen"):
            acc = self.evaluate_batch_projective(params, inputs, device=device)
            with profiling.annotate("crh.affine"):
                return fast_mod(self.curve).to_affine(self.curve, acc)


class PedersenTwoToOneCRH(TwoToOneCRHScheme):
    """mod.rs:132-198: the halves, zero-padded into one input buffer."""

    def __init__(self, curve, window: Window):
        self.curve = curve
        self.window = window
        self.crh = PedersenCRH(curve, window)
        self.input_size_bits = self.crh.input_size_bits
        self.half_input_size_bits = self.input_size_bits // 2

    def setup(self, rng) -> PedersenParameters:
        return self.crh.setup(rng)

    def _check_halves(self, left_len: int, right_len: int) -> None:
        if left_len != right_len:
            raise ValueError("left and right input should be of equal length")
        if left_len * 8 > self.half_input_size_bits:
            raise ValueError(f"incorrect input length {left_len} for each half")

    def evaluate(self, params: PedersenParameters, left: bytes, right: bytes):
        self._check_halves(len(left), len(right))
        return self.crh.evaluate(params, bytes(left) + bytes(right))

    def compress(self, params: PedersenParameters, left, right):
        """Digests -> uncompressed x || y bytes -> evaluate (mod.rs:187-198)."""
        return self.evaluate(params, self.curve.to_uncompressed_bytes(left),
                             self.curve.to_uncompressed_bytes(right))

    def evaluate_batch(self, params: PedersenParameters, left, right, device=None) -> torch.Tensor:
        """left/right (..., nbytes) uint8 -> affine digests (..., 2, W)."""
        dev = resolve_device(device)
        left = torch.as_tensor(left, dtype=torch.uint8, device=dev)
        right = torch.as_tensor(right, dtype=torch.uint8, device=dev)
        if left.shape != right.shape:
            raise ValueError("left and right input should be of equal length")
        self._check_halves(left.shape[-1], right.shape[-1])
        return self.crh.evaluate_batch(params, torch.cat([left, right], dim=-1), device=dev)

    def compress_batch(self, params: PedersenParameters, left, right, device=None) -> torch.Tensor:
        """left/right are affine digest rows (..., 2, W) Montgomery words."""
        dev = resolve_device(device)
        left = torch.as_tensor(left, device=dev)
        right = torch.as_tensor(right, device=dev)
        return self.evaluate_batch(params, affine_to_uncompressed_bytes(self.curve, left),
                                   affine_to_uncompressed_bytes(self.curve, right), device=dev)
