"""Poseidon permutation, duplex sponge, and default parameter derivation.

Twin of ``crypto_primitives_tpu/models/sponge/poseidon.py`` (the reference's
src/sponge/poseidon/{mod.rs,traits.rs}).

Two tiers:
  * :class:`PoseidonSponge`: host sponge over Python ints, line for line the
    reference's duplex bookkeeping, including its squeeze-at-rate-boundary
    permutation skip.  It is the parity oracle.
  * :class:`PoseidonSpongeBatch`: the batched sponge.  Its state is a
    ``(..., t, W)`` int32 tensor of Montgomery words; each permutation is one
    launch of the CUDA kernel on a CUDA tensor (``ops/poseidon_kernel.py``),
    or its plain PyTorch version on a CPU tensor.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.errors import MissingParameters
from crypto_primitives_tpu_torch.models.sponge.grain_lfsr import PoseidonGrainLFSR
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops import poseidon_kernel
from crypto_primitives_tpu_torch.ops.field import FieldSpec

# Set-up counters of this process: seconds spent deriving parameters (the
# Grain LFSR and the MDS matrix, :func:`find_poseidon_ark_and_mds`) and
# making and uploading the kernel's schedule image (the first
# ``PoseidonConfig.schedule_tables`` of a config on a device).
derive_seconds = 0.0
schedule_seconds = 0.0


@dataclasses.dataclass(eq=False)
class PoseidonConfig:
    """Round constants and MDS matrix over Python ints (canonical form), the
    reference's ``PoseidonConfig`` (src/sponge/poseidon/mod.rs:27-45).
    Compared and hashed by identity."""

    field: FieldSpec
    full_rounds: int
    partial_rounds: int
    alpha: int
    ark: list  # [full + partial][t] ints
    mds: list  # [t][t] ints
    rate: int
    capacity: int

    def __post_init__(self):
        t = self.rate + self.capacity
        if self.full_rounds % 2:
            raise ValueError("full_rounds must be even")
        if self.alpha < 1:
            raise ValueError("alpha must be >= 1")
        if len(self.ark) != self.full_rounds + self.partial_rounds or any(
            len(row) != t for row in self.ark
        ):
            raise ValueError(f"ark must be ({self.full_rounds + self.partial_rounds}, {t})")
        if len(self.mds) != t or any(len(row) != t for row in self.mds):
            raise ValueError(f"mds must be ({t}, {t})")
        self._tables: dict = {}

    @property
    def t(self) -> int:
        return self.rate + self.capacity

    def tables(self, device) -> tuple:
        """(ark (rounds, t, W), mds (t, t, W)) Montgomery words on ``device``,
        built once per device."""
        key = str(device)
        if key not in self._tables:
            spec = self.field
            self._tables[key] = (
                torch.from_numpy(spec.pack(self.ark)).to(device),
                torch.from_numpy(spec.pack(self.mds)).to(device),
            )
        return self._tables[key]

    def schedule_tables(self, device) -> tuple:
        """(n_sparse, image): the kernel's constant-bank image of this config
        (``poseidon_kernel.kernel_image``: the modulus, then ark[0], the MDS,
        pre_full, the sparse rows sp_m00 / sp_v / sp_w and the folds of the
        sparse schedule, in Montgomery words) as an int32 tensor on
        ``device``, built once per device."""
        global schedule_seconds
        key = ("schedule", str(device))
        if key not in self._tables:
            t0 = time.perf_counter()
            n_sparse, image = poseidon_kernel.kernel_image(self)
            self._tables[key] = (n_sparse, torch.from_numpy(image.view(np.int32)).to(device))
            schedule_seconds += time.perf_counter() - t0
        return self._tables[key]


def permute(config: PoseidonConfig, state: torch.Tensor) -> torch.Tensor:
    """The Poseidon permutation of ``state`` ``(..., t, W)`` Montgomery words:
    the CUDA kernel on a CUDA tensor, its plain version on a CPU tensor."""
    lead = state.shape[:-2]
    flat = state.reshape((-1,) + tuple(state.shape[-2:])).contiguous()
    return poseidon_kernel.permute(config, flat).reshape(lead + tuple(state.shape[-2:]))


def _bits_le_to_field(bits: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """``(..., nb)`` LE bits -> ``(..., W)`` Montgomery words of ``spec``
    (``from_le_bytes_mod_order`` with nb <= nbits, so one conditional
    subtraction reduces)."""
    nb = bits.shape[-1]
    L = spec.num_digits
    if nb > spec.nbits:
        raise ValueError("more bits than the field holds")
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, 16 * L - nb))
    weights = torch.tensor([1 << i for i in range(16)], dtype=torch.int64, device=bits.device)
    digits = (b.reshape(b.shape[:-1] + (L, 16)) * weights).sum(-1)
    digits = ff._reduce(digits, spec._consts(bits.device)["p"], 1)
    return ff.to_mont(spec, ff.from_digits(digits))


class PoseidonSpongeBatch:
    """Batched duplex sponge with a host-side absorb/squeeze schedule.

    The duplex bookkeeping (mode and index) is Python state, so a sequence
    of calls becomes a fixed sequence of slot additions and permutations,
    with the reference's exact permutation schedule, quirk included
    (src/sponge/poseidon/mod.rs:124-186).  The state is ``(..., t, W)``
    int32 Montgomery words on ``device`` (``None`` means CUDA).  The JAX
    package's ``rep="rns"`` state and ``squeeze_native_rns`` are not ported.
    """

    def __init__(self, config: PoseidonConfig, batch_shape=(), state=None, device=None):
        _require_config(config)
        self.config = config
        self.spec = config.field
        self.device = resolve_device(device)
        W = self.spec.num_words
        if state is None:
            self.batch_shape = tuple(batch_shape)
            state = ff.zeros(self.spec, self.batch_shape + (config.t,), device=self.device)
        else:
            state = torch.as_tensor(state, device=self.device)
            if state.dtype != torch.int32 or tuple(state.shape[-2:]) != (config.t, W):
                raise ValueError(f"state must be int32 (..., {config.t}, {W}), got {state.dtype} {tuple(state.shape)}")
            self.batch_shape = tuple(state.shape[:-2])
        self.state = state
        self.mode = "absorbing"
        self.index = 0  # next_absorb_index or next_squeeze_index

    # -- state import/export (SpongeExt twin, src/sponge/mod.rs:184-191) --
    def into_state(self):
        return {"state": self.state, "mode": self.mode, "index": self.index}

    @classmethod
    def from_state(cls, st, config: PoseidonConfig, device=None):
        sponge = cls(config, state=st["state"], device=device)
        sponge.mode, sponge.index = st["mode"], st["index"]
        return sponge

    def _permute(self):
        self.state = permute(self.config, self.state)

    def _slot_add(self, lo: int, hi: int, elems: torch.Tensor):
        """state[..., cap+lo:cap+hi, :] += elems (a new tensor: the caller's
        state tensor is never written)."""
        cap = self.config.capacity
        new = self.state.clone()
        new[..., cap + lo : cap + hi, :] = ff.add(
            self.spec, self.state[..., cap + lo : cap + hi, :], elems
        )
        self.state = new

    def _absorb_internal(self, rate_start: int, elems: torch.Tensor):
        """Mirrors absorb_internal (src/sponge/poseidon/mod.rs:124-153)."""
        rate = self.config.rate
        k = elems.shape[-2]
        pos = 0
        while True:
            remaining = k - pos
            if rate_start + remaining <= rate:
                self._slot_add(rate_start, rate_start + remaining, elems[..., pos:, :])
                self.mode, self.index = "absorbing", rate_start + remaining
                return
            n = rate - rate_start
            self._slot_add(rate_start, rate, elems[..., pos : pos + n, :])
            self._permute()
            pos += n
            rate_start = 0

    def absorb(self, elems):
        """Absorb field elements ``(..., k, W)`` (Montgomery words)."""
        elems = torch.as_tensor(elems, device=self.device)
        if elems.shape[-2] == 0:
            return
        if self.mode == "absorbing":
            idx = self.index
            if idx == self.config.rate:
                self._permute()
                idx = 0
            self._absorb_internal(idx, elems)
        else:
            self._absorb_internal(0, elems)

    def _squeeze_internal(self, rate_start: int, n: int) -> torch.Tensor:
        """Mirrors squeeze_internal (src/sponge/poseidon/mod.rs:156-186),
        including the no-permute-on-exact-boundary behaviour."""
        rate, cap = self.config.rate, self.config.capacity
        outs = []
        remaining = n
        while True:
            if rate_start + remaining <= rate:
                outs.append(self.state[..., cap + rate_start : cap + rate_start + remaining, :])
                self.mode, self.index = "squeezing", rate_start + remaining
                return torch.cat(outs, dim=-2)
            k = rate - rate_start
            outs.append(self.state[..., cap + rate_start : cap + rate, :])
            remaining -= k
            if remaining > 0:
                self._permute()
            rate_start = 0

    def squeeze_native_field_elements(self, n: int) -> torch.Tensor:
        """``(..., n, W)`` Montgomery words (src/sponge/poseidon/mod.rs:324-344)."""
        if self.mode == "absorbing":
            self._permute()
            return self._squeeze_internal(0, n)
        idx = self.index
        if idx == self.config.rate:
            self._permute()
            idx = 0
        return self._squeeze_internal(idx, n)

    # -- CryptographicSponge byte/bit tier (src/sponge/mod.rs:101-154) --

    def _squeeze_canonical_bytes_le(self, num_elements: int) -> torch.Tensor:
        """num_elements native squeezes -> ``(..., n, 4W)`` canonical LE bytes."""
        std = ff.from_mont(self.spec, self.squeeze_native_field_elements(num_elements))
        v = std.to(torch.int64) & ff.WORD_MASK
        by = torch.stack([(v >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1)
        return by.reshape(std.shape[:-1] + (-1,)).to(torch.uint8)

    def squeeze_bytes(self, num_bytes: int) -> torch.Tensor:
        """``(..., num_bytes)`` uint8 (src/sponge/poseidon/mod.rs:259-273)."""
        usable = (self.spec.nbits - 1) // 8
        n = -(-num_bytes // usable)
        by = self._squeeze_canonical_bytes_le(n)[..., :usable]
        return by.reshape(by.shape[:-2] + (n * usable,))[..., :num_bytes]

    def squeeze_bits(self, num_bits: int) -> torch.Tensor:
        """``(..., num_bits)`` bool, LE bit order per element
        (src/sponge/poseidon/mod.rs:275-289)."""
        usable = self.spec.nbits - 1
        n = -(-num_bits // usable)
        std = ff.from_mont(self.spec, self.squeeze_native_field_elements(n))
        v = std.to(torch.int64) & ff.WORD_MASK
        shifts = torch.arange(32, dtype=torch.int64, device=v.device)
        bits = ((v.unsqueeze(-1) >> shifts) & 1).reshape(std.shape[:-1] + (-1,))[..., :usable]
        return bits.reshape(bits.shape[:-2] + (n * usable,))[..., :num_bits] == 1

    def squeeze_field_elements_with_sizes(self, target_spec: FieldSpec, sizes) -> torch.Tensor:
        """Cross-field squeeze via bit truncation (src/sponge/mod.rs:57-96);
        ``(..., len(sizes), W_target)`` Montgomery words of ``target_spec``."""
        from crypto_primitives_tpu_torch.models.sponge import FieldElementSize

        if not sizes:
            return torch.zeros(
                self.batch_shape + (0, target_spec.num_words),
                dtype=torch.int32, device=self.device,
            )
        if target_spec.p == self.spec.p and all(s == FieldElementSize.FULL for s in sizes):
            return self.squeeze_native_field_elements(len(sizes))
        nbs = [FieldElementSize.num_bits(s, target_spec) for s in sizes]
        bits = self.squeeze_bits(sum(nbs))
        outs = []
        window = 0
        for nb in nbs:
            outs.append(_bits_le_to_field(bits[..., window : window + nb], target_spec))
            window += nb
        return torch.stack(outs, dim=-2)

    def fork(self, domain: bytes) -> "PoseidonSpongeBatch":
        """Domain separation (src/sponge/mod.rs:145-153): a copy that has
        absorbed the length-prefixed domain bytes."""
        from crypto_primitives_tpu_torch.models.sponge.absorb import (
            Usize,
            to_sponge_bytes,
            to_sponge_field_elements,
        )

        new = PoseidonSpongeBatch(self.config, state=self.state, device=self.device)
        new.mode, new.index = self.mode, self.index
        inp = to_sponge_bytes(Usize(len(domain)), self.spec) + bytes(domain)
        packed = torch.from_numpy(self.spec.pack(to_sponge_field_elements(inp, self.spec)))
        new.absorb(packed.to(self.device).expand(self.batch_shape + tuple(packed.shape)))
        return new


# ----------------------------------------------------------------------
# Host sponge (Python ints, exact reference semantics)
# ----------------------------------------------------------------------


class PoseidonSponge:
    """Host-side duplex sponge over Python ints (the parity oracle)."""

    def __init__(self, config: PoseidonConfig):
        _require_config(config)
        self.config = config
        self.p = config.field.p
        self.state = [0] * config.t
        self.mode = "absorbing"
        self.index = 0

    def clone(self) -> "PoseidonSponge":
        s = PoseidonSponge(self.config)
        s.state = list(self.state)
        s.mode, s.index = self.mode, self.index
        return s

    # SpongeExt twin
    def into_state(self):
        return (list(self.state), self.mode, self.index)

    @classmethod
    def from_state(cls, state, config):
        s = cls(config)
        s.state, s.mode, s.index = list(state[0]), state[1], state[2]
        return s

    def permute(self):
        """Python-int rounds: ark, S-box (all elements in full rounds, the
        first in partial rounds), MDS (src/sponge/poseidon/mod.rs:98-121)."""
        cfg, p = self.config, self.p
        state = list(self.state)
        rf2 = cfg.full_rounds // 2
        for i in range(cfg.full_rounds + cfg.partial_rounds):
            state = [(s + a) % p for s, a in zip(state, cfg.ark[i])]
            if i < rf2 or i >= rf2 + cfg.partial_rounds:
                state = [pow(s, cfg.alpha, p) for s in state]
            else:
                state[0] = pow(state[0], cfg.alpha, p)
            state = [sum(m * s for m, s in zip(row, state)) % p for row in cfg.mds]
        self.state = state

    def _absorb_internal(self, rate_start: int, elems: Sequence[int]):
        cfg = self.config
        pos = 0
        while True:
            remaining = len(elems) - pos
            if rate_start + remaining <= cfg.rate:
                for i in range(remaining):
                    j = cfg.capacity + rate_start + i
                    self.state[j] = (self.state[j] + elems[pos + i]) % self.p
                self.mode, self.index = "absorbing", rate_start + remaining
                return
            n = cfg.rate - rate_start
            for i in range(n):
                j = cfg.capacity + rate_start + i
                self.state[j] = (self.state[j] + elems[pos + i]) % self.p
            self.permute()
            pos += n
            rate_start = 0

    def absorb_elements(self, elems: Sequence[int]):
        """Absorb raw field elements (already encoded)."""
        if not elems:
            return
        if self.mode == "absorbing":
            idx = self.index
            if idx == self.config.rate:
                self.permute()
                idx = 0
            self._absorb_internal(idx, elems)
        else:
            self._absorb_internal(0, elems)

    def absorb(self, value):
        """Absorb any encodable value (see models/sponge/absorb.py)."""
        from crypto_primitives_tpu_torch.models.sponge.absorb import to_sponge_field_elements

        self.absorb_elements(to_sponge_field_elements(value, self.config.field))

    def _squeeze_internal(self, rate_start: int, n: int) -> list:
        cfg = self.config
        out = []
        remaining = n
        while True:
            if rate_start + remaining <= cfg.rate:
                out.extend(
                    self.state[cfg.capacity + rate_start : cfg.capacity + rate_start + remaining]
                )
                self.mode, self.index = "squeezing", rate_start + remaining
                return out
            k = cfg.rate - rate_start
            out.extend(self.state[cfg.capacity + rate_start : cfg.capacity + cfg.rate])
            remaining -= k
            if remaining > 0:
                self.permute()
            rate_start = 0

    def squeeze_native_field_elements(self, n: int) -> list:
        if self.mode == "absorbing":
            self.permute()
            return self._squeeze_internal(0, n)
        idx = self.index
        if idx == self.config.rate:
            self.permute()
            idx = 0
        return self._squeeze_internal(idx, n)

    def squeeze_bytes(self, num_bytes: int) -> bytes:
        """src/sponge/poseidon/mod.rs:259-273."""
        spec = self.config.field
        usable_bytes = (spec.nbits - 1) // 8
        num_elements = -(-num_bytes // usable_bytes)
        elems = self.squeeze_native_field_elements(num_elements)
        out = b"".join(spec.to_bytes_le(e)[:usable_bytes] for e in elems)
        return out[:num_bytes]

    def squeeze_bits(self, num_bits: int) -> list:
        """src/sponge/poseidon/mod.rs:275-289 (LE bit order per element)."""
        usable_bits = self.config.field.nbits - 1
        num_elements = -(-num_bits // usable_bits)
        bits = []
        for e in self.squeeze_native_field_elements(num_elements):
            bits.extend(bool((e >> i) & 1) for i in range(usable_bits))
        return bits[:num_bits]

    def _bits_with_sizes(self, sizes, spec: FieldSpec) -> list:
        """The trait's default path: squeeze bits, cut them by size, read
        each chunk as LE bytes mod p (src/sponge/mod.rs:57-96)."""
        from crypto_primitives_tpu_torch.models.sponge import FieldElementSize

        nbs = [FieldElementSize.num_bits(s, spec) for s in sizes]
        bits = self.squeeze_bits(sum(nbs))
        out = []
        window = 0
        for nb in nbs:
            value = sum(1 << i for i, b in enumerate(bits[window : window + nb]) if b)
            window += nb
            out.append(value % spec.p)
        return out

    def squeeze_field_elements_with_sizes(self, target_spec: FieldSpec, sizes) -> list:
        """Cross-field squeeze via bit truncation (sizes are FieldElementSize
        values)."""
        from crypto_primitives_tpu_torch.models.sponge import FieldElementSize

        if target_spec.p == self.config.field.p:
            if all(s == FieldElementSize.FULL for s in sizes):
                return self.squeeze_native_field_elements(len(sizes))
            return self._bits_with_sizes(sizes, self.config.field)
        if not sizes:
            return []
        return self._bits_with_sizes(sizes, target_spec)

    def squeeze_field_elements(self, n: int, target_spec: Optional[FieldSpec] = None) -> list:
        from crypto_primitives_tpu_torch.models.sponge import FieldElementSize

        if target_spec is None or target_spec.p == self.config.field.p:
            return self.squeeze_native_field_elements(n)
        return self.squeeze_field_elements_with_sizes(target_spec, [FieldElementSize.FULL] * n)

    def fork(self, domain: bytes) -> "PoseidonSponge":
        """Domain separation (src/sponge/mod.rs:145-153)."""
        from crypto_primitives_tpu_torch.models.sponge.absorb import Usize, to_sponge_bytes

        new = self.clone()
        new.absorb(to_sponge_bytes(Usize(len(domain)), self.config.field) + bytes(domain))
        return new


# ----------------------------------------------------------------------
# Default parameters (traits.rs twin)
# ----------------------------------------------------------------------

# (rate, alpha, full_rounds, partial_rounds, skip_matrices) for BLS12-381 Fr,
# from the reference's in-tree instance (src/sponge/test.rs:13-32).
BLS12_381_FR_PARAMS_OPT_FOR_CONSTRAINTS = [
    (2, 17, 8, 31, 0),
    (3, 5, 8, 56, 0),
    (4, 5, 8, 56, 0),
    (5, 5, 8, 57, 0),
    (6, 5, 8, 57, 0),
    (7, 5, 8, 57, 0),
    (8, 5, 8, 57, 0),
]
BLS12_381_FR_PARAMS_OPT_FOR_WEIGHTS = [
    (2, 257, 8, 13, 0),
    (3, 257, 8, 13, 0),
    (4, 257, 8, 13, 0),
    (5, 257, 8, 13, 0),
    (6, 257, 8, 13, 0),
    (7, 257, 8, 13, 0),
    (8, 257, 8, 13, 0),
]

_DEFAULT_PARAM_TABLES = {
    "bls12_381_fr": (
        BLS12_381_FR_PARAMS_OPT_FOR_CONSTRAINTS,
        BLS12_381_FR_PARAMS_OPT_FOR_WEIGHTS,
    ),
}


def find_poseidon_ark_and_mds(
    spec: FieldSpec, rate: int, full_rounds: int, partial_rounds: int, skip_matrices: int
):
    """Derive (ark, mds) from the Grain LFSR; mds is the Cauchy matrix
    1/(x_i + y_j) (src/sponge/poseidon/traits.rs:105-146)."""
    global derive_seconds
    t0 = time.perf_counter()
    p = spec.p
    t = rate + 1
    lfsr = PoseidonGrainLFSR(False, spec.nbits, t, full_rounds, partial_rounds)
    ark = [
        lfsr.get_field_elements_rejection_sampling(p, t)
        for _ in range(full_rounds + partial_rounds)
    ]
    for _ in range(skip_matrices):
        lfsr.get_field_elements_mod_p(p, 2 * t)
    xs = lfsr.get_field_elements_mod_p(p, t)
    ys = lfsr.get_field_elements_mod_p(p, t)
    mds = [[pow((x + y) % p, -1, p) for y in ys] for x in xs]
    derive_seconds += time.perf_counter() - t0
    return ark, mds


_DEFAULT_CONFIGS: dict = {}

_NO_CONFIG_HINT = (
    "no Poseidon parameters (get_default_poseidon_parameters returns None where the "
    "field or the rate has no default table); derive them with "
    "find_poseidon_ark_and_mds and build a PoseidonConfig"
)


def _require_config(config) -> None:
    """The sponges' check of their ``config``: ``None`` (what
    :func:`get_default_poseidon_parameters` returns for a missing table)
    raises :class:`MissingParameters` with the way to derive one."""
    if config is None:
        raise MissingParameters(_NO_CONFIG_HINT)
    if not isinstance(config, PoseidonConfig):
        raise TypeError(f"expected a PoseidonConfig, got {type(config).__name__}")


def get_default_poseidon_parameters(
    spec: FieldSpec, rate: int, optimized_for_weights: bool = False
) -> Optional[PoseidonConfig]:
    """traits.rs:69-102 twin (capacity always 1).

    Returns ``None``, as the JAX package does, where there is no table for
    the field or none for the rate; the sponges raise
    :class:`MissingParameters` when handed that ``None``."""
    key = (spec, rate, bool(optimized_for_weights))
    if key in _DEFAULT_CONFIGS:
        return _DEFAULT_CONFIGS[key]
    tables = _DEFAULT_PARAM_TABLES.get(spec.name)
    if tables is None:
        return None
    params_set = tables[1] if optimized_for_weights else tables[0]
    row = next((r for r in params_set if r[0] == rate), None)
    if row is None:
        return None
    _, alpha, full_r, partial_r, skip = row
    ark, mds = find_poseidon_ark_and_mds(spec, rate, full_r, partial_r, skip)
    cfg = PoseidonConfig(
        field=spec, full_rounds=full_r, partial_rounds=partial_r, alpha=alpha,
        ark=ark, mds=mds, rate=rate, capacity=1,
    )
    _DEFAULT_CONFIGS[key] = cfg
    return cfg
