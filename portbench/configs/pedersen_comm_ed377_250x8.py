"""``pedersen_comm_ed377_250x8``: the program's Pedersen commitment at
upstream's ``benches/comm.rs`` window and the plain reference beside it.

``Program`` drives the port's public entry points:
``PedersenCommitment(ED_ON_BLS12_377, Window(250, 8))``, its ``setup`` from
a ``random.Random`` seeded from the run's seed (251 powers of the blinding
base h, then the CRH's 8 x 250 generators), and ``commit_batch`` on the card
(the message's bits and K4 at 2^16 x 342, the opening's bits and K4 at
2^16 x 84, the complete addition of the two sums, the affine step).
``Reference`` (``reference/pedersen_comm_ref``) takes the program's window
bases ``generators[w][0]`` and h, checks them, derives their doubling powers
itself and sums each row's message and opening powers by one pairwise tree.
Inputs are the benchmark's: uniform records and uniform openings below r,
made on the device from a seed.

``Control`` is the reference in the program's place with the affine step
left out, and ``planted`` puts a fault into the curve tier's grouped sum
(``ops.curve_fast.conditional_sum_grouped_auto``), on the blinding call or
on the message call: with either, a run must read not correct.
"""

from __future__ import annotations

import contextlib
import random

import torch
import torch.nn.functional as F

from portbench.reference.pedersen_comm_ref import PedersenCommRef


LIMB = 32  # bits a limb of a drawn opening
CANDIDATES = 16  # drawn a row at once: all 16 at or above r with probability 0.417^16, below 1e-6


def _limbs(value: int, n: int, device) -> torch.Tensor:
    return torch.tensor([(value >> (LIMB * j)) & (1 << LIMB) - 1 for j in range(n)], dtype=torch.int64, device=device)


def below(limbs: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """limbs (..., L) and bound (L,), both little-endian 32-bit limbs ->
    (...) bool: the value is below the bound's."""
    lt = torch.zeros(limbs.shape[:-1], dtype=torch.bool, device=limbs.device)
    for j in range(limbs.shape[-1]):  # from the lowest limb up: a higher limb decides unless it is equal
        lt = (limbs[..., j] < bound[j]) | ((limbs[..., j] == bound[j]) & lt)
    return lt


def make_inputs(cfg: dict, seed: int, n: int, device) -> tuple:
    """(records (n, input_bytes) uint8, opening bits (n, opening_bits) uint8):
    uniform bytes, and openings uniform below r: each row takes the first of
    CANDIDATES uniform opening_bits-bit values that is below r, and a row
    with none draws again; the opening's little-endian bits."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    records = torch.randint(0, 256, (n, cfg["input_bytes"]), dtype=torch.uint8, device=device, generator=g)
    nbits = cfg["opening_bits"]
    L = -(-nbits // LIMB)
    bound = _limbs(int(cfg["subgroup_order"]), L, device)
    values = torch.empty((n, L), dtype=torch.int64, device=device)
    rows = torch.arange(n, device=device)
    while rows.numel():
        draw = torch.randint(0, 1 << LIMB, (rows.numel(), CANDIDATES, L), dtype=torch.int64, device=device,
                             generator=g)
        draw[..., -1] &= (1 << (nbits - LIMB * (L - 1))) - 1
        ok = below(draw, bound)
        hit = ok.any(-1)
        first = ok.to(torch.int32).argmax(-1)  # the first candidate below r
        values[rows[hit]] = draw[hit, first[hit]]
        rows = rows[~hit]
    shifts = torch.arange(LIMB, dtype=torch.int64, device=device)
    bits = ((values[:, :, None] >> shifts) & 1).flatten(1)[:, :nbits]
    return records, bits.to(torch.uint8)


def kernel_calls(cfg: dict, op: str, rows: int) -> list:
    """A batch is two K4 calls: the message's groups, then the opening's over
    the blinding table."""
    shape = {"w": cfg["group_w"], "num_words": cfg["num_words"]}
    return [("k4_msm_te", {"batch": rows, "groups": -(-nbits // cfg["group_w"]), **shape})
            for nbits in (8 * cfg["input_bytes"], cfg["opening_bits"])]


class Program:
    def __init__(self, cfg: dict, device):
        from crypto_primitives_tpu_torch.models.commitment import PedersenCommitment
        from crypto_primitives_tpu_torch.models.crh import Window, pedersen
        from crypto_primitives_tpu_torch.ops import affine_kernel, curves_known, msm_kernel

        curve = getattr(curves_known, cfg["curve"].upper())
        p = curve.base.p
        stated = (int(cfg["modulus"]), cfg["a"] % p, cfg["d"], int(cfg["subgroup_order"]), cfg["num_words"],
                  cfg["group_w"], cfg["opening_bits"])
        got = (p, curve.a, curve.d, curve.scalar.p, curve.base.num_words, pedersen.GROUP_W, curve.scalar.nbits)
        if got != stated:
            raise ValueError(f"the program's curve and table width {got} are not the configuration's {stated}")
        self.comm = PedersenCommitment(curve, Window(cfg["window_size"], cfg["num_windows"]))
        self.device = torch.device(device)
        self._kernels = (msm_kernel, affine_kernel)

    def setup(self, seed: int) -> None:
        self.params = self.comm.setup(random.Random(seed))

    def bases(self) -> tuple:
        return [win[0] for win in self.params.generators], self.params.randomness_generator[0]

    def hash(self, inputs) -> torch.Tensor:
        records, opening = inputs
        return self.comm.commit_batch(self.params, records, opening, device=self.device)

    def to_host(self, digests):
        return digests.cpu().numpy()

    def launches(self) -> dict:
        return {k.__name__: k.launches for k in self._kernels}

    def release(self) -> None:
        del self.params  # and the grouped tables it keeps on the device


class Reference(PedersenCommRef):
    def __init__(self, cfg: dict, device, **kw):
        super().__init__(int(cfg["modulus"]), cfg["d"], int(cfg["subgroup_order"]), cfg["window_size"],
                         cfg["num_windows"], cfg["num_words"], device, **kw)


class Control(Program):
    """The control: the program's set-up, then the plain reference's sums
    with the affine step left out, projective X and Y returned undivided."""

    def __init__(self, cfgmod, cfg: dict, device):
        super().__init__(cfg, device)
        self.ref = Reference(cfg, device)

    def hash(self, inputs):
        sums = self.ref.projective(self.bases(), inputs)
        return self.ref.words([v for X, Y, _ in sums for v in (X, Y)]).reshape(len(sums), 2, -1)

    def to_host(self, digests):
        return digests

    def launches(self) -> dict:
        return {}


def _blinding(params_like) -> bool:
    """The grouped sum over the commitment's blinding table (the message's
    runs over the CRH's parameters)."""
    from crypto_primitives_tpu_torch.models.commitment.pedersen import PedersenCommitmentParameters

    return isinstance(params_like, PedersenCommitmentParameters)


def _blind_dropped(orig):
    def msm(curve, params_like, bits, w):
        if _blinding(params_like):
            bits = torch.zeros_like(bits)  # every index 0: the identity
        return orig(curve, params_like, bits, w)

    return msm


def _opening_bit_shifted(orig):
    def msm(curve, params_like, bits, w):
        if _blinding(params_like):
            bits = F.pad(bits[..., :-1], (1, 0))  # bit j moves to j + 1
        return orig(curve, params_like, bits, w)

    return msm


def _second_half_zeroed(orig):
    def msm(curve, params_like, bits, w):
        out = orig(curve, params_like, bits, w)
        if not _blinding(params_like):
            out = out.clone()
            out[out.shape[0] // 2:] = 0
        return out

    return msm


FAULTS = {"blind_dropped": _blind_dropped, "opening_bit_shifted": _opening_bit_shifted,
          "second_half_zeroed": _second_half_zeroed}


@contextlib.contextmanager
def planted(fault: str):
    """The curve tier's grouped sum with ``fault`` in it: the blinding call's
    sum the identity, the opening's bits shifted one place up before the
    blinding call, or the second half of the message call's rows zeroed."""
    from crypto_primitives_tpu_torch.ops import curve_fast

    saved = curve_fast.conditional_sum_grouped_auto
    curve_fast.conditional_sum_grouped_auto = FAULTS[fault](saved)
    try:
        yield
    finally:
        curve_fast.conditional_sum_grouped_auto = saved
