"""``pedersen_crh_ed377_250x8``: the program's Pedersen CRH at upstream's
``benches/crh.rs`` window and the plain reference beside it.

``Program`` drives the port's public entry points:
``PedersenCRH(ED_ON_BLS12_377, Window(250, 8))``, its ``setup`` from a
``random.Random`` seeded from the run's seed, and ``evaluate_batch`` on the
card (the bits, K4, the affine step).  ``Reference``
(``reference/pedersen_ref``) takes the program's window bases
``generators[w][0]``, checks them, derives their doubling powers itself and
sums each row's by a pairwise tree.  Inputs are the benchmark's: uniform
bytes made on the device from a seed.

``Control`` is the reference in the program's place with the affine step
left out, and ``planted`` puts a fault into K4's wrapper
(``ops.msm_kernel.grouped_msm``): with either, a run must read not correct.
"""

from __future__ import annotations

import contextlib
import random

import torch

from portbench.reference.pedersen_ref import PedersenRef


def make_inputs(cfg: dict, seed: int, n: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n, cfg["input_bytes"]), dtype=torch.uint8, device=device, generator=g)


def kernel_calls(cfg: dict, op: str, rows: int) -> list:
    """A batch is one K4 call over the groups that the input bits reach."""
    groups = -(-8 * cfg["input_bytes"] // cfg["group_w"])
    return [("k4_msm_te", {"batch": rows, "groups": groups, "w": cfg["group_w"], "num_words": cfg["num_words"]})]


class Program:
    def __init__(self, cfg: dict, device):
        from crypto_primitives_tpu_torch.models.crh import PedersenCRH, Window, pedersen
        from crypto_primitives_tpu_torch.ops import curves_known, msm_kernel

        curve = getattr(curves_known, cfg["curve"].upper())
        p = curve.base.p
        stated = (int(cfg["modulus"]), cfg["a"] % p, cfg["d"], int(cfg["subgroup_order"]), cfg["num_words"],
                  cfg["group_w"])
        got = (p, curve.a, curve.d, curve.scalar.p, curve.base.num_words, pedersen.GROUP_W)
        if got != stated:
            raise ValueError(f"the program's curve and table width {got} are not the configuration's {stated}")
        self.crh = PedersenCRH(curve, Window(cfg["window_size"], cfg["num_windows"]))
        self.device = torch.device(device)
        self._kernel = msm_kernel

    def setup(self, seed: int) -> None:
        self.params = self.crh.setup(random.Random(seed))

    def bases(self) -> list:
        return [win[0] for win in self.params.generators]

    def hash(self, inputs: torch.Tensor) -> torch.Tensor:
        return self.crh.evaluate_batch(self.params, inputs, device=self.device)

    def to_host(self, digests):
        return digests.cpu().numpy()

    def launches(self) -> dict:
        return {self._kernel.__name__: self._kernel.launches}

    def release(self) -> None:
        del self.params  # and the grouped table it keeps on the device


class Reference(PedersenRef):
    def __init__(self, cfg: dict, device, **kw):
        super().__init__(int(cfg["modulus"]), cfg["d"], int(cfg["subgroup_order"]), cfg["window_size"],
                         cfg["num_windows"], cfg["num_words"], device, **kw)


class Control(Program):
    """The control: the program's set-up, then the plain reference's sums
    with the affine step left out, projective X and Y returned undivided."""

    def __init__(self, cfgmod, cfg: dict, device):
        super().__init__(cfg, device)
        self.ref = Reference(cfg, device)

    def hash(self, inputs: torch.Tensor):
        sums = self.ref.projective(self.bases(), inputs)
        return self.ref.words([v for X, Y, _ in sums for v in (X, Y)]).reshape(len(sums), 2, -1)

    def to_host(self, digests):
        return digests

    def launches(self) -> dict:
        return {}


def _second_half_zeroed(orig):
    def msm(curve, table, idx):
        out = orig(curve, table, idx).clone()
        out[out.shape[0] // 2:] = 0
        return out

    return msm


def _row0_low_bit(orig):
    def msm(curve, table, idx):
        out = orig(curve, table, idx).clone()
        out[0, 0, 0] ^= 1
        return out

    return msm


def _last_group_dropped(orig):
    def msm(curve, table, idx):
        return orig(curve, table[:-1], idx[:, :-1].contiguous())

    return msm


FAULTS = {"second_half_zeroed": _second_half_zeroed, "row0_low_bit": _row0_low_bit,
          "last_group_dropped": _last_group_dropped}


@contextlib.contextmanager
def planted(fault: str):
    """K4's wrapper with ``fault`` in it: the second half of the rows zeroed,
    row 0's lowest bit flipped, or the last group left out."""
    from crypto_primitives_tpu_torch.ops import msm_kernel

    saved = msm_kernel.grouped_msm
    msm_kernel.grouped_msm = FAULTS[fault](saved)
    try:
        yield
    finally:
        msm_kernel.grouped_msm = saved
