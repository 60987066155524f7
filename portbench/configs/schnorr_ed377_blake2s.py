"""``schnorr_ed377_blake2s``: the program's Schnorr verification at upstream's
``benches/signature.rs`` deployment and the plain reference beside it.

``Program`` drives the port's public entry points:
``Schnorr(ED_ON_BLS12_377, digest=Blake2s-256)``, its ``setup`` from a
``random.Random`` seeded from the run's seed (32 salt bytes and a generator
in the prime-order subgroup), the pool's keys and signatures from
``keygen_batch`` and ``sign_batch`` (one ``random.Random`` for both), and
``verify_batch`` on the card with Python lists in and a list of bools out
(s's bits and K4 at the fixed-base 2^16 x 84, e pk by the windowed product in
plain torch, the complete addition A2, the affine step A1, the challenge
hashed a row on the host).  ``Reference`` (``reference/schnorr_ref``) takes
the generator, the salt, the keys, the messages and the signatures, checks
the generator and the keys, and verifies by its own doubling powers and one
pairwise tree a row.

``Control`` is the reference in the program's place with r' hashed
projective, X and Y undivided; ``planted`` puts a fault into the curve tier
while ``verify_batch`` runs (set-up's keygen and signing stay sound): e's
top window dropped before the windowed product, s's bits shifted one place
before the fixed-base product, or the second half of the rows' e pk replaced
by the identity.  With any of them a run must read not correct.
"""

from __future__ import annotations

import contextlib
import hashlib
import inspect
import random

import torch
import torch.nn.functional as F

from portbench.reference.schnorr_ref import SchnorrRef


def blake2s_256(data: bytes) -> bytes:
    """Blake2s with a 32-byte digest, unkeyed (upstream's ``Blake2s256``)."""
    return hashlib.blake2s(data).digest()


def kernel_calls(cfg: dict, op: str, rows: int) -> list:
    """A verify batch is one K4 call: s G over the generator's doubling-power
    table (the windowed product, A2 and A1 have no roofline here)."""
    return [("k4_msm_te", {"batch": rows, "groups": -(-cfg["scalar_bits"] // cfg["group_w"]),
                           "w": cfg["group_w"], "num_words": cfg["num_words"]})]


class Program:
    def __init__(self, cfg: dict, device):
        from crypto_primitives_tpu_torch.models.signature import Schnorr
        from crypto_primitives_tpu_torch.ops import add_kernel, affine_kernel, curve_fast, curves_known, msm_kernel

        curve = getattr(curves_known, cfg["curve"].upper())
        p = curve.base.p
        windowed_w = inspect.signature(curve_fast.scalar_mul_bits_windowed).parameters["w"].default
        fixed_w = inspect.signature(curve_fast.fixed_base_mul).parameters["w"].default
        stated = (int(cfg["modulus"]), cfg["a"] % p, cfg["d"], int(cfg["subgroup_order"]), cfg["num_words"],
                  cfg["scalar_bits"], cfg["window_w"], cfg["group_w"])
        got = (p, curve.a, curve.d, curve.scalar.p, curve.base.num_words, curve.scalar.nbits, windowed_w, fixed_w)
        if got != stated:
            raise ValueError(f"the program's curve and windows {got} are not the configuration's {stated}")
        self.cfg = cfg
        self.scheme = Schnorr(curve, digest=blake2s_256)
        self.device = torch.device(device)
        self._kernels = (msm_kernel, add_kernel, affine_kernel)

    def setup(self, seed: int) -> None:
        self.params = self.scheme.setup(random.Random(seed))
        if len(self.params.salt) != self.cfg["salt_bytes"]:
            raise ValueError(f"a {len(self.params.salt)}-byte salt, not {self.cfg['salt_bytes']}")

    def public(self) -> tuple:
        """(generator, salt): what a verifier holds."""
        return self.params.generator, self.params.salt

    def keys_and_signatures(self, seed: int, messages: list) -> tuple:
        """(keys, signatures), one keypair a message, each message signed
        under its own key: ``keygen_batch`` then ``sign_batch``, both drawing
        from one ``random.Random(seed)``."""
        rng = random.Random(seed)
        pairs = self.scheme.keygen_batch(self.params, rng, len(messages), device=self.device)
        sigs = self.scheme.sign_batch(self.params, [sk for _, sk in pairs], messages, rng, device=self.device)
        return [pk for pk, _ in pairs], sigs

    def verify(self, inputs) -> list:
        pks, messages, sigs = inputs
        return self.scheme.verify_batch(self.params, pks, messages, sigs, device=self.device)

    def launches(self) -> dict:
        return {k.__name__: k.launches for k in self._kernels}

    def release(self) -> None:
        del self.params  # the generator's table stays in curve_fast's cache, as in any process


class Reference(SchnorrRef):
    def __init__(self, cfg: dict, device, **kw):
        super().__init__(int(cfg["modulus"]), cfg["d"], int(cfg["subgroup_order"]), cfg["scalar_bits"],
                         cfg["num_words"], blake2s_256, device, **kw)

    def verdicts(self, public, inputs, projective: bool = False):
        """(B,) bool: the reference's verdicts on (keys, messages, the port's
        signatures) under (generator, salt)."""
        (generator, salt), (pks, messages, sigs) = public, inputs
        pairs = [(g.prover_response, g.verifier_challenge) for g in sigs]
        return self.verify(generator, salt, pks, messages, pairs, projective=projective)


class Control(Program):
    """The control: the program's set-up, keys and signatures, then the
    plain reference's verification with r' hashed projective, X and Y
    undivided by Z."""

    def __init__(self, cfgmod, cfg: dict, device):
        super().__init__(cfg, device)
        self.ref = Reference(cfg, device)

    def verify(self, inputs) -> list:
        return self.ref.verdicts(self.public(), inputs, projective=True).tolist()

    def launches(self) -> dict:
        return {}


def _top_window_dropped(orig):
    def windowed(curve, base, bits, w=4):
        top = (bits.shape[-1] - 1) // w * w  # the first bit of the most significant window
        return orig(curve, base, F.pad(bits[..., :top], (0, bits.shape[-1] - top)), w)

    return windowed


def _bits_shifted(orig):
    def fixed(curve, pt, bits, w=3):
        return orig(curve, pt, F.pad(bits[..., :-1], (1, 0)), w)  # bit j moves to j + 1

    return fixed


def _second_half_identity(orig):
    def windowed(curve, base, bits, w=4):
        out = orig(curve, base, bits, w).clone()
        ident = torch.from_numpy(curve.pack_points((0, 1))).to(out.device)
        out[out.shape[0] // 2:] = ident
        return out

    return windowed


# fault: (the curve_fast name it replaces, the replacement's maker)
FAULTS = {"e_top_window_dropped": ("scalar_mul_bits_windowed", _top_window_dropped),
          "s_bits_shifted": ("fixed_base_mul", _bits_shifted),
          "second_half_identity": ("scalar_mul_bits_windowed", _second_half_identity)}


@contextlib.contextmanager
def planted(fault: str):
    """``verify_batch`` with ``fault`` in the curve tier while it runs."""
    from crypto_primitives_tpu_torch.models.signature import Schnorr
    from crypto_primitives_tpu_torch.ops import curve_fast

    name, make = FAULTS[fault]
    verify = Schnorr.verify_batch

    def faulty(self, *args, **kw):
        saved = getattr(curve_fast, name)
        setattr(curve_fast, name, make(saved))
        try:
            return verify(self, *args, **kw)
        finally:
            setattr(curve_fast, name, saved)

    Schnorr.verify_batch = faulty
    try:
        yield
    finally:
        Schnorr.verify_batch = verify
