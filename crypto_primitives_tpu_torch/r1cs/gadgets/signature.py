"""Schnorr rerandomization gadget.

Twin of ``crypto_primitives_tpu/r1cs/gadgets/signature.py``, itself the
twin of the reference's src/signature/constraints.rs (`SigVerifyGadget` is
a trait only: the reference implements no Schnorr verify circuit) and
schnorr/constraints.rs:60-116:
`SchnorrRandomizePkGadget::randomize` = pk + scalar_mul_le(randomness bits)
of the parameter generator; parameters/public key allocated as vars.
"""

from __future__ import annotations

from typing import List

from crypto_primitives_tpu_torch.models.signature.schnorr import SchnorrParameters
from crypto_primitives_tpu_torch.ops.curve import TECurveSpec
from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem
from crypto_primitives_tpu_torch.r1cs.gadgets.curve import SWProjectiveVar, TEAffineVar
from crypto_primitives_tpu_torch.r1cs.vars import Boolean, UInt8


class SchnorrRandomizePkGadget:
    """Generic over the curve var, like the reference gadget's GC: CurveVar
    bound (schnorr/constraints.rs:32-59): any var exposing
    conditional_add_constant works — TEAffineVar and SWProjectiveVar both
    do (tests/test_torch_r1cs_curve_gadgets.py exercises both models)."""

    def __init__(self, curve):
        # curve: TECurveSpec or SWCurveSpec (host double_host shared)
        self.curve = curve

    @classmethod
    def var_for_curve(cls, curve):
        """The CurveVar type matching this curve model (the reference picks
        GC by the instantiation; here by the curve spec's model)."""
        return TEAffineVar if isinstance(curve, TECurveSpec) else SWProjectiveVar

    def randomize(self, cs: ConstraintSystem, params: SchnorrParameters,
                  public_key, randomness: List[UInt8]):
        """schnorr/constraints.rs:60-77: the randomness bytes' bits (the
        native multiplier's 2^position weights use the byte-MSB-first
        stream; scalar_mul_le consumes LSB-first bits of each byte's
        reversed order) drive conditional adds of 2^i * generator."""
        # bit i (stream order: byte-major, MSB-first within byte) has weight
        # 2^i — mirror models/signature/schnorr._randomness_multiplier
        bits: List[Boolean] = []
        for byte in randomness:
            bits.extend(reversed(byte.bits))  # MSB first
        acc = public_key
        g = params.generator
        for bit in bits:
            acc = acc.conditional_add_constant(bit, g)
            g = self.curve.double_host(g)
        return acc
