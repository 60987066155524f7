"""ElGamal encryption gadget.

Twin of ``crypto_primitives_tpu/r1cs/gadgets/elgamal.py``, itself the twin
of the reference's src/encryption/elgamal/constraints.rs:
encrypt-only circuit — c1 = r*G (fixed-base conditional adds), s = r*pk
(variable-base scalar_mul_le), c2 = m + s (:206-237); `OutputVar{c1, c2}`
with EqGadget (:19-182).
"""

from __future__ import annotations

from typing import List

from crypto_primitives_tpu_torch.models.encryption.elgamal import ElGamalParameters
from crypto_primitives_tpu_torch.ops.curve import TECurveSpec
from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem
from crypto_primitives_tpu_torch.r1cs.gadgets.curve import TEAffineVar
from crypto_primitives_tpu_torch.r1cs.vars import Boolean


class ElGamalOutputVar:
    def __init__(self, c1: TEAffineVar, c2: TEAffineVar):
        self.c1 = c1
        self.c2 = c2

    @property
    def value(self):
        return (self.c1.value, self.c2.value)

    def is_eq(self, other: "ElGamalOutputVar") -> Boolean:
        return self.c1.is_eq(other.c1) & self.c2.is_eq(other.c2)

    def enforce_equal(self, other: "ElGamalOutputVar"):
        self.c1.enforce_equal(other.c1)
        self.c2.enforce_equal(other.c2)


class ElGamalEncGadget:
    def __init__(self, curve: TECurveSpec):
        self.curve = curve

    def randomness_bits(self, cs: ConstraintSystem, randomness: int) -> List[Boolean]:
        nbits = self.curve.scalar.nbits
        return [
            Boolean.new_witness(cs, bool((int(randomness) >> i) & 1)) for i in range(nbits)
        ]

    def encrypt(self, cs: ConstraintSystem, params: ElGamalParameters,
                message: TEAffineVar, randomness_bits: List[Boolean],
                public_key: TEAffineVar) -> ElGamalOutputVar:
        # c1 = r * G: fixed-base conditional adds of 2^i * G
        acc = TEAffineVar.identity(cs, self.curve)
        g = params.generator
        for bit in randomness_bits:
            acc = acc.conditional_add_constant(bit, g)
            g = self.curve.double_host(g)
        c1 = acc
        # s = r * pk (variable base), c2 = m + s
        s = public_key.scalar_mul_le(randomness_bits)
        c2 = message.add(s)
        return ElGamalOutputVar(c1, c2)
