"""SNARKGadget: the verify-a-SNARK-inside-a-circuit protocol.

Twin of ``crypto_primitives_tpu/r1cs/snark_gadget.py``, itself the twin of
the trait layer of the reference's src/snark/constraints.rs:25-116:
``SNARKGadget`` fixes the four associated var types (vk / processed-vk /
input / proof), the two verify entry points returning a circuit
``Boolean``, the ``verifier_size`` ordering hook, and the *unchecked*
allocators whose default implementation simply delegates to the checked
ones (constraints.rs:56-82).  The reference crate ships no concrete SNARK
(Groth16/Marlin implement the trait downstream); to exercise the protocol
end-to-end — including ``BooleanInputVar`` input packing across fields —
this module also provides ``MockLinSNARK``, an explicitly-labelled test
double whose "proof" is a linear functional of the public input over a
small field F, verified inside a CF-circuit with an exact integer
mod-p_F reduction (witnessed quotient/remainder + range checks), the same
cross-field shape a real pairing-equation verifier gadget has.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional

from crypto_primitives_tpu_torch.ops.field import FieldSpec
from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem
from crypto_primitives_tpu_torch.r1cs.snark import BooleanInputVar
from crypto_primitives_tpu_torch.r1cs.vars import Boolean, FpVar


# ----------------------------------------------------------------------
# Native-side SNARK protocol (ark-snark's SNARK / *SetupSNARK traits)
# ----------------------------------------------------------------------


class SNARK:
    """Protocol: circuit_specific_setup / prove / verify /
    process_vk / verify_with_processed_vk."""

    def circuit_specific_setup(self, circuit, rng):
        raise NotImplementedError

    def prove(self, pk, circuit, rng):
        raise NotImplementedError

    def verify(self, vk, public_input, proof) -> bool:
        pvk = self.process_vk(vk)
        return self.verify_with_processed_vk(pvk, public_input, proof)

    def process_vk(self, vk):
        raise NotImplementedError

    def verify_with_processed_vk(self, pvk, public_input, proof) -> bool:
        raise NotImplementedError


class CircuitSpecificSetupSNARK(SNARK):
    """Marker twin of ark-snark's CircuitSpecificSetupSNARK."""


class UniversalSetupSNARK(SNARK):
    """Marker twin of ark-snark's UniversalSetupSNARK (setup bound by a
    ComputationBound rather than a circuit)."""

    def universal_setup(self, bound, rng):
        raise NotImplementedError


# ----------------------------------------------------------------------
# Circuit-side protocol (constraints.rs:25-116)
# ----------------------------------------------------------------------


class SNARKGadget:
    """Protocol for verifying S: SNARK<F> proofs inside a CF-circuit.

    Concrete gadgets define the var types and the two verify methods;
    the unchecked allocators default to the checked ones exactly like the
    reference's default trait methods (constraints.rs:56-82) — override
    them only when subgroup/range checks are safe to skip (e.g. the proof
    is a public input re-checked outside the circuit)."""

    # associated var types (set by subclasses)
    VerifyingKeyVar = None
    ProcessedVerifyingKeyVar = None
    InputVar = None
    ProofVar = None

    @classmethod
    def verifier_size(cls, circuit_vk):
        """PartialOrd info on the verify-circuit cost for ``circuit_vk``
        (constraints.rs:36-44): for LPCP-style SNARKs the public-input
        length; for universal-setup SNARKs a degree bound."""
        raise NotImplementedError

    @classmethod
    def verify_with_processed_vk(cls, circuit_pvk, x, proof) -> Boolean:
        raise NotImplementedError

    @classmethod
    def verify(cls, circuit_vk, x, proof) -> Boolean:
        raise NotImplementedError

    # -- default unchecked allocators (constraints.rs:46-82) --

    @classmethod
    def new_proof_unchecked(cls, cs: ConstraintSystem, proof, mode: str = "witness"):
        return cls.ProofVar.new_variable(cs, proof, mode)

    @classmethod
    def new_verification_key_unchecked(
        cls, cs: ConstraintSystem, vk, mode: str = "witness"
    ):
        return cls.VerifyingKeyVar.new_variable(cs, vk, mode)


class CircuitSpecificSetupSNARKGadget(SNARKGadget):
    """Marker twin (constraints.rs:97-104)."""


class UniversalSetupSNARKGadget(SNARKGadget):
    """Marker twin (constraints.rs:106-113); subclasses set BoundCircuit."""

    BoundCircuit = None


# ----------------------------------------------------------------------
# Range helper
# ----------------------------------------------------------------------


def enforce_lt_constant(x: FpVar, c: int):
    """Enforce x < c for x already range-bound below 2^bitlen(c-1)+slack:
    witness w = (c-1) - x, decompose w into bitlen(c-1) bits, and add the
    linear tie x + w = c-1.  Sound over the integers because both sides
    are far below the CF modulus."""
    cs = x.cs
    nb = (c - 1).bit_length()
    w = FpVar.new_witness(cs, (c - 1 - x.value) % cs.field.p)
    (x + w).enforce_equal(FpVar.constant(cs, c - 1))
    w.to_bits_le(nb)


# ----------------------------------------------------------------------
# MockLinSNARK: the test double exercising the protocol end-to-end
# ----------------------------------------------------------------------


@dataclass
class MockVerifyingKey:
    f: FieldSpec
    alpha: int
    betas: List[int]


@dataclass
class MockProcessedVerifyingKey:
    f: FieldSpec
    alpha: int
    betas: List[int]


@dataclass
class MockProof:
    s: int


class MockLinSNARK(CircuitSpecificSetupSNARK):
    """TEST DOUBLE — NOT a sound argument system.  "Proves" the linear
    statement s = alpha + sum_i x_i * beta_i over F; exists solely to give
    the SNARKGadget protocol a concrete end-to-end instantiation (the
    reference crate itself ships only the trait)."""

    def __init__(self, f: FieldSpec):
        self.f = f

    def circuit_specific_setup(self, num_inputs: int, rng: random.Random):
        vk = MockVerifyingKey(
            self.f,
            rng.randrange(self.f.p),
            [rng.randrange(self.f.p) for _ in range(num_inputs)],
        )
        return vk, vk  # pk == vk for the mock

    def prove(self, pk: MockVerifyingKey, public_input: List[int], rng=None) -> MockProof:
        p = self.f.p
        s = pk.alpha
        for x, b in zip(public_input, pk.betas, strict=True):
            s = (s + x * b) % p
        return MockProof(s)

    def process_vk(self, vk: MockVerifyingKey) -> MockProcessedVerifyingKey:
        return MockProcessedVerifyingKey(vk.f, vk.alpha, list(vk.betas))

    def verify_with_processed_vk(self, pvk, public_input, proof) -> bool:
        p = self.f.p
        s = pvk.alpha
        for x, b in zip(public_input, pvk.betas, strict=True):
            s = (s + x * b) % p
        return s == proof.s


# -- var types --


class MockVerifyingKeyVar:
    """vk over CF: alpha/beta allocated as CF elements holding F values.
    Checked allocation range-proves every element < f.p; the unchecked
    path (new_variable via SNARKGadget.new_verification_key_unchecked)
    skips those checks."""

    def __init__(self, f: FieldSpec, alpha: FpVar, betas: List[FpVar]):
        self.f = f
        self.alpha = alpha
        self.betas = betas

    @classmethod
    def new_variable(
        cls, cs: ConstraintSystem, vk: MockVerifyingKey, mode: str = "witness",
        checked: bool = False,
    ) -> "MockVerifyingKeyVar":
        alloc = {
            "constant": FpVar.constant,
            "input": FpVar.new_input,
            "witness": FpVar.new_witness,
        }[mode]
        alpha = alloc(cs, vk.alpha)
        betas = [alloc(cs, b) for b in vk.betas]
        if checked and mode != "constant":
            for v in [alpha] + betas:
                v.to_bits_le(vk.f.nbits)
                enforce_lt_constant(v, vk.f.p)
        return cls(vk.f, alpha, betas)

    @classmethod
    def new_witness_checked(cls, cs, vk):
        return cls.new_variable(cs, vk, "witness", checked=True)


class MockProofVar:
    def __init__(self, s: FpVar, f: FieldSpec):
        self.s = s
        self.f = f

    @classmethod
    def new_variable(
        cls, cs: ConstraintSystem, proof: MockProof, mode: str = "witness",
        f: Optional[FieldSpec] = None, checked: bool = False,
    ) -> "MockProofVar":
        alloc = {
            "constant": FpVar.constant,
            "input": FpVar.new_input,
            "witness": FpVar.new_witness,
        }[mode]
        s = alloc(cs, proof.s)
        if checked and f is not None and mode != "constant":
            s.to_bits_le(f.nbits)
            enforce_lt_constant(s, f.p)
        return cls(s, f)


class MockLinSNARKGadget(CircuitSpecificSetupSNARKGadget):
    """SNARKGadget instance for MockLinSNARK over constraint field CF.

    Requires n * f.p^2 < cf.p so the linear accumulation cannot wrap the
    constraint field (checked in verify); the mod-f.p reduction is done
    with a witnessed quotient/remainder and integer-exact range checks —
    the same verify-equation shape a pairing gadget has."""

    VerifyingKeyVar = MockVerifyingKeyVar
    ProcessedVerifyingKeyVar = MockVerifyingKeyVar
    ProofVar = MockProofVar
    InputVar = BooleanInputVar

    @classmethod
    def verifier_size(cls, circuit_vk: MockVerifyingKey) -> int:
        return len(circuit_vk.betas)

    @classmethod
    def verify_with_processed_vk(
        cls, circuit_pvk: MockVerifyingKeyVar, x: BooleanInputVar, proof: MockProofVar
    ) -> Boolean:
        f = circuit_pvk.f
        cs = circuit_pvk.alpha.cs
        cf = cs.field
        n = len(circuit_pvk.betas)
        if (n + 1) * f.p * f.p >= cf.p:
            raise ValueError("accumulation would wrap CF")
        if len(x.val) != n:
            raise ValueError("input length mismatch")
        # recompose x_i over CF from the BooleanInputVar bits (linear, free)
        xs = []
        for bits in x.val:
            acc = FpVar.constant(cs, 0)
            for i, b in enumerate(bits):
                acc = acc + b.fp.scale(1 << i)
            xs.append(acc)
        # T = alpha + sum x_i * beta_i  (exact over the integers: < cf.p)
        T = circuit_pvk.alpha
        for xi, bi in zip(xs, circuit_pvk.betas):
            T = T + xi * bi
        # witnessed euclidean reduction T = q * f.p + r with range proofs
        q_int, r_int = divmod(T.value, f.p)
        q = FpVar.new_witness(cs, q_int)
        r = FpVar.new_witness(cs, r_int)
        nb_q = f.nbits + (n + 1).bit_length() + 1
        q.to_bits_le(nb_q)
        r.to_bits_le(f.nbits)
        enforce_lt_constant(r, f.p)
        (q.scale(f.p) + r).enforce_equal(T)
        return r.is_eq(proof.s)

    @classmethod
    def verify(
        cls, circuit_vk: MockVerifyingKeyVar, x: BooleanInputVar, proof: MockProofVar
    ) -> Boolean:
        # the mock's vk processing is the identity (same var layout)
        return cls.verify_with_processed_vk(circuit_vk, x, proof)
