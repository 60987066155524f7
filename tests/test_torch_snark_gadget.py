"""The port's SNARKGadget protocol against the JAX package's, on the CPU.

Twins of the 7 tests of tests/test_snark_gadget.py, through the MockLinSNARK
test double: the native round trip, the verifier circuit over BLS12-381 Fr
(true, and false with a tampered proof), the processed-vk path, the
unchecked and checked allocators, ``verifier_size`` and ``repack_input``.
Each circuit is built by one helper, once in each package, from the same
seed: equal counts, assignments, matrices and outputs."""

import functools
import random

import pytest
import torch

from crypto_primitives_tpu_torch.ops.field import FieldSpec
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as CF
from crypto_primitives_tpu_torch.r1cs import ConstraintSystem
from crypto_primitives_tpu_torch.r1cs.device_check import check_satisfied_device
from crypto_primitives_tpu_torch.r1cs.snark import BooleanInputVar
from crypto_primitives_tpu_torch.r1cs.snark_gadget import (
    MockLinSNARK,
    MockLinSNARKGadget,
    MockProof,
    MockProofVar,
    MockVerifyingKeyVar,
    SNARK,
    SNARKGadget,
    enforce_lt_constant,
)

from test_torch_r1cs import JAX, PORT, assert_same_circuit, mod

torch.set_num_threads(1)

SEED = 20260817
M61 = 2**61 - 1


@functools.lru_cache(maxsize=None)
def small_field(pkg):
    """The mock's proof field F, one FieldSpec per package."""
    return mod(pkg, "ops.field").FieldSpec("m61", M61)


def setup(pkg, n=3, seed=SEED):
    sg = mod(pkg, "r1cs.snark_gadget")
    rng = random.Random(seed)
    snark = sg.MockLinSNARK(small_field(pkg))
    pk, vk = snark.circuit_specific_setup(n, rng)
    x = [rng.randrange(M61) for _ in range(n)]
    return snark, vk, x, snark.prove(pk, x)


def verify_circuit(pkg, tamper=False, processed=False, vk_mode="witness", input_mode="input", proof_mode="witness",
                   n=3):
    sg, s = mod(pkg, "r1cs.snark_gadget"), mod(pkg, "r1cs.snark")
    f = small_field(pkg)
    snark, vk, x, proof = setup(pkg, n)
    if tamper:
        proof = sg.MockProof((proof.s + 1) % M61)
    cs = mod(pkg, "r1cs").ConstraintSystem(mod(pkg, "ops.fields_known").BLS12_381_FR)
    key = snark.process_vk(vk) if processed else vk
    key_var = sg.MockLinSNARKGadget.ProcessedVerifyingKeyVar.new_variable(cs, key, vk_mode)
    x_var = getattr(s.BooleanInputVar, f"new_{input_mode}")(cs, x, f)
    p_var = sg.MockProofVar.new_variable(cs, proof, proof_mode, f=f)
    verify = sg.MockLinSNARKGadget.verify_with_processed_vk if processed else sg.MockLinSNARKGadget.verify
    ok = verify(key_var, x_var, p_var)
    return cs, [bool(ok.value), snark.verify(vk, x, proof)]


def allocators(pkg, checked):
    sg = mod(pkg, "r1cs.snark_gadget")
    _, vk, _, proof = setup(pkg)
    cs = mod(pkg, "r1cs").ConstraintSystem(mod(pkg, "ops.fields_known").BLS12_381_FR)
    if checked:
        sg.MockVerifyingKeyVar.new_variable(cs, vk, "witness", checked=True)
        sg.MockProofVar.new_variable(cs, proof, "witness", f=small_field(pkg), checked=True)
    else:
        sg.MockLinSNARKGadget.new_verification_key_unchecked(cs, vk)
        sg.MockLinSNARKGadget.new_proof_unchecked(cs, proof)
    return cs, [cs.num_constraints]


def test_native_roundtrip_matches_jax():
    snark, vk, x, proof = setup(PORT)
    _, jvk, jx, jproof = setup(JAX)
    assert (vk.alpha, vk.betas, x, proof.s) == (jvk.alpha, jvk.betas, jx, jproof.s)
    assert snark.verify(vk, x, proof) is True
    assert snark.verify(vk, x, MockProof((proof.s + 1) % M61)) is False
    assert snark.verify_with_processed_vk(snark.process_vk(vk), x, proof) is True
    with pytest.raises(ValueError):  # zip(strict=True): an input per beta
        snark.verify(vk, x[:2], proof)


@pytest.mark.parametrize("tamper", [False, True])
def test_gadget_verify_true_and_false(tamper):
    cs, outs, first = assert_same_circuit(lambda pkg: verify_circuit(pkg, tamper=tamper))
    assert outs == [not tamper, not tamper]
    assert first is None and cs.num_constraints > 0
    assert check_satisfied_device(cs, device="cpu") is True


def test_gadget_processed_vk_path():
    _, outs, first = assert_same_circuit(lambda pkg: verify_circuit(pkg, processed=True, vk_mode="constant"))
    assert outs == [True, True] and first is None


def test_unchecked_allocators_skip_range_checks():
    """new_*_unchecked default to the plain allocators: no constraint, where
    the checked ones range-prove every element (constraints.rs:46-82)."""
    _, unchecked, _ = assert_same_circuit(lambda pkg: allocators(pkg, False))
    _, checked, first = assert_same_circuit(lambda pkg: allocators(pkg, True))
    assert unchecked == [0] and checked[0] > 0 and first is None


def test_verifier_size_partial_ord():
    rng = random.Random(SEED)
    snark = MockLinSNARK(small_field(PORT))
    _, vk2 = snark.circuit_specific_setup(2, rng)
    _, vk5 = snark.circuit_specific_setup(5, rng)
    assert MockLinSNARKGadget.verifier_size(vk2) == 2 < MockLinSNARKGadget.verifier_size(vk5) == 5


def test_repack_input_matches_gadget_values():
    """Native repack_input and BooleanInputVar.new_input allocate the same
    packed CF inputs (constraints.rs:266-318 vs :180-263), in both packages."""
    def build(pkg):
        s = mod(pkg, "r1cs.snark")
        rng = random.Random(SEED + 1)
        x = [rng.randrange(M61) for _ in range(4)]
        fr_ = mod(pkg, "ops.fields_known").BLS12_381_FR
        packed = s.repack_input(x, small_field(pkg), fr_)
        cs = mod(pkg, "r1cs").ConstraintSystem(fr_)
        var = s.BooleanInputVar.new_input(cs, x, small_field(pkg))
        return cs, [var.values() == x, [cs.assignments[i] for i in cs._instance_vars[: len(packed)]] == packed, packed]

    _, outs, _ = assert_same_circuit(build)
    assert outs[:2] == [True, True]


def test_gadget_verify_witness_inputs():
    """The inputs allocated as witnesses, the key and proof as constants."""
    _, outs, first = assert_same_circuit(lambda pkg: verify_circuit(pkg, vk_mode="constant", input_mode="witness",
                                                                     proof_mode="constant", n=2))
    assert outs == [True, True] and first is None


def test_protocol_bases_and_range_helper():
    with pytest.raises(NotImplementedError):
        SNARK().process_vk(None)
    with pytest.raises(NotImplementedError):
        SNARKGadget.verify(None, None, None)
    cs = ConstraintSystem(CF)
    x = mod(PORT, "r1cs").FpVar.new_witness(cs, 99)
    enforce_lt_constant(x, 100)
    assert cs.is_satisfied()
    y = mod(PORT, "r1cs").FpVar.new_witness(cs, 100)
    with pytest.raises(ValueError):  # w = -1 mod p has no 7-bit decomposition
        enforce_lt_constant(y, 100)


def test_verify_refuses_a_wrapping_field_and_a_wrong_input_count():
    """Where JAX asserts, the port raises ValueError."""
    _, vk, x, proof = setup(PORT)
    big = FieldSpec("big", CF.p)  # n * p_F^2 wraps the constraint field
    cs = ConstraintSystem(CF)
    key = MockVerifyingKeyVar.new_variable(cs, vk, "witness")
    key.f = big
    with pytest.raises(ValueError):
        MockLinSNARKGadget.verify(key, BooleanInputVar.new_input(cs, x, small_field(PORT)),
                                  MockProofVar.new_variable(cs, proof, f=small_field(PORT)))
    key = MockVerifyingKeyVar.new_variable(cs, vk, "witness")
    with pytest.raises(ValueError):
        MockLinSNARKGadget.verify(key, BooleanInputVar.new_input(cs, x[:2], small_field(PORT)),
                                  MockProofVar.new_variable(cs, proof, f=small_field(PORT)))
