"""The port's R1CS tier against the JAX package's, on the CPU: the scalar tier
(constraint and witness counts, assignments, COO matrices and outputs of the
byte and Poseidon gadgets, the core variables and the SNARK input packing)
and ``check_satisfied_device``.  ``BatchConstraintSystem`` is in
tests/test_torch_r1cs_batch.py, which builds its scalar circuits with the
helpers here."""

import hashlib
import importlib
import random

import pytest
import torch

from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR
from crypto_primitives_tpu_torch.ops.fields_known import JUBJUB_FR
from crypto_primitives_tpu_torch.r1cs import ConstraintSystem
from crypto_primitives_tpu_torch.r1cs.device_check import check_satisfied_device

torch.set_num_threads(1)

PORT, JAX = "crypto_primitives_tpu_torch", "crypto_primitives_tpu"


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def fr(pkg):
    return mod(pkg, "ops.fields_known").BLS12_381_FR


def poseidon_cfg(pkg):
    return mod(pkg, "models.sponge").get_default_poseidon_parameters(fr(pkg), 2, False)


def _bytes(seed, n):
    rng = random.Random(seed)
    return bytes(rng.randrange(256) for _ in range(n))


# ---- scalar circuits, built by the same code in either package ---------------


def blake2s_bits(pkg, data):
    g, v = mod(pkg, "r1cs.gadgets.blake2s"), mod(pkg, "r1cs.vars")
    cs = mod(pkg, "r1cs").ConstraintSystem(fr(pkg))
    bits = [b for by in v.bytes_to_uint8s(cs, data, "witness") for b in by.bits]
    out = g.OutputVar.from_words(cs, g.evaluate_blake2s(cs, bits))
    return cs, [out.value], hashlib.blake2s(data).digest()


def blake2s_prf(pkg, seed=_bytes(1, 32), inp=_bytes(2, 32)):
    g, v = mod(pkg, "r1cs.gadgets.blake2s"), mod(pkg, "r1cs.vars")
    cs = mod(pkg, "r1cs").ConstraintSystem(fr(pkg))
    out = g.Blake2sPRFGadget.evaluate(cs, g.Blake2sPRFGadget.new_seed(cs, seed), v.bytes_to_uint8s(cs, inp))
    return cs, [out.value], hashlib.blake2s(seed + inp).digest()


def blake2s_commitment(pkg, m=_bytes(3, 20), r=_bytes(4, 32)):
    g, v = mod(pkg, "r1cs.gadgets.blake2s"), mod(pkg, "r1cs.vars")
    cs = mod(pkg, "r1cs").ConstraintSystem(fr(pkg))
    out = g.Blake2sCommitmentGadget.commit(cs, v.bytes_to_uint8s(cs, m), v.bytes_to_uint8s(cs, r))
    return cs, [out.value], hashlib.blake2s(m + r).digest()


def sha256_crh(pkg, data=_bytes(5, 55)):
    g, v = mod(pkg, "r1cs.gadgets.sha256"), mod(pkg, "r1cs.vars")
    cs = mod(pkg, "r1cs").ConstraintSystem(fr(pkg))
    out = g.Sha256CRHGadget().evaluate(cs, v.bytes_to_uint8s(cs, data))
    return cs, [out.value], hashlib.sha256(data).digest()


def sha256_two_to_one(pkg, left=_bytes(6, 32), right=_bytes(7, 32)):
    g, v = mod(pkg, "r1cs.gadgets.sha256"), mod(pkg, "r1cs.vars")
    cs = mod(pkg, "r1cs").ConstraintSystem(fr(pkg))
    two = g.Sha256TwoToOneCRHGadget()
    out = two.evaluate(cs, v.bytes_to_uint8s(cs, left), v.bytes_to_uint8s(cs, right))
    top = two.compress(cs, out, out)
    digest = hashlib.sha256(left + right).digest()
    eq = out.is_eq(top)
    return cs, [out.value, top.value, eq.value], hashlib.sha256(digest + digest).digest()


def poseidon_crh(pkg, vals=(11, 22, 33)):
    g, r = mod(pkg, "r1cs.gadgets.poseidon"), mod(pkg, "r1cs")
    cs = r.ConstraintSystem(fr(pkg))
    crh = g.PoseidonCRHGadget(poseidon_cfg(pkg))
    out = crh.evaluate(cs, [r.FpVar.new_witness(cs, x) for x in vals])
    folded = crh.evaluate(cs, [r.FpVar.constant(cs, x) for x in vals])  # the constant-folding path
    return cs, [out.value, folded.value, folded.const], None


def poseidon_two_to_one(pkg, left=5, right=FR.p - 7):
    g, r = mod(pkg, "r1cs.gadgets.poseidon"), mod(pkg, "r1cs")
    cs = r.ConstraintSystem(fr(pkg))
    two = g.PoseidonTwoToOneCRHGadget(poseidon_cfg(pkg))
    out = two.compress(cs, r.FpVar.new_witness(cs, left), r.FpVar.new_input(cs, right))
    folded = two.evaluate(cs, r.FpVar.constant(cs, left), r.FpVar.constant(cs, right))
    return cs, [out.value, folded.value], None


def poseidon_squeezes(pkg, v=123456789):
    """squeeze_bits, squeeze_bytes and the emulated squeeze into JubJub's
    scalar field (EmulatedFpVar of r1cs/snark.py)."""
    g, r = mod(pkg, "r1cs.gadgets.poseidon"), mod(pkg, "r1cs")
    jubjub = mod(pkg, "ops.fields_known").JUBJUB_FR
    cs = r.ConstraintSystem(fr(pkg))
    sp = g.PoseidonSpongeVar(cs, poseidon_cfg(pkg))
    sp.absorb([r.FpVar.new_witness(cs, v), r.FpVar.new_witness(cs, v + 1)])
    bits = sp.squeeze_bits(70)
    by = sp.squeeze_bytes(40)
    sp.absorb([r.FpVar.new_witness(cs, v + 2)])
    emu = sp.squeeze_emulated_field_elements(jubjub, 2)
    return cs, [[b.value for b in bits], bytes(b.value for b in by), [e.value for e in emu]], None


def core_ops(pkg, a=3, b=FR.p - 5):
    """FpVar, Boolean and UInt32 operations of r1cs/vars.py."""
    r = mod(pkg, "r1cs")
    cs = r.ConstraintSystem(fr(pkg))
    x, y = r.FpVar.new_witness(cs, a), r.FpVar.new_input(cs, b)
    q = x.mul_by_inverse(y)
    inv = (x + y).inverse()
    eq, ne = x.is_eq(x.scale(1)), x.is_eq(y)
    sel = r.FpVar.select(ne, x, y)
    p5 = x.pow_by_constant(5)
    bits = p5.to_bits_le(20)
    u = r.UInt32.new_witness(cs, 0xDEADBEEF)
    w = r.UInt32.new_witness(cs, 0x12345678)
    s = r.UInt32.addmany([u, w, u.rotr(7) ^ w.shr(3), r.UInt32.constant(cs, 0xFFFFFFFF)])
    pick = r.UInt32.select(eq, s, u & w.not_())
    orr = bits[0] | bits[1].not_()
    return cs, [q.value, inv.value, eq.value, ne.value, sel.value, [b.value for b in bits], s.value, pick.value,
                orr.value], None


def boolean_input_var(pkg):
    s, r = mod(pkg, "r1cs.snark"), mod(pkg, "r1cs")
    jubjub = mod(pkg, "ops.fields_known").JUBJUB_FR
    vals = [7, JUBJUB_FR.p - 1, 2 ** 200 + 3]
    cs = r.ConstraintSystem(fr(pkg))
    biv = s.BooleanInputVar.new_input(cs, vals, jubjub)
    back = s.BooleanInputVar.from_field_elements([r.FpVar.new_witness(cs, x) for x in vals[:2]], jubjub)
    emu = s.EmulatedFieldInputVar.new_input(cs, vals, jubjub)
    return cs, [biv.values(), back.values(), emu.values(), s.repack_input(vals, jubjub, fr(pkg))], None


SCALAR = {
    "blake2s_prf": blake2s_prf,
    **{f"blake2s_{n}_bytes": (lambda pkg, n=n: blake2s_bits(pkg, _bytes(100 + n, n))) for n in (0, 3, 32, 63, 64, 65, 128)},
    "blake2s_commitment": blake2s_commitment,
    "sha256_crh_55": sha256_crh,
    "sha256_two_to_one": sha256_two_to_one,
    "poseidon_crh": poseidon_crh,
    "poseidon_two_to_one": poseidon_two_to_one,
    "poseidon_squeezes": poseidon_squeezes,
    "core_ops": core_ops,
    "boolean_input_var": boolean_input_var,
}


def _coo_lists(cs):
    coo = cs.to_coo()
    return {m: (coo[m][0].tolist(), coo[m][1].tolist(), [int(x) for x in coo[m][2]]) for m in "abc"}


def matrices(cs):
    """A, B and C row by row, each row its {variable: coefficient} terms:
    equal rows are equal COO matrices, compared without flattening the
    millions of nonzeros of a Pedersen circuit."""
    return [[lc.terms for lc in rows] for rows in (cs.a_rows, cs.b_rows, cs.c_rows)]


def assert_same_circuit(build):
    """Build one circuit in both packages: equal counts, assignments,
    matrices, outputs and first failing constraints.  Returns the port's
    (cs, outputs, first failing constraint or None)."""
    cs, outs = build(PORT)
    jcs, jouts = build(JAX)
    assert (cs.num_constraints, cs.num_witness, cs.num_instance) == (
        jcs.num_constraints, jcs.num_witness, jcs.num_instance)
    assert cs.assignments == jcs.assignments
    assert outs == jouts
    assert matrices(cs) == matrices(jcs)
    first = cs.which_unsatisfied()
    assert first == jcs.which_unsatisfied()
    return cs, outs, first


@pytest.mark.parametrize("name", sorted(SCALAR))
def test_scalar_circuit_matches_jax(name):
    cs, outs, want = SCALAR[name](PORT)
    jcs, jouts, _ = SCALAR[name](JAX)
    assert (cs.num_constraints, cs.num_witness, cs.num_instance) == (
        jcs.num_constraints, jcs.num_witness, jcs.num_instance)
    assert cs.assignments == jcs.assignments
    assert outs == jouts
    if want is not None:
        assert want in outs
    if name == "blake2s_prf":
        assert cs.num_constraints == 21792  # the reference's pinned count
    assert _coo_lists(cs) == _coo_lists(jcs)
    assert cs.is_satisfied() and jcs.is_satisfied()


def test_constant_input_blake2s_has_no_constraints():
    g, v = mod(PORT, "r1cs.gadgets.blake2s"), mod(PORT, "r1cs.vars")
    cs = ConstraintSystem(FR)
    bits = [b for by in v.bytes_to_uint8s(cs, bytes(range(64)), "constant") for b in by.bits]
    out = g.OutputVar.from_words(cs, g.evaluate_blake2s(cs, bits))
    assert out.value == hashlib.blake2s(bytes(range(64))).digest() and cs.num_constraints == 0


# ---- check_satisfied_device on the CPU ------------------------------------------


@pytest.mark.parametrize("name", ["blake2s_prf", "poseidon_two_to_one", "core_ops"])
def test_check_satisfied_device_agrees_with_jax(name):
    cs, _, _ = SCALAR[name](PORT)
    jcs, _, _ = SCALAR[name](JAX)
    assert check_satisfied_device(cs, device="cpu") is True
    # tamper the last witness (a digest bit, a sponge output, a select) in both
    k = len(cs.assignments) - 1
    for c in (cs, jcs):
        c.assignments[k] = (c.assignments[k] + 1) % FR.p
    assert check_satisfied_device(cs, device="cpu") is jcs.is_satisfied() is False
    assert cs.which_unsatisfied() == jcs.which_unsatisfied()


def test_check_satisfied_device_on_an_empty_system():
    assert check_satisfied_device(ConstraintSystem(FR), device="cpu") is True
