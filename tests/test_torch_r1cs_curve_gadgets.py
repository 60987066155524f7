"""The port's curve gadgets against the JAX package's, on the CPU.

Twins of the tests of tests/test_r1cs_curve_gadgets.py (TE and SW curve
variables, the Pedersen CRH, two-to-one CRH and commitment, Bowe-Hopwood,
the injective map, Schnorr public-key randomisation on TE and SW curves,
ElGamal encryption), of the two pedersen.py gadgets of
tests/test_r1cs_byte_merkle.py (the Bowe-Hopwood two-to-one CRH and the
commitment compressor) and of the absorb-gadget test of
tests/test_misc_components.py:184-208.  Each circuit is built by one
helper, once in each package, with parameters from the same seed: equal
counts, assignments, matrices and outputs, every gadget output equal to its
package's native output, and the circuit satisfied."""

import random

import pytest
import torch

from crypto_primitives_tpu_torch.models.crh import Window
from crypto_primitives_tpu_torch.models.crh.bowe_hopwood import BoweHopwoodCRH
from crypto_primitives_tpu_torch.models.crh.pedersen import PedersenCRH, PedersenTwoToOneCRH
from crypto_primitives_tpu_torch.ops.curves_known import JUBJUB
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR
from crypto_primitives_tpu_torch.r1cs import ConstraintSystem, FpVar
from crypto_primitives_tpu_torch.r1cs.gadgets.absorb import absorb_gadget
from crypto_primitives_tpu_torch.r1cs.gadgets.curve import fpvar_to_bytes_le, precomputed_base_multiscalar_mul_le
from crypto_primitives_tpu_torch.r1cs.gadgets.pedersen import (
    BoweHopwoodCRHGadget,
    BoweHopwoodTwoToOneCRHGadget,
    PedersenCRHGadget,
    PedersenTwoToOneCRHGadget,
)
from crypto_primitives_tpu_torch.r1cs.vars import bytes_to_uint8s

from test_torch_r1cs import assert_same_circuit, mod

torch.set_num_threads(1)


def _bytes(rng, n):
    return bytes(rng.randrange(256) for _ in range(n))


def _ctx(pkg, field="BLS12_381_FR"):
    """(module loader, curves, a fresh ConstraintSystem over ``field``)."""
    def m(name):
        return mod(pkg, name)

    return m, m("ops.curves_known"), m("r1cs").ConstraintSystem(getattr(m("ops.fields_known"), field))


# ---- circuits, built by the same code in either package ----------------------


def te_affine_var_ops(pkg):
    m, c, cs = _ctx(pkg)
    TE, Boolean, J = m("r1cs.gadgets.curve").TEAffineVar, m("r1cs.vars").Boolean, c.JUBJUB
    rng = random.Random(101)
    p1, p2 = J.rand_point(rng), J.rand_point(rng)
    v1, v2 = TE.new_witness(cs, J, p1), TE.new_witness(cs, J, p2)
    add, dbl = v1.add(v2), v1.double()
    n0 = cs.num_constraints
    v1.add(TE.constant(cs, J, p2))
    const_cost = cs.num_constraints - n0
    k = rng.randrange(1 << 16)
    bits = [Boolean.new_witness(cs, bool((k >> i) & 1)) for i in range(16)]
    mul = v1.scalar_mul_le(bits)
    ident = TE.identity(cs, J).add(v1.negate()).add(v1)
    gadget = [add.value, dbl.value, const_cost, mul.value, ident.value, add.is_eq(add).value, v1.is_eq(v2).value]
    native = [J.add_host(p1, p2), J.double_host(p1), 3, J.scalar_mul_host(p1, k), (0, 1), True, False]
    return cs, {"gadget": gadget, "native": native}


def pedersen_crh(pkg):
    m, c, cs = _ctx(pkg)
    ped, v = m("models.crh.pedersen"), m("r1cs.vars")
    rng = random.Random(102)
    w = ped.Window(4, 16)
    crh = ped.PedersenCRH(c.JUBJUB, w)
    params = crh.setup(rng)
    msg = _bytes(rng, 8)
    out = m("r1cs.gadgets.pedersen").PedersenCRHGadget(c.JUBJUB, w).evaluate(cs, params, v.bytes_to_uint8s(cs, msg))
    return cs, {"gadget": out.value, "native": crh.evaluate(params, msg)}


def pedersen_two_to_one(pkg):
    m, c, cs = _ctx(pkg)
    ped, v = m("models.crh.pedersen"), m("r1cs.vars")
    rng = random.Random(103)
    w = ped.Window(4, 256)
    two = ped.PedersenTwoToOneCRH(c.JUBJUB, w)
    params = two.setup(rng)
    left, right = _bytes(rng, 32), _bytes(rng, 32)
    g = m("r1cs.gadgets.pedersen").PedersenTwoToOneCRHGadget(c.JUBJUB, w)
    out = g.evaluate(cs, params, v.bytes_to_uint8s(cs, left), v.bytes_to_uint8s(cs, right))
    top = g.compress(cs, params, out, out)
    native = two.evaluate(params, left, right)
    return cs, {"gadget": [out.value, top.value], "native": [native, two.compress(params, native, native)]}


def bowe_hopwood(pkg):
    m, c, cs = _ctx(pkg)
    bh, v = m("models.crh.bowe_hopwood"), m("r1cs.vars")
    rng = random.Random(104)
    w = m("models.crh.pedersen").Window(8, 4)
    crh = bh.BoweHopwoodCRH(c.JUBJUB, w)
    params = crh.setup(rng)
    msg = _bytes(rng, 12)
    out = m("r1cs.gadgets.pedersen").BoweHopwoodCRHGadget(c.JUBJUB, w).evaluate(cs, params, v.bytes_to_uint8s(cs, msg))
    return cs, {"gadget": out.value, "native": crh.evaluate(params, msg)}


def bowe_hopwood_two_to_one(pkg):
    m, c, cs = _ctx(pkg)
    bh, v = m("models.crh.bowe_hopwood"), m("r1cs.vars")
    rng = random.Random(105)
    w = m("models.crh.pedersen").Window(58, 6)
    two = bh.BoweHopwoodTwoToOneCRH(c.JUBJUB, w)
    params = two.setup(rng)
    left, right = _bytes(rng, 32), _bytes(rng, 32)
    g = m("r1cs.gadgets.pedersen").BoweHopwoodTwoToOneCRHGadget(c.JUBJUB, w)
    out = g.evaluate(cs, params, v.bytes_to_uint8s(cs, left), v.bytes_to_uint8s(cs, right))
    top = g.compress(cs, params, out, out)
    native = two.evaluate(params, left, right)
    return cs, {"gadget": [out.value, top.value], "native": [native, two.compress(params, native, native)]}


def injective_map(pkg):
    m, c, cs = _ctx(pkg)
    v = m("r1cs.vars")
    rng = random.Random(106)
    w = m("models.crh.pedersen").Window(4, 16)
    comp = m("models.crh.injective_map").PedersenCRHCompressor(c.JUBJUB, w)
    params = comp.setup(rng)
    msg = _bytes(rng, 8)
    g = m("r1cs.gadgets.pedersen")
    out = g.PedersenCRHCompressorGadget(c.JUBJUB, w).evaluate(cs, params, v.bytes_to_uint8s(cs, msg))
    point = g.PedersenCRHGadget(c.JUBJUB, w).evaluate(cs, params, v.bytes_to_uint8s(cs, msg))
    return cs, {"gadget": [out.value, g.TECompressorGadget.injective_map(point).value],
                "native": [comp.evaluate(params, msg)] * 2}


def _commitment(pkg, module, cls, gadget_cls, seed):
    m, c, cs = _ctx(pkg)
    v = m("r1cs.vars")
    rng = random.Random(seed)
    w = m("models.crh.pedersen").Window(4, 96)  # up to 48-byte inputs
    comm = getattr(m(module), cls)(c.JUBJUB, w)
    params = comm.setup(rng)
    msg, r = _bytes(rng, 16), comm.rand_randomness(rng)
    g = getattr(m("r1cs.gadgets.pedersen"), gadget_cls)(c.JUBJUB, w)
    out = g.commit(cs, params, v.bytes_to_uint8s(cs, msg), g.randomness_bits(cs, r))
    return cs, {"gadget": out.value, "native": comm.commit(params, msg, r)}


def pedersen_commitment(pkg):
    return _commitment(pkg, "models.commitment.pedersen", "PedersenCommitment", "PedersenCommitmentGadget", 107)


def pedersen_commitment_compressor(pkg):
    return _commitment(pkg, "models.commitment.injective_map", "PedersenCommitmentCompressor",
                       "PedersenCommitmentCompressorGadget", 108)


def _schnorr(pkg, curve_name, seed):
    m, c, _ = _ctx(pkg)
    curve = getattr(c, curve_name)
    cs = m("r1cs").ConstraintSystem(curve.base)
    rng = random.Random(seed)
    scheme = m("models.signature.schnorr").Schnorr(curve)
    params = scheme.setup(rng)
    pk, _ = scheme.keygen(params, rng)
    randomness = _bytes(rng, 32)
    g = m("r1cs.gadgets.signature").SchnorrRandomizePkGadget(curve)
    var = g.var_for_curve(curve)
    out = g.randomize(cs, params, var.new_witness(cs, curve, pk), m("r1cs.vars").bytes_to_uint8s(cs, randomness))
    return cs, {"gadget": out.value, "native": scheme.randomize_public_key(params, pk, randomness),
                "var": var.__name__}


def schnorr_randomize_pk(pkg):
    return _schnorr(pkg, "JUBJUB", 109)


def schnorr_randomize_pk_sw(pkg):
    """The curve-generic gadget on Pallas with SWProjectiveVar."""
    return _schnorr(pkg, "PALLAS", 110)


def elgamal_enc(pkg):
    m, c, cs = _ctx(pkg)
    TE, J = m("r1cs.gadgets.curve").TEAffineVar, c.JUBJUB
    rng = random.Random(111)
    scheme = m("models.encryption.elgamal").ElGamal(J)
    params = scheme.setup(rng)
    pk, _ = scheme.keygen(params, rng)
    msg, r = J.rand_point(rng), scheme.rand_randomness(rng)
    g = m("r1cs.gadgets.elgamal").ElGamalEncGadget(J)
    out = g.encrypt(cs, params, TE.new_witness(cs, J, msg), g.randomness_bits(cs, r), TE.new_witness(cs, J, pk))
    again = g.encrypt(cs, params, TE.constant(cs, J, msg), g.randomness_bits(cs, r), TE.new_witness(cs, J, pk))
    out.enforce_equal(again)
    return cs, {"gadget": [out.value, out.is_eq(again).value], "native": [scheme.encrypt(params, pk, msg, r), True]}


def sw_projective_var_ops(pkg):
    m, c, cs = _ctx(pkg, "BLS12_381_FQ")
    SW, Boolean, G1 = m("r1cs.gadgets.curve").SWProjectiveVar, m("r1cs.vars").Boolean, c.BLS12_381_G1
    rng = random.Random(112)
    p1, p2 = G1.rand_point(rng), G1.rand_point(rng)
    v1, v2 = SW.new_witness(cs, G1, p1), SW.new_witness(cs, G1, p2)
    ident = SW.identity(cs, G1)
    k = rng.randrange(1 << 16)
    bits = [Boolean.new_witness(cs, bool((k >> i) & 1)) for i in range(16)]
    mul = v1.scalar_mul_le(bits)
    v1.add(v2).enforce_equal(v2.add(v1))
    gadget = [v1.add(v2).value, v1.double().value, v1.add(v1.negate()).value, ident.add(v1).value,
              v1.add(ident).value, mul.value]
    native = [G1.add_host(p1, p2), G1.double_host(p1), None, p1, p1, G1.scalar_mul_host(p1, k)]
    return cs, {"gadget": gadget, "native": native}


def sw_affine_var_to_affine(pkg):
    m, c, cs = _ctx(pkg, "BLS12_381_FQ")
    SW, G1 = m("r1cs.gadgets.curve").SWProjectiveVar, c.BLS12_381_G1
    p1 = G1.rand_point(random.Random(113))
    aff = SW.new_witness(cs, G1, p1).to_affine()
    inf = SW.new_witness(cs, G1, None).to_affine()  # (0, 1) with the flag set (r1cs-std to_affine)
    const = SW.constant(cs, G1, p1).to_affine()
    gadget = [(aff.x.value, aff.y.value), aff.infinity.value, aff.value, (inf.x.value, inf.y.value),
              inf.infinity.value, inf.value, const.value]
    return cs, {"gadget": gadget, "native": [p1, False, p1, (0, 1), True, None, p1]}


def sw_absorb(pkg):
    """The reference's sw_curve_consistency_check (sponge/constraints/absorb.rs:270-311)."""
    m, c, cs = _ctx(pkg, "BLS12_381_FQ")
    a, SW, G1 = m("models.sponge.absorb"), m("r1cs.gadgets.curve").SWProjectiveVar, c.BLS12_381_G1
    fq = m("ops.fields_known").BLS12_381_FQ
    p1 = G1.rand_point(random.Random(114))
    var = SW.new_witness(cs, G1, p1)
    gadget = m("r1cs.gadgets.absorb").absorb_gadget
    native = a.to_sponge_field_elements(a.SWPointAbsorb(p1[0], p1[1]), fq)
    return cs, {"gadget": [[g.value for g in gadget(cs, var.to_affine())], [g.value for g in gadget(cs, var)]],
                "native": [native, native]}


def pedersen_crh_sw(pkg):
    """The Pedersen gadget over an SW curve var (G1, constraint field Fq)."""
    m, c, cs = _ctx(pkg, "BLS12_381_FQ")
    ped, v = m("models.crh.pedersen"), m("r1cs.vars")
    rng = random.Random(115)
    w = ped.Window(4, 8)
    crh = ped.PedersenCRH(c.BLS12_381_G1, w)
    params = crh.setup(rng)
    msg = _bytes(rng, 4)
    out = m("r1cs.gadgets.pedersen").PedersenCRHGadget(c.BLS12_381_G1, w).evaluate(cs, params,
                                                                                 v.bytes_to_uint8s(cs, msg))
    return cs, {"gadget": out.value, "native": crh.evaluate(params, msg)}


def absorb_encodings(pkg):
    """tests/test_misc_components.py:184-208: bytes (a length-prefixed u8
    batch, packed into field elements for free), field elements, a TE
    point, a Boolean and a lone UInt8."""
    m, c, cs = _ctx(pkg)
    a, v, r = m("models.sponge.absorb"), m("r1cs.vars"), m("r1cs")
    fr_ = m("ops.fields_known").BLS12_381_FR
    rng = random.Random(116)
    data = _bytes(rng, 40)
    pt = c.JUBJUB.rand_point(rng)
    gadget = m("r1cs.gadgets.absorb").absorb_gadget
    te = m("r1cs.gadgets.curve").TEAffineVar.new_witness(cs, c.JUBJUB, pt)
    byte_vars = v.bytes_to_uint8s(cs, data, "witness")
    bit = v.Boolean.new_witness(cs, True)
    g = [[x.value for x in gadget(cs, byte_vars)],
         [x.value for x in gadget(cs, [r.FpVar.new_witness(cs, 7), te])],
         [x.value for x in gadget(cs, [bit, byte_vars[0]])]]
    native = [a.to_sponge_field_elements(data, fr_),
              a.to_sponge_field_elements([a.Felt(7), a.TEPointAbsorb(*pt)], fr_),
              [1, data[0]]]
    return cs, {"gadget": g, "native": native}


CIRCUITS = {
    "te_affine_var_ops": te_affine_var_ops,
    "pedersen_crh": pedersen_crh,
    "pedersen_two_to_one": pedersen_two_to_one,
    "bowe_hopwood": bowe_hopwood,
    "bowe_hopwood_two_to_one": bowe_hopwood_two_to_one,
    "injective_map": injective_map,
    "pedersen_commitment": pedersen_commitment,
    "pedersen_commitment_compressor": pedersen_commitment_compressor,
    "schnorr_randomize_pk": schnorr_randomize_pk,
    "schnorr_randomize_pk_sw": schnorr_randomize_pk_sw,
    "elgamal_enc": elgamal_enc,
    "sw_projective_var_ops": sw_projective_var_ops,
    "sw_affine_var_to_affine": sw_affine_var_to_affine,
    "sw_absorb": sw_absorb,
    "pedersen_crh_sw": pedersen_crh_sw,
    "absorb_encodings": absorb_encodings,
}


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_curve_gadget_matches_native_and_jax(name):
    _, outs, first = assert_same_circuit(CIRCUITS[name])
    assert outs["gadget"] == outs["native"]
    assert first is None
    if name == "schnorr_randomize_pk_sw":
        assert outs["var"] == "SWProjectiveVar"


# ---- where JAX asserts, the port raises ----------------------------------------


def test_gadgets_refuse_inputs_too_long_for_their_window():
    rng = random.Random(117)
    cs = ConstraintSystem(FR)
    w = Window(8, 4)
    bh_params = BoweHopwoodCRH(JUBJUB, w).setup(rng)
    with pytest.raises(ValueError):  # bowe_hopwood/constraints.rs:56-64
        BoweHopwoodCRHGadget(JUBJUB, w).evaluate(cs, bh_params, bytes_to_uint8s(cs, bytes(100)))
    with pytest.raises(ValueError):
        BoweHopwoodTwoToOneCRHGadget(JUBJUB, w).evaluate(cs, bh_params, bytes_to_uint8s(cs, bytes(4)),
                                                        bytes_to_uint8s(cs, bytes(5)))
    w = Window(4, 16)
    params = PedersenCRH(JUBJUB, w).setup(rng)
    with pytest.raises(ValueError):
        PedersenCRHGadget(JUBJUB, w).evaluate(cs, params, bytes_to_uint8s(cs, bytes(9)))
    two = PedersenTwoToOneCRHGadget(JUBJUB, w)
    two_params = PedersenTwoToOneCRH(JUBJUB, w).setup(rng)
    with pytest.raises(ValueError):  # unequal halves
        two.evaluate(cs, two_params, bytes_to_uint8s(cs, bytes(2)), bytes_to_uint8s(cs, bytes(3)))
    with pytest.raises(ValueError):  # halves wider than half the window
        two.evaluate(cs, two_params, bytes_to_uint8s(cs, bytes(5)), bytes_to_uint8s(cs, bytes(5)))
    with pytest.raises(ValueError):  # more bits than generators
        precomputed_base_multiscalar_mul_le(cs, JUBJUB, params.generators, bytes_to_uint8s(cs, bytes(9))[0].bits * 9)
    with pytest.raises(ValueError):  # 255 bits do not fit 31 bytes (JAX drops the top bits)
        fpvar_to_bytes_le(FpVar.new_witness(cs, 5), 31)
    assert [b.value for b in fpvar_to_bytes_le(FpVar.new_witness(cs, 0x0102), 32)][:3] == [2, 1, 0]
    with pytest.raises(TypeError):
        absorb_gadget(cs, object())
