"""The port's ``BatchConstraintSystem`` on the CPU: N instances synthesised as
one trace (the Blake2s PRF, the SHA-256 CRH, the Poseidon two-to-one CRH,
the field-plane hooks and ``UInt32.select``) equal the scalar tier per
instance (counts, every assignment, outputs), and both checks and
``which_unsatisfied`` agree with the scalar tiers of the port and of the JAX
package after a tamper, at the default chunk and at one smaller than N."""

import hashlib
import random

import numpy as np
import pytest
import torch

from crypto_primitives_tpu_torch.errors import DeviceUnavailable
from crypto_primitives_tpu_torch.models.crh.poseidon import PoseidonTwoToOneCRH
from crypto_primitives_tpu_torch.models.sponge import PoseidonSponge, get_default_poseidon_parameters
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR
from crypto_primitives_tpu_torch.r1cs import Boolean, ConstraintSystem, FpVar, UInt32
from crypto_primitives_tpu_torch.r1cs.batch import BatchConstraintSystem, SmallWord
from crypto_primitives_tpu_torch.r1cs.gadgets.blake2s import Blake2sPRFGadget
from crypto_primitives_tpu_torch.r1cs.gadgets.poseidon import PoseidonSpongeVar, PoseidonTwoToOneCRHGadget
from crypto_primitives_tpu_torch.r1cs.gadgets.sha256 import Sha256CRHGadget
from crypto_primitives_tpu_torch.r1cs.vars import bytes_to_uint8s

from test_torch_r1cs import JAX, PORT, blake2s_prf, poseidon_two_to_one, sha256_crh

torch.set_num_threads(1)


# ---- BatchConstraintSystem --------------------------------------------------------


def _column(bcs, i):
    return [bcs.value_host(v, i) for v in bcs.assignments]


def _batch_byte_circuit(kind, n_inst, seed):
    rng = np.random.default_rng(seed)
    bcs = BatchConstraintSystem(FR, n_inst, device="cpu")
    if kind == "blake2s_prf":
        seeds, msgs = rng.integers(0, 256, (2, n_inst, 32), dtype=np.uint8)
        out = Blake2sPRFGadget.evaluate(bcs, Blake2sPRFGadget.new_seed(bcs, seeds), bytes_to_uint8s(bcs, msgs))
        scalar = [lambda pkg, i=i: blake2s_prf(pkg, seeds[i].tobytes(), msgs[i].tobytes()) for i in range(n_inst)]
        want = [hashlib.blake2s(seeds[i].tobytes() + msgs[i].tobytes()).digest() for i in range(n_inst)]
    else:
        data = rng.integers(0, 256, (n_inst, 55), dtype=np.uint8)
        out = Sha256CRHGadget().evaluate(bcs, bytes_to_uint8s(bcs, data))
        scalar = [lambda pkg, i=i: sha256_crh(pkg, data[i].tobytes()) for i in range(n_inst)]
        want = [hashlib.sha256(data[i].tobytes()).digest() for i in range(n_inst)]
    return bcs, out, scalar, want


@pytest.mark.parametrize("kind", ["blake2s_prf", "sha256_crh"])
def test_batched_byte_circuit_matches_scalar_tier_and_jax(kind):
    n_inst, bad = 4, 2
    bcs, out, scalar, want = _batch_byte_circuit(kind, n_inst, 21)
    assert [bytes(row) for row in out.value] == want
    cs0, cs = scalar[0](PORT)[0], scalar[bad](PORT)[0]
    assert (bcs.num_constraints, bcs.num_witness) == (cs.num_constraints, cs.num_witness)
    if kind == "blake2s_prf":
        assert bcs.num_constraints == 21792
    assert _column(bcs, 0) == cs0.assignments and _column(bcs, bad) == cs.assignments
    assert bcs.satisfied_per_instance().tolist() == [True] * n_inst and bcs.is_satisfied()
    assert bcs.which_unsatisfied().tolist() == [-1] * n_inst and bcs.which_unsatisfied(bad) is None

    # flip one digest bit's witness in one instance: that instance alone fails,
    # at the constraint the scalar tiers of both packages name
    k = list(out.bytes[0].bits[0].fp.lc.terms)[0]
    assert isinstance(bcs.assignments[k], SmallWord)
    bcs.assignments[k].v[bad] ^= 1
    expect = [i != bad for i in range(n_inst)]
    assert bcs.satisfied_per_instance().tolist() == expect
    assert bcs.satisfied_per_instance(chunk=3).tolist() == expect
    assert not bcs.is_satisfied()
    jcs, _, _ = scalar[bad](JAX)
    for c in (cs, jcs):
        c.assignments[k] ^= 1
    assert cs.is_satisfied() is jcs.is_satisfied() is False
    first = bcs.which_unsatisfied()
    assert first.dtype == torch.int64
    assert first.tolist() == [-1 if i != bad else cs.which_unsatisfied() for i in range(n_inst)]
    assert bcs.which_unsatisfied(bad) == cs.which_unsatisfied() == jcs.which_unsatisfied()


def test_batched_poseidon_two_to_one_matches_scalar_tier_and_jax():
    cfg = get_default_poseidon_parameters(FR, 2, False)
    rng = random.Random(22)
    n_inst, bad = 5, 1
    ls = [rng.randrange(FR.p) for _ in range(n_inst)]
    rs = [rng.randrange(FR.p) for _ in range(n_inst)]
    bcs = BatchConstraintSystem(FR, n_inst, device="cpu")
    g = PoseidonTwoToOneCRHGadget(cfg)
    out = g.compress(bcs, FpVar.new_witness(bcs, torch.from_numpy(FR.pack(ls))),
                     FpVar.new_input(bcs, torch.from_numpy(FR.pack(rs))))
    native = PoseidonTwoToOneCRH(FR).evaluate_batch(cfg, FR.pack(ls), FR.pack(rs), device="cpu")
    assert torch.equal(out.value, native)
    scalar = [poseidon_two_to_one(PORT, ls[i], rs[i])[0] for i in range(n_inst)]
    assert (bcs.num_constraints, bcs.num_witness, bcs.num_instance) == (
        scalar[0].num_constraints, scalar[0].num_witness, scalar[0].num_instance)
    for i in range(n_inst):
        assert _column(bcs, i) == scalar[i].assignments
    assert bcs.satisfied_per_instance().tolist() == [True] * n_inst
    # the output's witness changed in one instance
    k = list(out.lc.terms)[0]
    bcs.assignments[k] = bcs.assignments[k].clone()
    bcs.assignments[k][bad] = torch.from_numpy(FR.pack([7])[0])
    expect = [i != bad for i in range(n_inst)]
    assert bcs.satisfied_per_instance().tolist() == expect
    assert bcs.satisfied_per_instance(chunk=2).tolist() == expect  # a Montgomery chunk smaller than N
    jcs, _, _ = poseidon_two_to_one(JAX, ls[bad], rs[bad])
    for c in (scalar[bad], jcs):
        c.assignments[k] = 7
    assert not jcs.is_satisfied() and not bcs.is_satisfied()
    # the Montgomery check names the constraint both packages' scalar tiers name
    # (JAX's batch raises NotImplementedError for a field circuit)
    first = bcs.which_unsatisfied()
    assert first.tolist() == [-1 if i != bad else jcs.which_unsatisfied() for i in range(n_inst)]
    assert bcs.which_unsatisfied(bad) == scalar[bad].which_unsatisfied() == jcs.which_unsatisfied()


def _field_plane(cs, cfg, xv, yv):
    x, y = FpVar.new_witness(cs, xv), FpVar.new_witness(cs, yv)
    eq = x.is_eq(y)
    inv = (x + y).inverse()
    sel = Boolean.select(eq, eq.not_(), eq)
    sp = PoseidonSpongeVar(cs, cfg)
    sp.absorb([x])
    return eq, inv, sel, sp.squeeze_bits(19)


def test_batched_field_plane_bits_is_eq_and_inverse():
    """The device-plane hooks: v_bits (squeeze_bits), v_is_zero and v_inv0
    (is_eq, inverse), v_from_bool and v_select, against the native sponge
    and the scalar tier."""
    cfg = get_default_poseidon_parameters(FR, 2, False)
    ins, other = [3, 5, 3, FR.p - 1], [3, 4, 3, 2]
    n_inst = len(ins)
    bcs = BatchConstraintSystem(FR, n_inst, device="cpu")
    eq, inv, sel, bits = _field_plane(bcs, cfg, torch.from_numpy(FR.pack(ins)), torch.from_numpy(FR.pack(other)))
    assert bcs.is_satisfied()
    assert eq.value.tolist() == [a == b for a, b in zip(ins, other)]
    assert sel.value.tolist() == [False] * n_inst
    for i in range(n_inst):
        h = PoseidonSponge(cfg)
        h.absorb_elements([ins[i]])
        assert [bool(b.value[i]) for b in bits] == h.squeeze_bits(19)
        assert bcs.value_host(inv.value, i) == pow(ins[i] + other[i], -1, FR.p)
        cs = ConstraintSystem(FR)
        _field_plane(cs, cfg, ins[i], other[i])
        assert (bcs.num_constraints, bcs.num_witness) == (cs.num_constraints, cs.num_witness)
        assert _column(bcs, i) == cs.assignments


def test_batched_uint32_select_and_which_unsatisfied():
    rng = random.Random(23)
    n_inst, bad = 5, 2
    xs = [rng.randrange(1 << 32) for _ in range(n_inst)]
    ys = [rng.randrange(1 << 32) for _ in range(n_inst)]
    cond = [bool(i % 2) for i in range(n_inst)]
    bcs = BatchConstraintSystem(FR, n_inst, device="cpu")
    xv = UInt32.new_witness(bcs, np.asarray(xs, np.uint64))
    yv = UInt32.new_witness(bcs, np.asarray(ys, np.uint64))
    cv = Boolean.new_witness(bcs, np.asarray(cond))
    sel = UInt32.select(cv, xv, yv)
    assert bcs.is_satisfied()
    assert [int(v) for v in sel.value] == [x if c else y for x, y, c in zip(xs, ys, cond)]
    cs = ConstraintSystem(FR)
    sx, sy = UInt32.new_witness(cs, xs[bad]), UInt32.new_witness(cs, ys[bad])
    s = UInt32.select(Boolean.new_witness(cs, cond[bad]), sx, sy)
    assert s.value == int(sel.value[bad]) and _column(bcs, bad) == cs.assignments
    # xor of two witnesses holding the same words is zero, one constraint a
    # bit; one output bit flipped in one instance is named
    zv = UInt32.new_witness(bcs, np.asarray(xs, np.uint64))
    x2 = xv ^ zv
    assert bcs.which_unsatisfied().tolist() == [-1] * n_inst
    k = list(x2.bits[5].fp.lc.terms)[0]
    bcs.assignments[k].v[bad] ^= 1
    first = bcs.which_unsatisfied().tolist()
    assert first[bad] >= 0 and all(first[i] == -1 for i in range(n_inst) if i != bad)
    assert bcs.which_unsatisfied(bad) == first[bad]
    assert bcs.satisfied_per_instance().tolist() == [i != bad for i in range(n_inst)]


def test_batch_constraint_system_needs_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(DeviceUnavailable):
        BatchConstraintSystem(FR, 2)


def test_montgomery_check_takes_host_rows_and_negative_values():
    """A circuit that mixes card values with host rows (a UInt32 word, a
    negative centered value) fails the small-domain bounds and takes the
    Montgomery check: the host rows go through to_mont (and neg) in
    stack_assignments; values and verdicts equal the scalar tier's."""
    xs, ws, negs = [3, FR.p - 2, 12345, 0], [7, 0xFFFFFFFF, 1, 2 ** 31], [-3, 5, -(2 ** 40), 0]
    bcs = BatchConstraintSystem(FR, 4, device="cpu")
    x = FpVar.new_witness(bcs, torch.from_numpy(FR.pack(xs)))
    w = UInt32.new_witness(bcs, np.asarray(ws, np.uint64)).to_fp()
    n = FpVar.new_witness(bcs, SmallWord(np.asarray(negs, np.int64), 2 ** 40))
    out = (x * w) * n
    assert isinstance(bcs.assignments[list(n.lc.terms)[0]], SmallWord)
    assert bcs._small_check_data() is None
    assert bcs.satisfied_per_instance().tolist() == [True] * 4
    assert bcs.satisfied_per_instance(chunk=3).tolist() == [True] * 4
    for i in range(4):
        cs = ConstraintSystem(FR)
        sx = FpVar.new_witness(cs, xs[i])
        sw = UInt32.new_witness(cs, ws[i]).to_fp()
        sn = FpVar.new_witness(cs, negs[i])
        sout = (sx * sw) * sn
        assert bcs.value_host(out.value, i) == sout.value == xs[i] * ws[i] * negs[i] % FR.p
        assert _column(bcs, i) == cs.assignments
    k = list(n.lc.terms)[0]
    bcs.assignments[k].v[2] += 1
    assert bcs.satisfied_per_instance().tolist() == [True, True, False, True]
