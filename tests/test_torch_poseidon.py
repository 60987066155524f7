"""The port's Poseidon parameters, permutation and sponges against the JAX package.

Inputs are made from a seed with numpy and go through both packages on the
CPU; field elements cross through crypto_primitives_tpu_torch.interop and are
compared exactly.  The JAX side is its XLA reference path
(models/sponge/poseidon.permute, the limb-rep PoseidonSpongeBatch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_primitives_tpu.models import sponge as jsponge
from crypto_primitives_tpu.models.sponge import poseidon as jposeidon
from crypto_primitives_tpu.models.sponge.grain_lfsr import PoseidonGrainLFSR as JGrain
from crypto_primitives_tpu.ops import fields_known as jfk
from crypto_primitives_tpu_torch import interop
from crypto_primitives_tpu_torch.errors import MissingParameters
from crypto_primitives_tpu_torch.models import sponge as tsponge
from crypto_primitives_tpu_torch.models.sponge.grain_lfsr import PoseidonGrainLFSR as TGrain
from crypto_primitives_tpu_torch.ops import fields_known as tfk
from crypto_primitives_tpu_torch.ops import poseidon_kernel

torch.set_num_threads(1)

PINNED = [
    40442793463571304028337753002242186710310163897048962278675457993207843616876,
    2664374461699898000291153145224099287711224021716202960480903840045233645301,
    50191078828066923662070228256530692951801504043422844038937334196346054068797,
]
FIELD_NAMES = ["BLS12_381_FR", "JUBJUB_FR", "BLS12_377_FR", "ED_ON_BLS12_377_FR", "BLS12_381_FQ"]


def _configs(name: str):
    """(JAX config, port config): the default table for BLS12-381 Fr, and the
    rate-2 shape of that table (alpha 5 for the 381-bit field) elsewhere."""
    jspec = getattr(jfk, name)
    if name == "BLS12_381_FR":
        jcfg = jsponge.get_default_poseidon_parameters(jspec, 2, False)
    else:
        alpha, partial = (5, 60) if name == "BLS12_381_FQ" else (17, 31)
        ark, mds = jsponge.find_poseidon_ark_and_mds(jspec, 2, 8, partial, 0)
        jcfg = jsponge.PoseidonConfig(jspec, 8, partial, alpha, ark, mds, 2, 1)
    tcfg = interop.poseidon_config(jspec.p, jcfg.ark, jcfg.mds, jcfg.full_rounds,
                                   jcfg.partial_rounds, jcfg.alpha, jcfg.rate, jcfg.capacity)
    assert tcfg.field is getattr(tfk, name)
    return jcfg, tcfg


def _random_values(p: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    nbytes = (p.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nbytes), "little") % p for _ in range(n)]


def test_grain_lfsr_stream_matches_jax():
    j, t = JGrain(False, 255, 3, 8, 31), TGrain(False, 255, 3, 8, 31)
    p = jfk.BLS12_381_FR.p
    assert t.get_bits(300) == j.get_bits(300)
    assert t.get_field_elements_rejection_sampling(p, 4) == j.get_field_elements_rejection_sampling(p, 4)
    assert t.get_field_elements_mod_p(p, 4) == j.get_field_elements_mod_p(p, 4)


@pytest.mark.parametrize("rate", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("weights", [False, True])
def test_default_parameter_tables_match_jax(rate, weights):
    j = jsponge.get_default_poseidon_parameters(jfk.BLS12_381_FR, rate, weights)
    t = tsponge.get_default_poseidon_parameters(tfk.BLS12_381_FR, rate, weights)
    assert (t.full_rounds, t.partial_rounds, t.alpha, t.rate, t.capacity) == (
        j.full_rounds, j.partial_rounds, j.alpha, j.rate, j.capacity)
    assert t.ark == j.ark
    assert t.mds == j.mds


@pytest.mark.parametrize("name", FIELD_NAMES)
def test_plain_permute_matches_jax(name):
    jcfg, tcfg = _configs(name)
    jspec = jcfg.field
    vals = _random_values(jspec.p, 4 * 3, seed=11)
    vals[:3] = [0, 1, jspec.p - 1]
    jstate = jspec.pack(np.asarray(vals, dtype=object).reshape(4, 3))
    want = np.asarray(jposeidon.permute(jspec, jcfg.packed(), jnp.asarray(jstate)))
    # the public permute takes any leading batch shape; on CPU tensors it runs
    # poseidon_kernel.permute_plain
    words = torch.from_numpy(interop.words_from_limbs(jstate))
    got = tsponge.permute(tcfg, words.reshape(2, 2, 3, -1)).reshape(4, 3, -1)
    assert np.array_equal(got.numpy(), interop.words_from_limbs(want))


def test_host_sponge_pinned_vector():
    cfg = tsponge.get_default_poseidon_parameters(tfk.BLS12_381_FR, 2, False)
    sponge = tsponge.PoseidonSponge(cfg)
    sponge.absorb([tsponge.Felt(0), tsponge.Felt(1), tsponge.Felt(2)])
    assert sponge.squeeze_native_field_elements(3) == PINNED


def test_batched_sponge_pinned_vector():
    cfg = tsponge.get_default_poseidon_parameters(tfk.BLS12_381_FR, 2, False)
    sponge = tsponge.PoseidonSpongeBatch(cfg, batch_shape=(2,), device="cpu")
    sponge.absorb(torch.from_numpy(tfk.BLS12_381_FR.pack([[0, 1, 2]] * 2)))
    out = tfk.BLS12_381_FR.unpack(sponge.squeeze_native_field_elements(3))
    assert [[int(v) for v in row] for row in out] == [PINNED, PINNED]


def test_batched_mode_switches_match_jax():
    """absorb/squeeze interleavings across the rate boundary, including the
    squeeze-at-boundary permutation skip, step by step against JAX's limb-rep
    PoseidonSpongeBatch."""
    jspec, tspec = jfk.BLS12_381_FR, tfk.BLS12_381_FR
    jcfg = jsponge.get_default_poseidon_parameters(jspec, 2, False)
    tcfg = tsponge.get_default_poseidon_parameters(tspec, 2, False)
    B = 4  # the batch of test_plain_permute_matches_jax: JAX compiles permute once
    js = jsponge.PoseidonSpongeBatch(jcfg, batch_shape=(B,), rep="limb")
    ts = tsponge.PoseidonSpongeBatch(tcfg, batch_shape=(B,), device="cpu")
    seed = 21
    for op, k in [("absorb", 1), ("squeeze", 2), ("absorb", 3), ("squeeze", 1),
                  ("squeeze", 3), ("absorb", 2), ("absorb", 1), ("squeeze", 2)]:
        if op == "absorb":
            vals = np.asarray(_random_values(jspec.p, B * k, seed), dtype=object).reshape(B, k)
            seed += 1
            limbs = jspec.pack(vals)
            js.absorb(jnp.asarray(limbs))
            ts.absorb(torch.from_numpy(interop.words_from_limbs(limbs)))
        else:
            want = np.asarray(js.squeeze_native_field_elements(k))
            got = ts.squeeze_native_field_elements(k).numpy()
            assert np.array_equal(got, interop.words_from_limbs(want))
        assert (ts.mode, ts.index) == (js.mode, js.index)
    assert np.array_equal(ts.state.numpy(), interop.words_from_limbs(np.asarray(js.state)))


def test_batched_byte_tiers_match_host():
    cfg = tsponge.get_default_poseidon_parameters(tfk.BLS12_381_FR, 2, False)
    host = tsponge.PoseidonSponge(cfg)
    host.absorb([tsponge.Felt(5), tsponge.Felt(6)])
    batch = tsponge.PoseidonSpongeBatch(cfg, batch_shape=(1,), device="cpu")
    batch.absorb(torch.from_numpy(tfk.BLS12_381_FR.pack([[5, 6]])))
    assert bytes(batch.squeeze_bytes(40)[0].numpy()) == host.squeeze_bytes(40)
    assert batch.squeeze_bits(70)[0].tolist() == host.squeeze_bits(70)
    sizes = [tsponge.FieldElementSize.Truncated(100), tsponge.FieldElementSize.FULL]
    got = batch.squeeze_field_elements_with_sizes(tfk.JUBJUB_FR, sizes)
    assert [int(v) for v in tfk.JUBJUB_FR.unpack(got[0])] == host.squeeze_field_elements_with_sizes(tfk.JUBJUB_FR, sizes)


@pytest.mark.parametrize("field,rate,weights", [
    ("BLS12_381_FQ", 2, False),  # no table for the field
    ("BLS12_381_FR", 9, False),  # no row for the rate
    ("BLS12_381_FR", 9, True),
])
def test_missing_default_parameters_raise(field, rate, weights):
    """Both packages return None where no default table exists; the port's
    sponges then raise MissingParameters with the way to derive parameters
    (the JAX package's batched sponge fails with AttributeError instead)."""
    assert jsponge.get_default_poseidon_parameters(getattr(jfk, field), rate, weights) is None
    assert tsponge.get_default_poseidon_parameters(getattr(tfk, field), rate, weights) is None
    for make in (lambda: tsponge.PoseidonSponge(None), lambda: tsponge.PoseidonSpongeBatch(None, device="cpu")):
        with pytest.raises(MissingParameters, match="find_poseidon_ark_and_mds"):
            make()
    with pytest.raises(TypeError):
        tsponge.PoseidonSpongeBatch(object(), device="cpu")


def test_kernel_wrapper_has_no_fallback():
    """A tensor on a device that is neither the CPU nor CUDA is refused, not
    computed some other way."""
    cfg = tsponge.get_default_poseidon_parameters(tfk.BLS12_381_FR, 2, False)
    with pytest.raises(ValueError):
        poseidon_kernel.permute(cfg, torch.empty((4, 3, 8), dtype=torch.int32, device="meta"))
