"""The port's Bowe-Hopwood CRH, its two-to-one CRH and the injective-map
compressors (CRH, two-to-one CRH, commitment) against the JAX package's.

Parameters come from one ``random.Random`` seed on both sides (and are also
carried across with ``interop``); inputs are made from a seed with numpy.
Host results are compared as Python ints; batched results (the port's plain
PyTorch versions on the CPU) word for word after ``interop.words_from_limbs``.
The JAX package's ``evaluate_batch`` runs its XLA grouped path off the TPU.
Tolerance: exact equality throughout.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_primitives_tpu.models.commitment import PedersenCommitmentCompressor as JComCompressor
from crypto_primitives_tpu.models.crh.bowe_hopwood import BoweHopwoodCRH as JBH
from crypto_primitives_tpu.models.crh.bowe_hopwood import BoweHopwoodTwoToOneCRH as JBHTwo
from crypto_primitives_tpu.models.crh.bowe_hopwood import max_chunks_per_segment as j_max_chunks
from crypto_primitives_tpu.models.crh.injective_map import PedersenCRHCompressor as JCRHCompressor
from crypto_primitives_tpu.models.crh.injective_map import PedersenTwoToOneCRHCompressor as JTwoCompressor
from crypto_primitives_tpu.models.crh.pedersen import Window as JWindow
from crypto_primitives_tpu.ops import curves_known as jck
from crypto_primitives_tpu_torch import interop
from crypto_primitives_tpu_torch.models.commitment import PedersenCommitmentCompressor
from crypto_primitives_tpu_torch.models.crh import Window
from crypto_primitives_tpu_torch.models.crh.bowe_hopwood import (
    BoweHopwoodCRH,
    BoweHopwoodTwoToOneCRH,
    max_chunks_per_segment,
)
from crypto_primitives_tpu_torch.models.crh.injective_map import (
    PedersenCRHCompressor,
    PedersenTwoToOneCRHCompressor,
    TECompressor,
)
from crypto_primitives_tpu_torch.ops import curve_fast, curve_sw_fast
from crypto_primitives_tpu_torch.ops import curves_known as tck

torch.set_num_threads(1)
CPU = "cpu"


def _inputs(rows, nbytes, seed):
    return np.random.default_rng(seed).integers(0, 256, (rows, nbytes), dtype=np.uint8)


@pytest.mark.parametrize("name", ["JUBJUB", "ED_ON_BLS12_377"])
def test_setup_and_signed_combos_match_jax(name):
    j, t = getattr(jck, name), getattr(tck, name)
    jb, tb = JBH(j, JWindow(4, 8)), BoweHopwoodCRH(t, Window(4, 8))
    jp, tp = jb.setup(random.Random(3)), tb.setup(random.Random(3))
    assert tp.generators == jp.generators
    assert max_chunks_per_segment(t.scalar.p) == j_max_chunks(j.scalar.p)
    for n_real in (11, 32):
        assert tp._signed_combos(n_real) == jp._signed_combos(n_real)
    table = tp.packed_signed_grouped(11)
    assert table.shape == (32, 8, 3, t.base.num_words)
    # the identity rows past n_real, and (x, y, d x y) of a negated combo
    assert [int(v) for v in t.base.unpack(table[11:, 5].reshape(-1, t.base.num_words))] == [0, 1, 0] * 21
    x, y = jp._signed_combos(11)[0][6]
    assert [int(v) for v in t.base.unpack(table[0, 6])] == [x, y, t.d * x * y % t.base.p]


@pytest.mark.parametrize("nbytes", [12, 4, 5, 1])
def test_host_evaluate_matches_jax(nbytes):
    """12 bytes fill the 4 x 8 window's 96 bits; 4, 5 and 1 byte give bit
    lengths that are not a multiple of 3, padded to the next chunk."""
    j, t = jck.JUBJUB, tck.JUBJUB
    jb, tb = JBH(j, JWindow(4, 8)), BoweHopwoodCRH(t, Window(4, 8))
    jp = jb.setup(random.Random(4))
    tp = tb.setup(random.Random(4))
    carried = interop.bowe_hopwood_parameters(t, jp.generators)
    for row in _inputs(3, nbytes, nbytes):
        want = jb.evaluate(jp, bytes(row))
        assert tb.evaluate(tp, bytes(row)) == want
        assert tb.evaluate(carried, bytes(row)) == want


@pytest.mark.parametrize("nbytes", [12, 4, 5])
def test_evaluate_batch_matches_jax_batch(nbytes):
    j, t = jck.JUBJUB, tck.JUBJUB
    jb, tb = JBH(j, JWindow(4, 8)), BoweHopwoodCRH(t, Window(4, 8))
    jp = jb.setup(random.Random(5))
    tp = interop.bowe_hopwood_parameters(t, jp.generators)
    data = _inputs(6, nbytes, 10 + nbytes)
    data[0] = 0
    data[1] = 255
    jout = np.asarray(jb.evaluate_batch(jp, jnp.asarray(data)))
    tout = tb.evaluate_batch(tp, data, device=CPU)
    assert tout.shape == (6, t.base.num_words)
    assert np.array_equal(interop.words_from_limbs(jout), tout.numpy())
    assert [int(v) for v in t.base.unpack(tout)] == [jb.evaluate(jp, bytes(r)) for r in data]


def test_evaluate_batch_keeps_leading_axes_and_ed_on_bls12_377():
    t = tck.ED_ON_BLS12_377
    tb = BoweHopwoodCRH(t, Window(5, 6))
    tp = tb.setup(random.Random(6))
    data = _inputs(6, 11, 7).reshape(2, 3, 11)
    out = tb.evaluate_batch(tp, data, device=CPU)
    assert out.shape == (2, 3, t.base.num_words)
    assert [int(v) for v in t.base.unpack(out.reshape(6, -1))] == \
        [tb.evaluate(tp, bytes(r)) for r in data.reshape(6, 11)]


def test_window_check_and_lengths_raise():
    t = tck.JUBJUB
    too_wide = max_chunks_per_segment(t.scalar.p) + 1
    with pytest.raises(ValueError, match="maximum segment size"):
        BoweHopwoodCRH(t, Window(too_wide, 2)).setup(random.Random(1))
    with pytest.raises(ValueError, match="maximum segment size"):
        JBH(jck.JUBJUB, JWindow(too_wide, 2)).setup(random.Random(1))
    tb = BoweHopwoodCRH(t, Window(4, 8))
    tp = tb.setup(random.Random(2))
    with pytest.raises(ValueError, match="bitlength"):
        tb.evaluate(tp, bytes(13))
    with pytest.raises(ValueError, match="bitlength"):
        tb.evaluate_batch(tp, np.zeros((2, 13), np.uint8), device=CPU)
    two = BoweHopwoodTwoToOneCRH(t, Window(4, 8))
    with pytest.raises(ValueError):
        two.evaluate(tp, bytes(2), bytes(3))
    with pytest.raises(ValueError):
        two.evaluate(tp, bytes(7), bytes(7))


def test_two_to_one_matches_jax():
    j, t = jck.JUBJUB, tck.JUBJUB
    # the halves hold two serialized field elements (32 bytes each)
    window = (43, 4)
    jtwo, ttwo = JBHTwo(j, JWindow(*window)), BoweHopwoodTwoToOneCRH(t, Window(*window))
    jp, tp = jtwo.setup(random.Random(8)), ttwo.setup(random.Random(8))
    assert tp.generators == jp.generators
    left, right = _inputs(2, 32, 9)
    assert ttwo.evaluate(tp, bytes(left), bytes(right)) == jtwo.evaluate(jp, bytes(left), bytes(right))
    x1, x2 = jtwo.evaluate(jp, bytes(left), bytes(right)), jtwo.evaluate(jp, bytes(right), bytes(left))
    assert ttwo.compress(tp, x1, x2) == jtwo.compress(jp, x1, x2)


@pytest.mark.parametrize("mod", [curve_fast, curve_sw_fast])
def test_pack_table_grouped_is_pack_combos_of_subset_groups(mod):
    t = tck.JUBJUB if mod is curve_fast else tck.BLS12_381_G1
    pts = [t.rand_point(random.Random(10 + i)) for i in range(7)]
    groups = mod.subset_groups(t, pts, 3)
    assert np.array_equal(mod.pack_table_grouped(t, pts, 3), mod.pack_combos(t, groups))
    assert mod.pack_combos(t, groups).shape == (3, 8, 3, t.base.num_words)
    with pytest.raises(ValueError):
        mod.pack_combos(t, [groups[0], groups[1][:4]])


def test_crh_compressors_match_jax():
    j, t = jck.JUBJUB, tck.JUBJUB
    jc, tc = JCRHCompressor(j, JWindow(6, 8)), PedersenCRHCompressor(t, Window(6, 8))
    jp, tp = jc.setup(random.Random(11)), tc.setup(random.Random(11))
    assert tp.generators == jp.generators
    data = _inputs(4, 6, 12)
    for row in data:
        assert tc.evaluate(tp, bytes(row)) == jc.evaluate(jp, bytes(row))
    jout = np.asarray(jc.evaluate_batch(jp, jnp.asarray(data)))
    tout = tc.evaluate_batch(tp, data, device=CPU)
    assert np.array_equal(interop.words_from_limbs(jout), tout.numpy())
    assert torch.equal(tout, TECompressor.injective_map_batch(tc.crh.evaluate_batch(tp, data, device=CPU)))

    jtwo, ttwo = JTwoCompressor(j, JWindow(4, 128)), PedersenTwoToOneCRHCompressor(t, Window(4, 128))
    jp2, tp2 = jtwo.setup(random.Random(13)), ttwo.setup(random.Random(13))
    left, right = _inputs(2, 32, 14)
    assert ttwo.evaluate(tp2, bytes(left), bytes(right)) == jtwo.evaluate(jp2, bytes(left), bytes(right))
    x1, x2 = (int.from_bytes(bytes(r), "little") % t.base.p for r in (left, right))
    assert ttwo.compress(tp2, x1, x2) == jtwo.compress(jp2, x1, x2)


def test_commitment_compressor_matches_jax():
    j, t = jck.JUBJUB, tck.JUBJUB
    jc, tc = JComCompressor(j, JWindow(6, 8)), PedersenCommitmentCompressor(t, Window(6, 8))
    jp, tp = jc.setup(random.Random(15)), tc.setup(random.Random(15))
    rng_j, rng_t = random.Random(16), random.Random(16)
    rs = [jc.rand_randomness(rng_j) for _ in range(4)]
    assert [tc.rand_randomness(rng_t) for _ in range(4)] == rs
    data = _inputs(4, 6, 17)
    for row, r in zip(data, rs):
        assert tc.commit(tp, bytes(row), r) == jc.commit(jp, bytes(row), r)
    rbits = tc.inner.randomness_to_bits(rs)
    jout = np.asarray(jc.commit_batch(jp, jnp.asarray(data), jnp.asarray(rbits)))
    tout = tc.commit_batch(tp, data, rbits, device=CPU)
    assert np.array_equal(interop.words_from_limbs(jout), tout.numpy())
