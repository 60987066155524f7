"""The port's plain field tier against crypto_primitives_tpu.ops.field.

Same inputs (made from a seed with numpy) go through both packages on the CPU;
limbs cross via crypto_primitives_tpu_torch.interop and are compared exactly,
word for word, and as Python ints.  P-256's fields, whose Montgomery R differs
between the two packages (2^272 and 2^288), cross with their spec, which
rescales the Montgomery forms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_primitives_tpu.ops import field as jff
from crypto_primitives_tpu.ops import curves_known as jck
from crypto_primitives_tpu.ops import fields_known as jfk
from crypto_primitives_tpu_torch import interop
from crypto_primitives_tpu_torch.ops import curves_known as tck
from crypto_primitives_tpu_torch.ops import field as tff
from crypto_primitives_tpu_torch.ops import fields_known as tfk

torch.set_num_threads(1)

FIELD_NAMES = ["BLS12_381_FR", "JUBJUB_FR", "BLS12_377_FR", "ED_ON_BLS12_377_FR", "BLS12_381_FQ"]
N = 48


def _values(p: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    nbytes = (p.bit_length() + 7) // 8 + 8
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % p for _ in range(N - 3)]
    return vals + [0, 1, p - 1]


@pytest.fixture(scope="module", params=FIELD_NAMES)
def fields(request):
    return getattr(jfk, request.param), getattr(tfk, request.param)


def test_field_constants_identical(fields):
    jspec, tspec = fields
    for attr in ("p", "nbits", "num_limbs", "R", "R_mod_p", "R2_mod_p", "n0", "n_prime",
                 "bigint_bytes", "compressed_bytes"):
        assert getattr(tspec, attr) == getattr(jspec, attr), attr
    for attr in ("p_limbs", "r_limbs", "r2_limbs", "n_prime_limbs"):
        assert np.array_equal(getattr(tspec, attr), getattr(jspec, attr)), attr


def test_pack_layout_matches_jax_limbs(fields):
    jspec, tspec = fields
    vals = _values(jspec.p, 1)
    for mont in (True, False):
        jl = jspec.pack(vals, mont=mont)
        tw = tspec.pack(vals, mont=mont)
        assert np.array_equal(interop.words_from_limbs(jl), tw)
        assert np.array_equal(interop.limbs_from_words(tw), jl)
        assert list(tspec.unpack(tw, mont=mont)) == vals


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops_match_jax(fields, op):
    jspec, tspec = fields
    a, b = _values(jspec.p, 2), _values(jspec.p, 3)[::-1]
    ja, jb = jspec.pack(a), jspec.pack(b)
    want = np.asarray(getattr(jff, op)(jspec, jnp.asarray(ja), jnp.asarray(jb)))
    got = getattr(tff, op)(
        tspec,
        torch.from_numpy(interop.words_from_limbs(ja)),
        torch.from_numpy(interop.words_from_limbs(jb)),
    ).numpy()
    assert np.array_equal(got, interop.words_from_limbs(want))
    assert list(tspec.unpack(got)) == list(jspec.unpack(want))


def test_mont_conversions_match_jax(fields):
    jspec, tspec = fields
    vals = _values(jspec.p, 4)
    std = jspec.pack(vals, mont=False)
    mont = jspec.pack(vals)
    want_to = np.asarray(jff.to_mont_device(jspec, jnp.asarray(std)))
    want_from = np.asarray(jff.from_mont_device(jspec, jnp.asarray(mont)))
    got_to = tff.to_mont(tspec, torch.from_numpy(interop.words_from_limbs(std))).numpy()
    got_from = tff.from_mont(tspec, torch.from_numpy(interop.words_from_limbs(mont))).numpy()
    assert np.array_equal(got_to, interop.words_from_limbs(want_to))
    assert np.array_equal(got_from, interop.words_from_limbs(want_from))


def test_pow_const_matches_host(fields):
    _, tspec = fields
    vals = _values(tspec.p, 5)[:8]
    got = tff.pow_const(tspec, torch.from_numpy(tspec.pack(vals)), 17)
    assert list(tspec.unpack(got)) == [pow(v, 17, tspec.p) for v in vals]


def _known_specs():
    specs = tfk.ALL_FIELDS + [tfk.BLS12_381_FQ]
    for c in tck.TE_CURVES + tck.SW_CURVES:
        specs += [c.base, c.scalar]
    return list({id(s): s for s in specs}.values())


def test_word_layout_rule_on_every_known_field():
    """W = ceil(nbits / 32) plus a spare word when p fills its words: the JAX
    R = 2^(16 L) for every known field but P-256's two, which take W = 9 and
    R = 2^288; every p keeps the spare top bit the kernels need."""
    p256 = {tck.SECP256R1_FQ.name, tck.SECP256R1_FR.name}
    specs = _known_specs()
    assert len(specs) == 11 and p256 <= {s.name for s in specs}
    for s in specs:
        assert s.p < 1 << (32 * s.num_words - 1), s.name
        assert s.R == 1 << (32 * s.num_words) and s.num_digits == 2 * s.num_words
        if s.name in p256:
            assert (s.num_limbs, s.num_words, s.R) == (17, 9, 1 << 288)
        else:
            assert s.num_limbs == 2 * s.num_words and s.R == 1 << (16 * s.num_limbs), s.name


@pytest.mark.parametrize("name", ["SECP256R1_FQ", "SECP256R1_FR"])
def test_p256_field_matches_jax(name):
    """P-256's fields on the batched tier: pack, unpack, add, sub, the
    Montgomery product and conversions equal the JAX package's, across
    interop's rescaling of the Montgomery forms."""
    jspec, tspec = getattr(jck, name), getattr(tck, name)
    assert (tspec.p, tspec.nbits, tspec.num_limbs, tspec.n0, tspec.bigint_bytes) == \
        (jspec.p, jspec.nbits, jspec.num_limbs, jspec.n0, jspec.bigint_bytes)
    a, b = _values(jspec.p, 6), _values(jspec.p, 7)[::-1]
    ja, jb = jspec.pack(a), jspec.pack(b)
    ta, tb = tspec.pack(a), tspec.pack(b)
    assert np.array_equal(interop.words_from_limbs(ja, tspec), ta)
    assert list(tspec.unpack(ta)) == a
    for op in ("add", "sub", "mont_mul"):
        want = np.asarray(getattr(jff, op)(jspec, jnp.asarray(ja), jnp.asarray(jb)))
        got = getattr(tff, op)(tspec, torch.from_numpy(ta), torch.from_numpy(tb)).numpy()
        assert np.array_equal(got, interop.words_from_limbs(want, tspec)), op
        assert list(tspec.unpack(got)) == list(jspec.unpack(want)), op
    std = jspec.pack(a, mont=False)
    got_to = tff.to_mont(tspec, torch.from_numpy(interop.words_from_limbs(std, tspec, mont=False))).numpy()
    assert np.array_equal(got_to, interop.words_from_limbs(np.asarray(jff.to_mont_device(jspec, jnp.asarray(std))), tspec))
    got_from = tff.from_mont(tspec, torch.from_numpy(ta)).numpy()
    want_from = np.asarray(jff.from_mont_device(jspec, jnp.asarray(ja)))
    assert np.array_equal(interop.limbs_from_words(got_from, tspec, mont=False), want_from)


@pytest.mark.parametrize("name", ["SECP256R1_FQ", "BLS12_381_FR", "BLS12_381_FQ"])
@pytest.mark.parametrize("mont", [True, False])
def test_interop_round_trips_jax_limbs(name, mont):
    """JAX limbs -> port words -> JAX limbs is the identity; for a field whose
    R is the same in both packages the words are the digits paired, with no
    arithmetic."""
    jspec = getattr(jck, name) if name.startswith("SECP") else getattr(jfk, name)
    tspec = getattr(tck, name) if name.startswith("SECP") else getattr(tfk, name)
    vals = _values(jspec.p, 8)
    limbs = jspec.pack(vals, mont=mont)
    words = interop.words_from_limbs(limbs, tspec, mont=mont)
    assert words.shape == (N, tspec.num_words)
    assert np.array_equal(words, tspec.pack(vals, mont=mont))
    assert np.array_equal(interop.limbs_from_words(words, tspec, mont=mont), limbs)
    if tspec.num_digits == tspec.num_limbs:
        assert np.array_equal(interop.words_from_limbs(limbs), words)
        assert np.array_equal(interop.limbs_from_words(words), limbs)


@pytest.mark.parametrize("name", ["BLS12_381_FR", "BLS12_377_FR", "BLS12_381_FQ"])
def test_field_probe_plain_ops_on_edge_values(name):
    """The plain values the card's field probe is held against, in Python
    ints, on every pair of edge words (words taken as Montgomery forms)."""
    import itertools

    from crypto_primitives_tpu_torch.ops import field_probe

    spec = getattr(tfk, name)
    p, R = spec.p, 1 << (32 * spec.num_words)
    vals = field_probe.edge_values(spec)
    assert 0 in vals and p - 1 in vals and R % p in vals and all(0 <= v < p for v in vals)
    pairs = list(itertools.product(vals, repeat=2))
    a = torch.from_numpy(spec.pack([x for x, _ in pairs], mont=False))
    b = torch.from_numpy(spec.pack([y for _, y in pairs], mont=False))
    rinv = pow(R, -1, p)
    want = {
        "mont_mul": [x * y * rinv % p for x, y in pairs],
        "dot3": [(3 * x * y * rinv + x) % p for x, y in pairs],
        "dot9": [(9 * x * y * rinv + x) % p for x, y in pairs],
        "sparse_row": [(x * y * rinv + x + y) % p for x, y in pairs],
        "add": [(x + y) % p for x, y in pairs],
        "sub": [(x - y) % p for x, y in pairs],
        "mont_sqr": [x * x * rinv % p for x, _ in pairs],
        "mul_chain": [x * (y * rinv) ** 3 % p for x, y in pairs],
        "sqr_chain": [pow(x * rinv, 8, p) * R % p for x, _ in pairs],
    }
    for op in field_probe.OPS:
        got = spec.unpack(field_probe.field_ops_plain(spec, op, a, b, iters=3), mont=False)
        assert [int(v) for v in got] == want[op], op
