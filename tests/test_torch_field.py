"""The port's plain field tier against crypto_primitives_tpu.ops.field.

Same inputs (made from a seed with numpy) go through both packages on the CPU;
limbs cross via crypto_primitives_tpu_torch.interop and are compared exactly,
word for word, and as Python ints.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_primitives_tpu.ops import field as jff
from crypto_primitives_tpu.ops import fields_known as jfk
from crypto_primitives_tpu_torch import interop
from crypto_primitives_tpu_torch.errors import UnsupportedField
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


def test_field_without_word_layout_raises():
    p256 = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
    spec = tff.FieldSpec("p256", p256)
    assert spec.num_limbs == 17 and spec.R == jff.FieldSpec("p256", p256).R
    with pytest.raises(UnsupportedField):
        spec.pack([1])
    with pytest.raises(UnsupportedField):
        tff.zeros(spec, (2,))


@pytest.mark.parametrize("name", ["BLS12_381_FR", "BLS12_377_FR", "BLS12_381_FQ"])
def test_field_probe_plain_ops_on_edge_values(name):
    """The plain values the card's field probe is held against, in Python
    ints, on every pair of edge words (words taken as Montgomery forms)."""
    import itertools

    from crypto_primitives_tpu_torch.ops import field_probe

    spec = getattr(tfk, name)
    p, R = spec.p, 1 << (32 * spec.require_words())
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
