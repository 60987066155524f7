"""The curve tier's windowed variable-base product (``ops/windowed_kernel.py``):
twisted-Edwards points in extended coordinates times scalars given as bits,
the 2^w multiples of each point, then w doublings and one addition a window.

On the CPU: the wrapper's plain branch against ``curve_fast.windowed_digits``
over the digit chain and, made affine, against the host oracle
``scalar_mul_host``, on every twisted-Edwards curve of ``curves_known``, at
the scalars 0, 1, r - 1, 2^250 and all-ones windows and on the identity and
the generator; the broadcast shapes of its callers (Schnorr's point a row,
ElGamal encrypt's one point, decrypt's one scalar, the IPA fold's stacked
halves); its refusals; and its spans, with no launch.

On the card (marked ``cuda``; each skips without one): the kernel against
the plain version word for word at batches 1, 255, 257, 4096 and 2^16, on
every twisted-Edwards curve's edge cases, under each broadcast shape and on
a view off a 16-byte boundary; its refusals (w != 4, W != 8); one launch a
call; and ``kernel.windowed`` with ``rows`` on a launch.  Run there from the
root of the repository (``tests/conftest.py`` imports JAX, which that
machine may not have):

    python -m pytest --noconftest -m cuda tests/test_torch_windowed_kernel.py
"""

import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crypto_primitives_tpu_torch.ops import curve as cv
from crypto_primitives_tpu_torch.ops import curve_fast, windowed_kernel
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops.curve import TECurveSpec
from crypto_primitives_tpu_torch.ops.curves_known import ED_ON_BLS12_377, TE_CURVES
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FQ, BLS12_381_FR
from crypto_primitives_tpu_torch.utils import profiling


def bits_of(ks, nbits) -> torch.Tensor:
    """Scalars (each < 2^nbits, not reduced) -> (n, nbits) uint8 bits, least
    significant first."""
    return torch.from_numpy(np.asarray([[(k >> i) & 1 for i in range(nbits)] for k in ks], dtype=np.uint8))


def edge_rows(curve, rng) -> tuple:
    """(host points, scalars, points (n, 4, W), bits (n, nbits)): random
    points, the identity and the generator, times 0, 1, r - 1, 2^250, every
    window all ones, and random scalars."""
    r, nbits = curve.scalar.p, curve.scalar.nbits
    ks = [0, 1, r - 1, 1 << 250, (1 << nbits) - 1, rng.randrange(r), rng.randrange(r), rng.randrange(r)]
    pts = [curve.rand_point(rng) for _ in ks[:-2]] + [(0, 1), curve.generator]
    return pts, ks, torch.from_numpy(curve_fast.pack_points(curve, pts)), bits_of(ks, nbits)


def digit_schedule(curve, base, bits, w=4) -> torch.Tensor:
    ident = curve._consts(base.device)["identity"]
    return ff.from_digits(curve_fast.windowed_digits(lambda a, b: cv.te_add_digits(curve, a, b), ident,
                                                     ff.to_digits(base), bits, w))


def broadcast_cases(curve, rng, n=6, nbits=24):
    """(name, base, bits): the callers' shapes, from a point a row to the IPA
    fold's stacked halves of per-instance points with a scalar an instance;
    short scalars, since the shapes do not depend on their length."""
    pts = torch.from_numpy(curve_fast.pack_points(curve, [curve.rand_point(rng) for _ in range(n)]))
    bits = bits_of([rng.randrange(1 << nbits) for _ in range(n)], nbits)
    W = curve.base.num_words
    return [
        ("schnorr", pts, bits),
        ("encrypt_one_point", pts[0], bits),
        ("decrypt_one_scalar", pts, bits[0]),
        ("ipa_fold", pts.reshape(2, 1, n // 2, 4, W), bits.reshape(2, n // 2, 1, nbits)),
    ]


@pytest.mark.parametrize("curve", TE_CURVES, ids=lambda c: c.name)
def test_plain_branch_equals_the_digit_schedule_and_the_oracle(curve):
    pts, ks, base, bits = edge_rows(curve, random.Random(TE_CURVES.index(curve)))
    n0 = windowed_kernel.launches
    got = windowed_kernel.te_windowed(curve, base, bits)
    assert windowed_kernel.launches == n0  # the CPU branch launches nothing
    assert got.dtype == torch.int32 and got.shape == base.shape
    assert torch.equal(got, digit_schedule(curve, base, bits))
    assert list(curve_fast.unpack_affine(curve, got)) == [curve.scalar_mul_host(p, k) for p, k in zip(pts, ks)]


@pytest.mark.parametrize("curve", TE_CURVES, ids=lambda c: c.name)
def test_plain_branch_broadcasts_as_its_callers_do(curve):
    for name, base, bits in broadcast_cases(curve, random.Random(10 + TE_CURVES.index(curve))):
        got = windowed_kernel.te_windowed(curve, base, bits)
        lead = torch.broadcast_shapes(base.shape[:-2], bits.shape[:-1])
        assert got.shape == lead + (4, curve.base.num_words), name
        rows = digit_schedule(curve, base.expand(lead + base.shape[-2:]).reshape(-1, 4, curve.base.num_words),
                              bits.expand(lead + bits.shape[-1:]).reshape(-1, bits.shape[-1]))
        assert torch.equal(got.reshape(rows.shape), rows), name


@pytest.mark.parametrize("bad", ["coords", "words", "rank", "bits_rank", "no_bits", "dtype", "bits_dtype",
                                 "other_curve", "two_devices", "meta"])
def test_refusals_on_the_cpu(bad):
    curve = ED_ON_BLS12_377
    base = torch.zeros((2, 4, 8), dtype=torch.int32)
    bits = torch.zeros((2, 251), dtype=torch.uint8)
    match = r"\(\.\.\., 4, 8\)"
    if bad == "coords":
        base = base[:, :3]
    elif bad == "words":
        base = base[..., :7]
    elif bad == "rank":
        base = base[0, 0]
    elif bad == "bits_rank":
        bits, match = bits[0, 0], "nbits"
    elif bad == "no_bits":
        bits, match = bits[:, :0], "nbits"
    elif bad == "dtype":
        base, match = base.to(torch.int64), "int32"
    elif bad == "bits_dtype":
        bits, match = bits.to(torch.int32), "uint8"
    elif bad == "other_curve":  # W = 8 points handed to a W = 12 curve
        curve, match = TECurveSpec("test_w12", BLS12_381_FQ, BLS12_381_FR, -1, 5, 1), r"\(\.\.\., 4, 12\)"
    elif bad == "two_devices":
        bits, match = bits.to("meta"), "two devices"
    else:
        base, bits, match = base.to("meta"), bits.to("meta"), "CUDA or CPU"
    n0 = windowed_kernel.launches
    with pytest.raises(ValueError, match=match):
        windowed_kernel.te_windowed(curve, base, bits)
    assert windowed_kernel.launches == n0


def test_product_routes_through_the_wrapper_and_its_spans():
    curve = ED_ON_BLS12_377
    _, _, base, bits = edge_rows(curve, random.Random(7))
    bits = bits[:, :8]  # two windows
    with profile(activities=[ProfilerActivity.CPU]):
        got = curve_fast.scalar_mul_bits_windowed(curve, base[0], bits)
    assert torch.equal(got, digit_schedule(curve, base[0], bits))
    # the product's one span is the wrapper's (a verify holds it in ``sig.windowed``); on the
    # plain branch it has no rows, which only a kernel launch carries
    assert [(s.name, s.parent, s.rows) for s in profiling.spans()] == [("kernel.windowed", None, None)]


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def card_rows(curve, batch, g):
    """(batch, 4, W) random canonical words and (batch, nbits) random bits,
    made on the card: the arithmetic is the same whatever the coordinates."""
    W = curve.base.num_words
    w = torch.randint(-(1 << 31), 1 << 31, (batch, 4, W), dtype=torch.int64, device=g.device, generator=g)
    w[..., -1] = torch.randint(0, curve.base.p >> (32 * (W - 1)), (batch, 4), device=g.device, generator=g)
    bits = torch.randint(0, 2, (batch, curve.scalar.nbits), dtype=torch.uint8, device=g.device, generator=g)
    return w.to(torch.int32), bits


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 255, 257, 4096, 1 << 16])
def test_kernel_at_every_batch(cuda, batch):
    curve = ED_ON_BLS12_377
    g = torch.Generator(device=cuda).manual_seed(batch)
    base, bits = card_rows(curve, batch, g)
    n0 = windowed_kernel.launches
    got = windowed_kernel.te_windowed(curve, base, bits)
    assert windowed_kernel.launches == n0 + 1
    assert got.shape == (batch, 4, 8)
    # the plain version on the card: the same arithmetic
    assert torch.equal(got, windowed_kernel.te_windowed_plain(curve, base, bits, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("curve", TE_CURVES, ids=lambda c: c.name)
def test_kernel_equals_the_plain_version_and_the_oracle(cuda, curve):
    pts, ks, base, bits = edge_rows(curve, random.Random(20 + TE_CURVES.index(curve)))
    with profile(activities=[ProfilerActivity.CPU]):
        got = windowed_kernel.te_windowed(curve, base.to(cuda), bits.to(cuda))
    assert [(s.name, s.rows) for s in profiling.spans()] == [("kernel.windowed", base.shape[0])]
    assert torch.equal(got.cpu(), windowed_kernel.te_windowed_plain(curve, base, bits, 4))
    assert list(curve_fast.unpack_affine(curve, got)) == [curve.scalar_mul_host(p, k) for p, k in zip(pts, ks)]


@pytest.mark.cuda
@pytest.mark.parametrize("curve", TE_CURVES, ids=lambda c: c.name)
def test_kernel_broadcasts_as_its_callers_do(cuda, curve):
    for name, base, bits in broadcast_cases(curve, random.Random(30 + TE_CURVES.index(curve))):
        n0 = windowed_kernel.launches
        got = windowed_kernel.te_windowed(curve, base.to(cuda), bits.to(cuda))
        assert windowed_kernel.launches == n0 + 1, name
        assert torch.equal(got.cpu(), windowed_kernel.te_windowed(curve, base, bits)), name


@pytest.mark.cuda
def test_kernel_takes_views_off_a_16_byte_boundary(cuda):
    """The kernel reads 16-byte vectors: the wrapper hands it a copy of a
    view that starts one word into its storage."""
    curve = ED_ON_BLS12_377
    g = torch.Generator(device=cuda).manual_seed(35)
    base, bits = card_rows(curve, 33, g)
    flat = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda), base.flatten()])
    view = flat[1:].view(33, 4, 8)
    assert view.data_ptr() % 16 == 4
    got = windowed_kernel.te_windowed(curve, view, bits[:, 1:])
    assert torch.equal(got, windowed_kernel.te_windowed_plain(curve, base, bits[:, 1:], 4))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["w3", "w5", "not_built"])
def test_kernel_refusals(cuda, bad):
    curve = ED_ON_BLS12_377
    g = torch.Generator(device=cuda).manual_seed(40)
    base, bits = card_rows(curve, 6, g)
    w, err, match = 4, ValueError, "windows of 4 bits"
    if bad in ("w3", "w5"):
        w = int(bad[1])
    else:  # a twisted-Edwards curve of a width the kernel is not built for: the kernel's own refusal
        curve = TECurveSpec("test_w12", BLS12_381_FQ, BLS12_381_FR, -1, 5, 1)
        base = torch.zeros((6, 4, 12), dtype=torch.int32, device=cuda)
        err, match = RuntimeError, "curve_windowed: CUDA error"
    n0 = windowed_kernel.launches
    with pytest.raises(err, match=match):
        windowed_kernel.te_windowed(curve, base, bits, w)
    assert windowed_kernel.launches == n0
