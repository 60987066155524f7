"""The curve tier's device pack (``ops/curve_fast.pack_points_device``,
``ops/pack_kernel.py``): host twisted-Edwards points to extended Montgomery
words, the canonical (x, y) words built on the host and the Montgomery form,
T and Z computed on the device.

On the CPU: the device pack against the host pack
(``TECurveSpec.pack_points``) word for word on every twisted-Edwards curve
of ``curves_known``, for one tuple, lists of 1, 255 and 4097 points, the
identity and coordinates given as p + v and -v; its spans; the plain
branch's refusals; the SW twin (the host pack and its upload); and each
caller (Schnorr's ``verify_batch``, ElGamal's two batches, the IPA fold)
packing its host points once a call.

On the card (marked ``cuda``; each skips without one): A4 against the plain
version at batches 0, 1, 255 and 2^16 + 3 and on a view off a 16-byte
boundary, and its refusals (A4 against the host pack on 2^16 + 1 points of
each curve, and each path's launches, are in ``tests/test_torch_cuda.py``).
Run there from the root of the repository (``tests/conftest.py`` imports
JAX, which that machine may not have):

    python -m pytest --noconftest -m cuda tests/test_torch_pack_kernel.py
"""

import random

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crypto_primitives_tpu_torch.ops import curve_fast, curve_sw_fast, pack_kernel
from crypto_primitives_tpu_torch.ops.curve import TECurveSpec
from crypto_primitives_tpu_torch.ops.curves_known import ED_ON_BLS12_377, JUBJUB, PALLAS, TE_CURVES
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FQ, BLS12_381_FR
from crypto_primitives_tpu_torch.utils import profiling


def multiples(curve, rng, n) -> list:
    """n curve points: k P for k = 1..n of a random subgroup point P."""
    base = curve.rand_point(rng)
    pts = [base]
    while len(pts) < n:
        pts.append(curve.add_host(pts[-1], base))
    return pts


def shape_case(curve, shape, rng):
    """The host points of one case: a tuple or a list."""
    p = curve.base.p
    if shape == "tuple":
        return multiples(curve, rng, 1)[0]
    if shape == "identity":
        return [(0, 1), curve.rand_point(rng), (0, 1)]
    pts = multiples(curve, rng, 5)
    if shape == "p_plus_v":
        return [(p + x, y) for x, y in pts[:2]] + [(x, 2 * p + y) for x, y in pts[2:]]
    if shape == "minus_v":
        return [(-x, y) for x, y in pts[:2]] + [(x - p, -y) for x, y in pts[2:]] + [(-p, -1)]
    return multiples(curve, rng, int(shape))


SHAPES = ["tuple", "1", "255", "4097", "identity", "p_plus_v", "minus_v"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("curve", TE_CURVES, ids=lambda c: c.name)
def test_device_pack_equals_the_host_pack(curve, shape):
    rng = random.Random(f"{curve.name} {shape}")
    pts = shape_case(curve, shape, rng)
    n0 = pack_kernel.launches
    got = curve_fast.pack_points_device(curve, pts, "cpu")
    assert pack_kernel.launches == n0  # the CPU branch launches nothing
    want = torch.from_numpy(curve.pack_points(pts))
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    rows = [pts] if isinstance(pts, tuple) else pts
    p = curve.base.p
    assert list(curve.unpack_points(got.reshape(-1, 4, curve.base.num_words))) == \
           [(x % p, y % p) for x, y in rows]


def test_spans_of_a_device_pack():
    """``curve.pack`` covers the host words (``rows``: the points, one tuple
    counts 1), ``kernel.pack`` the Montgomery form, with no ``rows`` on the
    plain branch."""
    curve = ED_ON_BLS12_377
    pts = multiples(curve, random.Random(1), 6)
    with profile(activities=[ProfilerActivity.CPU]):
        curve_fast.pack_points_device(curve, pts, "cpu")
        curve_fast.pack_points_device(curve, pts[0], "cpu")
        curve_fast.pack_points_device(curve, [], "cpu")
    assert [(s.name, s.parent, s.rows) for s in profiling.spans()] == [
        ("curve.pack", None, 6), ("kernel.pack", None, None), ("curve.pack", None, 1), ("kernel.pack", None, None),
        ("curve.pack", None, 0), ("kernel.pack", None, None)]


def test_an_empty_list_packs_to_no_rows():
    got = curve_fast.pack_points_device(JUBJUB, [], "cpu")
    assert got.shape == (0, 4, JUBJUB.base.num_words) and got.dtype == torch.int32


@pytest.mark.parametrize("bad", ["coords", "words", "rank", "dtype", "other_curve", "meta"])
def test_refusals_on_the_cpu(bad):
    curve = ED_ON_BLS12_377
    xy = torch.zeros((3, 2, 8), dtype=torch.int32)
    match = r"\(\.\.\., 2, 8\)"
    if bad == "coords":
        xy = torch.zeros((3, 4, 8), dtype=torch.int32)
    elif bad == "words":
        xy = xy[..., :7]
    elif bad == "rank":
        xy = xy[0, 0]
    elif bad == "dtype":
        xy, match = xy.to(torch.int64), "int32"
    elif bad == "other_curve":  # W = 8 words handed to a W = 12 curve
        curve, match = TECurveSpec("test_w12", BLS12_381_FQ, BLS12_381_FR, -1, 5, 1), r"\(\.\.\., 2, 12\)"
    else:
        xy, match = xy.to("meta"), "CUDA or CPU"
    n0 = pack_kernel.launches
    with pytest.raises(ValueError, match=match):
        pack_kernel.te_pack(curve, xy)
    assert pack_kernel.launches == n0


def test_sw_twin_is_the_host_pack_and_its_upload():
    rng = random.Random(4)
    pts = [PALLAS.rand_point(rng) for _ in range(3)] + [None]
    with profile(activities=[ProfilerActivity.CPU]):
        got = curve_sw_fast.pack_points_device(PALLAS, pts, "cpu")
        one = curve_sw_fast.pack_points_device(PALLAS, pts[0], "cpu")
    assert torch.equal(got, torch.from_numpy(PALLAS.pack_points(pts)))
    assert torch.equal(one, torch.from_numpy(PALLAS.pack_points(pts[0])))
    assert [(s.name, s.rows) for s in profiling.spans()] == [("curve.pack", 4), ("curve.pack", 1)]


def _schnorr_verify(curve, rng):
    from crypto_primitives_tpu_torch.models.signature import Schnorr

    scheme = Schnorr(curve)
    params = scheme.setup(rng)
    keys = [scheme.keygen(params, rng) for _ in range(3)]
    msgs = [bytes([i]) * 4 for i in range(3)]
    sigs = [scheme.sign(params, sk, m, rng) for (_, sk), m in zip(keys, msgs)]
    return lambda: scheme.verify_batch(params, [pk for pk, _ in keys], msgs, sigs, device="cpu"), [True] * 3


def _elgamal(op):
    def prepare(curve, rng):
        from crypto_primitives_tpu_torch.models.encryption import ElGamal

        scheme = ElGamal(curve)
        params = scheme.setup(rng)
        pk, sk = scheme.keygen(params, rng)
        msgs = [curve.rand_point(rng) for _ in range(2)]
        rs = [scheme.rand_randomness(rng) for _ in range(2)]
        cts = [scheme.encrypt(params, pk, m, r) for m, r in zip(msgs, rs)]
        if op == "encrypt":
            return lambda: scheme.encrypt_batch(params, pk, msgs, rs, device="cpu"), cts
        return lambda: scheme.decrypt_batch(params, sk, cts, device="cpu"), msgs
    return prepare


def _ipa_fold(curve, rng):
    from crypto_primitives_tpu_torch.models.protocols.ipa_fold import ipa_fold_prove
    from crypto_primitives_tpu_torch.models.sponge import get_default_poseidon_parameters

    cfg = get_default_poseidon_parameters(curve.base, 2)
    gens = [curve.rand_point(rng) for _ in range(2)]
    scalars = [[rng.randrange(curve.scalar.p) for _ in range(2)]]
    return lambda: ipa_fold_prove(curve, cfg, gens, scalars, device="cpu"), None


CALLERS = {"schnorr.verify": _schnorr_verify, "elgamal.encrypt": _elgamal("encrypt"),
           "elgamal.decrypt": _elgamal("decrypt"), "ipa_fold": _ipa_fold}


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_each_caller_packs_its_points_once(caller, monkeypatch):
    """Every host point a call takes goes through one device pack, whose
    Montgomery form is one ``te_pack`` call; the results stay the host
    tier's."""
    curve = JUBJUB
    rng = random.Random(caller)
    call, want = CALLERS[caller](curve, rng)
    packed = []

    def te_pack(curve, xy, orig=pack_kernel.te_pack):
        packed.append(tuple(xy.shape))
        return orig(curve, xy)

    monkeypatch.setattr(pack_kernel, "te_pack", te_pack)
    got = call()
    points = {"schnorr.verify": 3, "elgamal.encrypt": 3, "elgamal.decrypt": 4, "ipa_fold": 2}[caller]
    assert packed == [(points, 2, curve.base.num_words)]
    if want is not None:
        assert list(got) == want


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def card_words(curve, shape, g) -> torch.Tensor:
    """Random canonical words made on the card: the top word below p's."""
    W = curve.base.num_words
    w = torch.randint(-(1 << 31), 1 << 31, shape + (W,), dtype=torch.int64, device=g.device, generator=g)
    w[..., -1] = torch.randint(0, curve.base.p >> (32 * (W - 1)), shape, device=g.device, generator=g)
    return w.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [0, 1, 255, (1 << 16) + 3])
def test_kernel_at_every_batch(cuda, batch):
    curve = ED_ON_BLS12_377
    g = torch.Generator(device=cuda).manual_seed(batch)
    xy = card_words(curve, (batch, 2), g)
    n0 = pack_kernel.launches
    with profile(activities=[ProfilerActivity.CPU]):
        got = pack_kernel.te_pack(curve, xy)
    assert got.shape == (batch, 4, 8)
    assert pack_kernel.launches == n0 + (batch > 0)
    assert [(s.name, s.rows) for s in profiling.spans()] == [("kernel.pack", batch)]
    # the plain version on the card: the same arithmetic
    assert torch.equal(got, pack_kernel.te_pack_plain(curve, xy))


@pytest.mark.cuda
def test_kernel_takes_views_off_a_16_byte_boundary(cuda):
    """The kernel reads 16-byte vectors: the wrapper hands it a copy of a
    view that starts one word into its storage."""
    curve = JUBJUB
    g = torch.Generator(device=cuda).manual_seed(7)
    xy = card_words(curve, (33, 2), g)
    flat = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda), xy.flatten()])
    view = flat[1:].view(33, 2, 8)
    assert view.data_ptr() % 16 == 4
    assert torch.equal(pack_kernel.te_pack(curve, view), pack_kernel.te_pack_plain(curve, xy))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "not_built"])
def test_kernel_refusals(cuda, bad):
    curve = ED_ON_BLS12_377
    xy = torch.zeros((6, 2, 8), dtype=torch.int32, device=cuda)
    if bad == "dtype":
        xy, err, match = xy.to(torch.int64), ValueError, "int32"
    else:  # a twisted-Edwards curve of a width the kernel is not built for: the kernel's own refusal
        curve = TECurveSpec("test_w12", BLS12_381_FQ, BLS12_381_FR, -1, 5, 1)
        xy, err, match = torch.zeros((6, 2, 12), dtype=torch.int32, device=cuda), RuntimeError, "curve_pack: CUDA error"
    n0 = pack_kernel.launches
    with pytest.raises(err, match=match):
        pack_kernel.te_pack(curve, xy)
    assert pack_kernel.launches == n0
