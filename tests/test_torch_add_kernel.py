"""The curve tier's complete addition (``ops/add_kernel.py``): twisted-Edwards
points in extended coordinates added by add-2008-hwcd.

On the CPU: the wrapper's plain branch against the digit chain
(``ops.curve.te_add_digits``) and, made affine, against the host oracle
``add_host``, on every twisted-Edwards curve of ``curves_known``: random
points, the identity on either side, doubling, P + (-P), under
broadcasting; its refusals; the curve tier's callers through it; and that it
launches nothing.

On the card (marked ``cuda``; each skips without one): the kernel against
the plain version word for word on every twisted-Edwards curve, on 4096
random points and the edge cases above, coordinates at p - 1 among them,
under broadcasting, at batches 0, 1, 255 and 2^16 + 3 and on a view off a
16-byte boundary; its refusals and its launch count; and the Pedersen
commitment's batch on 256 records against the host tier's ``commit``, one
launch a job.  Run there from the root of the repository
(``tests/conftest.py`` imports JAX, which that machine may not have):

    python -m pytest --noconftest -m cuda tests/test_torch_add_kernel.py
"""

import random

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crypto_primitives_tpu_torch.ops import add_kernel, curve_fast
from crypto_primitives_tpu_torch.ops import curve as cv
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops.curve import TECurveSpec
from crypto_primitives_tpu_torch.ops.curves_known import ED_ON_BLS12_377, TE_CURVES
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FQ, BLS12_381_FR
from crypto_primitives_tpu_torch.utils import profiling


def on_curve(curve, rng, n) -> torch.Tensor:
    """(n, 4, W) Montgomery words of random subgroup points, each scaled by
    a random Z: (x l, y l, x y l, l)."""
    q = curve.base
    rows = []
    for _ in range(n):
        x, y = curve.rand_point(rng)
        lam = rng.randrange(1, q.p)
        rows.append([x * lam, y * lam, x * y % q.p * lam, lam])
    return torch.from_numpy(q.pack(rows))


def random_words(curve, rng, n) -> torch.Tensor:
    """(n, 4, W) canonical words, no curve points: the arithmetic is the
    same whatever the coordinates."""
    q = curve.base
    return torch.from_numpy(q.pack([[rng.randrange(q.p) for _ in range(4)] for _ in range(n)], mont=False))


def edge_pairs(curve, rng) -> tuple:
    """(p1, p2), (n, 4, W) each: random points plus the identity on either
    side, P + P, P + (-P), and every coordinate at p - 1 against a point and
    against itself."""
    q = curve.base
    pts = on_curve(curve, rng, 4)
    ident = cv.identity(curve, (4,), "cpu")
    top = torch.from_numpy(q.pack([[q.p - 1] * 4], mont=False)).expand(4, 4, q.num_words)
    neg = cv.te_neg(curve, pts)
    p1 = torch.cat([pts, ident, pts, pts, pts, top, top])
    p2 = torch.cat([pts.flip(0), pts, ident, pts, neg, pts, top])
    return p1, p2


def affine(curve, pts) -> list:
    return [tuple(int(v) for v in xy) for xy in curve.unpack_points(pts)]


def digit_chain(curve, p1, p2) -> torch.Tensor:
    return ff.from_digits(cv.te_add_digits(curve, ff.to_digits(p1), ff.to_digits(p2)))


@pytest.mark.parametrize("curve", TE_CURVES, ids=lambda c: c.name)
def test_plain_branch_equals_the_digit_chain_and_the_oracle(curve):
    rng = random.Random(TE_CURVES.index(curve))
    p1, p2 = edge_pairs(curve, rng)
    n0 = add_kernel.launches
    got = add_kernel.te_add(curve, p1, p2)
    assert add_kernel.launches == n0  # the CPU branch launches nothing
    assert got.dtype == torch.int32 and got.shape == p1.shape
    assert torch.equal(got, digit_chain(curve, p1, p2))
    n = 20  # the rows made of curve points: all but the p - 1 rows
    want = [curve.add_host(a, b) for a, b in zip(affine(curve, p1[:n]), affine(curve, p2[:n]))]
    assert affine(curve, got[:n]) == want
    assert all(xy == (0, 1) for xy in want[16:20])  # P + (-P)


@pytest.mark.parametrize("curve", TE_CURVES, ids=lambda c: c.name)
def test_plain_branch_broadcasts(curve):
    rng = random.Random(10 + TE_CURVES.index(curve))
    one, many = on_curve(curve, rng, 1), on_curve(curve, rng, 5)
    want = digit_chain(curve, one.expand(5, 4, -1), many)
    assert torch.equal(add_kernel.te_add(curve, one, many), want)
    assert torch.equal(add_kernel.te_add(curve, many, one[0]), digit_chain(curve, many, one.expand(5, 4, -1)))
    grid = add_kernel.te_add(curve, many[:3].reshape(3, 1, 4, -1), many[3:])
    assert grid.shape == (3, 2, 4, curve.base.num_words)
    assert torch.equal(grid[2, 1], digit_chain(curve, many[2], many[4]))


@pytest.mark.parametrize("bad", ["coords", "words", "rank", "dtype", "other_curve", "two_devices", "meta"])
def test_refusals_on_the_cpu(bad):
    curve = ED_ON_BLS12_377
    p1 = p2 = random_words(curve, random.Random(3), 2)
    match = r"\(\.\.\., 4, 8\)"
    if bad == "coords":
        p1 = p1[:, :3]
    elif bad == "words":
        p2 = p2[..., :7]
    elif bad == "rank":
        p1 = p1[0, 0]
    elif bad == "dtype":
        p2, match = p2.to(torch.int64), "int32"
    elif bad == "other_curve":  # W = 8 points handed to a W = 12 curve
        curve, match = TECurveSpec("test_w12", BLS12_381_FQ, BLS12_381_FR, -1, 5, 1), r"\(\.\.\., 4, 12\)"
    elif bad == "two_devices":
        p2, match = p2.to("meta"), "two devices"
    else:
        p1, p2, match = p1.to("meta"), p2.to("meta"), "CUDA or CPU"
    n0 = add_kernel.launches
    with pytest.raises(ValueError, match=match):
        add_kernel.te_add(curve, p1, p2)
    assert add_kernel.launches == n0


@pytest.mark.parametrize("caller", ["te_add", "te_double", "dev_add", "curve_fast.add"])
def test_curve_tier_routes_through_the_wrapper(caller):
    curve = ED_ON_BLS12_377
    pts = on_curve(curve, random.Random(7), 3)
    other = pts if caller == "te_double" else pts.flip(0)
    call = {"te_add": lambda: cv.te_add(curve, pts, other), "te_double": lambda: cv.te_double(curve, pts),
            "dev_add": lambda: curve.dev_add(pts, other), "curve_fast.add": lambda: curve_fast.add(curve, pts, other)}
    with profile(activities=[ProfilerActivity.CPU]):
        got = call[caller]()
    assert torch.equal(got, add_kernel.te_add_plain(curve, pts, other))
    # the plain branch: a span with no rows, which only a kernel launch carries
    assert [(s.name, s.rows) for s in profiling.spans()] == [("kernel.add", None)]


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("curve", TE_CURVES, ids=lambda c: c.name)
def test_kernel_equals_the_plain_version(cuda, curve):
    rng = random.Random(20 + TE_CURVES.index(curve))
    e1, e2 = edge_pairs(curve, rng)
    p1 = torch.cat([random_words(curve, rng, 4096), e1]).to(cuda)
    p2 = torch.cat([random_words(curve, rng, 4096), e2]).to(cuda)
    n0 = add_kernel.launches
    with profile(activities=[ProfilerActivity.CPU]):
        got = add_kernel.te_add(curve, p1, p2)
    assert add_kernel.launches == n0 + 1
    assert [(s.name, s.rows) for s in profiling.spans()] == [("kernel.add", p1.shape[0])]
    want = add_kernel.te_add_plain(curve, p1.cpu(), p2.cpu())
    assert torch.equal(got.cpu(), want)
    tail = want[4096:4096 + 20]  # the rows made of curve points
    assert affine(curve, tail) == [curve.add_host(a, b) for a, b in
                                   zip(affine(curve, e1[:20]), affine(curve, e2[:20]))]


@pytest.mark.cuda
@pytest.mark.parametrize("curve", TE_CURVES, ids=lambda c: c.name)
def test_kernel_broadcasts(cuda, curve):
    rng = random.Random(30 + TE_CURVES.index(curve))
    one, many = on_curve(curve, rng, 1), random_words(curve, rng, 64)
    cases = [(one, many), (many, one[0]), (many[:8].reshape(8, 1, 4, -1), many[8:16])]
    for a, b in cases:
        n0 = add_kernel.launches
        got = add_kernel.te_add(curve, a.to(cuda), b.to(cuda))
        assert add_kernel.launches == n0 + 1
        assert torch.equal(got.cpu(), add_kernel.te_add_plain(curve, a, b))


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
    p1, p2 = (card_words(curve, (batch, 4), g) for _ in range(2))
    n0 = add_kernel.launches
    got = add_kernel.te_add(curve, p1, p2)
    assert got.shape == (batch, 4, 8)
    assert add_kernel.launches == n0 + (batch > 0)
    # the plain version on the card: the same arithmetic
    assert torch.equal(got, add_kernel.te_add_plain(curve, p1, p2))


@pytest.mark.cuda
def test_kernel_takes_views_off_a_16_byte_boundary(cuda):
    """The kernel reads 16-byte vectors: the wrapper hands it a copy of a
    view that starts one word into its storage."""
    curve = ED_ON_BLS12_377
    rng = random.Random(35)
    p1, p2 = random_words(curve, rng, 33), random_words(curve, rng, 33)
    flat = torch.cat([torch.zeros(1, dtype=torch.int32), p1.flatten()]).to(cuda)
    view = flat[1:].view(33, 4, 8)
    assert view.data_ptr() % 16 == 4
    got = add_kernel.te_add(curve, view, p2.to(cuda))
    assert torch.equal(got.cpu(), add_kernel.te_add_plain(curve, p1, p2))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "two_devices", "not_built"])
def test_kernel_refusals(cuda, bad):
    curve = ED_ON_BLS12_377
    p1 = p2 = random_words(curve, random.Random(40), 6).to(cuda)
    if bad == "dtype":
        p2, err, match = p2.to(torch.int64), ValueError, "int32"
    elif bad == "two_devices":
        p2, err, match = p2.cpu(), ValueError, "two devices"
    else:  # a twisted-Edwards curve of a width the kernel is not built for: the kernel's own refusal
        curve = TECurveSpec("test_w12", BLS12_381_FQ, BLS12_381_FR, -1, 5, 1)
        p1 = p2 = torch.zeros((6, 4, 12), dtype=torch.int32, device=cuda)
        err, match = RuntimeError, "curve_add: CUDA error"
    n0 = add_kernel.launches
    with pytest.raises(err, match=match):
        add_kernel.te_add(curve, p1, p2)
    assert add_kernel.launches == n0


@pytest.mark.cuda
def test_commit_batch_on_the_card_equals_the_host_commit(cuda):
    from crypto_primitives_tpu_torch.models.commitment.pedersen import PedersenCommitment
    from crypto_primitives_tpu_torch.models.crh.pedersen import Window

    curve = ED_ON_BLS12_377
    rng = random.Random(50)
    comm = PedersenCommitment(curve, Window(6, 40))
    params = comm.setup(rng)
    records = [bytes(rng.randrange(256) for _ in range(30)) for _ in range(256)]
    openings = [comm.rand_randomness(rng) for _ in range(256)]
    x = torch.tensor([list(r) for r in records], dtype=torch.uint8)
    bits = torch.from_numpy(comm.randomness_to_bits(openings))
    for _ in range(2):
        n0 = add_kernel.launches
        got = comm.commit_batch(params, x, bits, device=cuda)
        assert add_kernel.launches == n0 + 1
    q = curve.base
    got = q.unpack(got.cpu().numpy().reshape(-1, 2, q.num_words))
    assert [tuple(int(v) for v in row) for row in got] == [comm.commit(params, r, o) for r, o in zip(records, openings)]
