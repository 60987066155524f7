"""The curve tier's affine step (``ops/affine_kernel.py``): projective points
to affine (X / Z, Y / Z), Z inverted by Fermat.

On the CPU: the wrapper's plain branch against the composition the curve
tier used before the kernel (``field.pow_const_digits`` for Z^(p-2), then
one Montgomery product each for X and Y) and, out of Montgomery form,
against the host oracle x * z^-1, y * z^-1, on the twisted-Edwards curves
and BLS12-381 G1, at random and edge words (Z = 0 maps to (0, 0)); its
refusals; ``te_to_affine`` and ``sw_to_affine`` through it.

On the card (marked ``cuda``; each skips without one): the kernel against
the plain version word for word at every width it is built for (W = 8, 9,
12), on both layouts (C = 4 and 3), at the edge words, on points from the
MSM kernels' own outputs and at batches 0, 1, 127 and 2^16 + 3; its
refusals and its launch count.  Run there from the root of the repository
(``tests/conftest.py`` imports JAX, which that machine may not have):

    python -m pytest --noconftest -m cuda tests/test_torch_affine_kernel.py
"""

import random

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crypto_primitives_tpu_torch.ops import affine_kernel
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops.curve import te_to_affine
from crypto_primitives_tpu_torch.ops.curve_sw import sw_to_affine
from crypto_primitives_tpu_torch.ops.curves_known import (
    BLS12_381_G1,
    ED25519,
    ED_ON_BLS12_377,
    JUBJUB,
    PALLAS,
    SECP256R1,
)
from crypto_primitives_tpu_torch.utils import profiling

CPU_CURVES = [JUBJUB, ED_ON_BLS12_377, ED25519, BLS12_381_G1]
CUDA_CURVES = [JUBJUB, ED_ON_BLS12_377, ED25519, PALLAS, SECP256R1, BLS12_381_G1]  # W = 8, 8, 8, 8, 9, 12


def edge_words(q) -> list:
    """Word patterns (as stored, below p) that carry through every word:
    0, 1, R mod p (the Montgomery one), p - 1, and p's top words with every
    word below them all ones."""
    half = 32 * (q.num_words // 2)
    return [0, 1, q.R_mod_p, q.p - 1, ((q.p >> half) << half) - 1]


def random_words(q, rng, n) -> list:
    return [rng.randrange(q.p) for _ in range(n)]


def points(curve, case: str, seed: int) -> torch.Tensor:
    """(..., C, W) int32 words for one case: Z set to one edge value on
    random X, Y (and T), or every edge value of Z against every edge value
    of X and Y, or random coordinates, or projective points on the curve."""
    q, C = curve.base, curve.coords
    rng = random.Random(seed)
    if case == "edges":
        e = edge_words(q)
        rows = [[x, y] + random_words(q, rng, C - 3) + [z] for z in e for x in e for y in e[::2]]
    elif case.startswith("z_"):
        z = edge_words(q)[["z_zero", "z_one_std", "z_one", "z_p_minus_1", "z_low_ones"].index(case)]
        rows = [random_words(q, rng, C - 1) + [z] for _ in range(5)]
    elif case == "on_curve":  # (lx, ly, (lx y), l) or (lx, ly, l) for random l, in Montgomery form
        rows = []
        for _ in range(6):
            x, y = curve.rand_point(rng)
            lam = rng.randrange(1, q.p)
            coords = [x * lam, y * lam] + ([x * y % q.p * lam] if C == 4 else []) + [lam]
            rows.append([q.to_mont(v % q.p) for v in coords])
    else:  # random words, with two leading batch dimensions
        rows = [random_words(q, rng, C) for _ in range(6)]
        return torch.from_numpy(q.pack(rows, mont=False)).reshape(2, 3, C, q.num_words)
    return torch.from_numpy(q.pack(rows, mont=False))


def old_composition(curve, pts: torch.Tensor) -> torch.Tensor:
    """The affine step as the curve tier computed it before the kernel."""
    q = curve.base
    d = ff.to_digits(pts)
    zi = ff.pow_const_digits(q, d[..., curve.coords - 1, :], q.p - 2)
    return ff.from_digits(ff.mont_mul_digits(q, d[..., 0:2, :], zi.unsqueeze(-2)))


def oracle(curve, pts: torch.Tensor) -> list:
    """Host (x z^-1, y z^-1) of each point, standard form; 0 for Z = 0."""
    q = curve.base
    vals = q.unpack(pts.reshape(-1, curve.coords, q.num_words))
    out = []
    for row in vals:
        zi = pow(int(row[-1]), q.p - 2, q.p)
        out.append((int(row[0]) * zi % q.p, int(row[1]) * zi % q.p))
    return out


CASES = ["edges", "z_zero", "z_one_std", "z_one", "z_p_minus_1", "z_low_ones", "on_curve", "random"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("curve", CPU_CURVES, ids=lambda c: c.name)
def test_plain_branch_equals_the_old_composition_and_the_oracle(curve, case):
    pts = points(curve, case, seed=100 * CPU_CURVES.index(curve) + CASES.index(case))
    got = affine_kernel.to_affine(curve, pts)
    assert got.dtype == torch.int32 and got.shape == pts.shape[:-2] + (2, curve.base.num_words)
    assert torch.equal(got, old_composition(curve, pts))
    assert [tuple(int(v) for v in row) for row in curve.base.unpack(got.reshape(-1, 2, curve.base.num_words))] \
        == oracle(curve, pts)
    if case == "z_zero":
        assert not got.any()
    if case == "on_curve":  # and the affine point is the one the projective coordinates were made from
        assert all(curve.is_on_curve(xy) for xy in oracle(curve, pts))


@pytest.mark.parametrize("bad", ["coords", "words", "rank", "device"])
def test_refusals_on_the_cpu(bad):
    pts = points(ED_ON_BLS12_377, "random", 3)[0]
    if bad == "coords":  # an extended point handed over as short-Weierstrass
        with pytest.raises(ValueError, match=r"\(\.\.\., 3, 12\)"):
            affine_kernel.to_affine(BLS12_381_G1, torch.zeros((2, 4, 12), dtype=torch.int32))
        return
    if bad == "words":
        pts = pts[..., :7]
    elif bad == "rank":
        pts = pts[0, 0]
    else:
        pts = pts.to("meta")
    with pytest.raises(ValueError):
        affine_kernel.to_affine(ED_ON_BLS12_377, pts)


@pytest.mark.parametrize("curve", [ED_ON_BLS12_377, BLS12_381_G1], ids=lambda c: c.name)
def test_curve_tier_routes_through_the_wrapper(curve):
    pts = points(curve, "random", 5)
    to_affine = te_to_affine if curve.coords == 4 else sw_to_affine
    with profile(activities=[ProfilerActivity.CPU]):
        got = to_affine(curve, pts.transpose(0, 1))  # a view: the curve tier hands over a contiguous copy
    assert torch.equal(got, affine_kernel.to_affine_plain(curve, pts.transpose(0, 1)))
    # the plain branch: a span with no rows, which only a kernel launch carries
    assert [(s.name, s.rows) for s in profiling.spans()] == [("kernel.affine", None)]


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def msm_outputs(curve, rows: int, seed: int) -> torch.Tensor:
    """(rows, C, W) sums from the curve's MSM kernel: 64 doublings of a
    random point in groups of 3, random windows (row 0 all zero, the
    identity)."""
    from crypto_primitives_tpu_torch.ops import msm_kernel, msm_sw_kernel
    from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod

    rng = random.Random(seed)
    pts = [curve.rand_point(rng)]
    for _ in range(63):
        pts.append(curve.double_host(pts[-1]))
    table = torch.from_numpy(fast_mod(curve).pack_table_grouped(curve, pts, 3)).cuda()
    g = torch.Generator(device="cuda").manual_seed(seed)
    idx = torch.randint(0, 8, (rows, table.shape[0]), dtype=torch.int32, device="cuda", generator=g)
    idx[0] = 0
    kern = msm_kernel if curve.coords == 4 else msm_sw_kernel
    return kern.grouped_msm(curve, table, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("curve", CUDA_CURVES, ids=lambda c: c.name)
def test_kernel_equals_the_plain_version(cuda, curve):
    cases = [points(curve, case, 11).reshape(-1, curve.coords, curve.base.num_words) for case in CASES]
    pts = torch.cat(cases + [msm_outputs(curve, 256, 13).cpu()]).to(cuda)
    n0 = affine_kernel.launches
    with profile(activities=[ProfilerActivity.CPU]):
        got = affine_kernel.to_affine(curve, pts)
    assert affine_kernel.launches == n0 + 1
    assert [(s.name, s.rows) for s in profiling.spans()] == [("kernel.affine", pts.shape[0])]
    want = affine_kernel.to_affine_plain(curve, pts.cpu())
    assert torch.equal(got.cpu(), want)
    assert [tuple(int(v) for v in row) for row in curve.base.unpack(want)] == oracle(curve, pts.cpu())
    # leading batch dimensions, as the curve tier hands them over
    lead = pts[:24].reshape(2, 12, curve.coords, -1)
    assert torch.equal(affine_kernel.to_affine(curve, lead).cpu(), want[:24].reshape(2, 12, 2, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [0, 1, 127, (1 << 16) + 3])
@pytest.mark.parametrize("curve", [ED_ON_BLS12_377, BLS12_381_G1], ids=lambda c: c.name)
def test_kernel_at_every_batch(cuda, curve, batch):
    pts = msm_outputs(curve, max(batch, 1), 17)[:batch].contiguous()
    n0 = affine_kernel.launches
    got = affine_kernel.to_affine(curve, pts)
    assert got.shape == (batch, 2, curve.base.num_words)
    assert affine_kernel.launches == n0 + (batch > 0)
    # the plain version on the card: the same arithmetic, about a second at 2^16
    assert torch.equal(got, affine_kernel.to_affine_plain(curve, pts))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "coords", "not_contiguous", "device"])
def test_kernel_refusals(cuda, bad):
    curve = ED_ON_BLS12_377
    pts = points(curve, "random", 19).reshape(6, 4, 8).to(cuda)
    if bad == "dtype":
        pts, match = pts.to(torch.int64), "int32"
    elif bad == "coords":  # extended points handed over as short-Weierstrass
        curve, pts, match = JUBJUB, pts[:, :3], r"\(\.\.\., 4, 8\)"
    elif bad == "not_contiguous":
        pts, match = pts[::2], "contiguous"
    else:
        pts, match = pts.to("meta"), "CUDA or CPU"
    n0 = affine_kernel.launches
    with pytest.raises(ValueError, match=match):
        affine_kernel.to_affine(curve, pts)
    assert affine_kernel.launches == n0

