"""The port's Pedersen CRH at upstream's ``benches/crh.rs`` window (250 x 8,
ed-on-bls12-377) against the benchmark's plain reference
(``portbench/reference/pedersen_ref.py``), on the CPU: seeded generators,
8-16 rows of 128 bytes and the edge inputs, bit for bit; the reference's
refusal of a bad base; the CRH's spans and set-up counters under
``torch.profiler``; the benchmark's ``crh_affine_rows`` on a traced run.  On
the card (marked ``cuda``, skipped without one): the configuration's program
against the reference, through one affine launch."""

import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crypto_primitives_tpu_torch.models.crh import PedersenCRH, Window, pedersen
from crypto_primitives_tpu_torch.ops.curves_known import ED_ON_BLS12_377
from crypto_primitives_tpu_torch.utils import profiling
from portbench.harness import loader

CFG = loader.data("configs", "pedersen_crh_ed377_250x8")
P = ED_ON_BLS12_377.base.p
R = 1 << 256


def _rows(case):
    g = torch.Generator().manual_seed(7)
    if case == "random":
        return torch.randint(0, 256, (12, 128), dtype=torch.uint8, generator=g)
    if case == "random_and_edges":
        x = torch.randint(0, 256, (8, 128), dtype=torch.uint8, generator=g)
        x[1], x[2] = 0, 0xFF
        return x
    if case == "zeros":
        return torch.zeros((8, 128), dtype=torch.uint8)
    if case == "ones":
        return torch.full((8, 128), 0xFF, dtype=torch.uint8)
    return torch.randint(0, 256, (8, 1), dtype=torch.uint8, generator=g)  # one byte, zero-padded


@pytest.fixture(scope="module")
def cell():
    crh = PedersenCRH(ED_ON_BLS12_377, Window(CFG["window_size"], CFG["num_windows"]))
    params = crh.setup(random.Random(2**31 + 19))
    ref = loader.module("configs", "pedersen_crh_ed377_250x8").Reference(CFG, "cpu")
    return crh, params, [win[0] for win in params.generators], ref


def _words(v):
    return [(v * R % P) >> (32 * j) & 0xFFFFFFFF for j in range(8)]


@pytest.mark.parametrize("case", ["random", "random_and_edges", "zeros", "ones", "one_byte"])
def test_program_equals_the_reference(cell, case):
    crh, params, bases, ref = cell
    x = _rows(case)
    got = crh.evaluate_batch(params, x, device="cpu").numpy()
    want = ref.digests(bases, x)
    assert got.shape == want.shape == (x.shape[0], 2, 8)
    assert np.array_equal(got, want)
    # and the port's host tier, on the first row
    hx, hy = crh.evaluate(params, bytes(x[0].tolist()))
    assert got[0].view(np.uint32).tolist() == [_words(hx), _words(hy)]
    if case == "zeros":  # the identity, affine (0, 1)
        assert (got.view(np.uint32) == np.array([_words(0), _words(1)], dtype=np.uint32)).all()


@pytest.mark.parametrize("bad", ["off_curve", "outside_subgroup", "too_few"])
def test_reference_refuses_a_bad_base(cell, bad):
    _, _, bases, ref = cell
    x, y = bases[3]
    if bad == "off_curve":
        bases = bases[:3] + [(x, (y + 1) % P)] + bases[4:]
        match = "not on the curve"
    elif bad == "outside_subgroup":  # g + (0, -1), the point of order 2 added
        bases = bases[:3] + [((-x) % P, (-y) % P)] + bases[4:]
        match = "not in the subgroup"
    else:
        bases = bases[:7]
        match = "bases for 8 windows"
    with pytest.raises(ValueError, match=match):
        ref.digests(bases, _rows("random")[:2])


def test_reference_refuses_an_input_longer_than_the_window(cell):
    _, _, bases, ref = cell
    with pytest.raises(ValueError, match="do not fit"):
        ref.digests(bases, torch.zeros((1, 251), dtype=torch.uint8))


def test_spans_and_setup_counters():
    crh = PedersenCRH(ED_ON_BLS12_377, Window(CFG["window_size"], CFG["num_windows"]))
    s0 = pedersen.setup_seconds
    params = crh.setup(random.Random(2**31 + 23))
    assert pedersen.setup_seconds > s0
    x = _rows("random")[:4]
    t0 = pedersen.table_seconds
    with profile(activities=[ProfilerActivity.CPU]):
        out = crh.evaluate_batch(params, x, device="cpu")
    t1 = pedersen.table_seconds
    assert t1 > t0  # the grouped table made and put on the CPU, once
    spans = profiling.spans()
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in spans)
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["crh.pedersen"]
    children = [s for s in spans if s.parent == roots[0].id]
    assert [c.name for c in children] == ["crh.bits", "crh.msm", "crh.affine"]
    kernels = [s for s in spans if s.name == "kernel.k4"]
    assert [(k.parent, k.rows) for k in kernels] == [(children[1].id, 4)]
    assert all(s.rows is None for s in spans if s.name.startswith("crh."))
    # the second call uploads nothing, and gives the same digests without the profiler
    assert torch.equal(crh.evaluate_batch(params, x, device="cpu"), out)
    assert pedersen.table_seconds == t1


def test_crh_affine_rows_reads_the_affine_spans():
    """The benchmark's ``crh_affine_rows`` on a traced run of the cell on the
    CPU: 0 a job, as the affine step runs in plain PyTorch there and only a
    kernel launch gives its ``kernel.affine`` span rows; the batch a job from
    spans that carry rows; None for a run without such spans (a program whose
    affine step keeps no span) or without a trace."""
    from types import SimpleNamespace

    from portbench.harness import runner

    result, checks = runner.run("pedersen_crh.ed377_250x8", 2**31 + 29, 60.0, True, device="cpu",
                                scale={"batch": 8, "check_jobs": 1, "trace_jobs": 2}, max_jobs=1)
    assert result["correct"], checks
    assert result["metrics"]["crh_affine_rows"] == {"value": 0.0, "unit": "rows/job"}
    metric = loader.module("metrics", "crh_affine_rows")
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):  # two jobs, each launching the kernel on 8 points
            with profiling.annotate("crh.pedersen"), profiling.annotate("crh.affine"):
                with profiling.annotate("kernel.affine", 8):
                    pass
    assert metric.read(SimpleNamespace(trace=object())) == 8.0
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("crh.pedersen"), profiling.annotate("crh.affine"):
            pass
    assert metric.read(SimpleNamespace(trace=object())) is None
    assert metric.read(SimpleNamespace(trace=None)) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_program_on_the_card_equals_the_reference(cuda):
    """The configuration's ``Program.hash`` on 256 rows on the card: digests
    bit for bit the reference's, one affine launch, its span's ``rows``."""
    from crypto_primitives_tpu_torch.ops import affine_kernel

    cfgmod = loader.module("configs", "pedersen_crh_ed377_250x8")
    program = cfgmod.Program(CFG, cuda)
    program.setup(2**31 + 31)
    x = cfgmod.make_inputs(CFG, 37, 256, cuda)
    n0 = affine_kernel.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = program.to_host(program.hash(x))
    assert affine_kernel.launches == n0 + 1
    assert [s.rows for s in profiling.spans() if s.name == "kernel.affine"] == [256]
    want = cfgmod.Reference(CFG, cuda).digests(program.bases(), x)
    assert np.array_equal(got, want)
