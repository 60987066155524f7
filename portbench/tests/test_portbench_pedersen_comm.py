"""The ``pedersen_comm.ed377_250x8`` cell on the CPU at a tiny batch: a run
traced and not, the control and each planted fault (every one must read not
correct), the reference in float32 digits (it must disagree), and the two K4
calls' counted work; on the card (marked ``cuda``) a traced run reads K4's
roofline over both calls, the commitment's spans and the launches."""

import contextlib

import pytest
import torch

from portbench.harness import loader, manifest, runner
from portbench.roofline import k4_msm_te
from portbench.tests.test_portbench_pedersen_crh import Field32  # float32 digits, the precision below float64

CELL = "pedersen_comm.ed377_250x8"
TINY = {"batch": 8, "check_jobs": 2, "trace_jobs": 1}
CFGMOD = loader.module("configs", "pedersen_comm_ed377_250x8")
CFG = loader.data("configs", "pedersen_comm_ed377_250x8")
MAN = manifest.load()
PER_LAYER = {m["name"] for m in manifest.per_layer(MAN, CELL)}


@pytest.mark.parametrize("traced", [False, True])
def test_cell_on_the_cpu(traced):
    result, checks = runner.run(CELL, 2**31 + 9, 60.0, traced, device="cpu", scale=TINY, max_jobs=2)
    assert result["correct"], checks
    assert checks == {"digests_wrong": (0, 0), "digests_checked": (16, None)}
    assert result["attempted"] == 2 + traced * TINY["trace_jobs"]
    if traced:
        # K4's roofline needs the card's trace; every other metric reads the CPU run
        assert set(result["metrics"]) == PER_LAYER - {"k4_roofline.comm"}
        metrics = {k: v["value"] for k, v in result["metrics"].items()}
        assert 0 < metrics["comm_add_ms"] <= metrics["comm_self_ms"]
        assert metrics["kernel_launches.comm"] == 0.0  # the plain branches launch nothing
    else:
        assert set(result["metrics"]) == {"job_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["control", *CFGMOD.FAULTS])
def test_fault_is_not_correct(fault):
    program = CFGMOD.Control if fault == "control" else None
    with contextlib.nullcontext() if program else CFGMOD.planted(fault):
        result, checks = runner.run(CELL, 2**31 + 21, 0.05, False, device="cpu", scale=TINY, program=program,
                                    max_jobs=2)
    assert not result["correct"], checks
    assert result["failed"] > 0


def test_reference_in_float32_reads_every_row_wrong():
    program = CFGMOD.Program(CFG, "cpu")
    program.setup(2**31 + 5)
    x = CFGMOD.make_inputs(CFG, 3, 8, "cpu")
    exact = CFGMOD.Reference(CFG, "cpu").digests(program.bases(), x)
    assert (exact == program.to_host(program.hash(x))).all()
    low = CFGMOD.Reference(CFG, "cpu", field=Field32)
    assert (low.digests(program.bases(), x) != exact).reshape(8, -1).any(axis=1).all()


def test_k4_least_time_of_both_calls():
    # PERF.md's K4 bounds: the message's 2^16 x 342 and the fixed-base 2^16 x 84, W = 8
    assert CFGMOD.kernel_calls(CFG, "hash", 65536) == [
        ("k4_msm_te", {"batch": 65536, "groups": 342, "w": 3, "num_words": 8}),
        ("k4_msm_te", {"batch": 65536, "groups": 84, "w": 3, "num_words": 8})]
    assert k4_msm_te.least(batch=65536, groups=342, w=3, num_words=8) == pytest.approx(1.413e-3, rel=1e-3)
    assert k4_msm_te.least(batch=65536, groups=84, w=3, num_words=8) == pytest.approx(0.3471e-3, rel=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_traced_run_on_the_card(cuda):
    result, _ = runner.run(CELL, 2**31 + 79, 0.5, True, device=cuda, scale={"batch": 4096, "check_jobs": 2,
                                                                         "trace_jobs": 2})
    assert result["correct"], result["checks"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(metrics) == PER_LAYER, sorted(metrics)
    assert 0 < metrics["k4_roofline.comm"] <= 100
    assert 0 < metrics["comm_add_ms"] <= metrics["comm_self_ms"]
    assert metrics["kernel_launches.comm"] == 3.0
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
