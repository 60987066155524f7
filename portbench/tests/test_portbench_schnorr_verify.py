"""The ``schnorr.ed377.verify`` cell on the CPU at a tiny batch: a run traced
and not, the control and each planted fault (every one must read not
correct), the reference in float32 digits (it must disagree), and the K4
call's counted work; on the card (marked ``cuda``) a traced run reads every
per-layer metric of the cell."""

import contextlib

import numpy as np
import pytest
import torch

from portbench.harness import loader, manifest, runner
from portbench.roofline import k4_msm_te
from portbench.tests.test_portbench_pedersen_crh import Field32  # float32 digits, the precision below float64

CELL = "schnorr.ed377.verify"
TINY = {"batch": 48, "check_jobs": 2, "trace_jobs": 1}  # 3 tampered rows: one of each form
CFGMOD = loader.module("configs", "schnorr_ed377_blake2s")
CFG = loader.data("configs", "schnorr_ed377_blake2s")
MIX = loader.data("traffic", "sig_verify")
KIND = loader.module("kinds", "sig_verify")
MAN = manifest.load()
PER_LAYER = {m["name"] for m in manifest.per_layer(MAN, CELL)}


@pytest.mark.parametrize("traced", [False, True])
def test_cell_on_the_cpu(traced):
    result, checks = runner.run(CELL, 2**31 + 9, 60.0, traced, device="cpu", scale=TINY, max_jobs=2)
    assert result["correct"], checks
    assert checks == {"verdicts_wrong": (0, 0), "intent_wrong": (0, 0), "verdicts_checked": (96, None)}
    assert result["attempted"] == 2 + traced * TINY["trace_jobs"]
    if traced:
        # K4's roofline needs the card's trace; every other metric reads the CPU run
        assert set(result["metrics"]) == PER_LAYER - {"k4_roofline.sig"}
        metrics = {k: v["value"] for k, v in result["metrics"].items()}
        assert metrics["sig_windowed_ms"] > 0 and metrics["sig_host_ms"] > 0
        assert metrics["kernel_launches.sig"] == 0.0  # the plain branches launch nothing
    else:
        assert set(result["metrics"]) == {"job_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["control", *CFGMOD.FAULTS])
def test_fault_is_not_correct(fault):
    program = CFGMOD.Control if fault == "control" else None
    with contextlib.nullcontext() if program else CFGMOD.planted(fault):
        result, checks = runner.run(CELL, 2**31 + 21, 0.05, False, device="cpu", scale={**TINY, "batch": 16},
                                    program=program, max_jobs=2)
    assert not result["correct"], checks
    assert checks["verdicts_wrong"][0] > 0 and checks["intent_wrong"] == (0, 0)


def test_a_planted_fault_leaves_set_up_sound():
    """The faults act inside ``verify_batch`` alone: keys and signatures made
    under one are the sound ones."""
    def pool(plant):
        program = CFGMOD.Program(CFG, "cpu")
        traffic = KIND.Traffic(MIX, CFG, CFGMOD, program, 2**31 + 5, "cpu", {"batch": 4})
        with plant:
            traffic.setup(runner.Spans())
        return traffic.pks, [(g.prover_response, g.verifier_challenge) for g in traffic.sigs]

    sound = pool(contextlib.nullcontext())
    for fault in CFGMOD.FAULTS:
        assert pool(CFGMOD.planted(fault)) == sound


def test_reference_in_float32_reads_wrong():
    program = CFGMOD.Program(CFG, "cpu")
    traffic = KIND.Traffic(MIX, CFG, CFGMOD, program, 2**31 + 5, "cpu", {"batch": 8})
    traffic.setup(runner.Spans())
    pks, messages, sigs, _ = traffic.inputs(0)
    exact = CFGMOD.Reference(CFG, "cpu").verdicts(traffic.public, (pks, messages, sigs))
    assert exact.all()  # 8 // 16: no row tampered
    assert np.array_equal(np.asarray(program.verify((pks, messages, sigs))), exact)
    low = CFGMOD.Reference(CFG, "cpu", field=Field32).verdicts(traffic.public, (pks, messages, sigs))
    assert not low.any()


def test_k4_least_time_of_the_fixed_base_call():
    # PERF.md's K4 bound at the fixed-base 2^16 x 84, W = 8
    assert CFGMOD.kernel_calls(CFG, "verify", 65536) == [
        ("k4_msm_te", {"batch": 65536, "groups": 84, "w": 3, "num_words": 8})]
    assert k4_msm_te.least(batch=65536, groups=84, w=3, num_words=8) == pytest.approx(0.3471e-3, rel=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_traced_run_on_the_card(cuda):
    result, _ = runner.run(CELL, 2**31 + 79, 0.5, True, device=cuda, scale={"batch": 4096, "check_jobs": 2,
                                                                         "trace_jobs": 1})
    assert result["correct"], result["checks"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(metrics) == PER_LAYER, sorted(metrics)
    assert 0 < metrics["k4_roofline.sig"] <= 100
    assert 0 < metrics["sig_host_ms"] and 0 < metrics["sig_windowed_ms"]
    assert metrics["kernel_launches.sig"] == 3.0
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
