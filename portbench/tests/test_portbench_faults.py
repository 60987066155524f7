"""A run can come out not correct: the control (the plain reference with
every leaf left unhashed) and each planted fault of the timed path, driven
through the rest of a run on the CPU at a tiny tree, give ``correct``
false.  (The exchange between chips is no fault of these one-chip cells.)"""

import contextlib

import pytest

from portbench.harness import control, manifest, runner

CELLS = [w["name"] for w in manifest.load()["workloads"]]
TINY = {"num_leaves": 16, "batch": 8, "check_jobs": 2, "trace_jobs": 1}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["control", *control.FAULTS])
def test_fault_is_not_correct(cell, fault):
    program = control.ReferenceProgram if fault == "control" else None
    with contextlib.nullcontext() if program else control.planted(fault):
        result, checks = runner.run(cell, 2**31 + 21, 0.05, False, device="cpu", scale=TINY, program=program,
                                    max_jobs=2)
    assert not result["correct"], checks
    assert result["failed"] > 0
