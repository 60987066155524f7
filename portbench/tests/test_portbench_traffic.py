"""Each traffic kind end to end on the CPU at a tiny tree: set-up, the warm
job, a window, the traced stretch, the metrics and the check."""

import pytest

from portbench.harness import manifest, runner

MAN = manifest.load()
TINY = {"num_leaves": 16, "batch": 8, "check_jobs": 2, "trace_jobs": 1}
CELLS = [w["name"] for w in MAN["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_end_to_end_on_the_cpu(cell, traced):
    result, checks = runner.run(cell, 2**31 + 9, 0.05, traced, device="cpu", scale=TINY, max_jobs=2)
    assert result["correct"], checks
    assert list(result)[-1] == "checks" and result["checks"]["roots_wrong"] == {"value": 0, "limit": 0}
    if "verdicts_wrong" in checks:
        assert checks["verdicts_wrong"] == (0, 0) and checks["verdicts_checked"][0] > 0
    wanted = manifest.per_layer(MAN, cell) if traced else manifest.end_to_end(MAN, cell)
    units = {m["name"]: m["unit"] for m in wanted}
    # a device share and a roofline need the card; job_p95_ms needs more jobs than two
    missing = {"job_p95_ms", "k1_roofline.commit", "k1_roofline.paths", "k3_roofline.commit", "k3_roofline.paths"}
    assert set(units) - missing <= set(result["metrics"]) <= set(units)
    assert all(result["metrics"][n]["unit"] == units[n] for n in result["metrics"])
    if traced:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["window_s"] > 0


def test_inputs_repeat_from_the_seed():
    from portbench.harness import loader

    w = manifest.cell(MAN, "sha256_tree.paths")
    cfg = loader.data("configs", w["config"])
    cfgmod = loader.module("configs", w["config"])
    mix = loader.data("traffic", w["traffic"])
    kind = loader.module("kinds", mix["kind"])
    a, b = (kind.Traffic(mix, cfg, cfgmod, None, 2**31 + 5, "cpu", {"num_leaves": 64, "batch": 32})
            for _ in range(2))
    for t in (a, b):
        t.leaves = cfgmod.make_leaves(cfg, 1, 64, "cpu")
    (ia, ra), (ib, rb) = a.inputs(3), b.inputs(3)
    assert (ia == ib).all() and (ra == rb).all()
    ic, _ = a.inputs(4)
    assert not (ia == ic).all()
    # one in 16 of a batch is another leaf than its index's
    assert int((ra != a.leaves[ia]).any(dim=1).sum()) == 32 // mix["tamper_every"]
