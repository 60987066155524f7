"""The kernels' counted work, and that it follows the call shapes of both
traffic kinds."""

import pytest

from portbench.harness import loader, manifest
from portbench.roofline import k1_poseidon, k3_sha256, peaks

MAN = manifest.load()


def test_counts_copied_from_the_smoke():
    assert k1_poseidon.ops_per_permutation(3, 8, 17, 8, 31) == 211_520
    assert k3_sha256.ops_per_message(32) == 2_232
    assert k3_sha256.ops_per_message(64) == 2_232 + 1_544
    assert k3_sha256.ops_per_message(80) == 2 * 2_232
    # K1's least time per 2^19 states, operations-bound (PERF.md's 1.6552 ms)
    t = k1_poseidon.least(batch=1 << 19, t=3, num_words=8, alpha=17, full_rounds=8, partial_rounds=31)
    assert t == pytest.approx(1.6552e-3, rel=1e-4)
    assert t == (1 << 19) * 211_520 / peaks.PEAK_OPS_PER_S


def _calls(cell, scale):
    w = manifest.cell(MAN, cell)
    cfg = loader.data("configs", w["config"])
    cfgmod = loader.module("configs", w["config"])
    mix = loader.data("traffic", w["traffic"])
    traffic = loader.module("kinds", mix["kind"]).Traffic(mix, cfg, cfgmod, None, 1, "cpu", scale)
    return [c for op, rows in traffic.ops_per_job() for c in cfgmod.kernel_calls(cfg, op, rows)]


@pytest.mark.parametrize("n", [1 << 20, 64])
def test_commit_shapes(n):
    calls = _calls("poseidon_tree.commit", {"num_leaves": n})
    assert {name for name, _ in calls} == {"k1_poseidon"}
    assert sum(s["batch"] for _, s in calls) == 2 * n - 1  # every leaf and inner node is one permutation
    assert len(calls) == n.bit_length()  # one launch a hashed level
    calls = _calls("sha256_tree.commit", {"num_leaves": n})
    shapes = [(s["batch"], s["msg_bytes"]) for _, s in calls]
    assert shapes[:2] == [(n, 32), (n // 2, 80)]  # the leaves; the converted leaf digests in pairs
    assert shapes[2:] == [(n >> k, 64) for k in range(2, n.bit_length())]


@pytest.mark.parametrize("n, batch", [(1 << 20, 4096), (64, 16)])
def test_paths_shapes(n, batch):
    calls = _calls("poseidon_tree.paths", {"num_leaves": n, "batch": batch})
    assert [s["batch"] for _, s in calls] == [batch] * n.bit_length()  # the leaf hash, one compression a level
    calls = _calls("sha256_tree.paths", {"num_leaves": n, "batch": batch})
    assert [s["msg_bytes"] for _, s in calls] == [32, 80] + [64] * (n.bit_length() - 2)
