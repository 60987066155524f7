"""The port's program spans and set-up counters (``utils/profiling.py``,
``models/merkle_tree/device.py``, the kernel wrappers, ``native/build.py``,
``models/sponge/poseidon.py``), on the CPU: spans are off and free with no
profiler, and under ``torch.profiler`` a 16-leaf SHA-256 and Poseidon tree
record the tree layer's and the kernel wrappers' spans with their parents,
on the profiler's clock."""

import time
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crypto_primitives_tpu_torch.models.merkle_tree.device import (
    poseidon_device_tree, poseidon_tree_fns, sha256_device_tree, sha256_tree_fns)
from crypto_primitives_tpu_torch.models.sponge import poseidon
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR
from crypto_primitives_tpu_torch.utils import profiling

N = 16
IDX = [0, 3, 8, 15]
CFG = poseidon.get_default_poseidon_parameters(BLS12_381_FR, 2, False)


def _sha():
    leaves = torch.randint(0, 256, (N, 32), dtype=torch.uint8, generator=torch.Generator().manual_seed(1))
    return leaves, lambda x: sha256_device_tree(x, device="cpu"), sha256_tree_fns()[0]


def _poseidon():
    leaves = torch.from_numpy(BLS12_381_FR.pack(list(range(7, 7 + N))))
    return leaves, lambda x: poseidon_device_tree(BLS12_381_FR, CFG, x, device="cpu"), poseidon_tree_fns(CFG)[0]


TREES = {"sha256": _sha, "poseidon": _poseidon}


def _jobs(tree_kind):
    """A build, then proof_rows, a leaf hash and verify_rows_batch of IDX
    (one leaf swapped): (root row, verdicts)."""
    leaves, build, leaf_hash = TREES[tree_kind]()
    tree = build(leaves)
    idx = torch.tensor(IDX)
    raw = leaves[idx].clone()
    raw[1] = leaves[4]
    sib, auth = tree.proof_rows(idx)
    ok = tree.verify_rows_batch(tree.root_row(), leaf_hash(raw), idx, sib, auth)
    return tree.root_row(), ok


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture(scope="module", params=sorted(TREES))
def traced(request):
    """(tree kind, root row, verdicts, spans) of the jobs under the profiler,
    made once a module: the profiler makes the plain Poseidon slow."""
    (root, ok), _ = _profiled(lambda: _jobs(request.param))
    return request.param, root, ok, profiling.spans()


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_annotate_without_a_profiler_is_one_shared_noop():
    before = profiling.spans()
    a = profiling.annotate("tree.build_tree")
    assert a is profiling.annotate("kernel.k3", 64)
    with a as got:
        assert got is None
    assert profiling.spans() == before

    tracemalloc.start()
    try:
        for i in range(10000):
            with profiling.annotate("kernel.k3", i):
                pass
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 1024  # nothing kept a call: 10,000 records would take megabytes
    assert profiling.spans() == before


def test_tree_layer_spans_and_their_parents(traced):
    tree_kind, _, _, spans = traced
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in spans)
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["tree.build_tree", "tree.gather_paths", "tree.hash_leaves",
                                       "tree.verify_paths"]
    build, gather, leaf_hash, verify = roots
    kernel = "kernel.k3" if tree_kind == "sha256" else "kernel.k1"

    levels = ["tree.hash_level"] * 4  # 8, 4, 2 and 1 rows
    assert [c.name for c in _children(spans, build)] == ["tree.hash_leaves", "tree.convert_leaves"] + levels
    hashing = [c for c in _children(spans, build) if c.name in ("tree.hash_leaves", "tree.hash_level")]
    kernels = [k for c in hashing for k in _children(spans, c)]
    assert [k.name for k in kernels] == [kernel] * 5
    assert [k.rows for k in kernels] == [16, 8, 4, 2, 1]
    assert sum(k.rows for k in kernels) == 2 * N - 1
    # only a kernel span carries rows: no metric reads a tree span's
    assert all(s.rows is None for s in spans if s.name.startswith("tree."))

    assert [(k.name, k.rows) for k in _children(spans, leaf_hash)] == [(kernel, len(IDX))]
    assert [c.name for c in _children(spans, gather)] == ["tree.gather_level"] * 4 + ["tree.stack_paths"]
    assert [c.name for c in _children(spans, verify)] == (
        ["tree.convert_leaves"] + ["tree.select_level", "tree.hash_level"] * 4)
    for c in _children(spans, verify):
        want = [(kernel, len(IDX))] if c.name == "tree.hash_level" else []
        assert [(k.name, k.rows) for k in _children(spans, c)] == want
    # every kernel span is a leaf of the span tree
    assert not [s for s in spans if s.parent in {k.id for k in spans if k.name.startswith("kernel.")}]


def test_spans_lie_on_the_profilers_clock():
    _, prof = _profiled(lambda: _jobs("sha256"))
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e.start_ns())
    spans = profiling.spans()
    for name in ("tree.build_tree", "tree.hash_level", "kernel.k3", "tree.verify_paths"):
        mine = sorted(s.start_ns for s in spans if s.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs) > 0
        assert all(abs(a - b) < 1_000_000 for a, b in zip(mine, theirs)), (name, mine, theirs)


def test_records_hold_the_latest_session_alone():
    _profiled(lambda: _jobs("sha256"))
    first = profiling.spans()
    assert len(first) > 30
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("tree.second"):
            with profiling.annotate("kernel.inner", 3):
                pass
    second = profiling.spans()
    assert [(s.name, s.rows) for s in second] == [("tree.second", None), ("kernel.inner", 3)]
    assert second[0].parent is None and second[1].parent == second[0].id
    assert all(s.start_ns >= t0 for s in second)
    assert len(first) > 30  # a copy: the first session's list is left as it was


def test_parameter_derivation_and_schedule_raise_the_setup_counters():
    d0, s0 = poseidon.derive_seconds, poseidon.schedule_seconds
    ark, mds = poseidon.find_poseidon_ark_and_mds(BLS12_381_FR, 2, 8, 31, 0)
    assert poseidon.derive_seconds > d0
    assert (ark, mds) == (CFG.ark, CFG.mds)
    fresh = poseidon.PoseidonConfig(field=BLS12_381_FR, full_rounds=8, partial_rounds=31, alpha=17,
                                    ark=ark, mds=mds, rate=2, capacity=1)
    fresh.schedule_tables("cpu")
    s1 = poseidon.schedule_seconds
    assert s1 > s0
    fresh.schedule_tables("cpu")  # the cached image: not timed
    assert poseidon.schedule_seconds == s1


def test_a_build_raises_the_build_counters(tmp_path, monkeypatch):
    from crypto_primitives_tpu_torch.native import build

    fake = tmp_path / "nvcc"  # writes the library it is asked for, and nothing else
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    s0 = build.build_seconds
    assert build.build(["sha256_compress"])["sha256_compress"].exists()
    assert build.build_seconds > s0
    fake.unlink()  # built already: no nvcc is started
    assert build.build(["sha256_compress"])["sha256_compress"].exists()


def test_roots_and_verdicts_equal_with_spans_on_and_off(traced):
    tree_kind, root_on, ok_on, spans = traced
    root_off, ok_off = _jobs(tree_kind)
    assert len(spans) > 30
    assert torch.equal(root_on, root_off)
    assert ok_off.tolist() == ok_on.tolist() == [True, False, True, True]
