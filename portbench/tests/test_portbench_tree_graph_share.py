"""``tree_graph_share`` on hand-made span records, on the CPU."""

import pytest

from crypto_primitives_tpu_torch.utils import profiling
from portbench.harness import loader
from portbench.harness.runner import RunData
from portbench.harness.trace import Trace


def _span(sid, name, parent=None, rows=None):
    s = profiling.Span(name, rows)
    s.id, s.parent, s.start_ns, s.end_ns = sid, parent, 10 * sid, 10 * sid + 5
    return s


def _read(monkeypatch, records, traced=True):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    trace = Trace(window_s=1.0, busy_s=0.5, device_ops={}, idle={}) if traced else None
    run = RunData(unit="proofs", units_per_job=1, setup_s=0.0, jobs=1, window_s=1.0, latencies=[1.0], spans={},
                  launches={}, trace=trace)
    return loader.module("metrics", "tree_graph_share").read(run)


def _job(base, replayed):
    """One paths job's program spans: the leaf hash, the gather and the
    verify, each replayed (one ``kernel.graph`` child) or eager."""
    out = [_span(base, "tree.hash_leaves"), _span(base + 1, "kernel.k3", base, 256),
           _span(base + 2, "tree.gather_paths"), _span(base + 4, "tree.verify_paths")]
    if replayed:
        out += [_span(base + 3, "kernel.graph", base + 2, 0), _span(base + 5, "kernel.graph", base + 4, 3072)]
    else:
        out += [_span(base + 3, "tree.gather_level", base + 2), _span(base + 5, "tree.select_level", base + 4),
                _span(base + 6, "tree.hash_level", base + 4), _span(base + 7, "kernel.k3", base + 6, 256)]
    return out


@pytest.mark.parametrize("replayed, share", [([True, True], 100.0), ([False, False], 0.0), ([True, False], 50.0)])
def test_share_of_paths_calls_that_replay(monkeypatch, replayed, share):
    records = [s for k, r in enumerate(replayed) for s in _job(10 * k, r)]
    assert _read(monkeypatch, records) == pytest.approx(share)


def test_none_without_a_trace_or_a_paths_root(monkeypatch):
    assert _read(monkeypatch, _job(0, True), traced=False) is None
    assert _read(monkeypatch, []) is None
