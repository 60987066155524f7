"""``comm_add_rows`` on hand-made span records, on the CPU."""

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
    run = RunData(unit="rows", units_per_job=1, setup_s=0.0, jobs=1, window_s=1.0, latencies=[1.0], spans={},
                  launches={}, trace=trace)
    return loader.module("metrics", "comm_add_rows").read(run)


def _job(base, rows):
    """One commitment job's program spans: the root, the CRH's sum, the
    blinding sum, the addition (``kernel.add`` with ``rows``, None on the
    plain branch) and the affine step."""
    return [_span(base, "comm.pedersen"), _span(base + 1, "crh.msm", base), _span(base + 2, "kernel.k4", base + 1, 64),
            _span(base + 3, "comm.blind", base), _span(base + 4, "kernel.k4", base + 3, 64),
            _span(base + 5, "comm.add", base), _span(base + 6, "kernel.add", base + 5, rows),
            _span(base + 7, "comm.affine", base), _span(base + 8, "kernel.affine", base + 7, 64)]


@pytest.mark.parametrize("rows, want", [([64, 64], 64.0), ([None, None], 0.0), ([64, None], 32.0)])
def test_rows_of_the_addition_kernel_a_job(monkeypatch, rows, want):
    records = [s for k, r in enumerate(rows) for s in _job(10 * k, r)]
    assert _read(monkeypatch, records) == pytest.approx(want)


def test_additions_outside_a_commitment_are_not_counted(monkeypatch):
    # an addition of its own (an ElGamal or Schnorr batch) and one under another root
    stray = [_span(100, "kernel.add", None, 4096), _span(101, "crh.pedersen"), _span(102, "kernel.add", 101, 4096)]
    assert _read(monkeypatch, _job(0, 64) + stray) == pytest.approx(64.0)
    assert _read(monkeypatch, stray) is None


def test_none_without_a_trace_or_an_addition_span(monkeypatch):
    assert _read(monkeypatch, _job(0, 64), traced=False) is None
    assert _read(monkeypatch, []) is None
    # the parent's commitment: the same roots, no ``kernel.add`` span inside them
    assert _read(monkeypatch, [s for s in _job(0, 64) if s.name != "kernel.add"]) is None
