"""``sig_pack_rows`` on hand-made span records, on the CPU."""

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
    run = RunData(unit="signatures", units_per_job=1, setup_s=0.0, jobs=1, window_s=1.0, latencies=[1.0], spans={},
                  launches={}, trace=trace)
    return loader.module("metrics", "sig_pack_rows").read(run)


def _job(base, rows):
    """One verify job's program spans: the root, the keys' pack
    (``curve.pack``, then ``kernel.pack``, whose ``rows`` is None on the
    plain branch), s G and e pk."""
    return [_span(base, "sig.verify"), _span(base + 1, "sig.pack", base), _span(base + 2, "curve.pack", base + 1, 64),
            _span(base + 3, "kernel.pack", base + 1, rows), _span(base + 4, "sig.fixed", base),
            _span(base + 5, "kernel.k4", base + 4, 64), _span(base + 6, "sig.windowed", base),
            _span(base + 7, "kernel.windowed", base + 6, 64)]


@pytest.mark.parametrize("rows, want", [([64, 64], 64.0), ([None, None], 0.0), ([64, None], 32.0)])
def test_rows_of_the_pack_kernel_a_job(monkeypatch, rows, want):
    records = [s for k, r in enumerate(rows) for s in _job(10 * k, r)]
    assert _read(monkeypatch, records) == pytest.approx(want)


def test_packs_outside_a_verify_are_not_counted(monkeypatch):
    # a pack of its own (an ElGamal batch) and one under another root
    stray = [_span(100, "curve.pack", None, 4096), _span(101, "kernel.pack", None, 4096),
             _span(102, "comm.pedersen"), _span(103, "kernel.pack", 102, 4096)]
    assert _read(monkeypatch, _job(0, 64) + stray) == pytest.approx(64.0)
    assert _read(monkeypatch, stray) is None


def test_none_without_a_trace_or_a_pack_kernel_span(monkeypatch):
    assert _read(monkeypatch, _job(0, 64), traced=False) is None
    assert _read(monkeypatch, []) is None
    # a program without the kernel's span (the host pack): the same roots, no ``kernel.pack`` inside them
    assert _read(monkeypatch, [s for s in _job(0, 64) if s.name != "kernel.pack"]) is None
