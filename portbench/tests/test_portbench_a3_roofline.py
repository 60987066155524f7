"""A3's least work (``roofline/a3_curve_windowed.py``) and ``a3_roofline``
on hand-made span records and device times, on the CPU."""

import pytest

from crypto_primitives_tpu_torch.utils import profiling
from portbench.harness import loader
from portbench.harness.runner import RunData
from portbench.harness.trace import Trace
from portbench.roofline import a3_curve_windowed, k4_msm_te, peaks

KERNEL = "void (anonymous namespace)::curve_windowed_kernel<8>(unsigned int const*, unsigned char const*, uint4*)"


def test_least_work_of_the_configuration():
    call = a3_curve_windowed.call(1 << 16)
    assert call == {"rows": 1 << 16, "scalar_bits": 251, "w": 4, "num_words": 8}
    # 76 additions at K4's 8 products, 248 doublings at 3 products and 4 squares
    product, square = a3_curve_windowed.product_ops(8), a3_curve_windowed.square_ops(8)
    assert product == k4_msm_te.ops_per_row_group(8) // k4_msm_te.PRODUCTS_PER_ADD == 528 and square == 416
    assert a3_curve_windowed.ops_per_row(251, 4, 8) == 76 * 8 * 528 + 248 * (3 * 528 + 4 * 416) == 1_126_528
    nbytes, ops = a3_curve_windowed.work(**call)
    assert nbytes == (1 << 16) * (256 + 32) and ops == (1 << 16) * 1_126_528
    # operations-bound: about 1.10 ms on the card's peak, the bytes about 6 us
    least = a3_curve_windowed.least(**call)
    assert least == pytest.approx(ops / peaks.PEAK_OPS_PER_S) == pytest.approx(1.102e-3, rel=1e-3)
    assert nbytes / peaks.PEAK_BYTES_PER_S < 6e-6


def test_least_work_follows_the_schedule():
    # one window: the table's 14 additions only; each further window w doublings and one addition
    ops = a3_curve_windowed.ops_per_row
    assert ops(4, 4, 8) == 14 * 8 * 528
    assert ops(8, 4, 8) - ops(4, 4, 8) == 8 * 528 + 4 * (3 * 528 + 4 * 416)
    assert ops(9, 4, 8) == ops(12, 4, 8)


def _span(sid, name, parent=None, rows=None):
    s = profiling.Span(name, rows)
    s.id, s.parent, s.start_ns, s.end_ns = sid, parent, 10 * sid, 10 * sid + 5
    return s


def _job(base, rows):
    return [_span(base, "sig.verify"), _span(base + 1, "sig.windowed", base),
            _span(base + 2, "curve.windowed", base + 1, 64), _span(base + 3, "kernel.windowed", base + 2, rows)]


def _read(monkeypatch, records, device_ops, traced=True):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    trace = Trace(window_s=1.0, busy_s=0.5, device_ops=device_ops, idle={}) if traced else None
    run = RunData(unit="signatures", units_per_job=1, setup_s=0.0, jobs=1, window_s=1.0, latencies=[1.0], spans={},
                  launches={}, trace=trace)
    return loader.module("metrics", "a3_roofline").read(run)


def test_share_of_the_bound(monkeypatch):
    records = _job(0, 1 << 16) + _job(10, 1 << 16)
    least = 2 * a3_curve_windowed.least(**a3_curve_windowed.call(1 << 16))
    ops = {KERNEL: 4 * least, "void (anonymous namespace)::msm_te_kernel<8>(...)": 1.0}
    assert _read(monkeypatch, records, ops) == pytest.approx(25.0)


def test_none_without_a_trace_rows_or_device_time(monkeypatch):
    ops = {KERNEL: 1e-3}
    assert _read(monkeypatch, _job(0, 64), ops, traced=False) is None
    assert _read(monkeypatch, [], ops) is None
    assert _read(monkeypatch, _job(0, None), ops) is None  # the plain branch: no rows
    assert _read(monkeypatch, [s for s in _job(0, 64) if s.name != "kernel.windowed"], ops) is None  # the parent
    assert _read(monkeypatch, _job(0, 64), {}) is None  # no A3 op in the trace
