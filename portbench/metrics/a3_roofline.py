"""``a3_roofline``: the least time of the traced jobs' windowed products
(``roofline/a3_curve_windowed.py`` at the configuration's scalar bits, window
and words, on the ``rows`` of the ``kernel.windowed`` spans inside the
``sig.verify`` roots) over A3's device time in the trace (ops named
``curve_windowed_kernel``), in %.  None without a trace, without such spans
or rows (a program without the span, or the plain branch) or without A3's
device time."""

from portbench.harness import loader


def read(run):
    got = loader.module("metrics", "sig_windowed_ms").job_spans(run)
    if got is None:
        return None
    spans, roots = got
    rows = sum(s.rows or 0 for s in loader.module("metrics", "crh_self_ms").inside(spans, roots, "kernel.windowed"))
    a3 = loader.roofline("a3_curve_windowed")
    device = run.trace.kernel_seconds(a3.KERNEL_NAMES)
    return 100.0 * a3.least(**a3.call(rows)) / device if rows > 0 and device > 0 else None
