"""``sig_windowed_ms``: host milliseconds a Schnorr verify job spends in the
windowed variable-base product e pk (``ops.curve_fast.windowed_digits``: the
16 multiples of each key, then 62 windows of 4 doublings and one addition,
each addition ``ops.curve.te_add_digits`` in plain torch), from the
program's ``sig.windowed`` spans inside the ``sig.verify`` roots of the
traced stretch, over the jobs (one root a job).  On the card the span
closes when the product's last op is queued; what is still queued then is
waited for in ``sig.affine``, whose host ints read the sum.  Read under the
profiler, whose cost an op falls on the product's 236,000 small ops: it
ranks parts of the traced job, and is no untraced size.  None where the
program keeps no such spans.

``job_spans`` serves ``sig_host_ms`` too."""

from portbench.harness import loader

ROOT = "sig.verify"


def job_spans(run):
    """(the closed program spans of the traced stretch, its ``sig.verify``
    roots), or None."""
    from crypto_primitives_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if run.trace is None or spans is None:
        return None
    closed = [s for s in spans() if s.end_ns is not None]
    roots = [s for s in closed if s.parent is None and s.name == ROOT]
    return (closed, roots) if roots else None


def read(run):
    got = job_spans(run)
    if got is None:
        return None
    spans, roots = got
    windowed = loader.module("metrics", "crh_self_ms").inside(spans, roots, "sig.windowed")
    return sum(s.end_ns - s.start_ns for s in windowed) * 1e-6 / len(roots) if windowed else None
