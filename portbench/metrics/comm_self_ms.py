"""``comm_self_ms``: host milliseconds a job spends in the Pedersen
commitment and the curve glue it calls (the record's and the opening's bits,
the window indices, the complete addition of the two sums in plain torch,
the affine step), from the program's spans in the traced stretch: the root
``comm.pedersen`` spans' time less that of the ``kernel.k4`` spans inside
them (the message's and the blinding table's), over the jobs (one root a
job).  Read under the profiler, whose cost an op falls on the glue's many
small ops.  None where the program keeps no such spans.

``job_spans`` serves ``comm_add_ms`` too."""

from portbench.harness import loader

ROOT = "comm.pedersen"


def job_spans(run):
    """(the closed program spans of the traced stretch, its ``comm.pedersen``
    roots), or None."""
    from crypto_primitives_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if run.trace is None or spans is None:
        return None
    closed = [s for s in spans() if s.end_ns is not None]
    roots = [s for s in closed if s.parent is None and s.name == ROOT]
    return (closed, roots) if roots else None


def _ns(spans) -> int:
    return sum(s.end_ns - s.start_ns for s in spans)


def read(run):
    got = job_spans(run)
    if got is None:
        return None
    spans, roots = got
    k4 = loader.module("metrics", "crh_self_ms").inside(spans, roots, "kernel.k4")
    return (_ns(roots) - _ns(k4)) * 1e-6 / len(roots)
