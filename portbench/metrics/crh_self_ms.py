"""``crh_self_ms``: host milliseconds a job spends in the Pedersen CRH and the
curve glue it calls (the bytes' bits, the window indices, the table lookup,
the affine step's plain-torch products), from the program's spans in the
traced stretch: the root ``crh.pedersen`` spans' time less that of the
``kernel.k4`` spans inside them, over the jobs (one root a job).  Read under
the profiler, whose cost an op falls on the glue's many small ops.  None
where the program keeps no such spans.

``job_spans`` and ``inside`` serve ``crh_affine_ms`` too."""

ROOT = "crh.pedersen"


def job_spans(run):
    """(the closed program spans of the traced stretch, its ``crh.pedersen``
    roots), or None."""
    from crypto_primitives_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if run.trace is None or spans is None:
        return None
    closed = [s for s in spans() if s.end_ns is not None]
    roots = [s for s in closed if s.parent is None and s.name == ROOT]
    return (closed, roots) if roots else None


def inside(spans, roots, name: str) -> list:
    """The spans named ``name`` under one of ``roots``."""
    by_id = {s.id: s for s in spans}
    ids = {r.id for r in roots}
    out = []
    for s in spans:
        if s.name != name:
            continue
        up = s
        while up.parent is not None and up.parent in by_id:
            up = by_id[up.parent]
        if up.id in ids:
            out.append(s)
    return out


def _ns(spans) -> int:
    return sum(s.end_ns - s.start_ns for s in spans)


def read(run):
    got = job_spans(run)
    if got is None:
        return None
    spans, roots = got
    return (_ns(roots) - _ns(inside(spans, roots, "kernel.k4"))) * 1e-6 / len(roots)
