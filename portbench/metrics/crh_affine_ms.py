"""``crh_affine_ms``: host milliseconds a job spends in the affine step
(``ops.curve.te_to_affine``: Z^(p-2) by plain-torch Montgomery products,
then two more), from the program's ``crh.affine`` spans inside the
``crh.pedersen`` roots of the traced stretch, over the jobs.  Read under the
profiler.  None where the program keeps no such spans."""

from portbench.harness import loader


def read(run):
    base = loader.module("metrics", "crh_self_ms")
    got = base.job_spans(run)
    if got is None:
        return None
    spans, roots = got
    affine = base.inside(spans, roots, "crh.affine")
    return sum(s.end_ns - s.start_ns for s in affine) * 1e-6 / len(roots) if affine else None
