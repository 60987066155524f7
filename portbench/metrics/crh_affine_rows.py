"""``crh_affine_rows``: points a job hands to the affine kernel, the sum of
the ``rows`` of the program's ``kernel.affine`` spans (``ops.affine_kernel``)
inside the ``crh.pedersen`` roots of the traced stretch, over the jobs.  Only
a kernel launch gives its span ``rows``: the batch where the affine step runs
as one launch, 0 where it runs in plain PyTorch.  None where the program
keeps no such spans."""

from portbench.harness import loader


def read(run):
    base = loader.module("metrics", "crh_self_ms")
    got = base.job_spans(run)
    if got is None:
        return None
    spans, roots = got
    affine = base.inside(spans, roots, "kernel.affine")
    return sum(s.rows or 0 for s in affine) / len(roots) if affine else None
