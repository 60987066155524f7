"""``comm_add_rows``: point pairs a commitment job hands to the complete
addition kernel, the sum of the ``rows`` of the program's ``kernel.add``
spans (``ops.add_kernel``) inside the ``comm.pedersen`` roots of the traced
stretch, over the jobs.  Only a kernel launch gives its span ``rows``: the
batch where the addition runs as one launch, 0 where it runs in plain
PyTorch.  None where the program keeps no such spans."""

from portbench.harness import loader


def read(run):
    got = loader.module("metrics", "comm_self_ms").job_spans(run)
    if got is None:
        return None
    spans, roots = got
    add = loader.module("metrics", "crh_self_ms").inside(spans, roots, "kernel.add")
    return sum(s.rows or 0 for s in add) / len(roots) if add else None
