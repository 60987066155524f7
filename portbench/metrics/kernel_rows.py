"""``kernel_rows``: rows a job hands to the kernels (states to K1, messages
to K3), the sum of the ``rows`` of the program's ``kernel.*`` spans in the
traced stretch over its jobs: the work done, as a count.  None where the
program keeps no span records."""

from portbench.harness import loader


def read(run):
    base = loader.module("metrics", "tree_self_ms")
    got = base.program_spans(run)
    if got is None:
        return None
    spans, jobs = got
    return sum(k.rows or 0 for k, _ in base.outer_kernels(spans)) / jobs
