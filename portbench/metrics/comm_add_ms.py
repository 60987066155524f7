"""``comm_add_ms``: host milliseconds a job spends in the commitment's
complete addition of the message's and the opening's sums
(``ops.curve.te_add``: add-2008-hwcd, 11 plain-torch Montgomery products a
point in three stacked calls), from the program's ``comm.add`` spans inside
the ``comm.pedersen`` roots of the traced stretch, over the jobs.  Read under
the profiler.  None where the program keeps no such spans."""

from portbench.harness import loader


def read(run):
    got = loader.module("metrics", "comm_self_ms").job_spans(run)
    if got is None:
        return None
    spans, roots = got
    add = loader.module("metrics", "crh_self_ms").inside(spans, roots, "comm.add")
    return sum(s.end_ns - s.start_ns for s in add) * 1e-6 / len(roots) if add else None
