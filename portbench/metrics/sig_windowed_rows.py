"""``sig_windowed_rows``: points a Schnorr verify job hands to the windowed
product's kernel A3, the sum of the ``rows`` of the program's
``kernel.windowed`` spans (``ops.windowed_kernel``) inside the ``sig.verify``
roots of the traced stretch, over the jobs.  Only a kernel launch gives its
span ``rows``: the batch where the product runs as one launch, 0 where it
runs in plain PyTorch.  None where the program keeps no such spans."""

from portbench.harness import loader


def read(run):
    got = loader.module("metrics", "sig_windowed_ms").job_spans(run)
    if got is None:
        return None
    spans, roots = got
    windowed = loader.module("metrics", "crh_self_ms").inside(spans, roots, "kernel.windowed")
    return sum(s.rows or 0 for s in windowed) / len(roots) if windowed else None
