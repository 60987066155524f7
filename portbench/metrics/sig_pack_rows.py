"""``sig_pack_rows``: points a Schnorr verify job hands to the keys' pack
kernel A4, the sum of the ``rows`` of the program's ``kernel.pack`` spans
(``ops.pack_kernel``) inside the ``sig.verify`` roots of the traced stretch,
over the jobs.  Only a kernel launch gives its span ``rows``: the batch where
the keys' Montgomery form is one launch, 0 where it runs in plain PyTorch.
None where the program keeps no such spans."""

from portbench.harness import loader


def read(run):
    got = loader.module("metrics", "sig_windowed_ms").job_spans(run)
    if got is None:
        return None
    spans, roots = got
    packs = loader.module("metrics", "crh_self_ms").inside(spans, roots, "kernel.pack")
    return sum(s.rows or 0 for s in packs) / len(roots) if packs else None
