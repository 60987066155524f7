"""``sig_host_ms``: host milliseconds a Schnorr verify job spends in its host
stages: s's and e's bits and their upload (``sig.bits``), the keys' words
and their upload (``sig.pack``), and the challenge a row, serialised,
hashed with the digest and compared (``sig.challenge``), from the program's
spans inside the ``sig.verify`` roots of the traced stretch, over the jobs.
None where the program keeps no such spans."""

from portbench.harness import loader

HOST = ("sig.bits", "sig.pack", "sig.challenge")


def read(run):
    got = loader.module("metrics", "sig_windowed_ms").job_spans(run)
    if got is None:
        return None
    spans, roots = got
    inside = loader.module("metrics", "crh_self_ms").inside
    host = [s for name in HOST for s in inside(spans, roots, name)]
    return sum(s.end_ns - s.start_ns for s in host) * 1e-6 / len(roots) if host else None
