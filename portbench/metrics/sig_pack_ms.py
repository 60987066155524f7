"""``sig_pack_ms``: host milliseconds a Schnorr verify job spends building the
keys' words in Python (``ops.curve_fast.pack_points``: the ints (x, y, x y,
1) a key, then each element's Montgomery form, one at a time), from the
program's ``curve.pack`` spans inside the ``sig.verify`` roots of the traced
stretch, over the jobs.  The words' upload lies outside the span, in
``sig.pack``.  None where the program keeps no such spans.

``stage_ms`` serves the other readers of a verify's host stages
(``sig_bits_ms``, ``sig_unpack_ms``, ``sig_wait_ms``, ``sig_digest_ms``,
``sig_encode_ms``)."""

from portbench.harness import loader


def stage_ms(run, names: tuple):
    """Milliseconds a job in the spans named ``names`` inside the
    ``sig.verify`` roots of the traced stretch, or None where there are
    none."""
    got = loader.module("metrics", "sig_windowed_ms").job_spans(run)
    if got is None:
        return None
    spans, roots = got
    inside = loader.module("metrics", "crh_self_ms").inside
    found = [s for name in names for s in inside(spans, roots, name)]
    return sum(s.end_ns - s.start_ns for s in found) * 1e-6 / len(roots) if found else None


def read(run):
    return stage_ms(run, ("curve.pack",))
