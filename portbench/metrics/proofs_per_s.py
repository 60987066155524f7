"""``proofs_per_s``: membership proofs served and checked in the window,
over the window's seconds."""


def read(run):
    return run.rate() if run.unit == "proofs" else None
