"""``leaves_per_s``: leaves committed into roots in the window, over the
window's seconds."""


def read(run):
    return run.rate() if run.unit == "leaves" else None
