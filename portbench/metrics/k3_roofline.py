"""``k3_roofline``: the least time of the traced jobs' K3 calls
(``roofline/k3_sha256.py``) over K3's device time in the trace, in %."""


def read(run):
    return run.roofline_pct("k3_sha256")
