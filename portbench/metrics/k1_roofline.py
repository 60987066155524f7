"""``k1_roofline``: the least time of the traced jobs' K1 calls
(``roofline/k1_poseidon.py``) over K1's device time in the trace, in %."""


def read(run):
    return run.roofline_pct("k1_poseidon")
