"""``k4_roofline``: the least time of the traced jobs' K4 calls
(``roofline/k4_msm_te.py``) over K4's device time in the trace, in %."""


def read(run):
    return run.roofline_pct("k4_msm_te")
