"""``setup_s``: process start to the first measured job (imports, the
kernels' build where the checkout has none, set-up and the warm job)."""


def read(run):
    return run.setup_s
