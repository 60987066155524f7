"""``device_idle_pct``: the share of the traced jobs' wall time in which
nothing runs on the device, from the profiler's timeline."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t and t.window_s > 0 else None
