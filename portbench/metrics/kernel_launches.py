"""``kernel_launches``: kernel launches a job makes, from the kernel
wrappers' own counters read around the window's jobs."""


def read(run):
    return sum(run.launches.values()) / run.jobs if run.jobs and run.launches else None
