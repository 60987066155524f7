"""``job_p95_ms``: the 95th percentile of every window job's latency, from
the job's start to its result on the host."""

import statistics


def read(run):
    if len(run.latencies) < 2:
        return None
    return statistics.quantiles(run.latencies, n=100, method="inclusive")[94] * 1e3
