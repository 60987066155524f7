"""``tree_issue_ms``: host milliseconds a job spends inside the calls into
the Merkle tree layer (spans ``tree.*``), which return once their work is
queued: the host's time to issue a job, in the window."""


def read(run):
    total = sum(s for k, s in run.spans.items() if k.startswith("tree."))
    return total / run.jobs * 1e3 if run.jobs else None
