"""``tree_self_ms``: host milliseconds a job spends in the Merkle tree layer
and the hash glue it calls (the tree's Python, its ``where``,
``index_select`` and ``stack``, the converter, the sponge's state ``cat`` and
zero fill, ``_sha_compress``'s ``cat``), from the program's spans in the
traced stretch: the root ``tree.*`` spans' time less that of the
``kernel.*`` spans inside them.  Read under the profiler, whose cost a torch
op falls on this glue more than on a kernel wrapper's launch.  Jobs are counted by the program's root
spans: ``tree.build_tree`` where the unit is leaves, ``tree.verify_paths``
where it is proofs.  None where the program keeps no span records.

``program_spans`` and ``outer_kernels`` serve ``kernel_host_us`` and
``kernel_rows`` too."""

JOB_ROOTS = {"leaves": "tree.build_tree", "proofs": "tree.verify_paths"}


def program_spans(run):
    """(the closed program spans of the traced stretch, its jobs), or None."""
    from crypto_primitives_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if run.trace is None or spans is None:
        return None
    closed = [s for s in spans() if s.end_ns is not None]
    jobs = sum(s.parent is None and s.name == JOB_ROOTS.get(run.unit) for s in closed)
    return (closed, jobs) if jobs else None


def outer_kernels(spans) -> list:
    """(kernel span, its root span) of every ``kernel.*`` span that no other
    ``kernel.*`` span encloses."""
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        if not s.name.startswith("kernel."):
            continue
        root, up = s, by_id.get(s.parent)
        while up is not None and not up.name.startswith("kernel."):
            root, up = up, by_id.get(up.parent)
        if up is None:
            out.append((s, root))
    return out


def _tree_root(span) -> bool:
    return span.parent is None and span.name.startswith("tree.")


def read(run):
    got = program_spans(run)
    if got is None:
        return None
    spans, jobs = got
    roots = sum(s.end_ns - s.start_ns for s in spans if _tree_root(s))
    kernels = sum(k.end_ns - k.start_ns for k, root in outer_kernels(spans) if _tree_root(root))
    return (roots - kernels) * 1e-6 / jobs
