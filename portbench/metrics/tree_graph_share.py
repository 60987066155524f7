"""``tree_graph_share``: the share, in %, of the traced stretch's root
``tree.gather_paths`` and ``tree.verify_paths`` spans (the proof gathers and
the verifies) that replay a CUDA graph, that is, hold a ``kernel.graph``
span: 100 where every such call replayed, 0 where none did (the level loop
ran eagerly).  None where the program keeps no span records or the stretch
holds no such root."""

from portbench.harness import loader

ROOTS = ("tree.gather_paths", "tree.verify_paths")


def read(run):
    got = loader.module("metrics", "tree_self_ms").program_spans(run)
    if got is None:
        return None
    spans = got[0]
    by_id = {s.id: s for s in spans}
    roots = {s.id for s in spans if s.parent is None and s.name in ROOTS}
    if not roots:
        return None
    replayed = set()
    for s in spans:
        if s.name == "kernel.graph":
            up = s
            while up.parent is not None and up.parent in by_id:
                up = by_id[up.parent]
            replayed.add(up.id)
    return 100.0 * len(roots & replayed) / len(roots)
