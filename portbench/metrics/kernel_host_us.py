"""``kernel_host_us``: host microseconds a kernel wrapper call takes, from the
program's ``kernel.*`` spans in the traced stretch (shape checks, the
library lookup, the output's allocation, the launch; on the CPU the plain
version's whole work).  None where the program keeps no span records."""

from portbench.harness import loader


def read(run):
    base = loader.module("metrics", "tree_self_ms")
    got = base.program_spans(run)
    kernels = base.outer_kernels(got[0]) if got else []
    if not kernels:
        return None
    return sum(k.end_ns - k.start_ns for k, _ in kernels) * 1e-3 / len(kernels)
