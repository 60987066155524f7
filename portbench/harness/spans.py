"""The benchmark's spans around the calls into each layer of the program.

Each span adds its host seconds to a total by name; while the profiler
runs it is also a ``record_function`` range, so the trace shows which span
was open when the device sat idle.  A span's name starts with its layer:
``tree.`` for a call into the Merkle tree layer (it returns once its work is
queued), ``host.`` for a read of a result to the host (it waits for the
device), ``traffic.`` for the benchmark's own input making."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Spans:
    def __init__(self):
        self.seconds = defaultdict(float)
        self.profiled = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.profiled:
            from torch.profiler import record_function

            with record_function(name):
                yield
        else:
            yield
        self.seconds[name] += time.perf_counter() - t0
