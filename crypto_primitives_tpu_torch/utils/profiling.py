"""Profiling and tracing: the twin of ``crypto_primitives_tpu/utils/profiling.py``
and of the reference's two tracing mechanisms:

  * ``#[tracing::instrument(target = "r1cs")]`` per-gadget tracing (e.g. the
    reference's src/sponge/poseidon/constraints.rs:38-107) -> named spans
    (``annotate``, a ``torch.profiler.record_function``) that show in a
    captured trace, and ``constraint_report`` for the R1CS tier;
  * ``ark-std``'s ``start_timer!`` / ``end_timer!`` scope timers behind the
    ``print-trace`` feature (src/crh/pedersen/mod.rs:65-126) ->
    ``scope_timer``, on with CRYPTO_PRIMITIVES_PRINT_TRACE=1.

``capture`` wraps ``torch.profiler.profile`` over the CPU and, where a card
is present, CUDA activities, and writes a Chrome trace (``chrome://tracing``
or Perfetto) of the enclosed block under the given directory.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

PRINT_TRACE = os.environ.get("CRYPTO_PRIMITIVES_PRINT_TRACE", "") == "1"


@contextlib.contextmanager
def capture(log_dir: str = "profiles"):
    """Profile the enclosed block and write its Chrome trace to
    ``<log_dir>/trace_<pid>_<ns>.json``; yields the trace's path, written
    when the block ends.  Usage:

        with profiling.capture("profiles") as path:
            out = crh.evaluate_batch(params, inputs)
            torch.cuda.synchronize()
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def annotate(name: str):
    """A named span in captured traces (the ``tracing::instrument`` twin);
    a context manager."""
    return record_function(name)


@contextlib.contextmanager
def scope_timer(label: str, enabled: bool | None = None):
    """``start_timer!`` / ``end_timer!`` twin; prints when enabled (or when
    CRYPTO_PRIMITIVES_PRINT_TRACE=1)."""
    on = PRINT_TRACE if enabled is None else enabled
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if on:
            dt = time.perf_counter() - t0
            print(f"[trace] {label}: {dt*1e3:.2f} ms", flush=True)


def constraint_report(cs) -> dict:
    """Constraint-count introspection (the reference uses
    ``cs.num_constraints()`` as a profiler in tests,
    src/merkle_tree/tests/constraints.rs:92-147)."""
    return {
        "num_constraints": cs.num_constraints,
        "num_witness_variables": cs.num_witness,
        "num_instance_variables": cs.num_instance,
    }
