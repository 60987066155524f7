"""Profiling and tracing: the twin of ``crypto_primitives_tpu/utils/profiling.py``
and of the reference's ``#[tracing::instrument(target = "r1cs")]`` per-gadget
tracing (e.g. the reference's src/sponge/poseidon/constraints.rs:38-107).

  * ``annotate(name, rows=None)``: a named span of the program.  With no
    profiler recording it is one shared no-op (one flag read, nothing
    allocated or recorded).  While ``torch.profiler`` records it opens a
    profiler range (``torch._C._profiler._RecordFunctionFast``, the cheaper
    twin of ``record_function``), so the span lies in the profiler's trace
    beside the device's operations, and keeps a :class:`Span` record
    (name, id, parent, start and end in ``time.time_ns()`` nanoseconds,
    which is the clock of the profiler's events, and ``rows``).  The
    profiler is the only switch.
  * ``spans()``: the records of the latest profiling session, in the order
    the spans opened; a session's start clears the previous one's.
  * ``capture``: ``torch.profiler.profile`` over the CPU and, where a card is
    present, CUDA activities, writing a Chrome trace (``chrome://tracing`` or
    Perfetto) of the enclosed block under the given directory.
  * ``constraint_report``: constraint counts of an R1CS system.

Span names start with their layer: ``tree.`` in the Merkle tree layer
(``models/merkle_tree/device.py``), ``crh.`` in the Pedersen CRH
(``models/crh/pedersen.py``), ``comm.`` in the Pedersen commitment
(``models/commitment/pedersen.py``), ``sig.`` in Schnorr's batch verify
(``models/signature/schnorr.py``), ``curve.`` in the curve tier's moves
between host and device (``ops/curve_fast.py``: ``pack_points``,
``pack_points_device``, ``scalars_to_bits``, ``affine_host``, which
``ops/curve_sw_fast.py`` shares but the device pack), ``kernel.`` in the
kernel wrappers (``ops/poseidon_kernel.py``, ``ops/sha256_kernel.py``,
``ops/msm_kernel.py``, ``ops/affine_kernel.py``, ``ops/add_kernel.py``,
``ops/windowed_kernel.py``, ``ops/pack_kernel.py``).  Records are kept for the thread that opens
spans; the program opens them from one thread.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function


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


class _Off:
    """The span of a run with no profiler recording."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()
# The profiler's cheapest range: about 1-2 us on an H100 host while CUDA is
# traced, against 9-12 us for ``record_function`` (which stays the fallback
# for a torch without it).
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)
_records: list = []  # the latest profiling session's spans, in the order they opened
_open: list = []  # the spans open now, innermost last
_ids = itertools.count()


class Span:
    """One span of the program, recorded while the profiler records.
    ``parent`` is the id of the innermost span open when it opened (None for
    a root); ``end_ns`` is None while it is open; ``rows`` is the work it
    hands on (a kernel wrapper's rows), or None."""

    __slots__ = ("name", "rows", "id", "parent", "start_ns", "end_ns", "_range")

    def __init__(self, name: str, rows):
        self.name, self.rows = name, rows

    def __enter__(self):
        self._range = _RANGE(self.name)
        self._range.__enter__()
        self.id = next(_ids)
        self.parent = _open[-1].id if _open else None
        self.end_ns = None
        _records.append(self)
        _open.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _open.pop()
        self._range.__exit__(*exc)
        return False


def annotate(name: str, rows: int | None = None):
    """A span named ``name``, with the row count ``rows`` where it has one; a
    context manager.  Free of cost when no profiler records: pass only a
    count the caller holds already."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, rows)


def spans() -> list:
    """The :class:`Span` records of the latest profiling session."""
    return list(_records)


def _clear_on_profiler_start(start=_autograd_profiler._run_on_profiler_start):
    _records.clear()
    start()


# every profiler (torch.profiler.profile, torch.autograd.profiler.profile)
# calls this module function when it starts recording
_autograd_profiler._run_on_profiler_start = _clear_on_profiler_start


def constraint_report(cs) -> dict:
    """Constraint-count introspection (the reference uses
    ``cs.num_constraints()`` as a profiler in tests,
    src/merkle_tree/tests/constraints.rs:92-147)."""
    return {
        "num_constraints": cs.num_constraints,
        "num_witness_variables": cs.num_witness,
        "num_instance_variables": cs.num_instance,
    }
