"""One run of one cell: set-up, one warm job, the measured window, the traced
stretch (``trace``), the reading of the metrics and the check against the
plain reference.

``run`` returns the result line's object and the numbers compared.  It is
the whole of a run but the look for a card, which ``run.py`` makes; tests
call it on the CPU at a small ``scale`` and with the program replaced.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time

import torch

from portbench.harness import loader, manifest, trace
from portbench.harness.spans import Spans

# top-level modules that no run may load: JAX and the JAX package the port
# was made from (compared whole: the port's own name begins with the latter)
BANNED = ("jax", "jaxlib", "flax", "crypto_primitives_tpu")


def process_start() -> float:
    """The wall-clock time at which this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def banned_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


@dataclasses.dataclass
class RunData:
    """What the metric readers read."""

    unit: str
    units_per_job: int
    setup_s: float
    jobs: int
    window_s: float
    latencies: list
    spans: dict
    launches: dict
    trace: object = None

    def rate(self) -> float:
        return self.jobs * self.units_per_job / self.window_s

    def roofline_pct(self, kernel: str):
        t = self.trace
        if t is None:
            return None
        mod = loader.roofline(kernel)
        least = sum(mod.least(**shape) for name, shape in t.calls if name == kernel)
        device = t.kernel_seconds(mod.KERNEL_NAMES)
        return 100.0 * least / device if least > 0 and device > 0 else None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell_name: str, seed: int, seconds: float, traced: bool, device="cuda", scale=None,
        program=None, max_jobs=None, t_start=None) -> tuple:
    """(result, checks): the result line's object, and {name: (value, limit)}.

    ``program(cfgmod, cfg, device)`` stands in for the configuration's
    ``Program``: the control uses it."""
    t_start = process_start() if t_start is None else t_start
    device = torch.device(device)
    scale = scale or {}
    man = manifest.load()
    cell = manifest.cell(man, cell_name)
    cfg = loader.data("configs", cell["config"])
    cfgmod = loader.module("configs", cell["config"])
    mix = loader.data("traffic", cell["traffic"])
    kind = loader.module("kinds", mix["kind"])

    prog = program(cfgmod, cfg, device) if program else cfgmod.Program(cfg, device)
    traffic = kind.Traffic(mix, cfg, cfgmod, prog, seed, device, scale)
    setup_spans = Spans()
    traffic.setup(setup_spans)
    traffic.job(traffic.inputs(-1), setup_spans)  # the warm job: every shape of the window
    _sync(device)
    setup_s = time.time() - t_start

    # as timeit does: no collector pauses inside the measured jobs (the
    # program's objects hold no reference cycles; refcounting frees them)
    gc.collect()
    gc.disable()
    spans, results, latencies = Spans(), {}, []
    launches0 = prog.launches()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds and (max_jobs is None or i < max_jobs):
        with spans("traffic.inputs"):
            inputs = traffic.inputs(i)
        j0 = time.perf_counter()
        results[i] = traffic.job(inputs, spans)
        latencies.append(time.perf_counter() - j0)
        i += 1
    window_s = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in prog.launches().items()}

    data = RunData(unit=kind.UNIT, units_per_job=traffic.units_per_job, setup_s=setup_s, jobs=i,
                   window_s=window_s, latencies=latencies, spans=dict(spans.seconds), launches=launches)
    if traced:
        n_trace = scale.get("trace_jobs", mix["trace_jobs"])
        data.trace = trace.capture(traffic, Spans(), results, i, n_trace, device.type == "cuda")
        for op, rows in traffic.ops_per_job():
            data.trace.calls += cfgmod.kernel_calls(cfg, op, rows) * n_trace
    gc.enable()

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": cell["chips"],
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0}
    if traced:
        dev["busy_s"], dev["window_s"] = data.trace.busy_s, data.trace.window_s

    wanted = manifest.per_layer(man, cell_name) if traced else manifest.end_to_end(man, cell_name)
    metrics = {}
    for m in wanted:
        value = loader.module("metrics", m["name"].split(".")[0]).read(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check: the program's state is freed, the peak already read
    traffic.release()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = traffic.check(results, cfgmod.Reference(cfg, device))
    print(f"portbench: set-up {setup_s:.3f} s, window {window_s:.3f} s ({i} jobs), check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    failed = sum(v for name, (v, limit) in checks.items() if limit is not None)
    correct = all(v <= limit for v, limit in checks.values() if limit is not None)

    result = {"correct": correct, "attempted": len(results), "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = data.trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in checks.items()}
    return result, checks
