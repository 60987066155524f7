"""Profile a stretch of jobs and read the device's timeline in memory.

The stretch runs under ``torch.profiler`` (CPU and CUDA activities), inside
one range ``portbench.stretch`` and the benchmark's spans.  From the
profiler's events it takes every device operation (kernels, copies, sets)
inside the stretch: their union is the device's busy time, their sums by
name the device operations' times, and each gap between them is idle time,
named by the innermost benchmark span open on the host when it began.
Nothing is written to disk."""

from __future__ import annotations

import dataclasses

import torch

STRETCH = "portbench.stretch"
SPAN_LAYERS = ("tree", "host", "traffic")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: dict  # name -> seconds
    idle: dict  # host span -> [seconds, gaps]
    calls: list = dataclasses.field(default_factory=list)  # (roofline kernel, shape) of the traced jobs

    def kernel_seconds(self, names) -> float:
        return sum(s for op, s in self.device_ops.items() if any(n in op for n in names))

    def breakdown(self) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[name[:200], s] for name, s in ops],
                "idle_gaps": [[f"{label} ({n} gaps)", s] for label, (s, n) in gaps]}


def capture(traffic, spans, results: dict, start: int, n_jobs: int, cuda: bool) -> Trace:
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    spans.profiled = True
    with profile(activities=activities) as prof:
        with record_function(STRETCH):
            for i in range(start, start + n_jobs):
                with spans("traffic.inputs"):
                    inputs = traffic.inputs(i)
                results[i] = traffic.job(inputs, spans)
            if cuda:
                torch.cuda.synchronize()
    spans.profiled = False
    return parse(prof.profiler.kineto_results.events(), cuda)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def parse(events, cuda: bool) -> Trace:
    from torch.autograd import DeviceType

    stretch, host, dev = None, [], []
    for e in events:
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if name == STRETCH:
                stretch = (s, end)
            elif name.split(".")[0] in SPAN_LAYERS:
                host.append((s, end, name))
        elif not e.is_user_annotation() and end > s and name != STRETCH and name.split(".")[0] not in SPAN_LAYERS:
            dev.append((s, end, name))
    if stretch is None:
        raise RuntimeError(f"the profiler's events hold no {STRETCH} range")
    lo, hi = stretch
    ops, clipped = {}, []
    for s, e, name in dev:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            ops[name] = ops.get(name, 0.0) + (e - s) * 1e-9
            clipped.append((s, e))
    if cuda and not clipped:
        raise RuntimeError("the profiler's trace holds no device operation inside the traced stretch")
    busy = _union(clipped)
    idle, prev = {}, lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            open_spans = [h for h in host if h[0] <= prev < h[1]]
            label = max(open_spans)[2] if open_spans else "between spans"
            slot = idle.setdefault(label, [0.0, 0])
            slot[0] += (s - prev) * 1e-9
            slot[1] += 1
        prev = max(prev, e)
    return Trace(window_s=(hi - lo) * 1e-9, busy_s=sum(e - s for s, e in busy) * 1e-9,
                 device_ops=ops, idle=idle)
