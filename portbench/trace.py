"""The traced window: device activity from ``torch.profiler`` (CUDA
activity only, so host operations add nothing to the trace), reduced to
busy time, time per device operation and idle gaps named by the harness
span the host was in.  The profiler's timestamps are wall-clock
nanoseconds, the same base as ``time.time_ns``."""
from __future__ import annotations

from collections import defaultdict


def start():
    import torch

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every operation that ran on the card."""
    import torch

    prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, t0_ns: int, t1_ns: int, spans) -> dict:
    """Busy seconds, device seconds by operation name, and idle seconds by
    the host span the gap's midpoint falls in (``spans``: (name, start_ns,
    end_ns, units) on the same clock)."""
    clipped = [(n, max(s, t0_ns), min(e, t1_ns)) for n, s, e in events if e > t0_ns and s < t1_ns]
    busy = _union((s, e) for _, s, e in clipped)
    by_op = defaultdict(int)
    for n, s, e in clipped:
        by_op[n] += e - s
    gaps, prev = [], t0_ns
    for s, e in busy + [[t1_ns, t1_ns]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    ordered = sorted(spans, key=lambda sp: sp[1])
    idle = defaultdict(int)
    for gs, ge in gaps:
        mid, label = (gs + ge) // 2, "harness"
        for name, s, e, _ in ordered:
            if s > mid:
                break
            if e >= mid:
                label = name
        idle[label] += ge - gs
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (t1_ns - t0_ns) / 1e9,
            "n_events": len(clipped),
            "op_s": {n: ns / 1e9 for n, ns in by_op.items()},
            "idle_s": {n: ns / 1e9 for n, ns in idle.items()}}


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary["op_s"].items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(summary["idle_s"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[f"idle in {n}", s] for n, s in idle]}
