"""Arithmetic that the metric readers share.  A reader that finds nothing
to read returns None, and the harness leaves that metric out."""
from __future__ import annotations

import numpy as np

from . import manifest


def rate(ctx) -> float | None:
    """All the units of the window over the whole window."""
    return ctx.units / ctx.window_s if ctx.units and ctx.window_s > 0 else None


def percentile_ms(ctx, q: float) -> float | None:
    return float(np.percentile(ctx.latencies_ms, q)) if ctx.latencies_ms else None


def span_ms_per_unit(ctx, name: str) -> float | None:
    sp = [s for s in ctx.spans if s[0] == name]
    units = sum(s[3] for s in sp)
    return sum(s[2] - s[1] for s in sp) / 1e6 / units if units else None


def counter_per_unit(ctx, key: str) -> float | None:
    n = ctx.counters.get(key)
    return n / ctx.units if n and ctx.units else None


def idle_pct(ctx) -> float | None:
    t = ctx.trace
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def device_us_per_unit(ctx) -> float | None:
    """The card's busy time in the window (the union of its kernels and
    copies) per unit of the window's work."""
    t = ctx.trace
    if not t or t["busy_s"] <= 0 or not ctx.units:
        return None
    return 1e6 * t["busy_s"] / ctx.units


def device_s(ctx, ops: list[str]) -> float:
    return sum(s for n, s in ctx.trace["op_s"].items() if any(o in n for o in ops))


def bound_s(spec: dict, units: float, peaks: dict) -> float:
    """The least time the card could take for ``units`` of the kernel's
    work: the larger of its bytes over the memory rate and its integer
    operations over their peak rate."""
    return max(units * spec["bytes_per_unit"] / peaks["hbm_bytes_per_s"],
               units * spec["int_ops_per_unit"] / peaks["int32_ops_per_s"])


def roofline_pct(ctx, kernel: str) -> float | None:
    """The kernel's share of its roofline over the traced window: the
    bound for the window's units (an engine counter) over the kernel's
    device time."""
    if not ctx.trace:
        return None
    spec = manifest.roofline(kernel)
    units = ctx.counters.get(spec["counter"])
    t = device_s(ctx, spec["device_ops"])
    if not units or t <= 0:
        return None
    return 100.0 * bound_s(spec, units, manifest.peaks()) / t
