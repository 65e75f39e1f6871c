"""Profiling / tracing helpers (the reference's ad-hoc chrono
micro-benchmarks, tests/test_main.cpp:137-143).

- :func:`bench_us`: median-of-reps wall time of a thunk; where this
  process has used a CUDA device, each call ends with
  ``torch.cuda.synchronize()`` so the time covers the device work.
- :func:`trace`: context manager around ``torch.profiler`` writing a
  Chrome trace (``trace.json``) into a directory, with the port's stage
  spans (``tracing.span``) in it as ranges on the kernels' clock.
- :func:`op_report`: timing table for the standard op set of a keypair.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


def bench_us(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median wall time of fn() in microseconds."""

    def run_once():
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    for _ in range(warmup):
        run_once()
    times = sorted(run_once() for _ in range(reps))
    return times[len(times) // 2]


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the block (CPU activity, and CUDA where a
    card is present), written to ``logdir/trace.json`` for
    chrome://tracing or Perfetto.  The span log records for the block
    (``tracing.recording``; ``tracing.spans()`` reads it after), and each
    stage span is a ``record_function`` range of the trace."""
    from torch.profiler import ProfilerActivity, profile

    from .. import tracing

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof, tracing.recording(profile=True):
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def op_report(pk, sk, batch: int = 8) -> dict:
    """Timing table (µs/op) for the core op set; returns a dict and prints
    a small table."""
    from ..ops.arithmetic import ct_add, ct_mul_batch
    from ..ops.decrypt import dec_value_batch
    from ..ops.encrypt import enc_value_batch

    out = {}
    cts = enc_value_batch(pk, sk, list(range(batch)))  # warm
    out["enc_value_us"] = bench_us(
        lambda: enc_value_batch(pk, sk, list(range(batch)))) / batch
    out["dec_value_us"] = bench_us(
        lambda: dec_value_batch(pk, sk, cts)) / batch
    out["ct_add_us"] = bench_us(lambda: ct_add(pk, cts[0], cts[1]))
    pairs = [(cts[i], cts[(i + 1) % batch]) for i in range(batch)]
    ct_mul_batch(pk, pairs[:1])  # warm
    out["ct_mul_us"] = bench_us(lambda: ct_mul_batch(pk, pairs)) / batch
    for k, v in out.items():
        print(f"  {k:16s} {v:12.1f}")
    return out
