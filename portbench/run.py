"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell, its configuration (``configs/``),
its traffic mix (``traffic/``) and its metrics (``metrics/``) are found by
the names in ``BENCHMARK.json``.  One run is one process: set-up (imports,
CUDA context, the kernel library, keys, the mix's pool, one warm request
at the mix's largest size), then a closed loop of one caller for S seconds
(the last request issued in time runs to its end and the window with it),
then the check against the plain reference, with the program's state
freed.  With ``--trace 1`` the window runs under ``torch.profiler`` and the
per-layer metrics are reported instead of the end-to-end ones; a run whose
metrics read the device trace runs its window under the profiler either way.

The last line of standard output is the result JSON; the numbers the check
compared, each beside its limit, are the last lines of standard error and
the result's last key.  Without a CUDA card, or without enough of them,
the run exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter_ns()

import argparse  # noqa: E402
import gc  # noqa: E402
import resource  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from contextlib import contextmanager  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import generator, manifest, trace  # noqa: E402
from portbench.reference import scheme  # noqa: E402

PROGRAM = "pvac_hfhe_cppbyv_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "pvac_hfhe_cppbyv_tpu"}


class NoCard(Exception):
    pass


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's name only begins with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def look_for_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}")


def by_fifth(done: list[tuple[int, int]], t0: int, t1: int) -> list[float]:
    """Units a second completed in each fifth of the window, by the time
    each request ended: whether a run is slow all through or in bursts."""
    step = (t1 - t0) / 5
    units = [0] * 5
    for end, u in done:
        units[min(4, int((end - t0) / step))] += u
    return [round(u / (step / 1e9), 1) for u in units]


def power_limit() -> str | None:
    import subprocess

    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip() or None


class Window:
    """The closed loop of one caller, and the harness spans inside it."""

    def __init__(self):
        self.spans = []  # (name, start_ns, end_ns, units), perf_counter clock

    @contextmanager
    def span(self, name: str, units: int):
        t = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t, time.perf_counter_ns(), units))

    def run(self, loop, reqs, seconds: float) -> SimpleNamespace:
        lat, kept, done, units, attempted, failed = [], [], [], 0, 0, 0
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter_ns()
        deadline = t0 + int(seconds * 1e9)
        for req in reqs:
            if time.perf_counter_ns() >= deadline:
                break
            attempted += 1
            ts = time.perf_counter_ns()
            try:
                u, k = loop.run(req, self.span)
            except Exception:  # a failed request is counted; the caller goes on
                failed += 1
                if failed <= 3:
                    print(f"request {attempted} failed:\n{traceback.format_exc()}",
                          file=sys.stderr)
            else:
                units += u
                kept.extend(k)
                done.append((time.perf_counter_ns(), u))
            lat.append((time.perf_counter_ns() - ts) / 1e6)
        t1 = time.perf_counter_ns()
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        host = {"user_s": ru1.ru_utime - ru0.ru_utime, "sys_s": ru1.ru_stime - ru0.ru_stime,
                "involuntary_switches": ru1.ru_nivcsw - ru0.ru_nivcsw,
                "rate_by_fifth": by_fifth(done, t0, t1)}
        return SimpleNamespace(t0=t0, t1=t1, latencies_ms=lat, kept=kept, units=units,
                               attempted=attempted, failed=failed, host=host)


def counters(dep) -> dict:
    """The program's own counters: engine.stats summed over the engines,
    and kernel launches by name."""
    from pvac_hfhe_cppbyv_tpu_torch import kernels

    out = {}
    for eng in dep.engines():
        for k, v in eng.stats.items():
            out[k] = out.get(k, 0) + v
    for k, v in kernels.LAUNCHES.items():
        out[f"launches.{k}"] = v
    return out


def run_cell(cell: dict, config: dict, mix: dict, metrics: list[dict], seed: int,
             seconds: float, trace_on: bool, device: str = "cuda", tamper=None,
             t_start: int = T_START) -> dict:
    """Set up, measure, check.  ``tamper(dep)``, for the control and the
    fault tests only, breaks the program under the harness after set-up,
    for the window."""
    import torch

    from portbench import deploy

    loop_mod = manifest.loop(mix["loop"])
    dep = deploy.build(config, device)
    loop = loop_mod.Loop(dep, mix, seed)
    loop.run(generator.warm_request(mix, seed), Window().span)
    dep.sync()
    if tamper is not None:
        tamper(dep)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    c0 = counters(dep)
    win = Window()
    setup_seconds = (time.perf_counter_ns() - t_start) / 1e9
    profiled = trace_on or any(m["source"] == "device_trace" for m in metrics)
    prof = trace.start() if profiled and device != "cpu" else None
    wall_off = time.time_ns() - time.perf_counter_ns()
    res = win.run(loop, generator.requests(mix, seed), seconds)
    events = trace.device_events(prof) if prof is not None else None
    c1 = counters(dep)
    window_s = (res.t1 - res.t0) / 1e9
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    key_material, params = dep.key_material(), dep.params
    del loop, dep
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    key = scheme.Key(key_material["prf_k"], key_material["lpn_s_words"],
                     key_material["canon_tag"], key_material["g"], params)
    numbers = loop_mod.judge(res.kept, key, device, params)
    numbers["failed"] = res.failed
    ref_s = time.perf_counter() - t_ref
    limits = mix["check"]["limits"]
    checks = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    correct = (res.attempted > 0 and res.failed == 0 and numbers.get("checked", 1) > 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))

    summary = None
    if events is not None:
        spans = [(n, s + wall_off, e + wall_off, u) for n, s, e, u in win.spans]
        summary = trace.summarize(events, res.t0 + wall_off, res.t1 + wall_off, spans)
    ctx = SimpleNamespace(setup_seconds=setup_seconds, window_s=window_s, units=res.units,
                          latencies_ms=res.latencies_ms, spans=win.spans,
                          counters={k: c1[k] - c0.get(k, 0) for k in c1}, trace=summary)
    out_metrics = {}
    for m in metrics:
        v = manifest.reader(m["name"])(ctx)
        if v is not None:
            out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev_info = {"platform": "gpu" if device != "cpu" else "cpu",
                "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
                "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": res.attempted, "failed": res.failed,
              "metrics": out_metrics, "device": dev_info}
    if summary is not None and trace_on:
        dev_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = trace.breakdown(summary)
    print(f"units {res.units} in {window_s:.3f} s; setup {setup_seconds:.3f} s; "
          f"reference {ref_s:.3f} s over {numbers.get('checked')} answers; "
          f"counters {ctx.counters}; host in the window {res.host}", file=sys.stderr)
    if summary is not None:
        print(f"trace: {summary['n_events']} device events, busy {summary['busy_s']:.6f} s "
              f"of {summary['window_s']:.6f} s; power limit: {power_limit()}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None, tamper=None) -> int:
    args = parse(argv)
    try:
        man = manifest.load()
        cell = manifest.cell(man, args.workload)
        config = manifest.config(man, cell["config"])
        mix = manifest.traffic(cell["traffic"])
        metrics = manifest.metrics_for(man, cell["name"], bool(args.trace))
        if not (ROOT / PROGRAM).is_dir():
            raise manifest.ManifestError(f"the program {PROGRAM} is not in {ROOT}")
    except (manifest.ManifestError, OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    try:
        look_for_cards(cell["chips"])
    except NoCard as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 3
    result = run_cell(cell, config, mix, metrics, args.seed, args.seconds, bool(args.trace),
                      tamper=tamper)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: no result: modules loaded that the port must not use: {bad}",
              file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
