"""The port's stage spans on the card: what a span costs, how many a
request makes, and whether the span log's clock agrees with the profiler's
device events.

    python3 stage_check.py [--seconds S] [--seed N]

From the root of a checkout, on a machine with a CUDA card.  It prints

- the host cost of one span (``tracing.span``), new and reused, with the
  span log off and on;
- the host cost of ``ct_mul_batch``'s work counting (``tracing.count``
  and the span around compaction) a product, at the mul-eval cell's mean
  products a call, and its share of that cell's host time a product;
- for each of the benchmark's cells ``enc-bulk`` and ``mul-eval``
  (BENCHMARK.json, portbench/): a window of S seconds of the cell's
  traffic with the span log on and the profiler set up as the benchmark
  sets it up (CUDA activity only), and from it the spans a unit, the
  ``ns.*`` stage counters a unit, the caller's time a unit outside the
  harness's spans, how far the profiler's clock and the host's disagree
  (100 one-word copies from the card before and after the window, each
  timed on the host), the share of ``Memcpy DtoH`` device events that
  end inside an ``enc.wait`` span, and the window's idle time
  by the program stage its midpoint falls in
  (``portbench.trace.summarize`` fed with ``tracing.spans()``).

Its last line is the JSON of all of it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import deploy, generator, manifest, trace
from portbench.run import Window
from pvac_hfhe_cppbyv_tpu_torch import tracing

CELLS = ("enc-bulk", "mul-eval")


def span_cost_ns(reps: int = 200_000) -> dict:
    """Host ns of one span over an empty block, less the empty loop's."""
    class Engine:
        stats = {}

    class Key:
        _engine = Engine()

    key = Key()

    def per_rep(body) -> float:
        t = time.perf_counter_ns()
        body()
        return (time.perf_counter_ns() - t) / reps

    def empty():
        for _ in range(reps):
            pass

    def new():
        for _ in range(reps):
            with tracing.span(key, "x"):
                pass

    def reused():
        s = tracing.span(key, "x")
        for _ in range(reps):
            with s:
                pass

    out = {}
    for log in ("off", "on"):
        for name, body in (("new", new), ("reused", reused)):
            base = min(per_rep(empty) for _ in range(3))
            if log == "on":
                with tracing.recording():
                    t = min(per_rep(body) for _ in range(3))
            else:
                t = min(per_rep(body) for _ in range(3))
            out[f"{name}_log_{log}"] = t - base
    return out


def count_cost_ns(products: int, reps: int = 20_000) -> dict:
    """Host ns of ct_mul_batch's work counting for one call of ``products``
    products, less the empty loop's: the span around compaction (new each
    call), the per-product statements it adds (the layer tally around
    compaction, the route and pair tallies) on ciphertexts of the mul-eval
    cell's size, and one ``tracing.count`` of the call's counters: a
    mirror of the statements in ``ops/arithmetic.ct_mul_batch``."""
    from pvac_hfhe_cppbyv_tpu_torch.types import Cipher

    class Engine:
        stats = {}

    class Key:
        _engine = Engine()

    key = Key()
    n = 1212
    cts = [Cipher([None] * 8, np.zeros(n, np.int32), np.zeros(n, np.int32),
                  np.zeros(n, np.int8), np.zeros((n, 4), np.uint32), np.zeros((n, 0), np.uint32))
           for _ in range(products)]
    staged = [{"route": "native", "pairs": n * n} for _ in range(products)]

    def empty():
        for _ in range(reps):
            for C in cts:
                pass

    def counting():
        for _ in range(reps):
            with tracing.span(key, "mul.assemble.compact"):
                dropped = 0
                for C in cts:
                    n_layers = C.n_layers
                    dropped += n_layers - C.n_layers
            routes = [st["route"] for st in staged]
            counts = {f"mul.route.{r}": routes.count(r) for r in set(routes)}
            counts["mul.pairs"] = sum([st["pairs"] for st in staged])
            counts["mul.layers_dropped"] = dropped
            tracing.count(key, counts)

    def per_rep(body) -> float:
        t = time.perf_counter_ns()
        body()
        return (time.perf_counter_ns() - t) / reps

    call = min(per_rep(counting) for _ in range(3)) - min(per_rep(empty) for _ in range(3))
    return {"products_a_call": products, "ns_a_call": call, "ns_a_product": call / products}


def within(t: int, spans: list) -> bool:
    return any(s <= t <= e for s, e in spans)


def copies_from_card(n: int = 100) -> list[tuple[int, int]]:
    """Host perf_counter (start, end) of n synchronous 4-byte copies from
    the card: each is one ``Memcpy DtoH`` the profiler must place inside
    its host interval if the two clocks agree."""
    x = torch.zeros(1, device="cuda")
    out = []
    for _ in range(n):
        t = time.perf_counter_ns()
        x.cpu()
        out.append((t, time.perf_counter_ns()))
    return out


def lead_us(host: list, dev: list, wall_off: int) -> dict:
    """How long before the host saw each copy finish the profiler says it
    finished (host end less device end; negative: the device clock runs
    ahead of the host's), as the median and the range."""
    leads = sorted((h1 + wall_off - e) / 1e3 for (_, h1), (_, e) in zip(host, dev))
    return {"median": leads[len(leads) // 2], "min": leads[0], "max": leads[-1]}


def cell_window(cell_name: str, seed: int, seconds: float, device: str = "cuda") -> dict:
    """One window of the cell's traffic with the span log on, read as the
    module's docstring says."""
    man = manifest.load()
    cell = manifest.cell(man, cell_name)
    config = manifest.config(man, cell["config"])
    mix = manifest.traffic(cell["traffic"])
    dep = deploy.build(config, device)
    loop = manifest.loop(mix["loop"]).Loop(dep, mix, seed)
    loop.run(generator.warm_request(mix, seed), Window().span)
    dep.sync()
    c0 = {k: v for e in dep.engines() for k, v in e.stats.items()}
    prof = trace.start() if device != "cpu" else None
    wall_off = time.time_ns() - time.perf_counter_ns()
    before = copies_from_card() if prof is not None else []
    win = Window()
    with tracing.recording():
        res = win.run(loop, generator.requests(mix, seed), seconds)
    after = copies_from_card() if prof is not None else []
    events = trace.device_events(prof) if prof is not None else []
    recs = tracing.spans()
    c1 = {k: v for e in dep.engines() for k, v in e.stats.items()}
    t0, t1 = res.t0 + wall_off, res.t1 + wall_off
    units = res.units
    stages = {k: (v - c0.get(k, 0)) / 1e3 / units for k, v in c1.items()
              if k.startswith("ns.") and v > c0.get(k, 0)}
    in_harness = sum(e - s for _, s, e, _ in win.spans) / 1e3 / units
    waits = [(r.start, r.end) for r in recs if r.name == "enc.wait"]
    calls = [(r.start, r.end) for r in recs if r.parent == -1]
    all_dtoh = sorted((s, e) for n, s, e in events if "DtoH" in n)
    clock = ({"before_window": lead_us(before, all_dtoh[:len(before)], wall_off),
              "after_window": lead_us(after, all_dtoh[-len(after):], wall_off)}
             if events else None)
    dtoh = [e for n, _, e in events if "DtoH" in n and t0 <= e <= t1]
    in_call = [e for e in dtoh if within(e, calls)]
    summary = trace.summarize(events, t0, t1, [(r.name, r.start, r.end, r.units)
                                               for r in recs]) if events else None
    return {"cell": cell_name, "units": units, "window_s": (res.t1 - res.t0) / 1e9,
            "failed": res.failed, "host_us_per_unit": (res.t1 - res.t0) / 1e3 / units,
            "spans_per_unit": len(recs) / units, "stage_us_per_unit": stages,
            # the caller's time a unit outside the harness's own spans
            "harness_own_us_per_unit": (res.t1 - res.t0) / 1e3 / units - in_harness,
            "copy_lead_us": clock,
            "dtoh": len(dtoh), "dtoh_in_a_call": len(in_call),
            "dtoh_in_enc_wait": sum(within(e, waits) for e in dtoh),
            "busy_s": summary and summary["busy_s"],
            "idle_s_by_stage": summary and dict(sorted(summary["idle_s"].items(),
                                                       key=lambda kv: -kv[1]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=20261018)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_check: no CUDA card", file=sys.stderr)
        return 3
    out = {"card": torch.cuda.get_device_name(0), "span_cost_ns": span_cost_ns()}
    print(f"span cost (ns): {out['span_cost_ns']}", flush=True)
    # products a mul_batch call: the mean of the mul-eval mix's size levels
    lv = generator.levels(manifest.traffic("mul_d1")["size"])
    out["count_cost_ns"] = count_cost_ns(round(sum(lv) / len(lv)))
    print(f"work counting cost (ns): {out['count_cost_ns']}", flush=True)
    out["cells"] = []
    for name in CELLS:
        r = cell_window(name, args.seed, args.seconds)
        if name == "mul-eval":
            r["count_share_of_host_pct"] = (100 * out["count_cost_ns"]["ns_a_product"] / 1e3
                                            / r["host_us_per_unit"])
        out["cells"].append(r)
        print(json.dumps(r, indent=1), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
