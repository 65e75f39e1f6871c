"""The encrypted-analytics cell ``svc-circuits`` on the CPU, the look for a
card skipped: at small Params with B = 19 and a small edge budget, a mix cut
to 16 pairs, 2 rows and 4 samples from a pool of 64, so that the dot
product still crosses the budget; a whole run is correct when sound and not
correct under each fault (faults.py), and its readers read what the
program counts."""
import dataclasses
import time
from types import SimpleNamespace

import pytest

from portbench import deploy, faults, generator, manifest, run
from portbench.loops import circuits
from portbench.reference import scheme

pv = pytest.importorskip("pvac_hfhe_cppbyv_tpu_torch")
MAN = manifest.load()
CELL = manifest.cell(MAN, "svc-circuits")
SEED = 2**35 + 19
READERS = ("circ.idle_pct", "circ.sigma_edges_per_op", "circ.sum_us_per_op",
           "circ.compact_us_per_op", "circ.sigma_host_mb_per_op", "circ.compact_merged_pct")
# the products' metrics of mul-eval, read in this cell too (in BENCHMARK.json's order)
MUL_METRICS = ["sigma_roofline", "mul.layers_us_per_op", "mul.cross_us_per_op",
               "mul.dispatch_us_per_op", "mul.assemble_us_per_op", "mul.sigma_fused_pct",
               "mul.sigma_banked_pct"]


def small_config():
    config = manifest.config(MAN, CELL["config"])
    config["params"] = dataclasses.asdict(dataclasses.replace(
        pv.small_test_params(), B=19, edge_budget=2000))
    return config


def small_mix():
    mix = manifest.traffic(CELL["traffic"])
    mix.update(pool=64, rows=2, samples=4, size=dict(mix["size"], min=16, max=16))
    return mix


def small_run(tamper=None):
    return run.run_cell(CELL, small_config(), small_mix(),
                        manifest.metrics_for(MAN, CELL["name"], False), SEED, 0.05, False,
                        device="cpu", tamper=tamper, t_start=time.perf_counter_ns())


def test_sound_run_is_correct():
    res = small_run()
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["mismatched"]["value"] == 0
    assert res["checks"]["sigma_density_dev"]["value"] <= 0.3
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("fault", ["control", "answer_altered"])
def test_altered_answers_are_mismatched(fault):
    res = small_run(tamper=faults.FAULTS[fault])
    assert not res["correct"] and res["checks"]["mismatched"]["value"] > 0, res["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "sigma_zero"])
def test_fault_is_caught(fault):
    res = small_run(tamper=faults.FAULTS[fault])
    assert not res["correct"], res["checks"]


def test_loop_keeps_every_request_and_samples_the_reference():
    """Every request's plaintexts and decryptions are kept; the first
    request's records go to the reference and are right, the second's
    (record_every 2) are not kept; the dot product crossed the budget."""
    mix = small_mix()
    mix["check"] = dict(mix["check"], record_every=2)
    dep = deploy.build(small_config(), "cpu")
    loop = circuits.Loop(dep, mix, SEED)
    assert loop.run(generator.warm_request(mix, SEED), run.Window().span) == (21, [])
    reqs = generator.requests(mix, SEED)
    kept = []
    for _ in range(2):
        units, k = loop.run(next(reqs), run.Window().span)
        assert units == 16 + 4 + 1
        kept += k
    x, y, rows, samples, out, recs, sig = kept[0]
    assert len(x) == len(y) == 16 and len(rows) == 2 and samples == 4
    assert out == circuits.plain(x, y, rows, samples) and len(out) == 5
    assert len(recs) == 4 and sig.shape[0] == 64 and kept[1][5] is None
    assert len(recs[0]["w"]) > 2000  # the dot product's root sum passed the budget
    km = dep.key_material()
    key = scheme.Key(km["prf_k"], km["lpn_s_words"], km["canon_tag"], km["g"], dep.params)
    got = circuits.judge(kept, key, "cpu", dep.params)
    assert got["checked"] == 1 and got["requests"] == 2 and got["mismatched"] == 0
    rec = dict(recs[3], w=recs[3]["w"].copy())
    rec["w"][0, 0] ^= 1
    bad = [kept[0][:5] + ([*recs[:3], rec], sig)] + kept[1:]
    assert circuits.judge(bad, key, "cpu", dep.params)["mismatched"] == 1


def test_manifest_finds_the_cell():
    config = manifest.config(MAN, CELL["config"])
    mix = manifest.traffic(CELL["traffic"])
    assert CELL["chips"] == 1 and config["deployment"] == "split"
    assert config["params"] == manifest.config(MAN, "split-default")["params"]
    assert set(config["guarantees"]) == {"exact", "sigma", "circuits"}
    a = config["assumed"]
    assert (a["vector_length"], config["matvec_rows"], a["variance_samples"]) == (
        generator.levels(mix["size"])[0], mix["rows"], mix["samples"]) == (1024, 8, 32)
    assert mix["pool"] == 4096 and manifest.loop(mix["loop"]) is circuits
    names = [m["name"] for m in manifest.metrics_for(MAN, CELL["name"], True)]
    assert names == MUL_METRICS + list(READERS)
    for name in READERS:
        assert callable(manifest.reader(name))
    e2e = [m["name"] for m in manifest.metrics_for(MAN, CELL["name"], False)]
    assert e2e == ["mul_device_us_per_op", "setup_s"]


def _ctx(**kw):
    base = dict(setup_seconds=1.0, window_s=50.0, units=2114, latencies_ms=[], spans=[],
                counters={}, trace=None)
    return SimpleNamespace(**{**base, **kw})


def test_readers_on_a_synthetic_window():
    counters = {"sigma_edges": 2114 * 1212, "ns.sum": 2114 * 5000, "ns.compact_edges": 2114 * 3000,
                "sigma.host_bytes": 2114 * 2_500_000, "compact.edges": 4000,
                "compact.buckets": 3000}
    ctx = _ctx(counters=counters, trace={"busy_s": 5.0, "window_s": 50.0, "op_s": {}})
    got = {n: manifest.reader(n)(ctx) for n in READERS}
    assert got == pytest.approx({"circ.idle_pct": 90.0, "circ.sigma_edges_per_op": 1212.0,
                                 "circ.sum_us_per_op": 5.0, "circ.compact_us_per_op": 3.0,
                                 "circ.sigma_host_mb_per_op": 2.5,
                                 "circ.compact_merged_pct": 25.0})
    still = _ctx(counters={"compact.edges": 10, "compact.buckets": 10, "sigma.host_bytes": 0})
    assert manifest.reader("circ.compact_merged_pct")(still) == 0.0
    assert manifest.reader("circ.sigma_host_mb_per_op")(still) == 0.0
    # a program without the spans and counters (the parent's) reads nothing
    assert all(manifest.reader(n)(_ctx()) is None for n in READERS)
