"""The metric readers on a recorded window: spans, counters and a trace."""
from types import SimpleNamespace

import pytest

from portbench import manifest, readers, trace

MS = 1_000_000
# a recorded 1-second window: two requests, each encrypt then decrypt
T0 = 10_000 * MS
SPANS = [("encrypt", T0, T0 + 300 * MS, 8), ("decrypt", T0 + 300 * MS, T0 + 500 * MS, 4),
         ("encrypt", T0 + 500 * MS, T0 + 800 * MS, 8), ("decrypt", T0 + 800 * MS, T0 + 1000 * MS, 4)]
EVENTS = [("lpn_ybits_kernel", T0 + 10 * MS, T0 + 14 * MS),
          ("lpn_ybits_kernel", T0 + 510 * MS, T0 + 514 * MS),
          ("sigma_slices_kernel", T0 + 12 * MS, T0 + 20 * MS),  # overlaps the first
          ("sigma_noise_kernel", T0 + 600 * MS, T0 + 601 * MS),
          ("Memcpy HtoD", T0 - 5 * MS, T0 + 1 * MS)]          # clipped to the window


def ctx(trace_on=True):
    summary = trace.summarize(EVENTS, T0, T0 + 1000 * MS, SPANS) if trace_on else None
    return SimpleNamespace(setup_seconds=12.5, window_s=1.0, units=8,
                           latencies_ms=[float(x) for x in range(1, 101)], spans=SPANS,
                           counters={"prf_cores": 240, "sigma_edges": 16384}, trace=summary)


def test_summarize():
    s = trace.summarize(EVENTS, T0, T0 + 1000 * MS, SPANS)
    assert s["busy_s"] == pytest.approx((1 + 10 + 4 + 1) / 1e3)
    assert s["window_s"] == pytest.approx(1.0)
    assert s["op_s"]["lpn_ybits_kernel"] == pytest.approx(0.008)
    assert s["op_s"]["Memcpy HtoD"] == pytest.approx(0.001)
    assert sum(s["idle_s"].values()) == pytest.approx(1.0 - s["busy_s"])
    assert set(s["idle_s"]) <= {"encrypt", "decrypt", "harness"}
    b = trace.breakdown(s)
    for key in ("device_ops", "idle_gaps"):
        secs = [sec for _, sec in b[key]]
        assert secs == sorted(secs, reverse=True) and len(secs) <= 10
    assert len(b["device_ops"]) == len(s["op_s"])
    assert all(n.startswith("idle in ") for n, _ in b["idle_gaps"])


def test_gap_labels():
    s = trace.summarize([("k", T0 + 400 * MS, T0 + 600 * MS)], T0, T0 + 1000 * MS, SPANS)
    # [0, 400) has its midpoint 200 in the first encrypt; [600, 1000) at 800 is
    # where the second encrypt ends and the decrypt starts: the later span
    assert s["idle_s"] == {"encrypt": pytest.approx(0.4), "decrypt": pytest.approx(0.4)}


@pytest.mark.parametrize("name,want", [
    ("enc.ct_per_s", 8.0), ("mul.ops_per_s", 8.0), ("rt_pairs_per_s", 8.0),
    ("enc_device_us_per_ct", 1e6 * 0.016 / 8), ("mul_device_us_per_op", 1e6 * 0.016 / 8),
    ("req_p95_ms", 95.05), ("setup_s", 12.5),
    ("rt.dec_ms_per_ct", 400 / 8), ("rt.mul_ms_per_op", None),
    ("enc.prf_cores_per_ct", 30.0), ("mul.sigma_edges_per_op", 2048.0),
    ("enc.idle_pct", 100 * (1 - 0.016)), ("mul.idle_pct", 100 * (1 - 0.016)),
    ("rt.idle_pct", 100 * (1 - 0.016)),
])
def test_reader(name, want):
    got = manifest.reader(name)(ctx())
    assert got == (None if want is None else pytest.approx(want))


def test_roofline_readers():
    peaks = manifest.peaks()
    a = manifest.roofline("lpn_ybits")
    want = 100 * max(240 * a["bytes_per_unit"] / peaks["hbm_bytes_per_s"],
                     240 * a["int_ops_per_unit"] / peaks["int32_ops_per_s"]) / 0.008
    assert manifest.reader("lpn_ybits_roofline")(ctx()) == pytest.approx(want)
    c = manifest.roofline("sigma")
    want = 100 * 16384 * c["int_ops_per_unit"] / peaks["int32_ops_per_s"] / 0.009
    assert manifest.reader("sigma_roofline")(ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["enc.idle_pct", "lpn_ybits_roofline", "sigma_roofline",
                                  "enc_device_us_per_ct", "mul_device_us_per_op"])
def test_trace_readers_silent_without_a_trace(name):
    assert manifest.reader(name)(ctx(trace_on=False)) is None


def test_readers_silent_without_work():
    empty = SimpleNamespace(setup_seconds=1.0, window_s=1.0, units=0, latencies_ms=[],
                            spans=[], counters={}, trace=None)
    for m in manifest.load()["end_to_end"] + manifest.load()["per_layer"]:
        v = manifest.reader(m["name"])(empty)
        assert v is None or m["name"] == "setup_s", m["name"]
