"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files that the harness finds by that name."""
import dataclasses
import json
import re

import pytest

from portbench import manifest

MAN = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]
E2E = {m["name"]: m for m in MAN["end_to_end"]}


def cells_of(m):
    return m.get("workloads", [w["name"] for w in MAN["workloads"]])


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"] and MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_and_units():
    names = [x["name"] for x in MAN["configs"] + MAN["workloads"] + METRICS]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in MAN["workloads"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for c in MAN["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for text in ([c["source"] for c in MAN["configs"]] + [x["why"] for x in
                 MAN["configs"] + MAN["workloads"]] + [m["layer"] for m in MAN["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_enough():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_for(MAN, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert manifest.metrics_for(MAN, w["name"], True), w["name"]
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in E2E["setup_s"]


def test_moves_names_a_metric_of_the_same_cells():
    for m in MAN["per_layer"]:
        target = E2E[m["moves"]]
        assert set(cells_of(m)) <= set(cells_of(target)), m["name"]


def test_roofline_names():
    for m in METRICS:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
            assert m["name"].split(".")[0].endswith("_roofline")
            manifest.roofline(m["name"].split(".")[0][: -len("_roofline")])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    assert callable(manifest.reader(m["name"]))


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    config = manifest.config(MAN, w["config"])
    mix = manifest.traffic(w["traffic"])
    assert config["name"] == w["config"]
    assert manifest.loop(mix["loop"]).Loop and manifest.loop(mix["loop"]).judge
    assert {"failed", "mismatched"} <= set(mix["check"]["limits"])
    pairs = [(x["config"], x["traffic"]) for x in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith("portbench/configs/")
    cfg = json.loads((manifest.ROOT / c["file"]).read_text())
    assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert all(k in cfg for k in c["reduced"])
    import pvac_hfhe_cppbyv_tpu_torch as pv

    # the reference's default Params, uncut: no key of them is reduced
    assert cfg["params"] == dataclasses.asdict(pv.Params())


def test_run_py_names_no_cell_config_or_metric():
    text = (manifest.HERE / "run.py").read_text()
    named = ([x["name"] for x in MAN["configs"] + MAN["workloads"] + METRICS]
             + [w["traffic"] for w in MAN["workloads"]])
    found = [n for n in named
             if re.search(r"(?<![A-Za-z0-9_.-])" + re.escape(n) + r"(?![A-Za-z0-9_-])", text)]
    assert found == []
