"""A whole run of each cell at small Params on the CPU, the look for a card
skipped: correct when sound, not correct under each fault the cell can have
(faults.py), and the control among them."""
import dataclasses
import time

import pytest

from portbench import faults, manifest, run

pv = pytest.importorskip("pvac_hfhe_cppbyv_tpu_torch")
MAN = manifest.load()
CELL_FAULTS = {
    "enc-bulk": ["control", "answer_altered", "state_unchanged", "half_batch", "sigma_zero"],
    "mul-eval": ["control", "answer_altered", "state_unchanged", "half_batch", "sigma_zero"],
    "roundtrip-d1": ["control", "answer_altered", "state_unchanged", "half_batch"],
}
# cells whose loop and check are built but which the manifest leaves out
# while their runs spread too widely for a bound (PERF.md, section 7)
OUTSIDE = {"roundtrip-d1": {"name": "roundtrip-d1", "config": "split-default",
                            "traffic": "roundtrip_d1", "chips": 1}}


def small_run(cell_name, tamper=None, seed=2**31 + 7):
    cell = OUTSIDE.get(cell_name) or manifest.cell(MAN, cell_name)
    config = manifest.config(MAN, cell["config"])
    config["params"] = dataclasses.asdict(pv.small_test_params())
    mix = manifest.traffic(cell["traffic"])
    mix["size"] = {"min": 1, "max": 2, "levels": 2}
    if mix.get("pool"):
        mix["pool"] = 6
    return run.run_cell(cell, config, mix, manifest.metrics_for(MAN, cell_name, False), seed,
                        0.05, False, device="cpu", tamper=tamper,
                        t_start=time.perf_counter_ns())


@pytest.mark.parametrize("cell_name", list(CELL_FAULTS))
def test_sound_run_is_correct(cell_name):
    res = small_run(cell_name)
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks" and res["checks"]["mismatched"]["value"] == 0
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell_name,fault", [(c, f) for c, fs in CELL_FAULTS.items()
                                             for f in fs])
def test_fault_is_caught(cell_name, fault):
    res = small_run(cell_name, tamper=faults.FAULTS[fault])
    assert not res["correct"], res["checks"]
