"""The depth-3 cell ``deep-d3`` at small Params on the CPU, the look for a
card skipped: a whole run is correct when sound and not correct under each
fault (faults.py); its loop keeps the reference's sample and counts both
kinds of disagreement.

B = 19 divides p - 1 and keeps the chain's last product at 9728 edges
(172,544 at B = 337), so a chain's σ, on the plain twins, takes seconds."""
import dataclasses
import time

import numpy as np
import pytest

from portbench import deploy, faults, generator, manifest, run
from portbench.loops import square
from portbench.reference import scheme

pv = pytest.importorskip("pvac_hfhe_cppbyv_tpu_torch")
MAN = manifest.load()
CELL = manifest.cell(MAN, "deep-d3")
SEED = 2**33 + 17


def small_config():
    config = manifest.config(MAN, CELL["config"])
    config["params"] = dataclasses.asdict(dataclasses.replace(pv.small_test_params(), B=19))
    return config


def small_run(tamper=None):
    return run.run_cell(CELL, small_config(), manifest.traffic(CELL["traffic"]),
                        manifest.metrics_for(MAN, CELL["name"], False), SEED, 0.05, False,
                        device="cpu", tamper=tamper, t_start=time.perf_counter_ns())


def test_sound_run_is_correct():
    res = small_run()
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["mismatched"]["value"] == 0
    assert res["checks"]["sigma_density_dev"]["value"] <= 0.3
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("fault", ["control", "answer_altered", "state_unchanged",
                                   "half_batch", "sigma_zero"])
def test_fault_is_caught(fault):
    res = small_run(tamper=faults.FAULTS[fault])
    assert not res["correct"], res["checks"]


def test_config_depth_is_the_mix_steps():
    config = manifest.config(MAN, CELL["config"])
    mix = manifest.traffic(CELL["traffic"])
    assert config["depth"] == mix["steps"] == 3
    assert "depth" in config["reduced"] and config["source_values"]["depth"] > config["depth"]
    assert generator.levels(mix["size"]) == [1]


def test_reference_checks_a_final_ciphertext_and_both_disagreements_count():
    """The first chain's final ciphertext goes to the reference, the next
    one (record_every > 1) does not; an altered record is a mismatch even
    where the chain's own decryption is right."""
    mix = manifest.traffic(CELL["traffic"])
    dep = deploy.build(small_config(), "cpu")
    loop = square.Loop(dep, mix, SEED)
    assert loop.run(generator.warm_request(mix, SEED), run.Window().span) == (3, [])
    reqs = generator.requests(mix, SEED)
    kept = []
    for _ in range(2):
        units, k = loop.run(next(reqs), run.Window().span)
        assert units == 3
        kept += k
    km = dep.key_material()
    key = scheme.Key(km["prf_k"], km["lpn_s_words"], km["canon_tag"], km["g"], dep.params)
    got = square.judge(kept, key, "cpu", dep.params)
    assert got["checked"] == 1 and got["chains"] == 2 and got["mismatched"] == 0
    v, steps, out, rec, sig = kept[0]
    assert out == pow(v, 8, scheme.P) and rec is not None and sig.shape[0] == 64
    assert kept[1][3] is None
    rec = dict(rec, w=np.array(rec["w"]))
    rec["w"][0, 0] ^= 1
    got = square.judge([(v, steps, out, rec, sig)] + kept[1:], key, "cpu", dep.params)
    assert got["mismatched"] == 1
