"""The readers of the program's stage counters (``ns.*`` in engine.stats)
on a hand-built window, and their silence on a program that keeps none."""
from types import SimpleNamespace

import pytest

from portbench import manifest

MS = 1_000_000
ENC = ("plan", "draw", "dispatch", "wait", "weights", "assemble")
MUL = ("layers", "cross", "dispatch", "assemble")
# two requests of 4 units each, 300 ms of the harness's span apiece; the
# program's call took 280 ms of each, its stages 10, 20, ... ms in all
SPANS = [("encrypt", 0, 300 * MS, 4), ("encrypt", 400 * MS, 700 * MS, 4),
         ("mul_batch", 0, 300 * MS, 4), ("mul_batch", 400 * MS, 700 * MS, 4)]
COUNTERS = {"ns.enc": 560 * MS, "ns.mul": 560 * MS, "prf_cores": 240,
            **{f"ns.enc.{s}": 10 * (i + 1) * MS for i, s in enumerate(ENC)},
            **{f"ns.mul.{s}": 10 * (i + 1) * MS for i, s in enumerate(MUL)}}


def ctx(counters=COUNTERS, spans=SPANS):
    return SimpleNamespace(setup_seconds=1.0, window_s=1.0, units=8, latencies_ms=[],
                           spans=spans, counters=counters, trace=None)


@pytest.mark.parametrize("name,want", [
    *[(f"enc.{s}_us_per_ct", 10e3 * (i + 1) / 8) for i, s in enumerate(ENC)],
    *[(f"mul.{s}_us_per_op", 10e3 * (i + 1) / 8) for i, s in enumerate(MUL)],
    # 600 ms of harness span less 560 ms in the program, over 8 units
    ("enc.drain_us_per_ct", 40e3 / 8), ("mul.drain_us_per_op", 40e3 / 8),
])
def test_stage_reader(name, want):
    assert manifest.reader(name)(ctx()) == pytest.approx(want)


@pytest.mark.parametrize("op,stages,unit", [("enc", ENC, "ct"), ("mul", MUL, "op")])
def test_stages_and_drain_add_to_the_harness_span(op, stages, unit):
    """When the stages tile the call, the metrics add to the harness's
    span a unit: here 600 ms over 8 units, less the stages' 10 ms gaps."""
    c = {**COUNTERS, f"ns.{op}": sum(COUNTERS[f"ns.{op}.{s}"] for s in stages)}
    got = sum(manifest.reader(f"{op}.{s}_us_per_{unit}")(ctx(c))
              for s in (*stages, "drain"))
    assert got == pytest.approx(600e3 / 8)


@pytest.mark.parametrize("name", [f"enc.{s}_us_per_ct" for s in (*ENC, "drain")]
                         + [f"mul.{s}_us_per_op" for s in (*MUL, "drain")])
def test_silent_on_a_program_without_stage_counters(name):
    """The parent of the stage spans keeps no ns.* counter: nothing is
    read and nothing raises."""
    assert manifest.reader(name)(ctx({"prf_cores": 240})) is None


@pytest.mark.parametrize("name", ["enc.drain_us_per_ct", "mul.drain_us_per_op"])
def test_drain_silent_without_the_harness_span(name):
    assert manifest.reader(name)(ctx(spans=[])) is None
