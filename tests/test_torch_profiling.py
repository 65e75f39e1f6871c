"""The port's profiling helpers (utils/profiling.py) on the CPU: bench_us
returns the median of its timed calls and lets an exception through,
trace writes a Chrome trace, and op_report returns its four timings."""
import json

import pytest
import torch

import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch.utils import profiling

torch.set_num_threads(2)


def test_bench_us_returns_the_median(monkeypatch):
    """A clock that each call of fn moves by the next duration: the warm-up
    call is not counted, and the median of the five timed calls is."""
    now = [0.0]
    durations = iter([1.0, 0.004, 0.001, 0.009, 0.002, 0.003])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: now[0])

    def fn():
        now[0] += next(durations)

    assert profiling.bench_us(fn, reps=5, warmup=1) == pytest.approx(3000.0, abs=1e-6)


def test_bench_us_lets_an_exception_through():
    def fn():
        raise ZeroDivisionError("boom")

    with pytest.raises(ZeroDivisionError, match="boom"):
        profiling.bench_us(fn, reps=2, warmup=0)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.arange(64).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in ev.get("name", "") for ev in events)


def test_op_report_returns_four_timings(capsys):
    pk, sk = tpv.keygen(tpv.small_test_params(), device="cpu")
    out = profiling.op_report(pk, sk, batch=2)
    assert set(out) == {"enc_value_us", "dec_value_us", "ct_add_us", "ct_mul_us"}
    assert all(v > 0 for v in out.values())
    assert "ct_mul_us" in capsys.readouterr().out
