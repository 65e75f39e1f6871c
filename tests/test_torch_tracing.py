"""The port's stage spans (tracing.py) on a CPU engine: the always-on
``ns.*`` counters in engine.stats, the span log that recording() turns on,
the ranges profiling.trace shows, and the per-row σ salts LazySigma keeps
so a row can be rebuilt from its edge."""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch import tracing
from pvac_hfhe_cppbyv_tpu_torch.crypto import matrix
from pvac_hfhe_cppbyv_tpu_torch.models import circuits
from pvac_hfhe_cppbyv_tpu_torch.types import LazySigma, MixedLazySigma
from pvac_hfhe_cppbyv_tpu_torch.utils import profiling

torch.set_num_threads(2)

STAGES = {
    "enc": ("plan", "dispatch", "draw", "wait", "weights", "assemble"),
    "mul": ("layers", "cross", "dispatch", "assemble"),
    "dec": ("prf", "inv", "sums", "fold"),
}
VALUES = [3, 5, 7, 11]


@pytest.fixture(scope="module")
def keys():
    pk, sk = tpv.keygen(tpv.small_test_params(), device="cpu")
    tpv.enable_device(pk, sk, "cpu")
    return pk, sk


@pytest.fixture(scope="module")
def cts(keys):
    return tpv.enc_value_batch(*keys, VALUES)


def _run(op, keys, cts):
    pk, sk = keys
    if op == "enc":
        return tpv.enc_value_batch(pk, sk, VALUES)
    if op == "mul":
        return tpv.ct_mul_batch(pk, [(cts[0], cts[1]), (cts[2], cts[3])])
    return tpv.dec_value_batch(pk, sk, cts)


def _ns(stats):
    return {k: v for k, v in stats.items() if k.startswith("ns.")}


@pytest.mark.parametrize("op", sorted(STAGES))
def test_stage_counters_tile_the_call(keys, cts, op):
    """After one call every stage's counter moved, and the stages add to
    no more than the call's own counter."""
    stats = keys[0]._engine.stats
    before = _ns(stats)
    _run(op, keys, cts)
    after = _ns(stats)
    moved = {k: v - before.get(k, 0) for k, v in after.items()}
    parts = [moved.get(f"ns.{op}.{s}", 0) for s in STAGES[op]]
    assert all(p > 0 for p in parts), dict(zip(STAGES[op], parts))
    assert 0 < sum(parts) <= moved[f"ns.{op}"]
    assert all(k == f"ns.{op}" or k.startswith(f"ns.{op}.") for k, v in moved.items() if v)


def test_no_record_while_recording_is_off(keys, cts):
    with tracing.recording():
        pass
    assert tracing.spans() == []
    _run("enc", keys, cts)
    _run("dec", keys, cts)
    assert tracing.spans() == []


def test_records_nest_with_one_request_a_call(keys, cts):
    wall0 = time.time_ns()
    with tracing.recording():
        for op in ("enc", "mul", "dec"):
            _run(op, keys, cts)
    wall1 = time.time_ns()
    recs = tracing.spans()
    tops = [(i, r) for i, r in enumerate(recs) if r.parent == -1]
    assert [r.name for _, r in tops] == ["enc", "mul", "dec"]
    assert [r.request for _, r in tops] == [0, 1, 2]
    assert [r.units for _, r in tops] == [len(VALUES), 2, len(VALUES)]
    for r in recs:
        assert r.end is not None and r.start <= r.end
        # the profiler's clock: time.time_ns nanoseconds
        assert wall0 - 10**9 < r.start and r.end < wall1 + 10**9
        if r.parent == -1:
            continue
        p = recs[r.parent]
        assert p.start <= r.start and r.end <= p.end
        assert r.request == p.request and r.name.startswith(p.name + ".")
    for i, top in tops:
        names = {r.name for r in recs if r.parent == i}
        assert names == {f"{top.name}.{s}" for s in STAGES[top.name]}


def test_no_engine_counts_nothing_and_raises_nothing():
    pk, sk = tpv.keygen(tpv.small_test_params(), device="cpu")
    assert getattr(pk, "_engine", None) is None
    with tracing.recording():
        cts = tpv.enc_value_batch(pk, sk, [6, 7])
        prod = tpv.ct_mul_batch(pk, [(cts[0], cts[1])])
        assert tpv.dec_value_batch(pk, sk, cts + prod) == [6, 7, 42]
    assert getattr(pk, "_engine", None) is None
    # the log still records: only the counters need an engine
    assert [r.name for r in tracing.spans() if r.parent == -1] == ["enc", "mul", "dec"]


def test_span_is_reusable_and_counts_every_use():
    class Engine:
        stats = {}

    class Key:
        _engine = Engine()

    s = tracing.span(Key(), "x.y", 3)
    with tracing.recording():
        for _ in range(3):
            with s:
                pass
        s.start()
        s.stop()
    assert Engine.stats["ns.x.y"] > 0
    recs = tracing.spans()
    assert [(r.name, r.units, r.parent) for r in recs] == [("x.y", 3, -1)] * 4
    assert [r.request for r in recs] == [0, 1, 2, 3]


def test_profiling_trace_names_the_stages(keys, cts, tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        _run("enc", keys, cts)
        _run("mul", keys, cts)
    with open(tmp_path / "tr" / "trace.json") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    want = ({"enc", "mul", "mul.assemble.compact"}
            | {f"{op}.{s}" for op in ("enc", "mul") for s in STAGES[op]})
    assert want <= names
    assert {r.name for r in tracing.spans()} == want


def _check_rows(pk, C, picks):
    assert isinstance(C.sigma, LazySigma) and C.sigma.salt is not None
    rows = np.asarray(C.sigma)
    salts = C.sigma.salts
    for e in picks:
        seed = C.layers[int(C.layer_id[e])].seed
        got = matrix.sigma_from_H(pk, seed.ztag, seed.nonce, int(C.idx[e]), int(C.ch[e]),
                                  int(salts[e]))
        np.testing.assert_array_equal(got, rows[e])


def test_lazy_sigma_keeps_the_salt_of_each_row(keys, cts):
    """Rows of a fresh ciphertext (two shares' views, shuffled and
    concatenated) and of a product rebuild bit for bit from their edge's
    layer seed, idx, ch and salt."""
    pk, _ = keys
    rng = np.random.default_rng(13)
    for C in cts[:2]:
        _check_rows(pk, C, rng.choice(C.n_edges, 6, replace=False))
    prod = tpv.ct_mul_batch(pk, [(cts[0], cts[1]), (cts[2], cts[3])])
    for C in prod:
        _check_rows(pk, C, rng.choice(C.n_edges, 6, replace=False))
    view = prod[1].sigma[np.arange(4)[::-1].copy()]
    assert view.salt is prod[1].sigma.salt
    np.testing.assert_array_equal(view.salts, prod[1].sigma.salts[[3, 2, 1, 0]])


def test_circuit_spans_nest_under_their_parents(keys, cts):
    """A linear combination is a top-level ``scale`` then a top-level
    ``sum``; a dot product a top-level ``mul``, whose stages nest beneath it
    under its name, then a ``sum``."""
    pk, _ = keys
    with tracing.recording():
        circuits.linear_combination(pk, cts, [3, 1, 4, 1])
    recs = tracing.spans()
    assert [r.name for r in recs if r.parent == -1] == ["scale", "sum"]
    assert [r.units for r in recs if r.parent == -1] == [len(cts), len(cts)]
    with tracing.recording():
        circuits.dot_product(pk, cts[:2], cts[2:])
    recs = tracing.spans()
    assert [r.name for r in recs if r.parent == -1] == ["mul", "sum"]
    kids = [r for r in recs if r.parent != -1]
    assert kids and all(r.name.startswith(recs[r.parent].name + ".") for r in kids)
    assert {recs[r.parent].name for r in kids} <= {"mul", "mul.assemble"}


def test_sum_across_the_budget_moves_its_counters(keys, cts):
    """A tree sum of fresh ciphertexts of two encryption passes (σ rows on
    the engine) past the edge budget compacts its root: ns.sum, the
    compaction's nanoseconds, edges and buckets move, and σ stays a view
    of the engine's rows (sigma.host_bytes 0)."""
    pk, sk = keys
    stats = pk._engine.stats
    keep = pk.prm
    more = tpv.enc_value_batch(pk, sk, [2, 4])
    leaves = cts + more
    total = sum(c.n_edges for c in leaves)
    pk.prm = dataclasses.replace(keep, edge_budget=total - 1)
    try:
        before = dict(stats)
        out = circuits.sum_chain(pk, leaves)
    finally:
        pk.prm = keep
    moved = {k: v - before.get(k, 0) for k, v in stats.items()}
    assert moved["ns.sum"] >= moved["ns.compact_edges"] > 0
    assert moved["compact.edges"] == total
    assert moved["compact.buckets"] == out.n_edges == total
    assert moved["sigma.host_bytes"] == 0
    assert isinstance(out.sigma, MixedLazySigma) and len(out.sigma.srcs) == 2
    assert tpv.dec_value_batch(*keys, [out]) == [sum(VALUES) + 6]
