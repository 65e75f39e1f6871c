"""A depth-3 chain across the client/evaluator split on CPU engines: the
reference's depth test (tests/test_depth.cpp, repeated squaring) through
``Evaluator.mul_batch`` and ``Client.decrypt``, each step's product against
the benchmark's plain reference, and the counters that say what the chain
cost (tracing.count): the cross product's edge pairs and route, the layers
compaction dropped, and the edges and layers decrypted.

The keys are ``small_test_params()`` with B = 19 (which divides p - 1): the
chain's last product holds 9728 edges, where B = 337 gives 172,544 and
minutes of σ on the plain twins."""
import dataclasses

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu_torch as tpv
from portbench import cipher, deploy
from portbench.reference import scheme
from pvac_hfhe_cppbyv_tpu_torch import native, tracing
from pvac_hfhe_cppbyv_tpu_torch.core import bits
from pvac_hfhe_cppbyv_tpu_torch.ops import arithmetic as arith

torch.set_num_threads(2)

STEPS = 3
ROUTES = ("native", "numpy", "grid")


def _params():
    return dataclasses.replace(tpv.small_test_params(), B=19)


def _split():
    """A client and an evaluator as the benchmark's split deployment
    builds them (the evaluator on the pk.bin that load_pk read back), each
    with an engine of its own on the CPU."""
    config = {"deployment": "split", "params": dataclasses.asdict(_params())}
    dep = deploy.build(config, "cpu")
    tpv.enable_device(dep.client.pk, dep.client.sk, "cpu")
    tpv.enable_device(dep.evaluator.pk, None, "cpu")
    return dep


def _delta(stats, before):
    return {k: v - before.get(k, 0) for k, v in stats.items() if v != before.get(k, 0)}


@pytest.fixture(scope="module")
def chain():
    dep = _split()
    ev_stats, cl_stats = dep.evaluator.pk._engine.stats, dep.client.pk._engine.stats
    v = int(np.random.default_rng(20261018).integers(0, 1 << 64, dtype=np.uint64))
    cts = dep.client.encrypt([v])
    steps = []
    for _ in range(STEPS):
        c = cts[-1]
        before = dict(ev_stats)
        cts += dep.evaluator.mul_batch([(c, c)])
        steps.append(_delta(ev_stats, before))
    before = dict(cl_stats)
    out = dep.client.decrypt(cts)
    dec = _delta(cl_stats, before)
    km = dep.key_material()
    key = scheme.Key(km["prf_k"], km["lpn_s_words"], km["canon_tag"], km["g"], dep.params)
    ref = scheme.decrypt_all(key, [cipher.record(c) for c in cts], "cpu")
    return {"v": v, "cts": cts, "steps": steps, "out": out, "dec": dec, "ref": ref}


def test_chain_decrypts_to_v_to_the_8th(chain):
    assert chain["out"][-1] == pow(chain["v"], 1 << STEPS, scheme.P)
    assert chain["out"] == [pow(chain["v"], 1 << k, scheme.P) for k in range(STEPS + 1)]


@pytest.mark.parametrize("k", range(1, STEPS + 1))
def test_reference_decrypts_each_step(chain, k):
    assert chain["ref"][k] == pow(chain["v"], 1 << k, scheme.P)
    assert chain["cts"][k].n_edges > chain["cts"][k - 1].n_edges


@pytest.mark.parametrize("k", range(1, STEPS + 1))
def test_pairs_and_one_route_a_product(chain, k):
    """mul.pairs is |c|^2 of the squared ciphertext; of the route counters
    only native moves, by one (the native aggregator takes every step at
    these sizes)."""
    moved = chain["steps"][k - 1]
    assert moved["mul.pairs"] == chain["cts"][k - 1].n_edges ** 2
    routes = {r: moved.get(f"mul.route.{r}", 0) for r in ROUTES}
    assert routes == {"native": 1, "numpy": 0, "grid": 0}


def test_layers_dropped_by_compaction(chain):
    """A squaring of an L-layer ciphertext grids L + L + L^2 layers before
    compaction keeps the live ones."""
    for k, moved in enumerate(chain["steps"], 1):
        L = chain["cts"][k - 1].n_layers
        assert moved.get("mul.layers_dropped", 0) == 2 * L + L * L - chain["cts"][k].n_layers
    assert chain["steps"][-1]["mul.layers_dropped"] > 0


def test_compaction_span_inside_assemble(chain):
    for moved in chain["steps"]:
        assert 0 < moved["ns.mul.assemble.compact"] <= moved["ns.mul.assemble"]


def test_dec_counts_edges_and_layers(chain):
    cts = chain["cts"]
    assert chain["dec"]["dec.edges"] == sum(c.n_edges for c in cts)
    assert chain["dec"]["dec.layers"] == sum(c.n_layers for c in cts)
    assert not any(k.startswith("mul.") for k in chain["dec"])


@pytest.mark.parametrize("route", ROUTES)
def test_each_route_counts_its_products(route, monkeypatch):
    """Two depth-1 products on each route: its counter moves by 2, the
    others stay, and the products decrypt."""
    if route == "numpy":
        monkeypatch.setattr(native, "mul_cross_agg", lambda *a: None)
    if route == "grid":
        monkeypatch.setattr(arith, "MULGRID_PAIR_THRESHOLD", 1)
        monkeypatch.setattr(arith, "_native_agg_viable", lambda *a: False)
    dep = _split()
    cts = dep.client.encrypt([6, 7, 11, 13])
    stats = dep.evaluator.pk._engine.stats
    before = dict(stats)
    prods = dep.evaluator.mul_batch([(cts[0], cts[1]), (cts[2], cts[3])])
    moved = _delta(stats, before)
    assert {r: moved.get(f"mul.route.{r}", 0) for r in ROUTES} == \
        {r: 2 * (r == route) for r in ROUTES}
    assert moved["mul.pairs"] == cts[0].n_edges * cts[1].n_edges + cts[2].n_edges * cts[3].n_edges
    assert dep.client.decrypt(prods) == [42, 143]


def test_no_engine_counts_nothing_and_raises_nothing():
    pk, sk = tpv.keygen(_params(), device="cpu")
    assert getattr(pk, "_engine", None) is None
    a, b = tpv.enc_value_batch(pk, sk, [5, 9])
    sq = tpv.ct_mul_batch(pk, [(a, a), (a, b)])
    assert tpv.dec_value_batch(pk, sk, sq) == [25, 45]
    assert getattr(pk, "_engine", None) is None
    tracing.count(pk, {"mul.pairs": 1})
    assert getattr(pk, "_engine", None) is None


def test_count_adds_to_the_engine_stats():
    class Engine:
        stats = {"mul.pairs": 5}

    class Key:
        _engine = Engine()

    tracing.count(Key(), {"mul.pairs": 7, "dec.edges": 3})
    tracing.count(Key(), {})
    assert Engine.stats == {"mul.pairs": 12, "dec.edges": 3}


@pytest.mark.parametrize("nbytes", [4, bits.PINNED_MIN_BYTES - 4, bits.PINNED_MIN_BYTES])
def test_from_np_u32_keeps_the_bits(nbytes):
    a = np.random.default_rng(nbytes).integers(0, 1 << 32, nbytes // 4, dtype=np.uint32)
    got = bits.from_np_u32(a, "cpu")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy().view(np.uint32), a)


@pytest.mark.cuda
def test_pinned_upload_equals_pageable_on_card():
    """Uploads from PINNED_MIN_BYTES up go through pinned memory without
    blocking the host: the card holds the host's words as they were at the
    call, though the host overwrites them at once, as a pageable copy does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    for n in (16, bits.PINNED_MIN_BYTES // 4 - 1, bits.PINNED_MIN_BYTES // 4, 5 << 20):
        a = rng.integers(0, 1 << 32, n, dtype=np.uint32)
        live = a.copy()
        got = bits.from_np_u32(live, "cuda")
        live[:] = 0
        want = torch.from_numpy(a.view(np.int32)).to("cuda")
        assert torch.equal(got, want), n
