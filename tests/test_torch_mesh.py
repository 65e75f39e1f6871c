"""The engine on a mesh: one controller and three workers in a spawned
world of 4 gloo ranks on the CPU, (dp, tp) = (2, 2), every rank on the
twins, held against the single-device CPU engine and the JAX package's
mesh engine (enable_device(pk, sk, mesh=make_mesh(devs[:8])) on conftest's
8 virtual CPU devices), with the keys of one JAX keygen carried across by
keys_from_numpy.  The odd batch sizes split unevenly over dp.  Also the
world's failure modes: no card for a CUDA world, a rank that raises.

A spawned rank imports this module, so JAX is imported inside the
fixtures and tests only.  Everything is bit-exact (tolerance 0)."""
import dataclasses
import os
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch.crypto import lpn, matrix
from pvac_hfhe_cppbyv_tpu_torch.ops import arithmetic as arith
from pvac_hfhe_cppbyv_tpu_torch.parallel import engine as pe
from pvac_hfhe_cppbyv_tpu_torch.parallel.mesh import spawn_world

torch.set_num_threads(2)

N_PRF, N_SIGMA = 23, 37
VALUES = [5, 7, 123]


def _fields(pk, sk):
    return (dict(prm=dataclasses.asdict(pk.prm), canon_tag=pk.canon_tag, H=pk.H,
                 ubk_perm=pk.ubk.perm, ubk_inv=pk.ubk.inv, H_digest=pk.H_digest,
                 omega_B=pk.omega_B, powg_B=pk.powg_B),
            dict(prf_k=sk.prf_k, lpn_s_bits=sk.lpn_s_bits))


def _inputs():
    rng = np.random.default_rng(13)
    seeds = rng.integers(0, 1 << 62, size=(N_PRF, 3), dtype=np.uint64)
    dh = np.array([lpn.DOM_HASH[d] for d in ["pvac.prf.r.1", "pvac.prf.r.2",
                                             "pvac.prf.r.3"] * N_PRF][:N_PRF], dtype=np.uint64)
    cols = [rng.integers(0, 1 << 62, N_SIGMA, dtype=np.uint64) for _ in range(3)]
    cols += [rng.integers(0, 337, N_SIGMA, dtype=np.uint64), rng.integers(0, 2, N_SIGMA, dtype=np.uint64),
             rng.integers(0, 1 << 62, N_SIGMA, dtype=np.uint64)]
    return seeds, dh, cols


def _on_single(pk, sk, fn):
    """fn() with a single-device CPU engine attached to pk in place of the
    mesh engine."""
    mesh_eng = pk._engine
    tpv.enable_device(pk, sk, "cpu")
    try:
        return fn()
    finally:
        pk._engine = mesh_eng


def _controller(mesh, pkf, skf, seeds, dh, cols) -> dict:
    """Rank 0 of the world: every check's values, for the tests."""
    torch.set_num_threads(1)
    pk, sk = tpv.keys_from_numpy(pkf, skf, device="cpu")
    eng = tpv.enable_device(pk, sk, mesh=mesh)
    out = {"shape": (mesh.dp, mesh.tp)}
    out["prf"] = (lpn.prf_cores_batch(pk, sk, seeds, dh),
                  _on_single(pk, sk, lambda: lpn.prf_cores_batch(pk, sk, seeds, dh)))
    out["sigma"] = (matrix.sigma_words(pk, *cols),
                    _on_single(pk, sk, lambda: matrix.sigma_words(pk, *cols)))
    out["shard_report"] = eng.report()

    cts = tpv.enc_value_batch(pk, sk, VALUES)
    prod = tpv.ct_mul(pk, cts[0], cts[1])
    s = tpv.ct_add(pk, prod, cts[2])
    out["dec"] = tpv.dec_value_batch(pk, sk, cts + [prod, s])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.ct")
        tpv.save_cts(cts + [prod, s], path)
        with open(path, "rb") as f:
            out["ct_bytes"] = f.read()

    # the grid: one occupied layer a block, so the product prod x fresh has
    # a block for every rank, round-robin
    lblock, arith.MULGRID_LBLOCK = arith.MULGRID_LBLOCK, 1
    try:
        layers, base = arith._mul_layers(pk, prod, cts[2])
        out["grid"] = (arith._stage_device(pk, eng, prod, cts[2], layers, base)(),
                       _on_single(pk, sk, lambda: arith._stage_device(
                           pk, pk._engine, prod, cts[2], layers, base)()))
    finally:
        arith.MULGRID_LBLOCK = lblock
    out["report"] = eng.report()

    # an evaluator: the public key alone, in a mesh engine of its own
    ev_pk, _ = tpv.keys_from_numpy(pkf, skf, device="cpu")
    ev = tpv.enable_device(ev_pk, None, mesh=mesh)
    ev_prod = tpv.ct_mul(ev_pk, cts[0], cts[2])
    out["ev_report"] = ev.report()
    out["ev_dec"] = tpv.dec_value_batch(pk, sk, [ev_prod])

    # closing an engine releases its part on every rank
    tpv.disable_device(ev_pk)
    out["closed_report"] = eng.report()
    try:
        ev.report()
    except RuntimeError as e:
        out["closed_error"] = str(e)

    # an engine attached before its public key has H sends H at its first σ
    nh_pk = dataclasses.replace(pk, H=None)
    nh = tpv.enable_device(nh_pk, sk, mesh=mesh)
    try:
        nh.sigma(np.zeros((1, 7), dtype=np.uint64))
    except ValueError as e:
        out["no_H_error"] = str(e)
    nh_pk.H = pk.H
    out["late_H"] = matrix.sigma_words(nh_pk, *cols)
    tpv.disable_device(nh_pk)
    return out


@pytest.fixture(scope="module")
def keys():
    import pvac_hfhe_cppbyv_tpu as jpv

    jpk, jsk = jpv.keygen(jpv.small_test_params())
    return jpk, jsk, _fields(jpk, jsk)


@pytest.fixture(scope="module")
def world(keys):
    seeds, dh, cols = _inputs()
    res = spawn_world(pe.controller, (2, 2), "cpu", timeout_s=300,
                      args=(_controller, *keys[2], seeds, dh, cols))
    assert res[1:] == [None, None, None]
    return res[0]


@pytest.fixture(scope="module")
def jax_mesh(keys):
    """PRF cores and σ of the same inputs from the JAX mesh engine."""
    import jax

    from pvac_hfhe_cppbyv_tpu.crypto import lpn as jlpn
    from pvac_hfhe_cppbyv_tpu.crypto import matrix as jmatrix
    from pvac_hfhe_cppbyv_tpu.parallel.engine import disable_device, enable_device
    from pvac_hfhe_cppbyv_tpu.parallel.mesh import make_mesh

    jpk, jsk, _ = keys
    eng = enable_device(jpk, jsk, mesh=make_mesh(jax.devices()[:8]))
    eng.use_pallas_sha = False
    try:
        seeds, dh, cols = _inputs()
        return (np.asarray(jlpn.prf_cores_batch(jpk, jsk, seeds, dh)),
                np.asarray(jmatrix.sigma_words(jpk, *cols)))
    finally:
        disable_device(jpk)


@pytest.mark.parametrize("what", ["prf", "sigma"])
def test_mesh_engine_matches_single_and_jax_mesh(world, jax_mesh, what):
    mesh_out, single = world[what]
    want = jax_mesh[0 if what == "prf" else 1]
    assert mesh_out.shape == want.shape == (N_PRF if what == "prf" else N_SIGMA, want.shape[1])
    np.testing.assert_array_equal(mesh_out, single)
    np.testing.assert_array_equal(mesh_out, want)


def test_every_rank_took_its_dp_shard(world):
    """23 cores and 37 edges split 12 / 11 and 19 / 18 over dp, and each tp
    rank of a dp row ran the same lanes (kernel A on its window, kernel C
    on its columns)."""
    assert world["shape"] == (2, 2)
    rep = world["shard_report"]
    assert all(r["secret"] for r in rep)
    assert [r["stats"]["prf_cores"] for r in rep] == [12, 12, 11, 11]
    assert [r["stats"]["sigma_edges"] for r in rep] == [19, 19, 18, 18]


def test_mesh_roundtrip_decrypts(world):
    assert world["dec"] == [5, 7, 123, 35, 158]


def test_mesh_ciphertexts_decrypt_in_jax(world, keys, tmp_path):
    import pvac_hfhe_cppbyv_tpu as jpv

    jpk, jsk, _ = keys
    (tmp_path / "mesh.ct").write_bytes(world["ct_bytes"])
    assert jpv.dec_value_batch(jpk, jsk, jpv.load_cts(str(tmp_path / "mesh.ct"))) \
        == [5, 7, 123, 35, 158]


def test_grid_round_robin_matches_single_device(world):
    got, want = world["grid"]
    for k in ("out_lid", "out_idx", "out_ch", "out_w"):
        np.testing.assert_array_equal(got[k], want[k])
    blocks = [r["stats"]["mulgrid_blocks"] for r in world["report"]]
    assert min(blocks) >= 1 and max(blocks) - min(blocks) <= 1


def test_evaluator_binds_no_secret_on_any_rank(world):
    rep = world["ev_report"]
    assert len(rep) == 4 and not any(r["secret"] for r in rep)
    assert all(r["stats"]["prf_cores"] == 0 for r in rep)
    assert sum(r["stats"]["sigma_edges"] for r in rep) > 0
    assert world["ev_dec"] == [5 * 123]


def test_cuda_world_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        spawn_world(pe.controller, (2, 1), "cuda", args=(_controller,))


def _raise_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 gives up")
    dist.all_reduce(torch.ones(4), group=mesh.group)  # waits for rank 1 forever
    return mesh.rank


def test_failing_rank_fails_the_world_within_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        spawn_world(_raise_on_rank_1, (1, 2), "cpu", timeout_s=120)
    assert time.monotonic() - t0 < 120


def test_closed_engine_is_released_on_every_rank(world):
    assert [r["engines"] for r in world["ev_report"]] == [2] * 4
    assert [r["engines"] for r in world["closed_report"]] == [1] * 4
    assert world["closed_error"] == "this mesh engine is closed"


def test_engine_sends_H_when_the_key_gains_it(world):
    assert world["no_H_error"].startswith("sigma needs H")
    np.testing.assert_array_equal(world["late_H"], world["sigma"][1])
