"""The multi-device step on torch.distributed against the JAX package's
make_multichip_step, and the split kernels' twins: kernel A on a tp word
window and kernel C on a block of H's columns.

The port's side runs in one spawned world of 4 gloo ranks on the CPU (the
twins), which builds a mesh of every shape in turn; the JAX side runs in
the pytest process on conftest's 8 virtual CPU devices, as
tests/test_sharding.py runs it.  A spawned rank imports this module, so
JAX is imported inside the test functions only.  Everything is
bit-exact (tolerance 0: GF(2) values and exact field elements)."""
import dataclasses

import numpy as np
import pytest
import torch

from pvac_hfhe_cppbyv_tpu_torch import small_test_params
from pvac_hfhe_cppbyv_tpu_torch.core.bits import from_np_u32
from pvac_hfhe_cppbyv_tpu_torch.crypto import lpn, lpn_ybits, sigma_xor
from pvac_hfhe_cppbyv_tpu_torch.params import Params
from pvac_hfhe_cppbyv_tpu_torch.parallel import mesh as pmesh
from pvac_hfhe_cppbyv_tpu_torch.parallel.engine import h_block
from pvac_hfhe_cppbyv_tpu_torch.parallel.sharding import make_multichip_step, multichip_inputs

torch.set_num_threads(2)

# tests/test_sharding.py's tiny Params
TINY = dict(m_bits=512, n_bits=1024, h_col_wt=48, x_col_wt=32, err_wt=32, lpn_n=256,
            lpn_t=256)
SHAPES = ((2, 2), (4, 1), (1, 4))
LANES, SEED = 32, 9
P = (1 << 127) - 1


def _ints(limbs) -> list[int]:
    return [int(a) | int(b) << 32 | int(c) << 64 | int(d) << 96
            for a, b, c, d in np.asarray(limbs, dtype=np.uint64)]


def _steps(mesh, tiny: dict, lanes: int, seed: int) -> dict:
    """Every rank: the step on a mesh of each shape of SHAPES, then at
    lpn_n 320 on (2, 2), where tp does not divide s_words64 = 5."""
    torch.set_num_threads(1)
    out = {}
    for shape, prm in [(s, Params(**tiny)) for s in SHAPES] + [
            ((2, 2), Params(**dict(tiny, lpn_n=320)))]:
        m = pmesh.make_mesh(shape, "cpu")
        step, build = make_multichip_step(m, prm, lanes)
        R, sums = step(*build(seed))
        out[shape, prm.lpn_n] = (m.dp_rank, m.tp_rank, R.numpy(), sums.numpy())
    return out


@pytest.fixture(scope="module")
def world():
    """{(shape, lpn_n): [(dp_rank, tp_rank, R of its dp shard, bucket sums)
    per rank]}."""
    ranks = pmesh.spawn_world(_steps, (2, 2), "cpu", timeout_s=300, args=(TINY, LANES, SEED))
    return {key: [r[key] for r in ranks] for key in ranks[0]}


def _gathered_R(per_rank) -> np.ndarray:
    """R over dp: the dp shards of tp rank 0, in dp order."""
    return np.concatenate([R for dp, tp, R, _ in sorted(per_rank, key=lambda r: r[:2])
                           if tp == 0]).astype(np.uint32)


@pytest.mark.parametrize("n", range(1, 17))
def test_default_mesh_shape_matches_jax(n):
    from pvac_hfhe_cppbyv_tpu.parallel.mesh import default_mesh_shape

    assert pmesh.default_mesh_shape(n) == default_mesh_shape(n)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_multichip_step_matches_jax(world, shape):
    import jax
    from jax.sharding import Mesh

    from pvac_hfhe_cppbyv_tpu.params import Params as JParams
    from pvac_hfhe_cppbyv_tpu.parallel.sharding import make_multichip_step as jax_step

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(shape), ("dp", "tp"))
    step, build = jax_step(mesh, JParams(**TINY), lanes_per_shard=LANES)
    args = build(seed=SEED)
    R, sums = (np.asarray(a) for a in step(*args))
    # the same numpy draws: nonce halves, secret and buckets come after the keys
    mine = multichip_inputs(Params(**TINY), LANES * shape[0], SEED)
    for k in (1, 2, 4, 5, 6, 7):
        assert np.array_equal(mine[k], args[k])
    per_rank = world[shape, 256]
    assert np.array_equal(_gathered_R(per_rank), R)
    for _, _, _, s in per_rank:
        assert np.array_equal(s.astype(np.uint32), sums)


def test_multichip_step_with_whole_secret(world):
    """lpn_n 320 on (2, 2): each tp rank runs the whole row; the cores equal
    the single-device program's and the bucket sums a host sum of them."""
    prm = Params(**dict(TINY, lpn_n=320))
    keys, nlo, nhi, tkeys, tnlo, tnhi, s32, bucket = multichip_inputs(prm, 2 * LANES, SEED)
    r, _ = lpn.prf_cores_device(prm, torch.from_numpy(keys), from_np_u32(nlo), from_np_u32(nhi),
                                torch.from_numpy(tkeys), from_np_u32(tnlo), from_np_u32(tnhi),
                                from_np_u32(s32))
    per_rank = world[(2, 2), 320]
    assert np.array_equal(_gathered_R(per_rank), r.numpy().astype(np.uint32))
    want = [0] * prm.B
    for v, b in zip(_ints(r.numpy()), bucket):
        want[b] = (want[b] + v) % P
    for _, _, _, s in per_rank:
        assert _ints(s) == want


def _a_inputs(prm, n, seed):
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(0, 256, (n, 32), dtype=np.uint8))
    nonces = rng.integers(0, 1 << 64, (n, 2), dtype=np.uint64).astype(np.uint32)
    nonces[0] = [0xFFFFFFF0, 7]  # the counter carries into the high half mid-stream
    s32 = rng.integers(0, 1 << 32, 2 * prm.s_words64, dtype=np.uint64).astype(np.uint32)
    return keys, from_np_u32(nonces[:, 0]), from_np_u32(nonces[:, 1]), s32


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("lpn_n", [256, 320])
def test_window_twin_xor_equals_whole(lpn_n, tp):
    """Kernel A's twin on each tp rank's window: the windows' y XOR to the
    whole row's, the noise owner's flags are the whole row's; where tp does
    not divide s_words64 (lpn_n 320) every rank takes the whole row."""
    prm = dataclasses.replace(small_test_params(), lpn_n=lpn_n)
    keys, nlo, nhi, s32 = _a_inputs(prm, 12, lpn_n + tp)
    tau = (min(127, prm.lpn_t), prm.lpn_tau_num, prm.lpn_tau_den)
    y, rej = lpn_ybits.lpn_ybits_plain(keys, nlo, nhi, from_np_u32(s32), *tau)
    wins = [lpn_ybits.tp_window(prm.s_words64, tp, r) for r in range(tp)]
    parts = [lpn_ybits.lpn_ybits_plain(keys, nlo, nhi, from_np_u32(s32[2 * w.lo:2 * w.hi]),
                                       *tau, window=w) for w in wins]
    if lpn_n == 320 and tp > 1:
        assert all(w == lpn_ybits.full_window(5) for w in wins)
        for py, prej in parts:
            assert torch.equal(py, y) and torch.equal(prej, rej)
        return
    assert sum(w.hi - w.lo for w in wins) == prm.s_words64 and [w.noise for w in wins].count(True) == 1
    acc = torch.zeros_like(y)
    for py, _ in parts:
        acc ^= py
    assert torch.equal(acc, y)
    owner = next(i for i, w in enumerate(wins) if w.noise)
    assert torch.equal(parts[owner][1], rej)
    assert all(not parts[i][1].any() for i in range(tp) if i != owner)


def test_window_rejection_flag_only_on_noise_owner():
    """A hand-built stream whose row-3 noise word is rejected: the flag
    comes from the window that holds the noise word only."""
    sw, rows = 4, 6
    u64s = np.random.default_rng(3).integers(0, 1 << 32, (2, rows * (sw + 1), 2), dtype=np.uint64)
    u64s[1, 3 * (sw + 1) + sw] = [0xFFFFFFFF - 2, 0xFFFFFFFF]
    u = torch.from_numpy(u64s.astype(np.int64))
    s32 = torch.from_numpy(np.arange(1, 2 * sw + 1, dtype=np.int64))
    _, rej = lpn_ybits.parity_noise_rows(u, s32, rows, 1, 8)
    assert rej[1, 3] and rej.sum() == 1
    for r in range(2):
        w = lpn_ybits.tp_window(sw, 2, r)
        _, wr = lpn_ybits.parity_noise_rows(u, s32[2 * w.lo:2 * w.hi], rows, 1, 8, w)
        assert torch.equal(wr, rej if w.noise else torch.zeros_like(rej))


def test_window_blocks_at_default_params():
    """The blocks kernel A encrypts per core: all 4128 for the whole row,
    the (row, block) pairs of each window at tp = 2 and 4."""
    rows, sw = 127, Params().s_words64
    assert lpn_ybits.window_blocks(rows, lpn_ybits.full_window(sw)) == 4128
    assert [lpn_ybits.window_blocks(rows, lpn_ybits.tp_window(sw, 2, r)) for r in range(2)] \
        == [2095, 2159]
    assert [lpn_ybits.window_blocks(rows, lpn_ybits.tp_window(sw, 4, r)) for r in range(4)] \
        == [1079, 1079, 1079, 1143]


def _c_inputs(mw, n_rows, E, k, dn, seed):
    rng = np.random.default_rng(seed)
    Hx = rng.integers(0, 1 << 32, (n_rows + 1, mw), dtype=np.uint64).astype(np.uint32)
    Hx[-1] = 0
    ridx = torch.from_numpy(rng.integers(0, n_rows + 1, (E, k)).astype(np.int16))
    nv = np.stack([rng.choice(32 * mw, dn, replace=False) for _ in range(E)])
    nv[rng.random((E, dn)) < 0.2] = -1
    return Hx, ridx, torch.from_numpy(nv.astype(np.int16))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_column_block_twin_concatenates_to_whole(tp):
    """Kernel C's twin on each tp rank's block of H's columns: the blocks'
    words, side by side, are the whole σ rows."""
    mw = small_test_params().sigma_words32
    Hx, ridx, nbit = _c_inputs(mw, 300, 64, 32, 40, tp)
    whole = sigma_xor.sigma_rows_plain(from_np_u32(Hx), ridx, nbit)
    blocks = [h_block(mw, tp, r) for r in range(tp)]
    assert blocks[0][0] == 0 and blocks[-1][1] == mw and all(
        c1 - c0 == mw // tp for c0, c1 in blocks)
    parts = [sigma_xor.sigma_rows_plain(from_np_u32(Hx[:, c0:c1]), ridx, nbit, 32 * c0)
             for c0, c1 in blocks]
    assert torch.equal(torch.cat(parts, dim=1), whole)


def test_noise_bits_outside_the_row_are_skipped():
    """A noise bit at or past 32 mw (or before a block's first bit) flips
    nothing: no draw may write past its row."""
    mw = 16
    Hx, ridx, nbit = _c_inputs(mw, 100, 8, 32, 10, 5)
    H = from_np_u32(Hx)
    want = sigma_xor.sigma_rows_plain(H, ridx, nbit)
    wild = nbit.clone()
    wild[:, 0] = 32 * mw
    wild[:, 1] = 32 * mw + 77
    kept = nbit.clone()
    kept[:, :2] = -1
    assert torch.equal(sigma_xor.sigma_rows_plain(H, ridx, wild),
                       sigma_xor.sigma_rows_plain(H, ridx, kept))
    c0, c1 = 8, 16
    blk = sigma_xor.sigma_rows_plain(from_np_u32(Hx[:, c0:c1]), ridx, nbit, 32 * c0)
    assert torch.equal(blk, want[:, c0:c1])


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("lpn_n", [4096, 320])
def test_window_kernel_matches_twin_on_card(lpn_n, tp):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prm = dataclasses.replace(Params(), lpn_n=lpn_n)
    keys, nlo, nhi, s32 = _a_inputs(prm, 256, lpn_n + tp)
    keys, nlo, nhi = keys.cuda(), nlo.cuda(), nhi.cuda()
    tau = (min(127, prm.lpn_t), prm.lpn_tau_num, prm.lpn_tau_den)
    for r in range(tp):
        w = lpn_ybits.tp_window(prm.s_words64, tp, r)
        args = (keys, nlo, nhi, from_np_u32(s32[2 * w.lo:2 * w.hi], "cuda"), *tau, w)
        got = lpn_ybits.lpn_ybits_cuda(*args)
        torch.cuda.synchronize()
        want = lpn_ybits.lpn_ybits_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_column_block_kernel_matches_twin_on_card():
    """Kernel C on each tp = 2 and 4 block of H's columns, with noise bits
    past the row that it must skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mw = 256
    Hx, ridx, nbit = _c_inputs(mw, 16384, 2048, 128, 144, 7)
    nbit[:, 0] = 32 * mw
    H, ridx, nbit = from_np_u32(Hx, "cuda"), ridx.cuda(), nbit.cuda()
    for tp in (2, 4):
        for r in range(tp):
            c0, c1 = h_block(mw, tp, r)
            args = (H[:, c0:c1].contiguous(), ridx, nbit, 32 * c0)
            got = sigma_xor.sigma_rows_cuda(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, sigma_xor.sigma_rows_plain(*args))


def test_h_block_keeps_whole_rows_when_tp_does_not_divide():
    assert h_block(256, 2, 1) == (128, 256)
    assert h_block(16, 4, 3) == (12, 16)
    assert h_block(20, 4, 1) == (0, 20)  # 5 words a rank: not whole 2-word slices
    assert h_block(6, 4, 0) == (0, 6)
