"""Kernel D's plain twin (crypto/prf_keys.prf_keys_plain: both AES keys
and nonces of PRF cores from raw seeds, from the midstate of the key
pair's prefix), the plain SHA-256 of pre-padded messages, and the PRF
pass from seeds, against hashlib, the JAX package's derive_keys_xp and
derive_keys_batch, the reference's derive_aes_key vectors, and
host-derived PRF cores.  Bit-exact (tolerance 0: integer digests, keys,
nonces and field values)."""
import dataclasses
import hashlib
import pathlib

import numpy as np
import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
from pvac_hfhe_cppbyv_tpu.core import hash as JH
from pvac_hfhe_cppbyv_tpu.crypto import lpn as jlpn
from pvac_hfhe_cppbyv_tpu.params import Params as JParams
from pvac_hfhe_cppbyv_tpu.types import PubKey as JPubKey, SecKey as JSecKey
import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch.core import hash as H
from pvac_hfhe_cppbyv_tpu_torch.core.bits import u32_to_i32
from pvac_hfhe_cppbyv_tpu_torch.crypto import lpn, prf_keys as pk_, sha256_blocks as sb

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"
TOEP = lpn.DOM_HASH[tpv.Dom.TOEP]


def _fields(u64: np.ndarray) -> torch.Tensor:
    """[n, k] uint64 -> [n, k, 2] int64 (lo, hi) u32 halves."""
    u64 = np.ascontiguousarray(u64, dtype=np.uint64)
    return torch.from_numpy(u64.view(np.uint32).reshape(*u64.shape, 2).astype(np.int64))


def _seeds4(u64: np.ndarray) -> torch.Tensor:
    """[n, 4] uint64 -> [n, 4] int64 of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(u64, dtype=np.uint64).view(np.int64))


def _digest_bytes(d: torch.Tensor) -> list[bytes]:
    """[n, 8] int32 digest words -> digest bytes BE(h0)..BE(h7)."""
    return [d[i].numpy().view(np.uint32).astype(">u4").tobytes() for i in range(d.shape[0])]


def _nonces_u64(nonces: torch.Tensor) -> np.ndarray:
    """[4, n] int32 halves -> [2, n] uint64 (nonce, tnonce)."""
    h = nonces.numpy().view(np.uint32).astype(np.uint64)
    return np.stack([h[0] | h[1] << np.uint64(32), h[2] | h[3] << np.uint64(32)])


def _hashlib_keys(prefix: bytes, f64: np.ndarray, w: int) -> list[bytes]:
    """hashlib's key w (0 main, 1 Toeplitz) of every row of f64 [n, 4]."""
    rows = f64.copy()
    if w:
        rows[:, 3] = TOEP
    return [hashlib.sha256(prefix + r.astype("<u8").tobytes()).digest() for r in rows]


@pytest.mark.parametrize("prefix_len,n_fields", [(3, 2), (40, 1), (72, 4), (100, 3)])
def test_plain_matches_hashlib(prefix_len, n_fields):
    """1-block (3 + 16, 40 + 8 bytes) and 2-block (72 + 32, 100 + 24 bytes)
    messages, padded by MsgLayout."""
    rng = np.random.default_rng(prefix_len)
    prefix = bytes(rng.integers(0, 256, prefix_len, dtype=np.uint8))
    layout = H.MsgLayout(prefix, n_fields)
    u64 = rng.integers(0, 1 << 64, (9, n_fields), dtype=np.uint64)
    blocks = u32_to_i32(layout.build_blocks(_fields(u64)))
    assert blocks.shape == (9, layout.n_blocks, 16)
    got = _digest_bytes(sb.sha256_blocks_plain(blocks))
    want = [hashlib.sha256(prefix + row.astype("<u8").tobytes()).digest() for row in u64]
    assert got == want


def test_dispatch_uses_twin_on_cpu():
    msg = pk_.key_msg(bytes(72))
    seeds = _seeds4(np.arange(8, dtype=np.uint64).reshape(2, 4))
    for a, b in zip(pk_.prf_keys(msg, seeds, TOEP), pk_.prf_keys_plain(msg, seeds, TOEP)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        pk_.prf_keys_cuda(msg, seeds, TOEP)


@pytest.mark.parametrize("prefix_len", [8, 64, 72, 100, 136])
def test_midstate_matches_first_blocks(prefix_len):
    """key_msg's midstate is the state after the prefix's whole blocks of
    the JAX package's block chain, its tail the remaining template words;
    the twin's keys from them equal hashlib's.  72 is the scheme's prefix
    (two blocks, one hoisted); 100 leaves a two-block tail."""
    rng = np.random.default_rng(prefix_len)
    prefix = bytes(rng.integers(0, 256, prefix_len, dtype=np.uint8))
    msg = pk_.key_msg(prefix)
    jl = JH.MsgLayout(prefix, 4)
    f64 = rng.integers(0, 1 << 64, (6, 4), dtype=np.uint64)
    blocks = jl.build_blocks(f64.view(np.uint32).reshape(6, 4, 2))
    hoist = prefix_len // 64
    state = JH.sha256_init_state((6,), np)
    for b in range(hoist):
        state = JH.sha256_compress(state, blocks[:, b, :])
    assert msg.fpos == prefix_len - 64 * hoist
    assert msg.mid.dtype == np.uint32 and np.array_equal(np.tile(msg.mid, (6, 1)), state)
    assert np.array_equal(msg.tail, jl.template_words()[16 * hoist:])
    assert msg.tail.shape[0] // 16 == jl.n_blocks - hoist
    keys, _ = pk_.prf_keys_plain(msg, _seeds4(f64), TOEP)
    for w in (0, 1):
        assert [bytes(k) for k in keys[w].numpy()] == _hashlib_keys(prefix, f64, w)


@pytest.fixture(scope="module")
def synth(vectors):
    """The reference's synthetic PRF key set, in both packages."""
    pi = vectors["prf_inputs"]
    prf_k = [int(x) for x in pi["prf_k"]]
    bits = [int(x) for x in pi["lpn_s_bits"]]
    kw = dict(canon_tag=int(pi["canon_tag"]), H=None, ubk=None,
              H_digest=bytes.fromhex(pi["H_digest"]), omega_B=0, powg_B=[])
    jpk = JPubKey(prm=JParams(), **kw)
    pk = tpv.PubKey(prm=tpv.Params(), **kw)
    seed = [int(pi["ztag"]), int(pi["nonce_lo"]), int(pi["nonce_hi"])]
    return jpk, JSecKey(prf_k=prf_k, lpn_s_bits=bits), pk, \
        tpv.SecKey(prf_k=prf_k, lpn_s_bits=bits), seed


def _key_pair(name, synth):
    """(JAX pk, JAX sk, port pk, port sk) of the synthetic set or of a
    golden key pair (small or default Params), no engine attached."""
    if name == "synth":
        return synth[:4]
    g = GOLDEN / name
    return (jpv.load_pklite(str(g / "pklite.bin")), jpv.load_sk(str(g / "sk.bin")),
            tpv.load_pklite(str(g / "pklite.bin"), device="cpu"), tpv.load_sk(str(g / "sk.bin")))


@pytest.mark.parametrize("keys", ["synth", "small", "default"])
def test_prf_keys_matches_jax_xp(keys, synth):
    """Both keys of every core against the JAX package's derive_keys_xp
    of the same messages and against hashlib."""
    jpk, jsk, pk, sk = _key_pair(keys, synth)
    rng = np.random.default_rng(23)
    f64 = rng.integers(0, 1 << 64, (16, 4), dtype=np.uint64)
    f64[0] = (1 << 64) - 1
    f64[1] = 0
    msg = lpn.derive_msg(pk, sk)
    keys2, _ = pk_.prf_keys_plain(msg, _seeds4(f64), TOEP)
    assert keys2.dtype == torch.uint8 and keys2.shape == (2, 16, 32)
    jl = jlpn.derive_layout(jpk, jsk)
    prefix = lpn.derive_layout(pk, sk).prefix
    for w in (0, 1):
        rows = f64.copy()
        if w:
            rows[:, 3] = TOEP
        want = jlpn.derive_keys_xp(jl, jl.template_words(), rows.view(np.uint32).reshape(16, 4, 2))
        assert np.array_equal(keys2[w].numpy(), want)
        assert [bytes(k) for k in keys2[w].numpy()] == _hashlib_keys(prefix, f64, w)


def test_prf_keys_matches_vectors(vectors, synth):
    """The reference's derive_aes_key KATs (key bytes and nonces), one per
    domain."""
    _, _, pk, sk, seed = synth
    cases = vectors["derive_aes_key"]
    f64 = np.array([seed + [lpn.fnv1a_domain(c["dom"])] for c in cases], dtype=np.uint64)
    keys, nonces = pk_.prf_keys_plain(lpn.derive_msg(pk, sk), _seeds4(f64), TOEP)
    assert [bytes(k).hex() for k in keys[0].numpy()] == [c["key"] for c in cases]
    assert _nonces_u64(nonces)[0].tolist() == [
        lpn.derive_aes_key(pk, sk, tpv.RSeed(seed[0], tpv.Nonce128(seed[1], seed[2])),
                           c["dom"])[1] for c in cases]


@pytest.mark.parametrize("keys", ["synth", "default"])
def test_nonces_match_jax_derive_keys_batch(keys, synth):
    """Keys and nonce halves against the JAX package's derive_keys_batch:
    nonce = dom_hash ^ nonce_lo, and the Toeplitz nonce its base (derived
    with TOEP for dom_hash) XOR dom_hash."""
    jpk, jsk, pk, sk = _key_pair(keys, synth)
    rng = np.random.default_rng(31)
    seeds = rng.integers(0, 1 << 64, (12, 3), dtype=np.uint64)
    seeds[0] = (1 << 64) - 1
    dh = np.array([jlpn.DOM_HASH[d] for d in ("pvac.prf.r.2", "pvac.prf.noise.1")],
                  dtype=np.uint64)[np.arange(12) % 2]
    keys2, nonces = pk_.prf_keys_plain(lpn.derive_msg(pk, sk), lpn.seed_fields(seeds, dh, "cpu"),
                                       TOEP)
    jk, jn = jlpn.derive_keys_batch(jpk, jsk, seeds, dh)
    jtk, jtb = jlpn.derive_keys_batch(jpk, jsk, seeds, np.full(12, TOEP, dtype=np.uint64))
    got = _nonces_u64(nonces)
    assert np.array_equal(got[0], jn) and np.array_equal(got[1], jtb ^ dh)
    assert np.array_equal(keys2[0].numpy(), jk) and np.array_equal(keys2[1].numpy(), jtk)


def test_seed_fields_packs_one_tensor():
    seeds = np.array([[1, (1 << 64) - 1, 1 << 63]], dtype=np.uint64)
    dh = np.array([TOEP], dtype=np.uint64)
    s4 = lpn.seed_fields(seeds, dh, "cpu")
    assert s4.dtype == torch.int64 and s4.shape == (1, 4) and s4.is_contiguous()
    assert s4.numpy().view(np.uint64).tolist() == [[1, (1 << 64) - 1, 1 << 63, TOEP]]


def test_fields_straddling_hoisted_block_raise():
    """A message whose fields would lie in a hoisted block, off a word
    boundary, past the tail or with a tail kernel D does not take raises
    in the twin and the dispatcher alike."""
    good = pk_.key_msg(bytes(72))
    seeds = _seeds4(np.zeros((1, 4), dtype=np.uint64))
    two = pk_.key_msg(bytes(100))
    bad = [good._replace(fpos=-8),                      # in the hoisted block
           good._replace(fpos=6),                       # off a word boundary
           good._replace(fpos=32),                      # over the pad and length
           two._replace(tail=np.zeros(48, np.uint32)),  # a three-block tail
           good._replace(mid=good.mid[:7])]
    for msg in bad:
        for fn in (pk_.prf_keys_plain, pk_.prf_keys):
            with pytest.raises(ValueError):
                fn(msg, seeds, TOEP)
    with pytest.raises(ValueError, match="straddle a hoisted block"):
        pk_.prf_keys(bad[0], seeds, TOEP)


@pytest.mark.parametrize("params", ["small", "default"])
def test_device_derived_cores_match_host(params):
    """prf_R cores through a CPU engine (keys and nonces derived from the
    seeds by kernel D's twin, then the twins of A and E) equal the
    host-keyed cores of the JAX package and of the port without an
    engine.  Default Params: a handful of full-size cores."""
    if params == "small":
        jpk, jsk = jpv.keygen(jpv.small_test_params())
        pkf = dict(prm=dataclasses.asdict(jpk.prm), canon_tag=jpk.canon_tag, H=jpk.H,
                   ubk_perm=None, ubk_inv=None, H_digest=jpk.H_digest,
                   omega_B=jpk.omega_B, powg_B=jpk.powg_B)
        pk, sk = tpv.keys_from_numpy(pkf, dict(prf_k=jsk.prf_k, lpn_s_bits=jsk.lpn_s_bits), device="cpu")
        n = 40
    else:
        g = GOLDEN / "default"
        jpk, jsk = jpv.load_pklite(str(g / "pklite.bin")), jpv.load_sk(str(g / "sk.bin"))
        pk, sk = tpv.load_pklite(str(g / "pklite.bin"), device="cpu"), tpv.load_sk(str(g / "sk.bin"))
        n = 4
    rng = np.random.default_rng(5)
    seeds = rng.integers(0, 1 << 64, (n, 3), dtype=np.uint64)
    doms = [jlpn.DOM_HASH[d] for d in ("pvac.prf.r.1", "pvac.prf.r.3", "pvac.prf.noise.2")]
    dh = np.array(doms, dtype=np.uint64)[np.arange(n) % 3]
    host = lpn.prf_cores_batch(pk, sk, seeds, dh)
    eng = tpv.enable_device(pk, sk, "cpu")
    try:
        eng.PRF_CHUNK = 3 if params == "small" else 16384
        dev = lpn.prf_cores_batch(pk, sk, seeds, dh)
        assert eng.stats["prf_cores"] == n
    finally:
        tpv.disable_device(pk)
    assert np.array_equal(dev, host)
    assert np.array_equal(dev, jlpn.prf_cores_batch(jpk, jsk, seeds, dh))


def test_rebind_replaces_midstate(synth):
    """An engine's midstate is its bound key pair's; a second sk replaces
    it, and an engine with no sk holds none and derives nothing."""
    _, _, pk, sk, _ = synth
    eng = tpv.CudaEngine(pk, None, "cpu")
    assert eng.key_msg is None and eng.sk is None and eng.stats["prf_cores"] == 0
    eng.bind_sk(sk)
    first = eng.key_msg
    assert np.array_equal(first.mid, lpn.derive_msg(pk, sk).mid)
    other = tpv.SecKey(prf_k=[k ^ 1 for k in sk.prf_k], lpn_s_bits=list(sk.lpn_s_bits))
    eng.bind_sk(other)
    assert eng.sk is other and not np.array_equal(eng.key_msg.mid, first.mid)
    assert np.array_equal(eng.key_msg.mid, lpn.derive_msg(pk, other).mid)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(synth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, pk, sk, _ = synth
    rng = np.random.default_rng(9)
    f64 = rng.integers(0, 1 << 64, (4096, 4), dtype=np.uint64)
    msg = lpn.derive_msg(pk, sk)
    seeds = _seeds4(f64).cuda()
    got = pk_.prf_keys_cuda(msg, seeds, TOEP)
    torch.cuda.synchronize()
    want = pk_.prf_keys_plain(msg, seeds.cpu(), TOEP)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    hk, hn = lpn.derive_keys_batch(pk, sk, f64[:, :3], f64[:, 3])
    assert np.array_equal(got[0][0].cpu().numpy(), hk)
    assert np.array_equal(_nonces_u64(got[1].cpu())[0], hn)
