"""The port's Client / Evaluator split (service.py) on the CPU at small
Params: a client that holds the keys, an evaluator that holds only a
pk.bin the client wrote and an EvalKey, every Evaluator method; and the
slice against the JAX package: JAX-encrypted inputs through the port's
dot_product, decrypted by both packages, and the reverse.  Encryption
draws from the OS CSPRNG, so values are checked by decryption, exactly.

A pk.bin stores no n_bits or column weights (the reference layout), so
load_pk keeps their defaults; at small Params the evaluator's key is
given the client's Params, which are public, beside the pk.bin."""
import dataclasses

import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu.models import circuits as jcircuits
from pvac_hfhe_cppbyv_tpu_torch.models import circuits as tcircuits

torch.set_num_threads(2)

P = tpv.P


@pytest.fixture(scope="module")
def pk_bin(tmp_path_factory):
    client = tpv.Client.generate(tpv.small_test_params(), device="cpu")
    path = str(tmp_path_factory.mktemp("svc") / "pk.bin")
    tpv.save_pk(client.pk, path)
    return client, path


@pytest.fixture(scope="module")
def roles(pk_bin):
    client, path = pk_bin
    pk_e = tpv.load_pk(path, device="cpu")
    pk_e.prm = dataclasses.replace(client.pk.prm)
    ek = client.evaluation_key(pool_size=2, depth_hint=1)
    return client, tpv.Evaluator(pk_e, ek)


def test_client_roundtrips(roles):
    client, _ = roles
    assert client.decrypt(client.encrypt(5)[0]) == [5]
    assert client.decrypt(client.encrypt(range(3))) == [0, 1, 2]
    assert client.decrypt_text(client.encrypt_text("evaluator")) == "evaluator"
    ev = client.evaluator()
    assert ev.pk is client.pk and ev.ek is None


def test_evaluator_holds_the_clients_public_key(roles):
    client, ev = roles
    a, b = ev.pk, client.pk
    assert (a.canon_tag, a.H_digest, a.omega_B, a.powg_B) == \
        (b.canon_tag, b.H_digest, b.omega_B, b.powg_B)
    assert (a.H == b.H).all() and (a.ubk.perm == b.ubk.perm).all()
    assert not hasattr(a, "_engine")


def test_every_evaluator_method(roles):
    client, ev = roles
    a, b = client.encrypt([42, 7])
    got = client.decrypt([ev.add(a, b), ev.sub(a, b), ev.neg(b), ev.mul(a, b),
                          *ev.mul_batch([(a, a), (b, b)]), ev.scale(a, 3),
                          ev.div_const(a, 7), ev.recrypt(ev.mul(a, b))])
    assert got == [49, 35, P - 7, 294, 1764, 49, 126, 6, 294]


def test_pk_bin_alone_keeps_the_default_n_bits(pk_bin):
    """Without the client's Params the loaded key has n_bits 16384 beside
    an H of 1024 columns: the σ-free methods still compute, and ct_mul
    raises, naming n_bits, before any σ row is drawn."""
    client, path = pk_bin
    ev = tpv.Evaluator(tpv.load_pk(path, device="cpu"))
    assert ev.pk.prm.n_bits == tpv.Params().n_bits != ev.pk.H.shape[0]
    a, b = client.encrypt([9, 4])
    assert client.decrypt([ev.add(a, b), ev.sub(a, b), ev.scale(b, 5)]) == [13, 5, 20]
    with pytest.raises(ValueError, match="n_bits"):
        ev.mul(a, b)


def test_recrypt_without_evalkey_raises(roles):
    client, ev = roles
    with pytest.raises(ValueError, match="EvalKey"):
        tpv.Evaluator(ev.pk).recrypt(client.encrypt(1)[0])


@pytest.fixture(scope="module")
def both():
    jpk, jsk = jpv.keygen(jpv.small_test_params())
    pkf = dict(prm=dataclasses.asdict(jpk.prm), canon_tag=jpk.canon_tag, H=jpk.H,
               ubk_perm=jpk.ubk.perm, ubk_inv=jpk.ubk.inv, H_digest=jpk.H_digest,
               omega_B=jpk.omega_B, powg_B=jpk.powg_B)
    return (jpk, jsk), tpv.keys_from_numpy(
        pkf, dict(prf_k=jsk.prf_k, lpn_s_bits=jsk.lpn_s_bits), device="cpu")


XS, YS = [3, 1 << 40, 5, P - 2], [7, 11, 1 << 60, 2]
WANT = sum(x * y for x, y in zip(XS, YS)) % P


def test_dot_product_of_jax_inputs(both, tmp_path):
    """JAX encrypts; the port's evaluator computes; both decrypt."""
    (jpk, jsk), (pk, sk) = both
    path = str(tmp_path / "in.ct")
    jpv.save_cts(jpv.enc_value_batch(jpk, jsk, XS + YS), path)
    cts = tpv.load_cts(path)
    out = tcircuits.dot_product(pk, cts[:len(XS)], cts[len(XS):])
    tpv.save_cts([out], str(tmp_path / "out.ct"))
    assert tpv.dec_value_batch(pk, sk, [out]) == [WANT]
    assert jpv.dec_value_batch(jpk, jsk, jpv.load_cts(str(tmp_path / "out.ct"))) == [WANT]


def test_dot_product_of_port_inputs_in_jax(both, tmp_path):
    """The port encrypts; the JAX package computes; both decrypt."""
    (jpk, jsk), (pk, sk) = both
    path = str(tmp_path / "in.ct")
    tpv.save_cts(tpv.Client(pk, sk).encrypt(XS + YS), path)
    cts = jpv.load_cts(path)
    out = jcircuits.dot_product(jpk, cts[:len(XS)], cts[len(XS):])
    jpv.save_cts([out], str(tmp_path / "out.ct"))
    assert jpv.dec_value_batch(jpk, jsk, [out]) == [WANT]
    assert tpv.dec_value_batch(pk, sk, tpv.load_cts(str(tmp_path / "out.ct"))) == [WANT]


def test_evaluator_circuits_decrypt_to_their_plaintexts(roles):
    """dot_product, matvec and mean_and_scaled_variance on the evaluator's
    key, decrypted by the client, against the plaintext circuits mod p."""
    client, ev = roles
    xs, ys = [3, 1 << 40, 5], [7, 11, P - 2]
    rows = [[1, 2, 3], [65535, 0, 9]]
    cts = client.encrypt(xs + ys)
    S, V = ev.mean_and_scaled_variance(cts[3:])
    got = client.decrypt([ev.dot_product(cts[:3], cts[3:]), *ev.matvec(cts[:3], rows), S, V])
    s = sum(ys)
    assert got == ([sum(a * b for a, b in zip(xs, ys)) % P]
                   + [sum(k * a for k, a in zip(r, xs)) % P for r in rows]
                   + [s % P, (3 * sum(y * y for y in ys) - s * s) % P])


def test_evaluator_circuits_run_every_product_through_mul_batch(roles):
    """A wrapped mul_batch (as the benchmark's faults wrap it) sees every
    product of the three circuits: n, none, and n + 1."""
    client, ev = roles
    cts = client.encrypt([2, 3, 4, 5])
    seen = []
    ev.mul_batch = lambda pairs: seen.append(len(pairs)) or tpv.Evaluator.mul_batch(ev, pairs)
    try:
        dot = ev.dot_product(cts[:2], cts[2:])
        assert seen == [2]
        ev.matvec(cts, [[1, 2, 3, 4]])
        assert seen == [2]
        ev.mean_and_scaled_variance(cts[:2])
        assert seen == [2, 2, 1]
    finally:
        del ev.mul_batch
    assert client.decrypt(dot) == [2 * 4 + 3 * 5]
