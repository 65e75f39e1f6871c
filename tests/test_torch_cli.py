"""The port's CLI (cli.py, __main__.py) on the CPU at small Params: the
flow of tests/test_cli.py in-process through ``cli.main([..., "--device",
"cpu"])`` plus mul, enc-text/dec-text and inspect -v; one run as a
subprocess; a KEYDIR and .ct written by the port and read by the JAX CLI,
and the reverse, with the KEYDIR files re-saved byte for byte by the
other package; and, where there is no card, the default device exits
non-zero naming it.  Tolerance 0."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import pvac_hfhe_cppbyv_tpu as jpv
from pvac_hfhe_cppbyv_tpu import cli as jcli
import pvac_hfhe_cppbyv_tpu_torch as tpv
from pvac_hfhe_cppbyv_tpu_torch import cli as tcli

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).parent.parent
CPU = ["--device", "cpu"]


def _run(main, capsys, *args):
    capsys.readouterr()
    main([str(a) for a in args])
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def keydir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli") / "keys"
    tcli.main(["keygen", str(d), "--small", *CPU])
    return d


def test_cli_flow(keydir, tmp_path, capsys):
    v, s, p = (tmp_path / n for n in ("v.ct", "s.ct", "p.ct"))
    assert "2 cipher(s)" in _run(tcli.main, capsys, "enc", keydir, 11, 31, "-o", v, *CPU)
    assert _run(tcli.main, capsys, "dec", keydir, v, *CPU).split() == ["11", "0", "31", "0"]
    _run(tcli.main, capsys, "add", keydir, v, v, "-o", s, *CPU)
    assert _run(tcli.main, capsys, "dec", keydir, s, *CPU).split() == ["22", "0"]
    _run(tcli.main, capsys, "--device", "cpu", "mul", keydir, v, v, "-o", p)
    assert _run(tcli.main, capsys, "--device", "cpu", "dec", keydir, p).split() == ["121", "0"]
    info = _run(tcli.main, capsys, "inspect", v)
    assert "2 cipher(s)" in info and "density=" in info
    verbose = _run(tcli.main, capsys, "inspect", p, "-v")
    assert "PROD pa=" in verbose and "BASE ztag=" in verbose


def test_cli_text(keydir, tmp_path, capsys):
    t = tmp_path / "t.ct"
    msg = "pvac on the card, 200 bytes or so"
    _run(tcli.main, capsys, "enc-text", keydir, msg, "-o", t, *CPU)
    assert _run(tcli.main, capsys, "dec-text", keydir, t, *CPU) == msg + "\n"


def test_cli_as_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "pvac_hfhe_cppbyv_tpu_torch", "--device", "cpu", "keygen",
         "keys", "--small"], cwd=tmp_path, env=env, capture_output=True, text=True,
        check=True).stdout
    assert "pklite.bin, sk.bin, params.json" in out
    assert {p.name for p in (tmp_path / "keys").iterdir()} == {"pklite.bin", "sk.bin",
                                                               "params.json"}


def _resaved_by(pkg, keydir, out):
    """The KEYDIR's three files loaded and saved again by ``pkg``."""
    kw = {"device": "cpu"} if pkg is tpv else {}
    out.mkdir()
    pk = pkg.load_pklite(str(keydir / "pklite.bin"), with_H=True, **kw)
    pkg.save_pklite(pk, str(out / "pklite.bin"))
    pkg.save_sk(pkg.load_sk(str(keydir / "sk.bin")), str(out / "sk.bin"))
    pkg.save_params(pkg.load_params(str(keydir / "params.json")), str(out / "params.json"))
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_keydir_and_ct_cross_the_packages(writer, keydir, tmp_path, capsys):
    """A KEYDIR and a product written by one package's CLI decrypt through
    the other's; the other package re-saves the KEYDIR byte for byte."""
    (wmain, wcpu), (rmain, rcpu), rpkg = (
        ((tcli.main, CPU), (jcli.main, []), jpv) if writer == "port"
        else ((jcli.main, []), (tcli.main, CPU), tpv))
    kd = keydir
    if writer == "jax":
        kd = tmp_path / "jkeys"
        _run(jcli.main, capsys, "keygen", kd, "--small")
    v, p = tmp_path / "v.ct", tmp_path / "p.ct"
    _run(wmain, capsys, "enc", kd, 6, 7, "-o", v, *wcpu)
    _run(rmain, capsys, "mul", kd, v, v, "-o", p, *rcpu)
    assert _run(wmain, capsys, "dec", kd, p, *wcpu).split() == ["36", "0"]
    assert _run(rmain, capsys, "dec", kd, v, *rcpu).split() == ["6", "0", "7", "0"]
    again = _resaved_by(rpkg, kd, tmp_path / "again")
    for name in ("pklite.bin", "sk.bin", "params.json"):
        assert (again / name).read_bytes() == (kd / name).read_bytes(), name


@pytest.mark.parametrize("cmd", ["keygen", "enc", "dec"])
def test_default_device_is_the_card(cmd, keydir, tmp_path, capsys):
    """Without --device the CLI computes on the card; where there is none
    it exits non-zero and names the device, and writes nothing."""
    ct = tmp_path / "x.ct"
    _run(tcli.main, capsys, "enc", keydir, 5, "-o", ct, *CPU)
    out = tmp_path / "out"
    args = {"keygen": ["keygen", out, "--small"], "enc": ["enc", keydir, 1, "-o", out],
            "dec": ["dec", keydir, ct]}[cmd]
    if torch.cuda.is_available():
        _run(tcli.main, capsys, *args)
        return
    with pytest.raises(SystemExit) as e:
        _run(tcli.main, capsys, *args)
    assert e.value.code != 0
    assert "device='cuda'" in capsys.readouterr().err
    assert not out.exists()
