"""run.py's exits: no result without a card, without the program, or for a
cell the manifest does not name."""
import shutil
import subprocess
import sys

import pytest

from portbench import manifest, run

ROOT = manifest.ROOT


def run_py(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure")


def test_exits_without_a_card(no_card):
    r = run_py(ROOT, "--workload", "enc-bulk", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert r.returncode not in (0, None) and r.stdout == ""
    assert "no result" in r.stderr


def test_exits_for_an_unknown_cell():
    r = run_py(ROOT, "--workload", "no-such-cell", "--seed", "1", "--seconds", "1")
    assert r.returncode == 2 and r.stdout == ""


def test_exits_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run_py(tmp_path, "--workload", "enc-bulk", "--seed", "1", "--seconds", "1")
    assert r.returncode == 2 and r.stdout == "" and "not in" in r.stderr


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pvac_hfhe_cppbyv_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "pvac_hfhe_cppbyv_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]
