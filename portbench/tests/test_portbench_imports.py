"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and the
reference loads nothing of the program."""
import json
import subprocess
import sys

from portbench import manifest

ROOT = manifest.ROOT
FORBIDDEN = ["jax", "jaxlib", "flax", "pvac_hfhe_cppbyv_tpu"]

LOAD_ALL = """
import importlib, json, pathlib, sys
sys.path.insert(0, {root!r})
here = pathlib.Path({root!r}) / "portbench"
from portbench import manifest
for p in sorted(here.rglob("*.py")):
    rel = p.relative_to(here.parent)
    if "tests" in rel.parts:
        continue
    if p.parent.name == "metrics":
        manifest.reader(p.stem)
    else:
        importlib.import_module(".".join(rel.with_suffix("").parts).replace(".__init__", ""))
import pvac_hfhe_cppbyv_tpu_torch  # what a run loads besides
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.scheme
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_names(code):
    r = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=300, cwd="/")
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_no_jax_in_what_a_run_loads():
    names = top_names(LOAD_ALL)
    assert "pvac_hfhe_cppbyv_tpu_torch" in names and "portbench" in names
    assert names.isdisjoint(FORBIDDEN), names & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = top_names(LOAD_REFERENCE)
    assert "pvac_hfhe_cppbyv_tpu_torch" not in names
    assert names.isdisjoint(FORBIDDEN)


def test_no_source_reads_the_old_benchmark():
    for p in (ROOT / "portbench").rglob("*.py"):
        if "tests" in p.parts:
            continue
        text = p.read_text()
        assert "BENCH_r" not in text and "benchmarks/" not in text, p
        assert "import jax" not in text and "from jax" not in text, p
