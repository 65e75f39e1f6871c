"""``BENCHMARK.json`` and the files it names, found by name.

Nothing here names a cell, a configuration or a metric: a new one is a new
file and a new entry in the manifest.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


class ManifestError(Exception):
    pass


def load(root: pathlib.Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise ManifestError(f"{path} not found")
    return json.loads(path.read_text())


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise ManifestError(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise ManifestError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    path = HERE / "traffic" / f"{name}.json"
    if not path.exists():
        raise ManifestError(f"no traffic mix {path}")
    return json.loads(path.read_text())


def metrics_for(man: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones.  A metric without ``workloads``
    belongs to every cell."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def load_module(path: pathlib.Path, name: str):
    """Import a file whose name need not be a Python identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{metric_name}.py"
    if not path.exists():
        raise ManifestError(f"no reader {path}")
    return load_module(path, f"portbench_metric_{metric_name.replace('.', '_')}").read


def loop(loop_name: str):
    """The module ``loops/<name>.py``."""
    if not (HERE / "loops" / f"{loop_name}.py").exists():
        raise ManifestError(f"no loop {loop_name!r} under portbench/loops")
    return importlib.import_module(f"portbench.loops.{loop_name}")


def roofline(kernel: str) -> dict:
    return json.loads((HERE / "roofline" / f"{kernel}.json").read_text())


def peaks() -> dict:
    return json.loads((HERE / "peaks.json").read_text())
