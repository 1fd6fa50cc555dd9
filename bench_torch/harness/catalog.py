"""Find what a benchmark cell is made of, by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix; everything else sits in files of its own under the
benchmark's folder, found by the name alone:

  configs/<config>.json   the scene's numbers, the program's entry points,
                          the site table its spans hook, the source
  traffic/<traffic>.json  the loop's parameters (transfer, dt, rate,
                          checking interval, warm-up steps, render_every)
  sites/<name>.json       (module, function, label) of each stage call a
                          traced run wraps in a span
  metrics/<metric>.py     the reader of one per-layer metric: read(trace),
                          and optionally capture(captured)
  references/<name>.py    the plain reference of a transfer, named by the
                          configuration's transfer entry ("reference"):
                          FIELDS, the state's fields compared, in order, and
                          step(scene, state, dt, dtype); imports torch, numpy
                          and the benchmark's own files, never the program
  faults/<name>.py        the faults planted in that transfer's program
                          (harness/faults.py), by the same name: SITES =
                          (module, step, P2G site, update site) and
                          half_batch(orig); may import the program

A later cell, mix, metric, reference or fault table is a new file and a
new entry; no code here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class CatalogError(Exception):
    """A name that BENCHMARK.json or the benchmark's folder does not hold."""


def _json(path: Path):
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as exc:
        raise CatalogError(f"{path} is missing") from exc


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise CatalogError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str, root: Path = BENCH) -> dict:
    return _json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = BENCH) -> dict:
    return _json(root / "traffic" / f"{name}.json")


def sites(name: str, root: Path = BENCH) -> list[tuple[str, str, str]]:
    return [tuple(row) for row in _json(root / "sites" / f"{name}.json")]


def _module(folder: str, name: str, root: Path):
    """The Python file <folder>/<name>.py, loaded as a module of its own
    and listed in sys.modules under that name, as a dataclass in it needs."""
    path = root / folder / f"{name}.py"
    if not path.exists():
        raise CatalogError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"bench_{folder}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = BENCH):
    """The module metrics/<name>.py: ``read(trace)`` gives the metric or
    None; an optional ``capture(captured)`` takes facts from a traced
    step's stage inputs."""
    return _module("metrics", name, root)


def reference(name: str, root: Path = BENCH):
    """The module references/<name>.py: ``FIELDS`` and
    ``step(scene, state, dt, dtype=torch.float32)``, which takes the
    configuration's ``scene`` dict as it stands and returns the new state's
    FIELDS in float32."""
    return _module("references", name, root)


def faults(name: str, root: Path = BENCH):
    """The module faults/<name>.py: ``SITES`` and ``half_batch(orig)``."""
    return _module("faults", name, root)


def end_to_end(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics the cell reports: those without a workloads
    key, and those that list it."""
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics the cell's traced run reports: those that list
    it, and those without a workloads key whose ``moves`` the cell reports."""
    moved = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]
