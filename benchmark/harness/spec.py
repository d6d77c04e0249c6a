"""Finds a cell's pieces by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``), the limits of its check
(``limits/<cell>.json``) and the reader of each per-layer metric
(``metrics/<metric>.py``).  A later change adds a cell, a configuration,
a mix or a metric by adding files and entries, never by editing code."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return _json(BENCH_DIR / "limits" / f"{cell}.json")


def metrics_for(entries: list, cell: str) -> list:
    """The metric entries that apply to ``cell``: those without a
    ``workloads`` key and those that list it."""
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """The module ``metrics/<name>.py``; its ``read(trace)`` returns the
    metric's value, or ``None`` when the trace holds nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
