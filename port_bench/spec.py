"""Cells, configurations, traffic mixes and metric readers, each found by
its name: ``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<mix>.json`` and ``metrics/<metric>.py`` under this folder, and
the cell's metrics from ``BENCHMARK.json`` at the checkout's root."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    return _load("workloads", name)


def config(name: str) -> dict:
    return _load("configs", name)


def traffic(name: str) -> dict:
    return _load("traffic", name)


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(cell: str, section: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries of BENCHMARK.json that
    cell ``cell`` reports: those without ``workloads`` and those that list
    it."""
    return [m for m in benchmark()[section]
            if cell in m.get("workloads", [cell])]


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{metric.replace('.', '_')}", path)
    if spec is None:
        raise FileNotFoundError(f"no reader for metric {metric!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
