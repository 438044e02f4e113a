"""``BENCHMARK.json`` and the files it names.

A cell of ``workloads`` names a configuration and a traffic mix; the
harness finds each by that name and nothing else:

- ``benchmark/configs/<config>.json``: the configuration as it is run, and
  ``benchmark/configs/<config>.py`` beside it, whose ``meshes()`` makes its
  geometry;
- ``benchmark/traffic/<mix>.json``: the mix's parameters, read by
  ``rtbench/traffic.py``; its ``kind`` picks the driver (``orbit``,
  ``train``);
- ``benchmark/limits/<cell>.json``: the limits of the cell's check;
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(ctx) -> float or None``.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def module(path: str, name: str):
    """A Python file loaded by path (metric and geometry names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(*parts) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config_name = self.entry["config"]
        self.traffic_name = self.entry["traffic"]
        self.config = _json("configs", f"{self.config_name}.json")
        self.mix = _json("traffic", f"{self.traffic_name}.json")
        self.limits = _json("limits", f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if _for_cell(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _for_cell(m, name)]

    def geometry(self):
        path = os.path.join(BENCH_DIR, "configs", f"{self.config_name}.py")
        return module(path, f"bench_geometry_{self.config_name}").meshes

    def reader(self, metric: str):
        path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
        return module(path, "bench_metric_" + metric.replace(".", "_")).read


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    return Cell(bench if bench is not None else load(), name)
