"""Resolve a cell of ``BENCHMARK.json`` to the files that define it, by
name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` for every metric the cell reports, and
``counts/<count>.py`` for the configuration's floor count.  A later cell,
configuration, traffic mix or metric is added as files and entries of
these names; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
SPEC = os.path.join(ROOT, "BENCHMARK.json")


def load_spec(path: str = SPEC) -> dict:
    with open(path) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` as a module (the name may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One workload with its configuration, traffic and metrics."""

    def __init__(self, name: str, spec: dict = None):
        spec = spec or load_spec()
        rows = [w for w in spec["workloads"] if w["name"] == name]
        if len(rows) != 1:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        self.row = rows[0]
        self.name, self.chips = name, self.row["chips"]
        self.config = _json("configs", self.row["config"])
        self.traffic = _json("traffic", self.row["traffic"])
        self.end_to_end: List[dict] = [m for m in spec["end_to_end"]
                                       if _applies(m, name)]
        self.per_layer: List[dict] = [m for m in spec["per_layer"]
                                      if _applies(m, name)]

    def files(self) -> List[str]:
        """Every file this cell reads, relative to the benchmark folder."""
        out = [f"configs/{self.row['config']}.json",
               f"traffic/{self.row['traffic']}.json",
               f"counts/{self.config['count']}.py"]
        out += [f"metrics/{m['name']}.py"
                for m in self.end_to_end + self.per_layer]
        if "lens_file" in self.config["camera"]:
            out.append(f"configs/{self.config['camera']['lens_file']}")
        return out

    def path(self, rel: str) -> str:
        return os.path.join(HERE, rel)
