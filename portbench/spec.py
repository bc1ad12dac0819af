"""Finds a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names the cells; a cell names a
configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``), and each per-layer metric is read
by ``portbench/metrics/<name>.py``. Adding a cell, a mix or a metric is
adding files: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Any, Dict, List

from portbench.fleet import broker_ids_flag

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def config(name: str) -> Dict[str, Any]:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic(name: str) -> Dict[str, Any]:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def metric_reader(name: str) -> ModuleType:
    """The module ``portbench/metrics/<name>.py`` (names may hold dots, so
    it is loaded from its path)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_name = "portbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, bench: Dict[str, Any], workload: str) -> None:
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
        w = cells[workload]
        self.name = workload
        self.chips = int(w["chips"])
        self.config_name = w["config"]
        self.traffic_name = w["traffic"]
        self.config = config(w["config"])
        self.traffic = traffic(w["traffic"])
        self.end_to_end = self._metrics(bench["end_to_end"])
        self.per_layer = self._metrics(bench["per_layer"])

    def _metrics(self, entries: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        return [m for m in entries
                if "workloads" not in m or self.name in m["workloads"]]

    def client_flags(self) -> List[str]:
        """The planner's flags a client passes: the mix's mode flags, the
        configuration's objective flags, then the cluster's brokers."""
        return list(self.traffic["client_flags"]) + list(
            self.config["planner_flags"]) + [broker_ids_flag(self.config)]
