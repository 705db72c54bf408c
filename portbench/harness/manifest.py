"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics; each lives in a file of its own under ``portbench/``:
``workloads/<cell>.json``, the configuration's ``file``,
``programs/<program>.py`` (the workload's ``program``) and
``metrics/<metric>.py``. A new cell, configuration or metric is new files
and new entries, never an edit."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Optional

ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _module(path: Path, prefix: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def program(name: str, root: Path = ROOT) -> ModuleType:
    return _module(root / "portbench" / "programs" / f"{name}.py", "portbench_program_")


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    return _module(root / "portbench" / "metrics" / f"{metric}.py", "portbench_metric_")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One workload with its configuration and metrics."""

    def __init__(self, name: str, bench: Optional[dict] = None, root: Path = ROOT):
        bench = bench if bench is not None else benchmark(root)
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.workload = load_json(root / "portbench" / "workloads" / f"{name}.json")
        self.root = root
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if applies(m, name) and m["moves"] in e2e]
        self.chips = int(self.entry["chips"])
        self.run_seconds = int(bench["run_seconds"])
