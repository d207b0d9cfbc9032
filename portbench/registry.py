"""Finds the benchmark's parts by the names ``BENCHMARK.json`` gives.

Nothing here lists a configuration, traffic mix, loop, generator, kind or
metric: each is a file found by its name, so a later change adds a cell
or a metric by adding files alone.

* a cell's configuration: the ``file`` of its entry under ``configs``;
* a traffic mix: ``traffic/<traffic>.json``;
* a loop shape: ``loops/<loop>.py``, named by the traffic file;
* an instance generator: ``generators/<generator>.py``, named by the
  configuration; a solver kind: ``kinds/<kind>.py``, likewise;
* a metric: ``metrics/<metric>.py``, with a ``read(run)`` function.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
import sys
from types import ModuleType

class Bench:
    """``BENCHMARK.json`` under ``root`` and the files beside it; the
    pluggable parts are read from ``root / "portbench"``."""

    def __init__(self, root: pathlib.Path):
        self.root = pathlib.Path(root)
        self.pkg = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        known = ", ".join(w["name"] for w in self.spec["workloads"])
        raise KeyError(f"no workload {name!r}; known: {known}")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r}")

    def traffic(self, name: str) -> dict:
        return json.loads((self.pkg / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones
        without the trace, the per-layer ones with it; a metric with a
        ``workloads`` list only in those cells."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def part(self, group: str, name: str) -> ModuleType:
        """The module ``<group>/<name>.py``, loaded from its file."""
        return load_file(self.pkg / group / f"{name}.py",
                         f"portbench_{group}_{name}")


def load_file(path: pathlib.Path, name: str) -> ModuleType:
    """Import the Python file at ``path`` under a module name made from
    ``name``; a name may hold dots, which a module name may not."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    modname = re.sub(r"[^0-9A-Za-z_]", "_", name)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod
