"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary directory whose cells are cut to a size the CPU solves in
seconds, and the program's sources on the path."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

# cell -> (configuration changes, traffic changes) that make it tiny
TINY = {
    "grid512-grabcut.b32": ({"height": 24, "width": 32},
                            {"batch": 4, "pool_batches": 2,
                             "trace_batches": 1}),
    "assign512-u100.b64": ({"n": 24}, {"batch": 4, "pool_batches": 2,
                                       "trace_batches": 1}),
}


def make_tiny_root(dest: pathlib.Path, tiny=TINY) -> pathlib.Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` under ``dest`` with
    every cell's configuration and traffic file cut as ``tiny`` says."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in spec["configs"]}
    for w in spec["workloads"]:
        cfg_change, traffic_change = tiny[w["name"]]
        path = dest / configs[w["config"]]["file"]
        path.write_text(json.dumps({**json.loads(path.read_text()),
                                    **cfg_change}))
        tpath = dest / "portbench" / "traffic" / f"{w['traffic']}.json"
        tpath.write_text(json.dumps({**json.loads(tpath.read_text()),
                                     **traffic_change}))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    (dest / "src").symlink_to(REPO / "src", target_is_directory=True)
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
