"""The harness end to end on the CPU at a tiny size: the result line's
keys, files found by name, and a directory without the program."""
from __future__ import annotations

import hashlib
import io
import json
import shutil
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests.conftest import REPO, make_tiny_root

SEED = 2 ** 31 + 12345
TOP = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run_cell(root, cell, trace=0, seconds=0.5, seed=SEED):
    buf = io.StringIO()
    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     str(seconds), "--trace", str(trace)],
                    root=root, device="cpu", out=buf) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["grid512-grabcut.b32",
                                  "assign512-u100.b64"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contract_keys(tiny_root, cell, trace):
    res = run_cell(tiny_root, cell, trace)
    assert set(res) == TOP | ({"breakdown"} if trace else set())
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    group = spec["per_layer" if trace else "end_to_end"]
    names = {m["name"]: m["unit"] for m in group}
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == names[name]
    if not trace:
        assert set(res["metrics"]) == {"solves_per_s", "setup_s"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_without_editing_any(tiny_root):
    """A configuration, a traffic mix and a metric added as new files
    (and entries in BENCHMARK.json) make a new cell that reports the new
    metric; no file of the benchmark changes."""
    before = _digest(tiny_root)
    pkg = tiny_root / "portbench"
    cfg = json.loads((pkg / "configs" / "grid-grabcut-512.json").read_text())
    cfg.update(name="grid-grabcut-tiny", height=16, width=20)
    (pkg / "configs" / "grid-grabcut-tiny.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "grabcut-g5.b2.json").write_text(json.dumps({
        "loop": "closed", "batch": 2, "pool_batches": 2, "trace_batches": 1,
        "instance": {"gamma": 5}, "why": "weak smoothing"}))
    (pkg / "metrics" / "batches_done.py").write_text(
        "def read(run):\n    return float(len(run.window.done))\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "grid-grabcut-tiny", "source": "test",
                            "file": "portbench/configs/grid-grabcut-tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.g5", "config": "grid-grabcut-tiny",
                              "traffic": "grabcut-g5.b2", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "batches_done", "unit": "batches",
                              "better": "higher", "source": "host_clock",
                              "layer": "front end (core/batch.py)",
                              "moves": "solves_per_s",
                              "workloads": ["tiny.g5"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run_cell(tiny_root, "tiny.g5", trace=1)
    assert res["correct"] and res["metrics"]["batches_done"]["value"] >= 1
    assert "K1_roofline" not in res["metrics"]       # not listed for it
    after = _digest(tiny_root)
    assert all(after[k] == v for k, v in before.items())


def test_fails_without_the_program(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: exit non-zero, no
    result line."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "assign512-u100.b64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert "correct" not in p.stdout
