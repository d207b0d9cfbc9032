"""On the card: each cell runs once with a short window and comes out
correct, and the control fails at the cell's size. Skips without a card.

    python -m pytest -q -m torch portbench/tests
"""
from __future__ import annotations

import torch
import pytest

from portbench import control
from portbench.tests.conftest import REPO
from portbench.tests.test_portbench_harness import TOP

CELLS = ["grid512-grabcut.b32", "assign512-u100.b64"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.torch
@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_on_card(card, cell, capsys):
    """A run as the benchmark makes it, at its ``run_seconds``: a shorter
    window may close before the grid's first clip is answered."""
    import json

    from portbench import run
    seconds = json.loads((REPO / "BENCHMARK.json").read_text())[
        "run_seconds"]
    assert run.main(["--workload", cell, "--seed", "20260001",
                     "--seconds", str(seconds), "--trace", "0"],
                    root=REPO) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == TOP and res["correct"] is True
    assert res["device"]["platform"] == "gpu"


@pytest.mark.torch
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_card(card, cell):
    assert control.readings(REPO, cell, 20260002, card)["control_failed"]
