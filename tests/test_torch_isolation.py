"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
card-only variant scripts import neither ``jax`` nor anything of the JAX
package ``repro``, and the smoke script refuses to run without a card or
without the repository.
"""
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?![\w])",
                        re.M)


def _run(code: str, **kw) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, **kw)


def test_import_pulls_in_neither_jax_nor_repro():
    """Every module imports, and the registry's lazy builtin imports
    resolve, without ``jax`` or ``repro`` in ``sys.modules``."""
    code = (
        "import sys\n"
        "import repro_torch.core.maxflow.grid, repro_torch.interop\n"
        "import repro_torch.kernels.grid_push.ops\n"
        "import repro_torch.kernels.bfs_relabel.ops\n"
        "import repro_torch.core.assignment.cost_scaling\n"
        "import repro_torch.core.assignment.ref\n"
        "import repro_torch.core.matching, repro_torch.core.matching.bfs\n"
        "import repro_torch.kernels.bidding.ops\n"
        "import repro_torch.kernels.frontier.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.configs.all, repro_torch.models.model\n"
        "import repro_torch.serve.engine, repro_torch.launch.serve\n"
        "import repro_torch.core, repro_torch.core.kinds\n"
        "import repro_torch.core.batch, repro_torch.core.refill\n"
        "import repro_torch.core.solver_loop\n"
        "import repro_torch.core.warm, repro_torch.checkpoint.store\n"
        "import repro_torch.core.routing, repro_torch.models.mlp\n"
        "import repro_torch.models.mamba\n"
        "import repro_torch.launch.mesh\n"
        "import repro_torch.obs, repro_torch.serve.metrics\n"
        "import repro_torch.serve.scheduler\n"
        "import repro_torch.optim.adamw, repro_torch.train.step\n"
        "import repro_torch.data.pipeline, repro_torch.runtime.ft\n"
        "import repro_torch.launch.train\n"
        "import repro_torch.roofline, repro_torch.roofline_hlo\n"
        "import repro_torch.launch.specs, repro_torch.launch.dryrun\n"
        "from repro_torch.launch.mesh import (make_host_mesh, spawn,\n"
        "    make_production_mesh, init_ranks, mesh_backend, batch_spec)\n"
        "from repro_torch.models.layers import Sharder, DEFAULT_RULES\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "from repro_torch.core.kinds import get_kind, registered_kinds\n"
        "assert get_kind('matching').name == 'matching'\n"
        "assert registered_kinds() == ('maxflow', 'assignment', 'matching')\n"
        "assert get_kind('maxflow').warm_state is not None\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = _run(code, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# the card-only variant scripts, and the mesh tests' ranks, import no jax
_CARD_SCRIPTS = ["tests/torch_smoke_k4_variants.py",
                 "tests/torch_smoke_k5_variants.py",
                 "tests/torch_smoke_k6_ablation.py",
                 "tests/torch_smoke_train_rows.py",
                 "tests/torch_mesh_ranks.py",
                 "tests/torch_mesh_gloo_probe.py",
                 "tests/torch_smoke_mesh.py"]


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in PORT.rglob("*.py")]
    + [pathlib.Path(p) for p in ["chip_smoke.py", *_CARD_SCRIPTS]]),
    ids=str)
def test_source_has_no_jax_or_repro_import(path):
    found = _FORBIDDEN.findall((ROOT / path).read_text())
    assert not found, f"{path} imports {found}"


def test_chip_smoke_fails_without_card():
    """No CUDA device: non-zero exit and nothing on standard output."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
        text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                     "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
