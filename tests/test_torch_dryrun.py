"""The port's dry run (``repro_torch.launch.specs``, ``.dryrun``) on the
``meta`` device.

The cells and skips are the reference's (``repro.launch.specs``) for all
10 archs x 4 shapes; building a cell allocates nothing off ``meta``;
smollm-135m's four cells count; K6's count on ``meta`` is the formula in
``repro_torch.roofline``; and the CLI prints its row. The reference's own
CLI and host-mesh dry-run tests fail under jax 0.9.0 (ROADMAP §3 F1), so
the port is held to its own contract there.
"""
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.launch import specs as jspecs
from repro_torch.configs.base import get_config
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.launch.dryrun import LM_ARCHS, run_cell
from repro_torch.launch.specs import SHAPES, build_cell, cell_skip_reason
from repro_torch.roofline import flash_attention_work
from repro_torch.roofline_hlo import _tensors, analyze

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_shapes_and_skips_equal_reference(arch):
    assert SHAPES == jspecs.SHAPES
    for shape in SHAPES:
        assert (cell_skip_reason(get_config(arch), shape)
                == jspecs.cell_skip_reason(jax_get_config(arch), shape))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_build_cell_stays_on_meta(arch):
    """Every tensor a cell holds (parameters, caches, inputs) is on
    ``meta``: nothing is allocated, even for nemotron's 340 B."""
    shape = "prefill_32k" if get_config(arch).frontend_dim else "decode_32k"
    cell = build_cell(arch, shape)
    ts = _tensors(cell.args)
    assert ts and {t.device.type for t in ts} == {"meta"}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_run_cell_smollm(shape):
    r = run_cell("smollm-135m", shape, verbose=False)
    if shape == "long_500k":
        assert r["status"] == "skip"
        return
    assert r["status"] == "ok", r
    assert r["mesh"] == "1" and r["chips"] == 1
    assert r["flops_per_chip"] > 0 and r["bytes_per_chip_accessed"] > 0
    assert r["bytes_per_chip"] >= r["entry_bytes"] > 0
    assert r["collective_bytes_per_chip"] == 0.0
    n_layers = get_config("smollm-135m").n_layers
    # K6: once a layer in a prefill, never in decode; the train step's
    # recompute (remat "full") runs every layer's attention twice
    want = {"train": 2 * n_layers, "prefill": n_layers, "decode": 0}
    assert r["k6_launches"] == want[SHAPES[shape]["kind"]]
    assert r["bottleneck"] in ("compute", "memory")


@pytest.mark.parametrize("dims,causal,lse,dtype", [
    ((2, 1024, 1024, 9, 3, 64, 64), True, False, torch.bfloat16),
    ((2, 300, 500, 8, 2, 192, 128), True, True, torch.float32),
    ((1, 512, 256, 4, 4, 80, 80), False, True, torch.float32),
])
def test_k6_count_on_meta_is_the_roofline_formula(dims, causal, lse, dtype):
    B, Sq, Sk, H, KV, dh, dv = dims
    q = torch.empty((B, Sq, H, dh), dtype=dtype, device="meta")
    k = torch.empty((B, Sk, KV, dh), dtype=dtype, device="meta")
    v = torch.empty((B, Sk, KV, dv), dtype=dtype, device="meta")
    acc = analyze(lambda q, k, v: flash_attention_fwd(
        q, k, v, causal=causal, return_lse=lse), q, k, v)
    pairs, flops, nbytes = flash_attention_work(
        B, Sq, Sk, H, KV, dh, dv, causal=causal,
        itemsize=q.element_size(), lse=lse)
    assert acc["by_op"]["repro_torch.flash_attention_fwd"] == {
        "count": 1, "flops": flops, "bytes": nbytes}
    assert acc["flops"] == flops
    assert pairs == B * H * (sum(min(i + 1, Sk) for i in range(Sq))
                             if causal else Sq * Sk)


def test_meta_never_reaches_the_plain_version():
    """A ``meta`` tensor takes the card's branch: one K6 op, never the
    plain version's products."""
    q = torch.empty((1, 64, 2, 16), device="meta")
    acc = analyze(lambda q: flash_attention_fwd(q, q, q), q)
    assert set(acc["by_op"]) == {"repro_torch.flash_attention_fwd"}


def test_dryrun_cli_single_cell():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k"],
        capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert "[ok] smollm-135m/decode_32k mesh=1" in proc.stdout
    assert "1 cells: 1 ok, 0 skip, 0 error" in proc.stdout
