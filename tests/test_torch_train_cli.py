"""The port's train CLI (``python -m repro_torch.launch.train``) on the
CPU: its report lines, checkpoint / resume and preemption.

The JAX CLI does not run here (its mesh setup fails on explicit-axis
sharding, ROADMAP §3 F1), so the port is held to the resume contract
itself: a run stopped after 4 steps and resumed to 6 ends with the same
train state, bit for bit, as 6 uninterrupted steps (the data rows are a
function of the step, every CPU operation is deterministic).
"""
import numpy as np
import pytest
import torch_mesh_ranks as ranks

from repro_torch.launch import train as cli
from repro_torch.runtime import ft

BASE = ["--arch", "smollm-135m", "--smoke", "--batch", "2", "--seq", "32",
        "--ckpt-every", "3", "--device", "cpu"]


def _run(capsys, *args):
    cli.main([*BASE, *args])
    return capsys.readouterr().out


def _leaves(path):
    z = np.load(path / "shard_0.npz")
    return [z[f"leaf_{i}"] for i in range(len(z.files))]


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, capsys):
    a, b = tmp_path / "a", tmp_path / "b"
    out = _run(capsys, "--steps", "4", "--ckpt-dir", str(a))
    assert "step 0: loss=" in out and "step 3: loss=" in out
    assert f"[ckpt] step 3 -> {a}/step_00000003" in out
    assert f"[ckpt] step 4 -> {a}/step_00000004" in out
    out = _run(capsys, "--steps", "6", "--ckpt-dir", str(a), "--resume",
               "auto")
    assert f"[resume] restored step 4 from {a}" in out
    assert "step 0:" not in out and "step 5: loss=" in out
    _run(capsys, "--steps", "6", "--ckpt-dir", str(b))
    got = _leaves(a / "step_00000006")
    want = _leaves(b / "step_00000006")
    assert len(got) == len(want) > 100
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    assert int(got[0]) == 6            # the optimizer's step, leaf 0


def test_preemption_checkpoints_and_exits(tmp_path, capsys, monkeypatch):
    enter = ft.PreemptionGuard.__enter__

    def preempted(self):
        enter(self)
        self.requested = True
        return self
    monkeypatch.setattr(cli.PreemptionGuard, "__enter__", preempted)
    out = _run(capsys, "--steps", "5", "--ckpt-dir", str(tmp_path))
    assert f"[ckpt] step 1 -> {tmp_path}/step_00000001" in out
    assert "[preempt] checkpoint written, exiting cleanly" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000001"]


def test_watchdog_line(capsys, monkeypatch):
    monkeypatch.setattr(cli.StepWatchdog, "stop", lambda self, step: (
        self.times.append(0.5), self.slow_steps.append((step, 0.5, 0.1)),
        True)[-1])
    out = _run(capsys, "--steps", "2", "--microbatches", "2")
    assert "[STRAGGLER]" in out
    assert "[watchdog] 2 straggler steps (median 500ms)" in out


@pytest.mark.parametrize("model_parallel", [2, 3])
def test_model_parallel(tmp_path, capsys, model_parallel):
    """``torchrun --nproc-per-node 2 ... --model-parallel 2``: two CPU
    ranks on a 1 x 2 mesh train 3 steps and write the whole state, which
    matches the one-rank run's within 1e-4 of each leaf's largest |value|
    (other summation orders), the step counter exactly;
    ``--model-parallel 3`` does not divide the 2 ranks, and
    ``make_host_mesh`` refuses it."""
    mesh = ["--model-parallel", str(model_parallel), "--steps", "3"]
    if model_parallel == 3:
        run = ranks.torchrun("repro_torch.launch.train", 2, [*BASE, *mesh])
        assert run.returncode != 0
        assert "--model-parallel 3 does not divide the 2 ranks" in run.stderr
        return
    a, b = tmp_path / "a", tmp_path / "b"
    _run(capsys, "--steps", "3", "--ckpt-dir", str(a))
    run = ranks.torchrun("repro_torch.launch.train", 2,
                         [*BASE, *mesh, "--ckpt-dir", str(b)])
    assert run.returncode == 0, run.stderr[-4000:]
    out = run.stdout
    assert "step 0: loss=" in out and "step 2: loss=" in out
    assert out.count("step 0: loss=") == 1          # rank 0 prints
    got, want = _leaves(b / "step_00000003"), _leaves(a / "step_00000003")
    assert len(got) == len(want) > 50
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=1e-4 * max(np.abs(y).max(), 1e-30))


def test_refuses_the_encoder(tmp_path, capsys):
    """The encoder, refused before it was ported, now trains: hubert's
    smoke variant on the pipeline's frame rows, 2 steps in one run, and
    1 step then a resume to 2, ending in the same train state bit for
    bit."""
    enc = ["--arch", "hubert-xlarge", "--smoke", "--batch", "2", "--seq",
           "32", "--ckpt-every", "1", "--device", "cpu"]
    a, b = tmp_path / "a", tmp_path / "b"
    cli.main([*enc, "--steps", "2", "--ckpt-dir", str(a)])
    out = capsys.readouterr().out
    assert "step 0: loss=" in out and "step 1: loss=" in out
    cli.main([*enc, "--steps", "1", "--ckpt-dir", str(b)])
    cli.main([*enc, "--steps", "2", "--ckpt-dir", str(b), "--resume",
              "auto"])
    out = capsys.readouterr().out
    assert f"[resume] restored step 1 from {b}" in out
    assert "step 1: loss=" in out
    got, want = _leaves(b / "step_00000002"), _leaves(a / "step_00000002")
    assert len(got) == len(want) > 50
    assert all(x.dtype == y.dtype and x.tobytes() == y.tobytes()
               for x, y in zip(got, want))


def test_n_layers_and_router(capsys):
    """``--n-layers`` cuts the depth; ``--router`` picks phi's router."""
    cli.main(["--arch", "phi3.5-moe-42b-a6.6b", "--smoke",
              "--n-layers", "1", "--router", "topk", "--batch", "2",
              "--seq", "16", "--steps", "1", "--device", "cpu",
              "--quantize-moments", "--grad-dtype", "bf16"])
    assert "step 0: loss=" in capsys.readouterr().out
