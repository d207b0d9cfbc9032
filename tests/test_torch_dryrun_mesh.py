"""The dry run on the production meshes: rank 0 of a ``fake`` process
group, its shards and its collectives counted on ``meta``.

No JAX here: the reference's dry run on the mesh fails under this jax
(ROADMAP F1); the port's shapes and skips on one card are held to it in
``test_torch_dryrun.py``, its placements in ``test_torch_sharder.py``.
"""
import math

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_model, model_axes
from repro_torch.models.layers import Sharder
from repro_torch.models.model import init_caches
from repro_torch.roofline import LINK_BW, NET_BW, link_bw
from repro_torch.roofline_hlo import analyze
from repro_torch.serve.engine import make_prefill_step


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_smollm_train_4k_on_16x16():
    r = dryrun.run_cell("smollm-135m", "train_4k", mesh="16x16",
                        verbose=False)
    assert r["status"] == "ok", r
    assert (r["mesh"], r["chips"]) == ("16x16", 256)
    kinds = r["coll_breakdown"]
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= set(kinds)
    assert all(b > 0 for b in kinds.values())
    assert r["collective_bytes_per_chip"] == sum(kinds.values())
    # the per-card link rate across nodes: 256 cards are 32 nodes of 8
    assert r["t_collective_ms"] == pytest.approx(
        r["collective_bytes_per_chip"] / NET_BW * 1e3)
    one = dryrun.run_cell("smollm-135m", "train_4k", verbose=False)
    # 16 data ranks, each 1/16 of the rows: far less than one card's work
    assert r["flops_per_chip"] < one["flops_per_chip"] / 16
    assert one["coll_breakdown"] == {} and one["mesh"] == "1"


def test_multi_pod_cell():
    r = dryrun.run_cell("smollm-135m", "decode_32k", mesh="2x16x16",
                        verbose=False)
    assert r["status"] == "ok", r
    assert (r["mesh"], r["chips"]) == ("2x16x16", 512)
    assert r["coll_breakdown"]["all-reduce"] > 0


@pytest.mark.parametrize("arch,n_layers", [("deepseek-v2-236b", 2),
                                           ("mamba2-370m", 2),
                                           ("jamba-v0.1-52b", 8)])
def test_mla_and_mamba_count_on_a_mesh(arch, n_layers):
    """MLA and Mamba2 on the model axis of 16 x 16 (depth cut): counted,
    their partial outputs summed over ``model``, and each card does less
    than one card doing it all."""
    r = dryrun.run_cell(arch, "decode_32k", mesh="16x16", n_layers=n_layers,
                        verbose=False)
    assert r["status"] == "ok", r
    assert r["coll_breakdown"]["all-reduce"] > 0
    one = dryrun.run_cell(arch, "decode_32k", n_layers=n_layers,
                          verbose=False)
    assert r["flops_per_chip"] < one["flops_per_chip"]


def test_production_meshes_and_batch_spec():
    """16 x 16 over (data, model), 2 x 16 x 16 over (pod, data, model),
    this process rank 0 of each; ``batch_spec`` shards a leading batch
    over the first axis (or the one named), of a solver lane set too."""
    from repro_torch.launch.mesh import batch_spec, make_solver_mesh
    mesh = make_production_mesh()
    assert (mesh.mesh_dim_names, tuple(mesh.shape)) == (("data", "model"),
                                                        (16, 16))
    assert batch_spec(mesh) == ("data",)
    assert batch_spec(mesh, "model") == ("model",)
    pod = make_production_mesh(multi_pod=True)
    assert (pod.mesh_dim_names, tuple(pod.shape)) == (
        ("pod", "data", "model"), (2, 16, 16))
    assert dist.get_world_size() == 512 and dist.get_rank() == 0
    assert batch_spec(make_solver_mesh(2, device="cpu")) == ("batch",)
    with pytest.raises(ValueError):
        batch_spec(mesh, "pod")


def test_link_rate():
    assert link_bw(1) == link_bw(8) == LINK_BW == 450e9
    assert link_bw(256) == link_bw(512) == NET_BW == 50e9


def _fake_2x2():
    """A 2 x 2 ``("data", "model")`` mesh on a fake group of 4 ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-236b",
                                  "mamba2-370m"])
def test_prefill_collective_bytes_follow_the_placements(arch):
    """The smoke variant (d_model and vocab 128, 4 layers), prefill of 4 x
    16 into caches of 32, bf16, on a 2 x 2 mesh: rank 0's collectives, by
    kind, are

    * all-gather: every parameter with a ``"fsdp"`` dim, its data blocks
      made whole (its model block's numel x 2) at each use: once, but a
      tied embedding twice (the lookup and the logits); the last logits
      over the vocabulary (rows x 128); and per layer
      - smollm (4 heads over 2 kv heads of 32, d_ff 256): k and v of every
        kv head for the caches (2 x rows x 16 x 2 x 32);
      - deepseek (MLA, 2 of its 4 heads a rank; a dense first layer, then
        4 routed experts and 2 shared): none, its caches whole over heads;
      - mamba2 (8 heads of 32, d_state 16): ``in_proj``'s output (rows x
        16 x 552), the conv's (rows x 16 x 288) and the final state
        (rows x 8 x 32 x 16, float32);
    * all-reduce: the embedding's rows summed over the vocabulary's blocks
      (rows x 16 x 128) and the mixers' and FFNs' partial outputs, the
      same size each: smollm's attention and MLP, deepseek's MLA, dense
      MLP, routed experts and shared experts; mamba2's ``out_proj``, and
      its gated norm's sums of squares (rows x 16, float32);
    * reduce-scatter, all-to-all: none (no backward);

    rows = 2 (4 over 2 data ranks), every element 2 bytes but where
    said."""
    from repro_torch.models.model import layer_plan
    shd = Sharder(_fake_2x2())
    cfg = smoke_variant(get_config(arch))
    model = build_model(cfg, "meta", torch.bfloat16, shd)
    B, S, rows, el = 4, 16, 2, 2
    caches = init_caches(cfg, B, 32, dtype=torch.bfloat16, device="meta",
                         shd=shd)
    acc = analyze(make_prefill_step(model),
                  torch.empty((rows, S), dtype=torch.int32, device="meta"),
                  caches)
    axes = model_axes(cfg)
    params = [(n, p) for n, p in model.named_parameters()
              if "fsdp" in axes[n]]
    gather = sum(p.numel() * 2 for _, p in params)   # data blocks whole
    if cfg.tie_embeddings:
        gather += model.embed.numel() * 2               # the logits' use
    gather += rows * cfg.vocab
    partials = 1                                        # the embedding
    gather_f32 = reduce_f32 = 0
    for mixer, ffn in layer_plan(cfg):
        if mixer == "mamba":
            s = cfg.ssm
            di, N = s.d_inner(cfg.d_model), s.d_state
            H = s.n_heads(cfg.d_model)
            gather += rows * S * (2 * di + 2 * N + H + di + 2 * N)
            gather_f32 += rows * H * s.head_dim * N
            reduce_f32 += rows * S
        elif cfg.attn_type != "mla":
            gather += 2 * rows * S * cfg.n_kv_heads * cfg.dh
        partials += 1 + (ffn is not None) + (
            ffn == "moe" and cfg.moe.n_shared > 0)
    reduce = rows * S * cfg.d_model * partials
    assert acc["collectives"] == {
        "all-gather": gather * el + gather_f32 * 4,
        "all-reduce": reduce * el + reduce_f32 * 4}
    assert math.prod(model.embed.shape) * 4 == cfg.vocab * cfg.d_model


def test_n_layers_cuts_the_depth():
    """``--n-layers`` (ROADMAP M9b.3b's sizing): jamba at 8 layers, the
    smallest legal depth, on ``meta``."""
    r = dryrun.run_cell("jamba-v0.1-52b", "long_500k", n_layers=8,
                        verbose=False)
    assert r["status"] == "ok", r
    full = get_config("jamba-v0.1-52b")
    assert r["bytes_per_chip"] < 0.5 * 106e9 and full.n_layers == 32
    assert dryrun.main(["--arch", "jamba-v0.1-52b", "--shape", "long_500k",
                        "--n-layers", "8"]) == 0
