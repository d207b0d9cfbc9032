"""The port on meshes of CPU ranks against the JAX package unsharded.

The reference's own sharded paths fail under this jax (ROADMAP F1), so
the oracle is its math and the property its partitioner keeps: a
sharded run computes the function the unsharded one does. The one
exception is the MoE, whose tokens route in ``gcd(data_groups, T)``
groups: there JAX runs with ``GroupedSharder``, a test-side ``Sharder``
whose ``constrain`` returns its input and whose ``data_groups`` is the
mesh's data size. Nothing in the JAX package changes.

The ranks (``torch_mesh_ranks.py``: gloo, a ``FileStore`` under the
test's temporary directory) are started once for the module, on 4 CPU
processes that hold the meshes 1 x 2, 2 x 1 (ranks 0 and 1), 2 x 2 and
1 x 4. Tolerances (float32, other summation orders): logits within 1e-5
x JAX's largest |logit|; loss within 1e-5 and ``grad_norm`` within 1e-4,
both relative; step-0 gradients within 1e-4 x each leaf's largest |g|.
Routing bit for bit: the JAX package's router on the gate logits each
rank routed gives that rank's dispatch.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.core import routing as jrouting
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import rows_batch as jax_rows_batch
from repro.models import model as jmodel
from repro.models.layers import Sharder
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train import step as jstep
from repro_torch.checkpoint import store
from repro_torch.core.masking import tree_leaves
from repro_torch.interop import model_from_params, numpy_params, params_tree
from repro_torch.launch.mesh import spawn
from repro_torch.optim.adamw import Quantized
from repro_torch.train import step as tstep

LOGIT_TOL = 1e-5
LOSS_TOL = 1e-5
NORM_TOL = 1e-4
GRAD_TOL = 1e-4


@dataclasses.dataclass(frozen=True)
class GroupedSharder(Sharder):
    """No mesh, but the MoE groups of a mesh of ``groups`` data ranks."""
    groups: int = 1

    def constrain(self, x, *logical):
        return x

    @property
    def data_groups(self) -> int:
        return self.groups


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    """Every case's results, from one start of the 4 ranks. One-card
    checkpoints of smollm's step 1 are written first (the resume cases:
    float32 and int8 moments)."""
    d = tmp_path_factory.mktemp("mesh")
    for quantize in (False, True):
        state, _ = _one_card(quantize, 1)
        store.save(str(d / ranks.one_card_dir({"quantize": quantize})), 1,
                   tstep.state_tree(state))
    spawn(ranks.run, ranks.WORLD, str(d), device="cpu")
    return d


@functools.lru_cache(maxsize=None)
def _one_card(quantize: bool, steps: int):
    """smollm's one-card train state after ``steps`` steps, and the last
    step's metrics."""
    cfg = ranks.config("smollm-135m")
    tcfg = ranks.train_config(quantize)
    state = tstep.init_train_state(
        cfg, tcfg, model_from_params(cfg, numpy_params(cfg, 0), "cpu"))
    fn = tstep.make_train_step(cfg, tcfg)
    for step in range(steps):
        state, m = fn(state, _torch_rows(cfg, step))
    return state, m


def _torch_rows(cfg, step):
    return {k: torch.tensor(x) for k, x in ranks.train_batch(cfg, step)
            .items()}


def _load(out, case, rank):
    return torch.load(out / f"{case}.{rank}.pt", weights_only=False)


def _data_ranks(case):
    """(rank, data index) of model rank 0 of each data row of the mesh."""
    grid = ranks.MESHES[ranks.CASES[case][1]]
    return [(row[0], d) for d, row in enumerate(grid)], grid


def _key(case):
    """What a case's JAX reference depends on: meshes of other shapes
    share one where the model has no MoE (whose groups follow the data
    axis)."""
    kind, mesh, arch, over, extra = ranks.CASES[case]
    groups = len(ranks.MESHES[mesh]) if ranks.config(arch).moe else 1
    return (arch, repr(sorted(over.items())), groups,
            extra.get("S_max", ranks.S + ranks.NEW),
            extra.get("batch", ranks.TRAIN_B))


def _jax(case):
    kind, mesh, arch, over, extra = ranks.CASES[case]
    jcfg = jax_smoke_variant(jax_get_config(arch))
    if jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, router="flow"))
    jcfg = ranks.replaced(jcfg, over)
    cfg = ranks.config(arch, **over)
    params = jax.tree.map(jnp.asarray, numpy_params(cfg, 0))
    axes = jmodel.init_model(jcfg, jax.random.PRNGKey(0))[1]
    shd = GroupedSharder(groups=len(ranks.MESHES[mesh]))
    return cfg, jcfg, params, axes, shd, extra


_REFS = {}


def _cached(fn):
    """``fn(case)`` once per ``_key(case)``."""
    @functools.wraps(fn)
    def run(case):
        key = (fn.__name__, _key(case))
        if key not in _REFS:
            _REFS[key] = fn(case)
        return _REFS[key]
    return run


@_cached
def _jax_generate(case):
    """Each step's last-position logits (B, vocab) of the JAX package."""
    cfg, jcfg, params, axes, shd, extra = _jax(case)
    caches, _ = jmodel.init_caches(jcfg, ranks.B,
                                   extra.get("S_max", ranks.S + ranks.NEW),
                                   dtype=jnp.float32)

    @jax.jit
    def run(params, tokens, caches, off, decode):
        out = jmodel.apply_model(params, axes, jcfg, shd, {"tokens": tokens},
                                 caches=caches, decode=decode,
                                 pos_offset=off, logits_mode="last")
        return out.logits[:, -1], out.caches
    run = jax.jit(run.__wrapped__, static_argnums=(4,))
    logits, caches = run(params, jnp.asarray(ranks.prompts(cfg.vocab)),
                         caches, 0, False)
    steps = [np.asarray(logits)]
    for i in range(ranks.NEW - 1):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        logits, caches = run(params, nxt, caches, jnp.int32(ranks.S + i),
                             True)
        steps.append(np.asarray(logits))
    return np.stack(steps, 1)


SERVE = [c for c, v in ranks.CASES.items() if v[0] == "serve"]
TRAIN = [c for c, v in ranks.CASES.items() if v[0] == "train"]


@pytest.mark.parametrize("case", SERVE)
def test_serve_matches_jax(out, case):
    """Prefill and decode logits of every request, on every rank of the
    mesh (each its rows), within LOGIT_TOL x JAX's largest |logit|."""
    want = _jax_generate(case)
    heads, grid = _data_ranks(case)
    rows = ranks.B // len(grid)
    for row, (_, d) in zip(grid, heads):
        for rank in row:
            got = _load(out, case, rank)["logits"].numpy()
            w = want[d * rows:(d + 1) * rows]
            assert got.shape == w.shape, (case, rank)
            np.testing.assert_allclose(got, w, rtol=0,
                                       atol=LOGIT_TOL * np.abs(w).max(),
                                       err_msg=f"{case} rank {rank}")


def test_caches_split_where_the_mesh_divides_them(out):
    """S_max = 20 splits the caches' sequence over the model axis (the
    flash-decoding combine), GQA's and MLA's (``c_kv``); 21 leaves it
    whole on every rank."""
    assert _load(out, "smollm_serve_2x2", 0)["seq_split"] == "model"
    assert _load(out, "smollm_serve_2x2_whole_cache", 0)["seq_split"] is None
    for rank in range(4):
        assert _load(out, "deepseek_serve_1x4", rank)["seq_split"] == "model"
        assert _load(out, "deepseek_serve_2x2_whole_cache",
                     rank)["seq_split"] is None
    assert _load(out, "deepseek_serve_1x2", 0)["seq_split"] == "model"


@pytest.mark.parametrize("case", ["phi_serve_2x1", "phi_serve_2x2",
                                  "deepseek_serve_1x2", "deepseek_serve_1x4",
                                  "deepseek_serve_2x2_whole_cache"])
def test_phi_routing_bit_for_bit(out, case):
    """Each rank routed one group, its rows of the batch, at the group's
    capacity; the JAX package's router on that rank's gate logits gives
    its dispatch bit for bit, and the ranks of a model row agree. phi's
    MoE layers and deepseek's (after its dense first layer, with 2 shared
    experts)."""
    from repro_torch.models.model import layer_plan
    cfg = ranks.config(ranks.CASES[case][2])
    n_moe = sum(ffn == "moe" for _, ffn in layer_plan(cfg))
    heads, grid = _data_ranks(case)
    Tg = ranks.B // len(grid) * ranks.S
    for row in grid:
        seen = [_load(out, case, r)["routing"] for r in row]
        assert len(seen[0]) == n_moe * ranks.NEW
        for calls in seen[1:]:
            for a, b in zip(seen[0], calls):
                assert torch.equal(a[3], b[3])
        for name, capacity, scores, dispatch in seen[0]:
            fn = getattr(jrouting, name)
            kw = ({"n_iters": cfg.moe.router_iters}
                  if name == "auction_route" else {})
            want = fn(jnp.asarray(scores.numpy()), cfg.moe.top_k, capacity,
                      **kw).dispatch
            assert np.array_equal(np.asarray(want), dispatch.numpy())
        prefill = seen[0][0]
        assert prefill[0] == "auction_route"
        assert tuple(prefill[2].shape) == (1, Tg, cfg.moe.n_experts)


@_cached
def _jax_train(case):
    cfg, jcfg, params, axes, shd, extra = _jax(case)
    n = extra.get("batch", ranks.TRAIN_B)
    jb = {k: jnp.asarray(x) for k, x in jax_rows_batch(
        JData(vocab=cfg.vocab, seq_len=ranks.TRAIN_S,
              global_batch=n), 0, 0, n).items()}
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.loss_fn(p, axes, jcfg, shd, b),
        has_aux=True))(params, jb)
    jt = jstep.TrainConfig(optimizer=JAdamW(warmup_steps=2, decay_steps=10))
    state = jstep.init_train_state(jcfg, jt, params)
    fn = jax.jit(jstep.make_train_step(jcfg, axes, jt, shd))
    steps = []
    for step in range(2):
        b = {k: jnp.asarray(x) for k, x in ranks.train_batch(cfg, step, n)
             .items()}
        state, m = fn(state, b)
        steps.append(m)
    return cfg, loss, aux, grads, steps


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


@pytest.mark.parametrize("case", TRAIN)
def test_train_matches_jax(out, case):
    """Step-0 loss and gradients (made whole) on every rank, then two
    train steps' loss and ``grad_norm``."""
    cfg, loss, aux, jgrads, jsteps = _jax_train(case)
    model = model_from_params(cfg, numpy_params(cfg, 0), "cpu")
    _, grid = _data_ranks(case)
    for rank in sorted(r for row in grid for r in row):
        got = _load(out, case, rank)
        assert _rel(got["loss0"], loss) <= LOSS_TOL, rank
        assert float(got["tokens"]) == float(aux["tokens"])
        tree = params_tree(model, got["grads"])
        for (path, want), g in zip(
                jax.tree_util.tree_leaves_with_path(jgrads),
                jax.tree.leaves(tree)):
            want = np.asarray(want)
            np.testing.assert_allclose(
                g, want, rtol=0, atol=GRAD_TOL * np.abs(want).max(),
                err_msg=f"{case} rank {rank} {jax.tree_util.keystr(path)}")
        for i, (tm, jm) in enumerate(zip(got["steps"], jsteps)):
            assert _rel(tm["loss"], jm["loss"]) <= LOSS_TOL * 10 ** i, i
            assert _rel(tm["grad_norm"], jm["grad_norm"]) <= NORM_TOL, i
            assert np.asarray(jm["lr"]).tobytes() == tm["lr"].numpy().tobytes()


def test_encoder_forward_matches_jax(out):
    """hubert's non-causal forward on 1 x 2: its 16-way smoke heads split
    over the model axis, K6's plain version on each rank's heads."""
    cfg, jcfg, params, axes, shd, _ = _jax("hubert_forward_1x2")
    want = np.asarray(jax.jit(lambda p, e: jmodel.apply_model(
        p, axes, jcfg, shd, {"embeds": e}).logits)(
        params, jnp.asarray(ranks.frames(cfg))))
    for rank in (0, 1):
        got = _load(out, "hubert_forward_1x2", rank)["logits"].numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LOGIT_TOL * np.abs(want).max())


def test_resume_on_the_mesh(out):
    """On 1 x 2: a run saved at step 1 and resumed equals the run that
    never stopped, every leaf bit for bit; a one-card checkpoint resumed
    there gives the one card's next step within the tolerances."""
    got = _load(out, "resume_1x2", 0)
    a, b = tree_leaves(got["whole"]), tree_leaves(got["resumed"])
    assert len(a) == len(b) > 50
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    m = _one_card(False, 2)[1]
    assert _rel(got["from_one"]["loss"], m["loss"]) <= LOSS_TOL
    assert _rel(got["from_one"]["grad_norm"], m["grad_norm"]) <= NORM_TOL
    assert int(got["from_one_tree"]["opt"].step) == 2


@pytest.mark.parametrize("case", ["resume_1x2", "resume_q_1x2"])
def test_resumed_state_matches_one_card(out, case):
    """On 1 x 2, with float32 and with int8 moments: the run that never
    stopped and the one resumed from its own checkpoint are equal bit for
    bit, and both it and the run resumed from a one-card checkpoint end
    step 2 with the one card's moments: float32 ones (and then the
    parameters) within 1e-4 of each leaf's largest |value| (other
    summation orders), int8 ones with every code within one of the one
    card's (a rounding the float noise tips) and every scale within 1e-4
    of the largest. A moment read in the wrong placement (a block taken
    for the whole) puts zeros or another block's values in its columns,
    many codes off."""
    got = _load(out, case, 0)
    a, b = tree_leaves(got["whole"]), tree_leaves(got["resumed"])
    assert len(a) == len(b) > 50
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    quantize = ranks.CASES[case][4].get("quantize", False)
    want = tstep.state_tree(_one_card(quantize, 2)[0])
    n_quantized = 0
    for tree in (got["whole"], got["from_one_tree"]):
        for k in ("m", "v"):
            for name, w in getattr(want["opt"], k).items():
                g = getattr(tree["opt"], k)[name]
                assert type(g) is type(w), (case, k, name)
                if isinstance(w, Quantized):
                    n_quantized += 1
                    assert g.q.shape == w.q.shape, (case, k, name)
                    codes = (g.q.int() - w.q.int()).abs().max()
                    assert int(codes) <= 1, (case, k, name)
                    np.testing.assert_allclose(
                        g.scale, w.scale, rtol=0,
                        atol=1e-4 * float(w.scale.max()),
                        err_msg=f"{case} {k} {name}")
                else:
                    np.testing.assert_allclose(
                        g, w, rtol=0, atol=1e-4 * float(w.abs().max()),
                        err_msg=f"{case} {k} {name}")
        if not quantize:
            for name, w in want["params"].items():
                np.testing.assert_allclose(
                    tree["params"][name], w, rtol=0,
                    atol=1e-4 * float(w.abs().max()),
                    err_msg=f"{case} {name}")
    assert (n_quantized > 0) == quantize


def test_gather_by_all_to_all_equals_all_gather(out):
    """The all-gather that gloo takes for CUDA tensors (an all-to-all of
    each rank's block) gives the all-gather's tensor, over each axis of
    2 x 2 and along either dim; the ranks' blocks in mesh order."""
    for rank in range(4):
        got = _load(out, "collectives_2x2", rank)
        d, m = divmod(rank, 2)
        for (axis, dim), (native, composed) in got.items():
            assert torch.equal(native, composed), (rank, axis, dim)
            peers = [2 * i + m for i in range(2)] if axis == "data" \
                else [2 * d + j for j in range(2)]
            want = torch.cat([torch.arange(12.).reshape(3, 4) + 100 * p
                              for p in peers], dim)
            assert torch.equal(native, want), (rank, axis, dim)


def test_serve_cli_on_a_mesh(capfd):
    """``torchrun --nproc-per-node 4 ... --model-parallel 2``: four CPU
    ranks on 2 x 2 serve the requests the one-process CLI serves, the
    same tokens, rank 0's rows printed once."""
    from repro_torch.launch import serve
    args = ["--arch", "smollm-135m", "--smoke", "--batch", "4",
            "--prompt-len", "8", "--max-new", "4", "--device", "cpu"]
    serve.main(args)
    one = capfd.readouterr().out
    run = ranks.torchrun("repro_torch.launch.serve", 4,
                         [*args, "--model-parallel", "2"])
    assert run.returncode == 0, run.stderr[-4000:]
    mesh = run.stdout
    assert mesh.count("prefill: 4x8") == 1
    tokens = [line for line in one.splitlines() if line.startswith("  req")]
    assert len(tokens) == 2
    assert tokens == [line for line in mesh.splitlines()
                      if line.startswith("  req")]
