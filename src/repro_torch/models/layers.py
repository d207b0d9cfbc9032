"""Shared model building blocks: sharding, parameter init, norms,
activations, RoPE, the encoder's sinusoidal positions, the token cross
entropy.

Counterpart of ``repro/models/layers.py``. Parameter init takes an
explicit ``torch.Generator`` and uses the standard deviations of
``ParamFactory.dense``; the numbers differ from ``jax.random``'s, so the
parity tests carry weights across (``repro_torch.interop``) instead.

Sharding. Parameters and activations carry per-dim logical axes
(``"fsdp"``, ``"tp"``, ``"batch"``, ``"seq"``, None); a ``Sharder`` maps
them to the axes of a ``torch.distributed`` ``DeviceMesh`` by
``DEFAULT_RULES`` and replicates any dim whose size the mesh axes do not
divide, exactly as the reference's. Where the reference hands a
``PartitionSpec`` to XLA and lets its partitioner place the
communication, the port runs SPMD by hand: every rank holds its shard of
each parameter (``Sharder.shard``) and the model code calls the
collectives itself, each one a ``torch.ops._c10d_functional`` op (the
dry run counts them by kind, ``roofline_hlo.analyze``), wrapped in
autograd Functions that pair each forward collective with its
transpose:

* ``param``: FSDP. A parameter's ``"fsdp"`` dims are sharded over
  ``data`` and all-gathered before use; the backward reduce-scatters its
  gradient back to the shard (all-reduces it where the parameter is not
  sharded over a batch axis), so every gradient comes out summed over
  the data-parallel ranks, placed like its parameter.
* ``enter``: a value every rank of the ``model`` axis holds alike, used
  from here on in a way that depends on the rank (a column-parallel
  product, one rank's heads or experts): forward the rank's slice (or the
  value itself), backward an all-reduce of the gradient over ``model``.
* ``reduce``: partial sums of the ranks of ``model`` (a row-parallel
  product, one rank's experts): forward an all-reduce, backward the
  identity.
* ``gather``: a value split over ``model`` made whole: forward an
  all-gather, backward the rank's slice of the gradient.

Explicit collectives (not DTensor) because the port's model is eager
PyTorch run once per rank: the placements of each product are fixed by
the specs, each collective is visible where it is issued, and none is
inserted behind the code's back, so a rank's op stream (and the dry
run's count of it) is exactly what the code says. Without a mesh every
helper returns its input and the model runs the single-card ops, bit for
bit as before.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# Sharding: logical -> mesh axes (the reference's rules)
# ---------------------------------------------------------------------------

DEFAULT_RULES = {
    "fsdp": ("data",),
    "tp": ("model",),
    "batch": ("pod", "data"),   # pod axis folds into data parallelism
    "seq": ("model",),          # sequence sharding for KV caches / long ctx
}

_C = torch.ops._c10d_functional
# the collectives that gloo does not carry for CUDA tensors as
# ``_c10d_functional`` ops: on an H100 (torch 2.11, gloo over CUDA tensors,
# ranks sharing the card) ``all_gather_into_tensor`` kills the process
# (SIGSEGV) where all-reduce (sum, max), reduce-scatter, all-to-all and
# broadcast give the right values. There the all-gather is an all-to-all
# of the block sent to every rank (launch/mesh.py says where gloo is
# chosen)
GLOO_CUDA_COMPOSED = frozenset({"all_gather"})


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process group's name, its
    size and this rank's index along it, and whether the group is gloo's
    (where its CUDA tensors take ``GLOO_CUDA_COMPOSED`` otherwise)."""
    group: str
    size: int
    index: int
    gloo: bool = False

    def composed(self, op: str, t: torch.Tensor) -> bool:
        return self.gloo and t.is_cuda and op in GLOO_CUDA_COMPOSED


def all_reduce(t, ax: Axis, op: str = "sum"):
    return _C.wait_tensor(_C.all_reduce(t.contiguous(), op, ax.group))


def all_gather(t, dim: int, ax: Axis):
    """The ranks' ``t`` concatenated along ``dim`` in rank order."""
    dim = dim % t.dim()
    if ax.composed("all_gather", t):
        return all_gather_by_all_to_all(t, dim, ax)
    t0 = t.movedim(dim, 0).contiguous()
    out = _C.wait_tensor(_C.all_gather_into_tensor(t0, ax.size, ax.group))
    return out.movedim(0, dim)


def all_gather_by_all_to_all(t, dim: int, ax: Axis):
    """``all_gather`` as an all-to-all: each rank sends its block to every
    rank (the traffic of an all-gather)."""
    t0 = t.movedim(dim % t.dim(), 0).contiguous()
    n = t0.shape[0]
    src = t0.repeat(ax.size, *([1] * (t0.dim() - 1)))
    out = _C.wait_tensor(_C.all_to_all_single(src, [n] * ax.size,
                                              [n] * ax.size, ax.group))
    return out.movedim(0, dim % t.dim())


def reduce_scatter(t, dim: int, ax: Axis):
    """The sum over the ranks of ``t``, this rank's block of ``dim``."""
    dim = dim % t.dim()
    t0 = t.movedim(dim, 0).contiguous()
    out = _C.wait_tensor(_C.reduce_scatter_tensor(t0, "sum", ax.size,
                                                  ax.group))
    return out.movedim(0, dim)


class _Enter(torch.autograd.Function):
    """Forward: ``x`` (or its block ``[lo, lo + n)`` of ``dim``); backward:
    the gradient, zero outside the block, all-reduced over ``ax``."""

    @staticmethod
    def forward(ctx, x, ax: Axis, dim, lo: int, n: int):
        ctx.ax, ctx.dim, ctx.lo, ctx.shape = ax, dim, lo, x.shape
        if dim is None:
            return x.view_as(x)
        return x.narrow(dim, lo, n)

    @staticmethod
    def backward(ctx, g):
        if ctx.dim is not None:
            full = g.new_zeros(ctx.shape)
            full.narrow(ctx.dim, ctx.lo, g.shape[ctx.dim]).copy_(g)
            g = full
        return all_reduce(g, ctx.ax), None, None, None, None


class _Reduce(torch.autograd.Function):
    """Forward: the sum over ``ax``; backward: the identity."""

    @staticmethod
    def forward(ctx, x, ax: Axis):
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Forward: the all-gather over ``ax`` along ``dim``; backward: this
    rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, ax: Axis, dim: int):
        ctx.ax, ctx.dim, ctx.n = ax, dim, x.shape[dim]
        return all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ax.index * ctx.n, ctx.n), None, None


class _GatherParam(torch.autograd.Function):
    """FSDP. Forward: the shard all-gathered along each dim in ``dims``
    (over ``ax``, the data axis); backward: the gradient reduce-scattered
    back along them, then all-reduced over ``sums`` (the batch axes that do
    not shard the parameter)."""

    @staticmethod
    def forward(ctx, w, ax: Axis, dims: tuple, sums: tuple):
        ctx.ax, ctx.dims, ctx.sums = ax, dims, sums
        for d in dims:
            w = all_gather(w, d, ax)
        return w if dims else w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        for d in ctx.dims:
            g = reduce_scatter(g, d, ctx.ax)
        for ax in ctx.sums:
            g = all_reduce(g, ax)
        return g, None, None, None


@dataclasses.dataclass(frozen=True)
class Sharder:
    """Logical axes -> mesh axes, and this rank's part of the SPMD program.

    ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` with named
    dims (``launch/mesh.py``), or anything with ``mesh_dim_names`` and
    ``shape`` where only ``spec`` is asked; None is one card, where every
    helper returns its input."""
    mesh: Any = None
    rules: Any = None

    # -- the reference's semantics ---------------------------------------

    @property
    def sizes(self) -> dict:
        if self.mesh is None:
            return {}
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    def _axes(self, logical, size: int):
        sizes = self.sizes
        if self.mesh is None or logical is None:
            return None
        axes = tuple(a for a in (self.rules or DEFAULT_RULES).get(logical, ())
                     if a in sizes)
        if not axes:
            return None
        total = math.prod(sizes[a] for a in axes)
        if size % total != 0:
            return None             # replicate: not evenly divisible
        return axes if len(axes) > 1 else axes[0]

    def spec(self, shape, logical) -> tuple:
        """The reference's ``PartitionSpec`` as a tuple: per dim None, an
        axis name or a tuple of them."""
        assert len(shape) == len(logical), (shape, logical)
        return tuple(self._axes(l, s) for s, l in zip(shape, logical))

    @property
    def data_groups(self) -> int:
        """Number of data-parallel shards (the MoE dispatch group count)."""
        if self.mesh is None:
            return 1
        sizes = self.sizes
        return math.prod(sizes[a] for a in
                         (self.rules or DEFAULT_RULES).get("batch", ())
                         if a in sizes)

    # -- this rank ---------------------------------------------------------

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def axis(self, name: str) -> Axis:
        """``name`` as this rank sees it (size 1 where the mesh lacks it)."""
        if self.size(name) == 1:
            return Axis("", 1, 0)
        pg = self.mesh.get_group(name)
        return Axis(pg.group_name, self.size(name),
                    self.mesh.get_local_rank(name),
                    dist.get_backend(pg) == "gloo")

    def _spec_axes(self, entry) -> tuple:
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def block(self, entry) -> tuple[int, int]:
        """``(index, count)`` of this rank's block of a dim placed by the
        spec entry ``entry`` (pod-major over a tuple of axes)."""
        idx, count = 0, 1
        for a in self._spec_axes(entry):
            idx = idx * self.size(a) + self.axis(a).index
            count *= self.size(a)
        return idx, count

    def shard(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of the whole ``t`` placed by ``spec`` (a view)."""
        for d, entry in enumerate(spec):
            i, n = self.block(entry)
            if n > 1:
                step = t.shape[d] // n
                t = t.narrow(d, i * step, step)
        return t

    def full_shape(self, shape, spec) -> tuple:
        """The whole shape of a block ``shape`` placed by ``spec``."""
        return tuple(s * self.block(e)[1] for s, e in zip(shape, spec))

    def unshard(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The whole tensor of this rank's block ``t`` placed by ``spec``
        (all-gathers, no gradient; every rank takes part)."""
        for d, entry in enumerate(spec):
            for a in reversed(self._spec_axes(entry)):
                if self.size(a) > 1:
                    t = all_gather(t.detach(), d, self.axis(a))
        return t

    def reduce_all(self, x):
        """The sum over every rank of the mesh (no gradient)."""
        for a, n in self.sizes.items():
            if n > 1:
                x = all_reduce(x.detach(), self.axis(a))
        return x

    def replicas(self, spec) -> int:
        """How many ranks hold each block placed by ``spec``."""
        used = {a for e in spec for a in self._spec_axes(e)}
        return math.prod(n for a, n in self.sizes.items() if a not in used)

    # -- collectives (no-ops without a mesh or on an axis of size 1) ------

    def enter(self, x, dim=None, lo: int = 0, n: int = 0, axis="model"):
        """``x`` (held alike by the ranks of ``axis``) for a use that
        depends on the rank: itself, or its block ``[lo, lo + n)`` of
        ``dim``; the backward all-reduces the gradient over ``axis``."""
        if self.size(axis) == 1:
            return x if dim is None else x.narrow(dim, lo, n)
        return _Enter.apply(x, self.axis(axis), dim, lo, n)

    def reduce(self, x, axis="model"):
        """The sum of the ranks' partial ``x`` over ``axis``."""
        if self.size(axis) == 1:
            return x
        return _Reduce.apply(x, self.axis(axis))

    def gather(self, x, dim: int, axis="model"):
        """The ranks' blocks of ``x`` along ``dim`` made whole."""
        if self.size(axis) == 1:
            return x
        return _Gather.apply(x, self.axis(axis), dim % x.dim())

    def all_max(self, x, axis="model"):
        """The elementwise maximum over ``axis`` (no gradient)."""
        if self.size(axis) == 1:
            return x
        return all_reduce(x.detach(), self.axis(axis), "max")

    def reduce_batch(self, x):
        """The sum over the batch axes (no gradient): metrics and counts."""
        for a in (self.rules or DEFAULT_RULES)["batch"]:
            if self.size(a) > 1:
                x = all_reduce(x.detach(), self.axis(a))
        return x

    def param(self, w: torch.Tensor) -> torch.Tensor:
        """A parameter as this rank uses it: its ``"fsdp"`` dims gathered
        over ``data`` (``_GatherParam``) at each use and freed after it, as
        FSDP does; ``w`` itself without a mesh or where there is nothing to
        gather or sum (a serving placement, ``shard_model(fsdp=False)``,
        keeps every weight whole over ``data``)."""
        spec = getattr(w, "spec", None)
        if self.mesh is None or spec is None:
            return w
        data = "data"
        dims = tuple(d for d, e in enumerate(spec) if data in
                     self._spec_axes(e) and self.size(data) > 1)
        used = {a for e in spec for a in self._spec_axes(e)}
        sums = tuple(self.axis(a) for a in
                     (self.rules or DEFAULT_RULES)["batch"]
                     if self.size(a) > 1 and a not in used)
        if not dims and not sums:
            return w
        return _GatherParam.apply(w, self.axis(data), dims, sums)

    def tp(self, size: int) -> bool:
        """Whether a ``"tp"`` dim of ``size`` is split over a model axis
        above 1."""
        return self.size("model") > 1 and self._axes("tp", size) is not None

    def batch_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole batch ``t`` (dim 0 over the batch
        axes), its spec as ``.spec``. A batch that does not divide over the
        data-parallel ranks is replicated, as the reference replicates a
        dim the mesh does not divide: every data rank takes all of it
        (``row_replicas``)."""
        if self.mesh is None or self.data_groups == 1:
            return t
        spec = (self._axes("batch", t.shape[0]),)
        rows = self.shard(t, spec)[:]       # a view of its own
        rows.spec = spec
        return rows

    def row_replicas(self, rows: torch.Tensor) -> int:
        """How many data-parallel ranks hold the same ``rows`` of a batch
        (``batch_rows``): all of them where the batch was replicated, else
        one."""
        spec = getattr(rows, "spec", None)
        if self.mesh is None or spec is None or spec[0] is not None:
            return 1
        return self.data_groups

    def barrier(self) -> None:
        """Wait for every rank of the mesh (an all-reduce of a zero)."""
        if self.mesh is not None:
            self.reduce_all(torch.zeros(1, device=self.mesh.device_type))


NO_MESH = Sharder()


def normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``p`` in place with N(0, std^2) draws from ``generator``.

    Draws on the generator's device and copies, so a CPU generator can
    initialise a model on the card."""
    with torch.no_grad():
        w = torch.randn(p.shape, generator=generator, dtype=p.dtype,
                        device=generator.device)
        p.copy_(w.mul_(std))


def dense_std(fan_in: int) -> float:
    """``ParamFactory.dense``'s default standard deviation."""
    return fan_in ** -0.5


def depth_scaled_std(fan_in: int, n_layers: int) -> float:
    """The std of the residual output projections (``wo``, ``w2``)."""
    return fan_in ** -0.5 / (2 * n_layers) ** 0.5


def linear(d_in: int, d_out: int, device, dtype) -> nn.Linear:
    """A bias-free ``nn.Linear``; its ``weight`` is the JAX ``(d_in,
    d_out)`` matrix transposed."""
    return nn.Linear(d_in, d_out, bias=False, device=device, dtype=dtype)


def rmsnorm(x, g, eps=1e-6):
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * g


def layernorm(x, g, b, eps=1e-5):
    x32 = x.float()
    mu = torch.mean(x32, -1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, -1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


class Norm(nn.Module):
    """RMSNorm (``g``) or LayerNorm (``g``, ``b``), by ``cfg.norm``."""
    AXES = {"g": (None,), "b": (None,)}

    def __init__(self, d: int, kind: str, device=None, dtype=None):
        super().__init__()
        self.kind = kind
        self.g = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        if kind == "layernorm":
            self.b = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))

    def forward(self, x):
        if self.kind == "layernorm":
            return layernorm(x, self.g, self.b)
        return rmsnorm(x, self.g)


def relu2(x):
    r = F.relu(x)
    return r * r


def gelu_tanh(x):
    """``jax.nn.gelu``, whose default is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: dict[str, Callable] = {
    "relu2": relu2,          # nemotron/minitron squared-ReLU
    "gelu": gelu_tanh,
    "silu": F.silu,
}


def apply_rope(x, positions, theta: float = 10_000.0):
    """Table-free RoPE (rotate half). x: (B, S, H, D); positions: (S,) int.

    Frequencies are float32 and come from ``positions`` directly, as in
    the JAX package: no (max_seq, D/2) table.
    """
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    f = positions.to(torch.float32)[:, None] * inv[None, :]    # (S, D/2)
    c = torch.cos(f)[None, :, None, :]
    s = torch.sin(f)[None, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def sinusoidal_pos(positions, d_model: int):
    """The encoder's positional embedding ``(S, d_model)`` float32, on
    ``positions``' device: ``[sin(f), cos(f)]`` with ``f = positions *
    inv`` and ``inv = 1 / 10000 ** (arange(half) / half)``, as the JAX
    package's (a stub for HuBERT's convolutional positions)."""
    half = d_model // 2
    inv = 1.0 / (10_000.0 ** (torch.arange(half, dtype=torch.float32,
                                           device=positions.device) / half))
    f = positions.to(torch.float32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(f), torch.cos(f)], dim=-1)


def softmax_cross_entropy(logits, labels, z_loss: float = 0.0,
                          shd: Sharder = NO_MESH, vocab0: int | None = None):
    """Token cross entropy with an optional z-loss, reduced in float32:
    ``lse - label_logit`` (+ ``z_loss * lse ** 2``), shape of ``labels``.

    The reference takes the label logit with a masked sum (a vocab-sharded
    gather would all-gather the logits on its mesh); that sum adds only
    zeros besides the label's logit, so the ``gather`` here gives the same
    value. ``vocab0``: ``logits`` are this rank's block of the vocabulary
    from id ``vocab0`` (a model axis splits it): the ranks agree on each
    row's maximum, then sum their exponentials and their label logits
    (the masked sum), so the logits are never gathered.
    """
    logits = logits.float()
    if vocab0 is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        mx = shd.all_max(logits.detach().amax(-1))
        lse = mx + torch.log(shd.reduce(
            torch.exp(logits - mx[..., None]).sum(-1)))
        local = labels.long() - vocab0
        hit = (local >= 0) & (local < logits.shape[-1])
        own = torch.gather(logits, -1, local.clamp(
            0, logits.shape[-1] - 1)[..., None])[..., 0]
        ll = shd.reduce(torch.where(hit, own, 0.0))
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return loss
