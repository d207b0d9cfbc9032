"""Exact roofline accounting of one step, counted over its aten ops.

Counterpart of ``repro/roofline_hlo.py``, which parses the compiled HLO
text; the port has no compiler and no HLO, so this module counts aten
ops instead. ``analyze(fn, *args)`` runs ``fn`` once under a
``TorchDispatchMode`` and accumulates, per step:

  * flops        — ``torch.utils.flop_counter``'s formulas (mm, addmm,
                   bmm, baddbmm, convolution, ...) and K6's own, which
                   ``kernels/flash_attention/kernel.py`` registers for its
                   op (``roofline.flash_attention_work``)
  * bytes        — Σ (inputs + outputs) of every op that moves data: in
                   eager PyTorch every op is a boundary (the reference's
                   "non-fused op boundaries"); views and ``empty`` move
                   nothing and count 0
  * collectives  — output bytes per collective kind (all-gather,
                   all-reduce, reduce-scatter, all-to-all), as the
                   reference counts them: every ``_c10d_functional`` op
                   the rank issues, forward and backward (none on one
                   card); they count into the bytes too, as there
  * peak_bytes   — the high-water mark of live device storages (not the
                   CPU's), the step's inputs counted from entry

The reference multiplies a while body by its ``known_trip_count``,
because ``cost_analysis`` counts a scanned body once; here every
iteration of a Python loop dispatches its ops, so the count is exact by
construction. On the ``meta`` device nothing runs and nothing is
allocated: the same ops dispatch with shapes only, so a 340 B-parameter
step is counted on the CPU in seconds. K6 dispatches as one op on both
``cuda`` and ``meta`` (its ``meta`` version only makes the outputs), so a
step counted on the card gives the ``meta`` count. A collective on
``meta`` tensors (a mesh cell, on a ``fake`` process group) is not run:
the mode makes its output's shape.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# ops that allocate without writing
_NO_DATA = {torch.ops.aten.empty.memory_format,
            torch.ops.aten.empty_strided.default,
            torch.ops.aten.empty_like.default,
            torch.ops.aten.new_empty.default,
            torch.ops.aten.new_empty_strided.default}
# metadata queries: no op runs
_QUERIES = {torch.ops.aten.is_contiguous.default,
            torch.ops.aten.is_contiguous.memory_format,
            torch.ops.aten.is_strides_like_format.default,
            torch.ops.aten.is_non_overlapping_and_dense.default,
            torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
            torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
            torch.ops.aten.storage_offset.default,
            torch.ops.aten.sym_storage_offset.default,
            torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
            torch.ops.aten.dim.default, torch.ops.prim.layout.default,
            torch.ops.prim.device.default}


def _tensors(tree) -> list:
    """Every tensor in ``tree``: nested lists, tuples (NamedTuples), dicts,
    and the parameters and buffers of an ``nn.Module``."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """An op whose outputs alias an input without writing it (and
    ``_unsafe_view``, a view whose schema does not say so)."""
    return func is torch.ops.aten._unsafe_view.default or any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _Live:
    """Live device storages: each is added once and taken away when it is
    freed (a weakref finalizer); ``peak`` is the high-water mark."""

    def __init__(self):
        self.seen = weakref.WeakKeyDictionary()
        self.now = 0
        self.peak = 0

    def add(self, t: torch.Tensor):
        if t.device.type == "cpu":
            return
        st = t.untyped_storage()
        if st in self.seen:
            return
        n = st.nbytes()
        self.seen[st] = n
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int):
        self.now -= n


# the collectives, by their ``_c10d_functional`` names, and their kinds
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all", "broadcast": "broadcast"}


def _collective_meta(name: str, args) -> torch.Tensor:
    """A collective's output on ``meta`` (the op is not run)."""
    t = args[0]
    shape = list(t.shape)
    if name == "all_gather_into_tensor":
        shape[0] *= args[1]
    elif name == "reduce_scatter_tensor":
        shape[0] //= args[2]
    elif name == "all_to_all_single" and args[1]:
        shape[0] = sum(args[1])
    return torch.empty(shape, dtype=t.dtype, device="meta")


class _Count(TorchDispatchMode):
    def __init__(self, live: _Live):
        super().__init__()
        self.live = live
        self.flops = 0
        self.bytes = 0
        self.colls = defaultdict(float)
        self.by_op = defaultdict(lambda: {"count": 0, "flops": 0,
                                          "bytes": 0})

    def _collective(self, func, args, kwargs):
        name = func._overloadpacket.__name__
        meta = args[0].device.type == "meta"
        if name == "wait_tensor":
            return args[0] if meta else func(*args, **kwargs)
        out = _collective_meta(name, args) if meta \
            else func(*args, **kwargs)
        b = _nbytes(out)
        kind = _COLLECTIVES.get(name, name)
        self.colls[kind] += b
        self.bytes += b
        rec = self.by_op[f"_c10d_functional.{name}"]
        rec["count"] += 1
        rec["bytes"] += b
        self.live.add(out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return func(*args, **kwargs)
        if func.namespace == "_c10d_functional":
            return self._collective(func, args, kwargs)
        # a composite op (``linear``, ``einsum``, ``matmul``: what reaches
        # the mode under ``inference_mode``) counts as the ops it is made of
        if func._overloadpacket not in flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        rec = self.by_op[str(packet)]
        rec["count"] += 1
        formula = flop_registry.get(packet)
        if formula is not None:
            f = int(formula(*args, **kwargs, out_val=out))
            rec["flops"] += f
            self.flops += f
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if func not in _NO_DATA and not _is_view(func):
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            b = sum(_nbytes(t) for t in ins + outs)
            rec["bytes"] += b
            self.bytes += b
            for t in outs:
                self.live.add(t)
        elif func in _NO_DATA:
            for t in outs:
                self.live.add(t)
        return out


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once, counted. Returns ``flops``,
    ``bytes``, ``collectives`` (output bytes by kind; ``{}`` on one card),
    ``collective_bytes`` (their sum),
    ``peak_bytes``, ``entry_bytes`` (the inputs' device storages),
    ``end_bytes`` (the device storages live when ``fn`` returns),
    ``by_op`` (``{op: {"count", "flops", "bytes"}}``) and ``out``, what
    ``fn`` returned."""
    live = _Live()
    for t in _tensors((args, kwargs)):
        live.add(t)
    entry = live.now
    mode = _Count(live)
    with mode:
        out = fn(*args, **kwargs)
    return {"flops": float(mode.flops), "bytes": float(mode.bytes),
            "collectives": dict(mode.colls),
            "collective_bytes": float(sum(mode.colls.values())),
            "peak_bytes": float(live.peak), "entry_bytes": float(entry),
            "end_bytes": float(live.now),
            "by_op": {k: dict(v) for k, v in mode.by_op.items()},
            "out": out}
