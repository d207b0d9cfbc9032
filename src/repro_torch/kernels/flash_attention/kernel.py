"""Wrapper of K6 ``flash_attention_fwd``: causal GQA attention forward.

The CUDA kernel is in ``kernels/csrc/flash_attention.cu`` (source note
there: the TPU kernel it replaces, what bounds it, what the design does
about it). On CUDA tensors the wrapper launches it on the current stream
and adds one to ``launches``; on CPU tensors it runs the plain version
from ``ref.py``. There is no fallback: a CUDA tensor never reaches the
plain version, and a build or launch error raises. With
``return_lse=True`` it also gives each row's log-sum-exp, the residual of
the backward pass. The kernel has no backward of its own: where autograd
tracks an input on the card, the wrapper goes through the attention's
autograd Function (``repro_torch.models.attention.flash_core``), whose
forward is this kernel and whose backward is plain PyTorch, as the JAX
package's ``_flash_core_bwd`` is plain XLA.

The launch is one custom op, ``torch.ops.repro_torch.flash_attention_fwd``,
so that a dispatch mode (``repro_torch.roofline_hlo.analyze``) sees it
as one op: its CUDA version launches the kernel, its ``meta`` version
only makes the outputs' shapes (the dry run counts the card's work on
``meta`` tensors, which take the card's branch here), and its flop
formula is K6's count in ``repro_torch.roofline``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.roofline import flash_attention_work

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOS = {"flash_attention_fwd": [_P] * 5 + [_I] * 8
           + [ctypes.c_float, _I, _P, _P]}
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
BLOCK_Q = 64               # query rows per block: 4 warps of 16
THREADS = 128
WG_BLOCK_Q = 128           # flash_fwd_wgmma: 2 warpgroups of 64 rows
WG_THREADS = 256
STAGES = 2                 # depth of the k/v ring in shared memory
Q_REG_MAX = 64             # dh and dv up to this: q fragments in registers
SMEM_MAX = 232448          # shared memory one block may use on sm_90
GRID_Y_MAX = 65535


class Geometry(NamedTuple):
    """How one call of K6 is launched (see ``launch_geometry``)."""
    wgmma: bool            # float32, dh and dv <= 64: flash_fwd_wgmma
    q_in_registers: bool   # q's split fragments in registers (else smem)
    block_q: int
    block_k: int           # keys per tile of the ring
    stages: int
    threads: int
    dh_pad: int            # dh rounded up to the MMA depth of two k steps
    dv_pad: int            # dv rounded up to 32 (output column groups)
    dv_class: int          # the kernel's output width template: 64/128/256
    k_stride: int          # elements per row of a q or k tile in smem
    v_stride: int          # elements per row of a v tile in smem
    smem_bytes: int        # dynamic shared memory
    grid: tuple            # (B * H, query tiles), heaviest tile first

    def c_args(self):
        """The eleven ints the C entry launches with, once it has checked
        that they fit the kernel they pick, the shapes and the card."""
        return (int(self.wgmma), int(self.q_in_registers), self.block_k,
                self.dh_pad, self.dv_pad, self.dv_class, self.k_stride,
                self.v_stride, self.smem_bytes, *self.grid)


def launch_geometry(B: int, Sq: int, H: int, dh: int, dv: int,
                    dtype=torch.float32) -> Geometry:
    """K6's launch for q ``(B, Sq, H, dh)`` and v's width ``dv``.

    float32 with dh and dv up to ``Q_REG_MAX`` (the serve path) runs
    ``flash_fwd_wgmma``: 128-row blocks of two warpgroups, dh and dv padded
    to 64, the ring of raw k and v tiles plus the hi and lo planes of one
    64-key tile. Everything else runs ``flash_fwd_mma``, 64-row blocks: dh
    and dv up to ``Q_REG_MAX`` (bf16) keep q's fragments in registers and a
    key tile of 64; above, q stays in shared memory and the key tile is 32
    (the output accumulator takes up to 128 registers at dv 256). There dh
    is padded to the depth of two MMA k steps (16 in float32, 32 in bf16),
    dv to 32; row strides put a k row 64 bytes past a multiple of 128 and a
    v row 16 past a multiple of 64, so the fragment reads are free of bank
    conflicts; shared memory holds ``STAGES`` k and v tiles, plus the q
    tile when it stays there (with q in registers it is staged in ring
    stage 1)."""
    es = 4 if dtype == torch.float32 else 2
    q_reg = dh <= Q_REG_MAX and dv <= Q_REG_MAX
    if q_reg and es == 4:
        # flash_fwd_wgmma: 2 warpgroups of 64 rows, dh and dv padded to
        # 64, raw k and v rows 68 floats apart, and the split hi and lo
        # planes of a 64-key tile (k, and v transposed)
        return Geometry(True, True, WG_BLOCK_Q, 64, STAGES, WG_THREADS,
                        64, 64, 64, 68, 68,
                        (STAGES * 64 * 2 * 68 + 4 * 64 * 64) * es,
                        (B * H, math.ceil(Sq / WG_BLOCK_Q)))
    block_k = 64 if q_reg else 32
    kc = 16 if es == 4 else 32
    dh_pad = math.ceil(dh / kc) * kc
    dv_pad = math.ceil(dv / 32) * 32
    dv_class = 64 if dv_pad <= 64 else 128 if dv_pad <= 128 else 256
    k_stride = dh_pad + (64 - dh_pad * es) % 128 // es
    v_stride = dv_pad + 16 // es
    smem = (STAGES * block_k * (k_stride + v_stride)
            + (0 if q_reg else BLOCK_Q * k_stride)) * es
    return Geometry(False, q_reg, BLOCK_Q, block_k, STAGES, THREADS, dh_pad,
                    dv_pad, dv_class, k_stride, v_stride, smem,
                    (B * H, math.ceil(Sq / BLOCK_Q)))


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        scale: float | None = None, return_lse: bool = False):
    """Attention forward: q ``(B, Sq, H, dh)``, k ``(B, Sk, KV, dh)``, v
    ``(B, Sk, KV, dv)``. Returns ``(B, Sq, H, dv)`` in q's dtype; with
    ``return_lse`` also the float32 log-sum-exp of each row's scaled
    scores, ``(B, H, Sq)``.

    Head h reads kv head ``h // (H // KV)`` (``KV = 1`` is MQA); causal
    masking is top-left aligned (``pos_q >= pos_k``, both from 0); ``scale``
    defaults to ``dh ** -0.5``. float32 or bfloat16, all three alike, with
    float32 accumulation; ``dh`` and ``dv`` up to 256 each; any ``Sq`` and
    ``Sk >= 1``.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, dim)")
    B, Sq, H, dh = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    if (tuple(k.shape) != (B, Sk, KV, dh)
            or tuple(v.shape) != (B, Sk, KV, dv)):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if KV < 1 or H % KV or Sk < 1:
        raise ValueError(f"need Sk >= 1 and H % KV == 0 (H={H}, KV={KV}, "
                         f"Sk={Sk})")
    if not (1 <= dh <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"dh={dh}, dv={dv}: each must be in 1..256")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {_DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    scale = dh ** -0.5 if scale is None else float(scale)
    if not _build.card_branch(q):
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   return_lse=return_lse)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        from repro_torch.models.attention import flash_core
        return flash_core(q, k, v, causal=causal, scale=scale,
                          return_lse=return_lse)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Sq > GRID_Y_MAX * BLOCK_Q:
        raise ValueError(f"Sq={Sq}: at most {GRID_Y_MAX * BLOCK_Q} queries")
    out, lse = torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, causal, scale, return_lse)
    return (out, lse) if return_lse else out


def _out_shapes(q, v, return_lse: bool):
    B, Sq, H, _ = q.shape
    return (B, Sq, H, v.shape[-1]), ((B, H, Sq) if return_lse else (0,))


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float, return_lse: bool) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """One launch of K6 on checked, contiguous CUDA inputs: ``(out,
    lse)``, ``lse`` empty unless ``return_lse``."""
    B, Sq, H, dh = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    o_shape, l_shape = _out_shapes(q, v, return_lse)
    out = torch.empty(o_shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(l_shape, dtype=torch.float32, device=q.device)
    args = launch_geometry(B, Sq, H, dh, dv, q.dtype).c_args()
    lib = _build.load("flash_attention", _PROTOS)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(lib, lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, B, Sq, Sk, H, KV, dh, dv,
        int(q.dtype == torch.bfloat16), scale, int(causal),
        (ctypes.c_int * len(args))(*args), stream), "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


@_launch.register_fake
def _launch_meta(q, k, v, causal, scale, return_lse):
    o_shape, l_shape = _out_shapes(q, v, return_lse)
    return (q.new_empty(o_shape),
            q.new_empty(l_shape, dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flops(q_shape, k_shape, v_shape, causal, scale, return_lse, *,
           out_shape=None, **kw) -> int:
    B, Sq, H, dh = q_shape
    Sk, KV, dv = k_shape[1], k_shape[2], v_shape[-1]
    return flash_attention_work(B, Sq, Sk, H, KV, dh, dv, causal=causal,
                                itemsize=1)[1]


flash_attention_fwd.launches = 0
