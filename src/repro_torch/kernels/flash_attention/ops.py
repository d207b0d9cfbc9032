"""The attention op of the model's prefill on K6.

Counterpart of ``repro/kernels/flash_attention/ops.py``. The JAX op's
``block_q``, ``block_k`` and ``interpret`` arguments are the TPU's VMEM
tiling and its interpret mode; the port's kernel picks its own tiles and
has no interpret mode (a CPU tensor runs the plain version), so
``flash_attention_op`` drops them.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    flash_attention_ref)


def flash_attention_op(q, k, v, *, causal=True, scale=None,
                       return_lse=False):
    """``flash_attention_fwd`` (see ``kernel.py``) on contiguous inputs:
    K6 on the card, the dense plain version on the CPU; ``return_lse``
    also gives each row's log-sum-exp. ``block_q``, ``block_k`` and
    ``interpret`` of the JAX op do not exist here."""
    return flash_attention_fwd(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, scale=scale,
                               return_lse=return_lse)
