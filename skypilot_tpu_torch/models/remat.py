"""Remat policies of the training forward (the port of the reference's
``jax.checkpoint`` policies in ``skypilot_tpu/models/llama.py``
``forward``).

- ``'none'``: autograd keeps every intermediate.
- ``'block'`` (``nothing_saveable``): each layer under
  ``torch.utils.checkpoint``; only its input is kept and the backward
  re-runs the whole layer, attention included.
- ``'attn'`` (``save_only_these_names('q_rope', 'k_rope', 'v_proj',
  'attn_out')``): ``llama.forward`` checkpoints the part of the layer
  before the attention and the part after it separately, and leaves
  the attention between them, which keeps its own inputs and output
  (the flash path's q, k, v, out and logsumexp); the backward never
  re-runs the attention forward.
- ``'dots'`` (``dots_with_no_batch_dims_saveable``): each layer under a
  selective checkpoint that keeps the outputs of the products with no
  batch dimension and recomputes everything else.

Which products those are is decided at their call sites, not from the
ATen op: ``torch.einsum`` lowers a product with no batch dimension to
``bmm`` as readily as the attention's head-batched score products. The
layer's weight projections (q, k, v, o, the FFN's three, the MoE
router) and LoRA's thin products run inside :func:`weight_products`,
and the policy saves a matrix product only when it runs there.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

POLICIES = ('none', 'block', 'attn', 'dots')

_MATMULS = frozenset((torch.ops.aten.mm, torch.ops.aten.bmm,
                      torch.ops.aten.addmm, torch.ops.aten.baddbmm))
_tag = threading.local()


@contextlib.contextmanager
def weight_products():
    """Marks the matrix products run inside as products with no batch
    dimension (saved under ``'dots'``)."""
    prev = getattr(_tag, 'on', False)
    _tag.on = True
    try:
        yield
    finally:
        _tag.on = prev


def _dots_policy(ctx, op, *args, **kwargs):  # pylint: disable=unused-argument
    if getattr(_tag, 'on', False) and op.overloadpacket in _MATMULS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def dots_contexts():
    """``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for
    ``'dots'``."""
    return create_selective_checkpoint_contexts(_dots_policy)
