"""Ulysses sequence parallelism: the all-to-all head scatter (port of
``skypilot_tpu/ops/ulysses.py``).

Instead of rotating KV blocks around the sp ranks, one all-to-all turns
the sequence split into a head split, every rank runs ordinary
whole-sequence attention over its heads
(``attention.local_attention(impl='auto')``: K4 forward and K5a/K5b
backward on CUDA), and a second all-to-all turns it back. q/k/v arrive split ``[b, S / sp, h, d]`` and the output leaves the
same way; inside, each rank holds ``[b, S, h / sp, d]``.

GQA: the kv heads must divide by sp as well; when they do not, kv is
expanded to per-q-head form first (``ring_attention.seq_parallel_call``).
The communicators are the ring's: one rank of a training mesh
(``mesh.all_to_all`` over the sp group) or every rank in one process
(``ring_attention.LockstepComm``, the op-level entry point's).
"""
from __future__ import annotations

from typing import Optional

import torch

from skypilot_tpu_torch.ops import ring_attention as ring
from skypilot_tpu_torch.parallel import mesh as mesh_lib


def _attn_body(comm, qs, ks, vs, *, causal: bool, scale: float):
    """Per rank: sequence split -> head split (one all-to-all of q, k and
    v together), whole-sequence attention on the local heads, and back."""
    from skypilot_tpu_torch.ops.attention import local_attention
    heads = comm.all_to_all(list(zip(qs, ks, vs)), 2, 1)
    outs = []
    for qh, kh, vh in heads:
        # attention() applies its own 1/sqrt(d): fold the caller's scale
        # in by pre-scaling q, in q's dtype.
        d = qh.shape[-1]
        qh = qh * torch.tensor(scale * d ** 0.5, dtype=qh.dtype,
                               device=qh.device)
        outs.append((local_attention(qh, kh, vh, causal=causal,
                                    impl='auto'),))
    return [o[0] for o in comm.all_to_all(outs, 1, 2)]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh=None, *, causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with the sequence split over sp through head
    scatter all-to-alls (``mesh`` as for
    ``ring_attention.seq_parallel_call``). Needs the heads, per tp shard,
    divisible by sp."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if mesh is None:
        sc = mesh_lib.training()
        sp, tp = sc.mesh.axis_size('sp'), 1     # q holds tp-local heads
    else:
        sizes = (None if isinstance(mesh, int)
                 else mesh_lib.mesh_axis_sizes(mesh))
        sp = mesh if sizes is None else sizes['sp']
        tp = 1 if sizes is None else sizes['tp']
    if sp == 1:
        from skypilot_tpu_torch.ops.attention import reference_attention
        return reference_attention(q, k, v, causal=causal, scale=scale)
    if q.shape[2] % tp or (q.shape[2] // tp) % sp:
        raise ValueError(
            f'ulysses needs n_heads per tp shard ({q.shape[2]}/{tp}) '
            f'divisible by sp={sp}; use ring attention for head counts '
            'below tp*sp')

    def body(comm, qs, ks, vs):
        return _attn_body(comm, qs, ks, vs, causal=causal, scale=scale)
    # GQA grouping survives the head scatter iff each kv head's whole q
    # group lands on one shard: the kv heads must divide by sp.
    return ring.seq_parallel_call(q, k, v, mesh, body, kv_head_modulus=sp)
