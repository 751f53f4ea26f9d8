"""Mixture-of-experts FFN, Mixtral-class (the port's own copy of
``skypilot_tpu/models/moe.py``). Its leaves carry the reference's
logical axes (:func:`moe_logical_axes`); on a serving mesh the expert
axis has size 1, so every rank holds every expert with its ffn width
split over tp and :func:`moe_ffn` returns a partial sum over tp. On a
training mesh the experts fold over fsdp x sp and are all-gathered per
layer as fsdp gathers (``mesh.fsdp_gather``), and the layer computes
on every rank's tokens (``mesh.gather_rows``), so routing, capacity and
the drops are the whole batch's, as the reference's are (R6).

Dispatch is GShard-style capacity-based top-k: tokens are taken in
groups of :data:`_MOE_GROUP_SIZE`, each expert processes a fixed
``[capacity, d]`` buffer per group (capacity = group * k / E * the
capacity factor), and a (token, choice) pair past its expert's full
buffer is dropped: its combine weight is zero and the token's residual
passes through. The one-hot dispatch and combine contractions and the
expert products are plain ``einsum``s, as the reference computes them
in XLA outside any Pallas kernel.

The result equals the reference's choice for choice: top-k takes the
larger logit first and the lower expert index on ties (``lax.top_k``'s
order, here a stable descending sort); the weights are a softmax over
the k selected fp32 router logits; a pair's buffer position is the
running count of its expert over the group's pairs in token-major
order; the one-hots are built by comparison, so a position past the
capacity gives a zero row as ``jax.nn.one_hot`` does. Dispatch and
combine run in the activations' dtype, SiLU in fp32 cast back before
the ``* up``; int8 expert leaves dequantize through
:func:`quantization.deq` (codes times scale, rounded in the model
dtype).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from skypilot_tpu_torch.models import remat
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.quantization import deq, matmul_f32
from skypilot_tpu_torch.parallel import mesh as mesh_lib

Params = Dict[str, Any]

# Tokens are dispatched within fixed-size groups (GShard G x S layout):
# the one-hot dispatch tensor is [groups, GROUP, k, E, C] with C
# proportional to GROUP, so its memory is linear in the tokens.
_MOE_GROUP_SIZE = 512


def init_moe_params(cfg: ModelConfig, gen: torch.Generator,
                    device: torch.device, leaf=None) -> Params:
    """The MoE layer leaves with the reference's shapes and scaling
    (``N(0, 1) * fan_in ** -0.5``): ``router [L, d, E]``, ``moe_gate``/
    ``moe_up [L, E, d, f]``, ``moe_down [L, E, f, d]``, drawn from
    ``gen`` one layer at a time. ``leaf(name, shape, fan_in)``, when
    given, builds each stacked leaf instead (the caller's quantizing
    builder)."""
    d, f, E = cfg.dim, cfg.ffn_dim, cfg.n_experts

    def stacked(name, shape, fan_in):
        out = torch.empty((cfg.n_layers,) + shape, dtype=cfg.dtype,
                          device=device)
        for li in range(cfg.n_layers):
            w = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32)
            out[li] = w.mul_(fan_in ** -0.5).to(cfg.dtype)
        return out

    leaf = leaf or stacked
    return {
        'router': leaf('router', (d, E), d),
        'moe_gate': leaf('moe_gate', (E, d, f), d),
        'moe_up': leaf('moe_up', (E, d, f), d),
        'moe_down': leaf('moe_down', (E, f, d), f),
    }


def moe_logical_axes(cfg: ModelConfig) -> Params:
    """The MoE leaves' logical axes (the reference's): the router
    replicated, the experts on 'expert' (``('fsdp', 'sp')``, size 1 on a
    serving mesh, so every rank holds every expert) with their ffn width
    on 'mlp' (split over tp, as a dense FFN's is)."""
    del cfg
    return {
        'router': ('layers', 'embed', None),
        'moe_gate': ('layers', 'expert', 'embed', 'mlp'),
        'moe_up': ('layers', 'expert', 'embed', 'mlp'),
        'moe_down': ('layers', 'expert', 'mlp', 'embed'),
    }


def expert_capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert buffer size for a dispatch group: tokens * k / E
    scaled by the capacity factor, never below k."""
    ideal = num_tokens * cfg.n_experts_per_token / cfg.n_experts
    return max(cfg.n_experts_per_token,
               int(math.ceil(ideal * cfg.moe_capacity_factor)))


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a zero row for an index outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(router_logits: torch.Tensor, k: int):
    """Top-k of fp32 router logits [T, E]: (values, indices), larger
    first and the lower index first on ties."""
    vals, idx = torch.sort(router_logits, dim=-1, descending=True,
                           stable=True)
    return vals[:, :k], idx[:, :k]


def dispatch_slots(topk_idx: torch.Tensor, topk_w: torch.Tensor,
                   group: int, capacity: int, n_experts: int):
    """Buffer slots of the (token, choice) pairs of padded routing
    choices [Tp, k] taken in groups of ``group`` tokens: (assign [G,
    group * k, E] one-hot of each pair's expert, slot [G, group * k] its
    position in that expert's buffer, kept [G, group * k]). A pair's
    position is the running count of its expert over the group's pairs,
    token-major; pairs at position >= ``capacity``, and padding pairs
    (weight 0), drop to the residual path."""
    G = topk_idx.shape[0] // group
    k = topk_idx.shape[1]
    assign = _one_hot(topk_idx, n_experts, torch.int32).reshape(
        G, group * k, n_experts)
    position = torch.cumsum(assign, dim=1) * assign - assign
    slot = position.sum(-1)
    kept = (slot < capacity) & (topk_w.reshape(G, group * k) > 0)
    return assign, slot, kept


def moe_ffn(layer: Params, x: torch.Tensor, cfg: ModelConfig):
    """Capacity-based top-k routed SwiGLU experts (GShard dispatch).

    x: [b, s, d] -> ([b, s, d], aux_loss fp32 scalar), the aux loss the
    Switch-style load-balancing term (:func:`load_balancing_loss`).
    Every row of ``x`` claims buffer slots, padding rows included."""
    k, E = cfg.n_experts_per_token, cfg.n_experts
    b, s, d = x.shape
    T = b * s
    xt = x.reshape(T, d)
    with remat.weight_products():
        router_logits = matmul_f32(xt, layer['router'])        # [T, E]
    topk_vals, topk_idx = route(router_logits, k)
    topk_w = torch.softmax(topk_vals, dim=-1)                   # [T, k]
    aux = load_balancing_loss(router_logits.reshape(b, s, E),
                              topk_idx.reshape(b, s, k), E)

    # Pad T up to a multiple of the group size; padded pairs carry zero
    # weight, so they never claim a slot.
    group = min(_MOE_GROUP_SIZE, T)
    pad = (-T) % group
    G = (T + pad) // group
    C = expert_capacity(group, cfg)
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
        topk_idx = F.pad(topk_idx, (0, 0, 0, pad))
        topk_w = F.pad(topk_w, (0, 0, 0, pad))

    assign, slot, kept = dispatch_slots(topk_idx, topk_w, group, C, E)
    slot_oh = _one_hot(slot, C, x.dtype) * kept[..., None].to(x.dtype)
    dispatch = (assign.to(x.dtype)[..., None]
                * slot_oh[..., None, :]).reshape(G, group, k, E, C)
    dispatch_mask = dispatch.sum(2)                             # [G,g,E,C]
    combine = torch.einsum('gtk,gtkec->gtec',
                           topk_w.reshape(G, group, k).to(x.dtype), dispatch)

    # Under a training mesh with the experts' ffn width split over tp,
    # the replicated dispatch and combine meet tp-split products: their
    # gradients sum over tp (mesh.tp_copy; identity elsewhere).
    combine = mesh_lib.tp_copy(combine, 'mlp')
    xg = xt.reshape(G, group, d)
    expert_in = mesh_lib.tp_copy(
        torch.einsum('gtec,gtd->gecd', dispatch_mask, xg), 'mlp')
    gate = torch.einsum('gecd,edf->gecf', expert_in, deq(layer['moe_gate']))
    up = torch.einsum('gecd,edf->gecf', expert_in, deq(layer['moe_up']))
    h = F.silu(gate.float()).to(x.dtype) * up
    expert_out = torch.einsum('gecf,efd->gecd', h, deq(layer['moe_down']))
    out = torch.einsum('gtec,gecd->gtd', combine, expert_out)
    return out.reshape(G * group, d)[:T].reshape(b, s, d), aux


def load_balancing_loss(router_logits: torch.Tensor, topk_idx: torch.Tensor,
                        n_experts: int) -> torch.Tensor:
    """Auxiliary load-balancing loss (Switch/Mixtral top-k form): E *
    sum over experts of (share of the k assignments) * (mean router
    probability)."""
    probs = torch.softmax(router_logits, dim=-1)                # [b, s, E]
    k = topk_idx.shape[-1]
    frac_tokens = _one_hot(topk_idx, n_experts, torch.float32).sum(2).mean(
        (0, 1)) / k
    frac_probs = probs.mean((0, 1))
    return n_experts * torch.sum(frac_tokens * frac_probs)
