"""LoRA adapters: training and serving by folding (own copy of
``skypilot_tpu/models/lora.py``).

- Adapter leaves live under ``params['layers']['lora'][target]['a'|'b']``
  with the layer dimension stacked on the leading axis: ``a`` contracts
  the projection's input axes down to ``rank``, ``b`` expands ``rank``
  to its output axes.
- :func:`merge` folds ``W + (alpha / rank) * A @ B`` into the base
  weights, one layer at a time in the base dtype; the engines call
  :func:`maybe_merge`, so a LoRA checkpoint is served as its merged
  model. Only a bf16/fp32 base can be merged: quantize after merging.

- Training: :func:`init_lora_layers` draws ``a`` ~ N(0, 1/fan_in) and
  ``b`` = 0 in fp32, so the adapted model's first forward equals the
  base model's bit for bit; ``llama._layer_core`` adds :func:`apply`'s
  delta next to each adapted projection; the trainer differentiates
  only the adapter leaves (:func:`split_lora`), the base stays frozen.
  The factors stay fp32 and are cast to the activation dtype at apply
  time.

Per-request adapters over one base are the multi-LoRA bank
(``models/multilora.py``).

Under a training mesh the adapters carry the reference's logical axes
(:func:`lora_logical_axes`: the rank axis replicated, the input and
output axes those of the adapted projection), and a column-parallel
target's rank-``r`` product enters its tp-split ``b`` through
``mesh.tp_copy`` (and a row-parallel target's replicated ``b`` meets
the partial product the same way), so their gradients sum over tp.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from skypilot_tpu_torch.models import remat
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.utils.device import DeviceLike, resolve_device

Params = Dict[str, Any]

_ATTN_TARGETS = ('wq', 'wk', 'wv', 'wo')
_MLP_TARGETS = ('w_gate', 'w_up', 'w_down')

# The per-layer fold of each target: a [*in, r] with b [r, *out] into
# the weight's [*in, *out].
_FOLD_SPECS = {
    'wq': 'dr,rhk->dhk', 'wk': 'dr,rhk->dhk',
    'wv': 'dr,rhk->dhk', 'wo': 'hkr,rd->hkd',
    'w_gate': 'dr,rf->df', 'w_up': 'dr,rf->df',
    'w_down': 'fr,rd->fd',
}


def resolve_targets(cfg: ModelConfig) -> Tuple[str, ...]:
    """Validated adapter targets for this config."""
    targets = tuple(cfg.lora_targets)
    for t in targets:
        if t not in _ATTN_TARGETS + _MLP_TARGETS:
            raise ValueError(
                f'unknown LoRA target {t!r}; legal: '
                f'{_ATTN_TARGETS + _MLP_TARGETS}')
        if t in _MLP_TARGETS and cfg.is_moe:
            raise ValueError(
                f'LoRA target {t!r} needs a dense FFN; {cfg.name} is MoE '
                f'(adapt the attention projections instead)')
    return targets


def _target_shapes(cfg: ModelConfig, target: str):
    """(a_shape, b_shape) WITHOUT the leading layer axis. ``a`` ends in
    rank; ``b`` starts with rank."""
    d, hd, r = cfg.dim, cfg.head_dim, cfg.lora_rank
    n_h, n_kv, f = cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim
    return {
        'wq': ((d, r), (r, n_h, hd)),
        'wk': ((d, r), (r, n_kv, hd)),
        'wv': ((d, r), (r, n_kv, hd)),
        'wo': ((n_h, hd, r), (r, d)),
        'w_gate': ((d, r), (r, f)),
        'w_up': ((d, r), (r, f)),
        'w_down': ((f, r), (r, d)),
    }[target]


def _target_axes(target: str):
    """Logical axes for (a, b), leading 'layers' axis included. The rank
    axis is None (replicated); the input and output axes mirror the
    adapted projection's."""
    axes = {
        'wq': (('embed', None), (None, 'heads', 'head_dim')),
        'wk': (('embed', None), (None, 'kv_heads', 'head_dim')),
        'wv': (('embed', None), (None, 'kv_heads', 'head_dim')),
        'wo': (('heads', 'head_dim', None), (None, 'embed')),
        'w_gate': (('embed', None), (None, 'mlp')),
        'w_up': (('embed', None), (None, 'mlp')),
        'w_down': (('mlp', None), (None, 'embed')),
    }[target]
    return tuple(('layers',) + a for a in axes)


def lora_logical_axes(cfg: ModelConfig) -> Params:
    """The adapter subtree's logical axes (the reference's)."""
    return {t: {'a': _target_axes(t)[0], 'b': _target_axes(t)[1]}
            for t in resolve_targets(cfg)}


# The tp-split logical axis of each column-parallel target's output; a
# row-parallel target's input is split instead (its partial sum is
# reduced with its base product's, and its replicated ``b`` meets that
# partial sum).
_COLUMN_SPLIT = {'wq': 'heads', 'wk': 'kv_heads', 'wv': 'kv_heads',
                 'w_gate': 'mlp', 'w_up': 'mlp'}
_ROW_SPLIT = {'wo': 'heads', 'w_down': 'mlp'}


def init_lora_layers(cfg: ModelConfig, gen: torch.Generator, *,
                     device: DeviceLike = 'cuda') -> Params:
    """The ``params['layers']['lora']`` subtree: per-target a/b stacks
    ``[L, ...]`` in fp32 on ``device``, ``a`` ~ N(0, 1/fan_in) drawn
    from ``gen`` (a generator on that device) target by target, ``b`` =
    0: the delta is exactly zero until training moves ``b``."""
    dev = resolve_device(device)
    L = cfg.n_layers
    out: Params = {}
    for t in resolve_targets(cfg):
        a_shape, b_shape = _target_shapes(cfg, t)
        fan_in = 1
        for s in a_shape[:-1]:
            fan_in *= s
        a = torch.randn((L,) + a_shape, generator=gen, device=dev,
                        dtype=torch.float32)
        out[t] = {'a': a.mul_(fan_in ** -0.5),
                  'b': torch.zeros((L,) + b_shape, dtype=torch.float32,
                                   device=dev)}
    return out


def _ab_matmul(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               target: str) -> torch.Tensor:
    """x -> (x @ a) @ b for one layer's adapter, the factors cast to x's
    dtype (each product rounds to it, as the reference's einsums do)."""
    dt = x.dtype
    b = mesh_lib.tp_copy(b, _ROW_SPLIT.get(target))
    with remat.weight_products():
        if target == 'wo':                       # x: [b, s, h, k]
            z = torch.einsum('bshk,hkr->bsr', x, a.to(dt))
            return torch.einsum('bsr,rd->bsd', z, b.to(dt))
        z = torch.einsum('bsd,dr->bsr', x, a.to(dt))
        z = mesh_lib.tp_copy(z, _COLUMN_SPLIT.get(target))
        if target in ('wq', 'wk', 'wv'):
            return torch.einsum('bsr,rhk->bshk', z, b.to(dt))
        return torch.einsum('bsr,rf->bsf', z, b.to(dt))


def apply(lora_layer: Params, target: str, x: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """The scaled low-rank delta for ``target`` in x's dtype (the scale
    multiplies in that dtype), or a zero scalar if not adapted."""
    if lora_layer is None or target not in lora_layer:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    ab = lora_layer[target]
    return cfg.lora_scale * _ab_matmul(x, ab['a'], ab['b'], target)


def merge(cfg: ModelConfig, params: Params) -> Tuple[ModelConfig, Params]:
    """Fold the adapters into the base weights for serving:
    ``W <- W + (alpha/rank) * A @ B`` per target, per layer, in the base
    dtype (the reference's ``lax.map`` over layers: one layer's delta at
    a time, never the stacked fp32 delta). Returns (cfg with lora off,
    params without 'lora'); the caller's tree is left as it was.

    Only a bf16/fp32 base can be merged: quantize AFTER merging."""
    from skypilot_tpu_torch.models.quantization import quantized_mode
    layers = params['layers']
    if 'lora' not in layers:
        return dataclasses.replace(cfg, lora_rank=0), params
    if quantized_mode(params) is not None:
        raise ValueError('cannot merge LoRA into an int8 base; load the '
                         'bf16 checkpoint, merge, then quantize')
    # The fold scale comes from the CONFIG (alpha/rank): refuse to guess
    # when the config says no-LoRA but the tree carries adapters.
    first_ab = next(iter(layers['lora'].values()))
    tree_rank = int(first_ab['a'].shape[-1])
    if not cfg.lora_enabled:
        raise ValueError(
            f'params carry LoRA adapters (rank {tree_rank}) but '
            f'cfg.lora_rank == 0; pass the training config, e.g. '
            f'dataclasses.replace(cfg, lora_rank={tree_rank}, '
            f'lora_alpha=<alpha used in training>)')
    if tree_rank != cfg.lora_rank:
        raise ValueError(
            f'adapter rank in params ({tree_rank}) != cfg.lora_rank '
            f'({cfg.lora_rank})')
    scale = cfg.lora_scale
    new_layers = dict(layers)
    lora_tree = new_layers.pop('lora')
    with torch.no_grad():
        for t, ab in lora_tree.items():
            w = new_layers[t]
            out = torch.empty_like(w)
            for li in range(w.shape[0]):
                w_l = w[li]
                a_l = torch.as_tensor(ab['a'][li]).to(w_l.device, w_l.dtype)
                b_l = torch.as_tensor(ab['b'][li]).to(w_l.device, w_l.dtype)
                d = torch.einsum(_FOLD_SPECS[t], a_l, b_l)
                out[li] = w_l + (scale * d).to(w_l.dtype)
            new_layers[t] = out
    merged = dict(params, layers=new_layers)
    return dataclasses.replace(cfg, lora_rank=0), merged


def maybe_merge(cfg: ModelConfig, params) -> Tuple[ModelConfig, Any]:
    """Engine entry: serve a LoRA checkpoint by folding its adapters.
    No-op when params is None or carries no adapters (the config's LoRA
    fields are cleared either way)."""
    if params is None or 'lora' not in params.get('layers', {}):
        if cfg.lora_enabled:
            cfg = dataclasses.replace(cfg, lora_rank=0)
        return cfg, params
    return merge(cfg, params)


def split_lora(params: Params) -> Params:
    """The trainable adapter subtree (shared structure with params)."""
    return params['layers']['lora']


def with_lora(params: Params, lora_tree: Params) -> Params:
    """params with its adapter subtree replaced (no mutation)."""
    return dict(params, layers=dict(params['layers'], lora=lora_tree))
