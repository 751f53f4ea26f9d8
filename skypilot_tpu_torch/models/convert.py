"""Parameter and KV-cache conversion from the JAX package's trees.

``params_from_numpy`` takes the JAX param tree as host numpy arrays
(``jax.device_get(llama.init_params(...))``) and returns the port's
parameter dict with the same keys and layouts, so both packages compute
with the same weights. A tree the JAX package already quantized to int8
arrives with ``(int8, scale)`` named-tuple leaves and becomes the port's
``QuantizedWeight`` leaves: both packages then compute with the same
codes. ``kv_cache_from_numpy`` carries the slot engine's state across the same
way: a JAX ``KVCache`` as numpy (codes and scales included, int4's
packed rows too) becomes the port's ``llama.KVCache``. ``params_to_numpy`` goes the other way, so a
test can hold the port's params or grads after training steps against
the JAX package's. This module imports neither package's JAX code: the
trees arrive and leave as plain numpy."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from skypilot_tpu_torch.models.configs import ModelConfig, check_supported
from skypilot_tpu_torch.models.llama import KVCache, Params
from skypilot_tpu_torch.models.quantization import (QUANT_LEAF_TYPES,
                                                    QuantizedWeight,
                                                    QuantizedWeight4)
from skypilot_tpu_torch.utils.device import DeviceLike, resolve_device

_LAYER_KEYS = ('attn_norm', 'ffn_norm', 'wq', 'wk', 'wv', 'wo')
_FFN_KEYS = ('w_gate', 'w_up', 'w_down')
_MOE_KEYS = ('router', 'moe_gate', 'moe_up', 'moe_down')
_BIAS_KEYS = ('bq', 'bk', 'bv')
FP32_KEYS = ('final_norm', 'attn_norm', 'ffn_norm') + _BIAS_KEYS


def param_keys(cfg: ModelConfig):
    """(top-level keys, layer keys) of a param tree for ``cfg``: no
    ``unembed`` under tied embeddings, q/k/v biases under ``qkv_bias``,
    the router and expert leaves in place of the dense FFN under
    ``is_moe``."""
    top = ('embed', 'final_norm') + (() if cfg.tie_embeddings
                                     else ('unembed',))
    return top, (_LAYER_KEYS + (_MOE_KEYS if cfg.is_moe else _FFN_KEYS)
                 + (_BIAS_KEYS if cfg.qkv_bias else ()))


def _to_tensor(arr: Any) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == 'bfloat16':        # ml_dtypes bfloat16
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.uint16).copy()
        ).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, *,
                      device: DeviceLike = 'cuda') -> Params:
    """The JAX param tree (numpy leaves) as the port's parameters on
    ``device``: weights in ``cfg.dtype``, norms in fp32, int8 leaves as
    ``QuantizedWeight`` (codes int8, scales in ``cfg.dtype``) and int4
    leaves as ``QuantizedWeight4`` (packed uint8 codes, scales in
    ``cfg.dtype``). A LoRA tree (``cfg.lora_enabled``) brings its
    ``layers['lora']`` adapters across in fp32, whatever ``cfg.dtype``
    is."""
    check_supported(cfg)
    dev = resolve_device(device)
    top, layer_keys = param_keys(cfg)
    lora_key = {'lora'} if cfg.lora_enabled else set()
    extra = (set(tree) - set(top) - {'layers'}) | (
        set(tree['layers']) - set(layer_keys) - lora_key)
    if extra:
        raise NotImplementedError(
            f'param leaves {sorted(extra)} are not supported by the port')

    def leaf(name, arr):
        fields = getattr(arr, '_fields', None)
        if fields == ('int8', 'scale'):
            return QuantizedWeight(
                int8=_to_tensor(arr.int8).to(device=dev, dtype=torch.int8),
                scale=_to_tensor(arr.scale).to(device=dev, dtype=cfg.dtype))
        if fields == ('packed', 'scale'):
            return QuantizedWeight4(
                packed=_to_tensor(arr.packed).to(device=dev,
                                                 dtype=torch.uint8),
                scale=_to_tensor(arr.scale).to(device=dev, dtype=cfg.dtype))
        if fields is not None:
            raise NotImplementedError(
                f'param leaf {name!r} is a {fields} tuple; only int8 and '
                'int4 quantized leaves are ported')
        dtype = torch.float32 if name in FP32_KEYS else cfg.dtype
        return _to_tensor(arr).to(device=dev, dtype=dtype)

    out: Params = {k: leaf(k, tree[k]) for k in top}
    out['layers'] = {k: leaf(k, tree['layers'][k]) for k in layer_keys}
    if lora_key and 'lora' in tree['layers']:
        out['layers']['lora'] = {
            t: {k: _to_tensor(v).to(device=dev, dtype=torch.float32)
                for k, v in ab.items()}
            for t, ab in tree['layers']['lora'].items()}
    return out


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy` for unquantized trees
    (dense or MoE, with or without ``layers['lora']``): the port's
    params, or any subtree of them such as a gradient or adapter tree,
    as host numpy with the JAX tree's keys and layouts. numpy has no
    bfloat16, so bf16 leaves come back as fp32 holding the same values
    (``params_from_numpy`` casts them back exactly). Quantized leaves
    are refused: nothing trains them."""
    def leaf(v):
        if isinstance(v, dict):
            return {k: leaf(x) for k, x in v.items()}
        if isinstance(v, QUANT_LEAF_TYPES):
            raise NotImplementedError(
                'params_to_numpy takes dense trees; quantized leaves are '
                'not converted back')
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()

    return leaf(params)


def kv_cache_from_numpy(cache: Any, cfg: ModelConfig, *,
                        device: DeviceLike = 'cuda') -> KVCache:
    """A JAX ``KVCache`` with numpy leaves (``jax.device_get(cache)``) as
    the port's ``KVCache`` on ``device``, byte for byte: k/v [L, b, S,
    hkv, d] in ``cfg.dtype``, int8 codes, or packed int4 rows [..., d //
    2] uint8, the codes with their fp32 [L, b, S, hkv, 1] scales, and
    the int32 lengths."""
    dev = resolve_device(device)
    k, v = np.asarray(cache.k), np.asarray(cache.v)
    want = (cfg.n_layers, k.shape[1], k.shape[2], cfg.n_kv_heads,
            cfg.head_dim // 2 if k.dtype == np.uint8 else cfg.head_dim)
    if k.shape != want or v.shape != want:
        raise ValueError(f'cache k/v {k.shape}/{v.shape} do not match the '
                         f'config ([L, b, S, hkv, d] = {want})')
    length = _to_tensor(cache.length).to(device=dev, dtype=torch.int32)
    if cache.k_scale is None:
        return KVCache(_to_tensor(k).to(device=dev, dtype=cfg.dtype),
                       _to_tensor(v).to(device=dev, dtype=cfg.dtype), length)
    if k.dtype not in (np.int8, np.uint8):
        raise ValueError(f'a quantized cache holds int8 codes or packed '
                         f'uint8 rows, got {k.dtype}')
    return KVCache(*(_to_tensor(a).to(dev) for a in (k, v)), length,
                   *(_to_tensor(a).to(device=dev, dtype=torch.float32)
                     for a in (cache.k_scale, cache.v_scale)))
