"""Llama-family decoder-only transformer in PyTorch (port of
``skypilot_tpu/models/llama.py``).

Parameters are a plain dict with the JAX package's tree and layouts:
``embed [V, d]``, ``unembed [d, V]`` (absent when the config ties the
embeddings), ``final_norm [d]`` (fp32) and ``layers`` holding per-layer
tensors stacked on a leading ``[L]`` axis (``wq [L, d, h, hd]``,
``wk``/``wv [L, d, hkv, hd]``, ``wo [L, h, hd, d]``, ``w_gate``/``w_up
[L, d, f]``, ``w_down [L, f, d]``, norms ``[L, d]`` fp32, and under
``qkv_bias`` fp32 ``bq [L, h, hd]``, ``bk``/``bv [L, hkv, hd]``; an MoE
config has ``router``, ``moe_gate``, ``moe_up``, ``moe_down`` in place
of the dense FFN leaves, ``models/moe.py``). A layer is a view into the
stack (:func:`layer_params`), so the per-layer Python loop that
replaces ``lax.scan`` copies nothing. Matmul weights may be int8
``QuantizedWeight`` or packed int4 ``QuantizedWeight4`` leaves
(``quantization.quantize_params``): every dense matmul goes through
``quantization.qeinsum``.

Numerics follow the reference: activations in the model dtype, fp32
norms, fp32 attention logits and softmax. The family knobs of
``ModelConfig`` follow it too: Gemma's ``x * (1 + w)`` norms
(``norm_plus_one``), ``sqrt(dim)`` input scale in fp32
(``scale_embeddings``), tied unembedding against ``embed`` and tanh GeGLU
(``activation='gelu'``); Qwen2's q/k/v biases added in the activations'
dtype before rope (``qkv_bias``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from skypilot_tpu_torch.models import (lora, moe, multilora, quantization,
                                       remat)
from skypilot_tpu_torch.models.configs import ModelConfig, check_supported
from skypilot_tpu_torch.models.quantization import (QUANT_LEAF_TYPES,
                                                    matmul_f32, pack_int4,
                                                    qeinsum)
from skypilot_tpu_torch.ops.attention import (attention, chunk_attention,
                                              ring_decode_attention)
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.utils.device import DeviceLike, resolve_device

Params = Dict[str, Any]

# Sentinel token emitted when a row's logits are non-finite (real token
# ids are >= 0): the host evicts exactly that request at readback.
NONFINITE_TOKEN = -1

# Constrained decoding masks to a large-negative, FINITE value (see the
# JAX package's note: -inf would turn a fully masked row into NaNs).
VOCAB_MASK_NEG = -1e9


# --------------------------------------------------------------------------
# Initialization
# --------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: Union[int, torch.Generator] = 0,
                *, device: DeviceLike = 'cuda',
                quantize: Optional[str] = None,
                cut: Optional[Callable] = None) -> Params:
    """Random parameters with the reference's scaling (``N(0, 1) *
    fan_in ** -0.5``; norms at one, or at zero under ``norm_plus_one``;
    q/k/v biases at fp32 zero; no ``unembed`` under tied embeddings),
    drawn from a ``torch.Generator`` on ``device``. Stacked weights are
    filled one layer at a time so the fp32 draw never holds more than
    one layer's slice.

    ``quantize='int8'``/``'int4'`` quantizes each slice as it is drawn
    (``quantization.quantize_slice``), so the model-dtype tree never
    exists: the result equals ``quantize_params(init_params(...))``
    from the same seed, and a model too large for the card in bf16
    (mixtral-8x7b, llama3-70b) builds within its quantized size.

    Under ``cfg.lora_enabled`` the fp32 adapters
    (``lora.init_lora_layers``, from the same generator after the base)
    go under ``params['layers']['lora']``.

    ``cut(path, leaf, layer=False)`` (a serving mesh's
    ``parallel.mesh.leaf_cutter``) keeps one rank's shard: each leaf,
    and each layer's slice of a stacked leaf, is cut as it is drawn, so
    the rank holds its shard and one full slice at most; the draws, and
    so the shard's values, are those of the whole tree."""
    check_supported(cfg)
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        # A meta tree (shapes only, the cost model's) draws nothing; its
        # generator is a CPU one, as meta has none.
        gen = torch.Generator(device=dev if dev.type != 'meta' else 'cpu')
        gen.manual_seed(int(seed))
    d, hd = cfg.dim, cfg.head_dim
    n_h, n_kv, f, L = cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim, cfg.n_layers

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return w.mul_(fan_in ** -0.5).to(cfg.dtype)

    if quantize not in (None, 'int8', 'int4'):
        raise ValueError(f'unknown quantize mode {quantize!r}')
    quantized = quantize is not None
    group = quantization.int4_group_size() if quantize == 'int4' else 0

    def keep(path, t, layer=False):
        return t if cut is None else cut(path, t, layer)

    def stacked(name, shape, fan_in):
        path = ('layers', name)
        if not (quantized and name in quantization.REDUCE_AXES):
            out = None
            for li in range(L):
                w = keep(path, dense(shape, fan_in), True)
                if out is None:
                    out = torch.empty((L,) + tuple(w.shape), dtype=w.dtype,
                                      device=dev)
                out[li] = w
            return out
        return quantization.quantize_stacked(
            name, (dense(shape, fan_in) for _ in range(L)), L, quantize,
            group, cut=None if cut is None else
            (lambda q: cut(path, q, True)))

    norm = torch.zeros if cfg.norm_plus_one else torch.ones
    params: Params = {'embed': keep(('embed',),
                                    dense((cfg.vocab_size, d), d))}
    if not cfg.tie_embeddings:
        params['unembed'] = dense((d, cfg.vocab_size), d)
        if quantized:
            params['unembed'] = quantization.quantize_slice(
                'unembed', params['unembed'], quantize, group)
        params['unembed'] = keep(('unembed',), params['unembed'])
    params['final_norm'] = norm(d, dtype=torch.float32, device=dev)
    params['layers'] = {
        'attn_norm': norm(L, d, dtype=torch.float32, device=dev),
        'ffn_norm': norm(L, d, dtype=torch.float32, device=dev),
        'wq': stacked('wq', (d, n_h, hd), d),
        'wk': stacked('wk', (d, n_kv, hd), d),
        'wv': stacked('wv', (d, n_kv, hd), d),
        'wo': stacked('wo', (n_h, hd, d), n_h * hd),
    }
    if cfg.is_moe:
        params['layers'].update(moe.init_moe_params(cfg, gen, dev,
                                                    leaf=stacked))
    else:
        params['layers'].update(
            w_gate=stacked('w_gate', (d, f), d),
            w_up=stacked('w_up', (d, f), d),
            w_down=stacked('w_down', (f, d), f))
    if cfg.qkv_bias:
        params['layers'].update(
            bq=torch.zeros(L, n_h, hd, dtype=torch.float32, device=dev),
            bk=torch.zeros(L, n_kv, hd, dtype=torch.float32, device=dev),
            bv=torch.zeros(L, n_kv, hd, dtype=torch.float32, device=dev))
    if cut is not None:
        # Norms and biases: drawn nothing, small; cut whole.
        for k in ('attn_norm', 'ffn_norm', 'bq', 'bk', 'bv'):
            if k in params['layers']:
                params['layers'][k] = cut(('layers', k),
                                          params['layers'][k])
    if cfg.lora_enabled:
        adapters = lora.init_lora_layers(cfg, gen, device=dev)
        if cut is not None:
            adapters = {t: {k: cut(('layers', 'lora', t, k), ab[k])
                            for k in ab} for t, ab in adapters.items()}
        params['layers']['lora'] = adapters
    return params


def param_logical_axes(cfg: ModelConfig) -> Params:
    """The params tree's structure with logical-axis tuples as leaves
    (the reference's ``param_logical_axes``): what
    ``parallel.mesh.shard_params`` cuts a mesh's shards by. The leading
    stack axis is 'layers' (over pp; never split when serving). A LoRA
    config's adapters carry ``lora.lora_logical_axes``; the serving
    engines still refuse trained adapters under a mesh (they merge
    them first, ``lora.maybe_merge``)."""
    axes: Params = {
        'embed': ('vocab_in', 'embed'),
        'final_norm': ('norm',),
        'layers': {
            'attn_norm': ('layers', 'norm'),
            'ffn_norm': ('layers', 'norm'),
            'wq': ('layers', 'embed', 'heads', 'head_dim'),
            'wk': ('layers', 'embed', 'kv_heads', 'head_dim'),
            'wv': ('layers', 'embed', 'kv_heads', 'head_dim'),
            'wo': ('layers', 'heads', 'head_dim', 'embed'),
        },
    }
    if cfg.qkv_bias:
        axes['layers'].update({
            'bq': ('layers', 'heads', 'head_dim'),
            'bk': ('layers', 'kv_heads', 'head_dim'),
            'bv': ('layers', 'kv_heads', 'head_dim'),
        })
    if not cfg.tie_embeddings:
        axes['unembed'] = ('embed', 'vocab')
    if cfg.is_moe:
        axes['layers'].update(moe.moe_logical_axes(cfg))
    else:
        axes['layers'].update({
            'w_gate': ('layers', 'embed', 'mlp'),
            'w_up': ('layers', 'embed', 'mlp'),
            'w_down': ('layers', 'mlp', 'embed'),
        })
    if cfg.lora_enabled:
        axes['layers']['lora'] = lora.lora_logical_axes(cfg)
    return axes


def _select_layers(layers: Params, select: Callable) -> Params:
    """``select`` applied to every stacked layer leaf: to a dense leaf's
    tensor, to a quantized leaf's codes and scales alike, and through
    nested dicts (the multi-LoRA bank, ``layers['mlora']``)."""
    def one(v):
        if isinstance(v, dict):
            return _select_layers(v, select)
        if isinstance(v, QUANT_LEAF_TYPES):
            return type(v)(*map(select, v))
        return select(v)
    return {k: one(v) for k, v in layers.items()}


def layer_params(params: Params, li: int) -> Params:
    """Layer ``li``'s weights as views into the stacked tensors."""
    return _select_layers(params['layers'], lambda t: t[li])


def unbind_layers(params: Params):
    """Every layer's weights, unbound from the stacked tensors once: a
    list of per-layer dicts of views. Under autograd the stack's
    backward then stacks the layers' gradients once (a per-layer
    ``stack[li]`` would build a full-stack gradient per layer)."""
    cols = _select_layers(params['layers'], torch.unbind)
    return [layer_params({'layers': cols}, li)
            for li in range(len(cols['attn_norm']))]


# [..., d] KV rows -> (int8 codes, [..., 1] fp32 scales): the one per-row
# int8 quantizer, shared with the W8A8 activations.
quantize_kv_rows = quantization.quantize_rows


def quantize_kv_rows4(rows: torch.Tensor):
    """[..., d] rows -> (packed uint8 [..., d // 2] nibble codes,
    [..., 1] fp32 scales): absmax/7 per row, clamp to +-7, packed along
    head_dim so every token row stays self-contained."""
    rf = rows.float()
    absmax = rf.abs().amax(-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(rf / scale), -7, 7).to(torch.int8)
    return pack_int4(q, axis=-1), scale


# --------------------------------------------------------------------------
# Slot KV cache
# --------------------------------------------------------------------------
class KVCache:
    """The slot engine's decode cache (port of the reference's
    ``KVCache``): k/v ``[L, b, S, hkv, d]`` (int4: packed uint8 ``[...,
    d // 2]``), ``length [b]`` int32 valid rows per slot, and for int8
    and int4 caches fp32 row scales ``[L, b, S, hkv, 1]``. Unlike the reference's named tuple it is updated IN PLACE: a
    write happens after every read of the same call, so the result is
    what the reference's functional update computes."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None):
        self.k = k
        self.v = v
        self.length = length
        self.k_scale = k_scale
        self.v_scale = v_scale

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def packed(self) -> bool:
        """int4 caches: two nibble codes per byte along head_dim."""
        return self.k.dtype == torch.uint8

    @property
    def quant_mode(self):
        """False | True (int8) | 'int4': what the row quantizer keys on
        (:func:`_quantize_rows`)."""
        return 'int4' if self.packed else self.quantized

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, max_seq: int, *,
               kv_dtype: str = 'bf16',
               device: DeviceLike = 'cuda') -> 'KVCache':
        """Zero caches of ``kv_dtype``: 'bf16' (the model dtype), 'int8'
        (codes with zero fp32 scales) or 'int4' (packed uint8 rows of
        ``head_dim // 2`` bytes with zero fp32 scales)."""
        dev = resolve_device(device)
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        length = torch.zeros((batch,), dtype=torch.int32, device=dev)
        if kv_dtype in ('int8', 'int4'):
            sshape = shape[:-1] + (1,)
            cshape, cdtype = shape, torch.int8
            if kv_dtype == 'int4':
                if cfg.head_dim % 2:
                    raise ValueError('int4 KV needs an even head_dim')
                cshape, cdtype = shape[:-1] + (cfg.head_dim // 2,), \
                    torch.uint8
            return cls(torch.zeros(cshape, dtype=cdtype, device=dev),
                       torch.zeros(cshape, dtype=cdtype, device=dev),
                       length,
                       torch.zeros(sshape, dtype=torch.float32, device=dev),
                       torch.zeros(sshape, dtype=torch.float32, device=dev))
        if kv_dtype != 'bf16':
            raise ValueError(f'unknown kv_dtype {kv_dtype!r}')
        return cls(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev), length)

    def tensors(self):
        """The stored tensors, scales included when quantized."""
        if self.quantized:
            return self.k, self.v, self.k_scale, self.v_scale
        return self.k, self.v


def _quantize_rows(k_rows, v_rows, quantize):
    """(k, v) -> (kq, vq, ks, vs) when ``quantize`` (True: int8 codes,
    'int4': packed nibble rows), else (k, v)."""
    if not quantize:
        return k_rows, v_rows
    quant = quantize_kv_rows4 if quantize == 'int4' else quantize_kv_rows
    kq, ks = quant(k_rows)
    vq, vs = quant(v_rows)
    return kq, vq, ks, vs


def merge_rows_into_cache(cache: KVCache, k_rows: torch.Tensor,
                          v_rows: torch.Tensor, starts: torch.Tensor,
                          new_length: torch.Tensor) -> KVCache:
    """Write new ``[L, b, n, hkv, d]`` rows into the cache at each batch
    row's ``starts`` offset and set the lengths to ``new_length`` (in
    place, the length tensor too; returns ``cache``), quantizing
    them on the way in for an int8 or int4 cache. The start is CLAMPED to
    ``S - n`` as the reference's ``dynamic_update_slice`` clamps it."""
    n = k_rows.shape[2]
    S = cache.k.shape[2]
    dev = cache.k.device
    start = torch.clamp(starts.to(dev).long(), 0, S - n)
    pos = start[:, None] + torch.arange(n, device=dev)[None, :]   # [b, n]
    rows = torch.arange(pos.shape[0], device=dev)[:, None]
    new = _quantize_rows(k_rows, v_rows, cache.quant_mode)
    for dst, r in zip(cache.tensors(), new):
        dst[:, rows, pos] = r.to(dst.dtype)
    # In place: a decode call's graph reads the same length tensor.
    cache.length.copy_(new_length)
    return cache


# --------------------------------------------------------------------------
# Building blocks
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in fp32: ``x * w``, or Gemma's ``x * (1 + w)`` under
    ``plus_one``."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    scale = (1.0 + w) if plus_one else w
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _embed_tokens(params: Params, tokens: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    x = F.embedding(tokens, params['embed'])
    if cfg.scale_embeddings:                  # Gemma: sqrt(dim) input scale
        x = (x.float() * cfg.dim ** 0.5).to(x.dtype)
    return x


def _unembed_logits(params: Params, x: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """fp32 logits: the product is kept in fp32 (the reference's
    ``preferred_element_type=float32``), never rounded to the model
    dtype. Tied embeddings multiply by ``embed`` transposed (never
    quantized, so in the model dtype under int8 weights too).

    Under a serving mesh the unembedding is vocab-sharded (``'vocab':
    'tp'``; a tied one multiplies by this rank's rows of the replicated
    ``embed``): each rank computes its ``[.., vocab / tp]`` columns and
    one all-gather over tp assembles the full logits, so every rank
    samples the same token. Under a training mesh the logits stay
    vocab-sharded: the loss is the vocab-parallel cross-entropy
    (``train/trainer.py``)."""
    x = mesh_lib.tp_copy(x, 'vocab')
    if cfg.tie_embeddings:                    # Gemma: unembed = embed^T
        logits = matmul_f32(x, mesh_lib.tp_rows(params['embed'],
                                                'vocab').t())
    else:
        logits = qeinsum('bsd,dv->bsv', x, params['unembed'],
                         out_dtype=torch.float32)
    if mesh_lib.training() is not None:
        return logits
    return mesh_lib.gather_split(logits, 'vocab', -1)


def apply_vocab_mask(logits: torch.Tensor,
                     vocab_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Constrained-decoding vocab mask (True = allowed); None leaves the
    logits untouched."""
    if vocab_mask is None:
        return logits
    while vocab_mask.dim() < logits.dim():
        vocab_mask = vocab_mask[:, None]
    return torch.where(vocab_mask, logits,
                       torch.full((), VOCAB_MASK_NEG, dtype=logits.dtype,
                                  device=logits.device))


def filtered_logits(logits: torch.Tensor, temps: torch.Tensor,
                    topks: torch.Tensor, topps: torch.Tensor
                    ) -> torch.Tensor:
    """Temperature-scaled, top-k/top-p-masked logits over the last axis
    (kept tokens carry their scaled value, filtered ones -inf). top-k <=
    0 and top-p >= 1 disable their filters; rows with temp <= 0 are
    scaled by 1/1e-6 and take the greedy argmax at the caller."""
    temps = temps[..., None]
    topks = topks[..., None]
    topps = topps[..., None]
    scaled = logits / torch.clamp(temps, min=1e-6)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    idx = torch.clamp(topks - 1, 0, logits.shape[-1] - 1).long()
    # The rows' k-th values at every leading position (a verify round's
    # [b, k+1, vocab] logits with [b, 1] rows), as take_along_axis
    # broadcasts the index in the reference.
    kth = torch.gather(sorted_desc, -1,
                       idx.expand(sorted_desc.shape[:-1] + (1,)))
    # Constants are filled on the device (no host copy: a decode step
    # captured in a CUDA graph may not copy from the host).
    neg_inf = torch.full((), float('-inf'), device=logits.device)
    thr_k = torch.where(topks > 0, kth, neg_inf)
    masked_sorted = torch.where(sorted_desc >= thr_k, sorted_desc, neg_inf)
    probs = torch.softmax(masked_sorted.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < topps
    thr_p = torch.where(keep, masked_sorted,
                        torch.full((), float('inf'), device=logits.device)
                        ).amin(-1, keepdim=True)
    thr = torch.maximum(thr_k, torch.where(topps < 1.0, thr_p, neg_inf))
    return torch.where(scaled >= thr, scaled, neg_inf)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: [b, s, h, d], positions: [b, s]."""
    d = x.shape[-1]
    exps = -torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=x.device), exps)
    angles = positions[..., None].float() * freqs          # [b, s, d/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _bank(layer: Params, mlora_idx: Optional[torch.Tensor]):
    """The layer's multi-LoRA bank slice when rows name adapters."""
    return layer.get('mlora') if mlora_idx is not None else None


def _adapters(layer: Params, mlora_idx: Optional[torch.Tensor]):
    """The layer's trained LoRA adapters (``layer['lora']``) when no row
    names a bank adapter: the two are exclusive."""
    return layer.get('lora') if mlora_idx is None else None


def _plus_lora(y: torch.Tensor, lo: Optional[Params], target: str,
               x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``y`` plus the adapter's delta of ``target`` on input ``x``; ``y``
    itself when the target is not adapted."""
    if lo is None or target not in lo:
        return y
    return y + lora.apply(lo, target, x, cfg)


def _ffn(layer: Params, x: torch.Tensor, cfg: ModelConfig,
         mlora_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    ml = _bank(layer, mlora_idx)
    lo = _adapters(layer, mlora_idx)
    # Column-parallel under a training mesh: the gradient of x sums over
    # tp (mesh.tp_copy; identity elsewhere).
    xc = mesh_lib.tp_copy(x, 'mlp')
    with remat.weight_products():
        gate = qeinsum('bsd,df->bsf', xc, layer['w_gate'])
        up = qeinsum('bsd,df->bsf', xc, layer['w_up'])
    gate = _plus_lora(gate, lo, 'w_gate', x, cfg)
    up = _plus_lora(up, lo, 'w_up', x, cfg)
    if ml is not None:
        gate = multilora.adjusted(ml, 'w_gate', x, gate, mlora_idx)
        up = multilora.adjusted(ml, 'w_up', x, up, mlora_idx)
    act = (F.silu(gate.float()) if cfg.activation == 'silu'
           else F.gelu(gate.float(), approximate='tanh'))
    h = act.to(x.dtype) * up
    with remat.weight_products():
        down = qeinsum('bsf,fd->bsd', h, layer['w_down'], row_split='mlp')
    down = _plus_lora(down, lo, 'w_down', h, cfg)
    if ml is not None:
        down = multilora.adjusted(ml, 'w_down', h, down, mlora_idx)
    # Row-parallel under a serving mesh: the local mlp columns' partial
    # sum, reduced over tp.
    return mesh_lib.reduce_partial(down, 'mlp')


AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _attn_inputs(layer: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor,
                 mlora_idx: Optional[torch.Tensor] = None):
    """The layer up to its attention: the roped q and k, and v."""
    ml = _bank(layer, mlora_idx)
    lo = _adapters(layer, mlora_idx)
    h = rms_norm(x, layer['attn_norm'], cfg.norm_eps, cfg.norm_plus_one)
    # Column-parallel under a training mesh (mesh.tp_copy): one gradient
    # sum over tp for the q, k and v inputs when both head kinds split.
    hq = mesh_lib.tp_copy(h, 'heads')
    hkv = hq if mesh_lib.same_tp_split('heads', 'kv_heads') else \
        mesh_lib.tp_copy(h, 'kv_heads')
    with remat.weight_products():
        q = qeinsum('bsd,dhk->bshk', hq, layer['wq'])
        k = qeinsum('bsd,dhk->bshk', hkv, layer['wk'])
        v = qeinsum('bsd,dhk->bshk', hkv, layer['wv'])
    q = _plus_lora(q, lo, 'wq', h, cfg)
    k = _plus_lora(k, lo, 'wk', h, cfg)
    v = _plus_lora(v, lo, 'wv', h, cfg)
    if ml is not None:
        q = multilora.adjusted(ml, 'wq', h, q, mlora_idx)
        k = multilora.adjusted(ml, 'wk', h, k, mlora_idx)
        v = multilora.adjusted(ml, 'wv', h, v, mlora_idx)
    if cfg.qkv_bias:                          # Qwen2: biases before rope
        q = q + layer['bq'].to(q.dtype)
        k = k + layer['bk'].to(k.dtype)
        v = v + layer['bv'].to(v.dtype)
    # kv heads replicated over tp beside split q heads: each rank's
    # attention uses only its q heads, so the k and v gradients sum over
    # tp under a training mesh.
    k = mesh_lib.tp_copy_replicated_kv(rope(k, positions, cfg.rope_theta))
    v = mesh_lib.tp_copy_replicated_kv(v)
    return rope(q, positions, cfg.rope_theta), k, v


def _attn_outputs(layer: Params, x: torch.Tensor, out: torch.Tensor,
                  cfg: ModelConfig,
                  mlora_idx: Optional[torch.Tensor] = None):
    """The layer from its attention output ``out`` on: (x, aux)."""
    ml = _bank(layer, mlora_idx)
    with remat.weight_products():
        proj = qeinsum('bshk,hkd->bsd', out, layer['wo'], row_split='heads')
    proj = _plus_lora(proj, _adapters(layer, mlora_idx), 'wo', out, cfg)
    if ml is not None:
        proj = multilora.adjusted(ml, 'wo', out, proj, mlora_idx)
    # Row-parallel under a serving mesh: the local heads' partial sum,
    # reduced over tp.
    x = x + mesh_lib.reduce_partial(proj, 'heads')
    h = rms_norm(x, layer['ffn_norm'], cfg.norm_eps, cfg.norm_plus_one)
    if cfg.is_moe:
        # Under dp a decode step or a verify round holds only this
        # rank's rows, but the dispatch's capacity and slot order are
        # the whole batch's (ROADMAP R6): every row is gathered, routed
        # and computed, and this rank's rows kept. Under tp the experts'
        # local mlp columns give a partial sum, reduced as _ffn's is.
        # A training mesh gathers every rank's rows and sequence block
        # the same way (differentiable: the backward reduce-scatters).
        if mesh_lib.training() is not None:
            rows_all, (mine, seq) = mesh_lib.gather_rows(h)
            ffn_out, aux = moe.moe_ffn(layer, rows_all, cfg)
            ffn_out = ffn_out[mine, seq]
        else:
            rows_all, mine = mesh_lib.gather_dp_rows(h)
            ffn_out, aux = moe.moe_ffn(layer, rows_all, cfg)
            if mine is not None:
                ffn_out = ffn_out[mine]
        ffn_out = mesh_lib.reduce_partial(ffn_out, 'mlp')
    else:
        ffn_out, aux = _ffn(layer, h, cfg, mlora_idx), None
    return x + ffn_out, aux


def _layer_core(layer: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, attn_fn: AttnFn,
                mlora_idx: Optional[torch.Tensor] = None):
    """One transformer layer, parameterized by the attention op (maps
    roped (q, k, v) to the attention output). Returns (x, (k, v) new kv
    rows [b, s, hkv, d], aux): the FFN is ``moe.moe_ffn`` under
    ``cfg.is_moe``, whose load-balancing loss is ``aux`` (an fp32
    scalar; None for a dense FFN, which has none).

    Trained adapters (``layer['lora']``) add their delta next to each
    adapted projection (``lora.apply``). ``mlora_idx`` ([b] int32, -1 =
    none) instead gathers per-row adapters from the ``layer['mlora']``
    bank slice next to q, k, v and wo on every family and the dense
    FFN's projections; None leaves the bank untouched. The bank's delta
    applies to ``qeinsum``'s output, so it composes with int8 and int4
    weights."""
    q, k, v = _attn_inputs(layer, x, cfg, positions, mlora_idx)
    # Under tp with several replicated kv heads, this rank's q heads
    # attend through the virtual query of ``mesh.kv_head_layout``.
    out = mesh_lib.attend_local_heads(attn_fn, q, k, v)
    x, aux = _attn_outputs(layer, x, out, cfg, mlora_idx)
    return x, (k, v), aux


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------
def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            attn_impl: str = 'auto', return_aux: bool = False,
            mlora_idx: Optional[torch.Tensor] = None):
    """Full-sequence causal forward (training/eval; no cache): positions
    are [0..s), attention through ``ops.attention`` (``impl=attn_impl``:
    K4 forward and K5a/K5b backward on CUDA under 'auto'). Returns fp32
    logits [b, s, vocab], and with ``return_aux`` also the MoE
    load-balancing aux loss, the mean over layers (0 for a dense
    model). ``mlora_idx`` ([b], -1 = none) applies each row's adapter
    from the bank at ``params['layers']['mlora']``.

    Under autograd ``cfg.remat`` picks what the backward recomputes
    (``models/remat.py``): 'block' checkpoints each layer
    (``torch.utils.checkpoint``: only the layer inputs are kept, the
    backward re-runs each layer's forward once, attention included);
    'attn' checkpoints the parts before and after the attention, which
    keeps its own inputs and output, so the backward never re-runs it;
    'dots' keeps the outputs of the products with no batch dimension
    and recomputes the rest of the layer.

    Inside a training mesh's step (``parallel.mesh.training()``) the
    params are this rank's shards and ``tokens`` its rows and sequence
    block: the fsdp shards are all-gathered where used, the tp-split
    products carry their collectives, attention over a split sequence
    runs sequence-parallel (``ops.attention``), a pp mesh runs the layer
    stack as its stage of the GPipe schedule
    (``parallel/pipeline.py``, MoE's aux the mean over the live
    stage-ticks, as the reference's), and the logits returned are this
    rank's vocab shard."""
    if cfg.remat not in remat.POLICIES:
        raise ValueError(f'unknown remat policy {cfg.remat!r}; legal: '
                         f'{remat.POLICIES}')
    from skypilot_tpu_torch.parallel import pipeline as pipeline_lib
    # Under a training mesh (``mesh.training()``): params are this rank's
    # shards, all-gathered over fsdp where used (the embedding tables
    # here, each layer's leaves inside its checkpointed body, so the
    # backward gathers them again); tokens are this rank's rows and
    # sequence block, so positions start at the block's offset.
    sc = mesh_lib.training()
    gather = sc.plan.get('gather') if sc is not None else None
    params = dict(params, **mesh_lib.fsdp_gather(
        {k: params[k] for k in ('embed', 'unembed') if k in params},
        gather))
    layer_gather = (gather or {}).get('layers')
    x = _embed_tokens(params, tokens, cfg)
    b, s = tokens.shape
    offset = 0 if sc is None else sc.mesh.axis_index('sp') * s
    positions = (torch.arange(s, device=tokens.device)[None, :]
                 + offset).expand(b, s)

    def attn_fn(q, k, v):
        return attention(q, k, v, causal=True, impl=attn_impl)

    def layer_fn(layer, x, gathered=False):
        with mesh_lib.reenter(sc):
            if not gathered:
                layer = mesh_lib.fsdp_gather(layer, layer_gather)
            x, _, aux = _layer_core(layer, x, cfg, positions[:x.shape[0]],
                                    attn_fn, mlora_idx)
        return x, aux

    def attn_saving_fn(layer, x, gathered=False):
        if not gathered:
            layer = mesh_lib.fsdp_gather(layer, layer_gather)
        pos = positions[:x.shape[0]]

        def inputs(layer, x):
            with mesh_lib.reenter(sc):
                return _attn_inputs(layer, x, cfg, pos, mlora_idx)

        def outputs(layer, x, out):
            with mesh_lib.reenter(sc):
                return _attn_outputs(layer, x, out, cfg, mlora_idx)
        q, k, v = torch.utils.checkpoint.checkpoint(
            inputs, layer, x, use_reentrant=False)
        return torch.utils.checkpoint.checkpoint(
            outputs, layer, x, attn_fn(q, k, v), use_reentrant=False)

    policy = cfg.remat if torch.is_grad_enabled() else 'none'

    def run_layers(stack, x, gathered=False):
        """The layers of ``stack`` ({'layers': ...}) in order: (x, their
        aux values)."""
        auxs = []
        for layer in unbind_layers(stack):
            if policy == 'none':
                x, aux = layer_fn(layer, x, gathered)
            elif policy == 'attn':
                x, aux = attn_saving_fn(layer, x, gathered)
            else:
                kw = ({'context_fn': remat.dots_contexts}
                      if policy == 'dots' else {})
                x, aux = torch.utils.checkpoint.checkpoint(
                    layer_fn, layer, x, gathered, use_reentrant=False, **kw)
            if aux is not None:
                auxs.append(aux)
        return x, auxs

    def no_aux():
        return torch.zeros((), dtype=torch.float32, device=x.device)

    if sc is not None and sc.mesh.axis_size('pp') > 1:
        # The GPipe schedule over pp: each stage runs its layers on a
        # microbatch; its aux is their mean. The embedding's gradient
        # reaches stage 0 only, so it is summed over pp (a tied
        # unembedding's part is the same on every stage).
        x = mesh_lib.pp_copy(x)

        def stage_fn(stage_params, x_mb, gathered=False):
            y, auxs = run_layers({'layers': stage_params}, x_mb, gathered)
            return y, (torch.stack(auxs).mean() if auxs else no_aux())
        x, aux = pipeline_lib.pipeline_layers(
            params['layers'], x, stage_fn, with_aux=True,
            gather=lambda p: mesh_lib.fsdp_gather(
                p, mesh_lib.stacked_plan(layer_gather)))
    else:
        x, auxs = run_layers(params, x)
        aux = torch.stack(auxs).mean() if auxs else no_aux()
    x = rms_norm(x, params['final_norm'], cfg.norm_eps, cfg.norm_plus_one)
    logits = _unembed_logits(params, x, cfg)
    if return_aux:
        return logits, aux
    return logits


def mask_nonfinite_tokens(logits: torch.Tensor,
                          tokens: torch.Tensor) -> torch.Tensor:
    """Rows whose logits contain any NaN/Inf emit
    :data:`NONFINITE_TOKEN` instead of a sampled id."""
    finite = torch.isfinite(logits).all(-1)
    return torch.where(finite, tokens,
                       torch.full_like(tokens, NONFINITE_TOKEN))


# --------------------------------------------------------------------------
# Slot-engine prefill and decode
# --------------------------------------------------------------------------
def prefill_rows(
    params: Params,
    tokens: torch.Tensor,              # [n, bucket] padded prompts
    true_lens: Optional[torch.Tensor],  # [n] real prompt lengths (unused
                                       #     under all_logits)
    cfg: ModelConfig,
    *,
    attn_impl: str = 'auto',
    quantize_rows=False,               # False | True (int8) | 'int4':
                                       # emit codes + scales
    cache_kv=None,                     # chunked prefill: ([L, n, S, hkv,
                                       # d] k, v) or (kq, vq, ks, vs)
    cache_len: Optional[torch.Tensor] = None,   # [n] valid cache rows =
                                       # each row's chunk start offset
    w8a8: bool = False,
    all_logits: bool = False,
    mlora_idx: Optional[torch.Tensor] = None,   # [n] adapter slot per
                                       # row (-1 = base)
    dp_rows: Optional[slice] = None,   # a dp rank's block of the n rows
):
    """Prompt or chunk prefill for the slot engine. Without
    ``cache_kv``: causal attention over the padded bucket
    (``ops.attention``: K4 on CUDA). With ``cache_kv``/``cache_len``
    the bucket is a prompt CHUNK at a nonzero cache offset: positions
    start at ``cache_len`` per row and each layer attends the given
    cache rows (masked to ``cache_len``) plus the causal chunk
    (``ops.chunk_attention``: K3 on CUDA for bf16/fp32 caches).

    Returns (last_logits [n, vocab] fp32 at each row's position
    ``true_lens - 1``, rows): the per-layer KV rows stacked [L, n,
    bucket, hkv, d], ``(k, v)``, or quantized ``(kq, vq, ks, vs)``. A
    packed int4 cache chunk is read through ``cached_attention``, which
    unpacks it. ``all_logits=True`` returns every position's fp32
    logits ``[n, bucket, vocab]`` instead (the speculative verify
    round reads each of its k+1 positions). ``mlora_idx`` applies each
    row's adapter from the bank at ``params['layers']['mlora']``.
    ``w8a8`` runs the layer loop inside ``quantization.w8a8_region`` (the
    layer matmuls on int8 activations); the final norm and the
    unembedding stay W8A16.

    ``dp_rows`` (a serving mesh's dp rank's block of the rows,
    ``mesh.prefill_dp_rows``): the layers run on those rows only
    (``mesh.dp_split``), and the emitted rows and the last positions'
    hidden states are all-gathered over dp in one collective, so the
    returned rows and logits are the whole batch's (not with
    ``all_logits``)."""
    n, s = tokens.shape
    dev = tokens.device
    if dp_rows is not None and all_logits:
        raise ValueError('all_logits is not split over dp')
    rs = slice(None) if dp_rows is None else dp_rows
    x = _embed_tokens(params, tokens[rs].long(), cfg)
    m = x.shape[0]
    steps = torch.arange(s, device=dev)[None, :]
    positions = (steps.expand(m, s) if cache_len is None
                 else cache_len[rs].long()[:, None] + steps)
    if cache_kv is not None:
        ck_all, cv_all = cache_kv[0], cache_kv[1]
        ks_all, vs_all = (cache_kv[2], cache_kv[3]) if len(cache_kv) == 4 \
            else (None, None)
    emitted = []
    with quantization.w8a8_region(w8a8), mesh_lib.dp_split(dp_rows):
        for li in range(cfg.n_layers):
            if cache_kv is None:
                def attn_fn(q, k, v):
                    return attention(q, k, v, causal=True, impl=attn_impl)
            else:
                def attn_fn(q, k, v, li=li):
                    return chunk_attention(
                        q, k, v, ck_all[li][rs], cv_all[li][rs],
                        cache_len[rs], impl=attn_impl,
                        k_scale=None if ks_all is None else ks_all[li][rs],
                        v_scale=None if vs_all is None else vs_all[li][rs])
            x, (k, v), _ = _layer_core(
                layer_params(params, li), x, cfg, positions, attn_fn,
                None if mlora_idx is None else mlora_idx[rs])
            emitted.append(_quantize_rows(k, v, quantize_rows))
    rows = tuple(torch.stack(parts) for parts in zip(*emitted))
    x = rms_norm(x, params['final_norm'], cfg.norm_eps, cfg.norm_plus_one)
    if all_logits:
        return _unembed_logits(params, x, cfg), rows
    last_x = x[torch.arange(m, device=dev),
               true_lens[rs].long() - 1][:, None]
    if dp_rows is not None:
        *rows, last_x = mesh_lib.gather_dp_blocks(
            rows + (last_x,), (1,) * len(rows) + (0,))
        rows = tuple(rows)
    return _unembed_logits(params, last_x, cfg)[:, 0], rows


def decode_step(
    params: Params,
    cache: KVCache,
    tok: torch.Tensor,                 # [b] int32 current token (updated)
    step: torch.Tensor,                # int32 0-d device step index (updated)
    ring_k: torch.Tensor,              # [L, b, H, hkv, d] (updated)
    ring_v: torch.Tensor,
    out: torch.Tensor,                 # [b, H] int32 tokens (updated)
    cfg: ModelConfig,
    *,
    sample_fn=None,                    # logits [b, vocab] -> [b] int32
    kv_bucket: Optional[int] = None,   # attention reads only the first
                                       # kv_bucket rows; the caller
                                       # guarantees max(length) + H
                                       # <= kv_bucket
    vocab_mask: Optional[torch.Tensor] = None,   # [b, vocab] bool
    mlora_idx: Optional[torch.Tensor] = None,    # [b] adapter slot per
                                       # row (-1 = base)
) -> None:
    """ONE fused decode step over the slot cache at the device step
    index ``step``, in place. The main cache is read-only (masked by its
    lengths, which stay at the call-start values until the merge); the
    call's earlier rows live in the ring (rows < ``step``, model dtype),
    folded in by ``ring_decode_attention``. Writes this step's k/v rows
    into ring row ``step``, the next token into ``out[:, step]`` and
    ``tok``, and adds one to ``step``: every value it depends on is in
    device memory, so a CUDA graph captured of it replays any step."""
    n_layers = cfg.n_layers
    len0 = cache.length
    S = cache.k.shape[2]
    # The reference slices only when the slice at least halves the read.
    cut = kv_bucket if kv_bucket is not None and kv_bucket <= S // 2 else S
    positions = len0.long()[:, None] + step
    at = step.view(1).long()
    # A sentinel token (-1) wraps to the last embedding row, as the
    # reference's gather does; its slot is evicted at readback.
    x = _embed_tokens(params, torch.remainder(
        tok.long(), cfg.vocab_size)[:, None], cfg)
    for li in range(n_layers):
        ck, cv = cache.k[li][:, :cut], cache.v[li][:, :cut]
        sk = cache.k_scale[li][:, :cut] if cache.quantized else None
        sv = cache.v_scale[li][:, :cut] if cache.quantized else None

        def attn_fn(q, k, v, ck=ck, cv=cv, sk=sk, sv=sv, li=li):
            return ring_decode_attention(q, k, v, ck, cv, len0,
                                         ring_k[li], ring_v[li], step,
                                         k_scale=sk, v_scale=sv)

        x, (k_rows, v_rows), _ = _layer_core(
            layer_params(params, li), x, cfg, positions, attn_fn,
            mlora_idx)
        ring_k[li].index_copy_(1, at, k_rows)
        ring_v[li].index_copy_(1, at, v_rows)
    x = rms_norm(x, params['final_norm'], cfg.norm_eps, cfg.norm_plus_one)
    logits = apply_vocab_mask(_unembed_logits(params, x, cfg)[:, 0],
                              vocab_mask)
    if sample_fn is None:
        nxt = torch.argmax(logits, -1).to(torch.int32)
    else:
        nxt = sample_fn(logits)
    nxt = mask_nonfinite_tokens(logits, nxt)
    out.index_copy_(1, at, nxt[:, None])
    tok.copy_(nxt)
    step.add_(1)


def decode_horizon(
    params: Params,
    cache: KVCache,
    tokens: torch.Tensor,              # [b] current token per slot
    cfg: ModelConfig,
    *,
    horizon: int,
    sample_fn=None,                    # logits [b, vocab] -> [b] int32
    kv_bucket: Optional[int] = None,   # attention reads only the first
                                       # kv_bucket rows; the caller
                                       # guarantees max(length) + horizon
                                       # <= kv_bucket
    vocab_mask: Optional[torch.Tensor] = None,   # [b, vocab] bool
    mlora_idx: Optional[torch.Tensor] = None,    # [b] adapter slots
):
    """``horizon`` fused decode steps over the slot cache, eagerly: the
    one-step body :func:`decode_step` ``horizon`` times over fresh
    buffers (the slot engine replays its CUDA graph instead), then the
    ring merges into the cache once (``merge_rows_into_cache``,
    quantized for an int8 or int4 cache). Returns (tokens [b, horizon],
    cache with length = length + horizon); callers with inactive slots
    correct the lengths afterwards."""
    b = tokens.shape[0]
    dev = tokens.device
    ring_k = torch.zeros((cfg.n_layers, b, horizon, cfg.n_kv_heads,
                          cfg.head_dim), dtype=cfg.dtype, device=dev)
    ring_v = torch.zeros_like(ring_k)
    out = torch.zeros((b, horizon), dtype=torch.int32, device=dev)
    tok = tokens.to(torch.int32).clone()
    step = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(horizon):
        decode_step(params, cache, tok, step, ring_k, ring_v, out, cfg,
                    sample_fn=sample_fn, kv_bucket=kv_bucket,
                    vocab_mask=vocab_mask, mlora_idx=mlora_idx)
    len0 = cache.length
    cache = merge_rows_into_cache(cache, ring_k, ring_v, len0,
                                  len0 + horizon)
    return out, cache
