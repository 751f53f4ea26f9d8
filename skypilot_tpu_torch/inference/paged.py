"""Paged KV cache with prefix caching and chunked prefill (port of
``skypilot_tpu/inference/paged.py``, one device).

- **Page pool**: one ``[L, n_pages, hkv, page, d]`` tensor pair shared by
  all slots, HEAD-MAJOR so the decode kernels read each (page, kv head)
  as one contiguous ``[page, d]`` run. A slot holds a host-side list of
  page ids; page 0 is the reserved trash page for masked writes and the
  allocator never hands it out.
- **KV dtype** (``kv_cache_dtype``, its own knob; ``auto`` follows the
  weight quantize mode): the model dtype, int8 codes, or int4 codes
  packed two per byte along head_dim (``[..., d // 2]`` uint8). Quantized
  pools carry per-row fp32 scales ``[L, n_pages, hkv, page]``, head-major
  like the pool; rows are quantized on the way in (prefill rows, the
  decode ring at merge time) and every capacity decision costs tokens at
  the quantized byte width.
- **Prefix caching**: full pages are content-addressed by the chain hash
  of the token prefix they complete; freed registered pages retire into
  an LRU that allocation evicts last.
- **Chunked prefill**: prompts prefill in fixed ``prefill_chunk_tokens``
  slices against the pages written so far; ``prefill_w8a8`` runs their
  layer matmuls (and the speculative verify rounds') on int8 activations
  (``quantization.w8a8_region``).
- **Fused decode horizons**: a decode call runs ``horizon`` steps of
  ``paged_decode_step``, each layer attending over the slot's pages plus
  a ring of this call's rows (model dtype): the K1 CUDA kernel and a
  plain torch merge (``decode_impl='pallas'``), the K2 CUDA kernel that
  folds the ring in itself (``'cross_layer'``), or a page gather in
  plain torch (``'gather'``). The ring merges into the pool once per
  call (``merge_ring_into_pool``). The step is a function of device
  state only (its step index is an int32 on the device), so the engine
  captures it once per (horizon, sample, P) as a CUDA graph and replays
  it, one replay a step (``inference/graphs.py``);
  ``paged_decode_horizon`` is the same loop run eagerly.
- **Multi-step decode**: ``decode_steps_per_call=k`` pins every call at
  exactly k steps; ``decode_priority_ratio`` splits the interleave
  between prefill chunks and decode by a token budget.
- **Speculative decoding** (``speculate_k=k``): each step is one
  propose -> verify -> commit round (``paged_spec_verify``, a CUDA graph
  per (k, sample, P)), or with ``decode_steps_per_call`` that many
  rounds fused into one graph (``inference/speculative.py``).
- **Multi-tenant serving** (``adapter_slots > 0``, grammar masks): every
  device function here takes ``mlora_idx`` (each row's bank slot, -1 =
  base) and ``vocab_mask`` (each row's grammar mask, applied to the
  logits before the draw or the speculative acceptance), as the
  reference's do; the engine's decode and verify graphs read both from
  the static decode buffers.
- **KV handoff and the prefix checkpoint**: a slot's pages read back
  token-major in the stored dtype (``_gather_kv_rows``), snapshot rows
  scattered into fresh pages through ``merge_rows_into_pool``
  (``_scatter_snapshot_rows``: an ingest, or ``warm_prefix``, which
  registers the chain and leaves it in the prefix LRU). A host-side heat
  tracker of prefix chains feeds the checkpoint export
  (``export_prefix_snapshots``) and the routing digest
  (``hot_prefix_digest``). Every gather and scatter is plain torch
  indexing on the device, as the reference does them in XLA.
- **Serving mesh** (``mesh=``, ``parallel/mesh.py``): each rank's pool is
  its own contiguous ``[L, n_pages, hkv / tp, page, d]`` tensor (the kv
  heads split over tp, replicated when they do not divide; the pages
  replicated), sized per shard; the decode kernels read it as they read
  a whole pool. Each tp rank scatters its own heads' rows with no
  cross-rank traffic; under dp each rank decodes its block of slots and
  the merge first all-gathers the ring rows over dp, so the dp replicas
  of the pool stay byte-identical (the reference's
  ``_merge_rows_sharded``). A handoff gathers the tp ranks' heads into
  one SKKV blob of the meshless layout, and an ingest lands each rank's
  slice of it. CUDA ``auto`` keeps K1 under a mesh (it reads the local
  heads); the reference's TPU ``auto`` falls back to ``gather`` there.
  A verify round under dp runs its rank's block of slots and gathers
  the new rows and the commits before the masked merge.

Unlike JAX arrays, the pool is updated IN PLACE: ``merge_rows_into_pool``
scatters into the cache's tensors and returns the same cache. Every
write happens after the reads of the same call (prefill writes a layer's
rows only after that layer's attention; decode merges the ring after the
horizon), so the in-place update computes what the reference's
functional update does.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.inference import speculative
from skypilot_tpu_torch.inference import kv_transfer
from skypilot_tpu_torch.inference.engine import (Request, _EngineBase,
                                                 _bucket_len, _from_pretrained,
                                                 _ring_horizon_cap,
                                                 _ring_row_bytes,
                                                 kv_shard_degree,
                                                 kv_token_bytes,
                                                 prepare_params,
                                                 resolve_kv_cache_dtype,
                                                 serving_config,
                                                 rows_to_device, rows_to_host,
                                                 sample_tokens)
from skypilot_tpu_torch.models import llama, quantization
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.ops import paged_attention
from skypilot_tpu_torch.ops.attention import (cached_attention,
                                              ring_decode_attention)
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.telemetry import clock
from skypilot_tpu_torch.utils.device import (DeviceLike, device_upload,
                                             host_sync, resolve_device)

Params = Dict[str, Any]


class PagedKVCache:
    """Device state: the k and v page pools (and, quantized, their row
    scales). Per-slot lengths are HOST state, passed to each call."""

    def __init__(self, pool_k: torch.Tensor, pool_v: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None):
        self.pool_k = pool_k         # [L, n_pages, hkv, page, d (or d/2)]
        self.pool_v = pool_v
        self.k_scale = k_scale       # [L, n_pages, hkv, page] fp32 or None
        self.v_scale = v_scale

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def packed(self) -> bool:
        """int4 pools: two nibble codes per byte along head_dim."""
        return self.pool_k.dtype == torch.uint8

    @property
    def quant_mode(self):
        """False | True (int8) | 'int4': what the row quantizer keys
        on (``_maybe_quantize_rows``)."""
        if self.packed:
            return 'int4'
        return self.quantized

    def tensors(self):
        """The stored tensors, scales included when quantized."""
        if self.quantized:
            return self.pool_k, self.pool_v, self.k_scale, self.v_scale
        return self.pool_k, self.pool_v

    @property
    def page_size(self) -> int:
        return self.pool_k.shape[3]

    @property
    def n_pages(self) -> int:
        return self.pool_k.shape[1]

    @classmethod
    def create(cls, cfg: ModelConfig, *, n_pages: int, page_size: int = 128,
               kv_dtype: str = 'bf16',
               device: DeviceLike = 'cuda') -> 'PagedKVCache':
        """Zero pools of ``kv_dtype`` ('bf16' = the model dtype,
        'int8', 'int4'); quantized pools get zero fp32 scales."""
        dev = resolve_device(device)
        shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size,
                 cfg.head_dim)
        if kv_dtype == 'bf16':
            return cls(pool_k=torch.zeros(shape, dtype=cfg.dtype,
                                          device=dev),
                       pool_v=torch.zeros(shape, dtype=cfg.dtype,
                                          device=dev))
        if kv_dtype == 'int4':
            if cfg.head_dim % 2:
                raise ValueError('int4 KV needs an even head_dim')
            pshape, pdtype = shape[:-1] + (cfg.head_dim // 2,), torch.uint8
        elif kv_dtype == 'int8':
            pshape, pdtype = shape, torch.int8
        else:
            raise ValueError(f'unknown kv_dtype {kv_dtype!r}')
        return cls(pool_k=torch.zeros(pshape, dtype=pdtype, device=dev),
                   pool_v=torch.zeros(pshape, dtype=pdtype, device=dev),
                   k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev),
                   v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev))


# ---------------------------------------------------------------------------
# Device functions
# ---------------------------------------------------------------------------
def _flat_write_indices(table: torch.Tensor, starts: torch.Tensor, n: int,
                        valid_len: torch.Tensor, page: int) -> torch.Tensor:
    """Flat pool row index for each of ``n`` tokens appended per slot:
    token j of slot b lands at table[b, (starts_b+j)//page]*page +
    (starts_b+j)%page. Tokens past ``valid_len_b`` are redirected to the
    trash rows of page 0. Returns [slots, n] int64."""
    j = torch.arange(n, device=table.device)[None, :]
    pos = starts.long()[:, None] + j
    page_idx = torch.clamp(pos // page, max=table.shape[1] - 1)
    page_id = torch.gather(table.long(), 1, page_idx)
    flat = page_id * page + pos % page
    return torch.where(j < valid_len.long()[:, None], flat, j % page)


def _scatter_rows(pool: torch.Tensor, rows: torch.Tensor,
                  flat_idx: torch.Tensor) -> None:
    """pool [L, n_pages, hkv, page] (+ a trailing [d] for codes/values;
    none for scales) <- rows [L, slots, n, hkv] (+ the same tail; scales
    arrive as [..., 1]) at flat_idx [slots, n] logical token indices
    (page_id * page + pos), in place. Head-major pages interleave heads
    between a page's token rows, so each (layer, token, head) triple
    scatters to its own row: layer * n_pages*hkv*page + (tok // page) *
    hkv*page + head * page + tok % page."""
    L, n_pages, hkv, page = pool.shape[:4]
    tail = tuple(pool.shape[4:])
    rows_per_layer = n_pages * hkv * page
    f = flat_idx.reshape(-1)                                # [slots*n]
    heads = torch.arange(hkv, device=pool.device)
    tok = ((f[:, None] // page) * (hkv * page) + heads[None, :] * page
           + f[:, None] % page)                             # [slots*n, hkv]
    idx = (torch.arange(L, device=pool.device)[:, None, None]
           * rows_per_layer + tok[None]).reshape(-1)
    pool.view((L * rows_per_layer,) + tail)[idx] = rows.reshape(
        (-1,) + tail).to(pool.dtype)


def _scatter_all(cache: PagedKVCache, layers: slice, k_rows, v_rows,
                 flat_idx: torch.Tensor) -> None:
    """Scatter [l, slots, n, hkv, d] rows into pool layers ``layers``;
    quantized pools take ``(codes, scales)`` pairs."""
    if cache.quantized:
        (kq, ks), (vq, vs) = k_rows, v_rows
        pairs = ((cache.pool_k, kq), (cache.pool_v, vq),
                 (cache.k_scale, ks), (cache.v_scale, vs))
    else:
        pairs = ((cache.pool_k, k_rows), (cache.pool_v, v_rows))
    for pool, rows in pairs:
        _scatter_rows(pool[layers], rows, flat_idx)


def merge_rows_into_pool(cache: PagedKVCache, k_rows, v_rows,
                         table: torch.Tensor, starts: torch.Tensor,
                         valid_len: torch.Tensor) -> PagedKVCache:
    """Scatter [L, slots, n, hkv, d] new rows into the pool through the
    page table (in place; returns ``cache``). Quantized pools take the
    rows PRE-quantized as ``(codes, scales)`` pairs. Rows past
    ``valid_len`` land in the trash page."""
    n = (k_rows[0] if cache.quantized else k_rows).shape[2]
    flat_idx = _flat_write_indices(table, starts, n, valid_len,
                                   cache.page_size)
    _scatter_all(cache, slice(None), k_rows, v_rows, flat_idx)
    return cache


def _maybe_quantize_rows(new_kv, quant_mode):
    """(k_rows, v_rows) -> ((kq, ks), (vq, vs)) when the pool is
    quantized (``quant_mode``: False | True/int8 | 'int4', the cache's
    ``quant_mode``); identity otherwise."""
    if not quant_mode:
        return new_kv
    quant = (llama.quantize_kv_rows4 if quant_mode == 'int4'
             else llama.quantize_kv_rows)
    k_rows, v_rows = new_kv
    return quant(k_rows), quant(v_rows)


def _gather_layer(cache: PagedKVCache, li: int, table_p: torch.Tensor):
    """Pool layer ``li`` as contiguous token-major copies of each slot's
    first P pages: (k, v [slots, P*page, hkv, d], k_scale, v_scale
    [slots, P*page, hkv, 1] or None). The plain path; the kernels read
    the head-major pool directly. Quantized pools stay codes."""
    idx = table_p.long()

    def rows(pool):                               # [slots, P, hkv, page, ..]
        g = pool[li][idx]
        slots, P, hkv, page = g.shape[:4]
        return g.transpose(2, 3).reshape((slots, P * page, hkv)
                                         + tuple(g.shape[4:]))
    if not cache.quantized:
        return rows(cache.pool_k), rows(cache.pool_v), None, None
    return (rows(cache.pool_k), rows(cache.pool_v),
            rows(cache.k_scale)[..., None], rows(cache.v_scale)[..., None])


DECODE_IMPLS = ('gather', 'pallas', 'cross_layer')


def auto_decode_impl(cfg: ModelConfig, device_type: str) -> str:
    """What ``decode_impl='auto'`` resolves to on a device of this type:
    the K1 kernel on CUDA for every KV dtype where it takes the
    geometry, else ``'gather'``. The reference keeps int4 pools on
    'gather' under auto because its packed page blocks fall below the
    TPU's 128-lane tile; the CUDA kernel reads packed rows with 4-byte
    loads and has no such limit."""
    return ('pallas' if device_type == 'cuda'
            and paged_attention.kernel_supports(cfg.head_dim, cfg.n_heads,
                                                cfg.n_kv_heads)
            else 'gather')


def paged_decode_step(
    params: Params,
    cache: PagedKVCache,
    table_p: torch.Tensor,             # [slots, P] int32 first-P page ids
    lengths: torch.Tensor,             # [slots] int32 pool length at call start
    tok: torch.Tensor,                 # [slots] int32 current token (updated)
    step: torch.Tensor,                # int32 0-d device step index (updated)
    ring_k: torch.Tensor,              # [L, slots, H, hkv, d] (updated)
    ring_v: torch.Tensor,
    out: torch.Tensor,                 # [slots, H] int32 tokens (updated)
    cfg: ModelConfig,
    *,
    sample_fn=None,
    decode_impl: str = 'gather',       # 'gather' | 'pallas' | 'cross_layer'
    mlora_idx: Optional[torch.Tensor] = None,   # [slots] adapter slot
                                       #   per slot (-1 = base)
    vocab_mask: Optional[torch.Tensor] = None,  # [slots, vocab] bool
) -> None:
    """ONE fused decode step at the device step index ``step``, in place.

    Each layer attends over the slot's pool pages through the K1 CUDA
    kernel plus the plain ring merge (``'pallas'``: the name of the
    reference's kernel back-end), the K2 CUDA kernel that folds the ring
    and the current token in itself (``'cross_layer'``), or a per-layer
    page gather (``'gather'``). The pool length stays ``lengths`` (the
    length at call start) for every step of a call: the call's earlier
    rows live only in the ring (rows < ``step``, model dtype). The step
    writes its k/v rows into ring row ``step`` and its next token into
    ``out[:, step]`` and ``tok``, then adds one to ``step``.

    Every value it depends on is in device memory (the step index
    drives the positions, the ring write, the ring masks and K2's ring
    length), and it writes only its arguments: a CUDA graph captured of
    it replays any step of any call over the same buffers. READ-ONLY on
    the cache."""
    n_layers = cfg.n_layers
    len0 = lengths
    pool_k, pool_v = cache.pool_k, cache.pool_v
    ks_pool, vs_pool = cache.k_scale, cache.v_scale
    positions = len0.long()[:, None] + step
    at = step.view(1).long()
    # A sentinel token (-1) wraps to the last embedding row, as the
    # reference's gather does; its slot is evicted at readback.
    x = llama._embed_tokens(params, torch.remainder(
        tok.long(), cfg.vocab_size)[:, None], cfg)
    for li in range(n_layers):
        rk, rv = ring_k[li], ring_v[li]
        if decode_impl == 'pallas':
            def attn_fn(q, k, v, li=li, rk=rk, rv=rv):
                partial = paged_attention.paged_decode_attention(
                    q[:, 0], pool_k, pool_v, table_p, len0, ks_pool,
                    vs_pool, layer=li)
                return paged_attention.merge_partial_with_ring_self(
                    partial, q, k, v, rk, rv, step)
        elif decode_impl == 'cross_layer':
            def attn_fn(q, k, v, li=li, rk=rk, rv=rv):
                return paged_attention.paged_decode_attention_fused(
                    q[:, 0], k[:, 0], v[:, 0], rk, rv, step, pool_k,
                    pool_v, table_p, len0, ks_pool, vs_pool,
                    layer=li)[:, None]
        else:
            ck, cv, sck, scv = _gather_layer(cache, li, table_p)

            def attn_fn(q, k, v, ck=ck, cv=cv, sck=sck, scv=scv, rk=rk,
                        rv=rv):
                return ring_decode_attention(q, k, v, ck, cv, len0, rk, rv,
                                             step, k_scale=sck,
                                             v_scale=scv)

        x, (k_rows, v_rows), _ = llama._layer_core(
            llama.layer_params(params, li), x, cfg, positions, attn_fn,
            mlora_idx)
        rk.index_copy_(1, at, k_rows)
        rv.index_copy_(1, at, v_rows)
    x = llama.rms_norm(x, params['final_norm'], cfg.norm_eps,
                       cfg.norm_plus_one)
    logits = llama.apply_vocab_mask(
        llama._unembed_logits(params, x, cfg)[:, 0], vocab_mask)
    if sample_fn is None:
        nxt = torch.argmax(logits, -1).to(torch.int32)
    else:
        nxt = sample_fn(logits)
    nxt = llama.mask_nonfinite_tokens(logits, nxt)
    out.index_copy_(1, at, nxt[:, None])
    tok.copy_(nxt)
    step.add_(1)


def paged_decode_horizon(
    params: Params,
    cache: PagedKVCache,
    table_p: torch.Tensor,             # [slots, P] int32 first-P page ids
    tokens: torch.Tensor,              # [slots] int32
    lengths: torch.Tensor,             # [slots] int32 live tokens
    cfg: ModelConfig,
    *,
    horizon: int,
    sample_fn=None,
    decode_impl: str = 'gather',       # 'gather' | 'pallas' | 'cross_layer'
    mlora_idx: Optional[torch.Tensor] = None,   # [slots] adapter slots
    vocab_mask: Optional[torch.Tensor] = None,  # [slots, vocab] bool
):
    """``horizon`` fused decode steps over the paged pool, eagerly: the
    one-step body :func:`paged_decode_step` ``horizon`` times over fresh
    buffers (the engines replay its CUDA graph instead). table_p must
    cover lengths + horizon.

    READ-ONLY on the cache: returns (tokens [slots, horizon], ring_k,
    ring_v [L, slots, horizon, hkv, d]); the caller merges the ring into
    the pool with ``merge_ring_into_pool``."""
    if decode_impl not in DECODE_IMPLS:
        raise NotImplementedError(
            f'decode_impl {decode_impl!r} is not ported; use one of '
            f'{DECODE_IMPLS}')
    b = tokens.shape[0]
    dev = tokens.device
    ring_k = torch.zeros((cfg.n_layers, b, horizon, cfg.n_kv_heads,
                          cfg.head_dim), dtype=cfg.dtype, device=dev)
    ring_v = torch.zeros_like(ring_k)
    out = torch.zeros((b, horizon), dtype=torch.int32, device=dev)
    tok = tokens.to(torch.int32).clone()
    step = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(horizon):
        paged_decode_step(params, cache, table_p, lengths, tok, step,
                          ring_k, ring_v, out, cfg, sample_fn=sample_fn,
                          decode_impl=decode_impl, mlora_idx=mlora_idx,
                          vocab_mask=vocab_mask)
    return out, ring_k, ring_v


def merge_ring_into_pool(cache: PagedKVCache, ring_k, ring_v,
                         table_p: torch.Tensor, lengths: torch.Tensor,
                         active: Optional[torch.Tensor]) -> PagedKVCache:
    """Scatter a decode horizon's ring rows into the pool (inactive
    slots' rows go to the trash page), quantizing them on the way in
    when the pool is quantized."""
    horizon = ring_k.shape[2]
    act = (active.to(torch.int64) if active is not None
           else torch.ones_like(lengths, dtype=torch.int64))
    rk, rv = _maybe_quantize_rows((ring_k, ring_v), cache.quant_mode)
    return merge_rows_into_pool(cache, rk, rv, table_p, lengths,
                                valid_len=act * horizon)


def paged_prefill_chunk(
    params: Params,
    cache: PagedKVCache,
    table_p: torch.Tensor,             # [n, P] pages covering ctx+chunk
    tokens: torch.Tensor,              # [n, chunk] (padded)
    lengths: torch.Tensor,             # [n] context already in the pool
    valid: torch.Tensor,               # [n] tokens of this chunk in use
    want_idx: torch.Tensor,            # [n] in-chunk index of the row whose
                                       #     next token the caller needs
                                       #     (-1: none)
    cfg: ModelConfig,
    temps: Optional[torch.Tensor] = None,   # [n] per-row sampling params
    topks: Optional[torch.Tensor] = None,
    topps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    mlora_idx: Optional[torch.Tensor] = None,   # [n] adapter slot per row
    vocab_mask: Optional[torch.Tensor] = None,  # [n, vocab] bool mask for
                                       #   the completing rows' draw
    w8a8: bool = False,
    dp_rows: Optional[slice] = None,   # a dp rank's block of the n rows
):
    """One fixed-size prefill chunk for ``n`` slots: attends against the
    pages written so far (each slot's ``lengths``) plus causal
    self-attention within the chunk, writes the new rows into the pool,
    and samples each completing row's next token on the device
    (``temps=None``: every row greedy, the argmax path with no sort).

    Returns (first_tokens [n] int32, cache). Each layer's rows are
    written right after that layer's attention; later layers never read
    an earlier layer's pool, so this equals the reference's merge after
    the layer scan without its [L, n, chunk] transient. ``w8a8`` runs
    the layer loop inside ``quantization.w8a8_region`` (int8 activations
    in the layer matmuls); the unembedding stays W8A16.

    ``dp_rows`` (a serving mesh's dp rank's block of the batch rows,
    ``mesh.prefill_dp_rows``): the layers run on those rows only
    (``mesh.dp_split``, so an MoE layer still routes the whole batch),
    and every layer's landed rows and the rows' last hidden states are
    all-gathered over dp in one collective after the layer loop; every
    dp replica of the pool then writes every row, and the logits and
    the draw are the whole batch's, as without dp."""
    n, chunk = tokens.shape
    len0 = lengths
    rs = slice(None) if dp_rows is None else dp_rows
    x = llama._embed_tokens(params, tokens[rs].long(), cfg)
    positions = len0[rs].long()[:, None] + torch.arange(
        chunk, device=tokens.device)[None, :]
    flat_idx = _flat_write_indices(table_p, len0, chunk, valid,
                                   cache.page_size)
    k_parts, v_parts = [], []
    with quantization.w8a8_region(w8a8), mesh_lib.dp_split(dp_rows):
        for li in range(cfg.n_layers):
            ck, cv, sck, scv = _gather_layer(cache, li, table_p[rs])

            def attn_fn(q, k, v, ck=ck, cv=cv, sck=sck, scv=scv):
                return cached_attention(q, k, v, ck, cv, len0[rs],
                                        k_scale=sck, v_scale=scv)

            x, (k_rows, v_rows), _ = llama._layer_core(
                llama.layer_params(params, li), x, cfg, positions, attn_fn,
                None if mlora_idx is None else mlora_idx[rs])
            if dp_rows is not None:
                k_parts.append(k_rows)
                v_parts.append(v_rows)
                continue
            k_rows, v_rows = _maybe_quantize_rows(
                (k_rows[None], v_rows[None]), cache.quant_mode)
            _scatter_all(cache, slice(li, li + 1), k_rows, v_rows,
                         flat_idx)
    x = llama.rms_norm(x, params['final_norm'], cfg.norm_eps,
                       cfg.norm_plus_one)
    idx = torch.clamp(want_idx[rs].long(), 0, chunk - 1)
    last_x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    if dp_rows is not None:
        k_rows, v_rows, last_x = mesh_lib.gather_dp_blocks(
            (torch.stack(k_parts), torch.stack(v_parts), last_x), (1, 1, 0))
        k_rows, v_rows = _maybe_quantize_rows((k_rows, v_rows),
                                              cache.quant_mode)
        _scatter_all(cache, slice(0, cfg.n_layers), k_rows, v_rows,
                     flat_idx)
    logits = llama.apply_vocab_mask(
        llama._unembed_logits(params, last_x, cfg)[:, 0], vocab_mask)
    if temps is None:
        first = torch.argmax(logits, -1).to(torch.int32)
    else:
        first = sample_tokens(logits, generator, temps, topks, topps)
    return llama.mask_nonfinite_tokens(logits, first), cache


def paged_spec_verify(
    params: Params,
    cache: PagedKVCache,
    table_p: torch.Tensor,             # [n, P] pages covering len+k+1
    tokens: torch.Tensor,              # [n] int32 current token t0 (updated)
    proposals: torch.Tensor,           # [n, k] int32 drafted continuations
    n_prop: torch.Tensor,              # [n] int32 valid drafts per slot
    lengths: torch.Tensor,             # [n] int32 context in the pool
    active: torch.Tensor,              # [n] bool decodable mask
    cfg: ModelConfig,
    *,
    sample: bool,
    temps: Optional[torch.Tensor] = None,   # [n] sampling rows
    topks: Optional[torch.Tensor] = None,
    topps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    mlora_idx: Optional[torch.Tensor] = None,   # [n] adapter slot per row
    vocab_mask: Optional[torch.Tensor] = None,  # [n, vocab] bool mask
    w8a8: bool = False,
    dp_rows: Optional[slice] = None,   # a dp rank's block of the n rows
):
    """One speculative verify round over the paged pool, in place: a
    forward over the ``k+1`` positions ``[t0, d1..dk]`` per slot against
    the pages written so far (``paged_prefill_chunk``'s attention: a page
    gather and ``cached_attention``, in plain torch as the reference
    computes it in XLA) with every position's logits kept, device-side
    acceptance (``speculative.verify_tokens``), and a MASKED merge of
    the accepted rows: ``merge_rows_into_pool``'s ``valid_len`` sends
    the rows past each slot's ``n_commit`` to the trash page, so
    acceptance never changes a shape. ``tokens`` becomes each slot's
    last committed token (unchanged for inactive slots).

    Every layer's rows are kept until the logits decide ``n_commit``, so
    the pool is written after every read of the round. No host sync:
    a CUDA graph captured of the round replays any round over the same
    buffers. Returns ``(commit [n, k+1], n_commit [n])`` int32.
    ``w8a8`` runs the layer loop inside ``quantization.w8a8_region``; a
    graph captured of the round keeps that path.

    ``dp_rows`` (a serving mesh's dp rank's block of slots): the forward
    and the acceptance run on those rows only (``mesh.dp_split``), and
    the new KV rows and the commits are all-gathered over dp before the
    merge, so every dp replica of the pool writes every row, as the
    decode merge does."""
    n, k = proposals.shape
    dev = tokens.device
    len0 = lengths
    rs = slice(None) if dp_rows is None else dp_rows

    def mine(t):
        return None if t is None else t[rs]

    # A sentinel token (-1) of an inactive slot wraps to the last
    # embedding row, as the reference's gather does.
    seq = torch.remainder(torch.cat([tokens[rs, None], proposals[rs]],
                                    1).long(), cfg.vocab_size)
    x = llama._embed_tokens(params, seq, cfg)
    positions = len0[rs].long()[:, None] + torch.arange(k + 1,
                                                        device=dev)[None]
    k_parts, v_parts = [], []
    with quantization.w8a8_region(w8a8), mesh_lib.dp_split(dp_rows):
        for li in range(cfg.n_layers):
            ck, cv, sck, scv = _gather_layer(cache, li, table_p[rs])

            def attn_fn(q, kk, vv, ck=ck, cv=cv, sck=sck, scv=scv):
                return cached_attention(q, kk, vv, ck, cv, len0[rs],
                                        k_scale=sck, v_scale=scv)

            x, (k_rows, v_rows), _ = llama._layer_core(
                llama.layer_params(params, li), x, cfg, positions, attn_fn,
                mine(mlora_idx))
            k_parts.append(k_rows)
            v_parts.append(v_rows)
    x = llama.rms_norm(x, params['final_norm'], cfg.norm_eps,
                       cfg.norm_plus_one)
    logits = llama._unembed_logits(params, x, cfg)            # [n, k+1, v]
    # The grammar masks constrain verification: the [n, vocab] mask
    # broadcasts over the k+1 positions, so a proposal outside the
    # grammar is rejected like any other mismatching draft.
    logits = llama.apply_vocab_mask(logits, mine(vocab_mask))
    commit, n_commit = speculative.verify_tokens(
        logits, proposals[rs], n_prop[rs], generator, mine(temps),
        mine(topks), mine(topps), sample=sample, rows=dp_rows, n_rows=n)
    k_rows, v_rows = torch.stack(k_parts), torch.stack(v_parts)
    if dp_rows is not None:
        k_rows = mesh_lib.all_gather(k_rows, 'dp', 1)
        v_rows = mesh_lib.all_gather(v_rows, 'dp', 1)
        both = mesh_lib.all_gather(
            torch.cat([commit, n_commit[:, None]], 1), 'dp', 0)
        commit, n_commit = both[:, :-1], both[:, -1]
    n_commit = n_commit.masked_fill(~active, 0)
    k_rows, v_rows = _maybe_quantize_rows((k_rows, v_rows), cache.quant_mode)
    merge_rows_into_pool(cache, k_rows, v_rows, table_p, len0,
                         valid_len=n_commit)
    nxt = torch.gather(commit, 1,
                       torch.clamp(n_commit.long() - 1, min=0)[:, None])[:, 0]
    tokens.copy_(torch.where(active, nxt, tokens))
    return commit, n_commit


# ---------------------------------------------------------------------------
# Host-side allocator + prefix index
# ---------------------------------------------------------------------------
class PageAllocator:
    """Free-list + refcount + content-addressed prefix index.

    Pages: 1..n_pages-1 allocatable (0 reserved). A *registered* page
    completes a full token prefix and carries its hash; when its
    refcount hits 0 it retires into an LRU (``retained``) that stays
    hit-able for prefix reuse until pool pressure evicts it."""

    def __init__(self, n_pages: int, page_size: int):
        self.page_size = page_size
        self.n_pages = n_pages
        self.free: List[int] = list(range(n_pages - 1, 0, -1))
        self.refcount = np.zeros(n_pages, np.int32)
        self.page_hash: Dict[int, bytes] = {}      # page -> prefix hash
        self.by_hash: Dict[bytes, int] = {}        # prefix hash -> page
        # insertion-ordered dict as LRU: oldest first
        self.retained: Dict[int, None] = {}
        self.prefix_hits = 0
        self.prefix_misses = 0

    @property
    def available(self) -> int:
        return len(self.free) + len(self.retained)

    def alloc(self) -> int:
        if self.free:
            page = self.free.pop()
        elif self.retained:
            page = next(iter(self.retained))       # LRU victim
            del self.retained[page]
            self._forget(page)
        else:
            raise MemoryError('KV page pool exhausted')
        self.refcount[page] = 1
        return page

    def retain(self, page: int) -> None:
        if page in self.retained:                  # revive from LRU
            del self.retained[page]
        self.refcount[page] += 1

    def release(self, page: int) -> None:
        self.refcount[page] -= 1
        assert self.refcount[page] >= 0, page
        if self.refcount[page] == 0:
            if page in self.page_hash:
                self.retained[page] = None         # prefix-reusable, LRU
            else:
                self.free.append(page)

    def _forget(self, page: int) -> None:
        h = self.page_hash.pop(page, None)
        if h is not None and self.by_hash.get(h) == page:
            del self.by_hash[h]

    def _chain_hashes(self, prompt: List[int], upto: int,
                      salt: bytes = b''):
        """Rolling per-page chain digests: h_i = sha1(h_{i-1} || tokens
        of page i), from h_0 = ``salt`` (empty for the base model; an
        adapter's KV rows differ from the base model's for the same
        tokens, so its chains live under their own salt: the adapter's
        name and the load that wrote its slot)."""
        ps = self.page_size
        h = salt
        arr = np.asarray(prompt, np.int32)
        for i in range(upto):
            h = hashlib.sha1(h + arr[i * ps:(i + 1) * ps].tobytes()
                             ).digest()
            yield i, h

    def match_prefix(self, prompt: List[int],
                     salt: bytes = b'') -> List[int]:
        """Longest chain of cached full pages covering the prompt's
        reusable prefix (never the final token). Retains every matched
        page for the caller."""
        matched: List[int] = []
        max_full = (len(prompt) - 1) // self.page_size
        for _, h in self._chain_hashes(prompt, max_full, salt):
            page = self.by_hash.get(h)
            if page is None or (self.refcount[page] == 0
                                and page not in self.retained):
                break
            matched.append(page)
        for p in matched:
            self.retain(p)
        if matched:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1
        return matched

    def register_prefix(self, prompt: List[int], pages: List[int],
                        n_matched: int, salt: bytes = b'') -> None:
        """Content-address the full pages a prefill just wrote (pages
        beyond ``n_matched``); an existing entry for the same hash keeps
        the older page. Refuses a page list that cannot cover every full
        page of ``prompt``."""
        max_full = (len(prompt) - 1) // self.page_size
        if len(pages) < max_full:
            raise ValueError(
                f'register_prefix: {len(pages)} page(s) cannot cover '
                f'the {max_full} full page(s) of a {len(prompt)}-token '
                'context (truncated row batch?)')
        for i, h in self._chain_hashes(prompt, max_full, salt):
            if i < n_matched:
                continue
            page = pages[i]
            if h not in self.by_hash:
                self.by_hash[h] = page
                self.page_hash[page] = h


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
class PagedInferenceEngine(speculative.SpeculativeMixin, _EngineBase):
    """Continuous-batching engine over the paged pool (the serve
    layer's default engine):

    - admission matches cached prefix pages, then chunk-prefills only
      the uncached tail;
    - decode runs fused horizons whose attention reads each slot's pages
      (the K1 CUDA kernel under ``decode_impl='pallas'``, K2 under
      ``'cross_layer'``);
    - ``quantize='int8'`` serves int8 weights (``prepare_params``) and,
      with ``kv_cache_dtype`` left on auto, an int8 pool; int8/int4 KV
      also pairs with bf16 weights;
    - device memory = weights + a page pool sized from free memory at
      the KV dtype's byte width;
    - ``speculate_k > 0`` replaces decode with speculative rounds (one
      ``paged_spec_verify`` a round, or ``decode_steps_per_call`` of them
      fused into one graph).
    """

    _PREFILL_N_BUCKETS = (1, 2, 4, 8, 16, 32)
    _HORIZON_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
    # Stacked-chunk transient budget (prefill batch width cap).
    _PREFILL_STACK_BUDGET = int(1.5e9)
    # Ring-buffer byte cap for auto-sized pools (see _auto_n_pages).
    _RING_BYTES_CAP_PAGED = int(1.7e9)
    # Prefix chains the heat tracker keeps (the coldest is evicted).
    _PREFIX_HEAT_MAX = 64

    interleave_horizon = 8

    @mesh_lib.mirrored_init
    def __init__(self, cfg: ModelConfig, params: Optional[Params] = None, *,
                 max_batch: int = 8, max_seq: int = 1024,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 prefill_chunk_tokens: int = 256,
                 rng_seed: int = 0,
                 quantize: Optional[str] = None,
                 kv_cache_dtype: Optional[str] = None,
                 decode_impl: str = 'auto',
                 prefill_w8a8: bool = False,
                 decode_priority_ratio: Optional[float] = None,
                 decode_steps_per_call: Optional[int] = None,
                 speculate_k: int = 0,
                 adapter_slots: int = 0,
                 adapter_dir: Optional[str] = None,
                 adapter_rank: int = 8,
                 mesh=None,
                 param_seed: int = 0,
                 telemetry: bool = True,
                 device: DeviceLike = 'cuda'):
        self._init_telemetry(telemetry)
        self.cfg = serving_config(cfg)
        self.device = self._init_mesh(mesh, self.cfg, device,
                                      max_batch=max_batch)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.chunk = prefill_chunk_tokens
        # Int8 activations in the prefill chunks' and verify rounds'
        # layer matmuls (``quantization.w8a8_region``); decode stays
        # W8A16.
        self.prefill_w8a8 = bool(prefill_w8a8)
        # Decode share of the interleaved token budget while prompts
        # are mid-prefill (_EngineBase._interleave_horizon); None keeps
        # the fixed interleave horizon.
        self.decode_priority_ratio = decode_priority_ratio
        self.decode_steps_per_call = self._validate_decode_steps(
            decode_steps_per_call)
        self._init_spec(speculate_k)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)
        self.params, quantize = prepare_params(
            cfg, params, quantize=quantize, device=self.device,
            prefill_w8a8=self.prefill_w8a8, mesh=mesh,
            param_seed=param_seed)
        cfg = self.cfg
        # KV storage dtype: its own knob; None/'auto' follows the weight
        # quantize mode, resolved after prepare_params so a tree that
        # arrives quantized resolves 'auto' too.
        self.kv_cache_dtype = resolve_kv_cache_dtype(kv_cache_dtype,
                                                     quantize)
        if page_size is None:
            page_size = self._auto_page_size(cfg, max_seq)
        self.page = page_size
        self._param_bytes = quantization.per_device_bytes(self.params)
        # The bank lands before the pool is sized from free memory.
        self._init_adapters(adapter_slots, adapter_rank, adapter_dir)
        self._pool_auto_sized = n_pages is None
        if n_pages is None:
            n_pages = self._auto_n_pages(cfg, max_batch, max_seq, page_size)
            if mesh is not None:
                # Every rank's pool holds the same pages: the least
                # any rank's free memory admits.
                n_pages = mesh.min_over_ranks(n_pages)
        self.alloc = PageAllocator(n_pages, page_size)
        # This rank's kv heads of every page (the whole pool meshless).
        self.cache = PagedKVCache.create(self.shard_cfg, n_pages=n_pages,
                                         page_size=page_size,
                                         kv_dtype=self.kv_cache_dtype,
                                         device=self.device)
        if decode_impl == 'auto':
            decode_impl = auto_decode_impl(
                mesh_lib.attention_config(self.shard_cfg, self._tp_plan),
                self.device.type)
        if decode_impl not in DECODE_IMPLS:
            raise NotImplementedError(
                f'decode_impl {decode_impl!r} is not ported; use one of '
                f'{DECODE_IMPLS} or auto')
        self.decode_impl = decode_impl

        self._init_slots(max_batch)
        self._pages: List[List[int]] = [[] for _ in range(max_batch)]
        # slot -> tokens of its prompt TAIL prefilled so far; a slot in
        # this dict is assigned but not yet decodable.
        self._prefill_off: Dict[int, int] = {}
        self._slot_inflight = np.zeros(max_batch, np.int64)
        # Early-recycled requests whose tail tokens are still in the
        # pipeline (in neither _queue nor _slots).
        self._lagging: Dict[int, Request] = {}
        # Bumped when a slot is freed: an in-flight call enqueued for a
        # previous occupant must not decrement the NEW occupant's
        # inflight count at processing time.
        self._slot_epoch = np.zeros(max_batch, np.int64)
        self._deferred_events: List[Tuple[int, int, bool]] = []
        # Prefix heat: sha1 of a chain's page-grid tokens -> {'tokens':
        # the covered tokens and the next one, 'hits': uses}.
        self._prefix_heat: Dict[bytes, Dict[str, Any]] = {}
        tok_bytes = kv_token_bytes(self.cfg, self.kv_cache_dtype, mesh)
        n_fit = int(self._PREFILL_STACK_BUDGET
                    // max(1, self.chunk * tok_bytes))
        self._prefill_n_max = 1
        for b in self._PREFILL_N_BUCKETS:
            if b <= n_fit:
                self._prefill_n_max = b
        self.preemptions = 0
        # Decode steps enqueued (sum of horizons): each runs one
        # attention call per layer.
        self.decode_substeps = 0
        self._init_decode(self._ring_capacity(self._ring_horizon_bucket(
            self._ring_bytes())),
            table_cols=_bucket_len(self._pages_needed(max_seq), minimum=1))

    @classmethod
    def from_pretrained(cls, path: str, *, dtype: Optional[torch.dtype] = None,
                        **kwargs) -> 'PagedInferenceEngine':
        """A paged engine over an HF checkpoint directory (see
        ``InferenceEngine.from_pretrained``: bf16 by default, host int8
        quantization under ``quantize='int8'``, ``device=``)."""
        return _from_pretrained(cls, path, dtype, kwargs)

    @classmethod
    def _auto_page_size(cls, cfg: ModelConfig, max_seq: int) -> int:
        """Default page size: 128-token pages, smaller for short-context
        configs so a slot does not hold one oversized page."""
        del cfg
        return min(128, _bucket_len(max(8, max_seq // 8), minimum=8))

    # One decode step's temporaries besides the widened weight leaves
    # (activations, logits, the sampler's sort at batch <= 64), held in
    # the decode graphs' pool.
    _GRAPH_POOL_STEP_BYTES = int(0.5e9)

    def _auto_n_pages(self, cfg: ModelConfig, max_batch: int,
                      max_seq: int, page_size: int) -> int:
        """Size the pool from FREE device memory after the weights
        landed (``torch.cuda.mem_get_info``), keeping a reserve for the
        static decode ring, prefill transients, a quantized tree's
        widened per-layer leaf (``quantization.widened_leaf_bytes``:
        1.88 GB for mixtral-8x7b's int8 experts) and workspace, and for
        the decode graphs' pool, which the eager allocator cannot reuse:
        one step's temporaries and twice the widened leaf (an int4
        leaf's unpack passes beside its widened copy: llama3-70b's pool
        measured 7.3 GB against a 4.2 GB leaf on an H100), capped at 4x
        slot parity. CPU engines take slot parity and the conservative
        ring budget."""
        parity = max_batch * -(-max_seq // page_size) + 1
        if self.device.type != 'cuda':
            self._pool_auto_sized = False
            return parity
        free, total = torch.cuda.mem_get_info(self.device)
        limit, used = total, total - free
        used = max(used, self._param_bytes + int(0.15e9))
        row = _ring_row_bytes(cfg, max_batch, self.mesh)
        h_max = self._ring_capacity(
            self._ring_horizon_bucket(self._RING_BYTES_CAP_PAGED))
        widened = quantization.widened_leaf_bytes(self.params)
        reserve = (int(1.6e9) + 2 * row * h_max + self._PREFILL_STACK_BUDGET
                   + widened + 2 * widened + self._GRAPH_POOL_STEP_BYTES)
        page_bytes = (kv_token_bytes(cfg, self.kv_cache_dtype, self.mesh)
                      * page_size)
        fit = max(0, (limit - used - reserve)) // page_bytes
        return int(max(min(fit, 4 * parity), 2))

    def _ring_bytes(self) -> int:
        """Ring budget: auto-sized pools reserved memory for the full
        ring; explicit pools keep the conservative 512 MB cap."""
        return (self._RING_BYTES_CAP_PAGED if self._pool_auto_sized
                else int(512e6))

    def _ring_horizon_bucket(self, ring_bytes: int) -> int:
        """The horizon BUCKET the ring budget admits (shared by pool
        sizing and the decode horizon cap)."""
        row = _ring_row_bytes(self.cfg, self.max_batch, self.mesh)
        cap = min(self._HORIZON_BUCKETS[-1],
                  _ring_horizon_cap(self.cfg, self.max_batch,
                                    self._param_bytes, self.mesh),
                  max(8, ring_bytes // row))
        return next((b for b in reversed(self._HORIZON_BUCKETS)
                     if b <= cap), 8)

    # ---------------------------------------------------------- public
    def _validate_request(self, prompt: List[int],
                          max_new_tokens: int) -> None:
        super()._validate_request(prompt, max_new_tokens)
        need = self._pages_needed(len(prompt) + max_new_tokens)
        if need > self.alloc.n_pages - 1:
            raise ValueError(
                f'request needs {need} pages but the pool has only '
                f'{self.alloc.n_pages - 1}; raise n_pages')

    def memory_stats(self) -> Dict[str, Any]:
        page_bytes = kv_token_bytes(self.cfg, self.kv_cache_dtype) * self.page
        used = self.alloc.n_pages - 1 - len(self.alloc.free) \
            - len(self.alloc.retained)
        return {
            'n_pages': self.alloc.n_pages,
            'pages_in_use': used,
            'pages_retained_prefix': len(self.alloc.retained),
            'pages_free': len(self.alloc.free),
            'page_bytes': page_bytes,
            'pool_bytes': page_bytes * self.alloc.n_pages,
            'kv_cache_dtype': self.kv_cache_dtype,
            'pool_token_capacity': (self.alloc.n_pages - 1) * self.page,
            'prefix_hits': self.alloc.prefix_hits,
            'prefix_misses': self.alloc.prefix_misses,
        }

    def kv_token_capacity(self) -> int:
        """Token rows the pool tensors physically hold, trash page
        included (the cost model divides the pool's bytes, and page 0 is
        part of them); ``memory_stats``'s allocatable capacity excludes
        it."""
        return self.alloc.n_pages * self.page

    def kv_pool_stats(self) -> Dict[str, Any]:
        """KV capacity/pressure in TOKENS (page-granular). Prefix-retained
        pages count as free: allocation evicts them on demand."""
        stats = self.memory_stats()
        cap = stats['pool_token_capacity']
        used = stats['pages_in_use'] * self.page
        return {
            'kv_cache_dtype': self.kv_cache_dtype,
            'pool_token_capacity': cap,
            'tokens_used': used,
            'tokens_free': cap - used,
            'preemptions': int(self.preemptions),
            'kv_token_bytes': kv_token_bytes(self.cfg, self.kv_cache_dtype),
            # The bytes one device stores (kv heads split over tp, pages
            # replicated over dp); the token counts above stay global.
            'kv_token_bytes_per_shard': kv_token_bytes(
                self.cfg, self.kv_cache_dtype, self.mesh),
            'kv_shards': kv_shard_degree(self.cfg, self.mesh),
        }

    # ---------------------------------------------------------- admission
    def _pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page)

    def _ensure_pages(self, slot: int, upto_tokens: int) -> bool:
        """Grow the slot's page list to cover ``upto_tokens``; False if
        the pool is exhausted (caller backs off)."""
        need = self._pages_needed(upto_tokens)
        pages = self._pages[slot]
        grabbed = []
        try:
            while len(pages) < need:
                p = self.alloc.alloc()
                pages.append(p)
                grabbed.append(p)
            return True
        except MemoryError:
            for p in grabbed:
                pages.remove(p)
                self.alloc.release(p)
            return False

    def _free_slot(self, slot: int) -> None:
        for p in self._pages[slot]:
            self.alloc.release(p)
        self._pages[slot] = []
        self._prefill_off.pop(slot, None)        # cancel mid-prefill
        self._slot_inflight[slot] = 0
        self._slot_epoch[slot] += 1
        super()._free_slot(slot)

    def has_work(self) -> bool:
        self._purge_lagging()
        return super().has_work() or bool(self._lagging)

    def cancel(self, request_id: int) -> bool:
        if super().cancel(request_id):
            return True
        req = self._lagging.pop(request_id, None)
        if req is not None and req.finish_time is None:
            # Early-recycled: the slot/pages are already released; the
            # pipeline's tail tokens are dropped at readback.
            req.finish_time = clock.now()
            self._release_adapter(req)
            self._trace_finish(req, cancelled=True)
            return True
        return False

    def _slot_remaining_prefill(self, slot: int) -> int:
        """Uncached prompt-tail tokens still to prefill: the context
        minus prefix-matched pages minus the chunk cursor."""
        off = self._prefill_off.get(slot)
        if off is None:
            return 0
        req = self._slots[slot]
        tail = len(req._ctx) - req._n_matched * self.page
        return max(0, tail - off)

    def _purge_lagging(self) -> None:
        if self._lagging:
            for rid in [rid for rid, r in self._lagging.items()
                        if r.finish_time is not None]:
                del self._lagging[rid]

    def _maybe_early_free(self, slot: int, req: Request) -> None:
        """Recycle the slot the moment the request's whole output is
        covered by ENQUEUED device calls (budget-bound requests only;
        stop sequences and eos make completion data-dependent). Pages
        released here are only re-written by calls enqueued later, which
        the single stream orders after the in-flight reads."""
        if req.stop or req.eos_id is not None or req._early_freed:
            return
        budget = min(req.max_new_tokens,
                     max(1, self.max_seq - len(req.prompt)))
        if req._enq_out >= budget:
            req._early_freed = True
            self._lagging[req.request_id] = req
            self._free_slot(slot)

    def _preempt_slot(self, slot: int) -> None:
        """Pool pressure: push a live request back to the FRONT of the
        queue, releasing its pages (registered first, so re-admission
        re-matches the ORIGINAL bytes instead of recomputing them)."""
        req = self._slots[slot]
        self.preemptions += 1
        written = (req.prompt + req.output)[:int(self._slot_len[slot]) + 1]
        if self._pages[slot]:
            self.alloc.register_prefix(written, self._pages[slot],
                                       getattr(req, '_n_matched', 0),
                                       req._prefix_salt)
        if req.trace is not None:
            # Close the in-slot spans; the re-admission opens queue ->
            # prefill -> decode again.
            req.trace.end('decode')
            req.trace.end('prefill')
            req.trace.begin('queue', preempted=True)
        self._free_slot(slot)
        self._requeue_front([req])

    def _admit(self) -> List[Tuple[int, int, bool]]:
        """Assign free slots, then run ONE prefill chunk-batch — more
        while fewer than a quarter of the batch is decoding (burst
        admission)."""
        self._assign_slots()
        events = self._prefill_chunk_batch()
        while (self._prefill_off
               and sum(r is not None for r in self._slots)
               - len(self._prefill_off) < self.max_batch // 4):
            events += self._prefill_chunk_batch()
        return events

    def _assign_slots(self) -> None:
        for slot in range(self.max_batch):
            if self._slots[slot] is not None:
                continue
            req = self._queue_pop()
            if req is None:
                return
            # A preempted request re-enters with its generated tokens as
            # part of the context (preemption-by-recompute).
            ctx = req.prompt + req.output
            matched = self.alloc.match_prefix(ctx, req._prefix_salt)
            # Resume a prefix hit on the canonical chunk grid: a cold
            # prefill chunks from offset 0, so keeping only matched
            # pages up to a chunk-multiple boundary makes every hit-path
            # chunk the same computation on the same operands as the
            # cold path (otherwise greedy streams can differ on
            # near-tie logits). Preemption re-entry resumes from its own
            # registered pages and keeps the mid-grid resume.
            if not req.output:
                keep = len(matched)
                while keep and (keep * self.page) % self.chunk:
                    keep -= 1
                for p in matched[keep:]:
                    self.alloc.release(p)
                matched = matched[:keep]
            self._pages[slot] = list(matched)
            if not self._ensure_pages(slot, len(ctx)):
                for p in self._pages[slot]:
                    self.alloc.release(p)
                self._pages[slot] = []
                self._requeue_front([req])
                return
            self._slots[slot] = req
            self._slot_len[slot] = len(matched) * self.page
            req._n_matched = len(matched)        # host-only annotations
            req._ctx = ctx
            if matched and req.adapter is None:
                # A prefix hit is the strongest heat signal (the heat
                # tracker exports base-model chains only).
                self._note_hot_prefix(ctx)
            self._prefill_off[slot] = 0          # tail tokens done so far
            self._trace_sched(req)
            if req.trace is not None and matched:
                req.trace.instant('prefix_cache_hit', pages=len(matched))

    def _prefill_chunk_batch(self) -> List[Tuple[int, int, bool]]:
        """One fixed-size chunk across up to an n-bucket of mid-prefill
        slots. Always returns []: completing slots' first tokens are
        sampled on the device and merged into the device token vector
        before this returns; their events surface via ``_process_one``."""
        pending = sorted(self._prefill_off)
        if not pending:
            return []
        batch = pending[:self._prefill_n_max]
        n = next(b for b in self._PREFILL_N_BUCKETS if b >= len(batch))
        # Half-width chunk when every pending piece fits 128 tokens.
        rest_max = max(
            len(self._slots[s]._ctx)
            - self._slots[s]._n_matched * self.page
            - self._prefill_off[s]
            for s in batch)
        chunk_w = (128 if self.chunk > 128 and rest_max <= 128
                   else self.chunk)
        tokens = np.zeros((n, chunk_w), np.int32)
        lengths = np.zeros(n, np.int32)
        valid = np.zeros(n, np.int32)
        want = np.full(n, -1, np.int32)
        P_needed = 1
        for i, slot in enumerate(batch):
            req = self._slots[slot]
            tail = req._ctx[req._n_matched * self.page:]
            off = self._prefill_off[slot]
            piece = tail[off:off + chunk_w]
            lengths[i] = self._slot_len[slot]
            tokens[i, :len(piece)] = piece
            valid[i] = len(piece)
            if off + len(piece) == len(tail):
                want[i] = len(piece) - 1
            P_needed = max(P_needed, self._pages_needed(
                int(lengths[i]) + int(valid[i])))
        for i in range(len(batch), n):           # padding rows: valid=0
            lengths[i] = self._slot_len[batch[0]]   # rows write to trash
        P = _bucket_len(P_needed, minimum=1)
        table_p = np.zeros((n, P), np.int32)
        for i, slot in enumerate(batch):
            ps = self._pages[slot][:P]
            table_p[i, :len(ps)] = ps
        temps = np.zeros(n, np.float32)
        topks = np.zeros(n, np.int32)
        topps = np.ones(n, np.float32)
        for i, slot in enumerate(batch):
            req = self._slots[slot]
            temps[i] = req.temperature
            topks[i] = req.top_k or 0
            topps[i] = req.top_p
        (table_d, tokens_d, lengths_d, valid_d, want_d, temps_d, topks_d,
         topps_d) = device_upload((table_p, tokens, lengths, valid, want,
                                   temps, topks, topps), self.device)
        # Each row's adapter slot and grammar mask (padding rows: base,
        # unconstrained).
        adp_d, vm_d = self._upload_row_adapters(
            [self._slots[s] for s in batch] + [None] * (n - len(batch)))
        # Sampling variant only when a row COMPLETING this chunk needs
        # it: greedy completions take the argmax path with no sort.
        sample = any(self._slots[s].temperature > 0
                     for i, s in enumerate(batch) if want[i] >= 0)
        chunk_t0 = clock.monotonic()
        with self._prof.phase('prefill_chunk'), \
                self._prof.jit_key('prefill', (n, P, sample, chunk_w)):
            first, self.cache = paged_prefill_chunk(
                self.params, self.cache, table_d, tokens_d, lengths_d,
                valid_d, want_d, self.cfg,
                temps=temps_d if sample else None, topks=topks_d,
                topps=topps_d, generator=self._gen, mlora_idx=adp_d,
                vocab_mask=vm_d, w8a8=self.prefill_w8a8,
                dp_rows=self._prefill_split(n))
        chunk_t1 = clock.monotonic()
        for i, slot in enumerate(batch):
            r = self._slots[slot]
            if r.trace is not None:
                r.trace.add('prefill_chunk', chunk_t0, chunk_t1,
                            offset=self._prefill_off[slot],
                            tokens=int(valid[i]))
        done_rows: List[Tuple[int, int]] = []    # (row i, slot)
        for i, slot in enumerate(batch):
            req = self._slots[slot]
            self._slot_len[slot] += int(valid[i])
            self._prefill_off[slot] += int(valid[i])
            if want[i] < 0:
                continue                         # more chunks to go
            del self._prefill_off[slot]
            self.alloc.register_prefix(req._ctx, self._pages[slot],
                                       req._n_matched, req._prefix_salt)
            if req.adapter is None:
                self._note_hot_prefix(req._ctx)
            done_rows.append((i, slot))
        if done_rows:
            rows_d, slots_d = device_upload(
                (np.array([i for i, _ in done_rows], np.int64),
                 np.array([s for _, s in done_rows], np.int64)),
                self.device)
            self._tok_dev[slots_d] = first[rows_d]
            self._meta_dirty = True          # slots become decodable
            self._pending.append({
                'kind': 'prefill', 'toks': first,
                'event': self._record_event(),
                'batch': [(slot, self._slots[slot], i)
                          for i, slot in done_rows]})
            for i, slot in done_rows:
                req = self._slots[slot]
                req._enq_out = len(req.output) + 1
                self._maybe_early_free(slot, req)
        return []

    def _record_event(self) -> Optional[torch.cuda.Event]:
        """A marker after the work just enqueued, so ``step`` can tell
        without blocking whether a call's results are ready (None on the
        CPU, where every result is ready on return)."""
        if self.device.type != 'cuda':
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    # ------------------------------------------------------ prefix heat
    def _note_hot_prefix(self, tokens: List[int]) -> None:
        """One use of the prefix chain covering ``tokens``' full pages
        (host dict operations only; at most ``_PREFIX_HEAT_MAX`` chains,
        the coldest evicted). The checkpoint exports the hottest."""
        full = (len(tokens) - 1) // self.page
        if full < 1:
            return
        covered = full * self.page
        key = hashlib.sha1(np.asarray(
            tokens[:covered], np.int32).tobytes()).digest()
        rec = self._prefix_heat.get(key)
        if rec is not None:
            rec['hits'] += 1
            return
        if len(self._prefix_heat) >= self._PREFIX_HEAT_MAX:
            coldest = min(self._prefix_heat,
                          key=lambda k: self._prefix_heat[k]['hits'])
            del self._prefix_heat[coldest]
        self._prefix_heat[key] = {'tokens': list(tokens[:covered + 1]),
                                  'hits': 1}

    def hot_prefix_digest(self, max_entries: int = 16):
        """The hottest prefix chains, hottest first, as ``[{'hash': sha1
        hex of the page-grid token bytes (int32), 'len': covered tokens,
        'hits': n}, ...]``: host state only, no device work, so a
        metrics scrape can carry it. A load balancer hashes a prompt's
        page-grid prefixes the same way to route by the longest match; a
        hash may name a chain evicted since (a hint, not a promise)."""
        by_heat = sorted(self._prefix_heat.items(),
                         key=lambda kv: -kv[1]['hits'])
        return [{'hash': key.hex(),
                 'len': len(rec['tokens']) - 1,
                 'hits': int(rec['hits'])}
                for key, rec in by_heat[:max_entries]]

    def drain_pipeline(self):
        """Every call in flight read back, and the pool-pressure
        deferred events with them."""
        events = super().drain_pipeline()
        if self._deferred_events:
            events.extend(self._deferred_events)
            self._deferred_events = []
        return events

    # ------------------------------------------------ prefix checkpoint
    def export_prefix_snapshots(self, max_entries: int = 8):
        """The hottest still-cached prefix chains as prefix entries
        (``kv_transfer`` SKPF dicts): each heat record's pages matched
        again in the allocator (a chain evicted since exports nothing)
        and read back in the stored dtype. Returns ``(entries, drained
        events)``: the pipeline is drained first so the rows are
        final."""
        events = super().drain_pipeline()
        entries: List[Dict[str, Any]] = []
        for rec in sorted(self._prefix_heat.values(),
                          key=lambda r: -r['hits']):
            if len(entries) >= max_entries:
                break
            entry = self._export_prefix_record(rec)
            if entry is not None:
                entries.append(entry)
        return entries, events

    def _export_prefix_record(self, rec: Dict[str, Any]
                              ) -> Optional[Dict[str, Any]]:
        """One heat record's still-cached chain as a prefix entry (None
        when the allocator evicted it); the caller drains first."""
        tokens = rec['tokens']
        pages = self.alloc.match_prefix(tokens)
        if not pages:
            return None
        n_rows = len(pages) * self.page
        try:
            k, v, ks, vs = self._gather_pages(pages, n_rows)
        finally:
            for p in pages:
                self.alloc.release(p)
        return {
            'kv_cache_dtype': self.kv_cache_dtype,
            'n_rows': n_rows,
            'model': self._model_shape(),
            'tokens': list(tokens[:n_rows + 1]),
            'k': k, 'v': v, 'k_scale': ks, 'v_scale': vs,
        }

    def export_prefix_entry(self, hash_hex: str):
        """The hot chain a digest hash names, as ``(entry or None,
        drained events)``: None when the heat record or its pages are
        gone."""
        try:
            key = bytes.fromhex(hash_hex)
        except ValueError:
            return None, []
        rec = self._prefix_heat.get(key)
        if rec is None:
            return None, []
        events = super().drain_pipeline()
        return self._export_prefix_record(rec), events

    def warm_prefix(self, entry: Dict[str, Any]) -> int:
        """Land a prefix entry (or a request snapshot, viewed as one)
        into the prefix cache without seating a request: whole pages
        only, scattered at their exact bytes, the chain registered, the
        pages released into the prefix LRU, so a later prompt sharing
        the prefix hits the original KV. Idempotent: a chain already
        cached lands nothing. Returns the rows landed; raises
        ``ValueError`` on a mismatch (permanent) and
        ``HandoffCapacityError`` under pool pressure (retryable)."""
        if 'tokens' not in entry:
            entry = kv_transfer.as_prefix_entry(entry)
        n_rows = int(entry['n_rows'])
        tokens = [int(t) for t in entry['tokens']]
        if len(tokens) < n_rows + 1:
            raise ValueError(
                f'prefix entry carries {len(tokens)} token(s) for '
                f'{n_rows} row(s); need n_rows + 1')
        self._validate_kv_entry(entry, n_rows)
        full = n_rows // self.page
        if full < 1:
            return 0
        rows_used = full * self.page
        prefix_tokens = tokens[:rows_used + 1]
        matched = self.alloc.match_prefix(prefix_tokens)
        for p in matched:
            self.alloc.release(p)
        if len(matched) >= full:
            return 0                       # already warm
        if self.alloc.available < full:
            raise kv_transfer.HandoffCapacityError(
                f'KV page pool exhausted ({self.alloc.available} '
                f'page(s) free, {full} needed for prefix warmup)')
        pages = [self.alloc.alloc() for _ in range(full)]
        try:
            self._scatter_snapshot_rows(pages, entry, rows_used)
            self.alloc.register_prefix(prefix_tokens, pages, 0)
        except Exception:
            for p in pages:
                self.alloc.release(p)
            raise
        # Refcount 0: freshly hashed pages retire into the prefix LRU;
        # pages whose hash was already cached go back to the free list.
        for p in pages:
            self.alloc.release(p)
        self._note_hot_prefix(prefix_tokens)
        return rows_used

    # ------------------------------------------------------- KV handoff
    def _gather_pages(self, pages: List[int], n_rows: int):
        """The first ``n_rows`` rows of a page chain, token-major
        ``[L, n, hkv, d]`` (scales ``[L, n, hkv]``) in the stored dtype,
        read back with ONE sanctioned ``host_sync``."""
        (idx,) = device_upload((np.asarray(pages, np.int64),), self.device)

        def tok_major(pool):                       # [L, P, hkv, page, ..]
            g = pool[:, idx].transpose(2, 3)
            return g.reshape((g.shape[0], -1) + tuple(g.shape[3:]))[
                :, :n_rows]
        c = self.cache
        parts = [tok_major(c.pool_k), tok_major(c.pool_v)]
        if c.quantized:
            parts += [tok_major(c.k_scale), tok_major(c.v_scale)]
        # Under tp, every rank's kv heads gathered into the whole rows.
        parts = [mesh_lib.gather_split(p, 'kv_heads', 2) for p in parts]
        host = rows_to_host(parts)
        if c.quantized:
            return tuple(host)
        return host[0], host[1], None, None

    def _gather_kv_rows(self, slot: int, n_rows: int):
        pages = self._pages[slot][:self._pages_needed(max(1, n_rows))]
        return self._gather_pages(pages, n_rows)

    def _scatter_snapshot_rows(self, pages: List[int], snap,
                               n_rows: int) -> None:
        """``n_rows`` stored-dtype snapshot rows into ``pages``, in
        place, through ``merge_rows_into_pool`` (an ingest and a warm-up
        both land wire bytes at their exact values)."""
        cfg = self.cfg
        code_d = cfg.head_dim // 2 if self.cache.packed else cfg.head_dim
        # This rank's kv heads of the snapshot's (whole) rows.
        heads = mesh_lib.tp_slice(cfg.n_kv_heads, 'kv_heads')

        def rows(arr, tail):
            t = rows_to_device(arr, self.device)[:, :n_rows, heads]
            return t.reshape((cfg.n_layers, 1, n_rows,
                              self.shard_cfg.n_kv_heads) + tail)
        table, starts, valid = device_upload(
            (np.asarray([pages], np.int32), np.zeros(1, np.int32),
             np.array([n_rows], np.int32)), self.device)
        if self.cache.quantized:
            k_rows = (rows(snap['k'], (code_d,)),
                      rows(snap['k_scale'], (1,)))
            v_rows = (rows(snap['v'], (code_d,)),
                      rows(snap['v_scale'], (1,)))
        else:
            k_rows = rows(snap['k'], (cfg.head_dim,))
            v_rows = rows(snap['v'], (cfg.head_dim,))
        merge_rows_into_pool(self.cache, k_rows, v_rows, table, starts,
                             valid)

    def _land_kv_rows(self, slot: int, req: Request, snap) -> None:
        """Pages for the snapshot's rows, the rows scattered into them,
        and the landed full pages registered as the request's prefix
        (``register_prefix`` also refuses a page list too short for the
        context: the truncated-handoff guard)."""
        n_rows = int(snap['n_rows'])
        ctx = req.prompt + req.output
        self._pages[slot] = []
        if not self._ensure_pages(slot, max(1, n_rows)):
            raise kv_transfer.HandoffCapacityError(
                f'KV page pool exhausted ({self.alloc.available} '
                f'page(s) free, {self._pages_needed(n_rows)} needed)')
        try:
            self._scatter_snapshot_rows(self._pages[slot], snap, n_rows)
            self.alloc.register_prefix(ctx, self._pages[slot], 0)
            self._note_hot_prefix(ctx)
        except Exception:
            for p in self._pages[slot]:
                self.alloc.release(p)
            self._pages[slot] = []
            raise
        req._ctx = ctx
        req._n_matched = 0

    # ---------------------------------------------------------- step
    def step(self, horizon: int = 1) -> List[Tuple[int, int, bool]]:
        """Admit (one chunk-batch max), then enqueue decode through the
        async pipeline (results lag enqueues by up to
        ``_PIPELINE_DEPTH`` calls). While prompts are still streaming in
        the horizon is capped at ``interleave_horizon``; while the queue
        is non-empty at 32 (``decode_priority_ratio`` sets the
        interleave from a token budget; ``decode_steps_per_call`` pins
        every call at k steps). Returns [(request_id, token,
        finished)]."""
        events: List[Tuple[int, int, bool]] = []
        with self._prof.phase('readback'):
            while len(self._pending) >= self._PIPELINE_DEPTH:
                events.extend(self._process_one())
        with self._prof.phase('admit'):
            events.extend(self._admit())
        if self.speculate_k:
            # One synchronous propose -> verify -> commit round, or
            # decode_steps_per_call of them fused into one dispatch.
            if (self.decode_steps_per_call or 0) > 1:
                events.extend(self._spec_step_fused())
            else:
                events.extend(self._spec_step())
            if self._deferred_events:
                events.extend(self._deferred_events)
                self._deferred_events = []
            return events
        if self.decode_steps_per_call:
            # Multi-step pin: exactly k steps a call, over the
            # interleave and queue-pressure shrinks (the capacity caps
            # still apply in _enqueue_decode).
            horizon = self.decode_steps_per_call
        elif self._prefill_off:
            # decode_priority_ratio switches the fixed interleave
            # horizon to the token-budget split shared with the slot
            # engine.
            horizon = min(horizon,
                          self.interleave_horizon
                          if self.decode_priority_ratio is None
                          else self._interleave_horizon())
        elif self._queue:
            horizon = min(horizon, 32)
        with self._prof.phase('decode_enqueue'):
            enqueued = self._enqueue_decode(horizon)
        if not enqueued and self._pending:
            with self._prof.phase('readback'):
                events.extend(self._process_one())
        # Opportunistic drain: surface entries whose results are
        # already ready instead of letting them age in the pipeline.
        # Not under a mesh: whether a call has finished is a race, and
        # the ranks must read back at the same points.
        with self._prof.phase('readback'):
            while self._pending:
                ev = self._pending[0]['event']
                if ev is not None and (self.mesh is not None
                                       or not ev.query()):
                    break
                events.extend(self._process_one())
        if self._deferred_events:        # pool-pressure pipeline drain
            events.extend(self._deferred_events)
            self._deferred_events = []
        return events

    def _decode_call(self, horizon: int, sample: bool, P: int):
        """One decode call over the static buffers (uploaded): ``horizon``
        fused steps (graphs keyed (horizon, sample, P)), then the ring
        merge into the pool (keyed (horizon, P)). Returns tokens
        [max_batch, horizon]."""
        buf = self._buf
        table = buf.table(P)
        r = self._rows
        inputs = {k: r(v) for k, v in self._step_inputs().items()}

        def step(ring_k, ring_v, out, sample_fn):
            # Under dp this rank's block of slots only.
            with mesh_lib.dp_split(self._dp_rows):
                paged_decode_step(self.params, self.cache, r(table),
                                  r(buf.lengths), r(self._tok_dev),
                                  buf.step, r(ring_k, 1), r(ring_v, 1),
                                  r(out), self.cfg, sample_fn=sample_fn,
                                  decode_impl=self.decode_impl, **inputs)

        def merge(ring_k, ring_v):
            self._dp_gather(ring_k, ring_v, buf.out(horizon))
            merge_ring_into_pool(self.cache, ring_k, ring_v, table,
                                 buf.lengths, buf.active)

        return self._run_decode(horizon, sample, (P,), (P,), step, merge)

    # ------------------------------------------------------- speculative
    def _spec_room(self, slot: int) -> int:
        """Proposal cap from page availability: pages for len + k + 1
        rows, the cover shrinking under pool pressure down to 1 (a
        masked commit writes at most that many rows); -1 when even one
        more token has no page (the slot is then preempted)."""
        base = int(self._slot_len[slot])
        for cover in range(self.speculate_k + 1, 0, -1):
            if self._ensure_pages(slot, base + cover):
                return cover - 1
        return -1

    def _spec_starved(self, slots: List[int]) -> None:
        """The pool has no page for these slots even at one token:
        preempt them back to the queue (recompute, as the decode path's
        pool-pressure preemption does)."""
        for slot in slots:
            if self._slots[slot] is not None:
                self._preempt_slot(slot)

    def _spec_can_fuse(self, slot: int, rounds: int) -> bool:
        """Reserve the pages of ``rounds * (k + 1)`` rows up front: the
        fused rounds commit with no host step between them. False sends
        the step to the single round; pages reserved here stay with the
        slot and are released when it is freed."""
        base = int(self._slot_len[slot])
        return self._ensure_pages(
            slot, base + rounds * (self.speculate_k + 1))

    def _spec_stage(self, ready, **spec_inputs) -> int:
        """Stage and upload a speculative call's inputs: the sampling
        rows, the pool lengths, ``spec_inputs`` (``DecodeBuffers.
        set_spec``) and the page table over every page the ready slots
        hold (``_spec_room`` or ``_spec_can_fuse`` reserved them), in
        one copy. Returns the table width P."""
        buf = self._buf
        self._stage_rows(ready)
        P_needed = max(max((len(self._pages[s])
                            for s, r in enumerate(ready)
                            if r is not None), default=1), 1)
        P = _bucket_len(P_needed, minimum=1)
        table_p = np.zeros((self.max_batch, P), np.int32)
        for s in range(self.max_batch):
            ps = self._pages[s][:P]
            table_p[s, :len(ps)] = ps
        buf.set_lengths(self._slot_len)
        buf.set_spec(**spec_inputs)
        buf.upload(buf.set_table(table_p))
        return P

    def _spec_verify_fn(self, P: int):
        """``verify(proposals, n_prop, active) -> (commit, n_commit)``:
        ``paged_spec_verify`` over the static buffers, the pool lengths
        advanced by ``n_commit`` for a next fused round."""
        buf = self._buf
        table = buf.table(P)
        sample = self._sample
        inputs = self._step_inputs()

        def verify(proposals, n_prop, active):
            commit, n_commit = paged_spec_verify(
                self.params, self.cache, table, self._tok_dev, proposals,
                n_prop, buf.lengths, active, self.cfg, sample=sample,
                temps=buf.temps, topks=buf.topks, topps=buf.topps,
                generator=self._gen, w8a8=self.prefill_w8a8,
                dp_rows=self._dp_rows, **inputs)
            buf.lengths.add_(n_commit)
            return commit, n_commit

        return verify

    def _spec_verify_call(self, ready, proposals, n_prop) -> torch.Tensor:
        P = self._spec_stage(ready, proposals=proposals, n_prop=n_prop)
        return self._spec_run(P, self._spec_verify_fn(P))

    def _spec_fused_call(self, ready, rounds: int) -> torch.Tensor:
        hist, rem = self._spec_hist_state(ready)
        P = self._spec_stage(ready, hist=hist, rem=rem)
        return self._spec_run(P, self._spec_verify_fn(P), rounds)

    def _enqueue_decode(self, horizon: int = 1) -> bool:
        # Slots whose first token is still in flight DO decode: the
        # device-sampled token is already in the device token vector.
        # Held slots (a handoff pending) never decode.
        active_slots = [s for s in range(self.max_batch)
                        if self._slots[s] is not None
                        and s not in self._prefill_off
                        and not self._slots[s].hold]
        if not active_slots:
            return False
        cap = int(self.max_seq - 1 -
                  max(self._slot_len[s] + self._slot_inflight[s]
                      for s in active_slots))
        if cap < 1:
            return False
        horizon = max(1, min(horizon, cap))
        horizon = min(horizon, self._ring_horizon_bucket(self._ring_bytes()))
        if self.decode_steps_per_call is None:
            horizon = next(b for b in reversed(self._HORIZON_BUCKETS)
                           if b <= horizon)
        # else: the pin runs EXACTLY k (capacity-clamped), so the graph
        # key stays (k, sample, P) and one call covers k tokens.

        # Page capacity: every active slot must hold pages for
        # len+inflight+horizon; shrink the horizon under pool pressure,
        # and when even horizon=1 cannot fit, PREEMPT the newest request
        # back to the queue. Preemption must see complete outputs, so
        # with calls in flight the pipeline drains first and the step
        # retries.
        def covered(s, extra):
            return self._ensure_pages(
                s, int(self._slot_len[s] + self._slot_inflight[s]) +
                extra)

        while True:
            while horizon > 1:
                if all(covered(s, horizon) for s in active_slots):
                    break
                horizon //= 2
            if horizon > 1 or all(covered(s, 1) for s in active_slots):
                break
            if self._pending:
                drained = list(self._deferred_events)
                self._deferred_events = []
                while self._pending:
                    drained.extend(self._process_one())
                self._deferred_events = drained
                return False
            # Victims: every occupied slot EXCEPT the oldest decodable
            # request, which is guaranteed to fit the pool alone.
            oldest = min(active_slots,
                         key=lambda s: self._slots[s].request_id)
            cands = [s for s in range(self.max_batch)
                     if self._slots[s] is not None and s != oldest]
            if not cands:
                raise MemoryError(
                    'KV page pool exhausted even at horizon=1 with one '
                    'active request; raise n_pages')
            victim = max(cands, key=lambda s: self._slots[s].request_id)
            self._preempt_slot(victim)
            if victim in active_slots:
                active_slots.remove(victim)

        ready = self._decode_ready()
        self._stage_rows(ready)
        max_pages_live = max(
            self._pages_needed(int(self._slot_len[s] +
                                   self._slot_inflight[s]) + horizon)
            for s in active_slots)
        P = _bucket_len(max_pages_live, minimum=1)
        table_p = np.zeros((self.max_batch, P), np.int32)
        for s in range(self.max_batch):
            ps = self._pages[s][:P]
            table_p[s, :len(ps)] = ps
        # Device-truth lengths at this call = processed + in-flight.
        lengths = self._slot_len + self._slot_inflight
        self._buf.set_lengths(lengths)
        self._buf.upload(self._buf.set_table(table_p))
        # One dispatch covers ``horizon`` substeps (the profiler's
        # per-substep split); the key's first call captures its graphs.
        self._prof.note_substeps('decode_enqueue', horizon)
        t0 = clock.monotonic()
        with self._prof.jit_key('decode', (horizon, self._sample, P)):
            toks = self._decode_call(horizon, self._sample, P)
        self._note_decode_step(int(sum(int(lengths[s]) for s in active_slots)),
                               horizon, clock.monotonic() - t0)
        self.decode_substeps += horizon
        # Snapshot the epochs BEFORE any early free below bumps them.
        epochs = self._slot_epoch.copy()
        for s in range(self.max_batch):
            if ready[s] is not None:
                self._slot_inflight[s] += horizon
                ready[s]._enq_out += horizon
                self._maybe_early_free(s, ready[s])
        self._pending.append({'kind': 'decode', 'toks': toks,
                              'event': self._record_event(),
                              'horizon': horizon,
                              'snapshot': list(ready),
                              'epochs': epochs})
        return True

    def _process_one(self) -> List[Tuple[int, int, bool]]:
        """Read back the oldest in-flight call into events (the one
        blocking device->host copy of the pipeline)."""
        events: List[Tuple[int, int, bool]] = []
        entry = self._pending.popleft()
        vals = host_sync(entry['toks'])
        now = clock.now()
        if entry['kind'] == 'prefill':
            for slot, req, row in entry['batch']:
                if req.finish_time is not None:
                    continue
                tenant = self._slots[slot] is req
                if not tenant and not req._early_freed:
                    continue                     # cancelled/preempted
                token = int(vals[row])
                if token < 0:
                    events.append(self._evict_nonfinite(slot, req))
                    continue
                if req.first_token_time is None:  # not on re-admission
                    req.first_token_time = now
                self._trace_first_token(req)
                req.output.append(token)
                finished = self._finish_req(slot, req, token)
                events.append((req.request_id, token, finished))
            return events
        for slot, req in enumerate(entry['snapshot']):
            if req is None:
                continue
            if entry['epochs'][slot] == self._slot_epoch[slot]:
                self._slot_inflight[slot] = max(
                    0, self._slot_inflight[slot] - entry['horizon'])
            if req.finish_time is not None:
                continue
            tenant = self._slots[slot] is req
            if not tenant and not req._early_freed:
                continue                         # cancelled/preempted
            for i in range(entry['horizon']):
                token = int(vals[slot, i])
                if token < 0:
                    events.append(self._evict_nonfinite(slot, req))
                    break
                req.output.append(token)
                if tenant:
                    self._slot_len[slot] += 1
                finished = self._finish_req(slot, req, token)
                events.append((req.request_id, token, finished))
                if finished:
                    break
        return events
