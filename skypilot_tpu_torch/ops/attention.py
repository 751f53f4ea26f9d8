"""Attention ops and their dispatch (port of
``skypilot_tpu/ops/attention.py``): the plain PyTorch paths, and the
``attention``/``chunk_attention`` dispatchers that route to the flash
kernels (``ops/flash_attention.py``: K4 with its backward K5a/K5b, and
K3) on CUDA.

Shapes follow the [batch, seq, heads, head_dim] convention. GQA stays in
grouped form ([b, s, hkv, g, d]) so kv is never materialized at
query-head width. Logits and softmax run in fp32 (the JAX package's
``preferred_element_type=jnp.float32``); the probability-times-value
products run in the cache's dtype, as in the reference.

Quantized caches pass int8 CODES (or packed uint8 int4 nibble rows) with
per-row fp32 scales ``[b, S, hkv, 1]``: the k scales fold into the fp32
logits and the v scales into the probabilities, which are then rounded
to bf16 for p.V with fp32 accumulation, exactly where the reference
rounds (for fp32 models too).
"""
from __future__ import annotations

from typing import Optional

import torch

from skypilot_tpu_torch.models.quantization import unpack_int4
from skypilot_tpu_torch.ops import cost, flash_attention, paged_attention

NEG_INF = -1e30


def _scale_bhk(s: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[b, S, hkv, 1] fp32 per-row KV scales -> [b, hkv, 1, 1, S] for
    folding into 'bhgqk' logits/probs."""
    if s is None:
        return None
    return s[..., 0].permute(0, 2, 1)[:, :, None, None, :]


def _unpack_kv(cache_k: torch.Tensor, cache_v: torch.Tensor):
    """int4 caches arrive as packed uint8 nibble rows ([..., d // 2]):
    unpack to int8 codes so the scale-fold math is the int8 path's."""
    if cache_k.dtype != torch.uint8:
        return cache_k, cache_v
    return unpack_int4(cache_k, axis=-1), unpack_int4(cache_v, axis=-1)


def _cache_pv(pc: torch.Tensor, cache_v: torch.Tensor,
              vs: Optional[torch.Tensor], out_dtype: torch.dtype):
    """p.V over the cache block: plain caches multiply in the cache's
    dtype; quantized ones fold the v scales into p, round p to bf16 and
    accumulate against the codes in fp32."""
    if vs is None:
        return torch.einsum('bhgqk,bkhd->bqhgd', pc.to(cache_v.dtype),
                            cache_v)
    pq = (pc * vs).to(torch.bfloat16).float()
    return torch.einsum('bhgqk,bkhd->bqhgd', pq, cache_v.float()
                        ).to(out_dtype)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[b, s, kv_heads, d] -> [b, s, kv_heads * n_rep, d]."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def reference_attention(
    q: torch.Tensor,                   # [b, sq, h, d]
    k: torch.Tensor,                   # [b, skv, hkv, d]
    v: torch.Tensor,                   # [b, skv, hkv, d]
    *,
    causal: bool = True,
    q_offset: Optional[torch.Tensor] = None,   # [b] position of q[0]
    kv_len: Optional[torch.Tensor] = None,     # [b] valid kv rows
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention, fp32 logits and softmax, GQA in grouped form.
    ``q_offset``/``kv_len`` mask for cached use: q positions are
    ``q_offset + [0..sq)``, kv rows at or past ``kv_len`` are masked."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, sq, hkv, group, d).float()
    logits = torch.einsum('bqhgd,bkhd->bhgqk', qg, k.float()) * scale
    skv = k.shape[1]
    kv_pos = torch.arange(skv, device=q.device)[None, None, None, None, :]
    mask = torch.ones((1, 1, 1, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(sq, device=q.device)[None, None, None, :, None]
        if q_offset is not None:
            q_pos = q_pos + q_offset.reshape(-1, 1, 1, 1, 1)
        mask = mask & (kv_pos <= q_pos)
    if kv_len is not None:
        mask = mask & (kv_pos < kv_len.reshape(-1, 1, 1, 1, 1))
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum('bhgqk,bkhd->bqhgd', probs, v)
    return out.reshape(b, sq, h, d)


def cached_attention(
    q: torch.Tensor,                   # [b, s, h, d] new-token queries
    k_new: torch.Tensor,               # [b, s, hkv, d] new-token keys
    v_new: torch.Tensor,               # [b, s, hkv, d]
    cache_k: torch.Tensor,             # [b, S, hkv, d] cache WITHOUT new rows
    cache_v: torch.Tensor,             # [b, S, hkv, d]
    cache_len: torch.Tensor,           # [b] valid cache entries
    *,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # [b, S, hkv, 1] fp32: the
    v_scale: Optional[torch.Tensor] = None,   # cache holds CODES
) -> torch.Tensor:
    """Prefill/decode attention against a KV cache without materializing
    the concatenated [cache; new] sequence: the cache block (positions
    < cache_len) and the causal new-token block share one numerically
    stable softmax. The cache is only read here."""
    cache_k, cache_v = _unpack_kv(cache_k, cache_v)
    b, s, h, d = q.shape
    hkv = k_new.shape[2]
    group = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, s, hkv, group, d).float()

    lc = torch.einsum('bqhgd,bkhd->bhgqk', qg, cache_k.float()) * scale
    if k_scale is not None:
        lc = lc * _scale_bhk(k_scale)
    ls = torch.einsum('bqhgd,bkhd->bhgqk', qg, k_new.float()) * scale

    S = cache_k.shape[1]
    kv_pos = torch.arange(S, device=q.device)[None, None, None, None, :]
    lc = torch.where(kv_pos < cache_len.reshape(-1, 1, 1, 1, 1), lc,
                     NEG_INF)
    q_pos = torch.arange(s, device=q.device)[None, None, None, :, None]
    new_pos = torch.arange(s, device=q.device)[None, None, None, None, :]
    ls = torch.where(new_pos <= q_pos, ls, NEG_INF)

    m = torch.maximum(lc.amax(-1, keepdim=True), ls.amax(-1, keepdim=True))
    ec = torch.exp(lc - m)
    es = torch.exp(ls - m)
    denom = ec.sum(-1, keepdim=True) + es.sum(-1, keepdim=True)
    pc = ec / denom
    out = _cache_pv(pc, cache_v, _scale_bhk(v_scale), q.dtype)
    out = out + torch.einsum('bhgqk,bkhd->bqhgd',
                             (es / denom).to(v_new.dtype), v_new)
    return out.reshape(b, s, h, d)


def _flash_takes(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the CUDA flash kernels take these operands: CUDA tensors
    of bf16/fp32 at a head_dim and group size they support. The
    reference's TPU limits (sq >= 256, multiples of 128) are lane-tile
    limits the CUDA kernels do not have."""
    return (cost.device_type(q) == 'cuda'
            and q.dtype in (torch.bfloat16, torch.float32)
            and k.dtype == q.dtype
            and paged_attention.kernel_supports(q.shape[-1], q.shape[2],
                                                k.shape[2]))


def chunk_attention(
    q: torch.Tensor,                   # [b, s, h, d] chunk queries
    k_new: torch.Tensor,               # [b, s, hkv, d] chunk keys
    v_new: torch.Tensor,               # [b, s, hkv, d]
    cache_k: torch.Tensor,             # [b, S, hkv, d] cache WITHOUT chunk
    cache_v: torch.Tensor,
    cache_len: torch.Tensor,           # [b] valid cache rows (= chunk
                                       #     start position per row)
    *,
    impl: str = 'auto',
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunked-prefill attention: one chunk of new tokens against the
    rows already in the cache plus causal self-attention within the
    chunk. ``auto`` takes the K3 CUDA kernel (``flash_chunk_attention``,
    cache and chunk as two operands) for every bf16/fp32 cache on CUDA
    the kernel supports, and ``flash`` asks for it anywhere (the plain
    version on the CPU); quantized caches (codes + scales) and the CPU
    under ``auto`` take ``cached_attention``, the reference's two-block
    softmax."""
    use_flash = impl in ('auto', 'flash') and k_scale is None and (
        impl == 'flash' or _flash_takes(q, cache_k))
    if use_flash:
        return flash_attention.flash_chunk_attention(
            q, k_new, v_new, cache_k.to(k_new.dtype), cache_v.to(v_new.dtype),
            cache_len.to(torch.int32))
    return cached_attention(q, k_new, v_new, cache_k, cache_v, cache_len,
                            k_scale=k_scale, v_scale=v_scale)


def ring_decode_attention(
    q: torch.Tensor,                   # [b, 1, h, d] current-token queries
    k_self: torch.Tensor,              # [b, 1, hkv, d] current-token keys
    v_self: torch.Tensor,              # [b, 1, hkv, d]
    cache_k: torch.Tensor,             # [b, S, hkv, d] read-only main cache
    cache_v: torch.Tensor,
    cache_len: torch.Tensor,           # [b] valid main-cache entries (fixed
                                       #     for the whole fused horizon)
    ring_k: torch.Tensor,              # [b, H, hkv, d] this horizon's rows
    ring_v: torch.Tensor,
    ring_len: int,                     # rows < ring_len are valid
    *,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # [b, S, hkv, 1] fp32: the
    v_scale: Optional[torch.Tensor] = None,   # cache holds CODES
) -> torch.Tensor:
    """Single-token decode attention over three blocks sharing one
    softmax: the main cache (masked by the horizon-start lengths), the
    ring of rows produced by the previous steps of this horizon (model
    dtype, never quantized), and the current token."""
    cache_k, cache_v = _unpack_kv(cache_k, cache_v)
    b, _, h, d = q.shape
    hkv = k_self.shape[2]
    group = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, 1, hkv, group, d).float()

    lc = torch.einsum('bqhgd,bkhd->bhgqk', qg, cache_k.float()) * scale
    if k_scale is not None:
        lc = lc * _scale_bhk(k_scale)
    lr = torch.einsum('bqhgd,bkhd->bhgqk', qg, ring_k.float()) * scale
    lself = torch.einsum('bqhgd,bqhd->bhgq', qg,
                         k_self.float())[..., None] * scale

    S = cache_k.shape[1]
    pos = torch.arange(S, device=q.device)[None, None, None, None, :]
    lc = torch.where(pos < cache_len.reshape(-1, 1, 1, 1, 1), lc, NEG_INF)
    rpos = torch.arange(ring_k.shape[1],
                        device=q.device)[None, None, None, None, :]
    lr = torch.where(rpos < ring_len, lr, NEG_INF)

    m = torch.maximum(lc.amax(-1, keepdim=True), lr.amax(-1, keepdim=True))
    m = torch.maximum(m, lself)
    ec, er, es = torch.exp(lc - m), torch.exp(lr - m), torch.exp(lself - m)
    denom = (ec.sum(-1, keepdim=True) + er.sum(-1, keepdim=True) + es)
    pc = ec / denom
    out = _cache_pv(pc, cache_v, _scale_bhk(v_scale), q.dtype)
    out = out + torch.einsum('bhgqk,bkhd->bqhgd',
                             (er / denom).to(ring_v.dtype), ring_v)
    w_self = (es / denom)[..., 0].permute(0, 3, 1, 2)   # [b, 1, hkv, g]
    out = out + w_self.to(v_self.dtype)[..., None] * \
        v_self[:, :, :, None, :]
    return out.reshape(b, 1, h, d)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: Optional[torch.Tensor] = None,
    kv_len: Optional[torch.Tensor] = None,
    impl: str = 'auto',
) -> torch.Tensor:
    """Dispatching attention entry point of the models. impl: 'auto' |
    'xla' | 'flash' | 'ring' | 'ulysses'. 'auto' takes the K4 CUDA
    kernel for every causal un-cached attention the kernel supports on
    CUDA (head_dim 64 included, which the reference's TPU rule sends to
    XLA), and the plain path elsewhere (the CPU included, as the
    reference does off the TPU); 'flash' asks for the kernel anywhere
    (the plain version on the CPU); 'xla' is the plain path. The flash
    path carries gradients: its backward runs K5a/K5b on CUDA (the plain
    backward on the CPU).

    Inside a training mesh's step whose sequence splits over sp
    (``mesh.training()``, sp > 1) q/k/v are this rank's sequence block:
    'ring' (``ops/ring_attention.py``) and 'ulysses' (``ops/ulysses.py``)
    run sequence-parallel, as the reference's do on its ambient mesh;
    'xla' gathers the whole k/v over sp and masks by the block's
    offset, the reference's XLA attention over a split sequence; 'auto'
    and 'flash' take the ring, whose blocks run K4 (K5a/K5b in the
    backward) on CUDA. Outside such a mesh 'ring' and 'ulysses' take
    the plain path, as the reference's do without one."""
    if impl not in ('auto', 'xla', 'flash', 'ring', 'ulysses'):
        raise ValueError(f'unknown attention impl {impl!r}')
    uncached = q_offset is None and kv_len is None
    sc = _seq_parallel_scope()
    if sc is not None:
        if not uncached:
            raise ValueError('sequence-parallel attention is a '
                             'full-sequence path; decode masking args are '
                             'not supported')
        if impl == 'ulysses':
            from skypilot_tpu_torch.ops.ulysses import ulysses_attention
            return ulysses_attention(q, k, v, causal=causal)
        if impl == 'xla':
            from skypilot_tpu_torch.parallel import mesh as mesh_lib
            offset = sc.mesh.axis_index('sp') * q.shape[1]
            return reference_attention(
                q, mesh_lib.gather_seq(k), mesh_lib.gather_seq(v),
                causal=causal, q_offset=torch.full(
                    (q.shape[0],), offset, dtype=torch.long,
                    device=q.device))
        from skypilot_tpu_torch.ops.ring_attention import ring_attention
        return ring_attention(q, k, v, causal=causal,
                              block_impl='flash' if impl == 'flash'
                              else 'auto')
    return local_attention(q, k, v, causal=causal, q_offset=q_offset,
                           kv_len=kv_len, impl=impl)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    impl: str = 'auto') -> torch.Tensor:
    """:func:`attention` over the whole of q/k/v as given, never
    sequence-parallel: what Ulysses runs on each rank's heads. 'ring' and
    'ulysses' take the plain path here."""
    uncached = q_offset is None and kv_len is None
    if impl in ('ring', 'ulysses'):
        return reference_attention(q, k, v, causal=causal,
                                   q_offset=q_offset, kv_len=kv_len)
    use_flash = impl == 'flash' or (impl == 'auto' and causal and uncached
                                    and _flash_takes(q, k))
    if use_flash:
        return flash_attention.flash_attention(q, k, v, causal=causal)
    return reference_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len)


def _seq_parallel_scope():
    """The active training mesh's scope when its sequence splits over sp
    (sp > 1), else None."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    sc = mesh_lib.training()
    if sc is None or sc.mesh.axis_size('sp') == 1:
        return None
    return sc
