"""Flash attention: the Hopper kernels' wrappers and their plain
PyTorch versions (port of ``skypilot_tpu/ops/flash_attention.py``:
``flash_attention``, ``_fwd``, ``_fwd_chunk``, ``_bwd`` and the custom
VJP ``_flash_bhsd``).

- :func:`flash_attention_fwd` (``csrc/flash_fwd.cu`` ``skt_flash_fwd``,
  the port of ``_fwd_kernel``, K4) computes causal or full attention over
  model-layout tensors and returns the output and the logsumexp.
- :func:`flash_attention_bwd_dkv` and :func:`flash_attention_bwd_dq`
  (``csrc/flash_bwd.cu`` ``skt_flash_bwd_dkv``/``skt_flash_bwd_dq``, the
  ports of ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``, K5a and K5b)
  compute the FA-2 backward from the saved logsumexp; K5a sums dk/dv
  over each kv head's query-head group itself.
- :class:`_FlashAttention` is the ``torch.autograd.Function`` around
  them (the counterpart of ``_flash_bhsd``): K4 forward, K5a + K5b
  backward on CUDA, the plain versions on the CPU.
- :func:`flash_chunk_attention` (``skt_flash_fwd_chunk``, the port of
  ``_fwd_chunk_kernel``, K3) computes a prefill chunk against a per-row
  cache prefix; it takes the cache and the chunk as two operands, so the
  ``[cache; chunk]`` concatenation of the reference is never built. It
  is forward-only, as the reference's chunk path is.
- :func:`flash_attention` keeps the reference's signature and checks
  (``cache_len``/``kv_split`` select K3 on a concatenated kv; otherwise
  the differentiable K4/K5 path).

Layout [b, s, h, d], GQA with ``hkv | hq`` (kv head ``h // (hq // hkv)``,
no repeat). The kernels read their operands through strides (the last
axis contiguous) and mask ragged edges themselves, so the reference's
TPU block-size rules (512 -> 128 shrinking, 8-aligned blocks) have no
counterpart here.

Each wrapper takes the plain version only for tensors that lie on the
CPU. For CUDA tensors it launches its kernel or raises: there is no
fallback on build or launch failure.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops.paged_attention import (KERNEL_HEAD_DIMS,
                                                    KERNEL_MAX_GROUP,
                                                    _device_or_plain,
                                                    kernel_supports)

# The reference's DEFAULT_MASK_VALUE: finite, so a fully masked block
# never produces inf - inf.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# Kernel launches per entry point (K4, K3, K5a, K5b), counted where the
# kernel is launched and nowhere else (CPU calls of the plain versions
# do not count).
launch_counts: Dict[str, int] = {'flash_fwd': 0, 'flash_fwd_chunk': 0,
                                  'flash_bwd_dkv': 0, 'flash_bwd_dq': 0}
# K3's launches by query rows (chunk width, or k + 1 in a speculative
# verify round), counted beside ``launch_counts['flash_fwd_chunk']``.
chunk_launches_by_sq: Dict[int, int] = {}

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
# The C entry points' stride arrays: (batch, seq, head) of 6 operands
# (forward) or 7 (backward).
_STRIDES18 = ctypes.c_longlong * 18
_STRIDES21 = ctypes.c_longlong * 21


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    chunk_launches_by_sq.clear()


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------
def _masked_softmax_av(q, k, v, valid, scale):
    """softmax(q.k^T * scale, masked) . v in fp32, GQA grouped: q [b, sq,
    hq, d], k/v [b, skv, hkv, d], valid broadcastable to [b, 1, 1, sq,
    skv]. Returns (out [b, sq, hq, d] in q's dtype, lse [b, hq, sq])."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum('bqhgd,bkhd->bhgqk', qg, k.float()) * scale
    s = torch.where(valid, s, DEFAULT_MASK_VALUE)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    acc = torch.einsum('bhgqk,bkhd->bhgqd', p, v.float())
    out = (acc / l_safe).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    lse = (m + torch.log(l_safe))[..., 0].reshape(b, hq, sq)
    return out.to(q.dtype), lse


def _causal_valid(sq: int, skv: int, causal: bool, device) -> torch.Tensor:
    """[1, 1, 1, sq, skv] validity of (q, k) pairs."""
    if not causal:
        return torch.ones((1, 1, 1, sq, skv), dtype=torch.bool,
                          device=device)
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    return (k_pos <= q_pos)[None, None, None]


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: (out [b, sq, hq, d] in q's dtype,
    lse [b, hq, sq] fp32), one fp32 softmax over all kv rows with the
    reference's finite mask value."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    valid = _causal_valid(q.shape[1], k.shape[1], causal, q.device)
    return _masked_softmax_av(q, k, v, valid, scale)


def flash_chunk_reference(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, cache_len: torch.Tensor,
                          kv_split: int, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of K3 over k/v laid out as
    ``[cache(:kv_split); chunk]``: row j < kv_split is valid iff j <
    cache_len[b], chunk row j is valid iff j - kv_split <= the q row's
    chunk-local index. Returns [b, sq, hq, d] in q's dtype."""
    sq, skv = q.shape[1], k.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    j = torch.arange(skv, device=q.device)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    cache_ok = j[None, :] < cache_len.to(q.device).long()[:, None]  # [b, skv]
    chunk_ok = (j[None, :] - kv_split) <= q_pos                     # [sq, skv]
    valid = torch.where((j < kv_split)[None, None, :], cache_ok[:, None, :],
                        chunk_ok[None])                         # [b, sq, skv]
    return _masked_softmax_av(q, k, v, valid[:, None, None], scale)[0]


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(out * do) in fp32, [b, hq, sq] (the reference's
    ``_bwd`` computes it outside its kernels; it stays one plain op)."""
    return (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_plain(q, k, v, do, lse, delta, causal, scale):
    """The backward in fp32 from the logsumexp, GQA grouped: p =
    exp(s - lse) with the finite mask, dv = p^T do, ds = p (dp - delta)
    scale, dk = ds^T q, dq = ds k; dk/dv summed over each group in
    fp32. Returns (dq in q's dtype, dk, dv in k's dtype)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.float().reshape(b, sq, hkv, g, d)
    dog = do.float().reshape(b, sq, hkv, g, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum('bqhgd,bkhd->bhgqk', qg, kf) * scale
    s = torch.where(_causal_valid(sq, skv, causal, q.device), s,
                    DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse.reshape(b, hkv, g, sq)[..., None])
    dv = torch.einsum('bhgqk,bqhgd->bkhd', p, dog)
    dp = torch.einsum('bqhgd,bkhd->bhgqk', dog, vf)
    ds = p * (dp - delta.reshape(b, hkv, g, sq)[..., None]) * scale
    dk = torch.einsum('bhgqk,bqhgd->bkhd', ds, qg)
    dq = torch.einsum('bhgqk,bkhd->bqhgd', ds, kf).reshape(b, sq, hq, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor, *,
                                  causal: bool = True,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch version of the backward (K5a and K5b together):
    q/out/do [b, sq, hq, d], k/v [b, skv, hkv, d], lse [b, hq, sq] fp32
    -> (dq, dk, dv), recomputing p from lse in fp32 as the kernels do."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _bwd_plain(q, k, v, do, lse, attention_delta(out, do), causal,
                      scale)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------
def _bind(lib: ctypes.CDLL, fn_name: str, n_ptr: int, n_int: int) -> None:
    """Declare an entry point's argument list: ``n_ptr`` device
    pointers, the host stride array, ``n_int`` ints, the softmax scale,
    the dtype code and the stream."""
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * n_ptr + [ctypes.POINTER(ctypes.c_longlong)]
                       + [i32] * n_int + [ctypes.c_float, i32, ptr])
        fn.restype = ctypes.c_int
        lib.skt_error_string.argtypes = [ctypes.c_int]
        lib.skt_error_string.restype = ctypes.c_char_p


def _check_operands(q: torch.Tensor, **kv: torch.Tensor):
    """Raise on anything the kernels do not take; returns the stride
    array (batch, seq, head of every operand, in the given order, then
    zeros) and the dtype code."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f'q dtype {q.dtype}: the kernel takes bf16 or fp32')
    b, _, hq, d = q.shape
    hkv = next(iter(kv.values())).shape[2]
    if not kernel_supports(d, hq, hkv):
        raise ValueError(
            f'kernel takes head_dim in {KERNEL_HEAD_DIMS} and up to '
            f'{KERNEL_MAX_GROUP} query heads per kv head; got d={d}, '
            f'hq={hq}, hkv={hkv}')
    vec = 16 // q.element_size()
    dev, dtype = q.device, q.dtype
    strides = []
    for name, t in (('q', q),) + tuple(kv.items()):
        # Shape and strides read once: this runs on the host per launch.
        shape, st = t.shape, t.stride()
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, q on {dev}')
        if t.dtype != dtype:
            raise ValueError(f'{name} dtype {t.dtype} != q dtype {dtype}')
        if len(shape) != 4 or shape[0] != b or shape[3] != d:
            raise ValueError(f'{name} shape {tuple(shape)} does not match '
                             f'q {tuple(q.shape)}')
        if (st[3] != 1 or st[0] % vec or st[1] % vec or st[2] % vec
                or t.data_ptr() % 16):
            raise ValueError(f'{name} needs a contiguous head_dim, strides '
                             f'in multiples of {vec} and 16-byte alignment')
        strides += st[:3]
    return strides, _DTYPE_CODES[dtype]


def _stride_array(strides, out: torch.Tensor):
    """18 strides: the operands', zeros up to five operands, then out's."""
    vals = strides + [0] * (15 - len(strides)) + list(out.stride()[:3])
    return _STRIDES18(*vals)


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f'{name} kernel launch failed: '
                           + lib.skt_error_string(rc).decode())


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with the logsumexp (the counterpart of ``_fwd``):
    q [b, sq, hq, d], k/v [b, skv, hkv, d] -> (out [b, sq, hq, d] in q's
    dtype, lse [b, hq, sq] fp32). CPU tensors run the plain version;
    CUDA tensors launch ``csrc/flash_fwd.cu`` (K4) or raise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_or_plain(q, 'flash_attention_fwd'):
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    strides, code = _check_operands(q, k=k, v=v)
    if k.shape != v.shape:
        raise ValueError(f'k {tuple(k.shape)} and v {tuple(v.shape)} differ')
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    lib = _build.load('flash_fwd')
    _bind(lib, 'skt_flash_fwd', 5, 7)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.skt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _stride_array(strides, out), b, hq, hkv, sq, skv,
        d, int(bool(causal)), float(scale), code, stream)
    _raise_on(lib, rc, 'flash_fwd')
    launch_counts['flash_fwd'] += 1
    return out, lse


def flash_chunk_attention(q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, cache_len: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """A prefill chunk (q, k_new, v_new [b, sq, h(kv), d]) against each
    row's cache prefix (cache_k/v [b, S, hkv, d], valid below
    cache_len [b]) plus causal attention within the chunk: K3 on two
    operands. Returns [b, sq, hq, d] in q's dtype. CPU tensors run the
    plain version; CUDA tensors launch ``csrc/flash_fwd.cu`` or raise.
    Forward-only, as the reference's chunk path is: raises when an input
    requires grad."""
    if any(t.requires_grad for t in (q, k_new, v_new, cache_k, cache_v)):
        raise ValueError('the chunked-prefill flash path is forward-only; '
                         'its inputs must not require grad')
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_or_plain(q, 'flash_chunk_attention'):
        return flash_chunk_reference(
            q, torch.cat([cache_k.to(k_new.dtype), k_new], 1),
            torch.cat([cache_v.to(v_new.dtype), v_new], 1), cache_len,
            cache_k.shape[1], scale=scale)
    strides, code = _check_operands(q, cache_k=cache_k, cache_v=cache_v,
                                    k_new=k_new, v_new=v_new)
    b, sq, hq, d = q.shape
    split, hkv = cache_k.shape[1], cache_k.shape[2]
    if (cache_v.shape != cache_k.shape or k_new.shape != (b, sq, hkv, d)
            or v_new.shape != k_new.shape):
        raise ValueError(
            f'cache {tuple(cache_k.shape)}/{tuple(cache_v.shape)} and chunk '
            f'{tuple(k_new.shape)}/{tuple(v_new.shape)} rows do not match q '
            f'{tuple(q.shape)}')
    if (cache_len.device != q.device or cache_len.dtype != torch.int32
            or tuple(cache_len.shape) != (b,)
            or not cache_len.is_contiguous()):
        raise ValueError(f'cache_len must be a contiguous int32 [{b}] tensor '
                         f'on {q.device}')
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _build.load('flash_fwd')
    _bind(lib, 'skt_flash_fwd_chunk', 7, 6)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.skt_flash_fwd_chunk(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), cache_len.data_ptr(),
        out.data_ptr(), _stride_array(strides, out), b, hq, hkv, sq,
        split, d, float(scale), code, stream)
    _raise_on(lib, rc, 'flash_fwd_chunk')
    launch_counts['flash_fwd_chunk'] += 1
    chunk_launches_by_sq[sq] = chunk_launches_by_sq.get(sq, 0) + 1
    return out


def _bwd_launch(which: str, q, k, v, do, lse, delta, causal, scale):
    """Check the operands and launch K5a (``which='dkv'``, returns (dk,
    dv)) or K5b (``'dq'``, returns dq)."""
    strides, code = _check_operands(q, k=k, v=v, do=do)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or do.shape != q.shape:
        raise ValueError(f'k {tuple(k.shape)}, v {tuple(v.shape)} and do '
                         f'{tuple(do.shape)} do not match q {tuple(q.shape)}')
    if causal and sq != skv:
        raise ValueError(f'causal backward assumes sq == skv (got {sq} vs '
                         f'{skv})')
    for name, t in (('lse', lse), ('delta', delta)):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (b, hq, sq) or not t.is_contiguous()):
            raise ValueError(f'{name} must be a contiguous fp32 [{b}, {hq}, '
                             f'{sq}] tensor on {q.device}')
    lib = _build.load('flash_bwd')
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if which == 'dkv':
        dk = torch.empty_like(k, memory_format=torch.contiguous_format)
        dv = torch.empty_like(v, memory_format=torch.contiguous_format)
        outs = [0] * 3 + list(dk.stride()[:3]) + list(dv.stride()[:3])
        _bind(lib, 'skt_flash_bwd_dkv', 8, 7)
        rc = lib.skt_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _STRIDES21(*(strides + outs)), b, hq, hkv, sq,
            skv, d, int(bool(causal)), float(scale), code, stream)
        _raise_on(lib, rc, 'flash_bwd_dkv')
        launch_counts['flash_bwd_dkv'] += 1
        return dk, dv
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    outs = list(dq.stride()[:3]) + [0] * 6
    _bind(lib, 'skt_flash_bwd_dq', 7, 7)
    rc = lib.skt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _STRIDES21(*(strides + outs)), b, hq, hkv, sq, skv, d,
        int(bool(causal)), float(scale), code, stream)
    _raise_on(lib, rc, 'flash_bwd_dq')
    launch_counts['flash_bwd_dq'] += 1
    return dq


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor, *,
                            causal: bool = True,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv [b, skv, hkv, d] in k's dtype, summed over each kv head's
    query-head group, from q/do [b, sq, hq, d], k/v and the fp32 lse and
    delta [b, hq, sq]. CPU tensors run the plain version; CUDA tensors
    launch ``csrc/flash_bwd.cu`` (K5a) or raise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_or_plain(q, 'flash_attention_bwd_dkv'):
        return _bwd_plain(q, k, v, do, lse, delta, causal, scale)[1:]
    return _bwd_launch('dkv', q, k, v, do, lse, delta, causal, scale)


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor, *,
                           causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """dq [b, sq, hq, d] in q's dtype (operands as for
    :func:`flash_attention_bwd_dkv`). CPU tensors run the plain version;
    CUDA tensors launch ``csrc/flash_bwd.cu`` (K5b) or raise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_or_plain(q, 'flash_attention_bwd_dq'):
        return _bwd_plain(q, k, v, do, lse, delta, causal, scale)[0]
    return _bwd_launch('dq', q, k, v, do, lse, delta, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the counterpart of the
    reference's ``_flash_bhsd`` with ``_flash_fwd_rule`` and
    ``_flash_bwd_rule``): K4 forward saving (q, k, v, out, lse); K5a and
    K5b backward (for CPU tensors, the plain backward once). A kernel
    whose gradients no input asks for is not launched (K5a when neither
    k nor v needs one, K5b when q does not: a LoRA step's first layer
    with adapters on q alone)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == 'cpu':
            return flash_attention_bwd_reference(
                q, k, v, out, lse, do, causal=ctx.causal,
                scale=ctx.scale) + (None, None)
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        delta = attention_delta(out, do)
        dq = dk = dv = None
        if need_k or need_v:
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                             causal=ctx.causal,
                                             scale=ctx.scale)
        if need_q:
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                        causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    cache_len: Optional[torch.Tensor] = None,
                    kv_split: Optional[int] = None) -> torch.Tensor:
    """Flash attention over model-layout tensors, with the reference's
    signature and checks: q [b, sq, hq, d], k/v [b, skv, hkv, d] ->
    [b, sq, hq, d]. With ``cache_len`` and ``kv_split`` the kv rows are
    ``[cache(:kv_split); chunk]`` and the chunk path (K3, forward-only)
    runs on views of the two parts; otherwise K4, differentiable through
    K5a/K5b (:class:`_FlashAttention`)."""
    sq, hq = q.shape[1], q.shape[2]
    skv, hkv = k.shape[1], k.shape[2]
    if hq % hkv != 0:
        raise ValueError(f'GQA requires hkv ({hkv}) to divide hq ({hq})')
    if cache_len is not None or kv_split is not None:
        if cache_len is None or kv_split is None:
            raise ValueError('cache_len and kv_split must be passed '
                             'together')
        if not causal:
            raise ValueError('chunked-prefill flash is causal only')
        if skv != kv_split + sq:
            raise ValueError(
                f'kv must be [cache({kv_split}); chunk({sq})] rows, got '
                f'skv={skv}')
        return flash_chunk_attention(
            q, k[:, kv_split:], v[:, kv_split:], k[:, :kv_split],
            v[:, :kv_split], cache_len, scale=scale)
    if causal and sq != skv:
        raise ValueError(
            f'causal flash kernel assumes sq == skv (got {sq} vs {skv}); '
            'use ops.attention with q_offset for cached prefill/decode')
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, scale)
