"""Weight-only int8 and int4 quantization for serving, the W8A8/W4A8
prefill path, and the int4 nibble layout (port of
``skypilot_tpu/models/quantization.py``).

Quantized leaves are named tuples of tensors. ``QuantizedWeight(int8,
scale)``: symmetric per-output-channel codes ``clamp(round(w / scale),
-127, 127)`` with ``scale = absmax / 127`` over the contracted axes, the
scale stored in the weight's dtype. ``QuantizedWeight4(packed, scale)``:
codes ``clamp(round(w / scale), -7, 7)`` with ``scale = absmax / 7`` per
output channel, or per :func:`int4_group_size` slice of the LAST
contracted axis, packed two per byte along that axis. In both the scale
is rounded to its dtype first, so the codes are computed against the
exact scale dequantization multiplies by. :func:`qeinsum` contracts the
codes and applies per-channel scales to the (small) output in fp32;
group scales weight fp32 group partials. MoE expert leaves stay int8 in
int4 mode: ``models/moe.py`` contracts them through :func:`deq`, which
cannot know a packed leaf's contraction.

W8A8 (:func:`w8a8_region`, prefill only): inside the region
:func:`qeinsum` also quantizes the activation rows (:func:`quantize_rows`)
and contracts int8 codes against int8 codes into int32
(:func:`int8_matmul`: cuBLASLt's int8 GEMM through ``torch._int_mm`` on
CUDA, the int32 product on the CPU); both scales fold into the fp32
output. Per-channel int4 weights take the same path after their unpack
(W4A8); group-wise int4 and unquantized weights ignore the region.
cuBLASLt's int8 GEMM is several times faster with the weight codes
column-major (``chip_smoke.py``'s ``w8a8_check`` times both layouts), so
an engine serving W8A8 prefill on CUDA stores its int8 layer codes that
way once, at load (:func:`relayout_codes_for_int8_matmul`).

int4 nibble layout (the one place it is defined in the port): two codes
in [-8, 7] per uint8 byte along an even axis, byte ``j`` = code ``2j`` in
its low nibble | code ``2j+1`` in its high nibble; unpacking
sign-extends. The KV pool packs along head_dim with it, int4 weights
along their last contracted axis.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, NamedTuple, Optional

import torch

from skypilot_tpu_torch.ops import cost
from skypilot_tpu_torch.parallel import mesh as mesh_lib

Params = Dict[str, Any]


class QuantizedWeight(NamedTuple):
    int8: torch.Tensor        # same shape as the original weight
    scale: torch.Tensor       # original shape with contracted dims = 1

    @property
    def shape(self):
        return self.int8.shape

    @property
    def dtype(self):          # the COMPUTE dtype consumers see after deq
        return self.scale.dtype


class QuantizedWeight4(NamedTuple):
    """int4 weight leaf: ``packed`` is uint8 in the original weight's
    shape with the last contracted axis halved (two codes a byte);
    ``scale`` is the original shape with contracted dims = 1, except the
    last contracted axis, which is the group count under group scales
    (1 = per output channel)."""
    packed: torch.Tensor
    scale: torch.Tensor

    @property
    def dtype(self):          # the COMPUTE dtype consumers see
        return self.scale.dtype


QUANT_LEAF_TYPES = (QuantizedWeight, QuantizedWeight4)

# Leaves quantized to int4 in int4 mode; the MoE expert leaves stay int8
# (see the module docstring).
INT4_LEAVES = ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down',
               'unembed')


def int4_group_size() -> int:
    """Group size along the last contracted axis for int4 scales, from
    ``SKYTPU_INT4_GROUP`` (the reference's variable); 0 (default) = one
    scale per output channel. Read at quantize time only."""
    return max(0, int(os.environ.get('SKYTPU_INT4_GROUP', '0') or 0))


def pack_int4(codes: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack int8 codes in [-8, 7] two per byte along ``axis`` (even
    sized); returns uint8 with ``axis`` halved."""
    axis = axis % codes.dim()
    if codes.shape[axis] % 2:
        raise ValueError(f'int4 pack axis must be even-sized, got shape '
                         f'{tuple(codes.shape)} axis {axis}')
    bits = codes.view(torch.uint8)            # two's complement bytes
    lo = torch.index_select(bits, axis, torch.arange(
        0, codes.shape[axis], 2, device=codes.device)) & 0xF
    hi = torch.index_select(bits, axis, torch.arange(
        1, codes.shape[axis], 2, device=codes.device)) & 0xF
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: uint8 bytes -> sign-extended int8
    codes with ``axis`` doubled (low nibble first)."""
    ax = axis % packed.dim()
    lo = (packed & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = (packed >> 4).to(torch.int8)
    hi = torch.where(hi >= 8, hi - 16, hi)
    st = torch.stack([lo, hi], dim=ax + 1)
    shape = (packed.shape[:ax] + (packed.shape[ax] * 2,)
             + packed.shape[ax + 1:])
    return st.reshape(shape)


_a8_region = threading.local()

# ``torch._int_mm`` launches (cuBLASLt int8 GEMMs), by name. CUDA graph
# replays add what their capture recorded (``inference/graphs.py``).
launch_counts: Dict[str, int] = {'int_mm': 0}

# cuBLASLt's int8 GEMM needs more than this many rows.
_INT_MM_MIN_ROWS = 17


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@contextlib.contextmanager
def w8a8_region(active: bool = True):
    """While active on this thread, :func:`qeinsum` on a quantized weight
    also quantizes the activation rows (symmetric int8 per row) and
    contracts int8 x int8 into int32. Serving enters it around the layer
    loop of prefill only; decode stays W8A16. Thread-local, as the
    server's engine loop runs on its own thread; a CUDA graph captured
    inside the region keeps the int8 path. ``active=False`` changes
    nothing, so callers pass their option straight in."""
    prev = getattr(_a8_region, 'active', False)
    _a8_region.active = prev or active
    try:
        yield
    finally:
        _a8_region.active = prev


def w8a8_active() -> bool:
    return getattr(_a8_region, 'active', False)


def quantize_rows(x: torch.Tensor, row_split: Optional[str] = None):
    """``[..., k]`` rows -> (int8 codes, ``[..., 1]`` fp32 scales):
    ``scale = max(absmax, 1e-8) / 127`` per row, codes ``clamp(round(x /
    scale), -127, 127)`` with round half to even, computed in fp32 (the
    reference's activation quantizer and its KV row quantizer). Both
    divisions are true divisions on every device: CUDA divides by a
    Python scalar as a multiply by its reciprocal, which can differ in
    the last bit, so the 127 is a tensor.

    ``row_split`` names the logical axis a serving mesh splits the rows'
    ``k`` over (a row-parallel product's input): each rank holds a part
    of every row, so the absmax is all-reduced with MAX over tp first,
    and the scales are the whole rows' exactly."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    if row_split is not None:
        amax = mesh_lib.reduce_max(amax, row_split)
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """``x8 [..., k] @ w8 [k, n]``, int8 codes into an exact int32
    product. On CUDA it is one ``torch._int_mm`` (cuBLASLt) or it raises:
    ``k`` and ``n`` must be multiples of 8, and fewer than 17 rows are
    padded with zero rows, which leave the real rows' products as they
    are. On the CPU it is the int32 product."""
    k, n = w8.shape
    lead = x8.shape[:-1]
    a = x8.reshape(-1, k)
    if cost.device_type(a) != 'cuda':
        return (a.int() @ w8.int()).reshape(lead + (n,))
    if k % 8 or n % 8:
        raise ValueError(f'the int8 GEMM needs k and n multiples of 8, '
                         f'got k={k} n={n}')
    m = a.shape[0]
    if m < _INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros((_INT_MM_MIN_ROWS - m, k))])
    y = torch._int_mm(a, w8)
    if a.device.type == 'cuda':
        launch_counts['int_mm'] += 1
    return y[:m].reshape(lead + (n,))


def _w8a8_product(x2: torch.Tensor, codes: torch.Tensor,
                  scale: torch.Tensor,
                  row_split: Optional[str] = None) -> torch.Tensor:
    """The W8A8 contraction: ``x2 [..., k]`` quantized per row
    (``row_split``: :func:`quantize_rows`), int8 x int8 -> int32, then
    ``int32 -> fp32``, times the row scale, times the per-channel
    ``scale``, in that order (fp32)."""
    x8, xscale = quantize_rows(x2, row_split)
    y = int8_matmul(x8, codes).float() * xscale
    return y * scale.reshape(-1).float()


def deq(w):
    """Dequantize if quantized (codes times scale, rounded in the
    scale's dtype); identity otherwise. int4 leaves are refused: their
    packed axis is the contraction's, which only :func:`qeinsum` sees."""
    if isinstance(w, QuantizedWeight):      # one widened copy, scaled
        return w.int8.to(w.scale.dtype).mul_(w.scale)      # in place
    if isinstance(w, QuantizedWeight4):
        raise TypeError('QuantizedWeight4 leaves dequantize only inside '
                        'qeinsum (the packed axis is contraction-specific)')
    return w


class _MatmulF32(torch.autograd.Function):
    """``x [m, k] @ w [k, n]`` of two CUDA tensors of one 16-bit dtype,
    with an fp32 product (cuBLAS's ``out_dtype``, which has no autograd
    formula of its own). The backward multiplies in the operands' dtype
    with fp32 accumulation."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w.t() if ctx.needs_input_grad[0] else None
        gw = x.t() @ g if ctx.needs_input_grad[1] else None
        return gx, gw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., k] @ w [k, n]`` as an fp32 product, the reference's
    ``preferred_element_type=float32``: bf16/fp16 operands on CUDA go
    through one cuBLAS matmul with fp32 output; anything else multiplies
    in fp32."""
    if (cost.device_type(x) != 'cuda' or x.dtype != w.dtype
            or x.dtype == torch.float32):
        return torch.matmul(x.float(), w.float())
    lead = x.shape[:-1]
    return _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w).reshape(
        lead + (w.shape[-1],))


def qeinsum(eq: str, x: torch.Tensor, w, *,
            out_dtype: Optional[torch.dtype] = None,
            row_split: Optional[str] = None) -> torch.Tensor:
    """``einsum(eq, x, w)`` for the model's weight patterns, whose
    contracted axes lead ``w`` and close ``x`` ('bsd,dhk->bshk',
    'bshk,hkd->bsd', 'bsd,df->bsf', 'bsf,fd->bsd', 'bsd,dv->bsv'), as
    one matmul.

    Plain weights multiply in their dtype, or into an fp32 product
    (:func:`matmul_f32`) when ``out_dtype`` is fp32. A ``QuantizedWeight``
    contracts its codes into an fp32 product (the reference's
    ``preferred_element_type=float32``), scales it per channel in fp32,
    then casts to ``out_dtype`` (default x's dtype). fp32 activations
    and every CPU call multiply in fp32; bf16/fp16 activations on CUDA
    widen the codes to x's dtype for one cuBLAS matmul with fp32
    accumulation and fp32 output, which materialises that widened copy
    per call. A ``QuantizedWeight4`` goes through :func:`_qeinsum4`.

    Inside :func:`w8a8_region` a ``QuantizedWeight`` contracts the
    activation's int8 row codes instead (:func:`_w8a8_product`); a
    row-parallel product under a serving mesh names the logical axis its
    contraction is split over (``row_split``: 'heads' for ``wo``, 'mlp'
    for ``w_down``), so the row scales span the tp shards."""
    ins, _ = eq.split('->')
    xs, ws = ins.split(',')
    nc = sum(c in xs for c in ws)
    if xs[-nc:] != ws[:nc]:
        raise ValueError(f'unsupported qeinsum pattern {eq!r}')
    if isinstance(w, QuantizedWeight4):
        return _qeinsum4(x, w, nc, out_dtype, row_split)
    wshape = w.shape
    k = 1
    for s in wshape[:nc]:
        k *= s
    batch_shape = x.shape[:x.dim() - nc]
    out_shape = batch_shape + tuple(wshape[nc:])
    x2 = x.reshape(batch_shape + (k,))
    if not isinstance(w, QuantizedWeight):
        if out_dtype == torch.float32:
            return matmul_f32(x2, w.reshape(k, -1)).reshape(out_shape)
        y = torch.matmul(x2, w.reshape(k, -1))
        if out_dtype is not None:
            y = y.to(out_dtype)
        return y.reshape(out_shape)
    if w8a8_active():
        y = _w8a8_product(x2, w.int8.reshape(k, -1), w.scale, row_split)
    else:
        y = _codes_matmul(x2, w.int8.reshape(k, -1))
        y = y * w.scale.reshape(-1).float()
    return y.to(out_dtype if out_dtype is not None else x.dtype
                ).reshape(out_shape)


def _codes_matmul(x2: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``x2 [..., k] @ codes [k, n]`` as an fp32 product: fp32
    activations and every CPU call multiply in fp32; bf16/fp16 on CUDA
    widen the codes to x's dtype for one cuBLAS matmul with fp32
    output."""
    if cost.device_type(x2) == 'cpu' or x2.dtype == torch.float32:
        return torch.matmul(x2.float(), codes.float())
    k = x2.shape[-1]
    return torch.mm(x2.reshape(-1, k), codes.to(x2.dtype),
                    out_dtype=torch.float32).reshape(x2.shape[:-1] + (-1,))


def _qeinsum4(x: torch.Tensor, w: QuantizedWeight4, nc: int,
              out_dtype: Optional[torch.dtype],
              row_split: Optional[str] = None) -> torch.Tensor:
    """The int4 contraction behind :func:`qeinsum`: the packed ``[k/2,
    n]`` bytes unpack to ``[k, n]`` codes (pairs along the last
    contracted axis are adjacent in the flattened k order). Per-channel
    scales fold into the fp32 product (inside :func:`w8a8_region`, the
    W4A8 product of the activation's int8 row codes); group scales
    contract each group separately and sum the scale-weighted fp32
    partials, region or not."""
    kp = 1
    for d in w.packed.shape[:nc]:
        kp *= d
    k = kp * 2
    n = 1
    for d in w.packed.shape[nc:]:
        n *= d
    batch_shape = x.shape[:x.dim() - nc]
    out_shape = batch_shape + tuple(w.packed.shape[nc:])
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    x2 = x.reshape(batch_shape + (k,))
    G = 1
    for d in w.scale.shape[:nc]:
        G *= d
    if G == 1 and w8a8_active():
        # Unpacked from the transposed bytes, so the [k, n] codes come
        # out column-major: cuBLASLt's fast int8 layout.
        codes = unpack_int4(w.packed.reshape(kp, n).t(), axis=1).t()
        y = _w8a8_product(x2, codes, w.scale, row_split)
        return y.to(out_dtype).reshape(out_shape)
    codes = unpack_int4(w.packed.reshape(kp, n), axis=0)
    if G == 1:
        y = _codes_matmul(x2, codes) * w.scale.reshape(n).float()
        return y.to(out_dtype).reshape(out_shape)
    last = w.packed.shape[nc - 1] * 2
    g = last // G
    other = k // last
    kg = other * G
    xb = x2.reshape(-1, kg, g).transpose(0, 1)          # [kg, B, g]
    wg = codes.reshape(kg, g, n)
    if cost.device_type(x) == 'cpu' or x.dtype == torch.float32:
        y = torch.bmm(xb.float(), wg.float())             # [kg, B, n]
    else:
        y = torch.bmm(xb, wg.to(x.dtype), out_dtype=torch.float32)
    sflat = w.scale.reshape(1, G, n).expand(other, G, n).reshape(kg, 1, n)
    y = (y * sflat.float()).sum(0)
    return y.to(out_dtype).reshape(out_shape)


def quantize_array(w: torch.Tensor, reduce_axes,
                   scale_dtype: Optional[torch.dtype] = None
                   ) -> QuantizedWeight:
    """Symmetric per-channel int8: scale = absmax/127 over the
    contracting axes, stored in ``scale_dtype`` (default ``w``'s dtype).
    The scale is rounded to that dtype FIRST, so the codes are computed
    against the exact scale dequantization multiplies by."""
    wf = w.float()
    absmax = wf.abs().amax(dim=tuple(reduce_axes), keepdim=True)
    scale = (torch.clamp(absmax, min=1e-8) / 127.0).to(
        scale_dtype or w.dtype)
    q = torch.clamp(torch.round(wf / scale.float()), -127, 127)
    return QuantizedWeight(int8=q.to(torch.int8), scale=scale)


def quantize_array4(w: torch.Tensor, reduce_axes, group: int = 0,
                    scale_dtype: Optional[torch.dtype] = None
                    ) -> QuantizedWeight4:
    """Symmetric 4-bit: scale = absmax/7 over the contracting axes (per
    output channel), or per ``group``-sized slice of the LAST
    contracting axis; codes pack two a byte along that axis. The scale
    is rounded to ``scale_dtype`` (default ``w``'s dtype) first, as in
    :func:`quantize_array`."""
    reduce_axes = tuple(a % w.dim() for a in reduce_axes)
    ax = reduce_axes[-1]
    m = w.shape[ax]
    wf = w.float()
    sdt = scale_dtype or w.dtype
    if group:
        if m % group or group % 2:
            raise ValueError(f'SKYTPU_INT4_GROUP={group} must be even and '
                             f'divide the packed axis (size {m})')
        G = m // group
        wf_g = wf.reshape(w.shape[:ax] + (G, group) + w.shape[ax + 1:])
        red = tuple(a if a < ax else a + 1
                    for a in reduce_axes[:-1]) + (ax + 1,)
        absmax = wf_g.abs().amax(dim=red, keepdim=True)
        scale = (torch.clamp(absmax, min=1e-8) / 7.0).to(sdt)
        q = torch.clamp(torch.round(wf_g / scale.float()), -7, 7).to(
            torch.int8).reshape(w.shape)
        sshape = tuple(1 if a in reduce_axes else d
                       for a, d in enumerate(w.shape))
        scale = scale.reshape(sshape[:ax] + (G,) + sshape[ax + 1:])
    else:
        absmax = wf.abs().amax(dim=reduce_axes, keepdim=True)
        scale = (torch.clamp(absmax, min=1e-8) / 7.0).to(sdt)
        q = torch.clamp(torch.round(wf / scale.float()), -7, 7).to(
            torch.int8)
    return QuantizedWeight4(packed=pack_int4(q, axis=ax), scale=scale)


# Contracting axes per leaf (axis 0 of a layer leaf is the layer stack
# and is never contracted).
REDUCE_AXES = {
    'wq': (1,),          # [L, d, h, hd]   contract d
    'wk': (1,),
    'wv': (1,),
    'wo': (1, 2),        # [L, h, hd, d]   contract h, hd
    'w_gate': (1,),      # [L, d, f]       contract d
    'w_up': (1,),
    'w_down': (1,),      # [L, f, d]       contract f
    'moe_gate': (2,),    # [L, E, d, f]    contract d
    'moe_up': (2,),
    'moe_down': (2,),    # [L, E, f, d]    contract f
    'unembed': (0,),     # [d, V]          contract d
}


def quantize_slice(key: str, w: torch.Tensor, mode: str = 'int8',
                   group: int = 0,
                   scale_dtype: Optional[torch.dtype] = None):
    """Quantize ``w``, leaf ``key`` whole (``unembed``) or one layer's
    slice of a stacked leaf (the stack axis dropped): int4 for the
    :data:`INT4_LEAVES` under ``mode='int4'``, int8 otherwise."""
    axes = REDUCE_AXES[key]
    if key != 'unembed':
        axes = tuple(a - 1 for a in axes)
    if mode == 'int4' and key in INT4_LEAVES:
        return quantize_array4(w, axes, group, scale_dtype)
    return quantize_array(w, axes, scale_dtype)


def quantize_stacked(key: str, slices, n_layers: int, mode: str = 'int8',
                     group: int = 0, cut=None):
    """Layer-stacked leaf ``key`` quantized one layer slice at a time
    from the iterable ``slices`` (each slice quantized and dropped
    before the next is made, so the fp32 transient is one layer's);
    ``cut(q)`` keeps a part of each quantized slice (a mesh rank's
    shard)."""
    out = None
    for li, w in enumerate(slices):
        q = quantize_slice(key, w, mode, group)
        if cut is not None:
            q = cut(q)
        if out is None:
            out = type(q)(*(torch.empty((n_layers,) + tuple(t.shape),
                                        dtype=t.dtype, device=t.device)
                            for t in q))
        for dst, t in zip(out, q):
            dst[li] = t
    return out


def _quantize_leaf(key: str, w: torch.Tensor, mode: str = 'int8',
                   group: int = 0):
    """Quantize one leaf; a layer-stacked leaf goes one layer at a time
    (its reduce axes exclude the stack axis)."""
    if key == 'unembed':
        return quantize_slice(key, w, mode, group)
    return quantize_stacked(key, w, w.shape[0], mode, group)


def quantize_params(params: Params, *, donate: bool = False,
                    mode: str = 'int8') -> Params:
    """Quantize the matmul weights (:data:`REDUCE_AXES`) of a llama
    parameter dict; embeddings, norms, the router and q/k/v biases stay
    as they are (a tied ``embed`` is the unembedding too, and is never
    quantized: the tree then has no ``unembed`` leaf). ``mode='int4'``
    packs the :data:`INT4_LEAVES` with per-channel (or
    :func:`int4_group_size` group) scales; the MoE expert leaves stay
    int8.

    With ``donate=True`` each source leaf is dropped from ``params`` as
    soon as its quantized replacement exists, so a caller holding no
    other reference never keeps both trees (a 7B peaks near its bf16
    size plus one layer's transient). Only donate a dict the caller
    will not reuse."""
    if mode not in ('int8', 'int4'):
        raise ValueError(f'unknown quantize mode {mode!r}')
    group = int4_group_size() if mode == 'int4' else 0
    out: Params = {}
    for key in list(params):
        if key == 'layers':
            src = params['layers']
            layers = {}
            for k in list(src):
                if k in REDUCE_AXES:
                    layers[k] = _quantize_leaf(k, src[k], mode, group)
                    if donate:
                        del src[k]
                else:
                    layers[k] = src[k]
            out['layers'] = layers
        elif key in REDUCE_AXES:
            out[key] = _quantize_leaf(key, params[key], mode, group)
            if donate:
                del params[key]
        else:
            out[key] = params[key]
    return out


# The layer leaves :func:`qeinsum` contracts inside the W8A8 region (the
# unembedding stays outside it; MoE experts go through :func:`deq`).
W8A8_LEAVES = ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down')


def relayout_codes_for_int8_matmul(params: Params) -> Params:
    """``params`` with every int8 :data:`W8A8_LEAVES` leaf of its
    ``'layers'`` stored with each layer's codes column-major (contracted
    axes innermost): values, shapes and keys stay as they are, only the
    strides change, so each layer's ``[k, n]`` reshape is a column-major
    view, the layout cuBLASLt's int8 GEMM runs fast. The result is a new
    dict (and a new ``'layers'`` dict) that shares every other leaf; the
    caller's dict is not written, so other engines on it keep their
    layout. A leaf already column-major is shared, not copied."""
    layers = dict(params.get('layers', {}))
    for key in W8A8_LEAVES:
        w = layers.get(key)
        if not isinstance(w, QuantizedWeight):
            continue
        nc = len(REDUCE_AXES[key])
        perm = [0] + list(range(1 + nc, w.int8.dim())) + list(
            range(1, 1 + nc))
        if w.int8.permute(perm).is_contiguous():
            continue
        inv = [perm.index(i) for i in range(len(perm))]
        layers[key] = QuantizedWeight(
            int8=w.int8.permute(perm).contiguous().permute(inv),
            scale=w.scale)
    return dict(params, layers=layers)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, QUANT_LEAF_TYPES):
        yield from tree
    else:
        yield tree


def _quant_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _quant_leaves(v)
    elif isinstance(tree, QUANT_LEAF_TYPES):
        yield tree


def quantized_mode(params: Params) -> Optional[str]:
    """'int4' | 'int8' | None: int4 when any packed leaf exists (int4
    trees carry int8 MoE leaves beside them)."""
    kinds = {type(q) for q in _quant_leaves(params)}
    if QuantizedWeight4 in kinds:
        return 'int4'
    return 'int8' if kinds else None


def is_quantized(params: Params) -> bool:
    return quantized_mode(params) is not None


def quantized_bytes(params: Params) -> int:
    """Total parameter bytes as stored (int8 codes count 1 B each,
    packed int4 codes 1 B a pair)."""
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def widened_leaf_bytes(params: Params) -> int:
    """Bytes of the largest per-call transient of a quantized tree's
    matmuls: its largest quantized operand (one layer's slice of a
    stacked leaf, or the whole ``unembed``) widened to the compute
    dtype, twice (an int8 expert leaf's :func:`deq`; an int4 leaf's
    unpacked codes beside their widened copy). 0 for an unquantized
    tree."""
    leaves = [(v[0], v.scale) for v in params.values()
              if isinstance(v, QUANT_LEAF_TYPES)]
    leaves += [(v[0][0], v.scale) for v in params.get('layers', {}).values()
               if isinstance(v, QUANT_LEAF_TYPES)]
    most = 0
    for codes, scale in leaves:
        n = codes.numel() * (2 if codes.dtype == torch.uint8 else 1)
        most = max(most, n * scale.element_size())
    return 2 * most


def per_device_bytes(params: Params) -> int:
    """Bytes one device holds of the tree: an engine under a serving
    mesh keeps only its rank's shard of each leaf
    (``parallel.mesh.shard_params``), replicated leaves whole, so this
    is :func:`quantized_bytes` of the local tree; it is the figure pool
    sizing subtracts from device memory."""
    return quantized_bytes(params)


def _map_quant_leaves(axes: Params, leaf) -> Params:
    out: Params = {}
    for k, v in axes.items():
        if k == 'layers':
            out[k] = {lk: (leaf(lk, lv) if lk in REDUCE_AXES else lv)
                      for lk, lv in v.items()}
        elif k in REDUCE_AXES:
            out[k] = leaf(k, v)
        else:
            out[k] = v
    return out


def quantize_logical_axes(axes: Params, mode: str = 'int8') -> Params:
    """The logical-axes tree (``llama.param_logical_axes``) in the
    quantized tree's structure: each quantized leaf a
    ``QuantizedWeight`` (``QuantizedWeight4`` for the
    :data:`INT4_LEAVES` under ``mode='int4'``) whose codes and scales
    both carry the parent's axes; the divisibility-aware
    ``parallel.mesh.spec_for`` replicates a scale's size-1 contracted
    dims."""
    def leaf(k, v):
        if mode == 'int4' and k in INT4_LEAVES:
            return QuantizedWeight4(packed=v, scale=v)
        return QuantizedWeight(int8=v, scale=v)
    return _map_quant_leaves(axes, leaf)


def _packed_axis(key: str, ndim: int) -> int:
    """The axis an int4 leaf ``key`` packs along: its last contracted
    axis (a stacked leaf's ``REDUCE_AXES`` count the stack axis)."""
    return REDUCE_AXES[key][-1] % ndim


def shard_quant_leaf(key: str, q, axes, bounds, cut):
    """One rank's shard of a quantized leaf (``parallel.mesh.
    shard_params``): codes and scales cut by the parent's logical
    ``axes`` through ``bounds(shape, axes) -> [(start, len), ...]`` and
    ``cut(tensor, bounds)``. A scale's size-1 dims stay whole (a
    row-parallel leaf's per-channel scales are replicated). An int4
    leaf must split where its unpacked parent splits: a packed axis cut
    inside a byte, or group scales cut inside a group, raise
    ``ValueError`` (never a silent repack)."""
    if isinstance(q, QuantizedWeight):
        return QuantizedWeight(int8=cut(q.int8, bounds(q.int8.shape, axes)),
                               scale=cut(q.scale, bounds(q.scale.shape,
                                                         axes)))
    ax = _packed_axis(key, q.packed.dim())
    parent = list(q.packed.shape)
    parent[ax] *= 2
    bp = bounds(tuple(parent), axes)
    bk = bounds(tuple(q.packed.shape), axes)
    bs = bounds(tuple(q.scale.shape), axes)
    for dim, n in enumerate(parent):
        want = n // bp[dim][1]
        if q.packed.shape[dim] // bk[dim][1] != want:
            raise ValueError(
                f'int4 leaf {key!r}: its dim {dim} ({n} codes) splits '
                f'{want} ways, but its packed bytes ({q.packed.shape[dim]}) '
                'cannot split on the same boundaries (a shard would start '
                'inside a byte)')
        s = q.scale.shape[dim]
        if s != 1 and s // bs[dim][1] != want:
            raise ValueError(
                f'int4 leaf {key!r}: its dim {dim} splits {want} ways, but '
                f'its {s} scale groups do not (a shard would cut a group '
                f'of {n // s} codes; pick SKYTPU_INT4_GROUP so that each '
                'shard holds whole groups)')
    return QuantizedWeight4(packed=cut(q.packed, bk), scale=cut(q.scale, bs))
