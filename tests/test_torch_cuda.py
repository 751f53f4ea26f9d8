"""Tests of the port's CUDA kernels; they need an NVIDIA GPU with nvcc
and skip elsewhere. Run them on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: the suite's conftest imports JAX, which the port does not
need).

Each kernel is held against its plain PyTorch version on the same CUDA
inputs: fp32 q within 1e-5 (the sums run in another order; int8/int4
codes are exact in fp32), bf16 q within 2e-3 on the normalised output
(plus one bf16 rounding of the value where the kernel writes a bf16
output); the empty-slot sentinel is exact.
"""
import dataclasses

import pytest
import torch

from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
from skypilot_tpu_torch.models import configs, llama, quantization
from skypilot_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (run on the card)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _inputs(dtype, hq, hkv, d, page=16, P=4, L=2, seed=0, kind=None):
    """q, pools, table, lengths (and, for kind 'int8'/'int4', the pools
    as codes of the port's row quantizers with their scales)."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    slots = 5
    n_pages = slots * P + 1
    shape = (L, n_pages, hkv, page, d)
    pk = torch.randn(shape, generator=gen, device='cuda')
    pv = torch.randn(shape, generator=gen, device='cuda')
    q = torch.randn((slots, hq, d), generator=gen, device='cuda').to(dtype)
    table = (torch.randperm(n_pages - 1, generator=gen, device='cuda')[
        :slots * P] + 1).reshape(slots, P).to(torch.int32)
    lens = torch.tensor([0, 1, page + 5, page * P, 2 * page],
                        dtype=torch.int32, device='cuda')
    if kind is None:
        return q, pk.to(dtype), pv.to(dtype), table, lens
    quant = (llama.quantize_kv_rows if kind == 'int8'
             else llama.quantize_kv_rows4)
    (ck, ks), (cv, vs) = quant(pk), quant(pv)
    return (q, ck, cv, table, lens, ks[..., 0].contiguous(),
            vs[..., 0].contiguous())


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize('hq,hkv,d', [(8, 8, 64), (8, 2, 128), (4, 4, 256),
                                      (8, 1, 128), (8, 1, 256), (28, 4, 128)])
def test_kernel_matches_plain(cuda, dtype, tol, hq, hkv, d):
    q, pk, pv, table, lens = _inputs(dtype, hq, hkv, d)
    key = f'paged_decode_attention[{pa.pool_kind(pk)}]'
    before = pa.launch_counts[key]
    acc, m, l = pa.paged_decode_attention(q, pk, pv, table, lens, layer=1)
    torch.cuda.synchronize()
    assert pa.launch_counts[key] == before + 1
    racc, rm, rl = pa.paged_decode_attention_reference(q, pk, pv, table,
                                                       lens, layer=1)
    live = rl > 0
    out = acc[live] / l[live][:, None]
    rout = racc[live] / rl[live][:, None]
    assert (out - rout).abs().max().item() <= tol
    assert (m[0] == -1e30).all() and (l[0] == 0).all() and (acc[0] == 0).all()


def test_kernel_rejects_unsupported_head_dim(cuda):
    q, pk, pv, table, lens = _inputs(torch.float32, 4, 4, 64)
    q48 = q[..., :48].contiguous()
    pk48 = pk[..., :48].contiguous()
    with pytest.raises(ValueError, match='head_dim'):
        pa.paged_decode_attention(q48, pk48, pk48, table, lens)


def test_engine_kernel_path_matches_cpu_plain_path(cuda):
    cfg = dataclasses.replace(configs.TINY, dim=128, n_heads=2,
                              n_kv_heads=1, dtype=torch.float32)
    params = llama.init_params(cfg, 0, device='cpu')
    prompts = [[3, 1, 4, 1, 5], list(range(7, 40))]
    outs = []
    for dev in ('cuda', 'cpu'):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in params.items()}
        eng = PagedInferenceEngine(cfg, p, max_batch=2, max_seq=64,
                                   page_size=8, chunk=16,
                                   decode_impl='pallas', device=dev)
        rids = [eng.add_request(pr, max_new_tokens=8) for pr in prompts]
        done = eng.run_to_completion(horizon=4)
        outs.append([done[r].output for r in rids])
    assert outs[0] == outs[1]


# The last two: gemma-2b (one kv head at d 256) and qwen2-7b (group 7,
# run by the G = 8 body with a runtime group).
GEOS = [(8, 8, 64), (8, 2, 128), (4, 4, 256), (8, 1, 128), (8, 1, 256),
        (28, 4, 128)]


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize('kind', ['int8', 'int4'])
@pytest.mark.parametrize('hq,hkv,d', GEOS)
def test_quantized_kernel_matches_plain(cuda, dtype, tol, kind, hq, hkv, d):
    q, pk, pv, table, lens, ks, vs = _inputs(dtype, hq, hkv, d, kind=kind)
    key = f'paged_decode_attention[{kind}]'
    before = pa.launch_counts[key]
    acc, m, l = pa.paged_decode_attention(q, pk, pv, table, lens, ks, vs,
                                          layer=1)
    torch.cuda.synchronize()
    assert pa.launch_counts[key] == before + 1
    racc, rm, rl = pa.paged_decode_attention_reference(
        q, pk, pv, table, lens, ks, vs, layer=1)
    live = rl > 0
    out = acc[live] / l[live][:, None]
    rout = racc[live] / rl[live][:, None]
    assert (out - rout).abs().max().item() <= tol
    assert (m - rm).abs().max().item() <= 1e-4
    assert (m[0] == -1e30).all() and (l[0] == 0).all() and (acc[0] == 0).all()


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize('kind', [None, 'int8', 'int4'])
@pytest.mark.parametrize('hq,hkv,d', GEOS)
def test_fused_kernel_matches_plain(cuda, dtype, tol, kind, hq, hkv, d):
    ins = _inputs(dtype, hq, hkv, d, kind=kind)
    q, pk, pv, table, lens = ins[:5]
    ks, vs = ins[5:] if kind else (None, None)
    gen = torch.Generator(device='cuda').manual_seed(1)
    slots, H = q.shape[0], 4

    def f(*shape):
        return torch.randn(shape, generator=gen, device='cuda').to(dtype)
    k_self, v_self = f(slots, hkv, d), f(slots, hkv, d)
    ring_k, ring_v = f(slots, H, hkv, d), f(slots, H, hkv, d)
    key = f'paged_decode_attention_fused[{pa.pool_kind(pk)}]'
    for ring_len in (0, 1, H):
        before = pa.launch_counts[key]
        out = pa.paged_decode_attention_fused(
            q, k_self, v_self, ring_k, ring_v, ring_len, pk, pv, table,
            lens, ks, vs, layer=1)
        torch.cuda.synchronize()
        assert pa.launch_counts[key] == before + 1
        want = pa.paged_decode_attention_fused_reference(
            q, k_self, v_self, ring_k, ring_v, ring_len, pk, pv, table,
            lens, ks, vs, layer=1)
        assert out.dtype == dtype
        # bf16 outputs: one bf16 rounding of the value on top of tol.
        rounding = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
        err = ((out.float() - want.float()).abs()
               - rounding * want.float().abs())
        assert err.max().item() <= tol


def test_kernels_reject_bad_scales(cuda):
    q, pk, pv, table, lens, ks, vs = _inputs(torch.float32, 4, 4, 64,
                                             kind='int8')
    with pytest.raises(ValueError, match='k_scale'):
        pa.paged_decode_attention(q, pk, pv, table, lens)
    with pytest.raises(ValueError, match='fp32'):
        pa.paged_decode_attention(q, pk, pv, table, lens, ks.half(), vs)
    r = torch.zeros((q.shape[0], 2, 4, 64), device='cuda')
    s = torch.zeros((q.shape[0], 4, 64), device='cuda')
    with pytest.raises(ValueError, match='ring_len'):
        pa.paged_decode_attention_fused(q, s, s, r, r, 3, pk, pv, table,
                                        lens, ks, vs)
    with pytest.raises(ValueError, match='contiguous'):
        pa.paged_decode_attention_fused(q, r[:, 0], s, r, r, 1, pk, pv,
                                        table, lens, ks, vs)


@pytest.mark.parametrize('quantize,kv,impl', [
    ('int8', 'int8', 'pallas'), ('int8', 'int8', 'cross_layer'),
    (None, 'int4', 'pallas'), ('int8', 'int4', 'cross_layer')])
def test_quantized_engine_kernel_path_matches_cpu_plain_path(
        cuda, quantize, kv, impl):
    cfg = dataclasses.replace(configs.TINY, dim=128, n_heads=2,
                              n_kv_heads=1, dtype=torch.float32)
    params = llama.init_params(cfg, 0, device='cpu')
    if quantize:
        params = quantization.quantize_params(params)
    prompts = [[3, 1, 4, 1, 5], list(range(7, 40))]
    outs = []
    for dev in ('cuda', 'cpu'):
        p = {k: ({kk: _to(vv, dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else _to(v, dev))
             for k, v in params.items()}
        eng = PagedInferenceEngine(cfg, p, max_batch=2, max_seq=64,
                                   page_size=8, chunk=16, kv_cache_dtype=kv,
                                   decode_impl=impl, device=dev)
        rids = [eng.add_request(pr, max_new_tokens=8) for pr in prompts]
        done = eng.run_to_completion(horizon=4)
        outs.append([done[r].output for r in rids])
    assert outs[0] == outs[1]


def _to(t, dev):
    if isinstance(t, quantization.QuantizedWeight):
        return quantization.QuantizedWeight(t.int8.to(dev), t.scale.to(dev))
    return t.to(dev)


@pytest.mark.parametrize('eq,xshape,wshape,axes', [
    ('bsd,dhk->bshk', (3, 2, 64), (64, 4, 16), (0,)),
    ('bshk,hkd->bsd', (3, 2, 4, 16), (4, 16, 64), (0, 1)),
    ('bsd,df->bsf', (3, 2, 64), (64, 96), (0,)),
    ('bsf,fd->bsd', (3, 2, 96), (96, 64), (0,)),
    ('bsd,dv->bsv', (3, 2, 64), (64, 200), (0,))])
def test_qeinsum_bf16_on_card_matches_fp32_cpu(cuda, eq, xshape, wshape,
                                               axes):
    """bf16 activations against int8 codes on the card: an fp32 product
    (within 1e-5 of the CPU's fp32 path relative to its largest value;
    no bf16 rounding before the scale), then one rounding to bf16."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(xshape, generator=gen).to(torch.bfloat16)
    w = quantization.quantize_array(
        torch.randn(wshape, generator=gen).to(torch.bfloat16), axes)
    want = quantization.qeinsum(eq, x, w, out_dtype=torch.float32)
    got = quantization.qeinsum(eq, x.to(cuda), _to(w, cuda),
                               out_dtype=torch.float32).cpu()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    got16 = quantization.qeinsum(eq, x.to(cuda), _to(w, cuda)).cpu()
    assert got16.dtype == torch.bfloat16
    assert ((got16.float() - want).abs()
            <= 2.0 ** -8 * want.abs() + 1e-6).all()


@pytest.mark.parametrize('tied', [False, True], ids=['untied', 'tied'])
def test_matmul_f32_on_card(cuda, tied):
    """The unembedding's bf16 product on the card stays fp32 (within
    1e-5 of the CPU's fp32 product of the same bf16 values, relative to
    its largest value), tied (``embed`` transposed) and untied; its
    backward is the bf16 matmuls' (the gradient rounded to bf16)."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 3, 64), generator=gen).to(torch.bfloat16)
    w = torch.randn((200, 64) if tied else (64, 200),
                    generator=gen).to(torch.bfloat16)
    want = quantization.matmul_f32(x, w.t() if tied else w)
    xc = x.to(cuda).requires_grad_()
    wc = w.to(cuda).requires_grad_()
    got = quantization.matmul_f32(xc, wc.t() if tied else wc)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert ((got.detach().cpu() - want).abs().max().item()
            <= 1e-5 * want.abs().max().item())
    g = torch.randn(got.shape, generator=gen).to(cuda)
    got.backward(g)
    xr = x.to(cuda).requires_grad_()
    wr = w.to(cuda).requires_grad_()
    ((xr @ (wr.t() if tied else wr)).float() * g).sum().backward()
    assert xc.grad.dtype == wc.grad.dtype == torch.bfloat16
    for a, b in ((xc.grad, xr.grad), (wc.grad, wr.grad)):
        assert ((a.float() - b.float()).abs()
                <= 2.0 ** -7 * b.float().abs() + 1e-3).all()


# ----------------------------------------------------------- K3 and K4
# chip_smoke.py's geometries: 7B MHA, GQA 32/8, d 64, d 256, gemma-2b
# and qwen2-7b (group 7).
FLASH_GEOS = [(32, 32, 128), (32, 8, 128), (32, 32, 64), (16, 16, 256),
              (8, 1, 256), (28, 4, 128)]
# fp32: the sums run in another order; bf16: the kernel and the plain
# version both compute in fp32 from the same bf16 inputs, and each
# rounds the output to bf16 once, so they may differ by one rounding.
FLASH_TOL = {torch.float32: (1e-5, 0.0, 1e-5),
             torch.bfloat16: (2e-3, 2.0 ** -8, 1e-4)}   # out, rounding, lse


def _flash_inputs(dtype, b, sq, skv, hq, hkv, d, seed=0):
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def f(*shape):
        return torch.randn(shape, generator=gen, device='cuda').to(dtype)
    return f(b, sq, hq, d), f(b, skv, hkv, d), f(b, skv, hkv, d)


def _flash_err(got, want, rounding):
    diff = (got.float() - want.float()).abs()
    return (diff - rounding * want.float().abs()).max().item()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('hq,hkv,d', FLASH_GEOS)
@pytest.mark.parametrize('b,sq,skv,causal', [(2, 64, 64, True),
                                             (2, 256, 256, True),
                                             (1, 100, 100, True),
                                             (2, 64, 200, False)])
def test_flash_fwd_matches_plain(cuda, dtype, hq, hkv, d, b, sq, skv,
                                 causal):
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v = _flash_inputs(dtype, b, sq, skv, hq, hkv, d)
    before = fa.launch_counts['flash_fwd']
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_counts['flash_fwd'] == before + 1
    # The plain version's fp32 output (the same math on fp32 copies of
    # the inputs): a bf16 output is one rounding away from it. Against
    # the plain bf16 output, two roundings of two fp32 sums taken in
    # another order can land one ulp apart, more than the rounding
    # allowance for |out| in [1, 1.5) (measured: 0.0027 beyond it with
    # the tensor-core K4).
    want, want_lse = fa.flash_attention_reference(
        q.float(), k.float(), v.float(), causal=causal)
    tol, rounding, tol_lse = FLASH_TOL[dtype]
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    assert _flash_err(out, want, rounding) <= tol
    assert (lse - want_lse).abs().max().item() <= tol_lse


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('hq,hkv,d', FLASH_GEOS)
@pytest.mark.parametrize('sq,split', [(64, 64), (256, 512), (64, 100),
                                      (256, 1792)])
def test_flash_chunk_matches_plain(cuda, dtype, hq, hkv, d, sq, split):
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v = _flash_inputs(dtype, 3, sq, split + sq, hq, hkv, d, seed=1)
    cache_len = torch.tensor([0, split // 2 + 3, split], dtype=torch.int32,
                             device='cuda')
    before = fa.launch_counts['flash_fwd_chunk']
    out = fa.flash_attention(q, k, v, cache_len=cache_len, kv_split=split)
    torch.cuda.synchronize()
    assert fa.launch_counts['flash_fwd_chunk'] == before + 1
    # Against the plain version's fp32 output, as in
    # test_flash_fwd_matches_plain: bf16 K3 runs K4's tensor-core body.
    want = fa.flash_chunk_reference(q.float(), k.float(), v.float(),
                                    cache_len, split)
    tol, rounding, _ = FLASH_TOL[dtype]
    assert bool(torch.isfinite(out).all())
    assert _flash_err(out, want, rounding) <= tol
    # Masked cache rows are never read: NaN there changes nothing.
    k2, v2 = k.clone(), v.clone()
    k2[1, split // 2 + 3:split] = float('nan')
    v2[0, :split] = float('nan')
    again = fa.flash_attention(q, k2, v2, cache_len=cache_len,
                               kv_split=split)
    assert torch.equal(again, out)


def test_flash_rejects_unsupported(cuda):
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v = _flash_inputs(torch.float32, 1, 64, 64, 4, 4, 48)
    with pytest.raises(ValueError, match='head_dim'):
        fa.flash_attention_fwd(q, k, v)
    q, k, v = _flash_inputs(torch.float32, 1, 64, 64, 32, 2, 64)
    with pytest.raises(ValueError, match='query heads per kv head'):
        fa.flash_attention_fwd(q, k, v)
    q, k, v = _flash_inputs(torch.float16, 1, 64, 64, 4, 4, 64)
    with pytest.raises(ValueError, match='bf16 or fp32'):
        fa.flash_attention_fwd(q, k, v)


@pytest.mark.parametrize('chunk', [16, 0])
def test_slot_engine_kernel_path_matches_cpu_plain_path(cuda, chunk):
    """The slot engine on the card (prefill on K4 and, chunked, K3) and
    on the CPU (plain paths) give the same greedy streams."""
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.ops import flash_attention as fa
    cfg = dataclasses.replace(configs.TINY, dim=128, n_heads=2,
                              n_kv_heads=1, dtype=torch.float32)
    params = llama.init_params(cfg, 0, device='cpu')
    prompts = [[3, 1, 4, 1, 5], list(range(7, 40)), list(range(50, 90))]
    outs = []
    for dev in ('cuda', 'cpu'):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in params.items()}
        before = dict(fa.launch_counts)
        eng = InferenceEngine(cfg, p, max_batch=2, max_seq=128,
                              prefill_chunk_tokens=chunk, device=dev)
        rids = [eng.add_request(pr, max_new_tokens=8) for pr in prompts]
        done = eng.run_to_completion(horizon=4)
        outs.append([done[r].output for r in rids])
        if dev == 'cuda':
            calls = eng.prefill_calls
            assert fa.launch_counts['flash_fwd'] - before['flash_fwd'] == \
                cfg.n_layers * calls['uncached'] > 0
            assert (fa.launch_counts['flash_fwd_chunk']
                    - before['flash_fwd_chunk']
                    == cfg.n_layers * calls['cached'])
            assert (calls['cached'] > 0) == (chunk > 0)
    assert outs[0] == outs[1]


# The backward: each gradient element against the plain version on the
# same inputs, within 2e-5 of max(1, max |grad|) (fp32 sums over up to
# 8 x 300 rows in another order err with the size of their terms), with
# one bf16 ulp of the element allowed on top for bf16 gradients: both
# sides round the fp32 gradient, and a rounding boundary between them
# flips one ulp.
BWD_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-5, 2.0 ** -7)}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('hq,hkv,d', [(4, 4, 64), (8, 2, 128), (8, 1, 256),
                                      (8, 1, 64), (28, 4, 128)])
@pytest.mark.parametrize('b,sq,skv,causal', [(2, 64, 64, True),
                                             (1, 300, 300, True),
                                             (2, 100, 300, False)])
def test_flash_bwd_matches_plain(cuda, dtype, hq, hkv, d, b, sq, skv,
                                 causal):
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v = _flash_inputs(dtype, b, sq, skv, hq, hkv, d, seed=2)
    do = _flash_inputs(dtype, b, sq, sq, hq, hq, d, seed=3)[0]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = fa.attention_delta(out, do)
    before = dict(fa.launch_counts)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                        causal=causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_counts['flash_bwd_dkv'] == before['flash_bwd_dkv'] + 1
    assert fa.launch_counts['flash_bwd_dq'] == before['flash_bwd_dq'] + 1
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                            causal=causal)
    tol, rounding = BWD_TOL[dtype]
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == w.shape
        assert bool(torch.isfinite(got).all())
        norm = max(1.0, w.float().abs().max().item())
        assert _flash_err(got, w, rounding) <= tol * norm


def test_flash_autograd_runs_the_backward_kernels(cuda):
    """attention(impl='flash') on CUDA: one K4 launch forward, one K5a
    and one K5b launch backward, gradients as autograd through the
    plain forward (fp32)."""
    from skypilot_tpu_torch.ops import attention as at
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v = (t.requires_grad_(True) for t in _flash_inputs(
        torch.float32, 2, 128, 128, 8, 2, 64, seed=4))
    do = _flash_inputs(torch.float32, 2, 128, 128, 8, 8, 64, seed=5)[0]
    before = dict(fa.launch_counts)
    got = torch.autograd.grad(at.attention(q, k, v, impl='flash'),
                              (q, k, v), do)
    torch.cuda.synchronize()
    for key in ('flash_fwd', 'flash_bwd_dkv', 'flash_bwd_dq'):
        assert fa.launch_counts[key] == before[key] + 1, key
    want = torch.autograd.grad(
        fa.flash_attention_reference(q, k, v, causal=True)[0], (q, k, v), do)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 2e-5 * max(
            1.0, w.abs().max().item())


def test_training_steps_run_on_the_kernels(cuda):
    """Two optimizer steps of a small bf16 model (head_dim 64, GQA,
    remat 'block') on the card: finite metrics, K4 twice per layer per
    step (forward and the remat recompute), K5a and K5b once."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(configs.TINY, dim=256, n_heads=4,
                              n_kv_heads=2, ffn_dim=512, vocab_size=512,
                              remat='block')
    trainer = Trainer(cfg, train_config=TrainConfig(
        learning_rate=1e-3, warmup_steps=1, total_steps=4), device='cuda')
    state = trainer.init(0)
    gen = torch.Generator().manual_seed(0)
    fa.reset_launch_counts()
    for _ in range(2):
        toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen)
        state, m = trainer.step(state, {'inputs': toks[:, :-1],
                                        'targets': toks[:, 1:]})
        assert all(bool(torch.isfinite(v)) for v in m.values())
    assert fa.launch_counts['flash_fwd'] == 2 * cfg.n_layers * 2
    assert fa.launch_counts['flash_bwd_dkv'] == cfg.n_layers * 2
    assert fa.launch_counts['flash_bwd_dq'] == cfg.n_layers * 2
    assert fa.launch_counts['flash_fwd_chunk'] == 0


# ------------------------------------------------------------------- K6
@pytest.mark.parametrize('kind', ['bf16', 'fp32', 'int8', 'int4'])
def test_all_layers_kernel_matches_plain_and_stacked_k1(cuda, kind):
    """K6 against its plain version (K1's tolerances: fp32 1e-5, bf16
    2e-3 on acc and l over max(l, 1)) and bit for bit against one K1
    launch per layer: each block runs K1's page loop on its layer."""
    dtype = torch.float32 if kind == 'fp32' else torch.bfloat16
    code = None if kind in ('bf16', 'fp32') else kind
    ins = _inputs(dtype, 8, 2, 128, L=3, seed=11, kind=code)
    q1, pk, pv, table, lens = ins[:5]
    ks, vs = ins[5:] if code else (None, None)
    gen = torch.Generator(device='cuda').manual_seed(12)
    q = torch.randn((3,) + tuple(q1.shape), generator=gen,
                    device='cuda').to(dtype)
    before = dict(pa.launch_counts)
    got = pa.paged_decode_attention_all_layers(q, pk, pv, table, lens, ks,
                                               vs)
    torch.cuda.synchronize()
    key = f'paged_decode_attention_all_layers[{kind}]'
    assert pa.launch_counts[key] == before[key] + 1
    want = pa.paged_decode_attention_all_layers_reference(
        q, pk, pv, table, lens, ks, vs)
    tol = 1e-5 if dtype == torch.float32 else 2e-3
    acc, m, l = got
    norm = torch.clamp(want[2], min=1.0)
    assert ((acc - want[0]).abs() / norm[..., None]).max().item() <= tol
    assert ((l - want[2]).abs() / norm).max().item() <= tol
    assert (m - want[1]).abs().max().item() <= (1e-5 if tol == 1e-5
                                                else 1e-4)
    assert (m[:, 0] == -1e30).all() and (acc[:, 0] == 0).all() \
        and (l[:, 0] == 0).all()
    for li in range(q.shape[0]):
        one = pa.paged_decode_attention(q[li], pk, pv, table, lens, ks, vs,
                                        layer=li)
        for a, b in zip(got, one):
            assert torch.equal(a[li], b)


# ------------------------------------ bf16 K4 and K5a on the tensor cores
# Every head_dim and group the kernels take, causal at ragged and long
# sq and full attention at 100 x 300 (b 1 at 2048, else 2).
TC_GEOS = [(d, g) for d in (64, 128, 256) for g in (1, 4, 8)] + [(128, 7)]
TC_SHAPES = [(1, True), (17, True), (100, True), (300, True),
             (2048, True), ((100, 300), False)]


def _tc_case(d, g, shape, causal):
    sq, skv = shape if isinstance(shape, tuple) else (shape, shape)
    hkv = 1 if g >= 7 else 2
    return (1 if sq == 2048 else 2), sq, skv, g * hkv, hkv


@pytest.mark.parametrize('d,g', TC_GEOS)
@pytest.mark.parametrize('shape,causal', TC_SHAPES)
def test_flash_fwd_tensor_cores_match_plain(cuda, d, g, shape, causal):
    from skypilot_tpu_torch.ops import flash_attention as fa
    b, sq, skv, hq, hkv = _tc_case(d, g, shape, causal)
    q, k, v = _flash_inputs(torch.bfloat16, b, sq, skv, hq, hkv, d, seed=6)
    before = fa.launch_counts['flash_fwd']
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_counts['flash_fwd'] == before + 1
    # Against the plain version's fp32 output, as in
    # test_flash_fwd_matches_plain.
    want, want_lse = fa.flash_attention_reference(
        q.float(), k.float(), v.float(), causal=causal)
    tol, rounding, tol_lse = FLASH_TOL[torch.bfloat16]
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    assert _flash_err(out, want, rounding) <= tol
    assert (lse - want_lse).abs().max().item() <= tol_lse


@pytest.mark.parametrize('d,g', TC_GEOS)
@pytest.mark.parametrize('shape,causal', TC_SHAPES)
def test_flash_bwd_dkv_tensor_cores_match_plain(cuda, d, g, shape, causal):
    from skypilot_tpu_torch.ops import flash_attention as fa
    b, sq, skv, hq, hkv = _tc_case(d, g, shape, causal)
    q, k, v = _flash_inputs(torch.bfloat16, b, sq, skv, hq, hkv, d, seed=7)
    do = _flash_inputs(torch.bfloat16, b, sq, sq, hq, hq, d, seed=8)[0]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = fa.attention_delta(out, do)
    before = fa.launch_counts['flash_bwd_dkv']
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                        causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_counts['flash_bwd_dkv'] == before + 1
    _, want_dk, want_dv = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=causal)
    tol, rounding = BWD_TOL[torch.bfloat16]
    for got, w in ((dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == w.shape
        assert bool(torch.isfinite(got).all())
        norm = max(1.0, w.float().abs().max().item())
        assert _flash_err(got, w, rounding) <= tol * norm


@pytest.mark.parametrize('d,g', TC_GEOS)
@pytest.mark.parametrize('shape,causal', TC_SHAPES)
def test_flash_bwd_dq_tensor_cores_match_plain(cuda, d, g, shape, causal):
    from skypilot_tpu_torch.ops import flash_attention as fa
    b, sq, skv, hq, hkv = _tc_case(d, g, shape, causal)
    q, k, v = _flash_inputs(torch.bfloat16, b, sq, skv, hq, hkv, d, seed=7)
    do = _flash_inputs(torch.bfloat16, b, sq, sq, hq, hq, d, seed=8)[0]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = fa.attention_delta(out, do)
    before = fa.launch_counts['flash_bwd_dq']
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_counts['flash_bwd_dq'] == before + 1
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                            causal=causal)[0]
    tol, rounding = BWD_TOL[torch.bfloat16]
    assert dq.dtype == torch.bfloat16 and dq.shape == want.shape
    assert bool(torch.isfinite(dq).all())
    norm = max(1.0, want.float().abs().max().item())
    assert _flash_err(dq, want, rounding) <= tol * norm


# K3's chunk shapes: chunk rows, and cache rows (split) that are and are
# not a multiple of the kernel's kv tile.
TC_CHUNK_SQ = [1, 17, 64, 256]
TC_CHUNK_SPLIT = [64, 100, 512, 1792]


@pytest.mark.parametrize('d,g', TC_GEOS)
@pytest.mark.parametrize('sq', TC_CHUNK_SQ)
@pytest.mark.parametrize('split', TC_CHUNK_SPLIT)
def test_flash_chunk_tensor_cores_match_plain(cuda, d, g, sq, split):
    """bf16 K3 against the plain version's fp32 output, with per-row
    cache lengths 0, mid and full. The cache rows past each row's
    cache_len hold 1e4: a kernel that reads them unmasked, or masks the
    wrong rows, moves the output far beyond the tolerance."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    hkv = 1 if g >= 7 else 2
    q, k, v = _flash_inputs(torch.bfloat16, 3, sq, split + sq, g * hkv,
                            hkv, d, seed=12)
    lens = [0, split // 2 + 1, split]
    for row, n in enumerate(lens):
        k[row, n:split] = 1e4
        v[row, n:split] = 1e4
    cache_len = torch.tensor(lens, dtype=torch.int32, device='cuda')
    before = fa.launch_counts['flash_fwd_chunk']
    out = fa.flash_chunk_attention(q, k[:, split:], v[:, split:],
                                   k[:, :split], v[:, :split], cache_len)
    torch.cuda.synchronize()
    assert fa.launch_counts['flash_fwd_chunk'] == before + 1
    want = fa.flash_chunk_reference(q.float(), k.float(), v.float(),
                                    cache_len, split)
    tol, rounding, _ = FLASH_TOL[torch.bfloat16]
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    assert _flash_err(out, want, rounding) <= tol


def test_fp32_inputs_keep_the_cuda_core_kernels(cuda):
    """fp32 operands still run the CUDA-core K4, K3, K5a and K5b: their
    results hold the fp32 bounds of the earlier slices (out and lse
    within 1e-5, gradients within 2e-5 of max(1, max |grad|)), which the
    bf16 tensor-core bodies, with bf16 operands, could not."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    for d, g, (b, sq, skv, causal) in ((64, 4, (2, 300, 300, True)),
                                       (128, 1, (2, 100, 300, False)),
                                       (256, 8, (1, 100, 100, True))):
        hkv = 1 if g == 8 else 2
        q, k, v = _flash_inputs(torch.float32, b, sq, skv, g * hkv, hkv, d,
                                seed=9)
        do = _flash_inputs(torch.float32, b, sq, sq, g * hkv, g * hkv, d,
                           seed=10)[0]
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        want, want_lse = fa.flash_attention_reference(q, k, v,
                                                      causal=causal)
        assert out.dtype == torch.float32
        assert (out - want).abs().max().item() <= 1e-5
        assert (lse - want_lse).abs().max().item() <= 1e-5
        delta = fa.attention_delta(out, do)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                            causal=causal)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                       causal=causal)
        want_dq, want_dk, want_dv = fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=causal)
        for got, w in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
            assert got.dtype == torch.float32
            assert (got - w).abs().max().item() <= 2e-5 * max(
                1.0, w.abs().max().item())
        # K3 on fp32 operands: a chunk of sq rows against 100 cache rows.
        split = 100
        cq, ck, cv = _flash_inputs(torch.float32, 3, sq, split + sq,
                                   g * hkv, hkv, d, seed=11)
        cache_len = torch.tensor([0, split // 2 + 1, split],
                                 dtype=torch.int32, device='cuda')
        out = fa.flash_attention(cq, ck, cv, cache_len=cache_len,
                                 kv_split=split)
        want = fa.flash_chunk_reference(cq, ck, cv, cache_len, split)
        assert out.dtype == torch.float32
        assert (out - want).abs().max().item() <= 1e-5


# -------------------------------------------- K1/K2/K6 split-K (flash-decoding)
# Every pool kind, head_dim and group at a table wide enough that the
# split plan cuts it in four (ops/paged_attention.py `split_plan`), with
# lengths at the split boundaries: 0, 1, exactly one split, one split + 1,
# a ragged last split and the full table.
SPLIT_KINDS = ['bf16', 'fp32', 'int8', 'int4']


def _split_case(kind, d, g, page, seed=0, slots=6, L=2, hkv=2):
    """Inputs whose table the plan splits in four; returns (inputs as
    _inputs gives them, ks, vs, (splits, pps))."""
    dtype = torch.float32 if kind == 'fp32' else torch.bfloat16
    code = kind if kind in ('int8', 'int4') else None
    pps = max(1, pa.MIN_SPLIT_CODES // (page * d))
    P = 4 * pps
    plan = pa.split_plan(slots, hkv, P, page, d, pa._sm_count(
        torch.device('cuda', torch.cuda.current_device())))
    assert plan == (4, pps)
    span = pps * page
    gen = torch.Generator(device='cuda').manual_seed(seed)
    n_pages = slots * P + 1
    shape = (L, n_pages, hkv, page, d)
    pk = torch.randn(shape, generator=gen, device='cuda')
    pv = torch.randn(shape, generator=gen, device='cuda')
    q = torch.randn((slots, g * hkv, d), generator=gen,
                    device='cuda').to(dtype)
    table = (torch.randperm(n_pages - 1, generator=gen, device='cuda')[
        :slots * P] + 1).reshape(slots, P).to(torch.int32)
    lens = torch.tensor([0, 1, span, span + 1, 3 * span + page // 2 + 3,
                         P * page], dtype=torch.int32, device='cuda')
    if code is None:
        return (q, pk.to(dtype), pv.to(dtype), table, lens), None, None, plan
    quant = (llama.quantize_kv_rows if code == 'int8'
             else llama.quantize_kv_rows4)
    (ck, ks), (cv, vs) = quant(pk), quant(pv)
    return ((q, ck, cv, table, lens), ks[..., 0].contiguous(),
            vs[..., 0].contiguous(), plan)


def _assert_partial_close(got, want, tol):
    acc, m, l = got
    racc, rm, rl = want
    norm = torch.clamp(rl, min=1.0)
    assert ((acc - racc).abs() / norm[..., None]).max().item() <= tol
    assert ((l - rl).abs() / norm).max().item() <= tol
    assert (m - rm).abs().max().item() <= (1e-5 if tol == 1e-5 else 1e-4)
    live = rl > 0
    out = acc[live] / l[live][:, None]
    rout = racc[live] / rl[live][:, None]
    assert (out - rout).abs().max().item() <= tol


@pytest.mark.parametrize('kind', SPLIT_KINDS)
@pytest.mark.parametrize('d', [64, 128, 256])
@pytest.mark.parametrize('g', [1, 4, 7, 8])
@pytest.mark.parametrize('page', [16, 128])
def test_split_kernels_match_plain_at_split_boundaries(cuda, kind, d, g,
                                                       page):
    """K1 and K2 on a four-way split against their plain versions (fp32
    q 1e-5, bf16 2e-3 on the normalised output, acc and l over
    max(l, 1); K2's bf16 output one rounding on top), one launch each;
    the empty slot exactly (0, -1e30, 0)."""
    (q, pk, pv, table, lens), ks, vs, _ = _split_case(kind, d, g, page,
                                                      seed=d + g + page)
    tol = 1e-5 if q.dtype == torch.float32 else 2e-3
    key = f'paged_decode_attention[{kind}]'
    before = pa.launch_counts[key]
    got = pa.paged_decode_attention(q, pk, pv, table, lens, ks, vs, layer=1)
    torch.cuda.synchronize()
    assert pa.launch_counts[key] == before + 1
    want = pa.paged_decode_attention_reference(q, pk, pv, table, lens, ks,
                                               vs, layer=1)
    _assert_partial_close(got, want, tol)
    acc, m, l = got
    assert (m[0] == -1e30).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    gen = torch.Generator(device='cuda').manual_seed(5)
    slots, _, _ = q.shape
    hkv, H = pk.shape[2], 4

    def f(*shape):
        return torch.randn(shape, generator=gen, device='cuda').to(q.dtype)
    k_self, v_self = f(slots, hkv, d), f(slots, hkv, d)
    ring_k, ring_v = f(slots, H, hkv, d), f(slots, H, hkv, d)
    fkey = f'paged_decode_attention_fused[{kind}]'
    rounding = 2.0 ** -8 if q.dtype == torch.bfloat16 else 0.0
    for ring_len in (0, H):
        before = pa.launch_counts[fkey]
        out = pa.paged_decode_attention_fused(
            q, k_self, v_self, ring_k, ring_v, ring_len, pk, pv, table,
            lens, ks, vs, layer=1)
        torch.cuda.synchronize()
        assert pa.launch_counts[fkey] == before + 1
        want = pa.paged_decode_attention_fused_reference(
            q, k_self, v_self, ring_k, ring_v, ring_len, pk, pv, table,
            lens, ks, vs, layer=1)
        err = ((out.float() - want.float()).abs()
               - rounding * want.float().abs())
        assert bool(torch.isfinite(out).all())
        assert err.max().item() <= tol


def test_launches_are_counted_by_split_plan(cuda):
    """Every K1/K2/K6 launch adds one to its launch count and one to its
    (key, splits, pages per split) entry, and reset clears both."""
    (q, pk, pv, table, lens), ks, vs, (splits, pps) = _split_case(
        'int8', 128, 7, 16, seed=4)
    pa.reset_launch_counts()
    for _ in range(2):
        pa.paged_decode_attention(q, pk, pv, table, lens, ks, vs)
    key = 'paged_decode_attention[int8]'
    assert pa.launch_counts[key] == 2
    assert pa.split_plan_counts == {(key, splits, pps): 2}
    pa.reset_launch_counts()
    assert not pa.split_plan_counts and not any(pa.launch_counts.values())


@pytest.mark.parametrize('kind', SPLIT_KINDS)
def test_split_kernels_relaunch_is_bitwise_and_counters_reset(cuda, kind):
    """The last block merges the splits in split order, never arrival
    order: a relaunch equals the first launch bit for bit (K1 and K2),
    and every counter is back at 0 after each launch."""
    (q, pk, pv, table, lens), ks, vs, (splits, _) = _split_case(
        kind, 128, 4, 16, seed=3)
    slots, hq, d = q.shape
    hkv = pk.shape[2]
    first = pa.paged_decode_attention(q, pk, pv, table, lens, ks, vs)
    s = torch.zeros((slots, hkv, d), dtype=q.dtype, device='cuda')
    r = torch.ones((slots, 2, hkv, d), dtype=q.dtype, device='cuda')
    out1 = pa.paged_decode_attention_fused(q, s, s, r, r, 1, pk, pv, table,
                                           lens, ks, vs)
    for _ in range(3):
        again = pa.paged_decode_attention(q, pk, pv, table, lens, ks, vs)
        out2 = pa.paged_decode_attention_fused(q, s, s, r, r, 1, pk, pv,
                                               table, lens, ks, vs)
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)
        assert torch.equal(out1, out2)
    _, counters = pa._workspace(q.device, splits, 1, slots, hq, hkv, d)
    assert counters is not None and not counters.any()


def test_split_kernels_empty_slots_are_exact(cuda):
    """Every slot empty at a four-way split: K1 writes exactly
    (0, -1e30, 0), and K2 folds that partial as its plain version does
    (the ring and the current token alone)."""
    for kind in SPLIT_KINDS:
        (q, pk, pv, table, lens), ks, vs, _ = _split_case(kind, 128, 1, 16,
                                                          seed=4)
        lens = torch.zeros_like(lens)
        acc, m, l = pa.paged_decode_attention(q, pk, pv, table, lens, ks, vs)
        torch.cuda.synchronize()
        assert (m == -1e30).all() and (l == 0).all() and (acc == 0).all()
        slots, hq, d = q.shape
        hkv = pk.shape[2]
        gen = torch.Generator(device='cuda').manual_seed(6)
        s = torch.randn((slots, hkv, d), generator=gen,
                        device='cuda').to(q.dtype)
        r = torch.randn((slots, 3, hkv, d), generator=gen,
                        device='cuda').to(q.dtype)
        got = pa.paged_decode_attention_fused(q, s, s, r, r, 2, pk, pv,
                                              table, lens, ks, vs)
        want = pa.merge_partial_with_ring_self(
            (acc, m, l), q[:, None], s[:, None], s[:, None], r, r, 2)[:, 0]
        tol = 1e-5 if q.dtype == torch.float32 else 2e-3
        rounding = 2.0 ** -8 if q.dtype == torch.bfloat16 else 0.0
        err = ((got.float() - want.float()).abs()
               - rounding * want.float().abs())
        assert err.max().item() <= tol


def test_split_workspace_is_reused_across_shapes(cuda):
    """Two shapes whose workspaces have the same sizes (page 16 x 16
    pages and page 32 x 8 pages, both four splits) share one workspace:
    shape A, B, then A again are each right, and the counters are 0
    after every launch."""
    dev = torch.device('cuda', torch.cuda.current_device())
    cases = []
    for page, P in ((16, 16), (32, 8)):
        gen = torch.Generator(device='cuda').manual_seed(page)
        slots, hkv, hq, d = 4, 2, 4, 128
        n_pages = slots * P + 1
        shape = (2, n_pages, hkv, page, d)
        pk = torch.randn(shape, generator=gen, device='cuda')
        pv = torch.randn(shape, generator=gen, device='cuda')
        q = torch.randn((slots, hq, d), generator=gen, device='cuda')
        table = (torch.randperm(n_pages - 1, generator=gen, device='cuda')[
            :slots * P] + 1).reshape(slots, P).to(torch.int32)
        lens = torch.tensor([P * page, 0, page + 3, 2 * P * page // 3],
                            dtype=torch.int32, device='cuda')
        splits, _ = pa.split_plan(slots, hkv, P, page, d, pa._sm_count(dev))
        assert splits == 4
        cases.append((q, pk, pv, table, lens))
    ws_a = pa._workspace(dev, 4, 1, 4, 4, 2, 128)
    for q, pk, pv, table, lens in cases + cases[:1]:
        got = pa.paged_decode_attention(q, pk, pv, table, lens)
        torch.cuda.synchronize()
        want = pa.paged_decode_attention_reference(q, pk, pv, table, lens)
        _assert_partial_close(got, want, 1e-5)
        assert pa._workspace(dev, 4, 1, 4, 4, 2, 128)[0] is ws_a[0]
        assert not ws_a[1].any()


@pytest.mark.parametrize('kind', SPLIT_KINDS)
def test_all_layers_kernel_split_matches_stacked_k1(cuda, kind):
    """K6 on a four-way split: its plan is K1's (it does not depend on
    L), so layer li equals one K1 launch bit for bit, and both hold
    their plain version at K1's tolerances."""
    (q1, pk, pv, table, lens), ks, vs, _ = _split_case(kind, 128, 4, 16,
                                                       seed=8, L=3)
    gen = torch.Generator(device='cuda').manual_seed(9)
    q = torch.randn((3,) + tuple(q1.shape), generator=gen,
                    device='cuda').to(q1.dtype)
    got = pa.paged_decode_attention_all_layers(q, pk, pv, table, lens, ks,
                                               vs)
    torch.cuda.synchronize()
    want = pa.paged_decode_attention_all_layers_reference(
        q, pk, pv, table, lens, ks, vs)
    _assert_partial_close(got, want,
                          1e-5 if q.dtype == torch.float32 else 2e-3)
    for li in range(q.shape[0]):
        one = pa.paged_decode_attention(q[li], pk, pv, table, lens, ks, vs,
                                        layer=li)
        for a, b in zip(got, one):
            assert torch.equal(a[li], b)


# ---------------------------------------------------------------- MoE, int4
# Neither the MoE FFN nor the int4 weight product is a kernel of its own
# (the reference computes both in XLA outside any Pallas kernel); on the
# card they run cuBLAS products and plain torch, held here against the
# same functions on the CPU. bf16: within 2e-2 of the output's largest
# value (bf16 roundings of fp32 sums in another order).
TOL_CARD_VS_CPU = 2e-2


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, quantization.QUANT_LEAF_TYPES):
        return type(tree)(*(t.cpu() for t in tree))
    return tree.cpu()


@pytest.mark.parametrize('quantized', [False, True])
@pytest.mark.parametrize('tokens,cf', [(8, 1.25), (200, 0.5), (600, 1.25)])
def test_moe_ffn_bf16_card_matches_cpu(cuda, quantized, tokens, cf):
    from skypilot_tpu_torch.models import moe
    cfg = dataclasses.replace(configs.TINY_MOE, dim=256, ffn_dim=512,
                              moe_capacity_factor=cf)
    gen = torch.Generator(device='cuda').manual_seed(tokens)
    layer = {k: v[0] for k, v in moe.init_moe_params(cfg, gen, cuda).items()}
    if quantized:
        layer = {k: (quantization.quantize_slice(k, v)
                     if k.startswith('moe_') else v) for k, v in layer.items()}
    x = torch.randn((2, tokens // 2, cfg.dim), generator=gen,
                    device='cuda').to(torch.bfloat16)
    out, aux = moe.moe_ffn(layer, x, cfg)
    want, want_aux = moe.moe_ffn(_to_cpu(layer), x.cpu(), cfg)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    err = (out.float().cpu() - want.float()).abs().max().item()
    assert err <= TOL_CARD_VS_CPU * want.float().abs().max().item()
    assert abs(float(aux) - float(want_aux)) <= 1e-3


@pytest.mark.parametrize('group', [0, 32])
@pytest.mark.parametrize('eq,shape,axes', [
    ('bsd,dhk->bshk', (256, 4, 64), (0,)), ('bshk,hkd->bsd', (4, 64, 256),
                                              (0, 1)),
    ('bsd,df->bsf', (256, 512), (0,))])
def test_qeinsum4_bf16_card_matches_cpu(cuda, group, eq, shape, axes):
    gen = torch.Generator(device='cuda').manual_seed(7)
    w = torch.randn(shape, generator=gen, device='cuda').to(torch.bfloat16)
    w4 = quantization.quantize_array4(w, axes, group)
    cpu4 = quantization.quantize_array4(w.cpu(), axes, group)
    assert torch.equal(w4.packed.cpu(), cpu4.packed)
    assert torch.equal(w4.scale.cpu(), cpu4.scale)
    nc = len(axes)
    x = torch.randn((3, 5) + shape[:nc], generator=gen,
                    device='cuda').to(torch.bfloat16)
    got = quantization.qeinsum(eq, x, w4, out_dtype=torch.float32)
    want = quantization.qeinsum(eq, x.cpu(), cpu4, out_dtype=torch.float32)
    # bf16 operands are exact in fp32: the two differ by sum order only.
    assert (got.cpu() - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()


def test_int4_slot_cache_round_trip_on_card(cuda):
    """An int4 slot cache written on the card holds the CPU's rows: the
    same packed layout and lengths, fp32 row scales within one ulp (the
    card divides by a scalar through its reciprocal), and codes that
    differ by at most one step, only where a value sits on a rounding
    boundary. The slot engine decodes over such a cache on the card."""
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    cfg = dataclasses.replace(configs.TINY, dim=256, dtype=torch.float32)
    gen = torch.Generator(device='cuda').manual_seed(3)
    rows = [torch.randn((cfg.n_layers, 2, 5, cfg.n_kv_heads, cfg.head_dim),
                        generator=gen, device='cuda') for _ in range(2)]
    starts = torch.tensor([0, 7], dtype=torch.int32, device='cuda')
    caches = []
    for dev in ('cuda', 'cpu'):
        c = llama.KVCache.create(cfg, 2, 32, kv_dtype='int4', device=dev)
        caches.append(llama.merge_rows_into_cache(
            c, *(r.to(dev) for r in rows), starts.to(dev),
            (starts + 5).to(dev)))
    got, want = caches[0], caches[1]
    assert torch.equal(got.length.cpu(), want.length)
    for codes, ref in ((got.k, want.k), (got.v, want.v)):
        assert codes.dtype == ref.dtype == torch.uint8
        diff = (quantization.unpack_int4(codes.cpu()).int()
                - quantization.unpack_int4(ref).int())
        assert diff.abs().max() <= 1 and (diff != 0).float().mean() < 1e-2
    for sc, ref in ((got.k_scale, want.k_scale), (got.v_scale,
                                                  want.v_scale)):
        torch.testing.assert_close(sc.cpu(), ref, rtol=2.0 ** -23, atol=0)
    eng = InferenceEngine(cfg, max_batch=2, max_seq=64, quantize='int4',
                          device='cuda')
    assert eng.cache.packed and eng.cache.k.is_cuda
    rid = eng.add_request(list(range(3, 40)), max_new_tokens=6)
    assert len(eng.run_to_completion(horizon=4)[rid].output) == 6


# --------------------------------------------------------------------------
# The compiled decode program: CUDA graphs of the decode step and merge
# --------------------------------------------------------------------------
GRAPH_CFG = dataclasses.replace(configs.TINY, name='graphs-d64', dim=256,
                                vocab_size=512, max_seq_len=256,
                                dtype=torch.bfloat16)
GRAPH_PROMPTS = ([5, 9, 2, 7] * 3, list(range(3, 43)),
                 [int(3 + (i * 37) % 500) for i in range(75)])


def _seated_paged(kv, impl, **kw):
    """A paged engine with three requests prefilled, ready to decode."""
    params = llama.init_params(GRAPH_CFG, 0, device='cuda')
    eng = PagedInferenceEngine(GRAPH_CFG, params, max_batch=3, max_seq=256,
                               page_size=16, chunk=32, n_pages=48,
                               kv_cache_dtype=kv, decode_impl=impl,
                               device='cuda', **kw)
    for p in GRAPH_PROMPTS:
        eng.add_request(list(p), max_new_tokens=24)
    while eng._queue or eng._prefill_off:
        eng._admit()
    return eng


@pytest.mark.parametrize('impl,kv', [
    ('pallas', 'bf16'), ('pallas', 'int8'), ('pallas', 'int4'),
    ('cross_layer', 'bf16'), ('cross_layer', 'int8'),
    ('cross_layer', 'int4'), ('gather', 'bf16'), ('gather', 'int8')])
def test_graph_replay_equals_eager_step(cuda, impl, kv):
    """The paged engine's decode graphs (K1, K2 or the gather path under
    capture) give the eager step's tokens, ring rows and pool bytes bit
    for bit, at horizons 1, 4 and 8; each new horizon captures its step
    and merge once and replays them after."""
    from skypilot_tpu_torch.analysis import audit
    eng = _seated_paged(kv, impl)
    for h in (1, 4, 8):
        res = audit.graph_matches_eager(eng, h)
        assert res['tokens_equal'] and res['ring_equal'] \
            and res['pool_equal'], res
        assert res['captures'] == 2 and res['replays'] >= h + 1, res


@pytest.mark.parametrize('kv', ['bf16', 'int8'])
def test_slot_graph_replay_equals_eager_step(cuda, kv):
    """The slot engine's decode graphs against ``llama.decode_horizon``
    from the same cache: equal tokens and equal cache bytes and lengths
    after the merge."""
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    params = llama.init_params(GRAPH_CFG, 0, device='cuda')
    eng = InferenceEngine(GRAPH_CFG, params, max_batch=3, max_seq=256,
                          prefill_chunk_tokens=32, kv_cache_dtype=kv,
                          device='cuda')
    for p in GRAPH_PROMPTS:
        eng.add_request(list(p), max_new_tokens=24)
    while eng._queue or eng._prefill_off:
        eng._admit()
    eng._stage_rows(eng._decode_ready())
    eng._buf.upload(4 * eng.max_batch)
    h, kv_bucket = 8, 128
    state = [t.clone() for t in eng.cache.tensors()]
    length, tok = eng.cache.length.clone(), eng._tok_dev.clone()

    def restore():
        for t, s in zip(eng.cache.tensors(), state):
            t.copy_(s)
        eng.cache.length.copy_(length)
        eng._tok_dev.copy_(tok)
    eng._decode_call(h, False, kv_bucket)            # eager + capture
    restore()
    got = eng._decode_call(h, False, kv_bucket)      # replay
    got_cache = [t.clone() for t in eng.cache.tensors()]
    got_len = eng.cache.length.clone()
    assert eng.graph_stats()['graph_replays'] >= h + 1
    restore()
    want, cache = llama.decode_horizon(params, eng.cache, tok, GRAPH_CFG,
                                       horizon=h, kv_bucket=kv_bucket)
    assert torch.equal(got, want)
    assert torch.equal(got_len, cache.length)
    for g, w in zip(got_cache, cache.tensors()):
        assert torch.equal(g, w)


@pytest.mark.parametrize('which', ['paged', 'slot', 'multistep'])
def test_no_capture_after_warmup_three_rounds(cuda, which):
    """The steady-state audit on the card: after one warm-up round, three
    identical rounds capture nothing and make no unsanctioned sync
    (sync debug mode on); multi-step at k=4 dispatches two calls a
    round at horizon 4."""
    from skypilot_tpu_torch.analysis import audit
    if which == 'multistep':
        report = audit.audit_multistep(4, cfg=GRAPH_CFG)
        assert report.dispatches == 4
    else:
        report = audit.audit_engine(which, cfg=GRAPH_CFG, rounds=3)
    assert report.ok(), report.violations()
    assert report.captures[0] > 0 and not report.syncs


def test_replay_launch_counts_equal_eager_counts(cuda):
    """A replayed decode call adds the launches its capture recorded:
    K1 and its split plans count as the eager step's do."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.inference.paged import paged_decode_horizon
    eng = _seated_paged('bf16', 'pallas')
    res = audit.graph_matches_eager(eng, 4)          # captures the key
    buf, P = eng._buf, res['P']
    counts = {}
    for how in ('replay', 'eager'):
        pa.reset_launch_counts()
        if how == 'replay':
            eng._decode_call(4, False, P)
        else:
            paged_decode_horizon(eng.params, eng.cache, buf.table(P),
                                 eng._tok_dev, buf.lengths, GRAPH_CFG,
                                 horizon=4, decode_impl='pallas')
        torch.cuda.synchronize()
        counts[how] = (dict(pa.launch_counts), dict(pa.split_plan_counts))
    assert counts['replay'] == counts['eager']
    assert counts['replay'][0]['paged_decode_attention[bf16]'] == \
        4 * GRAPH_CFG.n_layers


@pytest.mark.parametrize('kind', [None, 'int8', 'int4'])
def test_fused_kernel_device_ring_len(cuda, kind):
    """K2 reads ring_len from device memory: equal to its plain version
    at 0, 1 and H, and one launch of one kernel under a graph replays
    with whatever count the tensor holds at replay time."""
    ins = _inputs(torch.bfloat16, 8, 2, 128, kind=kind)
    q, pk, pv, table, lens = ins[:5]
    ks, vs = ins[5:] if kind else (None, None)
    gen = torch.Generator(device='cuda').manual_seed(1)
    slots, H = q.shape[0], 4

    def f(*shape):
        return torch.randn(shape, generator=gen,
                           device='cuda').to(torch.bfloat16)
    k_self, v_self = f(slots, 2, 128), f(slots, 2, 128)
    ring_k, ring_v = f(slots, H, 2, 128), f(slots, H, 2, 128)
    n = torch.zeros((), dtype=torch.int32, device='cuda')

    def run():
        return pa.paged_decode_attention_fused(
            q, k_self, v_self, ring_k, ring_v, n, pk, pv, table, lens, ks,
            vs, layer=1)
    run()                                            # build and load
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        graph.capture_begin()
        out = run()
        graph.capture_end()
    for ring_len in (0, 1, H):
        n.fill_(ring_len)
        direct = run()
        graph.replay()
        torch.cuda.synchronize()
        want = pa.paged_decode_attention_fused_reference(
            q, k_self, v_self, ring_k, ring_v, ring_len, pk, pv, table,
            lens, ks, vs, layer=1)
        assert torch.equal(out, direct)
        err = ((out.float() - want.float()).abs()
               - 2.0 ** -8 * want.float().abs())
        assert err.max().item() <= 2e-3


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_same_seed_same_sampled_stream_under_graphs(cuda, kind):
    """Sampled decode through the graphs (the engine's generator
    registered with them): the same seed gives the same streams twice,
    and they differ from the greedy ones."""
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    params = llama.init_params(GRAPH_CFG, 0, device='cuda')

    def streams(temperature):
        if kind == 'paged':
            eng = PagedInferenceEngine(GRAPH_CFG, params, max_batch=3,
                                       max_seq=256, page_size=16,
                                       n_pages=48, rng_seed=7,
                                       device='cuda')
        else:
            eng = InferenceEngine(GRAPH_CFG, params, max_batch=3,
                                  max_seq=256, rng_seed=7, device='cuda')
        rids = [eng.add_request(list(p), max_new_tokens=16,
                                temperature=temperature, top_k=8)
                for p in GRAPH_PROMPTS]
        done = eng.run_to_completion(horizon=4)
        assert eng.graph_stats()['graph_replays'] > 0
        return [done[r].output for r in rids]
    a, b = streams(0.9), streams(0.9)
    assert a == b and a != streams(0.0)


def test_auto_n_pages_leaves_room_for_graph_pool(cuda):
    """A pool sized from free memory (not by the slot-parity cap) with
    int8 weights, whose widened leaf lives in the graphs' pool and in
    the eager allocator: decode captures, then a prefill after the
    capture still fits."""
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(configs.LLAMA2_7B, n_layers=4,
                              name='llama2-7b-depth4')
    eng = PagedInferenceEngine(cfg, quantize='int8', max_batch=64,
                               max_seq=32768, device='cuda')
    parity = 64 * (32768 // eng.page) + 1
    assert eng._pool_auto_sized and eng.alloc.n_pages < 4 * parity
    first = [eng.add_request([3 + (i * 7 + j) % 30000 for j in range(600)],
                             max_new_tokens=40) for i in range(8)]
    eng.run_to_completion(horizon=32)
    assert eng.graph_stats()['graph_captures'] > 0
    late = eng.add_request(list(range(5, 2005)), max_new_tokens=8)
    done = eng.run_to_completion(horizon=32)
    assert all(len(done[r].output) == 40 for r in first)
    assert len(done[late].output) == 8
    assert torch.cuda.max_memory_allocated() <= \
        torch.cuda.get_device_properties(0).total_memory
    del eng
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Speculative decoding: verify rounds as CUDA graphs, K3 at sq = k + 1
# --------------------------------------------------------------------------
@pytest.mark.parametrize('kind,kv,rounds', [
    ('paged', 'bf16', 0), ('paged', 'int8', 0), ('paged', 'int4', 0),
    ('slot', 'bf16', 0), ('slot', 'int8', 0), ('paged', 'bf16', 3),
    ('slot', 'bf16', 3)])
def test_spec_graph_replay_equals_eager_round(cuda, kind, kv, rounds):
    """A speculative call's graph (one verify round, or 3 fused rounds)
    gives the eager round's commit, n_commit, tokens and cache bytes
    bit for bit (``audit.spec_graph_matches_eager``); the key captures
    once and replays after."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    params = llama.init_params(GRAPH_CFG, 0, device='cuda')
    kw = dict(max_batch=3, max_seq=256, kv_cache_dtype=kv, speculate_k=4,
              decode_steps_per_call=rounds or None, device='cuda')
    if kind == 'paged':
        eng = PagedInferenceEngine(GRAPH_CFG, params, page_size=16,
                                   chunk=32, n_pages=48, **kw)
    else:
        eng = InferenceEngine(GRAPH_CFG, params, prefill_chunk_tokens=32,
                              **kw)
    for p in GRAPH_PROMPTS:
        eng.add_request(list(p), max_new_tokens=24)
    while eng._queue or eng._prefill_off:
        eng._admit()
    eng._spec_drain()
    res = audit.spec_graph_matches_eager(eng, rounds)
    assert res['commit_equal'] and res['n_commit_equal'] \
        and res['cache_equal'] and res['tokens_equal'], res
    assert res['captures'] == 1 and res['replays'] == 1, res
    done = eng.run_to_completion()
    assert all(len(r.output) == 24 for r in done.values())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('sq', [2, 3, 5, 9])
@pytest.mark.parametrize('split', [100, 1024])
def test_flash_chunk_at_verify_width_matches_plain(cuda, dtype, sq, split):
    """K3 at a verify round's shape (sq = k + 1 query rows against a
    cache prefix) at llama2-7b's heads against ``flash_chunk_reference``,
    with the cache rows past each length poisoned; the launch is counted
    under its query rows."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v = _flash_inputs(dtype, 4, sq, split + sq, 32, 32, 128, seed=21)
    lens = [0, 1, split // 2 + 1, split]
    for row, n in enumerate(lens):
        k[row, n:split] = 1e4
        v[row, n:split] = 1e4
    cache_len = torch.tensor(lens, dtype=torch.int32, device='cuda')
    before = fa.chunk_launches_by_sq.get(sq, 0)
    out = fa.flash_chunk_attention(q, k[:, split:], v[:, split:],
                                   k[:, :split], v[:, :split], cache_len)
    torch.cuda.synchronize()
    assert fa.chunk_launches_by_sq[sq] == before + 1
    want = fa.flash_chunk_reference(q.float(), k.float(), v.float(),
                                    cache_len, split)
    tol, rounding, _ = FLASH_TOL[dtype]
    assert bool(torch.isfinite(out).all())
    assert _flash_err(out, want, rounding) <= tol


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_speculative_equals_vanilla_fp32_on_card(cuda, kind):
    """Greedy speculative decoding on the card (verify rounds and fused
    rounds as graphs; K3 in the slot engine's rounds) gives the vanilla
    stream at fp32, k = 4, with proposals accepted; the slot engine's
    verify rounds launch K3 at sq = 5."""
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.ops import flash_attention as fa
    cfg = dataclasses.replace(GRAPH_CFG, dtype=torch.float32)
    params = llama.init_params(cfg, 0, device='cuda')
    prompts = [[5, 9, 2, 7] * 6, list(range(3, 43)), [11, 12] * 20]

    def run(**kw):
        if kind == 'paged':
            eng = PagedInferenceEngine(cfg, params, max_batch=3,
                                       max_seq=256, page_size=16,
                                       n_pages=64, device='cuda', **kw)
        else:
            eng = InferenceEngine(cfg, params, max_batch=3, max_seq=256,
                                  device='cuda', **kw)
        rids = [eng.add_request(list(p), max_new_tokens=20)
                for p in prompts]
        done = eng.run_to_completion(horizon=4)
        return [done[r].output for r in rids], eng
    want, _ = run()
    for fused in (None, 3):
        fa.chunk_launches_by_sq.clear()
        got, eng = run(speculate_k=4, decode_steps_per_call=fused)
        assert got == want
        assert eng.spec_metrics()['spec_accepted'] > 0
        assert eng.graph_stats()['graph_replays'] > 0
        if kind == 'slot':
            assert fa.chunk_launches_by_sq.get(5, 0) > 0


@pytest.mark.parametrize('which', ['paged', 'slot', 'fused'])
def test_spec_audits_on_card(cuda, which):
    """The speculative steady state on the card: no capture after the
    warm-up, no unsanctioned sync (sync debug mode), one sanctioned sync
    per dispatch; fused, one dispatch per 3 rounds."""
    from skypilot_tpu_torch.analysis import audit
    if which == 'fused':
        report = audit.audit_spec_multistep(4, 3, cfg=GRAPH_CFG)
        assert report.fallbacks == 0
    else:
        report = audit.audit_engine(which, cfg=GRAPH_CFG, speculate_k=4)
    assert report.ok(), report.violations()
    assert report.captures[0] > 0 and not report.syncs
    assert report.spec_syncs == report.dispatches > 0


# --------------------------------------------------------------------------
# KV handoff, prefix warm-up and checkpoint on the card
# --------------------------------------------------------------------------
def _handoff_engine(kind, kv, params, **kw):
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    if kind == 'paged':
        return PagedInferenceEngine(GRAPH_CFG, params, max_batch=3,
                                    max_seq=256, page_size=16, chunk=32,
                                    n_pages=48, kv_cache_dtype=kv,
                                    device='cuda', **kw)
    return InferenceEngine(GRAPH_CFG, params, max_batch=3, max_seq=256,
                           prefill_chunk_tokens=32, kv_cache_dtype=kv,
                           device='cuda', **kw)


def _engine_buffers(eng):
    c = eng.cache
    tensors = ((c.pool_k, c.pool_v, c.k_scale, c.v_scale)
               if hasattr(c, 'pool_k') else tuple(c.tensors()) + (c.length,))
    return [t.data_ptr() for t in tensors if t is not None] + [
        eng._tok_dev.data_ptr(), eng._buf.meta.data_ptr()]


@pytest.mark.parametrize('kind,kv,impl', [
    ('paged', 'bf16', 'pallas'), ('paged', 'int8', 'pallas'),
    ('paged', 'int4', 'pallas'), ('paged', 'int8', 'cross_layer'),
    ('slot', 'bf16', None), ('slot', 'int8', None)])
def test_handoff_equals_colocated_on_card(cuda, kind, kv, impl):
    """Export after the first token (one sanctioned readback), the wire,
    ingest into a second engine that shares the weights: the greedy
    stream equals the colocated one bit for bit, decode replaying K1/K2
    (paged) or the slot decode graphs; the ingest writes the engine's
    buffers in place (no pointer the graphs hold changes)."""
    from skypilot_tpu_torch.inference import kv_transfer
    from skypilot_tpu_torch.utils import device as dev
    params = llama.init_params(GRAPH_CFG, 0, device='cuda')
    kw = {'decode_impl': impl} if impl else {}
    prompt = GRAPH_PROMPTS[2]
    ref_eng = _handoff_engine(kind, kv, params, **kw)
    rid = ref_eng.add_request(list(prompt), max_new_tokens=24)
    want = ref_eng.run_to_completion(horizon=8)[rid].output
    src = _handoff_engine(kind, kv, params, **kw)
    rid = src.add_request(list(prompt), max_new_tokens=24, hold=True)
    while not any(r is not None and r.output for r in src._slots):
        src.step(horizon=8)
    src.drain_pipeline()
    n0 = dev.host_sync_count()
    snap, events = src.export_kv_snapshot(rid)
    assert events == [] and dev.host_sync_count() - n0 == 1
    assert snap['output'] == want[:1]
    blob = kv_transfer.encode_handoff(snap)
    dst = _handoff_engine(kind, kv, params, **kw)
    ptrs = _engine_buffers(dst)
    pa.reset_launch_counts()
    rid2 = dst.ingest_kv_snapshot(kv_transfer.decode_handoff(blob))
    assert _engine_buffers(dst) == ptrs
    assert dst.run_to_completion(horizon=8)[rid2].output == want
    assert _engine_buffers(dst) == ptrs
    assert dst.graph_stats()['graph_replays'] > 0
    if kind == 'paged':
        key = ('paged_decode_attention_fused' if impl == 'cross_layer'
               else 'paged_decode_attention')
        assert pa.launch_counts[f'{key}[{kv}]'] > 0


@pytest.mark.parametrize('kind,what,kv', [
    ('paged', 'ingest', 'bf16'), ('paged', 'ingest', 'int8'),
    ('paged', 'ingest', 'int4'), ('paged', 'warm', 'bf16'),
    ('slot', 'ingest', 'bf16'), ('slot', 'ingest', 'int8')])
def test_decode_after_landing_replays_captured_graphs(cuda, kind, what, kv):
    """``audit_handoff`` on the card: after one warm-up round, rounds that
    land new rows (ingest, or warm_prefix and the prefix hits it gives)
    capture no graph, use no new key and make no unsanctioned sync (sync
    debug mode on), the landing included."""
    from skypilot_tpu_torch.analysis import audit
    report = audit.audit_handoff(kind, what, cfg=GRAPH_CFG,
                                 kv_cache_dtype=kv)
    assert report.ok(), report.violations()
    assert report.captures[0] > 0 and not report.syncs
    assert report.landed_rows > 0 and report.dispatches > 0
    if what == 'warm':
        assert report.prefix_hits > 0


def test_warm_prefix_lands_exact_bytes_on_card(cuda):
    """A chain exported from one card engine and warmed into another
    reads back with the same bytes, and the pool tensors are the same
    tensors."""
    params = llama.init_params(GRAPH_CFG, 0, device='cuda')
    for kv in ('bf16', 'int8', 'int4'):
        src = _handoff_engine('paged', kv, params)
        rid = src.add_request(list(GRAPH_PROMPTS[2]), max_new_tokens=4)
        src.run_to_completion(horizon=8)
        src.pop_finished(rid)
        entries, _ = src.export_prefix_snapshots()
        dst = _handoff_engine('paged', kv, params)
        ptrs = _engine_buffers(dst)
        assert sum(dst.warm_prefix(e) for e in entries) > 0
        again, _ = dst.export_prefix_snapshots()
        assert _engine_buffers(dst) == ptrs
        for a, b in zip(entries, again):
            for key in ('k', 'v', 'k_scale', 'v_scale'):
                if a[key] is None:
                    continue
                ta = a[key] if torch.is_tensor(a[key]) else torch.from_numpy(
                    a[key])
                tb = b[key] if torch.is_tensor(b[key]) else torch.from_numpy(
                    b[key])
                assert torch.equal(ta, tb), (kv, key)


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_hold_on_card_keeps_the_held_token(cuda, kind):
    """A held request beside a decoding one (fp32, so a row's stream does
    not depend on its batch): no token while held, its token in the
    decode vector restored after every replayed call without a sync (the
    sync debug mode raises on one), and after ``release_hold`` the
    colocated stream."""
    cfg = dataclasses.replace(GRAPH_CFG, dtype=torch.float32,
                              name='graphs-d64-fp32')
    params = llama.init_params(cfg, 0, device='cuda')

    def make():
        from skypilot_tpu_torch.inference.engine import InferenceEngine
        if kind == 'paged':
            return PagedInferenceEngine(cfg, params, max_batch=3,
                                        max_seq=256, page_size=16, chunk=32,
                                        n_pages=48, device='cuda')
        return InferenceEngine(cfg, params, max_batch=3, max_seq=256,
                               prefill_chunk_tokens=32, device='cuda')
    held_p, other_p = GRAPH_PROMPTS[1], GRAPH_PROMPTS[2]
    ref = make()
    r = ref.add_request(list(held_p), max_new_tokens=16)
    want = ref.run_to_completion(horizon=4)[r].output
    eng = make()
    rid = eng.add_request(list(held_p), max_new_tokens=16, hold=True)
    other = eng.add_request(list(other_p), max_new_tokens=24)
    while not any(q is not None and q.request_id == rid and q.output
                  for q in eng._slots):
        eng.step(horizon=4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        for _ in range(4):
            assert [e for e in eng.step(horizon=4) if e[0] == rid] == []
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert eng.graph_stats()['graph_replays'] > 0
    assert eng.release_hold(rid)
    done = eng.run_to_completion(horizon=4)
    assert done[rid].output == want
    assert len(done[other].output) == 24


# --------------------------------------------------------------------------
# The serving front: telemetry around replayed graphs, drain
# --------------------------------------------------------------------------
def _front_engine(kind, **kw):
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    params = llama.init_params(GRAPH_CFG, 0, device='cuda')
    if kind == 'paged':
        return PagedInferenceEngine(GRAPH_CFG, params, max_batch=3,
                                    max_seq=256, page_size=16, chunk=32,
                                    n_pages=48, device='cuda', **kw)
    return InferenceEngine(GRAPH_CFG, params, max_batch=3, max_seq=256,
                           prefill_chunk_tokens=32, device='cuda', **kw)


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_substep_counter_and_traces_close_under_replay(cuda, kind):
    """Host telemetry sits outside the captured callables: after decode
    calls replayed from graphs, ``skytpu_engine_decode_substeps_total``
    equals calls x horizon (the pinned k) and the engine's substeps, and
    every finished request's trace has closed ``queue``, ``prefill`` and
    ``decode`` spans (a span opened inside a captured body would close
    once, at capture, and never on replay)."""
    from skypilot_tpu_torch.telemetry import registry, tracing
    reg = registry.reset_registry()
    tracing.get_trace_buffer().clear()
    eng = _front_engine(kind, decode_steps_per_call=4)
    for _ in range(2):                      # the second wave replays
        rids = [eng.add_request(list(p), max_new_tokens=21)
                for p in GRAPH_PROMPTS]
        done = eng.run_to_completion(horizon=4)
        assert all(len(done[r].output) == 21 for r in rids)
    stats = eng.graph_stats()
    assert stats['graph_replays'] > stats['graph_captures'] > 0
    counter = reg.get('skytpu_engine_decode_substeps_total').value
    assert counter == eng.decode_substeps == 4 * eng.decode_calls > 0
    assert eng.phase_stats()['phases']['decode_enqueue']['substeps'] == \
        eng.decode_substeps
    traces = tracing.get_trace_buffer().snapshot()
    assert len(traces) == 2 * len(GRAPH_PROMPTS)
    for tr in traces:
        names = [s.name for s in tr.spans]
        assert tr.done and {'queue', 'prefill', 'decode'} <= set(names)
        assert all(s.t1 is not None and s.t1 >= s.t0 for s in tr.spans)


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_telemetry_on_off_equal_streams_and_captures(cuda, kind):
    """``audit_telemetry_parity`` on the card: equal streams with
    telemetry off and on, the same captures, and after the first call of
    each key no capture and no unsanctioned sync with telemetry on."""
    from skypilot_tpu_torch.analysis import audit
    report = audit.audit_telemetry_parity(kind, cfg=GRAPH_CFG)
    assert report.ok(), report.violations()
    assert report.streams_equal and report.captures_by_mode[0] > 0
    assert not report.syncs


def test_drain_on_graph_replayed_server_loses_no_request(cuda):
    """A drain on a server whose decode replays graphs: the requests in
    flight finish with their full counts, a new submit gets a 503 with
    ``Retry-After``, and the drain ends drained."""
    import json
    import socket
    import threading
    import time
    import urllib.error
    import urllib.request
    from skypilot_tpu_torch.serve.server import ModelServer
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    params = llama.init_params(GRAPH_CFG, 0, device='cuda')
    srv = ModelServer(GRAPH_CFG, params=params, max_batch=3, max_seq=256,
                      port=port, page_size=16)
    srv.start(block=False)
    base = f'http://127.0.0.1:{port}'

    def post(path, body):
        req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                     {'Content-Type': 'application/json'})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.headers, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers, e.read()
    try:
        srv.wait_ready(timeout=300)
        post('/generate', {'prompt': list(GRAPH_PROMPTS[0]),
                           'max_new_tokens': 8})       # captures
        results = [None] * len(GRAPH_PROMPTS)

        def run(i):
            results[i] = post('/generate', {'prompt': list(GRAPH_PROMPTS[i]),
                                            'max_new_tokens': 120})
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(GRAPH_PROMPTS))]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while srv.engine.num_active < len(GRAPH_PROMPTS) \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        replays0 = srv.engine.graph_stats()['graph_replays']
        status, _, body = post('/drain', {})
        assert status == 200 and json.loads(body)['draining']
        shed = post('/generate', {'prompt': [5, 6, 7], 'max_new_tokens': 2})
        assert shed[0] == 503 and int(shed[1]['Retry-After']) >= 1
        for t in threads:
            t.join(120)
        assert [len(json.loads(r[2])['tokens']) for r in results] == \
            [120] * len(GRAPH_PROMPTS)
        assert srv.engine.graph_stats()['graph_replays'] > replays0
        while not srv.drain_status()['drained'] \
                and time.monotonic() < deadline + 60:
            time.sleep(0.05)
        assert srv.drain_status()['drained']
    finally:
        srv.stop()


# ------------------------------------------------- multi-tenant serving
def _adapter_tree(cfg, rank, seed, sigma=0.05):
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.models import multilora
    return audit._random_adapter(cfg, multilora.default_targets(cfg), rank,
                                 seed, sigma)


def _bank_engine(kind, cfg, params, **kw):
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    if kind == 'paged':
        return PagedInferenceEngine(cfg, params, max_batch=4, max_seq=128,
                                    page_size=16, chunk=32, device='cuda',
                                    **kw)
    return InferenceEngine(cfg, params, max_batch=4, max_seq=128,
                           prefill_chunk_tokens=32, device='cuda', **kw)


def _serve(eng, reqs):
    rids = [eng.add_request(list(p), max_new_tokens=n, **kw)
            for p, n, kw in reqs]
    done = eng.run_to_completion(horizon=8)
    return [done[r].output for r in rids]


_BANK_PROMPTS = [[(7 * i + 3) % 250 + 1 for i in range(40)],
                 [5, 6, 7, 8] * 9, [9, 4] * 17, [11] * 21]


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_bank_base_rows_bit_identical_in_graphs(cuda, kind):
    """bf16 on the card, decode replayed from graphs: base rows batched
    with live adapter rows stream exactly what an engine without a bank
    streams (the gathered slot-0 factors are selected away)."""
    cfg = configs.TINY
    params = llama.init_params(cfg, 0, device='cuda')
    reqs = [(p, 24, {}) for p in _BANK_PROMPTS[:2]]
    want = _serve(_bank_engine(kind, cfg, params), reqs)
    eng = _bank_engine(kind, cfg, params, adapter_slots=2, adapter_rank=8)
    for i in range(2):
        eng.adapters.register(f'ad{i}', _adapter_tree(cfg, 8, i, 0.3),
                              scale=1.0)
    mixed = reqs[:1] + [(_BANK_PROMPTS[2], 24, {'adapter': 'ad0'})] \
        + reqs[1:] + [(_BANK_PROMPTS[3], 24, {'adapter': 'ad1'})]
    got = _serve(eng, mixed)
    assert [got[0], got[2]] == want
    assert eng.graph_stats()['graph_replays'] > 0


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_adapter_loaded_after_capture_is_followed(cuda, kind):
    """A graph captured with one adapter in a slot, that slot then
    overwritten by another adapter: the replayed tokens follow the new
    adapter (equal to a fresh engine that loaded it first)."""
    cfg = configs.TINY
    params = llama.init_params(cfg, 0, device='cuda')
    trees = [_adapter_tree(cfg, 8, s, 0.3) for s in (1, 2)]
    eng = _bank_engine(kind, cfg, params, adapter_slots=1, adapter_rank=8)
    fresh = _bank_engine(kind, cfg, params, adapter_slots=1, adapter_rank=8)
    for e in (eng, fresh):
        for i, t in enumerate(trees):
            e.adapters.register(f'ad{i}', t, scale=1.0)
    req = [(_BANK_PROMPTS[0], 24, {'adapter': 'ad1'})]
    first = _serve(eng, [(_BANK_PROMPTS[0], 24, {'adapter': 'ad0'})])
    captures = eng.graph_stats()['graph_captures']
    got = _serve(eng, req)                         # ad1 evicts ad0
    assert eng.adapters.evictions_total == 1
    assert eng.graph_stats()['graph_captures'] == captures
    assert got == _serve(fresh, req) and got != first


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_adapter_fp32_equals_merged_on_card(cuda, kind):
    """fp32 on the card: a bank-served adapter streams what the
    offline-merged model streams."""
    from skypilot_tpu_torch.models import lora
    cfg = dataclasses.replace(configs.TINY, dtype=torch.float32)
    params = llama.init_params(cfg, 0, device='cuda')
    tree = _adapter_tree(cfg, 8, 3, 0.3)
    lcfg = dataclasses.replace(cfg, lora_rank=8, lora_alpha=8.0,
                               lora_targets=tuple(tree))
    _, merged = lora.merge(lcfg, lora.with_lora(params, {
        t: {k: torch.from_numpy(v).cuda() for k, v in ab.items()}
        for t, ab in tree.items()}))
    eng = _bank_engine(kind, cfg, params, adapter_slots=2, adapter_rank=8)
    eng.adapters.register('acme', tree, scale=1.0)
    reqs = [(_BANK_PROMPTS[0], 16, {'adapter': 'acme'}),
            (_BANK_PROMPTS[1], 16, {})]
    got = _serve(eng, reqs)
    plain = [(p, n, {}) for p, n, _ in reqs]
    assert got[0] == _serve(_bank_engine(kind, cfg, merged), plain)[0]
    assert got[1] == _serve(_bank_engine(kind, cfg, params), plain)[1]


@pytest.mark.parametrize('kind,spec', [('paged', 0), ('slot', 0),
                                       ('paged', 2), ('slot', 2)])
def test_adapter_audit_on_card(cuda, kind, spec):
    """Adapter load and evict churn with grammar masks live: no capture
    after warm-up, no unsanctioned sync, the bank unmoved."""
    from skypilot_tpu_torch.analysis import audit
    rep = audit.audit_adapters(kind, speculate_k=spec, device='cuda')
    assert rep.ok(), rep.violations()
    assert rep.adapter_loads > 0 and rep.adapter_evictions > 0


# --------------------------------------------------- LoRA fine-tuning
LORA_TARGETS = ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down')


def _lora_cfg(remat, dtype=torch.float32, targets=LORA_TARGETS):
    """A small model the flash kernels take (head_dim 64, GQA 4/2) with
    rank-4 adapters."""
    return dataclasses.replace(
        configs.TINY, dim=256, n_heads=4, n_kv_heads=2, ffn_dim=512,
        vocab_size=512, dtype=dtype, remat=remat, lora_rank=4,
        lora_alpha=8.0, lora_targets=targets)


def _lora_params(cfg):
    """CPU params with live adapters (``b`` away from its zeros)."""
    params = llama.init_params(cfg, 0, device='cpu')
    gen = torch.Generator().manual_seed(1)
    for ab in params['layers']['lora'].values():
        ab['b'].normal_(0.0, 0.05, generator=gen)
    return params


def _lora_batch(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (2, 129), generator=gen)
    return {'inputs': toks[:, :-1], 'targets': toks[:, 1:]}


def test_lora_step_on_card_matches_cpu(cuda):
    """fp32 LoRA on the card (K4, K5a, K5b on the CUDA cores) against the
    plain versions on the CPU from the same params and batch: loss and
    grad norm within 1e-5 relative and every adapter gradient within
    1e-4 of the largest (fp32 sums in another order); then one step on
    the card moves ``b`` and leaves every base leaf bit for bit."""
    from skypilot_tpu_torch.models import lora
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import trainer as tr
    from skypilot_tpu_torch.train.optim import global_norm, tree_leaves
    cfg = _lora_cfg('block')
    params = _lora_params(cfg)
    batch = _lora_batch(cfg)
    cpu_loss, _, cpu_grads = tr.value_and_grad(params, batch, cfg)
    card = _tree_to(params, 'cuda')
    fa.reset_launch_counts()
    loss, _, grads = tr.value_and_grad(
        card, {k: v.cuda() for k, v in batch.items()}, cfg)
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert fa.launch_counts == {'flash_fwd': 2 * L, 'flash_fwd_chunk': 0,
                                'flash_bwd_dkv': L, 'flash_bwd_dq': L}
    assert abs(float(loss) - float(cpu_loss)) <= 1e-5 * abs(float(cpu_loss))
    assert abs(float(global_norm(grads)) - float(global_norm(cpu_grads))) \
        <= 1e-5 * float(global_norm(cpu_grads))
    scale = max(float(g.abs().max()) for g in tree_leaves(cpu_grads))
    for g, w in zip(tree_leaves(grads), tree_leaves(cpu_grads)):
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * scale
    trainer = tr.Trainer(cfg, device='cuda', train_config=tr.TrainConfig(
        learning_rate=1e-3, warmup_steps=0, total_steps=4))
    state = trainer.state_from_params(card)
    base = [t.clone() for t in tree_leaves(
        {k: v for k, v in card.items() if k != 'layers'})] + [
        t.clone() for k, t in card['layers'].items() if k != 'lora']
    b0 = card['layers']['lora']['wq']['b'].clone()
    state, m = trainer.step(state, batch)
    assert bool(torch.isfinite(m['loss']))
    after = [t for t in tree_leaves(
        {k: v for k, v in state.params.items() if k != 'layers'})] + [
        t for k, t in state.params['layers'].items() if k != 'lora']
    assert all(torch.equal(a, b) for a, b in zip(after, base))
    assert not torch.equal(lora.split_lora(state.params)['wq']['b'], b0)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_lora_remat_policies_equal_on_card(cuda, dtype):
    """The same LoRA gradients under 'none', 'block', 'attn' and 'dots'
    on the card, bit for bit (K4, K5a and K5b sum in a fixed order, no
    atomics); K4 launches 2L times under 'block' and 'dots' and L times
    under 'none' and 'attn'."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import trainer as tr
    from skypilot_tpu_torch.train.optim import tree_leaves
    params = _tree_to(_lora_params(_lora_cfg('none', dtype)), 'cuda')
    batch = {k: v.cuda() for k, v in _lora_batch(_lora_cfg('none')).items()}
    runs = {}
    for remat in ('none', 'block', 'attn', 'dots'):
        cfg = _lora_cfg(remat, dtype)
        fa.reset_launch_counts()
        runs[remat] = tr.value_and_grad(params, batch, cfg)
        torch.cuda.synchronize()
        L = cfg.n_layers
        assert fa.launch_counts['flash_fwd'] == (
            2 * L if remat in ('block', 'dots') else L), remat
        assert fa.launch_counts['flash_bwd_dkv'] == L
        assert fa.launch_counts['flash_bwd_dq'] == L
    for remat in ('block', 'attn', 'dots'):
        assert torch.equal(runs[remat][0], runs['none'][0]), remat
        for a, b in zip(tree_leaves(runs[remat][2]),
                        tree_leaves(runs['none'][2])):
            assert torch.equal(a, b), remat


def test_lora_first_layer_skips_unneeded_backward_kernels(cuda):
    """Adapters on wq alone: layer 0's k and v need no gradient, so its
    K5a (dk, dv) is not launched; every layer launches K5b."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import trainer as tr
    cfg = _lora_cfg('attn', targets=('wq',))
    params = _tree_to(_lora_params(cfg), 'cuda')
    fa.reset_launch_counts()
    tr.value_and_grad(params, {k: v.cuda() for k, v in
                               _lora_batch(cfg).items()}, cfg)
    torch.cuda.synchronize()
    assert fa.launch_counts['flash_bwd_dkv'] == cfg.n_layers - 1
    assert fa.launch_counts['flash_bwd_dq'] == cfg.n_layers
