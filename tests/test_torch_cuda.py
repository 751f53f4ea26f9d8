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
                                      (8, 1, 128)])
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


GEOS = [(8, 8, 64), (8, 2, 128), (4, 4, 256), (8, 1, 128)]


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
    w = quantization._quantize_array(
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


# ----------------------------------------------------------- K3 and K4
# chip_smoke.py's geometries: 7B MHA, GQA 32/8, d 64 and d 256.
FLASH_GEOS = [(32, 32, 128), (32, 8, 128), (32, 32, 64), (16, 16, 256)]
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
                                      (8, 1, 64)])
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
TC_GEOS = [(d, g) for d in (64, 128, 256) for g in (1, 4, 8)]
TC_SHAPES = [(1, True), (17, True), (100, True), (300, True),
             (2048, True), ((100, 300), False)]


def _tc_case(d, g, shape, causal):
    sq, skv = shape if isinstance(shape, tuple) else (shape, shape)
    hkv = 1 if g == 8 else 2
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
    hkv = 1 if g == 8 else 2
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
