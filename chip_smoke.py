#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``skypilot_tpu_torch``) on one NVIDIA GPU.

Phases, one JSON line each; any failure exits non-zero:

1. device  — CUDA must be present; the card's name and power limit as
   ``nvidia-smi`` reports them.
2. build   — compile every CUDA kernel of the port from the sources in
   this checkout (one ``nvcc`` per source, all at once); count the
   tensor-core (HMMA) instructions of each flash kernel in its SASS
   (``cuobjdump``): the twelve bf16 bodies (K4, K3, K5a, K5b at d 64,
   128 and 256) must have them, no CUDA-core flash body is compiled for
   bf16, and no flash kernel spills registers (``ptxas -v``).
3. kernel_check — each kernel against its plain PyTorch version on the
   card, at the main paths' geometries, with the tolerance stated: K1
   (``paged_decode``) on bf16/fp32 pools and on int8 and int4 code
   pools, K2 (``paged_decode_fused``) on all four with ring_len 0, 1
   and H; K4 (``flash_fwd``) causal at sq 64, 256 and 2048 and full
   attention, K3 (``flash_fwd_chunk``) at sq 64 and 256 against 64, 512
   and 1792 cache rows with cache lengths 0, mid and full, then again
   with the cache rows past each cache length poisoned (1e4); K5a
   (``flash_bwd_dkv``) and K5b (``flash_bwd_dq``) at d 64, 128 and 256,
   groups 1, 4 and 8, causal at sq 100 and 300 and full at 100 x 300,
   bf16 and fp32. bf16 flash kernels run on the tensor cores, fp32 on
   the CUDA cores (``impl`` on each line); each K4/K5 line also carries
   ``sdpa_err``, the same error measure for
   ``scaled_dot_product_attention`` (forward, or its backward) against
   the same plain version, as the yardstick of what a library kernel
   gives. autograd_check — ``attention(impl='flash')`` backward (K4,
   K5a, K5b) against autograd through the plain forward at the
   llama3-1b training shape.
4. kernel_time — K1/K2 at llama2-7b decode (batch 8, context 1024), K4
   and K3 at the 7B prefill shapes the slot engine serves and at a long
   shape, K4, K5a and K5b at the llama3-1b training shape (batch 8, seq
   2048, 32/8 heads, d 64) and at the 7B shape (1 x 2048, 32/32, d 128),
   each beside its bound (bytes over the memory rate, operations over
   the peak for their operands' type), the plain version's time and one
   PyTorch library call's time (K5: the backward of
   ``scaled_dot_product_attention``). weight_path — one decode step's
   weight matmuls at batch 8 with bf16 weights and with int8 codes
   (which ``qeinsum`` widens to bf16 per call), in turns.
   kv_probe — K6 (``paged_decode_all_layers``), the KV bandwidth probe:
   all 32 layers' cache partials of llama2-7b's pool at the serve shape
   (8 slots at context 1024) in one launch, for bf16, int8 and int4
   pools in turn (each freed before the next); K6 against its plain
   version and bit for bit against 32 K1 launches, and timed beside its
   bound, the 32 K1 launches, the plain version and one SDPA call over
   all layers' gathered bf16 rows.
5. serve   — ``ModelServer('llama2-7b')`` (bf16 random weights from a
   seed, full width) answering concurrent ``/v1/completions`` and
   ``/generate`` requests; K1 launches, TTFT, TPOT, tok/s, peak memory;
   the kernel path's layer attention against the plain path's.
6. serve_slot — the same weights and requests through
   ``ModelServer(kv_cache='slot')``: chunked prefill on K4 (first
   chunks) and K3 (chunks against the cache), no paged kernel.
7. serve_int8 — ``quantize='int8'``: int8 weights quantized on the
   card, int8 paged KV, K1 on int8 codes.
8. decode_variants — two engines over the same int8 weights: int4 KV
   through K1, and int8 KV through K2 (``decode_impl='cross_layer'``).
9. reference — a small fp32 model served on the card (kernel paths) and
   on the CPU (plain paths) from the same weights gives the same greedy
   tokens: the paged engine for bf16, int8 and int4 KV, the slot engine
   chunked and monolithic.
10. train — ``Trainer.fit`` trains ``llama3-1b`` at full width (bf16,
    remat 'block', fp32 Adam mu, random weights from the seed) on batch
    8 x seq 2048 from ``packed_batches`` over a seeded corpus for 6
    steps: finite and falling loss, K4 twice and K5a/K5b once per layer
    per step, no other kernel; step time, tok/s, FLOP rate and its share
    of the bf16 peak, peak memory, the share of the step in K4 + K5.
11. train_reference — a small fp32 model (head_dim 64) trained 3 steps
    on the card (K4, K5a, K5b) and on the CPU (plain paths) from the
    same params: losses and grad norms agree.

Then the ``kernels`` line (K3's entry also times the long shape, K5b's
the 7B shape, under ``times_by_shape``) and, last, ``{"ok": true,
"device": ...}``.
Every launch count in the ``kernels`` line is from a main-path phase
(5-8, 10, and ``kv_probe`` for K6), with the counts set to 0 just
before it; launches made to compare or time a kernel do not count.
K4's count adds its two paths (``serve_slot`` prefill and ``train``).

Run with no arguments: ``python3 chip_smoke.py``. Imports nothing of
JAX and nothing of the ``skypilot_tpu`` package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

BW_BYTES_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
# Peak operation rates (H100 SXM data sheet, dense) by operand type:
# fp32 outside the tensor cores (the fp32 kernels and the decode kernels
# K1/K2, whose work is fp32 CUDA-core arithmetic), and bf16 on the
# tensor cores (the flash kernels' bf16 matmuls).
FLOP_PEAKS = {'fp32_cuda_cores': 67e12, 'bf16_tensor_cores': 989e12}
TOL_OUT = 2e-3                # normalised output, max abs
TOL_PARTIAL = 2e-3            # acc and l, max abs relative to max(l, 1)
TOL_M = 1e-4                  # running max, max abs; bf16 logsumexp
TOL_FP32 = 1e-5               # fp32 flash output and logsumexp, max abs:
                              # the same fp32 sums in another order
BF16_ULP = 2.0 ** -8          # one bf16 rounding, relative: K2 writes
                              # its output in q's dtype, so a bf16 output
                              # may differ from the plain version's by
                              # one rounding on top of TOL_OUT
GEOMETRIES = [('llama2-7b', dict(hq=32, hkv=32, d=128)),
              ('gqa', dict(hq=32, hkv=8, d=128)),
              ('d64', dict(hq=32, hkv=32, d=64)),
              ('d256', dict(hq=16, hkv=16, d=256))]
RING_H = 8                    # ring rows of the K2 checks and timing


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


# --------------------------------------------------------------------- 1
def phase_device(torch):
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {'phase': 'device', 'nvidia_smi': smi,
            'name': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count(),
            'torch': torch.__version__, 'cuda': torch.version.cuda}
    emit(info)
    return info


# --------------------------------------------------------------------- 2
def _cuobjdump():
    """The toolkit's ``cuobjdump`` (PATH, $CUDA_HOME, /usr/local/cuda)."""
    import shutil
    found = shutil.which('cuobjdump')
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        cand = os.path.join(root or '', 'bin', 'cuobjdump')
        if not found and root and os.path.exists(cand):
            found = cand
    require(found is not None, 'cuobjdump not found')
    return found


def _kernel_label(mangled):
    """'flash_fwd_kernel_tc<64>' or 'flash_fwd_kernel<bf16,128,chunk>'
    from a mangled kernel name (anonymous namespace, plain templates)."""
    import re
    m = re.search(r'\d+(flash_\w*?kernel(?:_tc)?)I(.*?)EEvNS_4ArgsE', mangled)
    if m is None:
        return mangled
    args = (m.group(2).replace('13__nv_bfloat16', 'bf16,')
            .replace('Lb1E', 'chunk,').replace('Lb0E', ''))
    args = re.sub(r'^f(?=L)', 'fp32,', args)
    args = re.sub(r'Li(\d+)E?', r'\1,', args).strip(',')
    return f'{m.group(1)}<{args}>'


def _sass_hmma(lib_path):
    """Tensor-core (HMMA) instructions per kernel in a library's SASS."""
    out = subprocess.run([_cuobjdump(), '--dump-sass', lib_path],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if 'Function :' in line:
            fn = _kernel_label(line.split('Function :')[1].strip())
            counts[fn] = 0
        elif fn is not None and 'HMMA' in line:
            counts[fn] += 1
    return counts


def phase_build():
    from skypilot_tpu_torch.ops import _build
    for name in _build.SOURCES:      # built anew: the report is this run's
        if os.path.exists(_build.library_path(name)):
            os.unlink(_build.library_path(name))
    t0 = time.monotonic()
    paths = _build.build_all()
    hmma = {name: _sass_hmma(_build.library_path(name))
            for name in ('flash_fwd', 'flash_bwd')}
    # K4, K3, K5a and K5b at d 64, 128 and 256: twelve bf16 bodies.
    tc = {k: n for lib in hmma.values() for k, n in lib.items()
          if '_tc<' in k}
    require(len(tc) == 12 and all(n > 0 for n in tc.values()),
            f'bf16 flash bodies without tensor-core instructions: {tc}')
    cuda_core_bf16 = [k for lib in hmma.values() for k in lib
                      if any(f'{body}<bf16' in k for body in (
                          'flash_fwd_kernel', 'flash_bwd_dkv_kernel',
                          'flash_bwd_dq_kernel'))]
    require(not cuda_core_bf16,
            f'CUDA-core flash bodies compiled for bf16: {cuda_core_bf16}')
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if 'registers' in ln]
            for name, log in _build.build_logs.items()}
    spills = {k: sum(' 0 bytes spill stores' not in ln
                     for ln in log.splitlines() if 'spill stores' in ln)
              for k, log in _build.build_logs.items()}
    emit({'phase': 'build', 'seconds': round(time.monotonic() - t0, 3),
          'libraries': [os.path.relpath(p) for p in paths],
          'ptxas_register_lines': {k: len(v) for k, v in regs.items()},
          'ptxas_max_registers': {
              k: max((int(ln.split('Used ')[1].split(' registers')[0])
                      for ln in v if 'Used ' in ln), default=None)
              for k, v in regs.items()},
          'ptxas_spills': spills, 'sass_hmma_by_kernel': hmma})
    require(spills['flash_fwd'] == 0 and spills['flash_bwd'] == 0,
            f'flash kernels spill registers: {spills}')


# --------------------------------------------------------------------- 3
def _cuda_ms(torch, fn, n_iter, n_warm=3):
    for i in range(n_warm):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def _make_paged_inputs(torch, *, slots, hq, hkv, d, page, P, lengths,
                       L, dtype, seed, kind=None):
    """q, pools (K and V), scales (None for bf16/fp32 pools), table and
    lengths on the card. ``kind`` 'int8'/'int4' quantizes random rows
    with the port's own row quantizers, as the engine writes them."""
    from skypilot_tpu_torch.models import llama
    gen = torch.Generator(device='cuda').manual_seed(seed)
    n_pages = slots * P + 1
    shape = (L, n_pages, hkv, page, d)
    pools, scales = [], []
    for _ in range(2):
        rows = torch.randn(shape, generator=gen, device='cuda')
        if kind in ('int8', 'int4'):
            quant = (llama.quantize_kv_rows if kind == 'int8'
                     else llama.quantize_kv_rows4)
            codes, sc = quant(rows)
            pools.append(codes)
            scales.append(sc[..., 0].contiguous())
        else:
            pools.append(rows.to(dtype))
            scales.append(None)
        del rows
    q = torch.randn((slots, hq, d), generator=gen, device='cuda').to(dtype)
    # Distinct pages per slot, page 0 reserved (engine style).
    perm = torch.randperm(n_pages - 1, generator=gen, device='cuda') + 1
    table = perm[:slots * P].reshape(slots, P).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    return (q, pools[0], pools[1], scales[0], scales[1], table.contiguous(),
            lens)


def _ring_inputs(torch, slots, hkv, d, dtype, seed):
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def f(*shape):
        return torch.randn(shape, generator=gen, device='cuda').to(dtype)
    return (f(slots, hkv, d), f(slots, hkv, d), f(slots, RING_H, hkv, d),
            f(slots, RING_H, hkv, d))


def _check_k1(torch, pa, ins):
    q, pk, pv, ks, vs, table, lens = ins
    got = pa.paged_decode_attention(q, pk, pv, table, lens, ks, vs, layer=1)
    torch.cuda.synchronize()
    want = pa.paged_decode_attention_reference(q, pk, pv, table, lens, ks,
                                               vs, layer=1)
    return _check_partial(torch, got, want, lens)


def _check_partial(torch, got, want, lens):
    """A decode partial (acc, m, l; K1 or, stacked over layers, K6)
    against its plain version: acc and l over max(l, 1), m, the output
    they normalise to, and the empty-slot sentinel."""
    (acc_k, m_k, l_k), (acc_r, m_r, l_r) = got, want
    norm = torch.clamp(l_r, min=1.0)
    err_acc = ((acc_k - acc_r).abs() / norm[..., None]).max().item()
    err_l = ((l_k - l_r).abs() / norm).max().item()
    err_m = (m_k - m_r).abs().max().item()
    live = l_r > 0
    out_k = acc_k[live] / l_k[live][:, None]
    out_r = acc_r[live] / l_r[live][:, None]
    err_out = (out_k - out_r).abs().max().item()
    empty = (lens == 0)[:, None].expand(m_k.shape)
    sentinel = bool((m_k[empty] == -1e30).all() and (l_k[empty] == 0).all()
                    and (acc_k[empty] == 0).all())
    finite = bool(torch.isfinite(acc_k).all() and torch.isfinite(l_k).all())
    ok = (err_acc <= TOL_PARTIAL and err_l <= TOL_PARTIAL
          and err_m <= TOL_M and err_out <= TOL_OUT and sentinel and finite)
    return ok, {'max_abs_err_acc_over_l': err_acc,
                'max_abs_err_l_over_l': err_l, 'max_abs_err_m': err_m,
                'max_abs_err_out': err_out, 'empty_slot_sentinel': sentinel,
                'tol_acc_l': TOL_PARTIAL, 'tol_m': TOL_M,
                'tol_out': TOL_OUT}


def _check_k2(torch, pa, ins, ring):
    q, pk, pv, ks, vs, table, lens = ins
    k_self, v_self, ring_k, ring_v = ring
    errs, excess = {}, {}
    finite = True
    rounding = BF16_ULP if q.dtype == torch.bfloat16 else 0.0
    for ring_len in (0, 1, RING_H):
        got = pa.paged_decode_attention_fused(
            q, k_self, v_self, ring_k, ring_v, ring_len, pk, pv, table,
            lens, ks, vs, layer=1)
        torch.cuda.synchronize()
        want = pa.paged_decode_attention_fused_reference(
            q, k_self, v_self, ring_k, ring_v, ring_len, pk, pv, table,
            lens, ks, vs, layer=1)
        finite = finite and bool(torch.isfinite(got).all())
        diff = (got.float() - want.float()).abs()
        errs[ring_len] = diff.max().item()
        excess[ring_len] = (diff - rounding * want.float().abs()).max().item()
    ok = finite and max(excess.values()) <= TOL_OUT
    return ok, {'ring_H': RING_H, 'max_abs_err_out_by_ring_len': errs,
                'max_err_beyond_output_rounding': excess,
                'tol_out': TOL_OUT, 'output_rounding': rounding}


def phase_kernel_checks(torch, page):
    """Every kernel against its plain version at every listed geometry
    and pool kind, 8 slots with mixed lengths (0 included). Returns the
    worst normalised-output error per kernel name."""
    from skypilot_tpu_torch.ops import paged_attention as pa
    P = 2048 // page
    full = P * page
    mixed = [0, 1, page + 72, full, 1024, 513, page, 777]
    cases = [(n, geo, torch.bfloat16, kind) for kind in ('bf16', 'int8',
                                                          'int4')
             for n, geo in GEOMETRIES]
    cases += [('llama2-7b-fp32', GEOMETRIES[0][1], torch.float32, kind)
              for kind in ('fp32', 'int8', 'int4')]
    worst = {}
    before = dict(pa.launch_counts)
    for name, geo, dtype, kind in cases:
        ins = _make_paged_inputs(
            torch, slots=8, page=page, P=P, lengths=mixed, L=2,
            dtype=dtype, seed=len(name) + len(kind), kind=kind, **geo)
        k1 = 'paged_decode' if kind in ('bf16', 'fp32') else \
            f'paged_decode_{kind}'
        ring = _ring_inputs(torch, 8, geo['hkv'], geo['d'], dtype,
                            seed=len(name))
        for kernel, (ok, errs) in (
                (k1, _check_k1(torch, pa, ins)),
                ('paged_decode_fused', _check_k2(torch, pa, ins, ring))):
            err = errs.get('max_abs_err_out',
                           max(errs.get('max_abs_err_out_by_ring_len',
                                        {0: 0.0}).values()))
            worst[kernel] = max(worst.get(kernel, 0.0), err)
            emit({'phase': 'kernel_check', 'kernel': kernel, 'case': name,
                  'q_dtype': str(dtype).replace('torch.', ''),
                  'pool': kind, 'slots': 8, 'page': page, 'P': P,
                  'lengths': mixed, **geo, **errs, 'ok': ok})
            require(ok, f'{kernel} disagrees with its plain version '
                        f'({name}, {kind})')
        del ins, ring
    pa.launch_counts.update(before)      # comparison launches do not count
    return worst


# --------------------------------------------------------------------- 4
CTX, SLOTS, LT = 1024, 8, 8    # timing shape: batch 8, context 1024,
                               # 8 pool layers cycled so reads are cold


def _bound(bytes_moved, flops, peak='fp32_cuda_cores'):
    """(bound_ms, 'bytes' | 'operations'): the larger of the bytes over
    the memory rate and the operations over ``FLOP_PEAKS[peak]``."""
    t_bytes, t_ops = bytes_moved / BW_BYTES_S, flops / FLOP_PEAKS[peak]
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def _gathered_bf16(torch, pool, scale, li, table, hkv, d):
    """One layer's pages of every slot as contiguous [slots, hkv, ctx, d]
    bf16, dequantized for code pools (the SDPA yardstick's operand)."""
    from skypilot_tpu_torch.models.quantization import unpack_int4
    g = pool[li][table.long()]                    # [slots, P, hkv, page, d']
    if g.dtype == torch.uint8:
        g = unpack_int4(g, axis=-1)
    g = g.float() if scale is not None else g
    if scale is not None:
        g = g * scale[li][table.long()][..., None]
    return (g.permute(0, 2, 1, 3, 4).reshape(SLOTS, hkv, CTX, d)
            .to(torch.bfloat16).contiguous())


def phase_kernel_times(torch, page):
    """Each kernel timed at the llama2-7b decode shape, beside its bound
    (from this call's inputs), its plain version and one SDPA call."""
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import paged_attention as pa
    hq = hkv = 32
    d = 128
    Pt = CTX // page
    before = dict(pa.launch_counts)
    results = {}
    for kind in ('bf16', 'int8', 'int4'):
        ins = _make_paged_inputs(
            torch, slots=SLOTS, hq=hq, hkv=hkv, d=d, page=page, P=Pt,
            lengths=[CTX] * SLOTS, L=LT, dtype=torch.bfloat16, seed=7,
            kind=kind)
        q, pk, pv, ks, vs, table, lens = ins
        k_self, v_self, ring_k, ring_v = _ring_inputs(torch, SLOTS, hkv, d,
                                                      torch.bfloat16, 9)
        n_rows = SLOTS * CTX
        row_bytes = {'bf16': 2 * d, 'int8': d + 4, 'int4': d // 2 + 4}[kind]
        kv_bytes = 2 * n_rows * hkv * row_bytes            # codes + scales
        small = table.numel() * 4 + SLOTS * 4 + SLOTS * hq * d * 2   # q
        flops = 4 * n_rows * hq * d                        # q.k and p.v
        ksv = [_gathered_bf16(torch, pk, ks, li, table, hkv, d)
               for li in range(LT)]
        vsv = [_gathered_bf16(torch, pv, vs, li, table, hkv, d)
               for li in range(LT)]
        q4 = q[:, :, None, :]
        library_k1 = _cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            q4, ksv[i % LT], vsv[i % LT]), 80)
        name = 'paged_decode' if kind == 'bf16' else f'paged_decode_{kind}'
        ms = _cuda_ms(torch, lambda i: pa.paged_decode_attention(
            q, pk, pv, table, lens, ks, vs, layer=i % LT), 80)
        plain = _cuda_ms(torch, lambda i: pa.paged_decode_attention_reference(
            q, pk, pv, table, lens, ks, vs, layer=i % LT), 5, n_warm=1)
        b = kv_bytes + small + SLOTS * hq * (d + 2) * 4    # + acc, m, l
        bound_ms, bound_by = _bound(b, flops)
        results[name] = {'ms': ms, 'plain_ms': plain,
                         'library_ms': library_k1, 'bound_ms': bound_ms,
                         'bound_by': bound_by, 'bytes': b, 'flops': flops}
        # K2 on the same pool: the page loop plus RING_H ring rows, the
        # current token and a bf16 output.
        ring_len = RING_H
        ksf = [torch.cat([ksv[li], ring_k.permute(0, 2, 1, 3),
                          k_self[:, :, None]], 2) for li in range(LT)]
        vsf = [torch.cat([vsv[li], ring_v.permute(0, 2, 1, 3),
                          v_self[:, :, None]], 2) for li in range(LT)]
        del ksv, vsv
        library_k2 = _cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            q4, ksf[i % LT], vsf[i % LT]), 80)
        del ksf, vsf
        ms2 = _cuda_ms(torch, lambda i: pa.paged_decode_attention_fused(
            q, k_self, v_self, ring_k, ring_v, ring_len, pk, pv, table,
            lens, ks, vs, layer=i % LT), 80)
        plain2 = _cuda_ms(torch, lambda i: (
            pa.paged_decode_attention_fused_reference(
                q, k_self, v_self, ring_k, ring_v, ring_len, pk, pv, table,
                lens, ks, vs, layer=i % LT)), 5, n_warm=1)
        b2 = (kv_bytes + small + 2 * SLOTS * (ring_len + 1) * hkv * d * 2
              + SLOTS * hq * d * 2)
        flops2 = 4 * SLOTS * (CTX + ring_len + 1) * hq * d
        bound2, by2 = _bound(b2, flops2)
        results[f'paged_decode_fused[{kind}]'] = {
            'ms': ms2, 'plain_ms': plain2, 'library_ms': library_k2,
            'bound_ms': bound2, 'bound_by': by2, 'bytes': b2,
            'flops': flops2}
        del ins, q, pk, pv, ks, vs
        torch.cuda.empty_cache()
    pa.launch_counts.update(before)      # timing launches do not count
    for name, r in results.items():
        emit({'phase': 'kernel_time', 'kernel': name,
              'shape': {'slots': SLOTS, 'hq': hq, 'hkv': hkv, 'd': d,
                        'page': page, 'context': CTX, 'q_dtype': 'bfloat16',
                        'ring_len': RING_H if 'fused' in name else None},
              **r, 'flop_peak': 'fp32_cuda_cores',
              'achieved_gb_s': r['bytes'] / (r['ms'] * 1e-3) / 1e9,
              'roofline_share': r['bound_ms'] / r['ms']})
    return results


# ------------------------------------------------------------ 3, 4: K3/K4
FLASH_CASES = ((2, 64, 64, True), (2, 256, 256, True), (1, 2048, 2048, True),
               (2, 64, 300, False))          # (b, sq, skv, causal) for K4
FLASH_CHUNKS = ((64, 64), (64, 512), (64, 1792), (256, 64), (256, 512),
                (256, 1792))                 # (sq, cache rows) for K3
POISON = 1e4                  # K3: stale cache rows past cache_len


def _flash_inputs(torch, b, sq, skv, hq, hkv, d, dtype, seed):
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def f(*shape):
        return torch.randn(shape, generator=gen, device='cuda').to(dtype)
    return f(b, sq, hq, d), f(b, skv, hkv, d), f(b, skv, hkv, d)


def _flash_impl(dtype):
    """Which body a flash kernel (K3, K4, K5a, K5b) runs for operands of
    ``dtype``: bf16 on the tensor cores, fp32 on the CUDA cores."""
    return 'tensor_core' if str(dtype).endswith('bfloat16') else 'cuda_core'


def phase_flash_checks(torch):
    """K4 and K3 against their plain versions at every listed geometry
    (bf16; the 7B geometry in fp32 too), held against the plain
    version's fp32 output: a bf16 output may differ from it by one bf16
    rounding (at most BF16_ULP of the value) on top of TOL_OUT. (Against
    the plain version's own bf16 output the two roundings of two fp32
    sums in another order can land one ulp apart, up to 2 x BF16_ULP of
    the value: a one-ulp flip at |out| 1.14 measured 0.0034 beyond the
    allowance on an H100.) Returns the worst output error per kernel
    name."""
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import flash_attention as fa
    cases = [(n, geo, torch.bfloat16) for n, geo in GEOMETRIES]
    cases.append(('llama2-7b-fp32', GEOMETRIES[0][1], torch.float32))
    worst = {'flash_fwd': 0.0, 'flash_fwd_chunk': 0.0}
    before = dict(fa.launch_counts)

    def judge(kernel, name, dtype, got, want, line, lse_err=None,
              sdpa=None):
        bf16 = dtype == torch.bfloat16
        rounding = BF16_ULP if bf16 else 0.0
        tol_out, tol_lse = (TOL_OUT, TOL_M) if bf16 else (TOL_FP32, TOL_FP32)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        excess = (diff - rounding * want.float().abs()).max().item()
        ok = (bool(torch.isfinite(got).all()) and excess <= tol_out
              and (lse_err is None or lse_err <= tol_lse))
        worst[kernel] = max(worst[kernel], err)
        emit({'phase': 'kernel_check', 'kernel': kernel, 'case': name,
              'q_dtype': str(dtype).replace('torch.', ''),
              'impl': _flash_impl(dtype), **line,
              'max_abs_err_out': err,
              'max_err_beyond_output_rounding': excess,
              'max_abs_err_lse': lse_err, 'tol_out': tol_out,
              'output_rounding': rounding,
              'tol_lse': tol_lse if lse_err is not None else None,
              'sdpa_err': None if sdpa is None else (
                  (sdpa.float() - want.float()).abs()
                  - rounding * want.float().abs()).max().item(),
              'ok': ok})
        require(ok, f'{kernel} disagrees with its plain version ({name}, '
                    f'{line})')

    for name, geo, dtype in cases:
        for b, sq, skv, causal in FLASH_CASES:
            q, k, v = _flash_inputs(torch, b, sq, skv, dtype=dtype, seed=sq,
                                    **geo)
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            # The plain version's fp32 output (its math on fp32 copies of
            # the same inputs, before the final rounding to q's dtype):
            # a bf16 output is then one rounding away from it.
            want, want_lse = fa.flash_attention_reference(
                q.float(), k.float(), v.float(), causal=causal)
            sdpa = F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in (q, k, v)), is_causal=causal,
                enable_gqa=True).transpose(1, 2)
            judge('flash_fwd', name, dtype, out, want,
                  {'b': b, 'sq': sq, 'skv': skv, 'causal': causal, **geo},
                  (lse - want_lse).abs().max().item(), sdpa)
            del q, k, v, out, lse, want, want_lse, sdpa
        for sq, split in FLASH_CHUNKS:
            q, k, v = _flash_inputs(torch, 3, sq, split + sq, dtype=dtype,
                                    seed=split, **geo)
            lens = [0, split // 2 + 1, split]
            cl = torch.tensor(lens, dtype=torch.int32, device='cuda')
            # Then again with the cache rows past each row's cache_len
            # set to POISON: a kernel that reads them unmasked, or masks
            # the wrong rows, lands far beyond the tolerance.
            for poison in (None, POISON):
                if poison is not None:
                    for row, n in enumerate(lens):
                        k[row, n:split] = poison
                        v[row, n:split] = poison
                out = fa.flash_attention(q, k, v, cache_len=cl,
                                         kv_split=split)
                torch.cuda.synchronize()
                want = fa.flash_chunk_reference(q.float(), k.float(),
                                                v.float(), cl, split)
                judge('flash_fwd_chunk', name, dtype, out, want,
                      {'b': 3, 'sq': sq, 'kv_split': split,
                       'cache_len': lens, 'poison_past_cache_len': poison,
                       **geo})
            del q, k, v, out, want
    torch.cuda.empty_cache()
    fa.launch_counts.update(before)      # comparison launches do not count
    return worst


FLASH_SETS = 4     # input sets cycled while timing, so reads are not
                   # served from the 50 MB L2 (each set is 25-67 MB)


def phase_flash_times(torch):
    """K4 and K3 timed at llama2-7b (hq = hkv = 32, d 128, bf16): the
    prefill shapes the slot engine serves (K4: a wave of 4 first chunks
    of 256; K3: 2 chunks of 256 against 256 cache rows) and a long shape
    (K4: one 2048-token prompt; K3: a chunk of 256 against 1792 rows),
    each beside its bound from this call's inputs (bf16 operands: the
    tensor-core peak), its plain version and one SDPA call (K3: with an
    explicit boolean mask over the concatenated kv)."""
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import flash_attention as fa
    hq = hkv = 32
    d = 128
    el = 2                                       # bf16 bytes
    before = dict(fa.launch_counts)
    results = {}
    for kernel, label, b, sq, split in (
            ('flash_fwd', 'served', 4, 256, 0),
            ('flash_fwd', 'long', 1, 2048, 0),
            ('flash_fwd_chunk', 'served', 2, 256, 256),
            ('flash_fwd_chunk', 'long', 1, 256, 1792)):
        sets = [_flash_inputs(torch, b, sq, split + sq, hq, hkv, d,
                              torch.bfloat16, seed=11 + i)
                for i in range(FLASH_SETS)]
        lib = [tuple(t.transpose(1, 2).contiguous() for t in st)
               for st in sets]
        qkv_bytes = 2 * b * sq * hq * d * el             # q read, out written
        if kernel == 'flash_fwd':
            def run(i):
                return fa.flash_attention_fwd(*sets[i % FLASH_SETS])

            def plain(i):
                return fa.flash_attention_reference(*sets[i % FLASH_SETS])

            def library(i):
                return F.scaled_dot_product_attention(*lib[i % FLASH_SETS],
                                                      is_causal=True)
            pairs = b * hq * sq * (sq + 1) // 2
            moved = qkv_bytes + 2 * b * sq * hkv * d * el + b * hq * sq * 4
            lens = None
        else:
            lens = [split] * b
            cl = torch.tensor(lens, dtype=torch.int32, device='cuda')

            def run(i):
                q, k, v = sets[i % FLASH_SETS]
                return fa.flash_chunk_attention(
                    q, k[:, split:], v[:, split:], k[:, :split],
                    v[:, :split], cl)

            def plain(i):
                return fa.flash_chunk_reference(*sets[i % FLASH_SETS], cl,
                                                split)
            j = torch.arange(split + sq, device='cuda')
            qp = torch.arange(sq, device='cuda')[:, None]
            mask = torch.where(j < split, j < cl[:, None, None, None],
                               (j - split) <= qp)        # [b, 1, sq, skv]

            def library(i):
                return F.scaled_dot_product_attention(*lib[i % FLASH_SETS],
                                                      attn_mask=mask)
            pairs = hq * sum(sq * c + sq * (sq + 1) // 2 for c in lens)
            moved = (qkv_bytes + 2 * sum(lens) * hkv * d * el
                     + 2 * b * sq * hkv * d * el)
        flops = 4 * d * pairs                            # q.k and p.v
        ms = _cuda_ms(torch, run, 40)
        plain_ms = _cuda_ms(torch, plain, 4, n_warm=1)
        library_ms = _cuda_ms(torch, library, 40)
        bound_ms, bound_by = _bound(moved, flops, 'bf16_tensor_cores')
        r = {'ms': ms, 'plain_ms': plain_ms, 'library_ms': library_ms,
             'bound_ms': bound_ms, 'bound_by': bound_by, 'bytes': moved,
             'flops': flops}
        results[(kernel, label)] = r
        emit({'phase': 'kernel_time', 'kernel': kernel, 'shape_kind': label,
              'shape': {'b': b, 'sq': sq, 'cache_rows': split or None,
                        'cache_len': lens, 'hq': hq, 'hkv': hkv, 'd': d,
                        'q_dtype': 'bfloat16'},
              **r, 'flop_peak': 'bf16_tensor_cores',
              'achieved_tflop_s': flops / (ms * 1e-3) / 1e12,
              'achieved_gb_s': moved / (ms * 1e-3) / 1e9,
              'roofline_share': bound_ms / ms})
        del sets, lib
        torch.cuda.empty_cache()
    fa.launch_counts.update(before)      # timing launches do not count
    return results


# ------------------------------------------------------------ 3, 4: K5
BWD_GEOMETRIES = [(d, g) for d in (64, 128, 256) for g in (1, 4, 8)]
BWD_SHAPES = ((2, 100, 100, True), (1, 300, 300, True),
              (2, 100, 300, False))          # (b, sq, skv, causal)
TOL_BWD = 2e-5                # element by element, times max(1, max |grad|):
                              # fp32 sums over up to 4 x 2048 rows in another
                              # order err with the size of their terms; bf16
                              # gradients get one bf16 ulp of the element on
                              # top (2 x BF16_ULP): both sides round the fp32
                              # gradient, and a rounding boundary between
                              # them flips one ulp
TOL_AUTOGRAD = 1e-2           # bf16 gradients of the K4/K5 Function against
                              # autograd through the plain forward, over
                              # max(1, |grad|): the kernels' delta is taken
                              # from the bf16-rounded output (2^-9 relative
                              # per element, as the reference's is), on top
                              # of one bf16 rounding of each gradient
TRAIN_ATTN = dict(b=8, sq=2048, hq=32, hkv=8, d=64)     # llama3-1b, batch 8
BIG_ATTN = dict(b=1, sq=2048, hq=32, hkv=32, d=128)     # llama2-7b, one row


def _grad_err(got, want, rounding):
    """(max abs error, worst absolute error beyond ``rounding`` x |want|
    element by element, max |want|)."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    return (diff.max().item(), (diff - rounding * mag).max().item(),
            mag.max().item())


def _bwd_cases():
    """(dtype name, b, sq, skv, hq, hkv, d, causal) of every K5 check:
    each (head_dim, group) of BWD_GEOMETRIES (2 kv heads, 1 for group 8)
    at every BWD_SHAPES entry in fp32 and bf16, then the training shape
    and the 7B shape (bf16, causal) that the timed runs and the train
    phase launch."""
    for name in ('float32', 'bfloat16'):
        for d, g in BWD_GEOMETRIES:
            hkv = 1 if g == 8 else 2
            for b, sq, skv, causal in BWD_SHAPES:
                yield name, b, sq, skv, g * hkv, hkv, d, causal
    for t in (TRAIN_ATTN, BIG_ATTN):
        yield ('bfloat16', t['b'], t['sq'], t['sq'], t['hq'], t['hkv'],
               t['d'], True)


def phase_flash_bwd_checks(torch):
    """K5a and K5b against the plain backward, from K4's own out and
    lse, at every case of ``_bwd_cases``: every gradient element within
    TOL_BWD x max(1, max |grad|) (beyond one bf16 ulp of it for bf16).
    Returns the worst absolute error per kernel name."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    worst = {'flash_bwd_dkv': 0.0, 'flash_bwd_dq': 0.0}
    before = dict(fa.launch_counts)
    for name, b, sq, skv, hq, hkv, d, causal in _bwd_cases():
        dtype = getattr(torch, name)
        rounding = 2 * BF16_ULP if dtype == torch.bfloat16 else 0.0
        q, k, v = _flash_inputs(torch, b, sq, skv, hq, hkv, d, dtype,
                                seed=sq + d + hq // hkv)
        do = _flash_inputs(torch, b, sq, sq, hq, hq, d, dtype,
                           seed=skv + d)[0]
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        delta = fa.attention_delta(out, do)
        got = {'flash_bwd_dkv': fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, causal=causal),
               'flash_bwd_dq': (fa.flash_attention_bwd_dq(
                   q, k, v, do, lse, delta, causal=causal),)}
        torch.cuda.synchronize()
        dq, dk, dv = fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=causal)
        want = {'flash_bwd_dkv': (dk, dv), 'flash_bwd_dq': (dq,)}
        sq_, sk_, sv_ = _sdpa_grads(torch, q, k, v, do, causal)
        sdpa = {'flash_bwd_dkv': (sk_, sv_), 'flash_bwd_dq': (sq_,)}
        for kernel, grads in got.items():
            errs = [_grad_err(a, w, rounding)
                    for a, w in zip(grads, want[kernel])]
            sdpa_err = max(_grad_err(a, w, rounding)[1]
                           for a, w in zip(sdpa[kernel], want[kernel]))
            err = max(e[0] for e in errs)
            excess = max(e[1] for e in errs)
            tol = TOL_BWD * max(1.0, max(e[2] for e in errs))
            ok = (excess <= tol and all(
                bool(torch.isfinite(a).all()) for a in grads))
            worst[kernel] = max(worst[kernel], err)
            emit({'phase': 'kernel_check', 'kernel': kernel,
                  'q_dtype': name, 'impl': _flash_impl(name),
                  'b': b, 'sq': sq, 'skv': skv,
                  'causal': causal, 'hq': hq, 'hkv': hkv, 'd': d,
                  'max_abs_err': err, 'max_err_beyond_rounding': excess,
                  'max_abs_grad': max(e[2] for e in errs),
                  'tol_abs': tol, 'output_rounding': rounding,
                  'sdpa_err': sdpa_err, 'ok': ok})
            require(ok, f'{kernel} disagrees with its plain version '
                        f'(d {d}, {hq}/{hkv} heads, {b}x{sq}x{skv}, '
                        f'causal {causal}, {name})')
        del q, k, v, do, out, lse, delta, got, want, dq, dk, dv, sdpa
        torch.cuda.empty_cache()
    fa.launch_counts.update(before)      # comparison launches do not count
    return worst


def _sdpa_grads(torch, q, k, v, do, causal):
    """(dq, dk, dv) of ``scaled_dot_product_attention`` (GQA) on the
    same inputs, in the model layout: the library yardstick of the
    backward checks."""
    import torch.nn.functional as F
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         enable_gqa=True)
    return tuple(g.transpose(1, 2) for g in torch.autograd.grad(
        out, (qt, kt, vt), do.transpose(1, 2)))


def phase_autograd_check(torch):
    """``attention(impl='flash')`` (the K4/K5 autograd Function) against
    ``torch.autograd`` through the plain forward at the training shape,
    bf16: one K4, one K5a and one K5b launch, gradients within
    TOL_AUTOGRAD of max(1, max |grad|). A check of the Function's
    plumbing; the kernels are held element by element at this shape in
    ``phase_flash_bwd_checks``."""
    from skypilot_tpu_torch.ops import attention as at
    from skypilot_tpu_torch.ops import flash_attention as fa
    t = TRAIN_ATTN
    q, k, v = (x.requires_grad_(True) for x in _flash_inputs(
        torch, t['b'], t['sq'], t['sq'], t['hq'], t['hkv'], t['d'],
        torch.bfloat16, seed=21))
    do = _flash_inputs(torch, t['b'], t['sq'], t['sq'], t['hq'], t['hq'],
                       t['d'], torch.bfloat16, seed=22)[0]
    before = dict(fa.launch_counts)
    got = torch.autograd.grad(at.attention(q, k, v, impl='flash'),
                              (q, k, v), do)
    torch.cuda.synchronize()
    launched = {key: fa.launch_counts[key] - before[key]
                for key in ('flash_fwd', 'flash_bwd_dkv', 'flash_bwd_dq')}
    fa.launch_counts.update(before)      # a comparison, not a main path
    want = torch.autograd.grad(
        fa.flash_attention_reference(q, k, v, causal=True)[0], (q, k, v), do)
    errs = {}
    for n, g, w in zip(('dq', 'dk', 'dv'), got, want):
        err, excess, mag = _grad_err(g, w, BF16_ULP)
        errs[n] = (err, excess / max(1.0, mag))
    ok = (all(e[1] <= TOL_AUTOGRAD for e in errs.values())
          and all(n == 1 for n in launched.values())
          and all(bool(torch.isfinite(g).all()) for g in got))
    emit({'phase': 'autograd_check', 'shape': TRAIN_ATTN,
          'q_dtype': 'bfloat16', 'launches': launched,
          'max_abs_err': {n: e[0] for n, e in errs.items()},
          'max_err_beyond_rounding_over_max_grad': {n: e[1] for n, e
                                                    in errs.items()},
          'tol': TOL_AUTOGRAD, 'ok': ok})
    require(ok, f'flash autograd disagrees with autograd through the plain '
                f'forward: {errs}, launches {launched}')
    del q, k, v, do, got, want
    torch.cuda.empty_cache()


def _sdpa_backward(torch, F, q, k, v, do):
    """A closure timing one backward of ``scaled_dot_product_attention``
    (causal, GQA) on [b, h, s, d] copies of the operands."""
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)

    def run(_):
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    return run


def phase_flash_bwd_times(torch):
    """K4, K5a and K5b at the training shape and the 7B shape (bf16,
    causal), each beside its bound (bf16 operands: the tensor-core peak),
    the plain version's time (for K5: the plain backward, which computes
    dq, dk and dv together) and one library call (K4: the SDPA forward;
    K5: the SDPA backward, all three gradients)."""
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import flash_attention as fa
    el = 2                                       # bf16 bytes
    before = dict(fa.launch_counts)
    results = {}
    for label, t in (('train', TRAIN_ATTN), ('7b', BIG_ATTN)):
        b, s, hq, hkv, d = t['b'], t['sq'], t['hq'], t['hkv'], t['d']
        q, k, v = _flash_inputs(torch, b, s, s, hq, hkv, d, torch.bfloat16,
                                seed=31)
        do = _flash_inputs(torch, b, s, s, hq, hq, d, torch.bfloat16,
                           seed=32)[0]
        out, lse = fa.flash_attention_fwd(q, k, v)
        delta = fa.attention_delta(out, do)
        pairs = b * hq * s * (s + 1) // 2
        q_bytes = b * s * hq * d * el                # q, do, out, dq each
        kv_bytes = b * s * hkv * d * el              # k, v, dk, dv each
        stats = 2 * b * hq * s * 4                   # lse and delta
        sdpa_fwd = [t_.transpose(1, 2).contiguous() for t_ in (q, k, v)]
        library_bwd = _cuda_ms(torch, _sdpa_backward(torch, F, q, k, v, do),
                               10)
        plain_bwd = _cuda_ms(torch, lambda i: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do), 2, n_warm=1)
        rows = {
            'flash_fwd': (lambda i: fa.flash_attention_fwd(q, k, v),
                          2 * q_bytes + 2 * kv_bytes + stats // 2,
                          4 * d * pairs,
                          _cuda_ms(torch, lambda i: (
                              fa.flash_attention_reference(q, k, v)), 2,
                              n_warm=1),
                          _cuda_ms(torch, lambda i: (
                              F.scaled_dot_product_attention(
                                  *sdpa_fwd, is_causal=True,
                                  enable_gqa=True)), 10)),
            'flash_bwd_dkv': (lambda i: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta), 2 * q_bytes + 4 * kv_bytes + stats,
                              8 * d * pairs, plain_bwd, library_bwd),
            'flash_bwd_dq': (lambda i: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, delta), 3 * q_bytes + 2 * kv_bytes + stats,
                             6 * d * pairs, plain_bwd, library_bwd)}
        for kernel, (run, moved, flops, plain_ms, library_ms) in rows.items():
            ms = _cuda_ms(torch, run, 10)
            bound_ms, bound_by = _bound(moved, flops, 'bf16_tensor_cores')
            r = {'ms': ms, 'plain_ms': plain_ms, 'library_ms': library_ms,
                 'bound_ms': bound_ms, 'bound_by': bound_by, 'bytes': moved,
                 'flops': flops}
            results[(kernel, label)] = r
            emit({'phase': 'kernel_time', 'kernel': kernel,
                  'shape_kind': label, 'shape': dict(t, causal=True,
                                                     q_dtype='bfloat16'),
                  **r, 'flop_peak': 'bf16_tensor_cores',
                  'plain_covers': ('dq, dk and dv' if kernel != 'flash_fwd'
                                   else 'the forward'),
                  'library_covers': ('sdpa backward: dq, dk and dv'
                                     if kernel != 'flash_fwd'
                                     else 'sdpa forward'),
                  'achieved_tflop_s': flops / (ms * 1e-3) / 1e12,
                  'roofline_share': bound_ms / ms})
        del q, k, v, do, out, lse, delta, sdpa_fwd, rows
        torch.cuda.empty_cache()
    fa.launch_counts.update(before)      # timing launches do not count
    return results


def phase_weight_path(torch):
    """The cost of the int8 weight path: one decode step's weight
    matmuls at batch 8 (one layer's seven products, timed and counted
    32 times, plus the unembed) with bf16 weights against int8 codes
    through ``qeinsum`` (which widens the codes to bf16 per call)."""
    from skypilot_tpu_torch.models import configs, quantization
    from skypilot_tpu_torch.models.quantization import qeinsum
    cfg = configs.LLAMA2_7B
    gen = torch.Generator(device='cuda').manual_seed(5)
    d, h, hd, f = cfg.dim, cfg.n_heads, cfg.head_dim, cfg.ffn_dim

    def w(*shape):
        return (torch.randn(shape, generator=gen, device='cuda')
                * shape[0] ** -0.5).to(torch.bfloat16)
    layer = {'wq': w(1, d, h, hd), 'wk': w(1, d, h, hd),
             'wv': w(1, d, h, hd), 'wo': w(1, h, hd, d),
             'w_gate': w(1, d, f), 'w_up': w(1, d, f), 'w_down': w(1, f, d)}
    tree = {'layers': layer, 'unembed': w(d, cfg.vocab_size)}
    qtree = quantization.quantize_params(tree)
    x = torch.randn((8, 1, d), generator=gen, device='cuda').to(
        torch.bfloat16)
    xf = torch.randn((8, 1, f), generator=gen, device='cuda').to(
        torch.bfloat16)
    xo = torch.randn((8, 1, h, hd), generator=gen, device='cuda').to(
        torch.bfloat16)

    def step(t):
        lw = {k: (quantization.QuantizedWeight(v.int8[0], v.scale[0])
                  if isinstance(v, quantization.QuantizedWeight) else v[0])
              for k, v in t['layers'].items()}

        def one(_):
            for _ in range(cfg.n_layers):
                for k in ('wq', 'wk', 'wv'):
                    qeinsum('bsd,dhk->bshk', x, lw[k])
                qeinsum('bshk,hkd->bsd', xo, lw['wo'])
                qeinsum('bsd,df->bsf', x, lw['w_gate'])
                qeinsum('bsd,df->bsf', x, lw['w_up'])
                qeinsum('bsf,fd->bsd', xf, lw['w_down'])
            qeinsum('bsd,dv->bsv', x, t['unembed'], out_dtype=torch.float32)
        return one
    times = {}
    for name, t in (('bf16', tree), ('int8', qtree), ('bf16_again', tree),
                    ('int8_again', qtree)):
        times[name] = _cuda_ms(torch, step(t), 5, n_warm=2)
    emit({'phase': 'weight_path', 'model': cfg.name, 'batch': 8,
          'what': 'one decode step of weight matmuls (32 x one layer + '
                  'unembed), CUDA events',
          'step_ms': times,
          'int8_minus_bf16_ms': (times['int8'] + times['int8_again']
                                 - times['bf16'] - times['bf16_again']) / 2})
    del tree, qtree, layer
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- kv_probe
PROBE_LAYERS = 32              # llama2-7b's pool: every layer in one call


def phase_kv_probe(torch, page):
    """K6's path, the KV bandwidth probe of the reference: llama2-7b's
    paged pool at the serve shape (32 layers, 8 slots at context 1024,
    32/32 heads, d 128, page ``page``), every layer's cache partial in
    one launch, for a bf16, an int8 and an int4 pool in turn. The counts
    are set to 0 just before each probe call and read just after; then
    (not counted) K6 against its plain version at K1's tolerances and
    bit for bit against 32 K1 launches, and K6 timed beside its bound
    (one call reads every layer's pages once), the 32 K1 launches, the
    plain version and one SDPA call over all layers' gathered bf16 rows.
    Each pool is freed before the next. Returns (launches, worst output
    error, timings by kernel name)."""
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import paged_attention as pa
    L, hq, hkv, d = PROBE_LAYERS, 32, 32, 128
    P = CTX // page
    launches, worst, results = 0, 0.0, {}
    before = dict(pa.launch_counts)
    for kind in ('bf16', 'int8', 'int4'):
        q1, pk, pv, ks, vs, table, lens = _make_paged_inputs(
            torch, slots=SLOTS, hq=hq, hkv=hkv, d=d, page=page, P=P,
            lengths=[CTX] * SLOTS, L=L, dtype=torch.bfloat16, seed=13,
            kind=kind)
        gen = torch.Generator(device='cuda').manual_seed(14)
        q = torch.randn((L,) + tuple(q1.shape), generator=gen,
                        device='cuda').to(torch.bfloat16)
        key = f'paged_decode_attention_all_layers[{kind}]'
        pa.reset_launch_counts()         # counts to 0 just before the path
        got = pa.paged_decode_attention_all_layers(q, pk, pv, table, lens,
                                                   ks, vs)
        torch.cuda.synchronize()
        after = dict(pa.launch_counts)
        require(after[key] == 1 and sum(after.values()) == 1,
                f'kv_probe ({kind}) launched {after}')
        launches += after[key]
        want = pa.paged_decode_attention_all_layers_reference(
            q, pk, pv, table, lens, ks, vs)
        ok, errs = _check_partial(torch, got, want, lens)
        k1 = [pa.paged_decode_attention(q[li], pk, pv, table, lens, ks, vs,
                                        layer=li) for li in range(L)]
        same = all(torch.equal(g[li], one[i]) for li, one in enumerate(k1)
                   for i, g in enumerate(got))
        del want, k1
        name = ('paged_decode_all_layers' if kind == 'bf16'
                else f'paged_decode_all_layers_{kind}')
        worst = max(worst, errs['max_abs_err_out'])
        emit({'phase': 'kernel_check', 'kernel': name, 'case': 'kv_probe',
              'q_dtype': 'bfloat16', 'pool': kind, 'layers': L,
              'slots': SLOTS, 'page': page, 'P': P, 'context': CTX,
              'hq': hq, 'hkv': hkv, 'd': d, **errs,
              'bitwise_equal_to_per_layer_k1': same, 'ok': ok and same})
        require(ok and same, f'{name} disagrees with its plain version or '
                             f'with {L} K1 launches')
        n_rows = SLOTS * CTX
        row_bytes = {'bf16': 2 * d, 'int8': d + 4, 'int4': d // 2 + 4}[kind]
        moved = (L * 2 * n_rows * hkv * row_bytes        # codes + scales
                 + table.numel() * 4 + SLOTS * 4 + q.numel() * 2
                 + L * SLOTS * hq * (d + 2) * 4)        # acc, m, l
        flops = L * 4 * n_rows * hq * d
        ksv = torch.cat([_gathered_bf16(torch, pk, ks, li, table, hkv, d)
                         for li in range(L)])           # [L * slots, ...]
        vsv = torch.cat([_gathered_bf16(torch, pv, vs, li, table, hkv, d)
                         for li in range(L)])
        q4 = q.reshape(L * SLOTS, hq, 1, d)
        library_ms = _cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            q4, ksv, vsv), 10)
        del ksv, vsv
        ms = _cuda_ms(torch, lambda i: pa.paged_decode_attention_all_layers(
            q, pk, pv, table, lens, ks, vs), 20)
        k1_ms = _cuda_ms(torch, lambda i: [pa.paged_decode_attention(
            q[li], pk, pv, table, lens, ks, vs, layer=li)
            for li in range(L)], 10)
        plain_ms = _cuda_ms(torch, lambda i: (
            pa.paged_decode_attention_all_layers_reference(
                q, pk, pv, table, lens, ks, vs)), 2, n_warm=1)
        bound_ms, bound_by = _bound(moved, flops)
        results[name] = {'ms': ms, 'plain_ms': plain_ms,
                         'library_ms': library_ms, 'bound_ms': bound_ms,
                         'bound_by': bound_by, 'bytes': moved,
                         'flops': flops}
        emit({'phase': 'kernel_time', 'kernel': name,
              'shape': {'layers': L, 'slots': SLOTS, 'hq': hq, 'hkv': hkv,
                        'd': d, 'page': page, 'context': CTX,
                        'q_dtype': 'bfloat16', 'pool': kind},
              **results[name], 'k1_x32_ms': k1_ms,
              'flop_peak': 'fp32_cuda_cores',
              'library_covers': 'one sdpa call over all layers, gathered '
                                'bf16 rows (gather not timed)',
              'achieved_gb_s': moved / (ms * 1e-3) / 1e9,
              'roofline_share': bound_ms / ms})
        del q1, q, q4, pk, pv, ks, vs, table, lens, got
        torch.cuda.empty_cache()
    pa.launch_counts.update(before)      # comparison launches do not count
    emit({'phase': 'kv_probe', 'model': 'llama2-7b', 'layers': L,
          'slots': SLOTS, 'context': CTX, 'pools': ['bf16', 'int8', 'int4'],
          'kernel_launches': {'paged_decode_attention_all_layers': launches},
          'ms_by_pool': {k: r['ms'] for k, r in results.items()}})
    return launches, worst, results


# --------------------------------------------------------------------- 5
N_NEW = 32                     # new tokens per served request
PROMPT_LENS = [100, 170, 240, 310, 380, 450, 520, 600]
TOL_ATTN = 1.6e-2              # layer attention output, max abs error
                               # over max(|output|, 1): both paths round
                               # the output to bf16 (2^-8 relative) and
                               # the plain path also rounds the
                               # probabilities to bf16 before p.V


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _post(url, body, stream):
    """POST JSON; returns (parsed result, client TTFT ms or None)."""
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as resp:
        if not stream:
            return json.loads(resp.read()), None
        events, ttft = [], None
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith('data:'):
                continue
            data = line[5:].strip()
            if ttft is None:
                ttft = (time.monotonic() - t0) * 1e3
            events.append(data)
        return events, ttft


def _served_tokens(route, stream, result):
    """Token ids (or count, for text chunks) a response carries."""
    if route == '/generate':
        if stream:
            done = json.loads(result[-1])
            require(done.get('done'), f'no done event: {result[-1]}')
            return done['tokens']
        return result['tokens']
    if stream:
        require(result[-1] == '[DONE]', 'completion stream not [DONE]')
        chunks = [json.loads(e) for e in result[:-1]]
        return [c for c in chunks if c['choices'][0]['finish_reason'] is None]
    return [None] * result['usage']['completion_tokens']


def _prompts(seed, vocab):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(3, vocab, n)] for n in PROMPT_LENS]


def _attention_check(torch, eng, seed, phase):
    """Kernel path against the plain path on an engine's state: seat one
    request, prefill it, then run its first decode step's layer
    attention both ways against the same pool (layers 0 and L-1)."""
    import numpy as np
    from skypilot_tpu_torch.inference import paged
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.quantization import qeinsum
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.ops.attention import ring_decode_attention
    cfg = eng.cfg
    rng = np.random.default_rng(seed + 99)
    prompt = [int(t) for t in rng.integers(3, cfg.vocab_size, 700)]
    rid = eng.add_request(prompt, max_new_tokens=4)
    for _ in range(64):
        if not (eng._prefill_off or eng._queue):
            break
        eng._admit()
    require(not (eng._prefill_off or eng._queue), 'probe request not seated')
    slot = next(s for s, r in enumerate(eng._slots)
                if r is not None and r.request_id == rid)
    P = eng._pages_needed(int(eng._slot_len[slot]) + 1)
    table = torch.zeros((1, P), dtype=torch.int32, device='cuda')
    table[0, :len(eng._pages[slot][:P])] = torch.tensor(
        eng._pages[slot][:P], dtype=torch.int32)
    lengths = torch.tensor([int(eng._slot_len[slot])], dtype=torch.int32,
                           device='cuda')
    tok = eng._tok_dev[slot:slot + 1].long()[:, None]
    params = eng.params
    layer = llama.layer_params(params, 0)
    x = llama._embed_tokens(params, tok, cfg)
    h = llama.rms_norm(x, layer['attn_norm'], cfg.norm_eps)
    pos = lengths.long()[:, None]
    q = llama.rope(qeinsum('bsd,dhk->bshk', h, layer['wq']), pos,
                   cfg.rope_theta)
    k = llama.rope(qeinsum('bsd,dhk->bshk', h, layer['wk']), pos,
                   cfg.rope_theta)
    v = qeinsum('bsd,dhk->bshk', h, layer['wv'])
    ring = torch.zeros((1, 1, cfg.n_kv_heads, cfg.head_dim),
                       dtype=cfg.dtype, device='cuda')
    c = eng.cache
    before = dict(pa.launch_counts)
    errs, mags = [], []
    layers = (0, cfg.n_layers - 1)
    for li in layers:
        kernel_paths = {}
        part = pa.paged_decode_attention(q[:, 0], c.pool_k, c.pool_v, table,
                                         lengths, c.k_scale, c.v_scale,
                                         layer=li)
        kernel_paths['pallas'] = pa.merge_partial_with_ring_self(
            part, q, k, v, ring, ring, 0)
        kernel_paths['cross_layer'] = pa.paged_decode_attention_fused(
            q[:, 0], k[:, 0], v[:, 0], ring, ring, 0, c.pool_k, c.pool_v,
            table, lengths, c.k_scale, c.v_scale, layer=li)[:, None]
        ck, cv, sck, scv = paged._gather_layer(c, li, table)
        want = ring_decode_attention(q, k, v, ck, cv, lengths, ring, ring, 0,
                                     k_scale=sck, v_scale=scv)
        mags.append(want.float().abs().max().item())
        for impl, got in kernel_paths.items():
            err = (got.float() - want.float()).abs().max().item()
            errs.append({'layer': li, 'impl': impl, 'max_abs_err': err})
            rel = err / max(mags[-1], 1.0)
            require(rel <= TOL_ATTN and bool(torch.isfinite(got).all()),
                    f'{phase} layer {li} attention ({impl}): kernel path vs '
                    f'plain path max abs err {err} (relative {rel}) > '
                    f'{TOL_ATTN}')
    pa.launch_counts.update(before)
    emit({'phase': 'attention_check', 'of': phase, 'model': cfg.name,
          'kv_cache_dtype': eng.kv_cache_dtype,
          'context': int(lengths[0]), 'layers': list(layers),
          'errors': errs, 'max_abs_value': mags,
          'tol_over_max_abs_value': TOL_ATTN})


def _drive(port, cfg, seed, reset):
    """The 8 requests (four routes, streamed and not) sent at once to the
    server on ``port``; ``reset`` runs just before the first is sent.
    Every request must bring back N_NEW tokens. Returns (token counts,
    TTFTs in ms, wall seconds)."""
    import threading
    routes = [('/v1/completions', False), ('/generate', True),
              ('/v1/completions', True), ('/generate', False)] * 2
    jobs = []
    for prompt, (route, stream) in zip(_prompts(seed, cfg.vocab_size),
                                       routes):
        body = ({'prompt': prompt, 'max_tokens': N_NEW,
                 'temperature': 0.0, 'eos_id': None}
                if route == '/v1/completions' else
                {'prompt': prompt, 'max_new_tokens': N_NEW,
                 'temperature': 0.0})
        body['stream'] = stream
        jobs.append((route, stream, body))
    results = [None] * len(jobs)
    errors = []

    def run(i, route, stream, body):
        try:
            results[i] = _post(f'http://127.0.0.1:{port}{route}', body,
                               stream)
        except Exception as e:  # pylint: disable=broad-except
            errors.append(f'{route}: {type(e).__name__}: {e}')

    threads = [threading.Thread(target=run, args=(i,) + job)
               for i, job in enumerate(jobs)]
    reset()
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start
    require(not errors, f'requests failed: {errors}')
    counts, ttfts = [], []
    for (route, stream, _), (res, ttft) in zip(jobs, results):
        toks = _served_tokens(route, stream, res)
        counts.append(len(toks))
        if ttft is not None:
            ttfts.append(ttft)
        if route == '/generate':
            require(all(0 <= t < cfg.vocab_size for t in toks),
                    'token id out of range')
        if route == '/generate' and not stream:
            ttfts.append(res['ttft_ms'])
    require(all(c == N_NEW for c in counts),
            f'token counts {counts}, want {N_NEW} each')
    return counts, ttfts, wall


def _serve_line(torch, phase, cfg, srv, counts, ttfts, wall, **extra):
    """The JSON line of a serve phase: latency, throughput, memory."""
    import numpy as np
    eng = srv.engine
    return {'phase': phase, 'model': cfg.name,
            'kv_cache_dtype': eng.kv_cache_dtype, 'max_batch': 8,
            'max_seq': 2048, **extra, 'requests': len(counts),
            'prompt_lens': PROMPT_LENS, 'new_tokens': counts,
            'wall_s': wall, 'ttft_ms': sorted(ttfts),
            'ttft_ms_median': float(np.median(ttfts)),
            'output_tok_s': sum(counts) / wall,
            'tpot_ms_median_server': srv.metrics_json()['tpot_ms_median'],
            'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
            'param_bytes': eng._param_bytes,
            'kv_pool': eng.kv_pool_stats()}


def phase_serve(torch, seed, phase, keep_params=False, **server_kw):
    """llama2-7b served end to end through the port's ModelServer; the
    decode kernel must run once per layer per decode step. Returns the
    launch count of the expected kernel and, with ``keep_params``, the
    served weights (else None)."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.serve.server import ModelServer

    kv = server_kw.get('kv_cache_dtype') or (
        'int8' if server_kw.get('quantize') == 'int8' else 'bf16')
    key = f'paged_decode_attention[{kv}]'
    torch.cuda.reset_peak_memory_stats()
    port = _free_port()
    t0 = time.monotonic()
    srv = ModelServer('llama2-7b', max_batch=8, max_seq=2048, port=port,
                      seed=seed, **server_kw)
    srv.start(block=False)
    try:
        srv.wait_ready(timeout=600)
        ready_s = time.monotonic() - t0
        eng = srv.engine
        cfg = eng.cfg
        require(eng.decode_impl == 'pallas',
                f'decode_impl resolved to {eng.decode_impl!r}')
        require(eng.kv_cache_dtype == kv,
                f'kv_cache_dtype resolved to {eng.kv_cache_dtype!r}')
        steps0 = eng.decode_substeps

        def reset():                     # counts to 0 just before the path
            pa.reset_launch_counts()
            fa.reset_launch_counts()
        counts, ttfts, wall = _drive(port, cfg, seed, reset)
        counts_after = dict(pa.launch_counts)
        flash_after = dict(fa.launch_counts)
        launches = counts_after[key]
        steps = eng.decode_substeps - steps0
        require(launches == cfg.n_layers * steps and steps > 0,
                f'{key} launches {launches} != n_layers {cfg.n_layers} x '
                f'decode steps {steps}')
        require(sum(counts_after.values()) == launches
                and not any(flash_after.values()),
                f'other kernels launched on the {phase} path: '
                f'{counts_after} {flash_after}')
        emit(_serve_line(
            torch, phase, cfg, srv, counts, ttfts, wall,
            weights=server_kw.get('quantize') or 'bfloat16',
            page=eng.page, n_pages=eng.alloc.n_pages,
            decode_impl=eng.decode_impl, ready_s=ready_s,
            decode_steps=steps, kernel_launches={key: launches}))
    finally:
        srv.stop()
    _attention_check(torch, eng, seed, phase)
    params = eng.params if keep_params else None
    del eng, srv
    torch.cuda.empty_cache()
    return launches, params


# --------------------------------------------------------------------- 6
def phase_serve_slot(torch, seed, params):
    """The bf16 7B weights of ``serve`` behind ``ModelServer(kv_cache=
    'slot')``, the same requests: every prefill call runs one flash
    launch per layer, K4 for calls without cache rows (first chunks) and
    K3 for chunks against the cache, both at least once; no paged
    kernel runs. Returns the K4 and K3 launch counts."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.serve.server import ModelServer
    torch.cuda.reset_peak_memory_stats()
    port = _free_port()
    t0 = time.monotonic()
    srv = ModelServer('llama2-7b', max_batch=8, max_seq=2048, port=port,
                      seed=seed, params=params, kv_cache='slot')
    srv.start(block=False)
    try:
        srv.wait_ready(timeout=600)
        ready_s = time.monotonic() - t0
        eng = srv.engine
        cfg = eng.cfg
        require(eng.chunked and eng.kv_cache_dtype == 'bf16',
                f'slot engine resolved to chunk {eng.chunk}, '
                f'{eng.kv_cache_dtype}')
        calls0 = dict(eng.prefill_calls)
        steps0 = eng.decode_substeps

        def reset():                     # counts to 0 just before the path
            pa.reset_launch_counts()
            fa.reset_launch_counts()
        counts, ttfts, wall = _drive(port, cfg, seed, reset)
        flash_after = dict(fa.launch_counts)
        paged_after = dict(pa.launch_counts)
        calls = {k: eng.prefill_calls[k] - calls0[k] for k in calls0}
        steps = eng.decode_substeps - steps0
        k4, k3 = flash_after['flash_fwd'], flash_after['flash_fwd_chunk']
        require(k4 == cfg.n_layers * calls['uncached'] and k4 > 0,
                f'K4 launches {k4} != {cfg.n_layers} x uncached prefill '
                f'calls {calls["uncached"]}')
        require(k3 == cfg.n_layers * calls['cached'] and k3 > 0,
                f'K3 launches {k3} != {cfg.n_layers} x cached prefill '
                f'calls {calls["cached"]}')
        require(not any(paged_after.values()),
                f'paged kernels launched on the slot path: {paged_after}')
        emit(_serve_line(
            torch, 'serve_slot', cfg, srv, counts, ttfts, wall, weights='bfloat16',
            kv_cache='slot', prefill_chunk_tokens=eng.chunk,
            ready_s=ready_s, decode_steps=steps, prefill_calls=calls,
            kernel_launches=flash_after))
    finally:
        srv.stop()
    del eng, srv
    torch.cuda.empty_cache()
    return k4, k3


# --------------------------------------------------------------------- 8
def phase_decode_variants(torch, seed, params):
    """Two engines over the same int8 weights at full width, 8 prompts x
    32 tokens: int4 KV through K1, int8 KV through K2. Each kernel must
    run once per layer per decode step. Returns their launch counts."""
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.ops import paged_attention as pa
    cfg = configs.LLAMA2_7B
    out = {}
    for kv, impl, key in (
            ('int4', 'pallas', 'paged_decode_attention[int4]'),
            ('int8', 'cross_layer', 'paged_decode_attention_fused[int8]')):
        torch.cuda.reset_peak_memory_stats()
        eng = PagedInferenceEngine(cfg, params, max_batch=8, max_seq=2048,
                                   kv_cache_dtype=kv, decode_impl=impl)
        require(eng.kv_cache_dtype == kv and eng.decode_impl == impl,
                f'engine resolved to {eng.kv_cache_dtype}/{eng.decode_impl}')
        eng.add_request([1, 2, 3], max_new_tokens=2)      # warm-up
        eng.run_to_completion(horizon=4)
        pa.reset_launch_counts()
        steps0 = eng.decode_substeps
        t0 = time.monotonic()
        rids = [eng.add_request(p, max_new_tokens=N_NEW)
                for p in _prompts(seed + 1, cfg.vocab_size)]
        done = eng.run_to_completion(horizon=32)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts_after = dict(pa.launch_counts)
        steps = eng.decode_substeps - steps0
        toks = [done[r].output for r in rids]
        require(all(len(t) == N_NEW for t in toks),
                f'{kv}/{impl}: token counts {[len(t) for t in toks]}')
        require(all(0 <= t < cfg.vocab_size for o in toks for t in o),
                f'{kv}/{impl}: token id out of range')
        launches = counts_after[key]
        require(launches == cfg.n_layers * steps and steps > 0,
                f'{key} launches {launches} != {cfg.n_layers} x {steps}')
        require(sum(counts_after.values()) == launches,
                f'other kernels launched: {counts_after}')
        out[key] = launches
        emit({'phase': 'decode_variants', 'model': cfg.name,
              'weights': 'int8', 'kv_cache_dtype': kv, 'decode_impl': impl,
              'requests': len(rids), 'new_tokens': N_NEW,
              'decode_steps': steps, 'kernel_launches': {key: launches},
              'wall_s': wall,
              'output_tok_s': sum(len(t) for t in toks) / wall,
              'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
              'kv_pool': eng.kv_pool_stats()})
        del eng, done
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- 9
def _to_device(params, dev):
    """A copy of ``params`` on ``dev`` (always a copy: the trainer
    updates its params in place)."""
    from skypilot_tpu_torch.models.quantization import QuantizedWeight
    if isinstance(params, dict):
        return {k: _to_device(v, dev) for k, v in params.items()}
    if isinstance(params, QuantizedWeight):
        return QuantizedWeight(params.int8.to(dev, copy=True),
                               params.scale.to(dev, copy=True))
    return params.to(dev, copy=True)


def phase_reference(torch, seed):
    """A small fp32 model with head_dim 64 served on the card through
    the kernels and on the CPU through the plain paths, from the same
    weights (int8 codes quantized once on the CPU): the greedy tokens
    must be equal for each paged (weights, KV dtype, decode impl), and
    for the slot engine chunked (chunk 32: K4 and K3 on the card) and
    monolithic (K4)."""
    import dataclasses
    import numpy as np
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    from skypilot_tpu_torch.models import configs, llama, quantization
    from skypilot_tpu_torch.ops import flash_attention as fa
    cfg = dataclasses.replace(
        configs.TINY, name='smoke-d64', vocab_size=512, dim=256,
        n_heads=4, n_kv_heads=2, ffn_dim=512, max_seq_len=256,
        dtype=torch.float32)
    cpu_params = llama.init_params(cfg, seed, device='cpu')
    trees = {None: cpu_params,
             'int8': quantization.quantize_params(cpu_params)}
    rng = np.random.default_rng(seed + 1)
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, n)]
               for n in (9, 40, 75, 130)]
    prompts.append(prompts[3][:64] + [5, 6, 7])          # prefix hit
    results = []
    for quantize, kv, impl in ((None, 'bf16', 'pallas'),
                               ('int8', 'int8', 'pallas'),
                               ('int8', 'int8', 'cross_layer'),
                               ('int8', 'int4', 'cross_layer')):
        outs = {}
        for dev in ('cuda', 'cpu'):
            eng = PagedInferenceEngine(
                cfg, _to_device(trees[quantize], dev), max_batch=3,
                max_seq=256, page_size=16, chunk=32, n_pages=40,
                kv_cache_dtype=kv, decode_impl=impl, device=dev)
            rids = [eng.add_request(p, max_new_tokens=24) for p in prompts]
            done = eng.run_to_completion(horizon=8)
            outs[dev] = [done[r].output for r in rids]
        same = outs['cuda'] == outs['cpu']
        results.append({'weights': quantize or 'float32',
                        'kv_cache_dtype': kv, 'decode_impl': impl,
                        'greedy_equal_cuda_kernel_vs_cpu_plain': same})
        require(same, f'greedy streams differ ({quantize}, {kv}, {impl}): '
                      f'{outs}')
    for chunk in (32, 0):
        outs, launched = {}, None
        for dev in ('cuda', 'cpu'):
            before = dict(fa.launch_counts)
            eng = InferenceEngine(cfg, _to_device(cpu_params, dev),
                                  max_batch=3, max_seq=256,
                                  prefill_chunk_tokens=chunk, device=dev)
            rids = [eng.add_request(p, max_new_tokens=24) for p in prompts]
            done = eng.run_to_completion(horizon=8)
            outs[dev] = [done[r].output for r in rids]
            if dev == 'cuda':
                launched = {k: fa.launch_counts[k] - before[k]
                            for k in before}
                fa.launch_counts.update(before)    # not a main-path run
        same = outs['cuda'] == outs['cpu']
        results.append({'engine': 'slot', 'prefill_chunk_tokens': chunk,
                        'kernel_launches_cuda': launched,
                        'greedy_equal_cuda_kernel_vs_cpu_plain': same})
        require(same and launched['flash_fwd'] > 0
                and (chunk == 0 or launched['flash_fwd_chunk'] > 0),
                f'slot engine (chunk {chunk}): streams equal {same}, '
                f'launches {launched}: {outs}')
    emit({'phase': 'reference', 'model': cfg.name, 'dtype': 'float32',
          'prompts': len(prompts), 'new_tokens': 24, 'runs': results})


# -------------------------------------------------------------------- 10
TRAIN_STEPS = 6
TRAIN_BATCH = TRAIN_ATTN['b']
TRAIN_SEQ = TRAIN_ATTN['sq']
TOL_TRAIN_REF = 1e-4           # card vs CPU, fp32 loss and grad norm,
                               # relative: the same fp32 math summed in
                               # other orders, through 3 Adam steps


def _write_corpus(path, seed, n_words=80000):
    """A seeded text corpus (random words from a fixed list)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    words = ('the of and to in is was for on that with as by at from his '
             'her it an were are which this be or has had not but their '
             'one all we they there been if more when will would who so '
             'no river mountain city music history science language '
             'village engine station winter summer garden letter').split()
    with open(path, 'w', encoding='utf-8') as f:
        for _ in range(0, n_words, 1000):
            f.write(' '.join(rng.choice(words, 1000)) + '.\n')
    return path


class _StepLog:
    """Callback recording each step's wall time (the step's metrics are
    read back before ``on_step_end``, so it covers the device work)."""

    def __init__(self):
        self.t0, self.times, self.metrics = None, [], []

    def on_step_begin(self, step):
        self.t0 = time.monotonic()

    def on_step_end(self, step, metrics):
        self.times.append(time.monotonic() - self.t0)
        self.metrics.append(metrics)

    def on_train_end(self):
        pass


def _kernel_class(name):
    """The class of a device kernel in the training profile."""
    for tag, cls in (('flash_fwd_kernel', 'K4'), ('flash_bwd_dkv', 'K5a'),
                     ('flash_bwd_dq', 'K5b')):
        if tag in name:
            return cls
    if any(t in name.lower() for t in ('gemm', 'xmma', 'cutlass', 'nvjet',
                                       'cublas', 'wgmma')):
        return 'matmul'
    return 'other'


def _train_breakdown(torch, trainer, state, batch, step_s):
    """Where a training step's time goes, measured after the main path's
    launch counts were read: one more step traced with torch.profiler
    (device time by kernel class, busy share of the unprofiled median
    step), then the optimizer update and the loss tail (argmax,
    log-softmax, gather, masked mean and its backward on fp32 logits of
    the step's shape) each timed alone with CUDA events."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.train import trainer as tr
    batch = trainer._batch(batch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = trainer.step(state, batch)
        torch.cuda.synchronize()
    device_ms, kernels = {}, []
    for evt in prof.key_averages():
        us = getattr(evt, 'self_device_time_total', None)
        if us is None:
            us = getattr(evt, 'self_cuda_time_total', 0)
        if us and str(getattr(evt, 'device_type', '')).endswith('CUDA'):
            cls = _kernel_class(evt.key)
            device_ms[cls] = device_ms.get(cls, 0.0) + us / 1e3
            kernels.append((us / 1e3, evt.count, cls, evt.key[:100]))
    busy = sum(device_ms.values())
    _, _, grads = tr.value_and_grad(state.params, batch, trainer.cfg,
                                    trainer.tc.attn_impl)
    optimizer_ms = _cuda_ms(torch, lambda i: trainer.optimizer.update(
        grads, state.opt_state, state.params), 3, n_warm=1)
    cfg, (b, s) = trainer.cfg, batch['inputs'].shape
    del grads, state
    torch.cuda.empty_cache()
    gen = torch.Generator(device='cuda').manual_seed(41)
    logits = torch.randn((b, s, cfg.vocab_size), generator=gen,
                         device='cuda').requires_grad_(True)
    tgt = batch['targets'].long()
    mask = batch['mask']

    def loss_tail(_):
        hits = torch.argmax(logits.detach(), -1) == tgt
        logp = F.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
        loss = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return torch.autograd.grad(loss, logits), (hits * mask).sum()
    ce_ms = _cuda_ms(torch, loss_tail, 3, n_warm=1)
    del logits
    torch.cuda.empty_cache()
    return {'device_ms_by_class': device_ms if busy else 'not measured',
            'top_kernels_ms_calls_class_name': sorted(kernels,
                                                      reverse=True)[:20],
            'device_busy_ms': busy or None,
            'device_idle_share': 1 - busy / (step_s * 1e3) if busy else None,
            'optimizer_ms': optimizer_ms, 'loss_tail_fwd_bwd_ms': ce_ms}


def phase_train(torch, seed, times):
    """llama3-1b trained at full width through ``Trainer.fit``; returns
    the K4, K5a and K5b launch counts of the run."""
    import statistics
    import tempfile
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models.tokenizer import load_tokenizer
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.train.data import TokenStream, packed_batches
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer
    cfg = configs.LLAMA3_1B
    require(cfg.remat == 'block' and cfg.dtype == torch.bfloat16,
            f'llama3-1b resolved to remat {cfg.remat}, {cfg.dtype}')
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                     total_steps=TRAIN_STEPS, mu_dtype='float32')
    with tempfile.TemporaryDirectory() as tmp:
        stream = TokenStream(_write_corpus(os.path.join(tmp, 'corpus.txt'),
                                           seed),
                             load_tokenizer(None, cfg.vocab_size))
    batch = TRAIN_BATCH
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    trainer = Trainer(cfg, train_config=tc, device='cuda')
    state = trainer.init(seed)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    data = packed_batches(stream, batch=batch, seq=TRAIN_SEQ)
    log = _StepLog()
    pa.reset_launch_counts()             # counts to 0 just before the path
    fa.reset_launch_counts()
    state = trainer.fit(state, data, TRAIN_STEPS, [log])
    flash_after, paged_after = dict(fa.launch_counts), dict(pa.launch_counts)
    losses = [m['loss'] for m in log.metrics]
    L, n = cfg.n_layers, TRAIN_STEPS
    k4, k5a, k5b = (flash_after[k] for k in ('flash_fwd', 'flash_bwd_dkv',
                                              'flash_bwd_dq'))
    step_s = statistics.median(log.times[1:])
    tokens = batch * TRAIN_SEQ
    t = TRAIN_ATTN
    attn_flops = 3 * 4 * t['d'] * t['hq'] * batch * (
        TRAIN_SEQ * (TRAIN_SEQ + 1) // 2) * L      # causal, fwd + bwd
    flops = cfg.flops_per_token(training=True) * tokens + attn_flops
    kernel_ms = (k4 / n * times[('flash_fwd', 'train')]['ms']
                 + k5a / n * times[('flash_bwd_dkv', 'train')]['ms']
                 + k5b / n * times[('flash_bwd_dq', 'train')]['ms'])
    line = {'phase': 'train', 'model': cfg.name, 'n_params': cfg.num_params,
            'dtype': 'bfloat16', 'remat': cfg.remat, 'mu_dtype': tc.mu_dtype,
            'batch': batch, 'seq': TRAIN_SEQ,
            'steps': n, 'lr': tc.learning_rate, 'warmup_steps': 1,
            'init_s': init_s, 'losses': losses,
            'accuracy': [m['accuracy'] for m in log.metrics],
            'grad_norms': [m['grad_norm'] for m in log.metrics],
            'step_s': log.times, 'step_s_median_after_step_1': step_s,
            'tok_s': tokens / step_s,
            'model_flops_per_step': flops,
            'model_tflop_s': flops / step_s / 1e12,
            'mfu': flops / step_s / FLOP_PEAKS['bf16_tensor_cores'],
            'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
            'attn_kernel_ms_per_step': kernel_ms,
            'attn_kernel_share_of_step': kernel_ms / (step_s * 1e3),
            'kernel_launches': flash_after}
    emit(line)
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f'losses {losses}: not finite and falling')
    require(k4 == 2 * L * n and k5a == L * n and k5b == L * n,
            f'launches K4 {k4} (want {2 * L * n}), K5a {k5a}, K5b {k5b} '
            f'(want {L * n} each)')
    require(flash_after['flash_fwd_chunk'] == 0
            and not any(paged_after.values()),
            f'other kernels launched on the train path: {flash_after} '
            f'{paged_after}')
    breakdown = _train_breakdown(torch, trainer, state, next(data), step_s)
    fa.launch_counts.update(flash_after)     # not part of the main path
    emit({'phase': 'train_breakdown', 'model': cfg.name, 'batch': batch,
          'seq': TRAIN_SEQ, 'step_s_median': step_s,
          'attn_kernel_ms_per_step': kernel_ms, **breakdown})
    del trainer, state, log
    torch.cuda.empty_cache()
    return k4, k5a, k5b


def phase_train_reference(torch, seed):
    """A 2-layer fp32 model with head_dim 64 trained 3 steps on the card
    (K4, K5a, K5b) and on the CPU (plain paths) from the same params on
    the same batches: losses and grad norms within TOL_TRAIN_REF."""
    import dataclasses
    import tempfile
    from skypilot_tpu_torch.models import configs, llama
    from skypilot_tpu_torch.models.tokenizer import load_tokenizer
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train.data import TokenStream, packed_batches
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(
        configs.TINY, name='smoke-train-d64', vocab_size=512, dim=256,
        n_heads=4, n_kv_heads=2, ffn_dim=512, max_seq_len=256,
        dtype=torch.float32, remat='block')
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    with tempfile.TemporaryDirectory() as tmp:
        stream = TokenStream(_write_corpus(os.path.join(tmp, 'c.txt'),
                                           seed + 1, 4000),
                             load_tokenizer(None, cfg.vocab_size))
    cpu_params = llama.init_params(cfg, seed, device='cpu')
    runs, launched = {}, None
    for dev in ('cuda', 'cpu'):
        trainer = Trainer(cfg, train_config=tc, device=dev)
        state = trainer.state_from_params(_to_device(cpu_params, dev))
        data = packed_batches(stream, batch=2, seq=128)
        before = dict(fa.launch_counts)
        log = _StepLog()
        trainer.fit(state, data, 3, [log])
        if dev == 'cuda':
            launched = {k: fa.launch_counts[k] - before[k] for k in before}
            fa.launch_counts.update(before)      # not a main-path run
        runs[dev] = log.metrics
    errs = {key: max(abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
                     for a, b in zip(runs['cuda'], runs['cpu']))
            for key in ('loss', 'grad_norm')}
    ok = (all(e <= TOL_TRAIN_REF for e in errs.values())
          and launched['flash_bwd_dkv'] == launched['flash_bwd_dq']
          == cfg.n_layers * 3 > 0)
    emit({'phase': 'train_reference', 'model': cfg.name, 'dtype': 'float32',
          'steps': 3, 'batch': 2, 'seq': 128,
          'loss_cuda': [m['loss'] for m in runs['cuda']],
          'loss_cpu': [m['loss'] for m in runs['cpu']],
          'grad_norm_cuda': [m['grad_norm'] for m in runs['cuda']],
          'grad_norm_cpu': [m['grad_norm'] for m in runs['cpu']],
          'max_rel_err': errs, 'tol_rel': TOL_TRAIN_REF,
          'kernel_launches_cuda': launched, 'ok': ok})
    require(ok, f'card vs CPU training differs: {errs}, launches {launched}')


# --------------------------------------------------------------------- main
_TIME_KEYS = ('ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')


def _kernel_entry(name, source, replaces, launches, worst, timing):
    return {'name': name, 'route': 'cuda',
            'source': f'skypilot_tpu_torch/csrc/{source}',
            'replaces': f'skypilot_tpu/ops/{replaces}',
            'launches': launches, 'max_abs_err': worst,
            **{k: timing[k] for k in _TIME_KEYS}}


def _times_by_shape(flash_times, kernel, labels):
    """A flash kernel's timings at several shapes, for its entry in
    the ``kernels`` line beside the main-path shape's."""
    return {label: {k: flash_times[(kernel, label)][k] for k in _TIME_KEYS}
            for label in labels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    try:
        import skypilot_tpu_torch  # noqa: F401
        from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
        from skypilot_tpu_torch.models import configs
    except ImportError as e:
        print(f'chip_smoke: the skypilot_tpu_torch package is missing '
              f'({e}); run from the root of the repository',
              file=sys.stderr)
        return 2
    # fp32 comparisons run in full fp32 on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    page = PagedInferenceEngine._auto_page_size(configs.LLAMA2_7B,
                                                max_seq=2048)
    try:
        dev = phase_device(torch)
        phase_build()
        worst = phase_kernel_checks(torch, page)
        worst.update(phase_flash_checks(torch))
        worst.update(phase_flash_bwd_checks(torch))
        phase_autograd_check(torch)
        times = phase_kernel_times(torch, page)
        flash_times = phase_flash_times(torch)
        flash_times.update(phase_flash_bwd_times(torch))
        phase_weight_path(torch)
        k6_launches, k6_worst, k6_times = phase_kv_probe(torch, page)
        bf16_launches, bf16_params = phase_serve(torch, args.seed, 'serve',
                                                 keep_params=True)
        k4_launches, k3_launches = phase_serve_slot(torch, args.seed,
                                                    bf16_params)
        del bf16_params
        torch.cuda.empty_cache()
        int8_launches, int8_params = phase_serve(
            torch, args.seed, 'serve_int8', keep_params=True,
            quantize='int8')
        variants = phase_decode_variants(torch, args.seed, int8_params)
        del int8_params
        torch.cuda.empty_cache()
        phase_reference(torch, args.seed)
        train_k4, k5a_launches, k5b_launches = phase_train(
            torch, args.seed, flash_times)
        phase_train_reference(torch, args.seed)
        emit({'kernels': [
            _kernel_entry('paged_decode', 'paged_decode.cu',
                          'paged_attention.py:131', bf16_launches,
                          worst['paged_decode'], times['paged_decode']),
            _kernel_entry('paged_decode_int8', 'paged_decode.cu',
                          'paged_attention.py:103', int8_launches,
                          worst['paged_decode_int8'],
                          times['paged_decode_int8']),
            _kernel_entry('paged_decode_int4', 'paged_decode.cu',
                          'paged_attention.py:65',
                          variants['paged_decode_attention[int4]'],
                          worst['paged_decode_int4'],
                          times['paged_decode_int4']),
            dict(_kernel_entry('paged_decode_all_layers', 'paged_decode.cu',
                               'paged_attention.py:193', k6_launches,
                               k6_worst, k6_times['paged_decode_all_layers']),
                 launches_by_path={'kv_probe': k6_launches}),
            _kernel_entry('paged_decode_fused', 'paged_decode_fused.cu',
                          'paged_attention.py:246',
                          variants['paged_decode_attention_fused[int8]'],
                          worst['paged_decode_fused'],
                          times['paged_decode_fused[int8]']),
            dict(_kernel_entry('flash_fwd_chunk', 'flash_fwd.cu',
                               'flash_attention.py:159', k3_launches,
                               worst['flash_fwd_chunk'],
                               flash_times[('flash_fwd_chunk', 'served')]),
                 times_by_shape=_times_by_shape(
                     flash_times, 'flash_fwd_chunk', ('served', 'long'))),
            dict(_kernel_entry('flash_fwd', 'flash_fwd.cu',
                               'flash_attention.py:44',
                               k4_launches + train_k4, worst['flash_fwd'],
                               flash_times[('flash_fwd', 'served')]),
                 launches_by_path={'serve_slot': k4_launches,
                                   'train': train_k4}),
            _kernel_entry('flash_bwd_dkv', 'flash_bwd.cu',
                          'flash_attention.py:284', k5a_launches,
                          worst['flash_bwd_dkv'],
                          flash_times[('flash_bwd_dkv', 'train')]),
            dict(_kernel_entry('flash_bwd_dq', 'flash_bwd.cu',
                               'flash_attention.py:341', k5b_launches,
                               worst['flash_bwd_dq'],
                               flash_times[('flash_bwd_dq', 'train')]),
                 times_by_shape=_times_by_shape(
                     flash_times, 'flash_bwd_dq', ('train', '7b')))]})
    except Exception as e:  # pylint: disable=broad-except
        import traceback
        traceback.print_exc()
        print(f'chip_smoke: FAILED: {type(e).__name__}: {e}',
              file=sys.stderr)
        return 1
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': dev['name'],
                                 'count': dev['count']}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
