"""The frozen reference computes the port's semantics.

At a tiny Qwen2 shape (biases drawn non-zero) and a tiny Mixtral shape
(capacity factor E / k, so the port drops no token), both in fp32:

- prefill: the port's full causal forward (``llama.forward``) against
  the reference's logits at every position;
- decode: the port's paged engine (chunked prefill, the page pool, its
  decode loop, greedy) generates; at every generated position the
  reference, fed the same tokens, ranks the generated token first, up
  to a near-tie.

Tolerance: both sides compute in fp32 with other operation orders
(einsum against plain matmuls, a fused softmax against a blocked one),
so logits of magnitude ~5 differ by some float32 roundings through two
layers, ~1e-5; 1e-4 leaves room and is still far below the ~0.05 a
bf16 rounding of the activations moves them.
"""
import dataclasses

import pytest
import torch

from perfbench.reference import model, weights
from perfbench.reference.sizes import Sizes
from perfbench.tests import rig

TOL = 1e-4


def _port_params(params):
    """The seeded tree with its bf16 matrices widened to fp32."""
    def f32(t):
        return t.float() if t.dtype == torch.bfloat16 else t
    out = {k: f32(v) for k, v in params.items() if k != 'layers'}
    out['layers'] = {k: f32(v) for k, v in params['layers'].items()}
    return out


def _setup(hf, capacity=None):
    from skypilot_tpu_torch.models import weights as port_weights
    s = Sizes.from_hf(hf)
    cfg = port_weights.config_from_hf(hf, name='t', dtype=torch.float32)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity)
    params = _port_params(weights.make_params(s, 2 ** 35 + 17, 'cpu'))
    return s, cfg, params


@pytest.mark.parametrize('hf,capacity', [(rig.TINY_QWEN, None),
                                         (rig.TINY_MIXTRAL, 2.0)],
                         ids=['qwen2', 'mixtral'])
def test_prefill_logits_equal_the_port(hf, capacity):
    from skypilot_tpu_torch.models import llama
    s, cfg, params = _setup(hf, capacity)
    gen = torch.Generator().manual_seed(3)
    seqs = [torch.randint(0, s.vocab, (n,), generator=gen).tolist()
            for n in (37, 70)]
    ref, _ = model.logits_at(params, s, seqs, [0, 0])
    for seq, r in zip(seqs, ref):
        with torch.no_grad():
            port = llama.forward(params, torch.tensor([seq]), cfg,
                                 attn_impl='auto')[0]
        assert (port - r).abs().max().item() < TOL


@pytest.mark.parametrize('hf,capacity', [(rig.TINY_QWEN, None),
                                         (rig.TINY_MIXTRAL, 2.0)],
                         ids=['qwen2', 'mixtral'])
def test_decode_through_the_pool_follows_the_reference(hf, capacity):
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    s, cfg, params = _setup(hf, capacity)
    eng = PagedInferenceEngine(cfg, params, max_batch=3, max_seq=128,
                               page_size=16, prefill_chunk_tokens=32,
                               device='cpu')
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, s.vocab, (n,), generator=gen).tolist()
               for n in (20, 45, 70)]
    ids = [eng.add_request(p, max_new_tokens=24) for p in prompts]
    done = eng.run_to_completion(horizon=8)
    outs = [done[i].output for i in ids]
    seqs = [p + o[:-1] for p, o in zip(prompts, outs)]
    ref, _ = model.logits_at(params, s, seqs, [len(p) - 1 for p in prompts])
    for r, out in zip(ref, outs):
        top2 = r.topk(2, -1).values
        gap = r.max(-1).values - r.gather(-1, torch.tensor(out)[:, None])[:, 0]
        near_tie = (top2[:, 0] - top2[:, 1]) < TOL
        assert bool(((gap < TOL) | near_tie).all())
        assert (gap > 0).sum() <= near_tie.sum()


def test_a_shared_prefix_changes_nothing():
    """The prefix cache's pages give the same logits as a cold prefill
    (the second request's first 32 tokens are served from the pool)."""
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    s, cfg, params = _setup(rig.TINY_QWEN)
    eng = PagedInferenceEngine(cfg, params, max_batch=2, max_seq=128,
                               page_size=16, prefill_chunk_tokens=32,
                               device='cpu')
    gen = torch.Generator().manual_seed(5)
    head = torch.randint(0, s.vocab, (40,), generator=gen).tolist()
    a = head + torch.randint(0, s.vocab, (9,), generator=gen).tolist()
    b = head + torch.randint(0, s.vocab, (13,), generator=gen).tolist()
    ia = eng.add_request(a, max_new_tokens=16)
    eng.run_to_completion(horizon=8)
    ib = eng.add_request(b, max_new_tokens=16)
    done = eng.run_to_completion(horizon=8)
    assert eng.alloc.prefix_hits >= 1
    for prompt, rid in ((a, ia), (b, ib)):
        out = done[rid].output
        (r,), _ = model.logits_at(params, s, [prompt + out[:-1]],
                                  [len(prompt) - 1])
        gap = r.max(-1).values - r.gather(-1, torch.tensor(out)[:, None])[:, 0]
        assert gap.max().item() < TOL


def test_routing_variants_equal_a_forward_routed_so():
    """Each routing variant's logits are those of a whole forward that
    routes that token through the (k+1)-th expert at the variant's
    layers, everything else alike."""
    s, _, params = _setup(rig.TINY_MIXTRAL, 2.0)
    gen = torch.Generator().manual_seed(6)
    seqs = [torch.randint(0, s.vocab, (n,), generator=gen).tolist()
            for n in (23, 31)]
    starts = [17, 20]
    ref, var = model.logits_at(params, s, seqs, starts, tie_margin=1e9)
    ref = torch.cat(ref)
    # Every layer is near a tie: one variant per layer and one per pair.
    L = s.n_layers
    assert var.logits.shape[0] == ref.shape[0] * (L + L * (L - 1) // 2)
    want = [o + p for o, st, n in zip((0, 23), starts, (23, 31))
            for p in range(st, n)]
    T = sum(len(q) for q in seqs)
    for v in (0, 1, 2, 5, var.logits.shape[0] - 1):
        w = int(var.position[v])
        first = v - (v % (L + L * (L - 1) // 2))
        combos = [(l,) for l in range(L)] + [(a, b) for a in range(L)
                                              for b in range(a + 1, L)]
        layers = combos[v - first]
        flips = {}
        for li in layers:
            mask = torch.zeros(T, dtype=torch.bool)
            mask[want[w]] = True
            flips[li] = mask
        forced, _ = model.logits_at(params, s, seqs, starts, flips=flips)
        forced = torch.cat(forced)[w]
        assert (forced - var.logits[v]).abs().max().item() < TOL
        assert (forced - ref[w]).abs().max().item() > 100 * TOL


def test_no_variants_without_a_near_tie():
    s, _, params = _setup(rig.TINY_MIXTRAL, 2.0)
    seqs = [list(range(5, 30))]
    _, var = model.logits_at(params, s, seqs, [10], tie_margin=0.0)
    assert var.logits.shape[0] == 0
    _, none = model.logits_at(params, s, seqs, [10])
    assert none is None
