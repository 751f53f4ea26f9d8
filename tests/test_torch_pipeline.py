"""Pipeline parallelism in the port (``parallel/pipeline.py``) held
against sequential execution, the JAX package's ``pipeline_layers`` on
the 8 CPU devices ``tests/conftest.py`` forces, and the port's meshless
trainer.

The op-level cases run through the pipeline's lock-step runner (every
stage in this process, one autograd graph); the trainer cases run gloo
training meshes of 4 and 8 ranks:

- the reference's cases (``tests/test_pipeline.py``): forward and
  gradients of a toy stack against sequential at (pp, M) = (2, 2),
  (2, 4) and (4, 4), with and without the bubble skip, and against the
  reference's pipeline; the microbatch divisibility error; ``with_aux``
  (the mean over live stage-ticks); the cached forward at pp 2 equal to
  pp 1 token for token (llama's layers, ``_layer_core`` against the
  cache through ``cached_attention``, chained by
  ``pipeline_decode_layers``), and pp 1's logits equal to the
  reference's cached forward;
- stage bodies counted instead of timed: with the skip, P x M of them;
  without, P x (M + P - 1);
- the trainer at pp 2 x fsdp 2 (the skip on, the stage's fsdp
  all-gather issued every tick) and at pp 2 x fsdp 2 x tp 2 (the skip
  off: tp collectives in the stage) against the meshless trainer: equal
  losses, grad norms and params, and rank 0's stage ran M or M + P - 1
  bodies a forward; MoE at pp 2 with its aux loss, equal to the mean of
  the per-microbatch aux losses, as the reference's test holds it.

Tolerances: fp32 within 1e-5 (sequential vs pipelined sums are the same
sums; the reference's test uses 1e-5 forward and 1e-4 gradients), the
trainer's metrics within 1e-5 relative and params within 1e-4 absolute,
as ``tests/test_torch_train_mesh.py`` argues.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jconfigs
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel.pipeline import pipeline_layers as jpipeline
from skypilot_tpu_torch.models import configs, convert, llama
from skypilot_tpu_torch.ops.attention import cached_attention
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import pipeline
from skypilot_tpu_torch.train import trainer as ttrainer

jax.config.update('jax_platforms', 'cpu')

ATOL = 1e-5
RTOL_METRICS = 1e-5
ATOL_PARAMS = 1e-4


def _toy_stack(n_layers=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return {'w': (rng.standard_normal((n_layers, d, d)) * 0.3).astype(
                np.float32),
            'b': (rng.standard_normal((n_layers, d)) * 0.1).astype(
                np.float32)}


def _stage_fn(params, x):
    for i in range(params['w'].shape[0]):
        x = torch.tanh(x @ params['w'][i] + params['b'][i])
    return x


def _tensors(tree):
    return {k: torch.tensor(v, requires_grad=True) for k, v in tree.items()}


@pytest.mark.parametrize('pp,n_micro', [(2, 2), (2, 4), (4, 4)])
@pytest.mark.parametrize('skip', [True, False])
def test_forward_and_gradients_match_sequential(pp, n_micro, skip):
    stack = _tensors(_toy_stack())
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (8, 4, 16)).astype(np.float32))
    want = _stage_fn(stack, x)
    want_g = torch.autograd.grad((want ** 2).sum(), list(stack.values()))
    pipeline.reset_stage_calls()
    got = pipeline.pipeline_layers(stack, x, _stage_fn, pp,
                                   num_microbatches=n_micro,
                                   skip_bubbles=skip)
    # Stage bodies run: live (stage, microbatch) pairs only with the
    # skip, every stage every tick without.
    assert pipeline.stage_calls['run'] == (
        pp * n_micro if skip else pp * (n_micro + pp - 1))
    got_g = torch.autograd.grad((got ** 2).sum(), list(stack.values()))
    np.testing.assert_allclose(got.detach(), want.detach(), rtol=0,
                               atol=ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_matches_the_reference_pipeline():
    stack = _toy_stack()
    x = np.random.default_rng(2).standard_normal((8, 4, 16)).astype(
        np.float32)

    def jstage(params, xx):
        def one(carry, layer):
            return jnp.tanh(carry @ layer['w'] + layer['b']), None
        return jax.lax.scan(one, xx, params)[0]
    mesh = jmesh.make_mesh(jmesh.MeshSpec(pp=2, dp=4), jax.devices()[:8])
    with mesh:
        want = jax.jit(functools.partial(
            jpipeline, stage_fn=jstage, mesh=mesh,
            num_microbatches=4))(stack, x)
    got = pipeline.pipeline_layers(
        {k: torch.tensor(v) for k, v in stack.items()}, torch.tensor(x),
        _stage_fn, mesh_lib.MeshSpec(pp=2, dp=4), num_microbatches=4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_batch_divisibility_and_skip_guard():
    stack = _tensors(_toy_stack())
    with pytest.raises(ValueError, match='microbatch'):
        pipeline.pipeline_layers(stack, torch.zeros(3, 4, 16), _stage_fn,
                                 2, num_microbatches=2)
    with pytest.raises(ValueError, match='skip_bubbles'):
        pipeline.pipeline_layers(stack, torch.zeros(4, 4, 16), _stage_fn,
                                 mesh_lib.MeshSpec(pp=2, tp=2),
                                 skip_bubbles=True)


def test_with_aux_is_the_mean_over_live_stage_ticks():
    stack = _tensors(_toy_stack())
    x = torch.randn(8, 4, 16)
    out, aux = pipeline.pipeline_layers(
        stack, x, lambda p, xx: (_stage_fn(p, xx), torch.tensor(2.5)), 2,
        with_aux=True)
    np.testing.assert_allclose(out.detach(), _stage_fn(stack, x).detach(),
                               rtol=0, atol=ATOL)
    assert float(aux) == 2.5


def _cached_forward(params, tokens, cfg, cache, pp):
    """The reference's cached forward (``llama.forward(cache=)``), with
    the layer stack chained through ``pipeline_decode_layers`` over
    ``pp`` lock-step stages: each layer attends its cache rows plus the
    causal new block, and the new rows are merged after the layers."""
    x = llama._embed_tokens(params, tokens, cfg)
    s = tokens.shape[1]
    positions = cache.length.long()[:, None] + torch.arange(s)[None, :]

    def stage_fn(stack, caches, x, extras):
        ks, vs = [], []
        for li, layer in enumerate(llama.unbind_layers({'layers': stack})):
            def attn_fn(q, k, v, ck=caches[0][li], cv=caches[1][li]):
                return cached_attention(q, k, v, ck, cv, cache.length)
            x, (k, v), _ = llama._layer_core(layer, x, cfg, positions,
                                             attn_fn, None)
            ks.append(k)
            vs.append(v)
        return x, (torch.stack(ks), torch.stack(vs))
    x, (k_rows, v_rows) = pipeline.pipeline_decode_layers(
        params['layers'], cache.tensors(), x, stage_fn, pp)
    llama.merge_rows_into_cache(cache, k_rows, v_rows, cache.length,
                                cache.length + s)
    x = llama.rms_norm(x, params['final_norm'], cfg.norm_eps,
                       cfg.norm_plus_one)
    return llama._unembed_logits(params, x, cfg), cache


def test_cached_forward_pp2_equals_pp1_and_the_reference():
    """Greedy prefill + 3 decode steps (the reference's
    ``test_cached_forward_pp2_matches_pp1``): the stages chained through
    ``pipeline_decode_layers`` give pp 1's tokens and logits exactly,
    and pp 1's prefill logits equal the reference's cached forward."""
    tcfg = dataclasses.replace(configs.TINY, n_layers=4,
                               dtype=torch.float32)
    jcfg = dataclasses.replace(jconfigs.TINY, n_layers=4,
                               dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_numpy(jax.device_get(jparams), tcfg,
                                       device='cpu')
    toks = (np.arange(12).reshape(2, 6) % tcfg.vocab_size) + 1

    def greedy(pp):
        cache = llama.KVCache.create(tcfg, 2, 32, device='cpu')
        x, outs, first = torch.tensor(toks), [], None
        for _ in range(4):
            logits, cache = _cached_forward(params, x, tcfg, cache, pp)
            first = logits if first is None else first
            x = logits[:, -1].argmax(-1)[:, None]
            outs.append(x[:, 0])
        return torch.stack(outs), first, logits
    ref_toks, ref_first, ref_last = greedy(1)
    pp_toks, pp_first, pp_last = greedy(2)
    assert torch.equal(pp_toks, ref_toks)
    assert torch.equal(pp_last, ref_last)
    jcache = jllama.KVCache.create(jcfg, batch=2, max_seq=32)
    jlogits, _ = jllama.forward(jparams, jnp.asarray(toks), jcfg,
                                cache=jcache, attn_impl='xla')
    np.testing.assert_allclose(pp_first, np.asarray(jlogits), rtol=0,
                               atol=ATOL)


def _batch(b=8, s=16, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return dict(inputs=rng.integers(0, vocab, (b, s)).astype(np.int32),
                targets=rng.integers(0, vocab, (b, s)).astype(np.int32))


@pytest.mark.parametrize('shape', [dict(pp=2, fsdp=2),
                                   dict(pp=2, fsdp=2, tp=2)],
                         ids=['fsdp_skip', 'tp_no_skip'])
def test_trainer_at_pp2_matches_pp1(shape):
    """Two steps at pp 2 (4 layers, 2 a stage, 2 microbatches) equal the
    meshless trainer's; under pp x fsdp the skip is on (rank 0's stage
    runs its 2 live microbatches a forward), under pp x tp it is off (3
    ticks a forward). Then MoE on the pp x fsdp mesh: its aux loss is
    the mean of the per-microbatch aux losses, as the reference's is."""
    cfg = dataclasses.replace(configs.TINY, n_layers=4, dtype=torch.float32)
    tc = ttrainer.TrainConfig(learning_rate=1e-3, warmup_steps=0,
                              total_steps=10, attn_impl='xla')
    plain = ttrainer.Trainer(cfg, train_config=tc, device='cpu')
    pstate = plain.init(0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(**shape), device='cpu',
                              timeout_s=60.0)
    try:
        tr = ttrainer.Trainer(cfg, mesh=mesh, train_config=tc)
        state = tr.init(0)
        for _ in range(2):
            pstate, want = plain.step(pstate, _batch())
            pipeline.reset_stage_calls()
            state, got = tr.step(state, _batch())
            # Rank 0 is stage 0: M live ticks, or every one of M + P - 1.
            assert pipeline.stage_calls['run'] == (
                3 if 'tp' in shape else 2)
            for key in ('loss', 'grad_norm', 'accuracy'):
                np.testing.assert_allclose(float(got[key]),
                                           float(want[key]),
                                           rtol=RTOL_METRICS, err_msg=key)
        full = tr.full_params(state)
        assert tuple(state.params['layers']['wq'].shape)[0] == 2
        for a, b in zip(jax.tree.leaves(convert.params_to_numpy(full)),
                        jax.tree.leaves(convert.params_to_numpy(
                            pstate.params))):
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL_PARAMS)
        tr.close()
        if 'tp' in shape:
            return
        moe = dataclasses.replace(configs.TINY_MOE, n_layers=4,
                                  dtype=torch.float32)
        mtr = ttrainer.Trainer(moe, mesh=mesh, train_config=tc)
        mstate = mtr.init(0)
        batch = _batch()
        _, m = mtr.step(mstate, batch)
        mtr.close()
    finally:
        mesh.shutdown()
        torch.set_num_threads(n)
    params = llama.init_params(moe, 0, device='cpu')
    tokens = torch.tensor(batch['inputs']).long()
    auxs = [llama.forward(params, tokens[i:i + 4], moe, attn_impl='xla',
                          return_aux=True)[1] for i in (0, 4)]
    want_aux = float(torch.stack(auxs).mean())
    assert float(m['moe_aux_loss']) > 0.0
    np.testing.assert_allclose(float(m['moe_aux_loss']), want_aux,
                               rtol=RTOL_METRICS)
