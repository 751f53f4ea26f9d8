"""The port's training path held against the JAX package on the CPU.

- The trainer: ``TINY`` in fp32 with every ``remat`` policy ('none',
  'block', 'attn', 'dots'), the JAX ``Trainer`` on a one-device mesh (``attn_impl='xla'``: on the CPU
  the JAX flash path would compile Mosaic) against the port's
  ``Trainer(device='cpu')`` with ``attn_impl`` 'xla' and 'flash' (the
  autograd Function over the plain forward and backward), from the same
  params (``params_from_numpy``) on the same batches for 3 steps. Loss,
  accuracy and grad_norm agree within 1e-5 relative at every step (fp32
  sums in different orders: measured ~2e-7); first-step grads within
  1e-5 of the largest |grad|; params after 3 steps within 1e-5
  absolute. Why 1e-5 for the params: Adam moves every element by about
  lr (1e-3 here) per step whatever its gradient, so a gradient whose
  sign or size near eps differed between the packages would show as a
  difference of order lr; 1e-5 (1% of lr) catches any such flip or a
  wrong update, with ~40x headroom over the measured 2.8e-7.
- The optimizer against optax op by op on numpy trees with fp32 leaves
  and a bf16 leaf, ``mu_dtype`` 'float32' and 'bfloat16', over steps
  0-3 of a warmup schedule with and without clipping: fp32 leaves within
  1e-6 relative (the global norm sums in another order: one fp32 ulp
  measured), bf16 leaves within one bf16 rounding (2^-8 relative).
- The corpus pipeline array for array, checkpoint resume bit for bit,
  and the command line (train, checkpoint, resume) on the CPU.
- The remat policies: gradients under 'block', 'attn' and 'dots' equal
  'none' bit for bit (dense and ``tiny-moe``, full and LoRA training:
  a policy only chooses what is kept and what recomputed, and the CPU
  recomputes the same sums); the attention forward runs again in the
  backward once a layer under 'block' and 'dots' and never under
  'attn'; 'dots' recomputes no weight product.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from skypilot_tpu.models import configs as jconfigs
from skypilot_tpu.models.tokenizer import load_tokenizer as jload_tokenizer
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import data as jdata
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch.models import configs as tconfigs
from skypilot_tpu_torch.models import convert, llama
from skypilot_tpu_torch.models.tokenizer import \
    load_tokenizer as tload_tokenizer
from skypilot_tpu_torch.train import data as tdata
from skypilot_tpu_torch.train import trainer as ttrainer
from skypilot_tpu_torch.train.__main__ import main as train_main
from skypilot_tpu_torch.train.optim import tree_leaves

jax.config.update('jax_platforms', 'cpu')

TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
STEPS = 3
RTOL_METRICS = 1e-5
TOL_GRADS = 1e-5
ATOL_PARAMS = 1e-5


def _batches(n, vocab=256, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(inputs=rng.integers(0, vocab, (b, s)).astype(np.int32),
                 targets=rng.integers(0, vocab, (b, s)).astype(np.int32),
                 mask=(rng.random((b, s)) > 0.2).astype(np.float32))
            for _ in range(n)]


def _tcfg(remat):
    return dataclasses.replace(tconfigs.TINY, dtype=torch.float32,
                               remat=remat)


@functools.lru_cache(maxsize=None)
def _jax_run(remat):
    """(initial params, first-step grads, per-step metrics, final
    params), all numpy, of the JAX trainer on one CPU device."""
    cfg = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32, remat=remat)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(), jax.devices()[:1])
    trainer = jtrainer.Trainer(
        cfg, train_config=jtrainer.TrainConfig(attn_impl='xla', **TC),
        mesh=mesh)
    state = trainer.init(jax.random.PRNGKey(0))
    params0 = jax.device_get(state.params)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in _batches(STEPS)]
    grads0 = jax.device_get(jax.grad(
        lambda p: jtrainer.loss_fn(p, batches[0], cfg, 'xla')[0])(
            state.params))
    metrics = []
    for batch in batches:
        state, m = trainer.step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return params0, grads0, metrics, jax.device_get(state.params)


@pytest.mark.parametrize('impl', ['xla', 'flash'])
@pytest.mark.parametrize('remat', ['none', 'block', 'attn', 'dots'])
def test_trainer_matches_jax(remat, impl):
    params0, grads0, want_metrics, want_params = _jax_run(remat)
    cfg = _tcfg(remat)
    trainer = ttrainer.Trainer(
        cfg, train_config=ttrainer.TrainConfig(attn_impl=impl, **TC),
        device='cpu')
    state = trainer.state_from_params(
        convert.params_from_numpy(params0, cfg, device='cpu'))
    batches = _batches(STEPS)

    _, _, grads = ttrainer.value_and_grad(
        state.params, trainer._batch(batches[0]), cfg, impl)
    got_g = jax.tree.leaves(convert.params_to_numpy(grads))
    want_g = jax.tree.leaves(grads0)
    scale = max(float(np.abs(w).max()) for w in want_g)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL_GRADS * scale)

    for batch, want in zip(batches, want_metrics):
        state, m = trainer.step(state, batch)
        for key in ('loss', 'accuracy', 'grad_norm'):
            np.testing.assert_allclose(float(m[key]), want[key],
                                       rtol=RTOL_METRICS, err_msg=key)
    assert state.step == STEPS and state.opt_state.count == STEPS
    for g, w in zip(jax.tree.leaves(convert.params_to_numpy(state.params)),
                    jax.tree.leaves(want_params)):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL_PARAMS)


def _opt_tree(rng, scale=1.0):
    return {'a': (scale * rng.standard_normal((8, 16))).astype(np.float32),
            'b': {'c': (scale * rng.standard_normal(64)).astype(
                ml_dtypes.bfloat16),
                  'd': (scale * rng.standard_normal(4)).astype(np.float32)}}


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


@pytest.mark.parametrize('mu_dtype', ['float32', 'bfloat16'])
def test_optimizer_matches_optax(mu_dtype):
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
              mu_dtype=mu_dtype)
    jopt = jtrainer.make_optimizer(jtrainer.TrainConfig(**kw))
    topt = ttrainer.make_optimizer(ttrainer.TrainConfig(**kw))
    rng = np.random.default_rng(1)
    params = _opt_tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = jax.tree.map(convert._to_tensor, params)
    tstate = topt.init(tp)
    for step in range(4):
        # Odd steps stay under the clip norm (1.0), even ones exceed it.
        grads = _opt_tree(rng, 0.05 if step % 2 else 1.0)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads),
                                      jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tstate, norm = topt.update(jax.tree.map(convert._to_tensor, grads),
                                   tstate, tp)
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        adam = jstate[1][0]
        assert tstate.count == int(adam.count) == step + 1
        for want_tree, got_tree in ((jp, tp), (adam.mu, tstate.mu),
                                    (adam.nu, tstate.nu)):
            for w, g in zip(jax.tree.leaves(want_tree),
                            tree_leaves(got_tree)):
                assert str(g.dtype).endswith(str(w.dtype))
                rtol = 2.0 ** -8 if w.dtype == jnp.bfloat16 else 1e-6
                np.testing.assert_allclose(_np(g), _np(w), rtol=rtol,
                                           atol=1e-7)


def test_learning_rate_schedule_matches_optax():
    from skypilot_tpu_torch.train.optim import warmup_cosine_schedule
    for warmup, total in ((3, 10), (100, 5), (0, 4)):
        lr = warmup_cosine_schedule(1e-3, warmup, total)
        clamped = min(warmup, max(total - 1, 0))
        want = optax.warmup_cosine_decay_schedule(
            0.0, 1e-3, clamped, total, end_value=1e-4)
        for count in range(total + 2):
            np.testing.assert_allclose(float(lr(count)), float(want(count)),
                                       rtol=1e-6, atol=1e-12)
    assert float(warmup_cosine_schedule(1e-3, 1, 6)(0)) == 0.0


def _corpus(tmp_path):
    rng = np.random.default_rng(3)
    words = ['alpha', 'beta', 'gamma', 'delta', 'epsilon', 'zeta']
    paths = []
    for i in range(3):
        path = tmp_path / f'doc{i}.txt'
        path.write_text(' '.join(rng.choice(words, 200 + 50 * i)))
        paths.append(str(path))
    return paths


def test_data_pipeline_matches_jax(tmp_path):
    paths = _corpus(tmp_path)
    for source in (paths[0], str(tmp_path), str(tmp_path / 'doc*.txt')):
        jstream = jdata.TokenStream(source, jload_tokenizer(None, 300))
        tstream = tdata.TokenStream(source, tload_tokenizer(None, 300))
        np.testing.assert_array_equal(tstream.tokens, jstream.tokens)
        for kw in (dict(batch=2, seq=16), dict(batch=3, seq=8, dp_rank=1,
                                               dp_size=2, start_step=5)):
            jit_, tit = (jdata.packed_batches(jstream, **kw),
                         tdata.packed_batches(tstream, **kw))
            for _ in range(4):
                jb, tb = next(jit_), next(tit)
                assert sorted(jb) == sorted(tb)
                for key in jb:
                    np.testing.assert_array_equal(tb[key], jb[key])
                    assert tb[key].dtype == jb[key].dtype
    for uri in ('gs://bucket/corpus', 's3://b/c', 'r2://b/c'):
        with pytest.raises(NotImplementedError):
            tdata.TokenStream(uri)


def test_checkpoint_resume_is_bit_exact(tmp_path):
    cfg = _tcfg('none')
    tc = ttrainer.TrainConfig(**TC)
    batches = _batches(4, seed=7)

    def fresh():
        trainer = ttrainer.Trainer(cfg, train_config=tc, device='cpu')
        return trainer, trainer.init(0)

    trainer, straight = fresh()
    for batch in batches:
        straight, _ = trainer.step(straight, batch)

    trainer, state = fresh()
    for batch in batches[:2]:
        state, _ = trainer.step(state, batch)
    trainer.save_checkpoint(str(tmp_path / 'ck'), state)
    trainer2 = ttrainer.Trainer(cfg, train_config=tc, device='cpu')
    resumed = trainer2.restore_checkpoint(str(tmp_path / 'ck'))
    assert resumed.step == 2 and resumed.opt_state.count == 2
    for batch in batches[2:]:
        resumed, _ = trainer2.step(resumed, batch)
    assert resumed.step == straight.step == 4
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(straight.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(resumed.opt_state.mu),
                    tree_leaves(straight.opt_state.mu)):
        assert torch.equal(a, b)


def test_fit_reports_host_metrics_to_callbacks(tmp_path):
    from skypilot_tpu_torch.callbacks import BaseCallback, TimerCallback

    class Record(BaseCallback):
        def __init__(self):
            self.seen = []

        def on_step_end(self, step, metrics):
            self.seen.append((step, metrics))

    rec = Record()
    timer = TimerCallback(log_dir=str(tmp_path), write_every=100)
    trainer = ttrainer.Trainer(_tcfg('block'),
                               train_config=ttrainer.TrainConfig(**TC),
                               device='cpu')
    state = trainer.fit(trainer.init(0), iter(_batches(3)), 3, [rec, timer])
    assert state.step == 3 and [s for s, _ in rec.seen] == [0, 1, 2]
    assert all(isinstance(m['loss'], float) and isinstance(
        m['grad_norm'], float) for _, m in rec.seen)
    summary = json.loads((tmp_path / 'benchmark_summary.json').read_text())
    assert summary['num_steps'] == 3


def test_cli_trains_and_resumes(tmp_path, capsys):
    corpus = _corpus(tmp_path)[2]
    ck = str(tmp_path / 'ck')
    common = ['--device', 'cpu', '--model', 'tiny', '--data', corpus,
              '--batch', '2', '--seq', '16', '--lr', '1e-2',
              '--warmup-steps', '1', '--log-every', '1', '--ckpt-dir', ck]
    train_main(common + ['--steps', '3', '--save-every', '2'])
    out = capsys.readouterr().out
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith('{')]
    assert [ln['step'] for ln in lines] == [1, 2, 3]
    assert all(set(ln) == {'step', 'loss', 'accuracy', 'tok_s'}
               for ln in lines)
    assert all(np.isfinite(ln['loss']) for ln in lines)
    assert sorted(os.listdir(ck)) == ['LATEST', 'step_2', 'step_3']
    train_main(common + ['--steps', '5'])
    out = capsys.readouterr().out
    assert 'resumed from' in out and 'step_3 at step 3' in out
    assert [json.loads(ln)['step'] for ln in out.splitlines()
            if ln.startswith('{')] == [4, 5]
    assert open(os.path.join(ck, 'LATEST'), encoding='utf-8').read() == \
        'step_5'


def test_forward_aux_and_remat_policies():
    cfg = _tcfg('none')
    params = llama.init_params(cfg, 0, device='cpu')
    tokens = torch.from_numpy(_batches(1)[0]['inputs']).long()
    logits = llama.forward(params, tokens, cfg)
    logits2, aux = llama.forward(params, tokens, cfg, return_aux=True)
    assert torch.equal(logits, logits2) and float(aux) == 0.0
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    grads = {r: ttrainer.value_and_grad(params, batch, _tcfg(r))[2]
             for r in ('none', 'block')}
    for a, b in zip(tree_leaves(grads['none']), tree_leaves(grads['block'])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    # Every policy runs the same forward without autograd.
    with torch.no_grad():
        for remat in ('block', 'attn', 'dots'):
            assert torch.equal(llama.forward(params, tokens, _tcfg(remat)),
                               logits)
    with pytest.raises(ValueError):
        llama.forward(params, tokens, _tcfg('everything'))


def test_training_options_on_a_mesh(tmp_path, capsys):
    """A mesh is ported: ``mesh_spec`` must be a ``MeshSpec``; a LoRA
    config builds a trainer; ``--tp 2`` and ``--sp 2`` train a few steps
    on a local corpus over a gloo mesh (2 ranks each on the CPU) with a
    falling loss. Object-store corpora still raise."""
    cfg = _tcfg('none')
    with pytest.raises(TypeError, match='MeshSpec'):
        ttrainer.Trainer(cfg, mesh_spec=object(), device='cpu')
    trainer = ttrainer.Trainer(dataclasses.replace(cfg, lora_rank=4),
                               device='cpu')
    assert trainer.init(0).params['layers']['lora']
    corpus = _corpus(tmp_path)[0]
    n = torch.get_num_threads()
    try:
        for flags in (['--tp', '2'], ['--sp', '2']):
            train_main(['--device', 'cpu', '--data', corpus, '--batch', '2',
                        '--seq', '16', '--steps', '4', '--log-every', '2',
                        '--lr', '1e-2', '--warmup-steps', '1'] + flags)
            lines = [json.loads(x) for x in capsys.readouterr().out.split(
                '\n') if x.startswith('{')]
            assert [x['step'] for x in lines] == [2, 4], flags
            assert lines[-1]['loss'] < lines[0]['loss'], (flags, lines)
    finally:
        torch.set_num_threads(n)
    with pytest.raises(NotImplementedError):
        train_main(['--device', 'cpu', '--data', 'gs://bucket/corpus',
                    '--steps', '1'])


def _remat_cfg(name, remat, lora_rank):
    targets = ('wq', 'wk', 'wv', 'wo') + (
        () if name == 'tiny-moe' else ('w_gate', 'w_up', 'w_down'))
    return dataclasses.replace(
        tconfigs.get_config(name), dtype=torch.float32, remat=remat,
        lora_rank=lora_rank, lora_alpha=8.0, lora_targets=targets)


def _live_params(cfg):
    """Params with live adapters (``b`` away from its zeros)."""
    params = llama.init_params(cfg, 0, device='cpu')
    gen = torch.Generator().manual_seed(1)
    for ab in params['layers'].get('lora', {}).values():
        ab['b'].normal_(0.0, 0.2, generator=gen)
    return params


@pytest.mark.parametrize('lora_rank', [0, 4], ids=['full', 'lora'])
@pytest.mark.parametrize('name', ['tiny', 'tiny-moe'])
@pytest.mark.parametrize('impl', ['xla', 'flash'])
def test_remat_policies_give_bit_identical_grads(impl, name, lora_rank):
    params = _live_params(_remat_cfg(name, 'none', lora_rank))
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    runs = {r: ttrainer.value_and_grad(
        params, batch, _remat_cfg(name, r, lora_rank), impl)
        for r in ('none', 'block', 'attn', 'dots')}
    loss0, metrics0, grads0 = runs['none']
    for remat in ('block', 'attn', 'dots'):
        loss, metrics, grads = runs[remat]
        assert torch.equal(loss, loss0), remat
        assert torch.equal(metrics['moe_aux_loss'],
                           metrics0['moe_aux_loss']), remat
        for a, b in zip(tree_leaves(grads), tree_leaves(grads0)):
            assert torch.equal(a, b), remat
    if name == 'tiny-moe':      # the aux loss flows out of every segment
        assert float(metrics0['moe_aux_loss']) > 0
        if not lora_rank:
            assert grads0['layers']['router'].abs().sum() > 0


class _CountOps(TorchDispatchMode):
    """ATen ops run while active, by op name."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize('remat,attn_fwd', [('none', 0), ('block', 2),
                                            ('attn', 0), ('dots', 2)])
def test_attention_forward_reruns_in_backward(monkeypatch, remat,
                                              attn_fwd):
    """The flash forward is called once a layer (L = 2) during the
    backward under 'block' and 'dots' and never under 'none' and
    'attn'; 'dots' multiplies the weights no more often in the backward
    than 'none' does (its saved products come back from the cache),
    'block' and 'attn' do (they recompute them)."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    cfg = _remat_cfg('tiny', remat, 4)
    params = _live_params(cfg)
    calls = []
    real_fwd = fa.flash_attention_fwd

    def fwd(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return real_fwd(*args, **kwargs)

    monkeypatch.setattr(fa, 'flash_attention_fwd', fwd)
    leaves = [t.requires_grad_(True) for t in tree_leaves(
        params['layers']['lora'])]
    tokens = torch.from_numpy(_batches(1)[0]['inputs']).long()
    loss = llama.forward(params, tokens, cfg, attn_impl='flash').sum()
    assert len(calls) == cfg.n_layers
    with _CountOps() as ops:
        torch.autograd.grad(loss, leaves)
    assert len(calls) - cfg.n_layers == attn_fwd
    mm_bwd = ops.counts.get('aten.mm', 0)
    # 'none' runs 12 weight-gradient and input-gradient products here;
    # a policy that recomputes the layer's 3 + 1 + 3 weight products
    # (and nothing else is an ``mm``) runs 7 more a layer.
    extra = {'none': 0, 'dots': 0, 'block': 7, 'attn': 7}[remat]
    assert mm_bwd == 12 + extra * cfg.n_layers, ops.counts
