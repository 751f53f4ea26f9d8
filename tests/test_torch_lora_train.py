"""LoRA fine-tuning in the port held against the JAX package on the CPU.

``TINY_LORA`` is ``TINY`` with rank 4, alpha 8 and all seven targets;
params and adapters cross between the packages through ``convert``.

- ``init_lora_layers``: ``b`` exactly 0 and the std of ``a`` within 5%
  of fan_in^-0.5 (over all targets' ~11,000 draws the sampling error is
  ~0.7%); at init the adapted forward equals the base forward bit for
  bit (fp32 and bf16: the delta is an exact zero).
- The unmerged forward against the reference's ``llama.forward`` on the
  same numpy tree: fp32 within 1e-5 absolute (the same fp32 sums in
  another order: measured 4.6e-6 on logits of size ~3), bf16 against
  the reference compiled without excess precision (ROADMAP R5) within
  one bf16 rounding of the logits (2^-8 relative, plus 2^-8 absolute
  for logits near zero: measured 4.8e-7); and against the port's own
  ``lora.merge`` at fp32 within 1e-5 (measured 6.1e-6).
- The trainer against the JAX ``Trainer`` on one CPU device
  (``attn_impl='xla'``) for 3 steps, the port with ``attn_impl`` 'xla'
  and 'flash' and ``lora_weight_decay`` 0 and 0.1: loss, accuracy and
  grad_norm within 1e-5 relative, adapters within 1e-5 absolute (the
  reasoning of ``test_torch_train.py``: Adam moves each element by ~lr =
  1e-3 a step, so 1e-5 catches any flipped or wrong update), and the
  base bit for bit in both packages. The optimizer state is
  adapter-sized; one batch overfits (30 steps at lr 5e-2 end below 0.9
  of the first loss, as ``tests/test_lora.py`` asks of the reference).
- Adapter checkpoints: ``save_adapter``/``load_adapter`` round-trip,
  the ``.lora.json`` sidecar byte for byte the reference's, a
  mismatched alpha refused with the reference's "mis-scale" message;
  ``init_from_pretrained`` on a ``synth.py`` directory gives a zero
  delta; a LoRA checkpoint resumes bit for bit; the command line with
  ``--lora-rank`` and ``--adapter-out``.
- Serving what was trained: the trained adapter as a bank ``.npz``
  (``multilora.save_adapter``), served by the port's and the reference's
  paged engines, streams the merged model's tokens at fp32.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference.paged import PagedInferenceEngine as JaxPaged
from skypilot_tpu.models import configs as jconfigs
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import lora as jlora
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
from skypilot_tpu_torch.models import configs as tconfigs
from skypilot_tpu_torch.models import convert, llama, lora, multilora, synth
from skypilot_tpu_torch.train import trainer as ttrainer
from skypilot_tpu_torch.train.__main__ import main as train_main
from skypilot_tpu_torch.train.optim import tree_leaves

jax.config.update('jax_platforms', 'cpu')

ALL = ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down')
LORA = dict(lora_rank=4, lora_alpha=8.0, lora_targets=ALL)
JDT = {'fp32': jnp.float32, 'bf16': jnp.bfloat16}
TDT = {'fp32': torch.float32, 'bf16': torch.bfloat16}
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
STEPS = 3
RTOL_METRICS = 1e-5
ATOL_ADAPTERS = 1e-5
ATOL_FP32 = 1e-5
BF16_ROUNDING = 2.0 ** -8


def _cfgs(dtype='fp32'):
    """``TINY_LORA`` in both packages."""
    return (dataclasses.replace(jconfigs.TINY, dtype=JDT[dtype], **LORA),
            dataclasses.replace(tconfigs.TINY, dtype=TDT[dtype], **LORA))


def _batches(n, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(inputs=rng.integers(0, 256, (b, s)).astype(np.int32),
                 targets=rng.integers(0, 256, (b, s)).astype(np.int32),
                 mask=(rng.random((b, s)) > 0.2).astype(np.float32))
            for _ in range(n)]


def _host(jcfg, seed=0):
    """The reference's LoRA params as numpy, ``b`` drawn from N(0, 0.2)
    so the delta is live."""
    host = jax.device_get(jllama.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    for ab in host['layers']['lora'].values():
        ab['b'] = rng.normal(0, 0.2, ab['b'].shape).astype(np.float32)
    return host


def _base(params):
    """The params without their adapters (a LoRA-off tree)."""
    return dict(params, layers={k: v for k, v in params['layers'].items()
                                if k != 'lora'})


# ----------------------------------------------------------------- init

def test_init_lora_layers_draws_and_zero_delta():
    _, tcfg = _cfgs()
    gen = torch.Generator().manual_seed(3)
    tree = lora.init_lora_layers(tcfg, gen, device='cpu')
    assert sorted(tree) == sorted(ALL)
    draws = []
    for t, ab in tree.items():
        a_shape, b_shape = lora._target_shapes(tcfg, t)
        assert tuple(ab['a'].shape) == (tcfg.n_layers,) + a_shape
        assert tuple(ab['b'].shape) == (tcfg.n_layers,) + b_shape
        assert ab['a'].dtype == ab['b'].dtype == torch.float32
        assert not ab['b'].any()
        fan_in = int(np.prod(a_shape[:-1]))
        draws.append(ab['a'].flatten() * fan_in ** 0.5)
    std = float(torch.cat(draws).std())
    assert abs(std - 1.0) < 0.05, std
    again = lora.init_lora_layers(tcfg, torch.Generator().manual_seed(3),
                                  device='cpu')
    assert torch.equal(again['wq']['a'], tree['wq']['a'])


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_forward_at_init_equals_the_base_bit_for_bit(dtype):
    _, tcfg = _cfgs(dtype)
    params = llama.init_params(tcfg, 0, device='cpu')
    assert sorted(params['layers']['lora']) == sorted(ALL)
    tokens = torch.from_numpy(_batches(1)[0]['inputs']).long()
    got = llama.forward(params, tokens, tcfg)
    want = llama.forward(_base(params), tokens,
                         dataclasses.replace(tcfg, lora_rank=0))
    assert torch.equal(got, want)


# -------------------------------------------------------------- forward

@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_unmerged_forward_matches_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    host = _host(jcfg)
    tokens = _batches(1)[0]['inputs']
    jp = jax.tree.map(jnp.asarray, host)
    fn = jax.jit(lambda p, t: jllama.forward(p, t, jcfg)[0])
    if dtype == 'bf16':                    # ROADMAP R5
        fn = fn.lower(jp, jnp.asarray(tokens)).compile(
            compiler_options={'xla_allow_excess_precision': False})
    want = np.asarray(fn(jp, jnp.asarray(tokens)), np.float32)
    tp = convert.params_from_numpy(host, tcfg, device='cpu')
    assert tp['layers']['lora']['wq']['a'].dtype == torch.float32
    got = llama.forward(tp, torch.from_numpy(tokens).long(), tcfg).numpy()
    if dtype == 'fp32':
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_FP32)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ROUNDING,
                                   atol=BF16_ROUNDING)
    # The adapters move the logits.
    base = llama.forward(_base(tp), torch.from_numpy(tokens).long(),
                         dataclasses.replace(tcfg, lora_rank=0)).numpy()
    assert np.abs(base - got).max() > 0.05


def test_unmerged_forward_matches_the_merge():
    jcfg, tcfg = _cfgs()
    tp = convert.params_from_numpy(_host(jcfg), tcfg, device='cpu')
    tokens = torch.from_numpy(_batches(1)[0]['inputs']).long()
    mcfg, merged = lora.merge(tcfg, tp)
    np.testing.assert_allclose(
        llama.forward(tp, tokens, tcfg).numpy(),
        llama.forward(merged, tokens, mcfg).numpy(), rtol=0, atol=ATOL_FP32)


# -------------------------------------------------------------- trainer

@functools.lru_cache(maxsize=None)
def _jax_run(lora_wd):
    """(initial params, per-step metrics, final params) of the JAX
    trainer on one CPU device, numpy."""
    jcfg, _ = _cfgs()
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(), jax.devices()[:1])
    trainer = jtrainer.Trainer(
        jcfg, mesh=mesh, train_config=jtrainer.TrainConfig(
            attn_impl='xla', lora_weight_decay=lora_wd, **TC))
    state = trainer.init(jax.random.PRNGKey(0))
    params0 = jax.device_get(state.params)
    metrics = []
    for batch in _batches(STEPS):
        state, m = trainer.step(state, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return params0, metrics, jax.device_get(state.params)


def _port_trainer(tcfg, impl='xla', lora_wd=0.0, **tc):
    return ttrainer.Trainer(tcfg, device='cpu',
                            train_config=ttrainer.TrainConfig(
                                attn_impl=impl, lora_weight_decay=lora_wd,
                                **{**TC, **tc}))


@pytest.mark.parametrize('lora_wd', [0.0, 0.1])
@pytest.mark.parametrize('impl', ['xla', 'flash'])
def test_trainer_matches_jax(impl, lora_wd):
    params0, want_metrics, want_params = _jax_run(lora_wd)
    _, tcfg = _cfgs()
    trainer = _port_trainer(tcfg, impl, lora_wd)
    state = trainer.state_from_params(
        convert.params_from_numpy(params0, tcfg, device='cpu'))
    base0 = {k: v.clone() for k, v in enumerate(
        tree_leaves(_base(state.params)))}
    for batch, want in zip(_batches(STEPS), want_metrics):
        state, m = trainer.step(state, batch)
        for key in ('loss', 'accuracy', 'grad_norm'):
            np.testing.assert_allclose(float(m[key]), want[key],
                                       rtol=RTOL_METRICS, err_msg=key)
    assert state.step == STEPS and state.opt_state.count == STEPS
    got = convert.params_to_numpy(lora.split_lora(state.params))
    for g, w in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jlora.split_lora(want_params))):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL_ADAPTERS)
    # b moved from its zeros in both packages; the base did not move.
    assert np.abs(got['wq']['b']).max() > 1e-4
    for i, leaf in enumerate(tree_leaves(_base(state.params))):
        assert torch.equal(leaf, base0[i])
    for w, w0 in zip(jax.tree.leaves(_base(want_params)),
                     jax.tree.leaves(_base(params0))):
        assert np.array_equal(np.asarray(w), np.asarray(w0))


def test_optimizer_state_is_adapter_sized_and_the_base_takes_no_grad():
    _, tcfg = _cfgs()
    trainer = _port_trainer(tcfg)
    state = trainer.init(0)
    n_adapter = sum(t.numel() for t in tree_leaves(
        lora.split_lora(state.params)))
    for moments in (state.opt_state.mu, state.opt_state.nu):
        assert sorted(moments) == sorted(ALL)
        assert sum(t.numel() for t in tree_leaves(moments)) == n_adapter
    _, _, grads = ttrainer.value_and_grad(
        state.params, trainer._batch(_batches(1)[0]), tcfg, 'xla')
    assert sorted(grads) == sorted(ALL)
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    assert not any(t.requires_grad for t in tree_leaves(state.params))


def test_lora_overfits_one_batch():
    _, tcfg = _cfgs()
    trainer = _port_trainer(tcfg, learning_rate=5e-2, warmup_steps=0,
                            total_steps=31)
    state = trainer.init(0)
    batch = _batches(1)[0]
    losses = []
    for _ in range(30):
        state, m = trainer.step(state, batch)
        losses.append(float(m['loss']))
    assert losses[-1] < 0.9 * losses[0], losses


# --------------------------------------------------- adapter checkpoints

def test_adapter_round_trip_and_sidecar_matches_reference(tmp_path):
    jcfg, tcfg = _cfgs()
    trainer = _port_trainer(tcfg)
    state = trainer.init(0)
    for batch in _batches(2):
        state, _ = trainer.step(state, batch)
    path = str(tmp_path / 'adapter')
    trainer.save_adapter(path + '/', state)
    assert sorted(os.listdir(tmp_path)) == ['adapter', 'adapter.lora.json']
    fresh = trainer.init(1)
    loaded = trainer.load_adapter(path, fresh)
    for a, b in zip(tree_leaves(lora.split_lora(loaded.params)),
                    tree_leaves(lora.split_lora(state.params))):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(_base(loaded.params)),
                    tree_leaves(_base(fresh.params))):
        assert a is b
    assert loaded.opt_state is fresh.opt_state

    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(), jax.devices()[:1])
    jt = jtrainer.Trainer(jcfg, mesh=mesh)
    jpath = str(tmp_path / 'ref' / 'adapter')
    jt.save_adapter(jpath, jt.init(jax.random.PRNGKey(0)))
    with open(jpath + '.lora.json', 'rb') as f:
        want = f.read()
    with open(path + '.lora.json', 'rb') as f:
        assert f.read() == want

    other = _port_trainer(dataclasses.replace(tcfg, lora_alpha=16.0))
    with pytest.raises(ValueError, match='mis-scale'):
        other.load_adapter(path, other.init(0))
    with pytest.raises(ValueError, match='requires a LoRA config'):
        _port_trainer(dataclasses.replace(tcfg, lora_rank=0)).save_adapter(
            path, state)


def test_init_from_pretrained_adds_zero_delta_adapters(tmp_path):
    _, tcfg = _cfgs()
    path = synth.write_synthetic_hf_checkpoint(
        str(tmp_path / 'ck'), dataclasses.replace(tcfg, lora_rank=0),
        dtype=np.float32)
    trainer = _port_trainer(tcfg)
    state = trainer.init_from_pretrained(path)
    assert sorted(lora.split_lora(state.params)) == sorted(ALL)
    assert not any(ab['b'].any() for ab in
                   lora.split_lora(state.params).values())
    tokens = torch.from_numpy(_batches(1)[0]['inputs']).long()
    assert torch.equal(
        llama.forward(state.params, tokens, tcfg),
        llama.forward(_base(state.params), tokens,
                      dataclasses.replace(tcfg, lora_rank=0)))
    assert sorted(state.opt_state.mu) == sorted(ALL)


def test_lora_checkpoint_resumes_bit_for_bit(tmp_path):
    _, tcfg = _cfgs()
    batches = _batches(4, seed=7)
    trainer = _port_trainer(tcfg, lora_wd=0.1)
    straight = trainer.init(0)
    for batch in batches:
        straight, _ = trainer.step(straight, batch)
    state = trainer.init(0)
    for batch in batches[:2]:
        state, _ = trainer.step(state, batch)
    trainer.save_checkpoint(str(tmp_path / 'ck'), state)
    trainer2 = _port_trainer(tcfg, lora_wd=0.1)
    resumed = trainer2.restore_checkpoint(str(tmp_path / 'ck'))
    assert resumed.step == 2 and resumed.opt_state.count == 2
    assert sorted(resumed.opt_state.mu) == sorted(ALL)
    for batch in batches[2:]:
        resumed, _ = trainer2.step(resumed, batch)
    for tree in ('params', 'mu', 'nu'):
        def get(s):
            return s.params if tree == 'params' else getattr(s.opt_state,
                                                             tree)
        for a, b in zip(tree_leaves(get(resumed)), tree_leaves(get(straight))):
            assert torch.equal(a, b)


def _corpus(tmp_path):
    rng = np.random.default_rng(3)
    words = ['alpha', 'beta', 'gamma', 'delta', 'epsilon', 'zeta']
    path = tmp_path / 'doc.txt'
    path.write_text(' '.join(rng.choice(words, 400)))
    return str(path)


def test_cli_trains_resumes_and_writes_the_adapter(tmp_path, capsys):
    ck, out = str(tmp_path / 'ck'), str(tmp_path / 'adapter')
    common = ['--device', 'cpu', '--model', 'tiny', '--data',
              _corpus(tmp_path), '--batch', '2', '--seq', '16', '--lr',
              '1e-2', '--warmup-steps', '1', '--log-every', '1',
              '--ckpt-dir', ck, '--lora-rank', '4', '--lora-alpha', '8',
              '--lora-targets', 'wq, wv', '--adapter-out', out]
    train_main(common + ['--steps', '2'])
    text = capsys.readouterr().out
    assert 'adapter saved' in text
    train_main(common + ['--steps', '4'])
    text = capsys.readouterr().out
    assert 'step_2 at step 2' in text
    assert [json.loads(ln)['step'] for ln in text.splitlines()
            if ln.startswith('{')] == [3, 4]
    with open(out + '.lora.json', encoding='utf-8') as f:
        assert json.load(f) == {'lora_rank': 4, 'lora_alpha': 8.0,
                                'lora_targets': ['wq', 'wv']}
    cfg = dataclasses.replace(tconfigs.TINY, lora_rank=4, lora_alpha=8.0,
                              lora_targets=('wq', 'wv'))
    trainer = ttrainer.Trainer(cfg, device='cpu')
    resumed = trainer.restore_checkpoint(os.path.join(ck, 'step_4'))
    loaded = trainer.load_adapter(out, trainer.init(0))
    for a, b in zip(tree_leaves(lora.split_lora(loaded.params)),
                    tree_leaves(lora.split_lora(resumed.params))):
        assert torch.equal(a, b)
    assert lora.split_lora(resumed.params)['wq']['b'].any()


# -------------------------------------------------------------- serving

def test_trained_adapter_is_served_as_the_merged_model(tmp_path):
    """Train TINY's adapters 3 steps, write them as the bank's ``.npz``
    and serve them on the port's and the reference's paged engines with
    a bank: both streams equal the merged model's (fp32)."""
    jcfg, tcfg = _cfgs()
    trainer = _port_trainer(tcfg, learning_rate=5e-2)
    state = trainer.init(0)
    for batch in _batches(3):
        state, _ = trainer.step(state, batch)
    tree = lora.split_lora(state.params)
    multilora.save_adapter(str(tmp_path / 'mine.npz'), tcfg, tree)
    host = convert.params_to_numpy(_base(state.params))
    base_t = dataclasses.replace(tcfg, lora_rank=0)
    base_j = dataclasses.replace(jcfg, lora_rank=0)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8]]
    kw = dict(max_batch=2, max_seq=64, page_size=8, adapter_slots=2,
              adapter_rank=4, adapter_dir=str(tmp_path))

    def streams(eng, adapter):
        extra = {'adapter': adapter} if adapter else {}
        rids = [eng.add_request(list(p), max_new_tokens=10, **extra)
                for p in prompts]
        done = eng.run_to_completion(horizon=4)
        return [done[r].output for r in rids]

    mcfg, merged = lora.merge(tcfg, state.params)
    want = streams(PagedInferenceEngine(mcfg, merged, max_batch=2,
                                        max_seq=64, page_size=8,
                                        device='cpu'), None)
    port = PagedInferenceEngine(
        base_t, convert.params_from_numpy(host, base_t, device='cpu'),
        device='cpu', **kw)
    ref = JaxPaged(base_j, jax.tree.map(jnp.asarray, host),
                   attn_impl='xla', **kw)
    assert streams(port, 'mine') == want
    assert streams(ref, 'mine') == want
    assert streams(port, None) != want
