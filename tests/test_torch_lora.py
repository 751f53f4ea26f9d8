"""Serving a LoRA checkpoint in the port: ``models/lora.py`` held against
``skypilot_tpu/models/lora.py`` on the same numpy trees, and both
engines serving a LoRA tree as its merged model (the fold runs before
quantization; folding into an int8 base is refused with the reference's
message). ``check_supported`` accepts a LoRA config, which trains
(``tests/test_torch_lora_train.py``) and is served merged."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jconfigs
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import lora as jlora
from skypilot_tpu_torch.inference.engine import (InferenceEngine,
                                                 prepare_params,
                                                 serving_config)
from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
from skypilot_tpu_torch.models import configs as tconfigs
from skypilot_tpu_torch.models import lora as tlora
from skypilot_tpu_torch.models import quantization as tq
from skypilot_tpu_torch.models.convert import params_from_numpy

jax.config.update('jax_platforms', 'cpu')

RANK = 4
ALL = ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down')


def _lora_tree(cfg, targets, seed, sigma=0.2):
    rng = np.random.default_rng(seed)
    out = {}
    for t in targets:
        a_shape, b_shape = tlora._target_shapes(cfg, t)
        out[t] = {'a': rng.normal(0, sigma, (cfg.n_layers,) + a_shape
                                  ).astype(np.float32),
                  'b': rng.normal(0, sigma, (cfg.n_layers,) + b_shape
                                  ).astype(np.float32)}
    return out


def _cfgs(dtype_name, targets=ALL):
    jdt = {'fp32': jnp.float32, 'bf16': jnp.bfloat16}[dtype_name]
    tdt = {'fp32': torch.float32, 'bf16': torch.bfloat16}[dtype_name]
    kw = dict(lora_rank=RANK, lora_alpha=8.0, lora_targets=targets)
    return (dataclasses.replace(jconfigs.TINY, dtype=jdt, **kw),
            dataclasses.replace(tconfigs.TINY, dtype=tdt, **kw))


def _trees(jcfg, tcfg, seed=0):
    """(JAX params with 'lora', the port's params with 'lora', the
    numpy adapter tree) from one seed."""
    host = jax.device_get(jllama.init_params(
        jax.random.PRNGKey(seed), dataclasses.replace(jcfg, lora_rank=0)))
    tree = _lora_tree(tcfg, tcfg.lora_targets, seed + 1)
    jp = jax.tree.map(jnp.asarray, host)
    jp = jlora.with_lora(jp, jax.tree.map(jnp.asarray, tree))
    tp = params_from_numpy(host, dataclasses.replace(tcfg, lora_rank=0),
                           device='cpu')
    tp = tlora.with_lora(tp, {t: {k: torch.from_numpy(v)
                                  for k, v in ab.items()}
                              for t, ab in tree.items()})
    return jp, tp, tree


def _to_np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


@pytest.mark.parametrize('dtype_name', ['fp32', 'bf16'])
@pytest.mark.parametrize('targets', [ALL, ('wq', 'wv')],
                         ids=['all', 'qv'])
def test_merge_matches_reference(dtype_name, targets):
    """Every folded weight equals the reference's fold (fp32 to 1e-6,
    bf16 to one ulp: the per-layer fold runs in the base dtype on both
    sides); untouched leaves stay bit for bit; the config comes back
    LoRA-off."""
    jcfg, tcfg = _cfgs(dtype_name, targets)
    jp, tp, _ = _trees(jcfg, tcfg)
    jc, jm = jlora.merge(jcfg, jp)
    tc, tm = tlora.merge(tcfg, tp)
    assert tc.lora_rank == jc.lora_rank == 0
    assert 'lora' not in tm['layers'] and 'lora' in tp['layers']
    for k, v in tm['layers'].items():
        want = np.asarray(jm['layers'][k].astype(jnp.float32))
        got = _to_np(v)
        if k not in targets:
            assert np.array_equal(got, want), k
        elif dtype_name == 'bf16':
            # One bf16 ulp where XLA and torch round the rank-r product
            # differently.
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # The caller's tree is left as it was.
    assert not torch.equal(tm['layers']['wq'], tp['layers']['wq'])


def test_merge_refusals_match_reference():
    jcfg, tcfg = _cfgs('fp32')
    jp, tp, _ = _trees(jcfg, tcfg)
    cases = [(dataclasses.replace(jcfg, lora_rank=0),
              dataclasses.replace(tcfg, lora_rank=0)),
             (dataclasses.replace(jcfg, lora_rank=8),
              dataclasses.replace(tcfg, lora_rank=8))]
    for jc, tc in cases:
        with pytest.raises(ValueError) as je:
            jlora.merge(jc, jp)
        with pytest.raises(ValueError) as te:
            tlora.merge(tc, tp)
        assert str(te.value) == str(je.value)
    tq8 = tq.quantize_params({k: v for k, v in tp.items()}, mode='int8')
    tq8['layers']['lora'] = tp['layers']['lora']
    with pytest.raises(ValueError) as te:
        tlora.merge(tcfg, tq8)
    assert str(te.value) == ('cannot merge LoRA into an int8 base; load the '
                             'bf16 checkpoint, merge, then quantize')
    with pytest.raises(ValueError, match='int8 base'):
        prepare_params(tcfg, tq8, device=torch.device('cpu'))


def test_resolve_targets_and_maybe_merge_match_reference():
    jcfg, tcfg = _cfgs('fp32')
    assert tlora.resolve_targets(tcfg) == jlora.resolve_targets(jcfg)
    for targets, moe in ((('wq', 'w_bogus'), False), (('wq', 'w_up'), True)):
        extra = {'n_experts': 4} if moe else {}
        with pytest.raises(ValueError) as je:
            jlora.resolve_targets(dataclasses.replace(
                jcfg, lora_targets=targets, **extra))
        with pytest.raises(ValueError) as te:
            tlora.resolve_targets(dataclasses.replace(
                tcfg, lora_targets=targets, **extra))
        assert str(te.value) == str(je.value)
    for t in ALL:
        assert tlora._target_shapes(tcfg, t) == jlora._target_shapes(jcfg, t)
    # No adapters: a no-op that clears the config's LoRA fields.
    cfg, params = tlora.maybe_merge(tcfg, None)
    assert cfg.lora_rank == 0 and params is None
    plain = {'layers': {'wq': torch.zeros(1)}}
    assert tlora.maybe_merge(tcfg, plain)[1] is plain
    assert tlora.split_lora(tlora.with_lora(plain, {'x': 1})) == {'x': 1}
    assert 'lora' not in plain['layers']
    assert tcfg.lora_enabled and tcfg.lora_scale == jcfg.lora_scale == 2.0


def test_check_supported_serving_path():
    """``lora_rank > 0`` passes ``check_supported`` (training and serving
    alike, so it has no serving switch any more); the engines serve the
    merged (LoRA-off) config."""
    _, tcfg = _cfgs('fp32')
    assert tconfigs.check_supported(tcfg) is tcfg
    with pytest.raises(TypeError):
        tconfigs.check_supported(tcfg, serving=True)
    assert serving_config(tcfg).lora_rank == 0


@pytest.mark.parametrize('kind', ['slot', 'paged'])
@pytest.mark.parametrize('quantize', [None, 'int8'])
def test_engines_serve_a_lora_tree_as_its_merge(kind, quantize):
    """An engine given a LoRA tree folds it (before quantizing) and
    streams exactly what an engine given the merged tree streams; the
    merged stream differs from the base model's."""
    jcfg, tcfg = _cfgs('fp32')
    _, tp, _ = _trees(jcfg, tcfg, seed=3)
    _, merged = tlora.merge(tcfg, tp)
    cls = InferenceEngine if kind == 'slot' else PagedInferenceEngine
    kw = dict(max_batch=2, max_seq=64, device='cpu', quantize=quantize)
    if kind == 'paged':
        kw['page_size'] = 8
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]

    def streams(cfg, params):
        eng = cls(cfg, params, **kw)
        assert eng.cfg.lora_rank == 0
        rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        done = eng.run_to_completion(horizon=4)
        return [done[r].output for r in rids]

    got = streams(tcfg, tp)
    base_cfg = dataclasses.replace(tcfg, lora_rank=0)
    assert got == streams(base_cfg, merged)
    base = {k: v for k, v in tp.items()}
    base['layers'] = {k: v for k, v in tp['layers'].items() if k != 'lora'}
    assert got != streams(base_cfg, base)
