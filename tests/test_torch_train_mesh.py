"""The port's training mesh (``parallel/mesh.py``, ``train/trainer.py``)
held against the JAX package's ``Trainer`` on the 8 CPU devices that
``tests/conftest.py`` forces, and against the port's own meshless
trainer.

Each mesh is a set of gloo ranks (this process rank 0, the others
follower processes), built once for the tests of its shape and shut
down before the next (only one process group may be up in a process):

- dp 2 x fsdp 2 x tp 2 (the reference's ``tests/test_model.py``
  trainer): two steps' loss, grad_norm, accuracy, tokens and updated
  params equal the reference's from the reference's ``init(PRNGKey(0))``
  params on the same batch; the loss falls over five steps at lr 1e-2;
  the shard layout is the reference's specs (``wq`` with embed over
  fsdp, heads over tp); ``init(seed)`` cuts the meshless init; mesh and
  meshless agree with clipping engaged; LoRA at tp 2 x fsdp 2 x dp 2
  matches the reference (``tests/test_lora.py``), its base bit for bit
  unchanged and its moments adapter-sized on every rank; checkpoints
  move between mesh and meshless trainers with equal next-step losses,
  and a LoRA adapter saved on the mesh loads meshless; a new state
  releases the one before.
- dp 8: LoRA against the reference at dp 8.
- tp 4 (4 ranks): tp does not divide TINY's 2 kv heads, so those leaves
  fall back to replication as ``spec_for`` says (each rank's q heads
  attend through the virtual query of ``mesh.kv_head_layout``); equal to
  the reference.

Tolerances (fp32 TINY, lr 1e-3, two Adam steps): metrics within 1e-5
relative (fp32 sums over ranks in other orders; measured <= 2e-7);
params within 1e-4 absolute. Adam moves an element by about lr per step
whatever its gradient, so a flipped or wrong update shows at ~1e-3;
but it divides each gradient by its own size, so an element whose
gradient is a few fp32 roundings from zero (summed over ranks in another
order) moves by a visible fraction of lr: measured up to 2.3e-5 on one
element of 8192 (pp 2 x fsdp 2 x tp 2, ``tests/test_torch_pipeline.py``).
Mesh against meshless in the port is the same bound.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jconfigs
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch.models import configs, convert, lora, llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import trainer as ttrainer
from skypilot_tpu_torch.train.optim import tree_leaves

jax.config.update('jax_platforms', 'cpu')

GROUP_TIMEOUT_S = 60.0
RTOL_METRICS = 1e-5
ATOL_PARAMS = 1e-4
TC = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10,
          attn_impl='xla')
TARGETS = ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down')
JCFG = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(configs.TINY, dtype=torch.float32)
JLORA = dataclasses.replace(JCFG, lora_rank=4, lora_alpha=8.0,
                            lora_targets=TARGETS)
TLORA = dataclasses.replace(TCFG, lora_rank=4, lora_alpha=8.0,
                            lora_targets=TARGETS)
DP2_FSDP2_TP2 = dict(dp=2, fsdp=2, tp=2)

_MESH = {}


def _mesh(**shape):
    """The mesh of ``shape``, shutting down another one first."""
    spec = mesh_lib.MeshSpec(**shape)
    if _MESH.get('spec') != spec:
        _close()
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        _MESH.update(spec=spec, threads=n, mesh=mesh_lib.make_mesh(
            spec, device='cpu', timeout_s=GROUP_TIMEOUT_S))
    return _MESH['mesh']


def _close():
    if _MESH:
        _MESH['mesh'].shutdown()
        torch.set_num_threads(_MESH['threads'])
        _MESH.clear()


@pytest.fixture(scope='module', autouse=True)
def _shutdown():
    yield
    _close()


def _batch(b=8, s=32, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return dict(inputs=rng.integers(0, vocab, (b, s)).astype(np.int32),
                targets=rng.integers(0, vocab, (b, s)).astype(np.int32),
                mask=(rng.random((b, s)) > 0.2).astype(np.float32))


def _jax_run(jcfg, shape, steps=2, **tc):
    """(initial params, per-step metrics, final params) of the
    reference trainer at ``shape``, numpy."""
    spec = jmesh.MeshSpec(**shape)
    tr = jtrainer.Trainer(jcfg, mesh=jmesh.make_mesh(
        spec, jax.devices()[:spec.num_devices]),
        train_config=jtrainer.TrainConfig(**{**TC, **tc}))
    state = tr.init(jax.random.PRNGKey(0))
    params0 = jax.device_get(state.params)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    metrics = []
    for _ in range(steps):
        state, m = tr.step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return params0, metrics, jax.device_get(state.params), tr


def _port_run(tcfg, params0, mesh=None, steps=2, **tc):
    tr = ttrainer.Trainer(tcfg, mesh=mesh, device='cpu',
                          train_config=ttrainer.TrainConfig(**{**TC, **tc}))
    state = tr.state_from_params(
        convert.params_from_numpy(params0, tcfg, device='cpu'))
    metrics = []
    for _ in range(steps):
        state, m = tr.step(state, _batch())
        metrics.append({k: float(v) for k, v in m.items()})
    return tr, state, metrics


def _assert_metrics(got, want, keys=('loss', 'grad_norm', 'accuracy',
                                     'tokens')):
    for g, w in zip(got, want):
        for key in keys:
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL_METRICS,
                                       err_msg=key)


def _assert_params(got, want, atol=ATOL_PARAMS):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), rtol=0,
                                   atol=atol)


def _numpy(tr, state):
    return convert.params_to_numpy(tr.full_params(state))


# ---------------------------------------------------------------- dp2 fsdp2 tp2
def test_trainer_matches_the_reference_at_dp2_fsdp2_tp2():
    params0, want, want_params, jtr = _jax_run(JCFG, DP2_FSDP2_TP2)
    mesh = _mesh(**DP2_FSDP2_TP2)
    tr, state, got = _port_run(TCFG, params0, mesh)
    _assert_metrics(got, want)
    _assert_params(_numpy(tr, state), want_params)
    # The shard layout is the reference's: wq [L, d, h, hd] with embed
    # over fsdp and heads over tp, and every leaf's spec alike.
    axes = llama.param_logical_axes(TCFG)
    shapes = llama.init_params(TCFG, 0, device='meta')

    def spec(path):
        a, s = axes, shapes
        for k in path:
            a, s = a[k], s[k]
        return mesh_lib.spec_for(a, shape=tuple(s.shape), mesh=mesh)
    want_specs = jax.tree_util.tree_flatten_with_path(jtr.param_shardings)[0]
    for path, sharding in want_specs:
        keys = tuple(p.key for p in path)
        assert spec(keys) == tuple(sharding.spec), keys
    assert spec(('layers', 'wq')) == ('pp', 'fsdp', 'tp')
    local = state.params['layers']['wq']
    assert tuple(local.shape) == (2, 32, 2, 16)
    tr.close()


def test_loss_decreases_and_init_cuts_the_meshless_init():
    """The reference's ``test_loss_decreases`` (five steps at lr 1e-2 on
    dp 2 x fsdp 2 x tp 2), and ``init(seed)`` on the mesh is the
    meshless ``init(seed)`` with each rank holding its cut."""
    mesh = _mesh(**DP2_FSDP2_TP2)
    tr = ttrainer.Trainer(TCFG, mesh=mesh, device='cpu',
                          train_config=ttrainer.TrainConfig(
                              learning_rate=1e-2, warmup_steps=1,
                              total_steps=50, attn_impl='xla'))
    state = tr.init(0)
    plain = llama.init_params(TCFG, 0, device='cpu')
    for a, b in zip(tree_leaves(tr.full_params(state)), tree_leaves(plain)):
        assert torch.equal(a, b)
    losses = []
    for _ in range(5):
        state, m = tr.step(state, _batch())
        losses.append(float(m['loss']))
    assert losses[-1] < losses[0], losses
    tr.close()


def test_mesh_matches_meshless_with_clipping():
    """Mesh against meshless in the port, with a grad_clip_norm small
    enough that every step clips: equal losses and grad norms, and equal
    params after two steps."""
    params0 = convert.params_to_numpy(llama.init_params(TCFG, 3,
                                                        device='cpu'))
    mesh = _mesh(**DP2_FSDP2_TP2)
    plain, plain_state, want = _port_run(TCFG, params0,
                                         grad_clip_norm=0.05)
    tr, state, got = _port_run(TCFG, params0, mesh, grad_clip_norm=0.05)
    assert all(m['grad_norm'] > 0.05 for m in want)
    _assert_metrics(got, want)
    _assert_params(_numpy(tr, state),
                   convert.params_to_numpy(plain_state.params))
    tr.close()


def _lora_params(jtr_params, tcfg):
    return convert.params_from_numpy(jtr_params, tcfg, device='cpu')


@pytest.mark.parametrize('shape', [DP2_FSDP2_TP2, dict(dp=8)],
                         ids=['tp2_fsdp2_dp2', 'dp8'])
def test_lora_matches_the_reference(shape):
    """The reference's ``test_tp_mesh_step_matches_dp_mesh`` shapes:
    LoRA on all seven targets against the reference's trainer at the same
    spec; the base unchanged bit for bit and the moments adapter-sized on
    every rank (checked on rank 0 here and on the gathered moments)."""
    params0, want, want_params, _ = _jax_run(JLORA, shape)
    mesh = _mesh(**shape)
    tr, state, got = _port_run(TLORA, params0, mesh)
    _assert_metrics(got, want)
    full = tr.full_params(state)
    _assert_params(convert.params_to_numpy(full), want_params)
    base0 = convert.params_from_numpy(params0, TLORA, device='cpu')
    for path in (('embed',), ('unembed',), ('layers', 'wq'),
                 ('layers', 'w_down'), ('layers', 'attn_norm')):
        a, b = full, base0
        for k in path:
            a, b = a[k], b[k]
        assert torch.equal(a, b), path
    # Moments over the adapters only, cut like them.
    lora_local = lora.split_lora(state.params)
    assert [t.shape for t in tree_leaves(state.opt_state.mu)] == \
        [t.shape for t in tree_leaves(lora_local)]
    n_adapter = sum(t.numel() for t in tree_leaves(lora.split_lora(full)))
    n_params = sum(t.numel() for t in tree_leaves(full))
    assert sum(t.numel() for t in tree_leaves(state.opt_state.mu)) <= \
        n_adapter < n_params
    tr.close()


def test_checkpoints_cross_between_mesh_and_meshless(tmp_path):
    """A checkpoint written by the mesh trainer resumes meshless and the
    reverse, with equal next-step losses and params; a LoRA adapter saved
    on the mesh loads meshless."""
    params0 = convert.params_to_numpy(llama.init_params(TCFG, 5,
                                                        device='cpu'))
    mesh = _mesh(**DP2_FSDP2_TP2)
    tr, state, _ = _port_run(TCFG, params0, mesh, steps=1)
    plain, plain_state, _ = _port_run(TCFG, params0, steps=1)
    tr.save_checkpoint(str(tmp_path / 'mesh'), state)
    plain.save_checkpoint(str(tmp_path / 'plain'), plain_state)
    resumed = plain.restore_checkpoint(str(tmp_path / 'mesh'))
    on_mesh = tr.restore_checkpoint(str(tmp_path / 'plain'))
    assert resumed.step == on_mesh.step == 1
    resumed, m_plain = plain.step(resumed, _batch(seed=1))
    on_mesh, m_mesh = tr.step(on_mesh, _batch(seed=1))
    np.testing.assert_allclose(float(m_mesh['loss']), float(m_plain['loss']),
                               rtol=RTOL_METRICS)
    _assert_params(_numpy(tr, on_mesh),
                   convert.params_to_numpy(resumed.params))
    tr.close()

    lora_tr = ttrainer.Trainer(TLORA, mesh=mesh, device='cpu',
                               train_config=ttrainer.TrainConfig(**TC))
    lstate = lora_tr.init(0)
    lstate, _ = lora_tr.step(lstate, _batch())
    lora_tr.save_adapter(str(tmp_path / 'adapter'), lstate)
    assert os.path.exists(str(tmp_path / 'adapter') + '.lora.json')
    meshless = ttrainer.Trainer(TLORA, device='cpu',
                                train_config=ttrainer.TrainConfig(**TC))
    loaded = meshless.load_adapter(str(tmp_path / 'adapter'),
                                   meshless.init(0))
    for a, b in zip(tree_leaves(lora.split_lora(loaded.params)),
                    tree_leaves(lora.split_lora(
                        lora_tr.full_params(lstate)))):
        assert torch.equal(a, b)
    lora_tr.close()


def test_a_new_state_releases_the_one_before(tmp_path):
    """A mesh trainer keeps one live state, as the reference's step
    donates its input: after ``init`` then ``restore_checkpoint`` the
    first state's params and moments are freed (no rank holds them), a
    step on the released state raises, and the restored one trains."""
    import gc
    import weakref
    tr = ttrainer.Trainer(TCFG, mesh=_mesh(**DP2_FSDP2_TP2), device='cpu',
                          train_config=ttrainer.TrainConfig(**TC))
    state = tr.init(0)
    tr.save_checkpoint(str(tmp_path / 'ckpt'), state)
    restored = tr.restore_checkpoint(str(tmp_path / 'ckpt'))
    with pytest.raises(ValueError, match='live'):
        tr.step(state, _batch())
    held = [weakref.ref(t) for tree in (state.params, state.opt_state.mu,
                                        state.opt_state.nu)
            for t in tree_leaves(tree)]
    del state
    gc.collect()
    assert all(r() is None for r in held)
    _, m = tr.step(restored, _batch())
    assert np.isfinite(float(m['loss']))
    tr.close()


# ------------------------------------------------------------------------ tp4
def test_indivisible_tp_falls_back_to_replication():
    """tp 4 does not divide TINY's 2 kv heads: wk/wv (and their shards)
    replicate over tp as ``spec_for`` says, the q heads split, and two
    steps equal the reference's at the same spec."""
    shape = dict(tp=4)
    params0, want, want_params, jtr = _jax_run(JCFG, shape)
    mesh = _mesh(**shape)
    tr, state, got = _port_run(TCFG, params0, mesh)
    _assert_metrics(got, want)
    _assert_params(_numpy(tr, state), want_params)
    jspec = jtr.param_shardings['layers']['wk'].spec
    assert tuple(jspec) == ('pp', 'fsdp') == mesh_lib.spec_for(
        ('layers', 'embed', 'kv_heads', 'head_dim'),
        shape=(2, 64, 2, 16), mesh=mesh)
    assert tuple(state.params['layers']['wk'].shape) == (2, 64, 2, 16)
    assert tuple(state.params['layers']['wq'].shape) == (2, 64, 1, 16)
    tr.close()
