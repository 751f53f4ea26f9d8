"""Sequence parallelism in the port (``ops/ring_attention.py``,
``ops/ulysses.py``) held against the JAX package's ``ring_attention``
and ``ulysses_attention`` on the 8 CPU devices ``tests/conftest.py``
forces, and against attention over the whole sequence.

The op-level cases run through the lock-step runner (every sp rank in
this process, a rotation a reassignment of blocks), whose forward and
backward are one autograd graph; the trainer cases run a gloo training
mesh of 4 ranks (sp 2 x tp 2: the reference's Ulysses trainer test
shape without its fsdp axis, which ``tests/test_torch_train_mesh.py``
holds).

- The ring at sp 2, 4 and 8, causal and not, contiguous and zigzag, GQA
  and MQA: output and q/k/v gradients against ``attention`` over the
  whole sequence for every case, and against the reference's ring for
  one case of each sp (its forward and ``jax.grad``); the K4 block body
  (``block_impl='flash'``: its plain version on the CPU, and the
  backward with the lse cotangent folded into delta) against the einsum
  body. ``ring_schedule_cost`` equals the reference's.
- Ulysses: the reference's cases (causal and not, GQA kept grouped, MQA
  expanded, indivisible heads rejected, a custom scale), against the
  reference's and the whole sequence's.
- A trainer step at sp 2 with ``attn_impl`` 'ring' and 'ulysses'
  equals the 'xla' step (the reference's trainer tests), and the 'xla'
  step equals the reference's trainer at the same spec.

Tolerances: fp32 outputs and gradients within 2e-5 absolute (the
reference's own test tolerance; the blocks' softmax sums in other
orders), trainer metrics within 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import configs as jconfigs
from skypilot_tpu.ops import ring_attention as jring
from skypilot_tpu.ops.ulysses import ulysses_attention as julysses
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch.models import configs, convert
from skypilot_tpu_torch.ops import ring_attention as ring
from skypilot_tpu_torch.ops.attention import reference_attention
from skypilot_tpu_torch.ops.ulysses import ulysses_attention
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import trainer as ttrainer

jax.config.update('jax_platforms', 'cpu')

ATOL = 2e-5
RTOL_METRICS = 1e-5


def _qkv(b=2, s=32, h=8, hkv=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                               (b, s, h, d)))


def _torch_run(fn, q, k, v, do):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.tensor(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _jmesh(sp):
    return jmesh.make_mesh(jmesh.MeshSpec(fsdp=8 // sp, sp=sp),
                           jax.devices()[:8])


def _jax_run(fn, q, k, v, do):
    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * do), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


WHOLE_CASES = [(sp, causal, layout, hkv)
               for sp in (2, 4, 8) for causal in (True, False)
               for layout in ('zigzag', 'contiguous') for hkv in (2, 1)
               if causal or layout == 'contiguous']


@pytest.mark.parametrize('sp,causal,layout,hkv', WHOLE_CASES)
def test_ring_matches_the_whole_sequence(sp, causal, layout, hkv):
    q, k, v, do = _qkv(hkv=hkv)
    want = _torch_run(lambda q, k, v: reference_attention(
        q, k, v, causal=causal), q, k, v, do)
    for impl in ('einsum', 'flash'):
        got = _torch_run(lambda q, k, v: ring.ring_attention(
            q, k, v, sp, causal=causal, layout=layout, block_impl=impl),
            q, k, v, do)
        _close(got[0], want[0])
        for g, w in zip(got[1], want[1]):
            _close(g, w)


REF_CASES = [(2, True, 'zigzag', 2), (4, True, 'contiguous', 1),
             (8, False, 'contiguous', 2)]


@pytest.mark.parametrize('sp,causal,layout,hkv', REF_CASES)
def test_ring_matches_the_reference(sp, causal, layout, hkv):
    q, k, v, do = _qkv(b=4, hkv=hkv, seed=sp)
    mesh = _jmesh(sp)
    with mesh:
        want = _jax_run(lambda q, k, v: jring.ring_attention(
            q, k, v, mesh, causal=causal, layout=layout,
            block_impl='einsum'), q, k, v, do)
    got = _torch_run(lambda q, k, v: ring.ring_attention(
        q, k, v, mesh_lib.MeshSpec(fsdp=8 // sp, sp=sp), causal=causal,
        layout=layout), q, k, v, do)
    _close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        _close(g, w)


def test_ring_schedule_cost_and_block_calls():
    for sp in (1, 2, 4, 8):
        for rank in range(sp):
            for layout in ('zigzag', 'contiguous'):
                assert ring.ring_schedule_cost(sp, rank, layout) == \
                    jring.ring_schedule_cost(sp, rank, layout)
    # Zigzag is balanced: every rank computes the same block pairs.
    assert {ring.ring_block_calls(4, r, 'zigzag') for r in range(4)} == {9}
    assert [ring.ring_block_calls(4, r, 'contiguous')
            for r in range(4)] == [1, 2, 3, 4]
    with pytest.raises(ValueError, match='divisible'):
        ring.ring_attention(*(torch.zeros(1, 30, 2, 8),) * 3, 4)


ULYSSES_CASES = [
    dict(causal=True, hkv=8), dict(causal=False, hkv=8),
    dict(causal=True, hkv=4), dict(causal=True, hkv=1),
    dict(causal=True, hkv=8, scale=2.0)]


@pytest.mark.parametrize('case', ULYSSES_CASES,
                         ids=['causal', 'full', 'gqa', 'mqa', 'scale'])
def test_ulysses_matches_the_reference(case):
    q, k, v, do = _qkv(s=32, h=8, hkv=case['hkv'], seed=4)
    scale = case.get('scale')
    mesh = _jmesh(4)
    with mesh:
        want = _jax_run(lambda q, k, v: julysses(
            q, k, v, mesh, causal=case['causal'], scale=scale), q, k, v, do)
    whole = _torch_run(lambda q, k, v: reference_attention(
        q, k, v, causal=case['causal'], scale=scale), q, k, v, do)
    got = _torch_run(lambda q, k, v: ulysses_attention(
        q, k, v, 4, causal=case['causal'], scale=scale), q, k, v, do)
    for ref in (want, whole):
        _close(got[0], ref[0])
        for g, w in zip(got[1], ref[1]):
            _close(g, w)


def test_ulysses_rejects_indivisible_heads():
    q, k, v, _ = _qkv(h=6, hkv=6)
    with pytest.raises(ValueError, match='n_heads'):
        ulysses_attention(*map(torch.tensor, (q, k, v)), 4)
    with pytest.raises(ValueError, match='n_heads'):
        julysses(q, k, v, _jmesh(4))


def test_trainer_at_sp2_ring_and_ulysses_equal_xla():
    """One step on an sp 2 x tp 2 mesh (the reference's
    ``test_trainer_attn_impl_ulysses`` shape without fsdp) with each attention
    impl, from the reference's init, on the reference's batch: 'ring'
    and 'ulysses' equal 'xla', and 'xla' equals the reference's trainer
    at the same spec."""
    jcfg = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.TINY, dtype=torch.float32)
    shape = dict(sp=2, tp=2)
    tc = dict(learning_rate=1e-3, warmup_steps=0, total_steps=4)
    batch = {'inputs': np.ones((4, 32), np.int32),
             'targets': np.ones((4, 32), np.int32)}
    jspec = jmesh.MeshSpec(**shape)
    jtr = jtrainer.Trainer(jcfg, mesh=jmesh.make_mesh(
        jspec, jax.devices()[:jspec.num_devices]),
        train_config=jtrainer.TrainConfig(attn_impl='xla', **tc))
    jstate = jtr.init(jax.random.PRNGKey(0))
    params0 = jax.device_get(jstate.params)
    _, jm = jtr.step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(**shape), device='cpu',
                              timeout_s=60.0)
    try:
        metrics = {}
        for impl in ('xla', 'ring', 'ulysses'):
            tr = ttrainer.Trainer(tcfg, mesh=mesh, device='cpu',
                                  train_config=ttrainer.TrainConfig(
                                      attn_impl=impl, **tc))
            state = tr.state_from_params(
                convert.params_from_numpy(params0, tcfg, device='cpu'))
            _, m = tr.step(state, batch)
            metrics[impl] = {k: float(v) for k, v in m.items()}
            tr.close()
    finally:
        mesh.shutdown()
        torch.set_num_threads(n)
    for impl in ('ring', 'ulysses'):
        for key in ('loss', 'grad_norm', 'accuracy'):
            np.testing.assert_allclose(metrics[impl][key],
                                       metrics['xla'][key],
                                       rtol=RTOL_METRICS, err_msg=key)
    for key in ('loss', 'grad_norm', 'accuracy'):
        np.testing.assert_allclose(metrics['xla'][key], float(jm[key]),
                                   rtol=RTOL_METRICS, err_msg=key)
