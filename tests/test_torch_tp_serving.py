"""Tensor-parallel serving on a tp = 2 serving mesh
(``skypilot_tpu_torch/parallel/mesh.py``): two gloo ranks on the CPU,
this process rank 0 and one follower process, held against the port's
meshless engines and the JAX package's (``tests/test_tp_serving.py``,
whose byte-identity gates fail on some hosts, R3: the port is held to
its own streams, and to the reference's meshless ones at fp32).

- greedy streams at fp32 TINY (the reference's ``PROMPTS``, 8 new
  tokens, prefill chunks of 16) on the paged and slot engines, with
  int8 KV (held to the port's meshless int8 stream, R1) and on a
  kv-replicated config (one kv head);
- one prefill's fp32 logits within 1e-5 (absolute) of the reference's
  tp = 2 mesh engine's weights on the same inputs;
- sharded prefix-cache reuse and pool-pressure preemption under tp;
- per-shard KV counts equal to the reference's;
- a KV handoff exported at tp = 2 lands at tp = 1 and the reverse, and
  the streams continue as the exporting engine's own;
- several replicated kv heads (6 q / 3 kv at tp = 2) serve on both
  engines, equal to the meshless and the reference's streams.

The mesh is one module fixture: a ``FileStore`` under ``tmp_path``, a
60 s process-group timeout (a hang fails the test instead of eating the
suite's time), and the follower reaped at teardown.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference.engine import InferenceEngine as JSlot
from skypilot_tpu.inference.paged import PagedInferenceEngine as JPaged
from skypilot_tpu.models import configs as jconfigs
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu_torch.inference.engine import InferenceEngine
from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models.convert import params_from_numpy
from skypilot_tpu_torch.parallel import mesh as mesh_lib

jax.config.update('jax_platforms', 'cpu')

PROMPTS = ([1, 2, 3] * 9, [4, 5] * 10, [7] * 21)
JCFG = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(configs.TINY, dtype=torch.float32)
# One kv head: replicated over tp (MQA), the q heads split.
JKV1 = dataclasses.replace(JCFG, n_kv_heads=1)
TKV1 = dataclasses.replace(TCFG, n_kv_heads=1)
GROUP_TIMEOUT_S = 60.0


@pytest.fixture(scope='module')
def mesh(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    m = mesh_lib.serving_mesh(
        tp=2, device='cpu', timeout_s=GROUP_TIMEOUT_S,
        store_dir=str(tmp_path_factory.mktemp('mesh')))
    pids = m.follower_pids()
    yield m
    m.shutdown()
    torch.set_num_threads(n)
    for pid in pids:
        assert not os.path.exists(f'/proc/{pid}') or \
            open(f'/proc/{pid}/stat').read().split()[2] == 'Z'


def _ref_params(jcfg, tcfg):
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.device_get(jp), tcfg, device='cpu')


@pytest.fixture(scope='module')
def tiny():
    return _ref_params(JCFG, TCFG)


def _run(cls, cfg, params, *, mesh=None, gen=8, prompts=PROMPTS, **kw):
    eng = cls(cfg, params, max_batch=4, max_seq=128,
              prefill_chunk_tokens=16, device='cpu', mesh=mesh, **kw)
    rids = [eng.add_request(list(p), max_new_tokens=gen) for p in prompts]
    done = eng.run_to_completion(horizon=8)
    return [done[r].output for r in rids], eng


def _jrun(cls, cfg, params, *, mesh=None, gen=8, prompts=PROMPTS, **kw):
    eng = cls(cfg, params, max_batch=4, max_seq=128,
              prefill_chunk_tokens=16, attn_impl='xla', mesh=mesh, **kw)
    rids = [eng.add_request(list(p), max_new_tokens=gen) for p in prompts]
    done = eng.run_to_completion(horizon=8)
    return [done[r].output for r in rids], eng


@pytest.mark.parametrize('engine', ['paged', 'slot'])
def test_tp2_greedy_streams_equal_meshless_and_reference(mesh, tiny,
                                                         engine):
    jp, tp = tiny
    cls, jcls = ((PagedInferenceEngine, JPaged) if engine == 'paged'
                 else (InferenceEngine, JSlot))
    want, _ = _jrun(jcls, JCFG, jp)
    meshless, _ = _run(cls, TCFG, tp)
    got, eng = _run(cls, TCFG, tp, mesh=mesh)
    eng.close()
    assert meshless == want
    assert got == meshless
    assert all(len(o) == 8 for o in got)


def test_tp2_int8_kv_streams_equal_meshless_int8(mesh, tiny):
    """int8 KV at tp = 2 is held to the port's meshless int8 stream (the
    reference's int8 streams turn on XLA's fusion, R1)."""
    _, tp = tiny
    for cls in (PagedInferenceEngine, InferenceEngine):
        want, _ = _run(cls, TCFG, tp, kv_cache_dtype='int8')
        got, eng = _run(cls, TCFG, tp, mesh=mesh, kv_cache_dtype='int8')
        assert eng.kv_pool_stats()['kv_shards'] == 2
        eng.close()
        assert got == want, cls.__name__


def test_tp2_kv_replicated_config(mesh):
    """One kv head (MQA) does not split over tp = 2: every rank keeps it
    whole beside its half of the q heads; the streams equal the
    meshless ones and the reference's."""
    jp, tp = _ref_params(JKV1, TKV1)
    want, _ = _jrun(JPaged, JKV1, jp)
    for cls in (PagedInferenceEngine, InferenceEngine):
        meshless, _ = _run(cls, TKV1, tp)
        got, eng = _run(cls, TKV1, tp, mesh=mesh)
        assert eng.shard_cfg.n_kv_heads == 1 and eng.shard_cfg.n_heads == 2
        assert eng.kv_pool_stats()['kv_shards'] == 1
        eng.close()
        assert meshless == want
        assert got == meshless, cls.__name__


def test_tp2_prefill_logits_match_the_reference_mesh_engine(mesh, tiny):
    """One prefill's fp32 logits (every position of two 24-token rows) at
    tp = 2 against the reference's tp = 2 mesh engine's sharded weights
    on the same inputs (``llama.prefill_rows(all_logits=True)``), within
    1e-5 absolute: the same fp32 sums, split and reduced in another
    order."""
    jp, tp = tiny
    tokens = np.random.default_rng(0).integers(1, 256, (2, 24)).astype(
        np.int32)
    jm = jmesh.serving_mesh(tp=2)
    jeng = JPaged(JCFG, jp, max_batch=4, max_seq=128,
                  prefill_chunk_tokens=16, attn_impl='xla', mesh=jm)
    want, _ = jllama.prefill_rows(jeng.params, jnp.asarray(tokens),
                                  jnp.full((2,), 24, jnp.int32), JCFG,
                                  attn_impl='xla', all_logits=True)
    want = np.asarray(jax.device_get(want))
    eng = PagedInferenceEngine(TCFG, tp, max_batch=4, max_seq=128,
                               prefill_chunk_tokens=16, device='cpu',
                               mesh=mesh)
    got = eng.prefill_logits(tokens)
    meshless = PagedInferenceEngine(TCFG, tp, max_batch=4, max_seq=128,
                                    device='cpu').prefill_logits(tokens)
    eng.close()
    assert got.shape == want.shape == (2, 24, 256)
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(got - meshless).max() <= 1e-5


def test_sharded_prefix_cache_hit_reuse(mesh, tiny):
    """A second request sharing full pages hits the prefix index under
    tp (tail-only prefill) and decodes on the head-sharded pool."""
    _, tp = tiny
    eng = PagedInferenceEngine(TCFG, tp, max_batch=2, max_seq=96,
                               prefill_chunk_tokens=16, device='cpu',
                               mesh=mesh)
    shared = list(range(1, 3 * eng.page + 1))
    eng.add_request(shared + [40], max_new_tokens=4)
    eng.run_to_completion(horizon=4)
    r2 = eng.add_request(shared + [41], max_new_tokens=4)
    done = eng.run_to_completion(horizon=4)
    assert eng.alloc.prefix_hits >= 1
    assert len(done[r2].output) == 4
    ref = PagedInferenceEngine(TCFG, tp, max_batch=2, max_seq=96,
                               prefill_chunk_tokens=16, device='cpu')
    ref.add_request(shared + [40], max_new_tokens=4)
    ref.run_to_completion(horizon=4)
    rr = ref.add_request(shared + [41], max_new_tokens=4)
    assert ref.run_to_completion(horizon=4)[rr].output == done[r2].output
    eng.close()


def test_preemption_resume_under_tp(mesh, tiny):
    """Pool pressure on the sharded pool: the newest request is
    preempted, re-registers its pages and resumes to the same stream as
    an ample pool's."""
    _, tp = tiny
    kw = dict(max_batch=2, max_seq=256, page_size=8, device='cpu',
              mesh=mesh)
    ref = PagedInferenceEngine(TCFG, tp, n_pages=64, **kw)
    rr = ref.add_request(list(range(1, 30)), max_new_tokens=24)
    ref_out = ref.run_to_completion(horizon=4)[rr].output
    assert ref.preemptions == 0
    ref.close()
    eng = PagedInferenceEngine(TCFG, tp, n_pages=12, **kw)
    r1 = eng.add_request(list(range(1, 30)), max_new_tokens=24)
    r2 = eng.add_request(list(range(1, 30)), max_new_tokens=24)
    done = eng.run_to_completion(horizon=4)
    assert eng.preemptions >= 1
    assert done[r1].output == ref_out
    assert done[r2].output == ref_out
    eng.close()


def test_per_shard_counts_equal_the_reference(mesh, tiny):
    """Token capacities stay global, byte views halve per shard: the
    pool stats of a tp = 2 engine equal the reference's tp = 2 engine's,
    and so do the mesh axes."""
    jp, tp = tiny
    jm = jmesh.serving_mesh(tp=2)
    _, jeng = _jrun(JPaged, JCFG, jp, gen=2, prompts=([1, 2, 3],), mesh=jm)
    _, eng = _run(PagedInferenceEngine, TCFG, tp, gen=2,
                  prompts=([1, 2, 3],), mesh=mesh)
    got, want = eng.kv_pool_stats(), jeng.kv_pool_stats()
    assert got == want
    assert got['kv_token_bytes_per_shard'] == got['kv_token_bytes'] // 2
    assert eng.mesh_axes() == jeng.mesh_axes()
    assert eng.mesh_axes()['tp'] == 2
    _, slot = _run(InferenceEngine, TCFG, tp, gen=2, prompts=([1, 2, 3],),
                   mesh=mesh)
    assert slot.kv_pool_stats()['kv_token_bytes_per_shard'] == \
        want['kv_token_bytes_per_shard']
    # Each rank's pool is its own contiguous tensor of the local heads.
    assert eng.cache.pool_k.is_contiguous()
    assert eng.cache.pool_k.shape[2] == TCFG.n_kv_heads // 2
    eng.close()
    slot.close()


def _decode_some(eng, prompt, steps=3):
    rid = eng.add_request(list(prompt), max_new_tokens=12)
    for _ in range(steps):
        eng.step(horizon=1)
    eng.drain_pipeline()
    return rid


@pytest.mark.parametrize('direction', ['tp2_to_tp1', 'tp1_to_tp2'])
@pytest.mark.parametrize('kv', ['bf16', 'int8'])
def test_kv_handoff_crosses_tp(mesh, tiny, direction, kv):
    """A snapshot exported mid-stream by one engine (the whole kv heads:
    the tp ranks' heads gathered into the meshless layout) lands in the
    other, and the ingesting engine's continuation equals the exporting
    engine's own."""
    _, tp = tiny
    kw = dict(max_batch=2, max_seq=64, prefill_chunk_tokens=16,
              device='cpu', kv_cache_dtype=kv)
    sharded = PagedInferenceEngine(TCFG, tp, mesh=mesh, **kw)
    plain = PagedInferenceEngine(TCFG, tp, **kw)
    src, dst = ((sharded, plain) if direction == 'tp2_to_tp1'
                else (plain, sharded))
    prompt = [5, 9, 2, 7] * 5
    rid = _decode_some(src, prompt)
    snap, _ = src.export_kv_snapshot(rid)
    assert snap is not None
    assert np.shape(snap['k'])[2] == TCFG.n_kv_heads       # whole heads
    own = src.run_to_completion(horizon=4)[rid].output
    new = dst.ingest_kv_snapshot(snap)
    cont = dst.run_to_completion(horizon=4)[new].output
    assert cont == own
    sharded.close()


@pytest.mark.parametrize('engine', ['paged', 'slot'])
def test_options_that_wait_raise_under_a_mesh(mesh, engine):
    """The layout that used to wait under a mesh (ROADMAP §1 item 2a)
    now serves: q heads split over tp while several kv heads replicate
    (6 q heads and 3 kv heads at tp = 2, the unaligned case: rank 1's q
    heads 3, 4, 5 read kv heads 1, 2, 2). Every rank keeps the whole kv
    heads (one kv shard) and attends through ``mesh.kv_head_layout``'s
    virtual query; the fp32 streams equal the meshless engine's and the
    reference's. The bank, MoE, speculation and W8A8 prefill run under a
    mesh too (``tests/test_torch_mesh_options.py``)."""
    jcfg = dataclasses.replace(JCFG, n_heads=6, n_kv_heads=3,
                               head_dim_override=16)
    tcfg = dataclasses.replace(TCFG, n_heads=6, n_kv_heads=3,
                               head_dim_override=16)
    jp, tp = _ref_params(jcfg, tcfg)
    cls, jcls = ((PagedInferenceEngine, JPaged) if engine == 'paged'
                 else (InferenceEngine, JSlot))
    want, _ = _jrun(jcls, jcfg, jp)
    meshless, _ = _run(cls, tcfg, tp)
    got, eng = _run(cls, tcfg, tp, mesh=mesh)
    assert eng.shard_cfg.n_kv_heads == 3 and eng.shard_cfg.n_heads == 3
    assert eng.kv_pool_stats()['kv_shards'] == 1
    assert eng._tp_plan['kv_groups'] == ((0, 1, 2), 6)    # rank 0
    eng.close()
    assert meshless == want
    assert got == meshless


def test_tp2_from_a_checkpoint_directory(mesh, tmp_path):
    """``from_pretrained`` under a mesh: rank 0 sends the path, every rank
    loads the checkpoint on its host and keeps its shard; the fp32
    streams equal a meshless engine's on the same directory."""
    from skypilot_tpu_torch.models import synth
    path = synth.write_synthetic_hf_checkpoint(
        str(tmp_path / 'tiny'), configs.TINY, unique_layers=True,
        dtype=np.float32)
    outs = []
    for m in (None, mesh):
        eng = PagedInferenceEngine.from_pretrained(
            path, dtype=torch.float32, max_batch=4, max_seq=128,
            prefill_chunk_tokens=16, device='cpu', mesh=m)
        rids = [eng.add_request(list(p), max_new_tokens=8) for p in PROMPTS]
        done = eng.run_to_completion(horizon=8)
        outs.append([done[r].output for r in rids])
        assert eng.load_s is not None
        eng.close()
    assert outs[0] == outs[1]


def test_prefix_checkpoint_warms_a_tp2_pool(mesh, tiny):
    """A prefix entry exported by a meshless engine (whole kv heads)
    warms a tp = 2 engine's prefix cache (each rank lands its heads'
    slice), and a request on that prefix hits it and decodes the
    meshless engine's stream; the tp = 2 engine's own export of the
    chain carries the same tokens, whole heads."""
    _, tp = tiny
    kw = dict(max_batch=2, max_seq=96, prefill_chunk_tokens=16,
              device='cpu')
    prompt = list(range(1, 3 * 16 + 1)) + [40]
    src = PagedInferenceEngine(TCFG, tp, **kw)
    rid = src.add_request(prompt, max_new_tokens=4)
    want = src.run_to_completion(horizon=4)[rid].output
    entries, _ = src.export_prefix_snapshots()
    assert entries
    eng = PagedInferenceEngine(TCFG, tp, mesh=mesh, **kw)
    assert eng.warm_prefix(entries[0]) > 0
    r2 = eng.add_request(prompt, max_new_tokens=4)
    assert eng.run_to_completion(horizon=4)[r2].output == want
    assert eng.alloc.prefix_hits >= 1
    back, _ = eng.export_prefix_snapshots()
    assert back and back[0]['tokens'] == entries[0]['tokens']
    assert np.shape(back[0]['k']) == np.shape(entries[0]['k'])
    eng.close()
