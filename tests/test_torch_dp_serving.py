"""Tensor- and data-parallel serving on a (tp = 2, dp = 2) serving mesh
(``skypilot_tpu_torch/parallel/mesh.py``): four gloo ranks on the CPU,
this process rank 0 and three follower processes (the reference's
``tests/test_tp_serving.py`` ``test_tp2_dp2_paged_byte_identical``,
held to the port's own streams and the reference's meshless ones at
fp32 TINY, R3). Each dp rank decodes its block of slots and the merge
all-gathers the ring rows over dp, so the dp replicas of each tp shard
of the pool hold the same bytes after a wave.

The mesh is one module fixture (a ``FileStore`` under ``tmp_path``, a
60 s process-group timeout, the followers reaped at teardown).
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
from skypilot_tpu_torch.analysis import audit
from skypilot_tpu_torch.inference.engine import InferenceEngine
from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
from skypilot_tpu_torch.models import configs, lora, moe
from skypilot_tpu_torch.models.convert import params_from_numpy
from skypilot_tpu_torch.parallel import mesh as mesh_lib

jax.config.update('jax_platforms', 'cpu')

PROMPTS = ([1, 2, 3] * 9, [4, 5] * 10, [7] * 21)
JCFG = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(configs.TINY, dtype=torch.float32)


@pytest.fixture(scope='module')
def mesh(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    m = mesh_lib.serving_mesh(tp=2, dp=2, device='cpu', timeout_s=60.0,
                              store_dir=str(tmp_path_factory.mktemp('mesh')))
    pids = m.follower_pids()
    yield m
    m.shutdown()
    torch.set_num_threads(n)
    for pid in pids:
        assert not os.path.exists(f'/proc/{pid}') or \
            open(f'/proc/{pid}/stat').read().split()[2] == 'Z'


@pytest.fixture(scope='module')
def tiny():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.device_get(jp), TCFG, device='cpu')


def _run(cls, params, *, mesh=None, **kw):
    eng = cls(TCFG, params, max_batch=4, max_seq=128,
              prefill_chunk_tokens=16, device='cpu', mesh=mesh, **kw)
    rids = [eng.add_request(list(p), max_new_tokens=8) for p in PROMPTS]
    done = eng.run_to_completion(horizon=8)
    return [done[r].output for r in rids], eng


@pytest.mark.parametrize('kv', ['bf16', 'int8'])
def test_tp2_dp2_paged_streams_and_identical_dp_replicas(mesh, tiny, kv):
    """The paged engine at (tp 2, dp 2): the streams equal the meshless
    engine's (and at fp32 KV the reference's), and after the wave every
    dp replica of a tp shard holds the same pool bytes (ranks 0 and 2
    hold tp shard 0, ranks 1 and 3 shard 1; the two shards differ)."""
    jp, tp = tiny
    meshless, _ = _run(PagedInferenceEngine, tp, kv_cache_dtype=kv)
    got, eng = _run(PagedInferenceEngine, tp, mesh=mesh, kv_cache_dtype=kv)
    assert eng.mesh_axes()['dp'] == 2 and eng._dp_rows == slice(0, 2)
    digests = [d['kv'] for d in eng.state_by_rank()]
    eng.close()
    assert got == meshless
    if kv == 'bf16':
        jeng = JPaged(JCFG, jp, max_batch=4, max_seq=128,
                      prefill_chunk_tokens=16, attn_impl='xla')
        jr = [jeng.add_request(list(p), max_new_tokens=8) for p in PROMPTS]
        jd = jeng.run_to_completion(horizon=8)
        assert got == [jd[r].output for r in jr]
    assert len(digests) == 4
    assert digests[0] == digests[2] and digests[1] == digests[3]
    assert digests[0] != digests[1]


def test_tp2_dp2_slot_streams(mesh, tiny):
    """The slot engine at (tp 2, dp 2): each dp rank decodes its slots,
    the merge gathers the rows, the caches of the dp replicas stay
    identical, and the streams equal the meshless engine's."""
    _, tp = tiny
    meshless, _ = _run(InferenceEngine, tp)
    got, eng = _run(InferenceEngine, tp, mesh=mesh)
    digests = [d['kv'] for d in eng.state_by_rank()]
    eng.close()
    assert got == meshless
    assert digests[0] == digests[2] and digests[1] == digests[3]


def test_dp_needs_a_batch_that_splits(mesh, tiny):
    """Each dp rank decodes a block of max_batch / dp slots: an odd
    batch is refused on every rank."""
    _, tp = tiny
    with pytest.raises(ValueError, match='dp'):
        PagedInferenceEngine(TCFG, tp, max_batch=3, max_seq=64,
                             device='cpu', mesh=mesh)
    got, eng = _run(PagedInferenceEngine, tp, mesh=mesh)
    eng.close()
    assert all(len(o) == 8 for o in got)


@pytest.mark.parametrize('cls', [PagedInferenceEngine, InferenceEngine])
def test_tp2_dp2_sampled_streams_equal_meshless(mesh, tiny, cls):
    """At temperature > 0 each dp rank takes its rows of one noise draw
    for the whole batch: the sampled streams equal the meshless engine's
    with the same ``rng_seed`` token for token, and the same prompt in
    slot 0 (dp rank 0) and slot 2 (dp rank 1) gets its own noise, so the
    two streams differ."""
    _, tp = tiny
    prompts = (PROMPTS[0], PROMPTS[1], PROMPTS[0], PROMPTS[2])

    def run(m):
        eng = cls(TCFG, tp, max_batch=4, max_seq=128,
                  prefill_chunk_tokens=16, device='cpu', mesh=m,
                  rng_seed=7)
        rids = [eng.add_request(list(p), max_new_tokens=8, temperature=1.0)
                for p in prompts]
        done = eng.run_to_completion(horizon=4)
        if m is not None:
            eng.close()
        return [done[r].output for r in rids]

    meshless = run(None)
    got = run(mesh)
    assert got == meshless
    assert got[0] != got[2]


# ------------------------------------------- the options under (tp, dp)
L = TCFG.n_layers
JMOE = dataclasses.replace(jconfigs.TINY_MOE, dtype=jnp.float32,
                           moe_capacity_factor=0.5)
TMOE = dataclasses.replace(configs.TINY_MOE, dtype=torch.float32,
                           moe_capacity_factor=0.5)
SPEC_PROMPTS = ([1, 2, 3, 4] * 7, [5, 6] * 11, [7, 8, 9] * 7)
KINDS = {'paged': (PagedInferenceEngine, JPaged),
         'slot': (InferenceEngine, JSlot)}
KW = dict(max_batch=4, max_seq=128, prefill_chunk_tokens=16)


def _opt_streams(eng, prompts=PROMPTS, reqs=None, **req_kw):
    rids = [eng.add_request(list(p), max_new_tokens=8,
                            **dict(req_kw, **(reqs[i] if reqs else {})))
            for i, p in enumerate(prompts)]
    done = eng.run_to_completion(horizon=8)
    return [done[r].output for r in rids]


def _port(kind, cfg, params, mesh=None, **kw):
    return KINDS[kind][0](cfg, params, device='cpu', mesh=mesh,
                          **dict(KW, **kw))


def _ref(kind, cfg, params, **kw):
    extra = {'decode_impl': 'gather'} if kind == 'paged' else {}
    return KINDS[kind][1](cfg, jax.tree.map(lambda x: x, params),
                          attn_impl='xla', **dict(KW, **extra, **kw))


def _census_of(eng, fn):
    census = {}
    audit._record_collectives(eng, census)
    try:
        fn()
    finally:
        del eng._run_graph
    return census


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_tp2_dp2_moe_routes_every_row_with_a_binding_capacity(
        mesh, kind, monkeypatch):
    """MoE at (tp 2, dp 2) with capacity factor 0.5: a decode step's
    rows split over dp, but the MoE layer all-gathers them and routes
    the whole batch (ROADMAP R6), so the capacity and the drops are the
    meshless engine's. The capacity binds (rank 0's dispatch drops
    choices), and the streams equal the port's and the reference's
    meshless ones; the census adds one all-gather over dp a layer."""
    jp = jllama.init_params(jax.random.PRNGKey(0), JMOE)
    tp = params_from_numpy(jax.device_get(jp), TMOE, device='cpu')
    want = _opt_streams(_ref(kind, JMOE, jp))
    meshless = _opt_streams(_port(kind, TMOE, tp))
    drops = []
    orig = moe.dispatch_slots

    def spy(topk_idx, topk_w, group, capacity, n_experts):
        assign, slot, kept = orig(topk_idx, topk_w, group, capacity,
                                  n_experts)
        valid = topk_w.reshape(kept.shape) > 0
        drops.append((topk_idx.shape[0], int((valid & ~kept).sum())))
        return assign, slot, kept

    monkeypatch.setattr(moe, 'dispatch_slots', spy)
    eng = _port(kind, TMOE, tp, mesh=mesh)
    got = []
    census = _census_of(eng, lambda: got.extend(_opt_streams(eng)))
    eng.close()
    assert meshless == want
    assert got == meshless
    # Decode's dispatches see all four rows, and some drop choices.
    assert any(rows == 4 and dropped for rows, dropped in drops)
    assert not any(rows == 2 for rows, _ in drops)
    assert census['decode'] == audit.expected_census(eng)['decode'] == {
        'all_reduce[tp]': 2 * L, 'all_gather[tp]': 1, 'all_gather[dp]': L}


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_tp2_dp2_bank_streams_and_identical_banks(mesh, tiny, kind):
    """The multi-LoRA bank at (tp 2, dp 2): adapter and base rows
    decode the meshless bank engine's streams and the reference's, and
    all four ranks hold the same bank bytes and registry state after the
    wave."""
    jp, tp = tiny
    rng = np.random.default_rng(1)
    lcfg = dataclasses.replace(TCFG, lora_rank=4)
    tree = {t: {'a': rng.normal(0, 0.3, (L,) + lora._target_shapes(
                    lcfg, t)[0]).astype(np.float32),
                'b': rng.normal(0, 0.3, (L,) + lora._target_shapes(
                    lcfg, t)[1]).astype(np.float32)}
            for t in ('wq', 'wk', 'wo', 'w_gate', 'w_down')}
    reqs = [{'adapter': 'a1'}, {}, {'adapter': 'a1'}]
    outs = []
    for m in (None, mesh):
        eng = _port(kind, TCFG, tp, mesh=m, adapter_slots=2,
                    adapter_rank=4)
        eng.register_adapter('a1', tree, 0.5)
        outs.append(_opt_streams(eng, reqs=reqs))
        digests = [d['bank'] for d in eng.state_by_rank()]
        eng.close()
    jeng = _ref(kind, JCFG, jp, adapter_slots=2, adapter_rank=4)
    jeng.adapters.register('a1', tree, 0.5)
    assert outs[0] == _opt_streams(jeng, reqs=reqs)
    assert outs[1] == outs[0]
    assert outs[0][0] != outs[0][1]
    assert len(digests) == 4 and len(set(digests)) == 1


@pytest.mark.parametrize('temperature', [0.0, 1.0])
@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_tp2_dp2_spec_rows_split_and_ranks_agree(mesh, tiny, kind,
                                                 temperature):
    """Speculation at (tp 2, dp 2): each dp rank verifies its block of
    slots and the commit all-gathers the new rows and the commits, so
    the streams equal the meshless speculative engine's (greedy: and
    the reference's vanilla stream; sampled: token for token, each row
    drawing its noise from one full-batch draw), all four ranks read
    back the same rounds, and a verify round's census adds the three
    all-gathers over dp."""
    jp, tp = tiny
    outs = []
    for m in (None, mesh):
        eng = _port(kind, TCFG, tp, mesh=m, speculate_k=2, rng_seed=7)
        census = _census_of(eng, lambda: outs.append(_opt_streams(
            eng, prompts=SPEC_PROMPTS, temperature=temperature)))
        trails = [d['spec'] for d in eng.state_by_rank()]
        eng.close()
    assert outs[1] == outs[0]
    assert len(trails) == 4 and all(t == trails[0] for t in trails)
    assert trails[0][1]['spec_rounds'] > 0
    if temperature == 0.0:
        assert outs[0] == _opt_streams(_ref(kind, JCFG, jp),
                                       prompts=SPEC_PROMPTS)
        assert trails[0][1]['spec_accepted'] > 0
    assert census['spec'] == audit.expected_census(eng)['spec'] == {
        'all_reduce[tp]': 2 * L, 'all_gather[tp]': 1, 'all_gather[dp]': 3}


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_tp2_dp2_w8a8_streams_equal_meshless(mesh, tiny, kind):
    """W8A8 prefill at (tp 2, dp 2) with int8 weights: prefill runs on
    every rank, its row absmax all-reduced with MAX over tp; the
    streams equal the meshless W8A8 engine's and the reference's."""
    jp, tp = tiny
    kw = dict(quantize='int8', prefill_w8a8=True)
    want = _opt_streams(_port(kind, TCFG, tp, **kw))
    assert want == _opt_streams(_ref(kind, JCFG, jp, **kw))
    eng = _port(kind, TCFG, tp, mesh=mesh, **kw)
    got = _opt_streams(eng)
    eng.close()
    assert got == want
