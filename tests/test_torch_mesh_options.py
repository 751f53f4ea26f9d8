"""The serving options that run under a tp = 2 serving mesh
(``skypilot_tpu_torch/parallel/mesh.py``): two gloo ranks on the CPU,
this process rank 0 and one follower process. Streams are held to the
port's meshless engines and the JAX package's meshless ones at fp32
(R3: the reference's own mesh byte identity is not the bar), and
logits to the reference's tp = 2 mesh engine within stated tolerances
where only the order of fp32 sums differs:

- MoE (``TINY_MOE``): the expert leaves' logical axes and partition
  specs are the reference's; each rank holds every expert with its ffn
  width split; greedy streams on both engines at capacity factors 1.25
  and 0.5; the decode step's census;
- the multi-LoRA bank: base and adapter rows' streams, prefill logits
  within 1e-5 of the reference's tp = 2 mesh engine, each rank's bank
  and registry state equal after loads and an eviction, and no
  collective added to a decode step;
- speculation on both engines, single and fused rounds: streams, each
  rank's trail of committed rounds equal, the verify round's census;
- W8A8 prefill: streams, prefill logits within 1e-5 of the reference's
  tp = 2 mesh engine, the ``wo`` input's row scales those of the
  meshless engine (exactly where the inputs are the same), and the
  prefill census with its MAX reductions (one a layer for MoE, whose
  experts stay W8A16);
- ``kv_static_check`` under a mesh equal to the reference's.

The mesh is one module fixture with a 60 s process-group timeout (a
hang fails the test instead of eating the suite's time), its follower
reaped at teardown.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.analysis import costmodel as jcm
from skypilot_tpu.inference.engine import InferenceEngine as JSlot
from skypilot_tpu.inference.paged import PagedInferenceEngine as JPaged
from skypilot_tpu.models import configs as jconfigs
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu_torch.analysis import audit
from skypilot_tpu_torch.analysis import costmodel as cm
from skypilot_tpu_torch.inference.engine import InferenceEngine
from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
from skypilot_tpu_torch.models import configs, llama, lora, quantization
from skypilot_tpu_torch.models.convert import params_from_numpy
from skypilot_tpu_torch.parallel import mesh as mesh_lib

jax.config.update('jax_platforms', 'cpu')

JCFG = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(configs.TINY, dtype=torch.float32)
JMOE = dataclasses.replace(jconfigs.TINY_MOE, dtype=jnp.float32)
TMOE = dataclasses.replace(configs.TINY_MOE, dtype=torch.float32)
L = TCFG.n_layers
PROMPTS = ([1, 2, 3] * 9, [4, 5] * 10, [7] * 21)
# Repetitive prompts: the n-gram proposer finds matches, acceptance
# varies per slot.
SPEC_PROMPTS = ([1, 2, 3, 4] * 7, [5, 6] * 11, [7, 8, 9] * 7)
KW = dict(max_batch=4, max_seq=128, prefill_chunk_tokens=16)
ENGINES = {'paged': (PagedInferenceEngine, JPaged),
           'slot': (InferenceEngine, JSlot)}
# fp32 logits of magnitude ~4, absolute: only the order of the sums
# differs.
TOL_BANK_LOGITS = 1e-5        # the bank's delta summed per rank before
                              # the reduce
TOL_W8A8_LOGITS = 1e-5        # int32 partial products scaled per rank
                              # before the reduce


@pytest.fixture(scope='module')
def mesh(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    m = mesh_lib.serving_mesh(
        tp=2, device='cpu', timeout_s=60.0,
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


@pytest.fixture(scope='module')
def tiny_moe():
    return _ref_params(JMOE, TMOE)


def _streams(eng, prompts=PROMPTS, gen=8, reqs=None):
    rids = [eng.add_request(list(p), max_new_tokens=gen,
                            **(reqs[i] if reqs else {}))
            for i, p in enumerate(prompts)]
    done = eng.run_to_completion(horizon=8)
    return [done[r].output for r in rids]


def _port(kind, cfg, params, mesh=None, **kw):
    return ENGINES[kind][0](cfg, params, device='cpu', mesh=mesh,
                            **dict(KW, **kw))


def _ref(kind, cfg, params, **kw):
    extra = {'decode_impl': 'gather'} if kind == 'paged' else {}
    # New containers: the reference's bank is written into the params
    # dict it was given.
    return ENGINES[kind][1](cfg, jax.tree.map(lambda x: x, params),
                            attn_impl='xla', **dict(KW, **extra, **kw))


def _census_of(eng, fn):
    """The collectives each graph label's last run issued while ``fn``
    drove ``eng`` (``audit._record_collectives`` on rank 0)."""
    census = {}
    audit._record_collectives(eng, census)
    try:
        fn()
    finally:
        del eng._run_graph
    return census


# ------------------------------------------------------------------ MoE
@pytest.mark.parametrize('tp', [1, 2, 4, 8])
@pytest.mark.parametrize('model', ['tiny-moe', 'mixtral-8x7b'])
def test_moe_leaves_have_the_reference_axes_and_specs(model, tp):
    """The MoE leaves' logical axes are the reference's, and on a
    serving mesh the expert axis ('fsdp', 'sp') has size 1: the experts
    stay whole, their ffn width follows 'mlp' over tp, the router is
    replicated, and ``spec_for`` gives the reference's spec leaf for
    leaf."""
    cfg, jcfg = configs.get_config(model), jconfigs.get_config(model)
    axes = llama.param_logical_axes(cfg)
    assert axes == jllama.param_logical_axes(jcfg)
    spec = mesh_lib.MeshSpec.for_serving(tp=tp)
    jm = jmesh.make_mesh(jmesh.MeshSpec.for_serving(tp=tp),
                         jax.devices()[:tp])
    shapes = llama.init_params(cfg, 0, device='meta')
    for name in ('router', 'moe_gate', 'moe_up', 'moe_down'):
        ax, leaf = axes['layers'][name], shapes['layers'][name]
        got = mesh_lib.spec_for(ax, shape=leaf.shape, mesh=spec)
        assert got == tuple(jmesh.spec_for(ax, shape=leaf.shape,
                                           mesh=jm)), name
        if name == 'router':
            assert 'tp' not in got
        else:
            # The expert dim maps to ('fsdp', 'sp'), size 1 here; only
            # the ffn width can split over tp.
            assert got[1] == ('fsdp', 'sp')
            assert got.index('tp') == (3 if name != 'moe_down' else 2)


@pytest.mark.parametrize('mode', ['bf16', 'int8'])
def test_moe_shards_put_back_and_cut_as_drawn(tmp_path, mode):
    """Each tp rank's MoE shard (codes and scales for int8: ``moe_gate``
    and ``moe_up`` scales split with mlp, ``moe_down``'s lie on embed and
    stay whole) put back is the full leaf; a rank's shard cut as
    ``init_params`` draws it and as ``load_checkpoint`` reads it (one
    expert at a time) equals the shard of the whole tree."""
    from skypilot_tpu_torch.models import weights
    cfg = configs.TINY_MOE
    q = None if mode == 'bf16' else mode
    axes = llama.param_logical_axes(cfg)
    whole = llama.init_params(cfg, 3, device='cpu', quantize=q)
    spec = mesh_lib.MeshSpec.for_serving(tp=2, dp=2)
    shards = [mesh_lib.shard_params(whole, axes, spec, rank=r)
              for r in range(4)]
    def comps(leaf):
        return (list(leaf) if isinstance(leaf, quantization.QUANT_LEAF_TYPES)
                else [leaf])

    for name in ('moe_gate', 'moe_up', 'moe_down', 'router'):
        fulls = comps(whole['layers'][name])
        parts = [comps(s['layers'][name]) for s in shards]
        for i, f in enumerate(fulls):
            ps = [p[i] for p in parts[:2]]
            dims = [d for d in range(f.dim()) if ps[0].shape[d] != f.shape[d]]
            if dims:
                assert dims == [3 if name != 'moe_down' else 2], name
                assert torch.equal(torch.cat(ps, dims[0]), f), name
            else:
                assert all(p is f for p in ps), name
            # dp rank 1's tp shard 0 is dp rank 0's.
            assert torch.equal(parts[2][i], parts[0][i]), name
    weights.save_hf_checkpoint(str(tmp_path), cfg,
                               llama.init_params(cfg, 3, device='cpu'))
    _, read_whole = weights.load_checkpoint(str(tmp_path), dtype=cfg.dtype,
                                            quantize=q, use_cache=False,
                                            device='cpu')
    for rank in (0, 1):
        cut = mesh_lib.leaf_cutter(axes, spec, rank=rank)
        drawn = llama.init_params(cfg, 3, device='cpu', quantize=q, cut=cut)
        _, read = weights.load_checkpoint(
            str(tmp_path), dtype=cfg.dtype, quantize=q, device='cpu',
            cut=lambda c: mesh_lib.leaf_cutter(
                llama.param_logical_axes(c), spec, rank=rank))
        for got, want in ((drawn, shards[rank]),
                          (read, mesh_lib.shard_params(read_whole, axes,
                                                       spec, rank=rank))):
            for name in ('moe_gate', 'moe_up', 'moe_down', 'router'):
                assert all(torch.equal(x, y) for x, y in zip(
                    comps(got['layers'][name]),
                    comps(want['layers'][name]))), (rank, name)


MOE_PROMPTS = ([3, 14, 15, 92, 65], [35, 89, 79, 32, 38, 46, 26, 43] * 3,
               [27, 18, 28] * 13, [61, 80, 33, 98, 87, 17, 71, 12, 120])
MOE_NEW = (12, 3, 12, 12)     # the second request ends early: a dead slot


@pytest.mark.parametrize('cf', [1.25, 0.5])
@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_moe_streams_equal_meshless_and_reference(mesh, tiny_moe, kind, cf):
    """MoE at tp = 2: the greedy streams equal the port's meshless
    engine's and the reference's meshless engine's, at ample capacity
    and at 0.5, where decode drops choices (ROADMAP R6); one decode
    step's census is the dense model's (the MoE combine's partial sum
    reduced once a layer)."""
    jp, tp = tiny_moe
    jcfg = dataclasses.replace(JMOE, moe_capacity_factor=cf)
    tcfg = dataclasses.replace(TMOE, moe_capacity_factor=cf)

    def streams(eng):
        rids = [eng.add_request(list(p), max_new_tokens=n)
                for p, n in zip(MOE_PROMPTS, MOE_NEW)]
        done = eng.run_to_completion(horizon=4)
        return [done[r].output for r in rids]

    want = streams(_ref(kind, jcfg, jp))
    meshless = streams(_port(kind, tcfg, tp))
    eng = _port(kind, tcfg, tp, mesh=mesh)
    assert eng.shard_cfg.ffn_dim == TMOE.ffn_dim // 2
    assert eng.params['layers']['moe_gate'].shape[1] == TMOE.n_experts
    got = []
    census = _census_of(eng, lambda: got.extend(streams(eng)))
    eng.close()
    assert meshless == want
    assert got == meshless
    assert [len(o) for o in got] == list(MOE_NEW)
    assert census['decode'] == audit.expected_census(eng)['decode'] == {
        'all_reduce[tp]': 2 * L, 'all_gather[tp]': 1}


# ------------------------------------------------------------ the bank
def _adapter_tree(cfg, seed, rank=4, targets=('wq', 'wv', 'wo', 'w_up',
                                             'w_down')):
    """A trainer-format adapter of host fp32 factors large enough to
    change the greedy stream."""
    rng = np.random.default_rng(seed)
    lcfg = dataclasses.replace(cfg, lora_rank=rank)
    tree = {}
    for t in targets:
        a_shape, b_shape = lora._target_shapes(lcfg, t)
        tree[t] = {
            'a': rng.normal(0, 0.3, (cfg.n_layers,) + a_shape).astype(
                np.float32),
            'b': rng.normal(0, 0.3, (cfg.n_layers,) + b_shape).astype(
                np.float32)}
    return tree


BANK = dict(adapter_slots=2, adapter_rank=4)
BANK_REQS = [{'adapter': 'a1'}, {}, {'adapter': 'a2'}]


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_bank_streams_and_no_added_collective(mesh, tiny, kind):
    """The bank at tp = 2 (replicated on each rank, each using its
    slice): the base row's stream is the meshless engine's without a
    bank bit for bit, the adapter rows' streams are the meshless bank
    engine's and the reference's, and a decode step's census is a
    bank-less engine's, the expected one."""
    jp, tp = tiny
    trees = {n: _adapter_tree(TCFG, s) for n, s in (('a1', 1), ('a2', 2))}
    jeng = _ref(kind, JCFG, jp, **BANK)
    for n, t in trees.items():
        jeng.adapters.register(n, t, 0.5)
    want = _streams(jeng, reqs=BANK_REQS)
    plain = _streams(_port(kind, TCFG, tp))
    meshless = _port(kind, TCFG, tp, **BANK)
    for n, t in trees.items():
        meshless.adapters.register(n, t, 0.5)
    want_port = _streams(meshless, reqs=BANK_REQS)
    eng = _port(kind, TCFG, tp, mesh=mesh, **BANK)
    for n, t in trees.items():
        eng.register_adapter(n, t, 0.5)
    got = []
    census = _census_of(eng, lambda: got.extend(_streams(eng,
                                                         reqs=BANK_REQS)))
    assert eng.adapters.bank['wq']['b'].shape[3] == TCFG.n_heads
    eng.close()
    bare = _port(kind, TCFG, tp, mesh=mesh)
    base_census = _census_of(bare, lambda: _streams(bare))
    bare.close()
    assert want_port == want
    assert got == want_port
    assert got[1] == plain[1]
    assert got[0] != plain[0] and got[2] != plain[2]
    assert census['decode'] == base_census['decode'] == \
        audit.expected_census(eng)['decode']


def test_bank_prefill_logits_match_the_reference_mesh_engine(mesh, tiny):
    """One prefill's fp32 logits, an adapter row and a base row, at
    tp = 2 against the reference's tp = 2 mesh engine (its bank
    replicated) within TOL_BANK_LOGITS: the row-parallel deltas are
    summed per rank before the reduce, where the partitioned reference
    may reduce ``x @ a`` first."""
    jp, tp = tiny
    tree = _adapter_tree(TCFG, 1)
    tokens = np.random.default_rng(0).integers(1, 256, (2, 24)).astype(
        np.int32)
    jeng = JPaged(JCFG, jax.tree.map(lambda x: x, jp), attn_impl='xla',
                  mesh=jmesh.serving_mesh(tp=2), **KW, **BANK)
    jeng.adapters.register('a1', tree, 0.5)
    slot = jeng.adapters.acquire('a1')
    want, _ = jllama.prefill_rows(
        jeng.params, jnp.asarray(tokens), jnp.full((2,), 24, jnp.int32),
        JCFG, attn_impl='xla', all_logits=True,
        mlora_idx=jnp.asarray([slot, -1], jnp.int32))
    want = np.asarray(jax.device_get(want))
    outs = []
    for m in (None, mesh):
        eng = _port('paged', TCFG, tp, mesh=m, **BANK)
        eng.register_adapter('a1', tree, 0.5)
        rid = eng.add_request([1, 2, 3], max_new_tokens=2, adapter='a1')
        eng.run_to_completion()
        eng.pop_finished(rid)
        outs.append(eng.prefill_logits(tokens, adapters=['a1', None]))
        eng.close()
    meshless, got = outs
    assert np.abs(got - want).max() <= TOL_BANK_LOGITS
    assert np.abs(got - meshless).max() <= TOL_BANK_LOGITS
    assert np.abs(got[0] - got[1]).max() > 100 * TOL_BANK_LOGITS


def test_bank_state_equal_on_every_rank_after_loads_and_an_eviction(
        mesh, tiny):
    """Two bank slots, three adapters: the third's load evicts the
    coldest. After each wave every rank's bank bytes and registry state
    (slots, loads, the prefix-cache salts) are equal; the eviction
    changed them, and the salt of a reloaded adapter is a new one on
    every rank alike."""
    _, tp = tiny
    eng = _port('paged', TCFG, tp, mesh=mesh, **BANK)
    for n, s in (('a1', 1), ('a2', 2), ('a3', 3)):
        eng.register_adapter(n, _adapter_tree(TCFG, s), 0.5)
    seen = []
    for wave in (('a1', 'a2'), ('a3',), ('a1',)):
        _streams(eng, prompts=PROMPTS[:len(wave)],
                 reqs=[{'adapter': n} for n in wave])
        digests = [d['bank'] for d in eng.state_by_rank()]
        assert len(digests) == 2 and digests[0] == digests[1], wave
        seen.append(digests[0])
    assert eng.adapters.evictions_total == 2
    assert len(set(seen)) == 3
    assert eng.adapters.prefix_salt('a1') == b'adapter:a1#4'
    eng.close()


# ---------------------------------------------------------- speculation
@pytest.mark.parametrize('rounds', [1, 2])
@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_spec_streams_ranks_agree_and_census(mesh, tiny, kind, rounds):
    """Speculation at tp = 2, single rounds and two fused rounds a call:
    the fp32 greedy streams equal the meshless speculative engine's and
    the reference's vanilla stream; every rank committed the same
    rounds (equal trails, equal accepted counts, some drafts accepted);
    a verify round's census is the expected one (the forward's
    reductions and the logits all-gather, on the tp-gathered logits
    every rank accepts alike)."""
    jp, tp = tiny
    kw = dict(speculate_k=2)
    if rounds > 1:
        kw['decode_steps_per_call'] = rounds
    want = _streams(_ref(kind, JCFG, jp), prompts=SPEC_PROMPTS)
    meshless_eng = _port(kind, TCFG, tp, **kw)
    meshless = _streams(meshless_eng, prompts=SPEC_PROMPTS)
    eng = _port(kind, TCFG, tp, mesh=mesh, **kw)
    got = []
    census = _census_of(eng, lambda: got.extend(
        _streams(eng, prompts=SPEC_PROMPTS)))
    trails = [d['spec'] for d in eng.state_by_rank()]
    eng.close()
    assert meshless == want
    assert got == meshless
    assert trails[0] == trails[1]
    assert trails[0][1] == meshless_eng.spec_metrics()
    assert trails[0][1]['spec_accepted'] > 0
    label = 'spec' if rounds == 1 else 'spec_fused'
    assert census[label] == audit.expected_census(eng)[label] == {
        'all_reduce[tp]': 2 * L * rounds, 'all_gather[tp]': rounds}


# ----------------------------------------------------------------- W8A8
W8A8 = dict(quantize='int8', prefill_w8a8=True)


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_w8a8_streams_equal_meshless(mesh, tiny, kind):
    """W8A8 prefill at tp = 2 (int8 weights): the streams equal the
    meshless W8A8 engine's and the reference's; on the paged engine with
    speculation the verify rounds run W8A8 too, and their census carries
    a MAX reduction before each row-parallel product."""
    jp, tp = tiny
    want = _streams(_ref(kind, JCFG, jp, **W8A8))
    meshless = _streams(_port(kind, TCFG, tp, **W8A8))
    eng = _port(kind, TCFG, tp, mesh=mesh, **W8A8)
    got = _streams(eng)
    eng.close()
    assert meshless == want
    assert got == meshless
    if kind == 'paged':
        want = _streams(_port(kind, TCFG, tp, speculate_k=2, **W8A8),
                        prompts=SPEC_PROMPTS)
        eng = _port(kind, TCFG, tp, mesh=mesh, speculate_k=2, **W8A8)
        got = []
        census = _census_of(eng, lambda: got.extend(
            _streams(eng, prompts=SPEC_PROMPTS)))
        eng.close()
        assert got == want
        assert census['spec'] == audit.expected_census(eng)['spec'] == {
            'all_reduce[tp]': 2 * L, 'all_reduce_max[tp]': 2 * L,
            'all_gather[tp]': 1}


def test_w8a8_prefill_logits_row_scales_and_census(mesh, tiny,
                                                   monkeypatch):
    """One W8A8 prefill at tp = 2: its fp32 logits within
    TOL_W8A8_LOGITS of the reference's tp = 2 mesh engine's and of the
    meshless engine's; the row scales of the ``wo`` input (each rank
    holds half of every row) are the meshless engine's: exactly in the
    first layer, whose input is the same, and within fp32 rounding in
    the next; rank 0's own half-row absmax alone is smaller for some
    rows, so the MAX reduction is what makes them equal. The census
    gains one MAX all-reduce before each row-parallel product."""
    jp, tp = tiny
    tokens = np.random.default_rng(0).integers(1, 256, (2, 24)).astype(
        np.int32)
    jeng = JPaged(JCFG, jp, attn_impl='xla', mesh=jmesh.serving_mesh(tp=2),
                  **KW, **W8A8)
    want, _ = jllama.prefill_rows(
        jeng.params, jnp.asarray(tokens), jnp.full((2,), 24, jnp.int32),
        JCFG, attn_impl='xla', all_logits=True, w8a8=True)
    want = np.asarray(jax.device_get(want))
    seen = []
    orig = quantization.quantize_rows

    def spy(x, row_split=None):
        q, s = orig(x, row_split)
        if row_split == 'heads':
            # This rank's part of each row: its own absmax, and the
            # scale quantize_rows made.
            seen.append((x.float().abs().amax(-1, keepdim=True), s))
        return q, s

    monkeypatch.setattr(quantization, 'quantize_rows', spy)
    outs, scales = [], []
    for m in (None, mesh):
        eng = _port('paged', TCFG, tp, mesh=m, **W8A8)
        seen.clear()
        mesh_lib.reset_collective_counts()
        outs.append(eng.prefill_logits(tokens))
        issued = dict(mesh_lib.collective_counts)
        scales.append(list(seen))
        if m is not None:
            expected = audit.expected_prefill_census(eng)
            eng.close()
    meshless, got = outs
    assert np.abs(got - want).max() <= TOL_W8A8_LOGITS
    assert np.abs(got - meshless).max() <= TOL_W8A8_LOGITS
    assert len(scales[0]) == len(scales[1]) == L
    (whole, s0), (half, s1) = scales[0][0], scales[1][0]
    assert torch.equal(s1, s0)
    assert (half < whole).any() and (half <= whole).all()
    for (_, a), (_, b) in zip(scales[0], scales[1]):
        assert torch.allclose(a, b, rtol=1e-6, atol=0)
    assert issued == expected == {'all_reduce[tp]': 2 * L,
                                  'all_reduce_max[tp]': 2 * L,
                                  'all_gather[tp]': 1}


def test_w8a8_moe_reduces_the_row_absmax_of_wo_only(mesh, tiny_moe):
    """MoE int8 with W8A8 prefill at tp = 2: the experts' einsums stay
    W8A16, so a prefill call and a paged verify round issue one MAX
    all-reduce a layer (before ``wo``), as ``expected_prefill_census``
    and ``expected_census`` count, beside the dense forward's reductions;
    the streams equal the meshless engine's."""
    _, tp = tiny_moe
    n = TMOE.n_layers
    tokens = np.random.default_rng(0).integers(1, 256, (2, 24)).astype(
        np.int32)
    kw = dict(speculate_k=2, **W8A8)
    want = _streams(_port('paged', TMOE, tp, **kw), prompts=SPEC_PROMPTS)
    eng = _port('paged', TMOE, tp, mesh=mesh, **kw)
    mesh_lib.reset_collective_counts()
    eng.prefill_logits(tokens)
    issued = dict(mesh_lib.collective_counts)
    got = []
    census = _census_of(eng, lambda: got.extend(
        _streams(eng, prompts=SPEC_PROMPTS)))
    expected = (audit.expected_prefill_census(eng),
                audit.expected_census(eng)['spec'])
    eng.close()
    assert got == want
    assert issued == expected[0] == census['spec'] == expected[1] == {
        'all_reduce[tp]': 2 * n, 'all_reduce_max[tp]': n,
        'all_gather[tp]': 1}


# ------------------------------------------------------------ cost model
@pytest.mark.parametrize('tp', [1, 2, 4])
@pytest.mark.parametrize('kv', ['bf16', 'int8', 'int4'])
def test_kv_static_check_under_a_mesh_equals_the_reference(tp, kv):
    """``kv_static_check`` under a serving mesh divides the static bytes
    a token by the kv shard degree (TINY's 2 kv heads split at tp = 2,
    replicate at 4), as the reference's does."""
    jm = jmesh.make_mesh(jmesh.MeshSpec.for_serving(tp=tp),
                         jax.devices()[:tp])
    spec = mesh_lib.MeshSpec.for_serving(tp=tp)
    per = cm.kv_static_check(configs.TINY, kv, 1.0)['static_bytes_per_token']
    got = cm.kv_static_check(configs.TINY, kv, per / (2 if tp == 2 else 1),
                             mesh=spec)
    want = jcm.kv_static_check(jconfigs.TINY, kv, per / (2 if tp == 2
                                                         else 1), mesh=jm)
    assert got['static_bytes_per_token'] == want['static_bytes_per_token']
    assert got['ok'] and want['ok']
