"""The serving mesh's pure functions (``skypilot_tpu_torch/parallel/
mesh.py``, ``serve/placement.py``) held against the JAX package's
``skypilot_tpu/parallel/mesh.py`` and ``serve/placement.py`` on the CPU,
with no process started: ``MeshSpec``, ``serving_spec_from_env``,
``spec_for`` and ``axis_shard_degree`` on every leaf of
``param_logical_axes`` of five presets at tp in {1, 2, 4, 8} and dp in
{1, 2} (compared as tuples), the per-shard KV byte counts,
``shard_params`` (the shards, put back together, are the full tree bit
for bit, for bf16, int8 and int4 leaves; an int4 shard that would cut a
scale group raises), and the placement policy.

The reference's meshes of up to 8 devices are real (``tests/
conftest.py`` forces 8 virtual CPU devices); the 16-device shapes use a
stand-in with the same ``shape`` mapping, all that ``spec_for`` reads.
"""
import dataclasses
import types

import jax
import pytest
import torch

from skypilot_tpu.inference import engine as jengine
from skypilot_tpu.models import configs as jconfigs
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.serve import placement as jplacement
from skypilot_tpu_torch.inference import engine as tengine
from skypilot_tpu_torch.models import configs, llama, quantization
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.serve import placement
from skypilot_tpu_torch.utils.device import local_rank_device

jax.config.update('jax_platforms', 'cpu')

MODELS = ['tiny', 'llama2-7b', 'llama3-8b', 'gemma-2b', 'qwen2-7b']
SHAPES = [(tp, dp) for tp in (1, 2, 4, 8) for dp in (1, 2)]


def _ref_mesh(tp, dp):
    spec = jmesh.MeshSpec.for_serving(tp=tp, dp=dp)
    if spec.num_devices <= jax.device_count():
        return jmesh.make_mesh(spec, jax.devices()[:spec.num_devices])
    return types.SimpleNamespace(shape=dict(zip(jmesh.MESH_AXES,
                                                spec.shape)))


def _leaves(axes, params, path=()):
    for k, v in axes.items():
        if isinstance(v, dict):
            yield from _leaves(v, params[k], path + (k,))
        else:
            yield path + (k,), v, params[k]


def test_mesh_spec_and_env_match_the_reference(monkeypatch):
    for tp, dp in SHAPES:
        t = mesh_lib.MeshSpec.for_serving(tp=tp, dp=dp)
        j = jmesh.MeshSpec.for_serving(tp=tp, dp=dp)
        assert (t.shape, t.num_devices) == (j.shape, j.num_devices)
    for n, kw in ((8, {}), (8, {'tp': 2}), (16, {'tp': 4, 'sp': 2})):
        assert mesh_lib.MeshSpec.auto(n, **kw).shape == \
            jmesh.MeshSpec.auto(n, **kw).shape
    for bad in ({'tp': 0}, {'dp': 0}):
        with pytest.raises(ValueError):
            mesh_lib.MeshSpec.for_serving(**bad)
    assert mesh_lib.MESH_AXES == jmesh.MESH_AXES
    assert mesh_lib.DEFAULT_RULES == jmesh.DEFAULT_RULES
    monkeypatch.setenv('SKYTPU_TP', '2')
    monkeypatch.setenv('SKYTPU_DP', '3')
    for kw in ({}, {'tp': 4, 'dp': 1}, {'dp': 2}):
        t = mesh_lib.serving_spec_from_env(**kw)
        j = jmesh.serving_spec_from_env(**kw)
        assert (t.tp, t.dp) == (j.tp, j.dp)
    assert mesh_lib.spec_from_env(num_devices=8, tp=2).shape == \
        jmesh.spec_from_env(num_devices=8, tp=2).shape


@pytest.mark.parametrize('tp,dp', SHAPES)
@pytest.mark.parametrize('model', MODELS)
def test_spec_for_every_leaf_matches_the_reference(model, tp, dp):
    """The port's logical axes are the reference's, leaf for leaf, and
    ``spec_for`` (divisibility-aware) gives the reference's
    PartitionSpec as a tuple on every leaf's shape; so does
    ``axis_shard_degree`` on the heads, kv heads, mlp and vocab."""
    cfg, jcfg = configs.get_config(model), jconfigs.get_config(model)
    axes = llama.param_logical_axes(cfg)
    assert axes == jllama.param_logical_axes(jcfg)
    spec = mesh_lib.MeshSpec.for_serving(tp=tp, dp=dp)
    jm = _ref_mesh(tp, dp)
    shapes = llama.init_params(cfg, 0, device='meta')
    for path, ax, leaf in _leaves(axes, shapes):
        want = tuple(jmesh.spec_for(ax, shape=leaf.shape, mesh=jm))
        assert mesh_lib.spec_for(ax, shape=leaf.shape, mesh=spec) == want, \
            path
        assert mesh_lib.spec_for(ax) == tuple(jmesh.spec_for(ax)), path
    for n in (cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim, cfg.vocab_size):
        assert mesh_lib.axis_shard_degree(spec, 'tp', n) == \
            jmesh.axis_shard_degree(jm, 'tp', n)
    assert mesh_lib.data_axis_size(spec) == (
        jmesh.data_axis_size(jm) if isinstance(jm, jax.sharding.Mesh)
        else dp)
    assert mesh_lib.mesh_axis_sizes(spec) == dict(
        zip(jmesh.MESH_AXES, jmesh.MeshSpec.for_serving(tp=tp,
                                                        dp=dp).shape))
    for kv in ('bf16', 'int8', 'int4'):
        assert tengine.kv_token_bytes(cfg, kv, mesh=spec) == \
            jengine.kv_token_bytes(jcfg, kv, mesh=jm), kv
    assert tengine.kv_shard_degree(cfg, spec) == \
        jengine.kv_shard_degree(jcfg, jm)
    assert tengine._ring_row_bytes(cfg, 8, spec) == \
        jengine._ring_row_bytes(jcfg, 8, jm)


def test_meshless_defaults_and_device_checks():
    """1 x 1 stays meshless; a CUDA mesh needs a card per rank (without
    one it raises: a CUDA rank never falls back to the CPU)."""
    assert mesh_lib.serving_mesh(1, 1, device='cpu') is None
    assert mesh_lib.mesh_axis_sizes(None) == {a: 1 for a in
                                             mesh_lib.MESH_AXES}
    assert jmesh.mesh_axis_sizes(None) == mesh_lib.mesh_axis_sizes(None)
    assert mesh_lib.axis_shard_degree(None, 'tp', 4) == 1
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match='CUDA devices'):
            mesh_lib.serving_mesh(tp=2, device='cuda')
        with pytest.raises(RuntimeError, match='CUDA device 1'):
            local_rank_device(1, 'cuda')
    assert local_rank_device(3, 'cpu') == torch.device('cpu')
    with pytest.raises(NotImplementedError, match='training meshes'):
        mesh_lib.make_mesh(mesh_lib.MeshSpec(fsdp=2), device='cpu')


def test_tp_plan_and_shard_config():
    """Which dims split, the local config, and the layout of q heads
    split over several replicated kv heads (``kv_groups``: each rank's q
    heads placed in a virtual query over every kv head)."""
    tiny = configs.TINY                                 # 4 q, 2 kv heads
    two = mesh_lib.MeshSpec.for_serving(tp=2)
    assert mesh_lib.tp_plan(tiny, two) == dict(heads=True, kv_heads=True,
                                               mlp=True, vocab=True,
                                               kv_groups=None)
    local = mesh_lib.shard_config(tiny, two)
    assert (local.n_heads, local.n_kv_heads, local.ffn_dim,
            local.head_dim, local.vocab_size) == (2, 1, 64, 16, 256)
    mqa = dataclasses.replace(tiny, n_kv_heads=1)
    assert mesh_lib.tp_plan(mqa, two)['kv_heads'] is False
    assert mesh_lib.shard_config(mqa, two).n_kv_heads == 1
    assert mesh_lib.tp_plan(mqa, two)['kv_groups'] is None
    one = mesh_lib.MeshSpec.for_serving(tp=1)
    plan1 = mesh_lib.tp_plan(tiny, one)
    assert all(plan1[k] for k in ('heads', 'kv_heads', 'mlp', 'vocab'))
    four = mesh_lib.MeshSpec.for_serving(tp=4)
    plan4 = mesh_lib.tp_plan(tiny, four)
    assert plan4['heads'] and not plan4['kv_heads']
    assert plan4['kv_groups'] == ((0,), 2)              # rank 0: kv 0
    assert mesh_lib.kv_head_layout(tiny, four, tp_rank=3) == ((1,), 2)
    local4 = mesh_lib.shard_config(tiny, four)
    assert (local4.n_heads, local4.n_kv_heads) == (1, 2)


def _put_back(shards, full):
    """The tp shards of one leaf concatenated along the dims they split."""
    out = shards[0]
    for dim in range(full.dim()):
        if out.shape[dim] != full.shape[dim]:
            out = torch.cat(shards, dim)
    return out


def _components(leaf):
    if isinstance(leaf, quantization.QUANT_LEAF_TYPES):
        return list(leaf)
    return [leaf]


@pytest.mark.parametrize('mode', ['bf16', 'int8', 'int4', 'int4-group'])
@pytest.mark.parametrize('tp', [2, 4])
def test_shard_params_put_back_is_the_full_tree(monkeypatch, mode, tp):
    """Each tp rank's shard (dp rank 0; a dp rank holds the same), put
    back together along the split dims, equals the full leaf exactly;
    a leaf whose shard is whole is the full tensor itself (no copy)."""
    if mode == 'int4-group':
        monkeypatch.setenv('SKYTPU_INT4_GROUP', '16')
    cfg = configs.TINY
    params = llama.init_params(cfg, 0, device='cpu',
                               quantize=None if mode == 'bf16'
                               else mode.split('-')[0])
    axes = llama.param_logical_axes(cfg)
    spec = mesh_lib.MeshSpec.for_serving(tp=tp, dp=2)
    shards = [mesh_lib.shard_params(params, axes, spec, rank=r)
              for r in range(tp)]
    assert mesh_lib.shard_params(params, axes, spec, rank=tp) is not None
    for path, _, full in _leaves(axes, params):
        got = []
        for sh in shards:
            leaf = sh
            for k in path:
                leaf = leaf[k]
            got.append(leaf)
        for i, f in enumerate(_components(full)):
            parts = [_components(g)[i] for g in got]
            assert torch.equal(_put_back(parts, f), f), (path, i)
            if all(p.shape == f.shape for p in parts):
                assert all(p is f for p in parts), path
    # Replicated: the embedding; split: the q heads (2 of 4 at tp = 2).
    assert shards[0]['embed'] is params['embed']
    wq = shards[0]['layers']['wq']
    heads = (wq.int8 if mode == 'int8' else wq.packed if 'int4' in mode
             else wq).shape[2]
    assert heads == cfg.n_heads // tp


def test_int4_shard_that_cuts_a_scale_group_raises(monkeypatch):
    """``w_down``'s group scales run along mlp, the axis tp splits:
    16-code groups of a 96-wide mlp make 6 groups, which 2 ranks split
    whole and 4 ranks (24 codes each) would cut; that raises, never a
    silent repack."""
    monkeypatch.setenv('SKYTPU_INT4_GROUP', '16')
    cfg = dataclasses.replace(configs.TINY, ffn_dim=96)
    params = llama.init_params(cfg, 0, device='cpu', quantize='int4')
    assert params['layers']['w_down'].scale.shape[1] == 6
    axes = llama.param_logical_axes(cfg)
    mesh_lib.shard_params(params, axes, mesh_lib.MeshSpec.for_serving(tp=2),
                          rank=1)
    with pytest.raises(ValueError, match='group'):
        mesh_lib.shard_params(params, axes,
                              mesh_lib.MeshSpec.for_serving(tp=4), rank=1)


def _tree_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    return all(torch.equal(x, y) for x, y in zip(_components(a),
                                                 _components(b)))


@pytest.mark.parametrize('mode', ['bf16', 'int8', 'int4'])
@pytest.mark.parametrize('cfg_name', ['tiny', 'tiny-qwen', 'tiny-gemma'])
def test_cut_as_drawn_and_as_read_equals_the_shard_of_the_whole(
        tmp_path, mode, cfg_name):
    """A rank's shard cut leaf by leaf as ``init_params`` draws it, and
    tensor by tensor as ``load_checkpoint`` reads it, equals
    ``shard_params`` of the whole tree bit for bit (so a rank never
    holds the whole model, and its shard is the one the meshless
    engine's weights imply), on every rank of a (tp 2, dp 2) mesh."""
    cfg = {'tiny': configs.TINY,
           'tiny-qwen': configs.get_config('tiny-qwen'),
           'tiny-gemma': configs.get_config('tiny-gemma')}[cfg_name]
    q = None if mode == 'bf16' else mode
    axes = llama.param_logical_axes(cfg)
    spec = mesh_lib.MeshSpec.for_serving(tp=2, dp=2)
    whole = llama.init_params(cfg, 3, device='cpu', quantize=q)
    from skypilot_tpu_torch.models import weights
    weights.save_hf_checkpoint(str(tmp_path), cfg,
                               llama.init_params(cfg, 3, device='cpu'))
    _, read_whole = weights.load_checkpoint(str(tmp_path), dtype=cfg.dtype,
                                            quantize=q, use_cache=False,
                                            device='cpu')
    for rank in range(spec.num_devices):
        cut = mesh_lib.leaf_cutter(axes, spec, rank=rank)
        drawn = llama.init_params(cfg, 3, device='cpu', quantize=q, cut=cut)
        assert _tree_equal(drawn, mesh_lib.shard_params(whole, axes, spec,
                                                        rank=rank)), rank
        _, read = weights.load_checkpoint(
            str(tmp_path), dtype=cfg.dtype, quantize=q, device='cpu',
            cut=lambda c: mesh_lib.leaf_cutter(
                llama.param_logical_axes(c), spec, rank=rank))
        assert _tree_equal(read, mesh_lib.shard_params(read_whole, axes,
                                                       spec, rank=rank))
    assert not list(tmp_path.glob('.*_cache.bin'))


def test_moe_and_lora_have_no_logical_axes_yet():
    """MoE leaves have the reference's logical axes now (their specs:
    ``tests/test_torch_mesh_options.py``); a config with trained LoRA
    adapters still has none (its serving engine merges them first)."""
    moe_cfg = configs.get_config('tiny-moe')
    assert llama.param_logical_axes(moe_cfg) == jllama.param_logical_axes(
        jconfigs.get_config('tiny-moe'))
    with pytest.raises(NotImplementedError, match='LoRA'):
        llama.param_logical_axes(dataclasses.replace(configs.TINY,
                                                     lora_rank=4))


def test_quantize_logical_axes_matches_the_reference():
    from skypilot_tpu.models import quantization as jq
    for mode in ('int8', 'int4'):
        t = quantization.quantize_logical_axes(
            llama.param_logical_axes(configs.TINY), mode)
        j = jq.quantize_logical_axes(
            jllama.param_logical_axes(jconfigs.TINY), mode)
        assert repr(t) == repr(j).replace('skypilot_tpu.', '')


@pytest.mark.parametrize('name', sorted(configs.PRESETS))
def test_placement_matches_the_reference(name):
    """``model_weight_bytes``, ``min_tp_to_fit``, ``choose_parallelism``
    and ``plan_for_model`` equal the reference's for every preset, at
    the reference's defaults (``hbm_per_chip_gb=16.0``, a TPU chip's)
    and at an H100's 80 GB."""
    for q in (None, 'int8'):
        b = placement.model_weight_bytes(name, quantize=q)
        assert b == jplacement.model_weight_bytes(name, quantize=q)
        for hbm in (16.0, 80.0):
            assert placement.min_tp_to_fit(b, hbm_per_chip_gb=hbm) == \
                jplacement.min_tp_to_fit(b, hbm_per_chip_gb=hbm)
            for chips in (1, 2, 4, 8):
                for tier in ('latency', 'throughput'):
                    kw = dict(slo_tier=tier, hbm_per_chip_gb=hbm)
                    try:
                        want = jplacement.plan_for_model(name, chips,
                                                         quantize=q, **kw)
                    except ValueError:
                        with pytest.raises(ValueError):
                            placement.plan_for_model(name, chips,
                                                     quantize=q, **kw)
                        continue
                    got = placement.plan_for_model(name, chips, quantize=q,
                                                   **kw)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want)
                    assert got.as_env() == want.as_env()
                    assert got.chips == want.chips
