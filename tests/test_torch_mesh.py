"""The mesh's pure functions (``skypilot_tpu_torch/parallel/mesh.py``,
``serve/placement.py``) held against the JAX package's
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

Five tests start follower processes: a training mesh (fsdp 2) builds
with a process group per axis and a serving engine refuses it; the
waits between calls (an idle follower outlives the mesh's group
timeout; a follower exits within a bound once its rank 0 is killed or
stalls; a stalled follower makes rank 0 raise within a bound); and a
mesh builds in a process whose earlier bootstrap failed.
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
    # A training mesh builds (a process group over each axis with more
    # than one rank); the serving engines refuse its training axes.
    m = mesh_lib.make_mesh(mesh_lib.MeshSpec(fsdp=2), device='cpu',
                           timeout_s=60.0)
    try:
        assert m.shape['fsdp'] == 2 and not m.is_serving
        assert m.group('fsdp') is not None and m.group('tp') is None
        assert m.axis_size(mesh_lib.DATA_AXES) == 2
        with pytest.raises(ValueError, match='training axes'):
            tengine.InferenceEngine(configs.TINY, None, max_batch=1,
                                    max_seq=32, device='cpu', mesh=m)
    finally:
        m.shutdown()


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


def test_moe_and_lora_logical_axes_match_the_reference():
    """MoE leaves have the reference's logical axes (their specs:
    ``tests/test_torch_mesh_options.py``), and so do a LoRA config's
    trained adapters (``lora.lora_logical_axes``), on every target."""
    moe_cfg = configs.get_config('tiny-moe')
    assert llama.param_logical_axes(moe_cfg) == jllama.param_logical_axes(
        jconfigs.get_config('tiny-moe'))
    targets = ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down')
    got = llama.param_logical_axes(dataclasses.replace(
        configs.TINY, lora_rank=4, lora_targets=targets))
    want = jllama.param_logical_axes(dataclasses.replace(
        jconfigs.TINY, lora_rank=4, lora_targets=targets))
    assert got == want
    assert got['layers']['lora']['wo'] == {
        'a': ('layers', 'heads', 'head_dim', None),
        'b': ('layers', None, 'embed')}


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


# ------------------------------------------------------------ the follower
def _tiny_engine(mesh):
    return tengine.InferenceEngine(
        dataclasses.replace(configs.TINY, dtype=torch.float32), None,
        max_batch=1, max_seq=32, device='cpu', mesh=mesh)


def _serve_one(eng):
    rid = eng.add_request([1, 2, 3], max_new_tokens=2)
    return eng.run_to_completion(horizon=2)[rid].output


def test_idle_follower_outlives_the_group_timeout():
    """An idle follower waits for rank 0's next call as long as rank 0
    lives: a mesh with a 6 s timeout serves a call, rank 0 idles 7 s
    (its pinger rings the doorbell meanwhile), and the next call still
    succeeds (before the repair the follower's wait timed out and it
    left the mesh)."""
    import time
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    m = mesh_lib.serving_mesh(tp=2, device='cpu', timeout_s=6.0)
    try:
        eng = _tiny_engine(m)
        first = _serve_one(eng)
        time.sleep(7.0)
        m.check_followers()
        assert _serve_one(eng) == first
    finally:
        m.shutdown()
        torch.set_num_threads(n)


def _alive(pid):
    try:
        with open(f'/proc/{pid}/stat') as f:
            return f.read().split()[2] != 'Z'
    except FileNotFoundError:
        return False


@pytest.mark.parametrize('how', ['killed', 'stalled'])
def test_follower_exits_when_rank_0_is_killed(how):
    """A follower whose rank 0 goes between calls leaves within a bound
    instead of waiting on the doorbell: at once when rank 0 is killed
    (SIGKILL), and within the mesh's 5 s timeout when rank 0 stalls
    (SIGSTOP: its process and connections live on, as when its host
    is lost without a reset, but it rings no more)."""
    import os
    import signal
    import subprocess
    import sys
    import time
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sig = 'SIGKILL' if how == 'killed' else 'SIGSTOP'
    script = (
        'import os, signal, sys, torch\n'
        f'sys.path.insert(0, {root!r})\n'
        'torch.set_num_threads(1)\n'
        'from skypilot_tpu_torch.parallel import mesh as mesh_lib\n'
        "m = mesh_lib.serving_mesh(tp=2, device='cpu', timeout_s=5.0)\n"
        'print(m.follower_pids()[0], flush=True)\n'
        f'os.kill(os.getpid(), signal.{sig})\n')
    proc = subprocess.Popen([sys.executable, '-c', script],
                            stdout=subprocess.PIPE, text=True)
    try:
        pid = int(proc.stdout.readline())
        bound = 10.0 if how == 'killed' else 20.0
        deadline = time.monotonic() + bound
        while _alive(pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not _alive(pid), \
            f'follower {pid} still waiting {bound} s after rank 0 {how}'
    finally:
        proc.kill()
        proc.wait(30)
        proc.stdout.close()


def test_stalled_follower_fails_rank_0_within_the_timeout():
    """A follower that stops answering (SIGSTOP: alive to ``poll`` and
    connected, as one whose host is lost without a reset) makes rank 0
    raise :class:`FollowerDied` within a bound of a few timeouts (the
    doorbell ring, the call's collectives and the agreement each wait
    at most the mesh's 5 s), instead of waiting on it."""
    import os
    import signal
    import time
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    m = mesh_lib.serving_mesh(tp=2, device='cpu', timeout_s=5.0)
    pid = m.follower_pids()[0]
    try:
        eng = _tiny_engine(m)
        _serve_one(eng)
        os.kill(pid, signal.SIGSTOP)
        t0 = time.monotonic()
        with pytest.raises(mesh_lib.FollowerDied):
            _serve_one(eng)
        assert time.monotonic() - t0 < 25.0
    finally:
        os.kill(pid, signal.SIGKILL)
        m.shutdown()
        torch.set_num_threads(n)


def test_a_mesh_builds_after_a_failed_bootstrap():
    """A bootstrap whose peer never came (``initialize_gang_distributed``
    over a world of 2, alone) raises within its timeout and leaves no
    process group, and a mesh built next in the same process serves:
    torch's group counter, which the failed init left raised, restarts
    at 0, so rank 0 names its default group as its fresh followers do
    (before the repair their rendezvous never met)."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    with pytest.raises(Exception):
        mesh_lib.initialize_gang_distributed(
            f'http://127.0.0.1:{port - 1000}', 0, 2, device='cpu',
            timeout_s=1.0)
    assert not dist.is_initialized()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    m = mesh_lib.serving_mesh(tp=2, device='cpu', timeout_s=60.0)
    try:
        assert len(_serve_one(_tiny_engine(m))) == 2
    finally:
        m.shutdown()
        torch.set_num_threads(n)
