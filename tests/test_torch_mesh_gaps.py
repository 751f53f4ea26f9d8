"""The serving mesh's last gaps (``skypilot_tpu_torch/parallel/mesh.py``,
``inference/engine.py``, ``inference/paged.py``, ``models/weights.py``),
on the CPU over gloo ranks, at fp32 TINY unless a test says otherwise:

- several kv heads replicated over tp (``mesh.kv_head_layout``): the
  unaligned 6 q / 3 kv at tp 2 and the aligned TINY 4 / 2 at tp 4, on
  both engines and every ``decode_impl``, and with int8 KV; the streams
  equal the meshless engine's and the reference's (int8: the port's
  meshless int8 stream, R1); one kv shard, as the reference's byte
  counts have it; a tp 2 to tp 1 handoff of the replicated pool lands
  the same bytes;
- dp-split prefill at dp 2 and at tp 2 x dp 2: the streams equal the
  meshless engine's, each rank runs ``n / dp`` of a call's rows, one
  all-gather over dp of the landed rows a call, and the ``paged-gang``
  audit agrees;
- the quantized checkpoint cache under a mesh: each rank's shard read
  from the cache equals ``shard_params`` of the meshless tree byte for
  byte without the host quantizer, and a cache the reference wrote
  serves a tp 2 load.

One mesh is up at a time (``_mesh`` shuts the previous one down), each
with its rendezvous under a temporary directory and a 60 s timeout.
"""
import dataclasses
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference.engine import InferenceEngine as JSlot
from skypilot_tpu.inference.paged import PagedInferenceEngine as JPaged
from skypilot_tpu.models import configs as jconfigs
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import weights as jweights
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu_torch.analysis import audit
from skypilot_tpu_torch.inference import paged as paged_mod
from skypilot_tpu_torch.inference.engine import InferenceEngine
from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
from skypilot_tpu_torch.models import configs, llama, quantization, synth
from skypilot_tpu_torch.models import weights
from skypilot_tpu_torch.models.convert import params_from_numpy
from skypilot_tpu_torch.parallel import mesh as mesh_lib

jax.config.update('jax_platforms', 'cpu')

PROMPTS = ([1, 2, 3] * 9, [4, 5] * 10, [7] * 21)
JCFG = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(configs.TINY, dtype=torch.float32)
J63 = dataclasses.replace(JCFG, n_heads=6, n_kv_heads=3,
                          head_dim_override=16)
T63 = dataclasses.replace(TCFG, n_heads=6, n_kv_heads=3,
                          head_dim_override=16)
KINDS = {'paged': (PagedInferenceEngine, JPaged),
         'slot': (InferenceEngine, JSlot)}
KW = dict(max_batch=4, max_seq=128, prefill_chunk_tokens=16)

_state = {'shape': None, 'mesh': None, 'dir': None}


def _shutdown():
    if _state['mesh'] is not None:
        _state['mesh'].shutdown()
        shutil.rmtree(_state['dir'], ignore_errors=True)
    _state.update(shape=None, mesh=None, dir=None)


def _mesh(tp, dp=1):
    """The (tp, dp) mesh, built once and kept until another shape is
    asked for (one process group per process)."""
    if _state['shape'] != (tp, dp):
        _shutdown()
        d = tempfile.mkdtemp(prefix='skytpu-gaps-')
        _state.update(shape=(tp, dp), dir=d, mesh=mesh_lib.serving_mesh(
            tp=tp, dp=dp, device='cpu', timeout_s=60.0, store_dir=d))
    return _state['mesh']


@pytest.fixture(scope='module', autouse=True)
def _meshes():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    _shutdown()
    torch.set_num_threads(n)


def _params(jcfg, tcfg):
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.device_get(jp), tcfg, device='cpu')


def _run(cls, cfg, params, *, mesh=None, prompts=PROMPTS, gen=8, **kw):
    eng = cls(cfg, params, device='cpu', mesh=mesh, **dict(KW, **kw))
    rids = [eng.add_request(list(p), max_new_tokens=gen) for p in prompts]
    done = eng.run_to_completion(horizon=8)
    return [done[r].output for r in rids], eng


def _ref(kind, jcfg, jp, **kw):
    extra = {'decode_impl': 'gather'} if kind == 'paged' else {}
    eng = KINDS[kind][1](jcfg, jax.tree.map(lambda x: x, jp),
                         attn_impl='xla', **dict(KW, **extra, **kw))
    rids = [eng.add_request(list(p), max_new_tokens=8) for p in PROMPTS]
    done = eng.run_to_completion(horizon=8)
    return [done[r].output for r in rids]


# ------------------------------------------------ replicated kv heads
CASES = [('paged', 'gather'), ('paged', 'pallas'), ('paged', 'cross_layer'),
         ('slot', None)]


@pytest.mark.parametrize('kind,impl', CASES)
def test_unaligned_6q_3kv_at_tp2(kind, impl):
    """Rank 1's q heads 3, 4, 5 read kv heads 1, 2, 2: the streams equal
    the meshless engine's and the reference's on every decode path."""
    jp, tp = _params(J63, T63)
    extra = {} if impl is None else {'decode_impl': impl}
    want = _ref(kind, J63, jp)
    meshless, _ = _run(KINDS[kind][0], T63, tp, **extra)
    got, eng = _run(KINDS[kind][0], T63, tp, mesh=_mesh(2), **extra)
    assert eng.kv_pool_stats()['kv_shards'] == 1
    assert eng.shard_cfg.n_kv_heads == 3
    eng.close()
    assert meshless == want
    assert got == meshless


def test_replicated_kv_layouts_of_both_ranks():
    spec = mesh_lib.MeshSpec.for_serving(tp=2)
    assert mesh_lib.kv_head_layout(T63, spec, tp_rank=0) == ((0, 1, 2), 6)
    assert mesh_lib.kv_head_layout(T63, spec, tp_rank=1) == ((2, 4, 5), 6)
    # The aligned 64 q / 8 kv at tp 16: each rank's 4 q heads read one
    # kv head, a group of 4 over the 8 kv heads.
    big = dataclasses.replace(T63, n_heads=64, n_kv_heads=8)
    sixteen = mesh_lib.MeshSpec.for_serving(tp=16)
    assert mesh_lib.kv_head_layout(big, sixteen, tp_rank=5) == \
        ((8, 9, 10, 11), 32)
    # The kv heads split, or one kv head: no layout.
    assert mesh_lib.kv_head_layout(TCFG, spec, tp_rank=1) is None
    assert mesh_lib.kv_head_layout(
        dataclasses.replace(TCFG, n_kv_heads=1), spec, tp_rank=1) is None


def test_replicated_pool_counts_equal_the_reference():
    """One kv shard: the pool stats of the 6/3 engine at tp 2 equal the
    reference's tp 2 engine's (its kv heads replicated by ``spec_for``)."""
    jp, tp = _params(J63, T63)
    jeng = JPaged(J63, jp, attn_impl='xla', mesh=jmesh.serving_mesh(tp=2),
                  **KW)
    jeng.add_request([1, 2, 3], max_new_tokens=2)
    jeng.run_to_completion()
    _, eng = _run(PagedInferenceEngine, T63, tp, mesh=_mesh(2), gen=2,
                  prompts=([1, 2, 3],))
    got, want = eng.kv_pool_stats(), jeng.kv_pool_stats()
    eng.close()
    assert got == want
    assert got['kv_token_bytes_per_shard'] == got['kv_token_bytes']


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_replicated_kv_heads_with_int8_kv(kind):
    _, tp = _params(J63, T63)
    cls = KINDS[kind][0]
    want, _ = _run(cls, T63, tp, kv_cache_dtype='int8')
    got, eng = _run(cls, T63, tp, mesh=_mesh(2), kv_cache_dtype='int8')
    assert eng.kv_pool_stats()['kv_shards'] == 1
    eng.close()
    assert got == want


def test_replicated_pool_handoff_tp2_to_tp1_is_byte_identical():
    """A snapshot of the replicated pool exported at tp 2 carries each
    kv head once (the meshless layout); landed at tp 1 and exported
    again, the SKKV blob is the same bytes, and the continuation equals
    the exporting engine's own."""
    from skypilot_tpu_torch.inference import kv_transfer
    _, tp = _params(J63, T63)
    kw = dict(max_batch=2, max_seq=64, prefill_chunk_tokens=16,
              device='cpu')
    src = PagedInferenceEngine(T63, tp, mesh=_mesh(2), **kw)
    dst = PagedInferenceEngine(T63, tp, **kw)
    rid = src.add_request([5, 9, 2, 7] * 5, max_new_tokens=12)
    for _ in range(3):
        src.step(horizon=1)
    src.drain_pipeline()
    snap, _ = src.export_kv_snapshot(rid)
    assert np.shape(snap['k'])[2] == 3                   # whole kv heads
    blob = kv_transfer.encode_handoff(snap)
    own = src.run_to_completion(horizon=4)[rid].output
    sent = kv_transfer.decode_handoff(blob)
    new = dst.ingest_kv_snapshot(sent)
    again, _ = dst.export_kv_snapshot(new)
    assert kv_transfer.encode_handoff(again) == blob
    cont = dst.run_to_completion(horizon=4)[new].output
    src.close()
    assert cont == own


@pytest.mark.parametrize('kind,impl', CASES)
def test_aligned_tiny_4q_2kv_at_tp4(kind, impl):
    """TINY at tp 4: each rank keeps one q head and both kv heads; the
    streams equal the meshless engine's and the reference's."""
    jp, tp = _params(JCFG, TCFG)
    extra = {} if impl is None else {'decode_impl': impl}
    want = _ref(kind, JCFG, jp)
    meshless, _ = _run(KINDS[kind][0], TCFG, tp, **extra)
    got, eng = _run(KINDS[kind][0], TCFG, tp, mesh=_mesh(4), **extra)
    assert eng.kv_pool_stats()['kv_shards'] == 1
    assert (eng.shard_cfg.n_heads, eng.shard_cfg.n_kv_heads) == (1, 2)
    eng.close()
    assert meshless == want
    assert got == meshless


# ------------------------------------------------- dp-split prefill
def _prefill_spy(monkeypatch, seen):
    orig_paged = paged_mod.paged_prefill_chunk
    orig_rows = llama.prefill_rows

    def paged_spy(*args, dp_rows=None, **kw):
        n = args[3].shape[0]
        seen.append((n, None if dp_rows is None
                     else dp_rows.stop - dp_rows.start))
        return orig_paged(*args, dp_rows=dp_rows, **kw)

    def rows_spy(*args, dp_rows=None, **kw):
        if not kw.get('all_logits'):
            n = args[1].shape[0]
            seen.append((n, None if dp_rows is None
                         else dp_rows.stop - dp_rows.start))
        return orig_rows(*args, dp_rows=dp_rows, **kw)

    monkeypatch.setattr(paged_mod, 'paged_prefill_chunk', paged_spy)
    monkeypatch.setattr(llama, 'prefill_rows', rows_spy)


@pytest.mark.parametrize('tp,dp', [(1, 2), (2, 2)])
@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_dp_split_prefill(kind, tp, dp, monkeypatch):
    """The prefill rows split over dp: the streams equal the meshless
    engine's, each of rank 0's prefill calls of four rows runs two, and
    each such call issues one all-gather over dp (of the landed rows
    and last hidden states, packed), as ``expected_prefill_census``
    says."""
    _, tp_params = _params(JCFG, TCFG)
    cls = KINDS[kind][0]
    prompts = PROMPTS + ([9, 8] * 11,)
    meshless, _ = _run(cls, TCFG, tp_params, prompts=prompts)
    seen = []
    _prefill_spy(monkeypatch, seen)
    census = {}
    before = dict(mesh_lib.collective_counts)
    got, eng = _run(cls, TCFG, tp_params, mesh=_mesh(tp, dp),
                    prompts=prompts)
    monkeypatch.undo()
    for k, n in mesh_lib.collective_counts.items():
        census[k] = n - before.get(k, 0)
    split = [(n, local) for n, local in seen if local is not None]
    assert split and all(local == n // dp for n, local in split)
    assert all(n == KW['max_batch'] for n, _ in split)
    assert all(n % dp for n, local in seen if local is None)
    want = audit.expected_prefill_census(eng, KW['max_batch'])
    assert want['all_gather[dp]'] == 1
    state = eng.state_by_rank()
    eng.close()
    assert got == meshless
    # The dp replicas of each tp shard hold the same KV.
    for r in range(tp):
        assert len({state[d * tp + r]['kv'] for d in range(dp)}) == 1


def test_paged_gang_audit_counts_the_prefill_gather():
    """The ``paged-gang`` preset (tp 2 x dp 2) records a prefill call's
    census beside the decode step's and the merge's; it equals the
    expected one (one all-gather over dp of the landed rows) and the
    audit passes."""
    _shutdown()
    report = audit.run_preset('paged-gang', device='cpu')
    assert 'prefill' in report.collectives
    assert report.collectives['prefill'] == \
        report.expected_collectives['prefill']
    assert report.collectives['prefill']['all_gather[dp]'] == 1
    assert report.collective_violations() == []
    assert report.ok(), report.violations()


# ----------------------------------------- the quantized cache per shard
def _shard_bytes(tree):
    out = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
            return
        parts = list(node) if isinstance(
            node, quantization.QUANT_LEAF_TYPES) else [node]
        out['/'.join(path)] = [(p.dtype, tuple(p.shape),
                                p.contiguous().view(-1).view(torch.uint8)
                                .numpy().tobytes()) for p in parts]
    walk((), tree)
    return out


def _no_quantizer(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError('the host quantizer ran')
    monkeypatch.setattr(quantization, 'quantize_slice', refuse)
    monkeypatch.setattr(quantization, 'quantize_array', refuse)


@pytest.mark.parametrize('quant', ['int8', 'int4'])
def test_mesh_load_reads_its_shard_from_the_cache(quant, tmp_path,
                                                  monkeypatch):
    """A meshless load writes the cache; at tp 2 each rank then maps it
    and cuts its shard, equal to ``shard_params`` of the meshless tree
    byte for byte, with the host quantizer never called."""
    cfg = configs.TINY
    path = synth.write_synthetic_hf_checkpoint(
        str(tmp_path / 'ckpt'), cfg, unique_layers=True, dtype=np.float32)
    _, full = weights.load_checkpoint(path, quantize=quant, device='cpu')
    assert os.path.exists(os.path.join(path, f'.{quant}_cache.bin'))
    _no_quantizer(monkeypatch)
    spec = mesh_lib.MeshSpec.for_serving(tp=2)
    for rank in range(2):
        def cut(c, rank=rank):
            return mesh_lib.leaf_cutter(llama.param_logical_axes(c), spec,
                                        rank=rank)
        got_cfg, shard = weights.load_checkpoint(path, quantize=quant,
                                                 device='cpu', cut=cut)
        want = mesh_lib.shard_params(full, llama.param_logical_axes(got_cfg),
                                     spec, rank=rank)
        assert _shard_bytes(shard) == _shard_bytes(want)


def test_reference_cache_serves_a_tp2_load(tmp_path, monkeypatch):
    """A cache the reference wrote (``load_checkpoint`` of the JAX
    package) serves a tp 2 engine of the port: the shards come from it
    with no requantization, and the fp32 streams equal a meshless
    engine's on the same cache."""
    cfg = configs.TINY
    path = synth.write_synthetic_hf_checkpoint(
        str(tmp_path / 'ckpt'), cfg, unique_layers=True, dtype=np.float32)
    jweights.load_checkpoint(path, dtype=jnp.float32, quantize='int8')
    assert os.path.exists(os.path.join(path, '.int8_cache.bin'))
    _no_quantizer(monkeypatch)
    spec = mesh_lib.MeshSpec.for_serving(tp=2)
    _, whole = weights.load_checkpoint(path, dtype=torch.float32,
                                       quantize='int8', device='cpu')
    for rank in range(2):
        _, shard = weights.load_checkpoint(
            path, dtype=torch.float32, quantize='int8', device='cpu',
            cut=lambda c, rank=rank: mesh_lib.leaf_cutter(
                llama.param_logical_axes(c), spec, rank=rank))
        assert _shard_bytes(shard) == _shard_bytes(mesh_lib.shard_params(
            whole, llama.param_logical_axes(configs.TINY), spec, rank=rank))
    monkeypatch.undo()
    outs = []
    for m in (None, _mesh(2)):
        eng = PagedInferenceEngine.from_pretrained(
            path, dtype=torch.float32, quantize='int8', max_batch=2,
            max_seq=64, prefill_chunk_tokens=16, device='cpu', mesh=m)
        rid = eng.add_request([1, 2, 3, 4, 5], max_new_tokens=6)
        outs.append(eng.run_to_completion(horizon=4)[rid].output)
        eng.close()
    assert outs[0] == outs[1]
