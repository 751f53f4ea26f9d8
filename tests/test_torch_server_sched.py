"""The port's serving front (``skypilot_tpu_torch/serve/server.py`` over
the SLO scheduler) against the reference's ``ModelServer`` on the CPU,
after ``tests/test_scheduler.py``, ``tests/test_telemetry.py`` and
``tests/test_graceful_drain.py``.

Two tiny servers (fp32 TINY, the same weights, the paged engine) get the
same traffic. Then:

- ``/metrics?format=json``: the same keys, nested blocks included (the
  port's own keys, listed below, aside);
- ``/metrics``: Prometheus text with the same families, types and label
  sets (values differ by timing; the families of modules not ported yet
  are listed below);
- ``/generate`` (streamed and not), ``/v1/completions`` and
  ``/v1/chat/completions``: the same greedy tokens;
- the same overflow sheds with a 429 and the same ``Retry-After`` and
  payload; an unknown tier is a 400;
- a drain: 503 + ``Retry-After`` for new work, ``draining`` readiness,
  the request in flight finished, the checkpoint written;
- request-key replay, ``/debug/requests``, ``/telemetry/summary``,
  ``/v1/models`` and the ``X-Skytpu-Trace`` context;
- ``audit_telemetry_parity`` on both engines.
"""
import contextlib
import dataclasses
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from skypilot_tpu.inference import kv_transfer as jkt
from skypilot_tpu.models import configs as jconfigs
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.serve import server as jserver
from skypilot_tpu.telemetry import registry as jreg
from skypilot_tpu.telemetry import tracing as jtrace
from skypilot_tpu_torch.analysis import audit
from skypilot_tpu_torch.inference import kv_transfer as tkt
from skypilot_tpu_torch.models import configs as tconfigs
from skypilot_tpu_torch.models.convert import params_from_numpy
from skypilot_tpu_torch.serve import scheduler as tsched
from skypilot_tpu_torch.serve import server as tserver
from skypilot_tpu_torch.telemetry import registry as treg
from skypilot_tpu_torch.telemetry import tracing as ttrace

jax.config.update('jax_platforms', 'cpu')

JCFG = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(tconfigs.TINY, dtype=torch.float32)
SERVER_KW = dict(max_batch=2, max_seq=128, page_size=8)

# Keys of the port's JSON block that the reference's lacks: the cache
# kind, the decode attention path, the kernels' launch counts, the
# decode graphs and the device.
PORT_ONLY_KEYS = {'kv_cache', 'decode_impl', 'decode_kernel_launches',
                  'prefill_kernel_launches', 'prefill_calls',
                  'decode_substeps', 'decode_calls', 'graph_captures',
                  'graph_replays', 'graph_capture_s', 'device'}
# The gang series (serve/gang.py) register on every server, gang or not.
GANG_FAMILIES = {
    'skytpu_gang_size', 'skytpu_gang_join_seconds',
    'skytpu_gang_failures_total', 'skytpu_gang_heartbeat_age_seconds'}

PROMPTS = [[(i * 7 + 3) % 256 for i in range(37)], [5, 6, 7, 8] * 6,
           [9, 4] * 20]


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def weights():
    host = jax.device_get(jllama.init_params(jax.random.PRNGKey(0), JCFG))
    return params_from_numpy(host, TCFG, device='cpu')


@contextlib.contextmanager
def _servers(weights, **kw):
    """A reference server (its 'tiny' preset in fp32: the reference
    draws its random weights from PRNGKey(0), the port's are the same
    weights carried over) and a port server, both ready."""
    mp = pytest.MonkeyPatch()
    orig = jconfigs.get_config
    mp.setattr(jconfigs, 'get_config',
               lambda name: JCFG if name == 'tiny' else orig(name))
    jreg.reset_registry()
    treg.reset_registry()
    jtrace.get_trace_buffer().clear()
    ttrace.get_trace_buffer().clear()
    j = jserver.ModelServer('tiny', port=_free_port(), **SERVER_KW,
                            **kw)
    t = tserver.ModelServer(TCFG, params=weights, port=_free_port(),
                            device='cpu', **SERVER_KW, **kw)
    try:
        j.start(block=False)
        t.start(block=False)
        assert j._ready.wait(300)
        t.wait_ready(timeout=300)
        yield {'jax': j, 'torch': t}
    finally:
        j.stop()
        t.stop()
        mp.undo()


def _req(srv, path, body=None, headers=None, timeout=120):
    """(status, headers, body bytes) of one request to ``srv``."""
    url = f'http://127.0.0.1:{srv.port}{path}'
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    h = {'Content-Type': 'application/json', **(headers or {})}
    req = urllib.request.Request(url, data=data, headers=h)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _sse(raw):
    return [json.loads(line[5:]) for line in raw.decode().split('\n')
            if line.startswith('data:') and line[5:].strip() != '[DONE]']


def _traffic(srv):
    """The same requests on either server; their parsed answers."""
    out = []
    for i, p in enumerate(PROMPTS):
        _, _, body = _req(srv, '/generate',
                          {'prompt': p, 'max_new_tokens': 10,
                           'slo_tier': ('latency', 'throughput')[i % 2]})
        out.append(json.loads(body)['tokens'])
    _, _, raw = _req(srv, '/generate', {'prompt': PROMPTS[0],
                                        'max_new_tokens': 10,
                                        'stream': True})
    out.append(_sse(raw)[-1]['tokens'])
    _, _, body = _req(srv, '/v1/completions',
                      {'prompt': PROMPTS[1], 'max_tokens': 8,
                       'eos_id': None},
                      headers={'X-SLO-Tier': 'throughput'})
    body = json.loads(body)
    out.append((body['object'], body['choices'][0]['text'],
                body['usage']))
    _, _, body = _req(srv, '/v1/chat/completions',
                      {'messages': [{'role': 'user', 'content': 'hi'}],
                       'max_tokens': 8, 'eos_id': None})
    body = json.loads(body)
    out.append((body['object'], body['choices'][0]['message'],
                body['choices'][0]['finish_reason'], body['usage']))
    _, _, raw = _req(srv, '/v1/chat/completions',
                     {'messages': [{'role': 'user', 'content': 'hi'}],
                      'max_tokens': 8, 'eos_id': None, 'stream': True})
    chunks = _sse(raw)
    out.append([c['choices'][0]['delta'] for c in chunks])
    return out


@pytest.fixture(scope='module')
def pair(weights):
    with _servers(weights) as servers:
        answers = {k: _traffic(s) for k, s in servers.items()}
        yield servers, answers


def test_same_greedy_tokens_on_every_route(pair):
    _, answers = pair
    assert answers['torch'] == answers['jax']
    assert all(len(toks) == 10 for toks in answers['torch'][:4])


def _keys(obj, prefix=''):
    """Every key path of a nested JSON object (lists not entered)."""
    out = set()
    for k, v in obj.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ('pinned',):
            out |= _keys(v, prefix + k + '.')
    return out


def test_json_metrics_key_sets_equal(pair):
    servers, _ = pair
    j = json.loads(_req(servers['jax'], '/metrics?format=json')[2])
    t = json.loads(_req(servers['torch'], '/metrics?format=json')[2])
    assert PORT_ONLY_KEYS <= set(t)
    t_shared = {k: v for k, v in t.items() if k not in PORT_ONLY_KEYS}
    assert _keys(t_shared) == _keys(j)
    assert t['sched']['tiers']['latency']['admitted'] == \
        j['sched']['tiers']['latency']['admitted'] > 0
    assert t['requests_served'] == j['requests_served'] == 7
    assert t['mesh'] == j['mesh']
    assert t['disagg']['role'] == j['disagg']['role'] == 'colocated'


def _families(text):
    """{family: (type, sorted label sets)} of a Prometheus text body;
    histogram samples fold into their family, ``le`` dropped."""
    types, labels = {}, {}
    for line in text.splitlines():
        if line.startswith('# TYPE '):
            _, _, name, kind = line.split()
            types[name] = kind
            labels.setdefault(name, set())
        elif line and not line.startswith('#'):
            sample = line.rsplit(' ', 1)[0]
            name, _, lab = sample.partition('{')
            for suffix in ('_bucket', '_sum', '_count'):
                if name.endswith(suffix) and name[:-len(suffix)] in types \
                        and types[name[:-len(suffix)]] == 'histogram':
                    name = name[:-len(suffix)]
            pairs = tuple(sorted(p for p in lab.rstrip('}').split(',')
                                 if p and not p.startswith('le=')))
            labels.setdefault(name, set()).add(pairs)
    return {n: (types.get(n), sorted(labels[n])) for n in labels}


def test_prometheus_families_and_labels_equal(pair):
    servers, _ = pair
    status, headers, jbody = _req(servers['jax'], '/metrics')
    tstatus, theaders, tbody = _req(servers['torch'], '/metrics')
    assert status == tstatus == 200
    assert theaders['Content-Type'] == headers['Content-Type'] == \
        'text/plain; version=0.0.4; charset=utf-8'
    j = _families(jbody.decode())
    t = _families(tbody.decode())
    assert GANG_FAMILIES <= set(j)
    assert set(t) == set(j)
    for name in j:
        assert t[name] == j[name], name
    assert 'skytpu_sched_shed_total' in t
    assert ('phase="decode_enqueue"',) in t[
        'skytpu_engine_step_phase_seconds'][1]


def _cold(srv):
    """A fresh throughput meter: the Retry-After then comes from the
    cold-meter rule on both servers (it is otherwise a measured rate)."""
    srv.sched._rate = type(srv.sched._rate)()


def test_same_overflow_sheds_429_with_retry_after(pair):
    servers, _ = pair
    seen = {}
    for name, srv in servers.items():
        srv.sched._max_queue_tokens = 4     # prompt + budget > 4 sheds
        _cold(srv)
        try:
            a = _req(srv, '/generate', {'prompt': [1, 2, 3, 4],
                                        'max_new_tokens': 8})
            b = _req(srv, '/generate', {'prompt': [1, 2, 3, 4],
                                        'max_new_tokens': 8},
                     headers={'X-SLO-Tier': 'throughput'})
            c = _req(srv, '/v1/completions', {'prompt': [1, 2, 3, 4],
                                              'max_tokens': 8})
        finally:
            srv.sched._max_queue_tokens = 10_000
        seen[name] = [(s, h['Retry-After'], json.loads(body))
                      for s, h, body in (a, b, c)]
    assert seen['torch'] == seen['jax']
    for status, retry, body in seen['torch']:
        assert status == 429 and int(retry) >= 1
        assert body['error']['reason'] == 'queue_full'
        assert body['error']['retry_after_s'] == int(retry)
    assert seen['torch'][1][2]['error']['tier'] == 'throughput'
    j = json.loads(_req(servers['jax'], '/metrics?format=json')[2])
    t = json.loads(_req(servers['torch'], '/metrics?format=json')[2])
    for tier in ('latency', 'throughput'):
        assert t['sched']['tiers'][tier]['shed_total'] == \
            j['sched']['tiers'][tier]['shed_total'] >= 1


@pytest.mark.parametrize('where', ['body', 'header', 'completions'])
def test_unknown_tier_is_400(pair, where):
    servers, _ = pair
    seen = {}
    for name, srv in servers.items():
        if where == 'body':
            r = _req(srv, '/generate', {'prompt': [1, 2],
                                        'max_new_tokens': 2,
                                        'slo_tier': 'platinum'})
        elif where == 'header':
            r = _req(srv, '/generate', {'prompt': [1, 2],
                                        'max_new_tokens': 2},
                     headers={'X-SLO-Tier': 'platinum'})
        else:
            r = _req(srv, '/v1/completions', {'prompt': [1, 2],
                                              'max_tokens': 2,
                                              'slo_tier': 'platinum'})
        seen[name] = (r[0], json.loads(r[2]))
    assert seen['torch'] == seen['jax']
    assert seen['torch'][0] == 400
    assert 'unknown SLO tier' in json.dumps(seen['torch'][1])


@pytest.mark.parametrize('stream', [False, True])
def test_request_key_replays_the_first_answer(pair, stream):
    servers, _ = pair
    answers = {}
    for name, srv in servers.items():
        body = {'prompt': PROMPTS[2], 'max_new_tokens': 6,
                'request_key': f'k-{stream}', 'stream': stream}
        first = _req(srv, '/generate', body)[2]
        again = _req(srv, '/generate', body)[2]
        served = json.loads(_req(srv, '/metrics?format=json')[2])[
            'requests_served']
        if stream:
            first, again = _sse(first), _sse(again)
            assert again[-1]['deduped'] is True
            assert [e['token'] for e in again[:-1]] == \
                [e['token'] for e in first[:-1]]
            answers[name] = (first[-1]['tokens'], sorted(again[-1]))
        else:
            first, again = json.loads(first), json.loads(again)
            assert again == dict(first, deduped=True)
            answers[name] = (first['tokens'], sorted(again))
        # The replay ran nothing: a third send leaves the count.
        _req(srv, '/generate', body)
        assert json.loads(_req(srv, '/metrics?format=json')[2])[
            'requests_served'] == served
    assert answers['torch'] == answers['jax']


def test_debug_requests_and_trace_context(pair):
    servers, _ = pair
    views = {}
    tid = 'ef' * 16
    for name, srv in servers.items():
        _req(srv, '/generate', {'prompt': PROMPTS[1],
                                'max_new_tokens': 4},
             headers={'X-Skytpu-Trace': f'{tid};lb-hop'})
        body = json.loads(_req(srv, '/debug/requests?limit=3')[2])
        reqs = body['requests']
        assert len(reqs) == 3
        newest = reqs[0]
        assert newest['trace_id'] == tid
        assert newest['parent_span'] == 'lb-hop'
        assert newest['done'] is True
        bad = json.loads(_req(srv, '/debug/requests?limit=x')[2])
        views[name] = (sorted(newest), [s['name'] for s in newest['spans']],
                       sorted(newest['spans'][0]), newest['meta'],
                       len(bad['requests']) > 3)
    assert views['torch'] == views['jax']


def test_telemetry_summary_and_models(pair):
    servers, _ = pair
    seen = {}
    for name, srv in servers.items():
        body = json.loads(_req(srv, '/telemetry/summary?since=0')[2])
        again = json.loads(_req(
            srv, f'/telemetry/summary?since={body["cursor"]}')[2])
        models = json.loads(_req(srv, '/v1/models')[2])
        seen[name] = (sorted(body), sorted(body['clock']),
                      len(body['traces']) > 0, again['traces'], models,
                      _req(srv, '/no/such/route')[0])
    assert seen['torch'] == seen['jax']
    assert seen['torch'][3] == []


def test_drain_finishes_inflight_refuses_new_and_checkpoints(weights,
                                                             tmp_path):
    seen = {}
    with _servers(weights) as servers:
        for name, srv in servers.items():
            ckpt = str(tmp_path / f'{name}.ckpt')
            srv.checkpoint_path = ckpt
            # A prefix to checkpoint, then a long request in flight.
            _req(srv, '/generate', {'prompt': PROMPTS[0] * 2,
                                    'max_new_tokens': 4})
            box = {}
            th = threading.Thread(target=lambda: box.update(r=_req(
                srv, '/generate', {'prompt': PROMPTS[1],
                                   'max_new_tokens': 60})))
            th.start()
            deadline = time.monotonic() + 60
            while not srv.engine.num_active and \
                    time.monotonic() < deadline:
                time.sleep(0.005)
            d = json.loads(_req(srv, '/drain', {'deadline_s': 60})[2])
            shed = _req(srv, '/generate', {'prompt': [1, 2],
                                           'max_new_tokens': 2})
            ready = _req(srv, '/readiness')
            th.join(120)
            status = json.loads(_req(srv, '/drain')[2])
            deadline = time.monotonic() + 30
            while not status['drained'] and time.monotonic() < deadline:
                time.sleep(0.05)
                status = json.loads(_req(srv, '/drain')[2])
            while not os.path.exists(ckpt) and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            codec = jkt if name == 'jax' else tkt
            with open(ckpt, 'rb') as f:
                entries = codec.decode_checkpoint(f.read())
            seen[name] = (
                sorted(d), d['draining'], shed[0], shed[1]['Retry-After'],
                json.loads(shed[2]), ready[0],
                json.loads(ready[2])['status'],
                len(json.loads(box['r'][2])['tokens']),
                status['drained'], status['inflight'], len(entries) > 0)
    assert seen['torch'] == seen['jax']
    assert seen['torch'][2] == 503 and seen['torch'][3] == '5'
    assert seen['torch'][6] == 'draining' and seen['torch'][7] == 60


@pytest.mark.parametrize('kind', ['paged', 'slot'])
def test_audit_telemetry_parity_on_cpu(kind):
    report = audit.audit_telemetry_parity(kind, device='cpu')
    assert report.ok(), report.violations()
    assert report.streams_equal is True
    assert report.dispatches > 0


def test_port_server_cli_flags(monkeypatch):
    """The scheduler, drain and role flags reach the port's server."""
    seen = {}

    class _Fake:
        def __init__(self, *a, **kw):
            seen.update(kw)

        def start(self, block):
            seen['block'] = block
    monkeypatch.setattr(tserver, 'ModelServer', _Fake)
    monkeypatch.setattr('sys.argv', [
        'server', '--device', 'cpu', '--slo-tier-default', 'throughput',
        '--max-queue-tokens', '4096', '--latency-admit-frac', '0.5',
        '--drain-deadline-s', '12', '--role', 'prefill',
        '--handoff-targets', 'http://a:1,http://b:2'])
    tserver.main()
    assert (seen['slo_tier_default'], seen['max_queue_tokens'],
            seen['latency_admit_frac'], seen['drain_deadline_s'],
            seen['role'], seen['handoff_targets']) == (
        'throughput', 4096, 0.5, 12.0, 'prefill',
        ['http://a:1', 'http://b:2'])
    assert not hasattr(tserver, '_RETRY_AFTER_S')
    assert tsched.TIERS == ('latency', 'throughput')


@pytest.mark.parametrize('kv_cache', ['paged', 'slot'])
def test_stop_frees_the_engine_without_a_collection(weights, kv_cache):
    """After ``stop()`` nothing of the server holds the engine (the
    scheduler's reference included), so its weights, pool and graphs
    are freed at once, with no garbage collection: on one card the next
    server's pool is sized from the memory this one frees."""
    import gc
    import weakref
    srv = tserver.ModelServer(TCFG, params=weights, port=_free_port(),
                              device='cpu', kv_cache=kv_cache,
                              max_batch=2, max_seq=128)
    srv.start(block=False)
    srv.wait_ready(timeout=300)
    _req(srv, '/generate', {'prompt': PROMPTS[0], 'max_new_tokens': 4})
    ref = weakref.ref(srv.engine)
    gc.disable()
    try:
        srv.stop()
        assert ref() is None
    finally:
        gc.enable()


def _adapter_dir(tmp_path, names=('a1', 'a2', 'a3')):
    """Rank-4 adapters written by the reference's ``save_adapter``."""
    import numpy as np
    from skypilot_tpu.models import multilora as jml
    rng = np.random.default_rng(0)
    for name in names:
        tree = {}
        for t in jml.default_targets(JCFG):
            a_shape, b_shape = jml.target_shapes(JCFG, t, 4)
            tree[t] = {'a': rng.normal(0, 0.3, (JCFG.n_layers,) + a_shape
                                       ).astype(np.float32),
                       'b': rng.normal(0, 0.3, (JCFG.n_layers,) + b_shape
                                       ).astype(np.float32)}
        jml.save_adapter(str(tmp_path / f'{name}.npz'), JCFG, tree,
                         scale=2.0)
    return str(tmp_path)


def _lora_traffic(srv):
    """Base, adapter, ``base:adapter``, grammar and response_format
    requests, an unknown adapter and a third adapter (an eviction);
    (status, tokens or error) per request and the ``lora`` block."""
    out = []
    for extra in ({}, {'adapter': 'a1'}, {'model': 'tiny:a2'},
                  {'grammar': [5, 9, 17]}, {'adapter': 'a1',
                                            'grammar': 'json'},
                  {'adapter': 'zz'}, {'adapter': '../x'},
                  {'adapter': 'a3', 'stream': True}):
        status, _, body = _req(srv, '/generate',
                               dict({'prompt': PROMPTS[1],
                                     'max_new_tokens': 8}, **extra))
        if extra.get('stream'):
            out.append((status, _sse(body)[-1]['tokens']))
        else:
            body = json.loads(body)
            out.append((status, body.get('tokens', body.get('error'))))
    status, _, body = _req(srv, '/v1/completions',
                           {'prompt': PROMPTS[2], 'max_tokens': 8,
                            'eos_id': None, 'model': 'tiny:a1',
                            'response_format': {'type': 'json_object'}})
    body = json.loads(body)
    out.append((status, body['choices'][0]['text'], body['model']))
    lora = json.loads(_req(srv, '/metrics?format=json')[2])['lora']
    return out, lora


def test_adapters_and_grammar_served_like_reference(weights, tmp_path):
    """A bank of two slots on both servers: every adapter spelling, the
    grammar and response_format, an unknown and an illegal adapter, and
    a third adapter that evicts: the same statuses, tokens and errors,
    and the same ``lora`` block (its load time aside)."""
    d = _adapter_dir(tmp_path)
    with _servers(weights, adapter_slots=2, adapter_dir=d,
                  adapter_rank=4) as servers:
        got = {k: _lora_traffic(s) for k, s in servers.items()}
    (t_out, t_lora), (j_out, j_lora) = got['torch'], got['jax']
    assert t_out == j_out
    assert [s for s, _ in t_out[:5]] == [200] * 5
    assert t_out[0][1] != t_out[1][1] != t_out[2][1]
    assert set(t_out[3][1]) <= {5, 9, 17}
    assert t_out[5][0] == 500 and 'unknown adapter' in t_out[5][1]
    assert 'illegal adapter name' in t_out[6][1]
    assert t_lora.pop('last_load_ms') > 0 and j_lora.pop('last_load_ms') > 0
    assert t_lora == j_lora
    assert (t_lora['loads_total'], t_lora['evictions_total']) == (3, 1)
    assert t_lora['loaded'] == ['a3', 'a1']


def test_full_bank_defers_instead_of_failing(weights, tmp_path):
    """One bank slot, two concurrent requests naming different adapters:
    the second waits in the scheduler while the first holds the slot,
    then runs; both answers equal the requests served one at a time."""
    d = _adapter_dir(tmp_path, ('a1', 'a2'))
    body = {'prompt': PROMPTS[0], 'max_new_tokens': 24}
    with _servers(weights, adapter_slots=1, adapter_dir=d,
                  adapter_rank=4) as servers:
        srv = servers['torch']
        alone = [json.loads(_req(srv, '/generate',
                                 dict(body, adapter=a))[2])['tokens']
                 for a in ('a1', 'a2')]
        results = {}

        def go(a):
            results[a] = _req(srv, '/generate', dict(body, adapter=a))

        threads = [threading.Thread(target=go, args=(a,))
                   for a in ('a1', 'a2')]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        lora = json.loads(_req(srv, '/metrics?format=json')[2])['lora']
    for i, a in enumerate(('a1', 'a2')):
        status, _, raw = results[a]
        assert status == 200, raw
        assert json.loads(raw)['tokens'] == alone[i]
    assert lora['slots'] == 1 and lora['pinned'] == {}
    assert lora['evictions_total'] >= 2


def test_port_server_cli_adapter_flags(monkeypatch):
    """The multi-LoRA bank's flags reach the port's server (off by
    default)."""
    seen = {}

    class _Fake:
        def __init__(self, *a, **kw):
            seen.update(kw)

        def start(self, block):
            pass
    monkeypatch.setattr(tserver, 'ModelServer', _Fake)
    monkeypatch.delenv('SKYTPU_ADAPTER_SLOTS', raising=False)
    monkeypatch.setattr('sys.argv', ['server', '--device', 'cpu'])
    tserver.main()
    assert (seen['adapter_slots'], seen['adapter_dir'],
            seen['adapter_rank']) == (0, None, 8)
    monkeypatch.setattr('sys.argv', [
        'server', '--device', 'cpu', '--adapter-slots', '4',
        '--adapter-dir', '/adapters', '--adapter-rank', '16'])
    tserver.main()
    assert (seen['adapter_slots'], seen['adapter_dir'],
            seen['adapter_rank']) == (4, '/adapters', 16)
