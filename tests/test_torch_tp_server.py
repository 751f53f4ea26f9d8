"""The model server on a tp = 2 serving mesh (``ModelServer(tp=2)``,
``--tp``/``--dp``) and the serving mesh's failure surface, on the CPU
(gloo ranks), after the reference's ``tests/test_tp_serving.py``
``test_e2e_server_tp2_streamed_completion`` and
``test_scheduler_work_token_scaling``:

- a streamed completion equals a meshless engine's tokens, ``/metrics``
  reports ``skytpu_mesh_shape{axis="tp"} 2``, the JSON ``mesh`` block
  ``devices: 2`` and the scheduler's ``mesh_speedup`` 2, and ``stop()``
  leaves no follower process;
- an adapter request on a tp = 2 server with a bank and speculation
  equals a meshless engine's tokens, both ranks' banks equal;
- a follower killed mid-wave makes rank 0 raise within the process
  group's timeout instead of hanging;
- the command line takes ``--tp`` and ``--dp``.

Each test builds its own mesh (one per process at a time), with its
rendezvous under ``tmp_path`` and a 60 s timeout; every follower is
reaped before the test ends.
"""
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

import pytest
import torch

from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.serve.server import ModelServer


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _gone(pid):
    try:
        with open(f'/proc/{pid}/stat') as f:
            return f.read().split()[2] == 'Z'
    except FileNotFoundError:
        return True


def test_e2e_server_tp2_streamed_completion(monkeypatch, tmp_path):
    """``ModelServer(tp=2)`` serves a streamed completion over its mesh
    and reports the mesh through both /metrics formats; the tokens equal
    a meshless engine's."""
    # The server's mesh puts its rendezvous file under tmp_path.
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    port = _free_port()
    server = ModelServer('tiny', max_batch=2, max_seq=64, port=port, tp=2,
                         device='cpu')
    server.start(block=False)
    pids = []
    try:
        server.wait_ready(120)
        assert server.engine.mesh is not None
        assert server.engine.mesh_axes()['tp'] == 2
        pids = server.mesh.follower_pids()
        assert len(pids) == 1
        body = json.dumps({'prompt': [1, 2, 3], 'max_new_tokens': 6,
                           'stream': True}).encode()
        req = urllib.request.Request(
            f'http://127.0.0.1:{port}/generate', body,
            {'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert 'text/event-stream' in r.headers.get('Content-Type', '')
            events = [json.loads(ln[5:]) for ln in r
                      if ln.startswith(b'data:')]
        tokens = [e['token'] for e in events if 'token' in e]
        assert len(tokens) == 6
        assert events[-1].get('done') is True
        ref = PagedInferenceEngine(configs.TINY, max_batch=2, max_seq=64,
                                   device='cpu')
        rid = ref.add_request([1, 2, 3], max_new_tokens=6)
        assert ref.run_to_completion(horizon=4)[rid].output == tokens
        with urllib.request.urlopen(
                f'http://127.0.0.1:{port}/metrics?format=json',
                timeout=10) as r:
            payload = json.loads(r.read())
        assert payload['mesh']['tp'] == 2
        assert payload['mesh']['devices'] == 2
        assert payload['sched']['mesh_speedup'] == 2
        assert server.sched.mesh_speedup == 2
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/metrics',
                                    timeout=10) as r:
            prom = r.read().decode()
        assert 'skytpu_mesh_shape{axis="tp"} 2' in prom
    finally:
        server.stop()
    assert pids and all(_gone(p) for p in pids)


def test_server_tp2_serves_an_adapter_request_speculatively(monkeypatch,
                                                           tmp_path):
    """``ModelServer(tp=2, adapter_slots=2, adapter_dir=D,
    speculate_k=2)``: a request naming an adapter of ``D`` loads it on
    both ranks (inside the mirrored admission) and decodes in
    speculative rounds whose proposals rank 0 prepares outside the
    lock; its tokens and a base request's equal a meshless engine's
    with the same bank, and both ranks' banks are equal."""
    from skypilot_tpu_torch.models import lora, multilora
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    # fp32: tp = 2 streams equal the meshless ones (bf16 ones need not).
    cfg = dataclasses.replace(configs.TINY, dtype=torch.float32)
    lcfg = dataclasses.replace(cfg, lora_rank=4)
    gen = torch.Generator().manual_seed(5)
    tree = {t: {'a': torch.randn((cfg.n_layers,) + lora._target_shapes(
                    lcfg, t)[0], generator=gen) * 0.3,
                'b': torch.randn((cfg.n_layers,) + lora._target_shapes(
                    lcfg, t)[1], generator=gen) * 0.3}
            for t in ('wq', 'wo', 'w_up', 'w_down')}
    adapter_dir = tmp_path / 'adapters'
    adapter_dir.mkdir()
    multilora.save_adapter(str(adapter_dir / 'a1.npz'), lcfg, tree)
    kw = dict(max_batch=2, max_seq=64, adapter_slots=2, adapter_rank=4,
              adapter_dir=str(adapter_dir), speculate_k=2)
    port = _free_port()
    server = ModelServer(cfg, port=port, tp=2, device='cpu', **kw)
    server.start(block=False)
    pids = []
    prompt = [1, 2, 3, 4] * 4
    try:
        server.wait_ready(120)
        pids = server.mesh.follower_pids()
        got = {}
        for name in ('a1', None):
            body = {'prompt': prompt, 'max_new_tokens': 8}
            if name:
                body['adapter'] = name
            req = urllib.request.Request(
                f'http://127.0.0.1:{port}/generate',
                json.dumps(body).encode(),
                {'Content-Type': 'application/json'})
            with urllib.request.urlopen(req, timeout=60) as r:
                got[name] = json.loads(r.read())['tokens']
        with server._lock:
            digests = [d['bank'] for d in server.engine.state_by_rank()]
        assert server.engine.spec_metrics()['spec_rounds'] > 0
    finally:
        server.stop()
    assert pids and all(_gone(p) for p in pids)
    assert len(digests) == 2 and digests[0] == digests[1]
    ref = PagedInferenceEngine(cfg, device='cpu', **kw)
    want = {}
    for name in ('a1', None):
        rid = ref.add_request(prompt, max_new_tokens=8, adapter=name)
        want[name] = ref.run_to_completion(horizon=4)[rid].output
    assert got == want
    assert got['a1'] != got[None]


def test_follower_killed_mid_wave_raises_on_rank_0(tmp_path):
    """A follower killed while a wave is in flight: rank 0's next engine
    call raises (within the 60 s group timeout), never hangs, and the
    mesh shuts down after."""
    mesh = mesh_lib.serving_mesh(tp=2, device='cpu', timeout_s=60.0,
                                 store_dir=str(tmp_path))
    pids = mesh.follower_pids()
    try:
        eng = PagedInferenceEngine(configs.TINY, max_batch=2, max_seq=64,
                                   device='cpu', mesh=mesh)
        for p in ([1, 2, 3] * 5, [4, 5] * 6):
            eng.add_request(p, max_new_tokens=16)
        eng.step(horizon=1)
        eng.step(horizon=1)
        os.kill(pids[0], signal.SIGKILL)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match='follower|closed|Connection'):
            for _ in range(64):
                eng.step(horizon=1)
        assert time.monotonic() - t0 < 60.0
        assert mesh.broken
        with pytest.raises(mesh_lib.FollowerDied):
            eng.add_request([1, 2], max_new_tokens=2)
    finally:
        mesh.shutdown()
    assert all(_gone(p) for p in pids)


def test_call_raising_on_a_follower_only_breaks_the_mesh(tmp_path,
                                                         monkeypatch):
    """A mirrored call that raises on a follower and not on rank 0 (here
    the follower has dropped the engine rank 0 still holds; an
    out-of-memory error on one card alike) leaves their host state
    apart: rank 0 raises ``FollowerDied`` at once, the follower exits
    non-zero, and every later call raises. A refusal that every rank
    raises alike (an unknown quantize mode) keeps the mesh up, as does a
    weights tree too large to send, which rank 0 refuses before sending."""
    mesh = mesh_lib.serving_mesh(tp=2, device='cpu', timeout_s=60.0,
                                 store_dir=str(tmp_path))
    pids = mesh.follower_pids()
    try:
        eng = PagedInferenceEngine(configs.TINY, max_batch=2, max_seq=64,
                                   device='cpu', mesh=mesh)
        with pytest.raises(ValueError, match='quantize'):
            PagedInferenceEngine(configs.TINY, max_batch=2, max_seq=64,
                                 device='cpu', mesh=mesh, quantize='int3')
        monkeypatch.setattr(mesh_lib, 'MAX_WIRE_PARAM_BYTES', 1024)
        big = {'embed': torch.zeros(64, 64)}
        with pytest.raises(ValueError, match='param_seed'):
            PagedInferenceEngine(configs.TINY, big, max_batch=2,
                                 max_seq=64, device='cpu', mesh=mesh)
        assert not mesh.broken
        rid = eng.add_request([1, 2, 3], max_new_tokens=2)
        mesh.close_engine(eng._mesh_eid)     # the follower's copy only
        t0 = time.monotonic()
        with pytest.raises(mesh_lib.FollowerDied, match='raised'):
            eng.cancel(rid)
        assert time.monotonic() - t0 < 30.0
        assert mesh.broken
        code = mesh._procs[0].wait(30)
        assert code == 1
        with pytest.raises(mesh_lib.FollowerDied):
            eng.add_request([1, 2], max_new_tokens=2)
    finally:
        mesh.shutdown()
    assert all(_gone(p) for p in pids)


def test_scheduler_scales_its_cold_rate_by_tp_only():
    """The reference's ``test_scheduler_work_token_scaling``, held to the
    port's factor: tp speeds every slot's decode, so a tp = 2 mesh
    quotes a shorter cold Retry-After; dp splits the decode rows of the
    same ``max_batch`` (which the rate already counts) and every dp rank
    runs every prefill, so dp adds nothing to the factor."""
    import threading
    from skypilot_tpu_torch.serve import scheduler as scheduler_lib

    class FakeEngine:
        max_batch = 8

        def __init__(self, axes):
            self.axes = axes

        def mesh_axes(self):
            return dict(self.axes)

    def sched_for(axes):
        sched = scheduler_lib.RequestScheduler(threading.Lock())
        sched.bind_engine(FakeEngine(axes))
        return sched

    single = sched_for({'tp': 1, 'dp': 1})
    tp2 = sched_for({'tp': 2, 'dp': 1})
    tp2dp2 = sched_for({'tp': 2, 'dp': 2})
    assert (single.mesh_speedup, tp2.mesh_speedup,
            tp2dp2.mesh_speedup) == (1, 2, 2)
    assert tp2dp2.json_stats()['mesh_speedup'] == 2
    work = 4000
    assert tp2.retry_after_s('latency', work) < \
        single.retry_after_s('latency', work)
    assert tp2dp2.retry_after_s('latency', work) == \
        tp2.retry_after_s('latency', work)


def test_cli_takes_tp_and_dp():
    out = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.serve.server', '--help'],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert '--tp' in out.stdout and '--dp' in out.stdout
