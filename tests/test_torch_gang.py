"""Multi-host gang serving in the port (``skypilot_tpu_torch/serve/
gang.py``, ``serve/server.py`` ``run_follower``, ``parallel/mesh.py``'s
bootstrap), on the CPU, after the reference's ``tests/test_gang_serving.py``:

- the coordinator, the spec and the digests against the reference's
  ``serve/gang.py``, call for call on the same clock;
- the reference's data-plane gang tests, ported: the env contract, the
  protocol and trim, the failure causes, rank-targeted faults, a
  two-process boot barrier, drain-ack ordering, a killed rank failing
  the whole gang, a join timeout, a lost coordinator and a checkpointed
  gang's byte-identical recovery (the load balancer and the replica
  manager are the control plane, which the port does not hold);
- a replicated gang's greedy fp32 streams against the port's meshless
  server and the reference engine, and a mesh gang joined over
  ``tcp://127.0.0.1`` against the spawned tp 2 mesh;
- the bootstrap: a partial world raises within its timeout, one process
  is a no-op, the rendezvous address is the reference's.

Followers are threads with their own engine (the protocol and the
failure paths are the process ones) or ``python -m
skypilot_tpu_torch.serve.server --gang-rank N`` processes.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference.paged import PagedInferenceEngine as JPaged
from skypilot_tpu.models import configs as jconfigs
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.serve import gang as jgang
from skypilot_tpu_torch import telemetry
from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models.convert import params_from_numpy
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.serve import faults as faults_lib
from skypilot_tpu_torch.serve import gang as gang_lib
from skypilot_tpu_torch.serve.server import (ModelServer, build_engine,
                                             gang_plane)

jax.config.update('jax_platforms', 'cpu')

FAST = dict(max_batch=2, max_seq=160, device='cpu')
TCFG = dataclasses.replace(configs.TINY, dtype=torch.float32)
JCFG = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port(offset: int = 0) -> int:
    """A free port whose ``port + offset`` is free too (a mesh gang's
    rendezvous sits at the HTTP port + 1000)."""
    for _ in range(64):
        with socket.socket() as s:
            s.bind(('127.0.0.1', 0))
            port = s.getsockname()[1]
        if not offset:
            return port
        if port + offset > 65535:
            continue
        with socket.socket() as s:
            try:
                s.bind(('127.0.0.1', port + offset))
            except OSError:
                continue
        return port
    raise RuntimeError('no free port pair')


def _leader_spec(world=2, **kw):
    kw.setdefault('join_timeout_s', 180.0)
    kw.setdefault('heartbeat_s', 0.05)
    kw.setdefault('heartbeat_timeout_s', 60.0)
    return gang_lib.GangSpec(gang_id=kw.pop('gang_id', 'g-test'), rank=0,
                             world=world, **kw)


def _follower_spec(coordinator, rank=1, world=2, **kw):
    kw.setdefault('join_timeout_s', 60.0)
    kw.setdefault('heartbeat_s', 0.05)
    kw.setdefault('heartbeat_timeout_s', 10.0)
    return gang_lib.GangSpec(gang_id=kw.pop('gang_id', 'g-test'), rank=rank,
                             world=world, coordinator=coordinator, **kw)


def _start_leader(port, cfg='tiny', params=None, fault_spec=None,
                  **gang_kw):
    srv = ModelServer(cfg, port=port, params=params, fault_spec=fault_spec,
                      gang=_leader_spec(**gang_kw), **FAST)
    srv.start(block=False)
    return srv


def _start_thread_follower(coordinator, cfg='tiny', params=None, *,
                           faults=None, **kw):
    """A follower rank in this process with its own engine: the process
    follower's protocol, op replay and failure paths."""
    engine = build_engine(cfg, params=params, **FAST)
    follower = gang_lib.GangFollower(_follower_spec(coordinator, **kw),
                                     engine, faults=faults)

    def run():
        try:
            follower.run()
        except faults_lib.InjectedFault:
            pass          # a simulated process death: heartbeats stop

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return follower, t


def _await_barrier(srv, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if srv._gang is not None and srv._gang.all_joined:
            return True
        if srv._error is not None:
            return False
        time.sleep(0.05)
    return False


def _generate(base, payload, timeout=180):
    req = urllib.request.Request(base + '/generate',
                                 json.dumps(payload).encode(),
                                 {'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _wait_caught_up(srv, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = srv._gang.status()
        if st['members'].get('1', {}).get('applied') == st['ops']:
            return True
        time.sleep(0.05)
    return False


def _follower_cmd(port, *extra):
    return [sys.executable, '-m', 'skypilot_tpu_torch.serve.server',
            '--model', 'tiny', '--max-batch', '2', '--max-seq', '160',
            '--device', 'cpu', '--gang-rank', '1', '--gang-world', '2',
            '--gang-coordinator', f'http://127.0.0.1:{port}', *extra]


def _follower_env():
    return dict(os.environ, OMP_NUM_THREADS='1',
                SKYTPU_GANG_HEARTBEAT='0.05',
                PYTHONPATH=os.pathsep.join(
                    [ROOT] + [p for p in os.environ.get(
                        'PYTHONPATH', '').split(os.pathsep) if p]))


def _reap(proc, timeout=60):
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(10)
        raise


# ------------------------------------------- parity with the reference
def _drive(mod, clock):
    """One scripted sequence of coordinator calls; every answer, as
    JSON."""
    out = []
    spec = mod.GangSpec(gang_id='g', rank=0, world=3, join_timeout_s=5.0,
                        heartbeat_s=0.1, heartbeat_timeout_s=1.0)
    c = mod.GangCoordinator(spec, clock=lambda: clock[0])
    out.append(c.status())
    for i in range(5):
        out.append(c.append_op({'k': 'step', 'h': 8, 'i': i}))
    clock[0] = 0.5
    out.append(c.sync(1, 0, [], {}))
    out.append(c.sync(2, 0, [], {}))
    out.append(c.sync(7, 0, [], {}))                 # out of range
    cid = c.command('drain', {'deadline_s': 3.0})
    out.append(cid)
    clock[0] = 0.8
    out.append(c.sync(1, 5, [cid], {}))
    out.append(c.acked(cid))
    out.append(c.sync(2, 3, [], {}))                 # trim to 3
    out.append(c.sync(2, 5, [cid], {}))
    out.append(c.acked(cid))
    out.append(c.append_op({'k': 'flush'}))
    out.append(c.sync(1, 5, [], {}))
    out.append(c.status())
    clock[0] = 2.5
    try:
        c.check()
        out.append(None)
    except mod.GangFailure as e:
        out.append([e.cause, str(e)])
    out.append(c.status())
    # A late join on a fresh coordinator.
    c2 = mod.GangCoordinator(spec, clock=lambda: clock[0])
    clock[0] += 6.0
    try:
        c2.check()
    except mod.GangFailure as e:
        out.append([e.cause, str(e)])
    # Divergence.
    c3 = mod.GangCoordinator(spec, clock=lambda: clock[0])
    c3.digest.finished[7] = 'aaaa'
    out.append(c3.sync(1, 0, [], {'7': 'bbbb'}))
    try:
        c3.check()
    except mod.GangFailure as e:
        out.append([e.cause, str(e)])
    c3.fail('gang is dead')
    out.append(c3.sync(2, 0, [], {}))
    out.append(c3.failed)
    return json.loads(json.dumps(out))


def test_coordinator_json_equals_the_reference():
    """The same calls on the same clock give the same JSON: op slices,
    bases and trims, commands and acks, status, and the failure causes
    of a lost heartbeat, a late join and a divergence."""
    want = _drive(jgang, [0.0])
    got = _drive(gang_lib, [0.0])
    assert got == want
    causes = [x[0] for x in got if isinstance(x, list) and len(x) == 2
              and x[0] in gang_lib.FAILURE_CAUSES]
    assert causes == ['heartbeat_lost', 'join_timeout', 'divergence']
    assert gang_lib.FAILURE_CAUSES == jgang.FAILURE_CAUSES


def test_spec_and_digest_equal_the_reference(monkeypatch):
    env = {gang_lib.ENV_RANK: '2', gang_lib.ENV_WORLD: '4',
           gang_lib.ENV_COORDINATOR: 'http://h0:8081',
           gang_lib.ENV_GANG_ID: 'svc-gang-7',
           gang_lib.ENV_JOIN_TIMEOUT: '33', gang_lib.ENV_HEARTBEAT: '0.2'}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(gang_lib.GangSpec.from_env()) == \
        dataclasses.asdict(jgang.GangSpec.from_env())
    monkeypatch.setenv(gang_lib.ENV_HEARTBEAT_TIMEOUT, '7.5')
    assert dataclasses.asdict(gang_lib.GangSpec.from_env(rank=1)) == \
        dataclasses.asdict(jgang.GangSpec.from_env(rank=1))
    rng = np.random.default_rng(0)
    for _ in range(8):
        prompt = rng.integers(0, 256, rng.integers(1, 40)).tolist()
        out = rng.integers(0, 256, rng.integers(0, 40)).tolist()
        assert gang_lib.finished_digest(prompt, out) == \
            jgang.finished_digest(prompt, out)


# -------------------------------------------------------- env contract
def test_gang_spec_env_contract(monkeypatch):
    monkeypatch.setenv(gang_lib.ENV_RANK, '2')
    monkeypatch.setenv(gang_lib.ENV_WORLD, '4')
    monkeypatch.setenv(gang_lib.ENV_COORDINATOR, 'http://h0:8081')
    monkeypatch.setenv(gang_lib.ENV_GANG_ID, 'svc-gang-7')
    monkeypatch.setenv(gang_lib.ENV_JOIN_TIMEOUT, '33')
    monkeypatch.setenv(gang_lib.ENV_HEARTBEAT, '0.2')
    spec = gang_lib.GangSpec.from_env()
    assert (spec.rank, spec.world) == (2, 4)
    assert spec.is_gang and not spec.is_leader
    assert spec.coordinator == 'http://h0:8081'
    assert spec.gang_id == 'svc-gang-7'
    assert spec.join_timeout_s == 33.0
    assert spec.heartbeat_s == 0.2
    assert spec.heartbeat_timeout_s == 2.0      # 10x the heartbeat
    spec = gang_lib.GangSpec.from_env(rank=0, world=1)
    assert not spec.is_gang
    monkeypatch.delenv(gang_lib.ENV_COORDINATOR)
    with pytest.raises(ValueError, match='SKYTPU_COORDINATOR'):
        gang_lib.GangSpec.from_env()
    with pytest.raises(ValueError, match='out of range'):
        gang_lib.GangSpec.from_env(rank=5, world=2,
                                   coordinator='http://h0:1')


def test_world_matching_neither_plane_raises():
    spec = _leader_spec(world=4)
    assert gang_plane(spec, 1, 1) == 'replicated'
    assert gang_plane(spec, 2, 2) == 'mesh'
    with pytest.raises(ValueError, match='replicated.*mesh'):
        gang_plane(spec, 2, 1)
    with pytest.raises(ValueError, match='neither data plane'):
        ModelServer('tiny', port=_free_port(), gang=spec, tp=2, dp=1,
                    **FAST)


# ------------------------------------------------- coordinator units
def test_coordinator_protocol_and_trim():
    spec = gang_lib.GangSpec(gang_id='g', rank=0, world=3,
                             join_timeout_s=10, heartbeat_s=0.05,
                             heartbeat_timeout_s=1.0)
    coord = gang_lib.GangCoordinator(spec)
    assert not coord.all_joined
    for i in range(4):
        coord.append_op({'k': 'step', 'h': 8, 'i': i})
    r1 = coord.sync(1, 0, [], {})
    assert not coord.all_joined
    r2 = coord.sync(2, 0, [], {})
    assert coord.all_joined
    assert [op['i'] for op in r1['ops']] == [0, 1, 2, 3]
    assert r1['base'] == 0 and r2['base'] == 0
    coord.sync(1, 4, [], {})
    r2 = coord.sync(2, 2, [], {})
    assert r2['base'] == 2
    assert [op['i'] for op in r2['ops']] == [2, 3]
    cid = coord.command('drain')
    assert not coord.acked(cid)
    coord.sync(1, 4, [cid], {})
    assert not coord.acked(cid)
    coord.sync(2, 4, [cid], {})
    assert coord.acked(cid)
    assert coord.wait_acked(cid, timeout=0.1)
    st = coord.status()
    assert st['barrier'] and st['world'] == 3 and st['ops'] == 4


def test_coordinator_failure_causes():
    clock = [0.0]
    spec = gang_lib.GangSpec(gang_id='g', rank=0, world=2,
                             join_timeout_s=5.0, heartbeat_s=0.1,
                             heartbeat_timeout_s=1.0)
    coord = gang_lib.GangCoordinator(spec, clock=lambda: clock[0])
    coord.check()
    clock[0] = 6.0
    with pytest.raises(gang_lib.GangFailure) as ei:
        coord.check()
    assert ei.value.cause == 'join_timeout'
    coord2 = gang_lib.GangCoordinator(spec, clock=lambda: clock[0])
    coord2.sync(1, 0, [], {})
    coord2.check()
    clock[0] += 2.0
    with pytest.raises(gang_lib.GangFailure) as ei:
        coord2.check()
    assert ei.value.cause == 'heartbeat_lost'
    coord3 = gang_lib.GangCoordinator(spec, clock=lambda: clock[0])
    coord3.digest.finished[7] = 'aaaa'
    resp = coord3.sync(1, 0, [], {'7': 'bbbb'})
    assert 'diverged' in resp['failed']
    with pytest.raises(gang_lib.GangFailure) as ei:
        coord3.check()
    assert ei.value.cause == 'divergence'
    coord2.fail('gang is dead')
    assert coord2.sync(1, 5, [], {})['failed'] == 'gang is dead'


def test_gang_fault_rules_rank_targeted():
    inj = faults_lib.FaultInjector({'rules': [
        {'kind': 'replica_crash', 'site': 'gang_member_crash',
         'rank': 1, 'at': 2}]})
    assert inj.fire('gang_member_crash', rank=2) is None
    assert inj.fire('gang_member_crash', rank=1) is not None
    assert inj.fire('gang_member_crash', rank=1) is None
    with pytest.raises(ValueError, match='unknown fault site'):
        faults_lib.make_injector({'rules': [
            {'kind': 'replica_crash', 'site': 'gang_sneeze'}]})


def test_injected_join_failure_and_crash_fire_on_their_rank():
    """``gang_join_timeout`` (``replica_crash``) makes the named rank
    never join; ``gang_member_crash`` kills the named rank at its
    heartbeat. Neither fires on another rank."""
    spec1 = _follower_spec('http://127.0.0.1:1', rank=1, world=3,
                           join_timeout_s=0.3)
    spec2 = _follower_spec('http://127.0.0.1:1', rank=2, world=3,
                           join_timeout_s=30.0)
    join = {'rules': [{'kind': 'replica_crash', 'site': 'gang_join_timeout',
                       'rank': 2, 'every': 1}]}
    f1 = gang_lib.GangFollower(spec1, None,
                               faults=faults_lib.make_injector(join))
    f2 = gang_lib.GangFollower(spec2, None,
                               faults=faults_lib.make_injector(join))
    t0 = time.monotonic()
    assert f2.run() == 'join_timeout'
    assert time.monotonic() - t0 < 10.0       # never waited its 30 s
    assert f1.run() == 'join_timeout'         # tried until its deadline
    crash = {'rules': [{'kind': 'replica_crash', 'site': 'gang_member_crash',
                        'rank': 1, 'at': 1}]}
    f = gang_lib.GangFollower(spec1, None,
                              faults=faults_lib.make_injector(crash))
    with pytest.raises(faults_lib.InjectedFault, match='rank 1'):
        f.run()
    g = gang_lib.GangFollower(dataclasses.replace(spec2, join_timeout_s=0.3),
                              None, faults=faults_lib.make_injector(crash))
    assert g.run() == 'join_timeout'


# ------------------------------------------------ two-process gang e2e
def test_two_process_gang_boot_barrier_byte_identical():
    """A two-process replicated gang (rank 1 a separate process on the
    follower entry) boots, is not ready before the barrier, passes it,
    serves, and its greedy output equals the meshless server's; the
    digests of every finished request agree, and rank 1 exits 0 on the
    leader's stop."""
    port = _free_port()
    # heartbeat_s 0.5: stop() waits 1 s for rank 1's shutdown ack.
    srv = _start_leader(port, gang_id='g-2proc', heartbeat_s=0.5)
    base = f'http://127.0.0.1:{port}'
    proc = None
    try:
        assert srv._ready.wait(300)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + '/readiness', timeout=10)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())['status'] == 'gang_joining'
        proc = subprocess.Popen(_follower_cmd(port, '--gang-id', 'g-2proc'),
                                env=_follower_env(),
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        assert _await_barrier(srv, timeout=240), srv._error
        with urllib.request.urlopen(base + '/readiness', timeout=10) as r:
            ready = json.loads(r.read())
        assert ready['status'] == 'ready'
        assert ready['gang']['world'] == 2 and ready['gang']['barrier']
        with urllib.request.urlopen(base + '/gang/status', timeout=10) as r:
            assert json.loads(r.read())['members']['1']['applied'] >= 0
        port2 = _free_port()
        ref = ModelServer('tiny', port=port2, **FAST)
        ref.start(block=False)
        try:
            assert ref._ready.wait(300)
            prompt, gen = [3, 1, 4, 1, 5], 24
            out_gang = _generate(base, {'prompt': prompt,
                                        'max_new_tokens': gen})
            out_ref = _generate(f'http://127.0.0.1:{port2}',
                                {'prompt': prompt, 'max_new_tokens': gen})
            assert out_gang['tokens'] == out_ref['tokens']
        finally:
            ref.stop()
        assert _wait_caught_up(srv)
        time.sleep(0.3)              # one more heartbeat carries the digest
        assert srv._error is None    # no divergence
        reg = telemetry.get_registry()
        assert reg.histogram('skytpu_gang_join_seconds').count >= 1
        assert reg.gauge('skytpu_gang_size').value == 2
    finally:
        srv.stop()
        if proc is not None:
            assert _reap(proc) == 0


def test_replicated_gang_streams_equal_meshless_and_reference():
    """fp32 TINY: a replicated two-rank gang's greedy streams equal the
    port's meshless server's and the reference engine's on the same
    prompts and weights, and rank 1's digest of every finished request
    equals rank 0's."""
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    tp = params_from_numpy(jax.device_get(jp), TCFG, device='cpu')
    prompts = ([3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5] * 3, [7] * 11)
    gen = 16
    ref = JPaged(JCFG, jp, max_batch=2, max_seq=160, decode_impl='gather')
    rids = [ref.add_request(list(p), max_new_tokens=gen) for p in prompts]
    done = ref.run_to_completion()
    want = [list(done[r].output) for r in rids]
    port = _free_port()
    srv = _start_leader(port, cfg=TCFG, params=tp, gang_id='g-rep')
    base = f'http://127.0.0.1:{port}'
    try:
        assert srv._ready.wait(300)
        follower, t = _start_thread_follower(base, cfg=TCFG, params=tp,
                                             gang_id='g-rep')
        assert _await_barrier(srv), srv._error
        got = [_generate(base, {'prompt': p, 'max_new_tokens': gen}
                         )['tokens'] for p in prompts]
        assert _wait_caught_up(srv)
        deadline = time.time() + 10
        while (time.time() < deadline
               and len(follower.digest.finished) < len(prompts)):
            time.sleep(0.05)
        lead = srv._gang.digest.finished
        mine = follower.digest.finished
        assert set(lead) >= set(mine) and len(mine) >= len(prompts)
        assert all(lead[r] == d for r, d in mine.items())
        assert srv._error is None
    finally:
        srv.stop()
    port2 = _free_port()
    solo = ModelServer(TCFG, port=port2, params=tp, **FAST)
    solo.start(block=False)
    try:
        assert solo._ready.wait(300)
        meshless = [_generate(f'http://127.0.0.1:{port2}',
                              {'prompt': p, 'max_new_tokens': gen}
                              )['tokens'] for p in prompts]
    finally:
        solo.stop()
    t.join(30)
    assert follower.exit_cause == 'shutdown'
    assert got == meshless == want


# ------------------------------------------------------ drain ordering
def test_gang_drain_ack_ordering():
    """"Gang drained" means every rank applied everything up to the
    drain command's pinned index: a lagging follower holds the drain
    open, and its catch-up ack completes it."""
    port = _free_port()
    srv = _start_leader(port, gang_id='g-drain')
    base = f'http://127.0.0.1:{port}'

    def sync(rank, applied, acks):
        req = urllib.request.Request(
            base + '/gang/sync',
            data=json.dumps({'rank': rank, 'gang_id': 'g-drain',
                             'applied': applied, 'acks': acks}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    try:
        assert srv._ready.wait(300)
        sync(1, 0, [])
        assert _await_barrier(srv, timeout=30)
        _generate(base, {'prompt': [2, 7, 1], 'max_new_tokens': 8})
        status = json.loads(urllib.request.urlopen(
            urllib.request.Request(
                base + '/drain',
                data=json.dumps({'deadline_s': 30}).encode(),
                headers={'Content-Type': 'application/json'}),
            timeout=10).read())
        assert status['draining'] is True
        resp = sync(1, 0, [])
        cmds = [c for c in resp['commands'] if c['kind'] == 'drain']
        assert cmds and cmds[0]['log_index'] > 0
        cid, pinned = cmds[0]['id'], cmds[0]['log_index']
        time.sleep(0.3)
        st = json.loads(urllib.request.urlopen(base + '/drain',
                                               timeout=10).read())
        assert st['drained'] is False
        assert st['gang_drain_acked'] is False
        sync(1, pinned, [cid])
        deadline = time.time() + 15
        while time.time() < deadline:
            st = json.loads(urllib.request.urlopen(base + '/drain',
                                                   timeout=10).read())
            if st['drained']:
                break
            time.sleep(0.1)
        assert st['drained'] is True and st['gang_drain_acked'] is True
        # A sync from another gang's rank is refused.
        req = urllib.request.Request(
            base + '/gang/sync',
            data=json.dumps({'rank': 1, 'gang_id': 'other'}).encode(),
            headers={'Content-Type': 'application/json'})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 409
    finally:
        srv.stop()


def test_drain_acked_by_a_thread_follower():
    """A live follower acks the drain once it caught up: the gang drains
    with both ranks, no request in flight."""
    port = _free_port()
    srv = _start_leader(port, gang_id='g-drain2')
    base = f'http://127.0.0.1:{port}'
    try:
        assert srv._ready.wait(300)
        follower, t = _start_thread_follower(base, gang_id='g-drain2')
        assert _await_barrier(srv), srv._error
        _generate(base, {'prompt': [2, 7, 1], 'max_new_tokens': 8})
        srv.begin_drain(30)
        deadline = time.time() + 30
        while time.time() < deadline and not srv.drain_status()['drained']:
            time.sleep(0.05)
        st = srv.drain_status()
        assert st['drained'] and st['gang_drain_acked']
        assert srv._gang.acked(srv._gang_drain_cid)
    finally:
        srv.stop()
    t.join(30)
    assert follower.exit_cause == 'shutdown'


# ------------------------------------------ one dead rank = dead gang
def test_rank1_kill_fails_the_whole_gang_no_request_lost():
    """A seeded ``gang_member_crash`` on rank 1 mid-stream fails the
    whole gang (rank 0 fails itself on the lost heartbeat), the stream
    in flight ends with a retryable error instead of hanging (a load
    balancer resubmits it elsewhere; the tokens it got are the prefix of
    an uninterrupted run), and the leader probes dead."""
    port = _free_port()
    srv = _start_leader(port, gang_id='g-kill', heartbeat_timeout_s=60.0,
                        fault_spec={'seed': 0, 'rules': [
                            {'kind': 'engine_stall', 'site': 'engine_step',
                             'every': 1, 'delay_s': 0.15}]})
    base = f'http://127.0.0.1:{port}'
    port_b = _free_port()
    survivor = ModelServer('tiny', port=port_b, **FAST)
    survivor.start(block=False)
    try:
        assert srv._ready.wait(300) and survivor._ready.wait(300)
        follower, _t = _start_thread_follower(base, gang_id='g-kill',
                                              heartbeat_timeout_s=10.0)
        assert _await_barrier(srv, timeout=60), srv._error
        prompt, gen = [3, 1, 4, 1, 5], 32
        _generate(base, {'prompt': [1, 2, 3, 4], 'max_new_tokens': gen})
        reference = _generate(f'http://127.0.0.1:{port_b}',
                              {'prompt': prompt,
                               'max_new_tokens': gen})['tokens']
        assert _wait_caught_up(srv)
        srv._gang.spec = dataclasses.replace(srv._gang.spec,
                                             heartbeat_timeout_s=1.0)
        t_kill = None
        sr = srv.submit_stream(prompt, max_new_tokens=gen)
        tokens, error = [], None
        while True:
            try:
                token, finished = sr.outbox.get(timeout=60)
            except Exception as e:  # noqa: BLE001 - the failure is the point
                error = e
                break
            if token is None:
                error = sr.outbox.error
                break
            tokens.append(int(token))
            if len(tokens) == 5:
                t_kill = time.monotonic()
                follower._faults = faults_lib.FaultInjector(
                    {'seed': 0, 'rules': [
                        {'kind': 'replica_crash',
                         'site': 'gang_member_crash', 'rank': 1,
                         'at': 1}]})
            if finished:
                break
        deadline = time.time() + 20
        while time.time() < deadline and srv._error is None:
            time.sleep(0.05)
        detect_s = time.monotonic() - t_kill
        assert srv._error is not None and 'heartbeat lost' in srv._error
        assert detect_s < 1.0 + 5.0
        # Not lost: the stream ended (with the gang's error) and what it
        # had streamed is the uninterrupted run's prefix.
        assert error is not None or len(tokens) == gen
        assert tokens == reference[:len(tokens)]
        reg = telemetry.get_registry()
        c = reg.get('skytpu_gang_failures_total', cause='heartbeat_lost')
        assert c is not None and c.value >= 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + '/readiness', timeout=10)
        assert ei.value.code == 503
        assert srv._gang.failed is not None
    finally:
        srv.stop()
        survivor.stop()


def test_join_timeout_fails_partial_gang():
    port = _free_port()
    srv = _start_leader(port, gang_id='g-late', join_timeout_s=3.0,
                        heartbeat_s=0.05, heartbeat_timeout_s=1.0)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and srv._error is None:
            time.sleep(0.1)
        assert srv._error is not None
        assert 'join timeout' in srv._error
        assert 'missing rank(s) [1]' in srv._error
        reg = telemetry.get_registry()
        c = reg.get('skytpu_gang_failures_total', cause='join_timeout')
        assert c is not None and c.value >= 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f'http://127.0.0.1:{port}/readiness',
                                   timeout=10)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())['status'] == 'failed'
    finally:
        srv.stop()


def test_follower_self_terminates_on_coordinator_loss():
    port = _free_port()
    srv = _start_leader(port, gang_id='g-loss', heartbeat_s=0.05,
                        heartbeat_timeout_s=1.0)
    base = f'http://127.0.0.1:{port}'
    try:
        assert srv._ready.wait(300)
        follower, t = _start_thread_follower(
            base, gang_id='g-loss', heartbeat_s=0.05,
            heartbeat_timeout_s=1.0)
        assert _await_barrier(srv, timeout=60)
        srv._gang.command = lambda *a, **k: -1   # no shutdown command
    finally:
        srv.stop()
    t.join(timeout=30)
    assert not t.is_alive()
    assert follower.exit_cause in ('coordinator_lost', 'coordinator_failed')


# ---------------------------------------- checkpoint -> warm recovery
def test_preempt_gang_checkpoint_recover_byte_identical():
    """Mid-stream, POST /checkpoint exports the gang's state, acked by
    every rank; a replacement single-process replica warms from the
    blob and the continuation equals an uninterrupted run."""
    port = _free_port()
    srv = _start_leader(port, cfg=TCFG, gang_id='g-ckpt',
                        fault_spec={'seed': 0, 'rules': [
                            {'kind': 'engine_stall', 'site': 'engine_step',
                             'every': 1, 'delay_s': 0.2}]})
    base = f'http://127.0.0.1:{port}'
    try:
        assert srv._ready.wait(300)
        follower, _t = _start_thread_follower(base, cfg=TCFG,
                                              gang_id='g-ckpt')
        assert _await_barrier(srv, timeout=60), srv._error
        prompt, gen = [9, 2, 6, 4], 48
        port_r = _free_port()
        ref_srv = ModelServer(TCFG, port=port_r, **FAST)
        ref_srv.start(block=False)
        try:
            assert ref_srv._ready.wait(300)
            reference = _generate(f'http://127.0.0.1:{port_r}',
                                  {'prompt': prompt,
                                   'max_new_tokens': gen})['tokens']
        finally:
            ref_srv.stop()
        sr = srv.submit_stream(prompt, max_new_tokens=gen)
        tokens = []
        while len(tokens) < 30:
            token, finished = sr.outbox.get(timeout=120)
            assert token is not None, sr.outbox.error
            tokens.append(int(token))
            assert not finished
        req = urllib.request.Request(
            base + '/checkpoint', data=json.dumps({}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=60) as r:
            blob = r.read()
            n_entries = int(r.headers['X-Checkpoint-Entries'])
        assert n_entries >= 1
        # Every rank acked the checkpoint command.
        ckpt = [c for c in srv._gang._commands if c['kind'] == 'checkpoint']
        assert ckpt and srv._gang.acked(ckpt[-1]['id'])
        srv.finish_stream(sr)
        port2 = _free_port()
        srv2 = ModelServer(TCFG, port=port2, **FAST)
        srv2.start(block=False)
        try:
            assert srv2._ready.wait(300)
            warm_req = urllib.request.Request(
                f'http://127.0.0.1:{port2}/kv/warmup', data=blob,
                headers={'Content-Type': 'application/octet-stream'})
            with urllib.request.urlopen(warm_req, timeout=60) as r:
                warm = json.loads(r.read())
            assert warm['entries'] == n_entries
            assert warm['warmed_rows'] >= 1
            cont = _generate(f'http://127.0.0.1:{port2}',
                             {'prompt': prompt + tokens,
                              'max_new_tokens': gen - len(tokens)}
                             )['tokens']
            assert tokens + cont == reference
        finally:
            srv2.stop()
        assert srv._error is None
    finally:
        srv.stop()


def test_gang_leader_refuses_kv_ingest_and_forces_colocated():
    port = _free_port()
    srv = ModelServer('tiny', port=port, role='prefill',
                      gang=_leader_spec(gang_id='g-role'), **FAST)
    assert srv.role == 'colocated'
    srv.start(block=False)
    base = f'http://127.0.0.1:{port}'
    try:
        assert srv._ready.wait(300)
        req = urllib.request.Request(base + '/kv/ingest', data=b'x',
                                     headers={'Content-Type':
                                              'application/octet-stream'})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())['error']['type'] == 'gang'
    finally:
        srv.stop()
    with pytest.raises(ValueError, match='rank-0 gang process'):
        ModelServer('tiny', port=_free_port(),
                    gang=_follower_spec('http://127.0.0.1:1'), **FAST)


# ------------------------------------------------------------ mesh gang
def test_mesh_gang_over_tcp_streams_as_the_spawned_mesh():
    """A mesh gang of world 2 at tp 2: rank 1 is a ``--gang-rank 1
    --tp 2`` process, the ranks meet over ``tcp://127.0.0.1`` at the
    HTTP port + 1000, and the streams equal the spawned tp 2 mesh's
    (``serving_mesh``) and the meshless server's. The op log stays
    empty; the drain is acked by rank 1's heartbeat; rank 1 exits 0."""
    prompts = ([3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5] * 3)
    gen = 12
    port = _free_port(mesh_lib.GANG_RENDEZVOUS_PORT_OFFSET)
    srv = ModelServer('tiny', port=port, tp=2, dp=1,
                      gang=_leader_spec(gang_id='g-mesh', heartbeat_s=0.5,
                                        join_timeout_s=120.0), **FAST)
    srv.start(block=False)
    base = f'http://127.0.0.1:{port}'
    proc = subprocess.Popen(_follower_cmd(port, '--tp', '2', '--gang-id',
                                          'g-mesh'),
                            env=_follower_env(), stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        assert srv._ready.wait(240), srv._error
        assert _await_barrier(srv), srv._error
        assert srv.gang_plane == 'mesh' and srv.mesh.size == 2
        got = [_generate(base, {'prompt': p, 'max_new_tokens': gen}
                         )['tokens'] for p in prompts]
        assert srv._gang.status()['ops'] == 0
        srv.begin_drain(30)
        deadline = time.time() + 30
        while time.time() < deadline and not srv.drain_status()['drained']:
            time.sleep(0.05)
        assert srv.drain_status()['gang_drain_acked']
    finally:
        srv.stop()
        assert _reap(proc) == 0
    port2 = _free_port()
    spawned = ModelServer('tiny', port=port2, tp=2, dp=1, **FAST)
    spawned.start(block=False)
    try:
        assert spawned._ready.wait(240), spawned._error
        want = [_generate(f'http://127.0.0.1:{port2}',
                          {'prompt': p, 'max_new_tokens': gen})['tokens']
                for p in prompts]
    finally:
        spawned.stop()
    assert got == want


def test_mesh_gang_rank_that_never_comes_fails_the_load():
    """A mesh gang whose rank 1 never starts: the TCP rendezvous gives
    up within the join timeout and the leader fails (join timeout or
    the rendezvous's error), never serving a partial mesh."""
    port = _free_port(mesh_lib.GANG_RENDEZVOUS_PORT_OFFSET)
    srv = ModelServer('tiny', port=port, tp=2, dp=1,
                      gang=_leader_spec(gang_id='g-miss',
                                        join_timeout_s=3.0,
                                        heartbeat_timeout_s=1.0), **FAST)
    t0 = time.monotonic()
    srv.start(block=False)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and srv._error is None:
            time.sleep(0.05)
        assert srv._error is not None
        assert time.monotonic() - t0 < 3.0 + 30.0
        assert not srv._ready.is_set()
    finally:
        srv.stop()


# ------------------------------------------------------------ bootstrap
def test_rendezvous_address_equals_the_reference():
    for url in ('http://h0:8081', 'http://10.0.0.1:9000/', 'h1:7000',
                'http://localhost', 'h2'):
        assert mesh_lib.coordinator_from_url(url) == \
            jmesh.jax_coordinator_from_url(url)


def test_bootstrap_is_a_noop_for_one_process(monkeypatch):
    import torch.distributed as dist
    assert mesh_lib.initialize_gang_distributed(
        'http://127.0.0.1:1', 0, 1, device='cpu') is False
    monkeypatch.delenv('SKYTPU_COORDINATOR_ADDRESS', raising=False)
    assert mesh_lib.initialize_distributed_from_env(device='cpu') is False
    monkeypatch.setenv('SKYTPU_COORDINATOR_ADDRESS', '127.0.0.1:1')
    monkeypatch.setenv('SKYTPU_NUM_NODES', '1')
    assert mesh_lib.initialize_distributed_from_env(device='cpu') is False
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            mesh_lib.initialize_gang_distributed('http://127.0.0.1:1', 0, 2)


_BOOT = textwrap.dedent('''
    import sys, time
    sys.path.insert(0, {root!r})
    from skypilot_tpu_torch.parallel import mesh
    t0 = time.monotonic()
    try:
        {call}
    except Exception as e:
        print('RAISED', type(e).__name__, round(time.monotonic() - t0, 2))
        sys.exit(3)
    print('JOINED')
''')


@pytest.mark.parametrize('which', ['gang', 'env'])
def test_partial_world_raises_within_its_timeout(which):
    """World 2 with only rank 0 up: the bounded rendezvous raises within
    its timeout plus a few seconds, in the gang form and in the training
    form; an idempotent second call is not reached."""
    port = _free_port(mesh_lib.GANG_RENDEZVOUS_PORT_OFFSET)
    if which == 'gang':
        call = (f"mesh.initialize_gang_distributed('http://127.0.0.1:{port}"
                f"', 0, 2, timeout_s=3.0, device='cpu')")
        env = dict(os.environ)
    else:
        call = "mesh.initialize_distributed_from_env(device='cpu', " \
               "timeout_s=3.0)"
        env = dict(os.environ, SKYTPU_COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
                   SKYTPU_NUM_NODES='2', SKYTPU_NODE_RANK='0')
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, '-c',
                          _BOOT.format(root=ROOT, call=call)],
                         env=env, capture_output=True, text=True,
                         timeout=60)
    took = time.monotonic() - t0
    assert out.returncode == 3, out.stdout + out.stderr
    assert 'RAISED' in out.stdout
    assert took < 3.0 + 15.0


def test_two_ranks_join_over_tcp():
    """Both ranks up: the rendezvous completes, a gloo all-reduce spans
    them, and a second call is idempotent."""
    port = _free_port(mesh_lib.GANG_RENDEZVOUS_PORT_OFFSET)
    body = textwrap.dedent(f'''
        import sys
        sys.path.insert(0, {ROOT!r})
        import torch, torch.distributed as dist
        from skypilot_tpu_torch.parallel import mesh
        r = int(sys.argv[1])
        assert mesh.initialize_gang_distributed(
            'http://127.0.0.1:{port}', r, 2, timeout_s=30, device='cpu')
        assert mesh.initialize_gang_distributed(
            'http://127.0.0.1:{port}', r, 2, timeout_s=30, device='cpu')
        t = torch.tensor([r + 1.0])
        dist.all_reduce(t)
        print('SUM', float(t))
        dist.destroy_process_group()
    ''')
    procs = [subprocess.Popen([sys.executable, '-c', body, str(r)],
                              stdout=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=60)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert all('SUM 3.0' in o for o in outs)


# -------------------------------------------------------------- the CLI
def _flags(module):
    out = subprocess.run([sys.executable, '-m', module, '--help'],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS='cpu'),
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    import re
    return set(re.findall(r'(--[a-z][a-z0-9-]+)', out.stdout)) - {'--help'}


def test_server_has_every_reference_flag():
    ref = _flags('skypilot_tpu.serve.server')
    port = _flags('skypilot_tpu_torch.serve.server')
    assert len(ref) == 33
    assert ref <= port, sorted(ref - port)
    assert {'--gang-rank', '--gang-world', '--gang-coordinator',
            '--gang-id'} <= port
