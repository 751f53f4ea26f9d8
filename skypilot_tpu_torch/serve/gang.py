"""Multi-host gang serving (own copy of ``skypilot_tpu/serve/gang.py``,
without JAX): a replica is a *gang* of processes that launch, drain,
checkpoint and die together.

One replica is ``SKYTPU_WORLD`` processes sharing a ``SKYTPU_GANG_ID``.
Rank 0 owns the HTTP front end, the SLO scheduler and the request
stream; each nonzero rank runs a :class:`GangFollower` loop
(``python -m skypilot_tpu_torch.serve.server --gang-rank N``).

Launch-env contract (mirroring ``SKYTPU_TP``/``SKYTPU_DP``):

- ``SKYTPU_COORDINATOR``: rank 0's base URL (the gang bus: followers
  POST ``/gang/sync`` against it). Absent on rank 0 itself.
- ``SKYTPU_RANK`` / ``SKYTPU_WORLD``: this process's rank and the gang
  size. ``WORLD <= 1`` disables everything (the single-process server
  is the server without a gang).
- ``SKYTPU_GANG_ID``: the shared identity (drain, checkpoint and
  teardown are keyed by it).
- ``SKYTPU_GANG_JOIN_TIMEOUT``: the barrier's bound. Unless every rank
  has joined rank 0's coordinator within this window, the whole gang
  fails (rank 0 fails itself; stragglers terminate themselves). Every
  distributed join in this module carries a timeout.
- ``SKYTPU_GANG_HEARTBEAT`` / ``SKYTPU_GANG_HEARTBEAT_TIMEOUT``: the
  follower sync period and the loss bound. A follower that misses
  heartbeats past the bound kills the gang (rank 0 fails itself), and
  a follower that cannot reach rank 0 past the bound terminates itself.
  One dead rank means the whole gang is dead, never a half-alive
  replica.

Two data planes (``serve/server.py`` picks one from the world size):

- *replicated* (``tp * dp == 1``): every rank holds a whole model.
  Rank 0 appends every engine mutation to an ordered *op log*: ``add``
  (admission), ``step`` (one fused step), ``cancel``, ``release_hold``,
  ``flush`` (a pipeline drain before a checkpoint export) and
  ``warmup`` (a prefix-cache checkpoint landing). Followers pull the
  log through ``/gang/sync`` (their heartbeat) and apply it in order to
  their own engine, and report a digest of every finished request's
  token stream; any mismatch with rank 0's fails the gang (cause
  ``divergence``).
- *mesh* (``tp * dp == world``): the gang's processes form one serving
  mesh over ``torch.distributed`` with a TCP rendezvous at rank 0's host
  (``parallel/mesh.py`` ``gang_mesh``); engine calls reach the
  followers over the mesh's control channel (``parallel/follower.py``).
  The gang bus then carries only what the gang adds: the join barrier,
  heartbeats, the drain and checkpoint commands with their acks, and
  the failure causes. The op log stays empty.

Drain and checkpoint are *commands* on the same bus. A command pins the
op-log index at which it was issued; a follower acks it only once it
has applied every op up to that index, so "gang drained" and "gang
checkpointed" mean every rank reached the same state.

Telemetry (registered at construction; zeros from the first scrape):
``skytpu_gang_size``, ``skytpu_gang_join_seconds``,
``skytpu_gang_failures_total{cause}``,
``skytpu_gang_heartbeat_age_seconds``.
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import logging
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from skypilot_tpu_torch import telemetry
from skypilot_tpu_torch.serve import wire

logger = logging.getLogger(__name__)

# Launch-env contract (mirrors SKYTPU_TP/SKYTPU_DP).
ENV_COORDINATOR = 'SKYTPU_COORDINATOR'
ENV_RANK = 'SKYTPU_RANK'
ENV_WORLD = 'SKYTPU_WORLD'
ENV_GANG_ID = 'SKYTPU_GANG_ID'
ENV_JOIN_TIMEOUT = 'SKYTPU_GANG_JOIN_TIMEOUT'
ENV_HEARTBEAT = 'SKYTPU_GANG_HEARTBEAT'
ENV_HEARTBEAT_TIMEOUT = 'SKYTPU_GANG_HEARTBEAT_TIMEOUT'

# The stable label set of skytpu_gang_failures_total{cause}.
FAILURE_CAUSES = ('join_timeout', 'heartbeat_lost', 'member_crash',
                  'divergence', 'coordinator_lost')

# Finished-request digests kept for cross-rank verification (bounded:
# a follower lagging further than this behind rank 0's finish stream
# is already heartbeat-dead).
_MAX_FINISHED_DIGESTS = 512
# Ops returned per sync (bounds one response; a fresh follower catches
# up over a few heartbeats).
_MAX_OPS_PER_SYNC = 256
# HTTP timeout for one sync POST (bounded: no join waits forever).
_SYNC_HTTP_TIMEOUT = 10.0


def register_metrics() -> None:
    """Register the gang series up front: zeros from the first scrape
    whether or not this process ever joins a gang (a stable schema)."""
    reg = telemetry.get_registry()
    reg.gauge('skytpu_gang_size',
              'Processes in this replica\'s gang (0 = not a gang)')
    reg.histogram('skytpu_gang_join_seconds',
                  'Gang barrier: coordinator start to all ranks '
                  'joined (s)',
                  buckets=telemetry.registry.DEFAULT_SECONDS_BUCKETS)
    for cause in FAILURE_CAUSES:
        reg.counter('skytpu_gang_failures_total',
                    'Whole-gang failures by cause (one dead rank '
                    'fails the gang)', cause=cause)
    reg.gauge('skytpu_gang_heartbeat_age_seconds',
              'Oldest follower heartbeat age (0 until a gang forms)')


@dataclasses.dataclass(frozen=True)
class GangSpec:
    """One process's identity inside a gang. ``world <= 1`` means not
    a gang at all — every hook is a no-op and the server behaves
    exactly as before."""
    gang_id: str = ''
    rank: int = 0
    world: int = 1
    coordinator: Optional[str] = None
    join_timeout_s: float = 120.0
    heartbeat_s: float = 0.5
    heartbeat_timeout_s: float = 5.0

    @property
    def is_gang(self) -> bool:
        return self.world > 1

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    @classmethod
    def from_env(cls, *, rank: Optional[int] = None,
                 world: Optional[int] = None,
                 coordinator: Optional[str] = None,
                 gang_id: Optional[str] = None) -> 'GangSpec':
        """The launch-env contract, with explicit args (CLI flags)
        winning over the env — mirroring ``serving_spec_from_env``."""
        if rank is None:
            rank = int(os.environ.get(ENV_RANK, '0') or 0)
        if world is None:
            world = int(os.environ.get(ENV_WORLD, '1') or 1)
        if coordinator is None:
            coordinator = os.environ.get(ENV_COORDINATOR) or None
        if gang_id is None:
            gang_id = os.environ.get(ENV_GANG_ID, '') or ''
        heartbeat = float(os.environ.get(ENV_HEARTBEAT, '0.5') or 0.5)
        hb_timeout = float(os.environ.get(ENV_HEARTBEAT_TIMEOUT,
                                          str(10 * heartbeat))
                           or 10 * heartbeat)
        spec = cls(
            gang_id=gang_id, rank=rank, world=world,
            coordinator=coordinator,
            join_timeout_s=float(os.environ.get(ENV_JOIN_TIMEOUT, '120')
                                 or 120),
            heartbeat_s=heartbeat,
            heartbeat_timeout_s=hb_timeout)
        if spec.is_gang and spec.rank > 0 and not spec.coordinator:
            raise ValueError(
                f'gang rank {spec.rank} of {spec.world} needs '
                f'{ENV_COORDINATOR} (rank 0\'s base URL)')
        if not 0 <= spec.rank < max(1, spec.world):
            raise ValueError(f'gang rank {spec.rank} out of range for '
                             f'world {spec.world}')
        return spec


def finished_digest(prompt: List[int], output: List[int]) -> str:
    """Digest of one finished request's full token stream — the unit
    of cross-rank byte-identity verification. Prompt is included so a
    rid collision across diverged admission orders cannot alias."""
    h = hashlib.sha256()
    h.update(json.dumps([list(map(int, prompt)),
                         list(map(int, output))]).encode())
    return h.hexdigest()[:16]


class GangDigest:
    """Per-rank accumulator of finished-request digests. Event *order*
    across requests is pipeline-timing dependent (the paged engine's
    eager drain), so lockstep is verified at request granularity — the
    full output stream of every finished request must match across
    ranks, which is timing-insensitive and byte-exact."""

    def __init__(self) -> None:
        self._streams: Dict[int, List[int]] = {}
        self.finished: 'Dict[int, str]' = {}

    def update(self, engine: Any,
               events: List[Tuple[int, int, bool]]) -> None:
        for rid, token, fin in events:
            self._streams.setdefault(rid, []).append(int(token))
            if fin:
                req = None
                if engine is not None:
                    # Finished request objects carry the authoritative
                    # (trimmed) output; fall back to the raw stream.
                    req = (engine._finished.get(rid)
                           if hasattr(engine, '_finished') else None)
                out = (list(req.output) if req is not None
                       else self._streams[rid])
                prompt = list(req.prompt) if req is not None else []
                self.finished[rid] = finished_digest(prompt, out)
                self._streams.pop(rid, None)
                while len(self.finished) > _MAX_FINISHED_DIGESTS:
                    self.finished.pop(next(iter(self.finished)))

    def drop(self, rid: int) -> None:
        """A cancelled request never finishes — forget its stream."""
        self._streams.pop(rid, None)


class GangFailure(RuntimeError):
    """A whole-gang failure: one dead/late/diverged rank fails the
    gang. ``cause`` is one of :data:`FAILURE_CAUSES`."""

    def __init__(self, cause: str, detail: str):
        super().__init__(detail)
        self.cause = cause


class _Member:
    __slots__ = ('rank', 'joined_at', 'last_seen', 'applied', 'acked')

    def __init__(self, rank: int, now: float):
        self.rank = rank
        self.joined_at = now
        self.last_seen = now
        self.applied = 0
        self.acked: set = set()


class GangCoordinator:
    """Rank 0's side of the gang bus: member registry + barrier, op
    log, command fan-out, heartbeat ages, divergence detection. Lives
    inside the leader's model-server process; followers reach it via
    ``POST /gang/sync`` on the same HTTP front end. Thread-safe (HTTP
    handler threads, the engine loop, and the monitor thread all
    touch it)."""

    def __init__(self, spec: GangSpec, *,
                 clock: Callable[[], float] = time.monotonic):
        self.spec = spec
        self._clock = clock
        self._lock = threading.Lock()
        self._started = clock()
        self._members: Dict[int, _Member] = {}
        self._joined = threading.Event()
        self._join_seconds: Optional[float] = None
        # Op log: ops[i] has global index _base + i. Trimmed up to the
        # slowest member's applied index.
        self._ops: List[Dict[str, Any]] = []
        self._base = 0
        self._commands: List[Dict[str, Any]] = []
        self._next_cid = 1
        self._acked_events: Dict[int, threading.Event] = {}
        self._failed: Optional[str] = None
        self._diverged: Optional[str] = None
        self.digest = GangDigest()
        reg = telemetry.get_registry()
        register_metrics()
        reg.gauge('skytpu_gang_size',
                  'Processes in this replica\'s gang '
                  '(0 = not a gang)').set(spec.world)
        self._h_join = reg.histogram('skytpu_gang_join_seconds')
        self._g_hb_age = reg.gauge('skytpu_gang_heartbeat_age_seconds')
        self._c_fail = {
            c: reg.counter('skytpu_gang_failures_total', cause=c)
            for c in FAILURE_CAUSES}

    # ------------------------------------------------------------ barrier
    @property
    def all_joined(self) -> bool:
        return self._joined.is_set()

    def barrier_wait(self, timeout: float) -> bool:
        """Bounded barrier wait (every distributed join carries a
        timeout)."""
        return self._joined.wait(timeout=timeout)

    @property
    def join_seconds(self) -> Optional[float]:
        return self._join_seconds

    # --------------------------------------------------------------- ops
    def append_op(self, op: Dict[str, Any]) -> int:
        """Append one engine op to the log; returns its global index.
        Called from the leader's engine loop (under the engine lock —
        this only takes the gang lock briefly)."""
        with self._lock:
            self._ops.append(op)
            return self._base + len(self._ops)

    @property
    def ops_len(self) -> int:
        with self._lock:
            return self._base + len(self._ops)

    # ----------------------------------------------------------- commands
    def command(self, kind: str,
                payload: Optional[Dict[str, Any]] = None) -> int:
        """Fan a control command (drain / checkpoint / shutdown /
        warmup) out to every follower; returns its command id. The
        command pins the CURRENT op-log index: followers ack only once
        they have applied every op up to it."""
        with self._lock:
            cid = self._next_cid
            self._next_cid += 1
            self._commands.append({
                'id': cid, 'kind': kind, 'payload': payload or {},
                'log_index': self._base + len(self._ops)})
            self._acked_events[cid] = threading.Event()
        return cid

    def acked(self, cid: int) -> bool:
        """True once every follower rank acked command ``cid``."""
        with self._lock:
            ranks = set(range(1, self.spec.world))
            return all(r in self._members
                       and cid in self._members[r].acked
                       for r in ranks)

    def wait_acked(self, cid: int, timeout: float) -> bool:
        """Bounded wait for the all-rank ack."""
        ev = self._acked_events.get(cid)
        if ev is None:
            return self.acked(cid)
        ev.wait(timeout=timeout)
        return self.acked(cid)

    # --------------------------------------------------------------- sync
    def sync(self, rank: int, applied: int, acks: List[int],
             finished: Dict[str, str]) -> Dict[str, Any]:
        """One follower heartbeat: register/refresh the member, verify
        its finished-request digests against rank 0's, hand back the
        op-log tail and pending commands. The response for a failed
        gang carries ``failed`` — the follower self-terminates."""
        now = self._clock()
        if not 1 <= rank < self.spec.world:
            return {'failed': f'rank {rank} out of range for world '
                              f'{self.spec.world}'}
        with self._lock:
            if self._failed is not None:
                return {'failed': self._failed}
            m = self._members.get(rank)
            if m is None:
                m = self._members[rank] = _Member(rank, now)
                logger.info(f'gang {self.spec.gang_id or "?"}: rank '
                            f'{rank} joined '
                            f'({len(self._members) + 1}/'
                            f'{self.spec.world})')
                if len(self._members) == self.spec.world - 1:
                    self._join_seconds = now - self._started
                    self._h_join.observe(self._join_seconds)
                    self._joined.set()
                    logger.info(
                        f'gang {self.spec.gang_id or "?"}: barrier '
                        f'complete in {self._join_seconds:.2f}s')
            m.last_seen = now
            m.applied = max(m.applied, int(applied))
            for cid in acks:
                cid = int(cid)
                m.acked.add(cid)
                ev = self._acked_events.get(cid)
                if (ev is not None
                        and len(self._members) == self.spec.world - 1
                        and all(cid in mm.acked
                                for mm in self._members.values())):
                    ev.set()
            # Cross-rank byte-identity: every finished request's token
            # stream must match rank 0's. A mismatch is the
            # half-alive-replica failure mode — fail the gang fast.
            for rid_s, dg in (finished or {}).items():
                mine = self.digest.finished.get(int(rid_s))
                if mine is not None and mine != dg:
                    self._diverged = (
                        f'rank {rank} diverged on request {rid_s}: '
                        f'{dg} != leader {mine}')
                    return {'failed': self._diverged}
            start = max(0, int(applied) - self._base)
            ops = self._ops[start:start + _MAX_OPS_PER_SYNC]
            # The response base MUST be captured before the trim:
            # _trim_locked advances self._base, and a base inflated by
            # the just-dropped prefix would make the follower skip
            # exactly that many ops — silent divergence.
            base = self._base + start
            cmds = [c for c in self._commands
                    if c['id'] not in m.acked]
            self._trim_locked()
            return {'ok': True, 'ops': ops, 'base': base,
                    'commands': cmds,
                    'heartbeat_s': self.spec.heartbeat_s}

    def _trim_locked(self) -> None:
        if len(self._members) < self.spec.world - 1:
            return
        low = min(m.applied for m in self._members.values())
        drop = min(max(0, low - self._base), len(self._ops))
        if drop:
            del self._ops[:drop]
            self._base += drop

    # ------------------------------------------------------------ failure
    def fail(self, error: str) -> None:
        """Mark the gang failed: every subsequent follower sync gets
        the error and self-terminates (the leader's ``_fatal`` calls
        this — one dead rank, whole gang dead)."""
        with self._lock:
            if self._failed is None:
                self._failed = error

    @property
    def failed(self) -> Optional[str]:
        with self._lock:
            return self._failed

    def count_failure(self, cause: str) -> None:
        self._c_fail[cause if cause in FAILURE_CAUSES
                     else 'member_crash'].inc()

    def check(self) -> None:
        """Health check, called by the leader's monitor thread: raises
        :class:`GangFailure` on join-deadline expiry, follower
        heartbeat loss, or digest divergence. Also refreshes the
        heartbeat-age gauge."""
        now = self._clock()
        with self._lock:
            diverged = self._diverged
            joined = self._joined.is_set()
            elapsed = now - self._started
            ages = {r: now - m.last_seen
                    for r, m in self._members.items()}
        if diverged:
            raise GangFailure('divergence', diverged)
        self._g_hb_age.set(max(ages.values()) if ages else 0.0)
        if not joined:
            if elapsed > self.spec.join_timeout_s:
                missing = sorted(set(range(1, self.spec.world))
                                 - set(ages))
                raise GangFailure(
                    'join_timeout',
                    f'gang join timeout after {elapsed:.1f}s '
                    f'(> {self.spec.join_timeout_s:.1f}s); missing '
                    f'rank(s) {missing}')
            return
        for rank, age in ages.items():
            if age > self.spec.heartbeat_timeout_s:
                raise GangFailure(
                    'heartbeat_lost',
                    f'gang member rank {rank} heartbeat lost '
                    f'({age:.1f}s > '
                    f'{self.spec.heartbeat_timeout_s:.1f}s)')

    # ------------------------------------------------------------- status
    def status(self) -> Dict[str, Any]:
        now = self._clock()
        with self._lock:
            return {
                'gang_id': self.spec.gang_id,
                'world': self.spec.world,
                'barrier': self._joined.is_set(),
                'join_seconds': self._join_seconds,
                'ops': self._base + len(self._ops),
                'failed': self._failed,
                'members': {
                    str(r): {'applied': m.applied,
                             'heartbeat_age_s': round(
                                 now - m.last_seen, 3)}
                    for r, m in self._members.items()},
            }


def apply_warmup(engine: Any, blob: bytes) -> int:
    """Land a checkpoint container into an engine's prefix cache —
    the follower-side twin of the server's ``warm_from_checkpoint``
    (same entry order, same capacity-stop semantics, so every rank's
    cache state stays identical). Returns rows warmed."""
    from skypilot_tpu_torch.inference import kv_transfer
    entries = kv_transfer.decode_checkpoint(blob)
    warmed = 0
    for entry in entries:
        try:
            warmed += engine.warm_prefix(entry)
        except kv_transfer.HandoffCapacityError:
            break
    return warmed


class GangFollower:
    """A nonzero rank's whole life: join rank 0's coordinator within
    the join timeout, then heartbeat/sync — applying the leader's op
    log to the local engine so every rank executes the same engine
    steps in the same order — until shutdown, coordinator loss, or an
    injected crash. ``run()`` returns the exit cause; the process
    wrapper exits with it. Self-termination on coordinator loss is
    the follower half of the one-dead-all-dead contract."""

    def __init__(self, spec: GangSpec, engine: Any, *,
                 faults: Optional[Any] = None,
                 stop: Optional[threading.Event] = None,
                 rng: Optional[random.Random] = None):
        if not spec.is_gang or spec.rank == 0:
            raise ValueError('GangFollower needs a nonzero gang rank')
        self.spec = spec
        self.engine = engine
        self._faults = faults
        self._stop = stop or threading.Event()
        self._rng = rng or random.Random()
        self._applied = 0
        self._acks: List[int] = []
        self._done_acks: set = set()
        self.digest = GangDigest()
        self._new_finished: Dict[int, str] = {}
        self.exit_cause: Optional[str] = None
        self.ops_applied = 0

    # ------------------------------------------------------------ protocol
    def _sync_once(self) -> Optional[Dict[str, Any]]:
        payload = {
            'rank': self.spec.rank,
            'gang_id': self.spec.gang_id,
            'applied': self._applied,
            'acks': list(self._acks),
            'finished': {str(r): d
                         for r, d in self._new_finished.items()},
        }
        out = wire.post_json(self.spec.coordinator + '/gang/sync',
                             payload, timeout=_SYNC_HTTP_TIMEOUT)
        self._new_finished.clear()
        self._acks.clear()        # delivered; coordinator recorded them
        return out

    def _note_events(self, events) -> None:
        before = set(self.digest.finished)
        self.digest.update(self.engine, events)
        for rid in set(self.digest.finished) - before:
            self._new_finished[rid] = self.digest.finished[rid]
        for rid, _tok, fin in events:
            if fin:
                self.engine.pop_finished(rid)

    def _apply_op(self, op: Dict[str, Any]) -> None:
        k = op.get('k')
        if k == 'add':
            rid = self.engine.add_request(
                op['prompt'], max_new_tokens=op['max_new_tokens'],
                temperature=op.get('temperature', 0.0),
                top_k=op.get('top_k', 0), top_p=op.get('top_p', 1.0),
                eos_id=op.get('eos_id'), stop=op.get('stop'),
                adapter=op.get('adapter'), tenant=op.get('tenant'),
                grammar=op.get('grammar'),
                priority=op.get('priority', 0))
            if rid != op['rid']:
                raise GangFailure(
                    'divergence',
                    f'rank {self.spec.rank} assigned request id {rid} '
                    f'where leader assigned {op["rid"]} — engine call '
                    'streams diverged')
            if op.get('trace_id') and hasattr(self.engine,
                                              'adopt_trace_context'):
                # Follower spans join the leader's fleet trace: the
                # op log is a replicated hop, tagged as such.
                self.engine.adopt_trace_context(
                    rid, trace_id=op['trace_id'],
                    parent_span='gang_oplog:rank0')
        elif k == 'step':
            self._note_events(self.engine.follower_step(
                op.get('h', 1), prepared=op.get('prepared', False)))
        elif k == 'cancel':
            self.engine.cancel(op['rid'])
            self.digest.drop(op['rid'])
        elif k == 'release_hold':
            self.engine.release_hold(op['rid'])
        elif k == 'flush':
            self._note_events(self.engine.drain_pipeline())
        elif k == 'warmup':
            apply_warmup(self.engine,
                         base64.b64decode(op['blob']))
        else:
            logger.warning(f'gang rank {self.spec.rank}: unknown op '
                           f'{k!r} skipped')
        self.ops_applied += 1

    def _handle_commands(self, cmds: List[Dict[str, Any]]) -> bool:
        """Ack every command whose pinned op-log index we have reached
        (drain/checkpoint consistency: the ack MEANS 'my engine state
        includes everything up to your index'). Returns True on a
        shutdown command."""
        shutdown = False
        for c in cmds:
            cid = int(c['id'])
            if cid in self._done_acks:
                continue
            if self._applied < int(c.get('log_index', 0)):
                continue          # not caught up yet; ack next sync
            if c.get('kind') == 'shutdown':
                shutdown = True
            self._done_acks.add(cid)
            if cid not in self._acks:
                self._acks.append(cid)
        return shutdown

    # ----------------------------------------------------------------- run
    def run(self) -> str:
        """The follower loop. Returns the exit cause:
        ``shutdown`` (clean), ``coordinator_lost`` (rank 0 gone past
        the heartbeat timeout — self-terminate), ``coordinator_failed``
        (rank 0 reported the gang failed), ``join_timeout`` (never got
        through the barrier window), or ``stopped`` (local stop event).
        An injected ``gang_member_crash`` raises — the process dies
        exactly as a real crash would."""
        from skypilot_tpu_torch.serve import faults as faults_lib
        spec = self.spec
        if self._faults is not None:
            # Deterministic partial-gang failures: a rank that never
            # joins (replica_crash) or joins late (engine_stall) at
            # the gang_join_timeout site, rank-targeted.
            rule = self._faults.fire('gang_join_timeout',
                                    rank=spec.rank)
            if rule is not None:
                if rule.kind == 'replica_crash':
                    logger.warning(
                        f'gang rank {spec.rank}: injected join '
                        'failure; never joining')
                    return self._exit('join_timeout')
                if rule.kind == 'engine_stall':
                    time.sleep(rule.delay_s)
        join_deadline = time.monotonic() + spec.join_timeout_s
        joined = False
        last_ok = time.monotonic()
        while not self._stop.is_set():
            if self._faults is not None:
                rule = self._faults.fire('gang_member_crash',
                                        rank=spec.rank)
                if rule is not None and rule.kind == 'replica_crash':
                    raise faults_lib.InjectedFault(
                        f'injected gang_member_crash on rank '
                        f'{spec.rank}')
            try:
                resp = self._sync_once()
            except Exception as e:  # pylint: disable=broad-except
                now = time.monotonic()
                logger.debug(f'gang rank {spec.rank}: sync failed '
                             f'({type(e).__name__}: {e})')
                if not joined and now > join_deadline:
                    return self._exit('join_timeout')
                if joined and now - last_ok > spec.heartbeat_timeout_s:
                    logger.warning(
                        f'gang rank {spec.rank}: coordinator lost '
                        f'({now - last_ok:.1f}s > '
                        f'{spec.heartbeat_timeout_s:.1f}s); '
                        'self-terminating (one dead rank = dead gang)')
                    return self._exit('coordinator_lost')
                self._sleep()
                continue
            last_ok = time.monotonic()
            if resp is None or resp.get('failed'):
                logger.warning(
                    f'gang rank {spec.rank}: coordinator reports gang '
                    f'failed ({(resp or {}).get("failed")}); '
                    'self-terminating')
                return self._exit('coordinator_failed')
            joined = True
            ops = resp.get('ops') or []
            base = int(resp.get('base', self._applied))
            for i, op in enumerate(ops):
                if base + i < self._applied:
                    continue          # already applied (resync overlap)
                self._apply_op(op)
                self._applied = base + i + 1
            if self._handle_commands(resp.get('commands') or []):
                # Flush the final acks so rank 0 sees the shutdown ack.
                try:
                    self._sync_once()
                except Exception:  # pylint: disable=broad-except
                    logger.debug('gang final ack sync failed '
                                 '(coordinator already gone)')
                return self._exit('shutdown')
            if not ops:
                self._sleep()
        return self._exit('stopped')

    def _exit(self, cause: str) -> str:
        self.exit_cause = cause
        return cause

    def _sleep(self) -> None:
        # Jittered idle poll (no fixed-period loops).
        self._stop.wait(timeout=self.spec.heartbeat_s
                        * (0.5 + self._rng.random()))
