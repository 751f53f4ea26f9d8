"""Deterministic, seedable fault injection for the serve stack (own
copy of ``skypilot_tpu/serve/faults.py`` on the port's telemetry: the
same kinds, sites, spec format, validation, RNG and metric names).

Each rule names a *kind* (what happens) and a *site* (where the hook
lives) and fires at an exact, reproducible point: the Nth invocation of
the site (``at``), every Nth (``every``), or with a probability drawn
from the spec-seeded RNG (``prob``); ``count`` caps its fires. The spec
is a JSON object, from the ``fault_spec`` argument or the
``SKYTPU_FAULT_SPEC`` environment variable (JSON, or ``@/path`` to a
JSON file)::

    {"seed": 42,
     "rules": [
       {"kind": "wedged_step", "site": "engine_step", "at": 3},
       {"kind": "nan_logits", "site": "engine_step", "every": 50},
       {"kind": "partial_response", "site": "handoff", "at": 1},
       {"kind": "kv_corruption", "site": "kv_wire", "at": 1}]}

The port's model server (``serve/server.py``) fires these sites:

- ``engine_step``, once per engine-loop iteration with work, before the
  engine lock is taken. Kinds: ``engine_stall`` (sleep ``delay_s``),
  ``replica_crash`` (raise :class:`InjectedFault` into the loop's fatal
  path), ``wedged_step`` (the loop hangs inside the step window until
  the step watchdog degrades the replica), ``nan_logits`` (one live
  decoding request is evicted as the non-finite sentinel evicts it;
  latched until such a request exists).
- ``handoff``, once per attempted KV handoff of a prefill-role server.
  Kind ``partial_response``: the POST "fails" before it is sent, and the
  request decodes locally.
- ``kv_wire``, once per encoded handoff container. Kind
  ``kv_corruption`` flips one byte (:func:`corrupt_blob`); the
  receiver's checksum refuses it.

- ``gang_join_timeout``, once as a gang follower starts, on its own
  rank (``serve/gang.py``). Kind ``replica_crash``: the rank never
  joins (the leader fails the gang with cause ``join_timeout``); kind
  ``engine_stall``: it joins ``delay_s`` late.
- ``gang_member_crash``, once per heartbeat of a gang follower, on its
  own rank. Kind ``replica_crash``: the rank dies (an ``InjectedFault``
  ends its process), and the leader fails the gang with cause
  ``heartbeat_lost``.

A rule with ``rank`` set fires only on that rank's invocations. The
other sites (the load balancer's, the replica manager's and the fleet
simulator's) belong to modules that are not ported; their rules still
validate, so one spec serves both packages.

Disabled, the hooks cost one attribute check: the server resolves its
injector once, and nothing under ``inference/`` refers to this module.
Every fire counts in ``skytpu_faults_injected_total{kind}``;
:func:`register_metrics` registers the stable series up front.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
from typing import Any, Dict, List, Optional

import logging

from skypilot_tpu_torch import telemetry

logger = logging.getLogger(__name__)

FAULT_SPEC_ENV = 'SKYTPU_FAULT_SPEC'

# The stable label set of skytpu_faults_injected_total{kind}.
# 'zone_outage' and 'straggler' are the fleet-simulator storm kinds
# (serve/sim/): a zone outage kills every replica in a zone at once; a
# straggler degrades a replica's service rate without killing it.
# The gray-failure kinds model failures that do NOT announce
# themselves — the replica keeps answering HTTP while serving wrong
# bytes or nothing at all:
# - 'wedged_step': the engine loop hangs inside a step forever (a
#   stuck device call / dead accelerator) — the wedge watchdog must
#   flip readiness to degraded and fail in-flight work over.
# - 'nan_logits': one live request's logits go non-finite — the
#   on-device sentinel must evict exactly that request (retryable)
#   while its co-batched neighbors continue.
# - 'kv_corruption': one byte of an encoded KV container (handoff /
#   checkpoint) flips in transit — the CRC-checked decoder must refuse
#   it all-or-nothing (fallback-local / cold-boot, never wrong bytes).
# - 'byzantine_response': a replica answers the manager's known-digest
#   canary prompt WRONG — silent data corruption; the manager must
#   quarantine it before it serves a second wrong response.
# The controller-failure kinds target the control plane
# itself:
# - 'controller_crash': the ServeController dies WITHOUT teardown —
#   replicas keep serving, the LB enters stale-while-revalidate, the
#   journal stays for the next boot.
# - 'controller_restart': a fresh controller boots with recover=True
#   and must reconcile the orphaned fleet (adopt, resume drains,
#   replay teardowns, reap zombies) instead of relaunching it.
FAULT_KINDS = ('replica_crash', 'probe_timeout', 'slow_response',
               'partial_response', 'engine_stall', 'preempt_signal',
               'zone_outage', 'straggler',
               'wedged_step', 'nan_logits', 'kv_corruption',
               'byzantine_response',
               'controller_crash', 'controller_restart', 'lb_crash')

# The stable label set of skytpu_gray_failures_total{kind}: detections
# by the gray-failure defense layer (watchdog fire, NaN eviction,
# checksum refusal, canary mismatch). Distinct from FAULT_KINDS —
# these count real DETECTIONS whether the cause was injected or not.
GRAY_FAILURE_KINDS = ('wedged_step', 'nan_logits', 'kv_corruption',
                      'byzantine_response')

# Injection sites (for spec validation; the hook call sites are the
# module docstring's list). The ``sim_*`` sites are fired by the fleet
# simulator's scenario clock (serve/sim/fleet.py), once per storm
# evaluation interval:
# - ``sim_storm`` — correlated spot-preemption storm: kind
#   ``preempt_signal`` with ``n`` kills the n most-recently-launched
#   SPOT replicas at once (the correlated-failure mode independent
#   per-replica rules can't express).
# - ``sim_zone_outage`` — kind ``zone_outage`` with ``zone`` kills
#   every replica placed in that zone in the same instant.
# - ``sim_straggler`` — kind ``straggler`` with ``factor`` multiplies
#   a replica's service time (slow HBM, noisy neighbor) without
#   killing it — the failure mode load-aware routing must absorb.
# - ``sim_gang_churn`` — kind ``replica_crash`` kills one gang
#   FOLLOWER cluster (rank picked by ``rank``, default 1) — the
#   one-dead-rank-dead-gang path at fleet scale.
# - ``kv_wire`` — fired wherever an encoded KV container leaves a
#   process (the prefill worker's handoff POST, the manager's
#   checkpoint fetch), once per transfer. Kind ``kv_corruption`` flips
#   one byte of the blob (offset ``n % len``) — the receiver's CRC
#   layer must refuse it.
# - ``canary`` — the manager's byzantine-detection canary probe, once
#   per canaried replica. Kind ``byzantine_response`` forces the
#   response digest to mismatch — the quarantine path runs exactly as
#   for a really-corrupt replica.
# - ``sim_gray`` — the fleet simulator's gray-failure storm site:
#   kinds ``wedged_step`` (replica accepts work, never finishes,
#   readiness degrades), ``nan_logits`` (evicts ``n`` in-flight
#   requests with retryable errors), ``byzantine_response`` (replica
#   answers canaries wrong until quarantined), ``kv_corruption``
#   (replica's next checkpoint export is garbage — its replacement
#   must boot cold, not byte-wrong).
# - ``controller_tick`` — the live controller's autoscaler loop, once
#   per iteration. Kind ``controller_crash`` stops the loop + HTTP API
#   dead (no teardown, no row writes) — the deterministic in-process
#   stand-in for a controller process crash.
# - ``sim_controller`` — the fleet simulator's storm clock. Kind
#   ``controller_crash`` halts the simulated controller's env (its
#   background tasks unwind, persistence stops landing);
#   ``controller_restart`` boots a fresh controller over the same
#   world with recover=True and reconciles.
# - ``sim_lb_crash`` — the fleet simulator's storm clock, horizontal
#   LB tier. Kind ``lb_crash`` kills one live load-balancer process
#   (highest index first): its policy state — probe caches, sticky
#   sessions, idempotency keys — is gone; the deterministic
#   client-side re-pick routes its sessions to the survivors, who must
#   lose ZERO requests (affinity re-forms from the replicas'
#   advertised digests).
FAULT_SITES = ('engine_step', 'probe', 'preempt', 'preempt_warning',
               'proxy', 'proxy_stream', 'http_response', 'handoff',
               'spot_preemption', 'gang_member_crash',
               'gang_join_timeout', 'sim_storm', 'sim_zone_outage',
               'sim_straggler', 'sim_gang_churn', 'kv_wire', 'canary',
               'sim_gray', 'controller_tick', 'sim_controller',
               'sim_lb_crash')

# Outcomes of skytpu_requests_migrated_total{outcome}: a migrated
# request either completed on a surviving replica or exhausted every
# replica and got the retryable error.
MIGRATION_OUTCOMES = ('completed', 'failed')


class InjectedFault(RuntimeError):
    """Raised by a ``replica_crash`` rule: the component's normal
    fatal-error path runs, exactly as a real crash would drive it."""


# Every key a rule dict may carry. Parse-time strictness matters more
# here than anywhere else in the repo: a chaos spec with a typo'd
# trigger field ("att": 3) would otherwise parse into a rule that
# SILENTLY never fires — the test then passes because nothing was
# injected, which is the exact false confidence a chaos suite exists
# to kill.
_RULE_FIELDS = ('kind', 'site', 'at', 'every', 'prob', 'count',
                'delay_s', 'after_events', 'rank', 'n', 'zone',
                'factor')
# Top-level spec keys.
_SPEC_FIELDS = ('seed', 'rules')


@dataclasses.dataclass
class FaultRule:
    kind: str
    site: str
    at: Optional[int] = None          # fire on the Nth invocation
    every: Optional[int] = None       # fire on every Nth invocation
    prob: float = 0.0                 # fire with seeded probability
    count: Optional[int] = None       # max total fires (None = no cap)
    delay_s: float = 0.25             # stall/slow-response duration
    after_events: int = 0             # proxy_stream: break after N events
    rank: Optional[int] = None        # gang sites: target this rank only
    n: int = 1                        # sim_storm: replicas per storm
    zone: Optional[str] = None        # sim_zone_outage: zone to kill
    factor: float = 4.0               # straggler: service-time multiplier
    fired: int = 0                    # bookkeeping (not a spec field)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> 'FaultRule':
        kind = d.get('kind')
        site = d.get('site')
        if kind not in FAULT_KINDS:
            raise ValueError(f'unknown fault kind {kind!r}; supported: '
                             f'{FAULT_KINDS}')
        if site not in FAULT_SITES:
            raise ValueError(f'unknown fault site {site!r}; supported: '
                             f'{FAULT_SITES}')
        unknown = sorted(set(d) - set(_RULE_FIELDS))
        if unknown:
            raise ValueError(
                f'unknown fault-rule field(s) {unknown} in rule '
                f'{{kind={kind!r}, site={site!r}}}; supported: '
                f'{_RULE_FIELDS} (a typo here would otherwise make '
                'the rule silently never fire)')
        def _opt_int(key: str) -> Optional[int]:
            # Presence-based (not truthiness): an explicit 0 must hit
            # the range validation below, not silently become "unset".
            return (int(d[key]) if key in d and d[key] is not None
                    else None)

        rule = cls(kind=kind, site=site,
                   at=_opt_int('at'),
                   every=_opt_int('every'),
                   prob=float(d.get('prob', 0.0)),
                   count=_opt_int('count'),
                   delay_s=float(d.get('delay_s', 0.25)),
                   after_events=int(d.get('after_events', 0)),
                   rank=(int(d['rank']) if 'rank' in d
                         and d['rank'] is not None else None),
                   n=max(1, int(d.get('n', 1))),
                   zone=(str(d['zone']) if d.get('zone') is not None
                         else None),
                   factor=float(d.get('factor', 4.0)))
        if rule.at is None and rule.every is None and rule.prob <= 0.0:
            raise ValueError(
                f'fault rule {{kind={kind!r}, site={site!r}}} has no '
                "trigger: set at least one of 'at' (Nth invocation), "
                "'every' (every Nth) or 'prob' (seeded probability) — "
                'a trigger-less rule never fires')
        if not 0.0 <= rule.prob <= 1.0:
            raise ValueError(f'prob must be in [0, 1], got {rule.prob}')
        if rule.at is not None and rule.at < 1:
            raise ValueError(f'at is 1-based, got {rule.at}')
        if rule.every is not None and rule.every < 1:
            raise ValueError(f'every must be >= 1, got {rule.every}')
        return rule


class FaultInjector:
    """Evaluates the fault spec at each instrumented site. Thread-safe:
    the LB's handler threads, the probe loop and the engine loop all
    fire through one injector. Deterministic for a fixed spec: site
    invocation counters drive ``at``/``every`` and a spec-seeded RNG
    drives ``prob``."""

    def __init__(self, spec: Dict[str, Any]):
        unknown = sorted(set(spec) - set(_SPEC_FIELDS))
        if unknown:
            raise ValueError(
                f'unknown fault-spec key(s) {unknown}; supported: '
                f'{_SPEC_FIELDS}')
        self.seed = int(spec.get('seed', 0))
        self._rng = random.Random(self.seed)
        self._rules: List[FaultRule] = [
            FaultRule.from_dict(r) for r in spec.get('rules', [])]
        self._site_counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        reg = telemetry.get_registry()
        self._counters = {
            kind: reg.counter(
                'skytpu_faults_injected_total',
                'Faults injected by the deterministic fault-injection '
                'subsystem', kind=kind) for kind in FAULT_KINDS}

    def fire(self, site: str,
             rank: Optional[int] = None) -> Optional[FaultRule]:
        """Count one invocation of ``site``; return the first rule
        that fires there (and record it in telemetry), else None.
        ``rank`` (the gang sites) scopes rank-targeted rules: a rule
        with ``rank`` set only fires on that rank's invocations. An
        UNSCOPED invocation (``rank=None`` — e.g. the fleet
        simulator's storm clock, which picks the victim rank FROM the
        rule) matches every rule; only a caller that declares its own
        rank filters rank-targeted rules."""
        with self._lock:
            n = self._site_counts.get(site, 0) + 1
            self._site_counts[site] = n
            for rule in self._rules:
                if rule.site != site:
                    continue
                if (rule.rank is not None and rank is not None
                        and rank != rule.rank):
                    continue
                if rule.count is not None and rule.fired >= rule.count:
                    continue
                hit = ((rule.at is not None and n == rule.at)
                       or (rule.every is not None
                           and n % rule.every == 0)
                       or (rule.prob > 0.0
                           and self._rng.random() < rule.prob))
                if not hit:
                    continue
                rule.fired += 1
                self._counters[rule.kind].inc()
                logger.warning(
                    'fault injected: kind=%s site=%s invocation=%d '
                    '(fire #%d)', rule.kind, site, n, rule.fired)
                return rule
        return None

    def site_count(self, site: str) -> int:
        with self._lock:
            return self._site_counts.get(site, 0)


def parse_spec(raw: str) -> Dict[str, Any]:
    """Parse a fault spec: a JSON object, or ``@/path`` to a JSON
    file."""
    if raw.startswith('@'):
        with open(raw[1:], encoding='utf-8') as f:
            raw = f.read()
    spec = json.loads(raw)
    if not isinstance(spec, dict):
        raise ValueError('fault spec must be a JSON object')
    return spec


def make_injector(spec: Optional[Any] = None) -> Optional[FaultInjector]:
    """Build an injector from an explicit spec (dict or JSON string),
    falling back to ``SKYTPU_FAULT_SPEC``; None when neither is set —
    the hooks then cost one attribute check."""
    if spec is None:
        raw = os.environ.get(FAULT_SPEC_ENV)
        if not raw:
            return None
        spec = parse_spec(raw)
    elif isinstance(spec, str):
        spec = parse_spec(spec)
    return FaultInjector(spec)


def get_injector() -> Optional[FaultInjector]:
    """Alias of :func:`make_injector` with no explicit spec — the
    spelling env-configured components resolve at construction."""
    return make_injector(None)


def gray_failure_counter(kind: str) -> 'telemetry.Counter':
    """The gray-failure DETECTION counter for ``kind`` (one of
    :data:`GRAY_FAILURE_KINDS`) — ticked by the watchdog, the NaN
    eviction path, the checksum refusal paths and the canary
    quarantine, injected or real alike."""
    return telemetry.get_registry().counter(
        'skytpu_gray_failures_total',
        'Gray failures detected by the data-plane defense layer',
        kind=kind)


def corrupt_blob(blob: bytes, rule: 'FaultRule') -> bytes:
    """Deterministically flip one byte of an encoded container (the
    ``kv_corruption`` kind at the ``kv_wire`` site): byte at offset
    ``rule.n % len(blob)`` XOR 0xff — the receiver's CRC layer must
    turn this into a loud, retryable refusal."""
    if not blob:
        return blob
    off = rule.n % len(blob)
    out = bytearray(blob)
    out[off] ^= 0xff
    return bytes(out)


def register_metrics() -> None:
    """Register the robustness series up front — zeros from the first
    scrape whether or not any fault, drain or migration ever happens
    (the reference's stable schema):

    - ``skytpu_faults_injected_total{kind}`` for every kind,
    - ``skytpu_gray_failures_total{kind}`` for every gray kind,
    - ``skytpu_requests_migrated_total{outcome}`` for every outcome,
    - ``skytpu_replica_drain_seconds`` (drain start -> idle),
    - ``skytpu_replica_recovery_seconds`` (failure detected -> stream
      resumed on a surviving replica).
    """
    reg = telemetry.get_registry()
    for kind in FAULT_KINDS:
        reg.counter('skytpu_faults_injected_total',
                    'Faults injected by the deterministic '
                    'fault-injection subsystem', kind=kind)
    for kind in GRAY_FAILURE_KINDS:
        gray_failure_counter(kind)
    for outcome in MIGRATION_OUTCOMES:
        reg.counter('skytpu_requests_migrated_total',
                    'In-flight requests migrated off a failed replica',
                    outcome=outcome)
    reg.histogram('skytpu_replica_drain_seconds',
                  'Graceful-drain duration: drain start to idle (s)',
                  buckets=telemetry.registry.DEFAULT_SECONDS_BUCKETS)
    reg.histogram('skytpu_replica_recovery_seconds',
                  'Mid-stream migration: replica failure detected to '
                  'stream resumed on a surviving replica (s)',
                  buckets=telemetry.registry.DEFAULT_SECONDS_BUCKETS)
