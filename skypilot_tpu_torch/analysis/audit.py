"""Steady-state audit of the engines' decode program (port of the
steady-state gates of ``skypilot_tpu/analysis/jaxpr_audit.py``:
``audit_engine`` :592, ``audit_multistep`` :702 and
``audit_spec_multistep`` :765).

The reference's contract for a serving engine in steady state, and how
the port observes each part:

- **No recompiles.** The reference counts its jit caches before and
  after the audited rounds; here a new program is a new CUDA graph, so
  the engine's graph captures must not grow. On the CPU, which has no
  graphs, the static key of every audited dispatch must be one the
  warm-up already used (a new key is what would be captured).
- **No unsanctioned device->host copies.** On CUDA the audited rounds
  run under PyTorch's sync debug mode ('warn': every synchronizing call
  is recorded with its Python location, so one run lists every site);
  ``utils.device.host_sync``, the engines' lagged token readback, lifts
  the mode for its own copy only. The mode is process-wide, so the
  audit drives the engine from the calling thread alone.
- **One dispatch per k tokens** under ``decode_steps_per_call=k``
  (``audit_multistep``): equal budget-bound prompts keep the slots in
  lockstep, ``max_new_tokens = 2k + 1`` is one first token from prefill
  and 2k decode tokens, so each audited round dispatches exactly two
  decode calls, each at horizon k.
- **Speculative rounds** (``audit_engine(speculate_k=k)``): every
  verify dispatch ends in exactly ONE sanctioned sync (``host_sync``
  calls on the driving thread, less the pipeline's token readbacks),
  and its static key carries (k, sample, P or kv_bucket).
  ``audit_spec_multistep(k, steps)``: with ``decode_steps_per_call =
  steps`` the fused engine dispatches once per ``steps`` rounds of a
  single-round engine's count on the same wave, with no single-round
  fallback.
- **Telemetry is free at the device boundary**
  (``audit_telemetry_parity``, after the reference's ``jaxpr_audit.py``
  :1047): the same requests on an engine with telemetry off and on give
  the same token streams, the same graph captures, and the telemetry-on
  rounds no unsanctioned sync and no steady-state capture (every span,
  phase and counter is a host clock outside the captured callables).
- **KV handoff and warm-up** (``audit_handoff``): the decode that
  follows an ``ingest_kv_snapshot`` (or a ``warm_prefix`` and the
  prefix hits it gives) replays the graphs the warm-up captured, and
  the landing itself makes no unsanctioned sync: its rows go up through
  pinned non-blocking copies and are written in place.

- **Adapter churn** (``audit_adapters``): with a multi-LoRA bank and
  grammar masks live, rounds whose requests load and evict adapters
  (more adapters than bank slots) capture no graph after the warm-up
  and make no unsanctioned sync. The bank-row upload is the one
  host-to-device copy an adapter load adds (pinned, non-blocking, in
  place: the bank's storage never moves, which the audit checks).

- **Cost and hygiene of the captured dispatches** (every engine audit):
  the audit captures its engine's steady-state decode (or speculative)
  dispatch (``costmodel.Capture``) and prices it on meta copies of the
  engine's state (``costmodel.engine_dispatch_costs``): the per-class
  bytes land in ``dispatch_costs``, and a host read or a float64 result
  inside the program is a violation (the reference's callback
  primitives and float64 promotions). :func:`run_preset` arms the
  preset's byte budget (``costmodel.BYTE_BUDGETS``) for the device type
  it ran on.
- **The presets table** (:data:`PRESETS`, :data:`DEFAULT_PRESETS`,
  :func:`run_preset`; the reference's ``jaxpr_audit.py`` :1200-1333),
  with the reference's ``llama`` (the forward traced on meta),
  ``disagg`` (a decode worker fed by another engine's KV snapshots
  over the SKKV codec makes no prefill call and no capture), ``digest``
  and ``fleet-obs`` (a host-side scrape after every wave adds no sync
  and no capture, and every scrape returns data).
- **The multi-device presets** (:data:`MULTI_DEVICE_PRESETS`:
  ``paged-tp`` and ``paged-tp-int8`` at tp = 2, ``paged-gang`` at
  (tp = 2, dp = 2)): the paged audit on a serving mesh
  (``parallel/mesh.py``; gloo ranks on the CPU), with the collective
  census (:attr:`AuditReport.collectives`: what one steady decode step
  and one merge issue, by op and axis, through the mesh's helpers; a
  CUDA graph's replays count what its capture recorded). The port's rule
  is exact where the reference's is a bound (``jaxpr_audit.py``
  ``collective_violations``): a tp step issues one all-reduce after
  ``wo`` and one after ``w_down`` per layer and one all-gather of the
  logits; under dp the merge all-gathers the ring's k and v rows and
  the tokens over dp; no collective carries pool pages, and none is an
  all-to-all.

The static key of a dispatch is what the engine's graph cache is keyed
by: (horizon, sample, P) on the paged engine, (horizon, sample,
kv_bucket) on the slot engine; the audit records it by wrapping the
engine's ``_decode_call``. A speculative dispatch's key is the graph
key (``('spec', k, sample, P|kv_bucket)``, ``('spec_fused', ...,
rounds)``), recorded by wrapping the engine's ``_run_graph``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.analysis import costmodel
from skypilot_tpu_torch.models import configs, llama
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.utils.device import (DeviceLike, host_sync_count,
                                             resolve_device)

# The warning PyTorch's sync debug mode raises at a synchronizing call.
_SYNC_WARNING = 'synchronizing CUDA operation'


@dataclasses.dataclass
class AuditReport:
    name: str
    device: str
    # Static key of every decode dispatch in the audited rounds, in order.
    static_keys: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    # Keys the warm-up dispatched (what the graph cache holds after it).
    warmup_keys: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    # Unsanctioned synchronizing calls, as 'file:line: message'.
    syncs: List[str] = dataclasses.field(default_factory=list)
    # Graph captures before and after the audited rounds (CUDA).
    captures: Tuple[int, int] = (0, 0)
    # audit_multistep: the pinned k and the dispatches the rounds must
    # make (None: not checked).
    k: Optional[int] = None
    expected_dispatches: Optional[int] = None
    # Speculative audits: the k every key must carry, the fused rounds
    # every fused key must carry, the sanctioned syncs of the
    # speculative rounds (host_sync calls less pipeline readbacks) and
    # the single-round fallbacks of a fused engine (None: not checked).
    speculate_k: Optional[int] = None
    rounds: Optional[int] = None
    spec_syncs: Optional[int] = None
    fallbacks: Optional[int] = None
    # audit_handoff: KV rows landed (ingested or warmed) and the paged
    # engine's prefix hits in the audited rounds.
    landed_rows: Optional[int] = None
    prefix_hits: Optional[int] = None
    # audit_telemetry_parity: whether the token streams of the
    # telemetry-off and telemetry-on engines are equal, their graph
    # captures (off, on), and the telemetry-off run's own violations.
    streams_equal: Optional[bool] = None
    captures_by_mode: Optional[Tuple[int, int]] = None
    off_violations: List[str] = dataclasses.field(default_factory=list)
    # audit_adapters: bank loads and evictions in the audited rounds,
    # whether the bank's storage stayed where the graphs captured it,
    # and whether every grammar request's tokens lay inside its mask.
    adapter_loads: Optional[int] = None
    adapter_evictions: Optional[int] = None
    bank_moved: Optional[bool] = None
    grammar_ok: Optional[bool] = None
    # Named (expected, actual) counts an audit holds (the reference's
    # compile_counts pairs): a mismatch is a violation.
    checks: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)
    # The cost model (analysis/costmodel.py): label -> DispatchCost of
    # the captured steady-state dispatches; the preset's byte budget
    # (armed by run_preset), the BYTE_BUDGETS key a default preset had
    # no entry for, and the error of a failed pricing.
    preset: str = ''
    dispatch_costs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    byte_budget: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    missing_budget: str = ''
    cost_error: str = ''
    # Host reads (aten._local_scalar_dense, copies to the CPU) and
    # float64 results inside the priced programs, each with its site.
    host_reads: List[str] = dataclasses.field(default_factory=list)
    f64_promotions: List[str] = dataclasses.field(default_factory=list)
    # The multi-device presets: the mesh's axis sizes, the collective
    # census of one steady decode step ('decode') and one merge
    # ('merge'), by 'op[axis]', the census the model's layout implies,
    # the shapes of every collective the audited rounds issued
    # ('op[axis] shape dtype' -> count), and the dims a tensor carrying
    # pool pages has (the local pool's ``[n_pages, hkv, page]``).
    mesh: Dict[str, int] = dataclasses.field(default_factory=dict)
    collectives: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    expected_collectives: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    collective_shapes: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    pool_pages_shape: Tuple[int, ...] = ()

    def collective_violations(self) -> List[str]:
        """The census gate (mesh presets): the decode step's and the
        merge's collectives must equal the expected census exactly, none
        may be an all-to-all, and none may carry pool pages (the
        resharding the reference's preset exists to ban)."""
        out = []
        if self.expected_collectives and not self.collectives:
            out.append('no collective census was recorded')
        for label in sorted(set(self.collectives)
                            | set(self.expected_collectives)):
            got = self.collectives.get(label, {})
            want = self.expected_collectives.get(label, {})
            if got != want:
                out.append(f'{label}: collectives {got} != {want}')
        k = len(self.pool_pages_shape)
        for key, n in sorted(self.collective_shapes.items()):
            op, shape = key.split(' ', 1)
            if 'all_to_all' in op:
                out.append(f'{n} {key}')
            dims = tuple(int(d) for d in shape.split(')')[0].strip(
                '(').split(',') if d.strip())
            if k and any(dims[i:i + k] == self.pool_pages_shape
                         for i in range(len(dims) - k + 1)):
                out.append(f'{n} collective(s) carry pool pages: {key}')
        return out

    @property
    def dispatches(self) -> int:
        return len(self.static_keys)

    @property
    def new_keys(self) -> List[Dict[str, Any]]:
        return [k for k in self.static_keys if k not in self.warmup_keys]

    def violations(self) -> List[str]:
        out = [f'unsanctioned sync: {s}' for s in self.syncs]
        if self.captures[1] != self.captures[0]:
            out.append(f'{self.captures[1] - self.captures[0]} graph '
                       'capture(s) in steady state')
        if self.new_keys:
            out.append(f'dispatch keys not seen in warm-up: '
                       f'{self.new_keys}')
        if (self.expected_dispatches is not None
                and self.dispatches != self.expected_dispatches):
            per = (f'one per {self.k} tokens' if self.rounds is None
                   else f'one per {self.rounds} rounds')
            out.append(f'{self.dispatches} dispatches, want '
                       f'{self.expected_dispatches} ({per})')
        if self.k is not None:
            bad = [key for key in self.static_keys
                   if key['horizon'] != self.k]
            if bad:
                out.append(f'dispatches at horizon != {self.k}: {bad}')
        if self.speculate_k is not None:
            bad = [key for key in self.static_keys
                   if key.get('k') != self.speculate_k]
            if bad:
                out.append(f'keys without k={self.speculate_k}: {bad}')
            if self.spec_syncs != self.dispatches:
                out.append(f'{self.spec_syncs} sanctioned syncs in '
                           f'{self.dispatches} speculative dispatches '
                           '(want one each)')
        if self.rounds is not None:
            bad = [key for key in self.static_keys
                   if key.get('rounds') != self.rounds]
            if bad:
                out.append(f'fused keys at rounds != {self.rounds}: {bad}')
        if self.fallbacks:
            out.append(f'{self.fallbacks} single-round fallback '
                       'dispatches')
        if self.streams_equal is False:
            out.append('token streams differ with telemetry off and on')
        if (self.captures_by_mode is not None
                and self.captures_by_mode[0] != self.captures_by_mode[1]):
            out.append(f'graph captures off {self.captures_by_mode[0]} '
                       f'!= on {self.captures_by_mode[1]}')
        out += [f'telemetry off: {v}' for v in self.off_violations]
        if self.adapter_evictions is not None and not (
                self.adapter_loads and self.adapter_evictions):
            out.append(f'no adapter churn in the audited rounds '
                       f'({self.adapter_loads} loads, '
                       f'{self.adapter_evictions} evictions)')
        if self.bank_moved:
            out.append('the adapter bank was reallocated')
        if self.grammar_ok is False:
            out.append('a grammar request emitted a token outside its '
                       'mask')
        for name, (want, got) in self.checks.items():
            if want != got:
                out.append(f'{name}: {got}, want {want}')
        out += [f'host read in a device program: {h}'
                for h in self.host_reads]
        out += [f'float64 in a device program: {f}'
                for f in self.f64_promotions]
        if self.cost_error:
            out.append(f'cost model failed: {self.cost_error}')
        out += [f'byte budget: {v}' for v in self.byte_budget_violations()]
        out += [f'collectives: {v}' for v in self.collective_violations()]
        return out

    def byte_budget_violations(self) -> List[str]:
        """The byte-budget gate: armed when a budget is declared for the
        preset (``run_preset``). A default preset without a budget for
        the device type it ran on, or a declared budget with no captured
        costs, is a loud failure, never a silent pass."""
        if self.missing_budget:
            return [f'no byte budget declared for {self.missing_budget!r} '
                    '(emit it: python -m skypilot_tpu_torch.analysis.'
                    'costmodel --emit-budgets)']
        if not self.byte_budget:
            return []
        if not self.dispatch_costs:
            return ['byte budget declared but no dispatch costs were '
                    'captured (the dispatch never ran through the capture?)']
        return costmodel.check_budget(self.dispatch_costs, self.byte_budget)

    def ok(self) -> bool:
        return not self.violations()

    def format(self) -> str:
        """The text report (the CLI's ``audit`` output)."""
        lines = [f'audit: {self.name}'
                 + (f' [{self.preset}]' if self.preset else '')
                 + f' on {self.device} - '
                 + ('OK' if self.ok() else 'VIOLATIONS')]
        lines.append(f'  dispatches: {self.dispatches}; graph captures '
                     f'{self.captures[0]} -> {self.captures[1]}')
        if self.static_keys:
            lines.append('  static keys: ' + str(
                [dict(k) for k in sorted({tuple(sorted(k.items()))
                                          for k in self.static_keys})]))
        for name, (want, got) in self.checks.items():
            lines.append(f'  {name}: {got} (want {want})')
        for label, counts in sorted(self.collectives.items()):
            lines.append(f'  collectives [{label}]: {counts} (want '
                         f'{self.expected_collectives.get(label, {})})')
        for label, cost in self.dispatch_costs.items():
            lines.append(f'  cost [{label}]: {cost.read_total:,} B read, '
                         f'{cost.written_total:,} B written, '
                         f'{cost.flops:,} FLOPs')
        for v in self.violations():
            lines.append(f'  VIOLATION: {v}')
        return '\n'.join(lines)

    def to_json(self) -> Dict[str, Any]:
        """The machine-readable report (the CLI's ``audit --json``):
        :meth:`as_dict` with the priced dispatches and the budget."""
        out = self.as_dict()
        out.update(
            dispatch_costs={k: c.to_json()
                            for k, c in self.dispatch_costs.items()},
            byte_budget=self.byte_budget, cost_error=self.cost_error,
            host_reads=list(self.host_reads),
            f64_promotions=list(self.f64_promotions))
        return out

    def as_dict(self) -> Dict[str, Any]:
        return {'name': self.name, 'device': self.device,
                'ok': self.ok(), 'dispatches': self.dispatches,
                'expected_dispatches': self.expected_dispatches,
                'static_keys': sorted({tuple(sorted(k.items()))
                                       for k in self.static_keys}),
                'unsanctioned_syncs': len(self.syncs),
                'spec_syncs': self.spec_syncs,
                'fallbacks': self.fallbacks,
                'landed_rows': self.landed_rows,
                'prefix_hits': self.prefix_hits,
                'streams_equal': self.streams_equal,
                'captures_by_mode': (list(self.captures_by_mode)
                                     if self.captures_by_mode else None),
                'adapter_loads': self.adapter_loads,
                'adapter_evictions': self.adapter_evictions,
                'sync_sites': self.syncs[:20],
                'captures_before_after': list(self.captures),
                'preset': self.preset,
                'checks': {k: list(v) for k, v in self.checks.items()},
                'dispatch_read_bytes': {k: c.read_total for k, c in
                                        self.dispatch_costs.items()},
                'byte_budget_violations': self.byte_budget_violations(),
                'mesh': dict(self.mesh),
                'collectives': {k: dict(v)
                                for k, v in self.collectives.items()},
                'expected_collectives': {
                    k: dict(v) for k, v in self.expected_collectives.items()},
                'collective_violations': self.collective_violations(),
                'violations': self.violations()}


def _tiny_engine(kind: str, cfg: ModelConfig, device: torch.device,
                 chunked: bool = True, **extra):
    """The reference audit's engine: max_batch 4, max_seq 128, prefill
    chunks of 16 (``chunked=False``: the slot engine's whole-prompt
    admission; the paged engine always prefills in chunks), random
    weights from seed 0."""
    if kind == 'paged':
        if not chunked:
            raise ValueError('the paged engine always prefills in chunks')
        from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
        return PagedInferenceEngine(cfg, max_batch=4, max_seq=128,
                                    prefill_chunk_tokens=16, device=device,
                                    **extra)
    if kind != 'slot':
        raise ValueError(f"kind must be 'paged' or 'slot', got {kind!r}")
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    return InferenceEngine(cfg, max_batch=4, max_seq=128,
                           prefill_chunk_tokens=16 if chunked else 0,
                           device=device, **extra)


def _third(engine) -> str:
    return ('P' if type(engine).__name__.startswith('Paged')
            else 'kv_bucket')


def _record_keys(engine, keys: List[Dict[str, Any]],
                 capture: Optional[Dict[str, Any]] = None) -> None:
    """Wrap the engine's decode call to log each dispatch's static key
    into ``keys`` and, with ``capture``, to keep the last dispatch of
    each key as a ``costmodel.Capture`` in ``capture['decode']``;
    ``_audited``
    removes the wrapper again (it refers to the engine, and an engine
    kept alive by a reference cycle would be freed, graphs and all, by
    whichever later collection runs)."""
    inner = engine._decode_call
    third = _third(engine)

    def shim(horizon, sample, key3):
        keys.append({'horizon': horizon, 'sample': sample, third: key3})
        if capture is not None:
            key = (horizon, sample, key3)
            capture.setdefault('decode', {})[key] = costmodel.Capture(
                engine, 'decode', key)
        return inner(horizon, sample, key3)

    engine._decode_call = shim


def _record_spec_keys(engine, keys: List[Dict[str, Any]],
                      capture: Optional[Dict[str, Any]] = None) -> None:
    """Wrap the engine's graph runner to log the key of each
    speculative dispatch (single rounds and fused calls) into ``keys``
    and, with ``capture``, to keep the last one of each key as a
    ``costmodel.Capture`` in ``capture['spec']``; ``_audited`` removes
    the wrapper."""
    inner = engine._run_graph
    third = _third(engine)

    def shim(key, body, sample=False):
        if key[0] == 'spec':
            keys.append({'k': key[1], 'sample': key[2], third: key[3]})
        elif key[0] == 'spec_fused':
            keys.append({'mode': 'fused', 'k': key[1], 'sample': key[2],
                         third: key[3], 'rounds': key[4]})
        if capture is not None and key[0] in ('spec', 'spec_fused'):
            ckey = (key[3], key[4] if key[0] == 'spec_fused' else 0)
            capture.setdefault('spec', {})[ckey] = costmodel.Capture(
                engine, 'spec', ckey)
        return inner(key, body, sample)

    engine._run_graph = shim


def _record_collectives(engine, census: Dict[str, Dict[str, int]]) -> None:
    """Wrap the engine's graph runner to keep, per graph label ('decode'
    for a step, 'merge'), the collectives its last run issued
    (``parallel.mesh.collective_counts`` around the run: a replay adds
    what its capture recorded); ``_audited`` removes the wrapper."""
    inner = engine._run_graph

    def shim(key, body, sample=False):
        before = dict(mesh_lib.collective_counts)
        out = inner(key, body, sample)
        label = {'step': 'decode'}.get(key[0], key[0])
        census[label] = {k: n - before.get(k, 0)
                         for k, n in mesh_lib.collective_counts.items()
                         if n != before.get(k, 0)}
        return out

    engine._run_graph = shim


def _forward_census(engine, *, dp_split: bool,
                    w8a8: bool) -> Dict[str, int]:
    """The collectives of one forward of a mesh engine, from its layout
    (``mesh.tp_plan``): per layer an all-reduce over tp after ``wo``
    (heads split) and after the FFN (mlp split: ``w_down``, or the MoE
    experts' combine), one all-gather over tp of the logits (vocab
    split); with ``w8a8`` a MAX all-reduce over tp of the row absmax
    before each of those row-parallel products that runs on int8
    activations (``wo``, and ``w_down`` of a dense FFN: the MoE experts'
    einsums stay W8A16); with ``dp_split``
    (a decode step's or a verify round's rows split over dp) an MoE
    layer's all-gather over dp of its input rows."""
    plan, mesh = engine._tp_plan, engine.mesh
    L = engine.cfg.n_layers
    out: Dict[str, int] = {}
    reduces = L * (int(plan['heads']) + int(plan['mlp']))
    if reduces:
        out['all_reduce[tp]'] = reduces
    maxes = L * (int(plan['heads'])
                 + int(plan['mlp'] and not engine.cfg.is_moe))
    if w8a8 and maxes:
        out['all_reduce_max[tp]'] = maxes
    if plan['vocab']:
        out['all_gather[tp]'] = 1
    if dp_split and engine.cfg.is_moe and mesh.shape['dp'] > 1:
        out['all_gather[dp]'] = L
    return out


def expected_census(engine) -> Dict[str, Dict[str, int]]:
    """The collectives each graph of a mesh engine's decode must issue,
    by graph label: one decode step ('decode', :func:`_forward_census`)
    and one merge ('merge': under dp three all-gathers over dp, the
    ring's k and v rows and the tokens); under ``speculate_k`` one
    verify round instead ('spec': the forward's, W8A8's MAX reductions
    too on the paged engine under ``prefill_w8a8``, and under dp the
    three all-gathers of the new k and v rows and the commits), or
    ``decode_steps_per_call`` fused rounds ('spec_fused', that many
    times one round's)."""
    dp = engine.mesh.shape['dp'] > 1
    gathers = {'all_gather[dp]': 3} if dp else {}
    if not engine.speculate_k:
        return {'decode': _forward_census(engine, dp_split=True,
                                          w8a8=False),
                'merge': gathers}
    from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
    # The slot engine's verify rounds stay W8A16, the paged engine's
    # take prefill's W8A8 (as in the reference).
    w8a8 = (bool(engine.prefill_w8a8)
            and isinstance(engine, PagedInferenceEngine))
    one = _forward_census(engine, dp_split=True, w8a8=w8a8)
    for key, n in gathers.items():
        one[key] = one.get(key, 0) + n
    rounds = engine.decode_steps_per_call or 1
    if rounds > 1:
        return {'spec_fused': {k: n * rounds for k, n in one.items()}}
    return {'spec': one}


def expected_prefill_census(engine, rows: Optional[int] = None
                            ) -> Dict[str, int]:
    """The collectives of one prefill call of ``rows`` batch rows
    (default ``max_batch``) on a mesh engine (a paged chunk, or a
    slot-engine prefill call): the forward's, W8A8's MAX reductions
    under ``prefill_w8a8``, and when dp splits the rows
    (``mesh.prefill_dp_rows``: dp > 1 dividing ``rows``) ONE all-gather
    over dp of the landed rows (with the last hidden states), plus an
    MoE layer's all-gather of its input rows. Prefill runs eagerly, so
    this is what ``mesh.collective_counts`` gains around one call."""
    dp = engine.mesh.shape['dp']
    rows = engine.max_batch if rows is None else rows
    split = dp > 1 and rows % dp == 0
    out = _forward_census(engine, dp_split=split,
                          w8a8=bool(engine.prefill_w8a8))
    if split:
        out['all_gather[dp]'] = out.get('all_gather[dp]', 0) + 1
    return out


def _record_prefill_census(census: Dict[str, Dict[str, int]],
                           rows: List[int]):
    """Wrap the prefill functions the engines call
    (``paged.paged_prefill_chunk``, ``llama.prefill_rows``) to keep the
    collectives of the last prefill call (label 'prefill') and its batch
    rows in ``rows[0]``; returns the undo."""
    from skypilot_tpu_torch.inference import paged as paged_mod
    targets = [(paged_mod, 'paged_prefill_chunk', 3),
               (llama, 'prefill_rows', 1)]
    saved = []
    for mod, name, tok_arg in targets:
        inner = getattr(mod, name)
        saved.append((mod, name, inner))

        def shim(*args, _inner=inner, _tok=tok_arg, **kwargs):
            if kwargs.get('all_logits'):
                return _inner(*args, **kwargs)
            before = dict(mesh_lib.collective_counts)
            out = _inner(*args, **kwargs)
            census['prefill'] = {
                k: n - before.get(k, 0)
                for k, n in mesh_lib.collective_counts.items()
                if n != before.get(k, 0)}
            rows[0] = int(args[_tok].shape[0])
            return out
        setattr(mod, name, shim)

    def undo():
        for mod, name, inner in saved:
            setattr(mod, name, inner)
    return undo


def _attach_costs(report: AuditReport, engine,
                  capture: Dict[str, Any]) -> None:
    """Price the captured steady-state dispatches
    (``costmodel.engine_dispatch_costs``) into the report, with the host
    reads and float64 results found in them: of each kind, the largest
    key seen (the widest dispatch, so the priced program does not
    depend on which call happened to come last). A failure lands in
    ``cost_error`` (a violation)."""
    try:
        costs = costmodel.engine_dispatch_costs(
            engine, [caps[max(caps)] for caps in capture.values()])
    except Exception as e:  # noqa: BLE001 - reported, not raised
        report.cost_error = f'{type(e).__name__}: {e}'
        return
    report.dispatch_costs.update(costs)
    for cost in costs.values():
        report.host_reads += cost.host_reads
        report.f64_promotions += cost.f64_promotions


def _count_calls(engine, name: str, counter: List[int]) -> None:
    """Wrap ``engine.<name>`` to count its calls into ``counter[0]``
    (removed again by ``del engine.<name>``)."""
    inner = getattr(engine, name)

    def counting(*args, **kwargs):
        counter[0] += 1
        return inner(*args, **kwargs)

    setattr(engine, name, counting)


def _audited(engine, report: AuditReport, keys: List[Dict[str, Any]],
             rounds: int, one_round,
             wrapped: Tuple[str, ...] = ('_decode_call',)) -> None:
    """Run ``rounds`` audited rounds: keys recorded into ``report``,
    captures counted, synchronizing calls recorded on CUDA; under
    speculation the sanctioned syncs of the rounds (every
    ``host_sync`` on this thread less the pipeline's readbacks in
    ``_process_one``). ``wrapped``: the engine attributes the audit
    wrapped, removed after the rounds."""
    report.warmup_keys = list(keys)
    keys.clear()
    readbacks = [0]
    _count_calls(engine, '_process_one', readbacks)
    syncs0 = host_sync_count()
    cuda = engine.device.type == 'cuda'
    before = engine.graph_stats()['graph_captures']
    if cuda:
        torch.cuda.synchronize(engine.device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        if cuda:
            torch.cuda.set_sync_debug_mode('warn')
        try:
            for _ in range(rounds):
                one_round()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
    if cuda:
        torch.cuda.synchronize(engine.device)
    for name in wrapped + ('_process_one',):      # drop the wrappers
        delattr(engine, name)
    if report.speculate_k is not None:
        report.spec_syncs = host_sync_count() - syncs0 - readbacks[0]
    report.static_keys = list(keys)
    report.captures = (before, engine.graph_stats()['graph_captures'])
    report.syncs = [f'{w.filename}:{w.lineno}: {w.message}'
                    for w in caught if _SYNC_WARNING in str(w.message)]


# The audits' wave: three prompts longer than one prefill chunk.
_WAVE_PROMPTS = [[1, 2, 3] * 9, [4, 5] * 10, [7] * 21]
# Repetitive prompts of the speculative audits: the n-gram proposer
# matches, and acceptance varies per slot.
_SPEC_PROMPTS = [[1, 2, 3, 4] * 7, [5, 6] * 11, [7, 8, 9] * 7]


def audit_engine(kind: str = 'slot', *, cfg: Optional[ModelConfig] = None,
                 chunked: bool = True,
                 rounds: int = 2, warmup_rounds: int = 1,
                 speculate_k: int = 0,
                 kv_cache_dtype: Optional[str] = None,
                 quantize: Optional[str] = None,
                 decode_impl: Optional[str] = None,
                 mesh_tp: int = 0, mesh_dp: int = 0,
                 device: DeviceLike = 'cuda') -> AuditReport:
    """Build a small engine (``cfg``, default ``TINY``), run
    ``warmup_rounds`` waves of three prompts longer than one prefill
    chunk (captures allowed), then audit ``rounds`` identical waves:
    a capture, a dispatch key the warm-up did not use or an
    unsanctioned sync in them is a violation. ``chunked=False``: the
    slot engine's whole-prompt admission. ``speculate_k > 0`` audits the
    speculative rounds on repetitive prompts instead: the verify
    dispatches' keys must carry k, and each must end in exactly one
    sanctioned sync. The last audited dispatch is priced
    (``dispatch_costs``). ``mesh_tp``/``mesh_dp`` run the engine on a
    serving mesh of that shape (``mesh.make_mesh`` on ``device``'s
    type; shut down before this returns) and take the collective census
    of the audited rounds."""
    dev = resolve_device(device)
    cfg = cfg or configs.TINY
    extra: Dict[str, Any] = {}
    for name, value in (('speculate_k', speculate_k or None),
                        ('kv_cache_dtype', kv_cache_dtype),
                        ('quantize', quantize),
                        ('decode_impl', decode_impl)):
        if value is not None:
            extra[name] = value
    tags = ''.join(f' + {k}={v}' for k, v in extra.items())
    if mesh_tp or mesh_dp:
        tags += f' + mesh tp={max(1, mesh_tp)} dp={max(1, mesh_dp)}'
    report = AuditReport(name=f'{kind} engine ('
                              f'{"chunked prefill + " if chunked else ""}'
                              f'decode{tags})', device=str(dev),
                         speculate_k=speculate_k or None)
    if not (mesh_tp or mesh_dp):
        _audit_engine_rounds(report, kind, cfg, dev, chunked, rounds,
                             warmup_rounds, speculate_k, extra)
        return report
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec.for_serving(
        tp=max(1, mesh_tp), dp=max(1, mesh_dp)), device=dev)
    try:
        _audit_engine_rounds(report, kind, cfg, dev, chunked, rounds,
                             warmup_rounds, speculate_k,
                             dict(extra, mesh=mesh))
    finally:
        mesh.shutdown()
    return report


def _audit_engine_rounds(report: AuditReport, kind: str, cfg, dev,
                         chunked: bool, rounds: int, warmup_rounds: int,
                         speculate_k: int, extra: Dict[str, Any]) -> None:
    """``audit_engine``'s waves and gates on an engine built with
    ``extra``; under a mesh also the collective census."""
    engine = _tiny_engine(kind, cfg, dev, chunked, **extra)
    mesh = extra.get('mesh')
    prompts = _SPEC_PROMPTS if speculate_k else _WAVE_PROMPTS

    def one_round():
        for p in prompts:
            engine.add_request(list(p), max_new_tokens=8)
        engine.run_to_completion(horizon=8)

    keys: List[Dict[str, Any]] = []
    capture: Dict[str, Any] = {}
    if speculate_k:
        _record_spec_keys(engine, keys, capture)
        wrapped = ('_run_graph',)
    else:
        _record_keys(engine, keys, capture)
        wrapped = ('_decode_call',)
    census: Dict[str, Dict[str, int]] = {}
    prefill_rows = [0]
    undo_prefill = None
    if mesh is not None:
        _record_collectives(engine, census)
        wrapped += ('_run_graph',)
    for _ in range(max(1, warmup_rounds)):
        one_round()
    census.clear()
    shapes0 = dict(mesh_lib.collective_shapes)
    if mesh is not None:
        undo_prefill = _record_prefill_census(census, prefill_rows)
    try:
        _audited(engine, report, keys, rounds, one_round, wrapped)
    finally:
        if undo_prefill is not None:
            undo_prefill()
    _attach_costs(report, engine, capture)
    if mesh is not None:
        report.mesh = mesh_lib.mesh_axis_sizes(mesh)
        report.collectives = dict(census)
        report.expected_collectives = expected_census(engine)
        if 'prefill' in census:
            report.expected_collectives['prefill'] = \
                expected_prefill_census(engine, prefill_rows[0])
        report.collective_shapes = {
            k: n - shapes0.get(k, 0)
            for k, n in mesh_lib.collective_shapes.items()
            if n != shapes0.get(k, 0)}
        report.pool_pages_shape = tuple(engine.cache.pool_k.shape[1:4])
        engine.close()


def audit_multistep(k: int = 4, *, cfg: Optional[ModelConfig] = None,
                    quantize: Optional[str] = None,
                    decode_impl: Optional[str] = None,
                    device: DeviceLike = 'cuda') -> AuditReport:
    """Multi-step decode (``decode_steps_per_call=k``) on the paged
    engine, audited: equal budget-bound prompts (no eos or stop: early
    slot recycling keeps every slot in lockstep) with ``max_new_tokens
    = 2k + 1``, caller horizon 1 (the KNOB must fuse k), one warm-up
    round and two audited rounds. Each audited round must dispatch
    exactly two decode calls, every one at horizon k, with no capture
    and no unsanctioned sync."""
    dev = resolve_device(device)
    cfg = cfg or configs.TINY
    extra: Dict[str, Any] = {'decode_steps_per_call': k}
    if quantize is not None:
        extra['quantize'] = quantize
    if decode_impl is not None:
        extra['decode_impl'] = decode_impl
    q_tag = f', quantize={quantize}' if quantize else ''
    report = AuditReport(
        name=f'multi-step decode (decode_steps_per_call={k}{q_tag})',
        device=str(dev), k=k)
    engine = _tiny_engine('paged', cfg, dev, **extra)
    prompts = [[3 + i, 5, 7, 9, 2, 4, 6, 8, 1, 3, 5, 7]
               for i in range(4)]                 # equal shapes: lockstep
    max_new = 2 * k + 1

    def one_round():
        for p in prompts:
            engine.add_request(list(p), max_new_tokens=max_new)
        engine.run_to_completion(horizon=1)

    keys: List[Dict[str, Any]] = []
    capture: Dict[str, Any] = {}
    _record_keys(engine, keys, capture)
    one_round()                                   # warm-up: captures
    rounds = 2
    report.expected_dispatches = 2 * rounds
    _audited(engine, report, keys, rounds, one_round)
    _attach_costs(report, engine, capture)
    return report


def audit_spec_multistep(k: int = 4, steps: int = 3, *,
                         cfg: Optional[ModelConfig] = None,
                         device: DeviceLike = 'cuda') -> AuditReport:
    """Fused speculative rounds (``speculate_k=k`` x
    ``decode_steps_per_call=steps``) on the paged engine, audited. A
    single-round engine serves one wave of the repetitive prompts (12
    new tokens each, caller horizon 1) after a warm-up wave: its verify
    dispatches are the count the fusion must divide. The fused engine
    then serves a warm-up wave and two audited waves, which must
    dispatch ``ceil(single / steps)`` fused calls a wave, every key at
    rounds == ``steps``, with no single-round fallback, no capture, no
    unsanctioned sync and one sanctioned sync a dispatch."""
    dev = resolve_device(device)
    cfg = cfg or configs.TINY
    max_new = 12

    def one_wave(engine):
        for p in _SPEC_PROMPTS:
            engine.add_request(list(p), max_new_tokens=max_new)
        engine.run_to_completion(horizon=1)

    ref = _tiny_engine('paged', cfg, dev, speculate_k=k)
    single = [0]
    _count_calls(ref, '_spec_verify_call', single)
    one_wave(ref)                                 # warm-up: captures
    single[0] = 0
    one_wave(ref)
    del ref._spec_verify_call, ref

    report = AuditReport(
        name=f'fused speculative rounds (speculate_k={k} x '
             f'decode_steps_per_call={steps})', device=str(dev),
        speculate_k=k, rounds=steps)
    engine = _tiny_engine('paged', cfg, dev, speculate_k=k,
                          decode_steps_per_call=steps)
    fallback = [0]
    keys: List[Dict[str, Any]] = []
    capture: Dict[str, Any] = {}
    _record_spec_keys(engine, keys, capture)
    _count_calls(engine, '_spec_verify_call', fallback)
    one_wave(engine)                              # warm-up: captures
    fallback[0] = 0
    waves = 2
    report.expected_dispatches = waves * -(-single[0] // steps)
    _audited(engine, report, keys, waves, lambda: one_wave(engine),
             ('_run_graph', '_spec_verify_call'))
    report.fallbacks = fallback[0]
    _attach_costs(report, engine, capture)
    return report


def audit_telemetry_parity(kind: str = 'slot', *,
                           cfg: Optional[ModelConfig] = None,
                           rounds: int = 2,
                           device: DeviceLike = 'cuda') -> AuditReport:
    """Telemetry is free at the device boundary. The same three prompts
    (longer than one prefill chunk, greedy, 8 new tokens) run through an
    engine built with ``telemetry=False`` and one built with
    ``telemetry=True``: a warm-up round each (captures allowed), then
    ``rounds`` audited rounds. The telemetry-on rounds must make no
    unsanctioned sync, no capture and no dispatch key the warm-up did
    not use (the off rounds are held to the same, separately), both
    engines must capture the same graphs, and every round's token
    streams must be equal across the two."""
    dev = resolve_device(device)
    cfg = cfg or configs.TINY
    report = AuditReport(name=f'telemetry parity ({kind} engine)',
                         device=str(dev))
    prompts = _WAVE_PROMPTS
    streams: Dict[bool, List[List[List[int]]]] = {}
    captures: Dict[bool, int] = {}
    for mode in (False, True):
        engine = _tiny_engine(kind, cfg, dev, telemetry=mode)
        out: List[List[List[int]]] = []

        def one_round():
            rids = [engine.add_request(list(p), max_new_tokens=8)
                    for p in prompts]
            engine.run_to_completion(horizon=8)
            out.append([list(engine.pop_finished(r).output) for r in rids])

        keys: List[Dict[str, Any]] = []
        capture: Dict[str, Any] = {}
        _record_keys(engine, keys, capture)
        one_round()                               # warm-up: captures
        sub = report if mode else AuditReport(name='', device=str(dev))
        _audited(engine, sub, keys, rounds, one_round)
        if mode:
            _attach_costs(report, engine, capture)
        else:
            report.off_violations = sub.violations()
        streams[mode] = out
        captures[mode] = engine.graph_stats()['graph_captures']
        del engine
    report.streams_equal = streams[False] == streams[True]
    report.captures_by_mode = (captures[False], captures[True])
    return report


def _shifted_prompts(r: int) -> List[List[int]]:
    """Round ``r``'s prompts: the same lengths every round (so the same
    dispatch keys), other tokens (so a warm-up lands new chains)."""
    return [[(t + 17 * r) % 200 + 3 for t in p] for p in
            ([1, 2, 3] * 9, [4, 5] * 10 + [6] * 13, [7] * 37)]


def audit_handoff(kind: str = 'paged', what: str = 'ingest', *,
                  cfg: Optional[ModelConfig] = None,
                  kv_cache_dtype: Optional[str] = None,
                  rounds: int = 2,
                  device: DeviceLike = 'cuda') -> AuditReport:
    """The decode that follows a KV landing, audited. A source engine
    (the same random weights) exports, for each round's prompts, either
    request snapshots after their first token (``what='ingest'``) or
    its prefix chains after serving them (``what='warm'``). A round on
    the audited engine lands them (``ingest_kv_snapshot``, or
    ``warm_prefix`` and then the same prompts served with prefix hits)
    and decodes to completion. One warm-up round, then ``rounds``
    identical rounds: no capture, no dispatch key the warm-up did not
    use, no unsanctioned sync (the landing included)."""
    if what not in ('ingest', 'warm'):
        raise ValueError(f"what must be 'ingest' or 'warm', got {what!r}")
    dev = resolve_device(device)
    cfg = cfg or configs.TINY
    extra: Dict[str, Any] = {}
    if kv_cache_dtype is not None:
        extra['kv_cache_dtype'] = kv_cache_dtype
    src = _tiny_engine(kind, cfg, dev, **extra)
    landings = []
    for r in range(1 + rounds):
        prompts = _shifted_prompts(r)
        if what == 'ingest':
            snaps = []
            for p in prompts:
                rid = src.add_request(list(p), max_new_tokens=8, hold=True)
                while not any(q is not None and q.request_id == rid
                              and q.output for q in src._slots):
                    src.step(horizon=1)
                snaps.append(src.export_kv_snapshot(rid)[0])
                src.cancel(rid)
            landings.append((snaps, None))
        else:
            for p in prompts:
                src.add_request(list(p), max_new_tokens=2)
            src.run_to_completion(horizon=8)
            landings.append((src.export_prefix_snapshots(16)[0], prompts))
    del src
    report = AuditReport(name=f'{kind} engine: decode after '
                              f'{"ingest" if what == "ingest" else "warm_prefix"}'
                              + ''.join(f' + {k}={v}'
                                        for k, v in extra.items()),
                         device=str(dev))
    engine = _tiny_engine(kind, cfg, dev, **extra)
    todo = iter(landings)
    landed = [0]

    def one_round():
        entries, prompts = next(todo)
        for e in entries:
            if what == 'ingest':
                engine.ingest_kv_snapshot(e)
                landed[0] += int(e['n_rows'])
            else:
                landed[0] += engine.warm_prefix(e)
        for p in prompts or ():
            engine.add_request(list(p), max_new_tokens=8)
        engine.run_to_completion(horizon=8)

    keys: List[Dict[str, Any]] = []
    _record_keys(engine, keys)
    one_round()                                   # warm-up: captures
    alloc = getattr(engine, 'alloc', None)
    hits0 = alloc.prefix_hits if alloc is not None else 0
    landed[0] = 0
    _audited(engine, report, keys, rounds, one_round)
    report.landed_rows = landed[0]
    report.prefix_hits = (alloc.prefix_hits - hits0 if alloc is not None
                          else 0)
    return report


def _random_adapter(cfg: ModelConfig, targets, rank: int, seed: int,
                    sigma: float = 0.05):
    """A trainer-format adapter tree (numpy fp32) from ``seed``."""
    from skypilot_tpu_torch.models import multilora
    rng = np.random.default_rng(seed)
    tree = {}
    for t in targets:
        a_shape, b_shape = multilora.target_shapes(cfg, t, rank)
        tree[t] = {'a': rng.normal(0.0, sigma, (cfg.n_layers,) + a_shape
                                   ).astype(np.float32),
                   'b': rng.normal(0.0, sigma, (cfg.n_layers,) + b_shape
                                   ).astype(np.float32)}
    return tree


def audit_adapters(kind: str = 'paged', *,
                   cfg: Optional[ModelConfig] = None, slots: int = 2,
                   rank: int = 4, rounds: int = 2, speculate_k: int = 0,
                   device: DeviceLike = 'cuda') -> AuditReport:
    """Adapter churn during decode, audited. An engine with a bank of
    ``slots`` slots and ``slots + 2`` registered adapters serves waves
    of four requests: a base request, a JSON-grammar request, and two
    adapter requests (one with a token-id grammar), the adapters
    rotating so that every audited wave loads and evicts. One warm-up
    wave (captures allowed: the bank and the masks are live from it on),
    then ``rounds`` waves: no capture, no dispatch key the warm-up did
    not use, no unsanctioned sync, the bank's storage unmoved, every
    grammar request inside its mask."""
    from skypilot_tpu_torch.inference import adapters as adapters_lib
    dev = resolve_device(device)
    cfg = cfg or configs.TINY
    extra: Dict[str, Any] = dict(adapter_slots=slots, adapter_rank=rank)
    if speculate_k:
        extra['speculate_k'] = speculate_k
    report = AuditReport(
        name=f'{kind} engine: adapter churn ({slots} slots, rank {rank}) '
             f'+ grammar masks'
             + (f' + speculate_k={speculate_k}' if speculate_k else ''),
        device=str(dev), speculate_k=speculate_k or None)
    engine = _tiny_engine(kind, cfg, dev, **extra)
    reg = engine.adapters
    n_adapters = slots + 2
    for i in range(n_adapters):
        reg.register(f'ad{i}', _random_adapter(cfg, reg.targets, rank, i),
                     scale=1.0)
    ptrs = [leaf.data_ptr() for ab in reg.bank.values()
            for leaf in (ab.values() if isinstance(ab, dict) else [ab])]
    ids = [3, 5, 9, 17, 33]
    json_mask = adapters_lib.compile_grammar('json', cfg.vocab_size)
    wave = [0]
    outputs: List[Tuple[Any, List[int]]] = []

    def one_round():
        w = wave[0]
        wave[0] += 1
        a, b = 2 * w % n_adapters, (2 * w + 1) % n_adapters
        reqs = [({}, None),
                ({'grammar': 'json'}, json_mask),
                ({'adapter': f'ad{a}'}, None),
                ({'adapter': f'ad{b}', 'grammar': ids}, None)]
        rids = []
        for i, (kw, mask) in enumerate(reqs):
            p = [(t + 7 * i + w) % 200 + 3 for t in range(20 + 3 * i)]
            rids.append((engine.add_request(p, max_new_tokens=8, **kw),
                         mask if kw.get('grammar') != ids else ids))
        done = engine.run_to_completion(horizon=8)
        for rid, mask in rids:
            outputs.append((mask, done[rid].output))

    keys: List[Dict[str, Any]] = []
    capture: Dict[str, Any] = {}
    if speculate_k:
        _record_spec_keys(engine, keys, capture)
        wrapped = ('_run_graph',)
    else:
        _record_keys(engine, keys, capture)
        wrapped = ('_decode_call',)
    one_round()                                   # warm-up: captures
    loads0, evict0 = reg.loads_total, reg.evictions_total
    outputs.clear()
    _audited(engine, report, keys, rounds, one_round, wrapped)
    _attach_costs(report, engine, capture)
    report.adapter_loads = reg.loads_total - loads0
    report.adapter_evictions = reg.evictions_total - evict0
    report.bank_moved = ptrs != [
        leaf.data_ptr() for ab in reg.bank.values()
        for leaf in (ab.values() if isinstance(ab, dict) else [ab])]

    def inside(mask, toks):
        if mask is None:
            return True
        if isinstance(mask, list):
            return set(toks) <= set(mask)
        return all(mask[t] for t in toks)
    report.grammar_ok = all(inside(m, t) for m, t in outputs)
    return report


def audit_llama_forward(*, cfg: Optional[ModelConfig] = None,
                        device: DeviceLike = 'cuda') -> AuditReport:
    """The llama training/prefill forward (``llama.forward`` on ``cfg``,
    default ``TINY``, two rows of 16 tokens) traced on the meta device,
    standing for the program of ``device``'s type, and priced
    (``dispatch_costs['forward']``): a host read or a float64 result in
    it is a violation (the reference's jaxpr walk)."""
    from skypilot_tpu_torch.models import llama
    dev = resolve_device(device)
    cfg = cfg or configs.TINY
    report = AuditReport(name='llama forward (traced on meta)',
                         device=str(dev))
    try:
        params = llama.init_params(cfg, 0, device='meta')
        tokens = torch.zeros((2, 16), dtype=torch.int32, device='meta')
        cost = costmodel.trace_dispatch(
            lambda p, t: llama.forward(p, t, cfg), (params, tokens),
            (costmodel.classify_params(params), costmodel.TABLE),
            label='forward', stands_for=dev.type)
    except Exception as e:  # noqa: BLE001 - reported, not raised
        report.cost_error = f'{type(e).__name__}: {e}'
        return report
    report.dispatch_costs['forward'] = cost
    report.host_reads = list(cost.host_reads)
    report.f64_promotions = list(cost.f64_promotions)
    return report


def _drive(engine, prompts=_WAVE_PROMPTS, max_new: int = 8) -> None:
    for p in prompts:
        engine.add_request(list(p), max_new_tokens=max_new)
    engine.run_to_completion(horizon=8)


def audit_disagg(*, cfg: Optional[ModelConfig] = None, rounds: int = 2,
                 device: DeviceLike = 'cuda') -> AuditReport:
    """Disaggregated prefill -> decode handoff (int8 KV over the SKKV
    wire codec), audited. Two paged engines on the same weights play
    prefill worker and decode worker: each round the prefill worker
    admits three held prompts and prefills them to their first token,
    exports each request's KV snapshot (one sanctioned readback each),
    the codec round-trips it, and the decode worker ingests it and
    decodes to completion. One warm-up round, then ``rounds`` rounds:
    the decode worker makes no prefill call at all (warm-up included),
    neither worker captures a graph, and nothing in the rounds (export,
    codec, ingest, decode) makes an unsanctioned sync."""
    from skypilot_tpu_torch.inference import kv_transfer
    dev = resolve_device(device)
    cfg = cfg or configs.TINY
    report = AuditReport(name='disagg prefill -> decode handoff (paged, '
                              'int8 KV, SKKV wire)', device=str(dev))
    prefill = _tiny_engine('paged', cfg, dev, kv_cache_dtype='int8')
    decode = _tiny_engine('paged', cfg, dev, kv_cache_dtype='int8')
    prefills = [0]
    inner_prefill = decode._prefill_chunk_batch

    def counting():
        if decode._prefill_off:           # a chunk would be dispatched
            prefills[0] += 1
        return inner_prefill()

    decode._prefill_chunk_batch = counting

    def first_token(rid) -> bool:
        return any(q is not None and q.request_id == rid and q.output
                   for q in prefill._slots)

    def one_round():
        rids = [prefill.add_request(list(p), max_new_tokens=24, hold=True)
                for p in _WAVE_PROMPTS]
        while not all(first_token(r) for r in rids):
            prefill.step(horizon=4)
        for rid in rids:
            snap, _events = prefill.export_kv_snapshot(rid)
            if snap is None:
                raise RuntimeError(f'export failed for request {rid}')
            prefill.cancel(rid)
            decode.ingest_kv_snapshot(kv_transfer.decode_handoff(
                kv_transfer.encode_handoff(snap)))
        decode.run_to_completion(horizon=8)
        prefill.run_to_completion(horizon=8)

    keys: List[Dict[str, Any]] = []
    capture: Dict[str, Any] = {}
    _record_keys(decode, keys, capture)
    one_round()                                   # warm-up: captures
    before = prefill.graph_stats()['graph_captures']
    _audited(decode, report, keys, rounds, one_round)
    del decode._prefill_chunk_batch
    report.checks['decode-worker prefill calls (must stay 0)'] = (
        0, prefills[0])
    report.checks['prefill-worker graph captures in steady state'] = (
        before, prefill.graph_stats()['graph_captures'])
    _attach_costs(report, decode, capture)
    return report


def audit_digest_export(*, cfg: Optional[ModelConfig] = None,
                        rounds: int = 2,
                        device: DeviceLike = 'cuda') -> AuditReport:
    """The prefix-digest export on the routing probe path, audited:
    ``hot_prefix_digest()`` after EVERY wave (far hotter than a real
    scrape cadence) is host state only, so the audited waves make no
    unsanctioned sync and no capture, and every scrape returns entries
    (an empty one means the heat tracker regressed)."""
    dev = resolve_device(device)
    cfg = cfg or configs.TINY
    report = AuditReport(name='hot-prefix digest export (paged probe '
                              'path)', device=str(dev))
    engine = _tiny_engine('paged', cfg, dev)
    scrapes: List[List[Dict[str, Any]]] = []

    def one_round():
        _drive(engine)
        scrapes.append(engine.hot_prefix_digest())

    keys: List[Dict[str, Any]] = []
    capture: Dict[str, Any] = {}
    _record_keys(engine, keys, capture)
    _drive(engine)                                # warm-up: captures
    _audited(engine, report, keys, rounds, one_round)
    report.checks['scrapes returning entries'] = (
        rounds, sum(1 for d in scrapes if d))
    _attach_costs(report, engine, capture)
    return report


def audit_fleet_obs(*, cfg: Optional[ModelConfig] = None, rounds: int = 2,
                    device: DeviceLike = 'cuda') -> AuditReport:
    """The fleet observability scrape, audited: after EVERY wave a full
    controller-style scrape (the registry's ``export_wire()``, the trace
    buffer's ``summaries_since``, ``FleetAggregator.ingest`` with its
    SLO burn evaluation, ``slo_status`` and ``render_prometheus``), all
    host-side bookkeeping: the audited waves make no unsanctioned sync
    and no capture, and every scrape lands series and completed traces
    in the aggregator."""
    from skypilot_tpu_torch.telemetry import clock as clock_lib
    from skypilot_tpu_torch.telemetry import fleet as fleet_lib
    from skypilot_tpu_torch.telemetry import registry as registry_lib
    from skypilot_tpu_torch.telemetry import tracing
    dev = resolve_device(device)
    cfg = cfg or configs.TINY
    report = AuditReport(name='fleet observability scrape (registry + '
                              'traces -> aggregator)', device=str(dev))
    engine = _tiny_engine('paged', cfg, dev, telemetry=True)
    agg = fleet_lib.FleetAggregator(
        clock=clock_lib.now,
        slos=[fleet_lib.TierSLO(tier='latency', ttft_ms=2000.0,
                                target=0.99)])
    reg = registry_lib.get_registry()
    buf = tracing.get_trace_buffer()
    good = [0]
    cursor = [buf.summaries_since(-1, limit=1 << 30)[0]]  # skip older ones

    def one_round():
        _drive(engine)
        cursor[0], traces = buf.summaries_since(cursor[0])
        wire = reg.export_wire()
        agg.ingest('audit-replica', {'clock': {'wall': clock_lib.now()},
                                     'registry': wire, 'traces': traces})
        agg.slo_status()
        if wire and traces and agg.render_prometheus():
            good[0] += 1

    keys: List[Dict[str, Any]] = []
    capture: Dict[str, Any] = {}
    _record_keys(engine, keys, capture)
    _drive(engine)                                # warm-up: captures
    cursor[0] = buf.summaries_since(cursor[0], limit=1 << 30)[0]
    _audited(engine, report, keys, rounds, one_round)
    report.checks['scrapes ingesting series and traces'] = (rounds, good[0])
    report.checks['aggregator sources'] = (1, agg.source_count())
    _attach_costs(report, engine, capture)
    return report


# The presets' model: the reference's TINY at head_dim 64 (dim 256), the
# smallest head_dim the port's CUDA kernels take, so that on the card the
# presets run K1, K2, K3 and K4 (TINY's head_dim 16 sends every one of
# them to its plain version there). On the CPU it is the same program as
# the reference's TINY presets, wider.
PRESET_CFG = dataclasses.replace(configs.TINY, name='tiny-d64', dim=256)


def _preset(fn, *args, **kwargs):
    """A preset: ``fn`` on :data:`PRESET_CFG` with fixed arguments,
    taking ``device=``."""
    def run(device: DeviceLike = 'cuda') -> AuditReport:
        return fn(*args, cfg=PRESET_CFG, device=device, **kwargs)
    return run


# The reference's preset table (``jaxpr_audit.py`` :1200), each preset
# taking ``device=`` (default CUDA).
PRESETS: Dict[str, Any] = {
    'slot': _preset(audit_engine, 'slot'),
    'slot-monolithic': _preset(audit_engine, 'slot', chunked=False),
    'paged': _preset(audit_engine, 'paged'),
    'slot-spec': _preset(audit_engine, 'slot', speculate_k=4),
    'paged-spec': _preset(audit_engine, 'paged', speculate_k=4),
    'telemetry': _preset(audit_telemetry_parity, 'slot'),
    'telemetry-paged': _preset(audit_telemetry_parity, 'paged'),
    # int8 KV over bf16 weights, the decoupled kv_cache_dtype path.
    'kv-int8': _preset(audit_engine, 'paged', kv_cache_dtype='int8'),
    'kv-int8-slot': _preset(audit_engine, 'slot', kv_cache_dtype='int8'),
    # int4 KV codes (packed nibble rows + fp32 row scales).
    'kv-int4': _preset(audit_engine, 'paged', kv_cache_dtype='int4'),
    'kv-int4-slot': _preset(audit_engine, 'slot', kv_cache_dtype='int4'),
    # K2: the ring and the current token folded into the kernel.
    'fused-attn': _preset(audit_engine, 'paged', decode_impl='cross_layer'),
    'disagg': _preset(audit_disagg),
    'int4': _preset(audit_engine, 'paged', quantize='int4'),
    'int4-slot': _preset(audit_engine, 'slot', quantize='int4'),
    'multistep': _preset(audit_multistep),
    'int4-multistep': _preset(audit_multistep, quantize='int4'),
    'spec-multistep': _preset(audit_spec_multistep),
    'adapters': _preset(audit_adapters, 'paged'),
    'adapters-slot': _preset(audit_adapters, 'slot'),
    'digest': _preset(audit_digest_export),
    'fleet-obs': _preset(audit_fleet_obs),
    'llama': _preset(audit_llama_forward),
}

# The serving-mesh presets (the reference's, ``jaxpr_audit.py``
# :1238-1257): the paged audit on a tp = 2 mesh, with int8 KV, and on a
# (tp = 2, dp = 2) mesh ('paged-gang' is the reference's name: a gang's
# mesh, with no gang code in it). On the CPU the ranks are gloo
# processes; on CUDA each needs its own card.
PRESETS.update({
    'paged-tp': _preset(audit_engine, 'paged', mesh_tp=2),
    'paged-tp-int8': _preset(audit_engine, 'paged', mesh_tp=2,
                             kv_cache_dtype='int8'),
    'paged-gang': _preset(audit_engine, 'paged', mesh_tp=2, mesh_dp=2,
                          warmup_rounds=2),
})

# Presets that need several devices: preset -> device count.
MULTI_DEVICE_PRESETS: Dict[str, int] = {
    'paged-tp': 2,
    'paged-tp-int8': 2,
    'paged-gang': 4,
}

# The reference's default list, in its order.
DEFAULT_PRESETS: List[str] = [
    'slot', 'paged', 'slot-spec', 'paged-spec', 'telemetry',
    'kv-int8', 'kv-int8-slot', 'kv-int4', 'kv-int4-slot',
    'fused-attn', 'paged-tp', 'paged-tp-int8',
    'paged-gang', 'disagg', 'int4', 'multistep', 'int4-multistep',
    'spec-multistep', 'adapters', 'adapters-slot', 'digest',
    'fleet-obs', 'llama']


def default_presets(device: DeviceLike = 'cuda') -> List[str]:
    """:data:`DEFAULT_PRESETS` less the multi-device presets this host
    cannot run on ``device`` (a CUDA mesh needs a card per rank; on the
    CPU every rank is a process)."""
    dev = resolve_device(device)
    have = torch.cuda.device_count() if dev.type == 'cuda' else None
    return [n for n in DEFAULT_PRESETS
            if have is None or MULTI_DEVICE_PRESETS.get(n, 1) <= have]


def run_preset(name: str, device: DeviceLike = 'cuda') -> AuditReport:
    """Run one preset on ``device`` and arm its byte budget for the
    device's type (``costmodel.budget_key``): a captured dispatch whose
    per-class reads exceed the declared ceiling fails ``ok()``, and so
    does a default preset with no budget for that device type."""
    report = PRESETS[name](device=device)
    report.preset = name
    key = costmodel.budget_key(name, resolve_device(device).type)
    budget = costmodel.BYTE_BUDGETS.get(key)
    if budget is not None:
        report.byte_budget = budget
    elif name in DEFAULT_PRESETS:
        report.missing_budget = key
    return report


def run_presets(names: Optional[List[str]] = None,
                device: DeviceLike = 'cuda') -> List[AuditReport]:
    return [run_preset(n, device) for n in (names or DEFAULT_PRESETS)]


def graph_matches_eager(engine, horizon: int) -> Dict[str, Any]:
    """The paged engine's decode graphs against the eager step, on one
    engine state: the engine's next decode call is staged (tables,
    lengths, sampling rows) and run twice from the same state through
    the engine (the first run of a key captures it, the second replays
    it), then the module-level eager driver ``paged_decode_horizon`` and
    ``merge_ring_into_pool`` run from that state too. Tokens, ring rows
    and the pool after the merge must be equal bit for bit; the engine
    is left in the state after the replayed call. Greedy rows only (a
    sampled call draws different numbers on each run). Returns the
    comparison and the key's capture and replay counts."""
    from skypilot_tpu_torch.inference import paged
    eng, buf = engine, engine._buf
    if eng._graphs is None:
        raise RuntimeError('graph_matches_eager needs a CUDA engine')
    ready = eng._decode_ready()
    live = [s for s, r in enumerate(ready) if r is not None]
    if not live:
        raise ValueError('no decodable slot: prefill first')
    eng._meta_dirty = True
    eng._stage_rows(ready)
    if eng._sample:
        raise ValueError('graph_matches_eager compares greedy calls')
    lengths = eng._slot_len + eng._slot_inflight
    P = paged._bucket_len(max(eng._pages_needed(int(lengths[s]) + horizon)
                              for s in live), minimum=1)
    for s in live:
        if not eng._ensure_pages(s, int(lengths[s]) + horizon):
            raise MemoryError('pool too small for the check')
    table_p = np.zeros((eng.max_batch, P), np.int32)
    for s in range(eng.max_batch):
        ps = eng._pages[s][:P]
        table_p[s, :len(ps)] = ps
    buf.set_lengths(lengths)
    buf.upload(buf.set_table(table_p))
    pools = [t for t in (eng.cache.pool_k, eng.cache.pool_v,
                         eng.cache.k_scale, eng.cache.v_scale)
             if t is not None]
    saved = [t.clone() for t in pools] + [eng._tok_dev.clone()]

    def restore():
        for t, s in zip(pools + [eng._tok_dev], saved):
            t.copy_(s)

    before = eng.graph_stats()
    eng._decode_call(horizon, False, P)            # capture (or replay)
    restore()
    toks_g = eng._decode_call(horizon, False, P)   # replay
    ring_g = [r.clone() for r in buf.ring(horizon)]
    pools_g = [t.clone() for t in pools]
    after = eng.graph_stats()
    restore()
    toks_e, rk, rv = paged.paged_decode_horizon(
        eng.params, eng.cache, buf.table(P), saved[-1], buf.lengths,
        eng.cfg, horizon=horizon, decode_impl=eng.decode_impl)
    paged.merge_ring_into_pool(eng.cache, rk, rv, buf.table(P), buf.lengths,
                               buf.active)
    result = {
        'horizon': horizon, 'P': P, 'decode_impl': eng.decode_impl,
        'kv_cache_dtype': eng.kv_cache_dtype,
        'tokens_equal': bool(torch.equal(toks_g, toks_e)),
        'ring_equal': bool(torch.equal(ring_g[0], rk)
                           and torch.equal(ring_g[1], rv)),
        'pool_equal': all(bool(torch.equal(g, t))
                          for g, t in zip(pools_g, pools)),
        'captures': after['graph_captures'] - before['graph_captures'],
        'replays': after['graph_replays'] - before['graph_replays']}
    for t, g in zip(pools, pools_g):           # the replayed call's state
        t.copy_(g)
    eng._tok_dev.copy_(toks_g[:, -1])
    return result


def spec_graph_matches_eager(engine, rounds: int = 0) -> Dict[str, Any]:
    """A speculative call's CUDA graph against the same round body run
    eagerly, on one engine state (either engine): the next call is
    staged from the host's proposals (``rounds`` 0: one verify round;
    else ``rounds`` fused rounds with the device proposer) and run twice
    from the same state through the engine's graphs (the first run of a
    key captures it, the second replays it), then once more with the
    graph cache set aside, which runs the body eagerly on the current
    stream. The packed output (commit, n_commit, n_prop), the token
    vector and every cache byte (and the slot cache's lengths) must be
    equal bit for bit, except the paged pool's trash page (page 0):
    every slot sends its rows past n_commit there, several to one row,
    and which write lands last is not fixed; no read covers it. The
    engine is left in the state before the check. Greedy rows only.
    Returns the comparison and the key's capture and replay counts."""
    eng = engine
    if eng._graphs is None:
        raise RuntimeError('spec_graph_matches_eager needs a CUDA engine')
    ready = eng._decode_ready()
    if not any(r is not None for r in ready):
        raise ValueError('no decodable slot: prefill first')
    eng._meta_dirty = True
    eng._stage_rows(ready)
    if eng._sample:
        raise ValueError('spec_graph_matches_eager compares greedy rounds')
    proposals, n_prop, starved = eng._spec_build_proposals(ready)
    if starved or (rounds and not all(
            eng._spec_can_fuse(s, rounds)
            for s, r in enumerate(ready) if r is not None)):
        raise MemoryError('pool too small for the check')
    cache = eng.cache
    paged = hasattr(cache, 'pool_k')
    if paged:
        state = [t for t in (cache.pool_k, cache.pool_v, cache.k_scale,
                             cache.v_scale) if t is not None]
    else:
        state = list(cache.tensors()) + [cache.length]
    state.append(eng._tok_dev)
    saved = [t.clone() for t in state]

    def restore(values):
        for t, s in zip(state, values):
            t.copy_(s)

    def call():
        out = (eng._spec_fused_call(ready, rounds) if rounds
               else eng._spec_verify_call(ready, proposals, n_prop))
        return out.clone()

    before = eng.graph_stats()
    call()                                       # capture (or replay)
    restore(saved)
    out_g = call()                               # replay
    state_g = [t.clone() for t in state]
    after = eng.graph_stats()
    restore(saved)
    graphs, eng._graphs = eng._graphs, None
    try:
        out_e = call()                           # the body, eagerly
    finally:
        eng._graphs = graphs
    k1 = eng.speculate_k + 1
    result = {
        'rounds': rounds, 'kv_cache_dtype': eng.kv_cache_dtype,
        'commit_equal': bool(torch.equal(out_g[..., :k1], out_e[..., :k1])),
        'n_commit_equal': bool(torch.equal(out_g[..., k1:], out_e[..., k1:])),
        'cache_equal': all(bool(torch.equal(g[:, 1:], t[:, 1:]) if paged
                                else torch.equal(g, t))
                           for g, t in zip(state_g[:-1], state[:-1])),
        'tokens_equal': bool(torch.equal(state_g[-1], state[-1])),
        'n_commit': out_g[..., k1].tolist(),
        'captures': after['graph_captures'] - before['graph_captures'],
        'replays': after['graph_replays'] - before['graph_replays']}
    restore(saved)
    return result
