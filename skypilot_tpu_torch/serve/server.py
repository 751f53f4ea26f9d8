"""Replica-side model server on the PyTorch engines (port of
``skypilot_tpu/serve/server.py``'s replica: the same routes, JSON and
SSE shapes, HTTP codes, metric names and error strings).

Request flow: handler threads submit into the SLO scheduler
(``serve/scheduler.py``), which owns the per-tier bounded queues, the
priority + shortest-remaining-work admission order, load shedding (HTTP
429 with a ``Retry-After`` from queue telemetry) and the per-request
outboxes the handlers stream from. One engine-loop thread tops the
engine up from the scheduler (``fill_engine``, under the engine lock),
runs ``engine.step()``, and routes the step's token events to the
outboxes outside the lock, so a slow client never holds a step back.

Routes:

- ``GET /readiness``: 200 ``{"status": "ready", ...}`` once the engine
  is built and warmed; 503 while loading, after a failure, ``{"status":
  "degraded", ...}`` after a gray failure, ``{"status": "draining",
  ...}`` during a drain, or ``{"status": "gang_joining", ...}`` until
  every rank of a gang joined.
- ``POST /generate``: ``{"prompt": [ids...] | "text", "max_new_tokens":
  N, "temperature", "top_k", "top_p", "stop", "slo_tier":
  "latency"|"throughput", "request_key"}``; ``"stream": true`` answers
  with SSE ``{"token": t}`` events and a final ``{"done": true,
  "tokens": [...]}``. A repeated ``request_key`` (or ``X-Request-ID``)
  replays the first answer instead of running again.
- ``POST /v1/completions`` and ``POST /v1/chat/completions``:
  OpenAI-style, streamed or not; ``GET /v1/models``.
- Every generation route takes the multi-tenant fields: ``"adapter"``
  (a bank adapter, or ``"model": "<base>:<adapter>"`` when the server
  has a bank or ``<base>`` is the served model), ``"tenant"`` (a label)
  and ``"grammar"`` (``"json"`` or a token-id list; also
  ``"response_format": {"type": "json_object"}``). A request whose
  adapter finds every bank slot pinned waits in the scheduler; an
  unknown adapter fails that request.
- ``GET /metrics``: the process registry in the Prometheus text format
  (``text/plain; version=0.0.4``): request TTFT/TPOT/queue-wait
  histograms (all and per tier), the scheduler's queue, admit and shed
  series, the engine step phases, KV pool and disagg series.
  ``GET /metrics?format=json``: the stable JSON gauge block, with the
  ``sched`` (per tier) and ``scheduler`` blocks, the ``disagg``,
  ``prefix_digest``, ``mesh``, ``gang`` and ``lora`` blocks, and the
  port's own keys (the KV cache kind, the decode attention path, the
  decode and prefill kernels' launch counts, the decode graphs'
  captures and replays, the device).
- ``GET /debug/requests?limit=N``: the newest completed request traces
  (spans ``queue``, ``prefill``, ``prefill_chunk``, ``decode``,
  ``spec_round``); ``GET /telemetry/summary?since=C``: the registry's
  wire export and the traces completed after cursor ``C``.
- ``POST /drain`` (``{"deadline_s": s}``) and ``GET /drain``: graceful
  drain. New submits get 503 + ``Retry-After``, running requests finish,
  stragglers past the deadline are failed (retryable); with a
  ``checkpoint_path`` the checkpoint is written when the drain begins.
- ``POST /checkpoint``, ``POST /kv/warmup``, ``POST /kv/ingest`` (an
  SKKV handoff seated through the scheduler's ``adopt``; 503 +
  ``Retry-After`` from queue telemetry when no slot or page is free) and
  ``GET /kv/prefix/export?hash=H``.

A prefill-role server (``--role prefill``) holds each request after its
first token, exports its KV and POSTs it to a decode worker's
``/kv/ingest`` (the ``X-Handoff-Target`` header, else the static
``--handoff-targets`` peer with the most free KV), relaying the decode
worker's stream to the client; when the handoff fails the request
decodes here (``fallback_local``).

Run: ``python -m skypilot_tpu_torch.serve.server --model llama2-7b``
(random weights), or ``--model-path DIR`` for an HF checkpoint directory;
``--quantize int8|int4``, ``--kv-cache-dtype``, ``--decode-impl``,
``--kv-cache slot`` (prefill on the flash kernels) with
``--prefill-chunk-tokens``, ``--prefill-w8a8`` (int8 activations in the
prefill layer matmuls), ``--decode-steps-per-call``,
``--speculate-k``, ``--checkpoint-path``; the multi-LoRA bank's
``--adapter-slots``, ``--adapter-dir`` and ``--adapter-rank``; the
scheduler's
``--slo-tier-default``, ``--max-queue-tokens``,
``--latency-admit-frac`` and ``--drain-deadline-s``; the disaggregated
roles' ``--role`` and ``--handoff-targets``; the fault surface's
``--fault-spec`` (``serve/faults.py``) and ``--step-watchdog-s``;
``--tp``/``--dp`` (else ``SKYTPU_TP``/``SKYTPU_DP``, else 1).

Multi-device serving (``tp``/``dp`` above 1): this process is rank 0 of
a serving mesh (``parallel/mesh.py``). It starts one follower process
per other rank, each holding its shard of the engine; the HTTP front
end, the scheduler, the tokenizer and every host decision stay here,
and each engine call is sent to the followers before it runs.
``stop()`` shuts the followers down. On the CPU the ranks are gloo
processes (``--device cpu``); on CUDA, NCCL ranks, one card each. Every
engine option combines with ``--tp``/``--dp``: ``--adapter-slots`` (a
request's adapter loads on every rank inside the mirrored admission),
``--speculate-k`` (the proposals prepared here, outside the lock; the
followers propose from the same histories), ``--prefill-w8a8`` and a
MoE model.

Multi-host gangs (``serve/gang.py``; ``--gang-rank``, ``--gang-world``,
``--gang-coordinator``, ``--gang-id``, else the ``SKYTPU_RANK``,
``SKYTPU_WORLD``, ``SKYTPU_COORDINATOR`` and ``SKYTPU_GANG_ID`` launch
env): rank 0 is this server with a ``GangCoordinator`` on its front end
(``POST /gang/sync``, ``GET /gang/status``; readiness waits for the
barrier), and ``main()`` sends every other rank to
:func:`run_follower`. With ``tp * dp == 1`` each rank holds a whole
model and replays rank 0's op log (the replicated plane); with ``tp *
dp`` equal to the world the ranks form one serving mesh over TCP (the
mesh plane). A failed rank, join or digest fails the whole gang
(``_fatal``); drain and checkpoint wait for every rank's ack.

Gray failures: a step watchdog thread degrades the replica when an
engine step outlives ``step_watchdog_s`` (a wedged step), and so does a
storm of ``nan_alarm_threshold`` non-finite-logits evictions. A degraded
replica stays up: ``/readiness`` answers 503 ``{"status": "degraded",
"cause": ...}``, every request in flight gets a retryable error, and new
submits a retryable 503 with ``Retry-After``.
"""
from __future__ import annotations

import argparse
import collections
import http.server
import json
import logging
import math
import os
import threading
import time
import urllib.error
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Union

from skypilot_tpu_torch import telemetry
from skypilot_tpu_torch.inference import kv_transfer
from skypilot_tpu_torch.inference.engine import (InferenceEngine,
                                                 MESH_AXES,
                                                 resolve_kv_cache_dtype)
from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
from skypilot_tpu_torch.models import configs, llama
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.tokenizer import load_tokenizer, sanitize_text
from skypilot_tpu_torch.ops import flash_attention, paged_attention
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.serve import disagg as disagg_lib
from skypilot_tpu_torch.serve import faults
from skypilot_tpu_torch.serve import gang as gang_lib
from skypilot_tpu_torch.serve import scheduler as scheduler_lib
from skypilot_tpu_torch.serve import wire
from skypilot_tpu_torch.telemetry import tracing
from skypilot_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

# Outbox wait per token before a handler gives up on the engine.
_OUTBOX_TIMEOUT_S = 300


KV_CACHES = ('paged', 'slot')
Engine = Union[PagedInferenceEngine, InferenceEngine]


def build_engine(cfg: Union[str, ModelConfig, None], *, max_batch: int,
                 max_seq: int, params: Optional[llama.Params] = None,
                 model_path: Optional[str] = None,
                 seed: int = 0, kv_cache: str = 'paged',
                 page_size: Optional[int] = None,
                 quantize: Optional[str] = None,
                 kv_cache_dtype: Optional[str] = None,
                 decode_impl: Optional[str] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefill_w8a8: bool = False,
                 decode_priority_ratio: Optional[float] = None,
                 decode_steps_per_call: Optional[int] = None,
                 speculate_k: int = 0,
                 adapter_slots: int = 0,
                 adapter_dir: Optional[str] = None,
                 adapter_rank: int = 8,
                 mesh=None,
                 device: DeviceLike = 'cuda') -> Engine:
    """Construct AND warm one engine: the paged engine (``kv_cache=
    'paged'``, the default) or the slot engine (``'slot'``; its
    ``page_size`` and ``decode_impl`` do not exist, and asking for them
    raises). ``prefill_chunk_tokens`` is the chunk width of either
    engine (0 = monolithic admission, slot engine only);
    ``prefill_w8a8`` runs either engine's prefill layer matmuls on int8
    activations (``quantization.w8a8_region``; decode stays W8A16);
    ``decode_priority_ratio`` is the decode share of the interleaved
    token budget and ``decode_steps_per_call`` pins every decode call at
    k steps, on either engine; ``speculate_k`` replaces decode with
    speculative rounds of up to k proposed tokens (fused
    ``decode_steps_per_call`` rounds a call when both are set).
    ``adapter_slots > 0`` gives the engine a multi-LoRA bank of that many
    slots at ``adapter_rank``, loading ``<name>.npz`` adapters from
    ``adapter_dir`` on first use. ``cfg``
    is a preset name or
    a ``ModelConfig``; without ``params`` the weights are random, drawn
    from ``seed`` on the device and, when ``quantize`` asks, quantized
    one layer slice at a time as they are drawn (the model-dtype tree
    never exists, so mixtral-8x7b in int8 and llama3-70b in int4 build
    on one 80 GB card). Params that arrive quantized are not quantized
    again. With ``model_path`` the config and the weights come from that
    HF checkpoint directory (the engine's ``from_pretrained``; ``cfg``
    and ``params`` must be None), quantized on the host during the load
    under ``quantize='int8'`` or ``'int4'``.
    Warmup runs one short request so the first real request does not
    pay first-call costs (and advances the request-id counter exactly as
    the JAX server's warmup does). With a serving ``mesh`` the engine
    is this rank's shard; random weights are then drawn by every rank
    from ``seed`` (``param_seed``) rather than sent from here."""
    if kv_cache not in KV_CACHES:
        raise ValueError(f'unknown kv_cache {kv_cache!r}; use one of '
                         f'{KV_CACHES}')
    if kv_cache == 'slot' and (page_size, decode_impl) != (None, None):
        raise ValueError('page_size and decode_impl apply only with '
                         "kv_cache='paged'")
    dev = resolve_device(device)
    common = dict(max_batch=max_batch, max_seq=max_seq, quantize=quantize,
                  kv_cache_dtype=kv_cache_dtype,
                  decode_priority_ratio=decode_priority_ratio,
                  decode_steps_per_call=decode_steps_per_call,
                  speculate_k=speculate_k, prefill_w8a8=prefill_w8a8,
                  device=dev)
    if prefill_chunk_tokens is not None:
        common['prefill_chunk_tokens'] = prefill_chunk_tokens
    if adapter_slots:
        common.update(adapter_slots=adapter_slots, adapter_dir=adapter_dir,
                      adapter_rank=adapter_rank)
    if mesh is not None:
        common['mesh'] = mesh
    if kv_cache == 'slot':
        engine_cls = InferenceEngine
    else:
        engine_cls = PagedInferenceEngine
        common.update(page_size=page_size, decode_impl=decode_impl or 'auto')
    if model_path:
        if cfg is not None or params is not None:
            raise ValueError('model_path brings its own config and '
                             'weights; pass neither cfg nor params')
        engine = engine_cls.from_pretrained(model_path, **common)
    else:
        if isinstance(cfg, str):
            cfg = configs.get_config(cfg)
        if params is None and mesh is not None:
            common['param_seed'] = seed
        elif params is None:
            params = llama.init_params(cfg, seed, device=dev,
                                       quantize=quantize)
        engine = engine_cls(cfg, params, **common)
    engine.add_request([1, 2, 3], max_new_tokens=2)
    engine.run_to_completion(horizon=4)
    return engine



def gang_plane(gang: gang_lib.GangSpec, tp: int, dp: int) -> str:
    """The data plane of a gang (``serve/gang.py``): ``'replicated'``
    when ``tp * dp == 1`` (every rank holds a whole model and replays
    rank 0's op log), ``'mesh'`` when ``tp * dp`` equals the gang's
    world (the ranks form one serving mesh over TCP). Any other world
    raises ``ValueError``."""
    n = tp * dp
    if n == 1:
        return 'replicated'
    if n == gang.world:
        return 'mesh'
    raise ValueError(
        f'gang world {gang.world} fits neither data plane: replicated '
        f'needs tp * dp == 1 (every rank a whole model), mesh needs '
        f'tp * dp == world; got tp={tp} x dp={dp} = {n}')


def _finish_reason(req) -> str:
    """``stop`` when the request ended on eos or a stop sequence, else
    ``length``."""
    hit_eos = (req is not None and req.eos_id is not None and req.output
               and req.output[-1] == req.eos_id)
    return ('stop' if req is not None and (req.stop_hit or hit_eos)
            else 'length')


class ModelServer:

    def __init__(self, cfg_name: Union[str, ModelConfig] = 'tiny', *,
                 max_batch: int = 8, max_seq: int = 1024, port: int = 8081,
                 host: str = '127.0.0.1',
                 params: Optional[llama.Params] = None, seed: int = 0,
                 model_path: Optional[str] = None,
                 kv_cache: str = 'paged',
                 page_size: Optional[int] = None,
                 quantize: Optional[str] = None,
                 kv_cache_dtype: Optional[str] = None,
                 decode_impl: Optional[str] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefill_w8a8: bool = False,
                 decode_priority_ratio: Optional[float] = None,
                 decode_steps_per_call: Optional[int] = None,
                 speculate_k: int = 0,
                 adapter_slots: int = 0,
                 adapter_dir: Optional[str] = None,
                 adapter_rank: int = 8,
                 slo_tier_default: str = 'latency',
                 max_queue_tokens: Optional[int] = None,
                 latency_admit_frac: float = 0.7,
                 drain_deadline_s: float = 30.0,
                 role: Optional[str] = None,
                 handoff_targets: Optional[List[str]] = None,
                 checkpoint_path: Optional[str] = None,
                 fault_spec: Optional[Any] = None,
                 step_watchdog_s: Optional[float] = None,
                 watchdog_clock: Optional[Callable[[], float]] = None,
                 nan_alarm_threshold: Optional[int] = None,
                 tp: Optional[int] = None, dp: Optional[int] = None,
                 gang: Optional[gang_lib.GangSpec] = None,
                 device: DeviceLike = 'cuda'):
        self.device = resolve_device(device)
        # The serving mesh's shape: the arguments, else SKYTPU_TP /
        # SKYTPU_DP, else 1 x 1 (meshless). The mesh itself is built
        # with the engine, on the engine thread.
        self.mesh_spec = mesh_lib.serving_spec_from_env(tp=tp, dp=dp)
        self.mesh: Optional[mesh_lib.ServingMesh] = None
        self.kv_cache = kv_cache      # 'paged' | 'slot'
        # HF checkpoint dir (real weights): the config, and so the name
        # the server answers with, come from it once the engine loads,
        # and ``cfg_name`` is not read.
        self.model_path = model_path
        self.cfg: Optional[ModelConfig] = None
        self.cfg_name: Optional[str] = None
        if not model_path:
            self.cfg = (configs.get_config(cfg_name)
                        if isinstance(cfg_name, str) else cfg_name)
            self.cfg_name = self.cfg.name
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.port = port
        self.host = host
        self.quantize = quantize
        self.kv_cache_dtype = kv_cache_dtype
        self._engine_kwargs = dict(
            params=params, seed=seed, kv_cache=kv_cache,
            page_size=page_size, quantize=quantize,
            kv_cache_dtype=kv_cache_dtype, decode_impl=decode_impl,
            prefill_chunk_tokens=prefill_chunk_tokens,
            prefill_w8a8=prefill_w8a8,
            decode_priority_ratio=decode_priority_ratio,
            decode_steps_per_call=decode_steps_per_call,
            speculate_k=speculate_k, adapter_slots=adapter_slots,
            adapter_dir=adapter_dir, adapter_rank=adapter_rank)
        self.decode_steps_per_call = decode_steps_per_call
        # The multi-LoRA bank's flags (0 slots = off): the ``lora`` block
        # is sized from them before the engine loads.
        self.adapter_slots = int(adapter_slots or 0)
        self.adapter_dir = adapter_dir
        self.adapter_rank = int(adapter_rank)
        self.speculate_k = int(speculate_k or 0)
        self.engine: Optional[Engine] = None
        self.tokenizer = None
        self._error: Optional[str] = None
        self._ready = threading.Event()
        self._work = threading.Event()
        self._lock = threading.Lock()          # engine mutation
        # The SLO scheduler, built up front so its /metrics schema is
        # stable from the first scrape; the engine binds once loaded.
        self.sched = scheduler_lib.RequestScheduler(
            self._lock, default_tier=slo_tier_default,
            max_queue_tokens=max_queue_tokens,
            latency_admit_frac=latency_admit_frac, wake=self._work.set)
        # Every number comes from the process registry (Prometheus text
        # at /metrics, the JSON block at /metrics?format=json); the
        # latency histograms' bounded windows give the rolling medians.
        reg = telemetry.get_registry()
        self._reg = reg
        self._m_served = reg.counter(
            'skytpu_requests_served_total',
            'Requests completed and returned to a client')
        self._m_aborted = reg.counter(
            'skytpu_requests_aborted_total',
            'Requests cancelled mid-stream (client disconnect)')
        self._h_ttft = reg.histogram(
            'skytpu_request_ttft_ms', 'Time to first token (ms)')
        self._h_tpot = reg.histogram(
            'skytpu_request_tpot_ms',
            'Mean time per output token after the first (ms)')
        self._h_queue_wait = reg.histogram(
            'skytpu_request_queue_wait_ms',
            'Time from submit to slot assignment (ms)')
        self._h_drain = reg.histogram(
            'skytpu_replica_drain_seconds',
            'Graceful-drain duration: drain start to idle (s)',
            buckets=telemetry.registry.DEFAULT_SECONDS_BUCKETS)
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._stopping = False
        self._engine_thread: Optional[threading.Thread] = None
        # Fault injection (serve/faults.py), resolved once from the
        # explicit spec or SKYTPU_FAULT_SPEC; None (the default) keeps
        # every hook at one attribute check.
        self._faults = faults.make_injector(fault_spec)
        # The robustness series (faults, gray failures, migrations,
        # drain, recovery) render as zeros from the first scrape.
        faults.register_metrics()
        # Step watchdog: the engine loop stamps the clock right before
        # ``engine.step`` and clears the stamp after it. A stamp older
        # than ``step_watchdog_s`` is a wedged step (a stuck device call)
        # while HTTP still answers: the watchdog thread then degrades
        # the replica (/readiness 503 'degraded', in-flight requests
        # failed retryably, new submits refused with a retryable 503).
        # ``watchdog_clock`` lets tests drive virtual time; 0 disables.
        self.step_watchdog_s = (
            float(step_watchdog_s) if step_watchdog_s is not None
            else float(os.environ.get('SKYTPU_STEP_WATCHDOG_S', '120')))
        self._wd_clock = watchdog_clock or time.monotonic
        self._wd_lock = threading.Lock()
        self._step_started: Optional[float] = None
        # The longest step that ended (seconds on the watchdog clock):
        # how close healthy steps come to the deadline.
        self.step_age_max_s = 0.0
        self._wd_thread: Optional[threading.Thread] = None
        self._wd_stop = threading.Event()     # wakes the watchdog at stop
        # Degraded: alive but not trustworthy (the watchdog or the NaN
        # storm alarm set it); the cause string.
        self._degraded: Optional[str] = None
        self.degraded_at: Optional[float] = None   # on the watchdog clock
        # NaN storm: single non-finite evictions stay per request, but
        # this many in all degrade the replica (bad memory, corrupt
        # weights).
        self.nan_alarm_threshold = (
            int(nan_alarm_threshold) if nan_alarm_threshold is not None
            else int(os.environ.get('SKYTPU_NAN_ALARM', '8')))
        self._nan_seen = 0
        self._nan_evict_pending = False    # a latched nan_logits fire
        self._g_wd_age = reg.gauge(
            'skytpu_engine_step_watchdog_age_seconds',
            'Age of the engine step currently in flight (0 when the '
            'loop is between steps); sustained growth = wedged step')
        # Graceful drain: every drain attribute is written under
        # _drain_lock (begin_drain is idempotent and may race the monitor
        # thread and /drain handlers).
        self.drain_deadline_s = float(drain_deadline_s)
        self._drain_lock = threading.Lock()
        self._drain_started: Optional[float] = None
        self._drain_deadline: Optional[float] = None
        self._drained = threading.Event()
        # Idempotent request keys: a bounded map of completed
        # request_key -> result, so a retried request gets the SAME
        # answer instead of a second execution.
        self._keys_lock = threading.Lock()
        self._completed_keys: 'collections.OrderedDict[str, Dict]' = \
            collections.OrderedDict()
        self._max_completed_keys = 512
        # Disaggregated serving: this replica's role (flag, else
        # SKYTPU_ROLE, else colocated) and the static peers a prefill
        # worker may hand off to without an X-Handoff-Target header.
        self.role = disagg_lib.resolve_role(role)
        self.handoff_targets = disagg_lib.static_targets(handoff_targets)
        disagg_lib.register_metrics(self.role)
        # Prefix-cache checkpoint: the argument, else the environment.
        # A drain persists the checkpoint there, and a (re)booting server
        # warms its prefix cache from the file before readiness.
        self.checkpoint_path = (checkpoint_path
                                or os.environ.get('SKYTPU_KV_CHECKPOINT_PATH')
                                or None)
        self.warm_boot: Optional[Dict[str, Any]] = None
        self._h_warmup = reg.histogram(
            'skytpu_prefix_warmup_seconds',
            'Prefix-cache warmup of a recovered replica: checkpoint '
            'POST to landed (s)',
            buckets=telemetry.registry.DEFAULT_SECONDS_BUCKETS)
        reg.counter(
            'skytpu_spot_preemptions_total',
            'Spot replica preemptions observed (advance warnings and '
            'hard cluster losses)')
        self._m_handoff = {o: disagg_lib.handoff_counter(o)
                           for o in disagg_lib.HANDOFF_OUTCOMES}
        self._m_kv_bytes = {d: disagg_lib.transfer_bytes_counter(d)
                            for d in disagg_lib.KV_TRANSFER_DIRECTIONS}
        self._h_kv_transfer = disagg_lib.transfer_seconds()
        # Multi-host gang serving (serve/gang.py): the explicit spec,
        # else the SKYTPU_COORDINATOR/SKYTPU_RANK/SKYTPU_WORLD launch
        # env; world <= 1 (the default) leaves every hook a None check.
        # Rank 0 hosts the GangCoordinator on this HTTP front end
        # (/gang/sync); nonzero ranks never build a ModelServer (main()
        # sends them to run_follower). The gang series register either
        # way, so the /metrics schema is stable from the first scrape.
        gang_lib.register_metrics()
        self.gang = gang if gang is not None else \
            gang_lib.GangSpec.from_env()
        self.gang_plane: Optional[str] = None
        self._gang: Optional[gang_lib.GangCoordinator] = None
        # The op log: the coordinator of a replicated gang (a mesh
        # gang's engine calls go over the mesh's control channel).
        self._oplog: Optional[gang_lib.GangCoordinator] = None
        self._gang_boot_blob: Optional[bytes] = None
        self._gang_drain_cid: Optional[int] = None
        if self.gang.is_gang:
            if not self.gang.is_leader:
                raise ValueError(
                    'ModelServer is the rank-0 gang process; run nonzero '
                    'ranks through the follower entry (python -m '
                    'skypilot_tpu_torch.serve.server --gang-rank N)')
            self.gang_plane = gang_plane(self.gang, self.mesh_spec.tp,
                                         self.mesh_spec.dp)
            if self.role != 'colocated':
                logger.warning('gang serving forces role=colocated (was '
                               '%s): a handoff into or out of a gang '
                               'would desync the followers', self.role)
                self.role = 'colocated'
            self._gang = gang_lib.GangCoordinator(self.gang)
            if self.gang_plane == 'replicated':
                self._oplog = self._gang
                # Every admission and cancel the scheduler performs is
                # recorded (under the engine lock), so the followers
                # replay the same engine calls.
                self.sched.on_admit = self._gang_record_admit
                self.sched.on_cancel = self._gang_record_cancel

    # ------------------------------------------------------------- engine
    def _load_engine(self) -> None:
        if self.gang_plane == 'mesh':
            # The gang's processes are the mesh's ranks, met over TCP at
            # this server's host (the HTTP port + 1000), the rendezvous
            # bounded by the join timeout.
            self.mesh = mesh_lib.gang_mesh(
                self.mesh_spec.tp, self.mesh_spec.dp,
                coordinator_url=(self.gang.coordinator
                                 or f'http://{self.host}:{self.port}'),
                rank=0, device=self.device,
                timeout_s=self.gang.join_timeout_s)
        else:
            self.mesh = mesh_lib.serving_mesh(self.mesh_spec.tp,
                                              self.mesh_spec.dp,
                                              device=self.device)
        engine = build_engine(self.cfg,
                              max_batch=self.max_batch,
                              max_seq=self.max_seq, device=self.device,
                              model_path=self.model_path, mesh=self.mesh,
                              **self._engine_kwargs)
        if self.model_path:
            self.cfg = engine.cfg
            self.cfg_name = engine.cfg.name
        self.tokenizer = load_tokenizer(
            self.model_path, model_vocab_size=engine.cfg.vocab_size)
        self.engine = engine
        self.sched.bind_engine(engine)
        # Warm boot: land a checkpoint file before readiness, so the
        # replica never serves cold when warm state exists on disk. A
        # replicated gang's leader defers the landing until the barrier
        # completes and sends it through the op log, so the followers
        # land the same entries in the same order.
        if self.checkpoint_path and os.path.exists(self.checkpoint_path):
            t0 = time.monotonic()
            try:
                with open(self.checkpoint_path, 'rb') as f:
                    blob = f.read()
                if self._oplog is not None:
                    self._gang_boot_blob = blob
                    self._ready.set()
                    return
                res = self.warm_from_checkpoint(blob)
                dt = time.monotonic() - t0
                self._h_warmup.observe(dt)
                self.warm_boot = dict(res, seconds=dt)
                logger.info('Warm boot from %s: %s', self.checkpoint_path,
                            self.warm_boot)
            except Exception as e:  # pylint: disable=broad-except
                logger.warning('Warm boot from %s failed (%s: %s); '
                               'serving cold', self.checkpoint_path,
                               type(e).__name__, e)
        self._ready.set()

    def _engine_loop(self) -> None:
        try:
            self._load_engine()
        except Exception as e:  # pylint: disable=broad-except
            self._fatal(e)
            return
        if self._stopping:
            # stop() raced the load: drop the engine just loaded.
            self.engine = None
            self._ready.clear()
            return
        while not self._stopping:
            try:
                self._work.wait()
                if self._stopping:
                    break
                if (self._gang_boot_blob is not None
                        and self._gang.all_joined):
                    self._gang_warm_boot()
                if self._faults is not None and self._fire_engine_step():
                    return               # an injected wedge never returns
                if self.speculate_k and self.engine is not None:
                    # The host n-gram matching of the next round runs
                    # BEFORE the lock, so handler threads never wait
                    # behind it; a stale result is recomputed in step().
                    self.engine.prepare_proposals()
                with self._lock:
                    # Top the engine up from the scheduler's tier queues
                    # (priority + SRW order, tier budget split), then
                    # step: the admission ORDER is decided here every
                    # step, not at submit time.
                    self.sched.fill_engine(self.engine)
                    # A prefill worker whose only live slots are HELD
                    # parks here; release_hold / submit / drain all set
                    # the wake event.
                    if self.engine.has_runnable_work():
                        # The pinned k, else long fused horizons at
                        # saturation and short ones for streaming
                        # latency when nearly idle.
                        sat = max(2, self.engine.max_batch // 2)
                        h = self.decode_steps_per_call or (
                            32 if self.engine.num_active >= sat else 8)
                        if self._oplog is not None:
                            # Recorded before it runs (op order is
                            # execution order: the engine lock holds
                            # both), so the followers run the same
                            # fused horizon.
                            self._oplog.append_op(
                                {'k': 'step', 'h': h,
                                 'prepared': bool(self.speculate_k)})
                        # The watchdog window is exactly the step.
                        self._wd_arm()
                        try:
                            events = self.engine.step(horizon=h)
                        finally:
                            self._wd_clear()
                        if self._nan_evict_pending:
                            events = self._inject_nan_evict(events)
                        if self._oplog is not None and events:
                            # The finished-request digests the
                            # followers' are checked against; before
                            # on_events pops the finished requests.
                            self._oplog.digest.update(self.engine, events)
                    else:
                        events = []
                        if not self.sched.backlog:
                            self._work.clear()
                            if self.sched.backlog:
                                # A submit raced the clear: re-arm, or
                                # the request strands until the next
                                # arrival.
                                self._work.set()
                # Outbox routing runs OUTSIDE the lock: a slow SSE
                # consumer never holds the engine step.
                self.sched.on_events(self.engine, events)
                if self._nan_storm():
                    return
            except Exception as e:  # pylint: disable=broad-except
                self._fatal(e)
                return
        # Clean stop: wake every waiter as _fatal does, the error set
        # first so woken handlers report the stop.
        if self._error is None:
            self._error = 'server stopped'
        self.sched.fail_all(self._error)

    def _fatal(self, e: Exception) -> None:
        """The engine died: drop readiness and fail every queued and
        in-flight request, so handler threads return errors instead of
        blocking. On a gang leader this fails the whole gang too: every
        follower's next sync gets the error and ends itself (one dead
        rank, dead gang; never a half-alive replica)."""
        logger.exception('Engine loop died: %s: %s', type(e).__name__, e)
        self._error = f'{type(e).__name__}: {e}'
        if self._gang is not None:
            self._gang.fail(self._error)
        self._ready.clear()
        self.sched.fail_all(self._error)

    # ------------------------------------------------ gray-failure defence
    def _fire_engine_step(self) -> bool:
        """The ``engine_step`` fault site, before the engine lock is
        taken: a stall sleeps, a crash raises into ``_fatal``, a
        ``nan_logits`` fire is latched for the next step with a live
        request. A wedge arms the watchdog stamp as a real step would and
        spins, holding no lock (so /readiness keeps answering), until the
        server stops or degrades; it then returns True and the loop
        ends, as a wedged step never returns."""
        rule = self._faults.fire('engine_step')
        if rule is None:
            return False
        if rule.kind == 'engine_stall':
            time.sleep(rule.delay_s)
        elif rule.kind == 'replica_crash':
            raise faults.InjectedFault(
                'injected replica_crash (engine_step '
                f'#{self._faults.site_count("engine_step")})')
        elif rule.kind == 'wedged_step':
            logger.warning('injected wedged_step: engine loop hanging '
                           'inside the step window')
            self._wd_arm()
            while not self._stopping and self._degraded is None:
                time.sleep(0.01)         # the injected hang itself
            return True
        elif rule.kind == 'nan_logits':
            self._nan_evict_pending = True
        return False

    def _inject_nan_evict(self, events):
        """A latched ``nan_logits`` fire (engine lock held): cancel one
        live decoding request and put the non-finite sentinel event
        first, so the scheduler fails exactly that outbox retryably, as
        a real sentinel does. Stays latched until a request decodes."""
        rids = self.engine.decoding_request_ids()
        if not rids:
            return events
        self._nan_evict_pending = False
        rid = rids[0]
        if self._oplog is not None:
            # The followers drop the same slot at the same log position.
            self._oplog.append_op({'k': 'cancel', 'rid': rid})
            self._oplog.digest.drop(rid)
        self.engine.cancel(rid)
        self.engine.nan_evictions += 1
        logger.warning('injected nan_logits: evicting request %s', rid)
        return [(rid, -1, True)] + list(events)

    def _nan_storm(self) -> bool:
        """The NaN storm alarm: ``nan_alarm_threshold`` non-finite
        evictions in all degrade the replica (the detections themselves
        were counted at each eviction). True when it fired."""
        eng = self.engine
        if eng is None or eng.nan_evictions <= self._nan_seen:
            return False
        self._nan_seen = eng.nan_evictions
        if (self.nan_alarm_threshold > 0
                and self._nan_seen >= self.nan_alarm_threshold
                and self._degraded is None):
            self._gray_degrade(
                'nan_logits', f'{self._nan_seen} non-finite-logits '
                'evictions (replica-level NaN storm)', count=False)
            return True
        return False

    def _wd_arm(self) -> None:
        with self._wd_lock:
            self._step_started = self._wd_clock()

    def _wd_clear(self) -> None:
        with self._wd_lock:
            if self._step_started is not None:
                self.step_age_max_s = max(
                    self.step_age_max_s,
                    self._wd_clock() - self._step_started)
            self._step_started = None

    def watchdog_age_s(self) -> float:
        """Age of the engine step in flight (0 between steps) on the
        watchdog clock: the ``skytpu_engine_step_watchdog_age_seconds``
        gauge."""
        with self._wd_lock:
            if self._step_started is None:
                return 0.0
            return max(0.0, self._wd_clock() - self._step_started)

    def watchdog_check(self) -> bool:
        """One watchdog evaluation (the watchdog thread's body; tests
        call it on a virtual clock): a step older than
        ``step_watchdog_s`` degrades the replica. True when it fired."""
        if self.step_watchdog_s <= 0 or self._degraded is not None:
            return False
        age = self.watchdog_age_s()
        if age <= self.step_watchdog_s:
            return False
        self._gray_degrade(
            'wedged_step', f'engine step stuck for {age:.1f}s '
            f'(deadline {self.step_watchdog_s:.1f}s)')
        return True

    def _gray_degrade(self, kind: str, detail: str,
                      count: bool = True) -> None:
        """Contain a replica-level gray failure: mark the replica
        degraded (/readiness answers 503 'degraded'), stop admitting, and
        fail every queued and in-flight request with a retryable error.
        The process stays up, as a wedged card does not stop HTTP."""
        if count:
            faults.gray_failure_counter(kind).inc()
        self.degraded_at = self._wd_clock()
        self._degraded = f'{kind}: {detail}'
        logger.warning('replica degraded (%s); failing in-flight work '
                       'over', self._degraded)
        if self._error is None:
            self._error = f'degraded ({kind}): {detail}'
        self._ready.clear()
        self.sched.fail_all(
            f'replica degraded ({kind}); retry on another replica')

    def _watchdog_loop(self) -> None:
        import random
        rng = random.Random()
        period = min(5.0, max(0.05, self.step_watchdog_s / 4.0))
        while not self._stopping and self._degraded is None:
            try:
                self.watchdog_check()
            except Exception:  # pylint: disable=broad-except
                logger.exception('watchdog check error')
            # Jittered poll; stop() wakes it at once.
            self._wd_stop.wait(period * (0.5 + rng.random()))

    # ------------------------------------------------------------- submit
    def submit(self, prompt: List[int], *, max_new_tokens: int,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Optional[int] = None, top_p: float = 1.0,
               stop=None, tier: Optional[str] = None,
               adapter: Optional[str] = None,
               tenant: Optional[str] = None,
               grammar: Optional[Any] = None,
               handoff_target: Optional[str] = None,
               trace_ctx: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
        """Blocking submit (non-streaming handlers): admission through
        the scheduler, then the outbox drained to completion. Raises
        ``scheduler.ShedError`` (HTTP 429, or 503 while draining) when
        the tier refuses it. With a ``handoff_target`` (a prefill-role
        replica) the request hands off to that decode worker after its
        first token and the continuation is collected from its stream,
        decoding here when the handoff fails."""
        if self._error is not None:
            raise RuntimeError(f'engine failed: {self._error}')
        sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                        eos_id=eos_id, stop=stop, adapter=adapter,
                        tenant=tenant, grammar=grammar)
        sr = self.sched.submit(
            prompt, max_new_tokens=max_new_tokens, tier=tier,
            trace_ctx=trace_ctx, hold=handoff_target is not None,
            **sampling)
        pre = None
        if handoff_target is not None:
            pre = sr.outbox.get(timeout=_OUTBOX_TIMEOUT_S)
            if pre[0] is not None and not pre[1]:
                result = self._collect_handoff(sr, handoff_target, prompt,
                                               sampling)
                if result is not None:
                    return result
                self._m_handoff['fallback_local'].inc()
                self.release_hold(sr)
        while True:
            token, finished = (pre if pre is not None
                               else sr.outbox.get(timeout=_OUTBOX_TIMEOUT_S))
            pre = None
            if token is None or finished:
                break
        if sr.outbox.error is not None or sr.result is None:
            raise RuntimeError(
                f'engine failed: {sr.outbox.error or self._error}')
        req = sr.result
        self._record_finished(req)
        return {
            'request_id': sr.request_id,
            'tokens': list(req.output),
            'ttft_ms': req.ttft_ms,
            'finish_reason': _finish_reason(req),
            'prompt_tokens': len(req.prompt),
        }

    def submit_stream(self, prompt: List[int], *, max_new_tokens: int,
                      temperature: float = 0.0, top_k: int = 0,
                      eos_id: Optional[int] = None, top_p: float = 1.0,
                      stop=None, tier: Optional[str] = None,
                      adapter: Optional[str] = None,
                      tenant: Optional[str] = None,
                      grammar: Optional[Any] = None, hold: bool = False,
                      trace_ctx: Optional[Dict[str, Any]] = None):
        """Register a streaming request; returns its
        ``ScheduledRequest`` (``sr.outbox`` streams ``(token, finished)``
        tuples). Callers must ``finish_stream(sr)`` when done. Raises
        ``scheduler.ShedError`` on an admission refusal. ``hold``: stop
        after the prefill-sampled first token (the handoff window; see
        ``release_hold``)."""
        if self._error is not None:
            raise RuntimeError(f'engine failed: {self._error}')
        return self.sched.submit(
            prompt, max_new_tokens=max_new_tokens, tier=tier,
            trace_ctx=trace_ctx, temperature=temperature, top_k=top_k,
            top_p=top_p, eos_id=eos_id, stop=stop, adapter=adapter,
            tenant=tenant, grammar=grammar, hold=hold)

    def release_hold(self, sr) -> None:
        """Resume local decoding of a held request: the colocated
        fallback when no decode worker took it."""
        with self._lock:
            if self.engine is not None and sr.request_id is not None:
                self.engine.release_hold(sr.request_id)
        self._work.set()

    def finish_stream(self, sr) -> None:
        """Deregister a streaming request. If the client left before it
        finished, cancel it so the slot stops generating tokens nobody
        reads, and count it as aborted, not served."""
        if sr.result is not None:
            self._record_finished(sr.result)
            return
        if self.sched.cancel(sr):
            self._m_aborted.inc()
        elif sr.result is not None:
            # Finished during the cancel race: cancel() popped the
            # finished request into sr.result instead of aborting.
            self._record_finished(sr.result)

    # ------------------------------------------------------------ handoff
    def handoff_target(self, header_value: Optional[str]) -> Optional[str]:
        """The decode worker this request hands off to: None on a
        replica that is not a prefill worker, and when neither the
        router header nor a live static peer names one (the request then
        decodes here)."""
        if self.role != 'prefill':
            return None
        return disagg_lib.pick_target(header_value, self.handoff_targets)

    def start_handoff(self, sr, target: str) -> Optional[Dict[str, Any]]:
        """Export ``sr``'s KV (quantized pools stay quantized on the
        wire) and POST it to ``target``'s ``/kv/ingest``; the response
        IS the decode worker's continuation stream. On success the local
        request is cancelled (the slot frees; its full prefix pages stay
        cached) and the caller relays the stream. Returns None on ANY
        failure: the caller keeps serving locally (the outbox still
        holds every token). A request with an adapter or a grammar
        decodes here: the snapshot carries neither. Fault sites: ``handoff``
        (``partial_response``: the POST fails before it is sent) and
        ``kv_wire`` (``kv_corruption``: one byte of the container flips,
        and the receiver's checksum refuses it)."""
        if (sr.sampling.get('adapter') is not None
                or sr.sampling.get('grammar') is not None):
            return None
        if self._faults is not None:
            rule = self._faults.fire('handoff')
            if rule is not None and rule.kind == 'partial_response':
                self._m_handoff['failed'].inc()
                logger.warning('handoff suppressed (injected '
                               'partial_response); decoding locally')
                return None
        with self._lock:
            if self.engine is None:
                return None
            snap, events = self.engine.export_kv_snapshot(sr.request_id)
        if events:
            # Tokens drained from the pipeline by the export belong to
            # their outboxes, as step() events do.
            self.sched.on_events(self.engine, events)
        if snap is None or sr.result is not None:
            return None          # finished or cancelled during the drain
        t0 = time.monotonic()
        try:
            blob = kv_transfer.encode_handoff(snap)
            if self._faults is not None:
                rule = self._faults.fire('kv_wire')
                if rule is not None and rule.kind == 'kv_corruption':
                    blob = faults.corrupt_blob(blob, rule)
                    logger.warning('injected kv_corruption on the handoff '
                                   'wire (1 byte flipped)')
            # The decode worker's continuation joins this request's
            # trace, with the prefill span as its causal parent.
            resp = wire.urlopen(
                target + '/kv/ingest', data=blob,
                headers={'Content-Type': 'application/octet-stream',
                         'X-SLO-Tier': sr.tier},
                trace={'trace_id': (sr.trace_ctx or {}).get('trace_id'),
                       'parent_span': 'prefill'},
                timeout=120)
        except urllib.error.HTTPError as e:
            body = e.read()
            outcome = 'no_capacity' if e.code == 503 else 'failed'
            self._m_handoff[outcome].inc()
            logger.warning('handoff to %s refused (HTTP %s: %r); decoding '
                           'locally', target, e.code, body[:120])
            return None
        except Exception as e:  # pylint: disable=broad-except
            self._m_handoff['failed'].inc()
            logger.warning('handoff to %s failed (%s: %s); decoding '
                           'locally', target, type(e).__name__, e)
            return None
        self._m_kv_bytes['export'].inc(len(blob))
        self._h_kv_transfer.observe(time.monotonic() - t0)
        self._m_handoff['sent'].inc()
        # The continuation lives on the decode worker now: release the
        # local slot. The snapshot's registered prefix pages stay in the
        # LRU, so a resubmit landing back here matches them.
        self.sched.cancel(sr)
        return {'prelude': [int(t) for t in snap['output']],
                'resp': resp, 'target': target}

    def _collect_handoff(self, sr, target: str, prompt,
                         sampling: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Non-streaming handoff: ``start_handoff`` and the decode
        worker's SSE continuation drained into one result dict. A decode
        failure mid-continuation resubmits ``prompt + tokens so far``
        HERE (the prefix cache makes the recompute cheap), so the caller
        still gets a complete answer."""
        ho = self.start_handoff(sr, target)
        if ho is None:
            return None
        tokens = list(ho['prelude'])
        finish_reason = None
        broke: Optional[str] = None
        try:
            with ho['resp'] as resp:
                for raw in resp:
                    if not raw.startswith(b'data:'):
                        continue
                    try:
                        ev = json.loads(raw[5:].strip())
                    except ValueError:
                        continue
                    if 'error' in ev:
                        broke = str(ev['error'])
                        break
                    if ev.get('done'):
                        finish_reason = ev.get('finish_reason', 'length')
                        break
                    if 'token' in ev:
                        tokens.append(int(ev['token']))
        except Exception as e:  # pylint: disable=broad-except
            broke = f'{type(e).__name__}: {e}'
        if finish_reason is None:
            # The decode worker died mid-continuation: finish here from
            # the tokens generated so far.
            self._m_handoff['failed'].inc()
            logger.warning('handoff continuation on %s broke (%s); '
                           'resuming locally with %d token(s) generated',
                           ho['target'], broke, len(tokens))
            remaining = sr.max_new_tokens - len(tokens)
            if remaining > 0:
                sr2 = self.sched.submit(
                    list(prompt) + tokens, max_new_tokens=remaining,
                    tier=sr.tier, **sampling)
                while True:
                    token, finished = sr2.outbox.get(
                        timeout=_OUTBOX_TIMEOUT_S)
                    if token is None:
                        raise RuntimeError(
                            f'engine failed: {sr2.outbox.error}')
                    if finished:
                        break
                req2 = sr2.result
                # req2.output is the continuation (stop sequences arrive
                # trimmed).
                tokens = tokens + list(req2.output if req2 is not None
                                       else [])
                finish_reason = _finish_reason(req2)
            else:
                finish_reason = 'length'
        else:
            self._m_handoff['completed'].inc()
        self._m_served.inc()
        ttft = (round((sr.first_token_time - sr.submit_time) * 1e3, 3)
                if sr.first_token_time is not None else None)
        return {
            'request_id': sr.request_id,
            'tokens': tokens,
            'ttft_ms': ttft,
            'finish_reason': finish_reason,
            'prompt_tokens': len(prompt),
            'handoff': True,
        }

    # ---------------------------------------------- prefix checkpoint
    def export_checkpoint(self, max_entries: int = 8):
        """The replica's checkpoint as ``(bytes, n_entries)``: a snapshot
        of every decoding request (SKKV) and the hottest prefix chains
        (SKPF) in one SKCK container. The receiver lands request entries
        as prefix warmth, never re-executing them. An engine that is not
        loaded yet gives an empty container."""
        entries: List[Dict[str, Any]] = []
        events: List[Any] = []
        eng = self.engine
        if eng is not None:
            with self._lock:
                if self._oplog is not None:
                    # The exports below drain the pipeline: the
                    # followers flush at the same log position.
                    self._oplog.append_op({'k': 'flush'})
                for rid in eng.decoding_request_ids():
                    if len(entries) >= max_entries:
                        break
                    snap, ev = eng.export_kv_snapshot(rid)
                    events.extend(ev)
                    if snap is not None:
                        entries.append(snap)
                pentries, ev = eng.export_prefix_snapshots(
                    max_entries=max_entries)
                events.extend(ev)
                entries.extend(pentries)
                if self._oplog is not None and events:
                    self._oplog.digest.update(eng, events)
            if events:
                # Tokens the exports drained belong to their outboxes, as
                # step() events do.
                self.sched.on_events(eng, events)
        blob = kv_transfer.encode_checkpoint(entries)
        if self._gang is not None:
            # Gang-atomic: "checkpointed" means every rank reached this
            # state. A bounded wait; stragglers leave a leader-only
            # checkpoint with a loud log, never a hang.
            cid = self._gang.command('checkpoint')
            if not self._gang.wait_acked(
                    cid, timeout=min(10.0,
                                     4 * self.gang.heartbeat_timeout_s)):
                logger.warning('gang checkpoint: not every rank acked in '
                               'time (%s); exporting the leader\'s state',
                               self._gang.status()['members'])
        self._m_kv_bytes['export'].inc(len(blob))
        return blob, len(entries)

    def export_prefix_blob(self, hash_hex: str):
        """One digest-named hot prefix chain as an SKCK container with
        one SKPF entry: ``(blob, n_rows)``, or ``(None, 0)`` when the
        chain is unknown or evicted."""
        eng = self.engine
        if eng is None:
            return None, 0
        with self._lock:
            if self._oplog is not None:
                self._oplog.append_op({'k': 'flush'})
            entry, events = eng.export_prefix_entry(hash_hex)
            if self._oplog is not None and events:
                self._oplog.digest.update(eng, events)
        if events:
            self.sched.on_events(eng, events)
        if entry is None:
            return None, 0
        blob = kv_transfer.encode_checkpoint([entry])
        self._m_kv_bytes['export'].inc(len(blob))
        return blob, int(entry['n_rows'])

    def warm_from_checkpoint(self, blob: bytes) -> Dict[str, Any]:
        """Land a checkpoint into the prefix cache: every entry (request
        snapshots included) through ``warm_prefix``, byte-exact, no
        request seated. Stops at the first capacity refusal (the hottest
        entries come first). Raises ``ValueError`` on a malformed
        container and ``RuntimeError`` when no engine is loaded."""
        entries = kv_transfer.decode_checkpoint(blob)
        warmed_rows = landed = skipped_capacity = 0
        with self._lock:
            if self.engine is None:
                raise RuntimeError('engine not loaded')
            if self._oplog is not None:
                # Through the op log (under the engine lock), so every
                # rank's prefix cache warms with the same entries: a
                # warm leader over cold followers would diverge on later
                # prefix hits.
                import base64
                self._oplog.append_op({
                    'k': 'warmup',
                    'blob': base64.b64encode(blob).decode()})
            for entry in entries:
                try:
                    rows = self.engine.warm_prefix(entry)
                except kv_transfer.HandoffCapacityError:
                    skipped_capacity = len(entries) - landed
                    break
                if rows:
                    landed += 1
                warmed_rows += rows
        self._m_kv_bytes['ingest'].inc(len(blob))
        return {'entries': len(entries), 'landed': landed,
                'warmed_rows': warmed_rows,
                'skipped_capacity': skipped_capacity,
                'kv_cache': self.kv_cache}

    def _persist_checkpoint(self) -> None:
        """Write the checkpoint to ``checkpoint_path`` (through a
        rename): the warm-boot source of a restarted replica."""
        assert self.checkpoint_path is not None
        try:
            blob, n = self.export_checkpoint()
            tmp = self.checkpoint_path + '.tmp'
            with open(tmp, 'wb') as f:
                f.write(blob)
            os.replace(tmp, self.checkpoint_path)
            logger.info('Checkpointed %d entr(ies) (%d bytes) to %s', n,
                        len(blob), self.checkpoint_path)
        except Exception as e:  # pylint: disable=broad-except
            logger.warning('Checkpoint persist failed (%s: %s)',
                           type(e).__name__, e)

    # -------------------------------------------------------------- drain
    def begin_drain(self, deadline_s: Optional[float] = None
                    ) -> Dict[str, Any]:
        """Enter graceful drain: the scheduler stops admitting (new
        submits get a retryable 503 + Retry-After), requests in flight
        run to completion, and a monitor thread records the drain's
        duration, failing whatever still runs once the deadline passes.
        With a ``checkpoint_path`` the checkpoint is written alongside
        (off this thread). Idempotent; returns the status payload."""
        with self._drain_lock:
            if self._drain_started is None:
                self._drain_started = time.monotonic()
                self._drain_deadline = self._drain_started + (
                    float(deadline_s) if deadline_s
                    else self.drain_deadline_s)
                self.sched.begin_drain()
                self._work.set()      # wake the loop to run the tail
                if self._gang is not None:
                    # The command pins the current op-log index; a
                    # follower acks once it applied everything up to
                    # it, so "gang drained" means every rank drained.
                    self._gang_drain_cid = self._gang.command(
                        'drain', {'deadline_s': float(deadline_s)
                                  if deadline_s else self.drain_deadline_s})
                if self.checkpoint_path:
                    threading.Thread(target=self._persist_checkpoint,
                                     daemon=True).start()
                threading.Thread(target=self._drain_monitor,
                                 daemon=True).start()
                logger.info('drain started: deadline %.1fs, %d request(s) '
                            'in flight',
                            self._drain_deadline - self._drain_started,
                            self.sched.inflight)
        return self.drain_status()

    def _drain_monitor(self) -> None:
        import random
        with self._drain_lock:
            started, deadline = self._drain_started, self._drain_deadline
        while time.monotonic() < deadline:
            if self.sched.drained and self._gang_drain_acked():
                break
            # Jittered poll.
            time.sleep(0.05 * (0.5 + random.random()))
        dur = time.monotonic() - started
        clean = self.sched.drained and self._gang_drain_acked()
        self._h_drain.observe(dur)
        self._drained.set()
        if clean:
            logger.info('drain complete in %.2fs', dur)
        else:
            # Deadline passed: fail the stragglers with a retryable
            # error (a load balancer resubmits them elsewhere).
            logger.warning('drain deadline exceeded after %.1fs with %d '
                           'request(s) still running; failing them over',
                           dur, self.sched.inflight)
            self.sched.fail_all('drain deadline exceeded; retry on '
                                'another replica')

    def _gang_drain_acked(self) -> bool:
        """True once every gang rank acked the drain command (always
        True without a gang and before a drain started)."""
        if self._gang is None:
            return True
        with self._drain_lock:
            cid = self._gang_drain_cid
        return cid is None or self._gang.acked(cid)

    def drain_status(self) -> Dict[str, Any]:
        with self._drain_lock:
            started, deadline = self._drain_started, self._drain_deadline
        now = time.monotonic()
        out = {
            'draining': started is not None,
            'drained': (self._drained.is_set() and self.sched.drained
                        and self._gang_drain_acked()),
            'inflight': self.sched.inflight,
            'deadline_remaining_s': (round(max(0.0, deadline - now), 2)
                                     if deadline is not None else None),
        }
        if self._gang is not None:
            out['gang_drain_acked'] = self._gang_drain_acked()
        return out

    # -------------------------------------------------------- idempotency
    def lookup_request_key(self, key: Optional[str]
                           ) -> Optional[Dict[str, Any]]:
        if not key:
            return None
        with self._keys_lock:
            return self._completed_keys.get(key)

    def record_request_key(self, key: Optional[str],
                           result: Dict[str, Any]) -> None:
        """Remember a completed keyed request (bounded LRU): a replay of
        the same key returns this result instead of running again."""
        if not key:
            return
        with self._keys_lock:
            self._completed_keys[key] = result
            self._completed_keys.move_to_end(key)
            while len(self._completed_keys) > self._max_completed_keys:
                self._completed_keys.popitem(last=False)

    def _record_finished(self, req) -> None:
        """Fold one finished request into the registry: the served count
        and its TTFT, TPOT and queue wait (the queue span of its
        trace)."""
        self._m_served.inc()
        if req.ttft_ms is not None:
            self._h_ttft.observe(req.ttft_ms)
        if (req.first_token_time is not None
                and req.finish_time is not None
                and len(req.output) > 1):
            self._h_tpot.observe(
                (req.finish_time - req.first_token_time) * 1e3
                / (len(req.output) - 1))
        trace = tracing.get_trace_buffer().find(req.request_id)
        if trace is not None:
            queue_ms = trace.span_ms('queue')
            if queue_ms is not None:
                self._h_queue_wait.observe(queue_ms)

    # ------------------------------------------------------------ metrics
    def _update_gauges(self) -> None:
        """Refresh the scrape-time registry gauges from engine state
        (get-or-create, so the schema is stable from the first scrape:
        zeros before the engine loads)."""
        eng = self.engine
        spec = eng.spec_metrics() if eng is not None else {}
        g = self._reg.gauge
        g('skytpu_active_slots',
          'Occupied decode slots').set(eng.num_active if eng else 0)
        # The engine queue (kept near empty by the scheduler) plus the
        # scheduler's tier backlog.
        g('skytpu_queue_depth', 'Requests waiting for a slot').set(
            (eng.queue_depth if eng else 0) + self.sched.backlog)
        g('skytpu_sched_engine_work_tokens',
          'Estimated work tokens ahead in the engine '
          '(prefill tails + decode budgets)').set(
              eng.remaining_work_tokens() if eng else 0)
        g('skytpu_prefill_inflight',
          'Slots still streaming prompt chunks in').set(
              len(getattr(eng, '_prefill_off', ())) if eng else 0)
        g('skytpu_max_batch', 'Configured decode batch').set(
            self.max_batch)
        # 0 between steps; sustained growth is a wedged step.
        self._g_wd_age.set(round(self.watchdog_age_s(), 3))
        for axis, size in self._mesh_axes().items():
            g('skytpu_mesh_shape',
              'Serving mesh axis size (1 = axis unused)',
              axis=axis).set(size)
        g('skytpu_decode_steps_per_call',
          'Pinned fused decode steps per decode call '
          '(0 = adaptive horizon)').set(
              getattr(eng, 'decode_steps_per_call', None)
              or self.decode_steps_per_call or 0)
        g('skytpu_speculate_k',
          'Speculative proposal depth (0 = off)').set(
              spec.get('speculate_k', 0))
        g('skytpu_spec_accept_rate',
          'Accepted / proposed draft tokens').set(
              spec.get('spec_accept_rate', 0.0))
        g('skytpu_spec_tokens_per_step',
          'Mean tokens committed per slot per verify call').set(
              spec.get('spec_tokens_per_step', 0.0))
        g('skytpu_spec_proposed_total',
          'Draft tokens proposed').set(spec.get('spec_proposed', 0))
        g('skytpu_spec_accepted_total',
          'Draft tokens accepted').set(spec.get('spec_accepted', 0))
        g('skytpu_spec_rounds_total',
          'Speculative verify rounds').set(spec.get('spec_rounds', 0))
        pool = self._kv_pool_stats()
        dtype = pool['kv_cache_dtype']
        g('skytpu_kv_pool_tokens',
          'KV cache pool tokens by state (paged: page-granular)',
          state='used', kv_cache_dtype=dtype).set(pool['tokens_used'])
        g('skytpu_kv_pool_tokens',
          'KV cache pool tokens by state (paged: page-granular)',
          state='free', kv_cache_dtype=dtype).set(pool['tokens_free'])
        g('skytpu_kv_pool_token_capacity',
          'Total KV pool token capacity',
          kv_cache_dtype=dtype).set(pool['pool_token_capacity'])
        g('skytpu_kv_pool_preemptions_total',
          'Pool-pressure preemptions (recompute requeues)').set(
              pool['preemptions'])

    def _mesh_axes(self) -> Dict[str, int]:
        """The replica's mesh shape, every logical axis (1 when
        unused)."""
        eng = self.engine
        if eng is not None:
            return eng.mesh_axes()
        return {a: 1 for a in MESH_AXES}

    def _kv_pool_stats(self) -> Dict[str, Any]:
        """The engine's KV pool stats, with a stable all-zeros fallback
        before it loads (the dtype resolved from the configured flags, so
        the gauge label never flips once serving starts)."""
        eng = self.engine
        if eng is not None:
            return eng.kv_pool_stats()
        return {'kv_cache_dtype': resolve_kv_cache_dtype(
                    self.kv_cache_dtype, self.quantize),
                'pool_token_capacity': 0, 'tokens_used': 0,
                'tokens_free': 0, 'preemptions': 0, 'kv_token_bytes': 0}

    # --------------------------------------------------------------- gang
    def _gang_record_admit(self, rid: int, sr) -> None:
        """Scheduler admission hook (engine lock held): the exact
        ``add_request`` call, for the followers' replay."""
        s = sr.sampling
        self._oplog.append_op({
            'k': 'add', 'rid': rid, 'prompt': list(sr.prompt),
            'max_new_tokens': sr.max_new_tokens,
            'priority': scheduler_lib.TIERS.index(sr.tier),
            'temperature': s.get('temperature', 0.0),
            'top_k': s.get('top_k', 0), 'top_p': s.get('top_p', 1.0),
            'eos_id': s.get('eos_id'), 'stop': s.get('stop'),
            # The followers decode with the same bank row and logit mask,
            # or their digests diverge on the first adapter token.
            'adapter': s.get('adapter'), 'tenant': s.get('tenant'),
            'grammar': s.get('grammar'),
            # The followers' replay joins the same fleet trace.
            'trace_id': (sr.trace_ctx or {}).get('trace_id')})

    def _gang_record_cancel(self, rid: int) -> None:
        self._oplog.append_op({'k': 'cancel', 'rid': rid})
        self._oplog.digest.drop(rid)

    def _gang_warm_boot(self) -> None:
        """The deferred warm boot of a replicated gang's leader, once the
        barrier is complete: ``warm_from_checkpoint`` sends the landing
        through the op log, so every rank lands it in log order."""
        blob, self._gang_boot_blob = self._gang_boot_blob, None
        t0 = time.monotonic()
        try:
            res = self.warm_from_checkpoint(blob)
            dt = time.monotonic() - t0
            self._h_warmup.observe(dt)
            self.warm_boot = dict(res, seconds=dt)
        except Exception as e:  # pylint: disable=broad-except
            logger.warning('gang warm boot failed (%s: %s); serving cold',
                           type(e).__name__, e)

    def _gang_monitor(self) -> None:
        """The leader's gang health loop: the join deadline, follower
        heartbeats and digest divergence. A gang failure goes through
        ``_fatal``: the whole replica leaves rotation at once."""
        import random
        rng = random.Random()
        while not self._stopping and self._error is None:
            try:
                self._gang.check()
            except gang_lib.GangFailure as e:
                self._gang.count_failure(e.cause)
                self._gang.fail(str(e))
                self._fatal(e)
                return
            except Exception:  # pylint: disable=broad-except
                logger.exception('gang monitor error')
            # Jittered poll.
            time.sleep(self.gang.heartbeat_s * (0.5 + rng.random()))

    def gang_status(self) -> Dict[str, Any]:
        """The /gang/status payload (the health block a controller
        reads): the same keys whether or not this replica is a gang."""
        if self._gang is None:
            return {'gang_id': self.gang.gang_id, 'world': 1,
                    'barrier': True, 'join_seconds': None, 'ops': 0,
                    'failed': self._error, 'members': {}}
        return self._gang.status()

    def _lora_stats(self) -> Dict[str, Any]:
        """The JSON ``lora`` block: the registry's stats, or the same keys
        all zero (sized from the flags) before the engine loads and with
        the bank off, so the schema never flips once serving starts."""
        eng = self.engine
        reg = getattr(eng, 'adapters', None) if eng is not None else None
        if reg is not None:
            return reg.stats()
        return {
            'slots': self.adapter_slots, 'used': 0,
            'free': self.adapter_slots,
            'rank': self.adapter_rank if self.adapter_slots else 0,
            'targets': [], 'loads_total': 0, 'evictions_total': 0,
            'last_load_ms': 0.0, 'loaded': [], 'pinned': {},
        }

    def metrics_json(self) -> Dict[str, Any]:
        """The stable JSON gauge block (``/metrics?format=json``): the
        reference's keys, every one always present and numeric (zeros
        when idle or a feature is off), and the port's own keys after
        them."""
        eng = self.engine
        spec = eng.spec_metrics() if eng is not None else {}
        pool = self._kv_pool_stats()
        sched_stats = self.sched.json_stats()
        graphs = (eng.graph_stats() if eng is not None else
                  {'graph_captures': 0, 'graph_replays': 0,
                   'graph_capture_s': 0.0})
        steps_per_call = int(getattr(eng, 'decode_steps_per_call', None)
                             or self.decode_steps_per_call or 0)
        return {
            'requests_served': int(self._m_served.value),
            'requests_aborted': int(self._m_aborted.value),
            'active_slots': eng.num_active if eng else 0,
            'queue_depth': ((eng.queue_depth if eng else 0)
                            + self.sched.backlog),
            # Work tokens ahead: engine prefill tails and decode budgets
            # plus the scheduler's backlog.
            'queue_tokens_total': (
                (eng.remaining_work_tokens() if eng else 0)
                + sum(t['queue_tokens']
                      for t in sched_stats['tiers'].values())),
            'prefill_inflight': (len(getattr(eng, '_prefill_off', ()))
                                 if eng else 0),
            'max_batch': self.max_batch,
            'ttft_ms_median': round(self._h_ttft.quantile(0.5), 1),
            'ttft_ms_p90': round(self._h_ttft.quantile(0.9), 1),
            'ttft_window': self._h_ttft.window_len,
            'tpot_ms_median': round(self._h_tpot.quantile(0.5), 2),
            'tpot_ms_p90': round(self._h_tpot.quantile(0.9), 2),
            'queue_wait_ms_median': round(
                self._h_queue_wait.quantile(0.5), 1),
            'queue_wait_ms_p90': round(
                self._h_queue_wait.quantile(0.9), 1),
            # Speculative decoding gauges (zeros when off).
            'speculate_k': spec.get('speculate_k', self.speculate_k),
            'spec_accept_rate': round(spec.get('spec_accept_rate', 0.0), 4),
            'spec_tokens_per_step': round(
                spec.get('spec_tokens_per_step', 0.0), 3),
            'spec_proposed': spec.get('spec_proposed', 0),
            'spec_accepted': spec.get('spec_accepted', 0),
            'spec_rounds': spec.get('spec_rounds', 0),
            'kv_cache_dtype': pool['kv_cache_dtype'],
            'kv_pool_token_capacity': pool['pool_token_capacity'],
            'kv_pool_tokens_used': pool['tokens_used'],
            'kv_pool_tokens_free': pool['tokens_free'],
            'kv_pool_preemptions': pool['preemptions'],
            'mesh': dict(self._mesh_axes(),
                         devices=math.prod(self._mesh_axes().values())),
            'disagg': disagg_lib.json_block(self.role),
            'gang': self.gang_status(),
            'decode_steps_per_call': steps_per_call,
            'scheduler': {
                'prefill_chunk_tokens': getattr(eng, 'chunk', 0) or 0,
                'decode_priority_ratio': getattr(
                    eng, 'decode_priority_ratio', 0) or 0,
                'decode_steps_per_call': steps_per_call,
                'speculate_k': spec.get('speculate_k', 0),
            },
            'sched': sched_stats,
            'lora': self._lora_stats(),
            # The paged engine's hot-prefix digest (host state only; an
            # empty list on the slot engine or before the engine loads).
            'prefix_digest': {
                'page': int(getattr(eng, 'page', 0) or 0),
                'entries': (eng.hot_prefix_digest()
                            if eng is not None else []),
            },
            # The port's own keys: the cache kind, the decode attention
            # path, the kernels' launch counts and the decode graphs.
            'kv_cache': self.kv_cache,
            'decode_impl': getattr(eng, 'decode_impl', ''),
            'decode_kernel_launches': sum(
                paged_attention.launch_counts.values()),
            'prefill_kernel_launches': {
                k: flash_attention.launch_counts[k]
                for k in ('flash_fwd', 'flash_fwd_chunk')},
            'prefill_calls': dict(getattr(eng, 'prefill_calls', {})),
            'decode_substeps': eng.decode_substeps if eng else 0,
            'decode_calls': eng.decode_calls if eng else 0,
            **{k: graphs[k] for k in ('graph_captures', 'graph_replays',
                                      'graph_capture_s')},
            'device': str(self.device),
        }

    # ------------------------------------------------------------- http
    def _make_handler(server):  # noqa: N805
        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = 'HTTP/1.1'
            # Socket-op timeout: a client that stops reading its stream
            # must not pin a handler thread (and its slot) forever.
            # Above the outbox wait, so a slow engine never trips it
            # first; finish_stream cancels the slot on a timeout.
            timeout = 330

            def log_message(self, *args):  # noqa: D401 - quiet
                pass

            def _json(self, code: int, obj,
                      extra_headers: Optional[Dict[str, str]] = None
                      ) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _octets(self, blob: bytes, headers: Dict[str, str]) -> None:
                self.send_response(200)
                self.send_header('Content-Type', 'application/octet-stream')
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header('Content-Length', str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def _body(self) -> bytes:
                length = int(self.headers.get('Content-Length', 0))
                return self.rfile.read(length) if length else b''

            def _sse_start(self) -> None:
                self.send_response(200)
                self.send_header('Content-Type', 'text/event-stream')
                self.send_header('Cache-Control', 'no-cache')
                self.send_header('Connection', 'close')
                self.end_headers()
                self.close_connection = True

            def _emit(self, data: str) -> None:
                self.wfile.write(f'data: {data}\n\n'.encode())
                self.wfile.flush()

            def _shed(self, e: scheduler_lib.ShedError) -> None:
                """Admission refusal: 429 (overload) or 503 (draining),
                always with Retry-After from live queue telemetry."""
                self._json(e.http_status, {'error': {
                    'message': str(e),
                    'type': ('draining' if e.reason == 'draining'
                             else 'overloaded'),
                    'tier': e.tier,
                    'reason': e.reason,
                    'retry_after_s': e.retry_after_s,
                }}, extra_headers={'Retry-After': str(e.retry_after_s)})

            def _request_key(self, payload) -> Optional[str]:
                """Idempotency key: the JSON field wins over the
                X-Request-ID header."""
                key = payload.get('request_key')
                if key is None:
                    key = self.headers.get('X-Request-ID')
                return str(key) if key else None

            def _slo_tier(self, payload) -> Optional[str]:
                """The request's SLO tier: the JSON field (``slo_tier``)
                wins over the ``X-SLO-Tier`` header; none -> the server
                default. An unknown tier raises ValueError (400)."""
                tier = payload.get('slo_tier')
                if tier is None:
                    tier = self.headers.get('X-SLO-Tier')
                return server.sched.resolve_tier(tier)

            def _trace_ctx(self):
                """The inbound trace context (``X-Skytpu-Trace``), or
                None when absent or malformed (the engine mints an
                id)."""
                return tracing.parse_trace_header(
                    self.headers.get(tracing.TRACE_HEADER))

            def do_GET(self):  # noqa: N802
                parsed = urllib.parse.urlparse(self.path)
                query = urllib.parse.parse_qs(parsed.query)
                if parsed.path == '/readiness':
                    if server._degraded is not None:
                        # Alive, but its data plane is not trusted.
                        self._json(503, {'status': 'degraded',
                                         'cause': server._degraded,
                                         'watchdog_age_s': round(
                                             server.watchdog_age_s(), 3)})
                    elif server._error is not None:
                        self._json(503, {'status': 'failed',
                                         'error': server._error})
                    elif server.sched.draining:
                        # Out of rotation while the tail finishes.
                        self._json(503, dict(server.drain_status(),
                                             status='draining'))
                    elif (server._gang is not None
                          and not server._gang.all_joined):
                        # The gang barrier gates readiness: a partial
                        # gang never enters rotation.
                        self._json(503, dict(server.gang_status(),
                                             status='gang_joining'))
                    elif server._ready.is_set():
                        self._json(200, {'status': 'ready',
                                         'model': server.cfg_name,
                                         'gang': server.gang_status()})
                    else:
                        self._json(503, {'status': 'loading'})
                elif parsed.path == '/gang/status':
                    self._json(200, server.gang_status())
                elif parsed.path == '/drain':
                    self._json(200, server.drain_status())
                elif parsed.path == '/metrics':
                    server._update_gauges()
                    if query.get('format', [''])[0] == 'json':
                        self._json(200, server.metrics_json())
                        return
                    body = server._reg.render_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        'Content-Type', 'text/plain; version=0.0.4; '
                                        'charset=utf-8')
                    self.send_header('Content-Length', str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif parsed.path == '/kv/prefix/export':
                    h = query.get('hash', [''])[0]
                    blob, n_rows = server.export_prefix_blob(h)
                    if blob is None:
                        self._json(404, {'error': {
                            'message': f'prefix {h!r} not cached',
                            'type': 'prefix_not_found'}})
                        return
                    self._octets(blob, {'X-Prefix-Rows': str(n_rows)})
                elif parsed.path == '/telemetry/summary':
                    # ``since`` is the caller's trace cursor: only traces
                    # completed after it ship; the clock block lets the
                    # caller compute this process's skew.
                    try:
                        since = int(query.get('since', ['0'])[0])
                    except ValueError:
                        since = 0
                    server._update_gauges()
                    cursor, traces = (tracing.get_trace_buffer()
                                      .summaries_since(since))
                    self._json(200, {
                        'clock': {'wall': time.time(),
                                  'monotonic': time.monotonic()},
                        'registry': server._reg.export_wire(),
                        'traces': traces,
                        'cursor': cursor,
                    })
                elif parsed.path == '/debug/requests':
                    try:
                        limit = int(query.get('limit', ['64'])[0])
                    except ValueError:
                        limit = 64
                    self._json(200, {'requests': tracing.get_trace_buffer()
                                     .to_json(limit)})
                elif parsed.path == '/v1/models':
                    self._json(200, {
                        'object': 'list',
                        'data': [{'id': server.cfg_name, 'object': 'model',
                                  'owned_by': 'skypilot-tpu'}],
                    })
                else:
                    self._json(404, {'error': f'no route {self.path}'})

            # ----------------------------------------------- /generate
            def _stream_generate(self, prompt, is_text, kwargs,
                                 key=None) -> None:
                """SSE: one ``data:`` line per token as the engine emits
                it, then a ``done`` event with the whole sequence. On a
                prefill-role replica, once the first token lands the KV
                hands off to a decode worker and this handler relays its
                stream; a failed handoff decodes here (the first token,
                read already, re-enters the loop)."""
                tok = server.tokenizer
                target = server.handoff_target(
                    self.headers.get('X-Handoff-Target'))
                sr = server.submit_stream(prompt, hold=target is not None,
                                          trace_ctx=self._trace_ctx(),
                                          **kwargs)
                tokens: List[int] = []
                # Everything after registration is under the finally: a
                # client gone before the headers flush must still reach
                # finish_stream, or the slot decodes for nobody.
                try:
                    self._sse_start()
                    pre = None
                    if target is not None:
                        pre = sr.outbox.get(timeout=_OUTBOX_TIMEOUT_S)
                        if pre[0] is not None and not pre[1]:
                            ho = server.start_handoff(sr, target)
                            if ho is not None:
                                self._relay_handoff(ho, sr, tokens, is_text,
                                                    tok, key)
                                return
                            server._m_handoff['fallback_local'].inc()
                            server.release_hold(sr)
                    self._stream_loop(sr, tokens, is_text, tok, key, pre=pre)
                except (BrokenPipeError, ConnectionResetError):
                    pass    # client gone; finish_stream cancels
                finally:
                    server.finish_stream(sr)

            def _relay_handoff(self, ho, sr, tokens, is_text, tok,
                               key=None) -> None:
                """Relay a handoff continuation: the snapshot's prelude
                tokens (made here during prefill), then the decode
                worker's live SSE events, as ONE client stream whose done
                event carries the whole token list. A broken decode leg
                ends in a retryable error event with ``tokens_so_far``."""
                def token_event(t: int) -> Dict[str, Any]:
                    ev = {'token': int(t)}
                    if is_text:
                        ev['text'] = sanitize_text(tok.decode([int(t)]))
                    return ev

                for t in ho['prelude']:
                    tokens.append(int(t))
                    self._emit(json.dumps(token_event(t)))
                broke = None
                try:
                    with ho['resp'] as resp:
                        for raw in resp:
                            if not raw.startswith(b'data:'):
                                continue
                            try:
                                ev = json.loads(raw[5:].strip())
                            except ValueError:
                                continue
                            if 'error' in ev:
                                broke = str(ev['error'])
                                break
                            if ev.get('done'):
                                done = {'done': True,
                                        'request_id': sr.request_id,
                                        'tokens': list(tokens)}
                                if 'finish_reason' in ev:
                                    done['finish_reason'] = \
                                        ev['finish_reason']
                                if is_text:
                                    done['text'] = sanitize_text(
                                        tok.decode(tokens))
                                server.record_request_key(key, dict(done))
                                self._emit(json.dumps(done))
                                server._m_handoff['completed'].inc()
                                server._m_served.inc()
                                return
                            if 'token' in ev:
                                tokens.append(int(ev['token']))
                                self._emit(json.dumps(
                                    token_event(ev['token'])))
                    if broke is None:
                        broke = 'decode worker stream ended early'
                except (BrokenPipeError, ConnectionResetError):
                    raise       # OUR client vanished: outer cleanup
                except Exception as e:  # pylint: disable=broad-except
                    broke = f'{type(e).__name__}: {e}'
                server._m_handoff['failed'].inc()
                logger.warning('handoff continuation on %s broke (%s)',
                               ho['target'], broke)
                # failed_upstream names the dead replica (the decode
                # worker), not this healthy relay.
                self._emit(json.dumps({
                    'error': f'decode worker failed mid-stream: {broke}',
                    'retryable': True, 'retry_after_s': 1,
                    'failed_upstream': ho['target'],
                    'tokens_so_far': list(tokens)}))

            def _stream_loop(self, sr, tokens, is_text, tok, key=None,
                             pre=None) -> None:
                pending = [] if pre is None else [pre]
                while True:
                    token, finished = (pending.pop(0) if pending else
                                       sr.outbox.get(
                                           timeout=_OUTBOX_TIMEOUT_S))
                    if token is None:       # engine died / shed
                        # Retryable: the event carries what a client (or
                        # a load balancer) needs to resubmit elsewhere.
                        self._emit(json.dumps({
                            'error': sr.outbox.error or 'engine failed',
                            'retryable': True, 'retry_after_s': 1}))
                        break
                    tokens.append(int(token))
                    event = {'token': int(token)}
                    if is_text:
                        event['text'] = sanitize_text(tok.decode([int(token)]))
                    self._emit(json.dumps(event))
                    if finished:
                        done = {'done': True, 'request_id': sr.request_id,
                                'tokens': tokens}
                        if is_text:
                            done['text'] = sanitize_text(tok.decode(tokens))
                        server.record_request_key(key, dict(done))
                        self._emit(json.dumps(done))
                        break

            def _replay_stream(self, cached, is_text, tok) -> None:
                """Replay a completed keyed request as one SSE burst: the
                duplicate streams the SAME tokens, never a second run."""
                try:
                    self._sse_start()
                    for t in cached.get('tokens', []):
                        event = {'token': int(t)}
                        if is_text:
                            event['text'] = sanitize_text(tok.decode([int(t)]))
                        self.wfile.write(
                            f'data: {json.dumps(event)}\n\n'.encode())
                    done = dict(cached, done=True, deduped=True)
                    self._emit(json.dumps(done))
                except (BrokenPipeError, ConnectionResetError):
                    pass

            # ------------------------------------- OpenAI-style routes
            def _parse_sampling(self, payload, tok) -> Dict[str, Any]:
                stop = payload.get('stop')
                if stop is not None:
                    if isinstance(stop, (str, bytes)):
                        stop = [stop]
                    stop = [tok.encode(s, bos=False) if isinstance(s, str)
                            else [int(t) for t in s] for s in stop]
                kwargs = dict(
                    max_new_tokens=int(payload.get(
                        'max_tokens', payload.get('max_new_tokens', 128))),
                    temperature=float(payload.get('temperature', 0.0)),
                    top_k=int(payload.get('top_k', 0)),
                    top_p=float(payload.get('top_p', 1.0)),
                    stop=stop,
                    eos_id=payload.get('eos_id', tok.eos_id))
                # Multi-tenant LoRA and constrained decoding: the adapter
                # name (also OpenAI-style 'model: base:adapter'), the
                # tenant label, and the grammar ('json' | token-id list,
                # or response_format {type: json_object}). Forwarded only
                # when present.
                adapter = payload.get('adapter')
                model = payload.get('model')
                if adapter is None and isinstance(model, str) \
                        and ':' in model:
                    base, _, suffix = model.partition(':')
                    # A colon-bearing model id ('llama3:8b') names an
                    # adapter only when this replica has a bank or the
                    # prefix names the served model.
                    if server.adapter_slots or base == server.cfg_name:
                        adapter = suffix or None
                if adapter is not None:
                    kwargs['adapter'] = str(adapter)
                if payload.get('tenant') is not None:
                    kwargs['tenant'] = str(payload['tenant'])
                grammar = payload.get('grammar',
                                      payload.get('response_format'))
                if isinstance(grammar, dict):
                    # OpenAI response_format: {'type': 'json_object'}.
                    grammar = ('json' if grammar.get('type')
                               in ('json_object', 'json') else None)
                if grammar is not None:
                    kwargs['grammar'] = grammar
                return kwargs

            def _openai_completions(self, payload, chat: bool) -> None:
                tok = server.tokenizer
                if chat:
                    # A minimal role-tagged template (the reference's).
                    text = ''.join(f"{m['role']}: {m['content']}\n"
                                   for m in payload['messages'])
                    text += 'assistant:'
                else:
                    text = payload['prompt']
                    if (isinstance(text, list) and text
                            and isinstance(text[0], (list, str))):
                        if len(text) != 1:
                            raise ValueError(
                                'multiple prompts per request are not '
                                'supported; send one request per prompt')
                        text = text[0]
                prompt_ids = (tok.encode(text) if isinstance(text, str)
                              else [int(t) for t in text])
                kwargs = self._parse_sampling(payload, tok)
                kwargs['tier'] = self._slo_tier(payload)
                if payload.get('stream'):
                    self._openai_stream(prompt_ids, chat, kwargs)
                    return
                result = server.submit(
                    prompt_ids, handoff_target=server.handoff_target(
                        self.headers.get('X-Handoff-Target')),
                    trace_ctx=self._trace_ctx(), **kwargs)
                out_text = sanitize_text(tok.decode(result['tokens']))
                if chat:
                    choice = {'index': 0,
                              'message': {'role': 'assistant',
                                          'content': out_text},
                              'finish_reason': result['finish_reason']}
                    obj = 'chat.completion'
                else:
                    choice = {'index': 0, 'text': out_text,
                              'logprobs': None,
                              'finish_reason': result['finish_reason']}
                    obj = 'text_completion'
                self._json(200, {
                    'id': f'cmpl-{result["request_id"]}',
                    'object': obj,
                    'created': int(time.time()),
                    'model': server.cfg_name,
                    'choices': [choice],
                    'usage': {
                        'prompt_tokens': result['prompt_tokens'],
                        'completion_tokens': len(result['tokens']),
                        'total_tokens': (result['prompt_tokens']
                                         + len(result['tokens'])),
                    },
                })

            def _openai_stream(self, prompt_ids, chat, kwargs) -> None:
                tok = server.tokenizer
                sr = server.submit_stream(
                    prompt_ids, trace_ctx=self._trace_ctx(), **kwargs)
                created = int(time.time())
                obj = 'chat.completion.chunk' if chat else 'text_completion'

                def chunk_of(choice):
                    return json.dumps({'id': f'cmpl-{sr.request_id}',
                                       'object': obj, 'created': created,
                                       'model': server.cfg_name,
                                       'choices': [choice]})
                try:
                    self._sse_start()
                    if chat:
                        # OpenAI chat streams open with a role delta.
                        self._emit(chunk_of({'index': 0,
                                             'delta': {'role': 'assistant'},
                                             'finish_reason': None}))
                    while True:
                        token, finished = sr.outbox.get(
                            timeout=_OUTBOX_TIMEOUT_S)
                        if token is None:
                            # An explicit error event and NO [DONE], so
                            # clients tell truncation from completion.
                            self._emit(json.dumps({'error': {
                                'message': 'engine failed'}}))
                            break
                        piece = sanitize_text(tok.decode([int(token)]))
                        choice = ({'index': 0, 'delta': {'content': piece},
                                   'finish_reason': None} if chat else
                                  {'index': 0, 'text': piece,
                                   'finish_reason': None})
                        self._emit(chunk_of(choice))
                        if finished:
                            # Terminal chunk with the real finish_reason,
                            # then [DONE]; sr.result is set before the
                            # finished token reaches the outbox.
                            reason = _finish_reason(sr.result)
                            final = ({'index': 0, 'delta': {},
                                      'finish_reason': reason} if chat
                                     else {'index': 0, 'text': '',
                                           'finish_reason': reason})
                            self._emit(chunk_of(final))
                            self._emit('[DONE]')
                            break
                except (BrokenPipeError, ConnectionResetError):
                    pass
                finally:
                    server.finish_stream(sr)

            # -------------------------------------------------- KV routes
            def _kv_ingest(self) -> None:
                """Seat a handoff and stream its continuation on this
                response: ``{"token": t}`` events, then a ``done`` event
                with the whole output and the finish reason. The request
                is seated in the engine and adopted by the scheduler
                under one hold of the engine lock. 400 for a malformed or
                mismatched handoff, 503 + Retry-After (from queue
                telemetry) when no slot or page is free or while
                draining."""
                data = self._body()
                t0 = time.monotonic()
                try:
                    snap = kv_transfer.decode_handoff(data)
                    tier = server.sched.resolve_tier(
                        self.headers.get('X-SLO-Tier'))
                except ValueError as e:
                    server._m_handoff['rejected'].inc()
                    if 'checksum mismatch' in str(e):
                        # A flipped byte, refused before any row landed.
                        faults.gray_failure_counter('kv_corruption').inc()
                    self._json(400, {'error': {
                        'message': str(e), 'type': 'invalid_handoff'}})
                    return
                if server.sched.draining:
                    self._json(503, {'error': {
                        'message': 'replica is draining; hand off to '
                                   'another decode worker',
                        'type': 'draining', 'retry_after_s': 5}},
                        extra_headers={'Retry-After': '5'})
                    return
                trace_ctx = self._trace_ctx()
                if trace_ctx:
                    # The hop carries the trace on the header, not in the
                    # wire container: the continuation adopts it.
                    snap['trace'] = trace_ctx
                try:
                    with server._lock:
                        rid = server.engine.ingest_kv_snapshot(snap)
                        # Adopt under the engine lock: fail_all cannot
                        # slip between the seat and the registration.
                        sr = server.sched.adopt(
                            rid, tier=tier, prompt=snap['prompt'],
                            output=snap['output'],
                            max_new_tokens=snap['max_new_tokens'],
                            trace_ctx=trace_ctx)
                except kv_transfer.HandoffCapacityError as e:
                    server._m_handoff['no_capacity'].inc()
                    retry = server.sched.retry_after_s(
                        tier, len(snap['prompt'])
                        + int(snap['max_new_tokens']))
                    self._json(503, {'error': {
                        'message': str(e), 'type': 'no_capacity',
                        'retry_after_s': retry}},
                        extra_headers={'Retry-After': str(retry)})
                    return
                except ValueError as e:
                    server._m_handoff['rejected'].inc()
                    self._json(400, {'error': {
                        'message': str(e), 'type': 'invalid_handoff'}})
                    return
                except RuntimeError as e:
                    self._json(500, {'error': {'message': str(e)}})
                    return
                server._m_kv_bytes['ingest'].inc(len(data))
                server._h_kv_transfer.observe(time.monotonic() - t0)
                server._m_handoff['ingested'].inc()
                server._work.set()        # wake the engine loop
                try:
                    self._sse_start()
                    while True:
                        token, finished = sr.outbox.get(
                            timeout=_OUTBOX_TIMEOUT_S)
                        if token is None:
                            self._emit(json.dumps({
                                'error': sr.outbox.error or 'engine failed',
                                'retryable': True, 'retry_after_s': 1}))
                            break
                        self._emit(json.dumps({'token': int(token)}))
                        if finished:
                            req = sr.result
                            self._emit(json.dumps({
                                'done': True, 'request_id': rid,
                                'tokens': (list(req.output) if req
                                           is not None else []),
                                'finish_reason': _finish_reason(req)}))
                            break
                except (BrokenPipeError, ConnectionResetError):
                    pass    # the relay is gone; cancel below
                finally:
                    if sr.result is None:
                        # Relay gone mid-continuation: free the slot (the
                        # prefill side resubmits elsewhere).
                        server.sched.cancel(sr)

            def _checkpoint(self) -> None:
                """The checkpoint as the response body, or with a
                ``path`` in the JSON body written to that file (through a
                rename, so a reader never sees half of it) and a JSON
                summary answered."""
                try:
                    body = self._body()
                    payload = json.loads(body) if body else {}
                except ValueError:
                    self._json(400, {'error': 'bad json'})
                    return
                try:
                    blob, n = server.export_checkpoint(
                        int(payload.get('max_entries', 8)))
                except Exception as e:  # pylint: disable=broad-except
                    self._json(500, {'error': {
                        'message': f'{type(e).__name__}: {e}'}})
                    return
                path = payload.get('path')
                if not path:
                    self._octets(blob, {'X-Checkpoint-Entries': str(n)})
                    return
                tmp = path + '.tmp'
                with open(tmp, 'wb') as f:
                    f.write(blob)
                os.replace(tmp, path)
                self._json(200, {'entries': n, 'bytes': len(blob),
                                 'path': path})

            def _kv_warmup(self) -> None:
                """Land a checkpoint into the prefix cache; 400 when it
                is malformed (nothing lands), partial landings under
                pool pressure are reported."""
                try:
                    self._json(200, server.warm_from_checkpoint(
                        self._body()))
                except ValueError as e:
                    if 'checksum mismatch' in str(e):
                        faults.gray_failure_counter('kv_corruption').inc()
                    self._json(400, {'error': {
                        'message': str(e), 'type': 'invalid_checkpoint'}})
                except RuntimeError as e:
                    self._json(503, {'error': {'message': str(e)}},
                               extra_headers={'Retry-After': '5'})

            def _gang_sync(self) -> None:
                """One follower heartbeat on the leader's gang bus:
                registers or refreshes the member, checks its digests,
                answers with the op-log tail and the pending commands
                (404 when this replica leads no gang)."""
                if server._gang is None:
                    self._json(404, {'error': 'not a gang leader'})
                    return
                try:
                    payload = json.loads(self._body())
                    rank = int(payload['rank'])
                except (KeyError, ValueError, TypeError) as e:
                    self._json(400, {'error': f'{type(e).__name__}: {e}'})
                    return
                gid = payload.get('gang_id')
                if gid and server.gang.gang_id and \
                        gid != server.gang.gang_id:
                    self._json(409, {'failed': f'gang id mismatch: '
                                               f'{gid!r} != '
                                               f'{server.gang.gang_id!r}'})
                    return
                self._json(200, server._gang.sync(
                    rank, int(payload.get('applied', 0)),
                    payload.get('acks') or [],
                    payload.get('finished') or {}))

            def do_POST(self):  # noqa: N802
                routes = ('/generate', '/v1/completions',
                          '/v1/chat/completions', '/drain', '/kv/ingest',
                          '/checkpoint', '/kv/warmup', '/gang/sync')
                if self.path not in routes:
                    self._json(404, {'error': f'no route {self.path}'})
                    return
                if self.path == '/gang/sync':
                    self._gang_sync()
                    return
                if self.path == '/drain':
                    try:
                        body = self._body()
                        payload = json.loads(body) if body else {}
                    except ValueError:
                        self._json(400, {'error': 'bad json'})
                        return
                    self._json(200, server.begin_drain(
                        payload.get('deadline_s')))
                    return
                if server._degraded is not None:
                    # Retryable: never executed here.
                    self._json(503, {'status': 'degraded',
                                     'cause': server._degraded,
                                     'retry_after_s': 5},
                               extra_headers={'Retry-After': '5'})
                    return
                if not server._ready.is_set():
                    self._json(503, {'status': 'loading'},
                               extra_headers={'Retry-After': '5'})
                    return
                if self.path == '/kv/ingest' and server._gang is not None:
                    # A gang cannot adopt foreign KV: the seat would
                    # bypass the followers. Retryable elsewhere.
                    self._json(503, {'error': {
                        'message': 'gang replicas do not accept KV '
                                   'handoffs',
                        'type': 'gang', 'retry_after_s': 5}},
                        extra_headers={'Retry-After': '5'})
                    return
                kv_routes = {'/kv/ingest': self._kv_ingest,
                             '/checkpoint': self._checkpoint,
                             '/kv/warmup': self._kv_warmup}
                if self.path in kv_routes:
                    kv_routes[self.path]()
                    return
                if self.path != '/generate':
                    try:
                        payload = json.loads(self._body())
                        self._openai_completions(
                            payload,
                            chat=self.path.endswith('chat/completions'))
                    except (KeyError, ValueError, TypeError,
                            NotImplementedError) as e:
                        self._json(400, {'error': {
                            'message': f'{type(e).__name__}: {e}',
                            'type': 'invalid_request_error'}})
                    except scheduler_lib.ShedError as e:
                        # Before RuntimeError: ShedError subclasses it,
                        # and a shed is a 429/503 contract, not a 500.
                        self._shed(e)
                    except RuntimeError as e:
                        self._json(500, {'error': {'message': str(e)}})
                    return
                try:
                    payload = json.loads(self._body())
                    prompt = payload['prompt']
                    tok = server.tokenizer
                    is_text = isinstance(prompt, str)
                    prompt = (tok.encode(prompt) if is_text
                              else [int(t) for t in prompt])
                    key = self._request_key(payload)
                    cached = server.lookup_request_key(key)
                    if cached is not None:
                        # The key already completed here: the SAME answer,
                        # not a second execution.
                        if payload.get('stream'):
                            self._replay_stream(cached, is_text, tok)
                        else:
                            self._json(200, dict(cached, deduped=True))
                        return
                    kwargs = self._parse_sampling(payload, tok)
                    kwargs['tier'] = self._slo_tier(payload)
                    # eos only applies to text prompts unless asked for.
                    if 'eos_id' not in payload and not is_text:
                        kwargs['eos_id'] = None
                    if payload.get('stream'):
                        self._stream_generate(prompt, is_text, kwargs, key)
                        return
                    result = server.submit(
                        prompt, handoff_target=server.handoff_target(
                            self.headers.get('X-Handoff-Target')),
                        trace_ctx=self._trace_ctx(), **kwargs)
                    if is_text:
                        result['text'] = sanitize_text(
                            tok.decode(result['tokens']))
                    server.record_request_key(key, result)
                    self._json(200, result)
                except (KeyError, ValueError, TypeError,
                        NotImplementedError) as e:
                    self._json(400, {'error': f'{type(e).__name__}: {e}'})
                except scheduler_lib.ShedError as e:
                    self._shed(e)
                except RuntimeError as e:
                    self._json(500, {'error': str(e)})

        return Handler

    def start(self, block: bool = True) -> None:
        self._engine_thread = threading.Thread(target=self._engine_loop,
                                               daemon=True)
        self._engine_thread.start()
        if self._gang is not None:
            threading.Thread(target=self._gang_monitor, daemon=True).start()
        if self.step_watchdog_s > 0:
            self._wd_thread = threading.Thread(target=self._watchdog_loop,
                                               daemon=True)
            self._wd_thread.start()
        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), self._make_handler())
        self._httpd.daemon_threads = True
        if block:
            self._httpd.serve_forever()
        else:
            threading.Thread(target=self._httpd.serve_forever,
                             daemon=True).start()

    def wait_ready(self, timeout: float = 600.0) -> None:
        """Block until the engine is built and warmed; raises if it
        failed or the timeout passed."""
        deadline = time.monotonic() + timeout
        while not self._ready.wait(0.1):
            if self._error is not None:
                raise RuntimeError(f'engine failed: {self._error}')
            if time.monotonic() > deadline:
                raise TimeoutError('engine not ready')

    def stop(self) -> None:
        """Shut down the HTTP front end, the engine loop and the
        watchdog, and drop the engine (its weights and pool)."""
        self._stopping = True
        if self._gang is not None:
            # The followers get the shutdown command (or, missing it,
            # lose the coordinator and end themselves): nobody outlives
            # the gang. A bounded grace for the acks.
            cid = self._gang.command('shutdown')
            self._gang.wait_acked(cid,
                                  timeout=min(1.0, 2 * self.gang.heartbeat_s))
        self._work.set()
        self._wd_stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._engine_thread is not None:
            self._engine_thread.join(timeout=60)
        if self._wd_thread is not None:
            self._wd_thread.join(timeout=60)
        # Drop the scheduler's reference too, so the engine's weights,
        # pool and graphs are freed when stop() returns rather than when
        # a garbage collection finds the server's reference cycles.
        self.engine = None
        self.sched._engine = None
        if self.mesh is not None:
            # Stops and reaps the follower processes.
            self.mesh.shutdown()


def main() -> None:
    ap = argparse.ArgumentParser()
    which = ap.add_mutually_exclusive_group()
    which.add_argument('--model', default='tiny',
                       help=f'preset config name (random weights): '
                            f'{sorted(configs.PRESETS)}')
    which.add_argument('--model-path', default=None,
                       help='HF checkpoint dir (config.json + '
                            'safetensors; real weights and, with a '
                            'tokenizer.json, their tokenizer; the config '
                            'comes from it)')
    ap.add_argument('--port', type=int, default=8081)
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--max-batch', type=int, default=8)
    ap.add_argument('--max-seq', type=int, default=1024)
    ap.add_argument('--kv-cache', default='paged', choices=list(KV_CACHES),
                    help="paged (default): shared page pool with prefix "
                         "caching; slot: fixed per-slot reservations, "
                         "prefill on the flash kernels")
    ap.add_argument('--page-size', type=int, default=None)
    ap.add_argument('--quantize', default=None, choices=['int8', 'int4'],
                    help='int8 or packed int4 weight-only quantization '
                         '(KV of the same width unless --kv-cache-dtype '
                         'says otherwise; MoE expert leaves stay int8)')
    ap.add_argument('--kv-cache-dtype', default=None,
                    choices=['auto', 'bf16', 'int8', 'int4'],
                    help="paged KV storage: 'bf16' is the model dtype, "
                         "'int4' packs two codes per byte (default: auto, "
                         'follows --quantize)')
    ap.add_argument('--decode-impl', default=None,
                    choices=['gather', 'pallas', 'cross_layer'],
                    help="decode attention: 'pallas' is the CUDA paged "
                         "kernel plus a torch ring merge, 'cross_layer' "
                         "the CUDA kernel that folds the ring in, "
                         "'gather' the plain path (default: auto)")
    ap.add_argument('--prefill-chunk-tokens', type=int, default=None,
                    help='chunked-prefill chunk width in tokens (engine '
                         'default 256); 0 = monolithic prefill (slot '
                         'engine only)')
    ap.add_argument('--prefill-w8a8', action='store_true',
                    help='quantize the prefill layer matmuls\' activations '
                         'to int8 per row (int8 x int8 products through '
                         'cuBLASLt on int8 or per-channel int4 weights); '
                         'adds quantization noise to the prefilled KV '
                         'rows; decode stays W8A16')
    ap.add_argument('--decode-priority-ratio', type=float, default=None,
                    help='decode share of the interleaved token budget '
                         'while prompts are mid-prefill (engine default)')
    ap.add_argument('--decode-steps-per-call', type=int, default=None,
                    help='pin every decode call at exactly k fused steps '
                         '(default: adaptive horizons)')
    ap.add_argument('--speculate-k', type=int, default=0,
                    help='speculative decoding: propose up to K tokens a '
                         'verify round by prompt lookup (n-gram match '
                         "against each request's own history; 0 = off); "
                         'greedy outputs equal vanilla decode, sampling '
                         'keeps the output distribution')
    ap.add_argument('--adapter-slots', type=int,
                    default=int(os.environ.get('SKYTPU_ADAPTER_SLOTS', '0')),
                    help='device-resident multi-LoRA bank slots (0 = '
                         'adapters off); a request may name an adapter '
                         '("adapter", or "model": "<base>:<adapter>"); '
                         'slots load and evict by LRU, in place, with no '
                         'graph captured again. Default: '
                         '$SKYTPU_ADAPTER_SLOTS, else 0')
    ap.add_argument('--adapter-dir',
                    default=os.environ.get('SKYTPU_ADAPTER_DIR') or None,
                    help='directory of <name>.npz LoRA adapters '
                         '(models/multilora.save_adapter layout), loaded '
                         'on first use by name')
    ap.add_argument('--adapter-rank', type=int,
                    default=int(os.environ.get('SKYTPU_ADAPTER_RANK', '8')),
                    help='the bank rank: lower-rank adapters zero-pad '
                         'into it, higher-rank ones are refused')
    ap.add_argument('--checkpoint-path', default=None,
                    help='prefix-cache checkpoint file: a drain persists '
                         'the hottest prefix chains and the in-flight '
                         'requests\' KV there, and a booting server warms '
                         'its cache from it before readiness (default: '
                         '$SKYTPU_KV_CHECKPOINT_PATH)')
    ap.add_argument('--slo-tier-default', default='latency',
                    choices=list(scheduler_lib.TIERS),
                    help='SLO tier of requests that declare none ("slo_tier" '
                         'in the JSON body or the X-SLO-Tier header '
                         'overrides): latency = interactive TTFT contract, '
                         'throughput = batch tokens/s contract')
    ap.add_argument('--max-queue-tokens', type=int, default=None,
                    help='per-tier admission bound in work tokens (prompt + '
                         'decode budget); a request that would overflow its '
                         'tier is shed with HTTP 429 + Retry-After. '
                         'Default: 2x the KV pool token capacity')
    ap.add_argument('--latency-admit-frac', type=float, default=0.7,
                    help='share of admitted work tokens reserved for the '
                         'latency tier while both tiers are backlogged '
                         '(0..1, exclusive)')
    ap.add_argument('--drain-deadline-s', type=float, default=30.0,
                    help='graceful-drain deadline (seconds): after POST '
                         '/drain new requests get a retryable 503 + '
                         'Retry-After while those in flight finish; '
                         'stragglers past the deadline are failed '
                         '(retryable)')
    ap.add_argument('--role', default=None, choices=list(disagg_lib.ROLES),
                    help='disaggregated-serving role: a prefill worker '
                         'hands each finished prefill\'s KV to a decode '
                         'worker (POST /kv/ingest) and relays its token '
                         'stream; colocated (default) runs both phases. '
                         'Default: $SKYTPU_ROLE, else colocated')
    ap.add_argument('--handoff-targets', default=None,
                    help='comma-separated decode-worker base URLs a prefill '
                         'worker may hand off to when no router sent '
                         'X-Handoff-Target (picked by live KV headroom). '
                         'Default: $SKYTPU_HANDOFF_TARGETS')
    ap.add_argument('--fault-spec', default=None,
                    help='deterministic fault-injection spec (JSON or '
                         '@/path/to/spec.json; default: '
                         '$SKYTPU_FAULT_SPEC); unset, no hook does any '
                         'work')
    ap.add_argument('--step-watchdog-s', type=float, default=None,
                    help='step-watchdog deadline (seconds): an engine step '
                         'stuck longer flips /readiness to a degraded 503 '
                         'and fails the requests in flight (retryable). '
                         'Default: $SKYTPU_STEP_WATCHDOG_S, else 120; 0 '
                         'disables')
    ap.add_argument('--tp', type=int, default=None,
                    help='tensor-parallel ranks of the serving mesh '
                         '(default: $SKYTPU_TP, else 1)')
    ap.add_argument('--dp', type=int, default=None,
                    help='data-parallel ranks of the serving mesh '
                         '(default: $SKYTPU_DP, else 1)')
    ap.add_argument('--gang-rank', type=int, default=None,
                    help='gang rank (0 = the leader: HTTP front end and '
                         'scheduler; > 0 = a follower that replays the '
                         'leader\'s op log, or a rank of its serving '
                         'mesh). Default: $SKYTPU_RANK, else 0')
    ap.add_argument('--gang-world', type=int, default=None,
                    help='gang size (processes per replica; 1 = not a '
                         'gang). Default: $SKYTPU_WORLD')
    ap.add_argument('--gang-coordinator', default=None,
                    help='rank 0\'s base URL (the gang bus; required on '
                         'nonzero ranks). Default: $SKYTPU_COORDINATOR')
    ap.add_argument('--gang-id', default=None,
                    help='the shared gang identity (the unit of drain, '
                         'checkpoint and teardown). Default: '
                         '$SKYTPU_GANG_ID')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    if args.kv_cache != 'paged' and args.page_size is not None:
        ap.error('--page-size only applies with --kv-cache paged')
    if args.kv_cache != 'paged' and args.decode_impl is not None:
        ap.error('--decode-impl only applies with --kv-cache paged')
    gang_spec = gang_lib.GangSpec.from_env(
        rank=args.gang_rank, world=args.gang_world,
        coordinator=args.gang_coordinator, gang_id=args.gang_id)
    if gang_spec.is_gang and not gang_spec.is_leader:
        run_follower(gang_spec, args)
        return
    ModelServer(args.model, max_batch=args.max_batch, max_seq=args.max_seq,
                port=args.port, host=args.host, kv_cache=args.kv_cache,
                model_path=args.model_path,
                page_size=args.page_size, quantize=args.quantize,
                kv_cache_dtype=args.kv_cache_dtype,
                decode_impl=args.decode_impl,
                prefill_chunk_tokens=args.prefill_chunk_tokens,
                prefill_w8a8=args.prefill_w8a8,
                decode_priority_ratio=args.decode_priority_ratio,
                decode_steps_per_call=args.decode_steps_per_call,
                speculate_k=args.speculate_k,
                adapter_slots=args.adapter_slots,
                adapter_dir=args.adapter_dir,
                adapter_rank=args.adapter_rank,
                slo_tier_default=args.slo_tier_default,
                max_queue_tokens=args.max_queue_tokens,
                latency_admit_frac=args.latency_admit_frac,
                drain_deadline_s=args.drain_deadline_s,
                role=args.role,
                handoff_targets=(args.handoff_targets.split(',')
                                 if args.handoff_targets else None),
                checkpoint_path=args.checkpoint_path,
                fault_spec=args.fault_spec,
                step_watchdog_s=args.step_watchdog_s,
                tp=args.tp, dp=args.dp, gang=gang_spec,
                seed=args.seed, device=args.device).start(block=True)


def _launch_counts() -> Dict[str, int]:
    return {**paged_attention.launch_counts, **flash_attention.launch_counts}


def run_follower(spec: gang_lib.GangSpec, args) -> None:
    """A nonzero gang rank's whole life (``--gang-rank N``); the process
    exits 0 after a clean shutdown and 1 when the gang died.

    - Replicated plane: build the engine rank 0 builds (the same
      ``build_engine`` recipe and warm-up, so request ids, prefix-cache
      state and graphs align), join the coordinator and replay its op
      log (``gang.GangFollower``).
    - Mesh plane: heartbeat the coordinator from a thread (its commands
      acked, its failure or loss ending this process) while this rank of
      the serving mesh, met over TCP (``mesh.gang_mesh``, bounded by the
      join timeout), serves rank 0's engine calls
      (``parallel/follower.py``)."""
    import sys
    from skypilot_tpu_torch.parallel import follower as follower_lib
    mesh_spec = mesh_lib.serving_spec_from_env(tp=args.tp, dp=args.dp)
    plane = gang_plane(spec, mesh_spec.tp, mesh_spec.dp)
    injector = faults.make_injector(args.fault_spec)
    logger.info('gang follower rank %d/%d (gang %s, %s plane)', spec.rank,
                spec.world, spec.gang_id or '?', plane)
    if plane == 'replicated':
        engine = build_engine(
            None if args.model_path else args.model,
            max_batch=args.max_batch, max_seq=args.max_seq,
            model_path=args.model_path, seed=args.seed,
            kv_cache=args.kv_cache, page_size=args.page_size,
            quantize=args.quantize, kv_cache_dtype=args.kv_cache_dtype,
            decode_impl=args.decode_impl,
            prefill_chunk_tokens=args.prefill_chunk_tokens,
            prefill_w8a8=args.prefill_w8a8,
            decode_priority_ratio=args.decode_priority_ratio,
            decode_steps_per_call=args.decode_steps_per_call,
            speculate_k=args.speculate_k,
            adapter_slots=args.adapter_slots, adapter_dir=args.adapter_dir,
            adapter_rank=args.adapter_rank, device=args.device)
        before = _launch_counts()
        follower = gang_lib.GangFollower(spec, engine, faults=injector)
        cause = follower.run()
        logger.info('gang follower rank %d exiting: %s', spec.rank, cause)
        # One JSON line for the launcher: the exit cause, the ops
        # replayed, the kernel launches of the replay (the warm-up's
        # excluded) and the digest of every finished request.
        after = _launch_counts()
        print(json.dumps({'gang_follower': {
            'rank': spec.rank, 'exit': cause,
            'ops_applied': follower.ops_applied,
            'launches': {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)},
            'finished': {str(r): d
                         for r, d in follower.digest.finished.items()}}}),
              flush=True)
        sys.exit(0 if cause in ('shutdown', 'stopped') else 1)
    follower = gang_lib.GangFollower(spec, None, faults=injector)

    def heartbeat() -> None:
        try:
            cause = follower.run()
        except BaseException as e:  # noqa: BLE001 - the rank dies below
            cause = f'{type(e).__name__}: {e}'
        if cause not in ('shutdown', 'stopped'):
            logger.warning('gang follower rank %d: %s; ending the process',
                           spec.rank, cause)
            os._exit(1)

    threading.Thread(target=heartbeat, daemon=True).start()
    mesh = mesh_lib.gang_mesh(mesh_spec.tp, mesh_spec.dp,
                              coordinator_url=spec.coordinator,
                              rank=spec.rank, device=args.device,
                              timeout_s=spec.join_timeout_s)
    follower_lib.serve(mesh)
    sys.exit(0)


if __name__ == '__main__':
    main()
