"""Continuous-batching engines: the host-side request lifecycle and the
slot engine (port of ``skypilot_tpu/inference/engine.py``: ``Request``,
``_bucket_len``, ``resolve_kv_cache_dtype``, ``kv_token_bytes``,
``prepare_params``, ``_EngineBase``, ``InferenceEngine`` and
``sample_tokens``).

``_EngineBase`` owns the queue, the slot table, finish/cancel
bookkeeping, NaN eviction and the async step loop; each engine
implements ``_admit``, ``_enqueue_decode`` and ``_process_one``: the
slot engine here over a fixed ``[L, max_batch, max_seq]`` cache, the
paged engine in ``inference/paged.py``. The dispatch pipeline keeps up
to ``_PIPELINE_DEPTH`` device calls in flight: CUDA runs them
asynchronously on the current stream and the host reads each call's
tokens back one or two calls later, as in the reference.

Decode is a compiled program, as in the reference: every decode call
runs a one-step body over engine-owned buffers (``inference/
graphs.py``), replayed on CUDA as a CUDA graph captured at the first
use of its key (the reference's jit key: horizon, sample, and the
paged table width P or the slot engine's kv bucket), and called
directly on the CPU. ``decode_steps_per_call=k`` pins every decode
call at exactly k steps (the reference's multi-step knob).

``speculate_k=k`` replaces decode with speculative rounds
(``inference/speculative.py``): one propose -> verify -> commit round a
step (a CUDA graph per (k, sample, kv_bucket) on the slot engine), or
``decode_steps_per_call`` rounds fused into one graph.

KV handoff (``inference/kv_transfer.py``): ``export_kv_snapshot``
reads a decoding request's context rows back in the cache's stored
dtype with ONE sanctioned ``host_sync``, and ``ingest_kv_snapshot``
seats a request from such a snapshot in a free slot, its rows landed
at the exact original bytes, in place, so the decode graphs captured
before keep reading the same buffers. ``hold=True`` parks a request
after its first token (a handoff candidate) until ``release_hold``.
The paged engine adds the prefix checkpoint (``export_prefix_snapshots``,
``warm_prefix``) and the hot-prefix digest; on the slot engine, which
has no prefix cache, they are no-ops.

The serve scheduler (``serve/scheduler.py``) admits requests with a
``priority`` (its SLO tier): ``_queue_pop`` takes the most urgent
priority first, FIFO within a class, so a preempted request requeued at
the front keeps its place among its own class only.
``remaining_work_tokens`` is the work ahead of a new arrival that the
scheduler's ``Retry-After`` reads.

Telemetry (``telemetry=``, and the process switch ``SKYTPU_TELEMETRY=0``):
every request carries a ``RequestTrace`` (queue, prefill chunks, decode,
speculative rounds), and the step phases (``readback``, ``admit``,
``prefill_chunk``, ``decode_enqueue``, ``spec_verify``) and the first
call of each static key are timed on the host around the device work.
None of it sits inside a callable that a CUDA graph captures, and none
of it synchronises.

Multi-tenant serving (``adapter_slots > 0``): the engine carries a
multi-LoRA bank (``models/multilora.py``) under the host registry
``self.adapters`` (``inference/adapters.py``); a request naming an
``adapter`` pins its bank slot at admission (``add_request``) and
releases it exactly once when it leaves (finish, cancel, NaN eviction).
Every prefill and decode call passes each row's slot (-1 = base model,
bit for bit) as ``mlora_idx``. A request's ``grammar`` compiles to a
[vocab] bool mask applied to the logits before every draw (first token,
decode, speculative acceptance). The per-slot slots and masks live in
the static decode buffers and are uploaded only when the slot table
changes; once a grammar request was seen the decode programs always get
a mask (all-True rows for unconstrained requests), so the graph key
flips at most once.

A serving mesh (``mesh=``, ``parallel/mesh.py``): the engine keeps
this rank's shard of the weights (q/k/v, gate/up and the unembedding
column-parallel, ``wo`` and ``w_down`` row-parallel, each followed by
one all-reduce over tp) and of the KV (its kv heads over tp, replicated
when they do not divide); the constructor and every mirrored method
(``mesh.mirrored``) run on every rank, rank 0 sending each call to the
followers first, so the host state stays identical everywhere. The
decode rows split over dp: each dp rank decodes its block of slots and
the merge all-gathers the ring rows and tokens over dp first, so every
dp replica of the KV stays identical. A prefill call's batch rows split
over dp too when dp divides them (``mesh.prefill_dp_rows``, the
reference's placement): each dp rank runs its block, and the landed
rows and last hidden states are all-gathered over dp once a call.
Several kv heads that tp does not divide are replicated on every rank
(one kv shard, as the reference's byte counts have it), and each rank's
q heads attend through ``mesh.kv_head_layout``'s virtual query.
Under a mesh the engine keeps every option: MoE experts split their ffn
width over tp (each rank holds every expert) and, under dp, route every
row of the batch (``llama._attn_outputs``); the multi-LoRA bank stays
whole on every rank and each uses its part (``multilora._gather_delta``;
``register_adapter`` and every load and eviction run on every rank);
speculative verify rounds split their rows over dp as decode does and
gather the committed rows before the commit; W8A8 prefill takes the row
absmax of a row-parallel product's input over tp (``quantization.
quantize_rows``).

Gang serving (``serve/gang.py``): a replicated gang's followers replay
rank 0's op log on their own engines through ``follower_step``,
``drain_pipeline``, ``adopt_trace_context``, ``cancel``,
``release_hold`` and ``warm_prefix``; a mesh gang's followers are this
engine's mesh ranks.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import telemetry
from skypilot_tpu_torch.inference import adapters as adapters_lib
from skypilot_tpu_torch.inference import speculative
from skypilot_tpu_torch.inference.graphs import DecodeBuffers, DecodeGraphs
from skypilot_tpu_torch.inference.kv_transfer import HandoffCapacityError
from skypilot_tpu_torch.models import (llama, lora, multilora, quantization,
                                       weights)
from skypilot_tpu_torch.models.configs import ModelConfig, check_supported
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.telemetry import clock, tracing
from skypilot_tpu_torch.utils.device import (DeviceLike, device_upload,
                                             host_sync, resolve_device)


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    # Stop sequences (token-id lists): decode finishes when the output
    # ends with any of them; the matched suffix is trimmed from
    # ``output``.
    stop: Optional[List[List[int]]] = None
    stop_hit: bool = False
    # Admission priority (lower = more urgent; the serve scheduler maps
    # SLO tiers to these). Orders queue pops, FIFO within a class, so a
    # preempted request requeued at the front cannot park a
    # latency-tier request behind newly queued throughput work. Carried
    # through a KV handoff.
    priority: int = 0
    # A handoff candidate: after its prefill-sampled first token the
    # request decodes no further until ``release_hold`` (it is exported
    # to another engine, or resumes here when the handoff fails).
    hold: bool = False
    # Multi-tenant serving: the bank adapter this request decodes with
    # (None = base model, bit-identical to an engine without a bank),
    # who submitted it (a telemetry label only), and an optional grammar
    # constraint ('json' | token-id list | [vocab] bool mask).
    adapter: Optional[str] = None
    tenant: Optional[str] = None
    grammar: Any = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    nan_evicted: bool = False
    # Paged-engine early slot recycle: output tokens covered by
    # ENQUEUED device calls, and whether the slot was freed before the
    # request's tail tokens surfaced through the async pipeline.
    _enq_out: int = 0
    _early_freed: bool = False
    # Lifecycle trace (telemetry.tracing.RequestTrace; None when the
    # engine's telemetry is off, and after it was published).
    trace: Optional[Any] = None
    # The bank slot the adapter was pinned to (-1 = none), the paged
    # prefix cache's salt for its chains (empty for the base model),
    # the compiled grammar mask, and whether the registry pin was
    # released.
    _adapter_slot: int = -1
    _prefix_salt: bytes = b''
    _vocab_mask: Optional[Any] = None
    _adapter_released: bool = False

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return (self.first_token_time - self.submit_time) * 1e3


def _bucket_len(n: int, minimum: int = 64) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def dtype_bytes(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


KV_CACHE_DTYPES = ('bf16', 'int8', 'int4')


def resolve_kv_cache_dtype(kv_cache_dtype: Optional[str],
                           quantize: Optional[str]) -> str:
    """Effective KV storage dtype ('bf16' | 'int8' | 'int4'; 'bf16'
    means the model dtype). ``None``/``'auto'`` follows the weight
    quantize mode (int8 weights => int8 KV); an explicit value decouples
    them either way."""
    if kv_cache_dtype in (None, 'auto'):
        return {'int8': 'int8', 'int4': 'int4'}.get(quantize, 'bf16')
    if kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(
            f'unknown kv_cache_dtype {kv_cache_dtype!r}; supported: '
            f"{KV_CACHE_DTYPES} (None/'auto' follows the weight quantize "
            'mode)')
    return kv_cache_dtype


def kv_shard_degree(cfg, mesh=None) -> int:
    """How many ways the stored kv-head dimension splits over the mesh:
    the tp size when it divides ``n_kv_heads``, else 1 (the kv heads
    are replicated), as ``mesh.spec_for``'s divisibility rule has it."""
    return mesh_lib.axis_shard_degree(
        mesh, mesh_lib.DEFAULT_RULES['kv_heads'], cfg.n_kv_heads)


def kv_token_bytes(cfg, kv_cache_dtype: str = 'bf16', mesh=None) -> int:
    """Stored bytes of ONE cached token: k+v rows across all layers, the
    fp32 row scales included for int8 and int4 pools (int4 rows pack two
    codes per byte). Every capacity decision rides this figure. With a
    ``mesh`` the bytes ONE device stores (the kv heads split over tp;
    dp replicates): what device-memory budgets use, while token
    capacities stay global."""
    if kv_cache_dtype == 'int4':
        row = cfg.head_dim // 2 + 4
    elif kv_cache_dtype == 'int8':
        row = cfg.head_dim + 4
    elif kv_cache_dtype == 'bf16':
        row = cfg.head_dim * dtype_bytes(cfg.dtype)
    else:
        raise ValueError(f'unknown kv_cache_dtype {kv_cache_dtype!r}')
    return (cfg.n_layers * cfg.n_kv_heads * row * 2
            // kv_shard_degree(cfg, mesh))


def _ring_row_bytes(cfg, batch: int, mesh=None) -> int:
    """Bytes of ONE horizon-step's ring rows (k+v across all layers);
    with a ``mesh``, per device (the kv heads split over tp; the ring
    holds every row after the dp merge gather, so dp is not credited)."""
    return (cfg.n_layers * batch * cfg.n_kv_heads * cfg.head_dim
            * dtype_bytes(cfg.dtype) * 2) // kv_shard_degree(cfg, mesh)


_RING_BYTES_CAP = int(1e9)

# Telemetry series every engine registers at construction (zeros from
# the first scrape): the decode step's KV read traffic and the host ms
# a decode substep takes, by the attention impl that served it.
KV_READ_METRIC = 'skytpu_kv_read_bytes_per_step'
ATTN_MS_METRIC = 'skytpu_attn_kernel_ms'

# The reference's logical mesh axes: a meshless engine reports 1 on each.
MESH_AXES = mesh_lib.MESH_AXES


def _ring_horizon_cap(cfg, batch: int, param_bytes: int,
                      mesh=None) -> int:
    """Longest sensible fused-decode horizon: the ring re-read stays
    under ~15% of the weight stream AND the ring buffers under ~1 GB
    (per device under a mesh)."""
    row = _ring_row_bytes(cfg, batch, mesh)
    return max(8, min(int(0.15 * param_bytes / row),
                      _RING_BYTES_CAP // row))


def prepare_params(cfg, params, *, quantize: Optional[str] = None,
                   device: torch.device, prefill_w8a8: bool = False,
                   mesh=None, param_seed: int = 0):
    """Parameter preparation for the engine: a LoRA checkpoint's
    adapters folded into its base first (``lora.maybe_merge``; folding
    into an int8 base is refused), random weights when none are given
    (quantized slice by slice as they are drawn, so the model-dtype tree
    never exists), else int8/int4 quantization of the given tree unless
    it already carries quantized leaves (no second quantize). With
    ``prefill_w8a8`` on CUDA the engine's int8 layer codes are stored
    column-major for the int8 GEMM in a dict of its own
    (``quantization.relayout_codes_for_int8_matmul``): the caller's
    dict, and every other engine on it, keeps its layout. Returns
    (params, effective quantize mode); the engine serves the merged
    model, ``serving_config(cfg)``. Random weights are drawn from
    ``param_seed``.

    With a serving ``mesh`` the result is this rank's shard on
    ``device``, by ``llama.param_logical_axes``: random weights are
    drawn from the same seed on every rank and cut leaf by leaf, layer
    by layer, as they are drawn (``mesh.leaf_cutter``); a checkpoint's
    shard arrives already cut (``mesh.LocalShard``, from
    ``weights.load_checkpoint(cut=)``); a small given tree is cut whole
    (``mesh.shard_params``)."""
    if quantize not in (None, 'int8', 'int4'):
        raise ValueError(f'unknown quantize mode {quantize!r}; '
                         "supported: 'int8', 'int4'")
    local = isinstance(params, mesh_lib.LocalShard)
    cfg, params = lora.maybe_merge(cfg, params)
    if params is None:
        local = mesh is not None
        params = llama.init_params(
            cfg, param_seed, device=device, quantize=quantize,
            cut=None if mesh is None else mesh_lib.leaf_cutter(
                llama.param_logical_axes(cfg), mesh))
    elif quantization.quantized_mode(params) is not None:
        quantize = quantization.quantized_mode(params)
    elif quantize is not None:
        params = quantization.quantize_params(params, mode=quantize)
    if mesh is not None:
        if not local:
            params = mesh_lib.shard_params(
                params, llama.param_logical_axes(cfg), mesh)
        params = _to_device(params, device)
    if prefill_w8a8 and device.type == 'cuda':
        params = quantization.relayout_codes_for_int8_matmul(params)
    return params, quantize


def _to_device(tree, device: torch.device):
    """Every tensor of a params tree on ``device`` (a leaf already there
    is kept, not copied)."""
    if torch.is_tensor(tree):
        return tree if tree.device == device else tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, quantization.QUANT_LEAF_TYPES):
        return type(tree)(*(_to_device(t, device) for t in tree))
    return tree


def serving_config(cfg: ModelConfig) -> ModelConfig:
    """The configuration an engine serves: ``cfg`` checked, its LoRA
    fields cleared (``prepare_params`` folds the adapters into the
    base)."""
    return lora.maybe_merge(check_supported(cfg), None)[0]


def _from_pretrained(engine_cls, path: str, dtype: Optional[torch.dtype],
                     kwargs: Dict[str, Any]):
    """An engine of ``engine_cls`` over an HF checkpoint directory, on
    the device ``kwargs`` names; its ``load_s`` is the seconds the
    checkpoint took to load (read, host quantization, copies to the
    device). Under a serving ``mesh`` of several ranks, rank 0 sends the
    path and every rank reads only its own shard of the checkpoint,
    tensor by tensor (``weights.load_checkpoint(cut=)``)."""
    mesh = kwargs.get('mesh')
    if mesh is not None:
        return mesh_lib.mirrored_classmethod_load(engine_cls, path, dtype,
                                                  kwargs, _load_pretrained)
    return _load_pretrained(engine_cls, path, dtype, kwargs)


def _load_pretrained(engine_cls, path: str, dtype: Optional[torch.dtype],
                     kwargs: Dict[str, Any]):
    t0 = clock.monotonic()
    mesh = kwargs.get('mesh')
    cut = None
    if mesh is not None:
        def cut(cfg):
            return mesh_lib.leaf_cutter(llama.param_logical_axes(cfg), mesh)
    cfg, params = weights.load_checkpoint(
        path, dtype=dtype if dtype is not None else torch.bfloat16,
        quantize=kwargs.get('quantize'),
        device=mesh.device if mesh is not None
        else kwargs.get('device', 'cuda'), cut=cut)
    if mesh is not None:
        params = mesh_lib.LocalShard(params)
    load_s = clock.monotonic() - t0
    engine = engine_cls(cfg, params, **kwargs)
    engine.load_s = load_s
    return engine


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temps: torch.Tensor, topks: torch.Tensor,
                  topps: torch.Tensor, rows: Optional[slice] = None,
                  n_rows: int = 0) -> torch.Tensor:
    """Per-row next-token sampling: temperature, then top-k and nucleus
    filtering (``llama.filtered_logits``), then a categorical draw by
    the Gumbel-max trick from ``generator``. Rows with temp <= 0 take
    the greedy argmax. ``logits`` may be the block ``rows`` of an
    ``n_rows`` batch (a dp rank's decode rows): the noise is then drawn
    for the whole batch and this block taken, so every row gets its own
    noise, the same as without dp."""
    next_greedy = torch.argmax(logits, -1).to(torch.int32)
    masked = llama.filtered_logits(logits, temps, topks, topps)
    shape = masked.shape if rows is None else (n_rows, masked.shape[-1])
    u = torch.rand(shape, generator=generator, device=masked.device)
    if rows is not None:
        u = u[rows]
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    sampled = torch.argmax(masked + gumbel, -1).to(torch.int32)
    return torch.where(temps > 0, sampled, next_greedy)


# Engine methods that change host or device state (or issue
# collectives): under a serving mesh, rank 0 sends each call to the
# followers before it runs (``mesh.mirrored``).
MIRRORED = ('add_request', 'cancel', 'step', 'run_to_completion',
            'pop_finished', 'release_hold', 'export_kv_snapshot',
            'ingest_kv_snapshot', 'warm_prefix', 'export_prefix_snapshots',
            'export_prefix_entry', 'drain_pipeline', 'prefill_logits',
            'state_by_rank', 'register_adapter')


def _mirror_methods(cls) -> None:
    for name in MIRRORED:
        fn = cls.__dict__.get(name)
        if fn is not None and not getattr(fn, '_mirrored', False):
            wrapped = mesh_lib.mirrored(fn)
            wrapped._mirrored = True
            setattr(cls, name, wrapped)


class _EngineBase:
    """Host-side request lifecycle shared by the engines: queue, slot
    table, finish/cancel bookkeeping, the async step loop."""

    device: torch.device
    load_s: Optional[float] = None   # checkpoint load (from_pretrained)
    # The serving mesh (None: meshless), the tp plan of this engine's
    # model over it (``mesh.tp_plan``), the config its shard computes
    # with (local heads and mlp width), and this dp rank's decode rows
    # (None: every row).
    mesh: Optional[mesh_lib.ServingMesh] = None
    _tp_plan: Optional[Dict[str, Any]] = None
    _dp_rows: Optional[slice] = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        _mirror_methods(cls)

    def _init_mesh(self, mesh, cfg: ModelConfig, device: DeviceLike, *,
                   max_batch: int) -> torch.device:
        """Bind the serving mesh (None: meshless) and return the device
        this rank runs on: the mesh's for a rank (``device`` must name
        the same type), else ``device`` resolved. A batch that does not
        split over dp raises ``ValueError``."""
        self.mesh = mesh
        self.shard_cfg = cfg
        if mesh is None:
            return resolve_device(device)
        if device is not None and torch.device(device).type \
                != mesh.device.type:
            raise ValueError(f'device={device!r} but the mesh runs on '
                             f'{mesh.device.type}')
        self._tp_plan = mesh_lib.tp_plan(cfg, mesh)
        self.shard_cfg = mesh_lib.shard_config(cfg, mesh)
        if self._tp_plan['kv_groups'] is not None:
            self._tp_plan['kv_index'] = torch.tensor(
                self._tp_plan['kv_groups'][0], dtype=torch.long,
                device=mesh.device)
        dp = mesh.shape['dp']
        if max_batch % dp:
            raise ValueError(f'max_batch={max_batch} must divide over '
                             f'dp={dp} (each dp rank decodes a block of '
                             'slots)')
        if dp > 1:
            per = max_batch // dp
            self._dp_rows = slice(mesh.dp_rank * per,
                                  (mesh.dp_rank + 1) * per)
        return mesh.device

    def _prefill_split(self, n: int) -> Optional[slice]:
        """This dp rank's block of a prefill call's ``n`` batch rows
        (``mesh.prefill_dp_rows``); None without dp or when dp does not
        divide ``n``."""
        if self._dp_rows is None:
            return None
        return mesh_lib.prefill_dp_rows(n, self.mesh.shape['dp'],
                                        self.mesh.dp_rank)

    def _rows(self, t: Optional[torch.Tensor], dim: int = 0):
        """This dp rank's decode rows of a per-slot tensor (``t`` itself
        without dp)."""
        if t is None or self._dp_rows is None:
            return t
        idx = [slice(None)] * dim + [self._dp_rows]
        return t[tuple(idx)]

    def _dp_gather(self, ring_k: torch.Tensor, ring_v: torch.Tensor,
                   out: torch.Tensor) -> None:
        """Before the merge under dp: every dp rank's ring rows ``[L,
        rows, h, hkv, d]``, tokens ``[rows, h]`` and current tokens
        all-gathered into the full buffers, in place, so every dp
        replica merges the same rows (the reference's ring-row
        all-gather in ``_merge_rows_sharded``)."""
        if self._dp_rows is None:
            return
        rs = self._dp_rows
        ring_k.copy_(mesh_lib.all_gather(ring_k[:, rs], 'dp', 1))
        ring_v.copy_(mesh_lib.all_gather(ring_v[:, rs], 'dp', 1))
        toks = torch.cat([out[rs], self._tok_dev[rs, None]], 1)
        full = mesh_lib.all_gather(toks, 'dp', 0)
        out.copy_(full[:, :-1])
        self._tok_dev.copy_(full[:, -1])

    def mesh_axes(self) -> Dict[str, int]:
        """{axis: size} of the engine's mesh (all 1s when meshless): the
        stable schema behind ``skytpu_mesh_shape{axis=}`` and the JSON
        ``mesh`` block."""
        return mesh_lib.mesh_axis_sizes(self.mesh)

    def close(self) -> None:
        """Drop the followers' copies of this engine (a mesh engine; a
        no-op otherwise). The mesh itself stays up."""
        if self.mesh is not None and not self.mesh.closed:
            self.mesh.close_engine(self._mesh_eid)

    def state_by_rank(self) -> List[Dict[str, Any]]:
        """Each rank's state, in rank order (one entry without a mesh):
        ``kv``, a sha1 of its KV tensors' bytes (after the same calls the
        dp replicas of a shard hold the same bytes); ``bank``, a sha1 of
        its adapter bank's bytes and registry state (which adapter holds
        which slot, and the load that wrote it: the prefix-cache salts;
        None without a bank); ``spec``, its ``(spec_trail,
        spec_metrics())`` (None without speculation), equal trails
        meaning every round read back the same commits and accepted
        counts on every rank. Reads the KV and the bank back to the
        host."""
        import hashlib

        def sha1(tensors, *extra):
            h = hashlib.sha1()
            for t in tensors:
                h.update(host_sync(t.contiguous().view(-1)
                                   .view(torch.uint8)).tobytes())
            for e in extra:
                h.update(repr(e).encode())
            return h.hexdigest()

        reg = self.adapters
        mine = {
            'kv': sha1(self.cache.tensors()),
            'bank': None if reg is None else sha1(
                multilora.bank_leaves(reg.bank), list(reg._loaded.items()),
                sorted(reg._generation.items()), list(reg._free),
                sorted(reg._refs.items()), reg.loads_total,
                reg.evictions_total),
            'spec': ((self.spec_trail, self.spec_metrics())
                     if self.speculate_k else None)}
        if self.mesh is None:
            return [mine]
        return self.mesh.gather_objects(mine)

    def register_adapter(self, name: str, lora_tree: Any,
                         scale: Optional[float] = None) -> None:
        """Register ``name``'s in-memory adapter source
        (``AdapterRegistry.register``), on every rank under a serving
        mesh (a mirrored call, ordered with the loads and evictions that
        the mirrored ``add_request`` makes): the one way to register an
        adapter on a mesh engine."""
        if self.adapters is None:
            raise ValueError('the engine has no adapter bank '
                             '(adapter_slots=0)')
        self.adapters.register(name, lora_tree, scale)

    def prefill_logits(self, tokens,
                       adapters: Optional[List[Optional[str]]] = None
                       ) -> np.ndarray:
        """fp32 logits ``[n, s, vocab]`` of every position of the token
        rows ``tokens`` ``[n, s]`` under the engine's weights (an
        uncached causal prefill, ``llama.prefill_rows``, on int8
        activations under ``prefill_w8a8``; every rank's shard under a
        mesh). ``adapters`` names each row's loaded bank adapter (None:
        the base model). Reads the result back to the host."""
        toks = np.asarray(tokens, np.int32)
        (tok_d,) = device_upload((toks,), self.device)
        adp_d = None
        if adapters is not None:
            slots = [-1 if a is None else self.adapters.slot_of(a)
                     for a in adapters]
            if None in slots:
                raise ValueError(f'adapters {adapters} are not all loaded')
            (adp_d,) = device_upload((np.asarray(slots, np.int32),),
                                     self.device)
        logits, _ = llama.prefill_rows(
            self.params, tok_d, None, self.cfg,
            attn_impl=getattr(self, 'attn_impl', 'auto'), all_logits=True,
            w8a8=self.prefill_w8a8, mlora_idx=adp_d)
        return host_sync(logits)

    def _init_telemetry(self, enabled: bool = True) -> None:
        """The step-phase profiler and per-request traces. ``enabled``
        ANDs with the process switch (``SKYTPU_TELEMETRY=0``). Every
        measurement is a host clock around the engine's device work:
        nothing inside a captured graph, nothing that synchronises."""
        from skypilot_tpu_torch.telemetry import profiler as profiler_lib
        self.telemetry_enabled = bool(enabled) and telemetry.enabled()
        self._prof = (profiler_lib.StepProfiler(engine=type(self).__name__)
                      if self.telemetry_enabled
                      else profiler_lib.NullProfiler())
        # The KV-read and attention-time gauges, registered at
        # construction so both are on the first scrape (zeros).
        self._kv_read_gauge = None
        self._attn_ms_gauges: Dict[str, Any] = {}
        if self.telemetry_enabled:
            reg = telemetry.get_registry()
            self._kv_read_gauge = reg.gauge(
                KV_READ_METRIC,
                'KV-cache bytes one decode substep streams from device '
                'memory (live context rows x per-token stored cost)')
            for impl in ('per_layer', 'cross_layer'):
                self._attn_ms_gauges[impl] = reg.gauge(
                    ATTN_MS_METRIC,
                    'Host wall ms per decode substep attributed to the '
                    'attention impl serving the dispatch', impl=impl)

    def _note_decode_step(self, live_tokens: int, substeps: int,
                          dt_s: float) -> None:
        """The two decode gauges of one dispatch: the KV bytes its
        attention reads (live context rows x the per-token stored cost)
        and host wall ms per substep, labelled by the attention impl
        (``cross_layer`` is K2, every other impl ``per_layer``). Host
        arithmetic only."""
        if self._kv_read_gauge is None:
            return
        self._kv_read_gauge.set(
            live_tokens * kv_token_bytes(self.cfg, self.kv_cache_dtype))
        impl = ('cross_layer'
                if getattr(self, 'decode_impl', None) == 'cross_layer'
                else 'per_layer')
        self._attn_ms_gauges[impl].set(dt_s / max(1, substeps) * 1e3)

    def phase_stats(self) -> Dict[str, Any]:
        """This engine's step-phase decomposition and first-call
        events."""
        return self._prof.phase_stats()

    def _trace_finish(self, req: Request, **meta: Any) -> None:
        """Complete a request's trace and publish it to the process ring
        buffer (``/debug/requests``), once."""
        if req.trace is None:
            return
        req.trace.end('decode')
        req.trace.finish(output_tokens=len(req.output), **meta)
        tracing.get_trace_buffer().add(req.trace)
        req.trace = None

    def _trace_sched(self, req: Request) -> None:
        """Queue -> slot: close the queue span and open the prefill span
        (a re-admission opens both again, keeping the real timeline)."""
        if req.trace is not None:
            req.trace.end('queue')
            req.trace.begin('prefill')

    def _trace_first_token(self, req: Request) -> None:
        """A request's first token (or, after a preemption, its first
        token again) was read back: prefill -> decode."""
        if req.trace is not None:
            req.trace.end('prefill')
            req.trace.begin('decode')

    def _init_slots(self, max_batch: int) -> None:
        self._slots: List[Optional[Request]] = [None] * max_batch
        # A deque: admission REQUEUES AT THE HEAD on capacity backoff.
        # Thread safety is the caller's job (the server serializes all
        # engine calls under one lock).
        self._queue: 'collections.deque[Request]' = collections.deque()
        self._next_id = 0
        self._finished: Dict[int, Request] = {}
        self._slot_len = np.zeros(max_batch, np.int64)
        # Device calls whose results have not been read back yet, oldest
        # first: {'kind': 'prefill'|'decode', 'toks': tensor, ...}.
        self._pending: 'collections.deque[dict]' = collections.deque()
        self._inflight_steps = 0     # sum of horizons of pending decodes
        self._meta_dirty = True      # slot table changed since upload
        # Device-resident current token per slot, an engine-owned buffer
        # the decode graphs read and write in place: decode call N+1 is
        # fed call N's last token without a host round trip, and a
        # completing prefill writes its first token into it.
        self._tok_dev = torch.zeros(max_batch, dtype=torch.int32,
                                    device=self.device)
        # Decode dispatches (one per call: ``horizon`` graph replays and
        # a merge on CUDA).
        self.decode_calls = 0
        # STICKY: once a grammar request is seen, every decode program
        # gets a vocab mask (all-True rows for unconstrained requests),
        # so the graph key flips at most once.
        self._vmask_any = False

    def _init_adapters(self, slots: int, rank: int,
                       adapter_dir: Optional[str]) -> None:
        """Install the multi-LoRA bank (``adapter_slots > 0``) into
        ``params['layers']['mlora']`` before any decode graph is
        captured; 0 leaves the params tree untouched. ``self.adapters``
        is the registry, or None without a bank."""
        self.adapters = None
        if slots > 0:
            self.adapters = adapters_lib.AdapterRegistry(
                self, slots=slots, rank=rank, adapter_dir=adapter_dir)

    def _upload_row_adapters(self, reqs):
        """A prefill batch's per-row multi-tenant inputs on the device,
        ``(mlora_idx, vocab_mask)``: bank slots ``[n]`` int32 (-1 for
        base and padding rows; None without a bank) and vocab masks
        ``[n, vocab]`` bool (all-True for unconstrained and padding
        rows; None before the first grammar request). ``reqs`` holds a
        request or None per row."""
        adp = vm = None
        if self.adapters is not None:
            (adp,) = device_upload((np.array(
                [r._adapter_slot if r is not None else -1 for r in reqs],
                np.int32),), self.device)
        if self._vmask_any:
            host = np.ones((len(reqs), self.cfg.vocab_size), bool)
            for i, r in enumerate(reqs):
                if r is not None and r._vocab_mask is not None:
                    host[i] = r._vocab_mask
            (vm,) = device_upload((host,), self.device)
        return adp, vm

    def _graph_flags(self) -> Tuple[bool, bool]:
        """The decode graphs' key flags: bank present, mask on."""
        return self.adapters is not None, self._vmask_any

    def _init_decode(self, h_max: int, table_cols: int = 0) -> None:
        """The static decode buffers (rings for up to ``h_max`` steps of
        this rank's kv heads, and a speculative round's inputs and
        outputs under ``speculate_k``) and, on CUDA, the graph cache."""
        cfg = self.shard_cfg
        self._buf = DecodeBuffers(
            self.device, self.max_batch, cfg.n_layers, cfg.n_kv_heads,
            cfg.head_dim, cfg.dtype, h_max, table_cols,
            spec_k=self.speculate_k, hist_window=self.spec_hist_window,
            spec_rounds=max(1, self.decode_steps_per_call or 1),
            vocab=cfg.vocab_size)
        self._sample = False
        self._graphs = (DecodeGraphs(self.device)
                        if self.device.type == 'cuda' else None)

    def _stage_rows(self, ready: List[Optional[Request]]) -> bool:
        """Stage the per-slot sampling rows and active mask of ``ready``
        for upload when the slot table changed since the last upload;
        returns whether it did."""
        if not self._meta_dirty:
            return False
        self._buf.set_rows(ready)
        if self._vmask_any:
            # The masks have their own buffer: staged and uploaded here,
            # only when the slot table changed.
            self._buf.upload_vmask(ready)
        self._sample = any(r is not None and r.temperature > 0
                           for r in ready)
        self._meta_dirty = False
        return True

    def _step_inputs(self) -> Dict[str, Any]:
        """The decode step's multi-tenant arguments over the static
        buffers: each slot's bank slot and vocab mask (None when the
        engine has no bank, or no grammar request was seen)."""
        buf = self._buf
        return {'mlora_idx': buf.adp if self.adapters is not None else None,
                'vocab_mask': buf.vmask if self._vmask_any else None}

    def _sample_fn(self, logits: torch.Tensor) -> torch.Tensor:
        buf = self._buf
        return sample_tokens(logits, self._gen, self._rows(buf.temps),
                             self._rows(buf.topks), self._rows(buf.topps),
                             rows=self._dp_rows, n_rows=self.max_batch)

    def _run_graph(self, key, body, sample: bool = False) -> None:
        """``body`` through the key's CUDA graph (captured at first use),
        or called directly on the CPU."""
        if self._graphs is None:
            body()
        else:
            self._graphs.run(key, body,
                             generator=self._gen if sample else None)

    def _run_decode(self, horizon: int, sample: bool, step_key, merge_key,
                    step_fn, merge_fn) -> torch.Tensor:
        """One decode call over the static buffers: ``horizon`` runs of
        ``step_fn(ring_k, ring_v, out, sample_fn)`` (graph replays keyed
        ('step', horizon, sample) + ``step_key``), then
        ``merge_fn(ring_k, ring_v)`` (keyed ('merge', horizon) +
        ``merge_key``). Returns a copy of the tokens [max_batch, horizon]:
        the next call's replays overwrite the static output while this
        call's tokens wait for readback."""
        buf = self._buf
        ring_k, ring_v = buf.ring(horizon)
        out = buf.out(horizon)
        ring_k.zero_()
        ring_v.zero_()
        buf.step.zero_()
        sample_fn = self._sample_fn if sample else None
        # The step writes every slot's next token into ``_tok_dev``;
        # a held slot (masked inactive) gets its own token back after
        # the call, so ``release_hold`` resumes from it.
        held = [s for s, r in enumerate(self._slots)
                if r is not None and r.hold]
        if held:
            (held_d,) = device_upload((np.array(held, np.int64),),
                                      self.device)
            held_tok = self._tok_dev[held_d]
        step_key = step_key + self._graph_flags()
        for _ in range(horizon):
            self._run_graph(('step', horizon, sample) + step_key,
                            lambda: step_fn(ring_k, ring_v, out, sample_fn),
                            sample)
        self._run_graph(('merge', horizon) + merge_key,
                        lambda: merge_fn(ring_k, ring_v))
        if held:
            self._tok_dev[held_d] = held_tok
        self.decode_calls += 1
        return out.clone()

    # ------------------------------------------ cost-model boundary
    # The decode call's operands, for the cost model
    # (``analysis/costmodel.py``), in the reference's convention:
    # args[0] the params tree, args[1] the KV cache, then the per-call
    # control and sampling operands (the token vector and the static
    # decode buffers, every table and ring included).
    def decode_args(self) -> Tuple[Any, ...]:
        return (self.params, self.cache, self._tok_dev) + self._buf.tensors()

    def decode_operand_classes(self, args):
        from skypilot_tpu_torch.analysis import costmodel
        return costmodel.classify_decode_args(args)

    def kv_token_capacity(self) -> int:
        """Token rows the KV tensors physically hold (the divisor that
        turns them into stored bytes per token): the slot cache reserves
        ``max_batch x max_seq``; the paged engine overrides with its
        page count."""
        return self.max_batch * self.max_seq

    def graph_stats(self) -> Dict[str, Any]:
        """Captures, replays, capture seconds and pool size of the
        decode graphs (zeros on the CPU, which has none)."""
        if self._graphs is None:
            return {'graph_captures': 0, 'graph_replays': 0,
                    'graph_capture_s': 0.0, 'graph_pool_gb': 0.0}
        return self._graphs.stats()

    # Multi-step decode: when set (k >= 1), every decode enqueue runs
    # EXACTLY k fused steps (capacity-clamped) in one dispatch, on-device
    # sampling included, so per-call dispatch, readback lag and sampling
    # amortize k x. None keeps the caller-driven adaptive horizon.
    # Pinning wins over the interleave and queue-pressure shrinks but
    # never over the capacity and ring caps; the graph key stays
    # (k, sample, P or kv_bucket).
    decode_steps_per_call: Optional[int] = None

    @staticmethod
    def _validate_decode_steps(decode_steps_per_call):
        if decode_steps_per_call is None:
            return None
        k = int(decode_steps_per_call)
        if k < 1:
            raise ValueError(
                f'decode_steps_per_call must be >= 1, got {k}')
        return k

    def _pinned_horizon(self, horizon: int) -> int:
        """The fused horizon ``step()`` should run: the pinned k when
        the multi-step knob is set, else the caller's horizon."""
        return self.decode_steps_per_call or horizon

    def _ring_capacity(self, cap: int) -> int:
        """Steps the static ring holds: the pinned k under the knob (at
        most ``cap``), else the largest horizon bucket under ``cap``."""
        if self.decode_steps_per_call:
            return max(1, min(self.decode_steps_per_call, cap))
        return next((b for b in reversed(self._HORIZON_BUCKETS)
                     if b <= cap), 1)

    def _queue_pop(self) -> Optional[Request]:
        """Next request to admit: the FIRST queue entry of the most
        urgent (lowest) priority present, so FIFO within a priority
        class, and a requeue at the front keeps its meaning for its own
        class. An O(n) scan: the serve scheduler keeps this queue a few
        entries deep (it holds the backlog itself)."""
        if not self._queue:
            return None
        best_i, best_p = 0, self._queue[0].priority
        if best_p > 0:                  # a lower-priority head: scan
            for i, r in enumerate(self._queue):
                if r.priority < best_p:
                    best_i, best_p = i, r.priority
                    if best_p <= 0:
                        break
        if best_i == 0:
            return self._queue.popleft()
        req = self._queue[best_i]
        del self._queue[best_i]
        return req

    def _requeue_front(self, reqs: List[Request]) -> None:
        """Put not-yet-admitted requests back at the FRONT, preserving
        their original order."""
        self._queue.extendleft(reversed(reqs))

    # ------------------------------------------------------------- API
    def add_request(self, prompt: List[int], max_new_tokens: int = 128,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 1.0, eos_id: Optional[int] = None,
                    stop: Optional[List[List[int]]] = None,
                    priority: int = 0, hold: bool = False,
                    adapter: Optional[str] = None,
                    tenant: Optional[str] = None,
                    grammar: Any = None) -> int:
        """Queue a request; returns its id. ``adapter`` names a bank
        adapter (the engine needs ``adapter_slots > 0``): it is pinned
        HERE, so an unknown adapter (``ValueError``) or a bank whose
        every slot is pinned (``AdapterBankFullError``) rejects at
        admission, never mid-step. ``grammar`` compiles to the request's
        vocab mask (``adapters.compile_grammar``)."""
        if not prompt:
            raise ValueError('empty prompt')
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f'top_p must be in (0, 1], got {top_p}')
        if stop:
            stop = [list(s) for s in stop if s]
        self._validate_request(prompt, max_new_tokens)
        registry = self.adapters
        if adapter is not None and registry is None:
            raise ValueError(
                f'request names adapter {adapter!r} but the engine has '
                f'no adapter bank (adapter_slots=0)')
        vocab_mask = None
        if grammar is not None:
            vocab_mask = adapters_lib.compile_grammar(
                grammar, self.cfg.vocab_size, eos_id)
        # Pin the adapter BEFORE building the request: a bank-full or
        # unknown-adapter error rejects at admission.
        adapter_slot = -1
        if adapter is not None:
            adapter_slot = registry.acquire(adapter)
        req = Request(request_id=self._next_id, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      top_k=top_k, top_p=top_p, eos_id=eos_id,
                      stop=stop or None, priority=int(priority),
                      hold=bool(hold), adapter=adapter, tenant=tenant,
                      grammar=grammar, submit_time=clock.now())
        req._adapter_slot = adapter_slot
        if adapter is not None:
            req._prefix_salt = registry.prefix_salt(adapter)
        req._vocab_mask = vocab_mask
        if vocab_mask is not None and not self._vmask_any:
            # The first grammar request: the mask buffer is staged at
            # the next decode call, whatever the slot table does.
            self._vmask_any = True
            self._meta_dirty = True
        if registry is not None:
            registry.note_request(adapter)
        if self.telemetry_enabled:
            req.trace = tracing.RequestTrace(req.request_id)
            req.trace.begin('queue', prompt_tokens=len(prompt),
                            max_new_tokens=max_new_tokens)
        self._next_id += 1
        self._queue.append(req)
        return req.request_id

    def adopt_trace_context(self, request_id: int,
                            trace_id: Optional[str] = None,
                            parent_span: Optional[str] = None
                            ) -> Optional[str]:
        """Join a queued or running request to a wire-supplied trace
        context (the ``X-Skytpu-Trace`` hop header). Returns the
        request's effective trace id (minted here when no wire context
        came), or None when the request is unknown or telemetry is off.
        The caller holds the engine lock."""
        for req in list(self._queue) + [r for r in self._slots
                                        if r is not None]:
            if req.request_id == request_id:
                if req.trace is None:
                    return None
                req.trace.adopt_wire_context(trace_id, parent_span)
                return req.trace.trace_id
        return None

    def _validate_request(self, prompt: List[int],
                          max_new_tokens: int) -> None:
        if len(prompt) + max_new_tokens > self.max_seq:
            raise ValueError(
                f'prompt ({len(prompt)}) + max_new_tokens '
                f'({max_new_tokens}) exceeds engine max_seq '
                f'({self.max_seq})')

    def has_work(self) -> bool:
        return (len(self._queue) > 0
                or any(r is not None for r in self._slots))

    def has_runnable_work(self) -> bool:
        """Whether ``step`` has anything to do: queued requests, calls
        still in flight, or a live slot that is not held (when every
        live slot is held, stepping does nothing)."""
        if self._pending:
            return True
        if not self.has_work():        # the paged engine purges its lag
            return False
        if self._queue or getattr(self, '_lagging', None):
            return True
        return any(r is not None and not r.hold for r in self._slots)

    def _decode_ready(self) -> List[Optional[Request]]:
        """Per-slot request list for decode: None for empty, mid-prefill
        and held slots (a held request stops after its prefill-sampled
        first token, so no local decode races its handoff)."""
        return [None if (r is None or s in self._prefill_off or r.hold)
                else r for s, r in enumerate(self._slots)]

    def release_hold(self, request_id: int) -> bool:
        """Resume local decoding of a held request (its handoff failed
        or found no taker). True when a hold was cleared."""
        for r in list(self._queue) + [r for r in self._slots
                                      if r is not None]:
            if r.request_id == request_id and r.hold:
                r.hold = False
                self._meta_dirty = True
                return True
        return False

    preemptions = 0
    nan_evictions = 0

    def _evict_nonfinite(self, slot: int,
                         req: Request) -> Tuple[int, int, bool]:
        """The device emitted the NaN sentinel for this request: evict
        it WITHOUT recording it as finished. Returns the event tuple the
        caller appends in place of a token event."""
        req.nan_evicted = True
        req.finish_time = clock.now()
        self.nan_evictions += 1
        self._release_adapter(req)
        self._trace_finish(req, nan_evicted=True)
        if 0 <= slot < len(self._slots) and self._slots[slot] is req:
            self._free_slot(slot)
        return (req.request_id, llama.NONFINITE_TOKEN, True)

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def _slot_remaining_prefill(self, slot: int) -> int:
        """Prompt tokens this slot still has to prefill (0 once
        decodable). The chunked engines override it with their
        cursor."""
        del slot
        return 0

    def _remaining_decode(self, req: Request) -> int:
        """Decode tokens the request may still emit (budget- and
        capacity-clamped)."""
        ctx = len(req.prompt) + len(req.output)
        return max(0, min(req.max_new_tokens - len(req.output),
                          self.max_seq - ctx))

    def remaining_work_tokens(self) -> int:
        """Estimated TOKENS of work ahead of a new arrival: every queued
        request's prefill and decode budget, and every live slot's
        unprefilled prompt tail and remaining decode budget. An upper
        bound (eos and stop end early); the scheduler's Retry-After
        reads it."""
        total = 0
        for r in self._queue:
            total += len(r.prompt) + min(r.max_new_tokens,
                                         self.max_seq - len(r.prompt))
        for slot, r in enumerate(self._slots):
            if r is None:
                continue
            total += self._slot_remaining_prefill(slot)
            total += self._remaining_decode(r)
        return total

    # Fraction of the interleaved scheduler's token budget spent on
    # decode while prompts are mid-prefill (None = engine default).
    _DEFAULT_DECODE_PRIORITY = 0.5
    decode_priority_ratio: Optional[float] = None

    def _interleave_horizon(self) -> int:
        """Decode horizon to run between prefill chunk batches, from the
        ``decode_priority_ratio`` token budget: one scheduler iteration
        spends ``n x chunk`` prompt tokens on the chunk batch and
        ``active x h`` on decode, so ``h = r / (1 - r) * chunk * n /
        active`` splits the budget r : (1 - r). The caller still caps by
        its own horizon and the ring/capacity limits."""
        r = self.decode_priority_ratio
        if r is None:
            r = self._DEFAULT_DECODE_PRIORITY
        if r >= 1.0:
            return self._HORIZON_BUCKETS[-1]
        active = self.num_active - len(self._prefill_off)
        if active <= 0:
            return 1
        n = max(1, min(len(self._prefill_off), self._prefill_n_max))
        want = r / max(1.0 - r, 1e-3) * self.chunk * n / active
        return max(1, int(want))

    # Device calls kept in flight before the host reads results back.
    _PIPELINE_DEPTH = 2

    def step(self, horizon: int = 1) -> List[Tuple[int, int, bool]]:
        """Admit waiting requests (prefill), enqueue up to ``horizon``
        fused decode steps. Returns [(request_id, token, finished)] in
        emission order; results lag enqueues by up to
        ``_PIPELINE_DEPTH`` calls."""
        events: List[Tuple[int, int, bool]] = []
        # Make room in the pipeline BEFORE admitting: processing frees
        # finished slots, so admission sees the freshest slot table.
        with self._prof.phase('readback'):
            while len(self._pending) >= self._PIPELINE_DEPTH:
                events.extend(self._process_one())
        with self._prof.phase('admit'):
            events.extend(self._admit())
        with self._prof.phase('decode_enqueue'):
            enqueued = self._enqueue_decode(self._pinned_horizon(horizon))
        if not enqueued and self._pending:
            with self._prof.phase('readback'):
                events.extend(self._process_one())
        return events

    def run_to_completion(self, horizon: int = 32) -> Dict[int, Request]:
        """Drive until queue + slots + in-flight calls drain. Returns
        finished requests."""
        while self.has_runnable_work():
            self.step(horizon)
        return dict(self._finished)

    def cancel(self, request_id: int) -> bool:
        """Abort a live request (queued or in a slot). Returns True if
        it was still live; it is NOT recorded as finished."""
        dropped = [r for r in self._queue if r.request_id == request_id]
        self._queue = collections.deque(
            r for r in self._queue if r.request_id != request_id)
        if dropped:
            self._release_adapter(dropped[0])
            self._trace_finish(dropped[0], cancelled=True)
            return True
        for slot, req in enumerate(self._slots):
            if req is not None and req.request_id == request_id:
                req.finish_time = clock.now()
                self._release_adapter(req)
                self._trace_finish(req, cancelled=True)
                self._free_slot(slot)
                return True
        return False

    def pop_finished(self, request_id: int) -> Optional[Request]:
        """Consume a finished request (long-lived servers must, or the
        table grows without bound)."""
        return self._finished.pop(request_id, None)

    def export_inflight(self) -> List[Dict[str, Any]]:
        """A resubmittable record of every live request (queued and
        decoding): the prompt, the tokens generated so far and the
        remaining budget, so another replica can continue from ``prompt
        + output``."""
        out: List[Dict[str, Any]] = []
        for req in list(self._queue) + [r for r in self._slots
                                        if r is not None]:
            if req.finish_time is not None:
                continue
            out.append({
                'request_id': req.request_id,
                'prompt': list(req.prompt),
                'output': list(req.output),
                'max_new_tokens': req.max_new_tokens,
                'remaining_new_tokens': max(
                    0, req.max_new_tokens - len(req.output)),
                'temperature': req.temperature,
                'top_k': req.top_k,
                'top_p': req.top_p,
                'eos_id': req.eos_id,
                'stop': ([list(s) for s in req.stop]
                         if req.stop else None),
                'priority': req.priority,
            })
        return out

    # ----------------------------------------------------- KV handoff
    def export_kv_snapshot(self, request_id: int):
        """A resumable snapshot of a live DECODING request: ``(snapshot,
        drained events)``. The pipeline is drained first, so the host's
        view (output tokens, row counts) is complete and the device rows
        are final; the drained token events are returned for the caller
        to route like ``step()`` events. ``(None, events)`` when the
        request is not in a decodable slot (finished, cancelled, queued,
        mid-prefill, or with no first token yet). The rows come back in
        the cache's stored dtype (``_gather_kv_rows``: one sanctioned
        ``host_sync``)."""
        events = self.drain_pipeline()
        slot = next((s for s, r in enumerate(self._slots)
                     if r is not None and r.request_id == request_id),
                    None)
        if slot is None or slot in self._prefill_off:
            return None, events
        req = self._slots[slot]
        if not req.output:
            return None, events
        n_rows = int(self._slot_len[slot])
        if n_rows != len(req.prompt) + len(req.output) - 1:
            return None, events
        k, v, ks, vs = self._gather_kv_rows(slot, n_rows)
        snapshot = {
            'kv_cache_dtype': self.kv_cache_dtype,
            'n_rows': n_rows,
            'model': self._model_shape(),
            'prompt': list(req.prompt),
            'output': list(req.output),
            'max_new_tokens': req.max_new_tokens,
            'temperature': req.temperature,
            'top_k': req.top_k,
            'top_p': req.top_p,
            'eos_id': req.eos_id,
            'stop': ([list(s) for s in req.stop] if req.stop else None),
            'priority': req.priority,
            'k': k, 'v': v, 'k_scale': ks, 'v_scale': vs,
        }
        return snapshot, events

    def _model_shape(self) -> Dict[str, int]:
        cfg = self.cfg
        return {'n_layers': cfg.n_layers, 'n_kv_heads': cfg.n_kv_heads,
                'head_dim': cfg.head_dim}

    def _gather_kv_rows(self, slot: int, n_rows: int):
        """Engine-specific: the slot's first ``n_rows`` context rows on
        the host (k, v, k_scale or None, v_scale or None), token-major
        ``[L, n, hkv, d]`` (scales ``[L, n, hkv]``)."""
        raise NotImplementedError

    def decoding_request_ids(self) -> List[int]:
        """Request ids seated in slots (those ``export_kv_snapshot`` can
        snapshot)."""
        return [r.request_id for r in self._slots if r is not None]

    def drain_pipeline(self) -> List[Tuple[int, int, bool]]:
        """Read back every call in flight; returns their events (the
        caller routes them like ``step()`` events). The gang ``flush``
        op: rank 0 drains before a checkpoint export and the followers
        of a replicated gang drain at the same op-log position, so every
        rank's later event stream stays aligned."""
        events: List[Tuple[int, int, bool]] = []
        while self._pending:
            events.extend(self._process_one())
        return events

    def follower_step(self, horizon: int = 1, *,
                      prepared: bool = False
                      ) -> List[Tuple[int, int, bool]]:
        """A replicated gang follower's step (``serve/gang.py``): the
        step rank 0 recorded, with the same proposal preparation and the
        same fused horizon; returns the step's events for the
        finished-request digests (the caller reaps finished requests; no
        scheduler runs on a follower)."""
        if prepared and getattr(self, 'speculate_k', 0):
            self.prepare_proposals()
        return self.step(horizon=horizon)

    # The prefix checkpoint: the paged engine overrides these; the slot
    # engine has no prefix cache, so they export and land nothing.
    def export_prefix_snapshots(self, max_entries: int = 8):
        """The hottest prefix-cache chains as prefix entries, and the
        events drained from the pipeline. Base: ``([], [])``."""
        del max_entries
        return [], []

    def warm_prefix(self, entry: Dict[str, Any]) -> int:
        """Land a prefix entry (or a request snapshot viewed as one)
        into the prefix cache without seating a request; returns the KV
        rows landed. Base: 0 (no prefix cache; not an error)."""
        del entry
        return 0

    def hot_prefix_digest(self, max_entries: int = 16):
        """A bounded digest of the hottest prefix chains (host state
        only). Base: empty."""
        del max_entries
        return []

    def export_prefix_entry(self, hash_hex: str):
        """One digest-named hot chain as ``(entry or None, events)``.
        Base: ``(None, [])``."""
        del hash_hex
        return None, []

    def _validate_kv_entry(self, entry: Dict[str, Any],
                           n_rows: int) -> None:
        """The KV payload of an ingest or a warm-up against this engine:
        model shape, kv dtype (no transcoding) and row shapes. Raises
        ``ValueError`` (a permanent refusal)."""
        cfg = self.cfg
        model = entry.get('model') or {}
        for key, want in (('n_layers', cfg.n_layers),
                          ('n_kv_heads', cfg.n_kv_heads),
                          ('head_dim', cfg.head_dim)):
            if int(model.get(key, -1)) != want:
                raise ValueError(
                    f'handoff model mismatch: {key}='
                    f'{model.get(key)} != engine {want}')
        if entry.get('kv_cache_dtype') != self.kv_cache_dtype:
            raise ValueError(
                'handoff kv_cache_dtype '
                f'{entry.get("kv_cache_dtype")!r} != engine '
                f'{self.kv_cache_dtype!r} (no wire transcoding: '
                'quantized KV must land in a same-dtype pool)')
        # int4 rows travel packed: two codes a byte along head_dim.
        row_d = (cfg.head_dim // 2 if self.kv_cache_dtype == 'int4'
                 else cfg.head_dim)
        for arr, name in ((entry['k'], 'k'), (entry['v'], 'v')):
            shape = tuple(np.shape(arr))
            want_shape = (cfg.n_layers, n_rows, cfg.n_kv_heads, row_d)
            if shape != want_shape:
                raise ValueError(f'handoff {name} rows shape {shape} '
                                 f'!= {want_shape}')
        if self.kv_cache_dtype in ('int8', 'int4'):
            for arr, name in ((entry['k_scale'], 'k_scale'),
                              (entry['v_scale'], 'v_scale')):
                shape = tuple(np.shape(arr))
                if shape != (cfg.n_layers, n_rows, cfg.n_kv_heads):
                    raise ValueError(
                        f'handoff {name} shape {shape} != '
                        f'{(cfg.n_layers, n_rows, cfg.n_kv_heads)}')
            want_np = 'uint8' if self.kv_cache_dtype == 'int4' else 'int8'
            for arr, name in ((entry['k'], 'k'), (entry['v'], 'v')):
                got = _dtype_name(arr)
                if got != want_np:
                    raise ValueError(
                        f'handoff {name} codes are {got}, expected '
                        f'{want_np} (quantized KV never widens on the '
                        'wire)')

    def _validate_ingest(self, snap: Dict[str, Any]) -> None:
        """An ingest's request and payload against this engine: row
        count, remaining budget, the engine's request limits and
        :meth:`_validate_kv_entry`. Raises ``ValueError``."""
        prompt, output = snap['prompt'], snap['output']
        if not output:
            raise ValueError('handoff carries no generated token')
        n_rows = int(snap['n_rows'])
        if n_rows != len(prompt) + len(output) - 1:
            raise ValueError(
                f'handoff n_rows {n_rows} != context rows '
                f'{len(prompt) + len(output) - 1}')
        if len(output) >= int(snap['max_new_tokens']):
            raise ValueError('handoff request is already complete')
        self._validate_request(prompt, int(snap['max_new_tokens']))
        self._validate_kv_entry(snap, n_rows)

    def _ingest_request(self, snap: Dict[str, Any]) -> Request:
        """The Request a snapshot describes, its output prepopulated so
        the finish checks behave as if the tokens had been made here.
        Its first token was made elsewhere: ``first_token_time`` is the
        submit time, and a server observes no TTFT for it."""
        req = Request(
            request_id=self._next_id, prompt=list(snap['prompt']),
            max_new_tokens=int(snap['max_new_tokens']),
            temperature=float(snap.get('temperature') or 0.0),
            top_k=int(snap.get('top_k') or 0),
            top_p=float(snap.get('top_p') or 1.0),
            eos_id=snap.get('eos_id'),
            stop=([list(s) for s in snap['stop']]
                  if snap.get('stop') else None),
            priority=int(snap.get('priority') or 0),
            output=list(snap['output']),
            submit_time=clock.now())
        req.first_token_time = req.submit_time
        req._enq_out = len(req.output)
        if self.telemetry_enabled:
            # The continuation joins the trace the prefill worker
            # started (the server parks the hop's X-Skytpu-Trace
            # context in ``snap['trace']``).
            ctx = snap.get('trace') or {}
            req.trace = tracing.RequestTrace(
                self._next_id, trace_id=ctx.get('trace_id'),
                parent_span=ctx.get('parent_span'))
            req.trace.begin('decode', handoff=True,
                            context_tokens=len(req.prompt)
                            + len(req.output))
        self._next_id += 1
        return req

    def ingest_kv_snapshot(self, snap: Dict[str, Any]) -> int:
        """Land a handoff: validate it, seat the request in a free slot
        with its rows written at the exact original bytes, and return
        the new request id; decode resumes on the next call. Raises
        ``ValueError`` for a malformed or mismatched snapshot
        (permanent) and :class:`HandoffCapacityError` when no slot or
        pool capacity is free (retryable). The current token is written
        into ``_tok_dev`` in place: the decode graphs read that
        buffer."""
        self._validate_ingest(snap)
        slot = next((s for s in range(self.max_batch)
                     if self._slots[s] is None), None)
        if slot is None:
            raise HandoffCapacityError('no free decode slot')
        req = self._ingest_request(snap)
        self._land_kv_rows(slot, req, snap)
        self._slots[slot] = req
        self._slot_len[slot] = int(snap['n_rows'])
        # A fill (a kernel with a scalar argument): assigning a Python
        # int through indexing copies it from the host and syncs.
        self._tok_dev[slot:slot + 1].fill_(int(req.output[-1]))
        self._meta_dirty = True
        return req.request_id

    def _land_kv_rows(self, slot: int, req: Request,
                      snap: Dict[str, Any]) -> None:
        """Engine-specific: write the snapshot's rows into this slot's
        storage (raises ``HandoffCapacityError`` under pool pressure)."""
        raise NotImplementedError

    # -------------------------------------------------------- internals
    def _free_slot(self, slot: int) -> None:
        self._slots[slot] = None
        self._slot_len[slot] = 0
        self._meta_dirty = True

    def _maybe_finish(self, slot: int, token: int) -> bool:
        return self._finish_req(slot, self._slots[slot], token)

    def _finish_req(self, slot: int, req: Request, token: int) -> bool:
        """Request-scoped finish check; frees the slot only when ``req``
        still owns it (early-recycled tenancies finish without touching
        the slot's new tenant)."""
        done = False
        if req.stop:
            for seq in req.stop:
                if (len(req.output) >= len(seq)
                        and req.output[-len(seq):] == seq):
                    del req.output[-len(seq):]
                    req.stop_hit = True
                    done = True
                    break
        done = (done or len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None and token == req.eos_id)
                or len(req.prompt) + len(req.output) >= self.max_seq)
        if done:
            req.finish_time = clock.now()
            self._finished[req.request_id] = req
            self._release_adapter(req)
            self._trace_finish(req, stop_hit=req.stop_hit)
            if self._slots[slot] is req:
                self._free_slot(slot)
        return done

    def _release_adapter(self, req: Request) -> None:
        """Drop this request's adapter-bank pin, exactly once per
        request (finish, cancel and NaN eviction all call it; the flag
        makes overlapping exit paths safe)."""
        if req.adapter is None or req._adapter_released:
            return
        req._adapter_released = True
        if self.adapters is not None:
            self.adapters.release(req.adapter)


_mirror_methods(_EngineBase)


def _dtype_name(arr) -> str:
    """The element type of a numpy array or a torch tensor, by numpy's
    name for it ('int8', 'uint8', 'bfloat16', ...)."""
    if torch.is_tensor(arr):
        return str(arr.dtype).replace('torch.', '')
    return np.dtype(getattr(arr, 'dtype', None)).name


def rows_to_host(parts: List[torch.Tensor]) -> List[Any]:
    """Device tensors read back with ONE sanctioned ``host_sync``: their
    bytes packed into one buffer on the device, split again on the host.
    int8, uint8 and fp32 tensors come back as numpy arrays, bf16 as
    torch CPU tensors (numpy has no bfloat16)."""
    flat = torch.cat([p.contiguous().view(-1).view(torch.uint8)
                      for p in parts])
    raw = host_sync(flat)
    out, off = [], 0
    for p in parts:
        n = p.numel() * p.element_size()
        chunk = raw[off:off + n]
        off += n
        if p.dtype == torch.bfloat16:
            out.append(torch.from_numpy(chunk.view(np.int16).copy()).view(
                torch.bfloat16).reshape(p.shape))
        else:
            dt = {torch.int8: np.int8, torch.uint8: np.uint8,
                  torch.float32: np.float32}[p.dtype]
            out.append(chunk.view(dt).reshape(tuple(p.shape)))
    return out


def rows_to_device(arr, device: torch.device) -> torch.Tensor:
    """A snapshot's rows (numpy codes or scales, a numpy array of
    bfloat16, or a torch CPU tensor) as a new tensor on ``device``,
    without blocking the host."""
    if not torch.is_tensor(arr):
        a = np.asarray(arr)
        if a.dtype.name == 'bfloat16':
            arr = torch.from_numpy(np.ascontiguousarray(a).view(
                np.int16).copy()).view(torch.bfloat16)
        else:
            arr = torch.from_numpy(np.array(a))
    t = arr.contiguous()
    if device.type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


def _commit_window(cache: llama.KVCache, rows, len0: torch.Tensor,
                   n_commit: torch.Tensor) -> None:
    """Write the first ``n_commit`` of each batch row's ``w`` new rows
    (``rows``: [L, b, w, hkv, d] k, v, and scales when quantized) at
    cache positions ``len0 .. len0 + n_commit - 1``, in place, with
    fixed shapes: a read-modify-write of the ``w``-row window from
    ``min(len0, S - w)``, where every position outside the committed
    range gets its old row back. The window's positions are distinct
    and inside the cache, so no two writes aim at one row; the result
    is the reference's scatter with the rows past ``n_commit`` dropped
    at the ``max_seq`` sentinel."""
    w = rows[0].shape[2]
    S = cache.k.shape[2]
    dev = cache.k.device
    len0 = len0.long()
    start = torch.clamp(len0, 0, S - w)
    pos = start[:, None] + torch.arange(w, device=dev)[None, :]   # [b, w]
    j = pos - len0[:, None]                  # which new row lands at pos
    take = (j >= 0) & (j < n_commit.long()[:, None])
    src = torch.clamp(j, 0, w - 1)
    bidx = torch.arange(pos.shape[0], device=dev)[:, None]
    for dst, r in zip(cache.tensors(), rows):
        old = dst[:, bidx, pos]                              # [L, b, w, ..]
        new = r[:, bidx, src].to(dst.dtype)
        dst[:, bidx, pos] = torch.where(take[None, :, :, None, None], new,
                                        old)


def _slot_spec_verify(params, cache: llama.KVCache, tokens: torch.Tensor,
                      proposals: torch.Tensor, n_prop: torch.Tensor,
                      temps, topks, topps, active: torch.Tensor,
                      generator: Optional[torch.Generator], *,
                      cfg: ModelConfig, attn_impl: str, kv_bucket: int,
                      sample: bool,
                      mlora_idx: Optional[torch.Tensor] = None,
                      vocab_mask: Optional[torch.Tensor] = None,
                      dp_rows: Optional[slice] = None):
    """One speculative verify round over the slot cache, in place: one
    forward over the ``k+1`` positions ``[t0, d1..dk]`` per slot as a
    chunk against each slot's first ``kv_bucket`` cache rows
    (``llama.prefill_rows(cache_kv=..., all_logits=True)``: K3 on CUDA
    for a bf16/fp32 cache, ``cached_attention`` for int8/int4),
    device-side acceptance (``speculative.verify_tokens``), the masked
    commit of the accepted rows (:func:`_commit_window`) and the cache
    lengths advanced by ``n_commit``. ``tokens`` becomes each slot's
    last committed token (unchanged for inactive slots). ``mlora_idx``
    applies each slot's adapter; ``vocab_mask`` constrains the k+1
    positions' logits before acceptance, so a proposal outside the
    grammar is rejected like any other mismatch. No host sync: a CUDA
    graph captured of it replays any round. Returns ``(commit [b, k+1],
    n_commit [b])`` int32.

    ``dp_rows`` (a serving mesh's dp rank's block of slots): the forward
    and the acceptance run on those rows only (``mesh.dp_split``), and
    the new KV rows and the commits are all-gathered over dp before the
    commit, so every dp replica of the cache writes every row, as the
    decode merge does."""
    len0 = cache.length
    b = tokens.shape[0]
    rs = slice(None) if dp_rows is None else dp_rows
    cache_kv = tuple(t[:, rs, :kv_bucket] for t in cache.tensors())
    # A sentinel token (-1) of an inactive slot wraps to the last
    # embedding row, as the reference's gather does.
    seq = torch.remainder(torch.cat([tokens[rs, None], proposals[rs]], 1),
                          cfg.vocab_size)

    def mine(t):
        return None if t is None else t[rs]

    with mesh_lib.dp_split(dp_rows):
        logits, rows = llama.prefill_rows(
            params, seq, None, cfg, attn_impl=attn_impl,
            cache_kv=cache_kv, cache_len=len0[rs], all_logits=True,
            mlora_idx=mine(mlora_idx))
    logits = llama.apply_vocab_mask(logits, mine(vocab_mask))
    commit, n_commit = speculative.verify_tokens(
        logits, proposals[rs], n_prop[rs], generator, mine(temps),
        mine(topks), mine(topps), sample=sample, rows=dp_rows, n_rows=b)
    if dp_rows is not None:
        rows = tuple(mesh_lib.all_gather(t, 'dp', 1) for t in rows)
        both = mesh_lib.all_gather(
            torch.cat([commit, n_commit[:, None]], 1), 'dp', 0)
        commit, n_commit = both[:, :-1], both[:, -1]
    rows = llama._quantize_rows(*rows, cache.quant_mode)
    n_commit = n_commit.masked_fill(~active, 0)
    _commit_window(cache, rows, len0, n_commit)
    cache.length.copy_(len0 + n_commit)
    nxt = torch.gather(commit, 1,
                       torch.clamp(n_commit.long() - 1, min=0)[:, None])[:, 0]
    tokens.copy_(torch.where(active, nxt, tokens))
    return commit, n_commit


class InferenceEngine(speculative.SpeculativeMixin, _EngineBase):
    """Slot-cache engine: every slot owns a fixed ``max_seq`` row range
    of one ``[L, max_batch, max_seq, hkv, d]`` cache (``llama.KVCache``),
    so admission never waits on a pool and there is no prefix cache.

    - Chunked prefill (default, ``prefill_chunk_tokens=256``): free
      slots are assigned at once and their prompts prefill in chunks
      interleaved with decode horizons. A chunk batch whose rows have no
      cache yet runs plain causal attention (the K4 CUDA kernel); later
      chunks attend their slots' cache rows (the K3 CUDA kernel on a
      bf16/fp32 cache, the scale-folding ``cached_attention`` on int8).
    - ``prefill_chunk_tokens=0``: whole-prompt admission waves (K4).
    - ``prefill_w8a8``: both prefill kinds run their layer matmuls on
      int8 activations (``quantization.w8a8_region``).
    - Decode runs fused horizons over the cache with a ring of this
      call's rows: ``llama.decode_step`` once a step (a CUDA graph
      replay on the card, keyed (horizon, sample, kv_bucket)), the ring
      merged once per call.
    - ``speculate_k > 0`` replaces decode with speculative rounds
      (``_slot_spec_verify``: the k+1 positions as a chunk against the
      cache, K3 on CUDA for a bf16/fp32 cache).

    ``prefill_calls`` counts prefill device calls by kind: ``uncached``
    (whole prompts and first chunks, ``kv_bucket == 0``) and ``cached``
    (chunks at a nonzero cache offset); each runs one attention per
    layer."""

    _PREFILL_N_BUCKETS = (1, 2, 4, 8, 16, 32)
    # Under saturation, monolithic admissions batch into waves of at
    # least this many slots (a prefill call's fixed cost dominates at
    # small n).
    _ADMIT_WAVE_MIN = 4
    _HORIZON_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
    # Per-call prefill transient budget (stacked rows plus gathered
    # cache rows) that caps the prefill batch width.
    _PREFILL_SCRATCH_BYTES = int(0.75e9)

    @mesh_lib.mirrored_init
    def __init__(self, cfg: ModelConfig, params: Optional[Any] = None, *,
                 max_batch: int = 8, max_seq: int = 1024,
                 mesh: Optional[Any] = None, rng_seed: int = 0,
                 param_seed: int = 0,
                 attn_impl: str = 'auto',
                 quantize: Optional[str] = None,
                 kv_cache_dtype: Optional[str] = None,
                 prefill_w8a8: bool = False,
                 prefill_chunk_tokens: Optional[int] = 256,
                 decode_priority_ratio: Optional[float] = None,
                 decode_steps_per_call: Optional[int] = None,
                 speculate_k: int = 0,
                 adapter_slots: int = 0,
                 adapter_dir: Optional[str] = None,
                 adapter_rank: int = 8,
                 telemetry: bool = True,
                 device: DeviceLike = 'cuda'):
        self._init_telemetry(telemetry)
        self.cfg = serving_config(cfg)
        self.device = self._init_mesh(mesh, self.cfg, device,
                                      max_batch=max_batch)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.attn_impl = attn_impl
        chunk = prefill_chunk_tokens or 0
        self.chunk = _bucket_len(chunk, minimum=8) if chunk else 0
        self.chunked = self.chunk > 0
        self.decode_priority_ratio = decode_priority_ratio
        self.decode_steps_per_call = self._validate_decode_steps(
            decode_steps_per_call)
        self._init_spec(speculate_k)
        if self.speculate_k + 1 > max_seq:
            raise ValueError(f'speculate_k={self.speculate_k} needs '
                             f'max_seq > k + 1, got {max_seq}')
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)
        # Int8 activations in the prefill calls' layer matmuls
        # (``quantization.w8a8_region``); decode and the speculative
        # verify stay W8A16, as in the reference.
        self.prefill_w8a8 = bool(prefill_w8a8)
        self.params, quantize = prepare_params(
            cfg, params, quantize=quantize, device=self.device,
            prefill_w8a8=self.prefill_w8a8, mesh=mesh,
            param_seed=param_seed)
        cfg = self.cfg
        self._param_bytes = quantization.per_device_bytes(self.params)
        self.kv_cache_dtype = resolve_kv_cache_dtype(kv_cache_dtype,
                                                     quantize)
        # This rank's kv heads under a mesh (the batch stays whole: dp
        # splits the decode rows, and every dp replica keeps them all).
        self.cache = llama.KVCache.create(self.shard_cfg, max_batch, max_seq,
                                          kv_dtype=self.kv_cache_dtype,
                                          device=self.device)
        self._init_slots(max_batch)
        self._init_adapters(adapter_slots, adapter_rank, adapter_dir)
        # slot -> prompt tokens prefilled so far; a slot in this dict is
        # assigned but not yet decodable.
        self._prefill_off: Dict[int, int] = {}
        self._prefill_n_max = self._PREFILL_N_BUCKETS[-1]
        self.decode_substeps = 0
        self.prefill_calls = {'uncached': 0, 'cached': 0}
        self._init_decode(self._ring_capacity(_ring_horizon_cap(
            cfg, max_batch, self._param_bytes, mesh)))

    @classmethod
    def from_pretrained(cls, path: str, *, dtype: Optional[torch.dtype] = None,
                        **kwargs) -> 'InferenceEngine':
        """An engine over an HF checkpoint directory (``config.json`` +
        safetensors; ``models/weights.py``), in ``dtype`` (default
        bf16). ``quantize='int8'`` quantizes on the host during the load
        (cached next to the checkpoint); the other keyword arguments,
        ``device=`` included, go to the constructor."""
        return _from_pretrained(cls, path, dtype, kwargs)

    def kv_pool_stats(self) -> Dict[str, Any]:
        """KV capacity/pressure in TOKENS, the paged engine's schema: the
        capacity is the static ``max_batch x max_seq`` reservation and
        nothing is ever preempted."""
        cap = self.max_batch * self.max_seq
        used = int(self._slot_len.sum())
        return {
            'kv_cache_dtype': self.kv_cache_dtype,
            'pool_token_capacity': cap,
            'tokens_used': used,
            'tokens_free': cap - used,
            'preemptions': int(self.preemptions),
            'kv_token_bytes': kv_token_bytes(self.cfg, self.kv_cache_dtype),
            'kv_token_bytes_per_shard': kv_token_bytes(
                self.cfg, self.kv_cache_dtype, self.mesh),
            'kv_shards': kv_shard_degree(self.cfg, self.mesh),
            'cache_bytes': sum(t.numel() * t.element_size()
                               for t in self.cache.tensors()),
        }

    # ------------------------------------------------------- KV handoff
    def _gather_kv_rows(self, slot: int, n_rows: int):
        """Rows ``[0, n_rows)`` of one slot straight off the cache, in
        the stored dtype (int4 rows packed, ``head_dim / 2`` bytes),
        with ONE sanctioned readback; the scales drop their trailing
        dimension of 1 (the wire's ``[L, n, hkv]``)."""
        c = self.cache
        parts = [c.k[:, slot, :n_rows], c.v[:, slot, :n_rows]]
        if c.quantized:
            parts += [c.k_scale[:, slot, :n_rows, :, 0],
                      c.v_scale[:, slot, :n_rows, :, 0]]
        # Under tp, every rank's kv heads gathered into the whole rows.
        parts = [mesh_lib.gather_split(p, 'kv_heads', 2) for p in parts]
        host = rows_to_host(parts)
        if c.quantized:
            return tuple(host)
        return host[0], host[1], None, None

    def _land_kv_rows(self, slot: int, req: Request,
                      snap: Dict[str, Any]) -> None:
        """The snapshot's rows into positions ``[0, n_rows)`` of the
        slot's reservation and its length set to ``n_rows``, in place
        (the decode graphs read these tensors)."""
        del req
        c = self.cache
        n_rows = int(snap['n_rows'])
        srcs = [snap['k'], snap['v']]
        if c.quantized:
            srcs += [snap['k_scale'], snap['v_scale']]
        heads = mesh_lib.tp_slice(self.cfg.n_kv_heads, 'kv_heads')
        for dst, src in zip(c.tensors(), srcs):
            rows = rows_to_device(src, self.device)[:, :, heads]
            dst[:, slot, :n_rows] = rows.reshape(
                dst[:, slot, :n_rows].shape).to(dst.dtype)
        c.length[slot:slot + 1].fill_(n_rows)

    # ------------------------------------------------------------ calls
    def _decode_call(self, horizon: int, sample: bool,
                     kv_bucket: int) -> torch.Tensor:
        """One fused decode call (graphs keyed (horizon, sample,
        kv_bucket) and (horizon,)): ``llama.decode_step`` ``horizon``
        times, then the ring merge, in which inactive slots do not
        advance their cache length. Returns tokens [max_batch,
        horizon]."""
        buf = self._buf
        inputs = {k: self._rows(v) for k, v in self._step_inputs().items()}
        c, r = self.cache, self._rows
        # This dp rank's rows of the cache (all of it without dp).
        cache = c if self._dp_rows is None else llama.KVCache(
            r(c.k, 1), r(c.v, 1), r(c.length), r(c.k_scale, 1),
            r(c.v_scale, 1))

        def step(ring_k, ring_v, out, sample_fn):
            with mesh_lib.dp_split(self._dp_rows):
                llama.decode_step(self.params, cache, r(self._tok_dev),
                                  buf.step, r(ring_k, 1), r(ring_v, 1),
                                  r(out), self.cfg, sample_fn=sample_fn,
                                  kv_bucket=kv_bucket, **inputs)

        def merge(ring_k, ring_v):
            self._dp_gather(ring_k, ring_v, buf.out(horizon))
            len0 = self.cache.length
            llama.merge_rows_into_cache(self.cache, ring_k, ring_v, len0,
                                        len0 + horizon * buf.active)

        return self._run_decode(horizon, sample, (kv_bucket,), (), step,
                                merge)

    def _prefill_call(self, tokens: np.ndarray, true_lens: np.ndarray,
                      slots: np.ndarray, reqs) -> torch.Tensor:
        """Whole prompts [n, bucket] prefilled and written into their
        slots' first ``bucket`` rows (duplicate padding rows write
        identical values); returns the greedy first token per row,
        under each row's grammar mask. ``reqs``: each row's request
        (its adapter and mask)."""
        bucket = tokens.shape[1]
        tokens_d, lens_d, slots_d = device_upload(
            (tokens, true_lens, slots.astype(np.int64)), self.device)
        adp_d, vm_d = self._upload_row_adapters(reqs)
        last, rows = llama.prefill_rows(
            self.params, tokens_d, lens_d, self.cfg,
            attn_impl=self.attn_impl, quantize_rows=self.cache.quant_mode,
            w8a8=self.prefill_w8a8, mlora_idx=adp_d,
            dp_rows=self._prefill_split(tokens.shape[0]))
        last = llama.apply_vocab_mask(last, vm_d)
        self.prefill_calls['uncached'] += 1
        first = llama.mask_nonfinite_tokens(
            last, torch.argmax(last, -1).to(torch.int32))
        self.cache.length[slots_d] = lens_d
        for dst, r in zip(self.cache.tensors(), rows):
            dst[:, slots_d, :bucket] = r.to(dst.dtype)
        return first

    def _chunk_prefill_call(self, tokens, starts, valid, want, slots, temps,
                            topks, topps, *, kv_bucket: int,
                            sample: bool, reqs) -> torch.Tensor:
        """One prefill chunk [n, chunk_w] per batch row at its slot's
        cursor: attends the slot's first ``kv_bucket`` cache rows (0 = no
        cache read: plain causal attention), writes the new rows back
        and samples each completing row's next token. Rows past
        ``valid`` and padding rows (slot ``max_batch``) are not written:
        the reference's ``mode='drop'`` scatter, done here by selecting
        the kept (row, position) pairs on the host."""
        n, chunk_w = tokens.shape
        gather = np.minimum(slots, self.max_batch - 1).astype(np.int64)
        keep = ((np.arange(chunk_w)[None, :] < valid[:, None])
                & (slots[:, None] < self.max_batch))
        pos = starts[:, None].astype(np.int64) + np.arange(chunk_w)[None, :]
        keep &= pos < self.max_seq
        ri, ci = np.nonzero(keep)
        real = slots < self.max_batch
        (tokens_d, starts_d, want_d, temps_d, topks_d, topps_d, gather_d,
         ri_d, ci_d, bi_d, pi_d, lslots_d, lvals_d) = device_upload(
            (tokens, starts, want, temps, topks, topps, gather, ri, ci,
             slots[ri].astype(np.int64), pos[ri, ci],
             slots[real].astype(np.int64), (starts + valid)[real]),
            self.device)
        cache_kv = None
        if kv_bucket:
            cache_kv = tuple(t[:, gather_d, :kv_bucket]
                             for t in self.cache.tensors())
        adp_d, vm_d = self._upload_row_adapters(
            list(reqs) + [None] * (n - len(reqs)))
        last_idx = torch.clamp(want_d, 0, chunk_w - 1)
        last, rows = llama.prefill_rows(
            self.params, tokens_d, last_idx + 1, self.cfg,
            attn_impl=self.attn_impl, quantize_rows=self.cache.quant_mode,
            cache_kv=cache_kv, cache_len=starts_d if kv_bucket else None,
            w8a8=self.prefill_w8a8, mlora_idx=adp_d,
            dp_rows=self._prefill_split(n))
        # Completing rows' first token honours the grammar.
        last = llama.apply_vocab_mask(last, vm_d)
        self.prefill_calls['cached' if kv_bucket else 'uncached'] += 1
        if sample:
            first = sample_tokens(last, self._gen, temps_d, topks_d, topps_d)
        else:
            first = torch.argmax(last, -1).to(torch.int32)
        first = llama.mask_nonfinite_tokens(last, first)
        self.cache.length[lslots_d] = lvals_d
        for dst, r in zip(self.cache.tensors(), rows):
            dst[:, bi_d, pi_d] = r[:, ri_d, ci_d].to(dst.dtype)
        return first

    # -------------------------------------------------------- admission
    def _admit(self) -> List[Tuple[int, int, bool]]:
        """Chunked (default): assign free slots and run ONE prefill
        chunk batch (more while under a quarter of the batch decodes);
        monolithic: one whole-prompt admission wave. Always returns []:
        first tokens surface through ``_process_one``."""
        if not self.chunked:
            return self._admit_monolithic()
        self._assign_slots()
        events = self._prefill_chunk_batch()
        while (self._prefill_off
               and self.num_active - len(self._prefill_off)
               < self.max_batch // 4):
            events += self._prefill_chunk_batch()
        return events

    def _assign_slots(self) -> None:
        """Reserve free slots for queued requests with a zero prefill
        cursor; their chunks stream in via _prefill_chunk_batch."""
        for slot in range(self.max_batch):
            if self._slots[slot] is not None:
                continue
            req = self._queue_pop()
            if req is None:
                return
            self._slots[slot] = req
            self._slot_len[slot] = 0
            self._prefill_off[slot] = 0
            self._trace_sched(req)

    def _slot_remaining_prefill(self, slot: int) -> int:
        off = self._prefill_off.get(slot)
        if off is None:
            return 0
        return max(0, len(self._slots[slot].prompt) - off)

    def _free_slot(self, slot: int) -> None:
        self._prefill_off.pop(slot, None)      # cancel mid-prefill
        super()._free_slot(slot)

    def _prefill_fit(self, width: int) -> int:
        """Largest n bucket whose prefill transient (``width`` rows per
        batch row) fits the scratch budget."""
        fit = self._PREFILL_SCRATCH_BYTES // max(
            1, width * kv_token_bytes(self.cfg, self.kv_cache_dtype))
        return max([1] + [b for b in self._PREFILL_N_BUCKETS if b <= fit])

    def _prefill_chunk_batch(self) -> List[Tuple[int, int, bool]]:
        """One prefill chunk across up to an n bucket of mid-prefill
        slots, attending the slots' existing cache rows and writing the
        new rows at each slot's cursor. Completing rows' first tokens
        are merged into the device token vector before this returns, so
        they decode on the next horizon. Always returns []."""
        pending = sorted(self._prefill_off)
        if not pending:
            return []

        def shapes(batch):
            # The full chunk, or a smaller bucket when every pending
            # piece is short; kv_bucket 0 when no row has context yet
            # (plain causal attention, the monolithic first-chunk math).
            rest_max = max(len(self._slots[s].prompt) - self._prefill_off[s]
                           for s in batch)
            chunk_w = min(self.chunk, _bucket_len(
                rest_max, minimum=min(64, self.chunk)))
            start_max = int(max(self._slot_len[s] for s in batch))
            kv_bucket = (0 if start_max == 0
                         else min(_bucket_len(start_max), self.max_seq))
            return chunk_w, kv_bucket

        batch = pending[:self._prefill_n_max]
        chunk_w, kv_bucket = shapes(batch)
        cap = self._prefill_fit(chunk_w + kv_bucket)
        if len(batch) > cap:
            batch = batch[:cap]
            chunk_w, kv_bucket = shapes(batch)
        n = next(b for b in self._PREFILL_N_BUCKETS if b >= len(batch))

        tokens = np.zeros((n, chunk_w), np.int32)
        starts = np.zeros(n, np.int32)
        valid = np.zeros(n, np.int32)
        want = np.full(n, -1, np.int32)
        # Padding rows carry the out-of-range slot max_batch: their
        # writes (rows, lengths, token merge) are all dropped.
        slots_arr = np.full(n, self.max_batch, np.int32)
        temps = np.zeros(n, np.float32)
        topks = np.zeros(n, np.int32)
        topps = np.ones(n, np.float32)
        for i, slot in enumerate(batch):
            req = self._slots[slot]
            off = self._prefill_off[slot]
            piece = req.prompt[off:off + chunk_w]
            tokens[i, :len(piece)] = piece
            starts[i] = self._slot_len[slot]
            valid[i] = len(piece)
            if off + len(piece) == len(req.prompt):
                want[i] = len(piece) - 1
            slots_arr[i] = slot
            temps[i] = req.temperature
            topks[i] = req.top_k or 0
            topps[i] = req.top_p
        # Sampling only when a COMPLETING row needs it.
        sample = any(self._slots[s].temperature > 0
                     for i, s in enumerate(batch) if want[i] >= 0)
        chunk_t0 = clock.monotonic()
        with self._prof.phase('prefill_chunk'), \
                self._prof.jit_key('chunk_prefill',
                                   (n, chunk_w, kv_bucket, sample)):
            first = self._chunk_prefill_call(
                tokens, starts, valid, want, slots_arr, temps, topks, topps,
                kv_bucket=kv_bucket, sample=sample,
                reqs=[self._slots[s] for s in batch])
        chunk_t1 = clock.monotonic()
        for i, slot in enumerate(batch):
            r = self._slots[slot]
            if r.trace is not None:
                r.trace.add('prefill_chunk', chunk_t0, chunk_t1,
                            offset=self._prefill_off[slot],
                            tokens=int(valid[i]))
        done_rows: List[Tuple[int, int]] = []    # (row i, slot)
        for i, slot in enumerate(batch):
            self._slot_len[slot] += int(valid[i])
            self._prefill_off[slot] += int(valid[i])
            if want[i] < 0:
                continue                         # more chunks to go
            del self._prefill_off[slot]
            done_rows.append((i, slot))
        if done_rows:
            rows_d, slots_d = device_upload(
                (np.array([i for i, _ in done_rows], np.int64),
                 np.array([s for _, s in done_rows], np.int64)), self.device)
            self._tok_dev[slots_d] = first[rows_d]
            self._meta_dirty = True              # slots become decodable
            self._pending.append({'kind': 'prefill', 'toks': first,
                                  'batch': [(slot, self._slots[slot], i)
                                            for i, slot in done_rows]})
        return []

    def _admit_monolithic(self) -> List[Tuple[int, int, bool]]:
        """Whole-prompt admission waves (``prefill_chunk_tokens=0``)."""
        free = [s for s in range(self.max_batch) if self._slots[s] is None]
        wave_min = min(self._ADMIT_WAVE_MIN, self.max_batch)
        if (0 < len(free) < wave_min and len(free) < self.max_batch
                and len(self._queue) > len(free) + wave_min):
            # Saturated with slots still decoding: hold admission until
            # a fuller wave accumulates.
            return []
        batch: List[Tuple[int, Request]] = []
        for slot in free:
            req = self._queue_pop()
            if req is None:
                break
            batch.append((slot, req))
        if not batch:
            return []

        def bucket_of(reqs):
            return min(_bucket_len(max(len(r.prompt) for _, r in reqs)),
                       self.max_seq)
        bucket = bucket_of(batch)
        cap = self._prefill_fit(bucket)
        if len(batch) > cap:                     # overflow keeps FIFO
            self._requeue_front([req for _, req in batch[cap:]])
            batch = batch[:cap]
            bucket = bucket_of(batch)
        n = next((b for b in self._PREFILL_N_BUCKETS if b >= len(batch)),
                 self._PREFILL_N_BUCKETS[-1])
        tokens = np.zeros((n, bucket), np.int32)
        true_lens = np.zeros(n, np.int32)
        slots = np.zeros(n, np.int32)
        # Padding rows re-prefill the LAST request into its own slot
        # (harmless duplicate writes of identical rows, its adapter
        # included).
        row_reqs = []
        for i in range(n):
            slot, req = batch[min(i, len(batch) - 1)]
            tokens[i, :len(req.prompt)] = req.prompt
            true_lens[i] = len(req.prompt)
            slots[i] = slot
            row_reqs.append(req)
        with self._prof.phase('prefill_chunk'), \
                self._prof.jit_key('prefill', (bucket, n)):
            next_tokens = self._prefill_call(tokens, true_lens, slots,
                                             row_reqs)
        (slots_used,) = device_upload(
            (np.array([s for s, _ in batch], np.int64),), self.device)
        self._tok_dev[slots_used] = next_tokens[:len(batch)]
        for slot, req in batch:
            self._slots[slot] = req
            self._slot_len[slot] = len(req.prompt)
            self._trace_sched(req)
        self._meta_dirty = True
        self._pending.append({'kind': 'prefill', 'toks': next_tokens,
                              'batch': [(slot, req, i) for i, (slot, req)
                                        in enumerate(batch)]})
        return []

    # ------------------------------------------------------------ step
    def step(self, horizon: int = 1) -> List[Tuple[int, int, bool]]:
        """Chunked scheduling loop: admit (one chunk batch max), then
        enqueue decode through the async pipeline. While prompts are
        mid-prefill the horizon is capped by the decode-priority token
        budget; while the queue is non-empty at 32. Monolithic mode
        keeps the base loop."""
        if not self.chunked and not self.speculate_k:
            return super().step(horizon)
        events: List[Tuple[int, int, bool]] = []
        with self._prof.phase('readback'):
            while len(self._pending) >= self._PIPELINE_DEPTH:
                events.extend(self._process_one())
        with self._prof.phase('admit'):
            events.extend(self._admit())
        if self.speculate_k:
            # One synchronous propose -> verify -> commit round (either
            # admission mode), or decode_steps_per_call of them fused
            # into one dispatch.
            if (self.decode_steps_per_call or 0) > 1:
                events.extend(self._spec_step_fused())
            else:
                events.extend(self._spec_step())
            return events
        if self.decode_steps_per_call:
            # Multi-step pin: exactly k steps a call, over the
            # interleave and queue-pressure shrinks (the capacity caps
            # still apply in _enqueue_decode).
            horizon = self.decode_steps_per_call
        elif self._prefill_off:
            horizon = min(horizon, self._interleave_horizon())
        elif self._queue:
            horizon = min(horizon, 32)
        with self._prof.phase('decode_enqueue'):
            enqueued = self._enqueue_decode(horizon)
        if not enqueued and self._pending:
            with self._prof.phase('readback'):
                events.extend(self._process_one())
        return events

    # ------------------------------------------------------- speculative
    def _spec_kv_bucket(self, rows: int) -> int:
        """The cache rows a speculative call reads: every live context
        plus the ``rows`` it may commit, bucketed; the whole cache once
        the bucket passes half of it (the reference's policy)."""
        max_live = int(max(self._slot_len[s] for s in range(self.max_batch)
                           if self._slots[s] is not None))
        kv_bucket = min(self.max_seq, _bucket_len(max_live + rows))
        return self.max_seq if kv_bucket > self.max_seq // 2 else kv_bucket

    def _spec_verify_fn(self, kv_bucket: int):
        """``verify(proposals, n_prop, active) -> (commit, n_commit)``:
        ``_slot_spec_verify`` over the static buffers."""
        buf = self._buf
        sample = self._sample
        inputs = self._step_inputs()

        def verify(proposals, n_prop, active):
            return _slot_spec_verify(
                self.params, self.cache, self._tok_dev, proposals, n_prop,
                buf.temps, buf.topks, buf.topps, active, self._gen,
                cfg=self.cfg, attn_impl=self.attn_impl,
                kv_bucket=kv_bucket, sample=sample, dp_rows=self._dp_rows,
                **inputs)

        return verify

    def _spec_verify_call(self, ready, proposals, n_prop) -> torch.Tensor:
        self._stage_rows(ready)
        kv_bucket = self._spec_kv_bucket(self.speculate_k + 1)
        self._buf.upload(self._buf.set_spec(proposals, n_prop))
        return self._spec_run(kv_bucket, self._spec_verify_fn(kv_bucket))

    def _spec_fused_call(self, ready, rounds: int) -> torch.Tensor:
        """``rounds`` fused rounds; the kv bucket covers their worst-case
        growth ``rounds * (k + 1)``."""
        self._stage_rows(ready)
        kv_bucket = self._spec_kv_bucket(rounds * (self.speculate_k + 1))
        hist, rem = self._spec_hist_state(ready)
        self._buf.upload(self._buf.set_spec(hist=hist, rem=rem))
        return self._spec_run(kv_bucket, self._spec_verify_fn(kv_bucket),
                              rounds)

    def _enqueue_decode(self, horizon: int = 1) -> bool:
        """Enqueue one fused-horizon decode call fed by device-resident
        state (the token vector, the cache). Mid-prefill slots are
        masked inactive. Returns False when nothing could be
        enqueued."""
        ready = self._decode_ready()
        if not any(r is not None for r in ready):
            return False
        # Capacity cap (+1 for the token written during the step),
        # counting the steps in flight. The max runs over EVERY occupied
        # slot, mid-prefill ones included: the ring merge writes
        # (masked-off) rows at each slot's device length and the write
        # clamps, so a merge pushed past max_seq would slide back over a
        # slot's real prompt rows.
        max_live = int(max(self._slot_len[s] for s in range(self.max_batch)
                           if self._slots[s] is not None))
        cap = int(self.max_seq - 1 - max_live - self._inflight_steps)
        if cap < 1:
            return False
        horizon = max(1, min(horizon, cap))
        horizon = min(horizon, self._buf.h_max)
        if self.decode_steps_per_call is None:
            horizon = next(b for b in reversed(self._HORIZON_BUCKETS)
                           if b <= horizon)
        # else: the pin runs EXACTLY k (capacity-clamped), so the graph
        # key stays (k, sample, kv_bucket).
        if self._stage_rows(ready):
            self._buf.upload(self._buf.rows_words)
        # Attention reads only the rows every live context (in-flight
        # steps included) reaches through this horizon.
        kv_bucket = min(self.max_seq, _bucket_len(
            max_live + self._inflight_steps + horizon))
        # One dispatch covers ``horizon`` substeps (the profiler's
        # per-substep split); the key's first call captures its graphs.
        self._prof.note_substeps('decode_enqueue', horizon)
        t0 = clock.monotonic()
        with self._prof.jit_key('decode', (horizon, self._sample,
                                           kv_bucket)):
            toks = self._decode_call(horizon, self._sample, kv_bucket)
        live = int(sum(self._slot_len[s] + self._inflight_steps
                       for s in range(self.max_batch)
                       if ready[s] is not None))
        self._note_decode_step(live, horizon, clock.monotonic() - t0)
        self.decode_substeps += horizon
        self._inflight_steps += horizon
        self._pending.append({'kind': 'decode', 'toks': toks,
                              'horizon': horizon, 'snapshot': ready})
        return True

    def _process_one(self) -> List[Tuple[int, int, bool]]:
        """Read back the oldest in-flight call into events. A request
        that finished or was cancelled after the call was enqueued
        produced garbage rows on the device: skipped here; its rows sit
        past the corrected length and the slot's next prefill overwrites
        them."""
        entry = self._pending.popleft()
        toks = host_sync(entry['toks'])
        events: List[Tuple[int, int, bool]] = []
        now = clock.now()
        if entry['kind'] == 'prefill':
            for slot, req, row in entry['batch']:
                if req.finish_time is not None:  # cancelled in flight
                    continue
                token = int(toks[row])
                if token < 0:
                    events.append(self._evict_nonfinite(slot, req))
                    continue
                req.first_token_time = now
                self._trace_first_token(req)
                req.output.append(token)
                finished = self._finish_req(slot, req, token)
                events.append((req.request_id, token, finished))
            return events
        self._inflight_steps -= entry['horizon']
        for slot, req in enumerate(entry['snapshot']):
            if req is None or req.finish_time is not None:
                continue
            if req.first_token_time is None:
                continue        # prefill result still queued (FIFO: never)
            for i in range(entry['horizon']):
                token = int(toks[slot, i])
                if token < 0:
                    events.append(self._evict_nonfinite(slot, req))
                    break
                req.output.append(token)
                self._slot_len[slot] += 1
                finished = self._maybe_finish(slot, token)
                events.append((req.request_id, token, finished))
                if finished:
                    break
        return events
