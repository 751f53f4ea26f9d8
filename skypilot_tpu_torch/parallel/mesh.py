"""The (tp, dp) serving mesh over ``torch.distributed`` (port of the
serving part of ``skypilot_tpu/parallel/mesh.py``).

The JAX package drives every device of a mesh from one controller and
lets XLA insert the collectives. PyTorch's idiom is SPMD, one process
per device, and so is this module's:

- :func:`serving_mesh` / :func:`make_mesh` start one follower process
  per extra rank (``python -m skypilot_tpu_torch.parallel.follower``: a
  fresh interpreter that imports this package only, never the caller's
  main module) and return rank 0's :class:`ServingMesh`: a process
  group (``nccl`` on CUDA, ``gloo`` on the CPU) with a ``DeviceMesh`` of
  dims ``('dp', 'tp')`` (``tp`` innermost, as the reference's
  ``make_mesh`` orders its axes) and a gloo group that carries rank 0's
  control messages.
- Rank 0 owns every host decision (the server, the scheduler, the
  tokenizer). An engine built with ``mesh=`` sends its constructor's
  arguments to the followers, and each mirrored engine method
  (:func:`mirrored`) sends its name and arguments before it runs, so
  every rank runs the same engine calls in the same order with the same
  arguments and keeps the same host state (slots, page tables,
  generator seeds). No rank reads another's device tensors outside a
  collective. The followers' loop is ``parallel/follower.py``.
- Each rank holds only its shard of the weights (:func:`shard_params`,
  by the logical axes of ``models/llama.py`` and the reference's
  :data:`DEFAULT_RULES`, divisibility-aware as its ``spec_for``) and of
  the KV pool.
- Every collective of the port goes through :func:`all_reduce` and
  :func:`all_gather` here, inside a mirrored call's scope
  (:func:`active`). They count what they issue (:data:`collective_counts`,
  :data:`collective_shapes`: the audits' census; a CUDA graph's replays
  add what its capture recorded, ``inference/graphs.py``) and, under
  the cost model's recorder, price their bytes per mesh axis instead of
  communicating.

A follower that dies makes rank 0 raise: before every control message
rank 0 checks that each follower it started is alive, and a collective
with a dead peer fails within the process group's timeout.

Multi-host bootstrap (the reference's ``jax_coordinator_from_url``,
``initialize_gang_distributed`` and ``initialize_distributed_from_env``,
as ``init_process_group`` with a ``tcp://host:port`` rendezvous):

- :func:`coordinator_from_url` gives the rendezvous ``host:port`` from a
  gang's ``SKYTPU_COORDINATOR`` URL (rank 0's HTTP port + 1000, the
  reference's offset);
- :func:`initialize_gang_distributed` and
  :func:`initialize_distributed_from_env` (the training contract:
  ``SKYTPU_COORDINATOR_ADDRESS``, ``SKYTPU_NUM_NODES``,
  ``SKYTPU_NODE_RANK``) join the default process group, bounded by a
  timeout, a no-op for one process, idempotent, and raising on a
  failed connect;
- :func:`gang_mesh` builds a :class:`ServingMesh` from processes a
  launcher already started (one ``python -m
  skypilot_tpu_torch.serve.server --gang-rank N`` per rank, on one host
  or several), met over that TCP rendezvous instead of the
  ``FileStore`` of :func:`make_mesh`. Rank 0 keeps the control channel,
  the per-call agreement and the census as above; a nonzero rank runs
  ``parallel/follower.py``'s loop on it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import importlib
import math
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from skypilot_tpu_torch.utils.device import local_rank_device

MESH_AXES = ('slice', 'pp', 'dp', 'fsdp', 'sp', 'tp')

# Seconds a process group waits for a peer before a collective (or the
# start-up rendezvous) fails.
DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Product must equal the device count."""
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1
    num_slices: int = 1
    pp: int = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.num_slices, self.pp, self.dp, self.fsdp, self.sp,
                self.tp)

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    @classmethod
    def auto(cls, num_devices: int, *, num_slices: int = 1,
             tp: Optional[int] = None, sp: int = 1) -> 'MeshSpec':
        """Everything not TP/SP goes to FSDP (the reference's default)."""
        per_slice = num_devices // num_slices
        if num_devices % num_slices:
            raise ValueError(f'{num_devices} devices not divisible into '
                             f'{num_slices} slices')
        tp = tp or 1
        if per_slice % (tp * sp):
            raise ValueError(f'tp*sp={tp * sp} must divide per-slice device '
                             f'count {per_slice}')
        return cls(dp=1, fsdp=per_slice // (tp * sp), sp=sp, tp=tp,
                   num_slices=num_slices)

    @classmethod
    def for_serving(cls, tp: int = 1, dp: int = 1) -> 'MeshSpec':
        """The serving layout: params and KV heads sharded over ``tp``,
        the decode rows over ``dp``; no fsdp/sp/pp."""
        if tp < 1 or dp < 1:
            raise ValueError(f'tp/dp must be >= 1, got tp={tp} dp={dp}')
        return cls(dp=dp, tp=tp)


def _cuda_devices() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def spec_from_env(*, tp: Optional[int] = None, sp: int = 1,
                  num_devices: Optional[int] = None) -> MeshSpec:
    """MeshSpec honouring ``SKYTPU_NUM_SLICES``; ``num_devices`` defaults
    to the visible CUDA devices (at least 1)."""
    num_slices = int(os.environ.get('SKYTPU_NUM_SLICES', '1') or 1)
    if num_devices is None:
        num_devices = max(1, _cuda_devices())
    return MeshSpec.auto(num_devices, num_slices=num_slices, tp=tp, sp=sp)


def serving_spec_from_env(*, tp: Optional[int] = None,
                          dp: Optional[int] = None) -> MeshSpec:
    """Serving MeshSpec from ``SKYTPU_TP``/``SKYTPU_DP`` (the
    controller's placement exports them); explicit arguments (``--tp``/
    ``--dp``) win. Absent both, tp = dp = 1."""
    if tp is None:
        tp = int(os.environ.get('SKYTPU_TP', '1') or 1)
    if dp is None:
        dp = int(os.environ.get('SKYTPU_DP', '1') or 1)
    return MeshSpec.for_serving(tp=tp, dp=dp)


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a :class:`ServingMesh`, a :class:`MeshSpec`, a
    mapping of axis sizes, or None (all 1)."""
    if mesh is None:
        return {a: 1 for a in MESH_AXES}
    if isinstance(mesh, MeshSpec):
        return dict(zip(MESH_AXES, mesh.shape))
    shape = getattr(mesh, 'shape', mesh)
    return {a: int(shape.get(a, 1)) for a in MESH_AXES}


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} for every logical mesh axis (all 1s without a mesh):
    the payload behind ``skytpu_mesh_shape{axis=...}``."""
    return _axis_sizes(mesh)


def axis_shard_degree(mesh, axes, dim: int) -> int:
    """How many ways a tensor dimension of size ``dim`` mapped to mesh
    ``axes`` (a name or a tuple) actually splits: trailing axes that do
    not divide ``dim`` drop to replication, as in :func:`spec_for`."""
    if mesh is None:
        return 1
    sizes = _axis_sizes(mesh)
    if isinstance(axes, str):
        axes = (axes,)
    keep = tuple(axes)
    while keep and dim % math.prod(sizes[a] for a in keep):
        keep = keep[:-1]
    return math.prod(sizes[a] for a in keep) if keep else 1


def data_axis_size(mesh) -> int:
    """Global data-parallel degree (batch must be divisible by this)."""
    sizes = _axis_sizes(mesh)
    return sizes['slice'] * sizes['dp'] * sizes['fsdp']


# --- Logical axis rules ----------------------------------------------------
LogicalRules = Dict[str, Any]

DEFAULT_RULES: LogicalRules = {
    'batch': ('slice', 'dp', 'fsdp'),
    'seq': 'sp',
    'embed': 'fsdp',
    'heads': 'tp',
    'kv_heads': 'tp',
    'head_dim': None,
    'mlp': 'tp',
    'vocab': 'tp',
    # The input embedding table stays replicated over its vocab dim.
    'vocab_in': None,
    'expert': ('fsdp', 'sp'),
    'norm': None,
    'layers': 'pp',
}


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: Optional[LogicalRules] = None, *,
             shape: Optional[Sequence[int]] = None,
             mesh=None) -> Tuple[Any, ...]:
    """A tuple of logical axis names -> the reference's PartitionSpec as
    a tuple (per dimension None, a mesh axis name, or a tuple of names;
    trailing Nones dropped). ``rules`` override :data:`DEFAULT_RULES`;
    an unknown axis raises. With ``shape`` and ``mesh`` the mapping is
    divisibility-aware: mesh axes that do not divide the dimension drop
    (trailing first) to replication, which is what replicates the KV
    heads when ``n_kv_heads % tp != 0``."""
    rules = {**DEFAULT_RULES, **rules} if rules else DEFAULT_RULES
    sizes = _axis_sizes(mesh) if mesh is not None else None
    parts: List[Any] = []
    used = set()
    for i, ax in enumerate(logical_axes):
        if ax is None:
            parts.append(None)
            continue
        if ax not in rules:
            raise ValueError(f'No sharding rule for logical axis {ax!r}')
        mesh_ax = rules[ax]
        if mesh_ax is None:
            keep: Tuple[str, ...] = ()
        elif isinstance(mesh_ax, (tuple, list)):
            keep = tuple(a for a in mesh_ax if a not in used)
        else:
            keep = (mesh_ax,) if mesh_ax not in used else ()
        if keep and shape is not None and sizes is not None:
            dim = shape[i]
            while keep and dim % math.prod(sizes[a] for a in keep):
                keep = keep[:-1]
        used.update(keep)
        if not keep:
            parts.append(None)
        elif len(keep) == 1 and not isinstance(rules[ax], (tuple, list)):
            parts.append(keep[0])
        else:
            parts.append(keep)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _coords(sizes: Dict[str, int], rank: int) -> Dict[str, int]:
    """This rank's index on every axis (row-major over MESH_AXES, so tp
    is innermost: rank = dp_index * tp + tp_index)."""
    out = {}
    for a in reversed(MESH_AXES):
        out[a] = rank % sizes[a]
        rank //= sizes[a]
    return out


def _shard_bounds(shape, axes, sizes, coords, rules):
    """Per dimension of a leaf: (start, length) of this rank's slice."""
    spec = spec_for(axes, rules, shape=shape, mesh=sizes)
    out = []
    for dim, n in enumerate(shape):
        part = spec[dim] if dim < len(spec) else None
        names = () if part is None else ((part,) if isinstance(part, str)
                                          else tuple(part))
        deg, idx = 1, 0
        for a in names:
            deg *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        out.append((idx * (n // deg), n // deg))
    return out


def _slice_leaf(t: torch.Tensor, bounds) -> torch.Tensor:
    """``t`` cut to ``bounds``; ``t`` itself (no copy) when whole."""
    out = t
    for dim, (start, length) in enumerate(bounds):
        if length != t.shape[dim]:
            out = out.narrow(dim, start, length)
    return t if out is t else out.contiguous()


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def leaf_cutter(logical_tree: Any, mesh, *, rank: Optional[int] = None,
                rules: Optional[LogicalRules] = None):
    """``cut(path, leaf, layer=False)``: this rank's shard of one leaf
    of a full params tree, by the logical axes at ``path`` in
    ``logical_tree`` (``('embed',)``, ``('layers', 'wq')``) under
    :func:`spec_for`'s divisibility-aware rules; with ``layer=True``
    ``leaf`` is one layer's slice of a stacked leaf (its stack axis
    dropped). The loaders cut leaf by leaf and layer by layer as they
    draw or read (``llama.init_params``, ``weights.load_hf_params``), so
    a rank never holds the whole tree. A leaf whose shard is the whole
    tensor is returned as is (no copy); a cut leaf is a contiguous copy.
    ``mesh`` is a :class:`ServingMesh` or a :class:`MeshSpec` (then
    ``rank`` names the shard).

    Quantized leaves shard their codes and scales together: a
    column-parallel leaf's per-channel scales split with it, a
    row-parallel leaf's are replicated. An int4 leaf whose packed codes
    or group scales would not split on the boundaries its unpacked
    parent splits on (a shard starting inside a byte or a scale group)
    raises ``ValueError``."""
    from skypilot_tpu_torch.models import quantization
    sizes = _axis_sizes(mesh)
    if rank is None:
        rank = getattr(mesh, 'rank', 0)
    coords = _coords(sizes, rank)

    def bounds(shape, axes):
        return _shard_bounds(shape, axes, sizes, coords, rules)

    def cut(path, t, layer=False):
        axes = logical_tree
        for k in path:
            if not isinstance(axes, dict) or k not in axes:
                raise ValueError(f'no logical axes for {"/".join(path)}')
            axes = axes[k]
        if not _is_axes(axes):
            raise ValueError(f'leaf {"/".join(path)}: unexpected axes '
                             f'{axes!r}')
        quant = isinstance(t, quantization.QUANT_LEAF_TYPES)
        if layer:
            # One layer's slice, cut as a stack of one.
            one = (type(t)(*(x[None] for x in t)) if quant else t[None])
            out = cut(path, one)
            return type(out)(*(x[0] for x in out)) if quant else out[0]
        if quant:
            return quantization.shard_quant_leaf(path[-1], t, axes, bounds,
                                                 _slice_leaf)
        if not torch.is_tensor(t):
            return t
        return _slice_leaf(t, bounds(t.shape, axes))
    return cut


class LocalShard(dict):
    """A params tree that already is one rank's shard (loaded through a
    :func:`leaf_cutter`): the engine keeps it as it is."""


def shard_params(params: Any, logical_tree: Any, mesh, *,
                 rank: Optional[int] = None,
                 rules: Optional[LogicalRules] = None) -> Any:
    """This rank's local shard of a full params tree (the reference's
    ``tree_shardings``, applied): every leaf of ``params`` cut by its
    logical axes in ``logical_tree`` (``llama.param_logical_axes``)
    through :func:`leaf_cutter`."""
    cut = leaf_cutter(logical_tree, mesh, rank=rank, rules=rules)

    def walk(path, p):
        if isinstance(p, dict):
            return {k: walk(path + (k,), v) for k, v in p.items()}
        return cut(path, p)
    return walk((), params)


# --------------------------------------------------------------------------
# The collectives and their census
# --------------------------------------------------------------------------
# Collectives issued, by 'op[axis]', and by 'op[axis] shape dtype' (the
# census the audits read). A CUDA graph's capture records what its body
# issues and every replay adds it again (``inference/graphs.py``).
collective_counts: Dict[str, int] = {}
collective_shapes: Dict[str, int] = {}


def reset_collective_counts() -> None:
    collective_counts.clear()
    collective_shapes.clear()


class _Scope:
    __slots__ = ('mesh', 'plan')

    def __init__(self, mesh: 'ServingMesh', plan: Dict[str, Any]):
        self.mesh = mesh
        self.plan = plan


_tls = threading.local()


def active() -> Optional[_Scope]:
    """The mesh scope of the mirrored call running on this thread, or
    None (a meshless engine, training, a test of a plain function)."""
    stack = getattr(_tls, 'scopes', None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def scope(mesh: 'ServingMesh', plan: Dict[str, Any]):
    """Make ``mesh`` (with the engine's tp ``plan``: which of heads,
    kv_heads, mlp and vocab split over tp, and the replicated kv-head
    layout) the one this thread's collectives run on."""
    stack = getattr(_tls, 'scopes', None)
    if stack is None:
        stack = _tls.scopes = []
    stack.append(_Scope(mesh, plan))
    try:
        yield
    finally:
        stack.pop()


def _note(op: str, axis: str, t: torch.Tensor) -> bool:
    """Count one collective (or, under the cost recorder, price it);
    True when the caller should communicate."""
    from skypilot_tpu_torch.ops import cost
    rec = cost.recorder()
    if rec is not None:
        rec.collective_entry(op, axis, t)
        return False
    key = f'{op}[{axis}]'
    collective_counts[key] = collective_counts.get(key, 0) + 1
    skey = f'{key} {tuple(t.shape)} {str(t.dtype).replace("torch.", "")}'
    collective_shapes[skey] = collective_shapes.get(skey, 0) + 1
    return True


def all_reduce(x: torch.Tensor, axis: str = 'tp',
               op: str = 'sum') -> torch.Tensor:
    """Reduce ``x`` over the active mesh's ``axis``, its sum or (``op=
    'max'``) its elementwise max, in place on a contiguous ``x``;
    returns the result. The census names a max ``all_reduce_max``."""
    sc = active()
    if sc is None:
        raise RuntimeError('all_reduce outside a mesh scope')
    if op not in ('sum', 'max'):
        raise ValueError(f'unknown all_reduce op {op!r}')
    y = x if x.is_contiguous() else x.contiguous()
    if _note('all_reduce' if op == 'sum' else 'all_reduce_max', axis, y):
        import torch.distributed as dist
        dist.all_reduce(y, op=(dist.ReduceOp.SUM if op == 'sum'
                               else dist.ReduceOp.MAX),
                        group=sc.mesh.group(axis))
    return y


def all_gather(x: torch.Tensor, axis: str = 'tp',
               dim: int = 0) -> torch.Tensor:
    """The active mesh's ``axis`` ranks' ``x`` concatenated along
    ``dim``, in rank order."""
    sc = active()
    if sc is None:
        raise RuntimeError('all_gather outside a mesh scope')
    n = sc.mesh.shape[axis]
    y = x.contiguous()
    if not _note('all_gather', axis, y):
        return torch.cat([y] * n, dim=dim)
    import torch.distributed as dist
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=sc.mesh.group(axis))
    return torch.cat(parts, dim=dim)


def reduce_partial(x: torch.Tensor, logical: str) -> torch.Tensor:
    """A row-parallel product's partial sum over tp when the active
    plan splits ``logical`` ('heads' after ``wo``, 'mlp' after
    ``w_down``); ``x`` itself otherwise."""
    sc = active()
    if sc is None or not sc.plan.get(logical):
        return x
    return all_reduce(x, 'tp')


def reduce_max(x: torch.Tensor, logical: str) -> torch.Tensor:
    """The elementwise max over tp of a per-rank statistic of a tensor
    split over tp by ``logical`` (the row absmax of a row-parallel
    product's input, 'heads' before ``wo``, 'mlp' before ``w_down``):
    the statistic of the whole row, exactly. ``x`` itself when the
    active plan does not split ``logical``."""
    sc = active()
    if sc is None or not sc.plan.get(logical):
        return x
    return all_reduce(x, 'tp', op='max')


def gather_split(x: torch.Tensor, logical: str, dim: int) -> torch.Tensor:
    """The whole of a tensor split over tp by ``logical`` ('vocab' for
    the logits, 'kv_heads' for KV rows read back), gathered along
    ``dim``; ``x`` itself when the active plan does not split it."""
    sc = active()
    if sc is None or not sc.plan.get(logical):
        return x
    return all_gather(x, 'tp', dim)


@contextlib.contextmanager
def dp_split(rows: Optional[slice]):
    """Mark the forward run inside as computing only this dp rank's
    block ``rows`` of the batch's rows (a decode step or a verify round
    under dp; None marks nothing): a layer that must see every row
    gathers them with :func:`gather_dp_rows`. A CUDA graph captured
    inside keeps the gathers."""
    prev = getattr(_tls, 'dp_rows', None)
    _tls.dp_rows = rows
    try:
        yield
    finally:
        _tls.dp_rows = prev


def gather_dp_rows(x: torch.Tensor
                   ) -> Tuple[torch.Tensor, Optional[slice]]:
    """``(every row of the batch, this rank's rows)`` for ``x`` whose
    dim 0 is this dp rank's block inside :func:`dp_split` (one
    all-gather over dp, rank order = row order); ``(x, None)``
    outside one."""
    rows = getattr(_tls, 'dp_rows', None)
    if rows is None:
        return x, None
    return all_gather(x, 'dp', 0), rows


def prefill_dp_rows(n: int, dp: int, dp_rank: int) -> Optional[slice]:
    """This dp rank's block of a prefill call's ``n`` batch rows: the
    reference's placement (the batch splits over the data axes when
    they divide it, ``paged.py`` ``_pool_shard_axes``), so a split call's
    rows in rank order are the meshless batch; None (every rank runs
    every row) without dp or when ``dp`` does not divide ``n``."""
    if dp <= 1 or n % dp:
        return None
    per = n // dp
    return slice(dp_rank * per, (dp_rank + 1) * per)


def gather_dp_blocks(tensors: Sequence[torch.Tensor],
                     dims: Sequence[int]) -> List[torch.Tensor]:
    """Every dp rank's block of each of ``tensors``, concatenated along
    its dim in ``dims`` in rank order, in ONE all-gather over dp: the
    tensors' bytes are packed into one uint8 buffer (exact for any
    dtype mix) and split again after the gather."""
    sc = active()
    if sc is None:
        raise RuntimeError('gather_dp_blocks outside a mesh scope')
    n = sc.mesh.shape['dp']
    flat = [t.contiguous().view(-1).view(torch.uint8) for t in tensors]
    sizes = [f.numel() for f in flat]
    every = all_gather(torch.cat(flat), 'dp', 0).view(n, -1)
    out, off = [], 0
    for t, size, dim in zip(tensors, sizes, dims):
        blocks = [every[r, off:off + size].clone().view(t.dtype)
                  .view(t.shape) for r in range(n)]
        out.append(torch.cat(blocks, dim))
        off += size
    return out


def tp_slice(n: int, logical: str) -> slice:
    """This rank's slice of a dimension of size ``n`` split over tp by
    ``logical`` (the whole dimension when the plan does not split it or
    no mesh is active)."""
    sc = active()
    if sc is None or not sc.plan.get(logical):
        return slice(0, n)
    tp = sc.mesh.shape['tp']
    per = n // tp
    return slice(sc.mesh.tp_rank * per, (sc.mesh.tp_rank + 1) * per)


def tp_plan(cfg, mesh) -> Dict[str, Any]:
    """Which of the model's tp-mapped logical dims split over this mesh
    (:func:`spec_for` on the config's sizes): 'heads', 'kv_heads',
    'mlp', 'vocab'. A tp mesh of one rank keeps all four (1 divides
    everything), so its forward issues the same collectives as a wider
    one. 'kv_groups' is this rank's :func:`kv_head_layout` (None when
    its q heads read the kv heads in a regular group)."""
    sizes = {'heads': cfg.n_heads, 'kv_heads': cfg.n_kv_heads,
             'mlp': cfg.ffn_dim, 'vocab': cfg.vocab_size}
    plan: Dict[str, Any] = {
        k: spec_for((k,), shape=(n,), mesh=mesh) == ('tp',)
        for k, n in sizes.items()}
    plan['kv_groups'] = kv_head_layout(cfg, mesh)
    return plan


def kv_head_layout(cfg, mesh, *, tp_rank: Optional[int] = None
                   ) -> Optional[Tuple[Tuple[int, ...], int]]:
    """Where this rank's q heads sit among the kv heads it attends when
    tp splits the q heads but replicates the kv heads (``n_kv_heads %
    tp != 0``, the reference's ``spec_for`` dropping to replication):
    ``(positions, n_virtual)``, or None when the local q heads already
    form regular groups over the local kv heads (the kv heads split
    too, one kv head, or no tp).

    Local q head ``j`` (global ``tp_rank * hq_local + j``) reads kv head
    ``kv = global // group``. The attention runs on a *virtual* query of
    ``n_kv_heads * g`` heads, ``g`` the most local q heads that read one
    kv head, with local head ``j`` at ``positions[j] = kv * g + i`` (its
    index ``i`` among the local heads of that kv head) and zeros
    elsewhere: a regular group ``g`` over every kv head of the
    replicated pool, which every attention path (the plain ones and the
    kernels) takes as it is. The aligned case (64 q / 8 kv at tp 16:
    each rank's 4 q heads read one kv head) and the unaligned one (6 q /
    3 kv at tp 2: rank 1's q heads 3, 4, 5 read kv heads 1, 2, 2) are the
    same mapping. The padded heads cost compute and kv reads over every
    kv head; their outputs are dropped."""
    sizes = _axis_sizes(mesh)
    t = sizes['tp']
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if t == 1 or hq % t or hkv % t == 0 or hkv == 1:
        return None
    if tp_rank is None:
        tp_rank = getattr(mesh, 'tp_rank', 0)
    group, local = hq // hkv, hq // t
    kv_of = [(tp_rank * local + j) // group for j in range(local)]
    g = max(kv_of.count(k) for k in set(kv_of))
    seen: Dict[int, int] = {}
    positions = []
    for kv in kv_of:
        positions.append(kv * g + seen.get(kv, 0))
        seen[kv] = seen.get(kv, 0) + 1
    return tuple(positions), hkv * g


def attend_local_heads(attn_fn, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """``attn_fn(q, k, v)`` for this rank's q heads ``q [b, s, hq_local,
    d]``: as it is, unless the active plan replicates several kv heads
    under split q heads (:func:`kv_head_layout`); then ``q`` is placed in
    the virtual query (zeros elsewhere), attended against every kv head,
    and this rank's heads are taken back out. The plan's 'kv_index' is
    the positions as a device tensor, made once by the engine (a CUDA
    graph captured later never uploads it)."""
    sc = active()
    layout = None if sc is None else sc.plan.get('kv_groups')
    if layout is None:
        return attn_fn(q, k, v)
    n_virtual = layout[1]
    pos = sc.plan['kv_index']
    qv = q.new_zeros(q.shape[:2] + (n_virtual,) + q.shape[3:])
    qv.index_copy_(2, pos, q)
    return attn_fn(qv, k, v).index_select(2, pos)


def attention_config(cfg, plan: Optional[Dict[str, Any]]):
    """The geometry the attention calls of a shard see: ``cfg`` (a shard
    config) with its q heads counted as the virtual query's under a
    replicated kv-head layout (:func:`kv_head_layout`)."""
    layout = None if plan is None else plan.get('kv_groups')
    if layout is None:
        return cfg
    return dataclasses.replace(cfg, n_heads=layout[1],
                               head_dim_override=cfg.head_dim)


def shard_config(cfg, mesh):
    """The config one rank's shard computes with: local q heads, kv
    heads and mlp width (vocab and every other field unchanged)."""
    t = _axis_sizes(mesh)['tp']
    plan = tp_plan(cfg, mesh)
    return dataclasses.replace(
        cfg,
        n_heads=cfg.n_heads // (t if plan['heads'] else 1),
        n_kv_heads=cfg.n_kv_heads // (t if plan['kv_heads'] else 1),
        ffn_dim=cfg.ffn_dim // (t if plan['mlp'] else 1),
        head_dim_override=cfg.head_dim)


# --------------------------------------------------------------------------
# The serving mesh: one process per rank
# --------------------------------------------------------------------------
def _to_wire(obj):
    """``obj`` with every tensor moved to the CPU, for a control
    message (numpy arrays, lists and named tuples pass through)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu() if obj.device.type != 'cpu' else obj
    if isinstance(obj, dict):
        return {k: _to_wire(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, '_fields'):
        return type(obj)(*(_to_wire(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_wire(v) for v in obj)
    return obj


def _wire_bytes(obj) -> int:
    """Bytes of the tensors and arrays in a control message."""
    if torch.is_tensor(obj):
        return obj.numel() * obj.element_size()
    if hasattr(obj, 'nbytes') and hasattr(obj, 'dtype'):
        return int(obj.nbytes)
    if isinstance(obj, dict):
        return sum(_wire_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_wire_bytes(v) for v in obj)
    return 0


# The most tensor bytes an engine's constructor may send the followers
# (a small test tree); larger weights come from ``param_seed`` or a
# checkpoint, which each rank draws or reads as its own shard.
MAX_WIRE_PARAM_BYTES = 64 << 20


class FollowerDied(RuntimeError):
    """A follower rank exited while the mesh was up, or the ranks fell
    out of step (a mirrored call raised on some ranks only)."""


class ServingMesh:
    """One rank's view of the serving mesh: its rank and coordinates,
    its device, the ``DeviceMesh`` and its tp and dp process groups, and
    (on rank 0) the follower processes it started and the control
    channel. ``store_path`` is the rendezvous: a file path (a
    ``FileStore`` on one host) or a ``tcp://host:port`` URL (rank 0
    hosts the store; :func:`gang_mesh`). ``local_rank`` names this
    rank's card on its host (default: ``rank``)."""

    def __init__(self, spec: MeshSpec, rank: int, device_type: str,
                 store_path: str, timeout_s: float, procs=(),
                 tmpdir: Optional[str] = None,
                 local_rank: Optional[int] = None):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if spec.shape[:2] != (1, 1) or spec.fsdp != 1 or spec.sp != 1:
            raise NotImplementedError(
                f'MeshSpec {spec.shape}: only serving meshes (tp, dp) are '
                'ported; fsdp/sp/pp/slices wait for the training meshes '
                '(ROADMAP item 4)')
        self.spec = spec
        self.rank = rank
        self.size = spec.num_devices
        self.shape = dict(zip(MESH_AXES, spec.shape))
        c = _coords(self.shape, rank)
        self.tp_rank, self.dp_rank = c['tp'], c['dp']
        self.device = local_rank_device(
            rank if local_rank is None else local_rank, device_type)
        self.timeout_s = float(timeout_s)
        self._procs = list(procs)
        self._tmpdir = tmpdir
        self._lock = threading.RLock()
        self._tls = threading.local()
        self._next_eid = 0
        self.engines: Dict[int, Any] = {}
        self.closed = False
        self.broken: Optional[str] = None
        timeout = datetime.timedelta(seconds=self.timeout_s)
        kw: Dict[str, Any] = dict(
            backend='nccl' if device_type == 'cuda' else 'gloo',
            init_method=(store_path if '://' in store_path
                         else f'file://{store_path}'),
            world_size=self.size,
            rank=rank, timeout=timeout)
        if device_type == 'cuda':
            torch.cuda.set_device(self.device)
            kw['device_id'] = self.device
        dist.init_process_group(**kw)
        self.device_mesh = init_device_mesh(
            device_type, (spec.dp, spec.tp), mesh_dim_names=('dp', 'tp'))
        self._groups = {'tp': self.device_mesh.get_group('tp'),
                        'dp': self.device_mesh.get_group('dp')}
        self._ctrl = dist.new_group(backend='gloo', timeout=timeout)
        # Every group's communicator set up now, eagerly: a lazy NCCL
        # init inside a CUDA graph capture fails.
        for g in self._groups.values():
            t = torch.zeros(1, device=self.device)
            dist.all_reduce(t, group=g)
            dist.all_gather([torch.empty_like(t)
                             for _ in range(dist.get_world_size(g))], t,
                            group=g)
        if device_type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ----------------------------------------------------------- queries
    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def group(self, axis: str):
        if axis not in self._groups:
            raise ValueError(f'no process group for mesh axis {axis!r}')
        return self._groups[axis]

    def __repr__(self) -> str:
        return (f'ServingMesh(tp={self.shape["tp"]}, dp={self.shape["dp"]}, '
                f'rank={self.rank}, device={self.device})')

    def follower_pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    # ---------------------------------------------------------- control
    def check_followers(self) -> None:
        """Raise :class:`FollowerDied` when a follower has exited (or
        an earlier failure broke the mesh)."""
        if self.broken:
            raise FollowerDied(self.broken)
        for i, p in enumerate(self._procs):
            code = p.poll()
            if code is not None:
                self.broken = (f'follower rank {i + 1} exited with code '
                               f'{code}')
                raise FollowerDied(self.broken)

    def send(self, msg: Tuple) -> None:
        """Rank 0: one control message to every follower."""
        import torch.distributed as dist
        if self.size == 1:
            return
        self.check_followers()
        try:
            dist.broadcast_object_list([_to_wire(msg)], src=0,
                                       group=self._ctrl)
        except Exception as e:
            self.broken = f'control broadcast failed: {e}'
            self.check_followers()
            raise FollowerDied(self.broken) from e

    def recv(self) -> Tuple:
        """A follower: the next control message from rank 0."""
        import torch.distributed as dist
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self._ctrl)
        return box[0]

    def min_over_ranks(self, value: int) -> int:
        """The least of ``value`` over every rank (the control group)."""
        import torch.distributed as dist
        if self.size == 1:
            return int(value)
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self._ctrl)
        return int(t.item())

    def gather_objects(self, obj) -> List[Any]:
        """Every rank's ``obj`` in rank order (the control group; every
        rank calls it at the same point, as a mirrored call does)."""
        import torch.distributed as dist
        if self.size == 1:
            return [obj]
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj, group=self._ctrl)
        return out

    def _depth(self) -> int:
        return getattr(self._tls, 'depth', 0)

    def agree(self, exc: Optional[BaseException]) -> None:
        """After each control message, on every rank: all-gather over
        the control group whether handling it raised, and what. The same
        exception type on every rank (a refusal that depends on the
        shared host state, such as a constructor's checks) leaves the
        mesh in step and returns. Any other mix means the ranks' host
        state may differ (an out-of-memory error on one rank): the mesh
        is broken and :class:`FollowerDied` raises here, on rank 0 as on
        the followers (which then exit non-zero)."""
        import torch.distributed as dist
        import zlib
        if self.size == 1:
            return
        code = 0 if exc is None else 1 + zlib.crc32(
            type(exc).__qualname__.encode())
        mine = torch.tensor([code], dtype=torch.int64)
        every = [torch.empty_like(mine) for _ in range(self.size)]
        try:
            dist.all_gather(every, mine, group=self._ctrl)
        except Exception as e:
            self.broken = f'control all-gather failed: {e}'
            if self.is_leader:
                self.check_followers()
            raise FollowerDied(self.broken) from e
        codes = [int(t.item()) for t in every]
        if len(set(codes)) == 1:
            return
        raised = [r for r, c in enumerate(codes) if c]
        self.broken = (f'ranks {raised} of {self.size} raised in a mirrored '
                       'call and the others did not (or raised otherwise): '
                       'their host state may differ')
        raise FollowerDied(self.broken) from exc

    @contextlib.contextmanager
    def op(self, msg_fn, plan: Optional[Dict[str, bool]] = None):
        """Run a mirrored operation: on rank 0, the outermost operation
        of this thread first sends ``msg_fn()`` to the followers (under
        the mesh lock, so the followers see the calls in rank 0's
        order); every rank then runs it inside the scope of ``plan``,
        and rank 0 ends it with :meth:`agree` (a follower agrees on the
        whole message it handled, ``parallel/follower.py``)."""
        with self._lock:
            depth = self._depth()
            outer = depth == 0 and self.is_leader
            if outer:
                self.send(msg_fn())
            self._tls.depth = depth + 1
            exc: Optional[BaseException] = None
            try:
                if plan is None:
                    yield
                else:
                    with scope(self, plan):
                        yield
            except BaseException as e:
                exc = e
                raise
            finally:
                self._tls.depth = depth
                if outer and self.size > 1:
                    self.agree(exc)

    def new_engine_id(self, engine) -> int:
        eid = self._next_eid
        self._next_eid += 1
        if not self.is_leader:
            self.engines[eid] = engine
        return eid

    def close_engine(self, eid: int) -> None:
        if self.is_leader:
            if not self.closed and not self.broken:
                self.send(('close', eid))
                self.agree(None)
        else:
            self.engines.pop(eid, None)

    # --------------------------------------------------------- shutdown
    def shutdown(self, timeout_s: float = 30.0) -> None:
        """Rank 0: stop the followers, wait for them (killing any that
        does not exit), and destroy the process group. Idempotent."""
        import torch.distributed as dist
        if self.closed:
            return
        self.closed = True
        if self.is_leader and self.size > 1:
            try:
                if not self.broken:
                    self.send(('stop',))
            except FollowerDied:
                pass
            _reap(self._procs, timeout_s)
        self.engines.clear()
        abort_broken_group(self)
        if self._tmpdir:
            shutil.rmtree(self._tmpdir, ignore_errors=True)


def abort_broken_group(mesh: ServingMesh) -> None:
    """Destroy the process group; a broken mesh's is aborted instead
    (NCCL: its communicators torn down, so a collective a dead or
    diverged peer never joined, one replayed in a CUDA graph too, stops
    waiting), with no barrier."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d
    if not dist.is_initialized():
        return
    if not mesh.broken:
        dist.destroy_process_group()
        return
    try:
        if mesh.device.type == 'cuda':
            distributed_c10d._abort_process_group()
        else:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - a peer is gone
        pass


def _reap(procs, timeout_s: float) -> None:
    """Wait for the follower processes, killing any still running after
    ``timeout_s``."""
    import subprocess
    for p in procs:
        try:
            p.wait(timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(5)


def make_mesh(spec: MeshSpec, *, device='cuda',
              timeout_s: float = DEFAULT_TIMEOUT_S,
              store_dir: Optional[str] = None,
              threads: Optional[int] = None) -> ServingMesh:
    """Build the serving mesh of ``spec`` on ``device``'s type (one rank
    per CUDA device, or per process on the CPU): start the followers
    (ranks 1.., ``parallel/follower.py``) and join as rank 0. Unlike
    :func:`serving_mesh` it builds a one-rank mesh too (a one-rank NCCL
    group: every collective a copy). ``store_dir`` holds the rendezvous
    file (a fresh temporary directory by default); ``threads`` sets the
    followers' CPU intra-op threads. Only one mesh may be up in a
    process at a time."""
    import subprocess
    import sys
    import torch.distributed as dist
    device_type = torch.device(device).type
    if device_type not in ('cuda', 'cpu'):
        raise ValueError(f'serving mesh on {device!r}: use cuda or cpu')
    if dist.is_initialized():
        raise RuntimeError('a process group is already up in this process '
                           '(shut the other serving mesh down first)')
    n = spec.num_devices
    if device_type == 'cuda' and n > _cuda_devices():
        raise ValueError(f'mesh {spec.shape} needs {n} CUDA devices, but '
                         f'only {_cuda_devices()} are visible')
    tmpdir = None
    if store_dir is None:
        tmpdir = store_dir = tempfile.mkdtemp(prefix='skytpu-mesh-')
    os.makedirs(store_dir, exist_ok=True)
    store_path = os.path.join(store_dir, 'rendezvous')
    if os.path.exists(store_path):
        os.remove(store_path)
    # The followers import this package from where this process found
    # it, whatever the caller's sys.path.
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [root] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.parallel.follower',
         '--rank', str(r), '--tp', str(spec.tp), '--dp', str(spec.dp),
         '--device-type', device_type, '--store', store_path,
         '--timeout-s', str(timeout_s), '--threads', str(threads or 1)],
        env=env, stdin=subprocess.DEVNULL) for r in range(1, n)]
    try:
        return ServingMesh(spec, 0, device_type, store_path, timeout_s,
                           procs, tmpdir)
    except BaseException:
        for p in procs:
            p.kill()
        _reap(procs, 5)
        if tmpdir:
            shutil.rmtree(tmpdir, ignore_errors=True)
        raise


def serving_mesh(tp: int = 1, dp: int = 1, *, device='cuda',
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 store_dir: Optional[str] = None,
                 threads: Optional[int] = None) -> Optional[ServingMesh]:
    """The (tp, dp) serving mesh over the first ``tp*dp`` devices, or
    None at tp = dp = 1: the engines' meshless path then skips sharding
    entirely, as the reference's does. Raises ``ValueError`` when the
    mesh needs more CUDA devices than are visible (on the CPU any count
    of ranks is allowed: each is a process)."""
    spec = MeshSpec.for_serving(tp=tp, dp=dp)
    if spec.num_devices == 1:
        return None
    return make_mesh(spec, device=device, timeout_s=timeout_s,
                     store_dir=store_dir, threads=threads)


# --------------------------------------------------------------------------
# Multi-host bootstrap
# --------------------------------------------------------------------------
# Port offset from the gang bus (rank 0's HTTP front end) to the process
# group's TCP rendezvous: the two services share a host, not a protocol.
GANG_RENDEZVOUS_PORT_OFFSET = 1000


def coordinator_from_url(url: str) -> str:
    """``host:port`` of the process group's rendezvous from a gang's
    ``SKYTPU_COORDINATOR`` HTTP URL (rank 0's model server): the same
    host, the HTTP port + :data:`GANG_RENDEZVOUS_PORT_OFFSET`."""
    import urllib.parse
    parsed = urllib.parse.urlparse(url if '//' in url else f'//{url}')
    host = parsed.hostname or 'localhost'
    port = (parsed.port or 8081) + GANG_RENDEZVOUS_PORT_OFFSET
    return f'{host}:{port}'


def _backend(device) -> str:
    """'nccl' for a CUDA device (raising when this host has none: the
    bootstrap never falls back to the CPU), 'gloo' for the CPU."""
    device_type = torch.device(device).type
    if device_type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('device=cuda but no CUDA device is '
                               "visible (pass device='cpu' for gloo)")
        return 'nccl'
    if device_type != 'cpu':
        raise ValueError(f'process group on {device!r}: use cuda or cpu')
    return 'gloo'


def _init_default_group(addr: str, rank: int, world: int,
                        timeout_s: float, device) -> bool:
    """Join the default process group at ``tcp://addr`` (idempotent:
    True at once when one is up). A rendezvous that does not complete
    within ``timeout_s`` or a connect failure raises."""
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    dist.init_process_group(
        backend=_backend(device), init_method=f'tcp://{addr}',
        world_size=int(world), rank=int(rank),
        timeout=datetime.timedelta(seconds=max(1.0, float(timeout_s))))
    return True


def initialize_gang_distributed(coordinator_url: str, rank: int,
                                world: int, *,
                                timeout_s: float = 120.0,
                                device='cuda') -> bool:
    """Multi-process bootstrap from the gang launch-env contract
    (``SKYTPU_COORDINATOR``/``SKYTPU_RANK``/``SKYTPU_WORLD``): the
    default process group over ``tcp://`` :func:`coordinator_from_url`,
    so that one program spans every gang process. Bounded by
    ``timeout_s`` (a member that never comes up fails the gang instead
    of hanging it); a no-op (False) for ``world <= 1``; idempotent; a
    failed connect raises, never swallowed (a half-joined gang would
    serve disconnected shards)."""
    if world <= 1:
        return False
    return _init_default_group(coordinator_from_url(coordinator_url), rank,
                               world, timeout_s, device)


def initialize_distributed_from_env(*, device='cuda',
                                    timeout_s: float = DEFAULT_TIMEOUT_S
                                    ) -> bool:
    """The training twin of :func:`initialize_gang_distributed`, from
    ``SKYTPU_COORDINATOR_ADDRESS`` (``host:port``), ``SKYTPU_NUM_NODES``
    and ``SKYTPU_NODE_RANK``: a no-op (False) when the contract is
    absent or names one node; idempotent; a failed connect raises."""
    coord = os.environ.get('SKYTPU_COORDINATOR_ADDRESS')
    n = int(os.environ.get('SKYTPU_NUM_NODES', '1') or 1)
    if not coord or n <= 1:
        return False
    rank = int(os.environ.get('SKYTPU_NODE_RANK', '0') or 0)
    return _init_default_group(coord, rank, n, timeout_s, device)


def gang_mesh(tp: int, dp: int, *, coordinator_url: str, rank: int,
              device='cuda', timeout_s: float = DEFAULT_TIMEOUT_S,
              local_rank: Optional[int] = None) -> ServingMesh:
    """This process's rank of the (tp, dp) serving mesh whose ranks a
    launcher started (a mesh gang: ``tp * dp`` processes, on one host or
    several), met at ``tcp://`` :func:`coordinator_from_url` (rank 0
    hosts the store). Nothing is spawned: rank 0's mesh has no follower
    processes of its own, and a nonzero rank runs
    ``parallel/follower.py``'s loop on the mesh returned. The rendezvous
    waits at most ``timeout_s`` for every rank and raises otherwise.
    ``local_rank`` names this rank's card on its host (default: the
    ``LOCAL_RANK`` environment variable, else ``rank``)."""
    import torch.distributed as dist
    device_type = torch.device(device).type
    _backend(device)
    if dist.is_initialized():
        raise RuntimeError('a process group is already up in this process '
                           '(shut the other serving mesh down first)')
    if local_rank is None:
        local_rank = int(os.environ.get('LOCAL_RANK', rank))
    spec = MeshSpec.for_serving(tp=tp, dp=dp)
    return ServingMesh(spec, rank, device_type,
                       'tcp://' + coordinator_from_url(coordinator_url),
                       timeout_s, local_rank=local_rank)


# --------------------------------------------------------------------------
# Mirrored engine calls
# --------------------------------------------------------------------------
def _qualname(cls) -> Tuple[str, str]:
    return cls.__module__, cls.__qualname__


def resolve(module: str, qualname: str):
    """A package class or function by its module and qualified name (a
    follower resolves what rank 0 names); only ``skypilot_tpu_torch``."""
    if not module.startswith('skypilot_tpu_torch.'):
        raise ValueError(f'refusing to resolve {module}.{qualname}')
    obj = importlib.import_module(module)
    for part in qualname.split('.'):
        obj = getattr(obj, part)
    return obj


def mirrored_init(init):
    """Decorate an engine's ``__init__``: with a ``mesh=`` of several
    ranks, rank 0 sends the constructor's arguments to the followers
    (each builds its own shard of the same engine), and every rank
    numbers the engine alike (``engine._mesh_eid``)."""
    @functools.wraps(init)
    def wrapper(self, *args, **kwargs):
        mesh = kwargs.get('mesh')
        if mesh is None:
            return init(self, *args, **kwargs)
        if not isinstance(mesh, ServingMesh):
            raise TypeError(f'mesh must be a ServingMesh (serving_mesh / '
                            f'make_mesh), got {type(mesh).__name__}')
        wire = {k: v for k, v in kwargs.items() if k not in ('mesh',
                                                             'device')}
        if mesh.size > 1 and _wire_bytes((args, wire)) > \
                MAX_WIRE_PARAM_BYTES:
            raise ValueError(
                f'{_wire_bytes((args, wire))} bytes of weights passed to '
                f'an engine on a {mesh.size}-rank mesh: more than '
                f'{MAX_WIRE_PARAM_BYTES} would go whole to every rank. '
                'Build it from param_seed= or from_pretrained(), which '
                'give each rank only its shard')

        def msg():
            return ('new',) + _qualname(type(self)) + (args, wire)

        with mesh.op(msg):
            self._mesh_eid = mesh.new_engine_id(self)
            init(self, *args, **kwargs)
    return wrapper


def mirrored(method):
    """Decorate an engine method that changes its state or issues
    collectives: under a mesh, rank 0 sends the call to the followers
    first (the outermost call of a thread only; calls it makes are
    mirrored by the followers' own call), and the method runs inside the
    engine's mesh scope on every rank."""
    name = method.__name__

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        mesh = getattr(self, 'mesh', None)
        if mesh is None:
            return method(self, *args, **kwargs)
        with mesh.op(lambda: ('call', self._mesh_eid, name, args, kwargs),
                     self._tp_plan):
            return method(self, *args, **kwargs)
    return wrapper


def mirrored_classmethod_load(cls, path: str, dtype, kwargs, load):
    """``from_pretrained`` under a mesh: rank 0 sends the checkpoint
    path and arguments, and every rank loads it (``load(cls, path,
    dtype, kwargs)``) and keeps its own shard."""
    mesh = kwargs['mesh']
    wire = {k: v for k, v in kwargs.items() if k not in ('mesh', 'device')}
    with mesh.op(lambda: ('pretrained',) + _qualname(cls)
                 + (path, dtype, wire)):
        return load(cls, path, dtype, kwargs)
