"""The mesh over ``torch.distributed`` (port of
``skypilot_tpu/parallel/mesh.py``): the (tp, dp) serving mesh and the
six-axis training mesh ``('slice', 'pp', 'dp', 'fsdp', 'sp', 'tp')``.

The JAX package drives every device of a mesh from one controller and
lets XLA insert the collectives. PyTorch's idiom is SPMD, one process
per device, and so is this module's:

- :func:`serving_mesh` / :func:`make_mesh` start one follower process
  per extra rank (``python -m skypilot_tpu_torch.parallel.follower``: a
  fresh interpreter that imports this package only, never the caller's
  main module) and return rank 0's :class:`ServingMesh`: a process
  group (``nccl`` on CUDA, ``gloo`` on the CPU), one process group per
  mesh axis (and per combination of axes the collectives use: the data
  axes, the expert axes, the whole world) with ranks laid out
  row-major over :data:`MESH_AXES` (``tp`` innermost, as the
  reference's ``make_mesh`` orders its axes), and two gloo groups that
  carry rank 0's control messages: the doorbell, on which an idle
  follower waits for rank 0's next call, and the control group of the
  per-call agreement. Both are bounded by the mesh's timeout like every
  collective inside a call; while the mesh is idle rank 0 rings the
  doorbell with a no-op (``('ping',)``) at a fraction of that timeout,
  so an idle follower waits for as long as rank 0 lives.
- Rank 0 owns every host decision (the server, the scheduler, the
  tokenizer, the training loop). An engine or a trainer built with
  ``mesh=`` sends its constructor's arguments to the followers, and
  each mirrored method (:func:`mirrored`) sends its name and arguments
  before it runs, so every rank runs the same calls in the same order
  with the same arguments and keeps the same host state. No rank reads
  another's device tensors outside a collective. The followers' loop is
  ``parallel/follower.py``.
- Each rank holds only its shard of the weights (:func:`shard_params`,
  by the logical axes of ``models/llama.py`` and the reference's
  :data:`DEFAULT_RULES`, divisibility-aware as its ``spec_for``): the
  serving engines' over (tp, dp), the trainer's over all six axes.
- Every collective of the port goes through this module, inside a
  mirrored call's scope (:func:`active`): :func:`all_reduce` and
  :func:`all_gather` for the engines; for training, the
  ``torch.autograd.Function`` pairs whose forward and backward
  collectives mirror each other (:func:`tp_copy` / :func:`reduce_partial`
  for the column- and row-parallel products, :func:`fsdp_gather` whose
  backward is a reduce-scatter, :func:`gather_rows`, the
  sequence-parallel :func:`exchange` and :func:`all_to_all`). They
  count what they issue (:data:`collective_counts`,
  :data:`collective_shapes`: the audits' census; a CUDA graph's replays
  add what its capture recorded, ``inference/graphs.py``) and, under the
  cost model's recorder, price their bytes per mesh axis instead of
  communicating.

A follower that dies or hangs makes rank 0 raise: before every control
message rank 0 checks that each follower it started is alive, and a
collective (a doorbell ring too) with a dead or stalled peer fails
within the process group's timeout. A follower whose rank 0 dies leaves
at once (its doorbell connection closes, and a follower rank 0 spawned
also watches its parent process); one whose rank 0 stalls or whose host
is lost leaves when no ring came within the timeout.

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
  ``FileStore`` of :func:`make_mesh`; :func:`launched_mesh` does the
  same for a launched training job (``python -m
  skypilot_tpu_torch.train`` on every node). Rank 0 keeps the control
  channel, the per-call agreement and the census as above; a nonzero
  rank runs ``parallel/follower.py``'s loop on it.
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

# Seconds the start-up rendezvous of a mesh whose followers
# :func:`make_mesh` spawns waits for them at least (each is an
# interpreter importing torch: slow on a loaded host).
STARTUP_TIMEOUT_S = 300.0

# While the mesh is idle, rank 0 rings the doorbell with a no-op once
# per this share of the mesh's timeout, so an idle follower's wait
# (bounded by that timeout, as every wait of the mesh) never runs out
# while rank 0 lives.
PING_FRACTION = 0.25

# The data axes (the batch splits over them) and the expert axes (MoE
# experts fold over them), as the reference's DEFAULT_RULES map 'batch'
# and 'expert'.
DATA_AXES = ('slice', 'dp', 'fsdp')
EXPERT_AXES = ('fsdp', 'sp')
# Every axis combination a collective runs over: each single axis, the
# data axes with and without sp (the loss's denominators, the gradient
# sums; without fsdp for a leaf whose gather already reduce-scattered
# over it), the expert axes and the whole world.
GROUP_AXES = tuple((a,) for a in MESH_AXES) + (
    DATA_AXES, DATA_AXES + ('sp',), ('slice', 'dp'), ('slice', 'dp', 'sp'),
    EXPERT_AXES, MESH_AXES)


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


def batch_sharding(mesh=None, rules: Optional['LogicalRules'] = None
                   ) -> Tuple[Any, ...]:
    """The spec of ``[batch, seq]`` token arrays (the reference's
    ``batch_sharding``, as a spec tuple): the batch over the data axes,
    the sequence over sp. ``mesh`` is accepted for the reference's
    signature; the spec does not depend on it."""
    del mesh
    return spec_for(('batch', 'seq'), rules)


def axes_key(axes) -> Tuple[str, ...]:
    """A mesh axis name or a collection of them, as a tuple in
    :data:`MESH_AXES` order (the key of a process group)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = set(names) - set(MESH_AXES)
    if unknown:
        raise ValueError(f'unknown mesh axes {sorted(unknown)}')
    return tuple(a for a in MESH_AXES if a in names)


def group_ranks(sizes: Dict[str, int], axes) -> List[List[int]]:
    """Every process group over ``axes``: the lists of global ranks that
    agree on every other axis, each in ascending order (so a group's
    rank order is the row-major index over ``axes``, the order in which
    :func:`spec_for` numbers a shard split over several axes)."""
    key = axes_key(axes)
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for r in range(math.prod(sizes[a] for a in MESH_AXES)):
        c = _coords(sizes, r)
        groups.setdefault(tuple(c[a] for a in MESH_AXES if a not in key),
                          []).append(r)
    return [groups[k] for k in sorted(groups)]


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


_REDUCE_OPS = ('sum', 'max', 'min')


def _axis_name(axis) -> str:
    """The census name of a mesh axis or of a combination of them."""
    return ','.join(axes_key(axis))


def _dist_reduce_op(op: str):
    import torch.distributed as dist
    return {'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX,
            'min': dist.ReduceOp.MIN}[op]


def _comm_all_reduce(mesh: 'ServingMesh', y: torch.Tensor, axis,
                     op: str = 'sum') -> None:
    """Reduce the contiguous ``y`` in place over ``axis`` of ``mesh``
    (counted; nothing moves over an axis of one rank)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f'unknown all_reduce op {op!r}')
    name = 'all_reduce' if op == 'sum' else f'all_reduce_{op}'
    if _note(name, _axis_name(axis), y):
        g = mesh.group(axis)
        if g is not None:
            import torch.distributed as dist
            dist.all_reduce(y, op=_dist_reduce_op(op), group=g)


def _comm_all_gather(mesh: 'ServingMesh', x: torch.Tensor, axis,
                     dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` over ``axis`` concatenated along ``dim``, in
    the group's rank order."""
    n = mesh.axis_size(axis)
    y = x.contiguous()
    if not _note('all_gather', _axis_name(axis), y):
        return torch.cat([y] * n, dim=dim)
    g = mesh.group(axis)
    if g is None:
        return y
    import torch.distributed as dist
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=g)
    return torch.cat(parts, dim=dim)


def _comm_reduce_scatter(mesh: 'ServingMesh', x: torch.Tensor, axis,
                         dim: int = 0) -> torch.Tensor:
    """The sum over ``axis`` of ``x``, this rank's ``1/n`` block of it
    along ``dim`` (block ``i`` to the group's rank ``i``): the
    transpose of :func:`_comm_all_gather`."""
    n = mesh.axis_size(axis)
    y = x.movedim(dim, 0).contiguous()
    if not _note('reduce_scatter', _axis_name(axis), y):
        return y[:y.shape[0] // n].movedim(0, dim)
    g = mesh.group(axis)
    if g is None:
        return x
    import torch.distributed as dist
    out = torch.empty((y.shape[0] // n,) + tuple(y.shape[1:]),
                      dtype=y.dtype, device=y.device)
    # ``reduce_scatter_single`` where this torch has it (the older name
    # is deprecated there).
    getattr(dist, 'reduce_scatter_single', dist.reduce_scatter_tensor)(
        out, y, group=g)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, axis='tp',
               op: str = 'sum') -> torch.Tensor:
    """Reduce ``x`` over the active mesh's ``axis`` (a name or a tuple
    of names), its sum or (``op='max'``/``'min'``) its elementwise max
    or min, in place on a contiguous ``x``; returns the result. The
    census names a max ``all_reduce_max`` and a min
    ``all_reduce_min``. No autograd: :func:`reduce_sum` is the
    differentiable sum."""
    sc = active()
    if sc is None:
        raise RuntimeError('all_reduce outside a mesh scope')
    y = x if x.is_contiguous() else x.contiguous()
    _comm_all_reduce(sc.mesh, y, axis, op)
    return y


def all_gather(x: torch.Tensor, axis='tp', dim: int = 0) -> torch.Tensor:
    """The active mesh's ``axis`` ranks' ``x`` concatenated along
    ``dim``, in rank order."""
    sc = active()
    if sc is None:
        raise RuntimeError('all_gather outside a mesh scope')
    return _comm_all_gather(sc.mesh, x, axis, dim)


def reduce_partial(x: torch.Tensor, logical: str) -> torch.Tensor:
    """A row-parallel product's partial sum over tp when the active
    plan splits ``logical`` ('heads' after ``wo``, 'mlp' after
    ``w_down``); ``x`` itself otherwise."""
    sc = active()
    if sc is None or not sc.plan.get(logical):
        return x
    if sc.plan.get('train'):
        return _ReduceSum.apply(x, sc.mesh, 'tp')
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
    n = sc.mesh.axis_size('dp')
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
# Training: differentiable collectives
# --------------------------------------------------------------------------
# Each autograd Function keeps its mesh and axes in ``ctx``: a CUDA
# backward runs on the autograd engine's device thread, where this
# thread's scope is not active.
def training() -> Optional[_Scope]:
    """The active scope when it is a training mesh's (its plan has
    ``'train'``), else None."""
    sc = active()
    return sc if sc is not None and sc.plan.get('train') else None


@contextlib.contextmanager
def reenter(sc: Optional[_Scope]):
    """Make the scope ``sc`` (captured in a forward) active again, for a
    function that may run on another thread: a checkpointed layer's
    recomputation in the backward. A no-op for None."""
    if sc is None:
        yield
        return
    stack = getattr(_tls, 'scopes', None)
    if stack is None:
        stack = _tls.scopes = []
    stack.append(sc)
    try:
        yield
    finally:
        stack.pop()


class _ReduceSum(torch.autograd.Function):
    """Forward: the sum over ``axes`` (an all-reduce); backward: the
    gradient as it is (every rank holds the whole upstream gradient).
    The row-parallel product's reduction, and the vocab-parallel loss's
    sums."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        y = x.contiguous().clone()
        _comm_all_reduce(mesh, y, axes)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyReduceGrad(torch.autograd.Function):
    """Forward: ``x`` as it is; backward: the sum of the gradient over
    ``axes``. Where a tensor replicated over tp meets a tp-split
    product, each rank's gradient is a partial sum."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _comm_all_reduce(ctx.mesh, g, ctx.axes)
        return g, None, None


class _SliceGatherGrad(torch.autograd.Function):
    """Forward: this rank's block along ``dim`` of ``x`` (replicated over
    ``axes``); backward: every rank's block gradient all-gathered into
    the whole gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        n, i = mesh.axis_size(axes), mesh.axis_index(axes)
        per = x.shape[dim] // n
        return x.narrow(dim, i * per, per)

    @staticmethod
    def backward(ctx, g):
        return (_comm_all_gather(ctx.mesh, g, ctx.axes, ctx.dim), None,
                None, None)


def reduce_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """The differentiable sum of ``x`` over the active training mesh's
    ``axis`` (gradient passed through as it is)."""
    return _ReduceSum.apply(x, training().mesh, axis)


def tp_copy(x: torch.Tensor, logical: str) -> torch.Tensor:
    """``x`` (replicated over tp) where it enters a product split over tp
    by ``logical``: its gradient is summed over tp in the backward (the
    column-parallel input's Function; the pair of :func:`reduce_partial`).
    ``x`` itself outside a training scope or when ``logical`` is not
    split."""
    sc = training()
    if sc is None or not sc.plan.get(logical):
        return x
    return _CopyReduceGrad.apply(x, sc.mesh, 'tp')


def pp_copy(x: torch.Tensor) -> torch.Tensor:
    """The activation entering a pp mesh's pipeline: only stage 0 uses
    it, so its gradient is summed over pp (every stage's embedding then
    takes the whole gradient). ``x`` itself without pp."""
    sc = training()
    if sc is None or sc.mesh.axis_size('pp') == 1:
        return x
    return _CopyReduceGrad.apply(x, sc.mesh, 'pp')


def stacked_plan(plan: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """A per-layer gather plan (:func:`gather_plan`'s ``'layers'``) for
    stacked leaves: each gathered dim one further in."""
    if plan is None:
        return None
    return {k: (stacked_plan(v) if isinstance(v, dict) else
                None if v is None else (v[0] + 1, v[1]))
            for k, v in plan.items()}


def same_tp_split(a: str, b: str) -> bool:
    """Whether the active plan splits logical dims ``a`` and ``b`` over
    tp alike (both or neither; True without a scope)."""
    sc = active()
    return sc is None or bool(sc.plan.get(a)) == bool(sc.plan.get(b))


def tp_copy_replicated_kv(x: torch.Tensor) -> torch.Tensor:
    """k or v rows whose kv heads are replicated over tp while the q
    heads split (``kv_head_layout``): under a training mesh their
    gradient sums over tp, each rank's q heads having used them."""
    sc = training()
    if sc is None or not sc.plan.get('heads') or sc.plan.get('kv_heads'):
        return x
    return _CopyReduceGrad.apply(x, sc.mesh, 'tp')


def tp_rows(t: torch.Tensor, logical: str, dim: int = 0) -> torch.Tensor:
    """This tp rank's block of a tensor replicated over tp (a tied
    embedding's vocab rows), differentiable: the backward all-gathers
    the blocks' gradients, so every rank holds the whole gradient."""
    sc = active()
    if sc is None or not sc.plan.get(logical):
        return t
    if sc.plan.get('train'):
        return _SliceGatherGrad.apply(t, sc.mesh, 'tp', dim)
    return t[tp_slice(t.shape[dim], logical)]


class _GatherLeaves(torch.autograd.Function):
    """All-gather several leaves over ``axes`` in ONE collective, each
    along its own dim; the backward reduce-scatters their gradients in
    one collective too (a rank keeps the sum of its own blocks)."""

    @staticmethod
    def forward(ctx, mesh, axes, dims, *xs):
        n = mesh.axis_size(axes)
        ctx.mesh, ctx.axes, ctx.dims = mesh, axes, dims
        ctx.shapes = [x.shape for x in xs]
        flat = torch.cat([x.movedim(d, 0).reshape(-1)
                          for x, d in zip(xs, dims)])
        every = _comm_all_gather(mesh, flat, axes, 0).view(n, -1)
        out, off = [], 0
        for x, d in zip(xs, dims):
            m = x.numel()
            moved = x.movedim(d, 0).shape
            blocks = every[:, off:off + m].reshape((n,) + tuple(moved))
            out.append(blocks.reshape((n * moved[0],) + tuple(moved[1:]))
                       .movedim(0, d))
            off += m
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.mesh.axis_size(ctx.axes)
        parts = []
        for g, d, shape in zip(gs, ctx.dims, ctx.shapes):
            moved = g.movedim(d, 0)
            parts.append(moved.reshape(n, -1))
        flat = torch.cat(parts, dim=1)
        mine = _comm_reduce_scatter(ctx.mesh, flat, ctx.axes, 0)
        mine = mine.reshape(-1)
        out, off = [], 0
        for d, shape in zip(ctx.dims, ctx.shapes):
            m = math.prod(shape)
            moved = torch.Size((shape[d],) + tuple(
                shape[i] for i in range(len(shape)) if i != d))
            out.append(mine[off:off + m].reshape(moved).movedim(0, d))
            off += m
        return (None, None, None) + tuple(out)


def fsdp_gather(tree: Dict[str, Any], plan: Dict[str, Any]
                ) -> Dict[str, Any]:
    """The leaves of ``tree`` (one layer's params, or the top-level
    ``embed``/``unembed``) with their fsdp shards all-gathered: ``plan``
    maps a leaf's name (nested dicts alike) to ``(dim, axes)``, the dim
    split over the mesh axes ``axes`` (``('fsdp',)``, or the experts'
    ``('fsdp', 'sp')``). Leaves of one axes, dtype and grad requirement
    go in one collective, whose backward reduce-scatters their
    gradients. ``tree`` itself outside a training scope."""
    sc = training()
    if sc is None or not plan:
        return tree
    flat: List[Tuple[Tuple[str, ...], torch.Tensor, int, Any]] = []

    def walk(path, t, p):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(path + (k,), v, (p or {}).get(k))
            elif p is not None and k in p and p[k] is not None:
                flat.append((path + (k,), v) + tuple(p[k]))
    walk((), tree, plan)
    groups: Dict[Any, List[int]] = {}
    for i, (_, t, _, axes) in enumerate(flat):
        groups.setdefault((axes, t.dtype, t.requires_grad), []).append(i)
    got: Dict[Tuple[str, ...], torch.Tensor] = {}
    for (axes, _, _), idx in groups.items():
        outs = _GatherLeaves.apply(sc.mesh, axes,
                                   tuple(flat[i][2] for i in idx),
                                   *(flat[i][1] for i in idx))
        for i, o in zip(idx, outs):
            got[flat[i][0]] = o

    def rebuild(path, t):
        return {k: (rebuild(path + (k,), v) if isinstance(v, dict)
                    else got.get(path + (k,), v)) for k, v in t.items()}
    return rebuild((), tree)


class _GatherRows(torch.autograd.Function):
    """All-gather ``x`` over ``axes`` along ``dim``; backward: the
    reduce-scatter of the gradient (each rank keeps its block's sum)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _comm_all_gather(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_comm_reduce_scatter(ctx.mesh, g, ctx.axes, ctx.dim),
                None, None, None)


def gather_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole sequence of ``x`` (this rank's sp block along ``dim``),
    all-gathered over sp, differentiable; ``x`` itself without sp."""
    sc = training()
    if sc is None or sc.mesh.axis_size('sp') == 1:
        return x
    return _GatherRows.apply(x, sc.mesh, 'sp', dim)


def gather_rows(x: torch.Tensor):
    """``(the whole batch's x, (rows, seq) of this rank in it))`` for a
    ``[b, s, ...]`` activation that holds this rank's rows (over the
    data axes) and sequence block (over sp), differentiable: what a layer
    that must see every token (MoE's routing, R6) computes on. ``(x,
    None)`` outside a training scope."""
    sc = training()
    if sc is None:
        return x, None
    mesh = sc.mesh
    b, s = x.shape[:2]
    full = _GatherRows.apply(x, mesh, 'sp', 1)
    full = _GatherRows.apply(full, mesh, DATA_AXES, 0)
    i, j = mesh.axis_index(DATA_AXES), mesh.axis_index('sp')
    return full, (slice(i * b, (i + 1) * b), slice(j * s, (j + 1) * s))


def gather_plan(logical_tree: Any, shapes: Any, mesh,
                rules: Optional['LogicalRules'] = None) -> Dict[str, Any]:
    """For each leaf of a params tree, the ``(dim, axes)`` an fsdp gather
    restores before use (a leaf split over fsdp, or the experts over
    fsdp x sp), or None; a stacked layer leaf's dim is counted without
    its 'layers' axis. ``shapes`` is the full tree (tensors or shapes)."""
    sizes = _axis_sizes(mesh)
    world = math.prod(sizes.values())

    def one(axes, shape, stacked):
        spec = spec_for(axes, rules, shape=tuple(shape), mesh=sizes)
        for dim, part in enumerate(spec):
            names = () if part is None else ((part,) if isinstance(
                part, str) else tuple(part))
            gathered = tuple(a for a in names if a in EXPERT_AXES)
            # A one-rank mesh gathers too (each a copy), so it issues
            # the collectives of a wider one.
            if gathered and (math.prod(sizes[a] for a in gathered) > 1
                             or world == 1):
                if gathered != names:
                    raise ValueError(f'axes {axes}: dim {dim} splits over '
                                     f'{names}, of which only {gathered} '
                                     'gather')
                return (dim - 1 if stacked else dim, axes_key(gathered))
        return None

    def walk(axes, shapes_t, stacked):
        if isinstance(axes, dict):
            return {k: walk(axes[k], shapes_t[k], stacked or k == 'layers')
                    for k in axes if k in shapes_t}
        shape = shapes_t.shape if hasattr(shapes_t, 'shape') else shapes_t
        return one(axes, shape, stacked)
    return walk(logical_tree, shapes, False)


def shard_axes(logical_tree: Any, shapes: Any, mesh,
               rules: Optional['LogicalRules'] = None) -> Dict[str, Any]:
    """For each leaf, the set of mesh axes its shards split over
    (:func:`spec_for`, divisibility-aware)."""
    sizes = _axis_sizes(mesh)

    def walk(axes, shapes_t):
        if isinstance(axes, dict):
            return {k: walk(axes[k], shapes_t[k]) for k in axes
                    if k in shapes_t}
        shape = shapes_t.shape if hasattr(shapes_t, 'shape') else shapes_t
        spec = spec_for(axes, rules, shape=tuple(shape), mesh=sizes)
        out = set()
        for part in spec:
            if part is not None:
                out.update((part,) if isinstance(part, str) else part)
        return frozenset(a for a in out if sizes[a] > 1)
    return walk(logical_tree, shapes)


class _Exchange(torch.autograd.Function):
    """Point-to-point sends over one axis's group in ONE batch: tensor
    ``i`` goes to ``perms[i][index]`` and its replacement comes from the
    index that maps to this one. The backward sends the gradients back
    along the inverse maps."""

    @staticmethod
    def forward(ctx, mesh, axis, perms, *xs):
        ctx.mesh, ctx.axis, ctx.perms = mesh, axis, perms
        return _p2p(mesh, axis, perms, xs)

    @staticmethod
    def backward(ctx, *gs):
        inv = tuple({dst: src for src, dst in p.items()}
                    for p in ctx.perms)
        return (None, None, None) + _p2p(ctx.mesh, ctx.axis, inv, gs)


def _p2p(mesh, axis, perms, xs) -> Tuple[torch.Tensor, ...]:
    """One batch of sends and receives over ``axis`` (tag = tensor
    index)."""
    import torch.distributed as dist
    me = mesh.axis_index(axis)
    g = mesh.group(axis)
    members = next(r for r in group_ranks(mesh.shape, axis)
                   if mesh.rank in r)
    outs: List[Optional[torch.Tensor]] = []
    ops = []
    for i, (x, perm) in enumerate(zip(xs, perms)):
        x = x.contiguous()
        dst = perm[me]
        src = next(r for r, d in perm.items() if d == me)
        _note('permute', axis, x)
        if dst == me:
            outs.append(x.clone())
            continue
        buf = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, members[dst], group=g, tag=i))
        ops.append(dist.P2POp(dist.irecv, buf, members[src], group=g,
                              tag=i))
        outs.append(buf)
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return tuple(outs)


def exchange(xs: Sequence[torch.Tensor], perms: Sequence[Dict[int, int]],
             axis: str = 'sp') -> Tuple[torch.Tensor, ...]:
    """Send each of ``xs`` over the active training mesh's ``axis`` group
    to the index its map in ``perms`` names ({src: dst} over that axis),
    receiving its counterpart; differentiable (the gradients travel back
    along the inverse maps). All in one batch of sends."""
    sc = training()
    return _Exchange.apply(sc.mesh, axis, tuple(dict(p) for p in perms),
                           *xs)


class _AllToAll(torch.autograd.Function):
    """All-to-all over sp of several tensors in one collective: tensor
    ``i``'s ``split_dim`` is cut into sp blocks, block ``j`` goes to sp
    rank ``j``, and the blocks received are concatenated along
    ``concat_dim`` in rank order. The backward is the reverse
    all-to-all."""

    @staticmethod
    def forward(ctx, mesh, split_dim, concat_dim, *xs):
        ctx.mesh, ctx.dims = mesh, (split_dim, concat_dim)
        return _a2a(mesh, split_dim, concat_dim, xs)

    @staticmethod
    def backward(ctx, *gs):
        split_dim, concat_dim = ctx.dims
        return (None, None, None) + _a2a(ctx.mesh, concat_dim, split_dim,
                                         gs)


def _a2a(mesh, split_dim, concat_dim, xs) -> Tuple[torch.Tensor, ...]:
    import torch.distributed as dist
    n = mesh.axis_size('sp')
    blocks = [list(x.chunk(n, dim=split_dim)) for x in xs]
    shapes = [b[0].shape for b in blocks]
    send = torch.cat([torch.cat([b[j].reshape(-1) for b in blocks])
                      for j in range(n)])
    if not _note('all_to_all', 'sp', send):
        recv = send
    elif mesh.group('sp') is None:
        recv = send
    else:
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=mesh.group('sp'))
    per = recv.numel() // n
    out = []
    off = 0
    for shape in shapes:
        m = math.prod(shape)
        out.append(torch.cat([recv[j * per + off:j * per + off + m]
                              .view(shape) for j in range(n)],
                             dim=concat_dim))
        off += m
    return tuple(out)


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int) -> Tuple[torch.Tensor, ...]:
    """The differentiable all-to-all of ``xs`` over the active training
    mesh's sp group (see :class:`_AllToAll`)."""
    sc = training()
    return _AllToAll.apply(sc.mesh, split_dim, concat_dim, *xs)


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
    """One rank's view of a mesh, serving (tp, dp) or training (all six
    axes; the name is the serving mesh's, which came first): its rank
    and coordinates, its device, its process group over each axis
    combination of :data:`GROUP_AXES`, and (on rank 0) the follower
    processes it started and the control channel. ``store_path`` is the rendezvous: a file path (a
    ``FileStore`` on one host) or a ``tcp://host:port`` URL (rank 0
    hosts the store; :func:`gang_mesh`). ``local_rank`` names this
    rank's card on its host (default: ``rank``)."""

    def __init__(self, spec: MeshSpec, rank: int, device_type: str,
                 store_path: str, timeout_s: float, procs=(),
                 tmpdir: Optional[str] = None,
                 local_rank: Optional[int] = None,
                 startup_timeout_s: Optional[float] = None):
        import torch.distributed as dist
        self.spec = spec
        self.rank = rank
        self.size = spec.num_devices
        self.shape = dict(zip(MESH_AXES, spec.shape))
        self.coords = _coords(self.shape, rank)
        self.tp_rank, self.dp_rank = self.coords['tp'], self.coords['dp']
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
        # The start-up rendezvous waits ``startup_timeout_s`` (default:
        # the mesh's timeout) for every rank's process to come up; the
        # groups made after it carry the mesh's own timeout.
        kw: Dict[str, Any] = dict(
            backend='nccl' if device_type == 'cuda' else 'gloo',
            init_method=(store_path if '://' in store_path
                         else f'file://{store_path}'),
            world_size=self.size,
            rank=rank, timeout=datetime.timedelta(
                seconds=startup_timeout_s or self.timeout_s))
        if device_type == 'cuda':
            torch.cuda.set_device(self.device)
            kw['device_id'] = self.device
        _reset_group_names()
        dist.init_process_group(**kw)
        # One group per axis combination with more than one rank (every
        # rank takes part in creating each, in the same order). A
        # one-rank mesh runs every axis on the world group, so its
        # collectives are issued (each a copy); a one-rank axis of a
        # larger mesh has no group and its collectives copy nothing.
        self._groups: Dict[Tuple[str, ...], Any] = {}
        for axes in GROUP_AXES:
            lists = group_ranks(self.shape, axes)
            if self.size == 1:
                self._groups[axes] = dist.group.WORLD
            elif len(lists[0]) > 1:
                self._groups[axes], _ = dist.new_subgroups_by_enumeration(
                    lists, timeout=timeout)
        self._ctrl = dist.new_group(backend='gloo', timeout=timeout)
        # The doorbell: an idle follower waits here for rank 0's next
        # message (rank 0's pinger keeps the wait alive, :meth:`_ping`).
        self._bell = dist.new_group(backend='gloo', timeout=timeout)
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
        self._stop_ping = threading.Event()
        if self.is_leader and self.size > 1:
            threading.Thread(target=self._ping, name='mesh-doorbell',
                             daemon=True).start()

    # ----------------------------------------------------------- queries
    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def group(self, axis):
        """The process group of this rank over ``axis`` (a name or a
        tuple of names), or None when those axes hold one rank of a
        larger mesh (a collective over them copies nothing)."""
        key = axes_key(axis)
        if key not in GROUP_AXES:
            raise ValueError(f'no process group for mesh axes {key!r}')
        return self._groups.get(key)

    def axis_size(self, axis) -> int:
        """Ranks over ``axis`` (a name or a tuple of names)."""
        return math.prod(self.shape[a] for a in axes_key(axis))

    def axis_index(self, axis) -> int:
        """This rank's index over ``axis`` (a name or a tuple of names:
        the row-major index, its rank in that group)."""
        idx = 0
        for a in axes_key(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    @property
    def is_serving(self) -> bool:
        """Whether this is a serving layout: (tp, dp) only."""
        return all(self.shape[a] == 1 for a in
                   ('slice', 'pp', 'fsdp', 'sp'))

    def __repr__(self) -> str:
        shape = ', '.join(f'{a}={n}' for a, n in self.shape.items()
                          if n > 1 or a in ('dp', 'tp'))
        return (f'ServingMesh({shape}, rank={self.rank}, '
                f'device={self.device})')

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
        """Rank 0: one control message to every follower (on the
        doorbell, within the mesh's timeout)."""
        import torch.distributed as dist
        if self.size == 1:
            return
        self.check_followers()
        try:
            dist.broadcast_object_list([_to_wire(msg)], src=0,
                                       group=self._bell)
        except Exception as e:
            self.broken = f'control broadcast failed: {e}'
            self.check_followers()
            raise FollowerDied(self.broken) from e

    def recv(self) -> Tuple:
        """A follower: the next control message from rank 0 other than
        a ping. A doorbell that breaks (rank 0 gone) or stays silent
        for the mesh's timeout (rank 0 stalled, its host lost) raises
        :class:`FollowerDied`."""
        import torch.distributed as dist
        while True:
            box = [None]
            try:
                dist.broadcast_object_list(box, src=0, group=self._bell)
            except Exception as e:
                self.broken = f'rank 0 is gone: {e}'
                raise FollowerDied(self.broken) from e
            if box[0][0] != 'ping':
                return box[0]

    def _ping(self) -> None:
        """Rank 0's pinger thread: ring the doorbell with a no-op every
        ``PING_FRACTION`` of the timeout while the mesh is idle (the
        mesh lock held, so a ring never falls inside a call). A ring
        that fails marks the mesh broken; the next call raises
        :class:`FollowerDied`."""
        while not self._stop_ping.wait(self.timeout_s * PING_FRACTION):
            with self._lock:
                if self.closed or self.broken:
                    return
                try:
                    self.send(('ping',))
                except FollowerDied:
                    return

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
            with self._lock:
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
        self._stop_ping.set()
        leads = self.is_leader and self.size > 1
        with self._lock:                 # no ring after the stop
            self.closed = True
            try:
                if leads and not self.broken:
                    self.send(('stop',))
            except FollowerDied:
                pass
        if leads:
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
    """Build the mesh of ``spec`` (serving or training) on ``device``'s
    type (one rank per CUDA device, or per process on the CPU): start the
    followers
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
         '--rank', str(r), '--shape', ','.join(map(str, spec.shape)),
         '--device-type', device_type, '--store', store_path,
         '--timeout-s', str(timeout_s), '--threads', str(threads or 1)],
        env=env, stdin=subprocess.DEVNULL) for r in range(1, n)]
    try:
        return ServingMesh(spec, 0, device_type, store_path, timeout_s,
                           procs, tmpdir, startup_timeout_s=max(
                               timeout_s, STARTUP_TIMEOUT_S))
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


def _reset_group_names() -> None:
    """With no process group up, restart torch's per-process group counter
    at 0. torch names each group from that counter and resets it only when
    a world is destroyed; an ``init_process_group`` that failed (a peer that
    never came) leaves it raised, and this process's next default group
    would then be named otherwise than its peers' (fresh processes count
    from 0): their rendezvous would never meet."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d
    if not dist.is_initialized():
        distributed_c10d._world.group_count = 0


def _init_default_group(addr: str, rank: int, world: int,
                        timeout_s: float, device) -> bool:
    """Join the default process group at ``tcp://addr`` (idempotent:
    True at once when one is up). A rendezvous that does not complete
    within ``timeout_s`` or a connect failure raises."""
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    _reset_group_names()
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


def launched_mesh(spec: MeshSpec, *, device='cuda',
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> ServingMesh:
    """This node's rank of the training mesh of a launched multi-node job
    (the training launch contract: ``SKYTPU_COORDINATOR_ADDRESS``
    ``host:port``, ``SKYTPU_NUM_NODES``, ``SKYTPU_NODE_RANK``; one
    process a node, on its ``LOCAL_RANK`` card), met at
    ``tcp://SKYTPU_COORDINATOR_ADDRESS`` (node 0 hosts the store).
    Nothing is spawned: node 0 leads, and a nonzero rank runs
    ``parallel/follower.py``'s loop on the mesh returned. ``spec`` must
    have one rank a node."""
    import torch.distributed as dist
    coord = os.environ.get('SKYTPU_COORDINATOR_ADDRESS')
    nodes = int(os.environ.get('SKYTPU_NUM_NODES', '1') or 1)
    if not coord:
        raise RuntimeError('launched_mesh needs SKYTPU_COORDINATOR_ADDRESS')
    if spec.num_devices != nodes:
        raise ValueError(f'mesh {spec.shape} has {spec.num_devices} ranks '
                         f'but the job has {nodes} nodes')
    _backend(device)
    if dist.is_initialized():
        raise RuntimeError('a process group is already up in this process')
    rank = int(os.environ.get('SKYTPU_NODE_RANK', '0') or 0)
    return ServingMesh(spec, rank, torch.device(device).type,
                       f'tcp://{coord}', timeout_s,
                       local_rank=int(os.environ.get('LOCAL_RANK', '0')))


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
        if not mesh.is_serving:
            raise ValueError(
                f'{type(self).__name__} serves on a (tp, dp) mesh '
                f'(MeshSpec.for_serving); {mesh!r} has training axes '
                '(fsdp, sp, pp or slices)')
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
