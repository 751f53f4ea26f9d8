"""Static per-dispatch cost model (port of
``skypilot_tpu/analysis/costmodel.py``, for eager PyTorch).

Prices a device program from the ATen ops it dispatches: device-memory
bytes read and written **by operand class** (int4/int8/bf16 weight
bytes, their scales, KV-pool bytes and scales, page tables,
activations, the adapter bank), and FLOPs. Three consumers, as in the
reference:

1. **Byte-budget gate**: every default audit preset declares a
   per-dispatch read budget per class (:data:`BYTE_BUDGETS`); a
   dispatch that reads more fails the audit, naming the ops that read
   the most (an extra pool sweep, a weight widened where it was not).
2. **Rooflines**: :func:`roofline_step_bytes` gives the bytes one decode
   step must read (its floor) beside what the port's program traces to,
   from abstract traces on the meta device (no weights materialised, so
   a 70B costs no memory); :func:`kv_static_check` holds the static KV
   bytes per token to the ``skytpu_kv_read_bytes_per_step`` gauge's
   ``kv_token_bytes`` within :data:`KV_TOLERANCE`.
3. ``python -m skypilot_tpu_torch.analysis costmodel`` prints the
   attribution table of a preset.

Modelling contract. XLA fuses; eager PyTorch does not, so the port is
priced at what eager really moves:

- ops are recorded by a ``TorchDispatchMode`` (:class:`Recorder`), which
  sees every ATen op a program dispatches; operand classes are tracked
  by storage identity (a view shares its base's class; ``data_ptr()``
  would not do, it is 0 for every meta tensor);
- a view (``view``, a contiguous ``reshape``, ``permute``, ``slice``,
  ``select``, ``expand``, ``unsqueeze``, ...) is free;
- the gather family (``index_select``, ``gather``, advanced indexing,
  ``embedding``) reads only the rows it returns, plus its indices;
- in-place scatters (``index_copy_``, ``index_put_``, ``scatter_``,
  ``copy_`` into a slice, ``fill_``) read and write only their updates;
- every other op reads its inputs (each distinct one once) and writes
  its outputs; ``mm``, ``bmm``, ``addmm`` and ``_int_mm`` count
  ``2*m*n*k`` FLOPs, reductions their input elements, other ops their
  output elements;
- an op's output takes the highest-priority class of its inputs
  (:data:`_PRIORITY`; a mix with activations is an activation), and a
  matmul's output is an activation. So ``qeinsum``'s widening of int8
  or int4 codes on every call bills the codes it reads, the copy it
  writes and that copy read again by the matmul, all in the weight's
  class: the excess over the floor shows in the weight classes;
- hand-written kernels are opaque (``ops/cost.py``): each entry point
  records one entry priced by its contract, whether the kernel, its
  plain version or a meta stub runs. The paged kernels' pool operands
  count each slot's pages up to its length, of one layer per call for
  the entries in ``ops.paged_attention.COST_KERNEL_KV_TRAFFIC`` (K1,
  K2) and of every layer for K6; K3 counts each row's valid cache rows.
  The lengths are host values (:meth:`Recorder.set_values`): the
  paged engine's staged lengths for a captured call, ``avg_ctx`` for
  an abstract one. Where they are not known (the slot engine's, or a
  length the program has written since), a contract prices the
  operand's bucketed width and says so in its note.

A trace also lists what a device program must never do: read a value
on the host (``aten._local_scalar_dense``, a copy to the CPU) or
compute in float64. On meta tensors a host read returns a placeholder
so the trace goes on; the audit reports it as a violation.

KV bytes per token: the pool's stored bytes over its token capacity,
the same quantity the gauge publishes, so the static model and the
telemetry are held to each other.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from skypilot_tpu_torch.ops import cost as kernel_cost
from skypilot_tpu_torch.parallel import mesh as mesh_lib

# ------------------------------------------------------------- classes
# Operand-class taxonomy. Priority decides the class of a mixed-operand
# result: KV beats weights beats tables beats activations, so a dequant
# chain (codes x scale) keeps its weight class until a matmul turns it
# into an activation.
WEIGHT_BF16 = 'weight_bf16'      # unquantized weight leaves (+ norms)
WEIGHT_INT8 = 'weight_int8'      # QuantizedWeight codes
WEIGHT_INT4 = 'weight_int4'      # QuantizedWeight4 packed nibbles
WEIGHT_SCALE = 'weight_scale'    # per-channel/group dequant scales
KV_POOL = 'kv_pool'              # cache k/v rows (any kv dtype)
KV_SCALE = 'kv_scale'            # per-row kv dequant scales
TABLE = 'table'                  # page tables, lengths, tokens, masks
ACTIVATION = 'activation'        # everything flowing between layers
CONST = 'const'                  # literals, tensors made in the program
ADAPTER = 'adapter_bank'         # multi-LoRA bank factors + scales

ALL_CLASSES = (WEIGHT_BF16, WEIGHT_INT8, WEIGHT_INT4, WEIGHT_SCALE,
               KV_POOL, KV_SCALE, ADAPTER, TABLE, ACTIVATION, CONST)
WEIGHT_CLASSES = (WEIGHT_BF16, WEIGHT_INT8, WEIGHT_INT4, WEIGHT_SCALE)

_PRIORITY = {KV_POOL: 8, KV_SCALE: 7, WEIGHT_INT4: 6, WEIGHT_INT8: 5,
             WEIGHT_BF16: 4, WEIGHT_SCALE: 3, ADAPTER: 2.5, TABLE: 2,
             ACTIVATION: 1, CONST: 0}

# Measured-vs-static tolerance for KV read bytes/step.
KV_TOLERANCE = 0.10

# Headroom the budget generator adds over the traced value: wide enough
# for trace-detail drift across PyTorch releases, narrow enough that
# the cheapest real regression (a weight stream widened to bf16, 2x or
# more) cannot hide under it.
BUDGET_HEADROOM = 1.25

# Bytes a class ABSENT from a budget entry may reach before it violates:
# a budget lists every stream the dispatch is supposed to have.
UNBUDGETED_FLOOR = 256 * 1024


# --------------------------------------------------------------- costs
@dataclasses.dataclass
class EqnCost:
    """One recorded op's priced traffic (``prim`` is the ATen op, or
    ``kernel:<entry point>``; ``site`` the Python line that issued
    it)."""
    prim: str
    read: Dict[str, int]
    written: Dict[str, int]
    flops: int = 0
    collective: Dict[str, int] = dataclasses.field(default_factory=dict)
    note: str = ''
    site: str = ''

    @property
    def read_total(self) -> int:
        return sum(self.read.values())

    def describe(self) -> str:
        parts = [f'{c}={v:,}B' for c, v in sorted(
            self.read.items(), key=lambda kv: -kv[1]) if v]
        where = f' at {self.site}' if self.site else ''
        tail = f' ({self.note})' if self.note else ''
        return (f'{self.prim}{where}: read ' + (', '.join(parts) or '0B')
                + tail)


@dataclasses.dataclass
class DispatchCost:
    """Totals for ONE dispatch (one captured device program: a decode
    call's steps, its merge, a speculative round)."""
    label: str
    eqns: List[EqnCost] = dataclasses.field(default_factory=list)
    read: Dict[str, int] = dataclasses.field(default_factory=dict)
    written: Dict[str, int] = dataclasses.field(default_factory=dict)
    flops: int = 0
    collective: Dict[str, int] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)
    # Stored KV bytes per cached token from the pool's tensors over its
    # token capacity (set at engine boundaries): the telemetry form.
    kv_bytes_per_token: Optional[float] = None
    kv_token_capacity: Optional[int] = None
    # Host reads and float64 results inside the program, with where
    # each was issued: violations for an audit.
    host_reads: List[str] = dataclasses.field(default_factory=list)
    f64_promotions: List[str] = dataclasses.field(default_factory=list)

    def add(self, eqn: EqnCost) -> None:
        self.eqns.append(eqn)
        for c, v in eqn.read.items():
            self.read[c] = self.read.get(c, 0) + v
        for c, v in eqn.written.items():
            self.written[c] = self.written.get(c, 0) + v
        self.flops += eqn.flops
        for ax, v in eqn.collective.items():
            self.collective[ax] = self.collective.get(ax, 0) + v

    @property
    def read_total(self) -> int:
        return sum(self.read.values())

    @property
    def written_total(self) -> int:
        return sum(self.written.values())

    def weight_bytes(self) -> int:
        """The traced weight stream (codes + scales + unquantized
        leaves, widened copies included)."""
        return sum(self.read.get(c, 0) for c in WEIGHT_CLASSES)

    def kv_read_bytes_per_step(self, live_tokens: int) -> float:
        """Static KV bytes one decode substep streams for
        ``live_tokens`` of resident context: the quantity the
        ``skytpu_kv_read_bytes_per_step`` gauge measures."""
        if self.kv_bytes_per_token is None:
            raise ValueError(f'{self.label}: no KV capacity annotation')
        return live_tokens * self.kv_bytes_per_token

    def top_eqns(self, cls: str, n: int = 3) -> List[EqnCost]:
        ranked = sorted((e for e in self.eqns if e.read.get(cls, 0)),
                        key=lambda e: -e.read[cls])
        return ranked[:n]

    def format_table(self) -> str:
        lines = [f'dispatch [{self.label}]: {self.read_total:,} B '
                 f'read, {self.written_total:,} B written, '
                 f'{self.flops:,} FLOPs, {len(self.eqns)} priced ops']
        for c in ALL_CLASSES:
            r, w = self.read.get(c, 0), self.written.get(c, 0)
            if r or w:
                lines.append(f'  {c:<13} read {r:>14,} B   '
                             f'written {w:>14,} B')
        for ax, v in sorted(self.collective.items()):
            lines.append(f'  collective[{ax}] {v:,} B')
        if self.kv_bytes_per_token is not None:
            lines.append(f'  kv stored bytes/token: '
                         f'{self.kv_bytes_per_token:,.1f} '
                         f'(pool capacity {self.kv_token_capacity:,} '
                         'tokens)')
        for n_ in self.notes:
            lines.append(f'  note: {n_}')
        for h in self.host_reads:
            lines.append(f'  HOST READ: {h}')
        for f in self.f64_promotions:
            lines.append(f'  FLOAT64: {f}')
        return '\n'.join(lines)

    def to_json(self) -> Dict[str, Any]:
        return {
            'label': self.label,
            'read_bytes': dict(self.read),
            'written_bytes': dict(self.written),
            'flops': self.flops,
            'collective_bytes': dict(self.collective),
            'kv_bytes_per_token': self.kv_bytes_per_token,
            'kv_token_capacity': self.kv_token_capacity,
            'notes': list(self.notes),
            'top_eqns': {c: [e.describe() for e in self.top_eqns(c)]
                         for c in ALL_CLASSES if self.read.get(c)},
        }


def _acc(d: Dict[str, int], cls: str, v: int) -> None:
    if v:
        d[cls] = d.get(cls, 0) + int(v)


def _out_class(matmul: bool, in_classes: Sequence[str]) -> str:
    cs = [c for c in in_classes if c != CONST]
    if matmul:
        return ACTIVATION
    if not cs:
        return CONST
    if len(set(cs)) > 1 and ACTIVATION in cs:
        return ACTIVATION
    return max(cs, key=lambda c: _PRIORITY[c])


# --------------------------------------------------- the recorder
# Ops that move nothing: allocation without a write, aliasing.
_FREE_OPS = {'detach', 'alias', 'lift_fresh', '_unsafe_view',
             '_reshape_alias', 'empty', 'empty_like', 'empty_strided',
             'new_empty', 'new_empty_strided', 'set_', 'resize_',
             'record_stream'}
_MATMUL_OPS = {'mm', 'bmm', 'addmm', 'baddbmm', '_int_mm', 'mv', 'dot',
               'addmv', 'addbmm'}
# Gather family: op -> (operand index, index-argument positions).
_GATHER_OPS = {'index_select': (0, (2,)), 'gather': (0, (2,)),
               'index': (0, (1,)), 'embedding': (0, (1,)),
               'take': (0, (1,))}
# In-place scatters: op -> position of the updates (None: a scalar).
_SCATTER_OPS = {'index_copy_': 3, 'index_add_': 3, 'index_put_': 2,
                '_index_put_impl_': 2, 'scatter_': 3, 'scatter_add_': 3,
                'scatter_reduce_': 3, 'masked_scatter_': 2, 'copy_': 1,
                'fill_': None, 'zero_': None, 'index_fill_': None,
                'masked_fill_': None}
_REDUCE_OPS = {'sum', 'mean', 'amax', 'amin', 'max', 'min', 'argmax',
               'argmin', 'prod', 'any', 'all', 'var', 'std', 'norm',
               'logsumexp', 'var_mean', 'std_mean', 'cumsum', 'sort',
               'topk'}
_HOST_READ_OPS = {'_local_scalar_dense', 'item'}
# The recorder's own frames, skipped when naming where an op came from.
_SKIP_FILES = (os.path.join('analysis', 'costmodel.py'),
               os.path.join('ops', 'cost.py'))
_TORCH_DIR = os.path.dirname(torch.__file__)


def _site() -> str:
    """The innermost Python frame outside torch and the recorder:
    where the op was issued, as ``file:line (function)``."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_TORCH_DIR) and not fn.endswith(_SKIP_FILES):
            short = fn.split('skypilot_tpu_torch' + os.sep, 1)[-1]
            return f'{os.path.basename(short) if short == fn else short}' \
                   f':{f.f_lineno} ({f.f_code.co_name})'
        f = f.f_back
    return '<unknown>'


def _storage_key(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):  # no storage (sparse ...)
        return id(t)


def _view_key(t: torch.Tensor) -> Tuple:
    return (_storage_key(t), t.storage_offset(), tuple(t.shape),
            tuple(t.stride()))


def _tensor_bytes(t: torch.Tensor) -> int:
    """Distinct elements a read of ``t`` touches (broadcast dims count
    once) times the element size."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _placeholder(dtype: torch.dtype):
    if dtype == torch.bool:
        return False
    return 0.0 if dtype.is_floating_point else 0


class Recorder(TorchDispatchMode):
    """Records the ATen ops a program dispatches into per-label
    :class:`DispatchCost` entries. ``stands_for``: the device type
    whose program a meta trace prices (``'cpu'`` or ``'cuda'``, read by
    ``ops.cost.device_type``). Ops outside :meth:`label` propagate
    classes but are not billed. Storages seen are kept alive for the
    recorder's lifetime, so a storage key is never reused."""

    def __init__(self, stands_for: str = 'cpu'):
        super().__init__()
        if stands_for not in ('cpu', 'cuda'):
            raise ValueError(f'stands_for must be cpu or cuda, got '
                             f'{stands_for!r}')
        self.stands_for = stands_for
        self.costs: Dict[str, DispatchCost] = {}
        self.current: Optional[DispatchCost] = None
        self._classes: Dict[int, str] = {}
        self._values: Dict[Tuple, List[int]] = {}
        self._keep: List[Any] = []
        self._opaque = 0
        self._prev = None

    # ------------------------------------------------------- classes
    def class_of(self, t: torch.Tensor) -> str:
        return self._classes.get(_storage_key(t), CONST)

    def _set_class(self, t: torch.Tensor, cls: str) -> None:
        key = _storage_key(t)
        if key not in self._classes:
            self._keep.append(t.untyped_storage() if key != id(t) else t)
        self._classes[key] = cls

    def register(self, tree, classes) -> None:
        """Label the tensors of ``tree`` with the mirrored ``classes``
        (a storage shared by two classes keeps the higher priority)."""
        for t, cls in tree_pairs(tree, classes):
            have = self._classes.get(_storage_key(t))
            if have is None or _PRIORITY[cls] > _PRIORITY[have]:
                self._set_class(t, cls)

    # ------------------------------------------------------- values
    def set_values(self, t: torch.Tensor, values) -> None:
        """The host-known values of ``t`` (the lengths an engine staged),
        read by the kernels' contracts (``ops.cost.host_values``) until
        an op writes ``t``'s storage."""
        self._keep.append(t)
        self._values[_view_key(t)] = [int(v) for v in values]

    def values_of(self, t: torch.Tensor) -> Optional[List[int]]:
        return self._values.get(_view_key(t))

    def _forget_written(self, func, args, kwargs) -> None:
        written = {_storage_key(t)
                   for i, a in enumerate(func._schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write
                   for t in _tensors(args[i] if i < len(args)
                                     else kwargs.get(a.name))}
        if written:
            self._values = {k: v for k, v in self._values.items()
                            if k[0] not in written}

    # ------------------------------------------------------ contexts
    @contextlib.contextmanager
    def label(self, name: str):
        """Bill the ops issued inside to the dispatch ``name``."""
        prev = self.current
        self.current = self.costs.setdefault(name, DispatchCost(label=name))
        try:
            yield self.current
        finally:
            self.current = prev

    @contextlib.contextmanager
    def opaque(self):
        """Ops issued inside are neither billed nor checked (a kernel's
        plain version, priced by its contract instead)."""
        self._opaque += 1
        try:
            yield
        finally:
            self._opaque -= 1

    def __enter__(self):
        self._prev = kernel_cost.set_recorder(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_cost.set_recorder(self._prev)
        return super().__exit__(*exc)

    # ------------------------------------------------------- kernels
    def kernel_entry(self, name: str, contract, out) -> None:
        """One kernel call, priced by its contract (``ops.cost``)."""
        ins = [self.class_of(t) for t, _ in contract.reads]
        out_cls = _out_class(False, ins)
        outs = _tensors(out)
        for t in outs:
            self._set_class(t, out_cls)
        if self.current is None:
            return
        read: Dict[str, int] = {}
        for (t, b), cls in zip(contract.reads, ins):
            _acc(read, cls, b)
        written: Dict[str, int] = {}
        for t in outs:
            _acc(written, out_cls, t.numel() * t.element_size())
        self.current.add(EqnCost(prim=f'kernel:{name}', read=read,
                                 written=written, flops=contract.flops,
                                 note=contract.note, site=_site()))

    def collective_entry(self, op: str, axis: str, t: torch.Tensor) -> None:
        """One collective of a serving mesh (``parallel/mesh.py``): the
        bytes of this rank's operand, billed to ``collective[axis]``
        (not to a read class: the budget holds them as
        ``collective.<axis>``)."""
        if self.current is None:
            return
        self.current.add(EqnCost(prim=f'collective:{op}', read={},
                                 written={},
                                 collective={axis: _tensor_bytes(t)},
                                 site=_site()))

    # ------------------------------------------------------ dispatch
    def _violation(self, kind: str, what: str) -> None:
        if self.current is not None:
            getattr(self.current, kind).append(f'{what} at {_site()}')

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._opaque:
            return func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _HOST_READ_OPS:
            self._violation('host_reads', f'aten.{name}')
            if args[0].device.type == 'meta':
                return _placeholder(args[0].dtype)
            return func(*args, **kwargs)
        if name in ('_to_copy', 'copy_'):
            src = args[1] if name == 'copy_' else args[0]
            dst_dev = (args[0].device if name == 'copy_'
                       else kwargs.get('device') or src.device)
            if (torch.device(dst_dev).type == 'cpu'
                    and src.device.type != 'cpu'):
                self._violation('host_reads', f'aten.{name} to the CPU')
                if src.device.type == 'meta':
                    if name == 'copy_':
                        return args[0]
                    return torch.empty(
                        src.shape, dtype=kwargs.get('dtype') or src.dtype)
        out = func(*args, **kwargs)
        if self._values:
            self._forget_written(func, args, kwargs)
        outs = _tensors(out)
        if any(t.dtype == torch.float64 for t in outs):
            self._violation('f64_promotions', f'aten.{name} -> float64')
        if func.is_view or name in _FREE_OPS:
            return out
        self._price(func, name, args, kwargs, outs)
        return out

    def _price(self, func, name, args, kwargs, outs) -> None:
        in_ts = []
        seen = set()
        for t in _tensors(list(args) + list(kwargs.values())):
            key = (_storage_key(t), t.storage_offset(), tuple(t.shape),
                   tuple(t.stride()), t.dtype)
            if key not in seen:
                seen.add(key)
                in_ts.append(t)
        mutated = [args[i] for i, a in enumerate(func._schema.arguments)
                   if i < len(args) and a.alias_info is not None
                   and a.alias_info.is_write and torch.is_tensor(args[i])]
        read: Dict[str, int] = {}
        written: Dict[str, int] = {}
        flops = 0
        if name in _SCATTER_OPS and mutated:
            target = mutated[0]
            pos = _SCATTER_OPS[name]
            upd = args[pos] if pos is not None and pos < len(args) else None
            idx = [t for t in in_ts if t is not target and t is not upd]
            n = self._updated_elems(name, target, args, upd)
            if torch.is_tensor(upd):
                _acc(read, self.class_of(upd), _tensor_bytes(upd))
            for t in idx:
                _acc(read, self.class_of(t), _tensor_bytes(t))
            cls = self.class_of(target)
            if cls == CONST and torch.is_tensor(upd):
                cls = self.class_of(upd)
                self._set_class(target, cls)
            _acc(written, cls, n * target.element_size())
            flops = n
            note = 'in-place update: updates bytes only'
        elif name in _GATHER_OPS:
            opr_i, idx_i = _GATHER_OPS[name]
            opr = args[opr_i]
            out_b = sum(t.numel() * t.element_size() for t in outs)
            cls = self.class_of(opr)
            _acc(read, cls, out_b)
            for i in idx_i:
                for t in _tensors(args[i] if i < len(args) else None):
                    _acc(read, self.class_of(t), _tensor_bytes(t))
            for t in outs:
                self._set_class(t, cls)
            _acc(written, cls, out_b)
            flops = sum(t.numel() for t in outs)
            note = 'gather: rows returned only'
        else:
            in_cls = [self.class_of(t) for t in in_ts]
            for t, cls in zip(in_ts, in_cls):
                _acc(read, cls, _tensor_bytes(t))
            matmul = name in _MATMUL_OPS
            cls = _out_class(matmul, in_cls)
            if mutated:
                for t in mutated:
                    have = self.class_of(t)
                    if have == CONST:
                        self._set_class(t, cls)
                    _acc(written, self.class_of(t),
                         t.numel() * t.element_size())
            else:
                for t in outs:
                    self._set_class(t, cls)
                    _acc(written, cls, t.numel() * t.element_size())
            if matmul:
                flops = _matmul_flops(name, args)
            elif name in _REDUCE_OPS:
                flops = sum(t.numel() for t in in_ts)
            else:
                flops = sum(t.numel() for t in (outs or mutated))
            note = ''
        if self.current is not None:
            self.current.add(EqnCost(prim=f'aten.{name}', read=read,
                                     written=written, flops=flops,
                                     note=note, site=_site()))

    @staticmethod
    def _updated_elems(name, target, args, upd) -> int:
        if name == 'copy_' or name in ('fill_', 'zero_', 'masked_fill_'):
            return target.numel()
        if name in ('scatter_', 'scatter_add_', 'scatter_reduce_'):
            return args[2].numel()
        if name == 'index_fill_':
            dim = args[1] % max(1, target.dim())
            return args[2].numel() * (target.numel()
                                      // max(1, target.shape[dim]))
        if name in ('index_put_', '_index_put_impl_'):
            idx = [i for i in args[1] if i is not None]
            n = 1
            for s in torch.broadcast_shapes(*[i.shape for i in idx]):
                n *= s
            rest = 1
            for s in target.shape[len(args[1]):]:
                rest *= s
            return max(n * rest, upd.numel() if torch.is_tensor(upd)
                       else 0)
        return upd.numel() if torch.is_tensor(upd) else target.numel()


def _matmul_flops(name: str, args) -> int:
    if name in ('addmm', 'baddbmm', 'addmv', 'addbmm'):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    if name in ('mv', 'addmv'):
        return 2 * a.shape[0] * a.shape[1]
    if name == 'dot':
        return 2 * a.shape[0]
    if name in ('bmm', 'baddbmm', 'addbmm'):
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


# ----------------------------------------------- boundary annotations
def tree_pairs(tree, classes):
    """(tensor, class) for every tensor leaf of ``tree`` against the
    mirrored ``classes`` (dicts by key, tuples and lists by position,
    other objects by attribute)."""
    if tree is None or classes is None:
        return
    if torch.is_tensor(tree):
        yield tree, classes
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_pairs(v, classes.get(k))
    elif isinstance(tree, (list, tuple)):
        for v, c in zip(tree, classes):
            yield from tree_pairs(v, c)
    elif hasattr(tree, '__dict__'):
        for k, v in vars(tree).items():
            yield from tree_pairs(v, getattr(classes, k, None))


def _fields(x) -> Optional[Tuple[str, ...]]:
    f = getattr(x, '_fields', None)
    return tuple(f) if f is not None else None


def _classify_class_tree(tree, cls: str) -> Any:
    """Mirror a tree with one uniform operand class on every leaf."""
    if isinstance(tree, dict):
        return {k: _classify_class_tree(v, cls) for k, v in tree.items()}
    f = _fields(tree)
    if f is not None:
        return type(tree)(*(_classify_class_tree(v, cls) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_classify_class_tree(v, cls) for v in tree)
    if tree is None:
        return None
    return cls


def classify_params(tree) -> Any:
    """Mirror a params tree with operand-class labels: quantized leaves
    split into code and scale classes, the multi-LoRA bank (``mlora``)
    is its own class, everything else is the bf16 weight stream. Duck
    typed on the named-tuple fields, as the reference's."""
    f = _fields(tree)
    if f == ('int8', 'scale'):
        return type(tree)(int8=WEIGHT_INT8, scale=WEIGHT_SCALE)
    if f == ('packed', 'scale'):
        return type(tree)(packed=WEIGHT_INT4, scale=WEIGHT_SCALE)
    if isinstance(tree, dict):
        return {k: (_classify_class_tree(v, ADAPTER) if k == 'mlora'
                    else classify_params(v))
                for k, v in tree.items()}
    if f is not None:
        return type(tree)(*(classify_params(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(classify_params(v) for v in tree)
    if tree is None:
        return None
    return WEIGHT_BF16


def classify_cache(cache) -> Any:
    """KV cache -> class labels of the same type: the paged pool
    (``pool_k``/``pool_v`` and optional scales) or the slot cache
    (``k``/``v``, ``length`` and optional scales)."""
    if hasattr(cache, 'pool_k'):
        return type(cache)(
            pool_k=KV_POOL, pool_v=KV_POOL,
            k_scale=None if cache.k_scale is None else KV_SCALE,
            v_scale=None if cache.v_scale is None else KV_SCALE)
    if hasattr(cache, 'length'):
        return type(cache)(
            k=KV_POOL, v=KV_POOL, length=TABLE,
            k_scale=None if cache.k_scale is None else KV_SCALE,
            v_scale=None if cache.v_scale is None else KV_SCALE)
    raise TypeError(f'not a KV cache: {type(cache)!r}')


def classify_aux(x) -> Any:
    """Non-params, non-cache operands: integer and bool tensors are
    control tables (tokens, lengths, page tables, masks), floats are
    activations, and non-tensors get a placeholder."""
    if not torch.is_tensor(x):
        return ACTIVATION
    if x.dtype == torch.bool or not (x.dtype.is_floating_point
                                     or x.dtype.is_complex):
        return TABLE
    return ACTIVATION


def classify_decode_args(args: Sequence[Any]) -> Tuple[Any, ...]:
    """Class labels for a decode dispatch's operands: by the engines'
    convention args[0] is the params tree, args[1] the KV cache, and
    the rest are per-call control and sampling operands."""
    return (classify_params(args[0]), classify_cache(args[1]),
            *(classify_aux(a) for a in args[2:]))


def kv_bytes_per_token(args: Sequence[Any], classes: Sequence[Any],
                       capacity: int, shard_degree: int = 1) -> float:
    """Stored KV bytes/token from the pool's tensors: the kv_pool +
    kv_scale bytes over the pool's token capacity (per shard). The
    quantity ``kv_token_bytes`` computes arithmetically."""
    kv = sum(t.numel() * t.element_size()
             for t, c in tree_pairs(tuple(args), tuple(classes))
             if c in (KV_POOL, KV_SCALE))
    return kv / capacity / max(1, shard_degree)


def class_bytes(tree, classes) -> Dict[str, int]:
    """Stored bytes of ``tree`` per operand class."""
    out: Dict[str, int] = {}
    for t, c in tree_pairs(tree, classes):
        _acc(out, c, t.numel() * t.element_size())
    return out


# ------------------------------------------------------------ tracing
def meta_copy(tree, memo: Optional[Dict[int, Any]] = None):
    """``tree`` with every tensor replaced by a meta tensor of the same
    shape, dtype and strides; tensors sharing a storage share one meta
    storage (views stay views). Dicts, lists, tuples and named tuples
    are rebuilt; other objects are shallow-copied with their
    attributes converted; anything else is shared."""
    memo = {} if memo is None else memo

    def conv(x):
        if torch.is_tensor(x):
            if x.device.type == 'meta':
                return x
            key = _storage_key(x)
            st = memo.get(key)
            if st is None:
                st = memo[key] = torch.UntypedStorage(
                    x.untyped_storage().nbytes(), device='meta')
            return torch.empty(0, dtype=x.dtype, device='meta').set_(
                st, x.storage_offset(), x.shape, x.stride())
        if isinstance(x, dict):
            return type(x)((k, conv(v)) for k, v in x.items())
        if _fields(x) is not None:
            return type(x)(*(conv(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if hasattr(x, '__dict__') and not isinstance(x, type) and any(
                torch.is_tensor(v) for v in vars(x).values()):
            y = copy.copy(x)
            for k, v in vars(x).items():
                setattr(y, k, conv(v))
            if hasattr(y, 'device'):
                y.device = torch.device('meta')
            return y
        return x
    return conv(tree)


def trace_dispatch(fn: Callable, args: Sequence[Any],
                   classes: Sequence[Any], label: str = 'dispatch',
                   stands_for: str = 'cpu',
                   values: Sequence[Tuple[torch.Tensor, Sequence[int]]] = ()
                   ) -> DispatchCost:
    """Run ``fn(*args)`` under a :class:`Recorder` and price it.
    ``args`` may be real or meta tensors (and trees of them);
    ``classes`` mirrors ``args``. ``stands_for``: the device type whose
    program a meta trace prices. ``values``: (tensor, host values)
    pairs for :meth:`Recorder.set_values`."""
    rec = Recorder(stands_for)
    rec.register(tuple(args), tuple(classes))
    for t, v in values:
        rec.set_values(t, v)
    with rec, rec.label(label):
        fn(*args)
    return rec.costs[label]


class Capture:
    """One captured engine dispatch: a shadow of the engine whose
    device state (params, cache, static buffers, token vector) is meta
    copies taken at the capture, and the call to repeat on it. Made by
    the audit at the engine's ``_decode_call`` (``kind='decode'``, key
    (horizon, sample, P or kv_bucket)) or at a speculative graph run
    (``kind='spec'``, key (third, rounds))."""

    def __init__(self, engine, kind: str, key: Tuple):
        from skypilot_tpu_torch.inference.paged import PagedInferenceEngine
        from skypilot_tpu_torch.telemetry.profiler import NullProfiler
        memo: Dict[int, Any] = {}
        sh = copy.copy(engine)
        # Wrappers an audit installed on the engine (over its methods)
        # would run the real engine: the shadow takes the class's own.
        for name, value in list(vars(sh).items()):
            if callable(value) and callable(getattr(type(sh), name, None)):
                delattr(sh, name)
        for name in ('params', 'cache', '_buf', '_tok_dev'):
            setattr(sh, name, meta_copy(getattr(engine, name), memo))
        sh.device = torch.device('meta')
        sh._graphs = None
        sh._gen = torch.Generator()
        sh._prof = NullProfiler()
        self.shadow, self.kind, self.key = sh, kind, tuple(key)
        self.stands_for = engine.device.type
        # The pool lengths the call reads, as the paged engine staged and
        # uploaded them (the slot engine's lengths live on the device
        # only, and the host does not track its free rows').
        self.host_lengths = (engine._buf.staged_lengths()
                             if isinstance(engine, PagedInferenceEngine)
                             else None)


# Graph-key heads -> the reference's dispatch labels.
_LABELS = {'step': 'decode', 'merge': 'merge', 'spec': 'spec_verify',
           'spec_fused': 'spec_fused'}


def engine_dispatch_costs(engine, captures: Sequence[Capture]
                          ) -> Dict[str, DispatchCost]:
    """Price an engine's steady-state dispatches from captures
    (:class:`Capture`), touching neither the engine nor its device
    buffers: each capture's call runs again on its meta shadow under a
    recorder, the graph bodies billed to their labels ('decode' for the
    horizon's steps, 'merge' for the ring merge, 'spec_verify' or
    'spec_fused' for a speculative call). A CUDA graph replay
    dispatches no ATen op, and running the body on the real buffers
    would write the ring and the pool, so neither is traced. The
    'decode' cost carries the pool's stored KV bytes per token."""
    out: Dict[str, DispatchCost] = {}
    for cap in captures:
        sh = cap.shadow
        rec = Recorder(cap.stands_for)
        args = sh.decode_args()
        rec.register(args, sh.decode_operand_classes(args))
        if cap.host_lengths is not None:
            rec.set_values(sh._buf.lengths, cap.host_lengths)

        def run_graph(key, body, sample=False, rec=rec):
            with rec.label(_LABELS[key[0]]):
                body()

        sh._run_graph = run_graph
        # A mesh engine's program runs in its mesh scope, where the
        # collectives price their bytes per axis instead of moving them.
        scope = (mesh_lib.scope(engine.mesh, engine._tp_plan)
                 if getattr(engine, 'mesh', None) is not None
                 else contextlib.nullcontext())
        with rec, scope:
            if cap.kind == 'decode':
                sh._decode_call(*cap.key)
            else:
                third, rounds = cap.key
                sh._spec_run(third, sh._spec_verify_fn(third), rounds)
        out.update(rec.costs)
        if 'decode' in rec.costs:
            cost = rec.costs['decode']
            cost.kv_token_capacity = engine.kv_token_capacity()
            cost.kv_bytes_per_token = kv_bytes_per_token(
                (args[1],), (classify_cache(args[1]),),
                cost.kv_token_capacity)
    return out


# ------------------------------------------------------------- budgets
def budget_from_costs(costs: Dict[str, DispatchCost],
                      headroom: float = BUDGET_HEADROOM
                      ) -> Dict[str, Dict[str, int]]:
    """A budget dict from traced costs (the generator behind
    :data:`BYTE_BUDGETS`): per dispatch label, a read-bytes ceiling per
    operand class (and 'collective.<axis>' ceilings)."""
    out: Dict[str, Dict[str, int]] = {}
    for label, cost in sorted(costs.items()):
        entry: Dict[str, int] = {}
        for c, v in sorted(cost.read.items()):
            entry[c] = int(v * headroom)
        for ax, v in sorted(cost.collective.items()):
            entry[f'collective.{ax}'] = int(v * headroom)
        out[label] = entry
    return out


def check_budget(costs: Dict[str, DispatchCost],
                 budget: Dict[str, Dict[str, int]]) -> List[str]:
    """Budget gate: every budgeted dispatch must exist, stay under its
    per-class read ceilings (and collective ceilings), and grow no
    unbudgeted stream past :data:`UNBUDGETED_FLOOR`. Violations name the
    ops that read the most of the offending class."""
    out: List[str] = []
    for label, caps in sorted(budget.items()):
        cost = costs.get(label)
        if cost is None:
            out.append(f'{label}: budgeted dispatch was never '
                       'captured (decode path changed?)')
            continue
        class_caps = {k: v for k, v in caps.items()
                      if not k.startswith('collective.')}
        for cls in sorted(set(cost.read) | set(class_caps)):
            cap = class_caps.get(cls, UNBUDGETED_FLOOR)
            got = cost.read.get(cls, 0)
            if got <= cap:
                continue
            tag = ('' if cls in class_caps
                   else ' [unbudgeted stream]')
            msg = (f'{label}: {cls} reads {got:,} B > budget '
                   f'{cap:,} B{tag}')
            for e in cost.top_eqns(cls):
                msg += f'\n      {e.describe()}'
            out.append(msg)
        for key, cap in sorted(caps.items()):
            if not key.startswith('collective.'):
                continue
            ax = key[len('collective.'):]
            got = cost.collective.get(ax, 0)
            if got > cap:
                out.append(f'{label}: collective[{ax}] moves '
                           f'{got:,} B > budget {cap:,} B')
    return out


def budget_key(preset: str, device_type: str = 'cpu') -> str:
    """The :data:`BYTE_BUDGETS` key of a preset's program: the preset's
    name on the CPU, ``<preset>@cuda`` on the card (a paged preset
    resolves ``auto`` to ``gather`` on the CPU and to K1 on the card:
    two programs, two budgets)."""
    return preset if device_type == 'cpu' else f'{preset}@{device_type}'


# Per-preset byte budgets: read-bytes ceilings per dispatch label and
# operand class, BUDGET_HEADROOM over the traced values of the tiny
# preset configurations. The CPU entries come from
# ``python -m skypilot_tpu_torch.analysis.costmodel --emit-budgets
# --device cpu``, the ``@cuda`` entries from the same command on the
# card. The multi-device presets (``audit.MULTI_DEVICE_PRESETS``) have
# CPU entries only, per shard (one rank's program, its collective bytes
# as ``collective.<axis>``): their meshes need one card per rank.
# Regenerate after a deliberate cost change and review the diff like a
# lockfile: an unexplained jump IS the regression this gate exists to
# catch. A stale key fails the tests.
BYTE_BUDGETS: Dict[str, Dict[str, Dict[str, int]]] = {
    'adapters': {
        'decode': {
            'activation': 6253320,
            'adapter_bank': 3773920,
            'const': 32360,
            'kv_pool': 14417920,
            'table': 171880,
            'weight_bf16': 16169440,
        },
        'merge': {
            'activation': 40960,
            'const': 480,
            'table': 11480,
        },
    },
    'adapters-slot': {
        'decode': {
            'activation': 6253320,
            'adapter_bank': 3773920,
            'const': 32360,
            'kv_pool': 9175040,
            'table': 165480,
            'weight_bf16': 16169440,
        },
        'merge': {
            'activation': 40960,
            'const': 160,
            'table': 820,
        },
    },
    'adapters-slot@cuda': {
        'decode': {
            'activation': 6212360,
            'adapter_bank': 3773920,
            'const': 32360,
            'kv_pool': 9175040,
            'table': 165480,
            'weight_bf16': 13548000,
        },
        'merge': {
            'activation': 40960,
            'const': 160,
            'table': 820,
        },
    },
    'adapters@cuda': {
        'decode': {
            'activation': 6565000,
            'adapter_bank': 3773920,
            'const': 22040,
            'kv_pool': 1310720,
            'table': 161640,
            'weight_bf16': 13548000,
        },
        'merge': {
            'activation': 40960,
            'const': 480,
            'table': 11480,
        },
    },
    'digest': {
        'decode': {
            'activation': 4979080,
            'const': 32320,
            'kv_pool': 14417920,
            'table': 138680,
            'weight_bf16': 16108000,
        },
        'merge': {
            'activation': 40960,
            'const': 480,
            'table': 11480,
        },
    },
    'digest@cuda': {
        'decode': {
            'activation': 5290760,
            'const': 22000,
            'kv_pool': 983040,
            'table': 128440,
            'weight_bf16': 13486560,
        },
        'merge': {
            'activation': 40960,
            'const': 480,
            'table': 11480,
        },
    },
    'disagg': {
        'decode': {
            'activation': 5306760,
            'const': 32320,
            'kv_pool': 14417920,
            'kv_scale': 245760,
            'table': 143800,
            'weight_bf16': 16108000,
        },
        'merge': {
            'activation': 560640,
            'const': 640,
            'table': 19800,
        },
    },
    'disagg@cuda': {
        'decode': {
            'activation': 5290760,
            'const': 22000,
            'kv_pool': 737280,
            'kv_scale': 46080,
            'table': 128440,
            'weight_bf16': 13486560,
        },
        'merge': {
            'activation': 560640,
            'const': 640,
            'table': 19800,
        },
    },
    'fleet-obs': {
        'decode': {
            'activation': 4979080,
            'const': 32320,
            'kv_pool': 14417920,
            'table': 138680,
            'weight_bf16': 16108000,
        },
        'merge': {
            'activation': 40960,
            'const': 480,
            'table': 11480,
        },
    },
    'fleet-obs@cuda': {
        'decode': {
            'activation': 5290760,
            'const': 22000,
            'kv_pool': 983040,
            'table': 128440,
            'weight_bf16': 13486560,
        },
        'merge': {
            'activation': 40960,
            'const': 480,
            'table': 11480,
        },
    },
    'fused-attn': {
        'decode': {
            'activation': 2901000,
            'const': 20640,
            'kv_pool': 983040,
            'table': 128280,
            'weight_bf16': 16108000,
        },
        'merge': {
            'activation': 40960,
            'const': 480,
            'table': 11480,
        },
    },
    'fused-attn@cuda': {
        'decode': {
            'activation': 2860040,
            'const': 20640,
            'kv_pool': 983040,
            'table': 128280,
            'weight_bf16': 13486560,
        },
        'merge': {
            'activation': 40960,
            'const': 480,
            'table': 11480,
        },
    },
    'int4': {
        'decode': {
            'activation': 6576520,
            'const': 32320,
            'kv_pool': 23592960,
            'kv_scale': 245760,
            'table': 143800,
            'weight_bf16': 502240,
            'weight_int4': 85196800,
            'weight_scale': 168960,
        },
        'merge': {
            'activation': 619520,
            'const': 1920,
            'table': 19800,
        },
    },
    'int4-multistep': {
        'decode': {
            'activation': 2744260,
            'const': 13280,
            'kv_pool': 5898240,
            'kv_scale': 61440,
            'table': 67700,
            'weight_bf16': 251120,
            'weight_int4': 42598400,
            'weight_scale': 84480,
        },
        'merge': {
            'activation': 309760,
            'const': 1760,
            'table': 9980,
        },
    },
    'int4-multistep@cuda': {
        'decode': {
            'activation': 2650500,
            'const': 10680,
            'kv_pool': 81920,
            'kv_scale': 10240,
            'table': 63860,
            'weight_bf16': 189680,
            'weight_int4': 36044800,
            'weight_scale': 84480,
        },
        'merge': {
            'activation': 309760,
            'const': 1760,
            'table': 9980,
        },
    },
    'int4@cuda': {
        'decode': {
            'activation': 6150920,
            'const': 22000,
            'kv_pool': 245760,
            'kv_scale': 30720,
            'table': 128440,
            'weight_bf16': 379360,
            'weight_int4': 72089600,
            'weight_scale': 168960,
        },
        'merge': {
            'activation': 619520,
            'const': 1920,
            'table': 19800,
        },
    },
    'kv-int4': {
        'decode': {
            'activation': 5306760,
            'const': 32320,
            'kv_pool': 23592960,
            'kv_scale': 245760,
            'table': 143800,
            'weight_bf16': 16108000,
        },
        'merge': {
            'activation': 619520,
            'const': 1920,
            'table': 19800,
        },
    },
    'kv-int4-slot': {
        'decode': {
            'activation': 5306760,
            'const': 32320,
            'kv_pool': 22282240,
            'kv_scale': 81920,
            'table': 132280,
            'weight_bf16': 16108000,
        },
        'merge': {
            'activation': 619520,
            'const': 1520,
            'table': 1460,
        },
    },
    'kv-int4-slot@cuda': {
        'decode': {
            'activation': 5265800,
            'const': 32320,
            'kv_pool': 22282240,
            'kv_scale': 81920,
            'table': 132280,
            'weight_bf16': 13486560,
        },
        'merge': {
            'activation': 619520,
            'const': 1520,
            'table': 1460,
        },
    },
    'kv-int4@cuda': {
        'decode': {
            'activation': 5290760,
            'const': 22000,
            'kv_pool': 245760,
            'kv_scale': 30720,
            'table': 128440,
            'weight_bf16': 13486560,
        },
        'merge': {
            'activation': 619520,
            'const': 1920,
            'table': 19800,
        },
    },
    'kv-int8': {
        'decode': {
            'activation': 5306760,
            'const': 32320,
            'kv_pool': 14417920,
            'kv_scale': 245760,
            'table': 143800,
            'weight_bf16': 16108000,
        },
        'merge': {
            'activation': 560640,
            'const': 640,
            'table': 19800,
        },
    },
    'kv-int8-slot': {
        'decode': {
            'activation': 5306760,
            'const': 32320,
            'kv_pool': 11796480,
            'kv_scale': 81920,
            'table': 132280,
            'weight_bf16': 16108000,
        },
        'merge': {
            'activation': 560640,
            'const': 240,
            'table': 1460,
        },
    },
    'kv-int8-slot@cuda': {
        'decode': {
            'activation': 5265800,
            'const': 32320,
            'kv_pool': 11796480,
            'kv_scale': 81920,
            'table': 132280,
            'weight_bf16': 13486560,
        },
        'merge': {
            'activation': 560640,
            'const': 240,
            'table': 1460,
        },
    },
    'kv-int8@cuda': {
        'decode': {
            'activation': 5290760,
            'const': 22000,
            'kv_pool': 491520,
            'kv_scale': 30720,
            'table': 128440,
            'weight_bf16': 13486560,
        },
        'merge': {
            'activation': 560640,
            'const': 640,
            'table': 19800,
        },
    },
    'llama': {
        'forward': {
            'activation': 2746240,
            'const': 129310,
            'table': 160,
            'weight_bf16': 2300640,
        },
    },
    'llama@cuda': {
        'forward': {
            'activation': 2295680,
            'const': 126740,
            'table': 160,
            'weight_bf16': 1972960,
        },
    },
    'multistep': {
        'decode': {
            'activation': 2006980,
            'const': 13280,
            'kv_pool': 3604480,
            'table': 66420,
            'weight_bf16': 8054000,
        },
        'merge': {
            'activation': 20480,
            'const': 320,
            'table': 5820,
        },
    },
    'multistep@cuda': {
        'decode': {
            'activation': 2220420,
            'const': 10680,
            'kv_pool': 327680,
            'table': 63860,
            'weight_bf16': 6743280,
        },
        'merge': {
            'activation': 20480,
            'const': 320,
            'table': 5820,
        },
    },
    'paged': {
        'decode': {
            'activation': 4979080,
            'const': 32320,
            'kv_pool': 14417920,
            'table': 138680,
            'weight_bf16': 16108000,
        },
        'merge': {
            'activation': 40960,
            'const': 480,
            'table': 11480,
        },
    },
    'paged-gang': {
        'decode': {
            'activation': 1493860,
            'collective.tp': 51200,
            'const': 32320,
            'kv_pool': 1966080,
            'table': 69720,
            'weight_bf16': 8079600,
        },
        'merge': {
            'activation': 61440,
            'collective.dp': 10330,
            'const': 440,
            'table': 9280,
        },
    },
    'paged-spec': {
        'spec_verify': {
            'activation': 2392770,
            'const': 4642,
            'kv_pool': 1802240,
            'table': 82935,
            'weight_bf16': 2177580,
        },
    },
    'paged-spec@cuda': {
        'spec_verify': {
            'activation': 2367170,
            'const': 4642,
            'kv_pool': 1802240,
            'table': 82935,
            'weight_bf16': 1849900,
        },
    },
    'paged-tp': {
        'decode': {
            'activation': 2987720,
            'collective.tp': 102400,
            'const': 32320,
            'kv_pool': 3932160,
            'table': 138680,
            'weight_bf16': 8243680,
        },
        'merge': {
            'activation': 20480,
            'const': 440,
            'table': 8920,
        },
    },
    'paged-tp-int8': {
        'decode': {
            'activation': 3151560,
            'collective.tp': 102400,
            'const': 32320,
            'kv_pool': 3932160,
            'kv_scale': 81920,
            'table': 143800,
            'weight_bf16': 8243680,
        },
        'merge': {
            'activation': 280320,
            'const': 560,
            'table': 14680,
        },
    },
    'paged@cuda': {
        'decode': {
            'activation': 5290760,
            'const': 22000,
            'kv_pool': 983040,
            'table': 128440,
            'weight_bf16': 13486560,
        },
        'merge': {
            'activation': 40960,
            'const': 480,
            'table': 11480,
        },
    },
    'slot': {
        'decode': {
            'activation': 4979080,
            'const': 32320,
            'kv_pool': 9175040,
            'table': 132280,
            'weight_bf16': 16108000,
        },
        'merge': {
            'activation': 40960,
            'const': 160,
            'table': 820,
        },
    },
    'slot-spec': {
        'spec_verify': {
            'activation': 2438840,
            'const': 4572,
            'kv_pool': 1198080,
            'table': 82260,
            'weight_bf16': 2177580,
        },
    },
    'slot-spec@cuda': {
        'spec_verify': {
            'activation': 1564440,
            'const': 3010,
            'kv_pool': 378880,
            'table': 81620,
            'weight_bf16': 1849900,
        },
    },
    'slot@cuda': {
        'decode': {
            'activation': 4938120,
            'const': 32320,
            'kv_pool': 9175040,
            'table': 132280,
            'weight_bf16': 13486560,
        },
        'merge': {
            'activation': 40960,
            'const': 160,
            'table': 820,
        },
    },
    'spec-multistep': {
        'spec_fused': {
            'activation': 7194210,
            'const': 33971,
            'kv_pool': 5406720,
            'table': 356105,
            'weight_bf16': 6532740,
        },
    },
    'spec-multistep@cuda': {
        'spec_fused': {
            'activation': 7117410,
            'const': 33971,
            'kv_pool': 5406720,
            'table': 356105,
            'weight_bf16': 5549700,
        },
    },
    'telemetry': {
        'decode': {
            'activation': 4979080,
            'const': 32320,
            'kv_pool': 9175040,
            'table': 132280,
            'weight_bf16': 16108000,
        },
        'merge': {
            'activation': 40960,
            'const': 160,
            'table': 820,
        },
    },
    'telemetry@cuda': {
        'decode': {
            'activation': 4938120,
            'const': 32320,
            'kv_pool': 9175040,
            'table': 132280,
            'weight_bf16': 13486560,
        },
        'merge': {
            'activation': 40960,
            'const': 160,
            'table': 820,
        },
    },
}


def budget_for(preset: str, device_type: str = 'cpu'
               ) -> Optional[Dict[str, Dict[str, int]]]:
    return BYTE_BUDGETS.get(budget_key(preset, device_type))


# --------------------------------------------------- abstract tracing
def abstract_params(cfg, quantize: Optional[str] = None):
    """The params tree of ``cfg`` on the meta device (shapes, dtypes
    and layout, no data: a 70B costs no memory), from the port's own
    ``init_params`` and quantization, so layout changes propagate here
    for free."""
    from skypilot_tpu_torch.inference.engine import serving_config
    from skypilot_tpu_torch.models import llama
    return llama.init_params(serving_config(cfg), 0, device='meta',
                             quantize=quantize)


def abstract_paged_cache(cfg, n_pages: int, page_size: int,
                         kv_cache_dtype: Optional[str] = None):
    """The paged pool on the meta device, laid out as the engine lays
    it out (``PagedKVCache.create``: [L, n_pages, hkv, page, d], int4
    packed two codes a byte, fp32 row scales for int8/int4)."""
    from skypilot_tpu_torch.inference.paged import PagedKVCache
    return PagedKVCache.create(cfg, n_pages=n_pages, page_size=page_size,
                               kv_dtype=kv_cache_dtype or 'bf16',
                               device='meta')


def abstract_decode_cost(cfg, *, batch: int, avg_ctx: int,
                         quantize: Optional[str] = None,
                         kv_cache_dtype: Optional[str] = None,
                         page_size: int = 16, horizon: int = 1,
                         decode_impl: Optional[str] = None,
                         params=None) -> DispatchCost:
    """Price ONE paged decode call of ``horizon`` steps for any
    configuration, abstractly: ``paged_decode_horizon`` on meta tensors
    (nothing computes, no weight materialises), standing for the card's
    program with ``decode_impl`` (default: what the engine's 'auto'
    picks there), every slot at ``avg_ctx`` live rows. ``params``: the
    meta tree, when the caller has built it (:func:`abstract_params`)."""
    from skypilot_tpu_torch.inference import paged as paged_lib
    from skypilot_tpu_torch.inference.engine import serving_config
    cfg = serving_config(cfg)
    impl = decode_impl or paged_lib.auto_decode_impl(cfg, 'cuda')
    if params is None:
        params = abstract_params(cfg, quantize)
    pages_per_req = -(-(avg_ctx + horizon) // page_size)
    n_pages = batch * pages_per_req + 1
    cache = abstract_paged_cache(cfg, n_pages, page_size, kv_cache_dtype)
    meta = dict(device='meta')
    table_p = torch.empty((batch, pages_per_req), dtype=torch.int32, **meta)
    tokens = torch.empty((batch,), dtype=torch.int32, **meta)
    lengths = torch.empty((batch,), dtype=torch.int32, **meta)

    def fn(p, c, t, tok, ln):
        paged_lib.paged_decode_horizon(p, c, t, tok, ln, cfg,
                                       horizon=horizon, decode_impl=impl)

    args = (params, cache, table_p, tokens, lengths)
    classes = (classify_params(params), classify_cache(cache),
               TABLE, TABLE, TABLE)
    label = (f'{cfg.name} decode (batch={batch}, ctx={avg_ctx}'
             + (f', {quantize} weights' if quantize else '')
             + (f', {kv_cache_dtype} kv' if kv_cache_dtype else '')
             + f', {impl})')
    cost = trace_dispatch(fn, args, classes, label=label,
                          stands_for='cuda',
                          values=[(lengths, [avg_ctx] * batch)])
    cost.kv_token_capacity = n_pages * page_size
    cost.kv_bytes_per_token = kv_bytes_per_token(
        (cache,), (classify_cache(cache),), n_pages * page_size)
    return cost


def weight_floor_by_class(cfg, params, rows: int) -> Dict[str, int]:
    """The stored weight bytes one decode step over ``rows`` tokens must
    read whatever implements it, by class: every weight leaf once, except
    the embedding table, of which only the ``rows`` gathered rows count
    (as the reference's gather prices it), plus the whole table when it
    is also the unembedding (tied)."""
    classes = classify_params(params)
    out: Dict[str, int] = {}
    for key, leaf in params.items():
        if key == 'embed':
            rows_b = rows * leaf.shape[1] * leaf.element_size()
            if cfg.tie_embeddings:
                rows_b += leaf.numel() * leaf.element_size()
            _acc(out, WEIGHT_BF16, rows_b)
            continue
        for t, c in tree_pairs(leaf, classes[key]):
            if c in WEIGHT_CLASSES:
                _acc(out, c, t.numel() * t.element_size())
    return out


def weight_floor_bytes(cfg, params, rows: int) -> int:
    """:func:`weight_floor_by_class`, summed."""
    return sum(weight_floor_by_class(cfg, params, rows).values())


def roofline_step_bytes(cfg, *, batch: int, avg_ctx: int,
                        quantize: Optional[str] = None,
                        kv_cache_dtype: Optional[str] = None,
                        decode_impl: Optional[str] = None
                        ) -> Dict[str, Any]:
    """One decode step's roofline denominator. ``weight_bytes``,
    ``kv_bytes_per_token``, ``live_tokens``, ``kv_bytes`` and
    ``step_bytes`` are the floor: the stored bytes a step must read
    whatever implements it (:func:`weight_floor_bytes` plus the live
    context's KV). ``read_by_class`` and ``flops`` are what the port's
    program traces to (:func:`abstract_decode_cost`), so any excess over
    the floor shows there."""
    from skypilot_tpu_torch.inference.engine import serving_config
    cfg = serving_config(cfg)
    params = abstract_params(cfg, quantize)
    cost = abstract_decode_cost(cfg, batch=batch, avg_ctx=avg_ctx,
                                quantize=quantize,
                                kv_cache_dtype=kv_cache_dtype,
                                decode_impl=decode_impl, params=params)
    live = batch * avg_ctx
    kv = cost.kv_read_bytes_per_step(live)
    floor = weight_floor_by_class(cfg, params, batch)
    weights = float(sum(floor.values()))
    return {
        'weight_bytes': weights,
        'kv_bytes_per_token': float(cost.kv_bytes_per_token),
        'live_tokens': float(live),
        'kv_bytes': float(kv),
        'step_bytes': weights + kv,
        'flops': float(cost.flops),
        'read_by_class': {k: float(v) for k, v in cost.read.items()},
        'weight_floor_by_class': {k: float(v) for k, v in floor.items()},
    }


def kv_static_check(cfg, kv_cache_dtype, measured_per_token: float,
                    mesh=None) -> Dict[str, Any]:
    """Hold the static stored bytes/token (the pool's tensors over its
    capacity) to a measured, telemetry-derived value within
    :data:`KV_TOLERANCE`. Returns the comparison record. Under a serving
    ``mesh`` (a ``ServingMesh``, a ``MeshSpec`` or axis sizes) the
    static bytes are one device's: divided by the kv shard degree, as
    the reference divides them."""
    page = 16
    n_pages = -(-64 // page) + 1
    cache = abstract_paged_cache(cfg, n_pages, page, kv_cache_dtype)
    static = kv_bytes_per_token((cache,), (classify_cache(cache),),
                                n_pages * page)
    if mesh is not None:
        from skypilot_tpu_torch.inference.engine import kv_shard_degree
        static /= kv_shard_degree(cfg, mesh)
    ratio = static / measured_per_token if measured_per_token else 0.0
    return {
        'static_bytes_per_token': static,
        'measured_bytes_per_token': float(measured_per_token),
        'ratio': ratio,
        'tolerance': KV_TOLERANCE,
        'ok': bool(measured_per_token
                   and abs(ratio - 1.0) <= KV_TOLERANCE),
    }


# ----------------------------------------------------------- CLI hook
def preset_costs(preset: str, device='cuda'
                 ) -> Tuple[Dict[str, DispatchCost], List[str]]:
    """Costs for one audit preset: runs the preset (which captures its
    steady-state dispatches) and returns its priced dispatches and any
    budget violations."""
    from skypilot_tpu_torch.analysis import audit
    report = audit.run_preset(preset, device=device)
    return report.dispatch_costs, report.byte_budget_violations()


def _emit_budgets(names: Optional[List[str]] = None,
                  device='cuda') -> str:
    """Trace the presets and print their BYTE_BUDGETS entries (keyed
    by :func:`budget_key` for the device's type)."""
    from skypilot_tpu_torch.analysis import audit
    from skypilot_tpu_torch.utils.device import resolve_device
    dev_type = resolve_device(device).type
    names = names or audit.default_presets(device)
    out: Dict[str, Dict[str, Dict[str, int]]] = {}
    for name in names:
        report = audit.PRESETS[name](device=device)
        if report.dispatch_costs:
            out[budget_key(name, dev_type)] = budget_from_costs(
                report.dispatch_costs)
    return json.dumps(out, indent=1, sort_keys=True)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.analysis.costmodel',
        description='print the BYTE_BUDGETS entries of audit presets')
    parser.add_argument('--emit-budgets', action='store_true',
                        required=True)
    parser.add_argument('--device', default='cuda',
                        choices=('cuda', 'cpu'))
    parser.add_argument('presets', nargs='*')
    args = parser.parse_args(argv)
    print(_emit_budgets(args.presets or None, args.device))
    return 0


if __name__ == '__main__':      # pragma: no cover - dev tool
    sys.exit(main())
