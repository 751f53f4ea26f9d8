"""Batched multi-LoRA: a device-resident adapter bank for multi-tenant
serving on ONE engine (own copy of ``skypilot_tpu/models/multilora.py``).

- Bank layout: ``params['layers']['mlora'][target]['a'|'b']`` with
  leaves ``a: [L, A, *in, r]`` / ``b: [L, A, r, *out]`` plus a
  per-(layer, adapter) ``scale: [L, A]`` fp32. The layer axis leads, so
  ``llama.layer_params`` views one layer's slice like every other
  stacked leaf; ``A`` is the slot axis, the engine's adapter capacity.
- Per-row adapter indices (``mlora_idx: [b] int32``, -1 = no adapter)
  gather each row's factors along the slot axis, so the low-rank
  correction ``(x @ a) @ b`` is two thin batched matmuls next to the
  base projection (:func:`adjusted`). The decode graphs depend only on
  the bank's SHAPE, never on which adapters occupy it.
- Adapter load and evict (:func:`set_bank_row`, :func:`clear_bank_row`)
  write one slot IN PLACE into the bank's existing storage: the bank is
  never rebound or reallocated, because a captured CUDA graph reads it
  through the pointers it held at capture.
- Zero-adapter rows are BIT-exact base model: :func:`adjusted`
  where-selects the untouched base projection for rows with idx < 0
  rather than adding a zero delta (the bank rows a -1 row gathers are
  slot 0's, an arbitrary live adapter).

Rank discipline: the bank has ONE static rank; adapters with a smaller
rank zero-pad (zero factor columns contribute nothing), larger ranks
are refused at load (:func:`adapter_row_from_tree`).

The delta is plain batched ``torch`` matmuls, as the reference computes
it in XLA outside any Pallas kernel.

Under a serving mesh's tp the bank stays whole on every rank (the
reference replicates it), and each rank uses its part of it at the
product (:func:`_gather_delta`): no collective of its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models import lora as lora_lib
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.utils.device import DeviceLike, resolve_device

Params = Dict[str, Any]

ATTN_TARGETS = lora_lib._ATTN_TARGETS
MLP_TARGETS = lora_lib._MLP_TARGETS


def default_targets(cfg: ModelConfig) -> Tuple[str, ...]:
    """Bank targets when none are pinned: all attention projections,
    plus the dense-FFN targets (MoE configs have no dense FFN)."""
    return ATTN_TARGETS + (() if cfg.is_moe else MLP_TARGETS)


def target_shapes(cfg: ModelConfig, target: str, rank: int):
    """(a_shape, b_shape) without layer/slot axes, at an explicit rank
    (the bank rank is an engine knob, not cfg.lora_rank)."""
    return lora_lib._target_shapes(
        dataclasses.replace(cfg, lora_rank=rank), target)


def init_bank(cfg: ModelConfig, slots: int, rank: int, *,
              targets: Optional[Sequence[str]] = None,
              dtype: torch.dtype = torch.bfloat16,
              device: DeviceLike = 'cuda') -> Params:
    """The ``params['layers']['mlora']`` subtree on ``device``: all-zero
    factors (an empty slot is a no-op even if gathered) and zero
    scales."""
    if slots <= 0 or rank <= 0:
        raise ValueError(f'bank needs slots>0, rank>0; got {slots}, {rank}')
    targets = tuple(targets) if targets is not None \
        else default_targets(cfg)
    for t in targets:
        if t not in ATTN_TARGETS + MLP_TARGETS:
            raise ValueError(f'unknown multi-LoRA target {t!r}')
        if t in MLP_TARGETS and cfg.is_moe:
            raise ValueError(
                f'multi-LoRA target {t!r} needs a dense FFN; '
                f'{cfg.name} is MoE')
    dev = resolve_device(device)
    L = cfg.n_layers
    bank: Params = {}
    for t in targets:
        a_shape, b_shape = target_shapes(cfg, t, rank)
        bank[t] = {
            'a': torch.zeros((L, slots) + a_shape, dtype=dtype, device=dev),
            'b': torch.zeros((L, slots) + b_shape, dtype=dtype, device=dev),
        }
    # Per-layer copies of the per-adapter scale, so a layer's view of
    # the bank carries its own [A] scale row.
    bank['scale'] = torch.zeros((L, slots), dtype=torch.float32, device=dev)
    return bank


def bank_slots(bank: Params) -> int:
    return int(bank['scale'].shape[1])


def bank_targets(bank: Params) -> Tuple[str, ...]:
    return tuple(t for t in bank if t != 'scale')


def bank_leaves(bank: Params):
    """The bank's tensors: each target's ``a`` and ``b``, then the
    scales."""
    for t in bank_targets(bank):
        yield bank[t]['a']
        yield bank[t]['b']
    yield bank['scale']


def bank_bytes(bank: Params) -> int:
    """Device bytes the bank holds (factors and scales)."""
    total = bank['scale'].numel() * bank['scale'].element_size()
    for t in bank_targets(bank):
        for leaf in bank[t].values():
            total += leaf.numel() * leaf.element_size()
    return total


# The logical axis tp splits each target's output (column-parallel) or
# input (row-parallel) over.
_COLUMN_SPLIT = {'wq': 'heads', 'wk': 'kv_heads', 'wv': 'kv_heads',
                 'w_gate': 'mlp', 'w_up': 'mlp'}
_ROW_SPLIT = {'wo': 'heads', 'w_down': 'mlp'}


def _gather_delta(ml: Params, target: str, x: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """The scaled low-rank delta, gathered per row from the bank slice
    of ONE layer (slot axis leads). idx is clipped: negative rows gather
    slot 0's factors, and :func:`adjusted` selects their result away.
    The reference's rounding order: the factors cast to ``x.dtype``,
    ``z = x @ a`` then ``z @ b`` in that dtype, times the fp32 scale
    cast to ``x.dtype``.

    Under tp (``mesh.tp_slice``) a column-parallel target (q, k, v,
    gate, up) takes this rank's output columns of ``b``, and a
    row-parallel one (``wo``, ``w_down``) this rank's input rows of
    ``a``: its delta is then a partial sum, which the reduce after the
    base product adds up with it. The rounding order differs from the
    reference's partitioned program (which may reduce ``x @ a`` first);
    fp32 keeps the two within rounding."""
    dt = x.dtype
    n_slots = ml['scale'].shape[0]
    g = torch.clamp(idx.long(), 0, n_slots - 1)
    a, b = ml[target]['a'], ml[target]['b']    # [A, *in, r], [A, r, *out]
    if target in _COLUMN_SPLIT:
        b = b[:, :, mesh_lib.tp_slice(b.shape[2], _COLUMN_SPLIT[target])]
    else:
        a = a[:, mesh_lib.tp_slice(a.shape[1], _ROW_SPLIT[target])]
    a = a[g].to(dt)                            # [b, *in, r]
    b = b[g].to(dt)                            # [b, r, *out]
    if target == 'wo':                         # x: [b, s, h, k]
        z = torch.einsum('bshk,bhkr->bsr', x, a)
        d = torch.einsum('bsr,brd->bsd', z, b)
    elif target in ('wq', 'wk', 'wv'):
        z = torch.einsum('bsd,bdr->bsr', x, a)
        d = torch.einsum('bsr,brhk->bshk', z, b)
    elif target == 'w_down':                   # x: [b, s, f]
        z = torch.einsum('bsf,bfr->bsr', x, a)
        d = torch.einsum('bsr,brd->bsd', z, b)
    else:                                      # w_gate / w_up
        z = torch.einsum('bsd,bdr->bsr', x, a)
        d = torch.einsum('bsr,brf->bsf', z, b)
    s = ml['scale'][g]                         # [b] fp32
    return d * s.reshape((-1,) + (1,) * (d.dim() - 1)).to(dt)


def adjusted(ml: Optional[Params], target: str, x: torch.Tensor,
             base: torch.Tensor, idx: Optional[torch.Tensor]
             ) -> torch.Tensor:
    """``base`` with each row's gathered adapter delta applied; rows
    with idx < 0 return base BIT-exactly (where-select, not +0)."""
    if ml is None or idx is None or target not in ml:
        return base
    delta = _gather_delta(ml, target, x, idx)
    keep = (idx >= 0).reshape((-1,) + (1,) * (base.dim() - 1))
    return torch.where(keep, base + delta.to(base.dtype), base)


def _row_leaves(bank: Params, row: Params):
    for t in bank_targets(bank):
        for leaf in ('a', 'b'):
            yield bank[t][leaf], row[t][leaf]
    yield bank['scale'], row['scale']


def set_bank_row(bank: Params, row: Params, slot: int) -> Params:
    """Overwrite one bank slot with an adapter's factors, IN PLACE
    (``copy_`` into the existing storage; returns ``bank``, the same
    tensors). ``row`` holds host numpy leaves, the bank leaves minus the
    slot axis (:func:`adapter_row_from_tree`): each is rounded to the
    bank's dtype on the host and copied through pinned memory without
    blocking the host, ordered on the current stream after every
    earlier read of the bank."""
    for dst, src in _row_leaves(bank, row):
        host = torch.from_numpy(np.ascontiguousarray(src, np.float32)).to(
            dst.dtype)
        view = dst[:, slot]
        if dst.device.type == 'cuda':
            host = host.pin_memory()
        view.copy_(host, non_blocking=True)
    return bank


def clear_bank_row(bank: Params, slot: int) -> Params:
    """Zero one slot (evict), in place: an all-zero row through
    :func:`set_bank_row`, so load and evict share one path."""
    zero = {t: {leaf: np.zeros(bank[t][leaf].shape[:1]
                               + bank[t][leaf].shape[2:], np.float32)
                for leaf in ('a', 'b')}
            for t in bank_targets(bank)}
    zero['scale'] = np.zeros(bank['scale'].shape[:1], np.float32)
    return set_bank_row(bank, zero, slot)


def adapter_row_from_tree(cfg: ModelConfig, lora_tree: Params,
                          bank_rank: int, scale: float, *,
                          targets: Sequence[str]) -> Params:
    """Convert a trainer-format adapter (``lora.split_lora`` layout:
    ``{target: {'a': [L, *in, r], 'b': [L, r, *out]}}``) into a bank row
    (host numpy fp32; :func:`set_bank_row` uploads it). Targets the bank
    carries but the adapter doesn't are zero (no-op); ranks below the
    bank rank zero-pad; ranks above are a hard error."""
    L = cfg.n_layers
    row: Params = {}
    for t in targets:
        a_shape, b_shape = target_shapes(cfg, t, bank_rank)
        if t in lora_tree:
            a = _host_f32(lora_tree[t]['a'])
            b = _host_f32(lora_tree[t]['b'])
            r = a.shape[-1]
            if r > bank_rank:
                raise ValueError(
                    f'adapter rank {r} exceeds bank rank {bank_rank} '
                    f'for target {t!r}')
            if a.shape[0] != L:
                raise ValueError(
                    f'adapter {t!r} has {a.shape[0]} layers; '
                    f'model has {L}')
            if r < bank_rank:
                a = np.concatenate(
                    [a, np.zeros(a.shape[:-1] + (bank_rank - r,),
                                 np.float32)], axis=-1)
                b = np.concatenate(
                    [b, np.zeros((b.shape[0], bank_rank - r)
                                 + b.shape[2:], np.float32)], axis=1)
            if a.shape != (L,) + a_shape or b.shape != (L,) + b_shape:
                raise ValueError(
                    f'adapter {t!r} shapes {a.shape}/{b.shape} do not '
                    f'match bank {(L,) + a_shape}/{(L,) + b_shape}')
            row[t] = {'a': a, 'b': b}
        else:
            row[t] = {'a': np.zeros((L,) + a_shape, np.float32),
                      'b': np.zeros((L,) + b_shape, np.float32)}
    row['scale'] = np.full((L,), scale, np.float32)
    return row


def _host_f32(arr) -> np.ndarray:
    """An adapter factor (numpy, or a torch tensor on any device) as a
    host fp32 numpy array."""
    if torch.is_tensor(arr):
        arr = arr.detach().to('cpu', torch.float32).numpy()
    return np.asarray(arr, np.float32)


def save_adapter(path: str, cfg: ModelConfig, lora_tree: Params, *,
                 scale: Optional[float] = None) -> None:
    """One adapter -> one ``.npz`` (the registry's checkpoint unit; the
    reference's keys ``{target}.a``, ``{target}.b`` and ``__scale__``,
    so either package loads the other's file). ``scale`` defaults to the
    config's alpha/rank fold scale, the number ``lora.merge`` folds
    with."""
    if scale is None:
        first = next(iter(lora_tree.values()))
        rank = int(np.shape(first['a'])[-1])
        scale = float(cfg.lora_alpha) / rank
    arrays = {'__scale__': np.float32(scale)}
    for t, ab in lora_tree.items():
        arrays[f'{t}.a'] = _host_f32(ab['a'])
        arrays[f'{t}.b'] = _host_f32(ab['b'])
    np.savez(path, **arrays)


def load_adapter(path: str) -> Tuple[Params, float]:
    """(trainer-format adapter tree of host numpy arrays, fold scale)
    from a ``.npz``."""
    data = np.load(path)
    tree: Params = {}
    scale = float(data['__scale__']) if '__scale__' in data else 1.0
    for key in data.files:
        if key == '__scale__':
            continue
        target, _, leaf = key.partition('.')
        if leaf not in ('a', 'b'):
            raise ValueError(f'unrecognized adapter array {key!r}')
        tree.setdefault(target, {})[leaf] = data[key]
    for t, ab in tree.items():
        if set(ab) != {'a', 'b'}:
            raise ValueError(f'adapter target {t!r} missing a/b factors')
    return tree, scale
