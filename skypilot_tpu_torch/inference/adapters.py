"""Multi-tenant adapter serving: the host-side registry over the
device-resident multi-LoRA bank, and the grammar vocab masks that ride
the same per-request plumbing (own copy of
``skypilot_tpu/inference/adapters.py``).

The bank (stacked per-layer A/B factors and per-adapter scales,
``params['layers']['mlora']``) and its gathered delta live in
``models/multilora.py``; this module owns WHICH adapter occupies WHICH
slot:

- **LRU load and evict, bank slots as the capacity unit**: a request
  naming a loaded adapter pins it (refcount); a miss loads the
  adapter's ``.npz`` checkpoint from ``adapter_dir`` (or the in-memory
  store) into a free slot; under pressure the coldest UNPINNED
  adapter's slot is overwritten in place. Load and evict are the same
  in-place upload into the bank's storage (``multilora.set_bank_row``):
  adapter churn never reallocates the bank, so the decode graphs
  captured before it keep reading the right memory and none is
  captured again.
- **Telemetry registered at construction** (zeros from the first
  scrape): ``skytpu_adapter_bank_slots{state}``,
  ``skytpu_adapter_loads_total`` / ``skytpu_adapter_evictions_total``,
  and ``skytpu_requests_total{adapter}`` with a BOUNDED label set (names
  beyond ``4 x slots`` distinct values collapse into ``other``).

Thread safety: calls run under the serve layer's engine lock, like
every other host-side engine call.
"""
from __future__ import annotations

import collections
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from skypilot_tpu_torch.models import multilora
from skypilot_tpu_torch.telemetry import clock

# Telemetry series (registered at construction; see module docstring).
ADAPTER_SLOTS_METRIC = 'skytpu_adapter_bank_slots'
ADAPTER_LOADS_METRIC = 'skytpu_adapter_loads_total'
ADAPTER_EVICTIONS_METRIC = 'skytpu_adapter_evictions_total'
REQUESTS_METRIC = 'skytpu_requests_total'

_NAME_RE = re.compile(r'^[A-Za-z0-9][A-Za-z0-9._-]*$')


def _check_name(name: str) -> str:
    """Adapter names double as checkpoint file stems and metric label
    values: reject path separators and traversal outright."""
    if not isinstance(name, str) or not _NAME_RE.match(name) \
            or '..' in name:
        raise ValueError(f'illegal adapter name {name!r}')
    return name


class AdapterBankFullError(RuntimeError):
    """Every bank slot is pinned by a live request; the new adapter
    cannot load until one finishes (the serve scheduler defers the
    request, a retryable condition)."""


class AdapterRegistry:
    """Name -> bank-slot mapping with LRU eviction and request-pinned
    refcounts, bound to one engine's bank. Construction installs an
    all-zero bank at ``engine.params['layers']['mlora']`` on the
    engine's device, in the model dtype (in new dicts: the weights the
    engine was given are left as they were)."""

    def __init__(self, engine, *, slots: int, rank: int,
                 adapter_dir: Optional[str] = None):
        self.engine = engine
        cfg = engine.cfg
        self.slots = int(slots)
        self.rank = int(rank)
        self.adapter_dir = adapter_dir
        self.targets = multilora.default_targets(cfg)
        self.bank = multilora.init_bank(cfg, self.slots, self.rank,
                                        targets=self.targets,
                                        dtype=cfg.dtype,
                                        device=engine.device)
        # New dicts around the same tensors: the caller's tree (which
        # another engine may share) never sees this engine's bank.
        engine.params = dict(engine.params, layers=dict(
            engine.params['layers'], mlora=self.bank))

        # name -> slot, insertion order == LRU order (oldest first).
        self._loaded: 'collections.OrderedDict[str, int]' = \
            collections.OrderedDict()
        self._refs: Dict[str, int] = {}
        self._free: List[int] = list(range(self.slots))
        # name -> the load that wrote its slot (``loads_total`` then):
        # part of the prefix-cache salt, so KV written under one load's
        # weights never serves a later load of the same name.
        self._generation: Dict[str, int] = {}
        # In-memory adapter source (tests, benchmarks; no checkpoint).
        self._store: Dict[str, Tuple[Any, float]] = {}
        self.loads_total = 0
        self.evictions_total = 0
        self.last_load_ms = 0.0
        # Bounded requests_total{adapter} label set.
        self._label_cap = 4 * self.slots
        self._req_counters: Dict[str, Any] = {}

        self._slots_used_g = self._slots_free_g = None
        self._loads_c = self._evictions_c = None
        if getattr(engine, 'telemetry_enabled', False):
            from skypilot_tpu_torch.telemetry import registry as registry_lib
            reg = registry_lib.get_registry()
            self._slots_used_g = reg.gauge(
                ADAPTER_SLOTS_METRIC,
                'Multi-LoRA bank slots by occupancy state',
                state='used')
            self._slots_free_g = reg.gauge(
                ADAPTER_SLOTS_METRIC, '', state='free')
            self._slots_free_g.set(self.slots)
            self._loads_c = reg.counter(
                ADAPTER_LOADS_METRIC,
                'Adapter checkpoint loads into the bank (LRU misses)')
            self._evictions_c = reg.counter(
                ADAPTER_EVICTIONS_METRIC,
                'Adapters evicted from the bank under slot pressure')
            # requests_total{adapter="none"} exists from the first
            # scrape; named labels join as adapters are first seen.
            self._req_counter('none')

    # ------------------------------------------------------------ sources
    def register(self, name: str, lora_tree: Any,
                 scale: Optional[float] = None) -> None:
        """In-memory adapter source (trainer-format tree, see
        ``lora.split_lora``): the checkpoint-less path. Registering a
        name that is loaded unloads it, so its next request loads the
        new factors; refused while live requests pin the old ones.
        This rank's registry only: callers go through the engine's
        ``register_adapter``, which a serving mesh mirrors to every
        rank."""
        _check_name(name)
        if self._refs.get(name, 0) > 0:
            raise ValueError(
                f'adapter {name!r} is pinned by {self._refs[name]} live '
                f'request(s); register it again after they finish')
        if scale is None:
            first = next(iter(lora_tree.values()))
            r = int(np.shape(first['a'])[-1])
            scale = float(self.engine.cfg.lora_alpha) / r
        self._store[name] = (lora_tree, scale)
        if name in self._loaded:
            self._free.append(self._loaded.pop(name))
            self._refs.pop(name, None)
            self._generation.pop(name, None)
            self._note_slots()

    def _find_source(self, name: str):
        """The in-memory ``(tree, scale)`` or the checkpoint's path; no
        read beyond a ``stat``."""
        if name in self._store:
            return self._store[name]
        if self.adapter_dir:
            path = os.path.join(self.adapter_dir, f'{name}.npz')
            if os.path.exists(path):
                return path
        raise ValueError(
            f'unknown adapter {name!r}: not registered and no '
            f'checkpoint under {self.adapter_dir!r}')

    def _has_room(self) -> bool:
        return bool(self._free) or any(
            self._refs.get(n, 0) <= 0 for n in self._loaded)

    # ------------------------------------------------------------ core
    def acquire(self, name: str) -> int:
        """Pin ``name`` for one request and return its bank slot,
        loading (and possibly evicting) on a miss. Balanced by exactly
        one :meth:`release` when the request leaves the engine."""
        _check_name(name)
        if name in self._loaded:
            self._loaded.move_to_end(name)
            self._refs[name] = self._refs.get(name, 0) + 1
            return self._loaded[name]
        source = self._find_source(name)
        # Full before any read: a deferred request retries every engine
        # step, under the engine lock.
        if not self._has_room():
            raise AdapterBankFullError(
                f'all {self.slots} adapter bank slots are pinned by live '
                f'requests')
        # Load AND validate the row before touching the bank: a bad
        # checkpoint (over-rank, wrong layer count, shape mismatch)
        # fails the one request without consuming a slot or evicting a
        # healthy adapter.
        t0 = clock.monotonic()
        tree, scale = (multilora.load_adapter(source)
                       if isinstance(source, str) else source)
        row = multilora.adapter_row_from_tree(
            self.engine.cfg, tree, self.rank, scale,
            targets=self.targets)
        slot = self._take_slot()
        try:
            # In place, without blocking the host: the copy is ordered
            # on the stream after every call that read the slot before.
            multilora.set_bank_row(self.bank, row, slot)
        except BaseException:
            # The slot is genuinely free (an evicted victim already left
            # _loaded): without this every failed upload would leak one
            # slot until AdapterBankFullError wedged admission.
            self._free.append(slot)
            self._note_slots()
            raise
        # Host ms of the load: the checkpoint read, the row's rounding
        # and its enqueue through pinned memory (the copy itself runs on
        # the stream, unwaited).
        self.last_load_ms = (clock.monotonic() - t0) * 1e3
        self._loaded[name] = slot
        self._refs[name] = self._refs.get(name, 0) + 1
        self.loads_total += 1
        self._generation[name] = self.loads_total
        if self._loads_c is not None:
            self._loads_c.inc()
        self._note_slots()
        return slot

    def release(self, name: str) -> None:
        """Unpin one request's hold on ``name`` (the adapter STAYS
        loaded: only slot pressure evicts)."""
        if name in self._refs and self._refs[name] > 0:
            self._refs[name] -= 1

    def _take_slot(self) -> int:
        if self._free:
            return self._free.pop()
        # Evict the coldest unpinned adapter; its slot is overwritten in
        # place by the incoming row (evict + load = ONE bank upload).
        for victim, slot in self._loaded.items():
            if self._refs.get(victim, 0) <= 0:
                del self._loaded[victim]
                self._refs.pop(victim, None)
                self._generation.pop(victim, None)
                self.evictions_total += 1
                if self._evictions_c is not None:
                    self._evictions_c.inc()
                return slot
        raise AdapterBankFullError(
            f'all {self.slots} adapter bank slots are pinned by live '
            f'requests')

    def prefix_salt(self, name: str) -> bytes:
        """The prefix-cache salt of a request pinning ``name``: the
        name and the load that wrote its slot."""
        return f'adapter:{name}#{self._generation[name]}'.encode()

    def slot_of(self, name: str) -> Optional[int]:
        return self._loaded.get(name)

    def loaded(self) -> List[str]:
        """Loaded adapter names, coldest first (LRU order)."""
        return list(self._loaded)

    # ------------------------------------------------------------ metrics
    def _note_slots(self) -> None:
        used = len(self._loaded)
        if self._slots_used_g is not None:
            self._slots_used_g.set(used)
            self._slots_free_g.set(self.slots - used)

    def _req_counter(self, label: str):
        c = self._req_counters.get(label)
        if c is None:
            from skypilot_tpu_torch.telemetry import registry as registry_lib
            c = registry_lib.get_registry().counter(
                REQUESTS_METRIC,
                'Requests accepted, labeled by adapter (bounded set)',
                adapter=label)
            self._req_counters[label] = c
        return c

    def note_request(self, adapter: Optional[str]) -> None:
        """Count one accepted request against its adapter label,
        bounded: past ``4 x slots`` distinct names, new ones collapse
        into ``other``."""
        if self._loads_c is None and self._slots_used_g is None:
            return                       # telemetry off
        label = adapter or 'none'
        if label not in self._req_counters and \
                len(self._req_counters) >= self._label_cap:
            label = 'other'
        self._req_counter(label).inc()

    def stats(self) -> Dict[str, Any]:
        """The JSON ``lora`` block (``/metrics?format=json``)."""
        return {
            'slots': self.slots,
            'used': len(self._loaded),
            'free': self.slots - len(self._loaded),
            'rank': self.rank,
            'targets': list(self.targets),
            'loads_total': self.loads_total,
            'evictions_total': self.evictions_total,
            'last_load_ms': self.last_load_ms,
            'loaded': list(self._loaded),
            'pinned': {n: r for n, r in self._refs.items() if r > 0},
        }


# ---------------------------------------------------------------------------
# Constrained decoding (grammar -> vocab mask)
# ---------------------------------------------------------------------------
def json_mode_mask(vocab_size: int,
                   eos_id: Optional[int] = None) -> np.ndarray:
    """JSON-mode token mask for byte-level vocabularies: printable ASCII
    plus JSON whitespace (tab, newline, CR) plus EOS. A token-set
    constraint, not a stateful grammar: it excludes non-JSON bytes
    (control chars, non-ASCII) while admitting every ASCII JSON
    document."""
    mask = np.zeros(vocab_size, bool)
    lo, hi = 0x20, min(0x7F, vocab_size)
    mask[lo:hi] = True
    for b in (0x09, 0x0A, 0x0D):
        if b < vocab_size:
            mask[b] = True
    if eos_id is not None and 0 <= eos_id < vocab_size:
        mask[eos_id] = True
    return mask


def compile_grammar(grammar: Any, vocab_size: int,
                    eos_id: Optional[int] = None
                    ) -> Optional[np.ndarray]:
    """Request ``grammar`` field -> [vocab] bool mask (True = allowed),
    or None for unconstrained. Accepted spellings:

    - ``None``: no constraint;
    - ``'json'``: :func:`json_mode_mask`;
    - a sequence of allowed token ids (EOS auto-allowed so constrained
      requests can still terminate);
    - a [vocab] bool array, used as-is (EOS auto-allowed).
    """
    if grammar is None:
        return None
    if isinstance(grammar, str):
        if grammar == 'json':
            return json_mode_mask(vocab_size, eos_id)
        raise ValueError(
            f'unknown grammar {grammar!r}; supported: "json", a token-id '
            f'list, or a [vocab] bool mask')
    # A host-side request payload; the dtype is inferred so the bool
    # mask and the id list stay distinguishable.
    arr = np.asarray(grammar, dtype=None)
    if arr.dtype == np.bool_:
        if arr.shape != (vocab_size,):
            raise ValueError(
                f'grammar mask shape {arr.shape} != ({vocab_size},)')
        mask = arr.copy()
    else:
        ids = arr.astype(np.int64).reshape(-1)
        if ids.size == 0:
            raise ValueError('grammar token-id list is empty')
        if (ids < 0).any() or (ids >= vocab_size).any():
            raise ValueError('grammar token id out of vocab range')
        mask = np.zeros(vocab_size, bool)
        mask[ids] = True
    if eos_id is not None and 0 <= eos_id < vocab_size:
        mask[eos_id] = True
    return mask
