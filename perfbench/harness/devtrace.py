"""The device trace of a traced run's slice, and its arithmetic.

``start`` and ``read`` run in the server process: ``torch.profiler``
with the CUDA activity only (CUPTI's kernels, copies and fills, and the
runtime calls that launched them; no host operator tracing, which would
cost more than the eager prefill it watches), stopped at the slice's
end. ``read``, once the window has closed, returns the slice as plain
tuples, so the readers in the harness process never touch the
profiler:

- ``dev``: ``(name index, start ns, duration ns, correlation, kind)``
  for every device activity;
- ``rt``: ``(name index, start ns, duration ns, correlation)`` for
  every CUDA runtime or driver call on the host;
- ``names``: the interned names; ``t0``/``t1``: the slice's ends on the
  host's monotonic clock.

A kernel launched by a CUDA graph replay carries the correlation id of
its ``cudaGraphLaunch`` call; every other kernel was launched eagerly.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Substrings of the kernel names of K1 (``csrc/paged_decode.cuh``).
K1_NAMES = ('paged_decode_kernel',)
_NAME_CHARS = 160


def start(on_cuda: bool):
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA if on_cuda
                               else ProfilerActivity.CPU])
    prof.start()
    return prof, time.monotonic()


def read(handle, t1: float) -> Dict[str, Any]:
    """The events of a stopped profiler, as compact tuples; ``t1`` is
    when it stopped."""
    prof, t0 = handle
    names: Dict[str, int] = {}
    dev, rt = [], []

    def idx(name: str) -> int:
        return names.setdefault(name[:_NAME_CHARS], len(names))

    for e in prof.profiler.kineto_results.events():
        kind = str(e.activity_type()) if hasattr(e, 'activity_type') else ''
        row = (idx(e.name()), int(e.start_ns()), int(e.duration_ns()),
               int(e.correlation_id()))
        if 'CUDA' in str(e.device_type()):
            dev.append(row + (kind,))
        elif 'cuda' in kind.lower() or e.name().startswith(('cuda', 'cu')):
            rt.append(row)
    return {'t0': t0, 't1': t1, 'dev': dev, 'rt': rt,
            'names': [n for n, _ in sorted(names.items(),
                                           key=lambda kv: kv[1])]}


def _merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Slice:
    """Readings of one traced slice."""

    def __init__(self, raw: Dict[str, Any]):
        self.raw = raw
        self.names = raw['names']
        self.dev = raw['dev']
        self.rt = raw['rt']
        self.window_s = raw['t1'] - raw['t0']
        graph = {c for n, _, _, c in self.rt
                 if 'GraphLaunch' in self.names[n]}
        self.graph = [d for d in self.dev if d[3] in graph]
        self.eager = [d for d in self.dev if d[3] not in graph]

    def name(self, ev) -> str:
        return self.names[ev[0]]

    @staticmethod
    def seconds(events) -> float:
        """Summed durations (s)."""
        return sum(e[2] for e in events) / 1e9

    def graph_launches(self, min_kernels: int) -> int:
        """Graph replays in the slice that ran at least ``min_kernels``
        kernels."""
        per = collections.Counter(e[3] for e in self.kernels(self.graph))
        return sum(1 for n in per.values() if n >= min_kernels)

    def busy_s(self) -> float:
        """Seconds in which some device activity ran (their union)."""
        return sum(b - a for a, b in
                   _merge([(e[1], e[1] + e[2]) for e in self.dev])) / 1e9

    def kernels(self, events=None, named: Optional[Sequence[str]] = None):
        """The kernels among ``events`` (default: all), optionally those
        whose name holds one of ``named``."""
        out = [e for e in (self.dev if events is None else events)
               if 'kernel' in e[4].lower() or not e[4]]
        if named is not None:
            out = [e for e in out if any(s in self.name(e) for s in named)]
        return out

    def device_ops(self, top: int = 10) -> List[List[Any]]:
        """The device activities that took the most time, by name."""
        acc: Dict[str, float] = collections.Counter()
        for e in self.dev:
            acc[self.name(e)] += e[2] / 1e9
        return [[n, s] for n, s in acc.most_common(top)]

    def idle_gaps(self, top: int = 10) -> List[List[Any]]:
        """Device idle time, by the host CUDA call that overlapped each
        gap the most (``host code`` where none did)."""
        busy = _merge([(e[1], e[1] + e[2]) for e in self.dev])
        calls = sorted((e[1], e[1] + e[2], self.names[e[0]])
                       for e in self.rt)
        acc: Dict[str, float] = collections.Counter()
        j = 0
        for (_, a), (b, _) in zip(busy, busy[1:]):
            while j < len(calls) and calls[j][1] < a:
                j += 1
            best, label = 0, 'host code'
            k = j
            while k < len(calls) and calls[k][0] <= b:
                c0, c1, n = calls[k]
                ov = min(b, c1) - max(a, c0)
                if ov > best:
                    best, label = ov, n
                k += 1
            acc[label] += (b - a) / 1e9
        return [[n, s] for n, s in acc.most_common(top)]
