"""What the readers share: the run's records and readings, and the
statistics taken over them.

A percentile is over every request of the window (a failed one counts
as the worst reading); a rate is over the whole window's seconds.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List, Optional, Sequence

from perfbench.harness import costs
from perfbench.harness.devtrace import Slice
from perfbench.reference.sizes import Sizes


def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """The ``p``-th percentile (linear between order statistics, as
    ``statistics.quantiles(method='inclusive')``); None for fewer than
    two values."""
    vals = sorted(values)
    if len(vals) < 2:
        return None
    return statistics.quantiles(vals, n=100, method='inclusive')[
        int(round(p)) - 1]


@dataclasses.dataclass
class Run:
    """One run's records and readings, as the readers see them."""
    cell: Any                        # spec.Cell
    sizes: Sizes
    records: List[Any]               # client.Record, every request sent
    w0: float                        # the window, monotonic seconds
    w1: float
    setup_s: float
    cap_s: float
    metrics0: Dict[str, Any]         # /metrics?format=json at w0, w1
    metrics1: Dict[str, Any]
    prom0: str                       # /metrics (Prometheus text) at w0, w1
    prom1: str
    traces: List[Any] = dataclasses.field(default_factory=list)
    page: int = 0
    slice: Optional[Slice] = None    # the traced slice, --trace 1

    @property
    def seconds(self) -> float:
        return self.w1 - self.w0

    @property
    def window(self) -> List[Any]:
        """The requests due inside the window: the sample."""
        return [r for r in self.records if self.w0 <= r.due < self.w1]

    def ttft_ms(self, rec) -> float:
        if not rec.ok:
            return self.cap_s * 1e3
        return (rec.times[0] - rec.due) * 1e3

    def tokens_between(self, a: float, b: float, first: bool = True) -> int:
        """Tokens that arrived in ``[a, b)`` (without each request's
        first token unless ``first``)."""
        n = 0
        for r in self.records:
            times = r.times if first else r.times[1:]
            n += sum(1 for t in times if a <= t < b)
        return n

    def decoding_rows(self, t: float):
        """(prompt length, tokens so far) of the requests decoding at
        ``t``, as the client saw them: first token in, last not yet."""
        out = []
        for r in self.records:
            if r.times and r.times[0] <= t and (
                    len(r.times) < r.req.max_new or r.times[-1] > t):
                got = sum(1 for x in r.times if x <= t)
                out.append((len(r.req.prompt), got))
        return out

    def traces_between(self, a: float, b: float):
        """Request spans whose queue span began in ``[a, b)``."""
        return [t for t in self.traces if t[2] is not None and a <= t[2] < b]

    def prefill_tokens_between(self, a: float, b: float) -> float:
        """Prompt tokens prefilled in ``[a, b)``: each prefill chunk's
        tokens times the share of its span inside."""
        n = 0.0
        for tr in self.traces:
            for c in tr[4]:
                t0, t1, tokens = c[0], c[1], c[2]
                ov = min(b, t1) - max(a, t0)
                if ov > 0:
                    n += tokens * (ov / (t1 - t0) if t1 > t0 else 1.0)
        return n

    def kv_bytes_per_token(self) -> int:
        return costs.kv_bytes_per_token(self.sizes)
