"""The one traffic generator: a mix's data file and a seed -> requests.

Every seed gets the same work in another order. Within each segment
of the schedule (the ramp, the measured window, the tail that keeps
the load on while the window's requests finish) the request sizes are
the distribution's quantiles at ``(i + 0.5) / n``, and the gaps between
open-loop arrivals are the exponential distribution's quantiles scaled
to fill the segment exactly; the seed permutes them and draws the token
ids. So two seeds differ in order, ids and which prompts meet in a
batch, and not in how much there is to do.

A mix file holds:

- ``prompt``: ``shared`` (optional: ``lengths`` of the tenants' system
  prompts and ``zipf_s``, the skew of requests over tenants) and
  ``unique``, the length of each request's own part;
- ``output``: the tokens each request asks for (it gets exactly that
  many: no end-of-sequence id is sent);
- ``arrivals``: ``poisson`` (open loop, at the cell's ``rate_per_s``)
  or ``closed`` (the cell's ``clients`` each send their next request
  when the last one ends);
- ``balance`` (optional, a block size ``B``): the seed's order is dealt
  so that each run of ``B`` consecutive requests holds one of each of
  ``B`` strata of prompt length, and each run of ``B`` consecutive gaps
  one of each of ``B`` strata of the gaps. A window then never holds a
  burst of the longest prompts at the shortest gaps, which one seed in
  a few draws where the order is free and which would make that seed's
  tail the run's whole reading.

A length is ``{"dist": "lognormal", "median", "sigma", "min", "max"}``
or ``{"dist": "uniform", "min", "max"}`` (both ends included).
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Any, Dict, List, Optional

import numpy as np

_NORMAL = statistics.NormalDist()
# Closed-loop requests are drawn in blocks that each hold the whole
# distribution once.
CLOSED_BLOCK = 256


@dataclasses.dataclass
class Request:
    idx: int
    segment: str                 # 'ramp' | 'window' | 'tail'
    due: Optional[float]         # seconds after the schedule starts; None
                                 # for a closed loop (sent when a client
                                 # is free)
    prompt: List[int]
    max_new: int
    tenant: int = -1             # system prompt index, -1 = none


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lengths(spec: Dict[str, Any], n: int) -> np.ndarray:
    """The ``n`` stratified lengths of ``spec``, ascending."""
    u = _quantiles(n)
    if spec['dist'] == 'lognormal':
        z = np.array([_NORMAL.inv_cdf(float(x)) for x in u])
        x = spec['median'] * np.exp(spec['sigma'] * z)
    elif spec['dist'] == 'uniform':
        x = spec['min'] + u * (spec['max'] - spec['min'] + 1) - 0.5
    else:
        raise ValueError(f'unknown length distribution {spec["dist"]!r}')
    return np.clip(np.rint(x), spec['min'], spec['max']).astype(np.int64)


def balanced_order(key: np.ndarray, block: int,
                   rng: np.random.Generator) -> np.ndarray:
    """A seeded order of ``range(len(key))`` dealt in ``ceil(n / block)``
    runs of consecutive positions, each holding at most one index of
    each of ``block`` strata of ``key`` (its ranks cut into runs of
    ``ceil(n / block)``); where the last stratum is short, the seed picks
    which runs lack a member of it."""
    n = len(key)
    m = -(-n // block)
    ranked = np.argsort(key, kind='stable')
    blocks: List[List[int]] = [[] for _ in range(m)]
    for j in range(block):
        stratum = rng.permutation(ranked[j * m:(j + 1) * m])
        for idx, b in zip(stratum, rng.permutation(m)):
            blocks[b].append(int(idx))
    return np.array([i for b in blocks for i in rng.permutation(b)],
                    dtype=np.int64)


def _tenant_counts(n: int, k: int, s: float) -> np.ndarray:
    """Zipf(s) shares of ``n`` requests over ``k`` tenants, rounded by
    largest remainder."""
    p = 1.0 / np.arange(1, k + 1) ** s
    exact = n * p / p.sum()
    counts = np.floor(exact).astype(np.int64)
    for j in np.argsort(-(exact - counts))[:n - counts.sum()]:
        counts[j] += 1
    return counts


class Generator:
    """Requests of one mix for one seed, over a vocabulary of ``vocab``
    ids."""

    def __init__(self, mix: Dict[str, Any], seed: int, vocab: int):
        self.mix = mix
        self.vocab = vocab
        self.seed = int(seed)
        self._rng = np.random.default_rng([self.seed, 1])
        shared = mix['prompt'].get('shared')
        self.system = [self._ids(n) for n in
                       (shared['lengths'] if shared else [])]
        self._next = 0

    def _ids(self, n: int) -> List[int]:
        return self._rng.integers(0, self.vocab, int(n)).tolist()

    def requests(self, n: int, segment: str,
                 dues: Optional[np.ndarray] = None) -> List[Request]:
        """``n`` requests holding the distribution once, in seeded
        order. Which unique length, output length and tenant go
        together is fixed by ``n`` alone, so every seed sends the same
        request shapes."""
        pair = np.random.default_rng([n, 0])
        unique = pair.permutation(lengths(self.mix['prompt']['unique'], n))
        out_len = pair.permutation(lengths(self.mix['output'], n))
        tenants = np.full(n, -1)
        if self.system:
            shared = self.mix['prompt']['shared']
            counts = _tenant_counts(n, len(self.system), shared['zipf_s'])
            tenants = pair.permutation(np.repeat(np.arange(len(counts)),
                                                 counts))
        rng = np.random.default_rng([self.seed, 2, self._next])
        if self.mix.get('balance'):
            sys_len = np.array([len(p) for p in self.system] + [0])
            order = balanced_order(sys_len[tenants] + unique,
                                   int(self.mix['balance']), rng)
        else:
            order = rng.permutation(n)
        reqs = []
        for i in order:
            t = int(tenants[i])
            prompt = (list(self.system[t]) if t >= 0 else []) + \
                self._ids(unique[i])
            reqs.append(Request(self._next, segment, None, prompt,
                                int(out_len[i]), t))
            self._next += 1
        if dues is not None:
            for r, d in zip(reqs, dues):
                r.due = float(d)
        return reqs

    def open_segment(self, start: float, seconds: float, rate: float,
                     segment: str) -> List[Request]:
        """Poisson arrivals at ``rate`` over ``[start, start +
        seconds)``: ``round(rate * seconds)`` requests, the exponential
        distribution's quantiles scaled to the segment as the gaps
        between them. The smallest gap is split between the segment's
        two ends; the seed permutes the others."""
        n = max(1, int(round(rate * seconds)))
        gaps = -np.log1p(-_quantiles(n))
        gaps *= seconds / gaps.sum()
        rng = np.random.default_rng([self.seed, 3, self._next])
        if self.mix.get('balance'):
            inner = gaps[1:][balanced_order(gaps[1:],
                                            int(self.mix['balance']), rng)]
        else:
            inner = rng.permutation(gaps[1:])
        dues = start + gaps[0] / 2 + np.concatenate([[0.0],
                                                      np.cumsum(inner)])
        return self.requests(n, segment, dues[:n])


def build_open(mix, seed: int, vocab: int, rate: float, ramp_s: float,
               seconds: float, tail_s: float) -> List[Request]:
    """The whole open-loop schedule: ramp, window, tail."""
    g = Generator(mix, seed, vocab)
    return (g.open_segment(0.0, ramp_s, rate, 'ramp')
            + g.open_segment(ramp_s, seconds, rate, 'window')
            + g.open_segment(ramp_s + seconds, tail_s, rate, 'tail'))


def build_closed(mix, seed: int, vocab: int, n: int) -> List[Request]:
    """``n`` closed-loop requests (rounded up to whole blocks), each
    block the distribution once; their segment is set when sent."""
    g = Generator(mix, seed, vocab)
    out: List[Request] = []
    for _ in range(math.ceil(n / CLOSED_BLOCK)):
        out += g.requests(CLOSED_BLOCK, 'unsent')
    return out
