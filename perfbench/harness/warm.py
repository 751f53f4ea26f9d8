"""Warm the decode shapes a cell's traffic will use, before the ramp.

The paged engine captures one CUDA graph per (horizon, sample, P) for a
decode step and one per (horizon, P) for the ring merge at the first
call with that key, P being the power-of-two bucket of the pages the
longest decoding row holds. The server runs a call at horizon 32 while
at least half of its slots decode and nothing waits for prefill, at
horizon 8 otherwise, and serves greedy requests with the argmax
variant only. So for every P bucket the traffic can reach, one round
of requests sends one long prompt whose rows land in that bucket and,
once it decodes, ``max_batch / 2`` short ones beside it: together they
decode at horizon 32, and the long one alone at horizon 8 before and
after. No capture is then
left for the measured window; the harness counts captures across the
window and says if one happened there.
"""
from __future__ import annotations

import concurrent.futures
import time
from typing import List

import numpy as np

from perfbench.harness import client
from perfbench.harness.traffic import Request

LONG_NEW = 96
SHORT_NEW = 48
SHORT_PROMPT = 16


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def page_buckets(mix, max_seq: int, page: int, horizon: int = 32
                 ) -> List[int]:
    """The P buckets the mix's decode calls can reach."""
    shared = mix['prompt'].get('shared')
    sys_min = min(shared['lengths']) if shared else 0
    sys_max = max(shared['lengths']) if shared else 0
    unique, out = mix['prompt']['unique'], mix['output']
    lo = sys_min + unique['min'] + 1
    hi = min(max_seq, sys_max + unique['max'] + out['max'] + horizon)
    first, last = _bucket(-(-lo // page)), _bucket(-(-hi // page))
    return [p for p in (2 ** i for i in range(16)) if first <= p <= last]


def rounds(mix, max_batch: int, max_seq: int, page: int, vocab: int,
           seed: int) -> List[List[Request]]:
    rng = np.random.default_rng([int(seed), 5])
    out = []
    for P in page_buckets(mix, max_seq, page):
        # Its rows at its last step (prompt + LONG_NEW + a horizon) in
        # the upper half of bucket P.
        target = int(0.75 * P * page) - LONG_NEW - 32
        n = max(SHORT_PROMPT, min(target, max_seq - LONG_NEW - 64))
        reqs = [Request(-1, 'warm', None,
                        rng.integers(0, vocab, n).tolist(), LONG_NEW)]
        reqs += [Request(-1, 'warm', None,
                         rng.integers(0, vocab, SHORT_PROMPT).tolist(),
                         SHORT_NEW) for _ in range(max(1, max_batch // 2))]
        out.append(reqs)
    return out


def run(port: int, mix, max_batch: int, max_seq: int, page: int,
        vocab: int, seed: int, cap_s: float) -> List[str]:
    """Send every round, one after the other: the long request first,
    the short ones once its first token is back (so they decode beside
    it, not before it ends its prefill); returns what each request that
    failed said."""
    failed = []
    with concurrent.futures.ThreadPoolExecutor(max_batch + 1) as pool:
        for reqs in rounds(mix, max_batch, max_seq, page, vocab, seed):
            now = time.monotonic()
            recs = [client.Record(r, now) for r in reqs]
            long_f = pool.submit(client.stream, port, recs[0], now + cap_s)
            while not (recs[0].times or long_f.done()):
                time.sleep(0.01)
            shorts = [pool.submit(client.stream, port, rec, now + cap_s)
                      for rec in recs[1:]]
            for f in [long_f] + shorts:
                rec = f.result()
                if not rec.ok:
                    failed.append(f'prompt {len(rec.req.prompt)}, '
                                  f'{len(rec.tokens or rec.times)} of '
                                  f'{rec.req.max_new} tokens: {rec.error}')
    return failed
