"""The traffic generator: one seed, one schedule; every seed the same
work in another order."""
import collections
import json
import os

import numpy as np

from perfbench.harness import traffic
from perfbench.harness.spec import BENCH_DIR

VOCAB = 32000


def _mix(name):
    with open(os.path.join(BENCH_DIR, 'traffic', name + '.json')) as f:
        return json.load(f)


def _sizes(reqs):
    return sorted((len(r.prompt), r.max_new, r.tenant, r.segment)
                  for r in reqs)


def test_same_seed_same_schedule():
    a = traffic.build_open(_mix('chat'), 2 ** 33 + 5, VOCAB, 3.0, 12, 45, 60)
    b = traffic.build_open(_mix('chat'), 2 ** 33 + 5, VOCAB, 3.0, 12, 45, 60)
    assert [(r.due, r.prompt, r.max_new) for r in a] == \
        [(r.due, r.prompt, r.max_new) for r in b]


def test_seeds_differ_in_order_not_in_work():
    a = traffic.build_open(_mix('chat'), 1, VOCAB, 3.0, 12, 45, 60)
    b = traffic.build_open(_mix('chat'), 2, VOCAB, 3.0, 12, 45, 60)
    assert _sizes(a) == _sizes(b)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    gaps = lambda rs, seg: sorted(round(y.due - x.due, 9) for x, y in zip(
        [r for r in rs if r.segment == seg],
        [r for r in rs if r.segment == seg][1:]))
    assert gaps(a, 'window') == gaps(b, 'window')


def test_window_holds_rate_times_seconds():
    reqs = traffic.build_open(_mix('docqa'), 7, VOCAB, 1.5, 8, 45, 30)
    window = [r for r in reqs if r.segment == 'window']
    assert len(window) == round(1.5 * 45)
    assert all(8 <= r.due < 8 + 45 for r in window)
    assert all(1024 <= len(r.prompt) <= 7936 for r in reqs)
    assert all(16 <= r.max_new <= 64 for r in reqs)


def test_tenants_share_system_prompts_by_zipf():
    reqs = traffic.Generator(_mix('chat'), 11, VOCAB).requests(1000, 'w')
    counts = collections.Counter(r.tenant for r in reqs)
    assert [counts[t] for t in range(4)] == [480, 240, 160, 120]
    sys_len = {0: 256, 1: 384, 2: 512, 3: 768}
    firsts = {}
    for r in reqs:
        head = tuple(r.prompt[:sys_len[r.tenant]])
        assert firsts.setdefault(r.tenant, head) == head


def test_closed_blocks_hold_the_distribution_once():
    reqs = traffic.build_closed(_mix('batch'), 3, VOCAB, 300)
    assert len(reqs) == 2 * traffic.CLOSED_BLOCK
    first, second = reqs[:traffic.CLOSED_BLOCK], reqs[traffic.CLOSED_BLOCK:]
    assert sorted(r.max_new for r in first) == \
        sorted(r.max_new for r in second)
    assert all(64 <= r.max_new <= 1024 for r in reqs)


def test_lengths_are_quantiles():
    spec = {'dist': 'lognormal', 'median': 256, 'sigma': 1.0, 'min': 16,
            'max': 2048}
    xs = traffic.lengths(spec, 1001)
    assert xs[500] == 256 and xs.min() >= 16 and xs.max() <= 2048
    u = traffic.lengths({'dist': 'uniform', 'min': 16, 'max': 64}, 49)
    assert list(u) == list(range(16, 65))



def test_balanced_order_deals_one_of_each_stratum_a_block():
    spec = {'dist': 'lognormal', 'median': 3072, 'sigma': 0.5,
            'min': 1024, 'max': 7936}
    key = traffic.lengths(spec, 32)
    a = traffic.balanced_order(key, 4, np.random.default_rng(1))
    b = traffic.balanced_order(key, 4, np.random.default_rng(2))
    assert sorted(a) == list(range(32)) and list(a) != list(b)
    # ``lengths`` is ascending, so an index's stratum is index // 8.
    for j in range(0, 32, 4):
        assert sorted(int(i) // 8 for i in a[j:j + 4]) == [0, 1, 2, 3]
    # A count that is no multiple of the block: still every index once.
    odd = traffic.balanced_order(traffic.lengths(spec, 31), 4,
                                 np.random.default_rng(3))
    assert sorted(odd) == list(range(31))


def test_balanced_mix_spreads_long_prompts_and_short_gaps():
    mix = dict(_mix('docqa'), balance=4)
    for seed in (1, 2 ** 33 + 7):
        w = [r for r in traffic.build_open(mix, seed, VOCAB, 0.72, 8, 45, 30)
             if r.segment == 'window']
        assert len(w) == 32
        lens = sorted(len(r.prompt) for r in w)
        top = set(lens[-8:])
        for j in range(0, 32, 4):
            assert sum(len(r.prompt) in top for r in w[j:j + 4]) == 1
        # Four consecutive gaps hold one of each quarter of the gaps, so
        # four arrivals span near four mean gaps (5.6 s).
        spans = [w[j + 4].due - w[j].due for j in range(0, 28, 4)]
        assert all(2.5 < s < 9.0 for s in spans)
    free = dict(_mix('docqa'))
    free.pop('balance', None)
    a = traffic.build_open(free, 5, VOCAB, 0.72, 8, 45, 30)
    b = traffic.build_open(mix, 5, VOCAB, 0.72, 8, 45, 30)
    assert _sizes(a) == _sizes(b)
