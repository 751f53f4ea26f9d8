"""Tails over every request of the window, rates over the whole
window."""
from types import SimpleNamespace

from perfbench.harness import client, stats
from perfbench.harness.spec import load_reader
from perfbench.harness.traffic import Request


def _rec(due, times, max_new=None, ok=True):
    req = Request(0, 'window', 0.0, [1] * 10, max_new or len(times))
    rec = client.Record(req, due, sent=due, times=list(times),
                        tokens=[0] * len(times) if ok else [], done=ok)
    return rec


def _run(records, w0=100.0, w1=110.0, cap_s=50.0):
    return stats.Run(cell=None, sizes=None, records=records, w0=w0, w1=w1,
                     setup_s=1.0, cap_s=cap_s, metrics0={}, metrics1={},
                     prom0='', prom1='')


def test_percentile():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 90) == 90.1
    assert stats.percentile([5.0], 90) is None


def test_ttft_tail_counts_every_window_request_and_failures_as_cap():
    recs = [_rec(100.0 + i, [100.0 + i + 0.1 * (i + 1), 200.0])
            for i in range(9)]
    recs.append(_rec(109.0, [], max_new=2, ok=False))    # failed
    recs.append(_rec(99.0, [99.5, 99.6]))                # ramp: not sampled
    run = _run(recs)
    assert len(run.window) == 10
    ttft = load_reader('ttft_p90_ms').read(run)
    assert abs(ttft - stats.percentile(
        [100.0 * (i + 1) for i in range(9)] + [50e3], 90)) < 1e-6


def test_tpot_over_each_request():
    recs = [_rec(100.0, [101.0, 101.1, 101.2]), _rec(101.0, [102.0, 104.0])]
    tpot = load_reader('tpot_p90_ms').read(_run(recs))
    assert abs(tpot - stats.percentile([100.0, 2000.0], 90)) < 1e-9


def test_output_rate_over_the_whole_window():
    # Tokens before, inside and after the window; every request counts,
    # ramp or not.
    recs = [_rec(95.0, [99.0, 100.0, 105.0, 109.99, 110.0]),
            _rec(101.0, [102.0, 103.0])]
    assert load_reader('output_tok_s').read(_run(recs)) == 5 / 10.0


def test_counters_between_the_window_ends():
    run = _run([_rec(100.0, [101.0, 102.0, 103.0, 104.0])])
    run.metrics0, run.metrics1 = {'decode_substeps': 10}, \
        {'decode_substeps': 13}
    assert load_reader('decode_rows_mean').read(run) == 1.0
    run.prom0 = 'skytpu_request_queue_wait_ms_sum 10\n' \
                'skytpu_request_queue_wait_ms_count 2\n'
    run.prom1 = 'skytpu_request_queue_wait_ms_sum 40\n' \
                'skytpu_request_queue_wait_ms_count 5\n'
    assert load_reader('sched_queue_wait_ms').read(run) == 10.0
    run.traces = [(1, 100, 101.0, 50, []), (2, 300, 102.0, 0, []),
                  (3, 100, 90.0, 100, [])]
    assert load_reader('prefix_hit_share').read(run) == 100 * 50 / 400


def test_slice_readings():
    from perfbench.harness.devtrace import Slice
    raw = {'t0': 0.0, 't1': 1.0,
           'names': ['cudaGraphLaunch', 'cudaLaunchKernel', 'gemm',
                     'paged_decode_kernel<bf16>'],
           # (name, start ns, duration ns, correlation, kind)
           'dev': [(3, 0, 100, 7, 'kernel'), (3, 100, 100, 7, 'kernel'),
                   (2, 300, 200, 9, 'kernel'), (2, 400, 200, 11, 'kernel')],
           'rt': [(0, 0, 10, 7), (1, 250, 10, 9), (1, 380, 10, 11)]}
    sl = Slice(raw)
    assert len(sl.graph) == 2 and len(sl.eager) == 2
    assert sl.busy_s() == 400 / 1e9 + 200 / 1e9 - 100 / 1e9
    assert sl.graph_launches(min_kernels=2) == 1
    assert sl.device_ops()[0][0] == 'gemm'
    gaps = sl.idle_gaps()
    assert gaps == [['cudaLaunchKernel', 100 / 1e9]]
    run = _run([])
    run.slice = sl
    run.sizes = SimpleNamespace(n_layers=2)
    assert abs(load_reader("decode_step_ms").read(run) - 200 / 1e6) < 1e-15
