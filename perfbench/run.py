"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json`` at the checkout's root; its
configuration, traffic mix, settings and metric readers are files under
``perfbench/`` found by name (``harness/spec.py``). A run:

1. looks for the cards the cell asks for, and stops with no result
   where there are fewer;
2. starts the server process (``harness/server.py``): weights drawn on
   the device from ``--seed``, ``skypilot_tpu_torch``'s ``ModelServer``
   on the paged engine with the server's defaults;
3. warms the decode shapes of the cell's traffic (``harness/warm.py``),
   then plays the traffic (``harness/traffic.py``, the requests and
   their order drawn from ``--seed``): a ramp of at least one mean
   request's length, so the batch is full when timing starts, then the
   measured window of ``--seconds``, the load kept on until every
   request due in the window has ended or reached the cell's cap;
4. with ``--trace 1``, profiles the device over ``slice_s`` seconds
   in mid-window (``harness/devtrace.py``), and reports the
   cell's per-layer metrics instead of its end-to-end ones;
5. stops the server, runs the fp32 reference over a seeded sample of
   the window's requests (``harness/check.py``) and prints the result
   as the last line of standard output, the numbers compared with
   their limits last on standard error.

Everything the run caches stays inside the checkout, under
``.perfbench/`` (kernel builds under ``skypilot_tpu_torch/_build/``).

Calibration only, never in the benchmark's own runs: ``--control 1``
also reads the fp8 control on the same sample, ``--sweep r1,r2,..``
measures one server at each rate in turn for the knee.
"""
from __future__ import annotations

import time

T_START = time.monotonic()     # set-up is timed from the process start

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import multiprocessing  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench.harness import (client, devtrace, imports, spec,  # noqa: E402
                               stats, traffic, warm)
from perfbench.reference.sizes import Sizes  # noqa: E402

# The server's load, warm-up and the reference take the rest of the
# 360 s a run has; a server that is not ready by then has failed.
READY_TIMEOUT_S = 240.0


def _err(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path in the checkout."""
    base = os.path.join(root, '.perfbench', 'cache')
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton')):
        path = os.path.join(base, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    # Keep any library that could load JAX by itself from doing so.
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def _card() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'unknown'


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--control', type=int, choices=(0, 1), default=0,
                    help='calibration: also read the fp8 control')
    ap.add_argument('--sweep', default=None,
                    help='calibration: comma-separated rates for the knee')
    return ap.parse_args(argv)


class _Server:
    """The server process and its pipe."""

    def __init__(self, job: Dict[str, Any]):
        ctx = multiprocessing.get_context('spawn')
        self.conn, child = ctx.Pipe()
        from perfbench.harness import server
        self.proc = ctx.Process(target=server.serve, args=(child, job),
                                daemon=True)
        self.proc.start()
        child.close()
        self.port = job['port']

    def recv(self, timeout: float) -> Dict[str, Any]:
        if not self.conn.poll(timeout):
            raise TimeoutError(f'server process silent for {timeout:.0f} s')
        msg = self.conn.recv()
        if 'error' in msg:
            raise RuntimeError(f'server process: {msg["error"]}\n'
                               f'{msg.get("traceback", "")}')
        return msg

    def ask(self, cmd: str, timeout: float = 120.0) -> Dict[str, Any]:
        self.conn.send({'cmd': cmd})
        return self.recv(timeout)

    def close(self) -> None:
        self.proc.join(timeout=60)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=30)
        self.conn.close()


def _job(cell: spec.Cell, seed: int, device: str, fault,
         trace: bool) -> Dict[str, Any]:
    return {'hf': cell.hf, 'config_name': cell.config['name'],
            'port_config': cell.config.get('port_config', {}),
            'seed': int(seed), 'device': device, 'trace': trace,
            'port': client.free_port(), 'engine': cell.settings['engine'],
            'ready_timeout_s': READY_TIMEOUT_S, 'fault': fault}


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def play(srv: _Server, cell: spec.Cell, sizes: Sizes, seed: int,
         seconds: float, trace: bool, rate: Optional[float]
         ) -> stats.Run:
    """The ramp, the window and the tail."""
    st = cell.settings
    cap_s = float(st['cap_s'])
    ramp_s, slice_s = float(st['ramp_s']), float(st['slice_s'])
    stop = threading.Event()
    recs: List[client.Record] = []
    t_start = time.monotonic() + 0.1
    w0, w1 = t_start + ramp_s, t_start + ramp_s + seconds
    if cell.traffic['arrivals'] == 'closed':
        reqs = traffic.build_closed(cell.traffic, seed, sizes.vocab,
                                    int(st['max_requests']))
        n_window = None
        # The clients stop sending at the window's end, so the window's
        # last requests drain without new ones admitted ahead of them.
        body = (client.run_closed, srv.port, reqs,
                int(st['arrivals']['clients']), cap_s,
                lambda: time.monotonic() < w1 and not stop.is_set(), recs,
                t_start)
    else:
        r = rate if rate is not None else float(st['arrivals']['rate_per_s'])
        reqs = traffic.build_open(cell.traffic, seed, sizes.vocab, r, ramp_s,
                                  seconds, cap_s)
        n_window = sum(1 for q in reqs if q.segment == 'window')
        body = (client.run_open, srv.port, reqs, t_start, cap_s,
                stop.is_set, recs)
    loader = threading.Thread(target=body[0], args=body[1:], daemon=True)
    loader.start()
    _sleep_until(w0)
    keys0 = set(srv.ask('keys')['keys'])
    m0 = client.get_json(srv.port, '/metrics?format=json')
    p0 = client.get_text(srv.port, '/metrics')
    raw = None
    if trace:
        # A steady slice in mid-window, kept in memory.
        _sleep_until(w0 + (seconds - slice_s) / 2)
        srv.ask('prof_start')
        _sleep_until(w0 + (seconds + slice_s) / 2)
        srv.ask('prof_stop')
    _sleep_until(w1)
    m1 = client.get_json(srv.port, '/metrics?format=json')
    p1 = client.get_text(srv.port, '/metrics')
    new_keys = sorted(set(srv.ask('keys')['keys']) - keys0)
    if trace:
        raw = srv.ask('prof_read', timeout=240)
    # Every request due in the window is followed to its end or cap.
    deadline = w1 + cap_s + 5
    while time.monotonic() < deadline:
        due = [x for x in list(recs) if w0 <= x.due < w1]
        if ((n_window is None or len(due) >= n_window)
                and all(x.done or x.error is not None for x in due)):
            break
        time.sleep(0.1)
    stop.set()
    if n_window is not None and len(due) < n_window:
        raise RuntimeError(f'the load generator sent {len(due)} of the '
                           f'window\'s {n_window} requests')
    run = stats.Run(cell=cell, sizes=sizes, records=recs, w0=w0, w1=w1,
                    setup_s=w0 - T_START, cap_s=cap_s, metrics0=m0,
                    metrics1=m1, prom0=p0, prom1=p1, page=srv.page,
                    slice=devtrace.Slice(raw) if raw else None)
    run.loader = loader
    run.new_keys = new_keys
    return run


def _finish(srv: _Server, run: Optional[stats.Run]) -> Dict[str, Any]:
    fin = srv.ask('finish', timeout=120)
    if run is not None:
        run.traces = fin['traces']
        run.loader.join(timeout=run.cap_s + 30)
    srv.close()
    return fin


def _result(cell, run: stats.Run, trace: bool, fin, kind: str, card: str,
            verdict) -> Dict[str, Any]:
    metrics: Dict[str, Any] = {}
    for m in cell.metrics_for(trace):
        value = m.reader.read(run)
        if value is None or not math.isfinite(value):
            _err(f'metric {m.name}: nothing to read in this run')
            continue
        metrics[m.name] = {'value': float(value), 'unit': m.unit}
    window = run.window
    device = {'platform': 'gpu', 'kind': kind, 'count': cell.chips,
              'memory_peak_bytes': fin['memory_peak_bytes']}
    out: Dict[str, Any] = {
        'correct': verdict.correct, 'attempted': len(window),
        'failed': sum(1 for r in window if not r.ok),
        'metrics': metrics, 'device': device}
    if trace and run.slice is not None:
        device['busy_s'] = run.slice.busy_s()
        device['window_s'] = run.slice.window_s
        out['breakdown'] = {'device_ops': run.slice.device_ops(),
                            'idle_gaps': run.slice.idle_gaps()}
    late = [r.sent - r.due for r in window if r.sent]
    out['card'] = card
    out['run'] = {
        'requests_sent': len(run.records),
        'loader_late_p90_ms': (stats.percentile(late, 90) or 0.0) * 1e3,
        'graph_captures_in_window': (run.metrics1.get('graph_captures', 0)
                                     - run.metrics0.get('graph_captures', 0)),
        'graph_keys_in_window': run.new_keys,
        # Each window request's (due s into the window, prompt tokens,
        # TTFT ms), to tell a stall that delays every request near one
        # time from the queue's own tail.
        'ttfts_ms': [[round(r.due - run.w0, 3), len(r.req.prompt),
                      round(run.ttft_ms(r), 1)] for r in window],
        'check': verdict.info}
    out['compared'] = verdict.compared
    return out


def main(argv=None, *, device: Optional[str] = None,
         root: str = ROOT, fault: Optional[str] = None) -> int:
    """One run; ``device``, ``root`` and ``fault`` are for the harness's
    own tests (no look for a card, another checkout, a planted fault in
    the server process)."""
    args = parse(argv)
    cell = spec.load_cell(args.workload, root=root)
    if device is None:
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            _err(f'{args.workload} needs {cell.chips} CUDA device(s); '
                 f'this machine has {have}: no result')
            return 3
        device = 'cuda'
    _cache_env(root)
    card = _card() if device == 'cuda' else 'cpu'
    sizes = Sizes.from_hf(cell.hf)
    srv = _Server(_job(cell, args.seed, device, fault,
                       bool(args.trace)))
    run = None
    try:
        ready = srv.recv(READY_TIMEOUT_S + 60)
        srv.page = ready['page']
        eng = cell.settings['engine']
        bad = warm.run(srv.port, cell.traffic, eng['max_batch'],
                       eng['max_seq'], srv.page, sizes.vocab, args.seed,
                       float(cell.settings['cap_s']))
        if bad:
            raise RuntimeError(f'{len(bad)} warm-up request(s) failed: '
                               + '; '.join(bad[:4]))
        if args.sweep:
            return sweep(srv, cell, sizes, args)
        run = play(srv, cell, sizes, args.seed, args.seconds,
                   bool(args.trace), None)
    finally:
        fin = _finish(srv, run) if srv.proc.is_alive() else None
    forbidden = sorted(set(imports.forbidden_loaded())
                       | set(fin['forbidden']))
    if forbidden:
        _err('forbidden modules loaded: ' + ', '.join(forbidden)
             + ': no result')
        return 4
    from perfbench.harness import check
    ck = cell.settings['check']
    verdict = check.judge(
        check.sample(run.window, args.seed, ck['min_tokens'],
                     ck['max_requests']),
        sizes, args.seed, device, {'logit_gap': ck['logit_gap']},
        tie_margin=ck.get('tie_margin'), control=bool(args.control))
    out = _result(cell, run, bool(args.trace), fin, ready['kind'], card,
                  verdict)
    _err(f'card: {card}')
    for k, v in verdict.info.items():
        _err(f'check {k}: {v}')
    for k, v in verdict.compared.items():
        _err(f'compared {k}: {v["value"]} limit {v["limit"]}')
    print(json.dumps(out), flush=True)
    return 0


def _sweep_line(run: stats.Run, rate: float) -> Dict[str, Any]:
    window = run.window
    ttft = [run.ttft_ms(r) for r in window]
    tpot = [(r.times[-1] - r.times[0]) / (len(r.times) - 1) * 1e3
            for r in window if r.ok and len(r.times) > 1]
    third = max(1, len(ttft) // 3)
    return {'rate_per_s': rate, 'requests': len(window),
            'failed': sum(1 for r in window if not r.ok),
            'queue_depth_w0': run.metrics0.get('queue_depth'),
            'queue_depth_w1': run.metrics1.get('queue_depth'),
            'ttft_p90_ms': stats.percentile(ttft, 90),
            'ttft_p50_first_third_ms': stats.percentile(ttft[:third], 50),
            'ttft_p50_last_third_ms': stats.percentile(ttft[-third:], 50),
            'tpot_p90_ms': stats.percentile(tpot, 90),
            'output_tok_s': run.tokens_between(run.w0, run.w1) / run.seconds,
            'graph_captures_in_window': (run.metrics1.get('graph_captures', 0)
                                         - run.metrics0.get('graph_captures',
                                                            0))}


def sweep(srv: _Server, cell: spec.Cell, sizes: Sizes, args) -> int:
    """The knee: one server, each rate in turn for ``--seconds``, a line
    each (queue depth at the window's ends, TTFT and TPOT p90, tok/s)."""
    for i, rate in enumerate(float(r) for r in args.sweep.split(',')):
        run = play(srv, cell, sizes, args.seed + i, args.seconds, False,
                   rate)
        run.loader.join(timeout=run.cap_s + 30)
        print(json.dumps(_sweep_line(run, rate)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
