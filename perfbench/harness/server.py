"""The server process: the system under test, and nothing else.

``serve(conn, job)`` runs in a child process of the harness (spawned,
so it starts from a fresh interpreter). It draws the configuration's
weights on the device from the seed (``reference/weights.py``), builds
``skypilot_tpu_torch.serve.server.ModelServer`` over them with the
cell's engine settings and the server's defaults otherwise, and serves
HTTP on a local port until the harness says ``finish``. The load comes
from the parent process, so the client never holds this process's
interpreter lock.

Over ``conn`` (a ``multiprocessing`` pipe) it answers:

- ``prof_start`` / ``prof_stop`` / ``prof_read``: ``torch.profiler``
  over the device activity only (kernels, copies, fills and the CUDA
  runtime calls that launched them), kept in memory; the read, once the
  window has closed, returns the slice as compact tuples
  (``devtrace.py``);
- ``keys``: the decode graphs' keys captured so far;
- ``finish``: the peak device memory, the completed requests' spans
  (the engine's own request traces: queue, prefix hit, prefill chunks),
  and the names of any forbidden module loaded here; then it stops the
  server and returns.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
import traceback
from typing import Any, Dict

# Completed-request traces kept in memory: far more than one run
# completes, so none is evicted before ``finish`` reads them.
TRACE_BUFFER = 200000


def _engine_config(job: Dict[str, Any]):
    from skypilot_tpu_torch.models import weights as port_weights
    cfg = port_weights.config_from_hf(job['hf'], name=job['config_name'])
    return dataclasses.replace(cfg, **job.get('port_config', {}))


def _compact_traces(page: int):
    """Each completed request's spans: (request id, prompt tokens,
    queue start, prefix-hit tokens, [(t0, t1, tokens, offset after the
    hit) per prefill chunk]), on this host's monotonic clock."""
    from skypilot_tpu_torch.telemetry import tracing
    out = []
    for tr in tracing.get_trace_buffer().snapshot():
        prompt, t_queue, hit, chunks = None, None, 0, []
        for sp in tr.spans:
            meta = sp.meta or {}
            if sp.name == 'queue' and prompt is None:
                prompt, t_queue = meta.get('prompt_tokens'), sp.t0
            elif sp.name == 'prefix_cache_hit':
                hit = int(meta.get('pages', 0)) * page
            elif sp.name == 'prefill_chunk' and sp.t1 is not None:
                chunks.append((sp.t0, sp.t1, int(meta.get('tokens', 0)),
                               int(meta.get('offset', 0))))
        out.append((tr.request_id, prompt, t_queue, hit, chunks))
    return out


def serve(conn, job: Dict[str, Any]) -> None:
    """The child's entry (see the module docstring)."""
    os.environ['SKYTPU_TRACE_BUFFER'] = str(TRACE_BUFFER)
    server = None
    try:
        import torch
        from perfbench.harness import devtrace, imports
        from perfbench.reference import sizes, weights
        from skypilot_tpu_torch.serve.server import ModelServer

        if job.get('fault'):
            # The harness's own tests: a fault planted in the program.
            import importlib
            mod, fn = job['fault'].split(':')
            getattr(importlib.import_module(mod), fn)()
        device = job['device']
        params = weights.make_params(sizes.Sizes.from_hf(job['hf']),
                                     job['seed'], device)
        server = ModelServer(
            _engine_config(job), params=params, port=job['port'],
            kv_cache='paged', device=device, **job['engine'])
        del params
        server.start(block=False)
        server.wait_ready(timeout=job['ready_timeout_s'])
        on_cuda = torch.device(device).type == 'cuda'
        if job.get('trace'):
            # The profiler's first start initialises CUPTI, which takes
            # seconds: done here, in set-up, so the slice in the window
            # starts at once.
            warm = devtrace.start(on_cuda)
            warm[0].stop()
            devtrace.read(warm, time.monotonic())
        conn.send({'ready': time.monotonic(),
                   'kind': (torch.cuda.get_device_name(0) if on_cuda
                            else 'cpu'),
                   'page': server.engine.page})
        prof = None
        while True:
            msg = conn.recv()
            cmd = msg['cmd']
            if cmd == 'prof_start':
                # Between two engine steps: CUPTI is started and stopped
                # with no CUDA call of the engine thread in flight (a
                # stop beside a graph launch was seen to hang).
                with server._lock:
                    prof = devtrace.start(on_cuda)
                conn.send({'t': time.monotonic()})
            elif cmd == 'prof_stop':
                with server._lock:
                    t1 = time.monotonic()
                    prof[0].stop()
                conn.send({'t': t1})
            elif cmd == 'keys':
                graphs = server.engine._graphs
                conn.send({'keys': sorted(repr(k) for k in (
                    graphs._graphs if graphs is not None else ()))})
            elif cmd == 'prof_read':
                # After the window: reading the events takes seconds of
                # this process's interpreter.
                conn.send(devtrace.read(prof, t1))
                prof = None
            elif cmd == 'finish':
                peak = (torch.cuda.max_memory_allocated()
                        if on_cuda else 0)
                conn.send({'memory_peak_bytes': int(peak),
                           'traces': _compact_traces(server.engine.page),
                           'forbidden': imports.forbidden_loaded()})
                break
            else:
                raise ValueError(f'unknown command {cmd!r}')
    except BaseException as e:  # reported to the parent, then re-raised
        try:
            conn.send({'error': f'{type(e).__name__}: {e}',
                       'traceback': traceback.format_exc()})
        except OSError:
            pass
        raise
    finally:
        if server is not None:
            server.stop()
        conn.close()
        sys.stdout.flush()
