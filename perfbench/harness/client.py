"""The load: streamed ``POST /generate`` requests against the server.

Each request is a token-id prompt with ``"stream": true``, greedy
(temperature 0) and no end-of-sequence id, so it yields exactly its
``max_new_tokens``. The client records, on this host's monotonic clock
(the server process reads the same clock), when the request was due,
when it went out, and when each token arrived.

Open loop (``run_open``): a dispatcher sends each request at its due
time whatever the server is doing; a latency is timed from the due
time, so a stall also counts against the requests it delayed, and the
dispatcher's own lateness is recorded. Closed loop (``run_closed``):
each client sends its next request when its last one ends.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import http.client
import json
import socket
import threading
import time
from typing import Callable, List, Optional

from perfbench.harness.traffic import Request


@dataclasses.dataclass
class Record:
    req: Request
    due: float                    # monotonic seconds
    sent: float = 0.0
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    request_id: Optional[int] = None
    error: Optional[str] = None
    done: bool = False

    @property
    def ok(self) -> bool:
        return (self.done and self.error is None
                and len(self.tokens) == self.req.max_new
                and len(self.times) == self.req.max_new)


def stream(port: int, rec: Record, deadline: float) -> Record:
    """Send ``rec.req`` and read its stream to the end or ``deadline``
    (monotonic), whichever comes first; the record says which."""
    body = json.dumps({'prompt': rec.req.prompt,
                       'max_new_tokens': rec.req.max_new,
                       'temperature': 0.0, 'stream': True}).encode()
    conn = http.client.HTTPConnection(
        '127.0.0.1', port, timeout=max(1.0, deadline - time.monotonic()))
    rec.sent = time.monotonic()
    try:
        conn.request('POST', '/generate', body,
                     {'Content-Type': 'application/json'})
        resp = conn.getresponse()
        if resp.status != 200:
            rec.error = f'HTTP {resp.status}: {resp.read()[:200]!r}'
            return rec
        while True:
            line = resp.readline()
            if not line:
                break
            if not line.startswith(b'data:'):
                continue
            now = time.monotonic()
            ev = json.loads(line[5:])
            if 'token' in ev:
                rec.times.append(now)
            elif ev.get('done'):
                rec.tokens = [int(t) for t in ev['tokens']]
                rec.request_id = ev.get('request_id')
                rec.done = True
                break
            elif 'error' in ev:
                rec.error = str(ev['error'])
                break
            if now > deadline:
                rec.error = 'cap reached'
                break
        if not rec.done and rec.error is None:
            rec.error = 'stream ended early'
    except (OSError, http.client.HTTPException, ValueError) as e:
        rec.error = f'{type(e).__name__}: {e}'
    finally:
        conn.close()
    return rec


def run_open(port: int, requests: List[Request], t_start: float,
             cap_s: float, stop: Callable[[], bool], recs: List[Record],
             workers: int = 512) -> None:
    """Send every request at ``t_start + due`` until ``stop()``,
    appending its record to ``recs`` as it goes out; returns once every
    stream sent has ended. Each stream ends by ``due + cap_s`` at the
    latest."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
    futures = []
    try:
        for req in requests:
            due = t_start + req.due
            while not stop():
                left = due - time.monotonic()
                if left <= 0:
                    break
                time.sleep(min(left, 0.02))
            if stop():
                break
            rec = Record(req, due)
            recs.append(rec)
            futures.append(pool.submit(stream, port, rec, due + cap_s))
        for f in futures:
            f.result()
    finally:
        pool.shutdown(wait=True)


def run_closed(port: int, requests: List[Request], clients: int,
               cap_s: float, keep_going: Callable[[], bool],
               recs: List[Record], t_start: float) -> None:
    """From ``t_start``, ``clients`` loops each sending the next request
    of ``requests`` when its last one ends, while ``keep_going()``;
    each record goes into ``recs`` as it is sent (its due time is its
    send time)."""
    lock = threading.Lock()
    it = iter(requests)

    def loop():
        while keep_going():
            with lock:
                req = next(it, None)
                if req is None:
                    return
                rec = Record(req, time.monotonic())
                recs.append(rec)
            stream(port, rec, rec.due + cap_s)

    wait = t_start - time.monotonic()
    if wait > 0:
        time.sleep(wait)
    threads = [threading.Thread(target=loop, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def get_json(port: int, path: str, timeout: float = 30.0):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=timeout)
    try:
        conn.request('GET', path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def get_text(port: int, path: str, timeout: float = 30.0) -> str:
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=timeout)
    try:
        conn.request('GET', path)
        return conn.getresponse().read().decode()
    finally:
        conn.close()


def histogram_sum_count(prom_text: str, name: str):
    """(sum, count) of an unlabelled histogram in Prometheus text."""
    vals = {}
    for line in prom_text.splitlines():
        for suffix in ('_sum', '_count'):
            if line.startswith(name + suffix + ' '):
                vals[suffix] = float(line.split()[-1])
    return vals.get('_sum', 0.0), vals.get('_count', 0.0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]
