"""The trace-propagating HTTP request helper of the serving tier (own
copy of ``skypilot_tpu/serve/wire.py``).

Every outbound HTTP call under ``serve/`` that carries a request body
to another process of the serving tier goes through here: the helper is
the one place the ``X-Skytpu-Trace`` hop header is attached, so a hop
added later cannot drop the cross-process trace chain. Read-only
liveness probes are exempt: they are not requests.

``trace`` accepts the formatted header value (str), a parsed context
dict (``{'trace_id', 'parent_span'}``), or None (no header: a call with
no request identity, such as the gang bus's bulk sync).
"""
from __future__ import annotations

import json
import urllib.request
from typing import Any, Dict, Optional, Union

from skypilot_tpu_torch.telemetry import tracing

TRACE_HEADER = tracing.TRACE_HEADER

TraceArg = Optional[Union[str, Dict[str, Any]]]


def trace_header_value(trace: TraceArg) -> Optional[str]:
    """Normalize a ``trace`` argument to the wire header value."""
    if not trace:
        return None
    if isinstance(trace, str):
        return trace
    tid = trace.get('trace_id')
    if not tid:
        return None
    return tracing.format_trace_header(tid, trace.get('parent_span'))


def build_request(url: str, *, data: Optional[bytes] = None,
                  headers: Optional[Dict[str, str]] = None,
                  method: Optional[str] = None,
                  trace: TraceArg = None) -> urllib.request.Request:
    """An outbound request with the trace hop header attached (unless
    the caller's headers already carry one: a proxied client header
    wins over a re-mint)."""
    headers = dict(headers or {})
    value = trace_header_value(trace)
    if value is not None and not any(
            k.lower() == TRACE_HEADER.lower() for k in headers):
        headers[TRACE_HEADER] = value
    return urllib.request.Request(url, data=data, headers=headers,
                                  method=method)


def urlopen(url_or_req, *, data: Optional[bytes] = None,
            headers: Optional[Dict[str, str]] = None,
            method: Optional[str] = None, trace: TraceArg = None,
            timeout: float = 30.0):
    """Open an outbound hop (returns the live response object; the
    caller streams and closes it). Accepts a prebuilt request from
    :func:`build_request` or a URL plus the same keywords."""
    if isinstance(url_or_req, urllib.request.Request):
        req = url_or_req
    else:
        req = build_request(url_or_req, data=data, headers=headers,
                            method=method, trace=trace)
    return urllib.request.urlopen(req, timeout=timeout)


def post_json(url: str, payload: Dict[str, Any], *,
              timeout: float = 10.0, trace: TraceArg = None,
              headers: Optional[Dict[str, str]] = None
              ) -> Dict[str, Any]:
    """POST a JSON body to another process; the parsed JSON reply."""
    headers = dict(headers or {})
    headers.setdefault('Content-Type', 'application/json')
    body = json.dumps(payload).encode()
    with urlopen(url, data=body, headers=headers, trace=trace,
                 timeout=timeout) as resp:
        return json.loads(resp.read())
