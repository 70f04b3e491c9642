"""Minimal stdlib HTTP client for the fleet's internal hops (router →
replica, launcher → replica). JSON request/response plus an SSE frame
iterator for proxied `/generate` streams. No third-party deps, no
retries — failover POLICY lives in the router; this module only makes
one attempt observable (every failure surfaces as ReplicaUnreachable
or ReplicaHTTPError with enough context to reroute). A copy of
`deeplearning4j_tpu/serving/fleet/client.py`, which imports nothing of
JAX."""

from __future__ import annotations

import http.client
import json
import socket
from typing import Iterator, Optional, Tuple
from urllib.parse import urlsplit


class ReplicaUnreachable(ConnectionError):
    """The replica did not produce a (complete) HTTP response — connect
    refused, timeout, or the connection died mid-stream. The router
    treats this as 'replica down': reroute / failover."""


class ReplicaHTTPError(RuntimeError):
    """The replica answered with a non-2xx status (it is ALIVE — this
    is a structured refusal, e.g. 503 draining, not a crash)."""

    def __init__(self, status: int, body: dict):
        super().__init__(f"HTTP {status}: {body.get('error', body)}")
        self.status = status
        self.body = body


def _split(url: str) -> Tuple[str, int]:
    u = urlsplit(url if "//" in url else f"http://{url}")
    return u.hostname or "127.0.0.1", int(u.port or 80)


def _request(url: str, method: str, path: str, body: Optional[dict],
             timeout: float) -> http.client.HTTPResponse:
    host, port = _split(url)
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        payload = None if body is None else json.dumps(body).encode()
        headers = {"Content-Type": "application/json"} if payload else {}
        conn.request(method, path, body=payload, headers=headers)
        resp = conn.getresponse()
    except (OSError, socket.timeout, http.client.HTTPException) as e:
        conn.close()
        raise ReplicaUnreachable(f"{method} {url}{path}: {e}") from e
    resp._fleet_conn = conn     # keep the socket alive for streaming
    return resp


def _finish_json(resp) -> dict:
    try:
        raw = resp.read()
    except (OSError, http.client.HTTPException) as e:
        raise ReplicaUnreachable(f"truncated response: {e}") from e
    finally:
        resp._fleet_conn.close()
    try:
        body = json.loads(raw.decode() or "{}")
    except ValueError:
        body = {"error": raw.decode(errors="replace")[:200]}
    if resp.status >= 400:
        raise ReplicaHTTPError(resp.status, body)
    return body


def post_json(url: str, path: str, body: dict,
              timeout: float = 30.0) -> dict:
    return _finish_json(_request(url, "POST", path, body, timeout))


def get_json(url: str, path: str, timeout: float = 10.0) -> dict:
    return _finish_json(_request(url, "GET", path, None, timeout))


def sse_events(url: str, path: str, body: dict,
               timeout: float = 60.0) -> Iterator[dict]:
    """POST and yield each SSE `data:` frame as a parsed dict. A
    connection that dies before a terminal done/error frame raises
    ReplicaUnreachable — the caller decides whether to fail over."""
    resp = _request(url, "POST", path, body, timeout)
    if resp.status >= 400:
        yield _finish_json(resp)    # raises ReplicaHTTPError
        return
    terminal = False
    try:
        for line in resp:
            line = line.strip()
            if not line.startswith(b"data:"):
                continue
            try:
                ev = json.loads(line[5:].decode())
            except ValueError:
                continue
            yield ev
            if "done" in ev or "error" in ev:
                terminal = True
                return
        if not terminal:
            raise ReplicaUnreachable(
                f"stream from {url}{path} ended without a terminal "
                f"frame")
    except (OSError, socket.timeout, http.client.HTTPException) as e:
        raise ReplicaUnreachable(
            f"stream from {url}{path} died mid-flight: {e}") from e
    finally:
        resp._fleet_conn.close()
