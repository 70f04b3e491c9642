"""Stdlib JSON-over-HTTP plumbing for the serving endpoints (a copy of
`deeplearning4j_tpu/serving/http_base.py`, which imports nothing of
JAX).

One implementation of the request/response mechanics (header parsing,
JSON encode/decode, status mapping, threaded serve/shutdown) for the
inference server — the role Play filled for the reference's REST
modules. `stop()` returns after the serving thread and every request
thread have ended (`ThreadingHTTPServer` joins its request threads on
close), so no thread outlives the server; a subclass whose handlers
wait on work ends that work between `stop_listening()` and the join.

Status contract (clients must be able to tell their bug from ours):
  400 — the request is at fault: malformed JSON, a non-object body, or a
        missing field (`KeyError` from a handler)
  4xx/5xx via `HttpError` — a handler's explicit verdict (the serving
        control plane uses 503 for shed/draining and 504 for deadlines)
  500 — any other handler exception: a server fault, never blamed on the
        client
"""

from __future__ import annotations

import inspect
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs


class HttpError(Exception):
    """Raise from a handler to pick the response status explicitly."""

    def __init__(self, status: int, message: str, **extra):
        super().__init__(message)
        self.status = int(status)
        self.payload = {"error": message, **extra}


class TextResponse:
    """Return from a GET handler to send a non-JSON body with an explicit
    Content-Type (the Prometheus /metrics rendering uses
    `text/plain; version=0.0.4`)."""

    def __init__(self, body: str,
                 content_type: str = "text/plain; charset=utf-8",
                 status: int = 200):
        self.body = body
        self.content_type = content_type
        self.status = int(status)


class StreamResponse:
    """Return from a POST handler to stream incrementally instead of
    sending one JSON body: each event from the iterable is written as an
    SSE frame (`data: <json>\\n\\n`) and flushed immediately. The server
    speaks HTTP/1.0, so connection-close delimits the stream — no
    chunked encoding needed. If the client disconnects mid-stream the
    event iterable is `close()`d (a generator sees GeneratorExit there,
    which the /generate handler turns into a session cancel)."""

    def __init__(self, events,
                 content_type: str = "text/event-stream",
                 status: int = 200):
        self.events = events
        self.content_type = content_type
        self.status = int(status)


def _wants_request(fn: Callable) -> bool:
    """True when a GET handler declares a parameter — it then receives
    {"query": ..., "headers": ...} for content negotiation; zero-arg
    handlers keep the original contract."""
    try:
        return bool(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return False


class JsonHttpServer:
    """Subclass and override get_routes()/post_routes().

    GET handlers: () -> payload dict, or (request) -> payload dict |
    TextResponse when they declare a parameter (request carries parsed
    query params + headers). POST handlers: (request dict) -> payload
    dict. Errors map per the module-level status contract."""

    def __init__(self, *, port: int = 0, host: str = "127.0.0.1"):
        self.port = port
        self.host = host
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def get_routes(self) -> Dict[str, Callable[[], dict]]:
        return {"/healthz": lambda: {"status": "ok"}}

    def get_prefix_routes(self) -> Dict[str, Callable[[str, dict], dict]]:
        """Path-parameter GET routes, consulted after an exact-route
        miss: `{"/trace/": fn}` serves `/trace/<id>` with
        fn(suffix, request). Longest prefix wins."""
        return {}

    def post_routes(self) -> Dict[str, Callable[[dict], dict]]:
        return {}

    def start(self) -> int:
        gets = self.get_routes()
        get_arity = {path: _wants_request(fn) for path, fn in gets.items()}
        prefixes = sorted(self.get_prefix_routes().items(),
                          key=lambda kv: -len(kv[0]))
        posts = self.post_routes()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _text(self, resp: TextResponse):
                body = resp.body.encode()
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                fn = gets.get(path)
                suffix = prefix_fn = None
                if fn is None:
                    for pre, pfn in prefixes:
                        if path.startswith(pre):
                            prefix_fn, suffix = pfn, path[len(pre):]
                            break
                    if prefix_fn is None:
                        return self._json(404, {"error": "not found"})
                try:
                    if prefix_fn is not None:
                        out = prefix_fn(suffix,
                                        {"query": parse_qs(query),
                                         "headers": self.headers})
                    elif get_arity[path]:
                        out = fn({"query": parse_qs(query),
                                  "headers": self.headers})
                    else:
                        out = fn()
                    if isinstance(out, TextResponse):
                        self._text(out)
                    else:
                        self._json(200, out)
                except HttpError as e:
                    self._json(e.status, e.payload)
                except Exception as e:
                    self._json(500, {"error": str(e)})

            def _stream(self, resp: StreamResponse):
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                try:
                    for ev in resp.events:
                        data = (ev if isinstance(ev, str)
                                else json.dumps(ev))
                        self.wfile.write(f"data: {data}\n\n".encode())
                        self.wfile.flush()
                # the client hung up mid-stream: the finally block
                # cancels the producer; nothing to report
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Exception as e:
                    try:        # headers are gone; best-effort in-band
                        self.wfile.write(
                            f"data: {json.dumps({'error': str(e)})}"
                            f"\n\n".encode())
                    # the socket is already dead; the in-band error
                    # frame was best-effort
                    except OSError:
                        pass
                finally:
                    close = getattr(resp.events, "close", None)
                    if close is not None:
                        close()

            def do_POST(self):
                fn = posts.get(self.path)
                if fn is None:
                    return self._json(404, {"error": "not found"})
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) or b"{}"
                try:
                    req = json.loads(raw)
                except (json.JSONDecodeError, UnicodeDecodeError) as e:
                    return self._json(400, {"error": f"malformed JSON: {e}"})
                if not isinstance(req, dict):
                    return self._json(
                        400, {"error": "request body must be a JSON object"})
                try:
                    out = fn(req)
                    if isinstance(out, StreamResponse):
                        return self._stream(out)
                    self._json(200, out)
                except HttpError as e:
                    self._json(e.status, e.payload)
                except KeyError as e:
                    self._json(400, {"error": f"missing field/model: {e}"})
                except Exception as e:
                    self._json(500, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop_listening(self):
        """End the serve loop: no request is accepted once this returns.
        `stop()` calls it too; calling it twice is harmless."""
        if self._httpd is not None:
            self._httpd.shutdown()

    def stop(self):
        if self._httpd is not None:
            self.stop_listening()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
