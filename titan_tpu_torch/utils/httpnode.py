"""Shared JSON-over-HTTP plumbing for the network nodes (storage + index).

One server shell and one client call so the error taxonomy stays aligned
on both wires: server-side TemporaryBackendError → HTTP 503 → client
TemporaryBackendError (retryable by the backend-op layer); anything else →
500 → PermanentBackendError; connection failures → TemporaryBackendError.
"""

from __future__ import annotations

import hmac
import json
import os
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from titan_tpu_torch.errors import PermanentBackendError, TemporaryBackendError


class NodeHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog sized for a burst of
    clients: the stdlib's 5 refuses or resets the connections past it
    when a batch's worth of callers connect at once (16 point queries
    meant to fuse into one device run)."""

    request_queue_size = 128


def _env_token() -> Optional[str]:
    return os.environ.get("TITAN_TPU_NODE_TOKEN") or None


class TextResponse:
    """Dispatch return type for non-JSON GET bodies — a node handler
    returns one when the payload is a text protocol (the Prometheus
    exposition on a scan worker's ``GET /metrics``), and the shell
    sends it verbatim with the given content type instead of
    json-encoding it."""

    __slots__ = ("text", "content_type")

    def __init__(self, text: str, content_type: str = "text/plain"):
        self.text = text
        self.content_type = content_type


class JsonNode:
    """HTTP server shell around a ``dispatch(path, request_dict)`` callable.

    ``auth_token``: shared bearer token; every request must carry
    ``Authorization: Bearer <token>`` (401 otherwise). ``None`` falls back
    to the ``TITAN_TPU_NODE_TOKEN`` env var (set it on every node and
    every client process and the whole mesh authenticates); ``""``
    disables auth explicitly."""

    def __init__(self, dispatch: Callable[[str, dict], dict],
                 host: str = "127.0.0.1", port: int = 0,
                 name: str = "node", auth_token: Optional[str] = None):
        self._dispatch = dispatch
        self.host = host
        self.port = port
        self._name = name
        self.auth_token = _env_token() if auth_token is None else \
            (auth_token or None)
        self._httpd: Optional[NodeHTTPServer] = None

    def start(self) -> "JsonNode":
        node = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, payload) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authorized(self) -> bool:
                # constant-time compare: this is the mesh-auth boundary,
                # a plain != leaks token prefixes through timing. Bytes,
                # not str: compare_digest raises on non-ASCII str input
                # (http.server decodes headers latin-1), and a malformed
                # header must 401, not crash the handler
                if node.auth_token is not None and not hmac.compare_digest(
                        (self.headers.get("Authorization") or "").encode(
                            "utf-8", "surrogateescape"),
                        f"Bearer {node.auth_token}".encode(
                            "utf-8", "surrogateescape")):
                    self._send(401, {"error": "missing or bad bearer token"})
                    return False
                return True

            def _reply(self, result) -> None:
                if isinstance(result, TextResponse):
                    body = result.text.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", result.content_type)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send(200, result)

            def do_POST(self):
                if not self._authorized():
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                    result = node._dispatch(self.path, req)
                except TemporaryBackendError as e:
                    self._send(503, {"error": str(e)})
                    return
                except Exception as e:   # noqa: BLE001 — wire boundary
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                self._reply(result)

            def do_GET(self):
                # the observation surface (/metrics, /healthz on
                # scan workers) — same auth gate and error taxonomy
                # as POST, empty request dict, path carries any query
                if not self._authorized():
                    return
                try:
                    result = node._dispatch(self.path, {})
                except TemporaryBackendError as e:
                    self._send(503, {"error": str(e)})
                    return
                except Exception as e:   # noqa: BLE001 — wire boundary
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                self._reply(result)

        self._httpd = NodeHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name=self._name).start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def json_call(url: str, path: str, payload: dict,
              timeout: float = 30.0, token: Optional[str] = None) -> dict:
    """Client half: POST + error-taxonomy mapping. ``token`` defaults to
    the ``TITAN_TPU_NODE_TOKEN`` env var (the server shell's counterpart)."""
    headers = {"Content-Type": "application/json"}
    token = _env_token() if token is None else (token or None)
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            msg = json.loads(e.read()).get("error", str(e))
        except Exception:   # noqa: BLE001
            msg = str(e)
        if e.code == 503:
            raise TemporaryBackendError(msg) from e
        raise PermanentBackendError(msg) from e
    except (urllib.error.URLError, OSError) as e:
        # connection failures are retryable (reference: thrift pool
        # rebuild + BackendOperation retries)
        raise TemporaryBackendError(str(e)) from e


def text_get(url: str, path: str, timeout: float = 10.0,
             token: Optional[str] = None) -> str:
    """GET a text endpoint (a peer's ``/metrics`` exposition or
    ``/healthz`` JSON) with the same bearer-token defaulting and error
    taxonomy as :func:`json_call` — the Federator's default fetch."""
    headers = {}
    token = _env_token() if token is None else (token or None)
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(url + path, headers=headers,
                                 method="GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read().decode("utf-8", "replace")
    except urllib.error.HTTPError as e:
        if e.code == 503:
            raise TemporaryBackendError(str(e)) from e
        raise PermanentBackendError(str(e)) from e
    except (urllib.error.URLError, OSError) as e:
        raise TemporaryBackendError(str(e)) from e


def run_node_cli(argv, usage: str, make_node: Callable[[str, str, int],
                                                       JsonNode]) -> None:
    """Shared ``python -m …`` entry: <data-dir> [port] [host]. Binds
    0.0.0.0 by default so remote graph instances can actually reach the
    node."""
    import sys
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print(usage, file=sys.stderr)
        raise SystemExit(2)
    port = int(args[1]) if len(args) > 1 else 0
    host = args[2] if len(args) > 2 else "0.0.0.0"
    node = make_node(args[0], host, port).start()
    print(f"{node._name} serving on {node.url}")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        node.stop()
