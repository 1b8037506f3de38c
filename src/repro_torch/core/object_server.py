"""Minimal HTTP object server: real-network front-end for multi-pod runs.

A thin shim translating HTTP requests onto
:class:`~repro_torch.core.remote_store.ServerTransport` — every semantic (single
PUT with declared checksum, idempotent multipart, list/HEAD/DELETE) lives
in ServerTransport, so in-process transport tests and real multi-pod HTTP
runs exercise identical server behaviour.

Stdlib only (``http.server.ThreadingHTTPServer``): the container bakes no
HTTP frameworks, and the two-phase commit needs nothing fancier. Backing
is either in-memory (default) or a durable :class:`LocalFSStore` root via
``--root`` — the latter gives multi-pod runs the same crash durability as
the shared-FS path.

Usage (programmatic, as the multi-pod tests do)::

    server, port = serve(backing=None)           # in-memory, ephemeral port
    ... hand f"http://127.0.0.1:{port}" to host workers ...
    server.shutdown()

or as a process: ``python -m repro_torch.core.object_server --port 0 [--root d]``
(prints ``LISTENING <host> <port>`` on stdout once bound).
"""

from __future__ import annotations

import argparse
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qsl, urlsplit

from .remote_store import ServerTransport
from .storage import LocalFSStore, ObjectStore


class _Handler(BaseHTTPRequestHandler):
    # keep-alive so HttpTransport's connection pool actually pools
    protocol_version = "HTTP/1.1"

    def _dispatch(self, method: str) -> None:
        parsed = urlsplit(self.path)
        params = dict(parse_qsl(parsed.query))
        length = int(self.headers.get("Content-Length", 0) or 0)
        body = self.rfile.read(length) if length else b""
        resp = self.server.transport.request(method, parsed.path,
                                             body=body, params=params)
        self.send_response(resp.status)
        for k, v in resp.headers.items():
            self.send_header(k, v)
        if method == "HEAD":
            # content-length header carries the OBJECT size; no body follows
            if "content-length" not in resp.headers:
                self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_header("Content-Length", str(len(resp.body)))
        self.end_headers()
        if resp.body:
            self.wfile.write(resp.body)

    def do_GET(self) -> None:
        self._dispatch("GET")

    def do_PUT(self) -> None:
        self._dispatch("PUT")

    def do_POST(self) -> None:
        self._dispatch("POST")

    def do_DELETE(self) -> None:
        self._dispatch("DELETE")

    def do_HEAD(self) -> None:
        self._dispatch("HEAD")

    def log_message(self, fmt, *args) -> None:  # pragma: no cover - quiet
        pass


class ObjectServer(ThreadingHTTPServer):
    daemon_threads = True  # worker threads must not block shutdown

    def __init__(self, addr, backing: Optional[ObjectStore] = None) -> None:
        super().__init__(addr, _Handler)
        self.transport = ServerTransport(backing)

    @property
    def backing(self) -> ObjectStore:
        return self.transport.backing


def serve(backing: Optional[ObjectStore] = None, host: str = "127.0.0.1",
          port: int = 0) -> Tuple[ObjectServer, int]:
    """Bind and start serving on a daemon thread; returns
    ``(server, bound_port)``. ``port=0`` picks an ephemeral port."""
    server = ObjectServer((host, port), backing)
    t = threading.Thread(target=server.serve_forever,
                         name="object-server", daemon=True)
    t.start()
    return server, server.server_address[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Check-N-Run object server (HTTP front-end)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks an ephemeral port (printed on stdout)")
    ap.add_argument("--root", default=None,
                    help="back with a durable LocalFSStore at this root "
                         "(default: in-memory)")
    args = ap.parse_args(argv)
    backing = LocalFSStore(args.root) if args.root else None
    server = ObjectServer((args.host, args.port), backing)
    print(f"LISTENING {server.server_address[0]} "
          f"{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover - operator stop
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
