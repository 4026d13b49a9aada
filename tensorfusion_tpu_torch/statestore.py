"""Standalone state-store daemon: the platform's apiserver.

The port's copy of ``tensorfusion_tpu/statestore.py``.

For HA deployments the store must outlive any single operator replica —
the reference delegates that to the Kubernetes apiserver/etcd; tpu-fusion
ships its own: this daemon hosts the authoritative
:class:`~tensorfusion_tpu_torch.store.ObjectStore` (optionally persisted)
behind the store gateway.  Operator replicas run with ``--store-url``
pointing here, elect a leader through a ``Lease`` object
(:class:`~tensorfusion_tpu_torch.utils.leader.StoreLeaderElector`), and node
hypervisors join with ``--operator-url`` set to this daemon's URL (chip
registration and pod watches go straight to the state store; only
client-facing APIs like /connection need the operator).

    python -m tensorfusion_tpu_torch.statestore --port 2379 \
        [--persist-dir DIR] [--token SECRET] [--port-file F]
"""

from __future__ import annotations

import json
import logging
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .gateway import RawJson, StoreGateway
from .store import ObjectStore

log = logging.getLogger("tpf.statestore")

#: pre-auth drain bound (see hypervisor/server.py)
MAX_REQUEST_BODY_BYTES = 32 << 20


class StateStoreServer:
    """Thin HTTP host for a StoreGateway (healthz + store routes only)."""

    def __init__(self, store: ObjectStore, host: str = "127.0.0.1",
                 port: int = 0, token: str = "",
                 tokens: Optional[dict] = None,
                 tls_cert: str = "", tls_key: str = ""):
        self.store = store
        self.gateway = StoreGateway(store, token=token, tokens=tokens)
        self.tls = bool(tls_cert)
        #: the open client connections, shut down by stop()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        outer = self

        from .utils.tlsutil import KeepAliveHandlerMixin, TlsHandshakeMixin

        class Handler(KeepAliveHandlerMixin, TlsHandshakeMixin,
                      BaseHTTPRequestHandler):

            def log_message(self, fmt, *args):
                log.debug(fmt, *args)

            def setup(self):
                super().setup()
                with outer._conns_lock:
                    outer._conns.add(self.request)

            def finish(self):
                with outer._conns_lock:
                    outer._conns.discard(self.request)
                super().finish()

            def _send(self, code, payload):
                body = payload.encode() if isinstance(payload, RawJson) \
                    else json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _handle(self, method):
                # drain the body FIRST, whatever the route does: unread
                # bytes would desync this HTTP/1.1 keep-alive connection
                # (oversized bodies are refused WITHOUT buffering)
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_REQUEST_BODY_BYTES:
                    self.close_connection = True
                    self._send(413, {"error": "request body too large"})
                    return
                raw = self.rfile.read(n) if n else b""

                url = urlparse(self.path)
                if url.path == "/healthz":
                    self._send(200, {"ok": True})
                    return
                body = {}
                if method in ("POST", "PUT"):
                    body = json.loads(raw) if raw else {}
                result = outer.gateway.handle(method, url.path,
                                              parse_qs(url.query), body,
                                              self.headers)
                if result is None:
                    self._send(404, {"error": "not found"})
                else:
                    self._send(*result)

            def do_GET(self):
                self._guard("GET")

            def do_POST(self):
                self._guard("POST")

            def do_PUT(self):
                self._guard("PUT")

            def do_DELETE(self):
                self._guard("DELETE")

            def _guard(self, method):
                try:
                    self._handle(method)
                except Exception as e:  # noqa: BLE001
                    log.exception("%s %s", method, self.path)
                    try:
                        self._send(500, {"error": str(e)})
                    # the failure above is already logged; the peer
                    # hanging up before reading the 500 adds nothing
                    # tpflint: disable=swallowed-error
                    except Exception:  # noqa: BLE001 - peer gone
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        if tls_cert:
            from .utils.tlsutil import wrap_http_server

            wrap_http_server(self._httpd, tls_cert, tls_key)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://127.0.0.1:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="tpf-statestore", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop serving and shut down every open connection, so that a
        client's keep-alive connection or long-poll fails at once and
        redials, rather than being served on by this stopped server (the
        handler of a poll in flight ends when its wait does)."""
        self._httpd.shutdown()
        self._httpd.server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def main(argv=None, stop_event: Optional[threading.Event] = None) -> int:
    """Daemon entry point.  ``stop_event`` lets tests drive the full
    wiring in-process (signal handlers only install in the main
    thread)."""
    import argparse
    import os
    import signal

    from . import constants
    from .api.types import ALL_KINDS

    ap = argparse.ArgumentParser(prog="tpf-statestore")
    ap.add_argument("--port", type=int, default=2379)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--persist-dir", default="")
    ap.add_argument("--token",
                    default=os.environ.get(constants.ENV_STORE_TOKEN, ""))
    ap.add_argument("--node-token",
                    default=os.environ.get("TPF_STORE_TOKEN_NODE", ""),
                    help="token granting the node-agent role (write "
                         "Node/TPUNode/TPUChip/Pod/Lease + push metrics)")
    ap.add_argument("--client-token",
                    default=os.environ.get("TPF_STORE_TOKEN_CLIENT", ""),
                    help="token granting read/watch only")
    ap.add_argument("--tls-cert",
                    default=os.environ.get("TPF_TLS_CERT", ""))
    ap.add_argument("--tls-key",
                    default=os.environ.get("TPF_TLS_KEY", ""))
    ap.add_argument("--tls-self-signed", action="store_true",
                    help="generate a self-signed cert/key pair under "
                         "--persist-dir (or cwd) and serve TLS with it")
    ap.add_argument("--port-file", default="")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s %(message)s")

    # tpflint: disable=shard-routing -- the statestore daemon hosts exactly one shard partition (run N daemons for N shards)
    store = ObjectStore(persist_dir=args.persist_dir or None)
    if args.persist_dir:
        n = store.load(ALL_KINDS)
        if n:
            log.info("loaded %d persisted objects", n)
    if args.tls_self_signed and not args.tls_cert:
        from .utils.tlsutil import generate_self_signed

        base = args.persist_dir or "."
        args.tls_cert = os.path.join(base, "statestore-cert.pem")
        args.tls_key = os.path.join(base, "statestore-key.pem")
        # reuse an existing pair: regenerating on every restart would
        # invalidate the trust anchor remote clients already copied
        if not (os.path.exists(args.tls_cert)
                and os.path.exists(args.tls_key)):
            from .utils.tlsutil import default_san_hosts

            generate_self_signed(args.tls_cert, args.tls_key,
                                 hosts=default_san_hosts(args.host))
        log.info("self-signed TLS cert at %s (clients: TPF_TLS_CA=%s)",
                 args.tls_cert, args.tls_cert)
    server = StateStoreServer(
        store, host=args.host, port=args.port, token=args.token,
        tokens={"node": args.node_token, "client": args.client_token},
        tls_cert=args.tls_cert, tls_key=args.tls_key)
    server.start()
    if args.port_file:
        with open(args.port_file, "w") as f:
            f.write(str(server.port))
    log.info("state store serving on %s", server.url)

    stop = stop_event or threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *a: stop.set())
        signal.signal(signal.SIGINT, lambda *a: stop.set())
    except ValueError:          # not the main thread (in-process test)
        pass
    try:
        while not stop.wait(0.5):
            pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
