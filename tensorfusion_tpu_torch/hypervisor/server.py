"""Hypervisor HTTP API: the port's copy of
tensorfusion_tpu/hypervisor/server.py.

- ``GET  /api/v1/devices``            device inventory + metrics
- ``GET  /api/v1/workers``            tracked workers + status
- ``GET  /api/v1/node``, ``/api/v1/topology``, ``/api/v1/allocations``
- ``GET  /api/v1/ticks``              the metering loop's last ticks
  (``[end time on time.monotonic(), host ms]`` each)
- ``GET  /api/v1/dispatch``, ``/api/v1/profile``, ``/api/v1/serving``
  the co-hosted ``remoting.RemoteVTPUWorker``s' dispatch, attribution
  and serving-engine snapshots
- ``GET  /api/v1/policy``             policy ledgers (none until the
  policy layer is ported)
- ``POST /api/v1/workers``            submit a worker (single-node backend)
- ``DELETE /api/v1/workers/<ns>/<name>``
- ``POST /api/v1/workers/<ns>/<name>/snapshot|resume|freeze`` and the
  streaming-migration routes (``migrate_delta|migrate_freeze|
  migrate_commit``, over the co-hosted remote worker)
- client bootstrap: ``GET /limiter`` (shm path + env of the calling
  worker), ``GET /pod`` (worker identity), ``POST /process`` (register a
  client PID)

Implemented on the stdlib ThreadingHTTPServer, with TLS (``tls_cert`` /
``tls_key``) and an optional ``X-TPF-Token`` on every route but
``/healthz`` and the bootstrap ones.
"""

from __future__ import annotations

import dataclasses
import hmac
import json
import logging
import re
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .framework import WorkerSpec
from .single_node import from_dict

log = logging.getLogger("tpf.hypervisor.server")

#: pre-auth drain bound: an unauthenticated peer must not be able to
#: make the server buffer an arbitrary Content-Length into memory
MAX_REQUEST_BODY_BYTES = 32 << 20


# -- TLS: the parts of tensorfusion_tpu/utils/tlsutil.py the server uses --


def wrap_http_server(httpd, cert_path: str, key_path: str) -> None:
    """Serve TLS on a stdlib (Threading)HTTPServer.  The listening socket
    is wrapped with ``do_handshake_on_connect=False`` so ``accept()``
    returns at once and the handshake runs in the connection's handler
    thread (:class:`TlsHandshakeMixin`): one silent peer cannot stall
    the accept loop."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cert_path, key_path)
    httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True,
                                   do_handshake_on_connect=False)


class KeepAliveHandlerMixin:
    """HTTP/1.1 with Content-Length on every response, so clients keep
    connections alive, and an idle timeout, so an abandoned client cannot
    pin a handler thread forever."""

    protocol_version = "HTTP/1.1"
    timeout = 300


class TlsHandshakeMixin:
    """Completes the TLS handshake per connection, with a deadline, in
    the handler's own thread; list it BEFORE the HTTP handler base
    class.  A failed handshake logs one debug line and closes the
    connection."""

    #: a peer must complete the handshake within this budget
    handshake_timeout_s = 10.0
    _tls_ok = True

    def setup(self):  # noqa: D102 - socketserver hook
        if isinstance(self.request, ssl.SSLSocket):
            timeout = self.request.gettimeout()
            self.request.settimeout(self.handshake_timeout_s)
            try:
                self.request.do_handshake()
            except (ssl.SSLError, OSError) as e:
                log.debug("TLS handshake from %s failed: %s",
                          self.client_address, e)
                self._tls_ok = False
            finally:
                try:
                    self.request.settimeout(timeout)
                except OSError:
                    pass
        super().setup()

    def handle(self):  # noqa: D102
        if self._tls_ok:
            super().handle()

    def finish(self):  # noqa: D102
        if self._tls_ok:
            super().finish()
        else:
            try:
                self.request.close()
            except OSError:
                pass


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


class HypervisorServer:
    def __init__(self, devices, workers, backend=None, snapshot_dir="/tmp",
                 provider=None, host: str = "127.0.0.1", port: int = 0,
                 token: str = "", tls_cert: str = "", tls_key: str = "",
                 remote_workers=(), policy_engines=()):
        self.devices = devices
        self.workers = workers
        self.backend = backend
        self.snapshot_dir = snapshot_dir
        self.provider = provider
        #: co-hosted RemoteVTPUWorker instances whose dispatch snapshot
        #: /api/v1/dispatch serves (the TUI dispatch pane's feed)
        self.remote_workers = list(remote_workers)
        #: co-hosted tpfpolicy engines: /api/v1/policy serves their
        #: decision ledgers; empty until the policy layer is ported
        self.policy_engines = list(policy_engines)
        #: optional shared token — freeze/resume/snapshot mutate worker
        #: state, so a non-loopback bind should set one
        self.token = token
        #: cached loopback client to the co-hosted remote worker for
        #: the streaming-migration endpoints (protocol v8,
        #: docs/migration.md) — created on first use
        self._mig_dev = None
        self.tls = bool(tls_cert)
        outer = self

        class Handler(KeepAliveHandlerMixin, TlsHandshakeMixin,
                      BaseHTTPRequestHandler):

            def log_message(self, fmt, *args):  # quiet
                log.debug("%s " + fmt, self.client_address[0], *args)

            def _send(self, code: int, payload) -> None:
                body = json.dumps(_to_jsonable(payload)).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _drain_body(self) -> bool:
                """Read the full request body BEFORE any response can be
                written: on an HTTP/1.1 keep-alive connection, unread
                body bytes would be parsed as the next request line.
                Oversized bodies are refused WITHOUT reading (close the
                connection instead — draining would buffer an
                attacker-chosen size pre-auth)."""
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_REQUEST_BODY_BYTES:
                    self.close_connection = True
                    self._raw_body = b""
                    self._send(413, {"error": "request body too large"})
                    return False
                self._raw_body = self.rfile.read(length) if length else b""
                return True

            def _body(self) -> dict:
                if not getattr(self, "_raw_body", b""):
                    return {}
                return json.loads(self._raw_body)

            #: tokenless routes: /healthz for liveness probes, and the
            #: workload-pod bootstrap endpoints (/limiter, /process) —
            #: pods discover their shm segment and register pids here,
            #: and handing every tenant pod the admin token (which can
            #: freeze/snapshot OTHER tenants' workers) would be worse
            #: than leaving node-local discovery open
            PUBLIC_PATHS = {"/healthz", "/limiter", "/process"}

            def _authed(self) -> bool:
                if not outer.token or \
                        urlparse(self.path).path in self.PUBLIC_PATHS:
                    return True
                offered = self.headers.get("X-TPF-Token", "")
                if hmac.compare_digest(offered, outer.token):
                    return True
                self._send(401, {"error": "missing or bad X-TPF-Token"})
                return False

            def do_GET(self):
                try:
                    if self._drain_body() and self._authed():
                        outer._get(self)
                except Exception as e:  # noqa: BLE001
                    log.exception("GET %s failed", self.path)
                    self._send(500, {"error": str(e)})

            def do_POST(self):
                try:
                    if self._drain_body() and self._authed():
                        outer._post(self)
                except Exception as e:  # noqa: BLE001
                    log.exception("POST %s failed", self.path)
                    self._send(500, {"error": str(e)})

            def do_DELETE(self):
                try:
                    if self._drain_body() and self._authed():
                        outer._delete(self)
                except Exception as e:  # noqa: BLE001
                    log.exception("DELETE %s failed", self.path)
                    self._send(500, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        if tls_cert:
            wrap_http_server(self._httpd, tls_cert, tls_key)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://127.0.0.1:{self.port}"

    def register_remote_worker(self, worker) -> None:
        """Expose a remote-vTPU worker's dispatch snapshot via
        /api/v1/dispatch (workers may start after the server)."""
        self.remote_workers.append(worker)

    def register_policy_engine(self, engine) -> None:
        """Expose a policy engine's decision ledger via
        /api/v1/policy (engines may start after the server)."""
        self.policy_engines.append(engine)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="tpf-hypervisor-http",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- routing ----------------------------------------------------------

    _WORKER_RE = re.compile(
        r"^/api/v1/workers/([^/]+)/([^/]+)"
        r"(?:/(snapshot|resume|freeze|migrate_delta|migrate_freeze"
        r"|migrate_commit))?$")

    def _get(self, h) -> None:
        url = urlparse(h.path)
        if url.path == "/healthz":
            h._send(200, {"ok": True})
        elif url.path == "/api/v1/devices":
            self.devices.refresh_metrics()
            out = []
            for e in self.devices.devices():
                out.append({"info": _to_jsonable(e.info),
                            "metrics": _to_jsonable(e.metrics),
                            "partitions": list(e.partitions)})
            h._send(200, out)
        elif url.path == "/api/v1/topology":
            topo = self.devices.topology()
            h._send(200, _to_jsonable(topo) if topo else {})
        elif url.path == "/api/v1/node":
            h._send(200, _to_jsonable(self.devices.node_info()))
        elif url.path == "/api/v1/ticks":
            # the metering loop's own cost: [end time (monotonic), host ms]
            h._send(200, list(self.workers.tick_samples))
        elif url.path == "/api/v1/workers":
            out = [{"spec": _to_jsonable(w.spec),
                    "status": _to_jsonable(w.status)}
                   for w in self.workers.list()]
            h._send(200, out)
        elif url.path == "/api/v1/dispatch":
            h._send(200, [rw.dispatcher.snapshot()
                          for rw in self.remote_workers])
        elif url.path == "/api/v1/migrate_target":
            # streaming-migration target discovery: the URL a SOURCE
            # worker ships its pre-copy deltas to (worker-to-worker,
            # never through the controller) — the co-hosted remote
            # worker's wire endpoint
            if not self.remote_workers:
                h._send(409, {"error": "no co-hosted remote worker"})
                return
            rw = self.remote_workers[0]
            h._send(200, {"worker_url": rw.url,
                          "protocol_version": rw.protocol_version})
        elif url.path == "/api/v1/profile":
            # tpfprof attribution view (docs/profiling.md): per-tenant
            # device-time shares, overlap efficiency and the recent
            # time bins of every co-hosted worker's profiler — the
            # TUI's [p]rofile pane and tools/tpfprof.py read this
            h._send(200, [rw.profiler.snapshot()
                          for rw in self.remote_workers
                          if getattr(rw, "profiler", None) is not None])
        elif url.path == "/api/v1/serving":
            # tpfserve engine view (docs/serving.md): throughput/TTFT,
            # KV pool incl. prefix-sharing dedup + CoW counters,
            # KV_SHIP ingest volume and spec-decode accept rates of
            # every co-hosted worker's engine — the TUI's [s]erving
            # pane reads this
            h._send(200, [rw.engine.snapshot()
                          for rw in self.remote_workers
                          if getattr(rw, "engine", None) is not None])
        elif url.path == "/api/v1/policy":
            # tpfpolicy view (docs/policy.md): decision ledgers with
            # full provenance (triggering alert, exemplar trace ids,
            # profiler digest, actuation, outcome) plus per-rule
            # counters — the TUI's p[o]licy pane and tools/tpfpolicy.py
            # read this
            h._send(200, [pe.snapshot() for pe in self.policy_engines])
        elif url.path == "/api/v1/allocations":
            # Pod-resources-proxy analog (pod_resources_proxy.go:87-318):
            # the per-pod device-assignment view monitoring agents
            # (DCGM-exporter-style) read to correlate metrics with pods.
            out = []
            for w in self.workers.list():
                out.append({
                    "namespace": w.spec.namespace,
                    "pod": w.spec.name,
                    "isolation": w.spec.isolation,
                    "devices": [{
                        "chip_id": b.chip_id,
                        "host_index": b.host_index,
                        "device_index": b.device_index,
                        "duty_percent": b.duty_percent,
                        "hbm_bytes": b.hbm_bytes,
                        "host_spill_bytes": b.host_spill_bytes,
                        "partition_id": b.grant.partition_id
                        if b.grant is not None else "",
                    } for b in w.allocation.bindings],
                    "mounts": list(w.allocation.mounts),
                })
            h._send(200, out)
        elif url.path == "/limiter":
            # Legacy client bootstrap: worker identity -> shm path + env.
            qs = parse_qs(url.query)
            ns = qs.get("namespace", ["default"])[0]
            name = qs.get("pod", [""])[0]
            w = self.workers.get(f"{ns}/{name}")
            if w is None:
                h._send(404, {"error": "unknown worker"})
                return
            h._send(200, {"shm_path": w.shm_path,
                          "isolation": w.spec.isolation,
                          "env": w.status.env})
        elif url.path == "/pod":
            qs = parse_qs(url.query)
            pid = int(qs.get("pid", ["0"])[0])
            mapping = (self.backend.resolve_process(pid)
                       if self.backend else None)
            if mapping is None:
                h._send(404, {"error": f"pid {pid} not mapped to a worker"})
                return
            h._send(200, _to_jsonable(mapping))
        else:
            h._send(404, {"error": "not found"})

    def _post(self, h) -> None:
        url = urlparse(h.path)
        m = self._WORKER_RE.match(url.path)
        if url.path == "/api/v1/workers":
            body = h._body()
            spec = from_dict(WorkerSpec, body)
            if self.backend is not None and hasattr(self.backend,
                                                   "submit_worker"):
                self.backend.submit_worker(spec)
            else:
                self.workers.add_worker(spec)
            w = self.workers.get(spec.key)
            h._send(201, {"key": spec.key,
                          "status": _to_jsonable(w.status) if w else None})
        elif url.path == "/process":
            # Client hook registers its host PID for metering.
            body = h._body()
            ns = body.get("namespace", "default")
            name = body.get("pod", "")
            pid = int(body.get("pid", 0))
            self.workers.register_pid(f"{ns}/{name}", pid)
            h._send(200, {"registered": pid})
        elif m and m.group(3) == "snapshot":
            key = f"{m.group(1)}/{m.group(2)}"
            self._snapshot(key, h)
        elif m and m.group(3) == "resume":
            key = f"{m.group(1)}/{m.group(2)}"
            self._resume(key, h)
        elif m and m.group(3) == "freeze":
            key = f"{m.group(1)}/{m.group(2)}"
            self.workers.freeze_worker(key)
            h._send(200, {"frozen": key})
        elif m and m.group(3) == "migrate_delta":
            self._migrate_delta(h)
        elif m and m.group(3) == "migrate_freeze":
            key = f"{m.group(1)}/{m.group(2)}"
            self._migrate_freeze(key, h)
        elif m and m.group(3) == "migrate_commit":
            self._migrate_commit(h)
        else:
            h._send(404, {"error": "not found"})

    def _delete(self, h) -> None:
        m = self._WORKER_RE.match(urlparse(h.path).path)
        if m and m.group(3) is None:
            key = f"{m.group(1)}/{m.group(2)}"
            if self.backend is not None and hasattr(self.backend,
                                                    "delete_worker"):
                self.backend.delete_worker(key)
            else:
                self.workers.remove_worker(key)
            h._send(200, {"deleted": key})
        else:
            h._send(404, {"error": "not found"})

    # -- streaming migration (protocol v8, docs/migration.md) -------------

    def _migration_device(self):
        """Loopback client to the co-hosted remote worker — the
        hypervisor drives the v8 migration opcodes over the real wire
        (same gates, same accounting) rather than poking worker
        internals."""
        if not self.remote_workers:
            return None
        if self._mig_dev is None:
            from ..remoting.client import RemoteDevice

            rw = self.remote_workers[0]
            self._mig_dev = RemoteDevice(rw.url, token=rw.token or "")
        return self._mig_dev

    def _migrate_delta(self, h) -> None:
        dev = self._migration_device()
        if dev is None:
            h._send(409, {"error": "no co-hosted remote worker"})
            return
        body = h._body()
        target_url = body.get("target_url", "")
        if not target_url:
            h._send(400, {"error": "migrate_delta without target_url"})
            return
        try:
            stats = dev.snapshot_delta(
                target_url,
                target_token=body.get("target_token"),
                final=bool(body.get("final")),
                quant=bool(body.get("quant")))
        except Exception as e:  # noqa: BLE001 - surface, don't crash
            h._send(502, {"error": f"migrate_delta failed: {e}"})
            return
        h._send(200, stats)

    def _migrate_freeze(self, key: str, h) -> None:
        dev = self._migration_device()
        if dev is None:
            h._send(409, {"error": "no co-hosted remote worker"})
            return
        try:
            stats = dev.migrate_freeze()
        except Exception as e:  # noqa: BLE001
            h._send(502, {"error": f"migrate_freeze failed: {e}"})
            return
        # process-level pause rides along: the workload's pids freeze
        # exactly like the stop-and-copy snapshot path
        self.workers.freeze_worker(key)
        h._send(200, stats)

    def _migrate_commit(self, h) -> None:
        dev = self._migration_device()
        if dev is None:
            h._send(409, {"error": "no co-hosted remote worker"})
            return
        body = h._body()
        try:
            stats = dev.migrate_commit(abort=bool(body.get("abort")))
        except Exception as e:  # noqa: BLE001
            h._send(502, {"error": f"migrate_commit failed: {e}"})
            return
        h._send(200, stats)

    # -- snapshot / resume (live-migration hooks, server.go:114-115) ------

    def _snapshot(self, key: str, h) -> None:
        w = self.workers.get(key)
        if w is None:
            h._send(404, {"error": "unknown worker"})
            return
        self.workers.freeze_worker(key)
        prov = self.provider or self.devices.provider
        for chip_id in w.status.chip_ids:
            prov.snapshot(self.snapshot_dir, chip_id=chip_id)
        h._send(200, {"snapshotted": key, "state_dir": self.snapshot_dir})

    def _resume(self, key: str, h) -> None:
        w = self.workers.get(key)
        if w is None:
            h._send(404, {"error": "unknown worker"})
            return
        prov = self.provider or self.devices.provider
        for chip_id in w.status.chip_ids:
            try:
                prov.restore(self.snapshot_dir, chip_id=chip_id)
            except Exception:  # noqa: BLE001 - streaming migrations
                # arrive with their state already worker-resident (no
                # disk snapshot); a missing manifest must not block
                # the thaw
                log.debug("provider restore skipped for %s", chip_id,
                          exc_info=True)
        self.workers.resume_worker(key)
        h._send(200, {"resumed": key})
