"""Remote worker of the port: serves one device over TCP.

The single-device subset of ``tensorfusion_tpu/remoting/worker.py``.  It
runs on the GPU host (``python -m tensorfusion_tpu_torch.remoting``),
accepts HELLO / INFO / COMPILE / PUT / FREE / FETCH / EXECUTE, and keeps
an executable cache keyed by content hash so repeated clients share one
loaded program.  A program is a ``torch.export`` archive
(``remoting/program.py``), checked before it is loaded and moved to the
worker's device; its flash attention runs the port's Hopper kernel there
(the custom op picks the kernel from its tensors' device).

With ``engine=`` (a :class:`~..serving.engine.ServingEngine` whose runner
lives on the worker's device) it also serves GENERATE (tokens stream
back as GENERATE_OK frames while the continuous-batching engine makes
them) and KV_SHIP (protocol v6: a prefill tier's KV pages, inline or
as ephemeral PUTs, ingested into the engine's pool with prefix dedup,
then streamed like GENERATE).  The engine's pool is charged against the
resident budget and the meter at :meth:`start` and released at
:meth:`stop`; compute is charged per EXECUTE only, never per engine
step.  Every other kind, including those of later parts of the port
(SNAPSHOT, RESTORE, migration, the collectives and the peer fabric, and
COMPILE_MLIR), gets the reference's ``unknown kind`` ERROR.

As in the reference:

- **auth**: with a token (constructor or ``TPF_REMOTING_TOKEN``) every
  connection must open with a HELLO carrying it (constant-time compare)
  before anything else is read; a non-loopback bind without a token is
  refused unless ``insecure``.  HELLO negotiates the wire version, the
  QoS class (the connection's dispatch weight) and q8 replies.
- **per-connection id namespaces**: client-minted ``c-`` buffer ids are
  rewritten to ``cn<conn>:c-...`` so two clients never collide.
- **QoS dispatch**: connection handlers enqueue EXECUTEs on one
  :class:`~.dispatch.DeviceDispatcher` (WFQ over the HELLO class,
  per-connection FIFO, BUSY bounds, deadlines, micro-batching); FETCH
  and FREE wait on the connection's barrier first.  Replies are
  serialized by a per-connection write lock.
- **resident memory**: PUT and ``keep_results`` buffers are admitted
  against ``max_resident_bytes`` and charged on ``meter_client.charge_hbm``
  (``_admit_resident`` / ``_release_resident``); FREE releases them, and
  an ``ephemeral`` PUT is released when its first consumer takes it.
- **one gate for device work**: the PUT copies on the copy pool, the
  module calls and flushes on the dispatcher thread and FETCH enter the
  process-wide :data:`~..device.DEVICE_GATE` shared, as the runners'
  eager calls do, so a hosted engine's lazy graph capture (which enters
  it alone) never overlaps them.
- **metering**: one ``meter_client.charge_launch(mflops)`` per EXECUTE
  (the client's ``mflops_hint`` at COMPILE), ``mflops * k`` for a fused
  batch of k.
- **overlap**: after a launch the next ``TPF_REMOTING_PREFETCH_DEPTH``
  queued items' inline arguments start their host-to-device copies on a
  thread pool, and the blocking device-to-host copy of a result (the
  deferred flush) runs after the next batch has been launched.
- **tracing and attribution**: traced (v5) requests get
  ``dispatcher.queue`` / ``device.launch`` / ``worker.upload`` /
  ``worker.flush`` spans in their reply; the profiler attributes queue,
  transfer and compute time per tenant; the flight recorder keeps the
  last dispatch decisions.

Micro-batching: a batch of k compatible requests (same executable, same
signature) runs as k calls of the loaded module in one dispatch.  It is
not captured as one CUDA graph: the calls take their inputs from
buffers the wire hands over per request, which a graph would copy into
its static inputs first.
"""

from __future__ import annotations

import hashlib
import hmac
import logging
import os
import socketserver
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from .. import constants
from ..device import DEVICE_GATE, DeviceLike, resolve_device
from ..profiling.profiler import Profiler
from ..profiling.recorder import FlightRecorder
from ..tracing.core import Tracer
from . import program, protocol
from .dispatch import BusyError, DeviceDispatcher, WorkItem, qos_weight
from .protocol import recv_message, send_message

log = logging.getLogger("tpf_torch.remoting.worker")

#: request kinds that observe execution effects (results, resident-set
#: mutations) and therefore wait for the connection's queued EXECUTEs
#: to finish before running — per-connection ordering across the shared
#: dispatch queue
_BARRIER_KINDS = ("FETCH", "FREE")


def _leaves(out) -> list:
    """A module's flat outputs as a list."""
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    return a.type != "cuda" or (a.index or 0) == (b.index or 0)


class RemoteVTPUWorker:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 meter_client=None, token: Optional[str] = None,
                 max_resident_bytes: int = 0,
                 compress: Optional[bool] = None,
                 quantize: Optional[bool] = None,
                 insecure: Optional[bool] = None,
                 protocol_version: int = protocol.VERSION,
                 dispatch_mode: Optional[str] = None,
                 max_queue_per_tenant: Optional[int] = None,
                 max_queue_global: Optional[int] = None,
                 max_microbatch: Optional[int] = None,
                 tracer: Optional[Tracer] = None,
                 engine=None,
                 profiler: Optional[Profiler] = None,
                 recorder: Optional[FlightRecorder] = None,
                 device: DeviceLike = "cuda"):
        #: the one device this worker owns; "cuda" without a card raises
        self.device = resolve_device(device)
        runner_dev = getattr(getattr(engine, "runner", None), "device", None)
        if runner_dev is not None and \
                not _same_device(torch.device(runner_dev), self.device):
            raise ValueError(f"the engine's runner is on {runner_dev}, the "
                             f"worker owns {self.device}")
        self.meter_client = meter_client    # optional VTPUClient
        #: highest wire version this worker speaks; pinning it to 2 makes
        #: the worker byte-faithful to a v2 build (mixed-version tests)
        self.protocol_version = protocol_version
        #: fresh per process, carried in HELLO_OK
        self.worker_uid = f"w-{os.urandom(6).hex()}"
        self.token = token if token is not None else \
            os.environ.get("TPF_REMOTING_TOKEN", "")
        # This socket loads and runs caller-supplied programs: an
        # unauthenticated non-loopback bind must be an explicit opt-in
        # (--insecure / TPF_REMOTING_INSECURE=1).
        if insecure is None:
            insecure = os.environ.get("TPF_REMOTING_INSECURE", "") == "1"
        if not self.token and not insecure and \
                host not in ("127.0.0.1", "localhost", "::1"):
            raise ValueError(
                f"refusing to serve remote execution on {host} without a "
                f"token: set TPF_REMOTING_TOKEN (or pass token=), or "
                f"opt in explicitly with insecure=True / "
                f"TPF_REMOTING_INSECURE=1")
        #: wire compression policy, decided per CONNECTION by
        #: ``protocol.default_compress``; the argument, when given, wins
        self.compress: Optional[bool] = compress   # None = auto
        #: reply quantization policy (v6, lossy q8): None = honor the
        #: client's HELLO ``quant`` flag; True/False force it for every
        #: v6 connection / never.
        if quantize is None:
            env = os.environ.get(constants.ENV_REMOTING_QUANT, "")
            quantize = {"1": True, "0": False}.get(env)
        self.quantize: Optional[bool] = quantize
        #: host->device prefetch overlap depth (queued items whose
        #: uploads start while the current launch runs)
        try:
            self.prefetch_depth = max(1, int(os.environ.get(
                constants.ENV_REMOTING_PREFETCH_DEPTH, "") or 2))
        except ValueError:
            self.prefetch_depth = 2
        self._lock = threading.Lock()
        # guarded by: _lock
        self._upload_stats: Dict[str, int] = {
            "prefetched_total": 0, "inflight": 0, "high_water": 0}
        #: realized compression accounting (reported by INFO)
        # guarded by: _lock
        self._wire_stats: Dict[str, int] = {}
        #: resident-buffer budget; 0 = unlimited
        self.max_resident_bytes = max_resident_bytes
        # guarded by: _lock
        self.resident_bytes = 0
        #: exe_id -> loaded module (flat tensors in, flat tensors out)
        # guarded by: _lock
        self._exe_cache: Dict[str, object] = {}
        # guarded by: _lock
        self._exe_costs: Dict[str, int] = {}
        #: exe_ids whose client opted into micro-batching at COMPILE
        # guarded by: _lock
        self._exe_microbatch: set = set()
        #: buf_id -> device tensor (or the Future of an async PUT)
        # guarded by: _lock
        self._buffers: Dict[str, object] = {}
        #: buf_ids freed when first consumed (KV_SHIP's page uploads: the
        #: client sends them ahead of the frame and never names them again)
        # guarded by: _lock
        self._ephemeral: set = set()
        # guarded by: _lock
        self._buf_seq = 0
        # guarded by: _lock
        self._conn_seq = 0            # per-connection id namespaces
        #: host->device copies of async PUTs and prefetched arguments
        # guarded by: _lock
        self._copy_pool: Optional[ThreadPoolExecutor] = None
        #: per-buffer async-copy durations (buf_id -> seconds), consumed
        #: at first use to split transfer time into hidden vs exposed
        # guarded by: _lock
        self._copy_durs: Dict[str, float] = {}
        #: hidden-transfer accumulator of the item resolving its args —
        #: dispatcher-thread only, reset per item
        self._hidden_acc = 0.0
        #: last result-materialization time — the anchor of the
        #: inter-completion-gap attribution; dispatcher-thread only
        self._last_completion_m = time.monotonic()
        mode = dispatch_mode or os.environ.get(
            constants.ENV_REMOTING_DISPATCH, "") or "wfq"
        kwargs = {}
        if max_queue_per_tenant is not None:
            kwargs["max_queue_per_tenant"] = max_queue_per_tenant
        if max_queue_global is not None:
            kwargs["max_queue_global"] = max_queue_global
        if max_microbatch is not None:
            kwargs["max_microbatch"] = max_microbatch
        #: server-side spans, only for requests that carry a sampled
        #: trace context (untraced serving pays nothing)
        self.tracer = tracer or Tracer(service="remote-worker")
        #: attribution ledger, always on unless TPF_PROF=0
        if profiler is None and \
                os.environ.get(constants.ENV_PROF, "") != "0":
            try:
                bin_s = float(os.environ.get(constants.ENV_PROF_BIN_S,
                                             "") or 1.0)
            except ValueError:
                bin_s = 1.0
            profiler = Profiler(name="worker0", bin_s=bin_s)
        self.profiler = profiler
        self.recorder = recorder or FlightRecorder(config={
            "component": "remote-worker",
            "dispatch_mode": mode,
            "prefetch_depth": self.prefetch_depth,
            "protocol_version": self.protocol_version,
            "device": str(self.device)})
        self.dispatcher = DeviceDispatcher(self._execute_batch,
                                           mode=mode,
                                           tracer=self.tracer,
                                           profiler=self.profiler,
                                           recorder=self.recorder,
                                           **kwargs)
        #: optional continuous-batching engine: GENERATE and KV_SHIP
        #: stream through it; its stepper starts and stops with the
        #: worker.  It shares the worker's tracer, attribution ledger and
        #: flight recorder unless it brought its own.
        self.engine = engine
        if engine is not None:
            for hook in ("tracer", "profiler", "recorder"):
                if getattr(engine, hook, None) is None:
                    setattr(engine, hook, getattr(self, hook))
        #: the paged pool's footprint, charged at start() like any
        #: resident buffer and released at stop()
        self._engine_pool_bytes = 0
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                import socket as _socket

                self.request.setsockopt(_socket.IPPROTO_TCP,
                                        _socket.TCP_NODELAY, 1)
                # wire version for this connection: starts at 2 (every
                # peer reads v2 frames), raised by the HELLO negotiation
                self.wire_version = 2
                self.accept = tuple(
                    v for v in protocol.SUPPORTED_VERSIONS
                    if v <= outer.protocol_version)
                peer = self.client_address[0] \
                    if isinstance(self.client_address, tuple) else ""
                self.compress_on = protocol.default_compress(
                    peer, outer.compress)
                self.client_quant = False
                self.quant_on = False
                #: per-connection q8 scratch for reply frames (reset per
                #: message under the write lock)
                self.pool = protocol.BufferPool()

            def requant(self) -> None:
                want = outer.quantize if outer.quantize is not None \
                    else self.client_quant
                self.quant_on = bool(want) and \
                    self.wire_version >= protocol.Q8_MIN_VERSION

            def negotiate(self, meta) -> int:
                try:
                    want = int(meta.get("max_version", 2) or 2)
                except (TypeError, ValueError):
                    want = 2
                self.wire_version = max(2, min(outer.protocol_version,
                                               want))
                return self.wire_version

            def handle(self):
                # The HELLO exchange runs synchronously *before* the
                # read-ahead thread exists: an unauthenticated peer never
                # gets pipelined frame decoding.
                self.qos = constants.DEFAULT_QOS
                try:
                    if outer.token and not self._hello():
                        return
                except (ConnectionError, OSError, ValueError):
                    return
                with outer._lock:
                    outer._conn_seq += 1
                    conn_ns = f"cn{outer._conn_seq}:"
                tenant = outer.dispatcher.register_tenant(conn_ns,
                                                          qos=self.qos)
                # EXECUTE replies come from the dispatcher thread while
                # this thread answers PUT/INFO/...: one write lock keeps
                # reply frames from interleaving on the socket
                wlock = threading.Lock()

                def xid(i):
                    return conn_ns + i if isinstance(i, str) and \
                        i.startswith("c-") else i

                def remap_ids(meta):
                    for key in ("buf_id", "result_id"):
                        if key in meta:
                            meta[key] = xid(meta[key])
                    for key in ("buf_ids", "arg_refs", "result_ids",
                                "kv_bufs"):
                        if meta.get(key) is not None:
                            meta[key] = [xid(v) for v in meta[key]]
                    meta["_conn_ns"] = conn_ns
                    meta["_wire_version"] = self.wire_version
                    meta["_quant_on"] = self.quant_on
                    return meta
                # Read-ahead: decode the next pipelined request while the
                # current one computes.
                import queue as _queue

                inbox: "_queue.Queue" = _queue.Queue(maxsize=32)

                def _reader():
                    try:
                        while True:
                            rx: Dict[str, int] = {}
                            kind, meta, buffers = recv_message(
                                self.request, accept=self.accept,
                                stats=rx)
                            meta["_rx_wire"] = rx
                            inbox.put((kind, meta, buffers))
                    except (ConnectionError, OSError, ValueError):
                        inbox.put(None)

                threading.Thread(target=_reader, daemon=True,
                                 name="tpf-remote-readahead").start()
                try:
                    while True:
                        item = inbox.get()
                        if item is None:
                            break
                        kind, meta, buffers = item
                        seq = meta.get("seq")

                        def reply(rkind, rmeta, rbufs, compress=False,
                                  _seq=seq):
                            if _seq is not None:
                                rmeta = dict(rmeta, seq=_seq)
                            st: Dict[str, int] = {}
                            with wlock:
                                # ``compress`` marks result-carrying
                                # replies, so it also gates q8
                                parts = protocol.encode_message_parts(
                                    rkind, rmeta, rbufs,
                                    compress=compress
                                    and self.compress_on,
                                    version=self.wire_version,
                                    quantize=compress
                                    and self.quant_on,
                                    pool=self.pool,
                                    stats=st)
                                outer._merge_wire_stats(st)
                                protocol._send_parts(self.request,
                                                     parts)

                        if kind == "HELLO":
                            # repeated HELLO on an authed connection is a
                            # no-op ack; unauthenticated connections
                            # negotiate the wire version and QoS here
                            qos = meta.get("qos") or self.qos
                            if qos != tenant.qos:
                                outer.dispatcher.set_qos(tenant, qos)
                            self.client_quant = bool(meta.get("quant"))
                            reply("HELLO_OK",
                                  {"version": self.negotiate(meta),
                                   "qos_weight": qos_weight(qos),
                                   "worker_uid": outer.worker_uid}, [])
                            self.requant()
                            continue
                        try:
                            if kind == "EXECUTE":
                                # enqueue for the central dispatcher and
                                # go straight back to decoding
                                outer._enqueue_execute(
                                    reply, remap_ids(meta), buffers,
                                    tenant)
                                continue
                            if kind == "GENERATE":
                                # admission now; GENERATE_OK frames
                                # stream from the engine thread
                                outer._handle_generate(
                                    reply, remap_ids(meta), tenant)
                                continue
                            if kind == "KV_SHIP":
                                # ingest the shipped pages, then stream
                                # exactly like GENERATE
                                outer._handle_kv_ship(
                                    reply, remap_ids(meta), buffers,
                                    tenant)
                                continue
                            if kind in _BARRIER_KINDS:
                                outer.dispatcher.barrier(tenant)
                            outer._dispatch(reply, kind, remap_ids(meta),
                                            buffers)
                        except Exception as e:  # noqa: BLE001
                            log.exception("remote %s failed", kind)
                            outer.recorder.note(
                                "worker", "error", request=kind,
                                tenant=conn_ns,
                                error=f"{type(e).__name__}: {e}"[:200])
                            reply("ERROR", {"error": str(e)}, [])
                except (ConnectionError, OSError):
                    pass
                finally:
                    outer.dispatcher.unregister(tenant)

            def _hello(self) -> bool:
                """First frame must be a HELLO with the right token."""
                kind, meta, _ = recv_message(self.request,
                                             accept=self.accept)
                seq = meta.get("seq")

                def reply(rkind, rmeta):
                    if seq is not None:
                        rmeta = dict(rmeta, seq=seq)
                    send_message(self.request, rkind, rmeta, [],
                                 version=self.wire_version)

                if kind != "HELLO":
                    reply("ERROR", {"error": "authentication required"})
                    return False
                if not hmac.compare_digest(str(meta.get("token", "")),
                                           outer.token):
                    reply("ERROR", {"error": "bad token"})
                    return False
                self.qos = meta.get("qos") or self.qos
                self.client_quant = bool(meta.get("quant"))
                reply("HELLO_OK", {"version": self.negotiate(meta),
                                   "qos_weight": qos_weight(self.qos),
                                   "worker_uid": outer.worker_uid})
                self.requant()
                return True

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self.executions = 0

    @property
    def url(self) -> str:
        return f"tcp://127.0.0.1:{self.port}"

    def start(self) -> None:
        self.dispatcher.start()
        if self.engine is not None:
            pool_bytes = int(getattr(self.engine.runner, "nbytes", 0) or 0)
            if pool_bytes:
                with self._lock:
                    err = self._admit_resident(pool_bytes)
                if err:
                    self.dispatcher.stop()
                    raise RuntimeError(
                        f"serving KV pool does not fit the resident-HBM "
                        f"budget: {err}")
                self._engine_pool_bytes = pool_bytes
            try:
                self.engine.start()
            except BaseException:
                self._release_engine_pool()
                self.dispatcher.stop()
                raise
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="tpf-remote-worker",
                                        daemon=True)
        self._thread.start()
        log.info("remote worker serving %s on %s%s (dispatch=%s)",
                 self.device, self.url,
                 " (token auth)" if self.token else " (OPEN — no token)",
                 self.dispatcher.mode)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self.dispatcher.stop()
        if self.engine is not None:
            self.engine.stop()
            self._release_engine_pool()
        with self._lock:
            pool, self._copy_pool = self._copy_pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def _release_engine_pool(self) -> None:
        """Release exactly the pool charge :meth:`start` made."""
        with self._lock:
            nbytes, self._engine_pool_bytes = self._engine_pool_bytes, 0
            if nbytes:
                self.resident_bytes = max(0, self.resident_bytes - nbytes)
                if self.meter_client is not None:
                    self.meter_client.charge_hbm(-nbytes)

    # -- resident-buffer accounting ------------------------------------

    def _admit_resident(self, nbytes: int) -> Optional[str]:  # holds _lock
        """Charge `nbytes` of resident device memory; returns an error
        string when the budget rejects it (caller holds the lock)."""
        if self.max_resident_bytes and \
                self.resident_bytes + nbytes > self.max_resident_bytes:
            return (f"resident HBM budget exceeded: "
                    f"{self.resident_bytes + nbytes} > "
                    f"{self.max_resident_bytes}")
        if self.meter_client is not None:
            self.meter_client.charge_hbm(nbytes)
        self.resident_bytes += nbytes
        return None

    @staticmethod
    def _leaf_nbytes(arr: torch.Tensor) -> int:
        return arr.numel() * arr.element_size()

    def _release_resident(self, arr) -> None:   # holds _lock
        nbytes = self._leaf_nbytes(arr)
        self.resident_bytes = max(0, self.resident_bytes - nbytes)
        if self.meter_client is not None:
            self.meter_client.charge_hbm(-nbytes)

    # -- host->device copies -------------------------------------------

    def _pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._copy_pool is None:
                self._copy_pool = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="tpf-remote-copy")
            return self._copy_pool

    @staticmethod
    def _resolve(arr):
        """A buffer-table entry: async PUTs park a Future of the device
        tensor; everything else is the tensor itself."""
        return arr.result() if isinstance(arr, Future) else arr

    def _timed_put(self, buf_id: str, host: torch.Tensor) -> torch.Tensor:
        """Pool host->device copy with its duration recorded, so the
        EXECUTE that consumes it can split its transfer time into hidden
        and exposed."""
        t0 = time.monotonic()
        with DEVICE_GATE.shared():
            arr = host.to(self.device)
        with self._lock:
            self._copy_durs[buf_id] = time.monotonic() - t0
            # bounded: a client that PUTs and never EXECUTEs must not
            # grow this forever
            if len(self._copy_durs) > 4096:
                self._copy_durs.pop(next(iter(self._copy_durs)))
        return arr

    def _take_shard(self, buf_id: str) -> torch.Tensor:
        """Look up one uploaded buffer; an ephemeral one is consumed (out
        of the table, its resident bytes released), since the client
        never names it again."""
        with self._lock:
            arr = self._buffers.get(buf_id)
            ephemeral = buf_id in self._ephemeral
            self._copy_durs.pop(buf_id, None)
        if arr is None:
            raise KeyError(f"unknown buffer {buf_id}")
        arr = self._resolve(arr)
        if ephemeral:
            with self._lock:
                if self._buffers.pop(buf_id, None) is not None:
                    self._ephemeral.discard(buf_id)
                    self._release_resident(arr)
        return arr

    # -- central QoS dispatch: enqueue + device-side execution ----------

    def _merge_wire_stats(self, st: Dict[str, int]) -> None:
        if not st:
            return
        with self._lock:
            for k, v in st.items():
                self._wire_stats[k] = self._wire_stats.get(k, 0) + v

    def _enqueue_execute(self, reply, meta, buffers, tenant) -> None:
        """Connection handler side of EXECUTE: validate, wrap into a
        WorkItem and hand it to the dispatcher.  v4 connections get
        structured BUSY rejections; older ones block here (TCP
        backpressure)."""
        exe_id = meta["exe_id"]
        with self._lock:
            known = exe_id in self._exe_cache
            mflops = self._exe_costs.get(exe_id, 1)
            batchable = exe_id in self._exe_microbatch
        if not known:
            reply("ERROR", {"error": f"unknown executable {exe_id}",
                            "code": "needs_compile"}, [])
            return
        v4 = meta.get("_wire_version", 2) >= 4
        deadline_t = None
        if v4 and meta.get("deadline_ms") is not None:
            try:
                deadline_t = time.monotonic() + \
                    float(meta["deadline_ms"]) / 1e3
            except (TypeError, ValueError):
                deadline_t = None
        # fusable: requests that want their results on the wire
        # (keep_results parks device tensors per request)
        batch_key = exe_id if batchable and not meta.get("keep_results") \
            else None
        item = WorkItem("EXECUTE", meta, buffers, reply, float(mflops),
                        exe_id, batch_key, deadline_t,
                        trace=self._parse_trace(meta))
        # fire-and-forget chains (quiet / keep_results step chains mint
        # ids they immediately depend on) block instead of BUSY
        block = not v4 or bool(meta.get("quiet")) or \
            bool(meta.get("keep_results"))
        try:
            self.dispatcher.submit(tenant, item, block=block)
        except BusyError as e:
            reply("ERROR", {"error": str(e), "code": "BUSY",
                            "retry_after_ms": e.retry_after_ms}, [])

    def _handle_generate(self, reply, meta, tenant) -> None:
        """Connection handler side of GENERATE: validate, submit to the
        engine with a streaming emit callback.  The tenant's HELLO QoS
        class is its admission priority and its queue-wait SLO tier."""
        if self.engine is None:
            reply("ERROR", {"error": "no serving engine attached to "
                                     "this worker"}, [])
            return
        try:
            prompt = [int(t) for t in meta.get("prompt") or []]
            max_tokens = int(meta.get("max_tokens", 1) or 1)
            eos_id = meta.get("eos_id")
            eos_id = int(eos_id) if eos_id is not None else None
            deadline_ms = meta.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
        except (TypeError, ValueError) as e:
            reply("ERROR", {"error": f"bad GENERATE request: {e}"}, [])
            return
        stream = bool(meta.get("stream", True))
        emit = self._generate_emit(reply, stream)
        try:
            self.engine.submit(prompt, max_tokens,
                               tenant=tenant.conn_id, qos=tenant.qos,
                               eos_id=eos_id, deadline_ms=deadline_ms,
                               emit=emit, trace=self._parse_trace(meta))
        except BusyError as e:
            reply("ERROR", {"error": str(e), "code": "BUSY",
                            "retry_after_ms": e.retry_after_ms}, [])
        except ValueError as e:
            reply("ERROR", {"error": str(e)}, [])

    @staticmethod
    def _generate_emit(reply, stream: bool):
        """The engine emit callback GENERATE and KV_SHIP stream through:
        token frames as they land, one final frame with the stats, the
        engine's shed / BUSY codes as structured ERROR."""
        acc: List[int] = []

        def emit(seq, new_tokens, done, info):
            # engine thread; ``reply`` serializes on the connection's
            # write lock like dispatcher replies do
            try:
                if not done:
                    if stream and new_tokens:
                        reply("GENERATE_OK",
                              {"tokens": [int(t) for t in new_tokens],
                               "done": False}, [])
                    else:
                        acc.extend(int(t) for t in new_tokens)
                    return
                code = info.get("code")
                if code:
                    emeta = {"error": info.get("error", "generation failed"),
                             "code": code,
                             "queue_wait_ms": info.get("queue_wait_ms", 0)}
                    if seq.trace_spans:
                        emeta["trace_spans"] = list(seq.trace_spans)
                    reply("ERROR", emeta, [])
                    return
                tokens = [int(t) for t in new_tokens] if stream \
                    else acc + [int(t) for t in new_tokens]
                final = {"tokens": tokens, "done": True,
                         "n_tokens": len(seq.tokens),
                         "ttft_ms": seq.ttft_ms,
                         "finish_reason": info.get("finish_reason", "")}
                if seq.trace_spans:
                    final["trace_spans"] = list(seq.trace_spans)
                reply("GENERATE_OK", final, [])
            except (ConnectionError, OSError):
                # dead client socket: the engine keeps serving the other
                # tenants; this sequence's tokens are dropped at each emit
                pass

        return emit

    def _handle_kv_ship(self, reply, meta, buffers, tenant) -> None:
        """Connection handler side of KV_SHIP (protocol v6): ingest a
        prefill tier's finished KV pages into the engine's pool (deduped
        per block against its prefix registry), then stream the
        generation exactly like GENERATE.  The pages arrive inline (two
        ``[L, n, n_kv, bs, D]`` frame buffers) or as ``kv_bufs`` naming
        ephemeral PUTs the client sent ahead.  The KV_SHIP_OK receipt
        goes out once the engine holds the pages; the engine may already
        be streaming by then, so a short generation's final frame can
        precede it (the client reads the stream until it has both)."""
        if self.engine is None:
            reply("ERROR", {"error": "no serving engine attached to "
                                     "this worker"}, [])
            return
        if meta.get("_wire_version", 2) < protocol.KV_SHIP_MIN_VERSION:
            # the feature must be negotiated, never smuggled to a peer
            # that did not ask for v6
            reply("ERROR", {"error": "KV_SHIP needs protocol >= "
                                     f"{protocol.KV_SHIP_MIN_VERSION} "
                                     "(negotiate v6 at HELLO)"}, [])
            return
        try:
            prompt = [int(t) for t in meta.get("prompt") or []]
            max_tokens = int(meta.get("max_tokens", 1) or 1)
            eos_id = meta.get("eos_id")
            eos_id = int(eos_id) if eos_id is not None else None
            deadline_ms = meta.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
            keys = [int(x) for x in meta.get("keys") or []]
            n_tokens = int(meta.get("n_tokens", len(prompt)))
            if meta.get("first_token") is None:
                # the prefill tier's last chunk always yields one; a
                # shipped sequence without it could never decode
                raise ValueError("KV_SHIP without first_token")
            first = int(meta["first_token"])
            kv_bufs = meta.get("kv_bufs")
            if kv_bufs is not None:
                k = self._take_shard(str(kv_bufs[0]))
                v = self._take_shard(str(kv_bufs[1]))
            elif len(buffers) >= 2:
                k, v = buffers[0], buffers[1]
            else:
                k = v = None        # metadata-only ship (dedup probe)
            if k is not None and (k.dim() != 5 or k.shape != v.shape or
                                  k.shape[1] != len(keys)):
                raise ValueError(
                    f"KV pages {tuple(k.shape)} disagree with "
                    f"{len(keys)} shipped keys")
        except (TypeError, ValueError, KeyError) as e:
            reply("ERROR", {"error": f"bad KV_SHIP request: {e}"}, [])
            return
        stream = bool(meta.get("stream", True))
        emit = self._generate_emit(reply, stream)
        payload = {"keys": keys, "k": k, "v": v,
                   "first_token": first, "n_tokens": n_tokens,
                   "bytes": self._leaf_nbytes(k) + self._leaf_nbytes(v)
                   if k is not None else 0}
        try:
            self.engine.submit_shipped(
                prompt, max_tokens, payload, tenant=tenant.conn_id,
                qos=tenant.qos, eos_id=eos_id, deadline_ms=deadline_ms,
                emit=emit, trace=self._parse_trace(meta))
        except BusyError as e:
            reply("ERROR", {"error": str(e), "code": "BUSY",
                            "retry_after_ms": e.retry_after_ms}, [])
            return
        except ValueError as e:
            reply("ERROR", {"error": str(e)}, [])
            return
        reply("KV_SHIP_OK", {"blocks": len(keys), "n_tokens": n_tokens}, [])

    @staticmethod
    def _parse_trace(meta) -> Optional[dict]:
        """Propagated span context from a v5 EXECUTE, or None; a
        malformed or unsampled context disables tracing for the request
        rather than failing it."""
        if meta.get("_wire_version", 2) < 5:
            return None
        trace = meta.get("trace")
        if not isinstance(trace, dict) or not trace.get("trace_id") \
                or not trace.get("sampled", True):
            return None
        return {"trace_id": str(trace["trace_id"]),
                "span_id": str(trace.get("span_id", "") or ""),
                "sampled": True}

    @staticmethod
    def _traced_meta(item: WorkItem, rmeta: dict) -> dict:
        if item.trace and item.trace_spans:
            rmeta = dict(rmeta, trace_spans=list(item.trace_spans))
        return rmeta

    def _inline_args(self, item: WorkItem) -> list:
        """All-inline argument list on the device, consuming any copies
        the prefetch already started for this item."""
        devf = item.meta.pop("_dev_args", None)
        if devf is not None:
            with self._lock:
                self._upload_stats["inflight"] = max(
                    0, self._upload_stats["inflight"] - 1)
            args = []
            for f in devf:
                w0 = time.monotonic()
                arr, dur = f.result()
                # copy time the prefetch already paid while the prior
                # launch ran = hidden transfer
                self._hidden_acc += max(
                    dur - (time.monotonic() - w0), 0.0)
                args.append(arr)
            return args
        with DEVICE_GATE.shared():
            return [b.to(self.device) for b in item.buffers]

    def _item_args(self, item: WorkItem) -> list:
        """One item's flat argument list: resident refs and/or inline
        wire buffers."""
        arg_refs = item.meta.get("arg_refs")
        if arg_refs is None:
            return self._inline_args(item)
        resident = []
        with self._lock:
            for ref in arg_refs:
                arr = None if ref is None else self._buffers.get(ref)
                if ref is not None and arr is None:
                    raise KeyError(f"unknown buffer {ref}")
                resident.append(arr)
            dur = sum(self._copy_durs.pop(r, 0.0) for r in arg_refs
                      if r is not None)
        # copies and async PUTs (Futures in the table) resolve outside
        # the lock; what the PUT copy took beyond this wait ran hidden
        it = iter(item.buffers)
        w0 = time.monotonic()
        with DEVICE_GATE.shared():
            inline = [next(it).to(self.device) for arr in resident
                      if arr is None]
        inline_it = iter(inline)
        out = [next(inline_it) if arr is None else self._resolve(arr)
               for arr in resident]
        self._hidden_acc += max(dur - (time.monotonic() - w0), 0.0)
        return out

    def upload_stats(self) -> Dict[str, int]:
        """Prefetch depth accounting (INFO): queued items whose copies
        started ahead of dispatch, copies in flight, high-water depth."""
        with self._lock:
            return dict(self._upload_stats, depth=self.prefetch_depth)

    def _prefetch_next(self, peek_next) -> None:
        """Transfer/compute overlap: while the launch just issued runs,
        start the next ``prefetch_depth`` queued items' host->device
        copies on the pool."""
        if peek_next is None:
            return
        upcoming = self.dispatcher.peek_next_n(self.prefetch_depth)
        started = 0
        for nxt in upcoming:
            if nxt is None or not nxt.buffers or \
                    nxt.meta.get("_dev_args") is not None or \
                    nxt.meta.get("arg_refs") is not None:
                continue
            with self._lock:
                plain = nxt.exe_id in self._exe_cache
            if not plain:
                continue
            try:
                pool = self._pool()
                device = self.device

                def _timed_dev_put(b):
                    t0 = time.monotonic()
                    with DEVICE_GATE.shared():
                        arr = b.to(device)
                    return arr, time.monotonic() - t0

                nxt.meta["_dev_args"] = [
                    pool.submit(_timed_dev_put, b) for b in nxt.buffers]
                started += 1
            except Exception:  # noqa: BLE001 - overlap is advisory
                log.debug("prefetch overlap failed; EXECUTE will "
                          "transfer inline", exc_info=True)
                nxt.meta.pop("_dev_args", None)
        if started:
            with self._lock:
                st = self._upload_stats
                st["prefetched_total"] += started
                st["inflight"] += started
                st["high_water"] = max(st["high_water"], st["inflight"])

    def _execute_batch(self, items: List[WorkItem], peek_next):
        """Dispatcher callback: launch one work batch.  Returns a
        deferred flush (blocking result copy + reply) when there is
        one, so the dispatcher can overlap it with the next launch."""
        if len(items) == 1:
            return self._execute_one(items[0], peek_next)
        return self._execute_fused(items, peek_next)

    def _execute_fused(self, items: List[WorkItem], peek_next):
        """Micro-batched dispatch: k compatible requests, k calls of the
        loaded module back to back, results split back per request."""
        exe_id = items[0].exe_id
        k = len(items)
        with self._lock:
            module = self._exe_cache.get(exe_id)
            mflops = self._exe_costs.get(exe_id, 1)
        argsets = []
        for item in items:
            try:
                up0 = self.tracer.clock.now() if item.trace else 0.0
                self._hidden_acc = 0.0
                up_m0 = time.monotonic()
                args = self._item_args(item)
                self._attr_transfer(item, time.monotonic() - up_m0,
                                    self._hidden_acc)
                self._upload_span(item, up0, len(args))
                argsets.append((item, args))
            except KeyError as e:
                self._safe_reply(item, "ERROR",
                                 {"error": str(e.args[0])}, [])
        try:
            if len(argsets) != k:
                raise ValueError("partial batch")
            enq_m = time.monotonic()
            for item, _ in argsets:
                item.meta["_enq_m"] = enq_m
            with torch.no_grad(), DEVICE_GATE.shared():
                outs = [_leaves(module(*args)) for _, args in argsets]
        except Exception:  # noqa: BLE001 - degrade, don't fail the batch
            # a bad item must not take the innocent requests with it:
            # run the survivors one by one (on the same device)
            log.exception("fused dispatch of %d x %s degraded to "
                          "individual dispatch", k, exe_id)
            for item, _ in argsets:
                item.meta.pop("_dev_args", None)
                flush = self._execute_one(item, None)
                if flush is not None:
                    flush()
            return None
        self.executions += k
        if self.meter_client is not None:
            # each fused request is charged like an individual launch
            # (the fusion saves dispatch overhead, not billed compute)
            self.meter_client.charge_launch(mflops * k)
        self._prefetch_next(peek_next)

        def flush():
            f0 = self.tracer.clock.now() \
                if any(item.trace for item, _ in argsets) else 0.0
            materialized = []
            for (item, _), leaves in zip(argsets, outs):
                try:
                    with DEVICE_GATE.shared():
                        results = [leaf.detach().cpu() for leaf in leaves]
                except Exception as e:  # noqa: BLE001 - exec error
                    log.exception("fused flush failed")
                    self._safe_reply(item, "ERROR", {"error": str(e)}, [])
                    results = None
                materialized.append((item, results))
            self._attr_flush_compute(
                [item for item, r in materialized if r is not None],
                time.monotonic())
            for item, results in materialized:
                if results is None:
                    continue
                self._flush_span(item, f0, len(results))
                self._safe_reply(
                    item, "EXECUTE_OK",
                    self._traced_meta(item, {"n_results": len(results),
                                             "microbatched": k}),
                    results, compress=True)

        return flush

    @staticmethod
    def _rx_enc(rx: Dict[str, int]) -> str:
        """Dominant inbound wire encoding of one request's buffers."""
        for enc in ("q8", "zlib"):
            if rx.get(f"buffers_{enc}"):
                return enc
        return "raw"

    def _attr_flush_compute(self, items: List[WorkItem],
                            done_m: float) -> None:
        """Device-time attribution at result materialization: the
        inter-completion gap ``completion_k - max(completion_{k-1},
        enqueue_k)``, split cost-weighted across a fused batch (the
        flush's own wait would absorb other tenants' backlog)."""
        if self.profiler is None:
            return
        start = self._last_completion_m
        for item in items:
            enq = item.meta.get("_enq_m")
            if enq is not None:
                start = max(start, enq)
                break               # FIFO: the first item bounds all
        dur = max(done_m - start, 0.0)
        self._last_completion_m = done_m
        total_cost = sum(i.cost for i in items) or 1.0
        for item in items:
            if item.tenant is None:
                continue
            self.profiler.attribute(item.tenant.conn_id, "compute",
                                    dur * item.cost / total_cost,
                                    qos=item.tenant.qos, count=False)

    def _attr_transfer(self, item: WorkItem, exposed_s: float,
                       hidden_s: float) -> None:
        """Transfer attribution for one item: exposed = argument
        resolution on the launch's critical path, hidden = async copy
        time that ran behind earlier work."""
        if self.profiler is None or item.tenant is None:
            return
        exposed_s = max(exposed_s, 0.0)
        # the dispatcher subtracts the exposed portion from its launch
        # window so transfer time is never double-counted as compute
        item.meta["_xfer_exposed_s"] = exposed_s
        self.profiler.attribute(item.tenant.conn_id, "transfer",
                                exposed_s + hidden_s,
                                qos=item.tenant.qos,
                                hidden_s=hidden_s)

    def _upload_span(self, item: WorkItem, start_s: float,
                     n_args: int) -> None:
        """worker.upload span: argument resolution + host->device copy
        time for one traced item."""
        if not item.trace:
            return
        rx = item.meta.get("_rx_wire") or {}
        with self._lock:
            depth = self._upload_stats["inflight"]
        d = self.tracer.record_span(
            "worker.upload", start_s, self.tracer.clock.now(),
            parent=item.trace,
            attrs={"exe_id": item.exe_id, "args": n_args,
                   "enc": self._rx_enc(rx),
                   "wire_bytes": rx.get("wire_bytes", 0),
                   "overlap_depth": depth})
        if d is not None:
            item.trace_spans.append(d)

    def _flush_span(self, item: WorkItem, start_s: float,
                    n_results: int) -> None:
        """worker.flush span: the blocking device->host copy of one
        traced item's results."""
        if not item.trace:
            return
        d = self.tracer.record_span(
            "worker.flush", start_s, self.tracer.clock.now(),
            parent=item.trace,
            attrs={"exe_id": item.exe_id, "results": n_results})
        if d is not None:
            item.trace_spans.append(d)

    @staticmethod
    def _safe_reply(item: WorkItem, rkind, rmeta, rbufs,
                    compress: bool = False) -> None:
        """Reply without letting one tenant's dead socket poison the
        dispatcher (other tenants' items share the thread)."""
        try:
            item.reply(rkind, rmeta, rbufs, compress=compress)
        except (ConnectionError, OSError):
            pass

    def _execute_one(self, item: WorkItem, peek_next):
        """Single-request launch, on the dispatcher thread."""
        meta, reply = item.meta, item.reply
        exe_id = meta["exe_id"]
        with self._lock:
            module = self._exe_cache.get(exe_id)
            mflops = self._exe_costs.get(exe_id, 1)
        if module is None:
            self._safe_reply(item, "ERROR",
                             {"error": f"unknown executable {exe_id}",
                              "code": "needs_compile"}, [])
            return None
        if self.meter_client is not None:
            self.meter_client.charge_launch(mflops)
        # arg_refs: per-argument, a buf_id string for resident buffers
        # or null meaning "next inline wire buffer"
        up0 = self.tracer.clock.now() if item.trace else 0.0
        self._hidden_acc = 0.0
        up_m0 = time.monotonic()
        try:
            args = self._item_args(item)
        except KeyError as e:
            self._safe_reply(item, "ERROR",
                             {"error": str(e.args[0])}, [])
            return None
        self._attr_transfer(item, time.monotonic() - up_m0,
                            self._hidden_acc)
        self._upload_span(item, up0, len(args))
        item.meta["_enq_m"] = time.monotonic()
        with torch.no_grad(), DEVICE_GATE.shared():
            leaves = _leaves(module(*args))
        self.executions += 1
        # overlap: while this launch runs, start the next items' copies
        self._prefetch_next(peek_next)
        if meta.get("keep_results"):
            # park results device-side, hand back references; a client
            # may pre-assign result ids ("c-" namespace) so its very next
            # EXECUTE can reference them without waiting for this reply
            want_ids = meta.get("result_ids")
            if want_ids is not None:
                if len(want_ids) != len(leaves):
                    self._safe_reply(
                        item, "ERROR",
                        {"error": f"result_ids count {len(want_ids)} "
                                  f"!= {len(leaves)} results"}, [])
                    return None
                ns = meta.get("_conn_ns", "")
                if not all(str(i).startswith(ns) for i in want_ids):
                    # only ids the connection-namespace remap produced
                    # are accepted — a raw id could clobber another
                    # client's (or worker-minted) buffer
                    self._safe_reply(item, "ERROR",
                                     {"error": "result_ids must be "
                                               "c-namespace ids"}, [])
                    return None
            ids, shapes, dtypes = [], [], []
            with self._lock:
                total = sum(self._leaf_nbytes(l) for l in leaves)
                err = self._admit_resident(total)
                for j, leaf in enumerate(leaves if not err else ()):
                    if want_ids is not None:
                        buf_id = str(want_ids[j])
                    else:
                        self._buf_seq += 1
                        buf_id = f"buf-{self._buf_seq}"
                    self._buffers[buf_id] = leaf
                    ids.append(buf_id)
                    shapes.append(list(leaf.shape))
                    dtypes.append(protocol.WIRE_NAMES[leaf.dtype])
            if err:
                self._safe_reply(item, "ERROR", {"error": err}, [])
                return None
            if meta.get("quiet"):
                # pipelined client: it minted the ids itself and
                # discards success replies unread
                return None
            self._safe_reply(item, "EXECUTE_OK",
                             self._traced_meta(item,
                                               {"result_refs": ids,
                                                "shapes": shapes,
                                                "dtypes": dtypes}), [])
            return None

        # defer the device->host copy: the dispatcher launches the next
        # batch before this flush blocks, so reply serialization of
        # launch k overlaps device compute of k+1
        def flush(_leaves=leaves, _item=item):
            try:
                f0 = self.tracer.clock.now() if _item.trace else 0.0
                with DEVICE_GATE.shared():
                    results = [leaf.detach().cpu() for leaf in _leaves]
                self._attr_flush_compute([_item], time.monotonic())
                self._flush_span(_item, f0, len(results))
                self._safe_reply(_item, "EXECUTE_OK",
                                 self._traced_meta(
                                     _item,
                                     {"n_results": len(results)}),
                                 results, compress=True)
            except Exception as e:  # noqa: BLE001 - exec error
                log.exception("deferred EXECUTE flush failed")
                self._safe_reply(_item, "ERROR", {"error": str(e)}, [])

        return flush

    # ------------------------------------------------------------------

    def _info(self, meta) -> dict:
        dev = self.device
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "cpu"
        platform = "gpu" if dev.type == "cuda" else dev.type
        with self._lock:
            snapshot = dict(self._buffers)
        resident = 0
        for arr in snapshot.values():
            try:
                resident += self._leaf_nbytes(self._resolve(arr))
            # a failed async PUT surfaces at the EXECUTE that uses the
            # buffer; the INFO stats loop just skips it
            except Exception:  # noqa: BLE001 - failed async PUT
                continue
        with self._lock:
            wire = dict(self._wire_stats)
            cached_executables = len(self._exe_cache)
            resident_bytes = self.resident_bytes
        if wire.get("raw_bytes"):
            # realized adaptive-compression ratio: wire bytes actually
            # sent / raw bytes they encode
            wire["realized_ratio"] = round(
                wire.get("wire_bytes", 0) / wire["raw_bytes"], 4)
        return {
            "platform": platform,
            "device_kind": kind,
            "n_devices": 1,
            "protocol_version": self.protocol_version,
            "quant_on": bool(meta.get("_quant_on")),
            "upload_overlap": self.upload_stats(),
            "dispatch": self.dispatcher.snapshot(),
            "profile": self.profiler.snapshot()
            if self.profiler is not None else None,
            "serving": self.engine.snapshot()
            if self.engine is not None else None,
            "worker_uid": self.worker_uid,
            "wire_compression": wire,
            "devices": [{"id": 0, "platform": platform,
                         "device_kind": kind, "process_index": 0,
                         "coords": [0]}],
            "resident_bytes_per_device": {"0": resident},
            "cached_executables": cached_executables,
            "resident_bytes": resident_bytes}

    def _compile(self, reply, meta, buffers) -> None:
        """COMPILE: the blob is a torch.export archive; its exe_id is
        the first 32 hex digits of its sha256.  A blob that fails the
        check, the load or the move to this device raises, and the
        handler replies ERROR."""
        blob = buffers[0].numpy().tobytes() if buffers else b""
        exe_id = hashlib.sha256(blob).hexdigest()[:32]
        with self._lock:
            known = exe_id in self._exe_cache
        if not known:
            module = program.load_program(blob, self.device)
            with self._lock:
                if exe_id not in self._exe_cache:
                    self._exe_cache[exe_id] = module
                    # charge model: the client's FLOP estimate
                    self._exe_costs[exe_id] = int(
                        meta.get("mflops_hint", 1))
        if meta.get("microbatch"):
            with self._lock:
                self._exe_microbatch.add(exe_id)
        reply("COMPILE_OK", {"exe_id": exe_id}, [])

    def _put(self, reply, meta, buffers) -> None:
        """PUT: a device-resident buffer, uploaded once and referenced
        many times.  v3: a client-minted ``buf_id`` (``c-`` namespace)
        copies on the pool and returns at once; ``quiet`` skips the
        success reply; ``ephemeral`` frees the buffer when its first
        consumer takes it (``_take_shard``)."""
        host = buffers[0]
        v3 = meta.get("_wire_version", 2) >= 3
        device_id = int(meta.get("device_id", 0)) if v3 else 0
        if device_id != 0:
            reply("ERROR", {"error": f"no device {device_id} "
                                     f"(worker has 1)"}, [])
            return
        want_id = meta.get("buf_id") if v3 else None
        if want_id is not None and \
                not str(want_id).startswith(meta.get("_conn_ns", "")):
            reply("ERROR", {"error": "client-minted buf_id must be "
                                     "a c-namespace id"}, [])
            return
        with self._lock:
            err = self._admit_resident(self._leaf_nbytes(host))
            if not err and want_id is not None:
                buf_id = str(want_id)
            elif not err:
                self._buf_seq += 1
                buf_id = f"buf-{self._buf_seq}"
        if err:
            # replies go out of the lock: framing one merges wire stats
            reply("ERROR", {"error": err}, [])
            return
        if want_id is not None:
            arr = self._pool().submit(self._timed_put, buf_id, host)
        else:
            # worker-minted ids keep the v2 contract: PUT_OK means the
            # buffer is resident (and a failed copy releases its charge)
            try:
                with DEVICE_GATE.shared():
                    arr = host.to(self.device)
            except Exception:
                with self._lock:
                    self._release_resident(host)
                raise
        with self._lock:
            self._buffers[buf_id] = arr
            if v3 and meta.get("ephemeral"):
                self._ephemeral.add(buf_id)
        if v3 and meta.get("quiet"):
            return
        reply("PUT_OK", {"buf_id": buf_id, "device_id": 0}, [])

    def _free(self, reply, meta) -> None:
        freed = 0
        for buf_id in list(meta.get("buf_ids", [])):
            with self._lock:
                arr = self._buffers.pop(buf_id, None)
                self._copy_durs.pop(buf_id, None)
                self._ephemeral.discard(buf_id)
            if arr is not None:
                arr = self._resolve(arr)    # async PUT still in flight
                with self._lock:
                    self._release_resident(arr)
                freed += 1
        if meta.get("quiet") and meta.get("_wire_version", 2) >= 3:
            return
        reply("FREE_OK", {"freed": freed}, [])

    def _fetch(self, reply, meta) -> None:
        with self._lock:
            arr = self._buffers.get(meta["buf_id"])
        if arr is None:
            reply("ERROR",
                  {"error": f"unknown buffer {meta['buf_id']}"}, [])
            return
        arr = self._resolve(arr)
        with DEVICE_GATE.shared():
            host = arr.detach().cpu()
        reply("FETCH_OK", {}, [host], compress=True)

    def _dispatch(self, reply, kind, meta, buffers) -> None:
        if kind == "INFO":
            reply("INFO_OK", self._info(meta), [])
        elif kind == "COMPILE":
            self._compile(reply, meta, buffers)
        elif kind == "PUT":
            self._put(reply, meta, buffers)
        elif kind == "FREE":
            self._free(reply, meta)
        elif kind == "FETCH":
            self._fetch(reply, meta)
        else:
            reply("ERROR", {"error": f"unknown kind {kind}"}, [])
