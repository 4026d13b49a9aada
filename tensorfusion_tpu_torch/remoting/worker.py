"""Remote worker of the port: serves one device, or the ranks of a rank
group as a mesh, over TCP.

The port's ``tensorfusion_tpu/remoting/worker.py``.  It runs on the GPU
host (``python -m tensorfusion_tpu_torch.remoting``), accepts HELLO /
INFO / COMPILE / PUT / FREE / FETCH / EXECUTE, and keeps an executable
cache keyed by content hash so repeated clients share one loaded
program.

With ``ranks=n`` (``--ranks n``, n > 1) its devices are the n ranks of a
``parallel.launch.RankGroup`` that it spawns at :meth:`start`
(``remoting/sharded.py``; rank r on ``cuda:(r % count)``), and it
serves protocol v3's sharded programs: COMPILE returns ``nr_devices``
and a wire layout per argument and result, EXECUTE takes
``arg_shards`` (resident or inline shards in layout order), PUT and
FETCH a ``device_id``, INFO lists the devices and
``resident_bytes_per_device`` (and, when the request asks with
``ranks``, each rank's pid, launches and launch hook report).  Each rank runs the program on its own
shards; the worker process itself never touches the card.  Such a
worker refuses the kinds that need one device's state (GENERATE,
KV_SHIP, the collectives, the fabric, SNAPSHOT / RESTORE, migration),
naming what it refused.  A program is a ``torch.export`` archive
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
step.

State and peers, each kind refused below its wire version (the worker
half of the double gate):

- **federated collectives** (v7): ALLREDUCE_SHIP / ALLGATHER_SHIP ride
  the dispatcher as work items whose heavy half (take the partials,
  reduce, reply) is the deferred flush; half-float terms are summed in
  f32 on the device and cast back once, integers and bools exactly.
- **peer fabric** (v9): FABRIC_OPEN parks a ring session; each member's
  FABRIC_ALLREDUCE leg adds its partials to the running sum its
  predecessor deposited (PEER_REDUCE), relays it up-ring over a pooled
  :class:`~.fabric.PeerLink`, fans the total back down-ring
  (PEER_INSTALL) and installs it resident, so the client relays no
  payload.  A hop waits at most :data:`FABRIC_HOP_TIMEOUT_S`.
- **SNAPSHOT / RESTORE**: resident buffers (raw little-endian files, the
  reference's layout) and executable archives persist to a directory
  that must resolve inside the worker's ``state_root``.
- **streaming live migration** (v8): every install of a resident buffer
  bumps its write generation; SNAPSHOT_DELTA ships what changed since
  the previous round to a target worker as staged PUTs (a low-QoS
  ``migration`` tenant's work item); MIGRATE_FREEZE holds mutating kinds
  at the handlers, drains the dispatcher and pauses a hosted engine
  between steps; MIGRATE_COMMIT ships the final delta and publishes it
  on the target (or, with ``abort``, frees it there and thaws). The
  target gives the source's client-minted ids a fresh namespace and
  never replaces a resident buffer; INFO ``migration.moved`` tells each
  source connection its ids there. Like the reference's, these
  orchestrator kinds trust any caller that holds the worker's token.

Archives are code, not data: every archive loaded outside COMPILE (at
RESTORE, or shipped by a migrating peer) must hash to its id and pass
:func:`~.program.check_archive` first.  COMPILE_MLIR (the reference's
raw-StableHLO path) gets the reference's ``unknown kind`` ERROR.

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
import itertools
import json
import logging
import os
import re
import socket
import socketserver
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import constants
from ..device import DEVICE_GATE, DeviceLike, resolve_device
from ..profiling.profiler import Profiler
from ..profiling.recorder import FlightRecorder
from ..tracing.core import Tracer
from . import program, protocol
from .sharded import RankDevices, RankError
from .dispatch import BusyError, DeviceDispatcher, WorkItem, qos_weight
from .fabric import PeerLinkPool
from .protocol import recv_message, send_message

log = logging.getLogger("tpf_torch.remoting.worker")

#: request kinds that observe execution effects (results, resident-set
#: mutations) and therefore wait for the connection's queued EXECUTEs
#: to finish before running — per-connection ordering across the shared
#: dispatch queue
_BARRIER_KINDS = ("FETCH", "FREE", "SNAPSHOT", "RESTORE")

#: request kinds that mutate resident state (or generate) and so wait at
#: the connection handler while a MIGRATE_FREEZE holds the worker dark
_MUTATING_KINDS = ("EXECUTE", "GENERATE", "KV_SHIP", "ALLREDUCE_SHIP",
                   "ALLGATHER_SHIP", "FABRIC_ALLREDUCE", "PUT", "FREE")

#: how long a frozen worker holds mutating requests: a dead orchestrator
#: must not wedge tenant connections for ever
MIGRATE_FREEZE_MAX_S = 30.0

#: how long one fabric ring member waits for its peer's deposit: a
#: wedged ring aborts (freeing the dispatcher thread) strictly before a
#: freeze's quiesce gives up
FABRIC_HOP_TIMEOUT_S = 20.0

#: an executable id: the first 32 hex digits of its archive's sha256
_EXE_ID = re.compile(r"[0-9a-f]{32}")

#: request kinds a worker over several ranks refuses: each needs one
#: device's resident state, an engine or a peer of one device
_ONE_DEVICE_KINDS = ("GENERATE", "KV_SHIP", "ALLREDUCE_SHIP",
                     "ALLGATHER_SHIP", "SNAPSHOT", "RESTORE",
                     "SNAPSHOT_DELTA", "MIGRATE_FREEZE", "MIGRATE_COMMIT",
                     "FABRIC_OPEN", "FABRIC_ALLREDUCE", "PEER_REDUCE",
                     "PEER_INSTALL")


def _exe_id(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()[:32]


def _leaves(out) -> list:
    """A module's flat outputs as a list."""
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    return a.type != "cuda" or (a.index or 0) == (b.index or 0)


class _MigrationSession:
    """Source side of one streaming pre-copy: a pooled link to the
    target (leased as the lowest QoS class), the real-id -> staged-id
    manifest accumulated over rounds, and the write generation fully
    shipped so far."""

    def __init__(self, pool: PeerLinkPool, target_url: str, token: str = "",
                 quantize: bool = False):
        self.target_url = target_url
        self._pool = pool
        self.link = pool.lease(target_url, token=token,
                               qos=constants.QOS_LOW, quantize=quantize)
        self.device = self.link.device
        #: real buf_id -> staged c- id (the latest round's copy)
        self.staged: Dict[str, str] = {}
        #: exe_id -> staged c- id carrying the archive
        self.staged_exes: Dict[str, str] = {}
        #: staged ids superseded by re-dirtied buffers; freed at commit
        self.drops: List[str] = []
        self.round = 0
        #: write generation fully shipped (dirty = gen > shipped_gen)
        self.shipped_gen = 0
        self.raw_bytes = 0
        self.wire_bytes = 0
        #: set by MIGRATE_FREEZE: the start of the tenant-dark window
        self.freeze_m: Optional[float] = None
        #: "live" or "frozen" while the session exists; "committed" or
        #: "aborted" as MIGRATE_COMMIT clears it
        self.state = "live"
        self._mint = itertools.count(1)

    def mint(self, tag: str) -> str:
        return f"c-mig{next(self._mint)}-{tag}"

    def close(self) -> None:
        """Give the link back to the pool for the next session or ring."""
        try:
            self._pool.release(self.link)
        except Exception:  # noqa: BLE001 - teardown best effort
            log.debug("migration session close failed", exc_info=True)


class _FabricCollective:
    """One open peer-fabric collective: made by FABRIC_OPEN, consumed by
    this worker's FABRIC_ALLREDUCE flush.  Peer deposits arrive on other
    connections' handler threads and park here; the flush waits for
    them, bounded by :data:`FABRIC_HOP_TIMEOUT_S`."""

    def __init__(self, cid: str):
        self.cid = cid
        #: "open" or "reducing" while the session exists; "done" or
        #: "aborted" as its flush clears it
        self.state = "open"
        self._cv = threading.Condition()
        #: step -> running sum the up-ring PEER_REDUCE deposited
        self._reduces: Dict[int, torch.Tensor] = {}
        #: step -> total the down-ring PEER_INSTALL deposited
        self._installs: Dict[int, torch.Tensor] = {}
        self._error: Optional[str] = None

    def deposit(self, table: str, step: int, payload) -> None:
        with self._cv:
            tbl = self._reduces if table == "reduce" else self._installs
            tbl[step] = payload
            self._cv.notify_all()

    def take(self, table: str, step: int, timeout: float):
        """Wait for the peer's ``step`` deposit (or the hop timeout, or
        the session's abort)."""
        deadline = time.monotonic() + timeout
        tbl = self._reduces if table == "reduce" else self._installs
        with self._cv:
            while step not in tbl:
                if self._error is not None:
                    raise RuntimeError(self._error)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"fabric {table} hop {step} timed out after "
                        f"{timeout:.0f}s (cid={self.cid})")
                self._cv.wait(timeout=min(remaining, 0.5))
            return tbl.pop(step)

    def abort(self, error: str) -> None:
        """Wake every waiter with the failure."""
        with self._cv:
            self._error = error
            self._cv.notify_all()


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
                 device: DeviceLike = "cuda",
                 state_root: Optional[str] = None,
                 ranks: int = 1):
        #: the device this worker owns, or its ranks' device type (rank r
        #: on ``cuda:(r % count)``); "cuda" without a card raises
        self.device = resolve_device(device)
        if ranks < 1:
            raise ValueError(f"ranks must be at least 1, got {ranks}")
        if ranks > 1 and engine is not None:
            raise ValueError("a worker over several ranks hosts no engine")
        #: the number of devices; above 1 they are the ranks that
        #: :meth:`start` spawns (``rank_devices``)
        self.n_ranks = ranks
        self.rank_devices: Optional[RankDevices] = None
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
        #: exe_id -> archive bytes (SNAPSHOT and migration ship them)
        # guarded by: _lock
        self._exe_blobs: Dict[str, bytes] = {}
        #: exe_ids whose client opted into micro-batching at COMPILE
        # guarded by: _lock
        self._exe_microbatch: set = set()
        #: SNAPSHOT / RESTORE read and write only below this directory
        #: (``state_dir`` comes off the wire); None refuses both
        self.state_root = os.path.realpath(state_root) if state_root \
            else None
        #: write generation per resident buffer, bumped on every install
        #: (PUT, keep_results, collective install, RESTORE, migration),
        #: so a SNAPSHOT_DELTA round ships only what changed
        # guarded by: _lock
        self._buf_gen: Dict[str, int] = {}
        # guarded by: _lock
        self._write_gen = 0
        #: the one live pre-copy session (None between migrations)
        # guarded by: _lock
        self._mig_session: Optional[_MigrationSession] = None
        #: the one open fabric collective (None between rings); a new
        #: FABRIC_OPEN replaces and aborts it
        # guarded by: _lock
        self._fab_session: Optional[_FabricCollective] = None
        #: pooled worker-to-worker links: migration sessions and ring
        #: hops lease from here
        self._peer_pool = PeerLinkPool()
        # guarded by: _lock
        self._fab_stats: Dict[str, float] = {
            "rings_total": 0, "reduce_hops_total": 0,
            "install_hops_total": 0, "aborted_total": 0,
            "peer_raw_bytes_total": 0, "peer_wire_bytes_total": 0}
        #: set = thawed; MIGRATE_FREEZE clears it and mutating kinds wait
        #: at the handler until commit or abort (at most
        #: MIGRATE_FREEZE_MAX_S)
        self._mig_thaw = threading.Event()
        self._mig_thaw.set()
        #: the dispatch tenant SNAPSHOT_DELTA rounds queue as (lowest
        #: weight; made at the first round)
        self._mig_tenant = None
        # guarded by: _lock
        self._mig_stats: Dict[str, float] = {
            "rounds_total": 0, "delta_buffers_total": 0,
            "delta_raw_bytes_total": 0, "delta_wire_bytes_total": 0,
            "streaming_total": 0, "aborted_total": 0,
            "installed_total": 0, "pause_ms_last": 0.0,
            "pause_ms_max": 0.0}
        #: the last committed migration: its target and every buffer id
        #: shipped there -> its id on the target (INFO ``migration
        #: .moved`` tells each connection its own)
        # guarded by: _lock
        self._mig_moved: Optional[Dict[str, object]] = None
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
        #: the sockets of open connections (stop() ends them)
        # guarded by: _lock
        self._conns: set = set()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                import socket as _socket

                self.request.setsockopt(_socket.IPPROTO_TCP,
                                        _socket.TCP_NODELAY, 1)
                with outer._lock:
                    outer._conns.add(self.request)
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

            def finish(self):
                with outer._lock:
                    outer._conns.discard(self.request)

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
                                "kv_bufs", "acc_bufs"):
                        if meta.get(key) is not None:
                            meta[key] = [xid(v) for v in meta[key]]
                    if isinstance(meta.get("arg_shards"), list):
                        meta["arg_shards"] = [
                            None if g is None else [xid(v) for v in g]
                            for g in meta["arg_shards"]]
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
                        if kind in _MUTATING_KINDS and \
                                not outer._mig_thaw.is_set():
                            # MIGRATE_FREEZE: mutations wait here until
                            # commit or abort thaws the worker; reads
                            # (INFO, FETCH, COMPILE) keep flowing
                            outer._mig_thaw.wait(
                                timeout=MIGRATE_FREEZE_MAX_S)

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
                            if kind in _ONE_DEVICE_KINDS and \
                                    outer.n_ranks > 1:
                                reply("ERROR", {
                                    "error": f"{kind} is not served by a "
                                             f"worker over {outer.n_ranks} "
                                             f"ranks (it needs one device)"},
                                      [])
                                continue
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
                            if kind in ("ALLREDUCE_SHIP",
                                        "ALLGATHER_SHIP"):
                                # v7: dispatcher items with a deferred
                                # flush, ordered by the connection's FIFO
                                outer._enqueue_collective(
                                    reply, kind, remap_ids(meta),
                                    buffers, tenant)
                                continue
                            if kind == "SNAPSHOT_DELTA":
                                # v8: one pre-copy round, queued as the
                                # low-QoS migration tenant
                                outer._enqueue_snapshot_delta(
                                    reply, remap_ids(meta))
                                continue
                            if kind == "MIGRATE_FREEZE":
                                outer._handle_migrate_freeze(
                                    reply, remap_ids(meta))
                                continue
                            if kind == "MIGRATE_COMMIT":
                                outer._handle_migrate_commit(
                                    reply, remap_ids(meta))
                                continue
                            if kind == "FABRIC_OPEN":
                                # v9 rendezvous, answered at once so every
                                # member is open before any leg flies
                                outer._handle_fabric_open(
                                    reply, remap_ids(meta))
                                continue
                            if kind == "FABRIC_ALLREDUCE":
                                outer._enqueue_fabric_allreduce(
                                    reply, remap_ids(meta), buffers,
                                    tenant)
                                continue
                            if kind in ("PEER_REDUCE", "PEER_INSTALL"):
                                # a ring neighbour's hop: deposit and ack
                                outer._handle_peer_hop(
                                    reply, kind, remap_ids(meta), buffers)
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
        if self.n_ranks > 1:
            self._start_ranks()
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
        # thaw first: handlers parked behind a freeze must see the
        # shutdown instead of waiting out their timeout
        self._mig_thaw.set()
        with self._lock:
            sess, self._mig_session = self._mig_session, None
            fab, self._fab_session = self._fab_session, None
        if sess is not None:
            sess.close()
        if fab is not None:
            fab.abort("worker stopping")
        self._peer_pool.close()
        self._server.shutdown()
        self._server.server_close()
        # end the connections still open: their handler threads hold this
        # worker (and its engine, buffers and ranks) for as long as they run
        with self._lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self.dispatcher.stop()
        if self.engine is not None:
            self.engine.stop()
            self._release_engine_pool()
        with self._lock:
            pool, self._copy_pool = self._copy_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        if self.rank_devices is not None:
            self.rank_devices.close()

    def _start_ranks(self) -> None:
        """Spawn the ranks.  Under the node agent's launch hook this
        process joins its tenant's segment first (the ranks inherit the
        hook and each joins at its first launch), so the segment lists
        every process of the tenant."""
        from ..hypervisor import cuda_hook_binding

        hook = cuda_hook_binding.loaded()
        if hook is not None:
            hook.metered()
        self.rank_devices = RankDevices(
            self.n_ranks, self.device, self._lock,
            admit=self._admit_resident, release=self._release_bytes)

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

    def _touch_buf(self, buf_id: str) -> None:   # holds _lock
        """Bump ``buf_id``'s write generation: every install or
        overwrite of a resident buffer lands here."""
        self._write_gen += 1
        self._buf_gen[buf_id] = self._write_gen

    def _pop_buffer(self, buf_id: str):   # holds _lock
        """Take ``buf_id`` out of the table with its bookkeeping; the
        caller releases its bytes."""
        self._copy_durs.pop(buf_id, None)
        self._ephemeral.discard(buf_id)
        self._buf_gen.pop(buf_id, None)
        return self._buffers.pop(buf_id, None)

    @staticmethod
    def _leaf_nbytes(arr: torch.Tensor) -> int:
        return arr.numel() * arr.element_size()

    def _release_resident(self, arr) -> None:   # holds _lock
        self._release_bytes(self._leaf_nbytes(arr))

    def _release_bytes(self, nbytes: int) -> None:   # holds _lock
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
                if self._pop_buffer(buf_id) is not None:
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
            known = exe_id in self._exe_cache or (
                self.rank_devices is not None
                and exe_id in self.rank_devices.exes)
            mflops = self._exe_costs.get(exe_id, 1)
            batchable = exe_id in self._exe_microbatch
        if not known:
            reply("ERROR", {"error": f"unknown executable {exe_id}",
                            "code": "needs_compile"}, [])
            return
        if meta.get("arg_shards") is not None and \
                not self._version_gate(reply, meta, "arg_shards",
                                       protocol.SHARD_MIN_VERSION):
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

    # -- version gates and deferred work items --------------------------

    @staticmethod
    def _version_gate(reply, meta, kind: str, need: int) -> bool:
        """Worker half of the double gate: the client refuses to send
        ``kind`` below ``need``; a frame smuggled from a connection that
        negotiated less dies here."""
        if meta.get("_wire_version", 2) < need:
            reply("ERROR", {"error": f"{kind} needs protocol >= {need} "
                                     f"(negotiate v{need} at HELLO)"}, [])
            return False
        return True

    def _enqueue_work(self, reply, kind: str, meta, buffers, tenant) -> None:
        """Queue a collective, ring leg or pre-copy round on ``tenant``.
        These consume resident state already parked here, so they block
        (TCP backpressure) instead of answering BUSY."""
        item = WorkItem(kind, meta, buffers, reply, 1.0,
                        f"<{kind.lower()}>", None, None,
                        trace=self._parse_trace(meta))
        self.dispatcher.submit(tenant, item, block=True)

    def _launch_deferred(self, item: WorkItem):
        """Dispatcher arm of a collective, ring leg or pre-copy round: the
        launch is empty and the work runs as the deferred flush, so the
        dispatcher launches the connection's next queued EXECUTE first."""
        flushes = {"ALLREDUCE_SHIP": self._flush_allreduce,
                   "ALLGATHER_SHIP": self._flush_allgather,
                   "FABRIC_ALLREDUCE": self._flush_fabric_allreduce,
                   "SNAPSHOT_DELTA": self._flush_snapshot_delta}

        def flush(_item=item):
            kind = _item.kind
            try:
                flushes[kind](_item)
            except Exception as e:  # noqa: BLE001 - reply, keep serving
                if isinstance(e, KeyError) and e.args:
                    error = str(e.args[0])
                elif kind == "SNAPSHOT_DELTA" and \
                        isinstance(e, (ConnectionError, OSError)):
                    # the target died mid-round: the session survives
                    # and the orchestrator decides (retry or abort)
                    error = f"delta ship failed: {e}"
                else:
                    log.exception("%s failed", kind)
                    error = str(e)
                if kind == "FABRIC_ALLREDUCE":
                    self._abort_fabric(_item, error)
                else:
                    self._safe_reply(_item, "ERROR", {"error": error}, [])

        return flush

    # -- federated collectives (protocol v7) ----------------------------

    def _enqueue_collective(self, reply, kind: str, meta, buffers,
                            tenant) -> None:
        if self._version_gate(reply, meta, kind, protocol.FED_MIN_VERSION):
            self._enqueue_work(reply, kind, meta, buffers, tenant)

    def _collective_sources(self, ids, free_src: bool) -> List[torch.Tensor]:
        """The named resident buffers; ``free_src`` consumes them (the
        partials a reduce retires, with no FREE round trip)."""
        parts = []
        for sid in ids:
            sid = str(sid)
            with self._lock:
                arr = self._buffers.get(sid)
            if arr is None:
                raise KeyError(f"unknown buffer {sid}")
            arr = self._resolve(arr)
            parts.append(arr)
            if free_src:
                with self._lock:
                    if self._pop_buffer(sid) is not None:
                        self._release_resident(arr)
        return parts

    def _accumulate(self, terms: List[torch.Tensor]) -> torch.Tensor:
        """Sum on this worker's device, left to right, into a fresh
        tensor.  bf16 and f16 terms are summed in f32 and cast back once
        (widening is exact and the f32 adds are IEEE, so the total equals
        the reference's numpy sum bit for bit); integers and bools sum
        exactly."""
        out_dtype = terms[0].dtype
        acc_dtype = torch.float32 \
            if out_dtype in (torch.float16, torch.bfloat16) else out_dtype
        with DEVICE_GATE.shared():
            total = terms[0].to(self.device, acc_dtype, copy=True)
            for t in terms[1:]:
                total = total + t.to(self.device, acc_dtype)
            return total.to(out_dtype)

    def _install_resident(self, rid: str, total: torch.Tensor,
                          conn_ns: str) -> str:
        """Park a reduced total resident under a client-minted id.  A
        re-install over an existing id releases the old buffer first."""
        if not rid.startswith(conn_ns):
            # only ids the connection-namespace remap produced: a raw id
            # could clobber another client's buffer
            raise ValueError("result_id must be a c-namespace id")
        with self._lock:
            old = self._pop_buffer(rid)
        if old is not None:
            old = self._resolve(old)
            with self._lock:
                self._release_resident(old)
        with self._lock:
            err = self._admit_resident(self._leaf_nbytes(total))
        if err:
            raise RuntimeError(err)
        with DEVICE_GATE.shared():
            arr = total.to(self.device)
        with self._lock:
            self._buffers[rid] = arr
            self._touch_buf(rid)
        return rid

    def _attr_collective(self, item: WorkItem, ship_s: float) -> None:
        """The reduce-and-ship tail on the tenant's transfer ledger; the
        completion anchor moves so the next launch's gap excludes it."""
        if self.profiler is not None and item.tenant is not None:
            self.profiler.attribute(item.tenant.conn_id, "transfer",
                                    max(ship_s, 0.0), qos=item.tenant.qos)
        self._last_completion_m = time.monotonic()

    def _host(self, arr: torch.Tensor) -> torch.Tensor:
        """A device tensor's host copy for the wire or the disk."""
        with DEVICE_GATE.shared():
            return arr.detach().cpu()

    def _flush_allreduce(self, item: WorkItem) -> None:
        meta, buffers = item.meta, item.buffers
        op = meta.get("op", "sum")
        if op != "sum":
            raise ValueError(f"unsupported collective op {op!r}")
        parts = self._collective_sources(meta.get("buf_ids") or [],
                                         bool(meta.get("free_src")))
        acc = None
        acc_bufs = meta.get("acc_bufs")
        if acc_bufs:
            # the client's accumulator came ahead as an ephemeral PUT
            acc = self._take_shard(str(acc_bufs[0]))
        elif buffers:
            acc = buffers[0]
        terms = parts + ([acc] if acc is not None else [])
        if not terms:
            raise ValueError("ALLREDUCE_SHIP with nothing to reduce")
        m1 = time.monotonic()
        total = self._accumulate(terms)
        rmeta = {"op": op, "n_src": len(parts), "shape": list(total.shape),
                 "dtype": protocol.WIRE_NAMES[total.dtype]}
        rid = meta.get("result_id")
        if rid is not None:
            rmeta["installed"] = self._install_resident(
                str(rid), total, meta.get("_conn_ns", ""))
        nbytes = sum(self._leaf_nbytes(t) for t in terms)
        self.dispatcher.note_collective(meta.get("_conn_ns", ""),
                                        "allreduce", nbytes)
        if not (meta.get("quiet") and meta.get("receipt_only")):
            # fire-and-forget installs skip the frame (errors still
            # reply); a receipt_only reply carries no array
            rbufs = [] if meta.get("receipt_only") else [self._host(total)]
            self._safe_reply(item, "ALLREDUCE_SHIP_OK",
                             self._traced_meta(item, rmeta), rbufs,
                             compress=True)
        self._attr_collective(item, time.monotonic() - m1)

    def _flush_allgather(self, item: WorkItem) -> None:
        meta = item.meta
        axis = int(meta.get("axis", 0) or 0)
        parts = self._collective_sources(meta.get("buf_ids") or [],
                                         bool(meta.get("free_src")))
        if not parts:
            raise ValueError("ALLGATHER_SHIP with no source buffers")
        m1 = time.monotonic()
        # one frame leaves the worker however many local pieces fed it
        with DEVICE_GATE.shared():
            piece = (parts[0] if len(parts) == 1
                     else torch.cat(parts, dim=axis)).detach().cpu()
        rmeta = {"n_src": len(parts), "shape": list(piece.shape),
                 "dtype": protocol.WIRE_NAMES[piece.dtype]}
        self.dispatcher.note_collective(
            meta.get("_conn_ns", ""), "allgather",
            sum(self._leaf_nbytes(p) for p in parts))
        self._safe_reply(item, "ALLGATHER_SHIP_OK",
                         self._traced_meta(item, rmeta), [piece],
                         compress=True)
        self._attr_collective(item, time.monotonic() - m1)

    # -- peer fabric (protocol v9) ----------------------------------------

    def _handle_fabric_open(self, reply, meta) -> None:
        """Rendezvous: make (or replace) this worker's fabric session
        under ``cid`` and ack at once.  The client opens every member
        before any leg flies, so no PEER hop can race its session; a
        replaced session is aborted, and its flush errors against its own
        object, never the new one."""
        if not self._version_gate(reply, meta, "FABRIC_OPEN",
                                  protocol.FABRIC_MIN_VERSION):
            return
        cid = str(meta.get("cid") or "")
        if not cid:
            reply("ERROR", {"error": "FABRIC_OPEN without cid"}, [])
            return
        sess = _FabricCollective(cid)
        with self._lock:
            old, self._fab_session = self._fab_session, sess
        if old is not None:
            old.abort(f"fabric session replaced by {cid!r}")
        reply("FABRIC_OPEN_OK", {"cid": cid, "worker_uid": self.worker_uid},
              [])

    def _enqueue_fabric_allreduce(self, reply, meta, buffers,
                                  tenant) -> None:
        """A ring leg rides the owning connection's tenant, so its hops
        overlap the connection's next queued EXECUTE and its bytes are
        that tenant's."""
        if self._version_gate(reply, meta, "FABRIC_ALLREDUCE",
                              protocol.FABRIC_MIN_VERSION):
            self._enqueue_work(reply, "FABRIC_ALLREDUCE", meta, buffers,
                               tenant)

    def _abort_fabric(self, item: WorkItem, error: str) -> None:
        """Error arm of a ring leg: clear the slot if it still holds this
        leg's session, wake its waiters, reply ERROR."""
        cid = str(item.meta.get("cid") or "")
        with self._lock:
            sess = self._fab_session
            if sess is not None and sess.cid == cid:
                self._fab_session = None
            else:
                sess = None
            self._fab_stats["aborted_total"] += 1
        if sess is not None:
            sess.state = "aborted"
            sess.abort(error)
        self._safe_reply(item, "ERROR", {"error": error}, [])

    def _ship_hop(self, url: str, quant: bool, send, host) -> tuple:
        """One hop over a pooled link: ``send(link, host)``; returns the
        (raw, wire) bytes it moved."""
        link = self._peer_pool.lease(url, token=self.token, quantize=quant)
        try:
            w0 = link.wire_bytes
            send(link, host)
            return self._leaf_nbytes(host), link.wire_bytes - w0
        finally:
            self._peer_pool.release(link)

    def _flush_fabric_allreduce(self, item: WorkItem) -> None:
        """One leg of the accumulator-relay ring.  Member 0 ships its
        pre-reduced partial to member 1; each member adds its partial to
        the running sum and relays it up-ring (PEER_REDUCE); the last
        holds the total and fans it down-ring (PEER_INSTALL, forwarded
        before the local install).  Every member installs the total
        under ``result_id`` and replies a receipt.  ``ring`` and
        ``index`` come off the wire and are bounded before use.  No wait
        here is inside the device gate or the worker's lock."""
        meta = item.meta
        cid = str(meta.get("cid") or "")
        with self._lock:
            sess = self._fab_session
        if sess is None or sess.cid != cid:
            raise ValueError(
                f"FABRIC_ALLREDUCE without an open fabric session "
                f"(cid={cid!r}): send FABRIC_OPEN first")
        if sess.state != "open":
            raise ValueError(f"fabric session {cid!r} is {sess.state!r}, "
                             f"not open")
        op = str(meta.get("op", "sum") or "sum")
        if op != "sum":
            raise ValueError(f"unsupported collective op {op!r}")
        ring = meta.get("ring") or []
        n = len(ring)
        if n < 2 or n > protocol.MAX_FABRIC_RING:
            raise ValueError(f"fabric ring size {n} outside "
                             f"[2, {protocol.MAX_FABRIC_RING}]")
        index = int(meta.get("index", -1))
        if index < 0 or index >= n:
            raise ValueError(f"fabric ring index {index} outside [0, {n})")
        sess.state = "reducing"
        quant = bool(meta.get("quant"))
        parts = self._collective_sources(meta.get("buf_ids") or [],
                                         bool(meta.get("free_src")))
        if not parts:
            raise ValueError("FABRIC_ALLREDUCE with nothing to reduce")
        m0 = time.monotonic()
        # local pre-reduction: one payload rides each hop however many
        # partials this member holds
        running = self._accumulate(parts)
        if index > 0:
            upstream = sess.take("reduce", index, FABRIC_HOP_TIMEOUT_S)
            running = self._accumulate([running, upstream])
        hops = link_raw = link_wire = 0
        if index < n - 1:
            raw, wire = self._ship_hop(
                str((ring[index + 1] or {}).get("url") or ""), quant,
                lambda link, h: link.ship_reduce(cid, index + 1, h, op=op),
                self._host(running))
            hops, link_raw, link_wire = hops + 1, link_raw + raw, \
                link_wire + wire
            total = sess.take("install", index, FABRIC_HOP_TIMEOUT_S)
        else:
            total = running
        if index > 0:
            raw, wire = self._ship_hop(
                str((ring[index - 1] or {}).get("url") or ""), quant,
                lambda link, h: link.ship_install(cid, index - 1, h),
                self._host(total))
            hops, link_raw, link_wire = hops + 1, link_raw + raw, \
                link_wire + wire
        rid = meta.get("result_id")
        installed = None
        if rid is not None:
            installed = self._install_resident(str(rid), total,
                                               meta.get("_conn_ns", ""))
        elapsed = time.monotonic() - m0
        nbytes = sum(self._leaf_nbytes(p) for p in parts)
        self.dispatcher.note_collective(meta.get("_conn_ns", ""),
                                        "allreduce", nbytes)
        with self._lock:
            if index == 0:
                self._fab_stats["rings_total"] += 1
            self._fab_stats["peer_raw_bytes_total"] += link_raw
            self._fab_stats["peer_wire_bytes_total"] += link_wire
        rmeta = {"cid": cid, "index": index, "hops": hops, "op": op,
                 "n_src": len(parts), "shape": list(total.shape),
                 "dtype": protocol.WIRE_NAMES[total.dtype],
                 "peer_raw_bytes": link_raw, "peer_wire_bytes": link_wire,
                 "elapsed_ms": round(elapsed * 1e3, 3)}
        if installed is not None:
            rmeta["installed"] = installed
        if item.trace:
            d = self.tracer.record_span(
                "fabric.ring", m0, self.tracer.clock.now(),
                parent=item.trace,
                attrs={"cid": cid, "index": index, "workers": n,
                       "hops": hops, "raw_bytes": link_raw,
                       "wire_bytes": link_wire})
            if d is not None:
                item.trace_spans.append(d)
        with self._lock:
            if self._fab_session is sess:
                self._fab_session = None
        sess.state = "done"
        # a receipt: the total never rides back to the client
        self._safe_reply(item, "FABRIC_ALLREDUCE_OK",
                         self._traced_meta(item, rmeta), [])
        self._attr_collective(item, elapsed)

    def _handle_peer_hop(self, reply, kind: str, meta, buffers) -> None:
        """A ring neighbour's hop (PEER_REDUCE up-ring, PEER_INSTALL
        down-ring): deposit the payload for this worker's own leg and
        ack; the ack is the ring's backpressure."""
        if not self._version_gate(reply, meta, kind,
                                  protocol.FABRIC_MIN_VERSION):
            return
        cid = str(meta.get("cid") or "")
        try:
            step = int(meta.get("step", -1))
        except (TypeError, ValueError):
            step = -1
        if step < 0 or step >= protocol.MAX_FABRIC_RING:
            reply("ERROR", {"error": f"peer step {step} outside "
                                     f"[0, {protocol.MAX_FABRIC_RING})"}, [])
            return
        if not buffers:
            reply("ERROR", {"error": f"{kind} without payload"}, [])
            return
        with self._lock:
            sess = self._fab_session
        if sess is None or sess.cid != cid or \
                sess.state not in ("open", "reducing"):
            reply("ERROR", {"error": f"no open fabric session for cid "
                                     f"{cid!r} (send FABRIC_OPEN to every "
                                     f"ring member first)"}, [])
            return
        table = "reduce" if kind == "PEER_REDUCE" else "install"
        sess.deposit(table, step, buffers[0])
        with self._lock:
            self._fab_stats[f"{table}_hops_total"] += 1
        reply(f"{kind}_OK", {"cid": cid, "step": step}, [])

    def fabric_stats(self) -> Dict[str, object]:
        """INFO ``fabric``: lifetime ring, hop and byte counters, the
        open session and the peer-link pool's ledger."""
        with self._lock:
            out: Dict[str, object] = dict(self._fab_stats)
            sess = self._fab_session
            out["session"] = {"cid": sess.cid, "state": sess.state} \
                if sess is not None else None
        out["pool"] = self._peer_pool.snapshot()
        return out

    # -- archives from outside COMPILE ------------------------------------

    def _load_module(self, blob: bytes):
        """Check and load an archive onto this worker's device; the move
        of its constants is device work, so it enters the gate."""
        with DEVICE_GATE.shared():
            module, shardings = program.load_program(blob, self.device)
        if shardings is not None:
            raise ValueError(f"executable is sharded over "
                             f"{shardings['nr_devices']} devices but this "
                             f"worker has 1")
        return module

    def _load_archive(self, exe_id: str, blob: bytes, mflops: int) -> None:
        """Load an archive from a snapshot directory or a migrating peer,
        neither more trusted than a tenant: it must hash to its id and
        pass the program check before anything unpickles it."""
        if not _EXE_ID.fullmatch(str(exe_id)) or _exe_id(blob) != exe_id:
            raise ValueError(f"archive does not hash to its id {exe_id!r}")
        with self._lock:
            known = exe_id in self._exe_cache
        if known:
            return
        module = self._load_module(blob)
        with self._lock:
            self._exe_cache.setdefault(exe_id, module)
            self._exe_blobs.setdefault(exe_id, blob)
            self._exe_costs.setdefault(exe_id, max(int(mflops), 1))

    # -- snapshot / restore -------------------------------------------------

    def _state_path(self, state_dir) -> str:
        """``state_dir`` (off the wire) resolved inside ``state_root``."""
        if self.state_root is None:
            raise ValueError("SNAPSHOT / RESTORE need the worker's "
                             "state_root (state_root= or --state-root)")
        if not isinstance(state_dir, str) or not state_dir:
            raise ValueError("SNAPSHOT / RESTORE without a state_dir")
        return self._inside(self.state_root, state_dir)

    def _inside(self, root: str, name: str) -> str:
        """``root/name`` with every link resolved, refused unless it
        stays inside the state root."""
        path = os.path.realpath(os.path.join(root, name))
        if os.path.commonpath([self.state_root, path]) != self.state_root:
            raise ValueError(f"state path {name!r} resolves outside the "
                             f"worker's state_root")
        return path

    def _state_file(self, state_dir: str, name: str, suffix: str) -> str:
        name = str(name)
        if not name or name in (".", "..") or "/" in name or "\0" in name:
            raise ValueError(f"bad snapshot entry {name!r}")
        return self._inside(state_dir, name + suffix)

    def snapshot_to(self, state_dir: str) -> Dict[str, int]:
        """Persist resident buffers and executable archives under
        ``state_dir`` (inside ``state_root``): one raw little-endian file
        per buffer, its shape and dtype name in ``manifest.json`` (the
        reference's layout), one ``{exe_id}.pt2`` per archive."""
        path = self._state_path(state_dir)
        os.makedirs(path, exist_ok=True)
        with self._lock:
            buffers = dict(self._buffers)
            blobs = dict(self._exe_blobs)
            costs = dict(self._exe_costs)
            buf_seq = self._buf_seq
        manifest = {"buf_seq": buf_seq, "buffers": {}, "executables": {}}
        nbytes = 0
        for buf_id, arr in buffers.items():
            wire = protocol._Wire(self._host(self._resolve(arr)))
            manifest["buffers"][buf_id] = {"shape": wire.shape,
                                           "dtype": wire.dtype}
            with open(self._state_file(path, buf_id, ".npy"), "wb") as f:
                f.write(memoryview(wire.u8))
            nbytes += wire.nbytes
        for exe_id, blob in blobs.items():
            with open(self._state_file(path, exe_id, ".pt2"), "wb") as f:
                f.write(blob)
            manifest["executables"][exe_id] = {"mflops": costs.get(exe_id,
                                                                   1)}
        with open(self._state_file(path, "manifest", ".json"), "w") as f:
            json.dump(manifest, f)
        return {"buffers": len(buffers), "executables": len(blobs),
                "bytes": nbytes}

    def restore_from(self, state_dir: str) -> Dict[str, int]:
        """Re-materialize a snapshot: every archive is checked and loaded
        first (a refused one restores nothing), then every buffer is
        admitted and copied to the device; a restored id replaces a
        resident one."""
        path = self._state_path(state_dir)
        with open(self._state_file(path, "manifest", ".json")) as f:
            manifest = json.load(f)
        bufs = manifest.get("buffers") or {}
        exes = manifest.get("executables") or {}
        for exe_id, info in exes.items():
            with open(self._state_file(path, exe_id, ".pt2"), "rb") as f:
                blob = f.read()
            self._load_archive(exe_id, blob, int((info or {}).get("mflops",
                                                                  1)))
        with self._lock:
            self._buf_seq = max(self._buf_seq,
                                int(manifest.get("buf_seq", 0) or 0))
        nbytes = 0
        for buf_id, desc in bufs.items():
            fname = self._state_file(path, buf_id, ".npy")
            raw = bytearray(os.path.getsize(fname))
            with open(fname, "rb") as f:
                f.readinto(raw)
            host = protocol._tensor_of(raw, {"dtype": desc["dtype"],
                                             "shape": desc["shape"]})
            self._install_buffer(str(buf_id), host, "restore rejected")
            nbytes += len(raw)
        return {"buffers": len(bufs), "executables": len(exes),
                "bytes": nbytes}

    def _install_buffer(self, buf_id: str, host: torch.Tensor,
                        what: str) -> None:
        """Admit ``host``, copy it to the device and publish it under
        ``buf_id``, replacing (and releasing) what was there."""
        with self._lock:
            err = self._admit_resident(self._leaf_nbytes(host))
        if err:
            raise RuntimeError(f"{what}: {err}")
        try:
            with DEVICE_GATE.shared():
                arr = host.to(self.device)
        except Exception:
            with self._lock:
                self._release_resident(host)
            raise
        self._publish(buf_id, arr)

    def _publish(self, buf_id: str, arr: torch.Tensor) -> None:
        """Publish an admitted device tensor under ``buf_id``; the
        buffer it replaces is released."""
        with self._lock:
            old = self._pop_buffer(buf_id)
            self._buffers[buf_id] = arr
            self._touch_buf(buf_id)
        if old is not None:
            old = self._resolve(old)
            with self._lock:
                self._release_resident(old)

    # -- streaming live migration (protocol v8) ----------------------------

    def _enqueue_snapshot_delta(self, reply, meta) -> None:
        """A pre-copy round queues as the lowest-weight ``migration``
        tenant, so it yields to serving and never starves it."""
        if not self._version_gate(reply, meta, "SNAPSHOT_DELTA",
                                  protocol.MIGRATE_MIN_VERSION):
            return
        if not meta.get("target_url"):
            reply("ERROR", {"error": "SNAPSHOT_DELTA without target_url"},
                  [])
            return
        if self._mig_tenant is None:
            self._mig_tenant = self.dispatcher.register_tenant(
                "migration", qos=constants.QOS_LOW)
        self._enqueue_work(reply, "SNAPSHOT_DELTA", meta, [],
                           self._mig_tenant)

    def _mig_ensure_session(self, meta) -> _MigrationSession:
        """The one live pre-copy session; a new target closes the old."""
        target = str(meta["target_url"])
        with self._lock:
            sess = self._mig_session
            old = None
            if sess is not None and sess.target_url != target:
                old, self._mig_session, sess = sess, None, None
        if old is not None:
            old.close()
        if sess is None:
            token = meta.get("target_token")
            sess = _MigrationSession(
                self._peer_pool, target,
                token=str(token) if token is not None else self.token,
                quantize=bool(meta.get("quant")))
            with self._lock:
                self._mig_session = sess
        return sess

    def _mig_ship_round(self, sess: _MigrationSession,
                        final: bool) -> Dict[str, object]:
        """One round: every buffer dirtied since the session's shipped
        generation, and every archive not shipped yet, go to the target
        as staged quiet PUTs; new archives are loaded there at once (a
        prepare-only MIGRATE_COMMIT), so no load lands in the frozen
        window.  Returns the round's receipt."""
        t0 = time.monotonic()
        with self._lock:
            gen_now = self._write_gen
            dirty_ids = sorted(bid for bid, g in self._buf_gen.items()
                               if g > sess.shipped_gen and
                               bid in self._buffers)
            dirty = [(bid, self._buffers[bid]) for bid in dirty_ids]
            blobs = {eid: blob for eid, blob in self._exe_blobs.items()
                     if eid not in sess.staged_exes}
            costs = {eid: self._exe_costs.get(eid, 1) for eid in blobs}
            resident_total = len(self._buffers)
        st: Dict[str, int] = {}
        raw = 0
        for bid, arr in dirty:
            host = self._host(self._resolve(arr))
            sid = sess.mint("b")
            old = sess.staged.pop(bid, None)
            if old is not None:
                # re-dirtied since an earlier round: that copy is freed
                # on the target at commit
                sess.drops.append(old)
            sess.staged[bid] = sid
            sess.link.stage(sid, host, stats=st)
            raw += self._leaf_nbytes(host)
        new_exes: Dict[str, str] = {}
        for eid in sorted(blobs):
            sid = sess.mint("x")
            sess.staged_exes[eid] = sid
            new_exes[eid] = sid
            sess.link.stage(sid, np.frombuffer(blobs[eid], dtype=np.uint8),
                            stats=st)
            raw += len(blobs[eid])
        sess.link.drain()
        if new_exes:
            sess.device._rpc(
                "MIGRATE_COMMIT",
                {"manifest": {}, "exes": new_exes, "costs": costs,
                 "drops": [], "buf_seq": 0, "prepare": True}, [])
        sess.shipped_gen = gen_now
        sess.round += 1
        elapsed = max(time.monotonic() - t0, 1e-9)
        wire = int(st.get("wire_bytes", 0))
        sess.raw_bytes += raw
        sess.wire_bytes += wire
        with self._lock:
            dirty_left = sum(1 for bid, g in self._buf_gen.items()
                             if g > gen_now and bid in self._buffers)
            ms = self._mig_stats
            ms["rounds_total"] += 1
            ms["delta_buffers_total"] += len(dirty)
            ms["delta_raw_bytes_total"] += raw
            ms["delta_wire_bytes_total"] += wire
        if self.profiler is not None:
            self.profiler.attribute("migration", "transfer", elapsed,
                                    qos=constants.QOS_LOW)
        return {"round": sess.round, "buffers": len(dirty),
                "executables": len(blobs), "raw_bytes": raw,
                "wire_bytes": wire, "elapsed_ms": round(elapsed * 1e3, 3),
                "dirty_left": dirty_left, "resident_total": resident_total,
                "bandwidth_bps": int(wire / elapsed), "final": bool(final)}

    def _flush_snapshot_delta(self, item: WorkItem) -> None:
        meta = item.meta
        final = bool(meta.get("final"))
        sess = self._mig_ensure_session(meta)
        s0 = self.tracer.clock.now() if item.trace else 0.0
        rmeta = self._mig_ship_round(sess, final)
        if item.trace:
            d = self.tracer.record_span(
                "migrate.delta", s0, self.tracer.clock.now(),
                parent=item.trace,
                attrs={"round": rmeta["round"], "buffers": rmeta["buffers"],
                       "raw_bytes": rmeta["raw_bytes"],
                       "wire_bytes": rmeta["wire_bytes"], "final": final})
            if d is not None:
                item.trace_spans.append(d)
        self._safe_reply(item, "SNAPSHOT_DELTA_OK",
                         self._traced_meta(item, rmeta), [])
        self._last_completion_m = time.monotonic()

    def _handle_migrate_freeze(self, reply, meta) -> None:
        """Freeze for the final round: mutations wait at the handlers,
        the dispatcher drains, a hosted engine pauses between steps (never
        inside one, so never inside a lazy capture); the reply reports
        the dirty set still to ship."""
        if not self._version_gate(reply, meta, "MIGRATE_FREEZE",
                                  protocol.MIGRATE_MIN_VERSION):
            return
        self._mig_thaw.clear()
        try:
            self.dispatcher.quiesce(timeout=MIGRATE_FREEZE_MAX_S)
            if self.engine is not None:
                self.engine.freeze()
        except TimeoutError as e:
            self._mig_thaw_now()
            reply("ERROR", {"error": str(e)}, [])
            return
        with self._lock:
            sess = self._mig_session
            if sess is not None and sess.state == "live":
                # a repeated FREEZE must not restart the pause clock
                sess.state = "frozen"
                sess.freeze_m = time.monotonic()
            shipped = sess.shipped_gen if sess is not None else 0
            dirty = [self._buffers[bid] for bid, g in self._buf_gen.items()
                     if g > shipped and bid in self._buffers]
        dirty_bytes = sum(self._leaf_nbytes(self._resolve(a)) for a in dirty)
        reply("MIGRATE_FREEZE_OK", {"frozen": True,
                                    "dirty_buffers": len(dirty),
                                    "dirty_bytes": dirty_bytes}, [])

    def _mig_thaw_now(self) -> None:
        if self.engine is not None:
            self.engine.thaw()
        self._mig_thaw.set()

    def _handle_migrate_commit(self, reply, meta) -> None:
        """Dual-role MIGRATE_COMMIT: with a ``manifest`` this worker is
        the target publishing staged state; without one it is the source
        ending its session (``abort`` frees the staged state on the
        target; otherwise ship the final frozen delta, publish it on the
        target, drop the state here).  Both thaw."""
        if not self._version_gate(reply, meta, "MIGRATE_COMMIT",
                                  protocol.MIGRATE_MIN_VERSION):
            return
        if meta.get("manifest") is not None:
            self._migrate_install(reply, meta)
            return
        with self._lock:
            sess, self._mig_session = self._mig_session, None
        if meta.get("abort"):
            if sess is not None:
                staged = list(sess.staged.values()) + \
                    list(sess.staged_exes.values()) + list(sess.drops)
                try:
                    if staged:
                        sess.device._submit(
                            "FREE", {"buf_ids": staged, "quiet": True},
                            [], want_reply=False)
                except (ConnectionError, OSError):
                    pass    # the target is gone: nothing to free there
                sess.state = "aborted"
                sess.close()
            with self._lock:
                self._mig_stats["aborted_total"] += 1
            self._mig_thaw_now()
            reply("MIGRATE_COMMIT_OK", {"aborted": True}, [])
            return
        if sess is None:
            reply("ERROR", {"error": "MIGRATE_COMMIT without a live "
                                     "migration session (send "
                                     "SNAPSHOT_DELTA first)"}, [])
            return
        if sess.state != "frozen" or self._mig_thaw.is_set():
            with self._lock:
                self._mig_session = sess    # still live: not consumed
            reply("ERROR", {"error": "MIGRATE_COMMIT on a thawed worker "
                                     "(send MIGRATE_FREEZE first)"}, [])
            return
        try:
            # a mutation that raced past the freeze check drains here;
            # the frozen final round ships what it dirtied
            self.dispatcher.quiesce(timeout=MIGRATE_FREEZE_MAX_S)
            final = self._mig_ship_round(sess, final=True)
            with self._lock:
                manifest = {rid: sid for rid, sid in sess.staged.items()
                            if rid in self._buffers}
                drops = sess.drops + [sid for rid, sid in sess.staged.items()
                                      if rid not in manifest]
                buf_seq = self._buf_seq
            # archives were loaded on the target during the rounds, so
            # the frozen commit only flips buffers live
            rmeta = sess.device._rpc(
                "MIGRATE_COMMIT", {"manifest": manifest, "exes": {},
                                   "drops": drops, "buf_seq": buf_seq},
                [])[1]
        except (ConnectionError, OSError, RuntimeError) as e:
            # the target died at the flip: the source keeps its state
            with self._lock:
                self._mig_session = sess
            self._mig_thaw_now()
            reply("ERROR", {"error": f"migrate commit failed: {e}"}, [])
            return
        # the state lives on the target now: drop it here, so a client
        # that reconnects never sees stale buffers
        renamed = dict(rmeta.get("ids") or {})
        with self._lock:
            self._mig_moved = {
                "target_url": sess.target_url,
                "ids": {rid: str(renamed.get(rid, rid)) for rid in manifest}}
            dropped, self._buffers = self._buffers, {}
            self._buf_gen.clear()
            self._ephemeral.clear()
            self._copy_durs.clear()
        for arr in dropped.values():
            try:
                arr = self._resolve(arr)
            # a failed async PUT holds no resident bytes to release
            except Exception:  # noqa: BLE001 - failed async PUT
                continue
            with self._lock:
                self._release_resident(arr)
        pause_ms = 0.0
        if sess.freeze_m is not None:
            pause_ms = round((time.monotonic() - sess.freeze_m) * 1e3, 3)
        with self._lock:
            ms = self._mig_stats
            ms["streaming_total"] += 1
            ms["pause_ms_last"] = pause_ms
            ms["pause_ms_max"] = max(ms["pause_ms_max"], pause_ms)
        out = {"pause_ms": pause_ms, "rounds": sess.round,
               "buffers": int(rmeta.get("installed", 0)),
               "executables": len(sess.staged_exes),
               "raw_bytes": sess.raw_bytes, "wire_bytes": sess.wire_bytes,
               "final_round": final, "ids": renamed}
        sess.state = "committed"
        sess.close()
        self._mig_thaw_now()
        reply("MIGRATE_COMMIT_OK", out, [])

    def _migrate_install(self, reply, meta) -> None:
        """Target side of MIGRATE_COMMIT: publish the staged buffers under
        their real ids (the bytes were admitted at PUT), load the shipped
        archives (each checked like a tenant's), free superseded copies
        and move ``buf_seq`` past the source's.  Staged ids must be this
        connection's ``c-`` ids: a peer cannot rename another client's
        buffers.

        Client-minted ids move to a fresh connection namespace here (the
        source's ``cn3:`` may be a live connection of this worker), and
        the receipt's ``ids`` maps each old id to its new one.  A
        manifest id that already names a buffer here refuses the whole
        install before anything is published: a migration never replaces
        another client's state (the reference's install did)."""
        conn_ns = meta.get("_conn_ns", "")

        def staged(sid) -> str:
            sid = str(sid)
            if not sid.startswith("c-"):
                raise ValueError(f"staged id {sid!r} is not a c- id")
            return conn_ns + sid

        manifest = meta.get("manifest") or {}
        exes = meta.get("exes") or {}
        costs = meta.get("costs") or {}
        drops = meta.get("drops") or []
        ids: Dict[str, str] = {}
        with self._lock:
            # moved first, so no id PUT meanwhile meets a shipped one
            self._buf_seq = max(self._buf_seq,
                                int(meta.get("buf_seq", 0) or 0))
            fresh: Dict[str, str] = {}
            for rid in map(str, manifest):
                ns, sep, cid = rid.partition(":")
                if sep and cid.startswith("c-"):
                    if ns not in fresh:
                        self._conn_seq += 1
                        fresh[ns] = f"cn{self._conn_seq}:"
                    ids[rid] = fresh[ns] + cid
                else:
                    ids[rid] = rid
            taken = sorted(rid for rid in manifest
                           if ids[str(rid)] in self._buffers)
        if taken:
            reply("ERROR", {"error": f"migrate install: {taken[:5]} "
                                     f"({len(taken)} total) already name "
                                     f"buffers here"}, [])
            return
        missing = []
        for eid, sid in sorted(exes.items()):
            with self._lock:
                arr = self._pop_buffer(staged(sid))
            if arr is None:
                missing.append(eid)
                continue
            arr = self._resolve(arr)
            blob = self._host(arr).numpy().tobytes()
            with self._lock:
                self._release_resident(arr)
            self._load_archive(str(eid), blob, int(costs.get(eid, 1) or 1))
        installed = 0
        for rid, sid in sorted(manifest.items()):
            with self._lock:
                arr = self._pop_buffer(staged(sid))
            if arr is None:
                missing.append(rid)
                continue
            self._publish(ids[str(rid)], self._resolve(arr))
            installed += 1
        for sid in drops:
            with self._lock:
                arr = self._pop_buffer(staged(sid))
            if arr is not None:
                arr = self._resolve(arr)
                with self._lock:
                    self._release_resident(arr)
        with self._lock:
            self._mig_stats["installed_total"] += installed
        if missing:
            reply("ERROR", {"error": f"migrate install missing staged state "
                                     f"for {missing[:5]} ({len(missing)} "
                                     f"total)"}, [])
            return
        reply("MIGRATE_COMMIT_OK",
              {"installed": installed, "executables": len(exes),
               "ids": {rid: new for rid, new in ids.items() if new != rid}},
              [])

    def migration_stats(self) -> Dict[str, object]:
        """INFO ``migration``: lifetime round, byte and pause counters,
        whether the worker is frozen, and the live session."""
        with self._lock:
            out: Dict[str, object] = dict(self._mig_stats)
            sess = self._mig_session
            out["frozen"] = not self._mig_thaw.is_set()
            out["session"] = {
                "target_url": sess.target_url, "round": sess.round,
                "staged_buffers": len(sess.staged),
                "staged_executables": len(sess.staged_exes),
                "raw_bytes": sess.raw_bytes,
                "wire_bytes": sess.wire_bytes,
            } if sess is not None else None
        return out

    def _moved_for(self, conn_ns: str) -> Optional[Dict[str, object]]:
        """INFO ``migration.moved`` for one connection: where the last
        committed migration went, and the connection's client-minted
        ids -> their ids there (worker-minted ids keep their names)."""
        with self._lock:
            moved = self._mig_moved
        if moved is None:
            return None
        return {"target_url": moved["target_url"],
                "ids": {rid[len(conn_ns):]: new
                        for rid, new in moved["ids"].items()
                        if conn_ns and rid.startswith(conn_ns)}}

    def _execute_batch(self, items: List[WorkItem], peek_next):
        """Dispatcher callback: launch one work batch.  Returns a
        deferred flush (blocking result copy + reply) when there is
        one, so the dispatcher can overlap it with the next launch."""
        if len(items) == 1 and items[0].kind != "EXECUTE":
            return self._launch_deferred(items[0])
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
        if self.rank_devices is not None:
            return self._execute_ranks(item)
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
            ids = self._result_ids(item, len(leaves))
            if ids is None:
                return None
            shapes, dtypes = [], []
            with self._lock:
                total = sum(self._leaf_nbytes(l) for l in leaves)
                err = self._admit_resident(total)
                for buf_id, leaf in zip(ids, leaves if not err else ()):
                    self._buffers[buf_id] = leaf
                    self._touch_buf(buf_id)
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

    def _result_ids(self, item: WorkItem, n_results: int):
        """A keep_results EXECUTE's ids: the client's (``c-`` ids of its
        connection, one a result) or minted here; None after replying
        ERROR."""
        want_ids = item.meta.get("result_ids")
        if want_ids is None:
            with self._lock:
                start, self._buf_seq = self._buf_seq, self._buf_seq + n_results
            return [f"buf-{start + j + 1}" for j in range(n_results)]
        if len(want_ids) != n_results:
            self._safe_reply(item, "ERROR",
                             {"error": f"result_ids count {len(want_ids)} "
                                       f"!= {n_results} results"}, [])
            return None
        ns = item.meta.get("_conn_ns", "")
        if not all(str(i).startswith(ns) for i in want_ids):
            # only ids the connection-namespace remap produced: a raw id
            # could clobber another client's (or a worker-minted) buffer
            self._safe_reply(item, "ERROR",
                             {"error": "result_ids must be c-namespace ids"},
                             [])
            return None
        return [str(i) for i in want_ids]

    def _execute_ranks(self, item: WorkItem):
        """An EXECUTE on the ranks, on the dispatcher thread: the ranks
        run it and answer, so the reply goes out at once (there is no
        device copy left to defer)."""
        meta = item.meta
        exe_id = meta["exe_id"]
        ranks = self.rank_devices
        with self._lock:
            mflops = self._exe_costs.get(exe_id, 1)
            shardings = ranks.exes.get(exe_id)
        if self.meter_client is not None:
            self.meter_client.charge_launch(mflops)
        ids = None
        if meta.get("keep_results"):
            n_out = len(shardings["out_shapes"]) if shardings is not None \
                else len(meta.get("result_ids") or ()) or None
            if n_out is None:
                self._safe_reply(item, "ERROR", {
                    "error": "keep_results of a one-device program on a "
                             "worker over ranks needs result_ids"}, [])
                return None
            ids = self._result_ids(item, n_out)
            if ids is None:
                return None
        item.meta["_enq_m"] = time.monotonic()
        try:
            with DEVICE_GATE.shared():
                out = ranks.execute(exe_id, meta.get("arg_refs"),
                                    meta.get("arg_shards"), item.buffers, ids)
        except KeyError as e:
            self._safe_reply(item, "ERROR", {"error": str(e.args[0])}, [])
            return None
        except (RankError, RuntimeError, ValueError) as e:
            log.exception("EXECUTE on the ranks failed")
            self._safe_reply(item, "ERROR", {"error": str(e)}, [])
            return None
        self.executions += 1
        self._attr_flush_compute([item], time.monotonic())
        if ids is not None:
            if not meta.get("quiet"):
                self._safe_reply(item, "EXECUTE_OK", self._traced_meta(
                    item, {"result_refs": out["refs"], "shapes": out["shapes"],
                           "dtypes": [protocol.WIRE_NAMES[d]
                                      for d in out["dtypes"]]}), [])
            return None
        results = out["results"]
        self._safe_reply(item, "EXECUTE_OK", self._traced_meta(
            item, {"n_results": len(results)}), results, compress=True)
        return None

    # ------------------------------------------------------------------

    def _info(self, meta) -> dict:
        dev = self.device
        if self.rank_devices is not None:   # this process stays off the card
            kind = self.rank_devices.infos[0]["kind"]
        else:
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
            cached_executables = len(self._exe_cache) + (
                len(self.rank_devices.exes) if self.rank_devices else 0)
            resident_bytes = self.resident_bytes
        if wire.get("raw_bytes"):
            # realized adaptive-compression ratio: wire bytes actually
            # sent / raw bytes they encode
            wire["realized_ratio"] = round(
                wire.get("wire_bytes", 0) / wire["raw_bytes"], 4)
        devices = [{"id": 0, "platform": platform, "device_kind": kind,
                    "process_index": 0, "coords": [0]}]
        per_device = {"0": resident}
        ranks = None
        if self.rank_devices is not None:
            devices = [{"id": r, "platform": platform, "device_kind": kind,
                        "process_index": 0, "coords": [r]}
                       for r in range(self.n_ranks)]
            per_device = self.rank_devices.resident_per_device()
        if self.rank_devices is not None and meta.get("ranks"):
            # asked for: a call on every rank, which waits behind the
            # ranks' work in flight
            with DEVICE_GATE.shared():
                ranks = self.rank_devices.stats()
            from ..hypervisor import cuda_hook_binding

            hook = cuda_hook_binding.loaded()
            ranks = {"worker": {"pid": os.getpid(),
                                "hook": hook.report() if hook else None},
                     "ranks": ranks}
        return {
            "platform": platform,
            "device_kind": kind,
            "n_devices": len(devices),
            "protocol_version": self.protocol_version,
            "quant_on": bool(meta.get("_quant_on")),
            "upload_overlap": self.upload_stats(),
            "dispatch": self.dispatcher.snapshot(),
            "profile": self.profiler.snapshot()
            if self.profiler is not None else None,
            "serving": self.engine.snapshot()
            if self.engine is not None else None,
            "migration": dict(self.migration_stats(), moved=self._moved_for(
                meta.get("_conn_ns", ""))),
            "fabric": self.fabric_stats(),
            "worker_uid": self.worker_uid,
            "wire_compression": wire,
            "devices": devices,
            "resident_bytes_per_device": per_device,
            "ranks": ranks,
            "cached_executables": cached_executables,
            "resident_bytes": resident_bytes}

    def _compile(self, reply, meta, buffers) -> None:
        """COMPILE: the blob is a torch.export archive; its exe_id is
        the first 32 hex digits of its sha256.  A blob that fails the
        check, the load or the move to this device raises, and the
        handler replies ERROR."""
        blob = buffers[0].numpy().tobytes() if buffers else b""
        exe_id = hashlib.sha256(blob).hexdigest()[:32]
        if self.rank_devices is not None:
            self._compile_ranks(reply, meta, blob, exe_id)
            return
        with self._lock:
            known = exe_id in self._exe_cache
        if not known:
            module = self._load_module(blob)
            with self._lock:
                if exe_id not in self._exe_cache:
                    self._exe_cache[exe_id] = module
                    self._exe_blobs[exe_id] = blob
                    # charge model: the client's FLOP estimate
                    self._exe_costs[exe_id] = int(
                        meta.get("mflops_hint", 1))
        if meta.get("microbatch"):
            with self._lock:
                self._exe_microbatch.add(exe_id)
        reply("COMPILE_OK", {"exe_id": exe_id}, [])

    def _compile_ranks(self, reply, meta, blob: bytes, exe_id: str) -> None:
        """COMPILE on a worker over ranks: the archive is checked here and
        loaded on every rank; a sharded one answers with its layouts (and
        needs a v3 connection, whose client can send shards)."""
        ranks = self.rank_devices
        with self._lock:
            known = exe_id in ranks.exes
        if not known:
            shardings = program.check_archive(blob)
            if shardings is not None and not self._version_gate(
                    reply, meta, f"an executable sharded over "
                    f"{shardings['nr_devices']} devices", protocol.SHARD_MIN_VERSION):
                return
            with DEVICE_GATE.shared():
                ranks.compile(exe_id, blob)
            with self._lock:
                self._exe_blobs[exe_id] = blob
                self._exe_costs[exe_id] = int(meta.get("mflops_hint", 1))
        reply("COMPILE_OK", dict(ranks.layouts(exe_id), exe_id=exe_id), [])

    def _put(self, reply, meta, buffers) -> None:
        """PUT: a device-resident buffer, uploaded once and referenced
        many times.  v3: a client-minted ``buf_id`` (``c-`` namespace)
        copies on the pool and returns at once; ``quiet`` skips the
        success reply; ``ephemeral`` frees the buffer when its first
        consumer takes it (``_take_shard``)."""
        host = buffers[0]
        v3 = meta.get("_wire_version", 2) >= 3
        if meta.get("device_id") is not None and not self._version_gate(
                reply, meta, "PUT device_id", protocol.SHARD_MIN_VERSION):
            return
        device_id = int(meta.get("device_id", 0))
        if not 0 <= device_id < self.n_ranks:
            reply("ERROR", {"error": f"no device {device_id} "
                                     f"(worker has {self.n_ranks})"}, [])
            return
        want_id = meta.get("buf_id") if v3 else None
        if want_id is not None and \
                not str(want_id).startswith(meta.get("_conn_ns", "")):
            reply("ERROR", {"error": "client-minted buf_id must be "
                                     "a c-namespace id"}, [])
            return
        if self.rank_devices is not None:
            if want_id is None:
                with self._lock:
                    self._buf_seq += 1
                    want_id = f"buf-{self._buf_seq}"
            with DEVICE_GATE.shared():
                err = self.rank_devices.put(str(want_id), host, device_id,
                                            v3 and bool(meta.get("ephemeral")))
            if err:
                reply("ERROR", {"error": err}, [])
            elif not (v3 and meta.get("quiet")):
                reply("PUT_OK", {"buf_id": str(want_id),
                                 "device_id": device_id}, [])
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
            self._touch_buf(buf_id)
            if v3 and meta.get("ephemeral"):
                self._ephemeral.add(buf_id)
        if v3 and meta.get("quiet"):
            return
        reply("PUT_OK", {"buf_id": buf_id, "device_id": 0}, [])

    def _free(self, reply, meta) -> None:
        ids = list(meta.get("buf_ids", []))
        if self.rank_devices is not None:
            with DEVICE_GATE.shared():
                freed = self.rank_devices.free(ids)
        else:
            freed = 0
            for buf_id in ids:
                with self._lock:
                    arr = self._pop_buffer(buf_id)
                if arr is not None:
                    arr = self._resolve(arr)    # async PUT still in flight
                    with self._lock:
                        self._release_resident(arr)
                    freed += 1
        if meta.get("quiet") and meta.get("_wire_version", 2) >= 3:
            return
        reply("FREE_OK", {"freed": freed}, [])

    def _fetch(self, reply, meta) -> None:
        want = meta.get("device_id")
        if want is not None and not self._version_gate(
                reply, meta, "FETCH device_id", protocol.SHARD_MIN_VERSION):
            return
        if self.rank_devices is not None:
            try:
                with DEVICE_GATE.shared():
                    host, dev = self.rank_devices.fetch(
                        meta["buf_id"], None if want is None else int(want))
            except KeyError as e:
                reply("ERROR", {"error": str(e.args[0])}, [])
                return
            reply("FETCH_OK", {} if want is None else {"device_id": dev},
                  [host], compress=True)
            return
        if want is not None and int(want) != 0:
            reply("ERROR", {"error": f"buffer {meta['buf_id']} has no shard "
                                     f"on device {want}"}, [])
            return
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
        elif kind == "SNAPSHOT":
            reply("SNAPSHOT_OK", self.snapshot_to(meta.get("state_dir")), [])
        elif kind == "RESTORE":
            reply("RESTORE_OK", self.restore_from(meta.get("state_dir")), [])
        else:
            reply("ERROR", {"error": f"unknown kind {kind}"}, [])
