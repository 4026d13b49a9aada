"""QoS-weighted fair dispatch for the remote worker (the port's copy of
``tensorfusion_tpu/remoting/dispatch.py``).  The serving engine shares
its admission vocabulary: ``qos_weight``, ``LatencyRecorder`` and
``BusyError``.

The worker used to be per-connection greedy: every connection handler
thread executed its own EXECUTEs straight onto the devices, so a single
tenant pipelining deeply could monopolize the accelerator while other
connections starved behind it.  This module centralizes the serving
path: connection handlers *enqueue* parsed EXECUTE work items (one FIFO
per tenant, preserving each connection's ``seq`` order) and a single
dispatcher thread drains the queues onto the devices under
**start-time fair queueing** (SFQ — Goyal et al.; the packet-scheduling
classic adapted to device launches):

- every item carries a cost (the executable's MFLOP estimate, the same
  charge model the meter uses) and is tagged on arrival with a virtual
  start/finish time: ``S = max(V, tenant.last_finish)``,
  ``F = S + cost / weight``;
- the dispatcher always serves the queue-head item with the smallest
  finish tag, and advances the global virtual time ``V`` to the served
  item's start tag.

Over any backlogged interval each tenant therefore receives device time
proportional to its weight — the remote analog of the ERL layer's
QoS-proportional duty redistribution for local tenants, resolved from
the same ``constants.QOS_DISPATCH_WEIGHTS`` ladder.

The dispatcher also owns:

- **adaptive backpressure**: bounded per-tenant and global queue depths.
  Connections that negotiated protocol v4 get a structured ``BUSY``
  reply (with a ``retry_after_ms`` estimated from the recent service
  rate) so they can retry with jitter instead of piling on; older (v2 /
  v3) connections block in their handler thread instead, which
  backpressures through TCP exactly like the old in-line execution did
  — no behavior change for old clients.
- **deadlines**: items whose ``deadline_ms`` elapsed while queued are
  answered with ``DEADLINE_EXCEEDED`` instead of burning device time on
  a result the client already gave up on.
- **micro-batch collection**: when the winning item's executable is
  batchable (client opt-in at COMPILE), queue heads across *all*
  tenants holding compatible items (same executable — hence identical
  arg signature — same wire options) are collected into one work batch
  the worker runs in one dispatch.  Per-tenant FIFO order
  is preserved because only consecutive head items are taken.
- **observability**: queue-wait and service-time histograms plus
  reject/deadline/launch counters, snapshotted by the worker's INFO
  reply and shipped as ``tpf_remote_dispatch`` influx lines by the
  metrics recorders.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from .. import constants
from ..tracing.core import Tracer

#: queue-depth defaults — a saturated worker should push back, not
#: buffer minutes of work it cannot serve
DEFAULT_MAX_QUEUE_PER_TENANT = constants.DEFAULT_MAX_QUEUE_PER_TENANT
DEFAULT_MAX_QUEUE_GLOBAL = constants.DEFAULT_MAX_QUEUE_GLOBAL
#: ceiling on how many compatible requests fuse into one dispatch
DEFAULT_MAX_MICROBATCH = constants.DEFAULT_MAX_MICROBATCH


def qos_weight(qos: Optional[str]) -> float:
    """Dispatch weight for a QoS class; unknown/absent -> the default
    tier, never a rejection (an old client simply doesn't send one)."""
    return float(constants.QOS_DISPATCH_WEIGHTS.get(
        qos or constants.DEFAULT_QOS,
        constants.QOS_DISPATCH_WEIGHTS[constants.DEFAULT_QOS]))


class LatencyRecorder:
    """Bounded reservoir + counters for one latency series.

    Keeps the most recent ``maxlen`` samples (seconds) in a ring; p50 /
    p99 are computed on snapshot.  Recent-window quantiles are the
    right shape for saturation alerting — a day-old histogram bucket
    would mask a queue that went bad five minutes ago."""

    def __init__(self, maxlen: int = 2048):
        self._samples: deque = deque(maxlen=maxlen)
        self.count = 0
        self.total_s = 0.0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)
            self.count += 1
            self.total_s += seconds

    def mean_s(self) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            return sum(self._samples) / len(self._samples)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            samples = sorted(self._samples)
            count, total = self.count, self.total_s
        if not samples:
            return {"count": count, "p50_ms": 0.0, "p99_ms": 0.0,
                    "mean_ms": 0.0}
        def q(p):
            return samples[min(int(p * (len(samples) - 1)),
                               len(samples) - 1)]
        return {"count": count,
                "p50_ms": round(q(0.50) * 1e3, 3),
                "p99_ms": round(q(0.99) * 1e3, 3),
                "mean_ms": round(sum(samples) / len(samples) * 1e3, 3)}


class WorkItem:
    """One parsed EXECUTE waiting for device time."""

    __slots__ = ("kind", "meta", "buffers", "reply", "tenant", "cost",
                 "exe_id", "batch_key", "enqueue_t", "deadline_t",
                 "start_tag", "finish_tag", "dispatch_t",
                 "trace", "trace_spans")

    def __init__(self, kind: str, meta: dict, buffers: list,
                 reply: Callable, cost: float, exe_id: str,
                 batch_key: Optional[str], deadline_t: Optional[float],
                 trace: Optional[dict] = None):
        self.kind = kind
        self.meta = meta
        self.buffers = buffers
        self.reply = reply
        self.tenant: Optional["Tenant"] = None
        self.cost = max(cost, 1e-9)
        self.exe_id = exe_id
        #: items sharing a non-None batch_key may fuse into one launch
        self.batch_key = batch_key
        self.enqueue_t = time.monotonic()
        self.deadline_t = deadline_t
        self.start_tag = 0.0
        self.finish_tag = 0.0
        self.dispatch_t = 0.0
        #: propagated v5 span context ({"trace_id","span_id","sampled"})
        #: or None; server-side spans accumulate in trace_spans and ride
        #: the reply back for client-side trace assembly
        self.trace = trace
        self.trace_spans: List[dict] = []


class Tenant:
    """Per-connection dispatch state: a FIFO of pending items plus the
    SFQ finish tag and completion accounting for barriers."""

    def __init__(self, conn_id: str, qos: str, weight: float):
        self.conn_id = conn_id
        self.qos = qos
        self.weight = max(weight, 1e-6)
        self.queue: deque = deque()
        self.last_finish = 0.0
        #: items dispatched but not yet fully completed (replied/flushed)
        self.inflight = 0
        self.submitted = 0
        self.completed = 0
        self.closed = False
        #: per-tenant queue-wait quantiles (the hypervisor TUI's
        #: dispatch pane reads these; per-QoS recorders aggregate
        #: coarser).  Internally locked, like the global recorders.
        self.wait = LatencyRecorder(maxlen=512)
        #: queue-wait SLO rollup vs this tenant's QoS threshold
        #: (constants.QOS_QUEUE_WAIT_SLO_MS) -> tpf_trace_slo series
        # guarded by: _cv
        self.slo_good = 0
        # guarded by: _cv
        self.slo_total = 0
        #: most recent sampled trace id dispatched for this tenant —
        #: the exemplar the TSDB attaches to its histogram series
        # guarded by: _cv
        self.last_trace_id = ""
        #: federated-collective accounting (protocol v7, docs/
        #: federation.md): ops served and payload bytes moved for THIS
        #: tenant's ALLREDUCE_SHIP / ALLGATHER_SHIP items — collective
        #: traffic is attributed to the owning tenant exactly like its
        #: device time (tpfprof keeps the time half; these keep bytes)
        # guarded by: _cv
        self.collective_ops = 0
        # guarded by: _cv
        self.collective_bytes = 0


class BusyError(Exception):
    """submit() rejection (a v4 connection, or the serving engine's
    admission): queue bounds exceeded."""

    def __init__(self, scope: str, depth: int, retry_after_ms: int):
        super().__init__(f"{scope} dispatch queue full ({depth} deep)")
        self.scope = scope
        self.depth = depth
        self.retry_after_ms = retry_after_ms


class DeviceDispatcher:
    """Central device dispatch scheduler (one per worker).

    ``execute_batch(items, peek_next)`` is the worker-supplied launch
    function: it must reply to every item (success or error) and may
    call ``peek_next()`` after launching to start the next item's
    host->device transfers while the devices are busy.  It may return a
    callable *flush* to defer the blocking result materialization; the
    dispatcher runs the flush after launching the following batch so
    result serialization of launch k overlaps device compute of k+1 —
    the same deferred-reply overlap the per-connection loop used to do,
    now across connections."""

    def __init__(self, execute_batch: Callable,
                 mode: str = "wfq",
                 max_queue_per_tenant: int = DEFAULT_MAX_QUEUE_PER_TENANT,
                 max_queue_global: int = DEFAULT_MAX_QUEUE_GLOBAL,
                 max_microbatch: int = DEFAULT_MAX_MICROBATCH,
                 tracer: Optional[Tracer] = None,
                 profiler=None, recorder=None):
        if mode not in ("wfq", "fifo"):
            raise ValueError(f"unknown dispatch mode {mode!r}")
        self.execute_batch = execute_batch
        self.mode = mode
        #: records dispatcher.queue / device.launch spans for traced
        #: items (protocol v5); None disables span recording entirely
        self.tracer = tracer
        #: tpfprof attribution ledger (docs/profiling.md): queue wait
        #: and device launch time charged per tenant, for EVERY item —
        #: unlike spans, attribution is always-on (None disables)
        self.profiler = profiler
        #: flight-recorder rings: one "dispatch" event per launch /
        #: crash so a postmortem bundle shows the last decisions
        self.recorder = recorder
        self.max_queue_per_tenant = max_queue_per_tenant
        self.max_queue_global = max_queue_global
        self.max_microbatch = max(1, max_microbatch)
        self._cv = threading.Condition()
        # guarded by: _cv
        self._tenants: Dict[str, Tenant] = {}
        # guarded by: _cv
        self._vtime = 0.0
        # guarded by: _cv
        self._depth = 0
        # guarded by: _cv
        self._fifo_seq = 0
        # guarded by: _cv
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        # -- observability ------------------------------------------------
        # (the LatencyRecorders are internally locked; the bare counters
        # and registries below share _cv with the queue state)
        self.queue_wait = LatencyRecorder()
        self.service = LatencyRecorder()
        # guarded by: _cv
        self.per_qos_wait: Dict[str, LatencyRecorder] = {}
        # guarded by: _cv
        self.per_qos_served: Dict[str, int] = {}
        # guarded by: _cv
        self.executed = 0          # requests served
        # guarded by: _cv
        self.launches = 0          # device launches (batches fuse many)
        # guarded by: _cv
        self.microbatched = 0      # requests that rode a fused launch
        # guarded by: _cv
        self.busy_rejected = 0
        # guarded by: _cv
        self.deadline_exceeded = 0
        #: most recently dispatched sampled trace id (any tenant) — the
        #: exemplar attached to the dispatcher-level histogram series
        # guarded by: _cv
        self._last_trace_id = ""
        # -- federated-collective totals (protocol v7) --------------------
        # guarded by: _cv
        self.collective_ops = 0
        # guarded by: _cv
        self.collective_bytes = 0

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        name="tpf-remote-dispatch",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- tenant registry --------------------------------------------------

    def register_tenant(self, conn_id: str,
                        qos: str = constants.DEFAULT_QOS) -> Tenant:
        tenant = Tenant(conn_id, qos, qos_weight(qos))
        with self._cv:
            self._tenants[conn_id] = tenant
        return tenant

    def set_qos(self, tenant: Tenant, qos: str) -> float:
        """Re-weight a tenant (HELLO negotiation may arrive after the
        connection registered with the default class)."""
        with self._cv:
            tenant.qos = qos
            tenant.weight = qos_weight(qos)
        return tenant.weight

    def unregister(self, tenant: Tenant) -> None:
        """Connection closed: drop anything still queued (their replies
        have no socket to land on) and remove the tenant."""
        with self._cv:
            tenant.closed = True
            self._depth -= len(tenant.queue)
            tenant.queue.clear()
            self._tenants.pop(tenant.conn_id, None)
            self._cv.notify_all()

    # -- enqueue ----------------------------------------------------------

    def _retry_after_ms(self) -> int:   # tpflint: holds=_cv
        """Backpressure hint: how long the current backlog needs to
        drain at the recent service rate (bounded to something a client
        can reasonably sleep)."""
        per_item = self.service.mean_s() or 0.005
        est = self._depth * per_item * 1e3
        return int(min(max(est, 5.0), 5000.0))

    def submit(self, tenant: Tenant, item: WorkItem,
               block: bool) -> None:
        """Enqueue one item in the tenant's FIFO.

        ``block=False`` (v4 connections): raises :class:`BusyError` when
        either depth bound is hit, carrying the retry hint.
        ``block=True`` (v2/v3 connections): waits for space, which
        stalls the connection's reader exactly like the old in-line
        execution — the wire-level backpressure old clients already
        understand."""
        with self._cv:
            while True:
                if tenant.closed or self._stopping:
                    raise ConnectionError("tenant closed")
                over_tenant = len(tenant.queue) >= self.max_queue_per_tenant
                over_global = self._depth >= self.max_queue_global
                if not over_tenant and not over_global:
                    break
                if not block:
                    self.busy_rejected += 1
                    scope = "per-tenant" if over_tenant else "global"
                    depth = len(tenant.queue) if over_tenant else self._depth
                    raise BusyError(scope, depth, self._retry_after_ms())
                self._cv.wait(timeout=0.5)
            item.tenant = tenant
            if self.mode == "wfq":
                item.start_tag = max(self._vtime, tenant.last_finish)
                item.finish_tag = item.start_tag + \
                    item.cost / tenant.weight
                tenant.last_finish = item.finish_tag
            else:
                # fifo baseline: global arrival order, no weighting
                self._fifo_seq += 1
                item.start_tag = item.finish_tag = float(self._fifo_seq)
            tenant.queue.append(item)
            tenant.submitted += 1
            self._depth += 1
            self._cv.notify_all()

    # -- barriers ---------------------------------------------------------

    def barrier(self, tenant: Tenant, timeout: float = 300.0) -> None:
        """Block until every item this tenant has submitted so far is
        fully complete (replied).  Connection handlers call this before
        serving requests that observe execution effects (FETCH / FREE /
        SNAPSHOT / RESTORE) so per-connection request ordering is
        preserved across the shared queue."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while tenant.queue or tenant.inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"dispatch barrier timed out for {tenant.conn_id}")
                self._cv.wait(timeout=min(remaining, 0.5))

    def quiesce(self, timeout: float = 30.0) -> None:
        """Global barrier (MIGRATE_FREEZE, docs/migration.md): block
        until EVERY tenant's queued and in-flight items are fully
        complete.  Unlike :meth:`barrier` this spans all connections —
        the freeze must not certify a dirty set while another tenant's
        launch is still about to mutate the resident table."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while any(t.queue or t.inflight
                      for t in self._tenants.values()):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("dispatch quiesce timed out")
                self._cv.wait(timeout=min(remaining, 0.5))

    def note_collective(self, conn_id: str, op: str,
                        nbytes: int) -> None:
        """Record one served federated collective (ALLREDUCE_SHIP /
        ALLGATHER_SHIP, protocol v7) against its owning tenant: the
        byte half of per-tenant collective attribution (tpfprof keeps
        the transfer-time half).  ``op`` rides the flight-recorder
        note so a postmortem bundle shows collective cadence."""
        with self._cv:
            self.collective_ops += 1
            self.collective_bytes += int(nbytes)
            tenant = self._tenants.get(conn_id)
            if tenant is not None:
                tenant.collective_ops += 1
                tenant.collective_bytes += int(nbytes)
        if self.recorder is not None:
            self.recorder.note("dispatch", "collective", op=op,
                               tenant=conn_id, nbytes=int(nbytes))

    def _complete(self, items: List[WorkItem]) -> None:
        with self._cv:
            for item in items:
                if item.tenant is not None:
                    item.tenant.inflight -= 1
                    item.tenant.completed += 1
            self._cv.notify_all()

    # -- dispatch loop ----------------------------------------------------

    def _pick_locked(self) -> Optional[List[WorkItem]]:
        """Choose the next work batch (caller holds the lock): the head
        item with the minimum finish tag, plus — when it is batchable —
        compatible head-run items from every queue, smallest tags
        first."""
        best: Optional[Tenant] = None
        for tenant in self._tenants.values():
            if not tenant.queue:
                continue
            if best is None or \
                    tenant.queue[0].finish_tag < best.queue[0].finish_tag:
                best = tenant
        if best is None:
            return None
        head = best.queue.popleft()
        self._depth -= 1
        self._vtime = max(self._vtime, head.start_tag)
        batch = [head]
        head.tenant.inflight += 1
        if head.batch_key is not None:
            # collect same-key items: first the winner's own consecutive
            # run (FIFO safe), then other tenants' head runs in tag order
            donors = sorted(
                (t for t in self._tenants.values() if t.queue),
                key=lambda t: t.queue[0].finish_tag)
            for tenant in [best] + [t for t in donors if t is not best]:
                while (len(batch) < self.max_microbatch and tenant.queue
                       and tenant.queue[0].batch_key == head.batch_key):
                    nxt = tenant.queue.popleft()
                    self._depth -= 1
                    nxt.tenant.inflight += 1
                    batch.append(nxt)
                if len(batch) >= self.max_microbatch:
                    break
        self._cv.notify_all()
        return batch

    def peek_next(self) -> Optional[WorkItem]:
        """The item the dispatcher will most likely serve next (used by
        the worker to overlap its host->device transfers with the launch
        in progress).  Only the dispatcher thread mutates items, so the
        worker may stash transfer futures on the returned item."""
        with self._cv:
            best = None
            for tenant in self._tenants.values():
                if tenant.queue and (
                        best is None
                        or tenant.queue[0].finish_tag < best.finish_tag):
                    best = tenant.queue[0]
            return best

    def peek_next_n(self, n: int) -> List[WorkItem]:
        """The next up-to-``n`` items in approximate service order
        (smallest finish tags across every tenant's queue head run) —
        the worker's N-deep transfer/compute overlap window.  Same
        contract as :meth:`peek_next`: only the dispatcher thread
        mutates items, so the caller may stash transfer futures on
        them; the order is advisory (a new arrival can still win the
        next pick)."""
        n = max(1, int(n))
        with self._cv:
            heads: List[WorkItem] = []
            for tenant in self._tenants.values():
                for item in list(tenant.queue)[:n]:
                    heads.append(item)
            heads.sort(key=lambda i: i.finish_tag)
            return heads[:n]

    def _expire_locked(self, item: WorkItem) -> bool:
        return item.deadline_t is not None and \
            time.monotonic() > item.deadline_t

    # -- span recording (protocol v5 traced items) ------------------------

    def _queue_span(self, item: WorkItem, wait_s: float,
                    qos: str) -> None:
        """dispatcher.queue span: exactly the wait the histogram
        observed for this item, so per-trace attribution and the
        aggregate metric always agree."""
        if self.tracer is None or not item.trace:
            return
        end = self.tracer.clock.now()
        d = self.tracer.record_span(
            "dispatcher.queue", end - wait_s, end, parent=item.trace,
            attrs={"qos": qos,
                   "tenant": item.tenant.conn_id if item.tenant else "",
                   "wait_ms": round(wait_s * 1e3, 3)})
        if d is not None:
            item.trace_spans.append(d)

    def _launch_spans(self, batch: List[WorkItem],
                      launch_s: float) -> None:
        """device.launch span per traced item (a fused batch shares one
        launch, so its members share the timing)."""
        if self.tracer is None:
            return
        end = self.tracer.clock.now()
        for item in batch:
            if not item.trace:
                continue
            d = self.tracer.record_span(
                "device.launch", end - launch_s, end, parent=item.trace,
                attrs={"exe_id": item.exe_id, "batch": len(batch),
                       "mflops": int(item.cost)})
            if d is not None:
                item.trace_spans.append(d)

    def _attr_compute(self, batch: List[WorkItem],
                      dur_s: float) -> None:
        """tpfprof device-time attribution for one batch, split
        cost-weighted across its members (a fused launch shares one
        device pass)."""
        if self.profiler is None or dur_s <= 0.0 or not batch:
            return
        total_cost = sum(i.cost for i in batch)
        for item in batch:
            if item.tenant is None:
                continue
            self.profiler.attribute(item.tenant.conn_id, "compute",
                                    dur_s * item.cost / total_cost,
                                    qos=item.tenant.qos)

    def _loop(self) -> None:
        pending_flush: Optional[Callable] = None
        pending_items: List[WorkItem] = []
        while True:
            with self._cv:
                batch = None if self._stopping else self._pick_locked()
                if batch is None and pending_flush is None:
                    if self._stopping:
                        return
                    self._cv.wait(timeout=0.5)
                    continue
            if batch is None:
                # queue drained: run the deferred flush now
                pending_flush()
                self._complete(pending_items)
                pending_flush, pending_items = None, []
                continue
            now = time.monotonic()
            expired = [i for i in batch if self._expire_locked(i)]
            batch = [i for i in batch if i not in expired]
            if expired:
                with self._cv:
                    self.deadline_exceeded += len(expired)
            for item in expired:
                wait = now - item.enqueue_t
                waited_ms = int(wait * 1e3)
                qos = item.tenant.qos if item.tenant else \
                    constants.DEFAULT_QOS
                # an expired request still spent its whole life queued:
                # it counts against the tenant's queue-wait SLO
                with self._cv:
                    if item.tenant is not None:
                        item.tenant.slo_total += 1
                self._queue_span(item, wait, qos)
                if self.profiler is not None and item.tenant is not None:
                    self.profiler.attribute(item.tenant.conn_id,
                                            "queue", wait, qos=qos)
                emeta = {
                    "error": f"deadline exceeded after {waited_ms}ms "
                             f"in queue",
                    "code": "DEADLINE_EXCEEDED",
                    "queue_wait_ms": waited_ms}
                if item.trace_spans:
                    emeta["trace_spans"] = item.trace_spans
                try:
                    item.reply("ERROR", emeta, [])
                except (ConnectionError, OSError):
                    pass
            if expired:
                self._complete(expired)
            if not batch:
                continue
            for item in batch:
                item.dispatch_t = now
                wait = now - item.enqueue_t
                self.queue_wait.observe(wait)
                tenant = item.tenant
                qos = tenant.qos if tenant else constants.DEFAULT_QOS
                slo_ms = constants.QOS_QUEUE_WAIT_SLO_MS.get(qos, 500.0)
                with self._cv:
                    rec = self.per_qos_wait.setdefault(
                        qos, LatencyRecorder())
                    if tenant is not None:
                        tenant.slo_total += 1
                        if wait * 1e3 <= slo_ms:
                            tenant.slo_good += 1
                        if item.trace:
                            tenant.last_trace_id = str(
                                item.trace.get("trace_id", ""))
                            self._last_trace_id = tenant.last_trace_id
                rec.observe(wait)
                if tenant is not None:
                    tenant.wait.observe(wait)
                self._queue_span(item, wait, qos)
                if self.profiler is not None and tenant is not None:
                    self.profiler.attribute(tenant.conn_id, "queue",
                                            wait, qos=qos)
            t0 = time.perf_counter()
            try:
                flush = self.execute_batch(batch, self.peek_next)
            except Exception as e:  # noqa: BLE001 - reply, keep serving
                flush = None
                for item in batch:
                    emeta = {"error": str(e)}
                    if item.trace_spans:
                        emeta["trace_spans"] = item.trace_spans
                    try:
                        item.reply("ERROR", emeta, [])
                    except (ConnectionError, OSError):
                        pass
                # worker crash path: freeze the last decisions into a
                # postmortem bundle (budgeted no-op without a
                # configured bundle dir)
                if self.recorder is not None:
                    self.recorder.note(
                        "dispatch", "crash",
                        exe=batch[0].exe_id, batch=len(batch),
                        error=f"{type(e).__name__}: {e}"[:200])
                    self.recorder.auto_bundle(
                        "dispatch-crash",
                        tracers=(self.tracer,) if self.tracer else ())
            else:
                # launch duration measured before the deferred-flush
                # overlap below runs (service includes it; the span
                # should not)
                launch_dt = time.perf_counter() - t0
                self._launch_spans(batch, launch_dt)
                # tpfprof: the launch window minus the worker-measured
                # argument-resolution (transfer) time — transfer was
                # already attributed by the worker, so compute is
                # never double-counted.  The rest of the batch's
                # device time surfaces at its deferred flush (the
                # blocking materialization), attributed below.
                xfer = sum(i.meta.get("_xfer_exposed_s", 0.0)
                           for i in batch)
                self._attr_compute(batch,
                                   max(launch_dt - xfer, 0.0))
                if self.recorder is not None:
                    self.recorder.note(
                        "dispatch", "launch",
                        exe=batch[0].exe_id, batch=len(batch),
                        tenants=sorted({i.tenant.conn_id for i in batch
                                        if i.tenant is not None}),
                        launch_ms=round(launch_dt * 1e3, 3))
            # run the PREVIOUS batch's deferred flush after this batch
            # launched: reply serialization overlaps device compute
            # (the flush closure attributes its own materialization
            # wait — the batch's remaining device time — to its items)
            if pending_flush is not None:
                pending_flush()
                self._complete(pending_items)
                pending_flush, pending_items = None, []
            dt = time.perf_counter() - t0
            with self._cv:
                self.launches += 1
                self.executed += len(batch)
                if len(batch) > 1:
                    self.microbatched += len(batch)
                for item in batch:
                    qos = item.tenant.qos if item.tenant else \
                        constants.DEFAULT_QOS
                    self.per_qos_served[qos] = \
                        self.per_qos_served.get(qos, 0) + 1
            for _ in batch:
                self.service.observe(dt)
            if flush is not None:
                pending_flush, pending_items = flush, batch
            else:
                self._complete(batch)

    # -- observability ----------------------------------------------------

    def depth(self) -> int:
        with self._cv:
            return self._depth

    def snapshot(self) -> dict:
        """Stats for INFO replies and the metrics recorders."""
        with self._cv:
            per_tenant = {
                t.conn_id: {"qos": t.qos, "weight": t.weight,
                            "queued": len(t.queue),
                            "submitted": t.submitted,
                            "completed": t.completed,
                            "queue_wait": t.wait.snapshot(),
                            "slo_good": t.slo_good,
                            "slo_total": t.slo_total,
                            "slo_ms": constants.QOS_QUEUE_WAIT_SLO_MS
                            .get(t.qos, 500.0),
                            "last_trace_id": t.last_trace_id,
                            "collective_ops": t.collective_ops,
                            "collective_bytes": t.collective_bytes}
                for t in self._tenants.values()}
            last_trace = self._last_trace_id
            depth = self._depth
            counters = {"executed": self.executed,
                        "launches": self.launches,
                        "microbatched_requests": self.microbatched,
                        "busy_rejected": self.busy_rejected,
                        "deadline_exceeded": self.deadline_exceeded,
                        "collective_ops": self.collective_ops,
                        "collective_bytes": self.collective_bytes}
            per_qos = {qos: (rec, self.per_qos_served.get(qos, 0))
                       for qos, rec in self.per_qos_wait.items()}
        return dict(counters, **{
            "mode": self.mode,
            "last_trace_id": last_trace,
            "depth": depth,
            "max_queue_per_tenant": self.max_queue_per_tenant,
            "max_queue_global": self.max_queue_global,
            "queue_wait": self.queue_wait.snapshot(),
            "service": self.service.snapshot(),
            "per_qos": {
                qos: dict(rec.snapshot(), served=served)
                for qos, (rec, served) in per_qos.items()},
            "tenants": per_tenant,
        })
