"""Hypervisor metrics: the port's copy of
tensorfusion_tpu/hypervisor/metrics.py.

``HypervisorMetricsRecorder`` writes periodic influx lines for devices
(``tpf_chip``), workers (``tpf_worker``) and co-hosted remote workers to a
local file, and pushes them to a sink when one is given (the reference's
operator store gateway; the port's control plane is not ported yet).
Push failures buffer into a bounded backlog and retry on the next tick.
The line builders of a remote worker's dispatcher, serving engine,
migrations and a federation are shared with the reference's layout.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
from collections import deque
from typing import Callable, List, Optional

from ..clock import default_clock
from ..metrics.encoder import encode_line
from ..profiling.export import profile_lines

log = logging.getLogger("tpf.hypervisor.metrics")


def remote_dispatch_lines(remote_worker, node_name: str,
                          ts: int, snap=None) -> List[str]:
    """Influx lines for one RemoteVTPUWorker's dispatch scheduler:
    ``tpf_remote_dispatch`` (queue saturation + launch counters),
    per-QoS ``tpf_remote_qos`` (share + queue wait per class) and
    per-tenant ``tpf_trace_slo`` (queue-wait SLO good/total rollups —
    the counters the burn-rate alert rules consume, docs/tracing.md).
    Shared by the node-agent recorder here and the operator-side
    MetricsRecorder so both topologies emit identical series; pass
    ``snap`` to reuse an already-taken dispatcher snapshot (the
    operator recorder also reads its exemplar trace ids from it)."""
    if snap is None:
        snap = remote_worker.dispatcher.snapshot()
    # upload-stream depth accounting (v6 transfer/compute overlap,
    # docs/wire-format.md): how deep the worker's host->device
    # prefetch actually ran, alongside the queue it drains
    upload = remote_worker.upload_stats() \
        if hasattr(remote_worker, "upload_stats") else {}
    tags = {"node": node_name, "mode": snap["mode"]}
    lines = [encode_line(
        "tpf_remote_dispatch", tags,
        {"depth": snap["depth"],
         "executed_total": snap["executed"],
         "launches_total": snap["launches"],
         "microbatched_total": snap["microbatched_requests"],
         "busy_rejected_total": snap["busy_rejected"],
         "deadline_exceeded_total": snap["deadline_exceeded"],
         "queue_wait_p50_ms": snap["queue_wait"]["p50_ms"],
         "queue_wait_p99_ms": snap["queue_wait"]["p99_ms"],
         "queue_wait_mean_ms": snap["queue_wait"]["mean_ms"],
         "service_p50_ms": snap["service"]["p50_ms"],
         "service_p99_ms": snap["service"]["p99_ms"],
         "service_mean_ms": snap["service"]["mean_ms"],
         "upload_prefetched_total": upload.get("prefetched_total", 0),
         "upload_inflight": upload.get("inflight", 0),
         "upload_overlap_high_water": upload.get("high_water", 0),
         "upload_depth": upload.get("depth", 1),
         "tenants": len(snap["tenants"])}, ts)]
    for qos, q in snap["per_qos"].items():
        lines.append(encode_line(
            "tpf_remote_qos", dict(tags, qos=qos),
            {"served_total": q["served"],
             "queue_wait_p50_ms": q["p50_ms"],
             "queue_wait_p99_ms": q["p99_ms"]}, ts))
    for conn_id, t in snap["tenants"].items():
        if not t.get("slo_total"):
            continue        # tenant never had a request dispatched
        lines.append(encode_line(
            "tpf_trace_slo",
            dict(tags, tenant=conn_id, qos=t["qos"]),
            {"good_total": t["slo_good"],
             "total": t["slo_total"],
             "slo_ms": t["slo_ms"],
             "good_ratio": round(t["slo_good"] / t["slo_total"], 6)},
            ts))
    return lines



def serving_engine_lines(engine, node_name: str, ts: int,
                         snap=None) -> List[str]:
    """Influx lines for one tpfserve continuous-batching engine
    (docs/serving.md): aggregate ``tpf_serving_engine`` (throughput,
    TTFT quantiles, batch occupancy, KV-block pool utilization and
    evictions) plus per-tenant ``tpf_serving_tenant`` (tokens, TTFT,
    admission-wait SLO rollup vs the tenant's QoS tier).  Shared by
    both recorders like ``remote_dispatch_lines``; pass ``snap`` to
    reuse an already-taken engine snapshot (the operator recorder also
    reads exemplar trace ids from it)."""
    if snap is None:
        snap = engine.snapshot()
    tags = {"node": node_name, "engine": snap["name"]}
    kv = snap["kv"]
    spec = snap.get("spec") or {}
    ship = snap.get("kv_ship") or {}
    lines = [encode_line(
        "tpf_serving_engine", tags,
        {"tokens_total": snap["tokens"],
         "tokens_per_s": snap["tokens_per_s"],
         "steps_total": snap["steps"],
         "decode_steps_total": snap["decode_steps"],
         "prefill_chunks_total": snap["prefill_chunks"],
         "admitted_total": snap["admitted"],
         "retired_total": snap["retired"],
         "shed_total": snap["shed"],
         "busy_rejected_total": snap["busy_rejected"],
         "preempted_total": snap["preempted"],
         "waiting": snap["waiting"],
         "active": snap["active"],
         "ttft_p50_ms": snap["ttft"]["p50_ms"],
         "ttft_p99_ms": snap["ttft"]["p99_ms"],
         "batch_occupancy_pct": snap["batch_occupancy_pct"],
         "kv_blocks_total": kv["usable"],
         "kv_blocks_used": kv["used"],
         "kv_util_pct": kv["utilization_pct"],
         "kv_evictions_total": kv["evicted_total"],
         "kv_shared_blocks": kv.get("shared_blocks", 0),
         "kv_cow_copies_total": kv.get("cow_copies_total", 0),
         "kv_prefix_hit_tokens_total":
             kv.get("prefix_hit_tokens_total", 0),
         "kv_prefix_cache_evictions_total":
             kv.get("prefix_cache_evictions_total", 0),
         "kv_prefix_cache_blocks": kv.get("cache_held_blocks", 0),
         "kv_ship_bytes_total": ship.get("bytes", 0),
         "kv_ship_blocks_total": ship.get("blocks", 0),
         "kv_ship_dedup_blocks_total": ship.get("dedup_blocks", 0),
         "spec_accept_rate": spec.get("accept_rate", 0.0),
         "spec_steps_total": spec.get("steps", 0)}, ts)]
    for tenant, t in snap["tenants"].items():
        if not t["slo_total"] and not t["tokens"]:
            continue        # tenant never reached admission
        good_ratio = round(t["slo_good"] / t["slo_total"], 6) \
            if t["slo_total"] else 1.0
        lines.append(encode_line(
            "tpf_serving_tenant",
            dict(tags, tenant=tenant, qos=t["qos"]),
            {"tokens_total": t["tokens"],
             "ttft_p50_ms": t["ttft"]["p50_ms"],
             "ttft_p99_ms": t["ttft"]["p99_ms"],
             "slo_good": t["slo_good"],
             "slo_total": t["slo_total"],
             "slo_ms": t["slo_ms"],
             "good_ratio": good_ratio,
             "prefix_hit_tokens_total": t.get("prefix_hit_tokens", 0),
             "spec_accept_rate": t.get("spec_accept_rate", 0.0)}, ts))
    return lines



def federation_lines(fed, node_name: str, ts: int,
                     snap=None) -> List[str]:
    """The ``tpf_fed_collective`` line of one
    :class:`~..remoting.federation.FederatedDevice`: collective counts,
    payload bytes raw and on the wire, bytes relayed through the client,
    and the hidden / exposed transfer split.  Pass ``snap`` to reuse a
    ``fed_snapshot()``."""
    if snap is None:
        snap = fed.fed_snapshot()
    tags = {"node": node_name,
            "federation": getattr(fed, "tenant", "fed0")}
    return [encode_line(
        "tpf_fed_collective", tags,
        {"workers": snap["workers"],
         "allreduce_total": snap["allreduce_total"],
         "allgather_total": snap["allgather_total"],
         "fabric_rings_total": snap.get("fabric_rings_total", 0),
         "client_relay_bytes_total": snap.get("client_relay_bytes", 0),
         "shard_execs_total": snap["shard_execs_total"],
         "fallback_calls_total": snap["fallback_calls_total"],
         "collective_raw_bytes_total": snap["collective_raw_bytes"],
         "collective_wire_bytes_total": snap["collective_wire_bytes"],
         "hidden_transfer_s_total": round(snap["hidden_s"], 6),
         "exposed_transfer_s_total": round(snap["exposed_s"], 6),
         "overlap_efficiency_pct": snap["overlap_efficiency_pct"]},
        ts)]


def migration_lines(remote_worker, node_name: str, ts: int,
                    snap=None) -> List[str]:
    """The ``tpf_migration`` line of one worker: pre-copy round and byte
    totals, realized pauses, and the live session's staging depth.  Pass
    ``snap`` to reuse a ``migration_stats()``."""
    if snap is None:
        snap = remote_worker.migration_stats()
    sess = snap.get("session") or {}
    return [encode_line(
        "tpf_migration", {"node": node_name},
        {"rounds_total": int(snap["rounds_total"]),
         "delta_buffers_total": int(snap["delta_buffers_total"]),
         "delta_raw_bytes_total": int(snap["delta_raw_bytes_total"]),
         "delta_wire_bytes_total": int(snap["delta_wire_bytes_total"]),
         "streaming_total": int(snap["streaming_total"]),
         "aborted_total": int(snap["aborted_total"]),
         "installed_total": int(snap["installed_total"]),
         "pause_ms_last": float(snap["pause_ms_last"]),
         "pause_ms_max": float(snap["pause_ms_max"]),
         "frozen": int(bool(snap["frozen"])),
         "session_round": int(sess.get("round", 0)),
         "session_staged_buffers": int(sess.get("staged_buffers", 0))},
        ts)]


#: max influx lines buffered while the operator is unreachable (at 5s
#: intervals and ~10 lines/tick this is ~an hour of partition)
PUSH_BACKLOG_LINES = 8192

#: max lines per POST when draining the backlog — after a long partition
#: the accumulated backlog must not ship as one oversized request that
#: repeatedly trips the client timeout (push_metrics has no transport
#: retry), which would leave the node unable to ever drain
PUSH_CHUNK_LINES = 512


class HypervisorMetricsRecorder:
    def __init__(self, devices, workers, path: str = "",
                 interval_s: float = 5.0, node_name: str = "local",
                 push: Optional[Callable[[List[str]], object]] = None,
                 remote_workers=()):
        self.devices = devices
        self.workers = workers
        self.path = path
        self.interval_s = interval_s
        self.node_name = node_name
        self.push = push
        #: RemoteVTPUWorker instances co-hosted on this node: their
        #: dispatch-queue saturation (queue wait / service time /
        #: backpressure counters) ships as ``tpf_remote_dispatch`` +
        #: per-QoS ``tpf_remote_qos`` lines over the same push path,
        #: so the operator TSDB sees remote-serving saturation exactly
        #: like local chip duty
        self.remote_workers = list(remote_workers)
        self._backlog: deque = deque(maxlen=PUSH_BACKLOG_LINES)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="tpf-hv-metrics", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.record_once()
            except Exception:
                log.exception("metrics pass failed")

    def _worker_generation(self, w) -> str:
        """Chip generation of the worker's first bound device — rides on
        the tpf_worker line so the operator-side autoscaler converts
        duty% to TFLOPs with the right per-generation peak
        (workload_metrics_loader.go loads real per-worker units)."""
        for chip_id in w.status.chip_ids:
            entry = self.devices.get(chip_id)
            if entry is not None:
                return entry.info.generation
        return ""

    def record_once(self) -> None:
        lines = []
        ts = default_clock().now_ns()
        self.devices.refresh_metrics()
        for e in self.devices.devices():
            m = e.metrics
            if m is None:
                continue
            lines.append(encode_line(
                "tpf_chip",
                {"node": self.node_name, "chip": e.info.chip_id,
                 "generation": e.info.generation},
                {"duty_cycle_pct": m.duty_cycle_pct,
                 "hbm_used_bytes": int(m.hbm_used_bytes),
                 "hbm_bw_util_pct": m.hbm_bw_util_pct,
                 "power_watts": m.power_watts,
                 "temp_celsius": m.temp_celsius,
                 "ici_tx_bytes": int(m.ici_tx_bytes),
                 "ici_rx_bytes": int(m.ici_rx_bytes),
                 "partitions": len(e.partitions)}, ts))
        for rw in self.remote_workers:
            lines.extend(remote_dispatch_lines(rw, self.node_name, ts))
            if hasattr(rw, "migration_stats"):
                lines.extend(migration_lines(rw, self.node_name, ts))
            # tpfprof attribution series (docs/profiling.md): the
            # worker's per-tenant device-time ledger ships next to the
            # dispatch saturation it explains
            if getattr(rw, "profiler", None) is not None:
                lines.extend(profile_lines(rw.profiler.snapshot(),
                                           self.node_name, ts))
            if getattr(rw, "engine", None) is not None:
                lines.extend(serving_engine_lines(rw.engine,
                                                  self.node_name, ts))
        for w in self.workers.list():
            tags = {"node": self.node_name, "namespace": w.spec.namespace,
                    "worker": w.spec.name, "qos": w.spec.qos,
                    "isolation": w.spec.isolation}
            generation = self._worker_generation(w)
            if generation:
                tags["generation"] = generation
            lines.append(encode_line(
                "tpf_worker", tags,
                {"duty_cycle_pct": w.status.duty_cycle_pct,
                 "hbm_used_bytes": int(w.status.hbm_used_bytes),
                 "frozen": w.status.frozen,
                 "pids": len(w.status.pids)}, ts))
        if not lines:
            return
        # buffer for the network path FIRST: a full disk must not cost
        # the (healthy) push path this tick's lines
        if self.push is not None:
            self._buffer_for_push(lines)
        if self.path:
            try:
                with open(self.path, "a") as f:
                    f.write("\n".join(lines) + "\n")
            except OSError as e:
                log.warning("metrics file append failed: %s", e)
        if self.push is not None:
            self.flush()

    def _buffer_for_push(self, lines: List[str]) -> None:
        """Append to the push backlog, warning when the bounded deque
        evicts (a silent gap in the operator's series otherwise)."""
        overflow = len(self._backlog) + len(lines) \
            - (self._backlog.maxlen or 0)
        if overflow > 0:
            log.warning("metrics backlog full: dropping %d oldest lines "
                        "(operator unreachable too long)",
                        min(overflow, len(self._backlog) + len(lines)))
        self._backlog.extend(lines)

    def flush(self) -> bool:
        """Attempt to ship the backlog; returns True when drained.

        Ships in bounded chunks, popping each chunk only on success — a
        post-partition backlog never rides one oversized request, and a
        mid-drain failure keeps the unshipped remainder buffered."""
        if self.push is None:
            return True
        while self._backlog:
            batch = list(itertools.islice(self._backlog, PUSH_CHUNK_LINES))
            try:
                self.push(batch)
            except Exception as e:  # noqa: BLE001 - operator down/
                # partition: keep buffering, the next tick retries
                log.debug("metrics push failed (%d lines buffered): %s",
                          len(self._backlog), e)
                return False
            # drop exactly what we shipped (lines appended meanwhile stay)
            for _ in range(min(len(batch), len(self._backlog))):
                self._backlog.popleft()
        return True
