"""The hypervisor's metrics lines of a worker's serving engine, a
federation and a worker's migrations: the port's copies of
``serving_engine_lines``, ``federation_lines`` and ``migration_lines``
from ``tensorfusion_tpu/hypervisor/metrics.py``.  The rest of that module
(the recorder of devices, workers and processes, and its push path)
comes with the node layer.
"""

from __future__ import annotations

from typing import List

from ..metrics.encoder import encode_line


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
