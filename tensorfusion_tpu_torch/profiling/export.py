"""The ``tpf_prof_*`` influx lines of a profiler snapshot: the port's
copy of ``profile_lines`` from ``tensorfusion_tpu/profiling/export.py``,
the hypervisor's view of a worker's per-tenant attribution.  The
artifact format around it (``to_doc``, ``write_profile``,
``load_profile``, ``profile_digest``, ``validate_profile``) comes with
the node layer, which ports the metrics schema.
"""

from __future__ import annotations

from typing import List

from ..metrics.encoder import encode_line


def profile_lines(snap: dict, node_name: str, ts: int) -> List[str]:
    """Influx lines for one profiler snapshot: device-level
    ``tpf_prof_device`` (utilization, attributed seconds by kind,
    overlap efficiency) plus per-tenant ``tpf_prof_tenant``
    (device-time share, attributed seconds, HBM gauge).  Shared by the
    node-agent and operator recorders so both topologies emit
    identical series (docs/metrics-schema.md)."""
    tags = {"node": node_name, "device": snap["name"]}
    if snap.get("shard"):
        # sharded control plane: per-shard attribution stays queryable
        # as its own series (opt tag — single-shard lines are unchanged)
        tags["shard"] = snap["shard"]
    tot = snap["totals"]
    overlap = snap["overlap"]
    lines = [encode_line(
        "tpf_prof_device", tags,
        {"utilization_pct": snap["utilization_pct"],
         "compute_s_total": tot["compute_s"],
         "transfer_s_total": tot["transfer_s"],
         "queue_s_total": tot["queue_s"],
         "hidden_transfer_s_total": tot["hidden_transfer_s"],
         "overlap_efficiency_pct": overlap["efficiency_pct"],
         "launches_total": tot["launches"],
         "transfers_total": tot["transfers"],
         "elapsed_s": snap["elapsed_s"],
         "tenants": len(snap["tenants"])}, ts)]
    for tenant, t in sorted(snap["tenants"].items()):
        lines.append(encode_line(
            "tpf_prof_tenant",
            dict(tags, tenant=tenant, qos=t["qos"] or "unknown"),
            {"device_share_pct": t["device_share_pct"],
             "compute_s_total": t["compute_s"],
             "transfer_s_total": t["transfer_s"],
             "queue_s_total": t["queue_s"],
             "launches_total": t["launches"],
             "hbm_resident_bytes": t["hbm_bytes"]}, ts))
    return lines

