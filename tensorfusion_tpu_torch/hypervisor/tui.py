"""Hypervisor terminal UI.

The port's copy of ``tensorfusion_tpu/hypervisor/tui.py``.

Analog of the reference's bubbletea TUI (``pkg/hypervisor/tui/``: model.go,
device_view.go, worker_view.go, metrics_view.go, chart.go, shm_dialog.go —
list navigation, detail views with time-series charts, a cluster metrics
view, and the raw-shm inspector dialog).  Layered the same way this repo's
other UIs are:

- pure-text renderers (``render_*``, ``TimeSeriesChart``) that produce the
  screens from plain dicts — unit-testable, no curses;
- a ``TuiState`` navigation model (view stack, selection, chart history) —
  the bubbletea ``Model.Update`` analog, driven by key characters, also
  curses-free and fully testable;
- a thin curses wrapper that fetches from the hypervisor HTTP API each
  tick, feeds ``TuiState`` and blits the rendered screen.

Keys (reference model.go key map): d=devices w=workers m=metrics
s=shm-inspector r=remote-dispatch p=profile v=serving o=policy, j/k or
arrows move the selection, enter opens the detail view for the
selected row, esc goes back, q quits.  The dispatch pane shows the co-hosted
remote-vTPU workers' fair-queue state per tenant — queue-wait p50/p99,
SLO good ratio and the last trace id (docs/tracing.md) — fed by
/api/v1/dispatch.  The profile pane shows tpfprof's per-tenant
device-time attribution — share of device time, transfer/queue
seconds, overlap efficiency, recent utilization bins
(docs/profiling.md) — fed by /api/v1/profile.  The serving pane shows
each co-hosted tpfserve engine — throughput/TTFT, the paged-KV pool
with prefix-sharing/CoW counters, KV_SHIP ingest volume and
speculative-decode accept rates (docs/serving.md) — fed by
/api/v1/serving.  The policy pane shows the tpfpolicy closed loop —
per-rule fired/actuated/resolved counters and the decision-ledger
tail with triggers, exemplar trace ids and outcomes (docs/policy.md)
— fed by /api/v1/policy.

    python -m tensorfusion_tpu_torch.hypervisor.tui --url http://127.0.0.1:8000
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from typing import Dict, List, Optional, Tuple

from ..clock import WALL
from .. import constants
from .limiter_binding import ShmView, list_worker_segments


def _bar(frac: float, width: int = 20) -> str:
    frac = max(0.0, min(1.0, frac))
    fill = int(frac * width)
    return "[" + "#" * fill + "-" * (width - fill) + f"] {frac*100:5.1f}%"


def _fmt_bytes(n: float) -> str:
    for unit, mult in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if n >= mult:
            return f"{n/mult:.1f}{unit}"
    return f"{n:.0f}B"


# --------------------------------------------------------------------------
# time-series charts (chart.go analog)
# --------------------------------------------------------------------------

# eighth-block characters for the partially-filled top cell of a column
_EIGHTHS = " ▁▂▃▄▅▆▇█"


class TimeSeriesChart:
    """Fixed-capacity time series rendered as a block-character chart.

    Mirrors chart.go: ring buffer of the last ``max_points`` samples,
    auto-scaling max with 10% headroom, label + current/avg/max footer.
    """

    def __init__(self, label: str, width: int = 60, height: int = 5,
                 max_points: int = 60, unit: str = "",
                 max_value: float = 100.0):
        self.label = label
        self.width = width
        self.height = height
        self.max_points = max_points
        self.unit = unit
        self.auto_max = max_value
        self.data: List[float] = []

    def add(self, value: float) -> None:
        self.data.append(float(value))
        if len(self.data) > self.max_points:
            del self.data[0]

    def render(self) -> str:
        if not self.data:
            return f"{self.label}: (no data)"
        # scale recomputed from the live window (+10% headroom over
        # spikes) so a transient bad sample stops squashing the chart
        # once it ages out of the ring buffer
        peak = max(self.data)
        hi = max(self.auto_max if peak <= self.auto_max else peak * 1.1,
                 1e-9)
        cols = self.data[-self.width:]
        rows: List[str] = []
        # each column is a vertical bar of height*8 sub-cells
        heights = [max(0.0, min(1.0, v / hi)) * self.height * 8
                   for v in cols]
        for r in range(self.height - 1, -1, -1):
            base = r * 8
            line = []
            for h in heights:
                fill = int(round(h)) - base
                line.append(_EIGHTHS[max(0, min(8, fill))])
            # y-axis label on the two edge rows
            if r == self.height - 1:
                tag = f"{hi:8.1f} ┤"
            elif r == 0:
                tag = f"{0.0:8.1f} ┤"
            else:
                tag = " " * 8 + " │"
            rows.append(tag + "".join(line))
        cur, avg, mx = cols[-1], sum(cols) / len(cols), max(cols)
        rows.append(f"{self.label}: cur={cur:.1f}{self.unit} "
                    f"avg={avg:.1f}{self.unit} max={mx:.1f}{self.unit}")
        return "\n".join(rows)


class _EntityHistory:
    """Per-entity chart set (DeviceMetricsHistory / WorkerMetricsHistory)."""

    def __init__(self, specs: List[Tuple[str, str, float]]):
        self.charts = {name: TimeSeriesChart(name, unit=unit,
                                             max_value=default_max)
                       for name, unit, default_max in specs}

    def add(self, **values: float) -> None:
        for name, v in values.items():
            if name in self.charts:
                self.charts[name].add(v)

    def render(self) -> str:
        return "\n\n".join(c.render() for c in self.charts.values())


_DEVICE_SERIES = [("duty", "%", 100.0), ("hbm_gib", "GiB", 1.0),
                  ("power", "W", 100.0), ("temp", "C", 100.0)]
_WORKER_SERIES = [("duty", "%", 100.0), ("hbm_gib", "GiB", 1.0)]


# --------------------------------------------------------------------------
# pure renderers (device_view.go / worker_view.go / metrics_view.go)
# --------------------------------------------------------------------------


def render_devices(devices: List[dict], selected: int = -1) -> str:
    lines = ["  CHIP                GEN   DUTY                        "
             "HBM USED       POWER  TEMP  PARTS"]
    for i, d in enumerate(devices):
        info, m = d.get("info", {}), d.get("metrics") or {}
        duty = m.get("duty_cycle_pct", 0.0)
        mark = ">" if i == selected else " "
        lines.append(
            f"{mark} {info.get('chip_id',''):<19} "
            f"{info.get('generation',''):<5} "
            f"{_bar(duty/100.0)}  "
            f"{_fmt_bytes(m.get('hbm_used_bytes', 0)):<13} "
            f"{m.get('power_watts', 0):5.0f}W "
            f"{m.get('temp_celsius', 0):4.0f}C  "
            f"{len(d.get('partitions', []))}")
    return "\n".join(lines)


def render_workers(workers: List[dict], selected: int = -1) -> str:
    lines = ["  WORKER                     ISO     QOS      DUTY   "
             "HBM         PIDS  FROZEN"]
    for i, w in enumerate(workers):
        spec, st = w.get("spec", {}), w.get("status", {})
        key = f"{spec.get('namespace','')}/{spec.get('name','')}"
        mark = ">" if i == selected else " "
        lines.append(
            f"{mark} {key:<26} {spec.get('isolation',''):<7} "
            f"{spec.get('qos',''):<8} "
            f"{st.get('duty_cycle_pct', 0.0):5.1f}% "
            f"{_fmt_bytes(st.get('hbm_used_bytes', 0)):<11} "
            f"{len(st.get('pids', [])):<5} "
            f"{'yes' if st.get('frozen') else 'no'}")
    return "\n".join(lines)


def render_device_detail(device: dict, history: Optional[_EntityHistory],
                         workers: Optional[List[dict]] = None) -> str:
    """device_view.go renderDeviceDetail analog: static info, live
    metrics, partitions, co-resident workers, and the chart set."""
    info, m = device.get("info", {}), device.get("metrics") or {}
    chip = info.get("chip_id", "?")
    lines = [f"== device {chip} ==", ""]
    lines.append(
        f"generation={info.get('generation','?')} "
        f"cores={info.get('core_count','?')} "
        f"hbm={_fmt_bytes(info.get('hbm_bytes', 0))} "
        f"peak={info.get('peak_bf16_tflops', info.get('bf16_tflops','?'))}TF "
        f"mesh={info.get('mesh','')} slice={info.get('slice_id','')}")
    ici = info.get("ici_links") or []
    if ici:
        lines.append("ici: " + ", ".join(
            f"{l.get('peer_chip_id','?')}({l.get('kind','')})"
            for l in ici))
    lines.append(
        f"now: duty={m.get('duty_cycle_pct', 0.0):.1f}% "
        f"hbm={_fmt_bytes(m.get('hbm_used_bytes', 0))} "
        f"power={m.get('power_watts', 0):.0f}W "
        f"temp={m.get('temp_celsius', 0):.0f}C")
    parts = device.get("partitions") or []
    if parts:
        lines.append("")
        lines.append("partitions:")
        for p in parts:
            # /api/v1/devices sends bare partition-id strings
            # (server.py "partitions": list(e.partitions)); accept dicts
            # too for richer feeds.
            if isinstance(p, dict):
                lines.append(f"  {p.get('partition_id','?'):<20} "
                             f"cores={p.get('core_ids', '')} "
                             f"owner={p.get('owner','')}")
            else:
                lines.append(f"  {p}")
    co = [w for w in (workers or [])
          if chip in (w.get("status", {}).get("chip_ids") or [])
          or any(q.get("chip_id") == chip
                 for q in w.get("spec", {}).get("devices", []))]
    if co:
        lines.append("")
        lines.append("workers on this chip:")
        for w in co:
            spec, st = w.get("spec", {}), w.get("status", {})
            lines.append(f"  {spec.get('namespace','')}/"
                         f"{spec.get('name','')} "
                         f"duty={st.get('duty_cycle_pct', 0.0):.1f}%")
    if history is not None:
        lines += ["", history.render()]
    return "\n".join(lines)


def render_worker_detail(worker: dict,
                         history: Optional[_EntityHistory]) -> str:
    """worker_view.go renderWorkerDetail analog."""
    spec, st = worker.get("spec", {}), worker.get("status", {})
    key = f"{spec.get('namespace','')}/{spec.get('name','')}"
    lines = [f"== worker {key} ==", ""]
    lines.append(f"isolation={spec.get('isolation','')} "
                 f"qos={spec.get('qos','')} "
                 f"frozen={'yes' if st.get('frozen') else 'no'} "
                 f"pids={st.get('pids', [])}")
    lines.append(
        f"now: duty={st.get('duty_cycle_pct', 0.0):.1f}% "
        f"hbm={_fmt_bytes(st.get('hbm_used_bytes', 0))} "
        f"launches={st.get('launches', 0)} "
        f"blocked={st.get('blocked_events', 0)}")
    # WorkerSpec.devices: WorkerDeviceRequest dicts (framework.py)
    reqs = spec.get("devices") or []
    if reqs:
        lines.append("")
        lines.append("device requests:")
        for q in reqs:
            lines.append(
                f"  {q.get('chip_id') or '(any)':<18} "
                f"duty<={q.get('duty_percent', 0):.1f}% "
                f"tflops={q.get('tflops', 0):.1f} "
                f"hbm<={_fmt_bytes(q.get('hbm_bytes', 0)) if q.get('hbm_bytes') else 'inf'}"
                + (f" template={q['partition_template']}"
                   if q.get("partition_template") else ""))
    chips = st.get("chip_ids") or []
    if chips:
        lines.append("chips: " + ", ".join(chips))
    if history is not None:
        lines += ["", history.render()]
    return "\n".join(lines)


def render_metrics(devices: List[dict], workers: List[dict]) -> str:
    """metrics_view.go analog: cluster-level aggregates."""
    lines = ["== cluster metrics ==", ""]
    n = len(devices)
    duty = sum((d.get("metrics") or {}).get("duty_cycle_pct", 0.0)
               for d in devices)
    hbm_used = sum((d.get("metrics") or {}).get("hbm_used_bytes", 0)
                   for d in devices)
    hbm_cap = sum((d.get("info") or {}).get("hbm_bytes", 0)
                  for d in devices)
    power = sum((d.get("metrics") or {}).get("power_watts", 0.0)
                for d in devices)
    lines.append(f"devices: {n}   aggregate duty: "
                 f"{duty / max(n, 1):.1f}% avg "
                 f"({duty:.0f}% total)")
    lines.append(f"hbm: {_fmt_bytes(hbm_used)} / {_fmt_bytes(hbm_cap)} "
                 f"{_bar(hbm_used / hbm_cap if hbm_cap else 0.0)}")
    lines.append(f"power: {power:.0f}W")
    lines.append("")
    by_qos: Dict[str, int] = {}
    by_iso: Dict[str, int] = {}
    frozen = 0
    for w in workers:
        spec, st = w.get("spec", {}), w.get("status", {})
        by_qos[spec.get("qos", "?")] = by_qos.get(spec.get("qos", "?"), 0) + 1
        by_iso[spec.get("isolation", "?")] = \
            by_iso.get(spec.get("isolation", "?"), 0) + 1
        frozen += 1 if st.get("frozen") else 0
    lines.append(f"workers: {len(workers)} ({frozen} frozen)")
    if by_qos:
        lines.append("  by qos: " + "  ".join(
            f"{k}={v}" for k, v in sorted(by_qos.items())))
    if by_iso:
        lines.append("  by isolation: " + "  ".join(
            f"{k}={v}" for k, v in sorted(by_iso.items())))
    return "\n".join(lines)


def render_dispatch(snapshots: List[dict]) -> str:
    """Remote-vTPU dispatch pane: per-tenant queue-wait quantiles, SLO
    rollup and last-trace summary from each worker's dispatcher
    snapshot (the dispatcher's metrics on screen)."""
    if not snapshots:
        return "(no remote-vTPU workers registered on this node)"
    lines: List[str] = []
    for i, snap in enumerate(snapshots):
        qw, sv = snap.get("queue_wait", {}), snap.get("service", {})
        lines.append(
            f"== remote worker {i} [{snap.get('mode','?')}] "
            f"depth={snap.get('depth', 0)} "
            f"executed={snap.get('executed', 0)} "
            f"launches={snap.get('launches', 0)} "
            f"busy={snap.get('busy_rejected', 0)} "
            f"deadline={snap.get('deadline_exceeded', 0)} ==")
        lines.append(
            f"queue-wait p50={qw.get('p50_ms', 0):.2f}ms "
            f"p99={qw.get('p99_ms', 0):.2f}ms   "
            f"service p50={sv.get('p50_ms', 0):.2f}ms "
            f"p99={sv.get('p99_ms', 0):.2f}ms")
        last = snap.get("last_trace_id", "")
        if last:
            lines.append(f"last trace: {last}")
        tenants = snap.get("tenants", {})
        if tenants:
            lines.append("  TENANT          QOS       W    QUEUED "
                         "DONE   WAIT p50/p99 ms   SLO ok     "
                         "LAST TRACE")
            for conn_id in sorted(tenants):
                t = tenants[conn_id]
                tq = t.get("queue_wait", {})
                total = t.get("slo_total", 0)
                good = t.get("slo_good", 0)
                ratio = f"{good / total * 100.0:5.1f}%" if total \
                    else "    -"
                lines.append(
                    f"  {conn_id:<15} {t.get('qos',''):<8} "
                    f"{t.get('weight', 0):4.0f} "
                    f"{t.get('queued', 0):6d} "
                    f"{t.get('completed', 0):5d} "
                    f"{tq.get('p50_ms', 0):8.2f}/{tq.get('p99_ms', 0):<8.2f} "
                    f"{ratio:<9} "
                    f"{t.get('last_trace_id', '') or '-'}")
        lines.append("")
    return "\n".join(lines).rstrip()


def render_serving(snapshots: List[dict]) -> str:
    """tpfserve pane (docs/serving.md): per-engine throughput/TTFT,
    the paged-KV pool with its prefix-sharing dedup + copy-on-write
    counters, KV_SHIP ingest volume (disaggregated prefill) and
    speculative-decode accept rates, plus the per-tenant table."""
    if not snapshots:
        return "(no serving engines registered on this node)"
    lines: List[str] = []
    for snap in snapshots:
        kv = snap.get("kv", {})
        ttft = snap.get("ttft", {})
        lines.append(
            f"== {snap.get('name', '?')} "
            f"tok/s={snap.get('tokens_per_s', 0.0):8.1f} "
            f"active={snap.get('active', 0)} "
            f"waiting={snap.get('waiting', 0)} "
            f"occupancy={snap.get('batch_occupancy_pct', 0.0):5.1f}% "
            f"ttft p50={ttft.get('p50_ms', 0):.2f}ms "
            f"p99={ttft.get('p99_ms', 0):.2f}ms ==")
        lines.append(
            f"kv: {kv.get('used', 0)}/{kv.get('usable', 0)} blocks "
            f"({kv.get('utilization_pct', 0.0):.1f}%) "
            f"shared={kv.get('shared_blocks', 0)} "
            f"logical={kv.get('logical_blocks', 0)} "
            f"cow={kv.get('cow_copies_total', 0)} "
            f"prefix-hit-tokens={kv.get('prefix_hit_tokens_total', 0)} "
            f"evicted={kv.get('evicted_total', 0)}")
        spec = snap.get("spec", {})
        ship = snap.get("kv_ship", {})
        if spec.get("k"):
            lines.append(
                f"spec: k={spec.get('k', 0)} "
                f"accept={spec.get('accept_rate', 0.0) * 100:5.1f}% "
                f"({spec.get('accepted', 0)}/{spec.get('proposed', 0)} "
                f"over {spec.get('steps', 0)} verify steps)")
        if ship.get("ships"):
            lines.append(
                f"kv-ship: {ship.get('ships', 0)} ships "
                f"{ship.get('blocks', 0)} blocks written "
                f"{ship.get('dedup_blocks', 0)} deduped "
                f"{_fmt_bytes(ship.get('bytes', 0))} shipped")
        tenants = snap.get("tenants", {})
        if tenants:
            lines.append("  TENANT          QOS      TOKENS  "
                         "TTFT p50/p99 ms   SLO ok   PREFIX-HIT  "
                         "SPEC ok")
            for name in sorted(tenants):
                t = tenants[name]
                tq = t.get("ttft", {})
                total = t.get("slo_total", 0)
                ratio = (f"{t.get('slo_good', 0) / total * 100:5.1f}%"
                         if total else "    -")
                spr = t.get("spec_proposed", 0)
                spec_ok = (f"{t.get('spec_accept_rate', 0.0) * 100:5.1f}%"
                           if spr else "    -")
                lines.append(
                    f"  {name:<15} {t.get('qos', '') or '-':<8} "
                    f"{t.get('tokens', 0):7d} "
                    f"{tq.get('p50_ms', 0):8.2f}/{tq.get('p99_ms', 0):<8.2f} "
                    f"{ratio:<8} "
                    f"{t.get('prefix_hit_tokens', 0):10d}  "
                    f"{spec_ok}")
        lines.append("")
    return "\n".join(lines).rstrip()


def render_profile(snapshots: List[dict]) -> str:
    """tpfprof pane (docs/profiling.md): per-device utilization and
    overlap efficiency, the per-tenant device-time share table, and a
    recent-bin utilization strip — the attribution ledger on screen."""
    if not snapshots:
        return "(no profiled workers registered on this node)"
    lines: List[str] = []
    for snap in snapshots:
        tot = snap.get("totals", {})
        overlap = snap.get("overlap", {})
        shard = snap.get("shard", "")
        lines.append(
            f"== {snap.get('name', '?')} "
            + (f"shard={shard} " if shard else "")
            + f"util={snap.get('utilization_pct', 0.0):5.1f}% "
            f"compute={tot.get('compute_s', 0.0):.3f}s "
            f"transfer={tot.get('transfer_s', 0.0):.3f}s "
            f"queue={tot.get('queue_s', 0.0):.3f}s "
            f"overlap-eff={overlap.get('efficiency_pct', 0.0):5.1f}% ==")
        tenants = snap.get("tenants", {})
        if tenants:
            lines.append("  TENANT          QOS       SHARE   "
                         "COMPUTE s  TRANSFER s   QUEUE s  LAUNCH  "
                         "HBM")
            ordered = sorted(
                tenants.items(),
                key=lambda kv: -kv[1].get("device_share_pct", 0.0))
            for tenant, t in ordered:
                lines.append(
                    f"  {tenant:<15} {t.get('qos', '') or '-':<8} "
                    f"{t.get('device_share_pct', 0.0):6.2f}% "
                    f"{t.get('compute_s', 0.0):10.3f} "
                    f"{t.get('transfer_s', 0.0):11.3f} "
                    f"{t.get('queue_s', 0.0):9.3f} "
                    f"{t.get('launches', 0):7d} "
                    f"{_fmt_bytes(t.get('hbm_bytes', 0))}")
        bins = snap.get("bins", [])
        if bins:
            recent = bins[-30:]
            strip = "".join(
                " .:-=+*#%@"[min(int(b.get("util_pct", 0.0) / 10.01),
                                 9)]
                for b in recent)
            lines.append(f"  util/bin ({snap.get('bin_s', 1.0)}s): "
                         f"|{strip}|  (oldest -> newest)")
        lines.append("")
    return "\n".join(lines).rstrip()


def render_policy(snapshots: List[dict]) -> str:
    """tpfpolicy pane (docs/policy.md): the closed loop on screen —
    per-rule fired/actuated/resolved counters and the tail of the
    decision ledger with each decision's trigger, exemplar trace ids
    and outcome (`tpfpolicy explain <id>` renders the full record)."""
    if not snapshots:
        return "(no policy engines registered on this node)"
    lines: List[str] = []
    for snap in snapshots:
        c = snap.get("counters", {})
        lines.append(
            f"== policy@{snap.get('node', '?')} "
            f"decisions={c.get('decisions_total', 0)} "
            f"actuated={c.get('actuations_total', 0)} "
            f"failed={c.get('actuation_failures_total', 0)} "
            f"resolved={c.get('resolved_total', 0)} "
            f"pending={c.get('pending', 0)} "
            f"suppressed={c.get('suppressed_total', 0)} ==")
        per_rule = snap.get("per_rule", {})
        if per_rule:
            lines.append("  RULE                    ACTION          "
                         "FIRED  ACT  FAIL  RESOLVED  LAST")
            for name in sorted(per_rule):
                st = per_rule[name]
                lines.append(
                    f"  {name:<23} {str(st.get('action', '-')):<15} "
                    f"{st.get('fired', 0):5.0f} "
                    f"{st.get('actuated', 0):4.0f} "
                    f"{st.get('failed', 0):5.0f} "
                    f"{st.get('resolved', 0):9.0f} "
                    f"{st.get('last_value', 0.0):8.2f}")
        ledger = (snap.get("ledger") or {}).get("decisions", [])
        if ledger:
            lines.append("  ID  T          RULE                 "
                         "TRIGGER                        OUTCOME   "
                         "EXEMPLARS")
            for d in ledger[-8:]:
                ev = d.get("evidence", {})
                ex = ",".join(ev.get("exemplars", [])[:2]) or "-"
                out = (d.get("outcome") or {}).get("state", "?")
                ok = (d.get("actuation") or {}).get("ok")
                mark = "" if ok else " !"
                lines.append(
                    f"  {d.get('id', 0):<3} {d.get('t', 0.0):<10.1f} "
                    f"{d.get('rule', '?'):<20} "
                    f"{str(d.get('trigger', '?'))[:30]:<30} "
                    f"{out:<9}{mark} {ex[:40]}")
        lines.append("")
    return "\n".join(lines).rstrip()


def render_shm(shm_base: str, selected: int = -1) -> str:
    """The shm inspector dialog (shm_dialog.go analog): raw token-bucket
    state of every worker segment."""
    lines = []
    for idx, (ns, pod, path) in enumerate(list_worker_segments(shm_base)):
        mark = ">" if idx == selected else " "
        try:
            state = ShmView(path).read()
        except (ValueError, OSError) as e:
            lines.append(f"{mark} {ns}/{pod}: unreadable ({e})")
            continue
        flags = "FROZEN" if state.frozen else (
            "AUTO-FROZEN" if state.auto_frozen else "active")
        lines.append(f"{mark} segment {ns}/{pod}  [{flags}]  "
                     f"heartbeat={state.heartbeat_ts_s}  "
                     f"pids={state.pids}")
        for i, dev in enumerate(state.devices):
            if not dev.active:
                continue
            cap = max(dev.capacity_mflop, 1)
            lines.append(
                f"   dev{i} {dev.chip_id:<18} duty={dev.duty_limit_bp/100:5.1f}% "
                f"tokens={_bar(dev.tokens_mflop / cap, 12)} "
                f"refill={dev.refill_mflop_per_s/1e3:.0f}GF/s "
                f"launches={dev.launches} blocked={dev.blocked_events}")
            lines.append(
                f"        hbm {_fmt_bytes(dev.hbm_used_bytes)}/"
                f"{_fmt_bytes(dev.hbm_limit_bytes) if dev.hbm_limit_bytes else 'inf'}"
                f"  charged={dev.total_charged_mflop/1e3:.1f}GFLOP")
    return "\n".join(lines) if lines else f"(no segments under {shm_base})"


# --------------------------------------------------------------------------
# navigation model (model.go Update analog — curses-free, testable)
# --------------------------------------------------------------------------

VIEW_DEVICES = "devices"
VIEW_WORKERS = "workers"
VIEW_METRICS = "metrics"
VIEW_SHM = "shm"
VIEW_DISPATCH = "dispatch"
VIEW_PROFILE = "profile"
VIEW_SERVING = "serving"
VIEW_POLICY = "policy"
VIEW_DEVICE_DETAIL = "device_detail"
VIEW_WORKER_DETAIL = "worker_detail"


class TuiState:
    """View stack + selection + chart history.

    ``update()`` ingests a fresh devices/workers snapshot (accumulating
    chart history for every entity, like model.go's updateMetricsHistory);
    ``key()`` handles one keypress and returns False when the UI should
    exit; ``render()`` produces the current screen as text.
    """

    def __init__(self, shm_base: str = ""):
        self.shm_base = shm_base
        self.view = VIEW_DEVICES
        self.sel_device = 0
        self.sel_worker = 0
        self.sel_shm = 0
        self.devices: List[dict] = []
        self.workers: List[dict] = []
        self.dispatch: List[dict] = []
        self.profile: List[dict] = []
        self.serving: List[dict] = []
        self.policy: List[dict] = []
        self.device_history: Dict[str, _EntityHistory] = {}
        self.worker_history: Dict[str, _EntityHistory] = {}
        self.last_update = 0.0
        self.error: Optional[str] = None

    # -- data ingestion ---------------------------------------------------

    def update_dispatch(self, snapshots: List[dict]) -> None:
        """Ingest /api/v1/dispatch (fetched separately from devices/
        workers so hypervisors without remote workers — or old servers
        without the endpoint — degrade to an empty pane)."""
        self.dispatch = snapshots or []

    def update_profile(self, snapshots: List[dict]) -> None:
        """Ingest /api/v1/profile (same degrade-to-empty contract as
        the dispatch pane for servers without the endpoint)."""
        self.profile = snapshots or []

    def update_serving(self, snapshots: List[dict]) -> None:
        """Ingest /api/v1/serving (same degrade-to-empty contract as
        the dispatch pane for servers without the endpoint)."""
        self.serving = snapshots or []

    def update_policy(self, snapshots: List[dict]) -> None:
        """Ingest /api/v1/policy (same degrade-to-empty contract as
        the dispatch pane for servers without the endpoint)."""
        self.policy = snapshots or []

    def update(self, devices: List[dict], workers: List[dict]) -> None:
        self.devices, self.workers = devices, workers
        self.error = None
        self.last_update = WALL.now()
        self.sel_device = min(self.sel_device, max(len(devices) - 1, 0))
        self.sel_worker = min(self.sel_worker, max(len(workers) - 1, 0))
        for d in devices:
            chip = (d.get("info") or {}).get("chip_id", "?")
            h = self.device_history.setdefault(
                chip, _EntityHistory(_DEVICE_SERIES))
            m = d.get("metrics") or {}
            h.add(duty=m.get("duty_cycle_pct", 0.0),
                  hbm_gib=m.get("hbm_used_bytes", 0) / 2**30,
                  power=m.get("power_watts", 0.0),
                  temp=m.get("temp_celsius", 0.0))
        for w in workers:
            spec, st = w.get("spec", {}), w.get("status", {})
            key = f"{spec.get('namespace','')}/{spec.get('name','')}"
            h = self.worker_history.setdefault(
                key, _EntityHistory(_WORKER_SERIES))
            h.add(duty=st.get("duty_cycle_pct", 0.0),
                  hbm_gib=st.get("hbm_used_bytes", 0) / 2**30)

    # -- key handling -----------------------------------------------------

    def key(self, ch: str) -> bool:
        """Process one key; returns False to quit."""
        if ch == "q":
            return False
        if ch in ("d", "w", "m", "s", "r", "p", "v", "o"):
            self.view = {"d": VIEW_DEVICES, "w": VIEW_WORKERS,
                         "m": VIEW_METRICS, "s": VIEW_SHM,
                         "r": VIEW_DISPATCH, "p": VIEW_PROFILE,
                         "v": VIEW_SERVING, "o": VIEW_POLICY}[ch]
            return True
        if ch == "esc":
            if self.view == VIEW_DEVICE_DETAIL:
                self.view = VIEW_DEVICES
            elif self.view == VIEW_WORKER_DETAIL:
                self.view = VIEW_WORKERS
            return True
        if ch in ("j", "down", "k", "up"):
            delta = 1 if ch in ("j", "down") else -1
            if self.view == VIEW_DEVICES:
                self.sel_device = _clamp(self.sel_device + delta,
                                         len(self.devices))
            elif self.view == VIEW_WORKERS:
                self.sel_worker = _clamp(self.sel_worker + delta,
                                         len(self.workers))
            elif self.view == VIEW_SHM:
                n = len(list_worker_segments(self.shm_base)) \
                    if self.shm_base else 0
                self.sel_shm = _clamp(self.sel_shm + delta, n)
            return True
        if ch == "enter":
            if self.view == VIEW_DEVICES and self.devices:
                self.view = VIEW_DEVICE_DETAIL
            elif self.view == VIEW_WORKERS and self.workers:
                self.view = VIEW_WORKER_DETAIL
            return True
        return True

    # -- rendering --------------------------------------------------------

    def _selected_device(self) -> Optional[dict]:
        if 0 <= self.sel_device < len(self.devices):
            return self.devices[self.sel_device]
        return None

    def _selected_worker(self) -> Optional[dict]:
        if 0 <= self.sel_worker < len(self.workers):
            return self.workers[self.sel_worker]
        return None

    def render(self) -> str:
        if self.error:
            return f"(error: {self.error})"
        if self.view == VIEW_DEVICES:
            return render_devices(self.devices, self.sel_device)
        if self.view == VIEW_WORKERS:
            return render_workers(self.workers, self.sel_worker)
        if self.view == VIEW_METRICS:
            return render_metrics(self.devices, self.workers)
        if self.view == VIEW_SHM:
            return render_shm(self.shm_base, self.sel_shm)
        if self.view == VIEW_DISPATCH:
            return render_dispatch(self.dispatch)
        if self.view == VIEW_PROFILE:
            return render_profile(self.profile)
        if self.view == VIEW_SERVING:
            return render_serving(self.serving)
        if self.view == VIEW_POLICY:
            return render_policy(self.policy)
        if self.view == VIEW_DEVICE_DETAIL:
            d = self._selected_device()
            if d is None:
                return "(no device selected)"
            chip = (d.get("info") or {}).get("chip_id", "?")
            return render_device_detail(
                d, self.device_history.get(chip), self.workers)
        if self.view == VIEW_WORKER_DETAIL:
            w = self._selected_worker()
            if w is None:
                return "(no worker selected)"
            spec = w.get("spec", {})
            key = f"{spec.get('namespace','')}/{spec.get('name','')}"
            return render_worker_detail(w, self.worker_history.get(key))
        return "(unknown view)"

    def header(self) -> str:
        stale = ""
        if self.last_update and WALL.now() - self.last_update > 5:
            stale = f"  (stale {WALL.now() - self.last_update:.0f}s)"
        return ("tpu-fusion hypervisor  [d]evices [w]orkers [m]etrics "
                "[s]hm [r]emote-dispatch [p]rofile [v]serving "
                "p[o]licy  j/k+enter detail  esc back  [q]uit" + stale)


def _clamp(idx: int, n: int) -> int:
    if n <= 0:
        return 0
    return max(0, min(n - 1, idx))


# --------------------------------------------------------------------------
# transport + entry points
# --------------------------------------------------------------------------


def _fetch(url: str, path: str):
    from ..utils.tlsutil import hypervisor_urlopen

    with hypervisor_urlopen(url + path, timeout_s=5) as r:
        return json.loads(r.read())


def snapshot(url: str, shm_base: str = "") -> str:
    """One-shot full dump (the --once mode)."""
    out = ["== tpu-fusion hypervisor ==", ""]
    try:
        devices = _fetch(url, "/api/v1/devices")
        workers = _fetch(url, "/api/v1/workers")
        out.append(render_devices(devices))
        out.append("")
        out.append(render_workers(workers))
        out.append("")
        out.append(render_metrics(devices, workers))
        # an older hypervisor without the endpoint = no dispatch pane;
        # silence is the design (the main fetch above already surfaced
        # reachability)
        try:
            dispatch = _fetch(url, "/api/v1/dispatch")
        # tpflint: disable=swallowed-error -- absent endpoint, by design
        except Exception:  # noqa: BLE001 - older server: no endpoint
            dispatch = []
        if dispatch:
            out += ["", render_dispatch(dispatch)]
        try:
            profile = _fetch(url, "/api/v1/profile")
        # tpflint: disable=swallowed-error -- absent endpoint, by design
        except Exception:  # noqa: BLE001 - older server: no endpoint
            profile = []
        if profile:
            out += ["", render_profile(profile)]
        try:
            serving = _fetch(url, "/api/v1/serving")
        # tpflint: disable=swallowed-error -- absent endpoint, by design
        except Exception:  # noqa: BLE001 - older server: no endpoint
            serving = []
        if serving:
            out += ["", render_serving(serving)]
        try:
            policy = _fetch(url, "/api/v1/policy")
        # tpflint: disable=swallowed-error -- absent endpoint, by design
        except Exception:  # noqa: BLE001 - older server: no endpoint
            policy = []
        if policy:
            out += ["", render_policy(policy)]
    except Exception as e:  # noqa: BLE001
        out.append(f"(hypervisor unreachable at {url}: {e})")
    if shm_base:
        out += ["", "-- shm inspector --", render_shm(shm_base)]
    return "\n".join(out)


_CURSES_KEYS = {10: "enter", 13: "enter", 27: "esc"}


def run_curses(url: str, shm_base: str, refresh_s: float = 1.0) -> None:
    import curses

    state = TuiState(shm_base)

    def main(scr):
        curses.curs_set(0)
        # getch blocks at most 100ms so keys are responsive; the (slow,
        # up-to-2x5s-timeout) HTTP fetch only runs when refresh_s has
        # elapsed, never between keystrokes.
        scr.timeout(100)
        last_fetch = 0.0
        dirty = True
        while True:
            now = WALL.now()
            if now - last_fetch >= refresh_s:
                last_fetch = now
                try:
                    state.update(_fetch(url, "/api/v1/devices"),
                                 _fetch(url, "/api/v1/workers"))
                    # older server without /api/v1/dispatch: empty
                    # pane, by design (devices/workers fetch above
                    # owns the reachability error)
                    try:
                        state.update_dispatch(
                            _fetch(url, "/api/v1/dispatch"))
                    # tpflint: disable=swallowed-error -- by design
                    except Exception:  # noqa: BLE001 - old server
                        state.update_dispatch([])
                    try:
                        state.update_profile(
                            _fetch(url, "/api/v1/profile"))
                    # tpflint: disable=swallowed-error -- by design
                    except Exception:  # noqa: BLE001 - old server
                        state.update_profile([])
                    try:
                        state.update_serving(
                            _fetch(url, "/api/v1/serving"))
                    # tpflint: disable=swallowed-error -- by design
                    except Exception:  # noqa: BLE001 - old server
                        state.update_serving([])
                    try:
                        state.update_policy(
                            _fetch(url, "/api/v1/policy"))
                    # tpflint: disable=swallowed-error -- by design
                    except Exception:  # noqa: BLE001 - old server
                        state.update_policy([])
                except Exception as e:  # noqa: BLE001
                    state.error = f"hypervisor unreachable at {url}: {e}"
                dirty = True
            if dirty:                   # render only fresh data/keys —
                dirty = False           # the shm view re-reads segments
                scr.erase()             # on every render
                try:
                    scr.addstr(0, 0, state.header(), curses.A_REVERSE)
                    for i, line in enumerate(state.render().splitlines()):
                        if i + 2 >= curses.LINES - 1:
                            break
                        scr.addstr(i + 2, 0, line[:curses.COLS - 1])
                except curses.error:
                    pass
                scr.refresh()
            while True:                 # drain every buffered key
                ch = scr.getch()
                if ch == -1:
                    break
                key = _CURSES_KEYS.get(ch)
                if key is None:
                    if ch == curses.KEY_DOWN:
                        key = "down"
                    elif ch == curses.KEY_UP:
                        key = "up"
                    elif 0 <= ch < 256:
                        key = chr(ch)
                    else:
                        continue
                if not state.key(key):
                    return
                dirty = True

    curses.wrapper(main)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpf-hypervisor-tui")
    ap.add_argument("--url", default="http://127.0.0.1:8000")
    ap.add_argument("--shm-base",
                    default=constants.DEFAULT_SHM_BASE)
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (no curses)")
    args = ap.parse_args(argv)
    if args.once or not sys.stdout.isatty():
        print(snapshot(args.url, args.shm_base))
        return 0
    run_curses(args.url, args.shm_base)
    return 0


if __name__ == "__main__":
    sys.exit(main())
