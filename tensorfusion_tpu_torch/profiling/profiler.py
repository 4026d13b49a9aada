"""Per-tenant device-time attribution into fixed-width time bins (the
port's copy of ``tensorfusion_tpu/profiling/profiler.py``).

The dispatcher, the serving engine and the hypervisor already *know*
every launch boundary — they time launches for histograms and spans.
This module turns those boundaries into an attribution ledger:

- ``attribute(tenant, kind, dur_s)`` charges ``dur_s`` seconds of
  ``compute`` / ``transfer`` / ``queue`` time to a tenant, splitting
  the interval across fixed-width bins (``bin_s``-wide, bounded ring of
  ``max_bins``), so "who had the device between 12:00:03 and 12:00:04"
  has an answer at any point in the retained window;
- **utilization** per device = attributed compute time / elapsed time;
- **overlap accounting**: transfer attributions carry the portion that
  ran *hidden* behind an in-flight launch (the worker's prefetch),
  so ``overlap efficiency = hidden / total transfer`` measures whether
  the upload stream actually overlaps instead of serializing;
- per-tenant **HBM-resident gauges** (the serving engine stamps each
  tenant's paged-KV footprint every step).

Determinism: every timestamp comes from the injectable
:class:`~tensorfusion_tpu_torch.clock.Clock`; there is no wall-clock
read and no randomness, so :meth:`digest` of a run under a manual clock
is stable.

Thread safety: one lock around the ledger; the per-item cost is a few
dict updates and two clock reads per boundary.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Dict, List, Optional

from ..clock import Clock, default_clock

#: attribution categories: device compute, host<->device transfer,
#: queue wait.  Anything else is a programming error, loudly.
KINDS = ("compute", "transfer", "queue")

#: default bin width (seconds) and retained bin count — ~10 minutes of
#: 1s bins; the ring stays bounded no matter how long the worker lives
DEFAULT_BIN_S = 1.0
DEFAULT_MAX_BINS = 600


class _TenantLedger:
    __slots__ = ("qos", "compute_s", "transfer_s", "queue_s",
                 "hidden_s", "launches", "transfers", "queued",
                 "hbm_bytes")

    def __init__(self, qos: str = ""):
        self.qos = qos
        self.compute_s = 0.0
        self.transfer_s = 0.0
        self.queue_s = 0.0
        #: portion of transfer_s that ran behind an in-flight launch
        self.hidden_s = 0.0
        self.launches = 0
        self.transfers = 0
        self.queued = 0
        self.hbm_bytes = 0


class Profiler:
    """Attribution ledger for one device (or one engine/component)."""

    def __init__(self, name: str = "device0",
                 clock: Optional[Clock] = None,
                 bin_s: float = DEFAULT_BIN_S,
                 max_bins: int = DEFAULT_MAX_BINS,
                 shard: str = ""):
        self.name = name
        #: control-plane shard this ledger attributes for ("" = not a
        #: sharded deployment); rides every snapshot + tpf_prof_* line
        #: so a hot shard shows up in `tpfprof top` / the TUI pane
        self.shard = str(shard)
        self.clock = clock or default_clock()
        self.bin_s = max(float(bin_s), 1e-3)
        self.max_bins = max(int(max_bins), 1)
        self._lock = threading.Lock()
        # guarded by: _lock
        self._start_m = self.clock.monotonic()
        # guarded by: _lock
        self._tenants: Dict[str, _TenantLedger] = {}
        #: bin index -> {"compute_s","transfer_s","queue_s",
        #:               "tenants": {tenant: compute_s}}
        # guarded by: _lock
        self._bins: Dict[int, dict] = {}
        # guarded by: _lock
        self._totals = _TenantLedger()

    # -- attribution ------------------------------------------------------

    def attribute(self, tenant: str, kind: str, dur_s: float,
                  qos: str = "", hidden_s: float = 0.0,
                  end_m: Optional[float] = None,
                  count: bool = True) -> None:
        """Charge ``dur_s`` seconds of ``kind`` time, ending at
        ``end_m`` (clock.monotonic; default: now), to ``tenant``.

        ``hidden_s`` (transfer only) is the portion that overlapped an
        in-flight launch — it counts toward transfer time AND the
        overlap ledger.  Zero-duration attributions still count (the
        digital twin's virtual-time reconciles have zero duration but
        their *counts* are the deterministic fingerprint); pass
        ``count=False`` when adding a second time slice to an event
        already counted (e.g. a launch's deferred-flush wait)."""
        if kind not in KINDS:
            raise ValueError(f"unknown attribution kind {kind!r}")
        dur_s = max(float(dur_s), 0.0)
        hidden_s = min(max(float(hidden_s), 0.0), dur_s) \
            if kind == "transfer" else 0.0
        end = self.clock.monotonic() if end_m is None else float(end_m)
        n = 1 if count else 0
        with self._lock:
            led = self._tenants.get(tenant)
            if led is None:
                led = self._tenants[tenant] = _TenantLedger(qos)
            elif qos and led.qos != qos:
                led.qos = qos
            for target in (led, self._totals):
                if kind == "compute":
                    target.compute_s += dur_s
                    target.launches += n
                elif kind == "transfer":
                    target.transfer_s += dur_s
                    target.hidden_s += hidden_s
                    target.transfers += n
                else:
                    target.queue_s += dur_s
                    target.queued += n
            self._bin_locked(tenant, kind, dur_s, end)

    def set_hbm(self, tenant: str, nbytes: int, qos: str = "") -> None:
        """Per-tenant HBM-resident gauge (e.g. paged-KV footprint)."""
        with self._lock:
            led = self._tenants.get(tenant)
            if led is None:
                led = self._tenants[tenant] = _TenantLedger(qos)
            led.hbm_bytes = int(nbytes)

    def _bin_locked(self, tenant: str, kind: str, dur_s: float,
                    end: float) -> None:   # tpflint: holds=_lock
        """Split [end-dur, end) across fixed-width bins; prune bins
        that fell out of the retained window."""
        start = max(end - dur_s, self._start_m)
        first = int((start - self._start_m) / self.bin_s)
        last = int(max(end - self._start_m, 0.0) / self.bin_s)
        for idx in range(first, last + 1):
            b = self._bins.get(idx)
            if b is None:
                b = self._bins[idx] = {"compute_s": 0.0,
                                       "transfer_s": 0.0,
                                       "queue_s": 0.0, "tenants": {}}
            lo = self._start_m + idx * self.bin_s
            hi = lo + self.bin_s
            part = max(min(end, hi) - max(start, lo), 0.0)
            b[f"{kind}_s"] += part
            if kind == "compute":
                b["tenants"][tenant] = \
                    b["tenants"].get(tenant, 0.0) + part
        if len(self._bins) > self.max_bins:
            for idx in sorted(self._bins)[:len(self._bins)
                                          - self.max_bins]:
                del self._bins[idx]

    # -- reading ----------------------------------------------------------

    def snapshot(self, bins: int = 60) -> dict:
        """The attribution view: totals, per-tenant shares, overlap
        efficiency, and the most recent ``bins`` time bins.  Floats are
        rounded to 9 places so the canonical form (and :meth:`digest`)
        is stable against formatting, not against reordering — the
        accumulation order itself is deterministic under the sim."""
        with self._lock:
            elapsed = max(self.clock.monotonic() - self._start_m, 1e-9)
            tot = self._totals
            compute_total = tot.compute_s
            tenants = {}
            for name, led in self._tenants.items():
                tenants[name] = {
                    "qos": led.qos,
                    "compute_s": round(led.compute_s, 9),
                    "transfer_s": round(led.transfer_s, 9),
                    "queue_s": round(led.queue_s, 9),
                    "hidden_transfer_s": round(led.hidden_s, 9),
                    "launches": led.launches,
                    "transfers": led.transfers,
                    "queued": led.queued,
                    "hbm_bytes": led.hbm_bytes,
                    "device_share_pct": round(
                        100.0 * led.compute_s / compute_total, 6)
                    if compute_total > 0 else 0.0,
                }
            recent = sorted(self._bins)[-max(int(bins), 0):]
            bin_rows = []
            for idx in recent:
                b = self._bins[idx]
                bin_rows.append({
                    "t_s": round(idx * self.bin_s, 9),
                    "compute_s": round(b["compute_s"], 9),
                    "transfer_s": round(b["transfer_s"], 9),
                    "queue_s": round(b["queue_s"], 9),
                    "util_pct": round(
                        100.0 * b["compute_s"] / self.bin_s, 6),
                    "tenants": {t: round(v, 9)
                                for t, v in sorted(b["tenants"].items())},
                })
            overlap_eff = (tot.hidden_s / tot.transfer_s
                           if tot.transfer_s > 0 else 0.0)
            return {
                "name": self.name,
                "shard": self.shard,
                "bin_s": self.bin_s,
                "elapsed_s": round(elapsed, 9),
                "utilization_pct": round(
                    100.0 * min(tot.compute_s / elapsed, 1.0), 6),
                "totals": {
                    "compute_s": round(tot.compute_s, 9),
                    "transfer_s": round(tot.transfer_s, 9),
                    "queue_s": round(tot.queue_s, 9),
                    "hidden_transfer_s": round(tot.hidden_s, 9),
                    "launches": tot.launches,
                    "transfers": tot.transfers,
                    "queued": tot.queued,
                },
                "overlap": {
                    "transfer_s": round(tot.transfer_s, 9),
                    "hidden_s": round(tot.hidden_s, 9),
                    "efficiency_pct": round(100.0 * overlap_eff, 6),
                },
                "tenants": tenants,
                "bins": bin_rows,
            }

    def shares_by_qos(self) -> Dict[str, float]:
        """Device-time share per QoS class (fraction of attributed
        compute) — what the remoting bench checks against the WFQ
        weight ladder."""
        with self._lock:
            by_qos: Dict[str, float] = {}
            for led in self._tenants.values():
                by_qos[led.qos] = by_qos.get(led.qos, 0.0) \
                    + led.compute_s
            total = sum(by_qos.values())
        if total <= 0:
            return {}
        return {q: v / total for q, v in by_qos.items()}

    def digest(self, bins: int = 10 ** 9) -> str:
        """sha256 of the canonical snapshot — the determinism
        fingerprint two same-seed sim runs must agree on (elapsed time
        is virtual under SimClock, so it participates too)."""
        doc = json.dumps(self.snapshot(bins=bins), sort_keys=True,
                         separators=(",", ":"))
        return hashlib.sha256(doc.encode()).hexdigest()


def merge_snapshots(snaps: List[dict], name: str = "merged") -> dict:
    """Aggregate view over several profiler snapshots (the tpfprof CLI
    merges per-device artifacts into one top table).  Bins are not
    merged — timelines stay per-device."""
    out = {"name": name, "elapsed_s": 0.0, "utilization_pct": 0.0,
           "totals": {"compute_s": 0.0, "transfer_s": 0.0,
                      "queue_s": 0.0, "hidden_transfer_s": 0.0,
                      "launches": 0, "transfers": 0, "queued": 0},
           "overlap": {"transfer_s": 0.0, "hidden_s": 0.0,
                       "efficiency_pct": 0.0},
           "tenants": {}, "bins": []}
    for snap in snaps:
        out["elapsed_s"] = max(out["elapsed_s"],
                               snap.get("elapsed_s", 0.0))
        for k, v in (snap.get("totals") or {}).items():
            out["totals"][k] = out["totals"].get(k, 0) + v
        for tname, t in (snap.get("tenants") or {}).items():
            cur = out["tenants"].setdefault(
                tname, {"qos": t.get("qos", ""), "compute_s": 0.0,
                        "transfer_s": 0.0, "queue_s": 0.0,
                        "hidden_transfer_s": 0.0, "launches": 0,
                        "transfers": 0, "queued": 0, "hbm_bytes": 0,
                        "device_share_pct": 0.0})
            for k in ("compute_s", "transfer_s", "queue_s",
                      "hidden_transfer_s", "launches", "transfers",
                      "queued", "hbm_bytes"):
                cur[k] += t.get(k, 0)
    compute_total = out["totals"]["compute_s"]
    for t in out["tenants"].values():
        t["device_share_pct"] = round(
            100.0 * t["compute_s"] / compute_total, 6) \
            if compute_total > 0 else 0.0
    if out["elapsed_s"] > 0:
        out["utilization_pct"] = round(
            100.0 * min(compute_total / out["elapsed_s"], 1.0), 6)
    tr, hid = out["totals"]["transfer_s"], \
        out["totals"]["hidden_transfer_s"]
    out["overlap"] = {"transfer_s": round(tr, 9),
                      "hidden_s": round(hid, 9),
                      "efficiency_pct": round(100.0 * hid / tr, 6)
                      if tr > 0 else 0.0}
    return out
