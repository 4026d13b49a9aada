"""Namespace quota store with two-phase (assumed/committed) accounting.

The port's copy of ``tensorfusion_tpu/allocator/quota.py``.

Analog of the reference's ``internal/quota/quota_store.go``:
``CheckQuotaAvailable``(:77), ``AllocateQuota``(:400), ``AssumeQuota``(:430),
``ReconcileQuotaStore``(:544), ``SyncQuotasToK8s``(:600) and the typed
``QuotaExceededError{Unresolvable}``(:665).

Assumed usage covers the scheduler's Reserve->Bind window: quota is held the
moment a pod is assumed onto chips and either committed on bind or released
by the TTL sweep / unreserve.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api.resources import AllocRequest, QuotaAmounts, ResourceAmount
from ..api.types import TPUResourceQuota
from ..store import ConflictError, ObjectStore


class QuotaExceededError(Exception):
    def __init__(self, namespace: str, reason: str, unresolvable: bool):
        super().__init__(f"quota exceeded in {namespace}: {reason}")
        self.namespace = namespace
        self.reason = reason
        #: True when the request can never fit (exceeds the total quota even
        #: on an empty namespace) — callers should fail fast instead of
        #: retrying.
        self.unresolvable = unresolvable


@dataclass
class _NsUsage:
    quota: Optional[TPUResourceQuota] = None
    committed_requests: ResourceAmount = field(default_factory=ResourceAmount)
    committed_limits: ResourceAmount = field(default_factory=ResourceAmount)
    assumed_requests: ResourceAmount = field(default_factory=ResourceAmount)
    assumed_limits: ResourceAmount = field(default_factory=ResourceAmount)
    committed_workers: int = 0
    assumed_workers: int = 0


class QuotaStore:
    def __init__(self, store: Optional[ObjectStore] = None):
        self.store = store
        self._lock = threading.RLock()
        self._ns: Dict[str, _NsUsage] = {}

    # -- quota object management ------------------------------------------

    def set_quota(self, quota: TPUResourceQuota) -> None:
        with self._lock:
            u = self._ns.setdefault(quota.metadata.namespace, _NsUsage())
            u.quota = quota

    def remove_quota(self, namespace: str) -> None:
        with self._lock:
            u = self._ns.get(namespace)
            if u is not None:
                u.quota = None

    def get_usage(self, namespace: str) -> Optional[_NsUsage]:
        with self._lock:
            return self._ns.get(namespace)

    # -- checks -----------------------------------------------------------

    def check(self, req: AllocRequest) -> None:
        """Raise QuotaExceededError if the request doesn't fit the
        namespace quota (committed + assumed)."""
        with self._lock:
            u = self._ns.get(req.namespace)
            if u is None or u.quota is None:
                return
            spec = u.quota.spec
            self._check_single(req, spec.single)
            total = spec.total
            if total.max_workers:
                used = u.committed_workers + u.assumed_workers
                if used + 1 > total.max_workers:
                    raise QuotaExceededError(
                        req.namespace,
                        f"workers {used}+1 > {total.max_workers}",
                        unresolvable=total.max_workers < 1)
            for attr in ("tflops", "hbm_bytes"):
                cap = getattr(total.requests, attr)
                if cap <= 0:
                    continue
                used = (getattr(u.committed_requests, attr)
                        + getattr(u.assumed_requests, attr))
                want = getattr(req.request, attr) * req.chip_count
                if used + want > cap + 1e-9:
                    raise QuotaExceededError(
                        req.namespace,
                        f"requests.{attr} {used:.1f}+{want:.1f} > {cap:.1f}",
                        unresolvable=want > cap + 1e-9)

    def check_adjust(self, namespace: str, old: ResourceAmount,
                     new: ResourceAmount, chip_count: int) -> None:
        """Vertical-resize gate: the *new* per-pod size must respect the
        single-pod cap, and usage + delta must respect the totals."""
        with self._lock:
            u = self._ns.get(namespace)
            if u is None or u.quota is None:
                return
            spec = u.quota.spec
            for attr in ("tflops", "hbm_bytes"):
                cap = getattr(spec.single.requests, attr)
                want = getattr(new, attr)
                if cap > 0 and want > cap + 1e-9:
                    raise QuotaExceededError(
                        namespace,
                        f"single.requests.{attr} {want:.1f} > {cap:.1f}",
                        unresolvable=True)
                total_cap = getattr(spec.total.requests, attr)
                if total_cap <= 0:
                    continue
                used = (getattr(u.committed_requests, attr)
                        + getattr(u.assumed_requests, attr))
                delta = (getattr(new, attr) - getattr(old, attr)) * chip_count
                if used + delta > total_cap + 1e-9:
                    raise QuotaExceededError(
                        namespace,
                        f"requests.{attr} {used:.1f}+{delta:.1f} > "
                        f"{total_cap:.1f}", unresolvable=False)

    def _check_single(self, req: AllocRequest, single: QuotaAmounts) -> None:
        for attr in ("tflops", "hbm_bytes"):
            cap = getattr(single.requests, attr)
            want = getattr(req.request, attr)
            if cap > 0 and want > cap + 1e-9:
                raise QuotaExceededError(
                    req.namespace,
                    f"single.requests.{attr} {want:.1f} > {cap:.1f}",
                    unresolvable=True)

    # -- two-phase accounting ---------------------------------------------

    def assume(self, req: AllocRequest) -> None:
        self.check(req)
        with self._lock:
            u = self._ns.setdefault(req.namespace, _NsUsage())
            u.assumed_requests = u.assumed_requests.add(
                req.request.scale(req.chip_count))
            u.assumed_limits = u.assumed_limits.add(
                req.limit.scale(req.chip_count))
            u.assumed_workers += 1

    def unassume(self, req: AllocRequest) -> None:
        with self._lock:
            u = self._ns.get(req.namespace)
            if u is None:
                return
            u.assumed_requests = u.assumed_requests.sub(
                req.request.scale(req.chip_count))
            u.assumed_limits = u.assumed_limits.sub(
                req.limit.scale(req.chip_count))
            u.assumed_workers = max(0, u.assumed_workers - 1)

    def commit(self, req: AllocRequest, was_assumed: bool = True) -> None:
        with self._lock:
            if was_assumed:
                self.unassume(req)
            u = self._ns.setdefault(req.namespace, _NsUsage())
            u.committed_requests = u.committed_requests.add(
                req.request.scale(req.chip_count))
            u.committed_limits = u.committed_limits.add(
                req.limit.scale(req.chip_count))
            u.committed_workers += 1

    def release(self, req: AllocRequest) -> None:
        with self._lock:
            u = self._ns.get(req.namespace)
            if u is None:
                return
            u.committed_requests = u.committed_requests.sub(
                req.request.scale(req.chip_count))
            u.committed_limits = u.committed_limits.sub(
                req.limit.scale(req.chip_count))
            u.committed_workers = max(0, u.committed_workers - 1)

    def adjust(self, namespace: str, delta_request: ResourceAmount,
               delta_limit: ResourceAmount) -> None:
        """Apply a live vertical-resize delta to committed usage."""
        with self._lock:
            u = self._ns.setdefault(namespace, _NsUsage())
            u.committed_requests = u.committed_requests.add(delta_request)
            u.committed_limits = u.committed_limits.add(delta_limit)

    # -- reconcile / sync -------------------------------------------------

    def reconcile(self, committed: List[AllocRequest]) -> None:
        """Rebuild committed usage from live allocations (restart recovery,
        ReconcileQuotaStore analog)."""
        with self._lock:
            for u in self._ns.values():
                u.committed_requests = ResourceAmount()
                u.committed_limits = ResourceAmount()
                u.committed_workers = 0
                u.assumed_requests = ResourceAmount()
                u.assumed_limits = ResourceAmount()
                u.assumed_workers = 0
            for req in committed:
                self.commit(req, was_assumed=False)

    def pressure(self) -> Dict[str, Dict[str, float]]:
        """Per-namespace quota pressure for observability + alerting
        (the role of ``alertThresholdPercent`` on
        ``gpuresourcequota_types.go:26-131``, which the reference's alert
        pipeline evaluates): per-resource used/cap percentages, the peak
        across resources, the quota's configured threshold, and a
        pre-evaluated ``over_threshold`` flag — so one static alert rule
        honors each namespace's own configured percent."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for ns, u in self._ns.items():
                if u.quota is None:
                    continue
                total = u.quota.spec.total
                ratios: Dict[str, float] = {}
                for attr in ("tflops", "hbm_bytes"):
                    cap = getattr(total.requests, attr)
                    if cap <= 0:
                        continue
                    used = (getattr(u.committed_requests, attr)
                            + getattr(u.assumed_requests, attr))
                    ratios[f"{attr}_used_pct"] = 100.0 * used / cap
                if total.max_workers > 0:
                    ratios["workers_used_pct"] = 100.0 * (
                        u.committed_workers + u.assumed_workers) \
                        / total.max_workers
                if not ratios:
                    continue
                peak = max(ratios.values())
                threshold = total.alert_threshold_percent
                out[ns] = dict(
                    ratios, pressure_pct=peak, threshold_pct=threshold,
                    over_threshold=1.0 if peak >= threshold else 0.0)
        return out

    def sync_to_store(self) -> None:
        """Write usage into TPUResourceQuota.status (SyncQuotasToK8s analog)."""
        if self.store is None:
            return
        with self._lock:
            items = [(ns, u) for ns, u in self._ns.items()
                     if u.quota is not None]
        for ns, u in items:
            obj = self.store.try_get(TPUResourceQuota,
                                     u.quota.metadata.name, ns)
            if obj is None:
                continue
            obj = obj.thaw()
            obj.status.used_requests = u.committed_requests
            obj.status.used_limits = u.committed_limits
            obj.status.used_workers = u.committed_workers
            try:
                # version-checked status patch: a concurrent quota spec
                # edit must win; the next periodic sync rewrites usage
                self.store.update(obj, check_version=True)
            except ConflictError:
                continue
