"""Worker controller: worker lifecycle + the metering hot loop.

The port's copy of tensorfusion_tpu/hypervisor/worker.py: worker tracking
from backend events, a shm segment per soft worker, a sync loop with
heartbeats and memory sync, orphaned-segment cleanup, and the ERL update
loop.  Each tick samples per-process duty and memory from the provider
(NVML's on the card), feeds the pure ERL PID controller, and pushes the
resulting refill rates into each worker's token buckets.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import constants
from ..clock import Clock, default_clock
from .allocation import AllocationController, WorkerAllocation
from .device import DeviceController
from .erl import AutoFreezeRule, ERLParameters, ERLQuotaController, Observation
from .framework import WorkerSpec, WorkerStatus
from .limiter_binding import (DeviceQuota, Limiter, LimiterError, ShmView,
                              list_worker_segments)

log = logging.getLogger("tpf.hypervisor.worker")


@dataclass
class TrackedWorker:
    spec: WorkerSpec
    allocation: WorkerAllocation
    status: WorkerStatus = field(default_factory=WorkerStatus)
    shm_path: str = ""
    view: Optional[ShmView] = None
    last_blocked: Dict[int, int] = field(default_factory=dict)
    last_active_ts: float = 0.0    # stamped by WorkerController's clock
    auto_frozen: bool = False


class WorkerController:
    def __init__(self, devices: DeviceController,
                 allocator: AllocationController,
                 limiter: Limiter,
                 shm_base: str,
                 erl_params: Optional[ERLParameters] = None,
                 qos_coeffs: Optional[Dict[str, float]] = None,
                 auto_freeze_rules: Optional[List[AutoFreezeRule]] = None,
                 tick_interval_s: float = 0.1,
                 clock: Optional[Clock] = None):
        self.clock = clock or default_clock()
        self.devices = devices
        self.allocator = allocator
        self.limiter = limiter
        self.shm_base = shm_base
        self.erl = ERLQuotaController(erl_params, qos_coeffs)
        self.auto_freeze_rules = {r.qos: r for r in (auto_freeze_rules or [])}
        self.tick_interval_s = tick_interval_s
        self._lock = threading.RLock()
        # guarded by: _lock
        self._workers: Dict[str, TrackedWorker] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_tick = self.clock.monotonic()
        self.limiter.init(shm_base)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        name="tpf-worker-sync", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_interval_s):
            try:
                self.tick()
            except Exception:
                log.exception("worker sync tick failed")

    # -- worker lifecycle (backend event handlers) ------------------------

    def add_worker(self, spec: WorkerSpec) -> TrackedWorker:
        # Check-and-insert atomically so concurrent adds of the same key
        # can't both allocate, and so the tracked worker (with its shm path)
        # is visible to the sync loop's orphan cleanup *before* the segment
        # exists.
        tracked = TrackedWorker(spec=spec,
                                allocation=WorkerAllocation(spec=spec),
                                last_active_ts=self.clock.now())
        tracked.shm_path = (
            os.path.join(self.shm_base, spec.namespace, spec.name)
            if spec.isolation == constants.ISOLATION_SOFT else "")
        with self._lock:
            if spec.key in self._workers:
                return self._workers[spec.key]
            self._workers[spec.key] = tracked
        try:
            allocation = self.allocator.allocate(spec)
            tracked.allocation = allocation
            tracked.status.phase = constants.PHASE_RUNNING
            tracked.status.chip_ids = [b.chip_id for b in allocation.bindings]
            tracked.status.partition_ids = {
                b.chip_id: b.grant.partition_id
                for b in allocation.bindings if b.grant is not None}
            tracked.status.env = allocation.env
            tracked.status.started_at = self.clock.now()
            if spec.isolation == constants.ISOLATION_SOFT:
                self._ensure_soft_shm(tracked)
        except Exception:
            with self._lock:
                self._workers.pop(spec.key, None)
            raise
        log.info("worker %s added (isolation=%s, chips=%s)", spec.key,
                 spec.isolation, tracked.status.chip_ids)
        return tracked

    def remove_worker(self, worker_key: str) -> None:
        with self._lock:
            tracked = self._workers.pop(worker_key, None)
        if tracked is None:
            return
        if tracked.view is not None:
            tracked.view.close()
        if tracked.shm_path:
            try:
                ns, pod = worker_key.split("/", 1)
                self.limiter.remove_worker(ns, pod)
            except LimiterError:
                log.warning("shm segment for %s already gone", worker_key)
        self.erl.forget(worker_key)
        self.allocator.release(worker_key)
        log.info("worker %s removed", worker_key)

    def get(self, worker_key: str) -> Optional[TrackedWorker]:
        with self._lock:
            return self._workers.get(worker_key)

    def list(self) -> List[TrackedWorker]:
        with self._lock:
            return list(self._workers.values())

    def all_pids(self) -> set:
        """Host PIDs of every tracked worker — the 'ours' set the backend
        subtracts when detecting chips used by a foreign runtime."""
        with self._lock:
            return {pid for w in self._workers.values()
                    for pid in w.status.pids}

    def register_pid(self, worker_key: str, host_pid: int) -> None:
        with self._lock:
            w = self._workers.get(worker_key)
            if w is not None and host_pid not in w.status.pids:
                w.status.pids.append(host_pid)
        # Only soft-isolation workers have an shm segment to register in.
        if w is not None and w.shm_path:
            ns, pod = worker_key.split("/", 1)
            self.limiter.register_pid(ns, pod, host_pid)

    # -- soft-mode shm (controller.go:552 analog) -------------------------

    def _ensure_soft_shm(self, tracked: TrackedWorker) -> None:
        spec = tracked.spec
        quotas = []
        for b in tracked.allocation.bindings:
            entry = self.devices.get(b.chip_id)
            peak_mflops = (entry.info.peak_bf16_tflops * 1e6
                           if entry else 1e6)
            share = b.duty_percent / 100.0
            refill = int(share * peak_mflops)
            cap = int(refill * self.erl.params.burst_window_seconds) or 1
            quotas.append(DeviceQuota(
                device_index=b.device_index, chip_id=b.chip_id,
                duty_limit_bp=int(b.duty_percent * 100),
                hbm_limit_bytes=b.hbm_bytes,
                capacity_mflop=cap, refill_mflop_per_s=refill))
        self.limiter.create_worker(spec.namespace, spec.name, quotas)
        tracked.shm_path = os.path.join(self.shm_base, spec.namespace,
                                        spec.name)
        tracked.view = ShmView(tracked.shm_path)
        tracked.status.env[constants.ENV_SHM_PATH] = tracked.shm_path
        self._inject_mandatory_metering(tracked.status.env)

    def _inject_mandatory_metering(self, env: Dict[str, str]) -> None:
        """Point the worker's client runtime at this node's limiter.  The
        reference also points an unmodified JAX process's PJRT plugin at
        its interception proxy; CUDA has no such proxy until the
        cuLaunchKernel / cuMemAlloc interception is ported, so a worker
        is metered only through the client runtime."""
        # absolute path: the worker process may run with any cwd
        env[constants.ENV_LIMITER_LIB] = os.path.abspath(self.limiter.lib_path)

    # -- hot loop ---------------------------------------------------------

    def tick(self) -> None:
        now = self.clock.monotonic()
        dt = max(now - self._last_tick, 1e-3)
        self._last_tick = now

        with self._lock:
            workers = list(self._workers.values())
        if not workers:
            self._cleanup_orphan_shm()
            return

        # 1. Sample per-process stats once.
        try:
            stats = self.devices.proc_stats()
        except Exception:
            log.exception("proc stats unavailable")
            stats = []
        by_pid_chip: Dict[tuple, float] = {}
        hbm_by_pid_chip: Dict[tuple, int] = {}
        for s in stats:
            by_pid_chip[(s.pid, s.chip_id)] = s.duty_cycle_pct
            hbm_by_pid_chip[(s.pid, s.chip_id)] = s.hbm_used_bytes

        observations: List[Observation] = []
        ts = int(self.clock.now())
        for w in workers:
            ns, pod = w.spec.namespace, w.spec.name
            shm_state = None
            if w.view is not None:
                try:
                    shm_state = w.view.read()
                except (ValueError, OSError):
                    log.warning("unreadable shm for %s", w.spec.key)
            pids = list(shm_state.pids) if shm_state else w.status.pids

            total_duty = 0.0
            total_hbm = 0
            for b in w.allocation.bindings:
                duty = sum(by_pid_chip.get((pid, b.chip_id), 0.0)
                           for pid in pids)
                hbm = sum(hbm_by_pid_chip.get((pid, b.chip_id), 0)
                          for pid in pids)
                total_duty += duty
                total_hbm += hbm
                if w.spec.isolation == constants.ISOLATION_SOFT:
                    entry = self.devices.get(b.chip_id)
                    peak = (entry.info.peak_bf16_tflops * 1e6
                            if entry else 1e6)
                    blocked = 0
                    if shm_state:
                        for d in shm_state.devices:
                            if d.chip_id == b.chip_id:
                                prev = w.last_blocked.get(b.device_index, 0)
                                blocked = max(0, d.blocked_events - prev)
                                w.last_blocked[b.device_index] = \
                                    d.blocked_events
                    observations.append(Observation(
                        worker_key=w.spec.key,
                        device_index=b.device_index,
                        chip_id=b.chip_id,
                        quota_duty_bp=int(b.duty_percent * 100),
                        peak_mflops_per_s=peak,
                        measured_duty_pct=duty,
                        blocked_delta=blocked,
                        qos=w.spec.qos))
                    try:
                        self.limiter.set_pod_hbm_used(ns, pod,
                                                      b.device_index, hbm)
                    except LimiterError:
                        pass
            w.status.duty_cycle_pct = total_duty
            w.status.hbm_used_bytes = total_hbm
            if total_duty > 0.5:
                w.last_active_ts = self.clock.now()

            if w.spec.isolation == constants.ISOLATION_SOFT:
                try:
                    self.limiter.heartbeat(ns, pod, ts)
                except LimiterError:
                    pass
            self._maybe_auto_freeze(w)

        # 2. Drive the ERL PID controller and push refill rates.
        for up in self.erl.step(observations, dt):
            ns, pod = up.worker_key.split("/", 1)
            try:
                self.limiter.update_quota(ns, pod, up.device_index,
                                          up.duty_limit_bp,
                                          up.refill_mflop_per_s,
                                          up.capacity_mflop)
            except LimiterError:
                log.warning("quota push failed for %s", up.worker_key)

        self._cleanup_orphan_shm()

    # -- auto freeze/resume (schedulingconfigtemplate auto-freeze analog) -

    def _maybe_auto_freeze(self, w: TrackedWorker) -> None:
        rule = self.auto_freeze_rules.get(w.spec.qos)
        if rule is None or not rule.enabled:
            return
        if w.spec.isolation != constants.ISOLATION_SOFT:
            return
        idle = self.clock.now() - w.last_active_ts
        ns, pod = w.spec.namespace, w.spec.name
        if not w.auto_frozen and idle > rule.freeze_to_mem_ttl_seconds:
            try:
                self.limiter.set_frozen(ns, pod, True, auto_freeze=True)
                w.auto_frozen = True
                w.status.frozen = True
                log.info("auto-froze idle worker %s (%.0fs idle)",
                         w.spec.key, idle)
            except LimiterError:
                pass

    def resume_worker(self, worker_key: str) -> None:
        w = self.get(worker_key)
        if w is None:
            return
        ns, pod = worker_key.split("/", 1)
        try:
            self.limiter.set_frozen(ns, pod, False, auto_freeze=True)
            self.limiter.set_frozen(ns, pod, False, auto_freeze=False)
        except LimiterError:
            pass
        w.auto_frozen = False
        w.status.frozen = False
        w.last_active_ts = self.clock.now()

    def freeze_worker(self, worker_key: str) -> None:
        ns, pod = worker_key.split("/", 1)
        self.limiter.set_frozen(ns, pod, True, auto_freeze=False)
        w = self.get(worker_key)
        if w is not None:
            w.status.frozen = True

    # -- orphan cleanup (controller.go:425-484 analog) --------------------

    def _cleanup_orphan_shm(self) -> None:
        with self._lock:
            known = {w.shm_path for w in self._workers.values() if w.shm_path}
        for ns, pod, path in list_worker_segments(self.shm_base):
            if path not in known:
                try:
                    self.limiter.remove_worker(ns, pod)
                    log.info("cleaned orphan shm %s", path)
                except LimiterError:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
