"""Worker controller: worker lifecycle + the metering hot loop.

The port's copy of tensorfusion_tpu/hypervisor/worker.py: worker tracking
from backend events, a shm segment per soft worker, a sync loop with
heartbeats and memory sync, orphaned-segment cleanup, and the ERL update
loop.  Each tick samples per-process duty and memory from the provider
(NVML's on the card), feeds the pure ERL PID controller, and pushes the
resulting refill rates into each worker's token buckets.  Each soft
worker runs with the launch and memory hook (``csrc/cuda_hook.c``) in its
``LD_PRELOAD``, which charges its launches in device time against those
buckets whether or not it uses the client runtime.  Where the device time
charged on a card exceeds the time the card was busy (tenants that
time-slice it each pay for the slices they waited through), each charged
worker's refill is raised by its part of the excess; where the provider
cannot tell a process's duty, the ERL reads each worker's from its
charges.  A frozen worker stays out of the ERL's step: the charges the
limiter refuses it while frozen are not hunger, and its refill and
capacity stay as they were until it resumes.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import constants
from ..clock import Clock, default_clock
from . import _build
from .allocation import AllocationController, WorkerAllocation
from .device import DeviceController
from .erl import AutoFreezeRule, ERLParameters, ERLQuotaController, Observation
from .framework import WorkerSpec, WorkerStatus
from .limiter_binding import (DeviceQuota, Limiter, LimiterError, ShmView, hook_side_file,
                              list_worker_segments)

log = logging.getLogger("tpf.hypervisor.worker")

# smoothing of a card's charged and busy shares, a tick at a time
OVERLAP_ALPHA = 0.1
# a worker charged less than this part of its card's charges has no part
# of the excess
OVERLAP_PAYING_FLOOR = 0.01


@dataclass
class _CardCharges:
    """One card's smoothed shares (device-seconds a second): the time the
    card was busy (NVML's duty) and each soft worker-device's charges."""

    busy: float = 0.0
    charged: Dict[tuple, float] = field(default_factory=dict)


@dataclass
class TrackedWorker:
    spec: WorkerSpec
    allocation: WorkerAllocation
    status: WorkerStatus = field(default_factory=WorkerStatus)
    shm_path: str = ""
    view: Optional[ShmView] = None
    last_blocked: Dict[int, int] = field(default_factory=dict)
    last_charged: Dict[int, int] = field(default_factory=dict)
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
        # keys being torn down by remove_worker (still in _workers)
        # guarded by: _lock
        self._removing: set = set()
        # held by a whole tick and by a freeze or resume, so that a tick
        # which read a worker as running cannot push its quota after the
        # worker was frozen
        self._tick_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_tick = self.clock.monotonic()
        # guarded by: the tick's caller (one thread)
        self._cards: Dict[str, _CardCharges] = {}
        #: (time.monotonic() at its end, host ms) of the loop's last ticks
        self.tick_samples = collections.deque(maxlen=4096)
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
            t0 = time.perf_counter()
            try:
                self.tick()
            except Exception:
                log.exception("worker sync tick failed")
            self.tick_samples.append((time.monotonic(),
                                      (time.perf_counter() - t0) * 1e3))

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
        """Tear a worker down.  It leaves the controller's map (``get``,
        ``list`` and the API's worker list) only once its segment is gone,
        so that a reader that no longer sees the worker finds no segment
        of it either."""
        with self._lock:
            tracked = self._workers.get(worker_key)
            if tracked is None or worker_key in self._removing:
                return
            self._removing.add(worker_key)
        try:
            if tracked.view is not None:
                tracked.view.close()
            if tracked.shm_path:
                try:
                    ns, pod = worker_key.split("/", 1)
                    self.limiter.remove_worker(ns, pod)
                except LimiterError:
                    log.warning("shm segment for %s already gone", worker_key)
                _unlink_side_file(tracked.shm_path)
            self.erl.forget(worker_key)
            for card in self._cards.values():
                for key in [k for k in card.charged if k[0] == worker_key]:
                    del card.charged[key]
            self.allocator.release(worker_key)
        finally:
            with self._lock:
                if self._workers.get(worker_key) is tracked:
                    del self._workers[worker_key]
                self._removing.discard(worker_key)
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
        self._inject_mandatory_metering(tracked)
        # last: a reader of the worker list that sees the segment's path
        # sees the whole env
        tracked.status.env[constants.ENV_SHM_PATH] = tracked.shm_path

    def _inject_mandatory_metering(self, tracked: TrackedWorker) -> None:
        """Preload the launch and memory hook into the worker, so that an
        unmodified CUDA process is metered: it charges each launch's
        device time at the card's peak (the unit of the refill above) and
        the device memory it allocates, against the worker's segment.
        The client runtime stays the path of a process without the hook,
        and does not charge twice in one with it (the reference points
        PJRT's plugin discovery at its interception proxy instead)."""
        env = tracked.status.env
        # absolute paths: the worker process may run with any cwd
        env[constants.ENV_LIMITER_LIB] = os.path.abspath(self.limiter.lib_path)
        binding = tracked.allocation.bindings[0] if tracked.allocation.bindings else None
        entry = self.devices.get(binding.chip_id) if binding else None
        env[constants.ENV_DEVICE_INDEX] = str(binding.device_index if binding else 0)
        env[constants.ENV_PEAK_MFLOPS] = repr(
            entry.info.peak_bf16_tflops * 1e6 if entry else 1e6)
        hook = str(_build.cuda_hook_path())
        preload = tracked.spec.env.get(constants.ENV_LD_PRELOAD,
                                       os.environ.get(constants.ENV_LD_PRELOAD, ""))
        env[constants.ENV_LD_PRELOAD] = ":".join(filter(None, (hook, preload)))
        # cooperative clients reconcile actual buffer churn periodically
        env.setdefault(constants.ENV_LIVE_HBM_INTERVAL, "10")

    # -- hot loop ---------------------------------------------------------

    def tick(self) -> None:
        with self._tick_lock:
            self._tick()

    def _tick(self) -> None:
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
        # per card: each soft worker-device's charged share this tick
        charged: Dict[str, Dict[tuple, float]] = {}
        peaks: Dict[str, float] = {}
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
            frozen = w.status.frozen or bool(shm_state and shm_state.frozen)

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
                    mflop = 0
                    if shm_state:
                        for d in shm_state.devices:
                            if d.chip_id == b.chip_id:
                                prev = w.last_blocked.get(b.device_index, 0)
                                blocked = max(0, d.blocked_events - prev)
                                w.last_blocked[b.device_index] = \
                                    d.blocked_events
                                mflop = max(0, d.total_charged_mflop - w.last_charged.get(
                                    b.device_index, 0))
                                w.last_charged[b.device_index] = d.total_charged_mflop
                    charged.setdefault(b.chip_id, {})[
                        (w.spec.key, b.device_index)] = mflop / peak / dt
                    peaks[b.chip_id] = peak
                    if not frozen:
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

        # 2. Drive the ERL PID controller and push refill rates, each raised
        # by the worker's part of its card's overcharge.
        extra, charged_duty = self._card_shares(charged, peaks)
        for ob in observations:
            ob.measured_duty_pct = charged_duty.get((ob.worker_key, ob.device_index),
                                                    ob.measured_duty_pct)
        for up in self.erl.step(observations, dt):
            ns, pod = up.worker_key.split("/", 1)
            refill, capacity = up.refill_mflop_per_s, up.capacity_mflop
            more = extra.get((up.worker_key, up.device_index), 0.0)
            if more > 0:
                capacity = int(capacity * (refill + more) / refill)
                refill = int(refill + more)
            try:
                self.limiter.update_quota(ns, pod, up.device_index,
                                          up.duty_limit_bp, refill, capacity)
            except LimiterError:
                log.warning("quota push failed for %s", up.worker_key)

        self._cleanup_orphan_shm()

    def _card_shares(self, charged: Dict[str, Dict[tuple, float]],
                     peaks: Dict[str, float]) -> tuple:
        """From each card's charged shares this tick: the MFLOP/s to add to
        each soft worker-device's refill, and the duty % to give the ERL
        for it where the provider cannot tell a process's duty.

        The refill: the launch hook charges the span of event windows on a
        worker's streams, and a window spans the slices in which the card
        ran another context, so tenants that time-slice a card each pay for
        the time they waited, and their buckets would hold the card idle.
        The excess of the smoothed charges over NVML's smoothed duty is
        split equally among the workers charged on the card: under
        round-robin slicing two tenants each pay for the whole overlap and
        each is given half of it, so the excess is exactly what each
        overpays.  Charges below the card's busy time (the client's FLOP
        estimates, a lone tenant) add nothing.

        The duty: where NVML's per-process utilization is unsupported, each
        worker's smoothed charged share, the time it had work on the card.
        The ERL counts a worker that uses most of its grant as hungry; read
        as 0, a tenant slowed by the other's slices but not by its bucket
        would count as idle and its share would go to the other."""
        extra: Dict[tuple, float] = {}
        duty: Dict[tuple, float] = {}
        cards = [chip for chip, by in charged.items()
                 if chip in self._cards or any(by.values())]
        if not cards:
            return extra, duty
        self.devices.refresh_metrics()
        for chip in cards:
            entry = self.devices.get(chip)
            metrics = entry.metrics if entry is not None else None
            busy = metrics.duty_cycle_pct / 100.0 if metrics is not None else 0.0
            if busy <= 0.0:          # no reading: nothing to compare with
                continue
            card = self._cards.setdefault(chip, _CardCharges())
            card.busy += OVERLAP_ALPHA * (busy - card.busy)
            for key, share in charged[chip].items():
                last = card.charged.get(key, 0.0)
                card.charged[key] = last + OVERLAP_ALPHA * (share - last)
            total = sum(card.charged.values())
            paying = [k for k, v in card.charged.items()
                      if v > OVERLAP_PAYING_FLOOR * total]
            excess = total - card.busy
            if excess > 0 and paying:
                for key in paying:
                    extra[key] = excess / len(paying) * peaks[chip]
            if metrics.extra.get("proc_util_supported", 1.0) == 0.0:
                for key in charged[chip]:
                    duty[key] = min(100.0, card.charged[key] * 100.0)
        return extra, duty

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
        with self._tick_lock:
            try:
                self.limiter.set_frozen(ns, pod, False, auto_freeze=True)
                self.limiter.set_frozen(ns, pod, False, auto_freeze=False)
            except LimiterError:
                pass
            w.auto_frozen = False
            w.status.frozen = False
            w.last_active_ts = self.clock.now()

    def freeze_worker(self, worker_key: str) -> None:
        """Freeze between two ticks: once this returns, no tick moves the
        worker's bucket until it resumes."""
        ns, pod = worker_key.split("/", 1)
        with self._tick_lock:
            self.limiter.set_frozen(ns, pod, True, auto_freeze=False)
            w = self.get(worker_key)
            if w is not None:
                w.status.frozen = True

    # -- orphan cleanup (controller.go:425-484 analog) --------------------

    def _cleanup_orphan_shm(self) -> None:
        """Remove the segments no tracked worker owns.  The directory is
        listed before the map is read: a worker enters the map before its
        segment is made, so every segment of the listing whose worker is
        being added is known by then.  Read the other way round, a segment
        made between the two reads was taken for an orphan."""
        segments = list_worker_segments(self.shm_base)
        with self._lock:
            known = {w.shm_path for w in self._workers.values() if w.shm_path}
        for ns, pod, path in segments:
            if path not in known:
                try:
                    self.limiter.remove_worker(ns, pod)
                    log.info("cleaned orphan shm %s", path)
                except LimiterError:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                _unlink_side_file(path)


def _unlink_side_file(shm_path: str) -> None:
    """Remove the launch hook's side file of a segment, if it made one."""
    try:
        os.unlink(hook_side_file(shm_path))
    except FileNotFoundError:
        pass
