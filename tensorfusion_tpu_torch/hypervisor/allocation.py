"""Worker allocation controller: worker -> device binding.

The port's copy of tensorfusion_tpu/hypervisor/allocation.py: device
binding with partition splits and their rollback, recovery of partitioned
workers after a restart, and the worker's env.  The one device-specific
change is the visible-device env: ``CUDA_VISIBLE_DEVICES`` (the bound host
indices) with ``CUDA_DEVICE_ORDER=PCI_BUS_ID``, where the reference sets
``TPU_VISIBLE_CHIPS``.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import constants
from .device import DeviceController
from .framework import WorkerSpec
from .provider_binding import PartitionGrant, ProviderError

log = logging.getLogger("tpf.hypervisor.alloc")


class AllocationError(RuntimeError):
    pass


@dataclass
class DeviceBinding:
    chip_id: str
    device_index: int              # shm slot index
    duty_percent: float
    hbm_bytes: int
    host_index: int = -1           # chip's index on this host
    grant: Optional[PartitionGrant] = None
    #: budget beyond the chip's physical HBM (pool host-expansion): the
    #: client runtime must host-offload at least this much
    host_spill_bytes: int = 0


@dataclass
class WorkerAllocation:
    spec: WorkerSpec
    bindings: List[DeviceBinding] = field(default_factory=list)
    mounts: List[str] = field(default_factory=list)   # mount-policy result

    @property
    def env(self) -> Dict[str, str]:
        env: Dict[str, str] = {}
        chip_ids, host_indices = [], []
        for b in self.bindings:
            if b.grant is not None:
                env.update(b.grant.env)
            chip_ids.append(b.chip_id)
            if b.host_index >= 0:
                host_indices.append(str(b.host_index))
        env[constants.ENV_CHIP_IDS] = ",".join(chip_ids)
        # Restrict CUDA to the allocated cards by host index, in NVML's
        # (PCI bus) order rather than CUDA's fastest-first default, which
        # disagree on a mixed host; a partition grant's
        # CUDA_VISIBLE_DEVICES=<UUID> overrides the indices.
        env.setdefault(constants.ENV_VISIBLE_DEVICES, ",".join(host_indices))
        env.setdefault(constants.ENV_DEVICE_ORDER, constants.DEVICE_ORDER_PCI)
        env[constants.ENV_ISOLATION] = self.spec.isolation
        if self.mounts:
            env[constants.ENV_DEVICE_MOUNTS] = ",".join(self.mounts)
        spill = sum(b.host_spill_bytes for b in self.bindings)
        if spill > 0:
            # host-expansion in play: the client runtime must offload at
            # least this much of its budget to host RAM/disk
            env[constants.ENV_HBM_HOST_SPILL] = str(spill)
        return env


class AllocationController:
    def __init__(self, devices: DeviceController, mount_policy=None):
        from .mounts import DeviceMountPolicy

        self.devices = devices
        self.mount_policy = mount_policy or DeviceMountPolicy(
            DeviceMountPolicy.default_rules())
        self._lock = threading.RLock()
        # guarded by: _lock
        self._allocations: Dict[str, WorkerAllocation] = {}

    # -- binding ----------------------------------------------------------

    def allocate(self, spec: WorkerSpec) -> WorkerAllocation:
        """Bind a worker's device requests to concrete chips.  Partition
        splits are rolled back as a unit on mid-flight failure
        (allocation.go:46-191 analog)."""
        with self._lock:
            if spec.key in self._allocations:
                return self._allocations[spec.key]
            alloc = WorkerAllocation(spec=spec)
            created: List[DeviceBinding] = []
            try:
                for idx, req in enumerate(spec.devices):
                    chip_id = req.chip_id or self._pick_chip(created)
                    entry = self.devices.get(chip_id)
                    if entry is None:
                        raise AllocationError(f"unknown chip {chip_id}")
                    binding = DeviceBinding(
                        chip_id=chip_id, device_index=idx,
                        duty_percent=req.duty_percent,
                        hbm_bytes=req.hbm_bytes,
                        host_index=entry.info.host_index,
                        host_spill_bytes=max(
                            0, req.hbm_bytes - entry.info.hbm_bytes))
                    if spec.isolation == constants.ISOLATION_PARTITIONED:
                        if not req.partition_template:
                            raise AllocationError(
                                f"{spec.key}: partitioned worker without a "
                                "partition template")
                        binding.grant = self.devices.split_device(
                            chip_id, req.partition_template)
                    elif spec.isolation == constants.ISOLATION_HARD:
                        # One-shot provider caps (allocation at worker start).
                        self.devices.provider.set_hbm_hard_limit(
                            chip_id, req.hbm_bytes)
                        self.devices.provider.set_duty_hard_limit(
                            chip_id, int(req.duty_percent))
                    created.append(binding)
                alloc.bindings = created
                alloc.mounts = self.mount_policy.mounts_for(spec, created)
                self._allocations[spec.key] = alloc
                return alloc
            except Exception:
                # Roll back partition splits already made for this worker.
                for b in created:
                    if b.grant is not None:
                        try:
                            self.devices.remove_partition(
                                b.chip_id, b.grant.partition_id)
                        except ProviderError:
                            log.exception("rollback of partition %s failed",
                                          b.grant.partition_id)
                raise

    def release(self, worker_key: str) -> None:
        with self._lock:
            alloc = self._allocations.pop(worker_key, None)
        if alloc is None:
            return
        for b in alloc.bindings:
            if b.grant is not None:
                try:
                    self.devices.remove_partition(b.chip_id,
                                                  b.grant.partition_id)
                except ProviderError:
                    log.exception("failed to remove partition %s",
                                  b.grant.partition_id)
            elif alloc.spec.isolation == constants.ISOLATION_HARD:
                # Clear the one-shot provider caps (0 / 100 = unlimited).
                try:
                    self.devices.provider.set_hbm_hard_limit(b.chip_id, 0)
                    self.devices.provider.set_duty_hard_limit(b.chip_id, 100)
                except ProviderError:
                    log.exception("failed to clear hard limits on %s",
                                  b.chip_id)

    def get(self, worker_key: str) -> Optional[WorkerAllocation]:
        with self._lock:
            return self._allocations.get(worker_key)

    def list(self) -> List[WorkerAllocation]:
        with self._lock:
            return list(self._allocations.values())

    # -- restart recovery (allocation.go:223-273 analog) ------------------

    def recover(self, spec: WorkerSpec,
                partition_ids: Dict[str, str]) -> WorkerAllocation:
        """Re-adopt a worker that survived a hypervisor restart: partitions
        already exist on the devices; rebuild the in-memory binding without
        re-splitting."""
        with self._lock:
            alloc = WorkerAllocation(spec=spec)
            for idx, req in enumerate(spec.devices):
                chip_id = req.chip_id
                entry = self.devices.get(chip_id)
                binding = DeviceBinding(
                    chip_id=chip_id, device_index=idx,
                    duty_percent=req.duty_percent,
                    hbm_bytes=req.hbm_bytes,
                    host_index=(entry.info.host_index if entry is not None
                                else -1),
                    host_spill_bytes=max(
                        0, req.hbm_bytes - entry.info.hbm_bytes)
                    if entry is not None else 0)
                part_id = partition_ids.get(chip_id)
                if part_id and entry is not None:
                    grant = entry.partitions.get(part_id)
                    if grant is None:
                        # Device registry lost it (provider restarted too);
                        # re-split.
                        grant = self.devices.split_device(
                            chip_id, req.partition_template)
                    binding.grant = grant
                alloc.bindings.append(binding)
            alloc.mounts = self.mount_policy.mounts_for(spec, alloc.bindings)
            self._allocations[spec.key] = alloc
            return alloc

    # -- helpers ----------------------------------------------------------

    def _pick_chip(self, taken: List[DeviceBinding]) -> str:
        """Least-loaded chip not already bound for this worker."""
        taken_ids = {b.chip_id for b in taken}
        with self._lock:
            load: Dict[str, float] = {}
            for alloc in self._allocations.values():
                for b in alloc.bindings:
                    load[b.chip_id] = load.get(b.chip_id, 0) + b.duty_percent
        best, best_load = None, None
        for entry in self.devices.devices():
            cid = entry.info.chip_id
            if cid in taken_ids:
                continue
            l = load.get(cid, 0.0)
            if best_load is None or l < best_load:
                best, best_load = cid, l
        if best is None:
            raise AllocationError("no chips available")
        return best
