"""Hypervisor framework interfaces: the port's copy of
tensorfusion_tpu/hypervisor/framework.py -- the contracts between the node
agent's controllers (device, allocation, worker, quota) and its pluggable
backend (the single-node process spawner; the control-plane watcher is not
ported yet).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .. import constants


@dataclass
class WorkerDeviceRequest:
    """One device share a worker wants."""

    chip_id: str = ""              # "" = any chip (allocation controller picks)
    duty_percent: float = 100.0    # MXU duty share (soft/hard isolation)
    tflops: float = 0.0            # alternative expression of duty
    hbm_bytes: int = 0
    partition_template: str = ""   # partitioned isolation only


@dataclass
class WorkerSpec:
    """A worker as seen by the hypervisor (one vTPU-consuming pod)."""

    namespace: str = "default"
    name: str = ""
    isolation: str = constants.DEFAULT_ISOLATION
    qos: str = constants.DEFAULT_QOS
    devices: List[WorkerDeviceRequest] = field(default_factory=list)
    command: List[str] = field(default_factory=list)   # single-node backend
    env: Dict[str, str] = field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class WorkerStatus:
    phase: str = constants.PHASE_PENDING
    message: str = ""
    chip_ids: List[str] = field(default_factory=list)
    partition_ids: Dict[str, str] = field(default_factory=dict)  # chip->part
    env: Dict[str, str] = field(default_factory=dict)  # grants for the pod
    pids: List[int] = field(default_factory=list)
    duty_cycle_pct: float = 0.0
    hbm_used_bytes: int = 0
    started_at: float = 0.0
    frozen: bool = False


@dataclass
class ProcessMapping:
    """Identity of a client process (reference: ProcessMappingInfo —
    cgroup-parsed pod identity, framework.go)."""

    host_pid: int = 0
    namespace: str = ""
    pod_name: str = ""
    container: str = ""


class Backend(abc.ABC):
    """Source of worker add/remove events + sink for node/device status."""

    @abc.abstractmethod
    def start(self, on_worker_added: Callable[[WorkerSpec], None],
              on_worker_removed: Callable[[str], None]) -> None:
        ...

    @abc.abstractmethod
    def stop(self) -> None:
        ...

    def publish_device_status(self, devices: List[dict]) -> None:
        """Push device inventory/metrics upstream (control-plane backend
        writes TPUChip status; single-node backend persists to file)."""

    def resolve_process(self, pid: int) -> Optional[ProcessMapping]:
        """Map a host PID to a worker identity (if known)."""
        return None
