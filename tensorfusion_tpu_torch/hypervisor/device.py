"""Device controller: provider discovery, registry, partition ops.

The port's copy of tensorfusion_tpu/hypervisor/device.py: a discovery loop
over the provider library, the device registry, partition splits and
``NodeInfo`` aggregation.  With the NVML provider a chip is a card, its
mesh coordinate its NVML index, and a partition the whole card.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .provider_binding import (ChipInfo, ChipMetrics, PartitionGrant,
                               ProcStats, Provider, Topology)

log = logging.getLogger("tpf.hypervisor.device")


@dataclass
class DeviceEntry:
    info: ChipInfo
    metrics: Optional[ChipMetrics] = None
    partitions: Dict[str, PartitionGrant] = field(default_factory=dict)


@dataclass
class NodeInfo:
    chip_count: int = 0
    generations: List[str] = field(default_factory=list)
    total_hbm_bytes: int = 0
    total_bf16_tflops: float = 0.0
    slice_ids: List[str] = field(default_factory=list)
    mesh_shape: tuple = (1, 1, 1)


class DeviceController:
    def __init__(self, provider: Provider,
                 discovery_interval_s: float = 12 * 3600):
        self.provider = provider
        self.discovery_interval_s = discovery_interval_s
        self._lock = threading.RLock()
        # guarded by: _lock
        self._devices: Dict[str, DeviceEntry] = {}
        # guarded by: _lock
        self._topology: Optional[Topology] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self.provider.init()
        self.discover()
        self._thread = threading.Thread(target=self._loop,
                                        name="tpf-device-discovery",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self.provider.shutdown()

    def _loop(self) -> None:
        while not self._stop.wait(self.discovery_interval_s):
            try:
                self.discover()
            except Exception:
                log.exception("device discovery failed")

    # -- discovery --------------------------------------------------------

    def discover(self) -> None:
        chips = self.provider.enumerate()
        topo = self.provider.topology()
        with self._lock:
            seen = set()
            for c in chips:
                seen.add(c.chip_id)
                entry = self._devices.get(c.chip_id)
                if entry is None:
                    self._devices[c.chip_id] = DeviceEntry(info=c)
                    log.info("discovered chip %s (%s, %d cores, %.0f GiB)",
                             c.chip_id, c.generation, c.core_count,
                             c.hbm_bytes / 2**30)
                else:
                    entry.info = c
            for gone in set(self._devices) - seen:
                log.warning("chip %s disappeared", gone)
                del self._devices[gone]
            self._topology = topo

    def refresh_metrics(self) -> None:
        with self._lock:
            ids = list(self._devices)
        if not ids:
            return
        metrics = self.provider.chip_metrics(ids)
        with self._lock:
            for m in metrics:
                if m.chip_id in self._devices:
                    self._devices[m.chip_id].metrics = m

    def proc_stats(self) -> List[ProcStats]:
        return self.provider.proc_stats()

    # -- registry ---------------------------------------------------------

    def devices(self) -> List[DeviceEntry]:
        with self._lock:
            return list(self._devices.values())

    def get(self, chip_id: str) -> Optional[DeviceEntry]:
        with self._lock:
            return self._devices.get(chip_id)

    def topology(self) -> Optional[Topology]:
        with self._lock:
            return self._topology

    def node_info(self) -> NodeInfo:
        with self._lock:
            entries = list(self._devices.values())
            topo = self._topology
        info = NodeInfo(chip_count=len(entries))
        gens, slices = set(), set()
        for e in entries:
            gens.add(e.info.generation)
            slices.add(e.info.slice_id)
            info.total_hbm_bytes += e.info.hbm_bytes
            info.total_bf16_tflops += e.info.peak_bf16_tflops
        info.generations = sorted(gens)
        info.slice_ids = sorted(slices)
        if topo:
            info.mesh_shape = topo.mesh_shape
        return info

    # -- partitioning (SplitDevice analog, controller.go:329-415) ---------

    def split_device(self, chip_id: str, template_id: str) -> PartitionGrant:
        grant = self.provider.partition_create(template_id, chip_id)
        with self._lock:
            entry = self._devices.get(chip_id)
            if entry is not None:
                entry.partitions[grant.partition_id] = grant
        log.info("created partition %s on %s (template %s)",
                 grant.partition_id, chip_id, template_id)
        return grant

    def remove_partition(self, chip_id: str, partition_id: str) -> None:
        self.provider.partition_destroy(partition_id, chip_id)
        with self._lock:
            entry = self._devices.get(chip_id)
            if entry is not None:
                entry.partitions.pop(partition_id, None)
        log.info("removed partition %s from %s", partition_id, chip_id)

    def partition_templates(self, chip_id: str):
        return self.provider.partition_templates(chip_id)
