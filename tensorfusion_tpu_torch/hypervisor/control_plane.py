"""Control-plane hypervisor backend.

The port's copy of ``tensorfusion_tpu/hypervisor/control_plane.py``.

Analog of the reference's kubernetes backend
(``pkg/hypervisor/backend/kubernetes/``): where that backend watches the
kubelet pod cache and **writes GPU CRs** (capacity, topology, capability
annotations — kubernetes_backend.go:302-447), this backend connects the
node agent to the tpu-fusion control plane:

- on start it publishes the node (Node + TPUNode with the hypervisor URL)
  and every discovered chip as TPUChip objects — capacity, ICI mesh
  coordinates + links, capabilities — which is how chips enter the
  allocator's inventory;
- it watches Pod events and turns pods *bound to this node* with chip-id
  annotations into worker add/remove calls (the pod-cache informer
  analog, pod_cache.go);
- a status loop writes live chip metrics back onto the TPUChip objects.

This closes the platform loop end to end: webhook -> scheduler -> bound
pod -> this backend -> allocation controller -> shm limiter -> client.

What differs from the reference: the vendor comes from the provider's
platform (``nvidia`` for the NVML provider's ``gpu``) instead of a fixed
``mock-tpu``; the default external-use probe marks a chip only for a
process it can map to the chip (:meth:`ControlPlaneBackend.
_probe_external_chips`); and :meth:`ControlPlaneBackend.stop` waits for
its threads.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, List, Optional

from .. import constants
from ..api.resources import ResourceAmount, parse_quantity
from ..api.types import ICILink, MeshCoords, Node, Pod, TPUChip, TPUNode
from ..store import AlreadyExistsError, ConflictError, DELETED, ObjectStore
from .device import DeviceController
from .framework import Backend, ProcessMapping, WorkerDeviceRequest, WorkerSpec

log = logging.getLogger("tpf.hypervisor.control_plane")

#: the vendor a TPUChip names, by the provider's platform; the reference
#: publishes every chip as "mock-tpu"
VENDOR_BY_PLATFORM = {"gpu": constants.VENDOR_NVIDIA}
DEFAULT_VENDOR = "mock-tpu"


def provider_vendor(devices: DeviceController) -> str:
    """The vendor of the provider's chips (the first chip's platform)."""
    chips = devices.devices()
    platform = chips[0].info.platform if chips else ""
    return VENDOR_BY_PLATFORM.get(platform, DEFAULT_VENDOR)


def holds_device(pid: int, device_path: str) -> bool:
    """Whether process ``pid`` of this pid namespace holds ``device_path``
    open: how a pid the provider reports is mapped to a process using the
    chip.  False where the process or its descriptors cannot be read (a
    pid of another namespace, or a container runtime whose NVML reports
    every process as pid 1)."""
    fd_dir = f"/proc/{pid}/fd"
    try:
        names = os.listdir(fd_dir)
    except OSError:
        return False
    for name in names:
        try:
            if os.readlink(os.path.join(fd_dir, name)) == device_path:
                return True
        except OSError:
            continue
    return False


class ControlPlaneBackend(Backend):
    def __init__(self, store: ObjectStore, devices: DeviceController,
                 node_name: str, pool: str = "",
                 hypervisor_url: str = "", vendor: str = DEFAULT_VENDOR,
                 known_pids: Optional[Callable[[], set]] = None,
                 external_probe: Optional[Callable[[], set]] = None):
        self.store = store
        self.devices = devices
        self.node_name = node_name
        self.pool = pool
        self.hypervisor_url = hypervisor_url
        self.vendor = vendor
        #: PIDs belonging to tpu-fusion workers (worker controller's shm
        #: registrations); any other process seen on a chip marks it as
        #: externally used.  When no source is wired, the default probe
        #: marks nothing — otherwise our own workers would read as foreign
        self.known_pids = known_pids
        #: overridable probe returning externally-used chip ids; default
        #: derives them from provider proc stats minus known worker PIDs
        #: (kubelet_checkpoint.go:82-537 external-device-plugin analog)
        self.external_probe = external_probe or self._probe_external_chips
        self._on_added: Optional[Callable[[WorkerSpec], None]] = None
        self._on_removed: Optional[Callable[[str], None]] = None
        self._watch = None
        self._thread: Optional[threading.Thread] = None
        self._status_thread: Optional[threading.Thread] = None
        self._known_workers: set = set()
        self._stop = threading.Event()

    # -- Backend ----------------------------------------------------------

    def start(self, on_worker_added, on_worker_removed) -> None:
        self._on_added = on_worker_added
        self._on_removed = on_worker_removed
        self._stop.clear()
        self.register_node()
        self.publish_chips()
        # conflated: _handle_pod reconciles latest state per pod (only
        # DELETED vs current-state matters), so intermediate events in a
        # churn burst are pure wire/serialize cost — the gateway
        # collapses them (a no-op for the in-process store)
        self._watch = self.store.watch("Pod", conflate=True)
        self._thread = threading.Thread(target=self._pod_loop,
                                        name="tpf-cp-backend", daemon=True)
        self._thread.start()
        self._status_thread = threading.Thread(
            target=self._status_loop, name="tpf-cp-status", daemon=True)
        self._status_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._watch is not None:
            self._watch.stop()
        for t in (self._thread, self._status_thread):
            if t is not None:
                t.join(timeout=10)
                if t.is_alive():
                    log.warning("%s did not stop within 10 s", t.name)

    def _status_loop(self, interval_s: float = 30.0) -> None:
        """Periodic inventory/status writeback (GPU CR update loop analog)."""
        while not self._stop.wait(interval_s):
            try:
                self.publish_chips()
            except Exception:
                log.exception("chip status writeback failed")

    def resolve_process(self, pid: int) -> Optional[ProcessMapping]:
        return None  # PIDs are registered via POST /process in this mode

    # -- node / chip publication (kubernetes_backend.go:302-447 analog) ---

    def register_node(self) -> None:
        node = Node.new(self.node_name)
        node.status.phase = constants.PHASE_RUNNING
        self.store.update_or_create(node)
        tnode = self.store.try_get(TPUNode, self.node_name)
        if tnode is None:
            tnode = TPUNode.new(self.node_name)
        else:
            tnode = tnode.thaw()
        tnode.spec.pool = self.pool
        tnode.status.phase = constants.PHASE_RUNNING
        tnode.status.hypervisor_ready = True
        tnode.status.hypervisor_url = self.hypervisor_url
        self.store.update_or_create(tnode)

    def _probe_external_chips(self) -> set:
        """Chips with device processes not registered to any tpu-fusion
        worker — a foreign runtime (raw CUDA job, another device plugin)
        is using them and the scheduler must not place on them.

        A pid counts only where it maps to a process of this namespace
        that holds the chip's device node open (:func:`holds_device`).
        NVML in a container may report processes under pids of another
        namespace, or, under some container runtimes, every process as
        pid 1: such pids name no process here that uses the chip, and
        marking the chip for them would take every card with a tenant of
        ours out of the inventory."""
        if self.known_pids is None:
            return set()   # no ours/theirs oracle: never mark (see ctor)
        try:
            stats = self.devices.proc_stats()
        except Exception:  # noqa: BLE001 - provider probe must not kill
            log.debug("proc_stats probe failed; skipping external-chip "
                      "detection this tick", exc_info=True)
            return set()
        known = self.known_pids()
        paths = {e.info.chip_id: e.info.device_path for e in self.devices.devices()}
        return {s.chip_id for s in stats
                if s.pid not in known and s.pid != 0
                and holds_device(s.pid, paths.get(s.chip_id, ""))}

    def publish_chips(self) -> None:
        topo = self.devices.topology()
        external = self.external_probe()
        for entry in self.devices.devices():
            # optimistic-concurrency loop: only inventory fields are ours;
            # available/running_apps belong to the allocator's sync and must
            # not be reverted by a stale read-modify-write
            for _ in range(3):
                try:
                    self._publish_one(entry, topo,
                                      entry.info.chip_id in external)
                    break
                except (ConflictError, AlreadyExistsError):
                    continue
        log.debug("published %d chips for node %s",
                  len(self.devices.devices()), self.node_name)

    def _publish_one(self, entry, topo, externally_used: bool = False) -> None:
        info = entry.info
        chip = self.store.try_get(TPUChip, info.chip_id)
        created = chip is None
        if created:
            chip = TPUChip.new(info.chip_id)
        else:
            chip = chip.thaw()
        st = chip.status
        cap = ResourceAmount(tflops=info.peak_bf16_tflops,
                             duty_percent=100.0,
                             hbm_bytes=float(info.hbm_bytes))
        first_publish = st.capacity.tflops == 0
        st.capacity = cap
        if first_publish:
            st.available = cap
        # never stomp a live-migration phase from the status loop
        if st.phase != constants.PHASE_MIGRATING:
            st.phase = constants.PHASE_RUNNING
        st.used_by = (constants.CHIP_USED_BY_EXTERNAL_PLUGIN
                      if externally_used
                      else constants.CHIP_USED_BY_TPU_FUSION)
        st.generation = info.generation
        st.vendor = self.vendor
        st.node_name = self.node_name
        st.pool = self.pool
        st.slice_id = info.slice_id
        st.host_index = info.host_index
        st.numa_node = info.numa_node
        st.core_count = info.core_count
        st.mesh = MeshCoords(*info.mesh)
        st.capabilities = dict(info.caps)
        if topo is not None and info.chip_id in topo.links:
            st.ici_links = [
                ICILink(peer_chip_id=l.peer_chip_id,
                        peer_index=l.peer_index, kind=l.kind,
                        hops=l.hops, gbps=l.gbps)
                for l in topo.links[info.chip_id]]
        if created:
            self.store.create(chip)
        else:
            self.store.update(chip, check_version=True)

    # -- pod watch (pod_cache informer analog) ----------------------------

    def _pod_loop(self) -> None:
        for event in self._watch:
            if self._stop.is_set():
                return
            try:
                self._handle_pod(event)
            except Exception:
                log.exception("pod event handling failed")

    def _handle_pod(self, event) -> None:
        pod: Pod = event.obj
        key = pod.key()
        ann = pod.metadata.annotations
        mine = (pod.spec.node_name == self.node_name
                and ann.get(constants.ANN_CHIP_IDS))
        if event.type == DELETED or not mine:
            if key in self._known_workers:
                self._known_workers.discard(key)
                if self._on_removed:
                    self._on_removed(key)
            return
        if key in self._known_workers:
            return
        self._known_workers.add(key)
        spec = self._worker_spec(pod)
        if self._on_added:
            self._on_added(spec)

    def _worker_spec(self, pod: Pod) -> WorkerSpec:
        ann = pod.metadata.annotations
        chip_ids = [c for c in
                    ann.get(constants.ANN_CHIP_IDS, "").split(",") if c]
        tflops = parse_quantity(ann.get(constants.ANN_TFLOPS_REQUEST, 0)
                                or 0)
        hbm = int(parse_quantity(ann.get(constants.ANN_HBM_REQUEST, 0) or 0))
        duty = float(ann.get(constants.ANN_DUTY_REQUEST, 0) or 0)
        devices = []
        for chip_id in chip_ids:
            entry = self.devices.get(chip_id)
            if duty > 0:
                duty_pct = duty
            elif tflops > 0 and entry is not None and \
                    entry.info.peak_bf16_tflops > 0:
                duty_pct = min(100.0,
                               tflops / entry.info.peak_bf16_tflops * 100.0)
            else:
                # HBM-only request: no compute contract -> unthrottled
                duty_pct = 100.0
            devices.append(WorkerDeviceRequest(
                chip_id=chip_id, duty_percent=duty_pct, hbm_bytes=hbm,
                partition_template=ann.get(constants.ANN_PARTITION_NAME,
                                           "")))
        return WorkerSpec(
            namespace=pod.metadata.namespace, name=pod.metadata.name,
            isolation=ann.get(constants.ANN_ISOLATION,
                              constants.DEFAULT_ISOLATION),
            qos=ann.get(constants.ANN_QOS, constants.DEFAULT_QOS),
            devices=devices)

    # -- status writeback -------------------------------------------------

    def publish_device_status(self, devices: List[dict]) -> None:
        self.publish_chips()
