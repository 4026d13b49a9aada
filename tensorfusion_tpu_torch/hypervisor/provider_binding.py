"""ctypes binding of the tpu-fusion provider ABI.

The port's copy of tensorfusion_tpu/hypervisor/provider_binding.py: the
same ctypes mirrors of ``csrc/provider.h`` (a byte-equal copy of
``native/include/tpufusion/provider.h``), the same ``Provider`` methods and
errors.  The hypervisor dlopens a provider library (the port's NVML
provider, or the reference's mock) and talks the C ABI directly.
"""

from __future__ import annotations

import ctypes as C
from dataclasses import dataclass, field
from typing import Dict, List, Optional

TPF_OK = 0
TPF_ERR_INVALID_ARG = 1
TPF_ERR_NOT_FOUND = 2
TPF_ERR_UNSUPPORTED = 3
TPF_ERR_EXHAUSTED = 4
TPF_ERR_FAILED = 5
TPF_ERR_INTERNAL = 6
TPF_ERR_NOT_INITIALIZED = 7

STATUS_NAMES = {
    0: "OK", 1: "INVALID_ARG", 2: "NOT_FOUND", 3: "UNSUPPORTED",
    4: "EXHAUSTED", 5: "FAILED", 6: "INTERNAL", 7: "NOT_INITIALIZED",
}

ID_LEN = 64
NAME_LEN = 96
PATH_LEN = 512
MAX_CHIPS = 256
MAX_PARTITION_ENV = 16
ENV_LEN = 256
MAX_PARTITION_NODES = 16
MAX_EXTRA_METRICS = 32
MAX_TEMPLATES = 16

LINK_KINDS = {0: "self", 1: "same-chip", 2: "ici", 3: "ici-routed",
              4: "dcn", 5: "none"}


class ProviderError(RuntimeError):
    def __init__(self, fn: str, status: int):
        super().__init__(f"{fn} failed: {STATUS_NAMES.get(status, status)}")
        self.status = status


# -- C struct mirrors -------------------------------------------------------


class CChipCaps(C.Structure):
    _fields_ = [("core_partitioning", C.c_uint8),
                ("soft_isolation", C.c_uint8),
                ("hard_isolation", C.c_uint8),
                ("snapshot", C.c_uint8),
                ("metrics", C.c_uint8),
                ("remoting", C.c_uint8),
                ("max_partitions", C.c_uint32),
                ("max_workers", C.c_uint32)]


class CChipInfo(C.Structure):
    _fields_ = [("chip_id", C.c_char * ID_LEN),
                ("platform", C.c_char * 32),
                ("generation", C.c_char * 32),
                ("slice_id", C.c_char * ID_LEN),
                ("device_path", C.c_char * PATH_LEN),
                ("driver_version", C.c_char * 48),
                ("global_index", C.c_int32),
                ("host_index", C.c_int32),
                ("numa_node", C.c_int32),
                ("core_count", C.c_int32),
                ("hbm_bytes", C.c_uint64),
                ("peak_bf16_tflops", C.c_double),
                ("peak_int8_tops", C.c_double),
                ("hbm_gbps", C.c_double),
                ("mesh_x", C.c_int32),
                ("mesh_y", C.c_int32),
                ("mesh_z", C.c_int32),
                ("caps", CChipCaps)]


class CLink(C.Structure):
    _fields_ = [("peer_chip_id", C.c_char * ID_LEN),
                ("peer_index", C.c_int32),
                ("kind", C.c_int),
                ("hops", C.c_int32),
                ("gbps", C.c_double)]


class CTopoRow(C.Structure):
    _fields_ = [("chip_id", C.c_char * ID_LEN),
                ("index", C.c_int32),
                ("mesh_x", C.c_int32),
                ("mesh_y", C.c_int32),
                ("mesh_z", C.c_int32),
                ("links", CLink * MAX_CHIPS),
                ("link_count", C.c_size_t)]


class CTopology(C.Structure):
    _fields_ = [("mesh_shape", C.c_int32 * 3),
                ("wraparound", C.c_uint8 * 3),
                ("rows", CTopoRow * MAX_CHIPS),
                ("row_count", C.c_size_t)]


class CPartitionTemplate(C.Structure):
    _fields_ = [("template_id", C.c_char * ID_LEN),
                ("name", C.c_char * NAME_LEN),
                ("core_count", C.c_int32),
                ("hbm_bytes", C.c_uint64),
                ("bf16_tflops", C.c_double),
                ("slots", C.c_uint32),
                ("is_default", C.c_uint8)]


class CPartitionGrant(C.Structure):
    _fields_ = [("kind", C.c_int),
                ("chip_id", C.c_char * ID_LEN),
                ("partition_id", C.c_char * ID_LEN),
                ("env", (C.c_char * ENV_LEN) * MAX_PARTITION_ENV),
                ("env_count", C.c_size_t),
                ("device_nodes",
                 (C.c_char * (PATH_LEN * 2 + 2)) * MAX_PARTITION_NODES),
                ("device_node_count", C.c_size_t)]


class CSnapshotCtx(C.Structure):
    _fields_ = [("pids", C.POINTER(C.c_int64)),
                ("pid_count", C.c_size_t),
                ("chip_id", C.c_char_p),
                ("state_dir", C.c_char_p)]


class CKVMetric(C.Structure):
    _fields_ = [("key", C.c_char * ID_LEN), ("value", C.c_double)]


class CChipMetrics(C.Structure):
    _fields_ = [("chip_id", C.c_char * ID_LEN),
                ("duty_cycle_pct", C.c_double),
                ("hbm_bw_util_pct", C.c_double),
                ("hbm_used_bytes", C.c_uint64),
                ("power_watts", C.c_double),
                ("temp_celsius", C.c_double),
                ("ici_tx_bytes", C.c_uint64),
                ("ici_rx_bytes", C.c_uint64),
                ("extra", CKVMetric * MAX_EXTRA_METRICS),
                ("extra_count", C.c_size_t)]


class CProcStats(C.Structure):
    _fields_ = [("pid", C.c_int64),
                ("chip_id", C.c_char * ID_LEN),
                ("duty_cycle_pct", C.c_double),
                ("hbm_used_bytes", C.c_uint64),
                ("hbm_reserved_bytes", C.c_uint64),
                ("programs_launched", C.c_uint64)]


class CMount(C.Structure):
    _fields_ = [("host_path", C.c_char * PATH_LEN),
                ("guest_path", C.c_char * PATH_LEN)]


LOG_FN = C.CFUNCTYPE(None, C.c_char_p, C.c_char_p)


# -- Python-facing dataclasses ----------------------------------------------


@dataclass
class ChipInfo:
    chip_id: str
    platform: str
    generation: str
    slice_id: str
    device_path: str
    driver_version: str
    global_index: int
    host_index: int
    numa_node: int
    core_count: int
    hbm_bytes: int
    peak_bf16_tflops: float
    peak_int8_tops: float
    hbm_gbps: float
    mesh: tuple
    caps: Dict[str, object] = field(default_factory=dict)


@dataclass
class TopoLink:
    peer_chip_id: str
    peer_index: int
    kind: str
    hops: int
    gbps: float


@dataclass
class Topology:
    mesh_shape: tuple
    wraparound: tuple
    links: Dict[str, List[TopoLink]]
    coords: Dict[str, tuple]


@dataclass
class PartitionTemplate:
    template_id: str
    name: str
    core_count: int
    hbm_bytes: int
    bf16_tflops: float
    slots: int
    is_default: bool


@dataclass
class PartitionGrant:
    kind: str                      # "env" | "device-node"
    chip_id: str
    partition_id: str
    env: Dict[str, str]
    device_nodes: List[str]


@dataclass
class ChipMetrics:
    chip_id: str
    duty_cycle_pct: float
    hbm_bw_util_pct: float
    hbm_used_bytes: int
    power_watts: float
    temp_celsius: float
    ici_tx_bytes: int
    ici_rx_bytes: int
    extra: Dict[str, float]


@dataclass
class ProcStats:
    pid: int
    chip_id: str
    duty_cycle_pct: float
    hbm_used_bytes: int
    hbm_reserved_bytes: int
    programs_launched: int


def _s(b: bytes) -> str:
    return b.decode("utf-8", "replace")


class Provider:
    """Loaded provider library (one per vendor, dlopened by the hypervisor)."""

    def __init__(self, lib_path: str, log_fn=None):
        self.lib_path = lib_path
        self._lib = C.CDLL(lib_path)
        self._log_cb = None  # keep the callback alive
        if log_fn is not None:
            self.set_log_sink(log_fn)

    def _call(self, name: str, *args) -> None:
        status = getattr(self._lib, name)(*args)
        if status != TPF_OK:
            raise ProviderError(name, status)

    # -- lifecycle --------------------------------------------------------

    def abi_version(self) -> int:
        fn = self._lib.tpf_abi_version
        fn.restype = C.c_uint32
        return fn()

    def init(self) -> None:
        self._call("tpf_init")

    def shutdown(self) -> None:
        self._call("tpf_shutdown")

    def set_log_sink(self, log_fn) -> None:
        self._log_cb = LOG_FN(
            lambda lvl, msg: log_fn(_s(lvl), _s(msg)))
        self._call("tpf_set_log_sink", self._log_cb)

    # -- enumeration ------------------------------------------------------

    def chip_count(self) -> int:
        n = C.c_size_t()
        self._call("tpf_chip_count", C.byref(n))
        return n.value

    def enumerate(self) -> List[ChipInfo]:
        max_n = self.chip_count()
        buf = (CChipInfo * max(max_n, 1))()
        n = C.c_size_t()
        self._call("tpf_enumerate", buf, max_n, C.byref(n))
        out = []
        for i in range(n.value):
            c = buf[i]
            out.append(ChipInfo(
                chip_id=_s(c.chip_id), platform=_s(c.platform),
                generation=_s(c.generation), slice_id=_s(c.slice_id),
                device_path=_s(c.device_path),
                driver_version=_s(c.driver_version),
                global_index=c.global_index, host_index=c.host_index,
                numa_node=c.numa_node, core_count=c.core_count,
                hbm_bytes=c.hbm_bytes,
                peak_bf16_tflops=c.peak_bf16_tflops,
                peak_int8_tops=c.peak_int8_tops, hbm_gbps=c.hbm_gbps,
                mesh=(c.mesh_x, c.mesh_y, c.mesh_z),
                caps={"core_partitioning": bool(c.caps.core_partitioning),
                      "soft_isolation": bool(c.caps.soft_isolation),
                      "hard_isolation": bool(c.caps.hard_isolation),
                      "snapshot": bool(c.caps.snapshot),
                      "metrics": bool(c.caps.metrics),
                      "remoting": bool(c.caps.remoting),
                      "max_partitions": c.caps.max_partitions,
                      "max_workers": c.caps.max_workers}))
        return out

    def topology(self) -> Topology:
        topo = CTopology()
        self._call("tpf_topology", C.byref(topo))
        links: Dict[str, List[TopoLink]] = {}
        coords: Dict[str, tuple] = {}
        for i in range(topo.row_count):
            row = topo.rows[i]
            cid = _s(row.chip_id)
            coords[cid] = (row.mesh_x, row.mesh_y, row.mesh_z)
            links[cid] = [
                TopoLink(peer_chip_id=_s(l.peer_chip_id),
                         peer_index=l.peer_index,
                         kind=LINK_KINDS.get(l.kind, "none"),
                         hops=l.hops, gbps=l.gbps)
                for l in (row.links[j] for j in range(row.link_count))]
        return Topology(mesh_shape=tuple(topo.mesh_shape),
                        wraparound=tuple(bool(w) for w in topo.wraparound),
                        links=links, coords=coords)

    # -- partitioning -----------------------------------------------------

    def partition_templates(self, chip_id: str) -> List[PartitionTemplate]:
        buf = (CPartitionTemplate * MAX_TEMPLATES)()
        n = C.c_size_t()
        self._call("tpf_partition_templates", chip_id.encode(), buf,
                   MAX_TEMPLATES, C.byref(n))
        return [PartitionTemplate(
            template_id=_s(t.template_id), name=_s(t.name),
            core_count=t.core_count, hbm_bytes=t.hbm_bytes,
            bf16_tflops=t.bf16_tflops, slots=t.slots,
            is_default=bool(t.is_default)) for t in buf[:n.value]]

    def partition_create(self, template_id: str,
                         chip_id: str) -> PartitionGrant:
        grant = CPartitionGrant()
        self._call("tpf_partition_create", template_id.encode(),
                   chip_id.encode(), C.byref(grant))
        env = {}
        for i in range(grant.env_count):
            kv = _s(grant.env[i].value)
            if "=" in kv:
                k, v = kv.split("=", 1)
                env[k] = v
        nodes = [_s(grant.device_nodes[i].value)
                 for i in range(grant.device_node_count)]
        return PartitionGrant(
            kind="env" if grant.kind == 0 else "device-node",
            chip_id=_s(grant.chip_id), partition_id=_s(grant.partition_id),
            env=env, device_nodes=nodes)

    def partition_destroy(self, template_or_partition_id: str,
                          chip_id: str) -> None:
        self._call("tpf_partition_destroy", template_or_partition_id.encode(),
                   chip_id.encode())

    # -- hard limits ------------------------------------------------------

    def set_hbm_hard_limit(self, chip_id: str, limit_bytes: int) -> None:
        self._call("tpf_set_hbm_hard_limit", chip_id.encode(),
                   C.c_uint64(limit_bytes))

    def set_duty_hard_limit(self, chip_id: str, duty_pct: int) -> None:
        self._call("tpf_set_duty_hard_limit", chip_id.encode(),
                   C.c_uint32(duty_pct))

    # -- snapshot ---------------------------------------------------------

    def snapshot(self, state_dir: str, chip_id: Optional[str] = None,
                 pids: Optional[List[int]] = None) -> None:
        self._snap_or_restore("tpf_snapshot", state_dir, chip_id, pids)

    def restore(self, state_dir: str, chip_id: Optional[str] = None,
                pids: Optional[List[int]] = None) -> None:
        self._snap_or_restore("tpf_restore", state_dir, chip_id, pids)

    def _snap_or_restore(self, fn, state_dir, chip_id, pids):
        ctx = CSnapshotCtx()
        arr = None
        if pids:
            arr = (C.c_int64 * len(pids))(*pids)
            ctx.pids = arr
            ctx.pid_count = len(pids)
        ctx.chip_id = chip_id.encode() if chip_id else None
        ctx.state_dir = state_dir.encode()
        self._call(fn, C.byref(ctx))

    # -- metrics ----------------------------------------------------------

    def proc_stats(self, max_count: int = 1024) -> List[ProcStats]:
        buf = (CProcStats * max_count)()
        n = C.c_size_t()
        self._call("tpf_proc_stats", buf, max_count, C.byref(n))
        return [ProcStats(pid=p.pid, chip_id=_s(p.chip_id),
                          duty_cycle_pct=p.duty_cycle_pct,
                          hbm_used_bytes=p.hbm_used_bytes,
                          hbm_reserved_bytes=p.hbm_reserved_bytes,
                          programs_launched=p.programs_launched)
                for p in buf[:n.value]]

    def chip_metrics(self, chip_ids: List[str]) -> List[ChipMetrics]:
        ids = (C.c_char_p * len(chip_ids))(*[c.encode() for c in chip_ids])
        buf = (CChipMetrics * len(chip_ids))()
        self._call("tpf_chip_metrics", ids, len(chip_ids), buf)
        return [ChipMetrics(
            chip_id=_s(m.chip_id), duty_cycle_pct=m.duty_cycle_pct,
            hbm_bw_util_pct=m.hbm_bw_util_pct,
            hbm_used_bytes=m.hbm_used_bytes, power_watts=m.power_watts,
            temp_celsius=m.temp_celsius, ici_tx_bytes=m.ici_tx_bytes,
            ici_rx_bytes=m.ici_rx_bytes,
            extra={_s(m.extra[i].key): m.extra[i].value
                   for i in range(m.extra_count)}) for m in buf]

    def mounts(self, max_count: int = 32) -> List[tuple]:
        buf = (CMount * max_count)()
        n = C.c_size_t()
        self._call("tpf_mounts", buf, max_count, C.byref(n))
        return [(_s(m.host_path), _s(m.guest_path)) for m in buf[:n.value]]
