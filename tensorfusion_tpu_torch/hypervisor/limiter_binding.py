"""ctypes binding of ``libtpf_limiter.so`` (native/limiter/limiter.cc)
and a Python mirror of its shared-memory segments.

The port's copy of tensorfusion_tpu/hypervisor/limiter_binding.py:

- :class:`Limiter` -- the hypervisor face (init, create_worker,
  update_quota, heartbeat, set_frozen, ...) and the worker face that the
  client runtime charges through (attach, charge_compute, charge_hbm).
  One loaded copy of the library holds one attached segment: a process
  that plays both faces loads two copies of the file;
- :class:`ShmView` -- a read-only mirror of one worker segment
  (``native/include/tpufusion/shm_layout.h``), read by the worker
  controller's tick, the chip smoke and the layout tests.  Its layout
  constants are the reference's byte-verified ones.
"""

from __future__ import annotations

import ctypes as C
import json
import mmap
import os
import struct
from dataclasses import dataclass
from typing import List

from .provider_binding import TPF_OK, STATUS_NAMES

SEGMENT_BYTES = 3072
HEADER_BYTES = 1024
DEVICE_BYTES = 256
MAX_DEVICES = 8
MAX_PIDS = 64
MAGIC = 0x314D48535F465054  # "TPF_SHM1"

FLAG_FROZEN = 1 << 0
FLAG_AUTO_FROZEN = 1 << 1

# struct layouts (must match shm_layout.h; verified against tfl_layout_json
# in tests/test_hypervisor.py)
_HEADER_FMT = "<QII64s128sQQQQ"        # magic, version, device_count, ns,
_HEADER_PIDS_OFF = 8 + 4 + 4 + 64 + 128 + 8 * 4
_DEVICE_FMT = "<64s13Q"                # chip_id + 13 u64 fields


class LimiterError(RuntimeError):
    def __init__(self, fn: str, status: int):
        super().__init__(f"{fn} failed: {STATUS_NAMES.get(status, status)}")
        self.status = status


class CDeviceQuota(C.Structure):
    _fields_ = [("device_index", C.c_uint32),
                ("chip_id", C.c_char * 64),
                ("duty_limit_bp", C.c_uint32),
                ("hbm_limit_bytes", C.c_uint64),
                ("capacity_mflop", C.c_uint64),
                ("refill_mflop_per_s", C.c_uint64)]


class CChargeResult(C.Structure):
    _fields_ = [("allowed", C.c_uint8),
                ("frozen", C.c_uint8),
                ("available", C.c_uint64),
                ("wait_hint_us", C.c_uint64)]


@dataclass
class DeviceQuota:
    device_index: int
    chip_id: str
    duty_limit_bp: int
    hbm_limit_bytes: int
    capacity_mflop: int
    refill_mflop_per_s: int


@dataclass
class ChargeResult:
    allowed: bool
    frozen: bool
    available: int
    wait_hint_us: int


class Limiter:
    """Host/control face of libtpf_limiter.so, plus the worker face used
    by the client runtime."""

    def __init__(self, lib_path: str):
        self.lib_path = lib_path
        self._lib = C.CDLL(lib_path)

    def _call(self, name: str, *args) -> None:
        status = getattr(self._lib, name)(*args)
        if status != TPF_OK:
            raise LimiterError(name, status)

    # -- hypervisor face --------------------------------------------------

    def init(self, shm_base: str) -> None:
        self._call("tfl_init", shm_base.encode())

    def shutdown(self) -> None:
        self._call("tfl_shutdown")

    def create_worker(self, ns: str, pod: str,
                      quotas: List[DeviceQuota]) -> None:
        arr = (CDeviceQuota * max(len(quotas), 1))()
        for i, q in enumerate(quotas):
            arr[i] = CDeviceQuota(q.device_index, q.chip_id.encode(),
                                  q.duty_limit_bp, q.hbm_limit_bytes,
                                  q.capacity_mflop, q.refill_mflop_per_s)
        self._call("tfl_create_worker", ns.encode(), pod.encode(), arr,
                   len(quotas))

    def remove_worker(self, ns: str, pod: str) -> None:
        self._call("tfl_remove_worker", ns.encode(), pod.encode())

    def register_pid(self, ns: str, pod: str, host_pid: int) -> None:
        self._call("tfl_register_pid", ns.encode(), pod.encode(),
                   C.c_uint64(host_pid))

    def update_quota(self, ns: str, pod: str, device_index: int,
                     duty_limit_bp: int, refill_mflop_per_s: int,
                     capacity_mflop: int = 0) -> None:
        self._call("tfl_update_quota", ns.encode(), pod.encode(),
                   C.c_uint32(device_index), C.c_uint32(duty_limit_bp),
                   C.c_uint64(refill_mflop_per_s),
                   C.c_uint64(capacity_mflop))

    def heartbeat(self, ns: str, pod: str, ts_seconds: int) -> None:
        self._call("tfl_heartbeat", ns.encode(), pod.encode(),
                   C.c_uint64(ts_seconds))

    def set_pod_hbm_used(self, ns: str, pod: str, device_index: int,
                         bytes_used: int) -> None:
        self._call("tfl_set_pod_hbm_used", ns.encode(), pod.encode(),
                   C.c_uint32(device_index), C.c_uint64(bytes_used))

    def set_frozen(self, ns: str, pod: str, frozen: bool,
                   auto_freeze: bool = False) -> None:
        self._call("tfl_set_frozen", ns.encode(), pod.encode(),
                   C.c_uint8(1 if frozen else 0),
                   C.c_uint8(1 if auto_freeze else 0))

    # -- worker face (client runtime + tests) -----------------------------

    def attach(self, shm_path: str) -> None:
        self._call("tfl_attach", shm_path.encode())

    def detach(self) -> None:
        self._call("tfl_detach")

    def charge_compute(self, device_index: int, mflops: int) -> ChargeResult:
        r = CChargeResult()
        self._call("tfl_charge_compute", C.c_uint32(device_index),
                   C.c_uint64(mflops), C.byref(r))
        return ChargeResult(bool(r.allowed), bool(r.frozen), r.available,
                            r.wait_hint_us)

    def charge_hbm(self, device_index: int, delta_bytes: int) -> ChargeResult:
        r = CChargeResult()
        self._call("tfl_charge_hbm", C.c_uint32(device_index),
                   C.c_int64(delta_bytes), C.byref(r))
        return ChargeResult(bool(r.allowed), bool(r.frozen), r.available,
                            r.wait_hint_us)

    def self_register_pid(self) -> None:
        self._call("tfl_self_register_pid")

    def worker_frozen(self) -> bool:
        return bool(self._lib.tfl_worker_frozen())

    # -- introspection ----------------------------------------------------

    def layout(self) -> dict:
        buf = C.create_string_buffer(4096)
        self._call("tfl_layout_json", buf, 4096)
        return json.loads(buf.value.decode())


@dataclass
class ShmDeviceState:
    chip_id: str
    active: bool
    duty_limit_bp: int
    hbm_limit_bytes: int
    hbm_used_bytes: int
    pod_hbm_used_bytes: int
    tokens_mflop: int
    capacity_mflop: int
    refill_mflop_per_s: int
    last_refill_us: int
    total_charged_mflop: int
    launches: int
    blocked_events: int
    hbm_denied_events: int


@dataclass
class ShmWorkerState:
    ns: str
    pod: str
    version: int
    heartbeat_ts_s: int
    frozen: bool
    auto_frozen: bool
    freeze_ts_us: int
    pids: List[int]
    devices: List[ShmDeviceState]


class ShmView:
    """Read-only mmap view of one worker segment."""

    def __init__(self, path: str):
        self.path = path
        fd = os.open(path, os.O_RDONLY)
        try:
            self._mm = mmap.mmap(fd, SEGMENT_BYTES, prot=mmap.PROT_READ)
        finally:
            os.close(fd)

    def close(self) -> None:
        self._mm.close()

    def read(self) -> ShmWorkerState:
        mm = self._mm
        magic, version, device_count, ns, pod, hb, flags, freeze_ts, \
            pid_count = struct.unpack_from(_HEADER_FMT, mm, 0)
        if magic != MAGIC:
            raise ValueError(f"bad shm magic in {self.path}: {magic:#x}")
        pids = []
        n = min(pid_count, MAX_PIDS)
        raw = struct.unpack_from(f"<{MAX_PIDS}Q", mm, _HEADER_PIDS_OFF)
        # skip transiently-zero slots (see shm_layout.h pid table note)
        pids = [p for p in raw[:n] if p != 0]
        devices = []
        for i in range(min(device_count, MAX_DEVICES)):
            off = HEADER_BYTES + i * DEVICE_BYTES
            vals = struct.unpack_from(_DEVICE_FMT, mm, off)
            chip_id = vals[0].split(b"\0", 1)[0].decode()
            (active, duty_bp, hbm_limit, hbm_used, pod_hbm, tokens, cap,
             refill, last_refill, charged, launches, blocked,
             hbm_denied) = vals[1:]
            devices.append(ShmDeviceState(
                chip_id=chip_id, active=bool(active), duty_limit_bp=duty_bp,
                hbm_limit_bytes=hbm_limit, hbm_used_bytes=hbm_used,
                pod_hbm_used_bytes=pod_hbm, tokens_mflop=tokens,
                capacity_mflop=cap, refill_mflop_per_s=refill,
                last_refill_us=last_refill, total_charged_mflop=charged,
                launches=launches, blocked_events=blocked,
                hbm_denied_events=hbm_denied))
        return ShmWorkerState(
            ns=ns.split(b"\0", 1)[0].decode(),
            pod=pod.split(b"\0", 1)[0].decode(),
            version=version, heartbeat_ts_s=hb,
            frozen=bool(flags & FLAG_FROZEN),
            auto_frozen=bool(flags & FLAG_AUTO_FROZEN),
            freeze_ts_us=freeze_ts, pids=pids, devices=devices)


def hook_side_file(shm_path: str) -> str:
    """The launch hook's side file of a worker's segment (``.<pod>.hook``
    beside it: csrc/cuda_hook.c, "Several processes of one worker")."""
    head, pod = os.path.split(shm_path)
    return os.path.join(head, f".{pod}.hook")


def list_worker_segments(shm_base: str) -> List[tuple]:
    """Enumerate (ns, pod, path) worker segments under the shm base dir
    (hidden files, such as the launch hook's side files, are not)."""
    out = []
    if not os.path.isdir(shm_base):
        return out
    for ns in sorted(os.listdir(shm_base)):
        ns_dir = os.path.join(shm_base, ns)
        if not os.path.isdir(ns_dir):
            continue
        for pod in sorted(os.listdir(ns_dir)):
            if not pod.startswith("."):
                out.append((ns, pod, os.path.join(ns_dir, pod)))
    return out
