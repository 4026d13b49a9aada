"""Client runtime of the port: meters a tenant's work on the GPU against
the shared-memory token buckets of ``libtpf_limiter.so``.

Counterpart of ``tensorfusion_tpu/client/runtime.py``, keeping its names
(``VTPUClient``, ``meter``) and its contract:

- bootstrap from ``TPF_SHM_PATH``, or ask the node hypervisor's
  ``/limiter`` endpoint for the segment and register the PID at
  ``/process``; with neither, run unmetered;
- ``meter(fn)`` charges once per call of the metered callable.  The cost
  is estimated once per argument-shape signature: the reference reads
  XLA's compiled ``cost_analysis``, the port runs ``fn`` once on fake
  tensors (shapes only, no device work) under
  ``torch.utils.flop_counter.FlopCounterMode``.  The flash kernels are
  custom ops with registered FLOP formulas, so their work (forward and
  backward) is counted;
- a dry bucket makes the launch sleep the limiter's wait hint and retry,
  and a frozen worker blocks at its next launch until thawed;
- device memory is charged once per signature, as the peak-allocation
  growth of the first call on the card, and released when the metered
  callable is dropped.

Not in this slice: ``activate()`` (global patching), the live-memory
sampler and host spill.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import os
import threading
import time
import urllib.request
import weakref
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.flop_counter import (FlopCounterMode, flop_registry,
                                      register_flop_formula)

from .. import constants
from ..device import DeviceLike, resolve_device
from ..hypervisor.limiter_binding import Limiter

log = logging.getLogger("tpf_torch.client")

_current: Optional["VTPUClient"] = None

if torch.ops.aten._int_mm not in flop_registry:
    # the w8a8 product on CUDA; torch does not count it itself
    @register_flop_formula(torch.ops.aten._int_mm)
    def _int_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs):
        return 2 * a_shape[0] * a_shape[1] * b_shape[1]


def _tree_map(fn: Callable, node: Any) -> Any:
    """Apply ``fn`` to every tensor in nested dicts, lists, tuples and
    dataclasses (QuantizedWeight, LlamaConfig)."""
    if isinstance(node, torch.Tensor):
        return fn(node)
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree_map(fn, x) for x in node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{
            f.name: _tree_map(fn, getattr(node, f.name))
            for f in dataclasses.fields(node) if f.init})
    return node


def _signature(node: Any):
    """Hashable (shape, dtype, device) signature of an argument tree."""
    if isinstance(node, torch.Tensor):
        return ("T", tuple(node.shape), str(node.dtype), node.device.type)
    if isinstance(node, dict):
        return ("D",) + tuple((k, _signature(v)) for k, v in node.items())
    if isinstance(node, (list, tuple)):
        return ("L",) + tuple(_signature(x) for x in node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return (type(node).__name__,) + tuple(
            _signature(getattr(node, f.name)) for f in dataclasses.fields(node))
    return ("py", repr(node))


def estimate_flops(fn: Callable, args: tuple, kwargs: dict) -> int:
    """FLOPs of one call of ``fn``, counted on fake copies of the
    arguments: the same shapes, devices and dtypes, and no device work."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake_mode = FakeTensorMode()
    fargs, fkwargs = _tree_map(fake_mode.from_tensor, (args, kwargs))
    with fake_mode, FlopCounterMode(display=False) as counter:
        fn(*fargs, **fkwargs)
    return counter.get_total_flops()


class VTPUClient:
    def __init__(self, limiter_lib: Optional[str] = None,
                 shm_path: Optional[str] = None,
                 hypervisor_url: Optional[str] = None,
                 device_index: int = 0,
                 register_pid: bool = True,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.limiter_lib = limiter_lib or os.environ.get(
            constants.ENV_LIMITER_LIB, "native/build/libtpf_limiter.so")
        self.shm_path = shm_path or os.environ.get(constants.ENV_SHM_PATH)
        self.hypervisor_url = hypervisor_url or os.environ.get(
            constants.ENV_HYPERVISOR_URL)
        self.device_index = device_index
        self.limiter: Optional[Limiter] = None
        self.attached = False
        self._lock = threading.Lock()
        # telemetry
        self.launches = 0
        self.blocked_time_s = 0.0
        self.charged_mflops = 0
        self.hbm_charged_bytes = 0
        self._bootstrap(register_pid)

    # -- bootstrap ---------------------------------------------------------

    def _bootstrap(self, register_pid: bool) -> None:
        if not self.shm_path and self.hypervisor_url:
            ns = os.environ.get(constants.ENV_POD_NAMESPACE, "default")
            pod = os.environ.get(constants.ENV_POD_NAME, "")
            try:
                with urllib.request.urlopen(
                        f"{self.hypervisor_url}/limiter?namespace={ns}"
                        f"&pod={pod}", timeout=5) as r:
                    info = json.loads(r.read())
                self.shm_path = info.get("shm_path") or None
                if register_pid:
                    req = urllib.request.Request(
                        f"{self.hypervisor_url}/process", method="POST",
                        data=json.dumps({"namespace": ns, "pod": pod,
                                         "pid": os.getpid()}).encode())
                    with urllib.request.urlopen(req, timeout=5):
                        pass
            except (OSError, ValueError):
                log.warning("hypervisor bootstrap failed; running unmetered",
                            exc_info=True)
        if not self.shm_path:
            log.info("no shm segment configured; metering disabled")
            return
        try:
            self.limiter = Limiter(self.limiter_lib)
            self.limiter.attach(self.shm_path)
            if register_pid:
                self.limiter.self_register_pid()
            self.attached = True
            log.info("metering active (segment %s)", self.shm_path)
        except (OSError, RuntimeError):
            log.exception("limiter attach failed; running unmetered")
            self.limiter = None

    def close(self) -> None:
        if self.limiter is not None and self.attached:
            self.limiter.detach()
            self.attached = False

    # -- charging ----------------------------------------------------------

    def charge_launch(self, mflops: int) -> None:
        """Charge one launch; blocks (sleeping the limiter's wait hints)
        until admitted.  No-op when unmetered."""
        if not self.attached or mflops <= 0:
            return
        while True:
            r = self.limiter.charge_compute(self.device_index, mflops)
            if r.allowed:
                with self._lock:
                    self.launches += 1
                    self.charged_mflops += mflops
                return
            wait = max(r.wait_hint_us, 100) / 1e6
            with self._lock:
                self.blocked_time_s += wait
            time.sleep(wait)

    def charge_hbm(self, delta_bytes: int) -> bool:
        if not self.attached or delta_bytes == 0:
            return True
        r = self.limiter.charge_hbm(self.device_index, delta_bytes)
        if not r.allowed:
            log.warning("device memory budget denied: wanted %+d, "
                        "available %d", delta_bytes, r.available)
            return False
        with self._lock:
            self.hbm_charged_bytes += delta_bytes
        return True

    def frozen(self) -> bool:
        return bool(self.attached and self.limiter.worker_frozen())

    # -- metering wrapper --------------------------------------------------

    def meter(self, fn: Callable) -> Callable:
        """Wrap ``fn`` so that each call is charged its estimated MFLOPs
        before it runs."""
        costs: Dict[Any, int] = {}
        hbm_charged: Dict[Any, int] = {}
        client = self

        @functools.wraps(fn)
        def metered(*args, **kwargs):
            sig = _signature((args, kwargs))
            mflops = costs.get(sig)
            first = mflops is None
            if first:
                try:
                    mflops = max(int(estimate_flops(fn, args, kwargs) / 1e6), 1)
                except Exception:  # noqa: BLE001 - any failure of a trace
                    log.warning("FLOP estimate failed; flat-rate charge",
                                exc_info=True)
                    mflops = 1
                costs[sig] = mflops
            client.charge_launch(mflops)
            if not (first and client.attached and client.device.type == "cuda"):
                return fn(*args, **kwargs)
            # one-time device-memory charge: the peak growth of this call
            before = torch.cuda.memory_allocated(client.device)
            torch.cuda.reset_peak_memory_stats(client.device)
            out = fn(*args, **kwargs)
            peak = torch.cuda.max_memory_allocated(client.device) - before
            if peak > 0 and client.charge_hbm(peak):
                hbm_charged[sig] = peak
            return out

        def _release(charged):
            total = sum(charged.values())
            if total:
                try:
                    client.charge_hbm(-total)
                # weakref.finalize may run at interpreter shutdown, after
                # the limiter is gone: nothing left to tell
                except Exception:  # noqa: BLE001
                    pass

        weakref.finalize(metered, _release, hbm_charged)
        return metered


def meter(fn: Callable) -> Callable:
    """Meter ``fn`` with the process-global client (created from the
    environment, on the card, at first use)."""
    global _current
    if _current is None:
        _current = VTPUClient()
    return _current.meter(fn)
