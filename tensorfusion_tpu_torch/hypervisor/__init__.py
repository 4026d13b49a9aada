"""The port's node agent ("hypervisor"): the copy of
tensorfusion_tpu/hypervisor/ for NVIDIA cards.  A device controller over a
dlopened provider library (the NVML provider of ``csrc/provider_nvml.c``,
or any other of the same ABI), worker allocation and lifecycle, the
limiter's shm segments, the ERL metering loop, a single-node process
spawner and an HTTP API.  Not ported yet: the control-plane backend and
the curses TUI.
"""

from .allocation import AllocationController, AllocationError, WorkerAllocation
from .device import DeviceController, DeviceEntry, NodeInfo
from .erl import ERLQuotaController, Observation, QuotaUpdate
from .framework import (Backend, ProcessMapping, WorkerDeviceRequest,
                        WorkerSpec, WorkerStatus)
from .limiter_binding import (ChargeResult, DeviceQuota, Limiter,
                              LimiterError, ShmView, list_worker_segments)
from .provider_binding import Provider, ProviderError
from .server import HypervisorServer
from .single_node import SingleNodeBackend
from .worker import TrackedWorker, WorkerController
