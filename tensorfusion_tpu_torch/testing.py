"""Test utilities: mock-provider control surface + fresh-library loading.

The port's copy of ``tensorfusion_tpu/testing.py``.

The mock provider .so (``native/provider/mock``) exports a ``tpf_mock_*``
control surface so tests can inject simulated processes and utilization —
the analog of the reference's mock-driver-based hypervisor suite
(``pkg/hypervisor/hypervisor_suite_test.go`` against driver_mock.c).

Because a dlopened library is a per-path singleton, tests that need an
independently-configured simulated host copy the .so to a unique path first
(``fresh_library``).
"""

from __future__ import annotations

import ctypes as C
import os
import shutil
import tempfile

from .hypervisor.provider_binding import Provider


def fresh_library(lib_path: str, tag: str = "") -> str:
    """Copy a shared library to a unique temp path so dlopen loads an
    isolated instance (fresh globals, fresh env snapshot)."""
    d = tempfile.mkdtemp(prefix=f"tpflib_{tag or 'copy'}_")
    dst = os.path.join(d, os.path.basename(lib_path))
    shutil.copy2(lib_path, dst)
    return dst


class MockProviderControl:
    """ctypes wrapper over the tpf_mock_* test surface of the mock provider."""

    def __init__(self, provider: Provider):
        self._lib = provider._lib

    def reset(self) -> None:
        self._lib.tpf_mock_reset()

    def proc_set(self, pid: int, chip_id: str, duty_pct: float,
                 hbm_bytes: int) -> int:
        return self._lib.tpf_mock_proc_set(C.c_int64(pid), chip_id.encode(),
                                           C.c_double(duty_pct),
                                           C.c_uint64(hbm_bytes))

    def proc_remove(self, pid: int) -> int:
        return self._lib.tpf_mock_proc_remove(C.c_int64(pid))

    def tick(self, seconds: float) -> None:
        self._lib.tpf_mock_tick(C.c_double(seconds))

    def partition_count(self, chip_id: str) -> int:
        return self._lib.tpf_mock_partition_count(chip_id.encode())

    def hbm_hard_limit(self, chip_id: str) -> int:
        fn = self._lib.tpf_mock_hbm_hard_limit
        fn.restype = C.c_uint64
        return fn(chip_id.encode())

    def duty_hard_limit(self, chip_id: str) -> int:
        fn = self._lib.tpf_mock_duty_hard_limit
        fn.restype = C.c_uint32
        return fn(chip_id.encode())
