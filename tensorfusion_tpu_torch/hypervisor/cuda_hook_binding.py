"""ctypes reader of the launch and memory hook (``csrc/cuda_hook.c``), as
``limiter_binding`` is of the limiter.

The node agent preloads ``libtpf_cuda_hook.so`` into each worker; inside
that worker the hook's symbols are in the process's global scope, so
:func:`loaded` finds them with ``ctypes.CDLL(None)`` and returns None in a
process without the hook.
"""

from __future__ import annotations

import ctypes as C
import json
from typing import Optional


class CudaHook:
    def __init__(self, lib: C.CDLL):
        self._lib = lib
        lib.tpf_cuda_hook_metered.restype = C.c_uint8
        lib.tpf_cuda_hook_frozen.restype = C.c_uint8
        lib.tpf_cuda_hook_report.restype = C.c_int
        lib.tpf_cuda_hook_report.argtypes = (C.c_char_p, C.c_size_t)

    def metered(self) -> bool:
        """True once the hook has attached to a segment (this attaches it,
        as the first launch would)."""
        return bool(self._lib.tpf_cuda_hook_metered())

    def frozen(self) -> bool:
        return bool(self._lib.tpf_cuda_hook_frozen())

    def report(self) -> dict:
        """What ``tpf_cuda_hook_stats`` gives (the reference proxy's
        ``tpf_proxy_stats`` fields and the device time read) and the rest
        of the hook's totals, its settings, and the calls that reached each
        entry."""
        size = 1 << 14
        buf = C.create_string_buffer(size)
        if self._lib.tpf_cuda_hook_report(buf, size) < 0:
            raise RuntimeError("tpf_cuda_hook_report overflowed its buffer")
        return json.loads(buf.value.decode())


def loaded() -> Optional[CudaHook]:
    """The hook preloaded into this process, or None."""
    lib = C.CDLL(None)
    try:
        lib.tpf_cuda_hook_metered
    except AttributeError:
        return None
    return CudaHook(lib)
