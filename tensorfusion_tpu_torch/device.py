"""The explicit-device rule of the port.

Every entry point takes a ``device`` that defaults to ``"cuda"``.  Asking
for CUDA on a machine without a usable card raises; nothing falls back to
the CPU on its own.  The CPU runs only where the caller asks for it (the
tests do), and there the kernels' plain PyTorch versions run.

:data:`DEVICE_GATE` is the process's one rule for who may touch the card
while a CUDA graph is being captured: eager device work (the serving
runners' prefills and page moves, the remote worker's copies, module
calls and fetches) enters it shared, a capture enters it alone.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


class _CaptureGate:
    """Eager device work enters shared; a graph capture enters alone,
    once the shared holders have left, and holds new ones off until it
    is done."""

    def __init__(self):
        self._cv = threading.Condition()
        self._shared = 0
        self._capturing = False     # a capture holds or waits for the gate

    @contextlib.contextmanager
    def shared(self):
        with self._cv:
            while self._capturing:
                self._cv.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cv:
                self._shared -= 1
                self._cv.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cv:
            while self._capturing:
                self._cv.wait()
            self._capturing = True
            while self._shared:
                self._cv.wait()
        try:
            yield
        finally:
            with self._cv:
                self._capturing = False
                self._cv.notify_all()


#: one gate for all device work of the process (they share the card)
DEVICE_GATE = _CaptureGate()
