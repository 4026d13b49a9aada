"""Injectable time: the port's copy of ``tensorfusion_tpu/clock.py``.

- :class:`Clock` — the contract: ``now()`` (wall seconds), a
  ``monotonic()`` timebase for deadlines/intervals, ``sleep()``, and
  ``wait()`` on a ``threading.Event``.
- :class:`WallClock` — production: delegates to :mod:`time`.
- :class:`SkewedClock` — a wall-skewed view over another clock (the
  digital twin injects per-replica clock skew through it).
- a process-wide **default clock** (:func:`default_clock`), swapped by
  tests and simulations through :func:`set_default_clock` /
  :func:`use_clock`.  Components take an explicit ``clock=`` parameter
  and resolve ``clock or default_clock()`` at construction.

The serving engine reads only ``monotonic()``, so a test drives it under
any object with that method (a manual clock advanced by hand).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional


class Clock:
    """The time contract threaded through the serving stack."""

    def now(self) -> float:
        """Wall-clock seconds since the epoch (timestamps, leases)."""
        raise NotImplementedError

    def now_ns(self) -> int:
        """``now()`` in nanoseconds (metrics line protocol)."""
        return int(self.now() * 1e9)

    def monotonic(self) -> float:
        """Monotonic seconds (deadlines, intervals): never jumps on
        skew — a lease TTL must not expire because NTP stepped."""
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def wait(self, event: threading.Event,
             timeout: Optional[float] = None) -> bool:
        """Wait up to ``timeout`` for ``event``; returns its state.
        The clock-routed form of ``stop_event.wait(interval)`` loops."""
        raise NotImplementedError


class WallClock(Clock):
    """Production clock: real time, real sleeps."""

    def now(self) -> float:
        return time.time()

    def now_ns(self) -> int:
        return time.time_ns()

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)

    def wait(self, event: threading.Event,
             timeout: Optional[float] = None) -> bool:
        return event.wait(timeout)



class SkewedClock(Clock):
    """A wall-skewed view over a base clock: ``now()`` is shifted by
    ``skew_s``, ``monotonic()`` is not (monotonic time never jumps).
    The twin gives each simulated replica its own skewed view of one
    :class:`~tensorfusion_tpu_torch.sim.SimClock` to model drifting nodes."""

    def __init__(self, base: Clock, skew_s: float = 0.0):
        self.base = base
        self.skew_s = skew_s

    def now(self) -> float:
        return self.base.now() + self.skew_s

    def monotonic(self) -> float:
        return self.base.monotonic()

    def sleep(self, seconds: float) -> None:
        self.base.sleep(seconds)

    def wait(self, event: threading.Event,
             timeout: Optional[float] = None) -> bool:
        return self.base.wait(event, timeout)


WALL = WallClock()

_default: Clock = WALL


def default_clock() -> Clock:
    """The process-wide clock components resolve when constructed
    without an explicit one."""
    return _default


def set_default_clock(clock: Clock) -> Clock:
    """Swap the default clock; returns the previous one.  Swapping while
    wall-clocked threads are running is the caller's responsibility."""
    global _default
    previous = _default
    _default = clock
    return previous


@contextlib.contextmanager
def use_clock(clock: Clock):
    """Scoped default-clock swap (tests)."""
    previous = set_default_clock(clock)
    try:
        yield clock
    finally:
        set_default_clock(previous)
