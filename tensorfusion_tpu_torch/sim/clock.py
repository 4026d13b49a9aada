"""SimClock: virtual time for the cluster digital twin.

The port's copy of ``tensorfusion_tpu/sim/clock.py``.

A :class:`~tensorfusion_tpu_torch.clock.Clock` whose time only moves when the
simulation advances it.  Design points (docs/simulation.md):

- **Single-threaded, cooperative.**  Nothing blocks: ``sleep(s)``
  *advances* virtual time by ``s`` (the sleeping actor is the only one
  running), firing any timers that fall due on the way.  An optional
  ``on_sleep`` hook lets the harness step other actors (scheduler,
  controllers) inside an actor's poll-sleep loop — that is how
  ``LiveMigrator.migrate``'s rebind wait converges in simulated time.
- **Timers are the event queue.**  ``call_at``/``call_later`` schedule
  callbacks on the monotonic timeline; ``advance_to`` fires them in
  (time, sequence) order, so two timers due at the same instant fire in
  scheduling order — runs are bit-for-bit reproducible.
- **Skew is wall-only.**  ``set_skew`` shifts ``now()`` (what lease
  timestamps and annotations see) without ever moving ``monotonic()``
  backward — the same contract NTP stepping has against
  ``CLOCK_MONOTONIC``.
"""

from __future__ import annotations

import heapq
import threading
from typing import Callable, List, Optional

from ..clock import Clock

#: sim wall-clock epoch: an arbitrary fixed origin so ``now()`` values
#: are stable across runs and machines (reproducible event logs)
SIM_EPOCH = 1_700_000_000.0


class TimerHandle:
    """Cancelable scheduled callback (``fn`` is dropped on cancel)."""

    __slots__ = ("due", "seq", "fn")

    def __init__(self, due: float, seq: int, fn: Optional[Callable]):
        self.due = due
        self.seq = seq
        self.fn = fn

    def cancel(self) -> None:
        self.fn = None

    def __lt__(self, other: "TimerHandle") -> bool:
        return (self.due, self.seq) < (other.due, other.seq)


class SimClock(Clock):
    def __init__(self, epoch: float = SIM_EPOCH):
        self._mono = 0.0
        self._epoch = epoch
        self._skew = 0.0
        self._timers: List[TimerHandle] = []
        self._seq = 0
        #: cooperative yield hook: called once per ``sleep()`` so the
        #: harness can run other ready actors while this one "sleeps"
        #: (guarded against reentrancy — a nested sleep just advances)
        self.on_sleep: Optional[Callable[[], None]] = None
        self._in_sleep_hook = False

    # -- Clock contract ---------------------------------------------------

    def now(self) -> float:
        return self._epoch + self._mono + self._skew

    def monotonic(self) -> float:
        return self._mono

    def sleep(self, seconds: float) -> None:
        self.advance(max(0.0, seconds))
        hook = self.on_sleep
        if hook is not None and not self._in_sleep_hook:
            self._in_sleep_hook = True
            try:
                hook()
            finally:
                self._in_sleep_hook = False

    def wait(self, event: threading.Event,
             timeout: Optional[float] = None) -> bool:
        if event.is_set():
            return True
        if timeout is None:
            # a truly unbounded wait can never return under virtual
            # time (no other thread will set the event) — surface the
            # misuse instead of spinning forever
            raise RuntimeError(
                "unbounded Event.wait() under SimClock — pass a timeout "
                "or drive the component from a sim timer")
        self.advance(max(0.0, timeout))
        return event.is_set()

    # -- skew (wall-only, injected by the ClockSkew fault) ----------------

    @property
    def skew_s(self) -> float:
        return self._skew

    def set_skew(self, skew_s: float) -> None:
        self._skew = skew_s

    # -- timers -----------------------------------------------------------

    def call_at(self, due_mono: float, fn: Callable[[], None]
                ) -> TimerHandle:
        self._seq += 1
        h = TimerHandle(max(due_mono, self._mono), self._seq, fn)
        heapq.heappush(self._timers, h)
        return h

    def call_later(self, delay: float, fn: Callable[[], None]
                   ) -> TimerHandle:
        return self.call_at(self._mono + max(0.0, delay), fn)

    def next_timer(self) -> Optional[float]:
        """Monotonic due time of the earliest pending timer."""
        while self._timers and self._timers[0].fn is None:
            heapq.heappop(self._timers)      # shed cancelled heads
        return self._timers[0].due if self._timers else None

    # -- advancing --------------------------------------------------------

    def advance(self, dt: float) -> None:
        self.advance_to(self._mono + max(0.0, dt))

    def advance_to(self, t_mono: float) -> None:
        """Move virtual time forward to ``t_mono``, firing every timer
        that falls due on the way (in due-time then scheduling order).
        Reentrant: a timer callback may sleep or schedule more timers —
        newly due ones fire within this same advance."""
        while self._timers and self._timers[0].due <= t_mono:
            h = heapq.heappop(self._timers)
            if h.fn is None:
                continue                      # cancelled
            if h.due > self._mono:
                self._mono = h.due
            fn, h.fn = h.fn, None
            fn()
        if t_mono > self._mono:
            self._mono = t_mono
