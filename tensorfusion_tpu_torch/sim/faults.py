"""Fault primitives for the digital twin.

The port's copy of ``tensorfusion_tpu/sim/faults.py``.

Each fault is a composable, seed-scheduled event against the REAL
store/controller stack: injection mutates the same objects (or pauses
the same delivery paths) a production failure would, and healing
restores them — the control plane must reconverge on its own.

Primitives (docs/simulation.md has the catalog):

- :class:`NodeCrash` / :class:`NodeFlap` — a node's phase leaves
  ``Running`` (and its chips fail with it); heal restores both.
- :class:`WatchStall` — named controllers stop draining their watch
  (the slow-watcher storm): backlog conflation and resync paths get
  exercised when delivery resumes.
- :class:`StoreLatency` — every store write pays an injected
  (simulated) latency: models journal/disk spikes without touching IO.
- :class:`Partition` — the operator loses the store: controllers,
  scheduler and sync all freeze; writers on the "client side" (traces)
  keep going.  Heal measures reconvergence from the backlog.
- :class:`ClockSkew` — wall clock steps by ``delta_s`` (monotonic time
  never moves backward — the invariant the clock tests pin).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List, Optional

from .. import constants
from ..api.types import Node, TPUChip
from ..store import ConflictError, mutate
from .harness import SimHarness

log = logging.getLogger("tpf.sim.faults")


@dataclass
class Fault:
    """Base: fires at ``at`` (sim seconds), heals after ``duration_s``
    when set.  ``schedule(harness)`` arms both edges as sim timers."""

    at: float = 0.0
    duration_s: Optional[float] = None
    name: str = "fault"

    def schedule(self, h: SimHarness) -> None:
        def fire():
            h.log_note("fault", self.name, "inject")
            self.inject(h)
            h.pump()
            if self.duration_s is not None:
                def heal():
                    h.log_note("fault", self.name, "heal")
                    self.heal(h)
                    h.pump()
                h.at(h.clock.monotonic() + self.duration_s, heal)
        h.at(self.at, fire)

    def inject(self, h: SimHarness) -> None:
        raise NotImplementedError

    def heal(self, h: SimHarness) -> None:
        raise NotImplementedError


@dataclass
class NodeCrash(Fault):
    """Node (and its chips) leave ``Running``; heal brings them back.
    The truthful model: the Pod objects bound to the node LINGER in the
    store — detecting and evicting them is the control plane's job."""

    node: str = ""
    name: str = "node-crash"

    def __post_init__(self):
        self.name = f"node-crash:{self.node}"

    def _set_phase(self, h: SimHarness, phase: str) -> None:
        def set_node(n):
            if n.status.phase == phase:
                return False
            n.status.phase = phase
        try:
            mutate(h.store, Node, self.node, set_node)
        except ConflictError:
            log.warning("sim: node %s phase flip lost a conflict fight",
                        self.node)
        for chip in h.store.list(
                TPUChip,
                selector=lambda c: c.status.node_name == self.node):
            def set_chip(c):
                if c.status.phase == phase:
                    return False
                c.status.phase = phase
            try:
                mutate(h.store, TPUChip, chip.name, set_chip)
            except ConflictError:
                pass    # the rollup re-stamps next pass

    def inject(self, h: SimHarness) -> None:
        self._set_phase(h, constants.PHASE_FAILED)

    def heal(self, h: SimHarness) -> None:
        self._set_phase(h, constants.PHASE_RUNNING)


@dataclass
class NodeFlap(Fault):
    """``count`` crash/heal cycles of ``period_s`` (down half, up half)."""

    node: str = ""
    period_s: float = 10.0
    count: int = 3
    name: str = "node-flap"

    def __post_init__(self):
        self.name = f"node-flap:{self.node}"

    def schedule(self, h: SimHarness) -> None:
        for i in range(self.count):
            NodeCrash(at=self.at + i * self.period_s,
                      duration_s=self.period_s / 2,
                      node=self.node).schedule(h)

    def inject(self, h: SimHarness) -> None:  # pragma: no cover
        pass

    def heal(self, h: SimHarness) -> None:  # pragma: no cover
        pass


@dataclass
class WatchStall(Fault):
    """The slow-watcher storm: the named controllers stop draining
    their watches; heal resumes delivery against the whole backlog."""

    controllers: List[str] = field(default_factory=list)
    name: str = "watch-stall"

    def inject(self, h: SimHarness) -> None:
        h.paused |= set(self.controllers)

    def heal(self, h: SimHarness) -> None:
        h.paused -= set(self.controllers)


@dataclass
class StoreLatency(Fault):
    """Every store write pays ``latency_s`` of *simulated* time (a
    journal fsync spike, a slow disk) — reconcile loops and the
    scheduler keep running during the stall via the cooperative sleep
    hook, so the latency reorders work the way a real spike would."""

    latency_s: float = 0.05
    name: str = "store-latency"
    _originals: dict = field(default_factory=dict, repr=False)

    def inject(self, h: SimHarness) -> None:
        store = h.store
        for op_name in ("create", "update", "delete"):
            original = getattr(store, op_name)
            self._originals[op_name] = original

            def slowed(*args, _original=original, **kwargs):
                h.clock.sleep(self.latency_s)
                return _original(*args, **kwargs)
            setattr(store, op_name, slowed)

    def heal(self, h: SimHarness) -> None:
        for op_name, original in self._originals.items():
            setattr(h.store, op_name, original)
        self._originals.clear()


@dataclass
class Partition(Fault):
    """Network partition between operator and remote store: every
    operator-side loop freezes (nothing can read OR write), while
    client-side writers keep mutating the store.  Heal lets the
    controllers face the accumulated backlog at once."""

    name: str = "partition"

    def inject(self, h: SimHarness) -> None:
        h.partitioned = True

    def heal(self, h: SimHarness) -> None:
        h.partitioned = False


@dataclass
class ClockSkew(Fault):
    """Wall clock steps by ``delta_s``; heal steps it back.  Monotonic
    time is unaffected by contract (SimClock.set_skew)."""

    delta_s: float = 0.0
    name: str = "clock-skew"

    def inject(self, h: SimHarness) -> None:
        h.clock.set_skew(self.delta_s)

    def heal(self, h: SimHarness) -> None:
        h.clock.set_skew(0.0)
