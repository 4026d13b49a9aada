"""Gang scheduling manager.

The port's copy of ``tensorfusion_tpu/scheduler/gang.py``.

Analog of the reference's annotation-driven PodGroups
(``internal/gang/manager.go``): PreEnqueue quorum gate (:509), Permit
wait-or-allow with a per-group waiting map (:746-882), group reject +
backoff on an unschedulable member (:262, :1099), timeout handling (:977).

A gang is declared with the ``tpu-fusion.ai/gang-*`` annotations stamped by
the admission webhook: group key, desired members, required members
(quorum), timeout, and strict mode.  On TPU pools gangs are the norm — an
SPMD job over a pod slice needs every host of the slice or none.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from .. import constants
from ..api.types import Pod
from ..clock import Clock, default_clock
from .framework import Code, OK, Status

log = logging.getLogger("tpf.scheduler.gang")

DEFAULT_GANG_TIMEOUT_S = 600.0

#: group reject backoff: exponential from BASE doubling per consecutive
#: reject up to MAX, reset when the gang schedules or gains a member
GANG_BACKOFF_BASE_S = 2.0
GANG_BACKOFF_MAX_S = 60.0


@dataclass
class GangGroup:
    key: str
    desired: int = 0
    required: int = 0
    strict: bool = False
    timeout_s: float = DEFAULT_GANG_TIMEOUT_S
    members: Set[str] = field(default_factory=set)       # observed pod keys
    waiting: Set[str] = field(default_factory=set)       # parked in Permit
    scheduled: Set[str] = field(default_factory=set)     # bound
    rejected_until: float = 0.0                          # group backoff
    reject_count: int = 0                                # consecutive rejects
    created_at: float = 0.0                              # stamped by observe()


def gang_info_from_pod(pod: Pod) -> Optional[Tuple[str, int, int, float, bool]]:
    ann = pod.metadata.annotations
    if ann.get(constants.ANN_GANG_ENABLED, "").lower() not in ("true", "1"):
        return None
    group_key = ann.get(constants.ANN_GANG_GROUP_KEY) or \
        f"{pod.metadata.namespace}/{ann.get(constants.ANN_WORKLOAD, pod.metadata.name)}"
    desired = int(ann.get(constants.ANN_GANG_DESIRED_MEMBERS, 0) or 0)
    required = int(ann.get(constants.ANN_GANG_REQUIRED_MEMBERS, 0) or
                   ann.get(constants.ANN_GANG_MIN_MEMBERS, 0) or desired)
    timeout = float(ann.get(constants.ANN_GANG_TIMEOUT,
                            DEFAULT_GANG_TIMEOUT_S) or DEFAULT_GANG_TIMEOUT_S)
    strict = ann.get(constants.ANN_GANG_MIN_MEMBERS, "") != "" and \
        required >= desired > 0
    return group_key, desired, required, timeout, strict


class GangManager:
    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or default_clock()
        self._lock = threading.RLock()
        self._groups: Dict[str, GangGroup] = {}
        self._pod_group: Dict[str, str] = {}
        # wired to the scheduler after construction
        self.allow_fn: Callable[[str], bool] = lambda key: False
        self.reject_fn: Callable[[str, str], bool] = lambda key, r: False
        self.activate_fn: Callable[[], None] = lambda: None
        self.status_sink: Optional[Callable[[GangGroup], None]] = None

    def bind_scheduler(self, scheduler) -> None:
        self.allow_fn = scheduler.allow_waiting
        self.reject_fn = scheduler.reject_waiting
        self.activate_fn = scheduler.activate
        # Keep gang waiting-sets honest when the scheduler rejects or times
        # out a parked pod for any reason.
        scheduler.permit_reject_listeners.append(self.on_permit_rejected)

    # -- membership -------------------------------------------------------

    def observe(self, pod: Pod) -> Optional[GangGroup]:
        info = gang_info_from_pod(pod)
        if info is None:
            return None
        group_key, desired, required, timeout, strict = info
        quorum_reached = False
        with self._lock:
            g = self._groups.get(group_key)
            if g is None:
                g = GangGroup(key=group_key, desired=desired,
                              required=required, timeout_s=timeout,
                              strict=strict,
                              created_at=self.clock.now())
                self._groups[group_key] = g
            else:
                g.desired = max(g.desired, desired)
                g.required = max(g.required, required)
            if pod.key() not in g.members:
                g.members.add(pod.key())
                # membership changed — what was unschedulable may fit now;
                # restart the backoff escalation from its base too
                g.rejected_until = 0.0
                g.reject_count = 0
                # the member that COMPLETES the quorum must requeue its
                # siblings: they were gated by pre_enqueue before quorum
                # existed, and without this wake-up the whole gang
                # live-locks until an unrelated event (historically the
                # allocator sync's chip write-backs — a 2s side channel
                # that vanishes on a quiet cluster; found by the twin's
                # thundering-herd scenario, tests/test_sim.py::
                # test_gang_quorum_completion_requeues_gated_members)
                quorum_reached = (g.required > 0
                                  and len(g.members) >= g.required)
            self._pod_group[pod.key()] = group_key
        if quorum_reached:
            self.activate_fn()      # outside _lock: re-enters enqueue
        with self._lock:
            return self._groups.get(group_key, g)

    def group_of(self, pod_key: str) -> Optional[GangGroup]:
        with self._lock:
            gk = self._pod_group.get(pod_key)
            return self._groups.get(gk) if gk else None

    # -- scheduler extension points ---------------------------------------

    def pre_enqueue(self, pod: Pod) -> Status:
        """Quorum gate: don't let gang members enter the scheduling queue
        until enough members exist (gang/manager.go:509)."""
        g = self.observe(pod)
        if g is None:
            return OK
        now = self.clock.now()
        if now < g.rejected_until:
            return Status(Code.UNSCHEDULABLE,
                          f"gang {g.key} backing off after reject")
        if g.required > 0 and len(g.members) < g.required:
            return Status(
                Code.UNSCHEDULABLE,
                f"gang {g.key} quorum {len(g.members)}/{g.required}")
        return OK

    def permit(self, pod: Pod) -> Tuple[Status, float]:
        """Wait-or-allow (gang/manager.go:746-882): the pod that completes
        the quorum releases every waiting member."""
        key = pod.key()
        with self._lock:
            g = self.group_of(key)
            if g is None:
                return OK, 0.0
            ready = len(g.waiting | {key}) + len(g.scheduled)
            if g.required > 0 and ready < g.required:
                g.waiting.add(key)
                return Status(Code.WAIT,
                              f"gang {g.key} waiting {ready}/{g.required}"), \
                    g.timeout_s
            # quorum complete: release everyone parked in Permit
            to_allow = list(g.waiting)
            g.waiting.clear()
        for waiting_key in to_allow:
            self.allow_fn(waiting_key)
        return OK, 0.0

    def on_bound(self, pod: Pod) -> None:
        with self._lock:
            g = self.group_of(pod.key())
            if g is None:
                return
            g.waiting.discard(pod.key())
            g.scheduled.add(pod.key())
            if len(g.scheduled) >= g.required:
                g.reject_count = 0      # gang formed; forget the backoff
            self._emit(g)

    def _backoff(self, g: GangGroup) -> None:
        """Exponential group backoff (caller holds the lock): repeated
        rejects of the same gang wait longer each time instead of
        hammering the queue every fixed interval."""
        g.reject_count += 1
        delay = min(GANG_BACKOFF_BASE_S * (2 ** (g.reject_count - 1)),
                    GANG_BACKOFF_MAX_S)
        g.rejected_until = self.clock.now() + delay

    def on_unschedulable(self, pod: Pod, reason: str) -> None:
        """Strict gangs: one member failing rejects the whole group
        (checkAndRejectGangIfNeeded, gang/manager.go:1099)."""
        with self._lock:
            g = self.group_of(pod.key())
            if g is None or not g.strict:
                return
            if pod.key() in g.scheduled:
                return
            waiting = list(g.waiting)
            g.waiting.clear()
            self._backoff(g)
        for key in waiting:
            self.reject_fn(key, f"strict gang rejected: {reason}")
        log.info("strict gang %s rejected (%s): bounced %d waiting members",
                 g.key, reason, len(waiting))
        self._emit(g)

    def on_permit_rejected(self, pod_key: str, reason: str) -> None:
        """Scheduler rejected/timed out a parked pod: drop it from the
        group's waiting set so quorum math stays truthful.  For a strict
        gang with nothing bound yet this is group-level cleanup: one
        bounced member means the gang cannot form this cycle, so every
        other parked member is bounced too (releasing its assumed chips)
        and the group backs off — instead of members timing out one by
        one, each holding capacity for the full permit window
        (gang/manager.go:977 timeout handling)."""
        to_bounce: List[str] = []
        with self._lock:
            g = self.group_of(pod_key)
            if g is None:
                return
            g.waiting.discard(pod_key)
            if g.strict and not g.scheduled and g.waiting:
                to_bounce = list(g.waiting)
                g.waiting.clear()
                self._backoff(g)
        # reject_fn re-enters this listener per pod; the waiting set is
        # already empty so each re-entry is a no-op discard
        for key in to_bounce:
            self.reject_fn(key, f"strict gang cleanup after {pod_key}: "
                                f"{reason}")

    def on_pod_deleted(self, pod_key: str) -> None:
        with self._lock:
            g = self.group_of(pod_key)
            if g is None:
                return
            g.members.discard(pod_key)
            g.waiting.discard(pod_key)
            g.scheduled.discard(pod_key)
            self._pod_group.pop(pod_key, None)
            if not g.members:
                self._groups.pop(g.key, None)
            else:
                self._emit(g)

    # -- probes / status --------------------------------------------------

    def is_waiting(self, pod_key: str) -> bool:
        """Probe for the allocator's assumed-TTL sweep
        (gangWaitingProbe, gpuallocator.go:389-395)."""
        with self._lock:
            g = self.group_of(pod_key)
            return g is not None and pod_key in g.waiting

    def groups(self) -> List[GangGroup]:
        with self._lock:
            return list(self._groups.values())

    def _emit(self, g: GangGroup) -> None:
        if self.status_sink is not None:
            try:
                self.status_sink(g)
            except Exception:
                log.exception("gang status sink failed")
