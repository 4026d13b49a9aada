"""Scheduling framework: plugin API + scheduling cycle.

The port's copy of ``tensorfusion_tpu/scheduler/framework.py``.

The reference embeds a patched kube-scheduler and registers out-of-tree
plugins (``cmd/sched/setup.go:62-183``); tpu-fusion has no Kubernetes, so
this module *is* the scheduler — a from-scratch implementation of the same
extension-point contract (PreEnqueue, PreFilter, Filter, PostFilter, Score,
Reserve, Permit, PreBind, Bind, PostBind, Unreserve) with an active queue,
an unschedulable set with event-driven requeue, and asynchronous Permit
waiting (gang members park without blocking the scheduling loop).
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple

from .. import constants
from ..api.types import Pod
from ..clock import Clock, default_clock

log = logging.getLogger("tpf.scheduler")


class Code(Enum):
    SUCCESS = "Success"
    UNSCHEDULABLE = "Unschedulable"
    WAIT = "Wait"
    ERROR = "Error"
    SKIP = "Skip"


@dataclass
class Status:
    code: Code = Code.SUCCESS
    reason: str = ""

    @property
    def ok(self) -> bool:
        return self.code in (Code.SUCCESS, Code.SKIP)


OK = Status()


class CycleState(dict):
    """Per-pod scheduling-cycle scratch space (CycleState analog)."""


#: a PreFilter plugin may narrow the node search space by storing a set of
#: node names here (kube-scheduler PreFilterResult analog)
STATE_PREFILTER_NODES = "prefilter/node_names"


class Plugin:
    name = "plugin"


class PreEnqueuePlugin(Plugin):
    def pre_enqueue(self, pod: Pod) -> Status: return OK


class PreFilterPlugin(Plugin):
    def pre_filter(self, state: CycleState, pod: Pod) -> Status: return OK


class FilterPlugin(Plugin):
    def filter(self, state: CycleState, pod: Pod, node: str) -> Status:
        return OK

    def filter_batch(self, state: CycleState, pod: Pod,
                     nodes) -> Optional[list]:
        """Optional vectorized filter: return the feasible subset of
        ``nodes`` (order preserved), or None to fall back to per-node
        ``filter()`` calls.  The scheduler takes the batch path only
        when EVERY registered FilterPlugin answers it — a plugin that
        needs per-node context just returns None."""
        return None


class PostFilterPlugin(Plugin):
    def post_filter(self, state: CycleState, pod: Pod,
                    statuses: Dict[str, Status]) -> Tuple[Optional[str], Status]:
        """May nominate a node (after preemption).  Returns (node, status)."""
        return None, Status(Code.UNSCHEDULABLE)


class ScorePlugin(Plugin):
    def score(self, state: CycleState, pod: Pod, node: str) -> float:
        return 0.0

    def score_batch(self, state: CycleState, pod: Pod, nodes):
        """Optional vectorized scoring: return a sequence of per-node
        scores aligned with ``nodes``, the scalar 0.0 meaning "this
        plugin contributes nothing this cycle" (saves building a zero
        vector), or None to fall back to per-node ``score()`` calls."""
        return None


class ReservePlugin(Plugin):
    def reserve(self, state: CycleState, pod: Pod, node: str) -> Status:
        return OK

    def unreserve(self, state: CycleState, pod: Pod, node: str) -> None:
        pass


class PermitPlugin(Plugin):
    def permit(self, state: CycleState, pod: Pod,
               node: str) -> Tuple[Status, float]:
        """Returns (status, wait_timeout_seconds)."""
        return OK, 0.0


class PreBindPlugin(Plugin):
    def pre_bind(self, state: CycleState, pod: Pod, node: str) -> Status:
        return OK


class PostBindPlugin(Plugin):
    def post_bind(self, state: CycleState, pod: Pod, node: str) -> None:
        pass


@dataclass
class _QueuedPod:
    priority: int
    ts: float
    pod: Pod = field(compare=False)
    gen: int = field(default=0, compare=False)

    def __lt__(self, other):
        return (-self.priority, self.ts) < (-other.priority, other.ts)


@dataclass
class WaitingPod:
    pod: Pod
    state: CycleState
    node: str
    deadline: float
    allowed: Optional[bool] = None
    reason: str = ""


class Scheduler:
    """One scheduling loop over our Pod objects.

    ``nodes_fn`` lists schedulable node names; ``bind_fn(pod, node)``
    persists the binding (sets pod.spec.node_name in the object store).
    """

    def __init__(self, nodes_fn: Callable[[], List[str]],
                 bind_fn: Callable[[Pod, str], None],
                 failure_handler: Optional[Callable[[Pod, str], None]] = None,
                 clock: Optional[Clock] = None,
                 tracer=None):
        self.nodes_fn = nodes_fn
        self.bind_fn = bind_fn
        self.failure_handler = failure_handler
        self.clock = clock or default_clock()
        #: optional tracing.Tracer: each scheduling cycle records a
        #: scheduler.schedule span on the pod's lifecycle trace
        #: (docs/tracing.md) — None disables span recording
        self.tracer = tracer
        self.plugins: List[Plugin] = []
        self._of_cache: Dict[type, List[Plugin]] = {}
        self._active: "queue.PriorityQueue[_QueuedPod]" = queue.PriorityQueue()
        self._unschedulable: Dict[str, Pod] = {}
        self._gated: Dict[str, Pod] = {}
        self._waiting: Dict[str, WaitingPod] = {}
        #: key -> generation of its newest queued entry.  A PriorityQueue
        #: can't remove or replace entries, so stale entries (older
        #: generation, or deleted pods — see _forgotten) are dropped at
        #: dequeue time by comparing generations.
        self._in_queue: Dict[str, int] = {}
        self._enqueue_gen = 0
        #: keys of deleted pods that were queued or mid-cycle when
        #: forget() ran — tombstoned and dropped at dequeue / park time
        #: (without this, a pod deleted while pending becomes a ghost
        #: that fails at bind and re-parks forever)
        self._forgotten: set = set()
        self._inflight: set = set()
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._timer: Optional[threading.Thread] = None
        # counters for benchmarks / metrics
        self.scheduled_count = 0
        self.failed_count = 0
        #: called with (pod_key, reason) whenever a parked pod is rejected
        self.permit_reject_listeners: List[Callable[[str, str], None]] = []

    # -- plugin registry --------------------------------------------------

    def register(self, plugin: Plugin) -> None:
        self.plugins.append(plugin)
        self._of_cache = {}

    def _of(self, cls) -> List[Plugin]:
        got = self._of_cache.get(cls)
        if got is None:
            got = [p for p in self.plugins if isinstance(p, cls)]
            self._of_cache[cls] = got
        return got

    # -- queue ------------------------------------------------------------

    def enqueue(self, pod: Pod) -> None:
        key = pod.key()
        for p in self._of(PreEnqueuePlugin):
            st = p.pre_enqueue(pod)
            if not st.ok:
                log.debug("pod %s gated by %s: %s", key, p.name, st.reason)
                with self._lock:
                    self._gated[key] = pod
                return
        with self._lock:
            if key in self._waiting:
                return
            if key in self._forgotten:
                # re-created under the same key: clear the tombstone and
                # supersede any stale queued entry with a new generation
                # (returning here would let dequeue consume the tombstone
                # and silently drop the recreated pod)
                self._forgotten.discard(key)
            elif key in self._in_queue:
                return
            self._enqueue_gen += 1
            gen = self._enqueue_gen
            self._in_queue[key] = gen
            self._unschedulable.pop(key, None)
            self._gated.pop(key, None)
        self._active.put(_QueuedPod(pod.spec.priority,
                                    self.clock.monotonic(), pod, gen))

    def activate(self) -> None:
        """Requeue unschedulable + gated pods (event-driven wakeup — the
        simplified analog of the reference's queueing hints,
        gpuresources.go:1042-1286)."""
        with self._lock:
            pods = list(self._unschedulable.values()) + \
                list(self._gated.values())
            self._unschedulable.clear()
            self._gated.clear()
        for pod in pods:
            self.enqueue(pod)

    def forget(self, pod_key: str) -> None:
        with self._lock:
            if pod_key in self._in_queue or pod_key in self._inflight:
                # can't pull it out of the PriorityQueue / running cycle:
                # tombstone it so dequeue/park drops it instead
                self._forgotten.add(pod_key)
            self._unschedulable.pop(pod_key, None)
            self._gated.pop(pod_key, None)
            w = self._waiting.pop(pod_key, None)
        if w is not None:
            self._finish_waiting(w, allowed=False, reason="pod deleted")

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="tpf-sched", daemon=True)
        self._thread.start()
        self._timer = threading.Thread(target=self._permit_timeout_loop,
                                       name="tpf-sched-permit", daemon=True)
        self._timer.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        if self._timer:
            self._timer.join(timeout=2)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._active.get(timeout=0.2)
            except queue.Empty:
                continue
            self._process(item)

    def _process(self, item: _QueuedPod) -> bool:
        """Run one dequeued entry's scheduling cycle (dropping stale /
        tombstoned entries).  Returns True when a cycle actually ran."""
        key = item.pod.key()
        with self._lock:
            if self._in_queue.get(key) != item.gen:
                return False   # superseded by a newer entry for this key
            del self._in_queue[key]
            if key in self._forgotten:
                self._forgotten.discard(key)   # deleted while queued
                return False
            self._inflight.add(key)
        try:
            self.schedule_one(item.pod)
        except Exception:
            log.exception("scheduling cycle for %s crashed", key)
        finally:
            with self._lock:
                self._inflight.discard(key)
        return True

    def run_until_idle(self, max_cycles: int = 100000) -> int:
        """Cooperative stepping (the digital twin's drive mode — no
        scheduler thread): drain the active queue synchronously.
        Returns the number of scheduling cycles run."""
        ran = 0
        while ran < max_cycles:
            try:
                item = self._active.get_nowait()
            except queue.Empty:
                return ran
            if self._process(item):
                ran += 1
        return ran

    # -- the scheduling cycle (SURVEY.md §3.3) ----------------------------

    def schedule_one(self, pod: Pod) -> Status:
        """One scheduling cycle, recorded as a ``scheduler.schedule``
        span on the pod's lifecycle trace when a tracer is wired."""
        if self.tracer is None:
            return self._schedule_cycle(pod)
        from ..tracing import pod_trace_context

        with self.tracer.span("scheduler.schedule",
                              parent=pod_trace_context(pod),
                              attrs={"pod": pod.key()}) as span:
            st = self._schedule_cycle(pod)
            span.set_attr("code", st.code.name)
            node = pod.status.nominated_node_name or pod.spec.node_name
            if node:
                span.set_attr("node", node)
            return st

    def _schedule_cycle(self, pod: Pod) -> Status:
        state = CycleState()
        key = pod.key()

        # PreFilter (an Unschedulable result still gets a PostFilter /
        # preemption attempt, matching kube-scheduler semantics)
        for p in self._of(PreFilterPlugin):
            st = p.pre_filter(state, pod)
            if st.code == Code.ERROR:
                return self._fail(pod, state, st)
            if not st.ok:
                return self._post_filter_or_unsched(pod, state, st, {})

        # Filter over all nodes (narrowed by PreFilterResult when
        # provided).  Two paths: when every FilterPlugin answers
        # filter_batch, the whole set is narrowed in a few vectorized/
        # set passes (no per-node plugin calls, no Status allocations —
        # the 1000-node hot path); otherwise the per-node loop with the
        # kube-style adaptive feasible cap.
        narrowed = state.get(STATE_PREFILTER_NODES)
        if narrowed is None:
            nodes = self.nodes_fn()
        elif isinstance(narrowed, (list, tuple)):
            nodes = narrowed    # identity preserved for batch alignment
        else:
            nodes = list(narrowed)
        # evaluate a preemptor's nominated node before everything else so
        # the adaptive feasible cap can never skip it (kube semantics)
        nominated = pod.status.nominated_node_name
        if nominated and nominated in nodes:
            nodes = [nominated] + [n for n in nodes if n != nominated]
        statuses: Dict[str, Status] = {}
        filter_plugins = self._of(FilterPlugin)
        feasible = nodes
        for p in filter_plugins:
            sub = p.filter_batch(state, pod, feasible)
            if sub is None:
                feasible = None
                break
            feasible = sub
        if feasible is None:
            # per-node fallback: stop once enough feasible nodes are
            # found on large clusters (numFeasibleNodesToFind)
            enough = self._num_feasible_to_find(len(nodes))
            feasible = []
            for node in nodes:
                node_st = OK
                for p in filter_plugins:
                    node_st = p.filter(state, pod, node)
                    if not node_st.ok:
                        break
                statuses[node] = node_st
                if node_st.ok:
                    feasible.append(node)
                    if len(feasible) >= enough:
                        break

        # PostFilter (preemption) when nothing fits
        if not feasible:
            return self._post_filter_or_unsched(
                pod, state,
                Status(Code.UNSCHEDULABLE, f"0/{len(nodes)} nodes feasible"),
                statuses)

        # A preemptor returns to the node its victims vacated: when the
        # nominated node is feasible, take it without re-scoring (kube
        # scheduler nominated-node preference).  The nomination is only
        # cleared on a successful bind — a Permit/Bind failure must not
        # destroy the preference the eviction paid for.
        if nominated and nominated in feasible:
            best = nominated
        else:
            best = self._pick_best(state, pod, feasible)

        # Reserve
        reserved: List[ReservePlugin] = []
        for p in self._of(ReservePlugin):
            st = p.reserve(state, pod, best)
            if not st.ok:
                for r in reversed(reserved):
                    r.unreserve(state, pod, best)
                return self._unsched(pod, state, st)
            reserved.append(p)

        # Permit
        max_wait = 0.0
        wait = False
        for p in self._of(PermitPlugin):
            st, timeout = p.permit(state, pod, best)
            if st.code == Code.WAIT:
                wait = True
                max_wait = max(max_wait, timeout)
            elif not st.ok:
                self._unreserve_all(state, pod, best)
                return self._unsched(pod, state, st)
        if wait:
            deadline = self.clock.monotonic() + (max_wait if max_wait > 0
                                                 else 3600.0)
            with self._lock:
                if key in self._forgotten:
                    # deleted mid-cycle: don't park a ghost holding its
                    # Reserve capacity until the permit deadline
                    self._forgotten.discard(key)
                    forgotten = True
                else:
                    forgotten = False
                    self._waiting[key] = WaitingPod(pod, state, best,
                                                    deadline)
            if forgotten:
                self._unreserve_all(state, pod, best)
                return Status(Code.UNSCHEDULABLE, "pod deleted")
            log.debug("pod %s waiting in Permit (%.0fs)", key, max_wait)
            return Status(Code.WAIT)

        return self._bind(pod, state, best)

    def _pick_best(self, state: CycleState, pod: Pod,
                   feasible) -> str:
        """Highest-scoring feasible node (first wins ties, matching the
        legacy strictly-greater loop).  Batch when every ScorePlugin
        answers score_batch; per-node otherwise."""
        if len(feasible) == 1:
            return feasible[0]
        score_plugins = self._of(ScorePlugin)
        totals = None
        batched = True
        for p in score_plugins:
            vals = p.score_batch(state, pod, feasible)
            if vals is None:
                batched = False
                break
            if isinstance(vals, float) and vals == 0.0:
                continue        # contributes nothing this cycle
            if totals is None:
                totals = vals
            else:
                totals = [a + b for a, b in zip(totals, vals)]
        if batched:
            if totals is None:
                return feasible[0]      # all plugins abstained: any tie
            argmax = getattr(totals, "argmax", None)
            if argmax is not None:      # numpy: first max in C
                return feasible[int(argmax())]
            return feasible[max(range(len(feasible)),
                                key=totals.__getitem__)]
        best, best_score = feasible[0], float("-inf")
        for node in feasible:
            total = 0.0
            for p in score_plugins:
                total += p.score(state, pod, node)
            if total > best_score:
                best, best_score = node, total
        return best

    # -- permit resolution ------------------------------------------------

    def allow_waiting(self, pod_key: str) -> bool:
        with self._lock:
            w = self._waiting.pop(pod_key, None)
        if w is None:
            return False
        self._finish_waiting(w, allowed=True)
        return True

    def reject_waiting(self, pod_key: str, reason: str = "") -> bool:
        with self._lock:
            w = self._waiting.pop(pod_key, None)
        if w is None:
            return False
        self._finish_waiting(w, allowed=False, reason=reason)
        return True

    def waiting_pods(self) -> List[str]:
        with self._lock:
            return list(self._waiting)

    def is_waiting(self, pod_key: str) -> bool:
        with self._lock:
            return pod_key in self._waiting

    def _finish_waiting(self, w: WaitingPod, allowed: bool,
                        reason: str = "") -> None:
        if allowed:
            self._bind(w.pod, w.state, w.node)
        else:
            for listener in self.permit_reject_listeners:
                try:
                    listener(w.pod.key(), reason)
                except Exception:
                    log.exception("permit-reject listener failed")
            self._unreserve_all(w.state, w.pod, w.node)
            self._unsched(w.pod, w.state,
                          Status(Code.UNSCHEDULABLE,
                                 reason or "rejected in Permit"))

    def _permit_timeout_loop(self) -> None:
        while not self._stop.wait(0.1):
            self.check_permit_timeouts()

    def check_permit_timeouts(self) -> None:
        """One pass over the Permit parking lot, rejecting pods past
        their deadline (the timer thread's body; the twin calls it
        directly after advancing simulated time)."""
        now = self.clock.monotonic()
        expired = []
        with self._lock:
            for key, w in list(self._waiting.items()):
                if now >= w.deadline:
                    expired.append(key)
        for key in expired:
            log.warning("pod %s timed out in Permit", key)
            self.reject_waiting(key, "permit timeout")

    # -- bind -------------------------------------------------------------

    def _bind(self, pod: Pod, state: CycleState, node: str) -> Status:
        for p in self._of(PreBindPlugin):
            st = p.pre_bind(state, pod, node)
            if not st.ok:
                self._unreserve_all(state, pod, node)
                return self._unsched(pod, state, st)
        try:
            self.bind_fn(pod, node)
        except Exception as e:  # noqa: BLE001
            self._unreserve_all(state, pod, node)
            return self._fail(pod, state, Status(Code.ERROR, str(e)))
        pod.spec.node_name = node
        pod.status.phase = constants.PHASE_RUNNING
        pod.status.nominated_node_name = ""   # preference consumed
        for p in self._of(PostBindPlugin):
            p.post_bind(state, pod, node)
        self.scheduled_count += 1
        log.debug("bound %s -> %s", pod.key(), node)
        return OK

    @staticmethod
    def _num_feasible_to_find(num_nodes: int) -> int:
        """Adaptive feasible-node cap (kube-scheduler's
        numFeasibleNodesToFind semantics: all nodes below 100, then a
        shrinking percentage with a floor of 100)."""
        if num_nodes <= 100:
            return num_nodes
        pct = max(5, 50 - num_nodes // 125)
        return max(100, num_nodes * pct // 100)

    def _post_filter_or_unsched(self, pod: Pod, state: CycleState,
                                st: Status,
                                statuses: Dict[str, Status]) -> Status:
        for p in self._of(PostFilterPlugin):
            nominated, pf_st = p.post_filter(state, pod, statuses)
            if pf_st.ok and nominated:
                pod.status.nominated_node_name = nominated
                return self._unsched(pod, state, Status(
                    Code.UNSCHEDULABLE,
                    f"nominated {nominated} after preemption"))
        return self._unsched(pod, state, st)

    def _unreserve_all(self, state: CycleState, pod: Pod, node: str) -> None:
        for p in reversed(self._of(ReservePlugin)):
            p.unreserve(state, pod, node)

    def _unsched(self, pod: Pod, state: CycleState, st: Status) -> Status:
        key = pod.key()
        log.debug("pod %s unschedulable: %s", key, st.reason)
        with self._lock:
            if key in self._forgotten:      # deleted mid-cycle: drop it
                self._forgotten.discard(key)
                return st
            self._unschedulable[key] = pod
        self.failed_count += 1
        if self.failure_handler is not None:
            try:
                self.failure_handler(pod, st.reason)
            except Exception:
                log.exception("failure handler for %s crashed", key)
        return st

    def _fail(self, pod: Pod, state: CycleState, st: Status) -> Status:
        key = pod.key()
        log.error("pod %s scheduling error: %s", key, st.reason)
        with self._lock:
            if key in self._forgotten:      # deleted mid-cycle: drop it
                self._forgotten.discard(key)
                return st
            self._unschedulable[key] = pod
        self.failed_count += 1
        return st
