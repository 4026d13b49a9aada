"""TPUResourcesFit — the main scheduling plugin.

The port's copy of ``tensorfusion_tpu/scheduler/tpuresources.py``.

Analog of the reference's GPUResourcesFit
(``internal/scheduler/gpuresources/gpuresources.go:43-1286``), implementing
every extension point of the framework:

- PreEnqueue: gang quorum gate (delegated);
- PreFilter: compose the AllocRequest from pod annotations, run
  quota + filter chain over the in-memory chip store, compute per-node
  scores, write CycleState (:161-322);
- Filter: node must hold eligible chips (:377-575);
- PostFilter: preemption honoring eviction-protection, then strict-gang
  group reject (:711-757);
- Score: node score from the PreFilter result (:576-617);
- Reserve: pick the final chips (topology-plan override > strategy top-N)
  and ``assume`` them (:619-683); Unreserve rolls back;
- Permit: delegate to the gang manager (:758);
- PreBind: stamp allocation annotations + host port + pod index (:859-1014);
- PostBind: commit the allocation, notify the gang (:1016).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Tuple

from .. import constants
from ..allocator.core import (AllocationConflictError, ChipState,
                              InsufficientResourcesError, TPUAllocator)
from ..allocator.indexalloc import IndexAllocator
from ..allocator.portalloc import PortAllocator, PortExhaustedError
from ..allocator.quota import QuotaExceededError
from ..api.resources import (AllocRequest, GangConfig, ResourceAmount,
                             parse_quantity)
from ..api.types import Pod, native_chip_request
from ..clock import Clock, default_clock
from .framework import (Code, CycleState, FilterPlugin, OK, PermitPlugin, STATE_PREFILTER_NODES,
                        PostBindPlugin, PostFilterPlugin, PreBindPlugin,
                        PreEnqueuePlugin, PreFilterPlugin, ReservePlugin,
                        ScorePlugin, Status)
from .gang import GangManager, gang_info_from_pod
from .topo import STATE_ALLOC_REQUEST, STATE_CANDIDATES, STATE_TOPO_PLANS

log = logging.getLogger("tpf.scheduler.fit")

STATE_NODE_SCORES = "fit/node_scores"
STATE_ASSUMED = "fit/assumed"
STATE_NOMINATION = "fit/nomination"

#: how long a preemption nomination reserves its node against other pods
#: before it is considered stale (the preemptor normally re-schedules onto
#: the node well within this)
NOMINATION_TTL_S = 120.0


def _compose_native_request(pod: Pod) -> Optional[AllocRequest]:
    """Whole-chip AllocRequest for an unmanaged native TPU pod routed
    here by progressive migration (pod_webhook.go:128-134 analog).

    The pod carries no tpu-fusion annotations, but it WILL occupy whole
    chips through the native device path — so the allocator must hold
    them *exclusively* (no colocation, no oversubscription), or a vTPU
    workload would be placed onto the same silicon.
    Shared isolation: capacity bookkeeping only, no enforcement."""
    chips = native_chip_request(pod)
    if chips <= 0:
        return None
    return AllocRequest(
        pool="",
        namespace=pod.metadata.namespace,
        workload_name="",
        pod_name=pod.metadata.name,
        request=ResourceAmount(duty_percent=100.0),
        limit=ResourceAmount(duty_percent=100.0),
        chip_count=chips,
        isolation=constants.ISOLATION_SHARED,
        exclusive=True,
        qos=constants.DEFAULT_QOS)


def compose_alloc_request(pod: Pod,
                          include_native: bool = False
                          ) -> Optional[AllocRequest]:
    """Build an AllocRequest from the pod's annotation contract
    (ComposeAllocationRequest analog, gpuresources.go:161).

    ``include_native=True`` additionally synthesizes whole-chip requests
    for unannotated native TPU pods (progressive migration). Callers
    that must only see *managed* pods — defrag, compaction, live
    migration — keep the default: an unmanaged native pod is not ours
    to evict or migrate."""
    ann = pod.metadata.annotations
    if constants.ANN_TFLOPS_REQUEST not in ann and \
            constants.ANN_HBM_REQUEST not in ann:
        return _compose_native_request(pod) if include_native else None
    gang = GangConfig()
    info = gang_info_from_pod(pod)
    if info is not None:
        _, desired, required, timeout, strict = info
        gang = GangConfig(enabled=True, min_members=required,
                          timeout_seconds=timeout, strict=strict)
    indices = [int(x) for x in
               ann.get(constants.ANN_CHIP_INDICES, "").split(",") if x]
    return AllocRequest(
        pool=ann.get(constants.ANN_POOL, ""),
        namespace=pod.metadata.namespace,
        workload_name=ann.get(constants.ANN_WORKLOAD, ""),
        pod_name=pod.metadata.name,
        request=ResourceAmount(
            tflops=parse_quantity(ann.get(constants.ANN_TFLOPS_REQUEST, 0)
                                  or 0),
            duty_percent=float(ann.get(constants.ANN_DUTY_REQUEST, 0) or 0),
            hbm_bytes=parse_quantity(ann.get(constants.ANN_HBM_REQUEST, 0)
                                     or 0)),
        limit=ResourceAmount(
            tflops=parse_quantity(ann.get(constants.ANN_TFLOPS_LIMIT, 0)
                                  or 0),
            duty_percent=float(ann.get(constants.ANN_DUTY_LIMIT, 0) or 0),
            hbm_bytes=parse_quantity(ann.get(constants.ANN_HBM_LIMIT, 0)
                                     or 0)),
        chip_count=int(ann.get(constants.ANN_CHIP_COUNT, 1) or 1),
        generation=ann.get(constants.ANN_CHIP_GENERATION, ""),
        vendor=ann.get(constants.ANN_VENDOR, ""),
        chip_indices=indices,
        excluded_nodes=[n for n in
                        ann.get(constants.ANN_EXCLUDED_NODES, "").split(",")
                        if n],
        isolation=ann.get(constants.ANN_ISOLATION,
                          constants.DEFAULT_ISOLATION),
        exclusive=str(ann.get(constants.ANN_DEDICATED_CHIP, "")).lower()
        in ("true", "1", "yes", "on"),
        qos=ann.get(constants.ANN_QOS, constants.DEFAULT_QOS),
        partition_template=ann.get(constants.ANN_PARTITION_NAME, ""),
        gang=gang)


class TPUResourcesFit(PreEnqueuePlugin, PreFilterPlugin, FilterPlugin,
                      PostFilterPlugin, ScorePlugin, ReservePlugin,
                      PermitPlugin, PreBindPlugin, PostBindPlugin):
    name = "TPUResourcesFit"

    def __init__(self, allocator: TPUAllocator,
                 gang: Optional[GangManager] = None,
                 ports: Optional[PortAllocator] = None,
                 indices: Optional[IndexAllocator] = None,
                 pods_on_node: Optional[Callable[[str], List[Pod]]] = None,
                 evict: Optional[Callable[[Pod], None]] = None,
                 clock: Optional[Clock] = None):
        self.allocator = allocator
        self.gang = gang
        self.clock = clock or default_clock()
        self.ports = ports
        self.indices = indices
        self.pods_on_node = pods_on_node or (lambda node: [])
        self.evict = evict or (lambda pod: None)
        # preemptor pod key -> (node, priority, request, expiry); consulted
        # by Filter so another pod can't steal a freshly-preempted node
        # (nominated-pod double-booking check, gpuresources.go:377-575).
        # unreserve runs on non-scheduler threads (Permit timeout, gang
        # reject), so all access is lock-guarded and in-place — replacing
        # the dict could drop a reservation re-inserted concurrently.
        self._nominations: Dict[str, Tuple[str, int, AllocRequest,
                                           float]] = {}
        self._nominations_lock = threading.Lock()

    # -- PreEnqueue -------------------------------------------------------

    def pre_enqueue(self, pod: Pod) -> Status:
        if self.gang is not None:
            return self.gang.pre_enqueue(pod)
        return OK

    # -- PreFilter --------------------------------------------------------

    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        req = compose_alloc_request(pod, include_native=True)
        if req is None:
            return Status(Code.SKIP)
        state[STATE_ALLOC_REQUEST] = req
        try:
            by_node, rejections = self.allocator.check_quota_and_filter(req)
        except QuotaExceededError as e:
            return Status(Code.UNSCHEDULABLE, str(e))
        state[STATE_CANDIDATES] = by_node
        state[STATE_NODE_SCORES] = self.allocator.score_nodes(req, by_node)
        # the CandidateMap's cached tuple keeps identity with the batch
        # score path (NodeScores.aligned) — no per-cycle set build
        state[STATE_PREFILTER_NODES] = (
            by_node.eligible_nodes() if hasattr(by_node, "eligible_nodes")
            else set(by_node))
        if not by_node:
            if not rejections:
                # vectorized path carries no reasons; re-run explained
                _, rejections = self.allocator.check_quota_and_filter(
                    req, explain=True)
            sample = "; ".join(list(rejections.values())[:3])
            return Status(Code.UNSCHEDULABLE,
                          f"no eligible chips on any node ({sample})")
        return OK

    # -- Filter -----------------------------------------------------------

    def filter(self, state: CycleState, pod: Pod, node: str) -> Status:
        req = state.get(STATE_ALLOC_REQUEST)
        if req is None:
            return OK
        by_node = state.get(STATE_CANDIDATES, {})
        # membership only — materializing the chip list here would defeat
        # the lazy CandidateMap on large pools
        if node not in by_node:
            return Status(Code.UNSCHEDULABLE, f"no eligible chips on {node}")
        plans = state.get(STATE_TOPO_PLANS)
        if plans is not None and req.chip_count > 1 and node not in plans:
            return Status(Code.UNSCHEDULABLE,
                          f"no topology plan for {node}")
        return self._check_nominations(pod, req, node)

    def filter_batch(self, state: CycleState, pod: Pod, nodes):
        """Vectorized Filter: candidate-map membership + topology-plan
        membership in one pass, no per-node Status objects.  Falls back
        to per-node filter() (None) while preemption nominations are
        outstanding — those need the per-node virtual-hold dry run."""
        if self._nominations:
            return None     # rare: preemption window
        req = state.get(STATE_ALLOC_REQUEST)
        if req is None:
            return list(nodes) if not isinstance(nodes, (list, tuple)) \
                else nodes
        by_node = state.get(STATE_CANDIDATES, {})
        plans = state.get(STATE_TOPO_PLANS)
        need_plan = plans is not None and req.chip_count > 1
        eligible = getattr(by_node, "eligible_nodes", None)
        if eligible is not None and nodes is eligible():
            # nodes IS this cycle's eligible tuple (the common case):
            # membership is a given, only the plan check remains
            if not need_plan:
                return nodes
            return [n for n in nodes if n in plans]
        if need_plan:
            return [n for n in nodes if n in by_node and n in plans]
        return [n for n in nodes if n in by_node]

    def _check_nominations(self, pod: Pod, req: AllocRequest,
                           node: str) -> Status:
        """A node freshly freed by preemption is reserved for its
        preemptor: other pods may only pass Filter here if the node still
        fits them *with every equal-or-higher-priority nominee virtually
        placed first*."""
        if not self._nominations:
            return OK   # hot path: preemption is rare, Filter is not
        now = self.clock.monotonic()
        with self._nominations_lock:
            for k in [k for k, v in self._nominations.items()
                      if v[3] <= now]:
                del self._nominations[k]
            blockers = [v[2] for k, v in self._nominations.items()
                        if v[0] == node and k != pod.key()
                        and v[1] >= pod.spec.priority]
        if not blockers:
            return OK
        if self.allocator.dry_run_fit(req, node, virtual_holds=blockers):
            return OK
        return Status(Code.UNSCHEDULABLE,
                      f"node {node} reserved for {len(blockers)} "
                      f"nominated preemptor(s)")

    # -- PostFilter: preemption (:711-757 + patched DefaultPreemption) ----

    def post_filter(self, state, pod, statuses):
        req = state.get(STATE_ALLOC_REQUEST)
        if req is None:
            return None, Status(Code.UNSCHEDULABLE)
        nominated = self._try_preempt(req, pod)
        if nominated is not None:
            return nominated, OK
        if self.gang is not None:
            self.gang.on_unschedulable(pod, "unschedulable after PostFilter")
        return None, Status(Code.UNSCHEDULABLE, "preemption found no victims")

    def _try_preempt(self, req: AllocRequest, pod: Pod) -> Optional[str]:
        """Pick a node where evicting lower-priority, unprotected pods
        makes the request actually fit (verified by a per-chip dry run of
        the full filter chain against the post-eviction state); evict them
        and nominate the node — recording the nomination so Filter
        reserves the node for this pod."""
        if pod.spec.preemption_policy == "Never":
            return None
        nodes = {c.chip.status.node_name
                 for c in self.allocator.chips(req.pool or None)}
        best_node, best_victims = None, None
        for node in nodes:
            victims = self._victims_on_node(req, pod, node)
            if victims is None:
                continue
            if best_victims is None or len(victims) < len(best_victims):
                best_node, best_victims = node, victims
        if best_node is None:
            return None
        for v in best_victims:
            log.info("preempting %s on %s for %s", v.key(), best_node,
                     pod.key())
            self.evict(v)
        with self._nominations_lock:
            self._nominations[pod.key()] = (
                best_node, pod.spec.priority, req,
                self.clock.monotonic() + NOMINATION_TTL_S)
        return best_node

    def _victims_on_node(self, req: AllocRequest, pod: Pod,
                         node: str) -> Optional[List[Pod]]:
        """Smallest prefix of the node's evictable pods (lowest priority
        first) whose release makes the request fit the node per the full
        filter chain — per-chip shapes included, unlike aggregate
        shortfall math which can evict victims whose freed capacity the
        pod still cannot use."""
        node_chip_names = {c.chip.name for c in
                           self.allocator.chips(req.pool or None)
                           if c.chip.status.node_name == node}
        if not node_chip_names:
            return None
        candidates = []
        for p in self.pods_on_node(node):
            if p.spec.priority >= pod.spec.priority:
                continue
            if p.metadata.annotations.get(
                    constants.ANN_EVICTION_PROTECTION, "").lower() in (
                        "true", "1"):
                continue  # patched-preemption eviction-protection analog
            rec = self.allocator.allocation(p.key())
            if rec is None or not (set(rec.chip_ids) & node_chip_names):
                continue
            candidates.append((p, rec))
        if not candidates:
            return None
        if self.allocator.dry_run_fit(req, node):
            # Capacity is not the problem (the pod failed for quota /
            # gang / other reasons) — evicting anyone cannot help.
            return None
        # lowest priority first
        candidates.sort(key=lambda pr: pr[0].spec.priority)
        victims: List[Pod] = []
        released: set = set()
        for p, rec in candidates:
            victims.append(p)
            released.add(p.key())
            if self.allocator.dry_run_fit(req, node,
                                          release_keys=released):
                return victims
        return None

    # -- Score ------------------------------------------------------------

    def score(self, state: CycleState, pod: Pod, node: str) -> float:
        scores = state.get(STATE_NODE_SCORES) or {}
        return scores.get(node, 0.0)

    def score_batch(self, state: CycleState, pod: Pod, nodes):
        scores = state.get(STATE_NODE_SCORES)
        if not scores:
            return 0.0
        aligned = getattr(scores, "aligned", None)
        if aligned is not None:
            dense = aligned(nodes)
            if dense is not None:   # zero-copy: nodes is the eligible tuple
                return dense
        return [scores.get(n, 0.0) for n in nodes]

    # -- Reserve ----------------------------------------------------------

    def reserve(self, state: CycleState, pod: Pod, node: str) -> Status:
        req = state.get(STATE_ALLOC_REQUEST)
        if req is None:
            return OK
        by_node = state.get(STATE_CANDIDATES, {})
        chips: List[ChipState] = by_node.get(node, [])
        plans = state.get(STATE_TOPO_PLANS)
        if plans and node in plans:
            wanted = set(plans[node].chip_names)
            planned = [c for c in chips if c.chip.name in wanted]
            if len(planned) == req.chip_count:
                chips = planned  # topology override (:645-648)
        try:
            chosen = self.allocator.select(req, chips)
            self.allocator.assume(req, chosen)
        except (InsufficientResourcesError, AllocationConflictError,
                QuotaExceededError) as e:
            return Status(Code.UNSCHEDULABLE, f"reserve failed: {e}")
        state[STATE_ASSUMED] = [c.chip.name for c in chosen]
        # The preemptor holds real (assumed) chips now; suspend its node
        # reservation so other pods' nomination checks don't double-count
        # it on top of the assumed hold.  Unreserve restores it — a
        # Permit timeout or PreBind failure must not leave the freshly
        # freed node up for grabs.
        with self._nominations_lock:
            nom = self._nominations.pop(pod.key(), None)
        if nom is not None:
            state[STATE_NOMINATION] = nom
        return OK

    def unreserve(self, state: CycleState, pod: Pod, node: str) -> None:
        req = state.get(STATE_ALLOC_REQUEST)
        if req is not None and state.get(STATE_ASSUMED):
            self.allocator.unassume(req.key())
            state.pop(STATE_ASSUMED, None)
        nom = state.pop(STATE_NOMINATION, None)
        if nom is not None and nom[3] > self.clock.monotonic():
            with self._nominations_lock:
                self._nominations[pod.key()] = nom

    # -- Permit -----------------------------------------------------------

    def permit(self, state: CycleState, pod: Pod,
               node: str) -> Tuple[Status, float]:
        if self.gang is not None:
            return self.gang.permit(pod)
        return OK, 0.0

    # -- PreBind ----------------------------------------------------------

    def pre_bind(self, state: CycleState, pod: Pod, node: str) -> Status:
        req = state.get(STATE_ALLOC_REQUEST)
        if req is None:
            return OK
        record = self.allocator.allocation(req.key())
        if record is None:
            return Status(Code.ERROR, "no assumed allocation at PreBind")
        self.allocator.stamp_pod(pod, record)
        if self.indices is not None:
            idx = self.indices.assign(pod.key())
            pod.metadata.annotations[constants.ANN_POD_INDEX] = str(idx)
        if pod.metadata.labels.get(constants.LABEL_HOST_PORT) == \
                constants.LABEL_HOST_PORT_AUTO and self.ports is not None:
            try:
                port = self.ports.assign_node_port(node, pod.key())
            except PortExhaustedError as e:
                return Status(Code.UNSCHEDULABLE, str(e))
            pod.metadata.annotations[constants.ANN_PORT_NUMBER] = str(port)
        return OK

    # -- PostBind ---------------------------------------------------------

    def post_bind(self, state: CycleState, pod: Pod, node: str) -> None:
        req = state.get(STATE_ALLOC_REQUEST)
        if req is None:
            return
        try:
            self.allocator.commit(req.key())
        except KeyError:
            log.error("PostBind: allocation for %s vanished", req.key())
        if self.gang is not None:
            self.gang.on_bound(pod)
