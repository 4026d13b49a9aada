"""TPU allocator: the in-memory device store + allocation state machine.

The port's copy of ``tensorfusion_tpu/allocator/core.py``.

Analog of the reference's ``internal/gpuallocator/gpuallocator.go`` (3.1k
LoC Go), the heart of the control plane.  Same state machine, TPU resources:

- stores: chip store, node->chips, pool->chips, pod->allocation
  (``gpuStore``/``nodeGpuStore``/``poolGpuStore``/``uniqueAllocation``,
  gpuallocator.go:276-328);
- two-phase allocation: ``assume`` holds capacity+quota during the
  scheduler's Reserve->Bind window (TTL-swept, :1078, :1348), ``commit``
  finalizes on bind (:1137);
- ``check_quota_and_filter`` (:1426) runs the quota check + filter chain and
  returns per-node candidates with rejection reasons (simulate-schedule);
- ``adjust_allocation`` (:1600) performs live vertical resize with capacity
  and quota dry-run;
- ``reconcile`` (:2592) rebuilds all allocation state from pod annotations
  after an operator restart;
- ``sync_to_store`` (:2309) batch-flushes dirty chip status to the object
  store.

Capacity model: virtual TFLOPs = peak x pool oversell ratio (MXU time is
time-sliced by the ERL limiter, so overselling compute is safe); HBM stays
physical per chip.
"""

from __future__ import annotations

import json
import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .. import constants
from ..clock import Clock, default_clock
from ..api.resources import AdjustRequest, AllocRequest, ResourceAmount
from ..api.types import Pod, TPUChip
from ..store import ConflictError, NotFoundError, ObjectStore
from .partition_planner import (PartitionPlanRegistry, Placement,
                                TemplateSpec)
from .filters import (Filter, FilterResult, NodeAffinityFilter,
                      NodeExclusionFilter, PartitionFitFilter, default_chain,
                      run_filters)
from .quota import QuotaExceededError, QuotaStore
from .strategy import Strategy, new_strategy
from .vecview import CandidateMap, PoolVectorView

#: below this chip count the plain Python filter chain is used (it is fast
#: enough and produces rejection reasons for free)
VECTORIZE_THRESHOLD = 64

log = logging.getLogger("tpf.allocator")

DEFAULT_ASSUME_TTL_S = 120.0


class AllocationConflictError(Exception):
    pass


class InsufficientResourcesError(Exception):
    pass


@dataclass
class AllocRecord:
    request: AllocRequest
    chip_ids: List[str]
    assumed: bool = True
    #: wall timestamp stamped by the allocator's clock at allocation
    assumed_at: float = 0.0
    partitions: Dict[str, str] = field(default_factory=dict)  # chip -> part id

    @property
    def key(self) -> str:
        return self.request.key()


class ChipState:
    """Mutable allocator-side state for one TPUChip."""

    def __init__(self, chip: TPUChip, oversell_ratio: float = 1.0,
                 template_cores: Optional[Dict[str, int]] = None,
                 hbm_expand_ratio: float = 1.0,
                 partition_registry: Optional[PartitionPlanRegistry]
                 = None):
        self.chip = chip
        self.oversell_ratio = oversell_ratio
        #: schedulable-HBM multiplier from the pool's host-expansion config
        #: (gpupool_types.go:64-77 vramExpandToHostMem/Disk analog): the
        #: slack beyond 1.0 is host-RAM/disk-backed — workers placed into
        #: it must spill (client runtime host offload), surfaced per chip
        #: as the hbm_spill_bytes metric
        self.hbm_expand_ratio = hbm_expand_ratio
        self._template_cores = template_cores or {}
        self.partition_registry = partition_registry or \
            PartitionPlanRegistry()
        self.allocated = ResourceAmount()
        self.holders: Dict[str, ResourceAmount] = {}   # pod key -> per-chip amt
        self.exclusive_keys: set = set()   # holders that own the whole chip
        self.partition_cores_used = 0
        #: pod key -> concrete core placement (planner bitmask arithmetic)
        self.partition_placements: Dict[str, Placement] = {}
        #: pod key -> template isolation group (must not mix on one chip)
        self.partition_groups: Dict[str, str] = {}
        self._avail_cache: Optional[ResourceAmount] = None

    # -- capacity ---------------------------------------------------------

    def virtual_capacity(self) -> ResourceAmount:
        cap = self.chip.status.capacity
        return ResourceAmount(tflops=cap.tflops * self.oversell_ratio,
                              duty_percent=100.0 * self.oversell_ratio,
                              hbm_bytes=cap.hbm_bytes
                              * self.hbm_expand_ratio)

    def hbm_spill_bytes(self) -> float:
        """Allocated HBM beyond the chip's physical capacity — the
        host-backed (spill) portion of the expansion budget in use."""
        return max(0.0, self.allocated.hbm_bytes
                   - self.chip.status.capacity.hbm_bytes)

    def available(self) -> ResourceAmount:
        if self._avail_cache is None:
            self._avail_cache = self.virtual_capacity().sub(self.allocated)
        return self._avail_cache

    def invalidate(self) -> None:
        self._avail_cache = None

    # -- partition helpers ------------------------------------------------

    def template_core_count(self, template_id: str) -> Optional[int]:
        if template_id in self._template_cores:
            return self._template_cores[template_id]
        # "-<n>c" convention parsing lives in the planner registry
        spec = self.partition_registry.spec(template_id)
        return spec.core_count if spec is not None else None

    def free_partition_cores(self) -> int:
        return max(0, self.chip.status.core_count
                   - self.partition_cores_used)

    def plan_partition(self, template_id: str) -> Optional[Placement]:
        """Planner verdict: concrete core placement for the template on
        this chip's current occupancy, or None (fragmentation and
        isolation-group conflicts included — stricter than free-count
        math, partition_strategy.go analog)."""
        return self.partition_registry.plan(
            template_id, self.chip.status.core_count,
            self.partition_placements, self.partition_groups)

    # -- mutation ---------------------------------------------------------

    def hold(self, key: str, amount: ResourceAmount,
             partition_template: str = "", exclusive: bool = False) -> None:
        if key in self.holders:
            raise AllocationConflictError(
                f"{key} already holds chip {self.chip.name}")
        # exclusivity is re-checked here (not only in the filter): a
        # concurrent allocation can take the chip between Filter and
        # Assume, and an exclusive hold must never share silicon
        if self.exclusive_keys:
            raise InsufficientResourcesError(
                f"chip {self.chip.name} exclusively held")
        if exclusive and self.holders:
            raise InsufficientResourcesError(
                f"chip {self.chip.name} not empty for exclusive hold")
        # tflops and duty% are two denominations of the same MXU time;
        # a hold expressed in only one must deplete both, or a duty-only
        # hold (proxied native pod, unknown-generation migration) would
        # reserve nothing against tflops-denominated requests. Here the
        # chip's own capacity is known, so the conversion is exact.
        cap = self.chip.status.capacity
        if cap.tflops > 0:
            if amount.duty_percent > 0 and amount.tflops <= 0:
                amount = ResourceAmount(
                    tflops=amount.duty_percent / 100.0 * cap.tflops,
                    duty_percent=amount.duty_percent,
                    hbm_bytes=amount.hbm_bytes)
            elif amount.tflops > 0 and amount.duty_percent <= 0:
                amount = ResourceAmount(
                    tflops=amount.tflops,
                    duty_percent=min(100.0,
                                     amount.tflops / cap.tflops * 100.0),
                    hbm_bytes=amount.hbm_bytes)
        placement = None
        if partition_template:
            placement = self.plan_partition(partition_template)
            if placement is None:
                raise InsufficientResourcesError(
                    f"no placement for template {partition_template} on "
                    f"chip {self.chip.name}")
        self.holders[key] = amount
        if exclusive:
            self.exclusive_keys.add(key)
        self.allocated = self.allocated.add(amount)
        self._avail_cache = None
        if placement is not None:
            self.partition_placements[key] = placement
            spec = self.partition_registry.spec(partition_template)
            self.partition_groups[key] = spec.isolation_group if spec \
                else ""
            self.partition_cores_used += placement.core_count

    def drop(self, key: str, partition_template: str = "") -> None:
        amount = self.holders.pop(key, None)
        if amount is None:
            return
        self.exclusive_keys.discard(key)
        self.allocated = self.allocated.sub(amount)
        self._avail_cache = None
        placement = self.partition_placements.pop(key, None)
        self.partition_groups.pop(key, None)
        if placement is not None:
            self.partition_cores_used = max(
                0, self.partition_cores_used - placement.core_count)
        elif partition_template:
            cores = self.template_core_count(partition_template) or 0
            self.partition_cores_used = max(
                0, self.partition_cores_used - cores)


class TPUAllocator:
    def __init__(self, store: Optional[ObjectStore] = None,
                 quota_store: Optional[QuotaStore] = None,
                 node_labels: Optional[Callable[[str], Dict[str, str]]] = None,
                 assume_ttl_s: float = DEFAULT_ASSUME_TTL_S,
                 clock: Optional[Clock] = None):
        self.store = store
        self.clock = clock or default_clock()
        self.quota = quota_store or QuotaStore(store)
        self.assume_ttl_s = assume_ttl_s
        self._lock = threading.RLock()
        self._chips: Dict[str, ChipState] = {}
        self._node_chips: Dict[str, set] = {}
        self._pool_chips: Dict[str, set] = {}
        self._allocations: Dict[str, AllocRecord] = {}
        self._dirty: set = set()
        self._pool_oversell: Dict[str, float] = {}
        self._pool_hbm_expand: Dict[str, float] = {}
        self._partition_registry = PartitionPlanRegistry()
        self._template_cores: Dict[str, int] = {}
        self._node_labels = node_labels or (lambda node: {})
        self._filters: List[Filter] = default_chain(
            lambda n: self._node_labels(n))
        self._strategies: Dict[str, Strategy] = {}
        self._gang_waiting_probe: Callable[[str], bool] = lambda key: False
        self._views: Dict[str, PoolVectorView] = {}
        #: pool -> cached chips() snapshot (invalidated with _views)
        self._chips_list_cache: Dict[str, List[ChipState]] = {}

    # -- configuration ----------------------------------------------------

    def set_pool_oversell(self, pool: str, percent: float) -> None:
        with self._lock:
            self._pool_oversell[pool] = max(percent, 100.0) / 100.0
            for name in self._pool_chips.get(pool, ()):  # re-rate chips
                state = self._chips[name]
                state.oversell_ratio = self._pool_oversell[pool]
                state.invalidate()
            self._views.clear()
            self._chips_list_cache.clear()

    def set_pool_hbm_expansion(self, pool: str, host_mem_percent: float,
                               host_disk_percent: float) -> None:
        """Schedulable HBM = physical * (1 + mem% + disk%): the expansion
        slack is host-backed, consumed by workers whose budget exceeds
        their physical share (gpupool_types.go:64-77 analog)."""
        from ..api.types import hbm_expansion_ratio

        with self._lock:
            ratio = hbm_expansion_ratio(host_mem_percent, host_disk_percent)
            self._pool_hbm_expand[pool] = ratio
            for name in self._pool_chips.get(pool, ()):
                state = self._chips[name]
                state.hbm_expand_ratio = ratio
                state.invalidate()
            self._views.clear()
            self._chips_list_cache.clear()

    def set_pool_strategy(self, pool: str, placement_mode: str) -> None:
        with self._lock:
            self._strategies[pool] = new_strategy(placement_mode)

    def set_template_cores(self, mapping: Dict[str, int]) -> None:
        with self._lock:
            self._template_cores.update(mapping)
            for template_id, cores in mapping.items():
                # never stomp a full spec (isolation group) already
                # registered via set_partition_templates
                existing = self._partition_registry.spec(template_id)
                group = existing.isolation_group if existing else ""
                self._partition_registry.register(
                    TemplateSpec(template_id, core_count=cores,
                                 isolation_group=group))

    def set_partition_templates(self, specs) -> None:
        """Register full template specs (incl. isolation groups) with the
        placement planner (ProviderConfig partition templates)."""
        with self._lock:
            for spec in specs:
                if not isinstance(spec, TemplateSpec):
                    spec = TemplateSpec(
                        template_id=spec.template_id,
                        core_count=getattr(spec, "core_count", 1),
                        isolation_group=getattr(spec, "isolation_group",
                                                ""))
                self._partition_registry.register(spec)
                self._template_cores[spec.template_id] = spec.core_count

    def set_gang_waiting_probe(self, probe: Callable[[str], bool]) -> None:
        """Probe asked before TTL-sweeping an assumed allocation — gang
        members legitimately wait in Permit (gpuallocator.go:389-395)."""
        self._gang_waiting_probe = probe

    # -- chip inventory ---------------------------------------------------

    def upsert_chip(self, chip: TPUChip) -> None:
        with self._lock:
            state = self._chips.get(chip.name)
            pool = chip.status.pool
            ratio = self._pool_oversell.get(pool, 1.0)
            hbm_ratio = self._pool_hbm_expand.get(pool, 1.0)
            if state is None:
                state = ChipState(chip, ratio, self._template_cores,
                                  hbm_expand_ratio=hbm_ratio,
                                  partition_registry=
                                  self._partition_registry)
                self._chips[chip.name] = state
            else:
                # migrate index entries when the chip moved pool/node —
                # stale membership would leak it into the old pool's
                # candidate lists (and KeyError after removal)
                old = state.chip.status
                if old.pool != pool:
                    self._pool_chips.get(old.pool, set()).discard(
                        chip.name)
                if old.node_name != chip.status.node_name:
                    self._node_chips.get(old.node_name, set()).discard(
                        chip.name)
                state.chip = chip
                state.oversell_ratio = ratio
                state.hbm_expand_ratio = hbm_ratio
            state.invalidate()
            self._node_chips.setdefault(chip.status.node_name,
                                        set()).add(chip.name)
            self._pool_chips.setdefault(pool, set()).add(chip.name)
            self._views.clear()
            self._chips_list_cache.clear()

    def remove_chip(self, name: str) -> None:
        with self._lock:
            state = self._chips.pop(name, None)
            if state is None:
                return
            self._node_chips.get(state.chip.status.node_name,
                                 set()).discard(name)
            self._pool_chips.get(state.chip.status.pool, set()).discard(name)
            self._views.clear()
            self._chips_list_cache.clear()

    def chips(self, pool: Optional[str] = None) -> List[ChipState]:
        """Chip states of a pool (all when pool is None).  The returned
        list is a cached snapshot rebuilt on inventory change — callers
        must not mutate it (it is rebuilt, not copied, on the PreFilter
        hot path once per scheduling cycle)."""
        key = pool   # None (all chips) is a valid dict key of its own —
        # `pool or "*"` would conflate pool="" with the all-chips entry
        with self._lock:
            got = self._chips_list_cache.get(key)
            if got is None:
                if pool is None:
                    got = list(self._chips.values())
                else:
                    got = [self._chips[n]
                           for n in self._pool_chips.get(pool, ())]
                self._chips_list_cache[key] = got
            return got

    def get_chip(self, name: str) -> Optional[ChipState]:
        with self._lock:
            return self._chips.get(name)

    def gang_slice_ids(self, gang_key: str) -> set:
        """Slice ids of chips already held by members of a gang
        (``gang_key`` = "<ns>/<workload>", the webhook's gang-group key).

        TPU-first scheduling input with no reference analog: a
        multi-host TPU slice (e.g. v5e-256 = 64 hosts) is one ICI
        fabric, so an SPMD gang spanning hosts should stay inside ONE
        slice — cross-slice traffic rides DCN. The topology plugin uses
        this to give same-slice nodes a scoring bonus once the first
        member lands."""
        ns, _, wl = gang_key.partition("/")
        out: set = set()
        with self._lock:
            for rec in self._allocations.values():
                r = rec.request
                if r.namespace != ns or r.workload_name != wl:
                    continue
                for cid in rec.chip_ids:
                    st = self._chips.get(cid)
                    if st is not None and st.chip.status.slice_id:
                        out.add(st.chip.status.slice_id)
        return out

    def node_slice_ids(self, node: str) -> set:
        """Slice ids present on one node — O(chips-per-host), i.e. <=8
        set lookups; the topology plugin's slice-affinity scoring calls
        this per feasible node instead of materializing candidate chip
        lists (which the lazy CandidateMap exists to avoid)."""
        with self._lock:
            return {self._chips[c].chip.status.slice_id
                    for c in self._node_chips.get(node, ())
                    if c in self._chips
                    and self._chips[c].chip.status.slice_id}

    def allocation(self, key: str) -> Optional[AllocRecord]:
        with self._lock:
            return self._allocations.get(key)

    def allocations(self) -> List[AllocRecord]:
        with self._lock:
            return list(self._allocations.values())

    # -- filtering / scoring (PreFilter path) ------------------------------

    def check_quota_and_filter(self, req: AllocRequest, explain: bool = False,
                               skip_quota: bool = False
                               ) -> Tuple[Dict[str, List[ChipState]],
                                          Dict[str, str]]:
        """Quota gate + filter chain.  Returns ({node: [chips]}, rejections).
        Raises QuotaExceededError when the namespace quota cannot admit the
        request (gpuallocator.go:1426 analog).

        skip_quota=True runs a capacity-only dry-run (defrag probes: the
        evicted pod's own quota is still committed, so re-checking quota
        would double-count it).

        Large pools go through the vectorized mask path (rejection reasons
        then require explain=True, which forces the Python chain — used by
        the simulate-schedule API)."""
        if not skip_quota:
            self.quota.check(req)
        with self._lock:
            candidates = self.chips(req.pool or None)
            if not explain and len(candidates) > VECTORIZE_THRESHOLD:
                return self._vector_filter(req), {}
            result = run_filters(self._filters, req, candidates)
            by_node: Dict[str, List[ChipState]] = {}
            for chip in result.chips:
                by_node.setdefault(chip.chip.status.node_name,
                                   []).append(chip)
            if req.same_node and req.chip_count > 1:
                for node in [n for n, chips in by_node.items()
                             if len(chips) < req.chip_count]:
                    for c in by_node[node]:
                        result.rejections[c.chip.name] = (
                            f"[same-node] node {node} has only "
                            f"{len(by_node[node])} eligible chips, "
                            f"need {req.chip_count}")
                    del by_node[node]
            return by_node, result.rejections

    def _vector_filter(self, req: AllocRequest) -> CandidateMap:
        """Masked filtering over the pool's vector view (caller holds the
        lock)."""
        pool_key = req.pool or "*"
        view = self._views.get(pool_key)
        if view is None:
            view = PoolVectorView(self.chips(req.pool or None))
            self._views[pool_key] = view
        mask = view.survivors(req)
        # Rare constraint kinds fall back to per-chip Python checks on the
        # survivors only.
        if req.node_affinity or req.excluded_nodes or \
                req.isolation == constants.ISOLATION_PARTITIONED:
            import numpy as np
            extra = []
            if req.node_affinity:
                extra.append(NodeAffinityFilter(self._node_labels))
            if req.excluded_nodes:
                extra.append(NodeExclusionFilter())
            if req.isolation == constants.ISOLATION_PARTITIONED:
                extra.append(PartitionFitFilter())
            for i in np.nonzero(mask)[0]:
                chip = view.states[i]
                for f in extra:
                    if f.check(req, chip) is not None:
                        mask[i] = False
                        break
        min_count = req.chip_count if (req.same_node and req.chip_count > 1) \
            else 1
        return CandidateMap(view, mask, min_count=min_count)

    def _refresh_views(self, chip_names: List[str]) -> None:
        for view in self._views.values():
            view.refresh(chip_names)

    def score_nodes(self, req: AllocRequest,
                    by_node: Dict[str, List[ChipState]]) -> Dict[str, float]:
        strategy = self._strategy_for(req.pool)
        if isinstance(by_node, CandidateMap):
            return by_node.node_scores(strategy.name)
        scores = {}
        for node, chips in by_node.items():
            if not chips:
                continue
            scores[node] = sum(strategy.score(c, for_node=True)
                               for c in chips) / len(chips)
        return scores

    def select(self, req: AllocRequest, chips: List[ChipState]
               ) -> List[ChipState]:
        """Pick req.chip_count chips by the pool strategy
        (gpuallocator.go:909 Select analog)."""
        strategy = self._strategy_for(req.pool)
        chosen = strategy.select(chips, req.chip_count)
        if len(chosen) < req.chip_count:
            raise InsufficientResourcesError(
                f"need {req.chip_count} chips, only {len(chosen)} eligible")
        return chosen

    def _strategy_for(self, pool: str) -> Strategy:
        with self._lock:
            return self._strategies.get(pool) or new_strategy("CompactFirst")

    # -- hypothetical fit (preemption / nominated-node dry-runs) ----------

    def _clone_chip_state(self, state: ChipState) -> ChipState:
        clone = ChipState(state.chip, state.oversell_ratio,
                          state._template_cores,
                          hbm_expand_ratio=state.hbm_expand_ratio,
                          partition_registry=state.partition_registry)
        clone.allocated = state.allocated
        clone.holders = dict(state.holders)
        clone.partition_cores_used = state.partition_cores_used
        clone.partition_placements = dict(state.partition_placements)
        clone.partition_groups = dict(state.partition_groups)
        return clone

    def dry_run_fit(self, req: AllocRequest, node: str,
                    release_keys: Iterable[str] = (),
                    virtual_holds: Iterable[AllocRequest] = ()) -> bool:
        """Would the full filter chain admit ``req`` on ``node`` in a
        hypothetical state where ``release_keys``' holds are released and
        each ``virtual_holds`` request (a nominated-but-unbound preemptor)
        is greedily placed first?

        This is the per-chip answer the aggregate shortfall math cannot
        give: eviction must free capacity *in a shape the request can use*
        (chip_count chips each satisfying tflops AND hbm AND partition
        slots).  FilterWithPreempt + nominated-pod double-booking analog
        (gpuallocator.go:666, gpuresources.go:377-575).
        """
        with self._lock:
            # pool-scoped like every other allocator path: chips of other
            # pools on the same node must not satisfy (or fake-satisfy)
            # the fit, since the request can never use them
            pool_names = self._pool_chips.get(req.pool) if req.pool else None
            clones = [self._clone_chip_state(self._chips[n])
                      for n in self._node_chips.get(node, ())
                      if n in self._chips
                      and (pool_names is None or n in pool_names)]
            if not clones:
                return False
            for key in release_keys:
                rec = self._allocations.get(key)
                template = rec.request.partition_template if rec else ""
                for clone in clones:
                    clone.drop(key, partition_template=template)
            strategy = self._strategy_for(req.pool)
            for i, nreq in enumerate(virtual_holds):
                res = run_filters(self._filters, nreq, clones)
                if len(res.chips) < nreq.chip_count:
                    continue  # nominee no longer fits; it can't block
                for c in strategy.select(res.chips, nreq.chip_count):
                    c.hold(f"__nominated_{i}__", nreq.request,
                           nreq.partition_template,
                           exclusive=nreq.exclusive)
            res = run_filters(self._filters, req, clones)
            return len(res.chips) >= req.chip_count

    def simulate_placement(self, reqs: List[AllocRequest],
                           skip_quota: bool = True
                           ) -> Optional[Dict[str, str]]:
        """All-or-nothing placement dry run: can every request in ``reqs``
        be placed *simultaneously*?  Capacity is held incrementally as each
        request is placed, so later members see earlier members' holds;
        every hold is rolled back before returning — pure simulation.

        Returns ``{req.key(): node}`` on success, None if any member has
        no placement.  Conservative by design: the callers' own current
        allocations (e.g. gang members about to be drained) still count as
        used, so a True answer under-promises.  Backs gang-atomic defrag
        drains and the simulate-schedule API (gpupool_defrag.go drain +
        gang/manager.go all-or-nothing semantics).
        """
        with self._lock:
            held: List[Tuple[ChipState, str, str]] = []
            touched: List[str] = []
            placements: Dict[str, str] = {}
            try:
                for req in reqs:
                    try:
                        by_node, _ = self.check_quota_and_filter(
                            req, skip_quota=skip_quota)
                    except QuotaExceededError:
                        return None
                    if not by_node:
                        return None
                    scores = self.score_nodes(req, by_node)
                    per_chip = ResourceAmount(
                        tflops=req.request.tflops,
                        duty_percent=req.request.duty_percent,
                        hbm_bytes=req.request.hbm_bytes)
                    placed_node = None
                    for node in sorted(
                            by_node, key=lambda n: -scores.get(n, 0.0)):
                        try:
                            chosen = self.select(req, list(by_node[node]))
                        except InsufficientResourcesError:
                            continue
                        for c in chosen:
                            c.hold(req.key(), per_chip,
                                   req.partition_template,
                                   exclusive=req.exclusive)
                            held.append((c, req.key(),
                                         req.partition_template))
                            touched.append(c.chip.name)
                        self._refresh_views([c.chip.name for c in chosen])
                        placed_node = node
                        break
                    if placed_node is None:
                        return None
                    placements[req.key()] = placed_node
                return placements
            finally:
                for c, key, tmpl in held:
                    c.drop(key, tmpl)
                if touched:
                    self._refresh_views(touched)

    # -- two-phase allocation ---------------------------------------------

    def assume(self, req: AllocRequest, chips: List[ChipState]) -> AllocRecord:
        """Hold capacity + quota for the Reserve->Bind window
        (gpuallocator.go:1078 Assume analog)."""
        key = req.key()
        with self._lock:
            if key in self._allocations:
                raise AllocationConflictError(f"{key} already allocated")
            self.quota.assume(req)
            record = AllocRecord(request=req,
                                 chip_ids=[c.chip.name for c in chips],
                                 assumed_at=self.clock.now())
            per_chip = ResourceAmount(tflops=req.request.tflops,
                                      duty_percent=req.request.duty_percent,
                                      hbm_bytes=req.request.hbm_bytes)
            held = []
            try:
                for c in chips:
                    c.hold(key, per_chip, req.partition_template,
                           exclusive=req.exclusive)
                    held.append(c)
            except (AllocationConflictError, InsufficientResourcesError):
                # conflict or no partition placement (a concurrent
                # allocation can take the last contiguous gap between
                # Filter and here): unwind everything
                for c in held:
                    c.drop(key, req.partition_template)
                self.quota.unassume(req)
                raise
            self._allocations[key] = record
            self._mark_dirty(record.chip_ids)
            self._refresh_views(record.chip_ids)
            return record

    def unassume(self, key: str) -> None:
        """Release an assumed-but-not-committed allocation (Unreserve)."""
        with self._lock:
            record = self._allocations.get(key)
            if record is None or not record.assumed:
                return
            self._drop_record(record)

    def commit(self, key: str) -> AllocRecord:
        """Finalize an assumed allocation on bind (gpuallocator.go:1137)."""
        with self._lock:
            record = self._allocations.get(key)
            if record is None:
                raise NotFoundError(f"no allocation for {key}")
            if record.assumed:
                record.assumed = False
                self.quota.commit(record.request)
            self._mark_dirty(record.chip_ids)
            return record

    def alloc(self, req: AllocRequest) -> AllocRecord:
        """One-shot allocate (filter+select+assume+commit) for callers
        outside the scheduler (gpuallocator.go:1405 Alloc analog)."""
        by_node, rejections = self.check_quota_and_filter(req)
        pool_chips = [c for chips in by_node.values() for c in chips]
        if not pool_chips:
            raise InsufficientResourcesError(
                f"no eligible chips: {json.dumps(rejections)[:400]}")
        if req.same_node and req.chip_count > 1:
            scores = self.score_nodes(req, by_node)
            node = max(scores, key=scores.get)
            pool_chips = by_node[node]
        chosen = self.select(req, pool_chips)
        self.assume(req, chosen)
        return self.commit(req.key())

    def dealloc(self, key: str) -> None:
        """Release a committed allocation (gpuallocator.go:1503)."""
        with self._lock:
            record = self._allocations.get(key)
            if record is None:
                return
            self._drop_record(record)

    def _drop_record(self, record: AllocRecord) -> None:
        for chip_name in record.chip_ids:
            state = self._chips.get(chip_name)
            if state is not None:
                state.drop(record.key, record.request.partition_template)
        if record.assumed:
            self.quota.unassume(record.request)
        else:
            self.quota.release(record.request)
        del self._allocations[record.key]
        self._mark_dirty(record.chip_ids)
        self._refresh_views(record.chip_ids)

    # -- live vertical resize (gpuallocator.go:1600 AdjustAllocation) -----

    def adjust_allocation(self, adjust: AdjustRequest,
                          dry_run: bool = False) -> ResourceAmount:
        key = f"{adjust.namespace}/{adjust.pod_name}"
        with self._lock:
            record = self._allocations.get(key)
            if record is None:
                raise NotFoundError(f"no allocation for {key}")
            old = record.request.request
            new = adjust.new_request
            delta = new.sub(old)
            # capacity check on every chip the pod holds
            for chip_name in record.chip_ids:
                state = self._chips.get(chip_name)
                if state is None:
                    continue
                avail = state.available()
                if delta.tflops > avail.tflops + 1e-9 or \
                        delta.hbm_bytes > avail.hbm_bytes + 1e-9:
                    raise InsufficientResourcesError(
                        f"chip {chip_name} cannot absorb resize "
                        f"(+{delta.tflops:.1f} tflops, "
                        f"+{delta.hbm_bytes:.0f} B)")
            # quota check: single cap against the NEW size, total cap
            # against current usage plus the delta
            if delta.tflops > 0 or delta.hbm_bytes > 0:
                self.quota.check_adjust(adjust.namespace, old, new,
                                        len(record.chip_ids))
            if dry_run:
                return delta
            n = len(record.chip_ids)
            for chip_name in record.chip_ids:
                state = self._chips.get(chip_name)
                if state is None:
                    continue
                state.allocated = state.allocated.add(delta)
                state.holders[key] = state.holders[key].add(delta)
                state.invalidate()
            self.quota.adjust(adjust.namespace, delta.scale(n),
                              adjust.new_limit.sub(
                                  record.request.limit).scale(n))
            record.request.request = new
            record.request.limit = adjust.new_limit
            self._mark_dirty(record.chip_ids)
            self._refresh_views(record.chip_ids)
            return delta

    # -- partitions -------------------------------------------------------

    def bind_partition(self, key: str, chip_name: str,
                       partition_id: str) -> None:
        with self._lock:
            record = self._allocations.get(key)
            if record is None:
                raise NotFoundError(f"no allocation for {key}")
            record.partitions[chip_name] = partition_id
            self._mark_dirty([chip_name])

    # -- assumed-allocation TTL sweep (gpuallocator.go:1348) ---------------

    def sweep_assumed(self, now: Optional[float] = None) -> List[str]:
        now = now or self.clock.now()
        swept = []
        with self._lock:
            for record in list(self._allocations.values()):
                if not record.assumed:
                    continue
                if now - record.assumed_at < self.assume_ttl_s:
                    continue
                if self._gang_waiting_probe(record.key):
                    continue  # gang member parked in Permit — keep holding
                log.warning("sweeping stale assumed allocation %s",
                            record.key)
                self._drop_record(record)
                swept.append(record.key)
        return swept

    # -- pod annotation contract ------------------------------------------

    def stamp_pod(self, pod: Pod, record: AllocRecord) -> None:
        """Persist the allocation onto the pod (PreBind analog,
        gpuresources.go:859-1014) so state survives restarts."""
        ann = pod.metadata.annotations
        req = record.request
        ann[constants.ANN_CHIP_IDS] = ",".join(record.chip_ids)
        ann[constants.ANN_POOL] = req.pool
        ann[constants.ANN_TFLOPS_REQUEST] = str(req.request.tflops)
        ann[constants.ANN_HBM_REQUEST] = str(int(req.request.hbm_bytes))
        ann[constants.ANN_TFLOPS_LIMIT] = str(req.limit.tflops)
        ann[constants.ANN_HBM_LIMIT] = str(int(req.limit.hbm_bytes))
        ann[constants.ANN_CHIP_COUNT] = str(req.chip_count)
        ann[constants.ANN_QOS] = req.qos
        ann[constants.ANN_ISOLATION] = req.isolation
        if req.request.duty_percent:
            ann[constants.ANN_DUTY_REQUEST] = str(req.request.duty_percent)
        if req.limit.duty_percent:
            ann[constants.ANN_DUTY_LIMIT] = str(req.limit.duty_percent)
        if req.generation:
            ann[constants.ANN_CHIP_GENERATION] = req.generation
        if req.vendor:
            ann[constants.ANN_VENDOR] = req.vendor
        if req.chip_indices:
            ann[constants.ANN_CHIP_INDICES] = ",".join(
                str(i) for i in req.chip_indices)
        if req.partition_template:
            ann[constants.ANN_PARTITION_NAME] = req.partition_template
        if record.partitions:
            ann[constants.ANN_PARTITION_IDS] = json.dumps(record.partitions)
        ann[constants.ANN_WORKLOAD] = req.workload_name

    @staticmethod
    def parse_pod(pod: Pod) -> Optional[AllocRecord]:
        ann = pod.metadata.annotations
        chip_ids = ann.get(constants.ANN_CHIP_IDS, "")
        if not chip_ids:
            return None
        req = AllocRequest(
            pool=ann.get(constants.ANN_POOL, ""),
            namespace=pod.metadata.namespace,
            workload_name=ann.get(constants.ANN_WORKLOAD, ""),
            pod_name=pod.metadata.name,
            request=ResourceAmount(
                tflops=float(ann.get(constants.ANN_TFLOPS_REQUEST, 0) or 0),
                duty_percent=float(ann.get(constants.ANN_DUTY_REQUEST, 0)
                                   or 0),
                hbm_bytes=float(ann.get(constants.ANN_HBM_REQUEST, 0) or 0)),
            limit=ResourceAmount(
                tflops=float(ann.get(constants.ANN_TFLOPS_LIMIT, 0) or 0),
                duty_percent=float(ann.get(constants.ANN_DUTY_LIMIT, 0) or 0),
                hbm_bytes=float(ann.get(constants.ANN_HBM_LIMIT, 0) or 0)),
            chip_count=int(ann.get(constants.ANN_CHIP_COUNT, 1) or 1),
            generation=ann.get(constants.ANN_CHIP_GENERATION, ""),
            vendor=ann.get(constants.ANN_VENDOR, ""),
            chip_indices=[int(x) for x in
                          ann.get(constants.ANN_CHIP_INDICES, "").split(",")
                          if x],
            qos=ann.get(constants.ANN_QOS, constants.DEFAULT_QOS),
            isolation=ann.get(constants.ANN_ISOLATION,
                              constants.DEFAULT_ISOLATION),
            partition_template=ann.get(constants.ANN_PARTITION_NAME, ""))
        record = AllocRecord(request=req, chip_ids=chip_ids.split(","),
                             assumed=False,
                             assumed_at=default_clock().now())
        parts = ann.get(constants.ANN_PARTITION_IDS, "")
        if parts:
            record.partitions = json.loads(parts)
        return record

    def reconcile(self, pods: List[Pod]) -> int:
        """Rebuild allocation state from pod annotations after a restart
        (gpuallocator.go:2592 reconcileAllocationState analog)."""
        with self._lock:
            for state in self._chips.values():
                state.allocated = ResourceAmount()
                state.holders.clear()
                state.partition_cores_used = 0
                state.partition_placements.clear()
                state.partition_groups.clear()
            self._allocations.clear()
            restored = 0
            committed_reqs = []
            for pod in pods:
                if pod.status.phase in (constants.PHASE_SUCCEEDED,
                                        constants.PHASE_FAILED):
                    continue
                record = self.parse_pod(pod)
                if record is None:
                    continue
                per_chip = record.request.request
                for chip_name in record.chip_ids:
                    state = self._chips.get(chip_name)
                    if state is None:
                        log.warning("reconcile: pod %s references unknown "
                                    "chip %s", record.key, chip_name)
                        continue
                    try:
                        state.hold(record.key, per_chip,
                                   record.request.partition_template,
                                   exclusive=record.request.exclusive)
                    except InsufficientResourcesError:
                        # corrupt annotations must not kill restart
                        # recovery; the pod keeps its record, unplaced
                        log.error("reconcile: no partition placement for "
                                  "%s on %s", record.key, chip_name)
                self._allocations[record.key] = record
                committed_reqs.append(record.request)
                restored += 1
            self.quota.reconcile(committed_reqs)
            self._dirty.update(self._chips.keys())
            self._views.clear()
            self._chips_list_cache.clear()
            return restored

    # -- store sync (gpuallocator.go:2309 SyncGPUsToK8s) -------------------

    def _mark_dirty(self, chip_names: List[str]) -> None:
        self._dirty.update(chip_names)

    def sync_to_store(self) -> int:
        if self.store is None:
            return 0
        with self._lock:
            dirty = list(self._dirty)
            self._dirty.clear()
            snapshot = []
            for name in dirty:
                state = self._chips.get(name)
                if state is None:
                    continue
                holders = [k for k in state.holders]
                snapshot.append((name, state.available(), holders))
        n = 0
        for name, avail, holders in snapshot:
            obj = self.store.try_get(TPUChip, name)
            if obj is None:
                continue
            obj = obj.thaw()
            obj.status.available = avail
            obj.status.running_apps = holders
            try:
                # version-checked: a concurrent chip write (node agent
                # status, live-migration phase) must not be clobbered by
                # this availability rollup.  On conflict the chip goes
                # back on the dirty list; the next sync pass re-reads.
                self.store.update(obj, check_version=True)
            except ConflictError:
                with self._lock:
                    self._dirty.add(name)
                continue
            n += 1
        self.quota.sync_to_store()
        return n
