"""Vectorized chip-store view: numpy-masked filtering and scoring.

The port's copy of ``tensorfusion_tpu/allocator/vecview.py``.

The reference's allocator iterates every GPU per scheduling cycle in Go
(``gpuallocator.go:610`` Filter) and still clears 400-500 pods/s at 4,000
GPUs.  A Python per-chip filter chain cannot match that, so the hot path is
vectorized: each pool keeps parallel numpy arrays (availability, capacity,
phase, generation/vendor codes, isolation capabilities, node index) and a
scheduling cycle evaluates the common filters as boolean masks in C.  The
Python filter chain remains the source of truth for rejection *reasons*
(the simulate-schedule API) and for rare constraint kinds (explicit chip
indices, node affinity, partition templates), applied only to mask
survivors.

``CandidateMap`` is the lazy `{node: [ChipState]}` mapping returned to the
scheduler: membership and counts come from bincounts; per-node chip lists
materialize only for nodes the cycle actually touches (Reserve, topology
planning).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, TYPE_CHECKING

import numpy as np

from .. import constants

if TYPE_CHECKING:
    from ..api.resources import AllocRequest
    from .core import ChipState


class PoolVectorView:
    def __init__(self, chips: List["ChipState"]):
        self.states = list(chips)
        self.names = [c.chip.name for c in self.states]
        self.index = {n: i for i, n in enumerate(self.names)}
        n = len(self.states)
        self.avail_tflops = np.zeros(n)
        self.avail_duty = np.zeros(n)
        self.n_holders = np.zeros(n, dtype=np.int32)
        self.has_exclusive = np.zeros(n, dtype=bool)
        self.avail_hbm = np.zeros(n)
        self.cap_tflops = np.zeros(n)
        self.cap_hbm = np.zeros(n)
        self.phase_ok = np.zeros(n, dtype=bool)
        self.soft_ok = np.zeros(n, dtype=bool)
        self.hard_ok = np.zeros(n, dtype=bool)
        self.part_ok = np.zeros(n, dtype=bool)
        self.free_cores = np.zeros(n, dtype=np.int32)

        self.node_names: List[str] = []
        node_idx_map: Dict[str, int] = {}
        self.node_idx = np.zeros(n, dtype=np.int64)
        self.gen_names: List[str] = []
        gen_map: Dict[str, int] = {}
        self.gen_code = np.zeros(n, dtype=np.int32)
        self.vendor_names: List[str] = []
        vendor_map: Dict[str, int] = {}
        self.vendor_code = np.zeros(n, dtype=np.int32)
        self.host_index = np.zeros(n, dtype=np.int32)

        for i, c in enumerate(self.states):
            st = c.chip.status
            node = st.node_name
            if node not in node_idx_map:
                node_idx_map[node] = len(self.node_names)
                self.node_names.append(node)
            self.node_idx[i] = node_idx_map[node]
            if st.generation not in gen_map:
                gen_map[st.generation] = len(self.gen_names)
                self.gen_names.append(st.generation)
            self.gen_code[i] = gen_map[st.generation]
            if st.vendor not in vendor_map:
                vendor_map[st.vendor] = len(self.vendor_names)
                self.vendor_names.append(st.vendor)
            self.vendor_code[i] = vendor_map[st.vendor]
            self.host_index[i] = st.host_index
            self.refresh_row(i)
        self.gen_map = gen_map
        self.vendor_map = vendor_map
        #: node name -> node id, shared by every CandidateMap over this
        #: view (hoisted: building it per scheduling cycle measured ~15%
        #: of the 1000-node cycle)
        self.node_id = {n: i for i, n in enumerate(self.node_names)}
        #: (eligible_mask bytes, ids, name tuple) memo shared across
        #: cycles: successive pods with the same constraints produce the
        #: same eligibility until a node fills up, and rebuilding a
        #: 1000-name tuple per pod was the top cost after batching
        self._eligible_memo: Optional[tuple] = None

    def refresh_row(self, i: int) -> None:
        c = self.states[i]
        st = c.chip.status
        avail = c.available()
        cap = c.virtual_capacity()
        self.avail_tflops[i] = avail.tflops
        self.avail_duty[i] = avail.duty_percent
        self.n_holders[i] = len(c.holders)
        self.has_exclusive[i] = bool(c.exclusive_keys)
        self.avail_hbm[i] = avail.hbm_bytes
        self.cap_tflops[i] = cap.tflops
        self.cap_hbm[i] = cap.hbm_bytes
        self.phase_ok[i] = (st.phase == constants.PHASE_RUNNING
                            and st.used_by == constants.CHIP_USED_BY_TPU_FUSION)
        caps = st.capabilities
        self.soft_ok[i] = caps.get("soft_isolation", True)
        self.hard_ok[i] = caps.get("hard_isolation", False)
        self.part_ok[i] = caps.get("core_partitioning", False)
        self.free_cores[i] = c.free_partition_cores()
        if self._util_cache is not None:
            # incremental: one allocation invalidating the whole pool's
            # utilization vector made scoring recompute 4000 chips per
            # scheduled pod — patch the single changed row instead
            ut = 1.0 - avail.tflops / cap.tflops if cap.tflops > 0 else 0.0
            uh = 1.0 - avail.hbm_bytes / cap.hbm_bytes if cap.hbm_bytes > 0 \
                else 0.0
            self._util_cache[i] = min(max(0.5 * ut + 0.5 * uh, 0.0), 1.0)

    def refresh(self, chip_names) -> None:
        for name in chip_names:
            i = self.index.get(name)
            if i is not None:
                self.refresh_row(i)

    # -- masked filtering -------------------------------------------------

    def survivors(self, req: "AllocRequest") -> np.ndarray:
        mask = self.phase_ok.copy()
        np.logical_and(mask, self.avail_tflops >= req.request.tflops - 1e-9,
                       out=mask)
        np.logical_and(mask, self.avail_hbm >= req.request.hbm_bytes - 1e-9,
                       out=mask)
        np.logical_and(mask,
                       self.avail_duty >= req.request.duty_percent - 1e-9,
                       out=mask)
        # exclusivity, with the same self-carveouts as the Python chain
        # (ResourceFitFilter): a chip held exclusively BY this request
        # stays eligible, and an exclusive request tolerates a chip whose
        # only holder is itself (restart/recheck flows)
        self_key = req.key()
        pre_exclusivity = None
        if self.has_exclusive.any() or \
                (req.exclusive and self.n_holders.any()):
            pre_exclusivity = mask.copy()
        np.logical_and(mask, ~self.has_exclusive, out=mask)
        if req.exclusive:
            np.logical_and(mask, self.n_holders == 0, out=mask)
        if pre_exclusivity is not None:
            for i in np.nonzero(pre_exclusivity & ~mask)[0]:
                c = self.states[i]
                if c.exclusive_keys and c.exclusive_keys != {self_key}:
                    continue
                if req.exclusive and set(c.holders) != {self_key}:
                    continue
                mask[i] = True
        if req.generation:
            code = self.gen_map.get(req.generation, -1)
            np.logical_and(mask, self.gen_code == code, out=mask)
        if req.vendor:
            code = self.vendor_map.get(req.vendor, -1)
            np.logical_and(mask, self.vendor_code == code, out=mask)
        if req.isolation == constants.ISOLATION_SOFT:
            np.logical_and(mask, self.soft_ok, out=mask)
        elif req.isolation == constants.ISOLATION_HARD:
            np.logical_and(mask, self.hard_ok, out=mask)
        elif req.isolation == constants.ISOLATION_PARTITIONED:
            np.logical_and(mask, self.part_ok, out=mask)
        if req.chip_indices:
            np.logical_and(mask, np.isin(self.host_index,
                                         np.array(req.chip_indices)),
                           out=mask)
        return mask

    #: invalidated by refresh_row — scoring a scheduling cycle reuses the
    #: previous cycle's per-chip utilization unless an allocation landed
    _util_cache: Optional[np.ndarray] = None

    def util(self) -> np.ndarray:
        got = self._util_cache
        if got is None:
            with np.errstate(divide="ignore", invalid="ignore"):
                ut = np.where(self.cap_tflops > 0,
                              1.0 - self.avail_tflops / self.cap_tflops,
                              0.0)
                uh = np.where(self.cap_hbm > 0,
                              1.0 - self.avail_hbm / self.cap_hbm, 0.0)
            got = np.clip(0.5 * ut + 0.5 * uh, 0.0, 1.0)
            self._util_cache = got
        return got


class CandidateMap(Mapping):
    """Lazy {node_name: [ChipState]} over a survivor mask.

    Built once per scheduling cycle on the PreFilter hot path, so every
    derived structure is lazy: eligibility is a numpy mask over node
    ids; the name tuple/set and per-node chip lists materialize only
    for the (batch-)filter/Reserve steps that actually ask."""

    def __init__(self, view: PoolVectorView, mask: np.ndarray,
                 min_count: int = 1):
        self.view = view
        self.mask = mask
        self.survivor_idx = np.nonzero(mask)[0]
        counts = np.bincount(view.node_idx[self.survivor_idx],
                             minlength=len(view.node_names)) \
            if len(self.survivor_idx) else np.zeros(len(view.node_names),
                                                    dtype=np.int64)
        self.counts = counts
        self._node_id = view.node_id
        self.eligible_mask = counts >= min_count
        self._eligible_ids: Optional[np.ndarray] = None
        self._eligible_tuple: Optional[tuple] = None
        self._len: Optional[int] = None
        self._cache: Dict[str, List["ChipState"]] = {}

    def eligible_nodes(self) -> tuple:
        """Eligible node names (cached tuple; identity-stable within the
        cycle — the scheduler's batch path relies on that for zero-cost
        alignment with node_scores)."""
        got = self._eligible_tuple
        if got is None:
            key = self.eligible_mask.tobytes()
            memo = self.view._eligible_memo
            if memo is not None and memo[0] == key:
                _, self._eligible_ids, got = memo
            else:
                names = self.view.node_names
                self._eligible_ids = np.nonzero(self.eligible_mask)[0]
                got = tuple(names[i] for i in self._eligible_ids)
                self.view._eligible_memo = (key, self._eligible_ids, got)
            self._eligible_tuple = got
        return got

    def __contains__(self, node) -> bool:
        nid = self._node_id.get(node)
        return nid is not None and bool(self.eligible_mask[nid])

    def __iter__(self) -> Iterator[str]:
        return iter(self.eligible_nodes())

    def __len__(self) -> int:
        if self._len is None:
            self._len = int(self.eligible_mask.sum())
        return self._len

    def __getitem__(self, node: str) -> List["ChipState"]:
        if node not in self:
            raise KeyError(node)
        if node not in self._cache:
            nid = self._node_id[node]
            idxs = self.survivor_idx[
                self.view.node_idx[self.survivor_idx] == nid]
            self._cache[node] = [self.view.states[i] for i in idxs]
        return self._cache[node]

    # -- vectorized node scores ------------------------------------------

    def node_scores(self, placement_mode: str) -> "NodeScores":
        return NodeScores(self, placement_mode)


class NodeScores(Mapping):
    """Lazy read-only {node_name: score} over a CandidateMap.

    One bincount pass computes per-node mean chip scores; no Python
    dict of all nodes is ever built (that dict was ~20% of a 1000-node
    scheduling cycle).  ``aligned()`` hands the scheduler's batch-score
    path the dense vector matching ``eligible_nodes()`` order."""

    def __init__(self, cm: CandidateMap, placement_mode: str):
        self.cm = cm
        view = cm.view
        n = len(view.node_names)
        if not len(cm.survivor_idx):
            self.means = np.zeros(n)
            return
        util = view.util()[cm.survivor_idx]
        if placement_mode == "LowLoadFirst":
            score = 100.0 * (1.0 - util)
        else:  # CompactFirst / NodeCompactChipLowLoad rank nodes by packing
            score = 100.0 * util
        nodes = view.node_idx[cm.survivor_idx]
        sums = np.bincount(nodes, weights=score, minlength=n)
        self.means = sums / np.maximum(cm.counts, 1)

    def aligned(self, nodes) -> Optional[np.ndarray]:
        """Dense score vector for ``nodes`` IF it is this cycle's
        eligible_nodes() tuple (identity check); None otherwise."""
        if nodes is self.cm._eligible_tuple and \
                self.cm._eligible_ids is not None:
            return self.means[self.cm._eligible_ids]
        return None

    def get(self, node, default=0.0):
        nid = self.cm._node_id.get(node)
        if nid is None or not self.cm.eligible_mask[nid]:
            return default
        return float(self.means[nid])

    def __getitem__(self, node: str) -> float:
        nid = self.cm._node_id.get(node)
        if nid is None or not self.cm.eligible_mask[nid]:
            raise KeyError(node)
        return float(self.means[nid])

    def __iter__(self) -> Iterator[str]:
        return iter(self.cm.eligible_nodes())

    def __len__(self) -> int:
        return len(self.cm)
