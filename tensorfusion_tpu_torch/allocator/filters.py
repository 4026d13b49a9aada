"""Chip filter chain.

The port's copy of ``tensorfusion_tpu/allocator/filters.py``.

Analog of the reference's chain-of-responsibility GPU filters
(``internal/gpuallocator/filter/filter.go:19-58`` registry): each filter
prunes the candidate chip list for one AllocRequest and reports a reason
for every chip it rejects (surfaced by the simulate-schedule API).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, TYPE_CHECKING

from .. import constants
from ..api.resources import AllocRequest

if TYPE_CHECKING:
    from .core import ChipState


@dataclass
class FilterResult:
    chips: List["ChipState"]
    rejections: Dict[str, str] = field(default_factory=dict)  # chip -> reason


class Filter:
    name = "filter"

    def check(self, req: AllocRequest, chip: "ChipState") -> Optional[str]:
        """Return None if the chip passes, else a rejection reason."""
        raise NotImplementedError


class PhaseFilter(Filter):
    name = "phase"

    def check(self, req, chip):
        phase = chip.chip.status.phase
        if phase != constants.PHASE_RUNNING:
            return f"chip phase {phase} is not Running"
        if chip.chip.status.used_by != constants.CHIP_USED_BY_TPU_FUSION:
            return f"chip used by {chip.chip.status.used_by}"
        return None


class IsolationCapabilityFilter(Filter):
    """Vendor capability tiers (constants.PARTITIONING_VENDORS etc.)."""

    name = "isolation"

    def check(self, req, chip):
        caps = chip.chip.status.capabilities
        if req.isolation == constants.ISOLATION_PARTITIONED and \
                not caps.get("core_partitioning", False):
            return "chip does not support core partitioning"
        if req.isolation == constants.ISOLATION_SOFT and \
                not caps.get("soft_isolation", True):
            return "chip does not support soft isolation"
        if req.isolation == constants.ISOLATION_HARD and \
                not caps.get("hard_isolation", False):
            return "chip does not support hard isolation"
        return None


class GenerationFilter(Filter):
    name = "generation"

    def check(self, req, chip):
        if req.generation and chip.chip.status.generation != req.generation:
            return (f"generation {chip.chip.status.generation} != "
                    f"requested {req.generation}")
        return None


class VendorFilter(Filter):
    name = "vendor"

    def check(self, req, chip):
        if req.vendor and chip.chip.status.vendor != req.vendor:
            return f"vendor {chip.chip.status.vendor} != {req.vendor}"
        return None


class IndexFilter(Filter):
    name = "index"

    def check(self, req, chip):
        if req.chip_indices and \
                chip.chip.status.host_index not in req.chip_indices:
            return f"host index {chip.chip.status.host_index} not in " \
                   f"{req.chip_indices}"
        return None


class NodeAffinityFilter(Filter):
    name = "node-affinity"

    def __init__(self, node_labels: Callable[[str], Dict[str, str]]):
        self._node_labels = node_labels

    def check(self, req, chip):
        if not req.node_affinity:
            return None
        labels = self._node_labels(chip.chip.status.node_name) or {}
        for k, v in req.node_affinity.items():
            if labels.get(k) != v:
                return f"node {chip.chip.status.node_name} lacks {k}={v}"
        return None


class NodeExclusionFilter(Filter):
    """Defrag/migration: never place back onto an excluded node."""

    name = "node-exclusion"

    def check(self, req, chip):
        if req.excluded_nodes and \
                chip.chip.status.node_name in req.excluded_nodes:
            return f"node {chip.chip.status.node_name} excluded"
        return None


class ResourceFitFilter(Filter):
    """Capacity check: request must fit the chip's remaining virtual
    TFLOPs (oversold), physical HBM, and MXU duty share — duty is its
    own dimension so whole-chip duty-only holds (proxied native pods,
    migrated pods of unknown generation) block tflops-denominated
    placements and vice versa."""

    name = "resource-fit"

    def check(self, req, chip):
        if chip.exclusive_keys and req.key() not in chip.exclusive_keys:
            return "chip exclusively held"
        if req.exclusive and chip.holders and \
                set(chip.holders) != {req.key()}:
            return "exclusive request needs an empty chip"
        avail = chip.available()
        if req.request.tflops > avail.tflops + 1e-9:
            return (f"insufficient tflops: want {req.request.tflops:.1f}, "
                    f"have {avail.tflops:.1f}")
        if req.request.hbm_bytes > avail.hbm_bytes + 1e-9:
            return (f"insufficient HBM: want {req.request.hbm_bytes:.0f}, "
                    f"have {avail.hbm_bytes:.0f}")
        if req.request.duty_percent > avail.duty_percent + 1e-9:
            return (f"insufficient duty: want "
                    f"{req.request.duty_percent:.0f}%, "
                    f"have {avail.duty_percent:.0f}%")
        return None


class PartitionFitFilter(Filter):
    """Partitioned isolation: the chip must have a concrete *placement*
    for the requested template — contiguous-core best-fit with
    isolation-group rules, not just a free-core count (the planner is
    the partition_strategy.go slot/placement-bitmask analog)."""

    name = "partition-fit"

    def check(self, req, chip):
        if req.isolation != constants.ISOLATION_PARTITIONED:
            return None
        if not req.partition_template:
            return "partitioned request without a template"
        if chip.template_core_count(req.partition_template) is None:
            return f"unknown partition template {req.partition_template}"
        if chip.plan_partition(req.partition_template) is None:
            return (f"no placement for template {req.partition_template} "
                    f"(free {chip.free_partition_cores()} of "
                    f"{chip.chip.status.core_count} cores, fragmentation/"
                    f"isolation-group rules applied)")
        return None


def default_chain(node_labels: Callable[[str], Dict[str, str]]
                  ) -> List[Filter]:
    return [PhaseFilter(), IsolationCapabilityFilter(), GenerationFilter(),
            VendorFilter(), IndexFilter(), NodeAffinityFilter(node_labels),
            NodeExclusionFilter(), PartitionFitFilter(), ResourceFitFilter()]


def run_filters(filters: List[Filter], req: AllocRequest,
                chips: List["ChipState"]) -> FilterResult:
    passed = []
    rejections: Dict[str, str] = {}
    for chip in chips:
        reason = None
        for f in filters:
            reason = f.check(req, chip)
            if reason is not None:
                rejections[chip.chip.name] = f"[{f.name}] {reason}"
                break
        if reason is None:
            passed.append(chip)
    return FilterResult(chips=passed, rejections=rejections)
