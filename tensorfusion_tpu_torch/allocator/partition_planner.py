"""Partition placement planner: slot/bitmask arithmetic for core grants.

The port's copy of ``tensorfusion_tpu/allocator/partition_planner.py``.

Analog of the reference's vendor partition planners
(``internal/gpuallocator/partition_strategy.go`` — NVIDIAMIGStrategy /
AscendPartitionStrategy slot+placement bitmask arithmetic), redesigned
for TPUs: a chip has N TensorCores; a partition template requests a
contiguous run of them.  The planner answers, for one chip,

- *can* a template be placed given the current core occupancy mask, and
- *where* — best-fit: the smallest free contiguous gap that fits, so
  large templates stay placeable as small ones come and go (the same
  fragmentation argument MIG placement tables encode), preferring
  aligned starts (start % size == 0) within equal gaps;

plus the isolation-group rule from ``ProviderConfig`` partition
templates (providerconfig_types.go:197-279): templates of different
isolation groups must not share a chip.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple


@dataclass(frozen=True)
class Placement:
    start_core: int
    core_count: int

    @property
    def mask(self) -> int:
        return ((1 << self.core_count) - 1) << self.start_core


def occupancy_mask(placements: Iterable[Placement]) -> int:
    mask = 0
    for p in placements:
        mask |= p.mask
    return mask


class TPUCorePlanner:
    """Best-fit contiguous-core placement on one chip."""

    @staticmethod
    def free_gaps(total_cores: int, used_mask: int
                  ) -> Iterable[Tuple[int, int]]:
        """Yield (start, length) of each maximal free run."""
        start = None
        for i in range(total_cores):
            free = not (used_mask >> i) & 1
            if free and start is None:
                start = i
            elif not free and start is not None:
                yield (start, i - start)
                start = None
        if start is not None:
            yield (start, total_cores - start)

    @classmethod
    def place(cls, total_cores: int, used_mask: int,
              want_cores: int) -> Optional[Placement]:
        """Best-fit start for a `want_cores` contiguous run, or None.

        Smallest adequate gap first (leaves the biggest gaps intact for
        future large templates); within a gap prefer an aligned start.
        """
        if want_cores < 1 or want_cores > total_cores:
            return None
        best: Optional[Tuple[int, int]] = None   # (gap_len, start)
        for start, length in cls.free_gaps(total_cores, used_mask):
            if length < want_cores:
                continue
            # aligned sub-start inside the gap when possible
            aligned = ((start + want_cores - 1) // want_cores) * want_cores
            pick = aligned if aligned + want_cores <= start + length \
                else start
            if best is None or length < best[0]:
                best = (length, pick)
        if best is None:
            return None
        return Placement(start_core=best[1], core_count=want_cores)

    @classmethod
    def can_place(cls, total_cores: int, used_mask: int,
                  want_cores: int) -> bool:
        return cls.place(total_cores, used_mask, want_cores) is not None


@dataclass
class TemplateSpec:
    """Allocator-side view of a partition template (the subset of
    ProviderConfig's PartitionTemplateSpec the planner needs)."""

    template_id: str
    core_count: int = 1
    isolation_group: str = ""


class PartitionPlanRegistry:
    """Template registry + per-chip planning entry point."""

    def __init__(self):
        self._templates: Dict[str, TemplateSpec] = {}

    def register(self, spec: TemplateSpec) -> None:
        self._templates[spec.template_id] = spec

    def register_all(self, specs: Iterable[TemplateSpec]) -> None:
        for s in specs:
            self.register(s)

    def spec(self, template_id: str) -> Optional[TemplateSpec]:
        got = self._templates.get(template_id)
        if got is not None:
            return got
        # conventional ids end in "-<n>c" — derivable without registration
        tail = template_id.rsplit("-", 1)[-1]
        if tail.endswith("c") and tail[:-1].isdigit():
            return TemplateSpec(template_id, core_count=int(tail[:-1]))
        return None

    def plan(self, template_id: str, total_cores: int,
             placements: Dict[str, Placement],
             groups: Dict[str, str]) -> Optional[Placement]:
        """Placement for `template_id` on a chip whose current holders'
        placements and isolation groups are given; None when it cannot be
        placed (no gap, unknown template, or isolation-group conflict)."""
        spec = self.spec(template_id)
        if spec is None:
            return None
        if spec.isolation_group:
            for g in groups.values():
                if g and g != spec.isolation_group:
                    return None
        used = occupancy_mask(placements.values())
        return TPUCorePlanner.place(total_cores, used, spec.core_count)
