"""Placement strategies.

The port's copy of ``tensorfusion_tpu/allocator/strategy.py``.

Analog of the reference's ``Strategy`` interface + implementations
(``internal/gpuallocator/strategy_compact_first.go``,
``strategy_low_load.go``, ``strategy_default.go``; ``NewStrategy``
``gpuallocator.go:265``): score a chip (or its node) between 0 and 100 and
pick the top-N for a request.

- CompactFirst: pack — prefer the *most* utilized chips so whole chips stay
  free for large/partitioned requests.
- LowLoadFirst: spread — prefer the least utilized chips (latency-sensitive
  tenants).
- NodeCompactChipLowLoad: pack nodes, spread chips within the chosen node —
  the default for TPU pools, since gang workloads want whole hosts while
  fractional tenants want quiet chips.
"""

from __future__ import annotations

from typing import Dict, List, TYPE_CHECKING

if TYPE_CHECKING:
    from .core import ChipState

COMPACT_FIRST = "CompactFirst"
LOW_LOAD_FIRST = "LowLoadFirst"
NODE_COMPACT_CHIP_LOW_LOAD = "NodeCompactChipLowLoad"


class Strategy:
    name = "strategy"

    def score(self, chip: "ChipState", for_node: bool = False) -> float:
        raise NotImplementedError

    def select(self, chips: List["ChipState"], count: int
               ) -> List["ChipState"]:
        ranked = sorted(chips, key=lambda c: self.score(c), reverse=True)
        return ranked[:count]


def _util_fraction(chip: "ChipState") -> float:
    cap = chip.virtual_capacity()
    if cap.tflops <= 0:
        return 0.0
    used_t = 1.0 - chip.available().tflops / cap.tflops
    used_h = (1.0 - chip.available().hbm_bytes / cap.hbm_bytes
              if cap.hbm_bytes > 0 else 0.0)
    return max(0.0, min(1.0, 0.5 * used_t + 0.5 * used_h))


class CompactFirst(Strategy):
    name = COMPACT_FIRST

    def score(self, chip, for_node=False):
        return 100.0 * _util_fraction(chip)


class LowLoadFirst(Strategy):
    name = LOW_LOAD_FIRST

    def score(self, chip, for_node=False):
        return 100.0 * (1.0 - _util_fraction(chip))


class NodeCompactChipLowLoad(Strategy):
    """Node score = compaction (high utilization good); chip score within a
    node = low load good.  The allocator calls with for_node=True when
    ranking nodes."""

    name = NODE_COMPACT_CHIP_LOW_LOAD

    def score(self, chip, for_node=False):
        u = _util_fraction(chip)
        return 100.0 * (u if for_node else (1.0 - u))


_STRATEGIES = {
    COMPACT_FIRST: CompactFirst,
    LOW_LOAD_FIRST: LowLoadFirst,
    NODE_COMPACT_CHIP_LOW_LOAD: NodeCompactChipLowLoad,
}


def new_strategy(name: str) -> Strategy:
    cls = _STRATEGIES.get(name, CompactFirst)
    return cls()
