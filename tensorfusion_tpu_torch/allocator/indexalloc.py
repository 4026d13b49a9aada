"""Small-int device-allocation index per pod.

The port's copy of ``tensorfusion_tpu/allocator/indexalloc.py``.

Analog of the reference's ``internal/indexallocator/indexallocator.go:29-345``:
every vTPU pod gets a small integer index (annotation ``tpu-fusion.ai/index``)
used to correlate the pod with its device-plugin allocation slot.
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, Optional


class IndexExhaustedError(Exception):
    pass


class IndexAllocator:
    def __init__(self, max_index: int = 1024):
        self.max_index = max_index
        self._lock = threading.RLock()
        self._by_owner: Dict[str, int] = {}
        # O(1) assignment: a watermark plus a min-heap of released indices
        self._next = 0
        self._free: list = []

    def assign(self, owner: str) -> int:
        with self._lock:
            if owner in self._by_owner:
                return self._by_owner[owner]
            if self._free:
                i = heapq.heappop(self._free)
            elif self._next < self.max_index:
                i = self._next
                self._next += 1
            else:
                raise IndexExhaustedError(
                    f"all {self.max_index} indices in use")
            self._by_owner[owner] = i
            return i

    def release(self, owner: str) -> Optional[int]:
        with self._lock:
            idx = self._by_owner.pop(owner, None)
            if idx is not None:
                heapq.heappush(self._free, idx)
            return idx

    def reconcile(self, assignments: Dict[str, int]) -> None:
        """Rebuild from persisted pod annotations.  Out-of-range indices
        (corrupt or foreign annotations) are dropped so one bad value can
        neither bypass the max_index bound nor balloon the free list.
        Duplicate indices (corrupt or copy-pasted annotations) would break
        the index's device-slot-correlation contract, so only the first
        owner (deterministic: lexicographic order) keeps the index and
        every later claimant is reassigned a fresh one."""
        with self._lock:
            self._by_owner = {}
            displaced = []
            claimed: Dict[int, str] = {}
            for owner in sorted(assignments):
                idx = assignments[owner]
                if not 0 <= idx < self.max_index:
                    continue
                if idx in claimed:
                    displaced.append(owner)
                    continue
                claimed[idx] = owner
                self._by_owner[owner] = idx
            used = set(self._by_owner.values())
            self._next = max(used) + 1 if used else 0
            self._free = [i for i in range(self._next) if i not in used]
            heapq.heapify(self._free)
            for owner in displaced:
                try:
                    self.assign(owner)
                except IndexExhaustedError:
                    # restart recovery must never throw: the displaced
                    # owner simply loses its index (re-assigned on demand)
                    pass
