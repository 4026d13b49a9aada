"""Bitmap host-port allocator.

The port's copy of ``tensorfusion_tpu/allocator/portalloc.py``.

Analog of the reference's ``internal/portallocator/portallocator.go:36-358``:
two ranges — per-node host ports (40000-42000) for worker processes, and a
cluster-level range (42000-62000) for cross-node endpoints.  Leader-only
assignment in the reference maps to the control plane's HTTP API
(``/assign-host-port``); released ports return to the bitmap when the owning
pod is deleted.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from .. import constants


class PortExhaustedError(Exception):
    pass


class _Range:
    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi
        self.bits = bytearray((hi - lo + 7) // 8)
        self.owners: Dict[int, str] = {}

    def _test(self, i: int) -> bool:
        return bool(self.bits[i // 8] & (1 << (i % 8)))

    def _set(self, i: int, v: bool) -> None:
        if v:
            self.bits[i // 8] |= 1 << (i % 8)
        else:
            self.bits[i // 8] &= ~(1 << (i % 8))

    def alloc(self, owner: str) -> int:
        # idempotent per owner: bind retries must not leak ports
        for port, o in self.owners.items():
            if o == owner:
                return port
        for i in range(self.hi - self.lo):
            if not self._test(i):
                self._set(i, True)
                port = self.lo + i
                self.owners[port] = owner
                return port
        raise PortExhaustedError(f"range {self.lo}-{self.hi} exhausted")

    def release(self, port: int) -> bool:
        if not (self.lo <= port < self.hi):
            return False
        i = port - self.lo
        if not self._test(i):
            return False
        self._set(i, False)
        self.owners.pop(port, None)
        return True

    def release_owner(self, owner: str) -> int:
        n = 0
        for port in [p for p, o in self.owners.items() if o == owner]:
            self.release(port)
            n += 1
        return n

    def mark(self, port: int, owner: str) -> None:
        if self.lo <= port < self.hi:
            self._set(port - self.lo, True)
            self.owners[port] = owner


class PortAllocator:
    def __init__(self,
                 node_range: Tuple[int, int] = constants.NODE_PORT_RANGE,
                 cluster_range: Tuple[int, int] = constants.CLUSTER_PORT_RANGE):
        self._lock = threading.RLock()
        self._node_ranges: Dict[str, _Range] = {}
        self._node_span = node_range
        self._cluster = _Range(*cluster_range)

    def assign_node_port(self, node: str, owner: str) -> int:
        with self._lock:
            rng = self._node_ranges.setdefault(node, _Range(*self._node_span))
            return rng.alloc(owner)

    def assign_cluster_port(self, owner: str) -> int:
        with self._lock:
            return self._cluster.alloc(owner)

    def release_node_port(self, node: str, port: int) -> bool:
        with self._lock:
            rng = self._node_ranges.get(node)
            return rng.release(port) if rng else False

    def release_cluster_port(self, port: int) -> bool:
        with self._lock:
            return self._cluster.release(port)

    def release_owner(self, owner: str) -> int:
        """Release every port held by a pod (pod-delete loop analog)."""
        with self._lock:
            n = self._cluster.release_owner(owner)
            for rng in self._node_ranges.values():
                n += rng.release_owner(owner)
            return n

    def reconcile(self, assignments) -> None:
        """Rebuild from live pods: iterable of (node|None, port, owner)."""
        with self._lock:
            for node, port, owner in assignments:
                if node:
                    rng = self._node_ranges.setdefault(
                        node, _Range(*self._node_span))
                    rng.mark(port, owner)
                else:
                    self._cluster.mark(port, owner)
