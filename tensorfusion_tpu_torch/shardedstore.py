"""ShardedStore: the partitioned control-plane state backbone.

The port's copy of ``tensorfusion_tpu/shardedstore.py``.

Every prior scale win still funneled through ONE in-memory
:class:`~tensorfusion_tpu_torch.store.ObjectStore` + journal — the same
single-binary control plane the survey criticizes in the reference's L5
layer (PAPER.md §1).  This module partitions it
(docs/control-plane-scale.md, "Sharded control plane"):

- **N partitions**: each shard is a full ObjectStore — its own lock,
  its own watch ring, its own resourceVersion sequence, and its own
  append-only journal (so group-commit flushes parallelize across
  shards instead of serializing on one file);
- **stable routing**: a :class:`ShardMap` sends every object to exactly
  one shard by its *routing key* — the namespace for namespaced kinds,
  ``"<Kind>/<name>"`` for cluster-scoped ones — via explicit pins
  (cell-aligned deployments pin a pool's namespaces next to its nodes)
  or a stable hash.  TPUChips follow their node's shard, so node
  capacity always lives with the node's shard owner.  First placement
  wins and is remembered (``_placement``), so objects written directly
  by a shard owner are found by router reads wherever they live;
- **ownership**: each shard has exactly ONE owning operator process,
  elected through a per-shard Lease *stored in the shard itself*
  (:class:`~tensorfusion_tpu_torch.utils.leader.ShardLeaseElector`) — the
  owner runs the full controller stack against its shard only, and its
  writes go straight to the shard store (the "shard-owner context" the
  ``shard-routing`` tpflint checker recognizes);
- **cross-shard reads**: merged ``list``/``watch`` and the listener
  feed concatenate per-shard streams.  Ordering is **rv-monotonic per
  shard and never invented across shards** — every delivered
  :class:`~tensorfusion_tpu_torch.store.Event` carries its feeding ``shard``
  so consumers (StoreCache replicas) can account monotonicity per
  feeder;
- **failover**: :meth:`ShardedStore.replace_shard` swaps a dead
  shard's partition for one replayed from its journal and resyncs
  every attached consumer informer-style (synthetic DELETED for
  objects that vanished in the loss window, ADDED replay for current
  state — duplicate ADDEDs are the same contract replay watches and
  RemoteWatch resets already have).

``events_since``/remote long-poll windows stay a per-shard surface: a
cross-shard window would need a global version order that does not
exist.  ``shards == 1`` is the default deployment and behaves exactly
like a bare ObjectStore.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Type

from .api.meta import Resource
from .store import (ADDED, DELETED, AlreadyExistsError, Event,
                    NotFoundError, ObjectStore, Watch)

log = logging.getLogger("tpf.shardedstore")


def stable_shard(route_key: str, n_shards: int) -> int:
    """Stable hash placement: the same key maps to the same shard on
    every replica and across restarts (blake2b, not ``hash()`` — the
    latter is salted per process)."""
    if n_shards <= 1:
        return 0
    digest = hashlib.blake2b(route_key.encode("utf-8"),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big") % n_shards


def route_key_for(kind: str, namespaced: bool, name: str,
                  namespace: str = "") -> str:
    """The unit of co-location: everything in one namespace shards
    together (a workload and its pods never split), cluster-scoped
    objects shard individually by kind-qualified name."""
    return namespace if namespaced else f"{kind}/{name}"


class ShardMap:
    """Stable (pool, namespace) -> shard assignment: explicit pins
    first (cell-aligned deployments pin each pool's namespaces and
    nodes onto one shard), stable hash for everything else."""

    def __init__(self, n_shards: int,
                 pins: Optional[Dict[str, int]] = None):
        self.n_shards = max(int(n_shards), 1)
        self._pins: Dict[str, int] = dict(pins or {})

    def pin(self, route_key: str, shard: int) -> None:
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range "
                             f"[0, {self.n_shards})")
        self._pins[route_key] = shard

    def shard_of(self, route_key: str) -> int:
        pinned = self._pins.get(route_key)
        if pinned is not None:
            return pinned
        return stable_shard(route_key, self.n_shards)

    def to_dict(self) -> dict:
        return {"n_shards": self.n_shards,
                "pins": dict(sorted(self._pins.items()))}


class MergedWatch:
    """One cross-shard event stream: a cursor per shard plus a shared
    wake flag.  Per-shard order (and per-shard rv monotonicity) is
    preserved because each shard's events come off that shard's own
    ring cursor; shards are drained round-robin and no ordering is
    invented between them.  Delivered events carry ``shard``."""

    def __init__(self, router: "ShardedStore", kinds: Iterable[str],
                 replay: bool = True, conflate: bool = False):
        self._router = router
        self.kinds = set(kinds)
        self._conflate = conflate
        self._closed = False
        self._wake = threading.Event()
        self._rr = 0
        self._lock = threading.Lock()
        # guarded by: _lock  — synthetic failover events (resync path)
        self._synthetic: List[Event] = []
        #: per-shard underlying cursors (index == shard)
        self._cursors: List[Watch] = [
            store.watch(*sorted(self.kinds), replay=replay,
                        conflate=conflate)
            for store in router.shards]
        #: times a shard swap forced an informer-style resync
        self.resyncs = 0
        self._on_any_event = lambda ev: self._wake.set()
        router._register_watch(self)

    @property
    def shard_resyncs(self) -> int:
        """Router-level resyncs plus every cursor's own ring resyncs."""
        return self.resyncs + sum(c.resyncs for c in self._cursors)

    def stop(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._router._unregister_watch(self)
        for c in self._cursors:
            c.stop()
        self._wake.set()

    def __iter__(self):
        while True:
            ev = self.get()
            if ev is None:
                return
            yield ev

    def get(self, timeout: Optional[float] = None) -> Optional[Event]:
        import time as _time
        deadline = None if timeout is None \
            else _time.monotonic() + max(0.0, timeout)
        while True:
            # clear BEFORE polling: a write landing after the poll sets
            # the flag again, so the wait below returns immediately
            self._wake.clear()
            with self._lock:
                if self._synthetic:
                    return self._synthetic.pop(0)
                closed = self._closed
                cursors = list(self._cursors)
            n = len(cursors)
            for k in range(n):
                i = (self._rr + k) % n
                ev = cursors[i].get(timeout=0)
                if ev is not None:
                    self._rr = (i + 1) % n
                    return Event(ev.type, ev.obj, ev.rv, shard=i)
            if closed:
                return None
            if deadline is None:
                self._wake.wait(1.0)
            else:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return None
                self._wake.wait(min(remaining, 1.0))

    # -- failover (router-called) ------------------------------------------

    def _swap_shard(self, shard: int, vanished: List[Resource],
                    new_store: ObjectStore) -> None:
        """Shard ``shard`` was replaced: synthesize DELETED for objects
        that did not survive the swap, then a fresh replay cursor on
        the successor store (duplicate ADDEDs for survivors — the
        informer resync contract)."""
        old = self._cursors[shard]
        fresh = new_store.watch(*sorted(self.kinds), replay=True,
                                conflate=self._conflate)
        with self._lock:
            for obj in vanished:
                if self.kinds and obj.KIND not in self.kinds:
                    continue
                self._synthetic.append(Event(DELETED, obj, shard=shard))
            self._cursors[shard] = fresh
            self.resyncs += 1
        old.stop()
        self._wake.set()


class ShardedStore:
    """Write router + read/watch aggregator over N ObjectStore
    partitions.  Implements the store interface controllers, caches and
    :func:`~tensorfusion_tpu_torch.store.mutate` already speak."""

    def __init__(self, shards: Optional[List[ObjectStore]] = None,
                 n_shards: int = 1,
                 persist_dir: Optional[str] = None,
                 shard_map: Optional[ShardMap] = None):
        if shards is None:
            shards = []
            for i in range(max(int(n_shards), 1)):
                sub = os.path.join(persist_dir, f"shard-{i:02d}") \
                    if persist_dir else None
                # the router IS the legal construction site for shard
                # partitions (tpflint shard-routing exempts this file)
                shards.append(ObjectStore(persist_dir=sub))
        if not shards:
            raise ValueError("ShardedStore needs at least one shard")
        self.shards: List[ObjectStore] = list(shards)
        self.map = shard_map or ShardMap(len(self.shards))
        if self.map.n_shards != len(self.shards):
            raise ValueError(
                f"shard map covers {self.map.n_shards} shards but "
                f"{len(self.shards)} partitions were given")
        self._persist_dir = persist_dir
        self._lock = threading.Lock()
        # (kind, object key) -> shard index; first placement wins.
        # Entries appear on router writes, journal load, and read
        # probes — shard-owner writes that bypass the router are still
        # discovered.  guarded by: _lock
        self._placement: Dict[Tuple[str, str], int] = {}
        # listener fn -> per-shard forwarding closures (attach order
        # preserved per shard by each shard's own combiner)
        # guarded by: _lock
        self._taps: Dict[Callable, List[Callable]] = {}
        # guarded by: _lock
        self._merged_watches: List[MergedWatch] = []

    # -- routing -----------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def _route_key_obj(self, obj: Resource) -> str:
        if obj.KIND == "TPUChip":
            node = getattr(obj.status, "node_name", "")
            if node:
                # chips co-locate with their node: capacity accounting
                # stays with the node's shard owner
                return route_key_for("Node", False, node)
        return route_key_for(obj.KIND, obj.NAMESPACED,
                             obj.metadata.name, obj.metadata.namespace)

    def shard_for(self, cls: Type[Resource], name: str,
                  namespace: str = "") -> int:
        """The shard an object of this identity routes to (placement
        registry first, then the stable map)."""
        key = f"{namespace}/{name}" if cls.NAMESPACED else name
        with self._lock:
            placed = self._placement.get((cls.KIND, key))
        if placed is not None:
            return placed
        return self.map.shard_of(
            route_key_for(cls.KIND, cls.NAMESPACED, name, namespace))

    def shard_store(self, shard: int) -> ObjectStore:
        return self.shards[shard]

    def shard_rvs(self) -> List[int]:
        """Per-shard resourceVersion high-water marks.  There is no
        global version order across shards — by design."""
        return [s.current_rv for s in self.shards]

    @property
    def current_rv(self) -> int:
        """Total writes across all shards (monotonic; NOT a watchable
        position — cross-shard windows do not exist)."""
        return sum(self.shard_rvs())

    def _remember(self, kind: str, key: str, shard: int) -> None:
        with self._lock:
            self._placement[(kind, key)] = shard

    def _forget(self, kind: str, key: str) -> None:
        with self._lock:
            self._placement.pop((kind, key), None)

    def _locate(self, cls: Type[Resource], name: str,
                namespace: str = "") -> Optional[int]:
        """Owning shard of an existing object: mapped shard first, then
        probe the rest (finds shard-owner writes that never crossed the
        router); the hit is cached in the placement registry."""
        key = f"{namespace}/{name}" if cls.NAMESPACED else name
        first = self.shard_for(cls, name, namespace)
        order = [first] + [i for i in range(len(self.shards))
                           if i != first]
        for i in order:
            if self.shards[i].try_get(cls, name, namespace) is not None:
                self._remember(cls.KIND, key, i)
                return i
        return None

    # -- CRUD --------------------------------------------------------------

    def create(self, obj: Resource) -> Resource:
        idx = self.map.shard_of(self._route_key_obj(obj))
        key = obj.key()
        existing = self._locate(type(obj), obj.metadata.name,
                                obj.metadata.namespace)
        if existing is not None:
            raise AlreadyExistsError(
                f"{obj.KIND} {key} already exists (shard {existing})")
        stored = self.shards[idx].create(obj)
        self._remember(obj.KIND, key, idx)
        return stored

    def get(self, cls: Type[Resource], name: str,
            namespace: str = "") -> Resource:
        idx = self._locate(cls, name, namespace)
        if idx is None:
            key = f"{namespace}/{name}" if cls.NAMESPACED else name
            raise NotFoundError(f"{cls.KIND} {key} not found")
        return self.shards[idx].get(cls, name, namespace)

    def try_get(self, cls: Type[Resource], name: str,
                namespace: str = "") -> Optional[Resource]:
        try:
            return self.get(cls, name, namespace)
        except NotFoundError:
            return None

    def update(self, obj: Resource, check_version: bool = False
               ) -> Resource:
        idx = self._locate(type(obj), obj.metadata.name,
                           obj.metadata.namespace)
        if idx is None:
            raise NotFoundError(f"{obj.KIND} {obj.key()} not found")
        return self.shards[idx].update(obj, check_version=check_version)

    def update_or_create(self, obj: Resource) -> Resource:
        try:
            return self.update(obj)
        except NotFoundError:
            try:
                return self.create(obj)
            except AlreadyExistsError:
                return self.update(obj)

    def delete(self, cls: Type[Resource], name: str,
               namespace: str = "") -> None:
        idx = self._locate(cls, name, namespace)
        if idx is None:
            key = f"{namespace}/{name}" if cls.NAMESPACED else name
            raise NotFoundError(f"{cls.KIND} {key} not found")
        self.shards[idx].delete(cls, name, namespace)
        key = f"{namespace}/{name}" if cls.NAMESPACED else name
        self._forget(cls.KIND, key)

    def list(self, cls: Type[Resource], namespace: Optional[str] = None,
             selector: Optional[Callable[[Resource], bool]] = None
             ) -> List[Resource]:
        """Concatenated per-shard lists, shard order — per-shard
        snapshots are atomic, the cross-shard view is the usual
        eventually-consistent informer read."""
        out: List[Resource] = []
        for store in self.shards:
            out.extend(store.list(cls, namespace=namespace,
                                  selector=selector))
        return out

    # -- watch / listener fan-in -------------------------------------------

    def watch(self, *kinds: str, replay: bool = True,
              conflate: bool = False) -> MergedWatch:
        return MergedWatch(self, kinds, replay=replay,
                           conflate=conflate)

    def _register_watch(self, w: MergedWatch) -> None:
        with self._lock:
            self._merged_watches.append(w)
        # each shard write pokes the merged watch's wake flag (set on
        # an already-set flag is near-free; no thundering herd)
        taps = []
        for i, store in enumerate(self.shards):
            store.attach_listener(w._on_any_event)
            taps.append(w._on_any_event)
        with self._lock:
            self._taps[w._on_any_event] = taps

    def _unregister_watch(self, w: MergedWatch) -> None:
        with self._lock:
            try:
                self._merged_watches.remove(w)
            except ValueError:
                pass
            self._taps.pop(w._on_any_event, None)
        for store in self.shards:
            store.detach_listener(w._on_any_event)

    def attach_listener(self, fn: Callable[[Event], None]
                        ) -> List[Resource]:
        """StoreCache feed across every shard: one forwarding closure
        per shard tags events with their feeding shard; delivery stays
        ordered per shard (each shard's combiner), merged snapshot
        returned in shard order."""
        snap: List[Resource] = []
        forwarders: List[Callable] = []
        for i, store in enumerate(self.shards):
            def forward(ev: Event, _i=i, _fn=fn) -> None:
                _fn(Event(ev.type, ev.obj, ev.rv, shard=_i))
            forwarders.append(forward)
            snap.extend(store.attach_listener(forward))
        with self._lock:
            self._taps[fn] = forwarders
        return snap

    def detach_listener(self, fn: Callable[[Event], None]) -> None:
        with self._lock:
            forwarders = self._taps.pop(fn, None)
        if not forwarders:
            return
        for store, forward in zip(self.shards, forwarders):
            store.detach_listener(forward)

    # -- failover ----------------------------------------------------------

    def replace_shard(self, shard: int, new_store: ObjectStore
                      ) -> Dict[str, int]:
        """Swap shard ``shard``'s partition for a successor store
        (journal-replayed after an owner crash) and resync every
        attached consumer: listeners get synthetic DELETED events for
        objects that did not survive the loss window, then the
        successor's full state as ADDED (rv-monotonic consumers no-op
        the unchanged survivors); merged watches swap their cursor the
        same way.  Returns ``{"survived": n, "vanished": m}``."""
        old = self.shards[shard]
        with self._lock:
            self.shards[shard] = new_store
            # placements pointing at the dead partition rebuild by probe
            self._placement = {k: v for k, v in self._placement.items()
                               if v != shard}
            taps = {fn: fwds for fn, fwds in self._taps.items()
                    if len(fwds) == len(self.shards)}
            watches = list(self._merged_watches)
        old_objs = {(o.KIND, o.key()): o for o in old.snapshot_objects()}
        new_objs: Dict[Tuple[str, str], Resource] = {}
        for fn, forwarders in taps.items():
            old.detach_listener(forwarders[shard])

            def forward(ev: Event, _i=shard, _fn=fn) -> None:
                _fn(Event(ev.type, ev.obj, ev.rv, shard=_i))
            # the attach snapshot IS the resync cut: events after it
            # flow through the new tap in order
            cut = new_store.attach_listener(forward)
            forwarders[shard] = forward
            new_objs = {(o.KIND, o.key()): o for o in cut}
            for okey in sorted(set(old_objs) - set(new_objs)):
                fn(Event(DELETED, old_objs[okey], shard=shard))
            for okey in sorted(new_objs):
                obj = new_objs[okey]
                fn(Event(ADDED, obj,
                         obj.metadata.resource_version, shard=shard))
        if not taps:
            new_objs = {(o.KIND, o.key()): o
                        for o in new_store.snapshot_objects()}
        vanished = [old_objs[k] for k in sorted(set(old_objs)
                                                - set(new_objs))]
        for w in watches:
            w._swap_shard(shard, vanished, new_store)
        for (kind, key) in sorted(new_objs):
            self._remember(kind, key, shard)
        log.info("shard %d replaced: %d objects survived, %d vanished "
                 "in the loss window", shard, len(new_objs),
                 len(vanished))
        return {"survived": len(new_objs), "vanished": len(vanished)}

    # -- persistence / lifecycle -------------------------------------------

    def load(self, kind_classes: Iterable[Type[Resource]]) -> int:
        """Replay every shard's journal and rebuild the placement
        registry from what each partition holds."""
        kind_classes = list(kind_classes)
        n = 0
        for i, store in enumerate(self.shards):
            n += store.load(kind_classes)
            for obj in store.snapshot_objects():
                self._remember(obj.KIND, obj.key(), i)
        return n

    def flush_journal(self) -> None:
        for store in self.shards:
            store.flush_journal()

    def close(self) -> None:
        for store in self.shards:
            store.close()

    def enable_event_log(self) -> None:
        for store in self.shards:
            store.enable_event_log()

    # -- remote-window surface (per-shard only) ----------------------------

    def snapshot_events(self, kinds: Iterable[str] = ()
                        ) -> Tuple[List[int], List[Tuple[str, str, dict]]]:
        """Per-shard rv vector + concatenated ADDED replay.  A remote
        watcher must then follow each shard's window separately."""
        rvs: List[int] = []
        events: List[Tuple[str, str, dict]] = []
        for store in self.shards:
            rv, evs = store.snapshot_events(kinds)
            rvs.append(rv)
            events.extend(evs)
        return rvs, events

    def events_since(self, since_rv: int, kinds: Iterable[str] = (),
                     wait_s: float = 0.0, serialized: bool = False,
                     conflate: bool = False):
        """Single-shard passthrough only: a merged cross-shard window
        would have to invent a global rv order that does not exist —
        remote watchers of a sharded cell attach one window per shard
        (``shard_store(i).events_since``)."""
        if len(self.shards) == 1:
            return self.shards[0].events_since(
                since_rv, kinds, wait_s=wait_s, serialized=serialized,
                conflate=conflate)
        raise NotImplementedError(
            "events_since is a per-shard surface; use "
            "shard_store(i).events_since — merged views never invent "
            "ordering across shards")
