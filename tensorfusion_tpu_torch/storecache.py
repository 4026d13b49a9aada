"""StoreCache: informer-style cached lister over a store's watch stream.

The port's copy of ``tensorfusion_tpu/storecache.py``.

The reference's controllers read through client-go informer caches — a
LIST once, then a WATCH keeps an indexed local map current, so reads are
memory lookups instead of apiserver round trips.  tpu-fusion's
scheduler, controllers, allocator and autoscaler previously re-listed
(and deep-copied) whole kinds per decision; ``StoreCache`` gives them
the informer contract instead:

- **zero-copy reads**: the cache holds the store's own frozen snapshots
  (see docs/control-plane-scale.md) — ``get``/``list`` return shared
  immutable objects, never copies;
- **event-fed**: against an in-process :class:`~tensorfusion_tpu_torch.store.
  ObjectStore` the cache registers a synchronous listener
  (``attach_listener`` — an atomic snapshot plus ordered delivery in
  the writer's thread, so a write is visible in the cache by the time
  the writing thread's next read runs); against a
  :class:`~tensorfusion_tpu_torch.remote_store.RemoteStore` it feeds from a
  replay watch (informer semantics: eventually consistent, resync on
  410);
- **indexed**: optional per-kind indexers (``pods by node``) maintained
  incrementally, plus ``on_event`` hooks for derived-value invalidation
  (the operator's running-node-names memo).

Events can arrive slightly out of order across writer threads; the
cache applies an event only when its object's resource_version is newer
than the cached one (per-key monotonicity), which also makes duplicate
replay ADDEDs idempotent.

Against a :class:`~tensorfusion_tpu_torch.shardedstore.ShardedStore` the same
attach path feeds the cache from EVERY shard's ring: events arrive
tagged with their feeding shard, keys are shard-exclusive (the shard
map routes each object to exactly one partition), so per-key
monotonicity IS per-shard rv monotonicity — the cache never compares
resource versions across shards.  ``shard_feed_rvs`` exposes the
per-shard apply high-water marks; a shard failover (``replace_shard``)
resyncs the cache informer-style through synthetic DELETED + ADDED
replay on the same feed.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Iterable, List, Optional, Type

from .api.meta import Resource
from .store import DELETED, Event

log = logging.getLogger("tpf.storecache")


class StoreCache:
    def __init__(self, store, kinds: Iterable[str] = (),
                 indexers: Optional[Dict[str, Dict[str, Callable]]] = None):
        """``kinds``: kinds to cache (empty = all seen).  ``indexers``:
        ``{kind: {index_name: key_fn(obj) -> str}}``; ``key_fn`` may
        return None to skip the object."""
        self._store = store
        self.kinds = set(kinds)
        self._indexers = indexers or {}
        self._lock = threading.Lock()
        # guarded by: _lock
        self._by_kind: Dict[str, Dict[str, Resource]] = {}
        # guarded by: _lock  — kind -> index -> value -> {key: obj}
        self._indexes: Dict[str, Dict[str, Dict[str, Dict[str, Resource]]]] = {}
        # guarded by: _lock  — kind -> key -> rv of the cached snapshot
        self._rvs: Dict[str, Dict[str, int]] = {}
        # guarded by: _lock  — feeding shard -> highest event rv applied
        # (sharded feeds only; each shard's rv sequence is independent)
        self._shard_rvs: Dict[int, int] = {}
        # guarded by: _lock  — stale/duplicate events dropped by the
        # per-key rv-monotonic apply (resync replays land here)
        self.stale_drops = 0
        self._listeners: List[Callable[[Event], None]] = []
        self._synced = threading.Event()
        self._watch = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._attached = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        attach = getattr(self._store, "attach_listener", None)
        if attach is not None:
            snapshot = attach(self._on_event)
            self._attached = True
            with self._lock:
                for obj in snapshot:
                    if not self.kinds or obj.KIND in self.kinds:
                        self._apply_locked("ADDED", obj)
            self._synced.set()
            return
        # remote store: replay watch feeds a background thread
        self._watch = self._store.watch(*sorted(self.kinds))
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch_loop,
                                        name="tpf-storecache", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._attached:
            self._store.detach_listener(self._on_event)
            self._attached = False
        if self._watch is not None:
            self._watch.stop()
            self._watch = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        self._synced.clear()

    def wait_synced(self, timeout: float = 10.0) -> bool:
        """True once the initial snapshot/replay has been applied."""
        return self._synced.wait(timeout)

    @property
    def synced(self) -> bool:
        return self._synced.is_set()

    def add_listener(self, fn: Callable[[Event], None]) -> None:
        """Called after each applied event (derived-cache invalidation);
        runs in the feeding thread — keep it O(1)."""
        self._listeners.append(fn)

    # -- feed --------------------------------------------------------------

    def _watch_loop(self) -> None:
        # remote replay delivers current state as ADDED first; mark
        # synced after the first drain of the initial burst
        while not self._stop.is_set():
            ev = self._watch.get(timeout=0.2)
            if ev is None:
                if not self._synced.is_set():
                    self._synced.set()
                continue
            self._on_event(ev)

    def _on_event(self, ev: Event) -> None:
        if self.kinds and ev.obj.KIND not in self.kinds:
            return
        with self._lock:
            shard = getattr(ev, "shard", -1)
            if shard >= 0 and ev.rv:
                prev = self._shard_rvs.get(shard, 0)
                self._shard_rvs[shard] = max(prev, ev.rv)
            applied = self._apply_locked(ev.type, ev.obj)
            if not applied and ev.type != DELETED:
                self.stale_drops += 1
        if applied:
            for fn in self._listeners:
                try:
                    fn(ev)
                except Exception:  # noqa: BLE001
                    log.exception("storecache listener failed")

    def _apply_locked(self, etype: str, obj: Resource) -> bool:
        kind, key = obj.KIND, obj.key()
        bucket = self._by_kind.setdefault(kind, {})
        rvs = self._rvs.setdefault(kind, {})
        rv = obj.metadata.resource_version
        if etype == DELETED:
            old = bucket.pop(key, None)
            rvs.pop(key, None)
            if old is not None:
                self._unindex_locked(kind, key, old)
            return old is not None
        # per-key rv monotonicity: stale/duplicate events no-op
        if key in rvs and rv <= rvs[key]:
            return False
        old = bucket.get(key)
        bucket[key] = obj
        rvs[key] = rv
        if old is not None:
            self._unindex_locked(kind, key, old)
        self._index_locked(kind, key, obj)
        return True

    def _index_locked(self, kind: str, key: str, obj: Resource) -> None:
        for index_name, key_fn in self._indexers.get(kind, {}).items():
            try:
                value = key_fn(obj)
            except Exception:  # noqa: BLE001
                # a broken indexer silently empties its index — the
                # scheduler would see zero pods on every node
                log.exception("indexer %s/%s failed on %s",
                              kind, index_name, key)
                continue
            if value is None:
                continue
            self._indexes.setdefault(kind, {}).setdefault(
                index_name, {}).setdefault(value, {})[key] = obj

    def _unindex_locked(self, kind: str, key: str, obj: Resource) -> None:
        for index_name, key_fn in self._indexers.get(kind, {}).items():
            try:
                value = key_fn(obj)
            except Exception:  # noqa: BLE001
                log.exception("indexer %s/%s failed unindexing %s",
                              kind, index_name, key)
                continue
            if value is None:
                continue
            vmap = self._indexes.get(kind, {}).get(index_name, {})
            entries = vmap.get(value)
            if entries is not None:
                entries.pop(key, None)
                if not entries:
                    del vmap[value]

    # -- reads (all frozen shared snapshots, zero copies) ------------------

    def get(self, cls: Type[Resource], name: str,
            namespace: str = "") -> Optional[Resource]:
        key = f"{namespace}/{name}" if cls.NAMESPACED else name
        with self._lock:
            return self._by_kind.get(cls.KIND, {}).get(key)

    try_get = get

    def list(self, cls: Type[Resource],
             selector: Optional[Callable[[Resource], bool]] = None
             ) -> List[Resource]:
        with self._lock:
            objs = list(self._by_kind.get(cls.KIND, {}).values())
        if selector is not None:
            objs = [o for o in objs if selector(o)]
        return objs

    def by_index(self, cls: Type[Resource], index_name: str,
                 value: str) -> List[Resource]:
        with self._lock:
            return list(self._indexes.get(cls.KIND, {})
                        .get(index_name, {}).get(value, {}).values())

    def count(self, cls: Type[Resource]) -> int:
        with self._lock:
            return len(self._by_kind.get(cls.KIND, {}))

    def shard_feed_rvs(self) -> Dict[int, int]:
        """Per-feeding-shard apply high-water marks (empty for plain
        single-store feeds) — the sharded-feed regression battery
        asserts these only ever grow, per shard, never compared
        across shards."""
        with self._lock:
            return dict(self._shard_rvs)
