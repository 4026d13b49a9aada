"""Versioned in-memory object store with watch streams.

The port's copy of ``tensorfusion_tpu/store.py``.

The tpu-fusion control plane's state backbone — the role the Kubernetes
apiserver + controller-runtime informer cache plays for the reference
(NexusGPU/tensor-fusion runs controllers against CRDs; here the platform is
self-hosted, so a thread-safe store with optimistic concurrency and watch
queues provides the same contract: create/get/update/delete/list + ADDED/
MODIFIED/DELETED events that drive reconcile loops).

Copy-on-write snapshots (docs/control-plane-scale.md): every write builds
ONE deeply frozen copy of the object; ``get``/``list``/watch events all
share that snapshot at zero cost instead of deep-copying per consumer.
Mutating a snapshot raises
:class:`~tensorfusion_tpu_torch.api.meta.FrozenResourceError` — writers take a
private copy with ``.thaw()`` or go through :func:`mutate`.  The
``frozen-view-mutation`` tpflint checker enforces the discipline
statically.

Event fan-out is a shared sequenced ring: a write appends one immutable
record and notifies; each :class:`Watch` is a *cursor* over the ring that
pulls events in its consumer's own thread (delivery happens outside the
store lock).  A slow watcher's backlog is conflated to the newest event
per object (bounded delivery), and one that falls off the ring resyncs
informer-style (synthetic DELETED for vanished objects + ADDED replay).
The same ring backs remote long-poll watches with per-event cached
serialization (the apiserver's cached-serialization trick).

Optionally persists every kind to a JSON-lines file so a restarted
control plane can rebuild (restart recovery is then exercised the same
way the reference rebuilds allocator state from annotations,
gpuallocator.go:2592).  Persistence is an **append-only journal with
periodic compaction and group commit**: writes buffer journal entries
under the lock, and a burst is encoded + flushed in one batch off the
critical section (one ``write()``+``flush()`` per burst instead of per
write).  The loss window on a crash is bounded by
``JOURNAL_GROUP_LATENCY_S`` (the journal was never fsync-durable — a
torn tail was always tolerated at load).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
from time import monotonic as _monotonic
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Type

from .api.meta import (FrozenResourceError, Resource, freeze_copy,
                       from_dict, is_frozen, sparse_dict)

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

log = logging.getLogger("tpf.store")

#: bounded history backing both in-process watch cursors and remote
#: long-poll watches; at control-plane event rates (binds, status
#: writebacks) this covers hours of history — a consumer further behind
#: than this resyncs (in-process) or gets ``reset`` and re-lists (remote)
EVENT_LOG_SIZE = 65536
#: ring trim granularity (amortizes the list slice-delete)
_RING_TRIM = 4096
#: a watcher with more than this many pending events gets its backlog
#: conflated to the newest event per object even without ``conflate=True``
#: (bounded slow-watcher delivery; reconcile-style consumers only ever
#: need latest state per key)
WATCH_CONFLATE_BACKLOG = 4096
#: max ring records examined per Watch.get() fill (keeps one get() call
#: from stalling on a giant backlog; conflation uses the full backlog)
_WATCH_FILL_BATCH = 2048
#: adaptive wake coalescing for reconcile-mode (conflate=True) watches:
#: a watch re-woken within this window of parking is riding sustained
#: churn — after WATCH_COALESCE_AFTER consecutive short parks it sleeps
#: the window out before refilling, so its wake rate is bounded at
#: ~1/window and the burst conflates in ONE fill pass.  An idle watch,
#: or one seeing a short event chain (a reconcile cascade in a test),
#: never sleeps — zero added latency off sustained churn.  This is what
#: holds fan-out retention flat at hundreds of watchers: without it,
#: every write wakes every parked consumer and the writer starves on
#: the GIL (measured 0.6% retention at 500 watchers; 91% with this).
WATCH_WAKE_COALESCE_S = 0.25
#: consecutive same-window re-wakes before coalescing engages
WATCH_COALESCE_AFTER = 3

#: journal group-commit: a kind's pending entries are flushed by the
#: writer once this many accumulate ...
JOURNAL_GROUP_LINES = 128
#: ... and by the background flusher at this cadence otherwise (this is
#: also the crash loss window — see module docstring)
JOURNAL_GROUP_LATENCY_S = 0.05


class ConflictError(Exception):
    """Optimistic-concurrency failure: resource_version mismatch."""


class NotFoundError(KeyError):
    pass


class AlreadyExistsError(Exception):
    pass


@dataclass
class Event:
    type: str
    obj: Resource
    #: store resource version of this event (0 for replay/resync events)
    rv: int = 0
    #: feeding shard when the event crossed a ShardedStore router
    #: (docs/control-plane-scale.md); -1 for plain single-store events
    shard: int = -1


class _EventRecord:
    """One ring entry: the frozen object plus lazily cached wire forms
    (``to_dict`` once per event for remote windows, JSON fragment once
    per event for the gateway's serialized fan-out)."""

    __slots__ = ("rv", "etype", "kind", "obj", "dict", "json")

    def __init__(self, rv: int, etype: str, obj: Resource):
        self.rv = rv
        self.etype = etype
        self.kind = obj.KIND
        self.obj = obj
        self.dict: Optional[dict] = None
        self.json: Optional[str] = None

    def obj_dict(self) -> dict:
        d = self.dict
        if d is None:
            d = self.dict = self.obj.to_dict()
        return d


class Watch:
    """One subscriber's event stream: a cursor over the store's shared
    event ring (closeable iterator).

    Events are pulled in the consumer's thread — the writer never does
    per-watcher work.  All objects delivered are frozen shared snapshots.
    A watcher that falls behind conflates its backlog (newest event per
    object); one that falls off the bounded ring resyncs: synthetic
    DELETED events for objects that vanished while it lagged, then the
    current state as ADDED events (``resyncs`` counts these — the same
    re-list contract RemoteWatch applies on 410-Gone resets).
    """

    def __init__(self, store: "ObjectStore", kinds: Iterable[str],
                 conflate: bool = False):
        self._store = store
        self.kinds = set(kinds)
        self._conflate = conflate
        self._closed = False
        #: absolute ring sequence of the next record to consider
        self._pos = 0
        #: ready-to-deliver events (replay/resync/conflated fills land here)
        self._out: "collections.deque[Event]" = collections.deque()
        #: (kind, key) -> last delivered snapshot (resync diff base)
        self._known: Dict[tuple, Resource] = {}
        #: times this watch fell off the ring and re-listed
        self.resyncs = 0
        #: wake-once signal: set by the writer when this watch is parked
        #: (see ObjectStore._parked) — a consumer that is busy draining
        #: never costs the writer anything
        self._wake = threading.Event()
        #: pure sleeper for wake coalescing (never set except by
        #: stop(), so wait(t) is an interruptible sleep)
        self._coalesce = threading.Event()
        #: consecutive short-park wakes (coalescing engages past
        #: WATCH_COALESCE_AFTER; any long park resets it)
        self._hot = 0

    def stop(self) -> None:
        with self._store._cond:
            if self._closed:
                return
            self._closed = True
            try:
                self._store._watches.remove(self)
            except ValueError:
                pass
            self._store._parked.discard(self)
            self._wake.set()
            self._coalesce.set()
            self._store._cond.notify_all()

    def __iter__(self):
        while True:
            ev = self.get()
            if ev is None:
                return
            yield ev

    def get(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Next event; None on timeout or after stop().  Buffered events
        are drained even after stop() (matching the old queue contract);
        un-pulled ring history is dropped at stop.

        Waiting is wake-once: with nothing pending the watch parks
        itself (ObjectStore._parked) and blocks on its own event flag
        OUTSIDE the store lock; the next write wakes it exactly once
        and forgets it until it parks again.  Pre-PR every write did a
        ``notify_all`` on the shared condition — at N parked watchers
        that is an N-thread thundering herd per write, which is what
        capped fan-out retention at high watcher counts."""
        import time as _time
        deadline = None if timeout is None \
            else _time.monotonic() + max(0.0, timeout)
        while True:
            with self._store._cond:
                if self._out:
                    return self._out.popleft()
                if self._closed:
                    return None
                self._fill_locked()
                if self._out:
                    return self._out.popleft()
                # nothing pending: park under the same lock _emit holds,
                # so clear-then-park can never lose a wake
                self._wake.clear()
                self._store._parked.add(self)
            parked_at = _time.monotonic()
            if deadline is None:
                self._wake.wait(1.0)
            else:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    with self._store._lock:
                        self._store._parked.discard(self)
                    return None
                self._wake.wait(min(remaining, 1.0))
            if self._conflate and not self._closed and \
                    self._wake.is_set() and \
                    _time.monotonic() - parked_at < WATCH_WAKE_COALESCE_S:
                self._hot += 1
                if self._hot >= WATCH_COALESCE_AFTER:
                    # re-woken almost immediately, repeatedly:
                    # sustained churn.  Sleep the window out so the
                    # burst conflates into ONE fill instead of one
                    # wake per write (idle watches and short reconcile
                    # cascades never get here — zero added latency)
                    self._coalesce.wait(WATCH_WAKE_COALESCE_S)
            else:
                self._hot = 0

    # -- internal (store._cond held) ---------------------------------------

    def _note(self, etype: str, obj: Resource) -> None:
        k = (obj.KIND, obj.key())
        if etype == DELETED:
            self._known.pop(k, None)
        else:
            self._known[k] = obj

    def _prime_locked(self, replay: bool) -> None:
        store = self._store
        self._pos = store._ring_base + len(store._ring)
        if not replay:
            return
        for kind, bucket in store._objects.items():
            if self.kinds and kind not in self.kinds:
                continue
            for obj in bucket.values():
                self._known[(kind, obj.key())] = obj
                self._out.append(Event(ADDED, obj))

    def _fill_locked(self) -> None:
        store = self._store
        base = store._ring_base
        if self._pos < base:
            self._resync_locked()
            return
        ring = store._ring
        i = self._pos - base
        n = len(ring)
        if i >= n:
            return
        if self._conflate or (n - i) > WATCH_CONFLATE_BACKLOG:
            # a watcher further behind than the live object count is
            # served cheaper by DIFFING STATE than by scanning its
            # backlog: O(live + known) instead of O(backlog), and the
            # shared frozen snapshots make change detection an identity
            # check.  Same net-transition semantics as the scan below.
            live = 0
            if self.kinds:
                for kind in self.kinds:
                    live += len(store._objects.get(kind, ()))
            else:
                for bucket in store._objects.values():
                    live += len(bucket)
            if (n - i) > max(live, 8):
                self._state_diff_locked()
                return
            # Conflate the backlog to NET transitions per object, judged
            # against what this watch has already delivered (_known).
            # Plain newest-per-key would be lossy for edge-triggered
            # consumers: a delete+recreate under the same key would drop
            # the DELETED (PodController would never dealloc), and a
            # create+modify would drop the ADDED (the pod would never be
            # enqueued).  Net semantics instead:
            #   unknown -> newest non-DELETED   = ADDED (type coerced)
            #   known   -> newest MODIFIED      = MODIFIED
            #   known   -> deleted + recreated  = DELETED then ADDED
            #   known   -> newest DELETED       = DELETED
            #   unknown -> created + deleted    = nothing (net no-op)
            newest: Dict[tuple, int] = {}
            had_delete: set = set()
            for j in range(i, n):
                rec = ring[j]
                if self.kinds and rec.kind not in self.kinds:
                    continue
                md = rec.obj.metadata
                k = (rec.kind, md.namespace, md.name)
                newest[k] = j
                if rec.etype == DELETED:
                    had_delete.add(k)
            for j in sorted(newest.values()):
                rec = ring[j]
                md = rec.obj.metadata
                k = (rec.kind, md.namespace, md.name)
                kk = (rec.kind, rec.obj.key())
                known = kk in self._known
                if rec.etype == DELETED:
                    if known:
                        self._note(DELETED, rec.obj)
                        self._out.append(Event(DELETED, rec.obj, rec.rv))
                    continue
                if known and k in had_delete:
                    old = self._known[kk]
                    self._note(DELETED, old)
                    self._out.append(Event(DELETED, old, rec.rv))
                    self._note(ADDED, rec.obj)
                    self._out.append(Event(ADDED, rec.obj, rec.rv))
                    continue
                etype = MODIFIED if known else ADDED
                self._note(etype, rec.obj)
                self._out.append(Event(etype, rec.obj, rec.rv))
            self._pos = base + n
            return
        end = min(n, i + _WATCH_FILL_BATCH)
        while i < end:
            rec = ring[i]
            i += 1
            if self.kinds and rec.kind not in self.kinds:
                continue
            self._note(rec.etype, rec.obj)
            self._out.append(Event(rec.etype, rec.obj, rec.rv))
        self._pos = base + i

    def _state_diff_locked(self) -> None:
        """Net-transition delivery by diffing current store state against
        what this watch has delivered (_known).  Because every snapshot
        is shared and frozen, ``old is not obj`` IS the modification
        test, and a uid change under one key is a delete+recreate.
        Cursor jumps to the ring head — the backlog is subsumed."""
        store = self._store
        self._pos = store._ring_base + len(store._ring)
        current: Dict[tuple, Resource] = {}
        for kind, bucket in store._objects.items():
            if self.kinds and kind not in self.kinds:
                continue
            for obj in bucket.values():
                current[(kind, obj.key())] = obj
        for k, old in list(self._known.items()):
            if k not in current:
                del self._known[k]
                self._out.append(Event(DELETED, old,
                                       old.metadata.resource_version))
        for k, obj in current.items():
            old = self._known.get(k)
            if old is obj:
                continue                      # unchanged: same snapshot
            rv = obj.metadata.resource_version
            if old is None:
                self._known[k] = obj
                self._out.append(Event(ADDED, obj, rv))
            elif old.metadata.uid and obj.metadata.uid and \
                    old.metadata.uid != obj.metadata.uid:
                self._known[k] = obj          # deleted + recreated
                self._out.append(Event(DELETED, old, rv))
                self._out.append(Event(ADDED, obj, rv))
            else:
                self._known[k] = obj
                self._out.append(Event(MODIFIED, obj, rv))

    def _resync_locked(self) -> None:
        """Fell off the bounded ring: informer-style re-list.  Synthetic
        DELETED for every object this watch knew that no longer exists,
        then the current state as ADDED (duplicate ADDEDs for survivors —
        the same contract replay watches and RemoteWatch resets have)."""
        store = self._store
        self._pos = store._ring_base + len(store._ring)
        self.resyncs += 1
        current: Dict[tuple, Resource] = {}
        for kind, bucket in store._objects.items():
            if self.kinds and kind not in self.kinds:
                continue
            for obj in bucket.values():
                current[(kind, obj.key())] = obj
        for k, obj in list(self._known.items()):
            if k not in current:
                del self._known[k]
                self._out.append(Event(DELETED, obj))
        for k, obj in current.items():
            self._known[k] = obj
            self._out.append(Event(ADDED, obj))


def mutate(store, cls: Type["Resource"], name: str, mutate_fn,
           namespace: str = "", attempts: int = 5) -> Optional["Resource"]:
    """Optimistic-concurrency read-modify-write against any store
    (ObjectStore or RemoteStore — same interface).

    Re-reads the object fresh, thaws it into a private mutable copy,
    applies ``mutate_fn(obj)``, and writes it back with
    ``check_version=True``; on :class:`ConflictError` the competing
    write wins the version and the loop re-reads and re-applies —
    nothing is ever clobbered (the PR-2 lost-update fix, as a reusable
    primitive instead of a per-controller pattern).

    Returns the updated object; ``None`` when the object does not exist
    (deleted concurrently — callers treat that as "nothing to patch").
    ``mutate_fn`` may return ``False`` to abort without writing (e.g. a
    phase transition whose precondition no longer holds).  After
    ``attempts`` straight conflicts the ConflictError propagates: that
    many lost races means a fight the caller must know about.
    """
    last: Optional[ConflictError] = None
    for _ in range(attempts):
        obj = store.try_get(cls, name, namespace)
        if obj is None:
            return None
        obj = obj.thaw()     # store reads are frozen shared snapshots
        if mutate_fn(obj) is False:
            return obj
        try:
            return store.update(obj, check_version=True)
        except ConflictError as e:
            last = e
    raise last if last is not None else ConflictError(
        f"{cls.KIND} {name}: mutate() made no attempt")


class ObjectStore:
    def __init__(self, persist_dir: Optional[str] = None):
        self._lock = threading.RLock()
        # _cond wraps the SAME underlying lock: holding either guards
        # the fields below (tpflint's guarded-by syntax lists both)
        self._cond = threading.Condition(self._lock)
        # guarded by: _lock, _cond
        self._objects: Dict[str, Dict[str, Resource]] = {}   # kind -> key -> frozen obj
        # guarded by: _lock, _cond
        self._watches: List[Watch] = []
        # watches parked with nothing pending: the next write sets each
        # one's wake flag ONCE and clears the set (wake-once fan-out —
        # busy consumers cost the writer nothing)
        # guarded by: _lock, _cond
        self._parked: set = set()
        # guarded by: _lock, _cond
        self._rv = 0
        # Shared event ring (one immutable _EventRecord per write): the
        # single fan-out backbone for in-process watch cursors, remote
        # long-poll windows (lazy to_dict per event) and the gateway's
        # serialize-once fragments.  A plain list + base sequence so
        # cursors index in O(1); trimmed in _RING_TRIM chunks.
        # guarded by: _lock, _cond
        self._ring: List[_EventRecord] = []
        # guarded by: _lock, _cond
        self._ring_base = 0
        # synchronous cache listeners (StoreCache): events queue under
        # the lock and drain OUTSIDE it, in order, via a combiner
        # guarded by: _lock, _cond
        self._listeners: List[Callable[[Event], None]] = []
        # guarded by: _lock, _cond
        self._listener_pending: "collections.deque[Event]" = \
            collections.deque()
        # guarded by: _lock, _cond
        self._listener_draining = False
        self._persist_dir = persist_dir
        # journal group-commit state.  pending entries are buffered under
        # _lock and flushed in batches by whichever writer crosses
        # JOURNAL_GROUP_LINES (outside _lock) or by the background
        # flusher at JOURNAL_GROUP_LATENCY_S.  _journal_drain_lock
        # serializes flushers (ordering); _journals/_journal_lines are
        # only touched while holding it.
        # guarded by: _lock, _cond
        self._journal_pending: Dict[str, list] = {}   # kind -> [(op, obj)]
        # guarded by: _lock, _cond
        self._journal_hot = False
        # guarded by: _lock, _cond
        self._journal_dirty = False
        self._journal_last_flush = 0.0
        self._journal_drain_lock = threading.Lock()
        # kind -> open append handle / journal line count
        # (flusher-only; serialized by _journal_drain_lock)
        self._journals: Dict[str, object] = {}
        self._journal_lines: Dict[str, int] = {}
        self._journal_stop = threading.Event()
        self._journal_thread: Optional[threading.Thread] = None
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)

    # -- internal ---------------------------------------------------------

    def _bucket(self, kind: str) -> Dict[str, Resource]:  # tpflint: holds=_lock
        return self._objects.setdefault(kind, {})

    # tpflint: holds=_lock
    def _emit(self, etype: str, obj: Resource, rv: Optional[int] = None
              ) -> None:
        """Append ONE immutable event record; all fan-out (in-process
        cursors, cache listeners, remote windows) shares it.  O(1) —
        no per-watcher copies, no eager serialization."""
        rv = self._rv if rv is None else rv
        self._ring.append(_EventRecord(rv, etype, obj))
        if len(self._ring) >= EVENT_LOG_SIZE + _RING_TRIM:
            drop = len(self._ring) - EVENT_LOG_SIZE
            del self._ring[:drop]
            self._ring_base += drop
        if self._listeners:
            self._listener_pending.append(Event(etype, obj, rv))
        if self._parked:
            for w in self._parked:
                w._wake.set()
            self._parked.clear()
        # remote long-poll windows (events_since) still wait on the
        # shared condition; with in-process watches parked on their own
        # flags this is a no-op herd-wise unless windows are waiting
        self._cond.notify_all()

    def _remove_watch(self, w: Watch) -> None:
        with self._lock:
            if w in self._watches:
                self._watches.remove(w)

    def _post_write(self) -> None:
        """Write-path side effects that must not run under _lock:
        ordered cache-listener delivery and journal group-commit."""
        with self._lock:
            notify = bool(self._listener_pending) or self._listener_draining
            # an isolated write flushes immediately (durable before the
            # caller returns, like the old per-write flush); writes
            # inside a burst batch until JOURNAL_GROUP_LINES or the
            # next latency tick — that's the group commit
            flush = self._journal_hot or (
                self._journal_dirty
                and _monotonic() - self._journal_last_flush
                >= JOURNAL_GROUP_LATENCY_S)
            if flush:
                self._journal_hot = False
        if notify:
            self._drain_listeners()
        if flush:
            self._flush_journal()

    def _drain_listeners(self) -> None:
        """Combiner: exactly one thread delivers pending listener events
        at a time, in order, outside _lock.  A writer that finds another
        thread draining returns immediately — the active drainer loops
        until the queue is empty, so no event is stranded."""
        while True:
            with self._lock:
                if self._listener_draining or not self._listener_pending:
                    return
                self._listener_draining = True
                batch = list(self._listener_pending)
                self._listener_pending.clear()
                listeners = list(self._listeners)
            try:
                for ev in batch:
                    for fn in listeners:
                        try:
                            fn(ev)
                        except Exception:  # noqa: BLE001 - a cache bug
                            # must not poison the write path
                            log.exception("store listener failed")
            finally:
                with self._lock:
                    self._listener_draining = False

    def snapshot_objects(self) -> List[Resource]:
        """Atomic snapshot of every current object (frozen shared
        copies, zero per-object cost) — the ShardedStore router's
        failover diff and listener priming read through this."""
        with self._lock:
            return [obj for bucket in self._objects.values()
                    for obj in bucket.values()]

    def attach_listener(self, fn: Callable[[Event], None]
                        ) -> List[Resource]:
        """Register a synchronous event listener and return an atomic
        snapshot of all current objects (frozen).  The listener sees
        every event after the snapshot cut, in order, delivered in
        writer threads outside the store lock (StoreCache's feed)."""
        with self._lock:
            snap = [obj for bucket in self._objects.values()
                    for obj in bucket.values()]
            self._listeners.append(fn)
            return snap

    def detach_listener(self, fn: Callable[[Event], None]) -> None:
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    @staticmethod
    def _content_equal(a: Resource, b: Resource) -> bool:
        da, db = a.to_dict(), b.to_dict()
        for d in (da, db):
            meta = d.get("metadata", {})
            meta.pop("resource_version", None)
            meta.pop("generation", None)
        return da == db

    def _stored_copy(self, obj: Resource, rv: int, generation: int
                     ) -> Resource:
        """Stamp version metadata and build the single frozen snapshot
        this write shares with every reader."""
        if is_frozen(obj):
            # rare: a snapshot passed straight back (mutate() thaws, so
            # this is a caller skipping the discipline with identical
            # content) — thaw to stamp, then freeze
            obj = obj.thaw()
        obj.metadata.resource_version = rv
        obj.metadata.generation = generation
        return freeze_copy(obj)

    #: compaction threshold: journal may grow to this many times the live
    #: object count (floor of JOURNAL_MIN lines) before being rewritten
    JOURNAL_SLACK = 4
    JOURNAL_MIN = 1024

    def _journal_path(self, kind: str) -> str:
        return os.path.join(self._persist_dir, f"{kind}.jsonl")

    # tpflint: holds=_lock
    def _persist(self, kind: str, op: str = "put",
                 obj: Optional[Resource] = None) -> None:
        """Buffer one journal entry (group commit: encode + IO happen in
        _flush_journal, off the critical section)."""
        if not self._persist_dir:
            return
        pend = self._journal_pending.get(kind)
        if pend is None:
            pend = self._journal_pending[kind] = []
        pend.append((op, obj))
        self._journal_dirty = True
        if len(pend) >= JOURNAL_GROUP_LINES:
            self._journal_hot = True
        if self._journal_thread is None:
            t = threading.Thread(target=self._journal_loop,
                                 name="tpf-store-journal", daemon=True)
            self._journal_thread = t
            t.start()

    def _journal_loop(self) -> None:
        while not self._journal_stop.wait(JOURNAL_GROUP_LATENCY_S):
            try:
                self._flush_journal()
            except Exception:  # noqa: BLE001 - keep flushing
                log.exception("journal flush failed")

    def _journal_handle(self, kind: str):
        """Open (resuming) journal handle + line count.  Flusher-only."""
        f = self._journals.get(kind)
        if f is None:
            path = self._journal_path(kind)
            f = open(path, "a")
            self._journals[kind] = f
            if self._journal_lines.get(kind, 0) == 0 and f.tell() > 0:
                with open(path) as rf:
                    self._journal_lines[kind] = sum(1 for _ in rf)
        return f

    def flush_journal(self) -> None:
        """Flush all buffered journal entries now (tests / shutdown)."""
        self._flush_journal()

    def _flush_journal(self) -> None:
        if not self._persist_dir:
            return
        self._journal_last_flush = _monotonic()
        with self._journal_drain_lock:
            while True:
                with self._lock:
                    kinds = [k for k, v in self._journal_pending.items()
                             if v]
                    if not kinds:
                        self._journal_dirty = False
                        return
                for kind in kinds:
                    self._flush_kind(kind)

    def _flush_kind(self, kind: str) -> None:
        """Group-commit one kind's pending entries (caller holds
        _journal_drain_lock).  Compaction folds the batch into a fresh
        snapshot instead of appending it."""
        f = self._journal_handle(kind)
        lines = self._journal_lines.get(kind, 0)
        # drain + compact decision under ONE lock acquisition: entries
        # appended after this cut are strictly post-snapshot, so replay
        # order can never regress an object
        with self._lock:
            entries = self._journal_pending.get(kind) or []
            if not entries:
                return
            self._journal_pending[kind] = []
            live = self._objects.get(kind, {})
            compact = lines + len(entries) > max(
                self.JOURNAL_SLACK * len(live), self.JOURNAL_MIN)
            snapshot = list(live.values()) if compact else None
        if compact:
            self._compact_write(kind, snapshot)
            return
        buf = []
        for op, obj in entries:
            entry = {"op": op}
            if obj is not None:
                # sparse serde: default-valued fields are omitted and
                # reconstructed by load()'s from_dict — roughly halves
                # encode time + bytes on default-heavy objects
                entry["obj"] = sparse_dict(obj)
            buf.append(json.dumps(entry))
        f.write("\n".join(buf) + "\n")
        f.flush()   # one page-cache write per burst, not per write
        self._journal_lines[kind] = lines + len(entries)

    def _compact_write(self, kind: str, objs: List[Resource]) -> None:
        """Rewrite the kind's journal as a snapshot (caller holds
        _journal_drain_lock; file IO runs outside the store lock —
        the objects are frozen, so serializing them lock-free is safe)."""
        f = self._journals.pop(kind, None)
        if f is not None:
            f.close()
        path = self._journal_path(kind)
        tmp = path + ".tmp"
        with open(tmp, "w") as out:
            for obj in objs:
                out.write(json.dumps({"op": "put",
                                      "obj": sparse_dict(obj)}) + "\n")
        os.replace(tmp, path)
        self._journal_lines[kind] = len(objs)

    def _compact(self, kind: str) -> None:
        """Compact one kind now (load()'s torn-tail repair path)."""
        with self._journal_drain_lock:
            with self._lock:
                self._journal_pending.pop(kind, None)
                snapshot = list(self._objects.get(kind, {}).values())
            self._compact_write(kind, snapshot)

    def close(self) -> None:
        self._journal_stop.set()
        t = self._journal_thread
        if t is not None:
            t.join(timeout=2)
        self._flush_journal()
        with self._journal_drain_lock:
            for f in self._journals.values():
                f.close()
            self._journals.clear()

    # -- CRUD -------------------------------------------------------------

    def create(self, obj: Resource) -> Resource:
        with self._lock:
            bucket = self._bucket(obj.KIND)
            key = obj.key()
            if key in bucket:
                raise AlreadyExistsError(f"{obj.KIND} {key} already exists")
            self._rv += 1
            stored = self._stored_copy(obj, self._rv, 1)
            bucket[key] = stored
            self._emit(ADDED, stored)
            self._persist(obj.KIND, "put", stored)
        self._post_write()
        return stored

    def get(self, cls: Type[Resource], name: str,
            namespace: str = "") -> Resource:
        key = f"{namespace}/{name}" if cls.NAMESPACED else name
        with self._lock:
            bucket = self._bucket(cls.KIND)
            if key not in bucket:
                raise NotFoundError(f"{cls.KIND} {key} not found")
            return bucket[key]

    def try_get(self, cls: Type[Resource], name: str,
                namespace: str = "") -> Optional[Resource]:
        try:
            return self.get(cls, name, namespace)
        except NotFoundError:
            return None

    def update(self, obj: Resource, check_version: bool = False) -> Resource:
        with self._lock:
            bucket = self._bucket(obj.KIND)
            key = obj.key()
            if key not in bucket:
                raise NotFoundError(f"{obj.KIND} {key} not found")
            current = bucket[key]
            if check_version and \
                    obj.metadata.resource_version != current.metadata.resource_version:
                raise ConflictError(
                    f"{obj.KIND} {key}: version {obj.metadata.resource_version}"
                    f" != {current.metadata.resource_version}")
            # No-op updates neither bump the version nor emit MODIFIED —
            # otherwise controllers that update the kinds they watch would
            # feed themselves a self-sustaining event loop.
            if self._content_equal(obj, current):
                return current
            self._rv += 1
            stored = self._stored_copy(obj, self._rv,
                                       current.metadata.generation + 1)
            bucket[key] = stored
            self._emit(MODIFIED, stored)
            self._persist(obj.KIND, "put", stored)
        self._post_write()
        return stored

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
        key = f"{namespace}/{name}" if cls.NAMESPACED else name
        with self._lock:
            bucket = self._bucket(cls.KIND)
            if key not in bucket:
                raise NotFoundError(f"{cls.KIND} {key} not found")
            obj = bucket.pop(key)
            # deletions advance the store version too: a remote watcher's
            # "events since rv" window must include them
            self._rv += 1
            self._emit(DELETED, obj)
            self._persist(cls.KIND, "del", obj)
        self._post_write()

    def list(self, cls: Type[Resource], namespace: Optional[str] = None,
             selector: Optional[Callable[[Resource], bool]] = None
             ) -> List[Resource]:
        """Frozen shared snapshots — zero copies.  Mutating an element
        raises; ``.thaw()`` one for a private mutable copy."""
        with self._lock:
            bucket = self._bucket(cls.KIND)
            if namespace is None and selector is None:
                return list(bucket.values())
            out = []
            for obj in bucket.values():
                if namespace is not None and obj.metadata.namespace != namespace:
                    continue
                if selector is not None and not selector(obj):
                    continue
                out.append(obj)
            return out

    # -- watch ------------------------------------------------------------

    def watch(self, *kinds: str, replay: bool = True,
              conflate: bool = False) -> Watch:
        """Subscribe to events for the given kinds (all kinds if empty).
        With replay=True, current objects are delivered first as ADDED.
        ``conflate=True`` delivers only the newest pending event per
        object (reconcile-style consumers; slow watchers conflate
        automatically past WATCH_CONFLATE_BACKLOG)."""
        with self._lock:
            w = Watch(self, kinds, conflate=conflate)
            w._prime_locked(replay)
            self._watches.append(w)
            return w

    # -- remote watch window (store-gateway backing) ----------------------

    @property
    def current_rv(self) -> int:
        with self._lock:
            return self._rv

    def enable_event_log(self) -> None:
        """Compat no-op: the shared ring now always records events (the
        per-write cost is one O(1) append; serialization is lazy)."""

    def snapshot_events(self, kinds: Iterable[str] = ()
                        ) -> Tuple[int, List[Tuple[str, str, dict]]]:
        """(current_rv, ADDED-event tuples for every current object of the
        given kinds) — the replay a fresh remote watcher starts from."""
        kinds = set(kinds)
        with self._lock:
            out = []
            for kind, bucket in self._objects.items():
                if kinds and kind not in kinds:
                    continue
                for obj in bucket.values():
                    out.append((ADDED, kind, obj.to_dict()))
            return self._rv, out

    def events_since(self, since_rv: int, kinds: Iterable[str] = (),
                     wait_s: float = 0.0, serialized: bool = False,
                     conflate: bool = False
                     ) -> Tuple[int, List, bool]:
        """Events with rv > since_rv for the given kinds, blocking up to
        ``wait_s`` when none are pending (long-poll).  Returns
        (current_rv, events, reset): ``reset`` is True when ``since_rv``
        pre-dates the bounded event ring — the caller must re-list (HTTP
        410 Gone semantics).  Events are ``(etype, kind, rv, obj_dict)``
        tuples, or — with ``serialized=True`` (the gateway's fan-out
        path) — ready JSON fragments cached once per event so N watchers
        don't pay N serializations.

        ``conflate=True`` keeps only the NEWEST event per object in the
        window — correct for reconcile-style consumers (every controller
        and informer here applies latest state per key; none replays
        histories), and it shrinks both the serialization and wire cost
        of a churn burst by the burst factor.  Event types still arrive
        faithfully for the surviving event (a delete is never masked by
        an earlier modify: the delete IS the newest)."""
        kinds = set(kinds)
        import time as _time
        deadline = _time.monotonic() + max(0.0, wait_s)
        with self._cond:
            while True:
                if since_rv > self._rv:
                    # the watcher is ahead of us: this store restarted
                    # with older state — the client must re-list, not be
                    # silently clamped into missing the gap
                    return self._rv, [], True
                ring = self._ring
                # every rv bump is logged, so the window is complete iff
                # it starts at/after the oldest logged event minus one
                oldest = ring[0].rv if ring else self._rv + 1
                if since_rv < oldest - 1:
                    return self._rv, [], True
                # rv-ordered ring: binary-search the window start instead
                # of rescanning history on every wakeup
                lo, hi = 0, len(ring)
                while lo < hi:
                    mid = (lo + hi) // 2
                    if ring[mid].rv <= since_rv:
                        lo = mid + 1
                    else:
                        hi = mid
                matched = []
                # conflation state: key -> True once its newest event is
                # kept; a later (older) DELETED is ALSO kept when the
                # surviving newest is a recreate — dropping it would mask
                # the identity change from delete+recreate under one key
                # (the consumer would never release the old object)
                seen_keys: Optional[dict] = {} if conflate else None
                for idx in range(len(ring) - 1, lo - 1, -1):
                    rec = ring[idx]
                    if kinds and rec.kind not in kinds:
                        continue
                    if seen_keys is not None:
                        # newest-first walk: the first event seen for an
                        # object is its latest; earlier ones conflate
                        # away, EXCEPT one DELETED preceding a recreate
                        md = rec.obj.metadata
                        okey = (rec.kind, md.namespace, md.name)
                        state = seen_keys.get(okey)
                        if state == "done":
                            continue
                        if state is None:
                            seen_keys[okey] = "done" \
                                if rec.etype == DELETED else "want-delete"
                        else:  # "want-delete": newest kept, non-DELETED
                            if rec.etype != DELETED:
                                continue
                            seen_keys[okey] = "done"
                    if serialized:
                        frag = rec.json
                        if frag is None:
                            frag = json.dumps(
                                {"type": rec.etype, "kind": rec.kind,
                                 "rv": rec.rv, "obj": rec.obj_dict()},
                                separators=(",", ":"))
                            rec.json = frag
                        matched.append(frag)
                    else:
                        matched.append((rec.etype, rec.kind, rec.rv,
                                        rec.obj_dict()))
                if matched:
                    matched.reverse()
                    return self._rv, matched, False
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return self._rv, [], False
                self._cond.wait(timeout=min(remaining, 1.0))

    # -- persistence ------------------------------------------------------

    def load(self, kind_classes: Iterable[Type[Resource]]) -> int:
        """Replay persisted journals (restart recovery). Returns the
        number of live objects restored.  Accepts both journal entries
        ({"op": .., "obj": ..}) and bare object lines (pre-journal
        snapshot format)."""
        if not self._persist_dir:
            return 0
        n = 0
        torn_kinds: List[str] = []
        with self._lock:
            for cls in kind_classes:
                path = self._journal_path(cls.KIND)
                if not os.path.exists(path):
                    continue
                bucket = self._bucket(cls.KIND)
                lines = 0
                with open(path) as f:
                    raw_lines = [l.strip() for l in f if l.strip()]
                torn = False
                for i, line in enumerate(raw_lines):
                    try:
                        data = json.loads(line)
                    except json.JSONDecodeError:
                        if i == len(raw_lines) - 1:
                            # a crash mid-append tears only the final
                            # line; dropping it loses at most one entry
                            # (re-derived from annotations) — refusing
                            # to boot would lose everything
                            log.warning(
                                "dropping torn trailing journal line "
                                "in %s", path)
                            torn = True
                            break
                        raise
                    lines += 1
                    if "op" in data:
                        op, data = data["op"], data.get("obj") or {}
                    else:
                        op = "put"
                    data.pop("kind", None)
                    obj = from_dict(cls, data)
                    if op == "del":
                        bucket.pop(obj.key(), None)
                    else:
                        bucket[obj.key()] = freeze_copy(obj)
                    self._rv = max(self._rv,
                                   obj.metadata.resource_version)
                self._journal_lines[cls.KIND] = lines
                if torn:
                    # rewrite the journal without the torn tail: a later
                    # append has no trailing newline to land after and
                    # would otherwise concatenate onto the partial line,
                    # corrupting a then-valid entry (compacted below,
                    # outside _lock — lock order is drain_lock -> _lock)
                    torn_kinds.append(cls.KIND)
                n += len(bucket)
        for kind in torn_kinds:
            self._compact(kind)
        return n
