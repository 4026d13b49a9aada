"""RemoteStore: ObjectStore client API over the store gateway.

The port's copy of ``tensorfusion_tpu/remote_store.py``.

The node-agent half of the networked control plane: where the reference's
hypervisor talks to the Kubernetes apiserver through client-go informers
(``kubernetes_backend.go:302-447``, ``pod_cache.go``), a tpu-fusion
hypervisor on another host builds a :class:`RemoteStore` against the
operator's URL and hands it to ``ControlPlaneBackend`` — which cannot
tell it apart from the in-process store: the same ``create / get /
try_get / update / update_or_create / delete / list / watch`` surface,
the same ``NotFoundError`` / ``ConflictError`` / ``AlreadyExistsError``
exceptions, and the same replay-then-events watch semantics (backed here
by a long-poll thread per watch instead of in-process queues).

Wire-level notes:

- every request retries transient transport errors with backoff — node
  agents must ride out operator restarts/failovers (the informer
  re-list/re-watch behavior);
- a watch that falls behind the gateway's bounded event log receives
  ``reset: true`` and transparently re-replays the current state as
  ADDED events (client-side informers do exactly this on 410 Gone);
- optional shared token goes in ``X-TPF-Token``.
"""

from __future__ import annotations

import http.client
import json
import logging
import queue
import socket
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Iterable, List, Optional, Type

from .clock import default_clock
from .api.meta import Resource, freeze_copy, from_dict
from .gateway import KIND_BY_NAME
from .store import (AlreadyExistsError, ConflictError, DELETED, Event,
                    NotFoundError)

log = logging.getLogger("tpf.remote_store")

#: long-poll wait per watch request (server caps at MAX_WATCH_WAIT_S)
WATCH_POLL_S = 20.0
#: transport-error retry backoff schedule (seconds); the last entry
#: repeats — a dead operator is retried forever at that cadence
RETRY_BACKOFF_S = (0.1, 0.3, 1.0, 3.0)


class RemoteStoreError(Exception):
    """Transport-level failure after retries were exhausted."""


class RemoteWatch:
    """Watch-compatible event stream fed by long-poll thread(s).

    Against a single-store gateway this is exactly the historical
    one-thread window.  Against a SHARDED cell (docs/control-plane-
    scale.md) there is no global rv order — the gateway's shard-less
    first response carries the shard count, and this watch fans out
    into **one long-poll window per shard** (each following its own
    shard's rv sequence, with per-shard reset/re-replay semantics)
    behind this single iterator — the remote analog of
    :class:`~.shardedstore.MergedWatch`.  Cross-shard event order is
    arbitrary, exactly like the in-process merged watch."""

    def __init__(self, store: "RemoteStore", kinds: Iterable[str],
                 replay: bool = True, conflate: bool = False):
        self._store = store
        self.kinds = set(kinds)
        self._conflate = conflate
        self.queue: "queue.Queue[Optional[Event]]" = queue.Queue()
        self._closed = threading.Event()
        self._replay = replay
        #: shard windows discovered (1 until the gateway says otherwise)
        self.shards = 1
        self._threads_lock = threading.Lock()
        self._threads: list = []
        self._spawn(None)

    # Watch interface ------------------------------------------------------

    def stop(self) -> None:
        """End the stream and its poll threads: a poll in flight has its
        socket shut down rather than being left in its long-poll wait."""
        if self._closed.is_set():
            return
        self._closed.set()
        self.queue.put(None)
        with self._threads_lock:
            threads = list(self._threads)
        for t in threads:
            self._store._abort(t.ident)
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout=5)

    def __iter__(self):
        while True:
            ev = self.queue.get()
            if ev is None:
                return
            yield ev

    def get(self, timeout: Optional[float] = None) -> Optional[Event]:
        try:
            return self.queue.get(timeout=timeout)
        except queue.Empty:
            return None

    # polling --------------------------------------------------------------

    def _spawn(self, shard: Optional[int]) -> None:
        name = "tpf-remote-watch" if shard is None \
            else f"tpf-remote-watch-s{shard}"
        t = threading.Thread(target=self._run, args=(shard,),
                             name=name, daemon=True)
        with self._threads_lock:
            self._threads.append(t)
        t.start()

    def _run(self, shard: Optional[int]) -> None:
        try:
            self._loop(shard)
        finally:
            self._store._drop_conn()

    def _loop(self, shard: Optional[int] = None) -> None:
        backoff = 0
        rv = 0
        primed = False
        replay = self._replay
        # kind -> key -> last seen object; lets a reset re-replay emit
        # synthetic DELETED events for objects removed while this watcher
        # was partitioned (the informer re-list diff).  Per WINDOW: each
        # shard diffs only the objects it owns.
        known: dict = {}
        while not self._closed.is_set():
            try:
                query = {"since_rv": str(rv),
                         "kinds": ",".join(sorted(self.kinds)),
                         "replay": "1" if replay else "0",
                         "primed": "1" if primed else "0",
                         "conflate": "1" if self._conflate else "0",
                         "wait_s": str(WATCH_POLL_S)}
                if shard is not None:
                    query["shard"] = str(shard)
                payload = self._store._request(
                    "GET", "/api/v1/store/watch", query=query,
                    # one retry inside _request; sustained failure handled
                    # by this loop's own backoff so stop() stays prompt
                    max_tries=1, cancelled=self._closed.is_set)
                backoff = 0
            except Exception:  # noqa: BLE001 - ANY poll failure (auth
                # rotation, proxy garbage, transport) must keep the watch
                # thread alive and retrying, or consumers hang silently
                if self._closed.is_set():
                    return          # stop() shut the poll's socket
                log.exception("watch poll failed; retrying")
                delay = RETRY_BACKOFF_S[min(backoff,
                                            len(RETRY_BACKOFF_S) - 1)]
                backoff += 1
                self._closed.wait(delay)
                continue
            if self._closed.is_set():
                return
            n_shards = int(payload.get("shards", 1) or 1)
            if shard is None and n_shards > 1:
                # sharded cell: the shard-less first response is window
                # discovery (no events) — fan out one long-poll window
                # per shard and continue THIS loop as shard 0's
                self.shards = n_shards
                for i in range(1, n_shards):
                    self._spawn(i)
                shard = 0
                continue
            if payload.get("reset"):
                # fell behind the bounded event log: re-replay current
                # state (informer 410-Gone re-list).  Consumers see
                # duplicate ADDEDs for objects they already know — the
                # same contract in-process replay watches have — plus
                # synthetic DELETEDs for objects that vanished meanwhile
                # (diffed against this window's ``known`` below).
                rv = 0
                replay = True
                primed = False
                continue
            is_replay = not primed and replay
            decoded = []
            for ev in payload.get("events", []):
                cls = KIND_BY_NAME.get(ev.get("kind", ""))
                if cls is None:
                    continue
                data = dict(ev["obj"])
                data.pop("kind", None)
                # frozen like in-process watch events: every consumer
                # sees the same immutable-snapshot contract either way
                decoded.append((ev["type"],
                                freeze_copy(from_dict(cls, data))))
            if is_replay:
                snapshot_keys = {(o.KIND, o.key()) for _, o in decoded}
                for kind, bucket in known.items():
                    for key, obj in list(bucket.items()):
                        if (kind, key) not in snapshot_keys:
                            del bucket[key]
                            self.queue.put(Event(DELETED, obj))
            for etype, obj in decoded:
                bucket = known.setdefault(obj.KIND, {})
                if etype == DELETED:
                    bucket.pop(obj.key(), None)
                else:
                    bucket[obj.key()] = obj
                self.queue.put(Event(etype, obj))
            rv = int(payload.get("rv", rv))
            primed = True


class RemoteStore:
    def __init__(self, base_url: str, token: str = "",
                 timeout_s: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout_s = timeout_s
        #: TLS context for https:// stores — trust anchors from
        #: TPF_TLS_CA (the statestore's self-signed cert works as its
        #: own anchor); None for plain http
        self._ssl_ctx = None
        if self.base_url.startswith("https://"):
            from .utils.tlsutil import client_context

            self._ssl_ctx = client_context()
        parsed = urllib.parse.urlsplit(self.base_url)
        self._host = parsed.hostname or "127.0.0.1"
        self._port = parsed.port or (443 if parsed.scheme == "https"
                                     else 80)
        self._https = parsed.scheme == "https"
        #: per-thread persistent connection (HTTP/1.1 keep-alive): the
        #: informer, controllers, and metrics pusher each hold one open
        #: socket instead of a TCP(+TLS) handshake per request
        self._tlocal = threading.local()
        #: the same connections by thread id, so that a watch's stop() and
        #: close() can shut them down from another thread
        self._conns: dict = {}

    def _conn(self):
        c = getattr(self._tlocal, "conn", None)
        if c is None:
            if self._https:
                c = http.client.HTTPSConnection(
                    self._host, self._port, timeout=self.timeout_s,
                    context=self._ssl_ctx)
            else:
                c = http.client.HTTPConnection(
                    self._host, self._port, timeout=self.timeout_s)
            self._tlocal.conn = c
            self._conns[threading.get_ident()] = c
        return c

    def _drop_conn(self):
        c = getattr(self._tlocal, "conn", None)
        if c is not None:
            self._tlocal.conn = None
            self._conns.pop(threading.get_ident(), None)
            try:
                c.close()
            except OSError:
                pass

    def _abort(self, ident) -> None:
        """Shut down the socket of thread ``ident``'s connection: a
        request in flight on it fails at once."""
        c = self._conns.get(ident)
        sock = getattr(c, "sock", None)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def close(self) -> None:
        """Shut down every thread's connection (watches have their own
        ``stop``); a later request dials afresh."""
        for ident in list(self._conns):
            self._abort(ident)

    # -- transport ---------------------------------------------------------

    def _request(self, method: str, path: str, query: Optional[dict] = None,
                 body: Optional[dict] = None, max_tries: int = 0,
                 cancelled: Optional[Callable[[], bool]] = None) -> dict:
        """One request, retried on transport errors ``max_tries`` times
        (and redialled once where a reused connection died unread);
        ``cancelled()`` true stops both (a watch being stopped)."""
        target = path
        if query:
            target += "?" + urllib.parse.urlencode(query)
        url = self.base_url + target
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["X-TPF-Token"] = self.token
        tries = 0
        free_redial = True
        while True:
            api_err = None
            reused = getattr(self._tlocal, "conn", None) is not None
            try:
                c = self._conn()
                c.request(method, target, body=data, headers=headers)
                r = c.getresponse()
                raw = r.read()
                if r.will_close:
                    self._drop_conn()
                if 300 <= r.status < 400:
                    # http.client follows no redirects; silently treating
                    # a 307 (follower leader-redirect) as success would
                    # hand the caller an empty dict
                    raise RemoteStoreError(
                        f"{method} {url}: unexpected redirect "
                        f"{r.status} to {r.getheader('Location')}")
                if r.status >= 400:
                    payload = {}
                    try:
                        payload = json.loads(raw or b"{}")
                    except ValueError:
                        pass    # non-JSON error body: keep the status
                    api_err = (r.status, payload)
                else:
                    return json.loads(raw or b"{}")
            except (http.client.HTTPException, OSError,
                    TimeoutError) as e:
                # a dead keep-alive socket (server restart, idle close)
                # is routine: drop it so the retry dials fresh
                self._drop_conn()
                # one FREE redial when a REUSED connection died before
                # returning anything: the server never processed the
                # request, so even no-retry callers (create,
                # push_metrics — no-double-delivery invariant) can
                # safely redial once instead of failing spuriously
                if cancelled is not None and cancelled():
                    raise RemoteStoreError(f"{method} {url}: cancelled") from e
                if free_redial and reused and isinstance(
                        e, (http.client.RemoteDisconnected,
                            ConnectionResetError, BrokenPipeError)):
                    free_redial = False
                    continue
                # a certificate mismatch never heals by retrying — fail
                # fast instead of burning the whole backoff schedule
                cause = getattr(e, "reason", e)
                if isinstance(cause, ssl.SSLCertVerificationError) or \
                        isinstance(e, ssl.SSLCertVerificationError):
                    raise RemoteStoreError(
                        f"{method} {url}: TLS verification failed "
                        f"(set TPF_TLS_CA to the server cert): "
                        f"{cause}") from e
                if tries >= max_tries:
                    raise RemoteStoreError(
                        f"{method} {url}: {e}") from e
                delay = RETRY_BACKOFF_S[min(tries,
                                            len(RETRY_BACKOFF_S) - 1)]
                tries += 1
                default_clock().sleep(delay)
                continue
            # raised OUTSIDE the try: several API errors are OSError
            # subclasses (PermissionError) and must not hit the
            # transport-retry clause
            self._raise_api_error(*api_err)

    @staticmethod
    def _raise_api_error(code: int, payload: dict):
        msg = payload.get("error", f"HTTP {code}")
        if code == 404:
            raise NotFoundError(msg)
        if code == 409:
            if payload.get("reason") == "exists":
                raise AlreadyExistsError(msg)
            raise ConflictError(msg)
        if code == 401:
            raise PermissionError(msg)
        raise RemoteStoreError(msg)

    @staticmethod
    def _decode(data: dict) -> Resource:
        kind = data.get("kind", "")
        cls = KIND_BY_NAME.get(kind)
        if cls is None:
            raise ValueError(f"unknown kind {kind!r} from gateway")
        d = dict(data)
        d.pop("kind", None)
        # frozen for contract parity with ObjectStore: reads hand out
        # immutable snapshots; writers thaw (docs/control-plane-scale.md)
        return freeze_copy(from_dict(cls, d))

    # -- ObjectStore surface ----------------------------------------------

    def create(self, obj: Resource) -> Resource:
        # no transport retry: create is not idempotent — a retried create
        # whose first attempt actually landed would surface a spurious
        # AlreadyExistsError to the caller that in fact succeeded (the
        # leader elector's acquire path turns exactly that into a stuck
        # lease).  Callers that can re-check state retry themselves.
        out = self._request("POST", "/api/v1/store/objects",
                            body={"obj": obj.to_dict()})
        return self._decode(out["obj"])

    def get(self, cls: Type[Resource], name: str,
            namespace: str = "") -> Resource:
        out = self._request("GET", "/api/v1/store/objects",
                            query={"kind": cls.KIND, "name": name,
                                   "namespace": namespace}, max_tries=3)
        return self._decode(out["obj"])

    def try_get(self, cls: Type[Resource], name: str,
                namespace: str = "") -> Optional[Resource]:
        try:
            return self.get(cls, name, namespace)
        except NotFoundError:
            return None

    def update(self, obj: Resource, check_version: bool = False) -> Resource:
        out = self._request("PUT", "/api/v1/store/objects",
                            body={"obj": obj.to_dict(),
                                  "check_version": check_version},
                            max_tries=3)
        return self._decode(out["obj"])

    def update_or_create(self, obj: Resource) -> Resource:
        out = self._request("PUT", "/api/v1/store/objects",
                            body={"obj": obj.to_dict(), "upsert": True},
                            max_tries=3)
        return self._decode(out["obj"])

    def delete(self, cls: Type[Resource], name: str,
               namespace: str = "") -> None:
        self._request("DELETE", "/api/v1/store/objects",
                      query={"kind": cls.KIND, "name": name,
                             "namespace": namespace}, max_tries=3)

    def list(self, cls: Type[Resource], namespace: Optional[str] = None,
             selector: Optional[Callable[[Resource], bool]] = None
             ) -> List[Resource]:
        query = {"kind": cls.KIND}
        if namespace is not None:
            query["namespace"] = namespace
        out = self._request("GET", "/api/v1/store/list", query=query,
                            max_tries=3)
        items = [self._decode(d) for d in out.get("items", [])]
        if selector is not None:
            items = [o for o in items if selector(o)]
        return items

    def watch(self, *kinds: str, replay: bool = True,
              conflate: bool = False) -> RemoteWatch:
        """``conflate=True`` asks the gateway for only the newest event
        per object per poll — safe for reconcile-style consumers (all of
        tpu-fusion's controllers/backends), and it cuts wire+serialize
        cost by the churn factor under bursts."""
        return RemoteWatch(self, kinds, replay=replay, conflate=conflate)

    # -- metrics shipping --------------------------------------------------

    def push_metrics(self, lines: List[str]) -> int:
        """Ship influx-line metrics to the store gateway's ring (the
        hypervisor→TSDB network path; vector-sidecar analog).  Returns
        the gateway's latest sequence number.

        No transport retry (max_tries=0): a timeout whose POST actually
        landed would double-deliver the same lines and skew count/sum
        aggregates — the recorder's backlog is the retry mechanism."""
        out = self._request("POST", "/api/v1/store/metrics",
                            body={"lines": list(lines)})
        return int(out.get("seq", 0))

    def drain_metrics(self, since_seq: int = 0,
                      wait_s: float = 0.0, epoch: str = ""):
        """Drain metrics lines pushed by remote hypervisors (the leader
        operator's feed).  Returns (latest_seq, lines, dropped, epoch):
        dropped counts lines that aged out of the gateway's ring before
        this drainer saw them (lossy by design, but observable); the
        epoch changes when the store restarts — sequence numbers are
        only comparable within one epoch, so the caller must reset its
        cursor to 0 on an epoch change.  Passing the cursor's ``epoch``
        lets the gateway detect the mismatch server-side and return the
        new epoch's lines immediately instead of long-polling a stale
        (possibly higher-than-current) sequence number."""
        query = {"since_seq": str(since_seq), "wait_s": str(wait_s)}
        if epoch:
            query["epoch"] = epoch
        out = self._request("GET", "/api/v1/store/metrics",
                            query=query, max_tries=1)
        return (int(out.get("seq", since_seq)), out.get("lines", []),
                int(out.get("dropped", 0)), str(out.get("epoch", "")))

    # -- liveness ----------------------------------------------------------

    def ping(self, timeout_s: float = 5.0) -> bool:
        try:
            with urllib.request.urlopen(self.base_url + "/healthz",
                                        timeout=timeout_s,
                                        context=self._ssl_ctx) as r:
                return r.status == 200
        except Exception:  # noqa: BLE001
            log.debug("healthz ping to %s failed", self.base_url,
                      exc_info=True)
            return False
