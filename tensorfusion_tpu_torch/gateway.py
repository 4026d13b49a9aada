"""Store gateway: the control plane's state API over HTTP.

The port's copy of ``tensorfusion_tpu/gateway.py``.

The reference platform is inherently distributed because every component
talks to the Kubernetes apiserver: node hypervisors register devices and
watch pods through it (``pkg/hypervisor/backend/kubernetes/
kubernetes_backend.go:302-447``, ``pod_cache.go``), and operator replicas
elect a leader through it (``cmd/main.go:785-812``).  tpu-fusion is
self-hosted, so this module plays the apiserver's role: it exposes the
in-process :class:`~tensorfusion_tpu_torch.store.ObjectStore` as REST +
long-poll-watch endpoints that remote hypervisors (and standby operators)
consume via :class:`~tensorfusion_tpu_torch.remote_store.RemoteStore`.

Endpoints (mounted under the operator API, or standalone):

- ``GET    /api/v1/store/objects?kind=&name=&namespace=``   one object
- ``GET    /api/v1/store/list?kind=[&namespace=]``          list a kind
- ``POST   /api/v1/store/objects``  body ``{"obj": {...}}`` create (409 on
  exists)
- ``PUT    /api/v1/store/objects``  body ``{"obj": {...},
  "check_version": bool, "upsert": bool}``  update / update-or-create
  (404 missing, 409 version conflict)
- ``DELETE /api/v1/store/objects?kind=&name=&namespace=``   delete
- ``GET    /api/v1/store/watch?since_rv=N[&kinds=a,b][&wait_s=S]``
  long-poll event window.  ``since_rv=0`` replays the current state as
  ADDED events; a client behind the bounded event log gets
  ``{"reset": true}`` (410-Gone semantics) and must re-list.
- ``POST   /api/v1/store/metrics`` body ``{"lines": [...]}`` — influx-line
  metrics ingestion from node hypervisors (the role the vector sidecar →
  GreptimeDB pipeline plays in the reference,
  ``internal/utils/compose.go:1224``, ``cmd/main.go:751-767``).  Lines
  land in a bounded ring AND in the host process's sink (the operator's
  TSDB) when one is attached.
- ``GET    /api/v1/store/metrics?since_seq=N[&wait_s=S]`` — long-poll
  drain of that ring.  The leader operator running against a standalone
  state store drains from here to feed its TSDB (so the autoscaler and
  alert evaluator see remote ``tpf_worker`` series without shared
  volumes).  Metrics are lossy-tolerant: a drainer that falls behind the
  ring gets ``dropped > 0`` and simply continues from the oldest line.

Auth: optional tokens (``X-TPF-Token`` header, constant-time compare) —
chip inventory and pod placement are cluster control state, so
cross-host deployments should set them.  Two modes:

- single shared ``token``: full access (back-compat / small clusters);
- per-role ``tokens`` dict (the RBAC split the reference gets from
  Kubernetes service accounts): ``admin`` (operators: everything),
  ``node`` (hypervisors: read/watch anything, write only node-scoped
  kinds — Node/TPUNode/TPUChip/Pod/Lease — and push metrics), and
  ``client`` (workload clients: read/watch only).  A client token can
  therefore never write chips; wrong method for a role is 403, missing
  or unknown token is 401.
"""

from __future__ import annotations

import hmac
import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Type

from .api.meta import Resource, from_dict
from .api.types import ALL_KINDS
from .store import (AlreadyExistsError, ConflictError, NotFoundError,
                    ObjectStore)

log = logging.getLogger("tpf.gateway")

KIND_BY_NAME: Dict[str, Type[Resource]] = {c.KIND: c for c in ALL_KINDS}

#: cap on one long-poll wait; clients re-issue (keeps worker threads from
#: pinning forever on dead connections)
MAX_WATCH_WAIT_S = 30.0


class RawJson(str):
    """A payload that is ALREADY serialized JSON: HTTP hosts must send it
    verbatim instead of json.dumps-ing it again.  Carries the watch
    fan-out's serialize-once optimization through to the wire."""

#: kinds a ``node``-role token may write: what a hypervisor legitimately
#: registers/updates about its own host (everything else is operator
#: state — quotas, pools, workloads — and needs ``admin``)
NODE_WRITABLE_KINDS = {"Node", "TPUNode", "TPUChip", "Pod", "Lease"}

#: lease names a ``node`` token may NOT touch: the HA leader-election
#: lease is control-plane state — a node token must not be able to
#: steal/expire the operator leadership (control-plane DoS)
PROTECTED_LEASES = {"operator-leader"}


class MetricsBuffer:
    """Bounded ring of influx lines with monotone sequence numbers.

    The store-side buffer between hypervisor pushes and the leader
    operator's drain.  Unlike the object event log, metrics loss is
    acceptable — a slow drainer is told how many lines aged out
    (``dropped``) and continues from the oldest retained line rather
    than resetting.
    """

    def __init__(self, maxlen: int = 65536):
        self._cond = threading.Condition()
        self._lines: deque = deque(maxlen=maxlen)   # (seq, line)
        self._seq = 0
        #: identifies this buffer instance: sequence numbers are only
        #: comparable within one epoch — a drainer that sees the epoch
        #: change (store restart) must restart from seq 0 or it silently
        #: skips the new epoch's lines
        import uuid
        self.epoch = uuid.uuid4().hex[:12]

    def push(self, lines: List[str]) -> int:
        """Append lines; returns the latest sequence number."""
        with self._cond:
            for line in lines:
                if not line:
                    continue
                self._seq += 1
                self._lines.append((self._seq, line))
            self._cond.notify_all()
            return self._seq

    def since(self, since_seq: int, wait_s: float = 0.0,
              epoch: Optional[str] = None):
        """Lines with seq > since_seq; blocks up to wait_s for news.

        Returns (latest_seq, lines, dropped) where dropped counts lines
        that aged out of the ring before this drainer saw them.

        ``epoch`` is the epoch the caller's cursor came from; when it
        names a different buffer instance (store restart) the cursor is
        meaningless here, so the drain restarts from seq 0 immediately
        instead of blocking out the long-poll on a stale (possibly
        higher-than-current) sequence number.
        """
        if epoch is not None and epoch != self.epoch:
            since_seq = 0
        deadline = time.monotonic() + wait_s
        with self._cond:
            while self._seq <= since_seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self._seq, [], 0
                self._cond.wait(remaining)
            oldest = self._lines[0][0] if self._lines else self._seq + 1
            dropped = max(0, oldest - since_seq - 1)
            lines = [line for seq, line in self._lines if seq > since_seq]
            return self._seq, lines, dropped


class StoreGateway:
    """HTTP-facing façade over an ObjectStore.

    Framework-neutral: the host server (OperatorServer, or the follower
    redirector) calls :meth:`handle` with the parsed request pieces and
    sends whatever (code, payload) comes back.
    """

    def __init__(self, store: ObjectStore, token: str = "",
                 metrics_sink: Optional[Callable[[List[str]], None]] = None,
                 tokens: Optional[Dict[str, str]] = None):
        self.store = store
        self.token = token
        #: role -> token ("admin" | "node" | "client"); the shared
        #: ``token`` doubles as the admin token when both are given
        self.tokens: Dict[str, str] = {
            role: t for role, t in (tokens or {}).items() if t}
        #: hypervisor-pushed influx lines; drained by the leader operator
        self.metrics = MetricsBuffer()
        #: optional same-process consumer (the operator's TSDB) — called
        #: on every push so a single-process deployment needs no drain
        self.metrics_sink = metrics_sink
        # event logging stays off until a watcher actually appears
        # (snapshot_events/events_since self-enable) — single-process
        # deployments with no remote watchers never pay the per-write
        # to_dict + ring append

    # -- helpers -----------------------------------------------------------

    def role_of(self, headers) -> Optional[str]:
        """The role the offered token grants: 'admin'/'node'/'client',
        'admin' when auth is off entirely, None when unauthorized."""
        if not self.token and not self.tokens:
            return "admin"
        offered = headers.get("X-TPF-Token", "")
        if self.token and hmac.compare_digest(offered, self.token):
            return "admin"
        for role in ("admin", "node", "client"):   # fixed probe order
            t = self.tokens.get(role, "")
            if t and hmac.compare_digest(offered, t):
                return role
        return None

    @staticmethod
    def _allowed(role: str, method: str, sub: str,
                 qs: Dict[str, list], body: dict) -> bool:
        """Role/route policy (see module docstring)."""
        if role == "admin":
            return True
        if sub in ("objects", "list", "watch") and method == "GET":
            return True
        if sub == "metrics":
            # push is a node-agent duty; the drain feeds the leader
            # operator's TSDB (admin)
            return method == "POST" and role == "node"
        if role == "node" and sub == "objects":
            if method in ("POST", "PUT"):
                obj = body.get("obj") or {}
                kind = obj.get("kind", "")
                name = (obj.get("metadata") or {}).get("name", "")
            elif method == "DELETE":
                kind = qs.get("kind", [""])[0]
                name = qs.get("name", [""])[0]
            else:
                return False
            if kind == "Lease" and name in PROTECTED_LEASES:
                return False
            return kind in NODE_WRITABLE_KINDS
        return False

    @staticmethod
    def _cls(kind: str) -> Optional[Type[Resource]]:
        return KIND_BY_NAME.get(kind)

    @staticmethod
    def _obj_from_body(body: dict) -> Resource:
        data = dict(body.get("obj") or {})
        kind = data.pop("kind", "")
        cls = KIND_BY_NAME.get(kind)
        if cls is None:
            raise ValueError(f"unknown kind {kind!r}")
        return from_dict(cls, data)

    # -- dispatch ----------------------------------------------------------

    def handle(self, method: str, path: str, qs: Dict[str, list],
               body: dict, headers) -> Optional[tuple]:
        """Returns (status_code, payload) for store paths, None for
        paths this gateway does not own."""
        if not path.startswith("/api/v1/store/"):
            return None
        role = self.role_of(headers)
        if role is None:
            return 401, {"error": "missing or bad X-TPF-Token"}
        sub = path[len("/api/v1/store/"):]
        if not self._allowed(role, method, sub, qs, body):
            return 403, {"error": f"role {role!r} may not {method} "
                                  f"/store/{sub}"}
        try:
            if sub == "objects":
                if method == "GET":
                    return self._get_object(qs)
                if method == "POST":
                    return self._create(body)
                if method == "PUT":
                    return self._update(body)
                if method == "DELETE":
                    return self._delete(qs)
            elif sub == "list" and method == "GET":
                return self._list(qs)
            elif sub == "watch" and method == "GET":
                return self._watch(qs)
            elif sub == "metrics":
                if method == "POST":
                    return self._push_metrics(body)
                if method == "GET":
                    return self._drain_metrics(qs)
            return 404, {"error": f"no store route {method} {path}"}
        except ValueError as e:
            return 400, {"error": str(e)}

    # -- handlers ----------------------------------------------------------

    @staticmethod
    def _name_args(qs) -> tuple:
        kind = qs.get("kind", [""])[0]
        name = qs.get("name", [""])[0]
        namespace = qs.get("namespace", [""])[0]
        if not kind or not name:
            raise ValueError("kind and name are required")
        return kind, name, namespace

    def _get_object(self, qs) -> tuple:
        kind, name, namespace = self._name_args(qs)
        cls = self._cls(kind)
        if cls is None:
            return 400, {"error": f"unknown kind {kind!r}"}
        obj = self.store.try_get(cls, name, namespace)
        if obj is None:
            return 404, {"error": f"{kind} {namespace}/{name} not found"}
        return 200, {"obj": obj.to_dict()}

    def _list(self, qs) -> tuple:
        kind = qs.get("kind", [""])[0]
        cls = self._cls(kind)
        if cls is None:
            return 400, {"error": f"unknown kind {kind!r}"}
        namespace = qs.get("namespace", [None])[0]
        items = self.store.list(cls, namespace=namespace)
        return 200, {"items": [o.to_dict() for o in items],
                     "rv": self.store.current_rv}

    def _create(self, body) -> tuple:
        obj = self._obj_from_body(body)
        try:
            created = self.store.create(obj)
        except AlreadyExistsError as e:
            return 409, {"error": str(e), "reason": "exists"}
        return 201, {"obj": created.to_dict()}

    def _update(self, body) -> tuple:
        obj = self._obj_from_body(body)
        try:
            if body.get("upsert"):
                updated = self.store.update_or_create(obj)
            else:
                updated = self.store.update(
                    obj, check_version=bool(body.get("check_version")))
        except NotFoundError as e:
            return 404, {"error": str(e)}
        except ConflictError as e:
            return 409, {"error": str(e), "reason": "conflict"}
        return 200, {"obj": updated.to_dict()}

    def _delete(self, qs) -> tuple:
        kind, name, namespace = self._name_args(qs)
        cls = self._cls(kind)
        if cls is None:
            return 400, {"error": f"unknown kind {kind!r}"}
        try:
            self.store.delete(cls, name, namespace)
        except NotFoundError as e:
            return 404, {"error": str(e)}
        return 200, {"deleted": True}

    def _watch(self, qs) -> tuple:
        since_rv = int(qs.get("since_rv", ["0"])[0])
        kinds = [k for k in qs.get("kinds", [""])[0].split(",") if k]
        wait_s = min(float(qs.get("wait_s", ["0"])[0]), MAX_WATCH_WAIT_S)
        # sharded cells (docs/control-plane-scale.md): there is no
        # global rv order across partitions, so the watch window is a
        # PER-SHARD surface — a shard-less first request is answered
        # with the shard count (window discovery) and the client opens
        # one long-poll per shard (`shard=i`), each backed by
        # ``shard_store(i).snapshot_events/events_since``
        n_shards = int(getattr(self.store, "n_shards", 1) or 1)
        shard = qs.get("shard", [None])[0]
        store = self.store
        if n_shards > 1:
            if shard is None:
                return 200, {"rv": 0, "reset": False, "events": [],
                             "shards": n_shards}
            idx = int(shard)
            if not 0 <= idx < n_shards:
                return 400, {"error": f"shard {idx} out of range "
                                      f"(cell has {n_shards})"}
            store = self.store.shard_store(idx)
        elif shard is not None and int(shard) != 0:
            return 400, {"error": "store is not sharded"}
        # a client's *first* request (primed=0) establishes its window:
        # with replay it gets the current state as ADDED events, without
        # it just the current rv — either way it then long-polls with
        # primed=1 from that rv (this distinguishes "start me up" from
        # "events since rv 0", which matter apart when the store is empty)
        if qs.get("primed", ["0"])[0] not in ("1", "true"):
            if qs.get("replay", ["1"])[0] in ("0", "false"):
                return 200, {"rv": store.current_rv, "reset": False,
                             "events": [], "shards": n_shards}
            rv, snapshot = store.snapshot_events(kinds)
            return 200, {"rv": rv, "reset": False, "shards": n_shards,
                         "events": [{"type": etype, "kind": kind,
                                     "obj": obj}
                                    for etype, kind, obj in snapshot]}
        conflate = qs.get("conflate", ["0"])[0] in ("1", "true")
        rv, frags, reset = store.events_since(since_rv, kinds,
                                              wait_s=wait_s,
                                              serialized=True,
                                              conflate=conflate)
        reset_s = "true" if reset else "false"
        return 200, RawJson(
            '{"rv":%d,"reset":%s,"events":[%s]}'
            % (rv, reset_s, ",".join(frags)))

    # -- metrics shipping --------------------------------------------------

    def _push_metrics(self, body) -> tuple:
        lines = body.get("lines")
        if not isinstance(lines, list) or \
                not all(isinstance(ln, str) for ln in lines):
            raise ValueError('body must be {"lines": ["<influx line>"...]}')
        seq = self.metrics.push(lines)
        if self.metrics_sink is not None:
            try:
                self.metrics_sink(lines)
            except Exception:  # noqa: BLE001 - sink trouble must not
                # bounce the hypervisor's push (it would retry forever)
                log.exception("metrics sink failed")
        return 200, {"seq": seq}

    def _drain_metrics(self, qs) -> tuple:
        since_seq = int(qs.get("since_seq", ["0"])[0])
        wait_s = min(float(qs.get("wait_s", ["0"])[0]), MAX_WATCH_WAIT_S)
        epoch = qs.get("epoch", [None])[0]
        seq, lines, dropped = self.metrics.since(since_seq, wait_s=wait_s,
                                                 epoch=epoch)
        return 200, {"seq": seq, "lines": lines, "dropped": dropped,
                     "epoch": self.metrics.epoch}
