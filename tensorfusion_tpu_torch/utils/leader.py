"""Leader election for HA operator deployments.

The port's copy of ``tensorfusion_tpu/utils/leader.py``.

Analog of the reference's controller-runtime leader election + the
leader-info ConfigMap carrying the leader's IP (``cmd/main.go:785-812``,
consumed by webhook host-port forwarding): several operator replicas
share one state directory (or PVC); an ``fcntl`` exclusive lock on the
lock file elects exactly one leader, which publishes its identity +
endpoint in ``leader-info.json`` next to it.  Followers poll for the
lock and read the info file to forward leader-only requests
(assign-host-port / assign-index in the reference).

File locks release automatically when the holder dies — crash failover
needs no TTL bookkeeping.
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import threading
from typing import Callable, Optional

from ..clock import Clock, default_clock

log = logging.getLogger("tpf.leader")


class LeaderElector:
    def __init__(self, lock_path: str, identity: str,
                 endpoint: str = "",
                 on_started_leading: Optional[Callable[[], None]] = None,
                 on_stopped_leading: Optional[Callable[[], None]] = None,
                 retry_interval_s: float = 1.0,
                 clock: Optional[Clock] = None):
        self.clock = clock or default_clock()
        self.lock_path = lock_path
        self.identity = identity
        self.endpoint = endpoint
        self.on_started_leading = on_started_leading or (lambda: None)
        self.on_stopped_leading = on_stopped_leading or (lambda: None)
        self.retry_interval_s = retry_interval_s
        self.is_leader = False
        self._fd: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def info_path(self) -> str:
        return os.path.join(os.path.dirname(self.lock_path) or ".",
                            "leader-info.json")

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._campaign,
                                        name="tpf-leader", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self._resign()

    def wait_for_leadership(self, timeout_s: float = 30.0) -> bool:
        deadline = self.clock.monotonic() + timeout_s
        while self.clock.monotonic() < deadline:
            if self.is_leader:
                return True
            if self._stop.is_set():
                return False
            self.clock.sleep(0.02)
        return self.is_leader

    # -- internals ------------------------------------------------------

    def _campaign(self) -> None:
        while not self._stop.is_set():
            if self._try_acquire():
                self.is_leader = True
                log.info("%s acquired leadership (%s)", self.identity,
                         self.lock_path)
                try:
                    self.on_started_leading()
                except Exception:
                    log.exception("on_started_leading failed")
                # hold until stopped; the OS releases the lock if we die
                self._stop.wait()
                return
            self._stop.wait(self.retry_interval_s)

    def _try_acquire(self) -> bool:
        os.makedirs(os.path.dirname(self.lock_path) or ".", exist_ok=True)
        fd = os.open(self.lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return False
        self._fd = fd
        os.ftruncate(fd, 0)
        os.write(fd, self.identity.encode())
        with open(self.info_path, "w") as f:
            json.dump({"identity": self.identity, "pid": os.getpid(),
                       "endpoint": self.endpoint,
                       "acquired_at": self.clock.now()}, f)
        return True

    def _resign(self) -> None:
        if self._fd is not None:
            was_leader = self.is_leader
            self.is_leader = False
            # retract our leader-info so followers don't forward to a
            # resigned leader (a successor overwrites it on acquire)
            try:
                info = self.read_leader_info(self.lock_path)
                if info and info.get("identity") == self.identity:
                    os.unlink(self.info_path)
            except OSError:
                pass
            try:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
            if was_leader:
                try:
                    self.on_stopped_leading()
                except Exception:
                    log.exception("on_stopped_leading failed")

    # -- follower side --------------------------------------------------

    @staticmethod
    def read_leader_info(lock_path: str) -> Optional[dict]:
        info_path = os.path.join(os.path.dirname(lock_path) or ".",
                                 "leader-info.json")
        try:
            with open(info_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None


class StoreLeaderElector:
    """Cross-host leader election through a Lease object in the (shared)
    store — fcntl locks only elect within one machine; operator replicas
    on different hosts race on optimistic-concurrency updates of a single
    ``Lease`` instead, exactly how the reference's replicas elect through
    a coordination Lease in the apiserver (``cmd/main.go:785-812``).

    Protocol per tick:

    - the holder renews ``renew_time`` with ``check_version=True``; a
      ``ConflictError`` means someone else wrote the lease — leadership
      is considered lost and ``on_stopped_leading`` fires;
    - a challenger acquires iff the lease is absent or stale
      (``now - renew_time > lease_duration_s``), again version-checked so
      exactly one concurrent challenger wins; acquisition increments the
      **fencing token**, which every store write by leader-only
      controllers can carry to be rejected if a deposed leader acts on
      a stale view.

    Clock note: staleness compares the challenger's clock against the
    holder's written wall clock — same tolerance class as Kubernetes
    leases (bounded skew assumed, durations ≫ skew).
    """

    LEASE_NAME = "operator-leader"

    def __init__(self, store, identity: str, endpoint: str = "",
                 lease_duration_s: float = 10.0,
                 renew_interval_s: float = 2.0,
                 on_started_leading: Optional[Callable[[], None]] = None,
                 on_stopped_leading: Optional[Callable[[], None]] = None,
                 clock: Optional[Clock] = None,
                 lease_name: str = ""):
        self.clock = clock or default_clock()
        self.store = store
        #: which lease this elector campaigns for — the default is the
        #: singleton operator lease; sharded control planes run one
        #: campaign per shard under per-shard names (shard_lease_name)
        self.lease_name = lease_name or self.LEASE_NAME
        self.identity = identity
        self.endpoint = endpoint
        self.lease_duration_s = lease_duration_s
        self.renew_interval_s = renew_interval_s
        self.on_started_leading = on_started_leading or (lambda: None)
        self.on_stopped_leading = on_stopped_leading or (lambda: None)
        self.is_leader = False
        self.fencing_token = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._campaign,
                                        name="tpf-store-leader",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if self.is_leader:
            self._resign()

    def wait_for_leadership(self, timeout_s: float = 30.0) -> bool:
        deadline = self.clock.monotonic() + timeout_s
        while self.clock.monotonic() < deadline and \
                not self._stop.is_set():
            if self.is_leader:
                return True
            self.clock.sleep(0.02)
        return self.is_leader

    def leader_info(self) -> Optional[dict]:
        """Current lease view (followers use holder_url to redirect)."""
        from ..api.types import Lease

        try:
            lease = self.store.try_get(Lease, self.lease_name)
        except Exception:  # noqa: BLE001 - transport error = unknown
            log.debug("lease read failed; leader unknown",
                      exc_info=True)
            return None
        if lease is None:
            return None
        return {"identity": lease.spec.holder,
                "endpoint": lease.spec.holder_url,
                "fencing_token": lease.spec.fencing_token,
                "renew_time": lease.spec.renew_time}

    # -- internals ------------------------------------------------------

    def _campaign(self) -> None:
        while not self._stop.is_set():
            self.campaign_tick()
            self.clock.wait(self._stop, self.renew_interval_s)

    def campaign_tick(self) -> None:
        """One renew-or-challenge pass.  The campaign thread runs it
        every ``renew_interval_s``; the digital twin drives it directly
        from a simulated-time timer (no thread)."""
        try:
            if self.is_leader:
                if not self._renew():
                    self._demote()
            else:
                if self._try_acquire():
                    self.is_leader = True
                    log.info("%s acquired store lease (token %d)",
                             self.identity, self.fencing_token)
                    try:
                        self.on_started_leading()
                    except Exception:
                        log.exception("on_started_leading failed")
        except Exception:  # noqa: BLE001 - keep campaigning through
            log.exception("leader campaign tick failed")

    def _try_acquire(self) -> bool:
        from ..api.types import Lease
        from ..store import AlreadyExistsError, ConflictError

        try:
            lease = self.store.try_get(Lease, self.lease_name)
        except Exception:  # noqa: BLE001 - store unreachable
            log.debug("lease read failed; not campaigning this tick",
                      exc_info=True)
            return False
        now = self.clock.now()
        try:
            if lease is None:
                lease = Lease.new(self.lease_name)
                self._fill(lease, now, lease.spec.fencing_token + 1)
                self.store.create(lease)
            else:
                age = now - lease.spec.renew_time
                if lease.spec.holder == self.identity:
                    pass          # reclaim our own lease (restart)
                elif age <= self.lease_duration_s:
                    return False  # healthy holder
                lease = lease.thaw()
                self._fill(lease, now, lease.spec.fencing_token + 1)
                lease.spec.transitions += 1
                self.store.update(lease, check_version=True)
        except (ConflictError, AlreadyExistsError):
            return False          # a concurrent challenger won
        except Exception:  # noqa: BLE001
            log.debug("lease acquire failed; retrying next tick",
                      exc_info=True)
            return False
        self.fencing_token = lease.spec.fencing_token
        return True

    def _fill(self, lease, now: float, token: int) -> None:
        lease.spec.holder = self.identity
        lease.spec.holder_url = self.endpoint
        lease.spec.lease_duration_s = self.lease_duration_s
        lease.spec.renew_time = now
        lease.spec.fencing_token = token

    def _renew(self) -> bool:
        from ..api.types import Lease
        from ..store import ConflictError, NotFoundError

        try:
            lease = self.store.get(Lease, self.lease_name)
            if lease.spec.holder != self.identity:
                return False      # usurped
            lease = lease.thaw()
            lease.spec.renew_time = self.clock.now()
            self.store.update(lease, check_version=True)
            return True
        except (ConflictError, NotFoundError):
            return False
        except Exception:  # noqa: BLE001 - store unreachable: fail safe
            # and drop leadership rather than risk split-brain past the
            # lease duration
            log.debug("lease renew failed; demoting", exc_info=True)
            return False

    def _demote(self) -> None:
        was = self.is_leader
        self.is_leader = False
        if was:
            log.warning("%s lost the store lease", self.identity)
            try:
                self.on_stopped_leading()
            except Exception:
                log.exception("on_stopped_leading failed")

    def _resign(self) -> None:
        """Graceful handoff: zero the renew_time so a successor can
        acquire immediately instead of waiting out the TTL."""
        from ..api.types import Lease

        self._demote()
        try:
            lease = self.store.try_get(Lease, self.lease_name)
            if lease is not None and lease.spec.holder == self.identity:
                lease = lease.thaw()
                lease.spec.renew_time = 0.0
                self.store.update(lease, check_version=True)
        except Exception:  # noqa: BLE001 - best effort
            log.debug("graceful lease handoff failed; successor waits "
                      "out the TTL", exc_info=True)


def shard_lease_name(shard: int) -> str:
    """Canonical per-shard ownership lease name (stored IN the shard it
    governs, so fencing tokens ride the shard's own journal and survive
    an owner crash + journal replay)."""
    return f"shard-{int(shard):02d}-owner"


class ShardLeaseElector(StoreLeaderElector):
    """One lease-owning campaign per store shard: the StoreLeaderElector
    protocol (version-checked renew/challenge, monotonic fencing
    tokens, skew tolerance — all sim-tested under the twin) pointed at
    a per-shard Lease.  N of these across N shards generalize "one
    leader" to "one owner per shard": each winner runs the full
    controller stack against its shard only
    (docs/control-plane-scale.md)."""

    def __init__(self, store, shard: int, identity: str, **kwargs):
        kwargs.setdefault("lease_name", shard_lease_name(shard))
        super().__init__(store, identity, **kwargs)
        self.shard = int(shard)
