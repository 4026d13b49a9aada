"""Worker-to-worker peer links: the port's copy of
``tensorfusion_tpu/remoting/fabric.py``.

A :class:`PeerLink` is one pooled :class:`~.client.RemoteDevice` session
framed by the same wire protocol the client speaks.  Every byte path
between two workers rides one: KV_SHIP from a prefill tier
(``serving/disagg.py:RemoteKVShipper``), the pre-copy rounds of a
streaming migration (staged quiet PUTs, :meth:`PeerLink.stage`), and the
reduce and install hops of the zero-relay fabric ring
(:meth:`PeerLink.ship_reduce` / :meth:`PeerLink.ship_install`, protocol
v9).  So each gets the adaptive encodings (q8 per leg when the link was
leased with ``quantize``), the target's WFQ tenancy and HELLO version
negotiation, which keeps a v9 hop from ever reaching a pre-v9 peer.

Staged PUTs are sent directly on the link's connection, in order; the
reference's background upload stream gave no overlap on the card and is
not ported.  :meth:`PeerLink.drain` is one round trip that returns once
the target has read every frame sent before it.

Links are pooled per ``(target_url, token, quantize)`` with an idle TTL
(:data:`PEER_LINK_IDLE_TTL_S`) instead of dialed per session.
HELLO_OK's ``worker_uid`` (fresh per worker process) is the staleness
oracle: a pooled link whose target restarted reports a changed uid when
it is re-verified on lease, and is replaced by a fresh dial, so pooled
transport never implies that staged state survived the peer's restart.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

from .. import constants
from ..clock import Clock, default_clock
from . import protocol
from .client import RemoteDevice

log = logging.getLogger("tpf_torch.remoting.fabric")

#: seconds a pooled peer link may sit idle before the sweep closes it
PEER_LINK_IDLE_TTL_S = 60.0

#: a link used within this window skips the worker_uid round trip on
#: lease: a target restart inside the window severed the TCP session, so
#: the next frame errors instead of landing on the new process; the uid
#: oracle protects staged state across idle gaps
PEER_LINK_VERIFY_FRESH_S = 1.0


class PeerLink:
    """One worker-to-worker session over a :class:`RemoteDevice`.  The
    link carries bytes; state its holders mint on the target is theirs.
    ``generation`` counts the re-dials of the same key (target
    restarts), so a holder that cached target-side state can tell it
    went stale.  ``raw_bytes`` / ``wire_bytes`` count what its hops
    moved over its lifetime."""

    def __init__(self, url: str, token: str = "",
                 qos: str = constants.DEFAULT_QOS,
                 quantize: bool = False,
                 clock: Optional[Clock] = None) -> None:
        self.url = url
        self.token = token
        self.quantize = bool(quantize)
        self.device = RemoteDevice(url, token=token, qos=qos,
                                   quantize=self.quantize)
        self.worker_uid: Optional[str] = None
        self.generation = 0
        self.raw_bytes = 0
        self.wire_bytes = 0
        self._clock = clock or default_clock()
        self.last_used_m = self._clock.monotonic()

    # -- staged uploads (the migration path) ---------------------------

    def stage(self, buf_id: str, host,
              stats: Optional[Dict[str, int]] = None) -> None:
        """Send one quiet client-minted PUT (q8-eligible when the link
        negotiated it).  Not ``ephemeral``: staged state survives until
        its owner binds or frees it."""
        self.device._submit("PUT", {"buf_id": buf_id, "quiet": True},
                            [host], want_reply=False, stats=stats)

    def drain(self) -> None:
        """Ordering barrier: returns once the target has read every
        staged PUT sent before it (an empty FREE, which the target
        answers in order on this connection)."""
        self.device._rpc("FREE", {"buf_ids": []}, [])

    # -- framed peer hops (the fabric ring) ------------------------------

    def _hop(self, kind: str, meta: Dict[str, Any],
             payload) -> Dict[str, Any]:
        self.device._ensure_version(protocol.FABRIC_MIN_VERSION,
                                    f"{kind} (peer fabric)")
        st: Dict[str, int] = {}
        fut = self.device._submit(kind, meta, [payload], stats=st)
        _, rmeta, _ = self.device._result(fut)
        self.raw_bytes += int(st.get("raw_bytes", 0))
        self.wire_bytes += int(st.get("wire_bytes", 0))
        self.touch()
        return rmeta

    def ship_reduce(self, cid: str, step: int, payload,
                    op: str = "sum") -> Dict[str, Any]:
        """One PEER_REDUCE hop: ship the running sum to the next ring
        member and wait for its ack (the ring's backpressure)."""
        return self._hop("PEER_REDUCE", {"cid": str(cid), "step": int(step),
                                         "op": str(op)}, payload)

    def ship_install(self, cid: str, step: int, payload) -> Dict[str, Any]:
        """One PEER_INSTALL hop: fan the reduced total down-ring."""
        return self._hop("PEER_INSTALL", {"cid": str(cid),
                                          "step": int(step)}, payload)

    # -- lifecycle --------------------------------------------------------

    def verify(self) -> bool:
        """Re-verify a pooled link on lease: dial (or reconnect) and
        compare the target's ``worker_uid`` with the one this link last
        saw.  False means the target restarted."""
        try:
            self.device.info()
        except Exception as e:  # noqa: BLE001 - any failure means re-dial
            log.debug("peer link %s verify failed: %s", self.url, e)
            return False
        uid = self.device.worker_uid
        if self.worker_uid is None:
            self.worker_uid = uid
            return True
        return uid is None or uid == self.worker_uid

    def touch(self) -> None:
        self.last_used_m = self._clock.monotonic()

    def close(self) -> None:
        try:
            self.device.close()
        except Exception as e:  # noqa: BLE001 - best-effort teardown
            log.debug("peer link close failed: %s", e)


class PeerLinkPool:
    """Idle :class:`PeerLink` sessions keyed by ``(target_url, token,
    quantize)``.
    ``lease()`` pops a pooled link for the key (re-verifying the
    target's ``worker_uid`` unless the link was used within
    :data:`PEER_LINK_VERIFY_FRESH_S`, and re-dialing when the target
    restarted) or dials fresh; ``release()`` parks the link and sweeps
    links idle past :data:`PEER_LINK_IDLE_TTL_S`.  Leased links are not tracked: one holder owns a link
    at a time, so two concurrent holders get two links."""

    def __init__(self, clock: Optional[Clock] = None) -> None:
        self._clock = clock or default_clock()
        # guarded by: _lock
        self._idle: Dict[Tuple[str, str, bool], List[PeerLink]] = {}
        self._lock = threading.Lock()
        # guarded by: _lock
        self._closed = False
        # guarded by: _lock
        self.stats = {"leases": 0, "hits": 0, "dials": 0,
                      "redials": 0, "expired": 0}

    def lease(self, url: str, token: str = "",
              qos: str = constants.DEFAULT_QOS,
              quantize: bool = False) -> PeerLink:
        key = (str(url), str(token), bool(quantize))
        pooled: Optional[PeerLink] = None
        with self._lock:
            self.stats["leases"] += 1
            bucket = self._idle.get(key)
            if bucket:
                pooled = bucket.pop()
                if not bucket:
                    del self._idle[key]
        if pooled is not None:
            fresh = (self._clock.monotonic() - pooled.last_used_m
                     <= PEER_LINK_VERIFY_FRESH_S)
            if fresh or pooled.verify():
                with self._lock:
                    self.stats["hits"] += 1
                pooled.touch()
                return pooled
            # the target restarted (or the link died): replace it, one
            # generation on, so holders know staged state is gone
            gen = pooled.generation + 1
            pooled.close()
            with self._lock:
                self.stats["redials"] += 1
            link = PeerLink(url, token=token, qos=qos, quantize=quantize,
                            clock=self._clock)
            link.generation = gen
            return link
        with self._lock:
            self.stats["dials"] += 1
        return PeerLink(url, token=token, qos=qos, quantize=quantize,
                        clock=self._clock)

    def release(self, link: PeerLink) -> None:
        """Park a link for reuse and sweep expired idle ones; after
        :meth:`close` a released link is closed instead."""
        link.touch()
        if link.worker_uid is None:
            # bind the uid the link spoke to, so the next lease's
            # verify() can see a restart in between
            link.worker_uid = link.device.worker_uid
        key = (link.url, link.token, link.quantize)
        with self._lock:
            if self._closed:
                closing = [link]
            else:
                self._idle.setdefault(key, []).append(link)
                closing = self._sweep_locked()
        for stale in closing:
            stale.close()

    def _sweep_locked(self) -> List[PeerLink]:   # holds _lock
        now = self._clock.monotonic()
        expired: List[PeerLink] = []
        for key in list(self._idle):
            keep = []
            for ln in self._idle[key]:
                (keep if now - ln.last_used_m <= PEER_LINK_IDLE_TTL_S
                 else expired).append(ln)
            if keep:
                self._idle[key] = keep
            else:
                del self._idle[key]
        self.stats["expired"] += len(expired)
        return expired

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self.stats,
                        idle_links=sum(len(b) for b in self._idle.values()))

    def close(self) -> None:
        with self._lock:
            self._closed = True
            links = [ln for b in self._idle.values() for ln in b]
            self._idle.clear()
        for ln in links:
            ln.close()
