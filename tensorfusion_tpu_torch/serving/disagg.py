"""Disaggregated prefill/decode, local pool: the port's copy of
``tensorfusion_tpu/serving/disagg.py`` (``_Job``, ``_PrefillWorker``,
``PrefillPool``).

Chunked prefill inside the decode loop bounds how long a long prompt can
stall the fused batch, but its chunks still spend decode-step time.
:class:`PrefillPool` moves prefill onto DESIGNATED workers, each owning
its own runner + :class:`~.kvpool.BlockAccount` (with the same
content-hash prefix sharing the decode side runs, plus a bounded
*retained* window so sequential jobs with a shared system prompt hit the
registry).  Finished pages ship to the decode engine as a *payload* —
per-block content keys, the ``[L, n, n_kv, bs, D]`` K/V pages and the
first generated token — which the engine ingests with per-block dedup
against ITS registry (``engine._activate_shipped``).

Two stepping modes: ``inline=True`` advances ONE chunk per
:meth:`PrefillPool.pump` call on the engine's stepper (deterministic —
the tests use it); otherwise :meth:`PrefillPool.start` runs one thread
per worker.  :class:`RemoteKVShipper` ships a payload to a remote decode
worker's engine as a protocol-v6 ``KV_SHIP`` over a pooled peer link
(``remoting/fabric.py``).
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Callable, List, Optional

from ..clock import Clock, default_clock
from ..remoting.fabric import PeerLinkPool
from .kvpool import BlockAccount, prompt_block_keys

#: prompt tokens prefilled per pool-worker advance (inline mode; the
#: thread mode runs whole prompts chunk by chunk without yielding)
DEFAULT_POOL_CHUNK = 64
#: finished jobs whose blocks a prefill worker retains as prefix cache
#: before the oldest is evicted (refcounts: retained blocks free the
#: moment pressure needs them and no live job shares them)
DEFAULT_RETAIN_JOBS = 8


class _Job:
    __slots__ = ("seq", "tokens", "owner", "keys", "pos", "first")

    def __init__(self, seq, tokens: List[int], owner: int):
        self.seq = seq
        self.tokens = list(tokens)
        self.owner = owner
        self.keys = None          # set on first advance
        self.pos = -1             # -1 = not started
        self.first: Optional[int] = None


class _PrefillWorker:
    """One designated prefill runner + its block account."""

    def __init__(self, runner, chunk_tokens: int, share: bool,
                 retain: int, ids):
        self.runner = runner
        self.account = BlockAccount(runner.num_blocks,
                                    runner.block_size)
        self.chunk_tokens = max(1, chunk_tokens)
        self.share = share
        self.retain = max(0, retain)
        self._ids = ids
        self.jobs: "deque[_Job]" = deque()
        #: finished owners whose blocks stay resident as prefix cache
        self.retained: "deque[int]" = deque()
        self.prefilled_tokens = 0
        self.shipped_jobs = 0
        self.failed_jobs = 0

    # -- allocation with retained-cache eviction ------------------------

    def _evict_one_retained(self) -> bool:
        if not self.retained:
            return False
        self.account.release(self.retained.popleft())
        return True

    def _ensure(self, owner: int, n_tokens: int) -> bool:
        while not self.account.ensure(owner, n_tokens):
            if not self._evict_one_retained():
                return False
        return True

    def _writable(self, owner: int, bi: int):
        while True:
            w = self.account.writable(owner, bi)
            if w is not None:
                return w
            if not self._evict_one_retained():
                return None

    # -- one chunk ------------------------------------------------------

    def advance(self, job: _Job) -> Optional[bool]:
        """Prefill one chunk of ``job``; True when the job finished,
        False to continue, None when the pool cannot hold the prompt
        even with the cache evicted (the engine falls back to inline
        prefill)."""
        acct = self.account
        n = len(job.tokens)
        if job.pos < 0:
            job.keys = prompt_block_keys(job.tokens, acct.block_size)
            matched = acct.adopt(job.owner, job.keys) \
                if self.share else 0
            job.pos = min(matched, n - 1)
            if not self._ensure(job.owner, n):
                acct.release(job.owner)
                self.failed_jobs += 1
                return None
        chunk = min(self.chunk_tokens, n - job.pos)
        bs = acct.block_size
        pairs = []
        for bi in range(job.pos // bs, (job.pos + chunk - 1) // bs + 1):
            w = self._writable(job.owner, bi)
            if w is None:
                acct.release(job.owner)
                self.failed_jobs += 1
                return None
            blk, src = w
            if src is not None:
                pairs.append((src, blk))
        if pairs:
            self.runner.copy_blocks(pairs)
        last = job.pos + chunk >= n
        first = self.runner.prefill(
            job.tokens[job.pos:job.pos + chunk],
            acct.table(job.owner), job.pos, last=last)
        if self.share:
            for bi, (key, covered) in enumerate(job.keys):
                if covered > job.pos + chunk:
                    break
                acct.publish(job.owner, bi, key)
        job.pos += chunk
        self.prefilled_tokens += chunk
        if not last:
            return False
        job.first = first
        return True

    def payload(self, job: _Job) -> dict:
        table = self.account.table(job.owner)
        k, v = self.runner.read_blocks(table)
        nbytes = (k.nbytes + v.nbytes) if k is not None else 0
        return {"keys": [key for key, _ in job.keys],
                "k": k, "v": v,
                "first_token": job.first,
                "n_tokens": len(job.tokens),
                "bytes": int(nbytes)}

    def finish(self, job: _Job) -> None:
        """Retain the finished job's blocks as prefix cache (bounded);
        refcounts keep any block a live job adopted resident."""
        self.shipped_jobs += 1
        self.retained.append(job.owner)
        while len(self.retained) > self.retain:
            self.account.release(self.retained.popleft())


class PrefillPool:
    """Designated prefill workers feeding a decode engine
    (``ServingEngine(prefill_pool=...)`` attaches the ready
    callback)."""

    def __init__(self, runners: List, chunk_tokens: int =
                 DEFAULT_POOL_CHUNK, share: bool = True,
                 retain: int = DEFAULT_RETAIN_JOBS,
                 inline: bool = False,
                 clock: Optional[Clock] = None):
        if not runners:
            raise ValueError("prefill pool needs at least one runner")
        self.clock = clock or default_clock()
        self.inline = bool(inline)
        ids = itertools.count(1)
        self.workers = [_PrefillWorker(r, chunk_tokens, share, retain,
                                       ids)
                        for r in runners]
        self._ids = ids
        self._on_ready: Optional[Callable] = None
        self._cv = threading.Condition()
        # guarded by: _cv
        self._stopping = False
        self._threads: List[threading.Thread] = []

    def attach(self, on_ready: Callable) -> None:
        """The engine's ingest callback: ``on_ready(seq, payload)``
        with ``payload=None`` for a prompt the pool cannot hold (the
        engine falls back to inline prefill)."""
        self._on_ready = on_ready

    def submit(self, seq, tokens: List[int]) -> None:
        """Route one admitted sequence to the least-loaded worker
        (ties: lowest index — deterministic)."""
        with self._cv:
            worker = min(self.workers, key=lambda w: len(w.jobs))
            worker.jobs.append(_Job(seq, tokens, next(self._ids)))
            self._cv.notify_all()

    def _complete(self, worker: _PrefillWorker, job: _Job,
                  done: Optional[bool]) -> None:
        if done is None:
            self._on_ready(job.seq, None)
            return
        payload = worker.payload(job)
        worker.finish(job)
        self._on_ready(job.seq, payload)

    # -- inline stepping (sim / deterministic tests) --------------------

    def pump(self) -> bool:
        """Advance each worker's current job by ONE chunk; returns
        whether any work happened.  Inline mode only — with threads
        running this is a no-op (they own the job queues)."""
        if not self.inline:
            return False
        did = False
        for worker in self.workers:
            with self._cv:
                job = worker.jobs[0] if worker.jobs else None
            if job is None:
                continue
            done = worker.advance(job)
            did = True
            if done is not False:
                with self._cv:
                    worker.jobs.popleft()
                self._complete(worker, job, done)
        return did

    # -- thread-per-worker (worker/bench topology) ----------------------

    def start(self) -> None:
        if self.inline or self._threads:
            return
        with self._cv:
            self._stopping = False
        for i, worker in enumerate(self.workers):
            t = threading.Thread(target=self._loop, args=(worker,),
                                 name=f"tpf-prefill-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []

    def _loop(self, worker: _PrefillWorker) -> None:
        while True:
            with self._cv:
                while not worker.jobs and not self._stopping:
                    self._cv.wait(timeout=0.05)
                if self._stopping:
                    return
                job = worker.jobs[0]
            done = worker.advance(job)
            while done is False:
                done = worker.advance(job)
            with self._cv:
                worker.jobs.popleft()
            self._complete(worker, job, done)

    def snapshot(self) -> dict:
        with self._cv:
            return {
                "workers": len(self.workers),
                "inline": self.inline,
                "queued": sum(len(w.jobs) for w in self.workers),
                "prefilled_tokens": sum(w.prefilled_tokens
                                        for w in self.workers),
                "shipped_jobs": sum(w.shipped_jobs
                                    for w in self.workers),
                "failed_jobs": sum(w.failed_jobs
                                   for w in self.workers),
                "prefix_hits": sum(w.account.prefix_hits
                                   for w in self.workers),
                "retained_jobs": sum(len(w.retained)
                                     for w in self.workers),
            }


class RemoteKVShipper:
    """Remote prefill tier -> decode worker: ships a finished
    :meth:`_PrefillWorker.payload` to a remote worker's engine as a
    ``KV_SHIP`` over a :class:`~..remoting.fabric.PeerLink` leased from
    its own pool, so the pages ship raw (exact) with connection reuse
    per ``(url, token)`` and the stale-uid re-dial on a decode-worker
    restart."""

    def __init__(self, target_url: str, token: str = ""):
        self.target_url = str(target_url)
        self.token = token
        self.pool = PeerLinkPool()
        self.shipped_jobs = 0
        self.shipped_bytes = 0

    def ship(self, prompt: List[int], payload: Optional[dict],
             max_tokens: int = 1, eos_id: Optional[int] = None,
             on_token: Optional[Callable[[int], None]] = None
             ) -> Optional[dict]:
        """Ship one finished prefill payload and consume the decode
        stream; None passes through (the pool could not hold the prompt
        and the caller prefills inline)."""
        if payload is None:
            return None
        link = self.pool.lease(self.target_url, token=self.token)
        try:
            out = link.device.ship_kv(
                prompt, max_tokens, payload["keys"], payload["k"],
                payload["v"], payload["first_token"],
                payload["n_tokens"], eos_id=eos_id, on_token=on_token)
        finally:
            self.pool.release(link)
        self.shipped_jobs += 1
        self.shipped_bytes += int(payload.get("bytes") or 0)
        return out

    def snapshot(self) -> dict:
        return {"target": self.target_url,
                "shipped_jobs": self.shipped_jobs,
                "shipped_bytes": self.shipped_bytes,
                "pool": self.pool.snapshot()}

    def close(self) -> None:
        self.pool.close()
