"""tpfserve: decode-step-granularity continuous batching — the port's
copy of ``tensorfusion_tpu/serving/engine.py``.  Only the imports differ
in the code: the port's own clock, QoS constants, dispatcher vocabulary
and block account.

Sequences join and leave the decode batch at EVERY step (admission on
arrival, retirement on EOS/max-tokens), prompt prefill is chunked and
interleaved with decode steps, and every sequence's KV lives in the
shared paged pool (``serving/kvpool.py``).

- **admission**: waiting sequences are admitted highest QoS weight
  first (``constants.QOS_DISPATCH_WEIGHTS``), FIFO within a class,
  while the pool can hold their prompt and a batch slot is free; the
  wait is judged against ``constants.QOS_QUEUE_WAIT_SLO_MS``.
- **backpressure**: a full waiting queue raises
  :class:`~..remoting.dispatch.BusyError` with a ``retry_after_ms``
  drain estimate; a request whose ``deadline_ms`` elapses before its
  prefill starts is shed with ``DEADLINE_EXCEEDED``.
- **preemption**: when the pool cannot grow a decoding sequence, the
  lowest-weight most-recent active sequence is evicted back to the
  waiting queue and recomputes its prefix on re-admission (greedy
  decode is position-deterministic, so the suffix is identical).
- **copy-on-write prefix sharing**, **disaggregated prefill** (a
  :class:`~.disagg.PrefillPool`) and **speculative decoding** (a
  ``draft`` verified in one fused ``runner.verify`` step, greedy-exact)
  ride the same step loop.

Threading: ``submit()`` is thread-safe; everything else runs on ONE
stepper — either the engine thread (:meth:`start`) or an external
caller of :meth:`step`.  Token/done callbacks fire outside every
lock.  The ``tracer`` (``tracer.clock.now()``, ``tracer.record_span``),
``profiler`` (``attribute``, ``set_hbm``) and ``recorder`` (``note``)
hooks keep the reference's call contract; all default to ``None``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .. import constants
from ..clock import Clock, default_clock
from ..remoting.dispatch import BusyError, LatencyRecorder, qos_weight
from .kvpool import BlockAccount, prompt_block_keys

#: how many sequences may wait for admission before submit() pushes
#: back with BUSY — deep enough for a burst, shallow enough that queue
#: wait stays bounded (same philosophy as the dispatcher's queue caps)
DEFAULT_MAX_WAITING = 64
#: fused decode batch capacity (power-of-two bucketed by the runner)
DEFAULT_MAX_BATCH = 8
#: how long freeze() waits for the step in flight to end
FREEZE_WAIT_S = 30.0
#: prompt tokens prefILLED per engine step, across sequences — the
#: knob that bounds how long a long prompt can stall the decode batch
DEFAULT_PREFILL_CHUNK = 64

#: sequence states
WAITING = "waiting"
PREFILL = "prefill"
ACTIVE = "active"
DONE = "done"

#: finish reasons
FINISH_EOS = "eos"
FINISH_LENGTH = "length"
FINISH_SHED = "shed"


class Sequence:
    """One generation request inside the engine."""

    __slots__ = ("sid", "tenant", "qos", "weight", "prompt",
                 "max_new_tokens", "eos_id", "emit", "trace",
                 "trace_spans", "arrival_m", "deadline_m", "admitted_m",
                 "ttft_ms", "state", "prefill_pos", "tokens", "emitted",
                 "finish_reason", "preemptions", "block_keys",
                 "prefix_matched", "disagg", "shipped", "spec_skip")

    def __init__(self, sid: int, tenant: str, qos: str,
                 prompt: List[int], max_new_tokens: int,
                 eos_id: Optional[int], emit: Optional[Callable],
                 trace: Optional[dict], arrival_m: float,
                 deadline_m: Optional[float]):
        self.sid = sid
        self.tenant = tenant
        self.qos = qos
        self.weight = qos_weight(qos)
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        #: emit(seq, new_tokens, done, info) — called OUTSIDE engine
        #: locks, on the stepper thread
        self.emit = emit
        #: propagated trace context ({"trace_id","span_id","sampled"})
        self.trace = trace
        #: server-side span dicts, carried back on the final reply
        self.trace_spans: List[dict] = []
        self.arrival_m = arrival_m
        self.deadline_m = deadline_m
        self.admitted_m: Optional[float] = None
        self.ttft_ms: Optional[float] = None
        self.state = WAITING
        #: prompt tokens already prefilled (over prompt + generated —
        #: a preempted sequence re-prefills its whole prefix)
        self.prefill_pos = 0
        #: generated tokens (greedy), grows one per decode step
        self.tokens: List[int] = []
        #: how many of ``tokens`` the emit callback has seen
        self.emitted = 0
        self.finish_reason = ""
        self.preemptions = 0
        #: per-block content keys of the prompt (lazy, prefix sharing)
        self.block_keys: Optional[List[Tuple[int, int]]] = None
        #: prompt tokens the block registry served at last admission
        self.prefix_matched = 0
        #: prefill runs on the disaggregated pool, not the step budget
        self.disagg = False
        #: pre-prefilled KV payload awaiting ingest (KV_SHIP / pool)
        self.shipped: Optional[dict] = None
        #: draft cooldown: after a round where EVERY proposal was
        #: rejected, skip speculating this sequence for one round (the
        #: draft is out of phase — don't burn verify width on it)
        self.spec_skip = False

    def context(self) -> List[int]:
        """The full prefix to (re)prefill: prompt + generated so far."""
        return self.prompt + self.tokens

    def context_len(self) -> int:
        return len(self.prompt) + len(self.tokens)


class _TenantStats:
    __slots__ = ("qos", "tokens", "ttft", "slo_good", "slo_total",
                 "last_trace_id", "prefix_hit_tokens", "spec_proposed",
                 "spec_accepted", "last_prefix_trace_id",
                 "last_spec_trace_id")

    def __init__(self, qos: str):
        self.qos = qos
        self.tokens = 0
        self.ttft = LatencyRecorder(maxlen=512)
        self.slo_good = 0
        self.slo_total = 0
        self.last_trace_id = ""
        self.prefix_hit_tokens = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        #: trace of the last request that ADOPTED a shared prefix /
        #: decoded speculatively — the field-scoped TSDB exemplars for
        #: prefix_hit_tokens_total and spec_accept_rate (the metrics
        #: recorder attaches them, docs/tracing.md), so policies over
        #: serving SLOs cite the request that took that path rather
        #: than whichever admission happened last
        self.last_prefix_trace_id = ""
        self.last_spec_trace_id = ""


class ServingEngine:
    def __init__(self, runner, clock: Optional[Clock] = None,
                 tracer=None, name: str = "engine0",
                 max_batch: int = DEFAULT_MAX_BATCH,
                 prefill_chunk_tokens: int = DEFAULT_PREFILL_CHUNK,
                 max_waiting: int = DEFAULT_MAX_WAITING,
                 profiler=None, recorder=None,
                 prefix_sharing: bool = True,
                 persistent_prefix: bool = False,
                 draft=None, spec_k: int = 0,
                 prefill_pool=None,
                 disagg_min_tokens: int = 0):
        self.runner = runner
        self.clock = clock or default_clock()
        #: copy-on-write prefix sharing over the paged pool (the
        #: no-sharing baseline cells pass False)
        self.prefix_sharing = bool(prefix_sharing)
        #: persistent prefix cache (ROADMAP 4a, docs/serving.md): the
        #: registry holds its own refcount on published blocks, so a
        #: shared system prompt survives quiescent gaps; cache blocks
        #: are evicted lowest-id first under pool pressure
        #: (kv_prefix_cache_evictions_total)
        self.persistent_prefix = bool(persistent_prefix) and \
            self.prefix_sharing
        #: speculative decoding: ``draft.propose(context, k)`` proposes
        #: up to ``spec_k`` tokens per sequence per step, verified in
        #: one fused target step with greedy-exact accept/reject
        self.draft = draft
        self.spec_k = max(0, int(spec_k)) if draft is not None else 0
        #: disaggregated prefill pool (serving/disagg.py): admitted
        #: prompts prefill on designated workers and ship pages back
        self.prefill_pool = prefill_pool
        #: prompts below this length prefill inline even with a pool —
        #: a short prompt costs less than a ship, and routing it to the
        #: pool would queue it behind the very long-prompt storms the
        #: pool exists to absorb (docs/serving-tuning.md)
        self.disagg_min_tokens = max(0, int(disagg_min_tokens))
        if prefill_pool is not None:
            prefill_pool.attach(self._on_pool_ready)
        #: span recorder (None disables tracing; only sequences that
        #: CARRY a sampled context record spans, so untraced serving
        #: pays nothing — same contract as the dispatcher)
        self.tracer = tracer
        #: tpfprof attribution (docs/profiling.md): decode/prefill
        #: device time + admission waits charged per tenant, paged-KV
        #: footprint stamped as the per-tenant HBM gauge — always-on,
        #: every sequence (None disables)
        self.profiler = profiler
        #: flight-recorder ring: one "engine" step summary per active
        #: step, the serving half of a postmortem bundle
        self.recorder = recorder
        #: per-block device bytes for the HBM gauge (0 when the runner
        #: has no physical pool, e.g. the twin's FakeRunner)
        self._block_nbytes = int(getattr(runner, "nbytes", 0)
                                 or 0) // max(int(getattr(
                                     runner, "num_blocks", 1)), 1)
        self.name = name
        self.max_batch = max(1, max_batch)
        self.prefill_chunk_tokens = max(1, prefill_chunk_tokens)
        self.max_waiting = max(1, max_waiting)
        self.account = BlockAccount(
            runner.num_blocks, runner.block_size,
            persistent_prefix=self.persistent_prefix)
        self._cv = threading.Condition()
        # guarded by: _cv
        self._waiting: List[Sequence] = []
        #: stepper-thread only (never touched by submit)
        self._running: List[Sequence] = []
        self._sids = itertools.count(1)
        self._thread: Optional[threading.Thread] = None
        # guarded by: _cv
        self._stopping = False
        #: MIGRATE_FREEZE hook (docs/migration.md): while frozen the
        #: stepper idles (step() is a no-op) so the pool's dirty set
        #: stays stable for the final migration round; submissions
        #: still queue and are served after thaw()
        # guarded by: _cv
        self._frozen = False
        #: a step is running (freeze() waits for it to end, so a freeze
        #: never lands inside a step or a lazy graph capture)
        # guarded by: _cv
        self._stepping = False
        #: sequences adopted from / handed to another engine by a
        #: streaming migration (snapshot counters)
        # guarded by: _cv
        self.migrated_in = 0
        # guarded by: _cv
        self.migrated_out = 0
        self._start_m = self.clock.monotonic()
        # -- counters (guarded by: _cv — snapshot() reads them from
        # other threads; the stepper writes them once per step) --------
        # guarded by: _cv
        self.submitted = 0
        # guarded by: _cv
        self.admitted = 0
        # guarded by: _cv
        self.retired = 0
        # guarded by: _cv
        self.shed = 0
        # guarded by: _cv
        self.busy_rejected = 0
        # guarded by: _cv
        self.preempted = 0
        # guarded by: _cv
        self.tokens_generated = 0
        # guarded by: _cv
        self.steps = 0
        # guarded by: _cv
        self.decode_steps = 0
        # guarded by: _cv
        self.prefill_chunks = 0
        # guarded by: _cv
        self._occupancy_sum = 0.0
        # guarded by: _cv
        self._tenants: Dict[str, _TenantStats] = {}
        # guarded by: _cv
        self._last_trace_id = ""
        #: pre-prefilled sequences awaiting KV ingest on the stepper
        #: (pool completions land here from the pool thread)
        # guarded by: _cv
        self._shipped_ready: List[Sequence] = []
        # -- spec-decode counters (stepper writes, snapshot reads) ------
        # guarded by: _cv
        self.spec_steps = 0
        # guarded by: _cv
        self.spec_proposed = 0
        # guarded by: _cv
        self.spec_accepted = 0
        # -- KV_SHIP ingest counters ------------------------------------
        # guarded by: _cv
        self.kv_ships = 0
        # guarded by: _cv
        self.kv_ship_blocks = 0
        # guarded by: _cv
        self.kv_ship_dedup_blocks = 0
        # guarded by: _cv
        self.kv_ship_bytes = 0
        #: step-duration reservoir -> the retry_after_ms drain estimate
        self.step_time = LatencyRecorder(maxlen=512)
        self.ttft = LatencyRecorder(maxlen=2048)

    # -- submission (any thread) ---------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int,
               tenant: str = "local", qos: Optional[str] = None,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               emit: Optional[Callable] = None,
               trace: Optional[dict] = None,
               _shipped: Optional[dict] = None) -> Sequence:
        """Enqueue one generation request.  Raises
        :class:`~..remoting.dispatch.BusyError` when the waiting queue
        is full (the worker maps it to the protocol ``BUSY`` code) and
        ``ValueError`` for requests that could never fit the pool."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        max_new_tokens = max(1, int(max_new_tokens))
        total = len(prompt) + max_new_tokens
        if total > self.account.seq_capacity_tokens():
            raise ValueError(
                f"request of {total} tokens exceeds the pool's "
                f"{self.account.seq_capacity_tokens()}-token sequence "
                f"capacity")
        now = self.clock.monotonic()
        deadline_m = None
        if deadline_ms is not None:
            deadline_m = now + float(deadline_ms) / 1e3
        seq = Sequence(next(self._sids), tenant,
                       qos or constants.DEFAULT_QOS, prompt,
                       max_new_tokens, eos_id, emit, trace, now,
                       deadline_m)
        if _shipped is not None:
            seq.shipped = dict(_shipped)
        with self._cv:
            if self._stopping:
                raise ConnectionError("engine stopping")
            if len(self._waiting) >= self.max_waiting:
                self.busy_rejected += 1
                raise BusyError("serving", len(self._waiting),
                                self._retry_after_ms_locked())
            self.submitted += 1
            self._waiting.append(seq)
            self._cv.notify_all()
        return seq

    def _retry_after_ms_locked(self) -> int:   # tpflint: holds=_cv
        """Drain estimate for BUSY replies: backlog x recent step time
        (same shape as the dispatcher's hint)."""
        per_step = self.step_time.mean_s() or 0.01
        backlog = len(self._waiting) + len(self._running)
        return int(min(max(backlog * per_step * 1e3, 5.0), 5000.0))

    def retry_after_ms(self) -> int:
        with self._cv:
            return self._retry_after_ms_locked()

    def submit_shipped(self, prompt: List[int], max_new_tokens: int,
                       payload: dict, tenant: str = "local",
                       qos: Optional[str] = None,
                       eos_id: Optional[int] = None,
                       deadline_ms: Optional[float] = None,
                       emit: Optional[Callable] = None,
                       trace: Optional[dict] = None) -> Sequence:
        """Enqueue a PRE-PREFILLED generation: the prompt's KV pages
        arrived with the request (the protocol-v6 ``KV_SHIP`` path —
        a prefill-tier worker computed them, docs/serving.md).
        ``payload``: ``{"keys": [per-block content keys], "k"/"v":
        [L, n, n_kv, bs, D] host arrays or None, "first_token",
        "n_tokens", "bytes"}``.  Admission (QoS ladder, BUSY
        backpressure, deadline shedding) is exactly :meth:`submit`'s;
        the pages are ingested — deduped against the prefix registry —
        instead of prefilled."""
        return self.submit(prompt, max_new_tokens, tenant=tenant,
                           qos=qos, eos_id=eos_id,
                           deadline_ms=deadline_ms, emit=emit,
                           trace=trace, _shipped=payload)

    def _on_pool_ready(self, seq: Sequence,
                       payload: Optional[dict]) -> None:
        """Prefill-pool completion (pool thread or inline pump): park
        the payload for the stepper to ingest.  ``payload=None`` means
        the pool could not hold the prompt — the sequence falls back
        to inline prefill on this engine's chunk budget."""
        seq.shipped = dict(payload) if payload is not None \
            else {"failed": True}
        with self._cv:
            self._shipped_ready.append(seq)
            self._cv.notify_all()

    def _ingest_shipped(self, events: List[tuple],
                        now: float) -> bool:
        """Write ONE parked shipped payload into the decode pool per
        step: blocks whose content key is already registered are
        ADOPTED (the shared prefix is counted once — the dedup the ≥5x
        prefix cell asserts), the rest allocate fresh blocks and take
        the shipped pages.  One ingest per step bounds how much page-
        writing a storm of simultaneous ships can inject between two
        decode steps — the decode-p99-stays-flat half of the disagg
        contract."""
        seq = None
        with self._cv:
            if self._shipped_ready:
                seq = self._shipped_ready.pop(0)
        if seq is None:
            return False
        if seq.state != PREFILL or seq not in self._running:
            return True         # preempted/retired while shipping
        self._activate_shipped(seq, events, now)
        return True

    def _activate_shipped(self, seq: Sequence, events: List[tuple],
                          now: float) -> bool:
        payload = seq.shipped
        if payload.get("failed"):
            # pool could not hold the prompt: fall back to this
            # engine's inline chunked prefill (allocate its table the
            # way admission would have)
            seq.shipped = None
            seq.disagg = False
            seq.prefill_pos = 0
            if not self.account.ensure(seq.sid,
                                       seq.context_len() + 1):
                self._preempt(seq)
            return True
        keys = payload.get("keys") or []
        n_tokens = int(payload["n_tokens"])
        write_ids: List[int] = []
        write_idx: List[int] = []
        dedup = 0
        ok = True
        for i, key in enumerate(keys):
            blk = (self.account.adopt_block(seq.sid, key)
                   if self.prefix_sharing and key else None)
            if blk is not None:
                dedup += 1
                continue
            blk = self.account.append_block(seq.sid)
            if blk is None:
                ok = False
                break
            write_ids.append(blk)
            write_idx.append(i)
        if not ok:
            # pool exhausted mid-ingest: put the sequence back in the
            # waiting queue with its payload intact and retry when the
            # pool breathes (all-or-nothing, like ensure)
            self._preempt(seq)
            return False
        if write_ids and payload.get("k") is not None:
            self.runner.write_blocks(
                write_ids,
                payload["k"][:, write_idx],
                payload["v"][:, write_idx])
        if self.prefix_sharing:
            for i, key in enumerate(keys):
                if key:
                    self.account.publish(seq.sid, i, key)
        seq.prefill_pos = n_tokens
        seq.shipped = None
        seq.state = ACTIVE
        nbytes = int(payload.get("bytes") or 0)
        with self._cv:
            self.kv_ships += 1
            self.kv_ship_blocks += len(write_ids)
            self.kv_ship_dedup_blocks += dedup
            self.kv_ship_bytes += nbytes
        self._ship_span(seq, now, len(write_ids), dedup, nbytes)
        first = payload.get("first_token")
        if not seq.tokens and first is not None:
            ttft_s = self.clock.monotonic() - seq.arrival_m
            seq.ttft_ms = round(ttft_s * 1e3, 3)
            self.ttft.observe(ttft_s)
            with self._cv:
                st = self._tenants.setdefault(seq.tenant,
                                              _TenantStats(seq.qos))
            st.ttft.observe(ttft_s)
            seq.tokens.append(int(first))
            self._maybe_finish(seq, events)
        return True

    # -- engine thread --------------------------------------------------

    def start(self) -> None:
        """Run the stepper on a dedicated thread (worker topology).  A
        sim or bench loop calls :meth:`step` directly instead."""
        if self._thread is not None:
            return
        with self._cv:
            self._stopping = False
        self._thread = threading.Thread(target=self._loop,
                                        name="tpf-serving-engine",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while True:
            with self._cv:
                if self._stopping:
                    return
            if not self.step():
                with self._cv:
                    if self._stopping:
                        return
                    self._cv.wait(timeout=0.05)

    # -- the step --------------------------------------------------------

    def step(self) -> bool:
        """One scheduling round: shed expired, admit, prefill chunks,
        one fused decode step, retire.  Returns False when there was
        nothing to do.  Single-stepper only."""
        with self._cv:
            if self._frozen:
                return False    # MIGRATE_FREEZE: the tenant is dark
            self._stepping = True
        try:
            return self._step()
        finally:
            with self._cv:
                self._stepping = False
                self._cv.notify_all()

    def _step(self) -> bool:
        now = self.clock.monotonic()
        events: List[tuple] = []       # (seq, new_tokens, done, info)
        shed, admitted_seqs = self._admit_locked_phase(now, events)
        did = bool(shed or admitted_seqs)

        # -- disaggregated prefill: pump the pool (inline pools advance
        # one chunk per engine step — deterministic under SimClock) and
        # ingest finished KV payloads into the decode pool ----------------
        if self.prefill_pool is not None:
            did = self.prefill_pool.pump() or did
        did = self._ingest_shipped(events, now) or did

        # -- prefill chunks (interleaved with decode; disaggregated
        # sequences prefill on the pool, never against this budget) -------
        budget = self.prefill_chunk_tokens
        chunks = 0
        for seq in list(self._running):
            if budget <= 0:
                break
            if seq.state != PREFILL or seq.disagg:
                continue
            chunks += 1
            budget -= self._prefill_chunk(seq, events)
        did = did or chunks > 0

        # -- one fused decode step ----------------------------------------
        batch = [s for s in self._running if s.state == ACTIVE]
        decoded = 0
        spec = self.draft is not None and self.spec_k > 0
        if batch:
            did = True
            batch = self._grow_or_preempt(
                batch, events, extra=self.spec_k if spec else 0)
        if batch and spec:
            decoded = self._spec_decode(batch, events)
        elif batch:
            t0 = self.clock.monotonic()
            tokens = [s.tokens[-1] for s in batch]
            positions = [s.context_len() - 1 for s in batch]
            tables = [self.account.table(s.sid) for s in batch]
            nxt = self.runner.decode(tokens, positions, tables)
            self._step_span(batch, t0)
            if self.profiler is not None:
                # one fused launch: its device time splits evenly
                # across the batch members (identical per-row cost)
                dur = self.clock.monotonic() - t0
                for s in batch:
                    self.profiler.attribute(s.tenant, "compute",
                                            dur / len(batch),
                                            qos=s.qos)
            decoded = len(batch)
            for seq, tok in zip(batch, nxt):
                seq.tokens.append(int(tok))
                self._maybe_finish(seq, events)

        # -- book-keeping under the lock ----------------------------------
        retired = [s for s, _, done, info in events
                   if done and info.get("finish_reason")]
        with self._cv:
            self.steps += 1
            self.prefill_chunks += chunks
            if decoded:
                self.decode_steps += 1
                self._occupancy_sum += decoded / self.max_batch
            for seq, toks, done, info in events:
                # every generated token appears in exactly one event
                # (incl. the prefill-produced first token), so this is
                # the engine-level tokens_total
                self.tokens_generated += len(toks)
                st = self._tenants.setdefault(seq.tenant,
                                              _TenantStats(seq.qos))
                st.tokens += len(toks)
                if seq.trace:
                    st.last_trace_id = str(
                        seq.trace.get("trace_id", ""))
                    self._last_trace_id = st.last_trace_id
            self.retired += sum(
                1 for s in retired if s.finish_reason != FINISH_SHED)
            waiting_n = len(self._waiting)
            steps_n = self.steps
            self._cv.notify_all()
        if did and self.profiler is not None:
            # per-tenant paged-KV footprint gauge: the sum of each
            # tenant's live block tables, in device bytes (0 under the
            # twin's storage-free FakeRunner — counts still attribute)
            hbm: Dict[str, int] = {}
            for s in self._running:
                hbm[s.tenant] = hbm.get(s.tenant, 0) + \
                    len(self.account.table(s.sid)) * self._block_nbytes
            for tenant, nbytes in sorted(hbm.items()):
                self.profiler.set_hbm(tenant, nbytes)
        if did and self.recorder is not None:
            self.recorder.note(
                "engine", "step", step=steps_n,
                admitted=len(admitted_seqs), shed=len(shed),
                prefill_chunks=chunks, decoded=decoded,
                retired=len(retired), waiting=waiting_n,
                active=len(self._running))
        if did:
            self.step_time.observe(self.clock.monotonic() - now)

        # -- callbacks, outside every lock --------------------------------
        for seq, toks, done, info in events:
            if seq.emit is not None:
                seq.emit(seq, toks, done, info)
        return did

    # -- streaming migration (docs/migration.md) --------------------------

    def freeze(self) -> None:
        """Pause the stepper (MIGRATE_FREEZE): step() becomes a no-op,
        so no decode write can dirty the pool while the final
        migration round ships.  Submissions still queue — the pause is
        bounded by the final delta, not by arrivals.  From another
        thread than the stepper's it returns once the step in flight has
        ended (TimeoutError after :data:`FREEZE_WAIT_S`), so no token is
        emitted after it and no graph capture is cut short."""
        deadline = time.monotonic() + FREEZE_WAIT_S
        with self._cv:
            self._frozen = True
            self._cv.notify_all()
            if threading.current_thread() is self._thread:
                return
            while self._stepping:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"engine step still running after "
                                       f"{FREEZE_WAIT_S:.0f}s")
                self._cv.wait(timeout=remaining)

    def thaw(self) -> None:
        with self._cv:
            self._frozen = False
            self._cv.notify_all()

    @property
    def frozen(self) -> bool:
        with self._cv:
            return self._frozen

    def export_sequences(self) -> List[Sequence]:
        """Drain every live sequence for migration to another engine:
        running sequences give their blocks back to the pool (their
        generated prefix stays on the Sequence — re-prefill covers
        prompt + generated, the preemption re-admission discipline),
        then the untouched waiting queue follows.  The engine is left
        empty; callers :meth:`freeze` first so no step races the
        export.  Runs on the stepper's thread (or any thread while
        frozen)."""
        moved: List[Sequence] = []
        for seq in list(self._running):
            self.account.release(seq.sid)
            seq.state = WAITING
            seq.prefill_pos = 0
            # shipped payloads / disagg routing are source-engine
            # state; the target re-prefills inline
            seq.shipped = None
            seq.disagg = False
            self._running.remove(seq)
            moved.append(seq)
        with self._cv:
            waiting, self._waiting = self._waiting, []
            out = moved + waiting
            self.migrated_out += len(out)
            self._cv.notify_all()
        return out

    def import_sequences(self, seqs: List[Sequence]) -> int:
        """Adopt migrated sequences: each re-enters this engine's
        waiting queue under a FRESH sid (block-table owner keys are
        per-engine) and re-prefills its full prefix on admission —
        greedy decode is position-deterministic, so the regenerated
        suffix is token-identical to an unmigrated run.  The queue cap
        deliberately does not apply: a migration must never drop a
        live request (``max_waiting`` bounds *new* admissions only)."""
        n = 0
        with self._cv:
            for seq in seqs:
                seq.sid = next(self._sids)
                seq.state = WAITING
                seq.prefill_pos = 0
                seq.prefix_matched = 0
                self._waiting.append(seq)
                self.submitted += 1
                self.migrated_in += 1
                n += 1
            self._cv.notify_all()
        return n

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Block until nothing is waiting or running (callers that
        submitted with callbacks use this as their quiescence barrier).
        Only meaningful while the engine thread runs."""
        deadline = self.clock.monotonic() + timeout_s
        with self._cv:
            while self._waiting or self._running:
                if self.clock.monotonic() >= deadline:
                    return False
                self._cv.wait(timeout=0.1)
        return True

    # -- step phases ------------------------------------------------------

    def _admit_locked_phase(self, now: float, events: List[tuple]):
        """Shed expired waiters, then admit by QoS weight while the
        pool and the batch have room."""
        with self._cv:
            shed = [s for s in self._waiting
                    if s.deadline_m is not None and now > s.deadline_m]
            for seq in shed:
                self._waiting.remove(seq)
                self.shed += 1
            # highest weight first, FIFO (arrival, sid) within a class
            self._waiting.sort(key=lambda s: (-s.weight, s.arrival_m,
                                              s.sid))
            admitted: List[Sequence] = []
            for seq in list(self._waiting):
                if len(self._running) + len(admitted) >= self.max_batch:
                    break
                if seq.shipped is not None or (
                        self.prefill_pool is not None and
                        seq.context_len() >= self.disagg_min_tokens):
                    # disaggregated path: blocks materialize at KV
                    # ingest (deduped against the registry there), so
                    # admission only soft-checks headroom
                    if not self.account.can_fit(seq.context_len() + 1):
                        continue
                    seq.disagg = True
                    seq.prefix_matched = 0
                else:
                    # room for the whole prompt plus the first
                    # generated token, minus whatever the prefix
                    # registry already holds; growth past that is
                    # preemption's problem
                    mblocks, mtokens = (
                        self.account.peek_match(self._seq_keys(seq))
                        if self.prefix_sharing else (0, 0))
                    need = self.account.blocks_for(
                        seq.context_len() + 1) - mblocks
                    if need > self.account.free_blocks:
                        continue
                    if mblocks:
                        mtokens = self.account.adopt(
                            seq.sid, self._seq_keys(seq))
                    seq.prefix_matched = mtokens
                    # a preempted disagg/shipped sequence re-prefills
                    # inline when no pool serves this engine
                    seq.disagg = False
                    self.account.ensure(seq.sid, seq.context_len() + 1)
                self._waiting.remove(seq)
                admitted.append(seq)
            for seq in admitted:
                self.admitted += 1
                st = self._tenants.setdefault(seq.tenant,
                                              _TenantStats(seq.qos))
                wait_ms = (now - seq.arrival_m) * 1e3
                slo_ms = constants.QOS_QUEUE_WAIT_SLO_MS.get(seq.qos,
                                                             500.0)
                st.slo_total += 1
                if wait_ms <= slo_ms:
                    st.slo_good += 1
                st.prefix_hit_tokens += seq.prefix_matched
                if seq.prefix_matched and seq.trace:
                    st.last_prefix_trace_id = str(
                        seq.trace.get("trace_id", ""))
            for seq in shed:
                st = self._tenants.setdefault(seq.tenant,
                                              _TenantStats(seq.qos))
                st.slo_total += 1
        for seq in shed:
            seq.state = DONE
            seq.finish_reason = FINISH_SHED
            waited = int((now - seq.arrival_m) * 1e3)
            events.append((seq, [], True, {
                "code": "DEADLINE_EXCEEDED",
                "error": f"deadline exceeded after {waited}ms waiting "
                         f"for admission",
                "queue_wait_ms": waited,
                "finish_reason": FINISH_SHED}))
        for seq in admitted:
            seq.state = PREFILL
            seq.admitted_m = now
            # a full-prompt registry hit still recomputes the last
            # position (its logits seed the first token); the rewrite
            # CoWs the shared tail block
            seq.prefill_pos = min(seq.prefix_matched,
                                  seq.context_len() - 1)
            self._running.append(seq)
            self._admit_span(seq, now)
            if seq.prefix_matched:
                self._prefix_span(seq, now)
            if seq.disagg:
                if seq.shipped is not None:
                    # KV arrived with the request (wire KV_SHIP):
                    # ingest on this very step
                    with self._cv:
                        self._shipped_ready.append(seq)
                else:
                    self.prefill_pool.submit(seq, seq.context())
            if self.profiler is not None:
                self.profiler.attribute(seq.tenant, "queue",
                                        now - seq.arrival_m,
                                        qos=seq.qos, end_m=now)
        if self.profiler is not None:
            for seq in shed:
                # a shed sequence spent its whole life waiting: that
                # wait is queue time it was charged for, never served
                self.profiler.attribute(seq.tenant, "queue",
                                        now - seq.arrival_m,
                                        qos=seq.qos, end_m=now)
        return shed, admitted

    def _seq_keys(self, seq: Sequence) -> List[Tuple[int, int]]:
        """Per-block content keys of the sequence's PROMPT (generated
        tokens are never matched at admission — the registry serves
        shared system prompts, not shared continuations)."""
        if seq.block_keys is None:
            seq.block_keys = prompt_block_keys(seq.prompt,
                                               self.account.block_size)
        return seq.block_keys

    def _secure_writes(self, seq: Sequence, lo_pos: int,
                       hi_pos: int) -> Optional[List[Tuple[int, int]]]:
        """Make every block covering positions ``[lo_pos, hi_pos]``
        writable for ``seq`` (copy-on-write where shared).  Returns the
        ``(src, dst)`` page copies the runner must perform before the
        write, or None when a CoW copy could not be allocated."""
        bs = self.account.block_size
        pairs: List[Tuple[int, int]] = []
        for bi in range(lo_pos // bs, hi_pos // bs + 1):
            w = self.account.writable(seq.sid, bi)
            if w is None:
                return None
            blk, src = w
            if src is not None:
                pairs.append((src, blk))
        return pairs

    def _publish_prompt_blocks(self, seq: Sequence,
                               new_pos: int) -> None:
        """Register every prompt block whose content is now fully
        prefilled (first-come wins; adopted/CoW-source blocks are
        already registered and no-op)."""
        if not self.prefix_sharing:
            return
        for bi, (key, covered) in enumerate(self._seq_keys(seq)):
            if covered > new_pos:
                break
            self.account.publish(seq.sid, bi, key)

    def _prefill_chunk(self, seq: Sequence, events: List[tuple]) -> int:
        """Advance one sequence's prefill by one chunk; on completion
        the first generated token appears (TTFT)."""
        ctx = seq.context()
        chunk = min(self.prefill_chunk_tokens,
                    len(ctx) - seq.prefill_pos)
        pairs = self._secure_writes(seq, seq.prefill_pos,
                                    seq.prefill_pos + chunk - 1)
        if pairs is None:
            # the CoW copy this chunk needs cannot be allocated: yield
            # this sequence's pages and retry when the pool breathes
            self._preempt(seq)
            return 0
        if pairs:
            self.runner.copy_blocks(pairs)
        last = seq.prefill_pos + chunk >= len(ctx)
        t0 = self.clock.monotonic()
        nxt = self.runner.prefill(
            ctx[seq.prefill_pos:seq.prefill_pos + chunk],
            self.account.table(seq.sid), seq.prefill_pos, last=last)
        self._publish_prompt_blocks(seq, seq.prefill_pos + chunk)
        self._prefill_span(seq, t0, chunk)
        if self.profiler is not None:
            self.profiler.attribute(seq.tenant, "compute",
                                    self.clock.monotonic() - t0,
                                    qos=seq.qos)
        seq.prefill_pos += chunk
        if last:
            seq.state = ACTIVE
            if not seq.tokens:
                # first generation for this sequence: TTFT
                ttft_s = self.clock.monotonic() - seq.arrival_m
                seq.ttft_ms = round(ttft_s * 1e3, 3)
                self.ttft.observe(ttft_s)
                with self._cv:
                    st = self._tenants.setdefault(
                        seq.tenant, _TenantStats(seq.qos))
                st.ttft.observe(ttft_s)
                seq.tokens.append(int(nxt))
                self._maybe_finish(seq, events)
            # a re-prefilled (preempted) sequence already holds its
            # generated tokens; the recomputed pages end exactly where
            # decode left off, so nxt is the token decode would emit —
            # but it is NOT appended here: the next fused decode step
            # regenerates it (position-deterministic), keeping the
            # emit stream strictly ordered
        return chunk

    def _spec_decode(self, batch: List[Sequence],
                     events: List[tuple]) -> int:
        """One speculative round: the draft proposes up to ``spec_k``
        tokens per sequence, ONE fused target verify step scores every
        proposal, and greedy-exact accept/reject appends the longest
        agreeing prefix plus the target's own token at the first
        mismatch — so the emitted stream is identical to plain greedy
        decode whatever the draft does.  Rejected positions roll the
        block table back (:meth:`~.kvpool.BlockAccount.truncate`);
        their stale KV is overwritten by the step that next reaches
        those positions, and the ``index <= pos`` mask hides it until
        then."""
        k = self.spec_k
        td = self.clock.monotonic()
        proposals = []
        for s in batch:
            if s.spec_skip:
                s.spec_skip = False
                proposals.append([])
                continue
            proposals.append(
                [int(t) for t in (self.draft.propose(s.context(), k)
                                  or ())][:k])
        draft_dur = self.clock.monotonic() - td
        if self.profiler is not None:
            # draft compute belongs to the tenant being served — there
            # is no phantom "draft" tenant in the attribution ledger
            for s in batch:
                self.profiler.attribute(s.tenant, "compute",
                                        draft_dur / len(batch),
                                        qos=s.qos)
        width = max(len(p) for p in proposals) + 1
        t0 = self.clock.monotonic()
        if width == 1:
            # draft had nothing anywhere this round: plain fused decode
            outs = [[int(t)] for t in self.runner.decode(
                [s.tokens[-1] for s in batch],
                [s.context_len() - 1 for s in batch],
                [self.account.table(s.sid) for s in batch])]
        else:
            # ONE fused verify launch for the whole batch; rows with
            # fewer (or cooled-down) proposals pad to the width — a
            # verify row costs barely more than a decode row, so one
            # launch beats splitting the batch across two
            rows = [[s.tokens[-1]] + p + [0] * (width - 1 - len(p))
                    for s, p in zip(batch, proposals)]
            outs = self.runner.verify(
                rows, [s.context_len() - 1 for s in batch],
                [self.account.table(s.sid) for s in batch])
        dur = self.clock.monotonic() - t0
        if self.profiler is not None:
            for s in batch:
                self.profiler.attribute(s.tenant, "compute",
                                        dur / len(batch), qos=s.qos)
        proposed_round = 0
        accepted_round = 0
        for seq, prop, out in zip(batch, proposals, outs):
            j = 0
            while j < len(prop) and out[j] == prop[j]:
                j += 1
            seq.spec_skip = bool(prop) and j == 0
            acc = [int(t) for t in out[:j + 1]]
            # plain greedy would have stopped at EOS / max_new_tokens:
            # trim the speculative surplus so the stream stays EXACT
            if seq.eos_id is not None and seq.eos_id in acc:
                acc = acc[:acc.index(seq.eos_id) + 1]
            acc = acc[:seq.max_new_tokens - len(seq.tokens)]
            seq.tokens.extend(acc)
            self._spec_span(seq, t0, dur, len(prop), j, len(batch))
            proposed_round += len(prop)
            accepted_round += j
            with self._cv:
                st = self._tenants.setdefault(seq.tenant,
                                              _TenantStats(seq.qos))
                st.spec_proposed += len(prop)
                st.spec_accepted += j
                if seq.trace:
                    st.last_spec_trace_id = str(
                        seq.trace.get("trace_id", ""))
            # rejected speculative positions: roll the block-table
            # high-water mark back to the accepted context
            self.account.truncate(seq.sid, seq.context_len())
            self._maybe_finish(seq, events)
        with self._cv:
            self.spec_steps += 1
            self.spec_proposed += proposed_round
            self.spec_accepted += accepted_round
        return len(batch)

    def _grow_or_preempt(self, batch: List[Sequence],
                         events: List[tuple],
                         extra: int = 0) -> List[Sequence]:
        """Every batch member needs pages for its next token (plus
        ``extra`` speculative positions) AND write access to the blocks
        those positions land in (copy-on-write when shared); when the
        pool is exhausted, the lowest-weight most-recent member is
        evicted back to the waiting queue until the rest fit.  Members
        are secured highest weight first, so victims always come from
        the lower tiers — the QoS promise under memory pressure."""
        kept: List[Sequence] = []
        cow: List[Tuple[int, int]] = []
        for seq in sorted(batch, key=lambda s: (-s.weight, s.arrival_m,
                                                s.sid)):
            if seq.state != ACTIVE:
                continue            # already evicted as a victim below
            while seq.state == ACTIVE:
                need = seq.context_len() + (extra if extra
                                            else 1)
                pairs = None
                if self.account.ensure(seq.sid, need):
                    # writes land at context-1 .. context-1+extra
                    pairs = self._secure_writes(
                        seq, seq.context_len() - 1,
                        seq.context_len() - 1 + extra)
                if pairs is not None:
                    cow.extend(pairs)
                    kept.append(seq)
                    break
                victims = [s for s in batch
                           if s is not seq and s.state == ACTIVE
                           and s not in kept]
                if not victims:
                    # nothing left to evict but higher-priority kept
                    # members: this sequence yields its own pages and
                    # re-admits when the pool breathes (submit()
                    # guaranteed it fits an empty pool)
                    self._preempt(seq)
                    break
                self._preempt(min(victims,
                                  key=lambda s: (s.weight, -s.arrival_m,
                                                 -s.sid)))
        if cow:
            self.runner.copy_blocks(cow)
        # original batch order keeps the fused step deterministic
        return [s for s in batch if s in kept]

    def _preempt(self, victim: Sequence) -> None:
        self.account.release(victim.sid, evicted=True)
        victim.state = WAITING
        victim.prefill_pos = 0
        victim.preemptions += 1
        if victim in self._running:
            self._running.remove(victim)
        with self._cv:
            self.preempted += 1
            self._waiting.append(victim)

    def _maybe_finish(self, seq: Sequence, events: List[tuple]) -> None:
        new = seq.tokens[seq.emitted:]
        done = False
        if seq.eos_id is not None and seq.tokens and \
                seq.tokens[-1] == seq.eos_id:
            done, seq.finish_reason = True, FINISH_EOS
        elif len(seq.tokens) >= seq.max_new_tokens:
            done, seq.finish_reason = True, FINISH_LENGTH
        seq.emitted = len(seq.tokens)
        if done:
            seq.state = DONE
            self._running.remove(seq)
            self.account.release(seq.sid)
            events.append((seq, new, True,
                           {"finish_reason": seq.finish_reason}))
        elif new:
            events.append((seq, new, False, {}))

    # -- spans ------------------------------------------------------------

    def _admit_span(self, seq: Sequence, now: float) -> None:
        """serving.admit: exactly the admission wait the SLO rollup
        judged, so per-trace attribution and the metric agree."""
        if self.tracer is None or not seq.trace:
            return
        end = self.tracer.clock.now()
        wait_s = now - seq.arrival_m
        d = self.tracer.record_span(
            "serving.admit", end - wait_s, end, parent=seq.trace,
            attrs={"tenant": seq.tenant, "qos": seq.qos,
                   "wait_ms": round(wait_s * 1e3, 3),
                   "prompt_tokens": len(seq.prompt)})
        if d is not None:
            seq.trace_spans.append(d)

    def _prefill_span(self, seq: Sequence, t0: float,
                      tokens: int) -> None:
        if self.tracer is None or not seq.trace:
            return
        end = self.tracer.clock.now()
        d = self.tracer.record_span(
            "serving.prefill_chunk",
            end - (self.clock.monotonic() - t0), end, parent=seq.trace,
            attrs={"tenant": seq.tenant, "tokens": tokens,
                   "pos": seq.prefill_pos})
        if d is not None:
            seq.trace_spans.append(d)

    def _step_span(self, batch: List[Sequence], t0: float) -> None:
        """serving.step: one fused decode launch, recorded against
        every traced member (they share the timing, like a fused
        dispatcher launch)."""
        if self.tracer is None:
            return
        end = self.tracer.clock.now()
        dur = self.clock.monotonic() - t0
        for seq in batch:
            if not seq.trace:
                continue
            d = self.tracer.record_span(
                "serving.step", end - dur, end, parent=seq.trace,
                attrs={"batch": len(batch),
                       "tokens": len(seq.tokens) + 1})
            if d is not None:
                seq.trace_spans.append(d)

    def _prefix_span(self, seq: Sequence, now: float) -> None:
        """serving.prefix_match: prompt tokens the block registry
        served at admission (zero-cost prefill)."""
        if self.tracer is None or not seq.trace:
            return
        end = self.tracer.clock.now()
        d = self.tracer.record_span(
            "serving.prefix_match", end, end, parent=seq.trace,
            attrs={"tenant": seq.tenant,
                   "matched_tokens": seq.prefix_matched,
                   "prompt_tokens": len(seq.prompt)})
        if d is not None:
            seq.trace_spans.append(d)

    def _ship_span(self, seq: Sequence, t0: float, blocks: int,
                   shared: int, nbytes: int) -> None:
        """serving.kv_ship: one shipped-KV ingest — fresh pages written
        vs blocks deduped onto the registry."""
        if self.tracer is None or not seq.trace:
            return
        end = self.tracer.clock.now()
        dur = self.clock.monotonic() - t0
        d = self.tracer.record_span(
            "serving.kv_ship", end - dur, end, parent=seq.trace,
            attrs={"tenant": seq.tenant, "blocks": blocks,
                   "shared": shared, "bytes": nbytes})
        if d is not None:
            seq.trace_spans.append(d)

    def _spec_span(self, seq: Sequence, t0: float, dur: float,
                   proposed: int, accepted: int, batch: int) -> None:
        """serving.spec_verify: one fused verify launch, recorded
        against every traced member like serving.step."""
        if self.tracer is None or not seq.trace:
            return
        end = self.tracer.clock.now()
        d = self.tracer.record_span(
            "serving.spec_verify", end - dur, end, parent=seq.trace,
            attrs={"batch": batch, "k": proposed,
                   "accepted": accepted})
        if d is not None:
            seq.trace_spans.append(d)

    # -- observability ----------------------------------------------------

    def snapshot(self) -> dict:
        """Stats for INFO replies and the tpf_serving_* metrics lines."""
        acct = self.account.snapshot()
        elapsed = max(self.clock.monotonic() - self._start_m, 1e-9)
        with self._cv:
            occupancy = (100.0 * self._occupancy_sum / self.decode_steps
                         if self.decode_steps else 0.0)
            tenants = {
                name: {"qos": st.qos, "tokens": st.tokens,
                       "ttft": st.ttft.snapshot(),
                       "slo_good": st.slo_good,
                       "slo_total": st.slo_total,
                       "slo_ms": constants.QOS_QUEUE_WAIT_SLO_MS.get(
                           st.qos, 500.0),
                       "prefix_hit_tokens": st.prefix_hit_tokens,
                       "spec_proposed": st.spec_proposed,
                       "spec_accepted": st.spec_accepted,
                       "spec_accept_rate": round(
                           st.spec_accepted / st.spec_proposed, 6)
                       if st.spec_proposed else 0.0,
                       "last_trace_id": st.last_trace_id,
                       "last_prefix_trace_id": st.last_prefix_trace_id,
                       "last_spec_trace_id": st.last_spec_trace_id}
                for name, st in self._tenants.items()}
            spec = {
                "k": self.spec_k,
                "steps": self.spec_steps,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "accept_rate": round(
                    self.spec_accepted / self.spec_proposed, 6)
                if self.spec_proposed else 0.0,
            }
            ship = {
                "ships": self.kv_ships,
                "blocks": self.kv_ship_blocks,
                "dedup_blocks": self.kv_ship_dedup_blocks,
                "bytes": self.kv_ship_bytes,
            }
            return {
                "name": self.name,
                "max_batch": self.max_batch,
                "prefill_chunk_tokens": self.prefill_chunk_tokens,
                "waiting": len(self._waiting),
                "active": len(self._running),
                "submitted": self.submitted,
                "admitted": self.admitted,
                "retired": self.retired,
                "shed": self.shed,
                "busy_rejected": self.busy_rejected,
                "preempted": self.preempted,
                "frozen": int(self._frozen),
                "migrated_in": self.migrated_in,
                "migrated_out": self.migrated_out,
                "tokens": self.tokens_generated,
                "tokens_per_s": round(self.tokens_generated / elapsed,
                                      3),
                "steps": self.steps,
                "decode_steps": self.decode_steps,
                "prefill_chunks": self.prefill_chunks,
                "batch_occupancy_pct": round(occupancy, 3),
                "ttft": self.ttft.snapshot(),
                "kv": acct,
                "prefix_sharing": self.prefix_sharing,
                "spec": spec,
                "kv_ship": ship,
                "disagg": self.prefill_pool is not None,
                "last_trace_id": self._last_trace_id,
                "tenants": tenants,
            }
