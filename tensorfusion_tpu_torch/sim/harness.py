"""SimHarness: the cluster digital twin's event loop.

The port's copy of ``tensorfusion_tpu/sim/harness.py``.

Runs the REAL control plane — the same :class:`~tensorfusion_tpu_torch.
operator.Operator` wiring production uses (store, cache, allocator,
scheduler, gang manager, all controllers) — against simulated time:

- no controller/scheduler/sync **threads**: the harness owns one
  conflated watch per controller and *steps* them cooperatively
  (``pump``), exactly the event-driven delivery the threaded runtime
  provides, minus the nondeterministic interleaving;
- periodic behavior (controller resyncs, the allocator sync pass,
  metrics passes, leader-elector ticks) becomes :class:`SimClock`
  timers;
- every store event is appended to a deterministic **event log**
  (``(sim_time, etype, kind, key, node)`` tuples) — two runs from the
  same seed produce identical logs (``log_digest()``), which is the
  contract the determinism tests assert;
- **fault injection** (:mod:`tensorfusion_tpu_torch.sim.faults`) schedules
  seed-reproducible failures against the same timeline;
- **invariant checks** (no lost pods, no over-allocation, no leaked
  allocations, convergence) read the real store/allocator state.

See docs/simulation.md for the who-steps-whom contract and how to add
a scenario.
"""

from __future__ import annotations

import hashlib
import logging
import random
from typing import Dict, List, Optional, Tuple

from .. import constants
from ..api.types import Node, Pod, TPUChip, TPUWorkload
from ..clock import set_default_clock
from ..operator import Operator
from ..profiling.profiler import Profiler
from ..profiling.recorder import FlightRecorder
from ..store import ObjectStore
from .clock import SimClock

log = logging.getLogger("tpf.sim")

#: pump gives up after this many event-cascade rounds without quiescing
#: (a controller feeding itself events forever is itself a bug worth
#: loud failure, not an infinite sim)
PUMP_MAX_ROUNDS = 500

#: Determinism roots for tpflint's sim-nondeterminism checker: fnmatch
#: patterns over module-qualified names.  Everything the call graph can
#: reach from these must be seed-deterministic — log/trace/profile
#: digests replay byte-for-byte from a seed, so unseeded randomness,
#: wall-clock reads into recorded state, and set-iteration order leaks
#: anywhere downstream of these entry points are lint failures, not
#: style nits.  Extending the sim surface?  Add the new entry point
#: here so the checker walks it.
SIM_ENTRY_POINTS = (
    "tensorfusion_tpu_torch.sim.harness.SimHarness.*",
    "tensorfusion_tpu_torch.sim.scenarios.*",
)


class SimHarness:
    def __init__(self, seed: int = 0, sync_interval_s: float = 2.0,
                 metrics_interval_s: float = 0.0,
                 operator_kwargs: Optional[dict] = None,
                 shards: int = 1,
                 persist_dir: Optional[str] = None):
        self.seed = seed
        self.rng = random.Random(seed)
        self.clock = SimClock()
        # module-level stampers (Resource.new, set_condition) must see
        # sim time too; restored in stop()
        self._restore_clock = set_default_clock(self.clock)
        self.shards = max(int(shards), 1)
        self.sync_interval_s = sync_interval_s
        self.persist_dir = persist_dir
        kwargs = dict(enable_expander=False)
        kwargs.update(operator_kwargs or {})
        self._operator_kwargs = kwargs
        if self.shards > 1:
            # sharded control plane (docs/control-plane-scale.md): the
            # twin builds the N partitions itself and steps one owning
            # operator per shard; self.store is the cross-shard router
            from ..shardedstore import ShardedStore

            stores = []
            for i in range(self.shards):
                sub = None
                if persist_dir:
                    import os as _os

                    sub = _os.path.join(persist_dir, f"shard-{i:02d}")
                # tpflint: disable=shard-routing -- the twin constructs the shard partitions the router fronts
                stores.append(ObjectStore(persist_dir=sub))
            self.store = ShardedStore(shards=stores)
            self.ops = [Operator(store=s, clock=self.clock,
                                 sync_interval_s=sync_interval_s,
                                 shard=i, **kwargs)
                        for i, s in enumerate(stores)]
        else:
            # tpflint: disable=shard-routing -- the twin's single-shard store (shard 0 of a 1-shard cell)
            self.store = ObjectStore(persist_dir=persist_dir)
            self.ops = [Operator(store=self.store, clock=self.clock,
                                 sync_interval_s=sync_interval_s,
                                 **kwargs)]
        self.op = self.ops[0]
        #: shards whose owner is currently dead (failover scenarios):
        #: their watches/timers are skipped until a successor is
        #: installed + started
        self.dead_shards: set = set()
        self.metrics_interval_s = metrics_interval_s
        #: tpfprof attribution in VIRTUAL time (docs/profiling.md):
        #: reconcile/scheduler activity charged per component.  Under
        #: SimClock reconcile durations are zero-width, so the digest
        #: fingerprints *which components ran, when, how often* — the
        #: third determinism fingerprint next to log/trace digests.
        #: One ledger per shard owner; sharded ledgers carry the shard
        #: tag end-to-end (tpf_prof_* opt tag, tpfprof top, TUI pane).
        self.profilers = [
            Profiler(name="control-plane" if self.shards == 1
                     else f"control-plane-s{i}",
                     clock=self.clock, bin_s=1.0,
                     shard="" if self.shards == 1 else str(i))
            for i in range(self.shards)]
        self.profiler = self.profilers[0]
        #: always-on flight recorder: recent store events + invariant
        #: trips, frozen into a deterministic postmortem bundle when a
        #: scenario fails (scenarios.py / sim_scenarios.py)
        self.recorder = FlightRecorder(
            clock=self.clock,
            config={"component": "sim-harness", "seed": seed,
                    "sync_interval_s": sync_interval_s,
                    "metrics_interval_s": metrics_interval_s})
        #: deterministic event log: (t, etype, kind, key, node)
        self.events: List[Tuple] = []
        #: controller names whose watch delivery is stalled (WatchStall)
        self.paused: set = set()
        #: operator<->store partition: nothing on the operator side runs
        self.partitioned = False
        self._watches: List[tuple] = []
        self._timers: List = []
        self._pumping = False
        self._started = False
        self._stopped = False
        self.pump_exhausted = 0
        self.clock.on_sleep = self._cooperative_step

    # -- lifecycle --------------------------------------------------------

    def __enter__(self) -> "SimHarness":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def start(self) -> None:
        if self._started:
            return
        self.store.attach_listener(self._record_event)
        for i, op in enumerate(self.ops):
            self._start_owner_components(i, op)
        self._started = True
        self.pump()

    def _start_owner_components(self, idx: int, op: Operator) -> None:
        """Wire one shard owner's stack into the cooperative loop: its
        informer cache, one conflated watch per controller against ITS
        shard store, and its periodic passes as virtual-time timers.
        Shared by start() and a failover successor (start_owner)."""
        op.cache.start()           # in-process: synchronous listener
        op._recover_state()
        for c in op.manager._controllers:
            watch = op.store.watch(*c.kinds, conflate=True)
            self._watches.append((idx, c, watch))
            try:
                c.on_start()
            except Exception:
                log.exception("sim: controller %s on_start failed",
                              c.name)
            if c.resync_interval_s > 0:
                self._arm_resync(idx, c, op)
        self._timers.append(
            self.clock.call_later(op.sync_interval_s,
                                  self._owner_tick(
                                      idx, op, self._sync_once,
                                      op.sync_interval_s)))
        if self.metrics_interval_s > 0 and op.metrics is not None:
            self._timers.append(self.clock.call_later(
                self.metrics_interval_s,
                self._owner_tick(idx, op, self._metrics_once,
                                 self.metrics_interval_s)))
        # the rest of the observability loop runs on virtual-time
        # timers too: alert evaluation and — when the operator carries
        # a policy engine — the closed-loop policy pass, each at its
        # own production interval (docs/policy.md campaign contract)
        if op.alerts is not None:
            self._timers.append(self.clock.call_later(
                op.alerts.interval_s,
                self._owner_tick(idx, op, self._alerts_once,
                                 op.alerts.interval_s)))
        if getattr(op, "policy", None) is not None:
            self._timers.append(self.clock.call_later(
                op.policy.interval_s,
                self._owner_tick(idx, op, self._policy_once,
                                 op.policy.interval_s)))

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        for t in self._timers:
            t.cancel()
        for _, _, watch in self._watches:
            watch.stop()
        for i, op in enumerate(self.ops):
            if i not in self.dead_shards:
                op.cache.stop()
        self.store.detach_listener(self._record_event)
        if self.shards > 1:
            # per-shard journals: stop flusher threads + close handles
            self.store.close()
        self.clock.on_sleep = None
        set_default_clock(self._restore_clock)

    # -- sharded-cell helpers (failover scenarios) -------------------------

    def owner(self, shard: int) -> Operator:
        return self.ops[shard]

    def shard_store(self, shard: int):
        """The CURRENT store of one shard (successor-aware — failover
        churn closures look the partition up per write)."""
        return self.store.shards[shard] if self.shards > 1 \
            else self.store

    def kill_owner(self, shard: int) -> None:
        """Crash shard ``shard``'s owner mid-flight: its journal is
        flushed + closed (what survived on disk IS the successor's
        replay source), its controller watches and cache detach, and
        the shard goes dark until install_owner/start_owner."""
        self.dead_shards.add(shard)
        store = self.shard_store(shard)
        store.close()
        for entry in list(self._watches):
            idx, _, watch = entry
            if idx == shard:
                watch.stop()
                self._watches.remove(entry)
        self.ops[shard].cache.stop()
        self.log_note("fault", f"shard-owner-crash:s{shard}", "inject")

    def install_owner(self, shard: int, new_store) -> Operator:
        """Swap the dead shard's partition for the successor's
        journal-replayed store (router-wide informer resync: synthetic
        DELETEDs + ADDED replay) and build — but do not yet start —
        the successor operator against it."""
        self.store.replace_shard(shard, new_store)
        op = Operator(store=new_store, clock=self.clock,
                      sync_interval_s=self.sync_interval_s,
                      shard=shard, **self._operator_kwargs)
        self.ops[shard] = op
        return op

    def start_owner(self, shard: int) -> None:
        """The successor won the shard lease: resume the shard's
        controller stack (recover state, resync cache, rejoin the
        cooperative loop)."""
        self.dead_shards.discard(shard)
        self._start_owner_components(shard, self.ops[shard])
        self.log_note("fault", f"shard-owner-takeover:s{shard}",
                      "heal")
        self.pump()

    # -- event log --------------------------------------------------------

    def _record_event(self, ev) -> None:
        node = getattr(ev.obj.spec, "node_name", "") \
            if ev.obj.KIND == "Pod" else ""
        entry = (round(self.clock.monotonic(), 9), ev.type,
                 ev.obj.KIND, ev.obj.key(), node)
        shard = getattr(ev, "shard", -1)
        if shard >= 0:
            # sharded runs fingerprint the feeding shard too (single-
            # shard logs keep their 5-tuple shape)
            entry = entry + (shard,)
        self.events.append(entry)
        self.recorder.note("store", ev.type, obj_kind=ev.obj.KIND,
                           key=ev.obj.key(), node=node)

    def log_note(self, *entry) -> None:
        """Scenario/fault annotations join the same deterministic log."""
        self.events.append((round(self.clock.monotonic(), 9), *entry))

    def log_digest(self) -> str:
        """Stable digest of the full event log — the determinism
        fingerprint two same-seed runs must agree on."""
        h = hashlib.sha256()
        for entry in self.events:
            h.update(repr(entry).encode())
        return h.hexdigest()

    # -- tpfprof: profile + postmortem bundles -----------------------------

    def profile_digest(self) -> str:
        """Canonical digest of the virtual-time attribution profile —
        the third determinism fingerprint (same seed => identical
        profile, alongside log_digest/trace_digest).  Sharded cells
        fold every owner's per-shard ledger into one digest."""
        if len(self.profilers) == 1:
            return self.profiler.digest()
        h = hashlib.sha256()
        for p in self.profilers:
            h.update(p.digest().encode())
        return h.hexdigest()

    def profiler_snapshots(self) -> List[dict]:
        """One snapshot per shard owner's ledger (shard-tagged when
        sharded) — what --export-profile writes."""
        return [p.snapshot(bins=10 ** 9) for p in self.profilers]

    def _bundle_extra(self) -> dict:
        extra = {"profile": self.profiler.snapshot(bins=10 ** 9),
                 "invariants": self.check_all(),
                 "sim_seconds": round(self.clock.monotonic(), 9)}
        if len(self.profilers) > 1:
            extra["profiles"] = self.profiler_snapshots()
        return extra

    def build_bundle(self, reason: str):
        """In-memory postmortem bundle ({filename: bytes}, digest):
        flight-recorder rings + the run's traces + invariant verdicts
        + the profile snapshot — digestable without touching disk, so
        the double-run determinism check covers bundles too."""
        return self.recorder.build_bundle(
            reason, tracers=tuple(op.tracer for op in self.ops),
            extra=self._bundle_extra())

    def dump_bundle(self, out_dir: str, reason: str):
        """Write the postmortem bundle directory; returns (path,
        digest).  Wired to invariant failures by scenarios.py."""
        return self.recorder.dump_bundle(
            out_dir, reason, tracers=tuple(op.tracer
                                           for op in self.ops),
            extra=self._bundle_extra())

    # -- virtual-time traces ----------------------------------------------

    def trace_spans(self) -> list:
        """Every span the control plane recorded this run (admission,
        scheduling, bind, workload spawn — all stamped in VIRTUAL time
        via the operator tracer's SimClock); sharded cells concatenate
        every live owner's tracer in shard order."""
        spans = []
        for op in self.ops:
            spans.extend(op.tracer.finished())
        return spans

    def trace_digest(self) -> str:
        """Canonical digest of the exported virtual-time trace — the
        second determinism fingerprint (same seed => byte-identical
        trace file, the ``make verify-trace`` contract)."""
        from ..tracing import trace_digest

        return trace_digest(self.trace_spans())

    def export_trace(self, path: str) -> str:
        """Write this run's spans as Chrome/Perfetto trace-event JSON
        (view in ui.perfetto.dev; validate/dump via tools/tpftrace.py)."""
        from ..tracing import write_trace

        return write_trace(path, self.trace_spans(),
                           meta={"seed": self.seed,
                                 "sim_seconds": round(
                                     self.clock.monotonic(), 3)})

    # -- timers -----------------------------------------------------------

    def at(self, t_sim: float, fn) -> None:
        """Schedule a scenario action at absolute sim time ``t_sim``."""
        self._timers.append(self.clock.call_at(t_sim, fn))

    def every(self, interval_s: float, fn, jitter_s: float = 0.0) -> None:
        """Recurring scenario action (seeded jitter keeps arrivals from
        lockstepping while staying reproducible)."""
        def fire():
            if self._stopped:
                return
            fn()
            delay = interval_s
            if jitter_s:
                delay += self.rng.uniform(0.0, jitter_s)
            self._timers.append(self.clock.call_later(delay, fire))
        self._timers.append(self.clock.call_later(interval_s, fire))

    def _arm_resync(self, idx: int, c, op) -> None:
        def fire():
            if self._stopped or self.ops[idx] is not op:
                return          # owner superseded (failover): retire
            if not self.partitioned and idx not in self.dead_shards \
                    and c.name not in self.paused:
                self._reconcile(idx, c, None)
            self._arm_resync(idx, c, op)
        self._timers.append(
            self.clock.call_later(c.resync_interval_s, fire))

    def _owner_tick(self, idx: int, op, pass_fn, interval: float):
        """Recurring virtual-time pass bound to ONE owner generation:
        a timer whose operator was killed/superseded retires instead
        of poking a dead (or the wrong) stack."""
        def fire():
            if self._stopped or self.ops[idx] is not op:
                return
            if not self.partitioned and idx not in self.dead_shards:
                try:
                    pass_fn(idx, op)
                except Exception:
                    log.exception("sim: %s failed for shard %d",
                                  getattr(pass_fn, "__name__", "pass"),
                                  idx)
            self._timers.append(self.clock.call_later(interval, fire))
        return fire

    def _sync_once(self, idx: int, op) -> None:
        op.sync_once()

    def _metrics_once(self, idx: int, op) -> None:
        if op.metrics is not None:
            op.metrics.record_once()

    def _alerts_once(self, idx: int, op) -> None:
        if op.alerts is not None:
            op.alerts.evaluate_once()

    def _policy_once(self, idx: int, op) -> None:
        policy = getattr(op, "policy", None)
        if policy is None:
            return
        for d in policy.evaluate_once():
            self.log_note("policy", d.rule, d.action,
                          ",".join(d.group))

    # -- stepping ---------------------------------------------------------

    def _reconcile(self, idx: int, c, ev) -> None:
        t0 = self.clock.monotonic()
        try:
            c.reconcile(ev)
        except Exception:
            log.exception("sim: controller %s reconcile failed", c.name)
        # virtual-time attribution: reconciles are zero-width under
        # SimClock, so this fingerprints which controller ran when —
        # per shard owner, so a hot shard shows in tpfprof
        self.profilers[idx].attribute(c.name, "compute",
                                      self.clock.monotonic() - t0)

    def _cooperative_step(self) -> None:
        """SimClock.on_sleep hook: when an actor poll-sleeps (e.g.
        LiveMigrator waiting for a rebind), the rest of the control
        plane runs during the sleep."""
        self.pump()

    def pump(self, max_rounds: int = PUMP_MAX_ROUNDS) -> int:
        """Deliver pending watch events + run the scheduler until the
        control plane quiesces.  Returns the number of rounds run."""
        if self._pumping or not self._started or self._stopped:
            return 0
        self._pumping = True
        try:
            rounds = 0
            while rounds < max_rounds:
                rounds += 1
                progress = False
                if self.partitioned:
                    break
                for i, op in enumerate(self.ops):
                    if i not in self.dead_shards:
                        op.scheduler.check_permit_timeouts()
                for idx, c, watch in self._watches:
                    if c.name in self.paused or idx in self.dead_shards:
                        continue
                    while True:
                        ev = watch.get(timeout=0)
                        if ev is None:
                            break
                        self._reconcile(idx, c, ev)
                        progress = True
                for i, op in enumerate(self.ops):
                    if i in self.dead_shards:
                        continue
                    if op.scheduler.run_until_idle():
                        progress = True
                        self.profilers[i].attribute("scheduler",
                                                    "compute", 0.0)
                if not progress:
                    break
            else:
                self.pump_exhausted += 1
                log.warning("sim: pump did not quiesce within %d rounds",
                            max_rounds)
            return rounds
        finally:
            self._pumping = False

    def run_for(self, sim_seconds: float) -> None:
        """Advance the simulation ``sim_seconds`` of virtual time,
        firing timers and stepping the control plane at each event."""
        end = self.clock.monotonic() + sim_seconds
        self.pump()
        while True:
            due = self.clock.next_timer()
            if due is None or due > end:
                break
            self.clock.advance_to(due)
            self.pump()
        self.clock.advance_to(end)
        self.pump()

    # -- invariants -------------------------------------------------------

    def live_nodes(self) -> set:
        return {n.name for n in self.store.list(Node)
                if n.status.phase == constants.PHASE_RUNNING}

    def check_no_lost_pods(self) -> List[str]:
        """Every (non-dynamic) workload must have its desired replica
        count of worker pods, each bound to a live node.  A pod bound
        to a dead node, or a missing replica, is a lost pod."""
        violations = []
        live = self.live_nodes()
        for wl in self.store.list(TPUWorkload):
            if wl.spec.dynamic_replicas:
                continue
            if wl.spec.is_local_tpu or wl.spec.embedded_worker:
                # client-pod profile records (webhook-admitted
                # standalone pods): no worker replicas are ever spawned
                # for these, same skip the WorkloadController applies
                continue
            desired = max(wl.spec.replicas, 0)
            pods = self.store.list(
                Pod, namespace=wl.metadata.namespace,
                selector=lambda p: (
                    p.metadata.annotations.get(constants.ANN_WORKLOAD)
                    == wl.metadata.name
                    and p.metadata.labels.get(constants.LABEL_COMPONENT)
                    == constants.COMPONENT_WORKER))
            bound = [p for p in pods if p.spec.node_name]
            if len(pods) < desired:
                violations.append(
                    f"{wl.key()}: {len(pods)}/{desired} replicas exist")
            for p in bound:
                if p.spec.node_name not in live:
                    violations.append(
                        f"{p.key()}: bound to dead node "
                        f"{p.spec.node_name}")
        return violations

    def _live_owners(self):
        return [op for i, op in enumerate(self.ops)
                if i not in self.dead_shards]

    def check_no_double_bind(self) -> List[str]:
        """No chip may be allocated beyond its virtual capacity, and no
        pod key may hold more than one allocation record — judged per
        live shard owner (keys are shard-exclusive, so cross-owner
        aggregation would never mask a double bind)."""
        violations = []
        for op in self._live_owners():
            for state in op.allocator.chips():
                avail = state.available()
                if avail.tflops < -1e-6 or avail.hbm_bytes < -1e-6:
                    violations.append(
                        f"chip {state.chip.name}: over-allocated "
                        f"({avail.tflops:.1f} tflops, "
                        f"{avail.hbm_bytes:.0f} HBM available)")
            seen: Dict[str, int] = {}
            for record in op.allocator.allocations():
                seen[record.key] = seen.get(record.key, 0) + 1
            for key, n in seen.items():
                if n > 1:
                    violations.append(f"{key}: {n} allocation records")
        return violations

    def check_no_leaked_allocations(self) -> List[str]:
        """Every committed allocation must belong to a live pod (a
        record whose pod is gone leaks chip capacity forever)."""
        violations = []
        live_keys = {p.key() for p in self.store.list(Pod)}
        for op in self._live_owners():
            for record in op.allocator.allocations():
                if record.assumed:
                    continue       # in-flight: the TTL sweep owns these
                if record.key not in live_keys:
                    violations.append(
                        f"allocation {record.key} has no live pod")
        return violations

    def check_converged(self) -> List[str]:
        """Steady state: every schedulable pod is bound, nothing is
        stuck in the queue, every non-dynamic workload is at strength."""
        violations = []
        for p in self.store.list(Pod):
            if p.spec.scheduler_name == constants.SCHEDULER_NAME \
                    and not p.spec.node_name:
                violations.append(f"pod {p.key()} still unbound")
        violations.extend(self.check_no_lost_pods())
        return violations

    def check_all(self) -> Dict[str, List[str]]:
        return {
            "no_lost_pods": self.check_no_lost_pods(),
            "no_double_bind": self.check_no_double_bind(),
            "no_leaked_allocations": self.check_no_leaked_allocations(),
            "converged": self.check_converged(),
        }
