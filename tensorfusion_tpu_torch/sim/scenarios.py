"""Named fault scenarios for the digital twin.

The port's copy of ``tensorfusion_tpu/sim/scenarios.py``.

Each scenario drives the REAL control plane through a failure story in
virtual time and judges it by invariants (no lost pods, no double
bind, no leaked allocations, convergence within a simulated deadline).
All randomness flows from the recorded seed — a failure reproduces
bit-for-bit from ``(scenario, seed, scale)``.

Run headless: ``python benchmarks/sim_scenarios.py`` (tier-1 scale) or
``make verify-sim``.  Adding a scenario: docs/simulation.md.
"""

from __future__ import annotations

import time as _wall_time   # wall-clock cost reporting only
from typing import Callable, Dict, List, Optional

from .. import constants
from ..api.types import Node, Pod
from .faults import (ClockSkew, NodeCrash, NodeFlap, Partition,
                     StoreLatency, WatchStall)
from .harness import SimHarness
from .trace import TraceGenerator

def _wall_now() -> float:
    """Real wall-clock timestamp for ``wall_seconds`` cost reporting.

    The ONLY sanctioned wall-time read on the sim path: ``wall_seconds``
    is run metadata (how long the twin took to execute), deliberately
    nondeterministic, and never folded into a log/trace/profile digest.
    Everything the digests record flows through ``clock.monotonic()``.
    """
    # tpflint: disable=sim-nondeterminism -- run-cost metadata, not digest state
    return _wall_time.perf_counter()


#: scenario registry: name -> fn(seed, scale) -> result dict
SCENARIOS: Dict[str, Callable] = {}

#: spans + meta of the most recent scenario run (captured by _result
#: while the harness is still alive) — ``sim_scenarios.py
#: --export-trace`` writes them as a Chrome/Perfetto file after the
#: run; a module global because scenario fns share the (seed, scale)
#: signature and results must stay JSON-small
LAST_TRACE: Dict[str, object] = {}

#: profiler snapshots + meta of the most recent scenario run —
#: ``sim_scenarios.py --export-profile`` writes them as a tpfprof-v1
#: artifact (tools/tpfprof.py reads it); same lifetime contract as
#: LAST_TRACE
LAST_PROFILE: Dict[str, object] = {}

SCALES = {
    # tier-1 / verify-sim: seconds of wall time
    "small": dict(nodes=8, chips=4, workloads=6, replicas=3, churn=10),
    # bench default
    "medium": dict(nodes=48, chips=4, workloads=40, replicas=4,
                   churn=80),
    # the 100k-pod-scale trace shape (minutes of wall time)
    "large": dict(nodes=1024, chips=8, workloads=2000, replicas=8,
                  churn=4000),
}

#: serving-burst-storm shapes (the engine scenario has its own axes:
#: intermittent tenants, per-tenant burst size, pool geometry).
#: ``sysprompts``/``sys_len``: tenants draw from a small set of shared
#: system prompts (block-aligned at block_size=4 so the full-prefix
#: copy-on-write path fires), exercising prefix sharing under churn;
#: ``spec_k``/``draft_acc``: the speculative-decode stepper — an
#: ArithmeticDraft at the given per-token hit rate against the
#: FakeRunner target, verified greedy-exact by invariant.
SERVING_SCALES = {
    # deliberately under-provisioned pools/queues: the storm must
    # exercise BUSY rejection, deadline shedding, block-pool
    # preemption, CoW on shared tails and spec rollback, not just the
    # happy path
    "small": dict(tenants=48, reqs=2, prompt=8, tokens=6, batch=8,
                  blocks=25, chunk=8, waiting=12, window_s=0.8,
                  sysprompts=3, sys_len=8, spec_k=3, draft_acc=0.7),
    "medium": dict(tenants=300, reqs=2, prompt=12, tokens=8, batch=16,
                   blocks=65, chunk=16, waiting=24, window_s=5.0,
                   sysprompts=4, sys_len=12, spec_k=3, draft_acc=0.7),
    "large": dict(tenants=2000, reqs=3, prompt=16, tokens=12, batch=32,
                  blocks=129, chunk=32, waiting=48, window_s=20.0,
                  sysprompts=6, sys_len=16, spec_k=4, draft_acc=0.7),
}


#: rolling-pool-upgrade shapes (docs/migration.md): a pool of serving
#: workers is streaming-migrated one at a time under sustained
#: mixed-QoS traffic.  ``block_bytes``/``bandwidth`` set the sim-time
#: cost of shipping one dirty KV page (the pre-copy rounds' clock);
#: ``ttft_p99_bound_ms`` is the scenario's bounded-latency criterion
#: in sim milliseconds.
MIGRATION_SCALES = {
    "small": dict(workers=3, tenants=24, reqs=2, prompt=8, tokens=40,
                  batch=8, blocks=161, chunk=16, waiting=64,
                  window_s=1.2, block_bytes=4096,
                  bandwidth=4 << 20, ttft_p99_bound_ms=600.0),
    "medium": dict(workers=4, tenants=120, reqs=2, prompt=12,
                   tokens=48, batch=16, blocks=321, chunk=24,
                   waiting=256, window_s=4.0, block_bytes=4096,
                   bandwidth=4 << 20, ttft_p99_bound_ms=800.0),
    "large": dict(workers=8, tenants=600, reqs=3, prompt=16,
                  tokens=64, batch=32, blocks=641, chunk=32,
                  waiting=1024, window_s=12.0, block_bytes=4096,
                  bandwidth=8 << 20, ttft_p99_bound_ms=1200.0),
}


#: shard-owner-failover shapes: a sharded cell (docs/control-plane-
#: scale.md) — per-shard node counts, per-shard workload churn, and the
#: ownership-lease timing the failover window is judged against
SHARD_SCALES = {
    "small": dict(shards=4, nodes=3, chips=2, workloads=4, replicas=2,
                  lease_s=4.0, renew_s=1.0),
    "medium": dict(shards=4, nodes=12, chips=4, workloads=24,
                   replicas=3, lease_s=4.0, renew_s=1.0),
    "large": dict(shards=8, nodes=96, chips=8, workloads=400,
                  replicas=6, lease_s=4.0, renew_s=1.0),
}


def scenario(name: str):
    def register(fn):
        SCENARIOS[name] = fn
        fn.scenario_name = name
        return fn
    return register


def _result(h: SimHarness, name: str, seed: int, scale: str,
            t_wall0: float, extra: Optional[dict] = None) -> dict:
    import os as _os

    checks = h.check_all()
    ok = not any(checks.values()) and h.pump_exhausted == 0
    out = {
        "scenario": name,
        "seed": seed,
        "scale": scale,
        "ok": ok,
        "sim_seconds": round(h.clock.monotonic(), 3),
        "wall_seconds": round(_wall_now() - t_wall0, 3),
        "store_events": len(h.events),
        "log_digest": h.log_digest(),
        "trace_spans": len(h.trace_spans()),
        "trace_digest": h.trace_digest(),
        "profile_digest": h.profile_digest(),
        "pods_scheduled": sum(op.scheduler.scheduled_count
                              for op in h.ops),
        "sched_failures": sum(op.scheduler.failed_count
                              for op in h.ops),
        "pump_exhausted": h.pump_exhausted,
        "invariants": {k: v[:10] for k, v in checks.items()},
    }
    if not ok:
        # invariant trip: freeze the black box.  The digest always
        # lands in the result (the double run must reproduce the SAME
        # postmortem); the directory is only written when a bundle dir
        # is configured (TPF_PROF_BUNDLE_DIR / TPF_SIM_BUNDLE_DIR).
        _, bundle_digest = h.build_bundle(f"invariant-{name}")
        out["bundle_digest"] = bundle_digest
        bundle_dir = _os.environ.get("TPF_SIM_BUNDLE_DIR", "") or \
            h.recorder.bundle_dir
        if bundle_dir:
            path, _ = h.dump_bundle(bundle_dir, f"invariant-{name}")
            out["bundle_path"] = path
    LAST_TRACE["spans"] = h.trace_spans()
    LAST_TRACE["meta"] = {"scenario": name, "seed": seed,
                          "scale": scale,
                          "sim_seconds": out["sim_seconds"]}
    LAST_PROFILE["snapshots"] = h.profiler_snapshots()
    LAST_PROFILE["meta"] = dict(LAST_TRACE["meta"])
    if extra:
        out.update(extra)
    return out


def run_scenario(name: str, seed: int = 0, scale: str = "small") -> dict:
    return SCENARIOS[name](seed, scale)


def run_all(seed: int = 0, scale: str = "small",
            names: Optional[List[str]] = None) -> List[dict]:
    return [run_scenario(n, seed=seed, scale=scale)
            for n in (names or sorted(SCENARIOS))]


# -- scenarios -------------------------------------------------------------

@scenario("rolling-node-failure")
def rolling_node_failure(seed: int = 0, scale: str = "small") -> dict:
    """Nodes crash one after another under steady load, each healing
    later.  The control plane must evict pods off each dead node,
    reschedule them elsewhere, and end with zero lost pods."""
    p = SCALES[scale]
    t0 = _wall_now()
    with SimHarness(seed=seed) as h:
        tg = TraceGenerator(h)
        tg.build_cluster(p["nodes"], p["chips"])
        for i in range(p["workloads"]):
            tg.submit_workload(tg.make_workload(
                f"roll-wl-{i:04d}", p["replicas"]))
        h.run_for(5.0)                      # converge the baseline
        # crash ~1/4 of the nodes, staggered; half heal after 15 sim-s,
        # half STAY dead (the case that strands pods without the node-
        # lifecycle eviction path — the round-11 bug).  Capacity
        # headroom stays positive so every pod CAN relocate.
        victims = h.rng.sample(tg.node_names,
                               max(2, len(tg.node_names) // 4))
        for i, node in enumerate(victims):
            NodeCrash(at=8.0 + 6.0 * i,
                      duration_s=15.0 if i % 2 == 0 else None,
                      node=node).schedule(h)
        h.run_for(8.0 + 6.0 * len(victims) + 40.0)
        node_ctrl = next(c for c in h.op.manager._controllers
                         if c.name == "node")
        return _result(h, "rolling-node-failure", seed, scale, t0,
                       {"nodes_crashed": len(victims),
                        "evictions": len(getattr(node_ctrl,
                                                 "evicted_from_dead",
                                                 ()))})


@scenario("thundering-herd-rescale")
def thundering_herd_rescale(seed: int = 0, scale: str = "small") -> dict:
    """Every plain workload rescales 1 -> R in the same instant, and a
    herd of FRESH strict gangs (full quorum required at birth) arrives
    alongside.  Convergence must be EVENT-driven: the allocator sync
    side-channel is pushed out to 1h, so nothing can hide behind its
    periodic chip write-backs — the configuration that exposed the
    gang-quorum live-lock (round-11 bug #2)."""
    p = SCALES[scale]
    t0 = _wall_now()
    with SimHarness(seed=seed, sync_interval_s=3600.0) as h:
        tg = TraceGenerator(h)
        tg.build_cluster(p["nodes"], p["chips"])
        names = []
        for i in range(p["workloads"]):
            name = f"herd-wl-{i:04d}"
            tg.submit_workload(tg.make_workload(name, 1))
            names.append(name)
        h.run_for(5.0)

        def herd():
            for name in names:
                tg.scale_workload(name, p["replicas"])
            # fresh strict gangs: every member must form at once, on a
            # cluster whose only wake-ups are these very events
            for g in range(max(2, p["workloads"] // 3)):
                tg.submit_workload(tg.make_workload(
                    f"herd-gang-{g:04d}", p["replicas"], gang=True,
                    strict=True))
        h.at(5.5, herd)
        h.run_for(30.0)        # event-driven deadline: well under the
        #                        first 1h sync pass
        return _result(h, "thundering-herd-rescale", seed, scale, t0,
                       {"herd_size": len(names) * p["replicas"]})


@scenario("partition-heal-reconvergence")
def partition_heal(seed: int = 0, scale: str = "small") -> dict:
    """The operator loses the store mid-churn for 20 sim-s; clients
    keep writing.  On heal the controllers face the whole backlog and
    must reconverge without double-binding or leaking allocations."""
    p = SCALES[scale]
    t0 = _wall_now()
    with SimHarness(seed=seed) as h:
        tg = TraceGenerator(h)
        tg.build_cluster(p["nodes"], p["chips"])
        tg.seeded_churn(duration_s=30.0, workloads=p["churn"],
                        max_replicas=p["replicas"])
        Partition(at=8.0, duration_s=20.0).schedule(h)
        h.run_for(90.0)
        return _result(h, "partition-heal-reconvergence", seed, scale,
                       t0)


@scenario("slow-watcher-storm")
def slow_watcher_storm(seed: int = 0, scale: str = "small") -> dict:
    """Reconcile-critical controllers stop draining their watches
    under churn (the slow-watcher storm), then resume against the
    accumulated backlog — the conflation/resync machinery must carry
    them back to a converged state."""
    p = SCALES[scale]
    t0 = _wall_now()
    with SimHarness(seed=seed) as h:
        tg = TraceGenerator(h)
        tg.build_cluster(p["nodes"], p["chips"])
        tg.seeded_churn(duration_s=30.0, workloads=p["churn"],
                        max_replicas=p["replicas"])
        WatchStall(at=5.0, duration_s=25.0,
                   controllers=["workload", "connection",
                                "pool"]).schedule(h)
        h.run_for(90.0)
        stalled = {c.name: w.resyncs for _, c, w in h._watches
                   if c.name in ("workload", "connection", "pool")}
        return _result(h, "slow-watcher-storm", seed, scale, t0,
                       {"stalled_watch_resyncs": stalled})


@scenario("leader-flap")
def leader_flap(seed: int = 0, scale: str = "small") -> dict:
    """Two operator replicas elect through a store Lease; the holder
    repeatedly freezes past the TTL (GC pause / network blip) and
    recovers.  Leadership must transfer, fencing tokens must grow
    monotonically, and a double-leader window must never outlive the
    lease duration."""
    from ..utils.leader import StoreLeaderElector

    t0 = _wall_now()
    lease_s, renew_s = 6.0, 1.0
    with SimHarness(seed=seed) as h:
        electors = [
            StoreLeaderElector(h.store, ident, lease_duration_s=lease_s,
                               renew_interval_s=renew_s, clock=h.clock)
            for ident in ("replica-a", "replica-b")]
        frozen: set = set()

        def tick(e):
            def fire():
                if e.identity not in frozen:
                    e.campaign_tick()
            return fire
        for e in electors:
            h.every(renew_s, tick(e))

        samples: List[tuple] = []
        tokens: List[int] = []

        def sample():
            leaders = [e.identity for e in electors if e.is_leader]
            samples.append((round(h.clock.monotonic(), 3),
                            tuple(leaders)))
            t = max(e.fencing_token for e in electors)
            if not tokens or t != tokens[-1]:
                tokens.append(t)
        h.every(0.5, sample)

        # flap the current holder 3 times: frozen past the TTL, then back
        def freeze_holder():
            holders = [e for e in electors if e.is_leader]
            if holders:
                ident = holders[0].identity
                frozen.add(ident)
                h.log_note("fault", f"leader-freeze:{ident}", "inject")
                h.at(h.clock.monotonic() + lease_s + 2 * renew_s,
                     lambda: (frozen.discard(ident),
                              h.log_note("fault",
                                         f"leader-freeze:{ident}",
                                         "heal")))
        for k in range(3):
            h.at(10.0 + k * 20.0, freeze_holder)
        h.run_for(75.0)

        # invariants: token monotonic; bounded double-leader window;
        # exactly one settled leader at the end
        violations = []
        if tokens != sorted(tokens):
            violations.append(f"fencing tokens regressed: {tokens}")
        double_run = worst_double = 0.0
        prev_t = None
        for t, leaders in samples:
            if len(leaders) > 1:
                double_run += 0.0 if prev_t is None else (t - prev_t)
                worst_double = max(worst_double, double_run)
            else:
                double_run = 0.0
            prev_t = t
        if worst_double > lease_s:
            violations.append(
                f"double leadership persisted {worst_double}s "
                f"(> lease {lease_s}s)")
        final_leaders = [e.identity for e in electors if e.is_leader]
        if len(final_leaders) != 1:
            violations.append(f"settled leaders: {final_leaders}")
        transitions = sum(
            1 for i in range(1, len(samples))
            if samples[i][1] and samples[i - 1][1]
            and samples[i][1] != samples[i - 1][1])
        result = _result(h, "leader-flap", seed, scale, t0, {
            "leadership_transitions": transitions,
            "fencing_tokens": tokens,
            "worst_double_leader_s": worst_double,
        })
        result["invariants"]["leader"] = violations
        result["ok"] = result["ok"] and not violations
        return result


@scenario("serving-burst-storm")
def serving_burst_storm(seed: int = 0, scale: str = "small") -> dict:
    """Hundreds of intermittent tenants burst GENERATE requests at the
    REAL continuous-batching engine (tensorfusion_tpu_torch/serving) under
    SimClock — the twin analog of benchmarks/burst_serving.py's
    wake-from-zero shape, at a tenant count wall-clock benches cannot
    touch.  The engine is stepped cooperatively with a deterministic
    FakeRunner (one decode step costs 1 sim-ms); arrivals, QoS mix,
    prompt/token lengths all flow from the seed.  Tenants draw their
    prompts from a small set of SHARED SYSTEM PROMPTS (prefix sharing
    + copy-on-write under churn) and decode SPECULATIVELY through an
    ArithmeticDraft.  Invariants: NO LOST SEQUENCES (every submission
    is retired, shed with a deadline code, or BUSY-rejected at submit
    — nothing vanishes), the refcounted KV block pool FULLY RECLAIMED
    at quiescence (no block, owner, or registry entry survives), and
    SPECULATIVE TOKENS EXACT — every completed sequence's stream
    equals the closed-form non-speculative greedy chain."""
    import hashlib
    import json as _json
    import random as _random

    from ..profiling.profiler import Profiler
    from ..profiling.recorder import FlightRecorder
    from ..remoting.dispatch import BusyError
    from ..serving.engine import ServingEngine
    from ..serving.runner import FakeRunner
    from ..serving.spec import ArithmeticDraft
    from ..tracing import Tracer
    from ..tracing.export import trace_digest
    from .clock import SimClock

    p = SERVING_SCALES[scale]
    t0 = _wall_now()
    clock = SimClock()
    tracer = Tracer(service="serving-sim", clock=clock, id_prefix="sb")
    profiler = Profiler(name="sim-engine", clock=clock, bin_s=0.1)
    recorder = FlightRecorder(clock=clock,
                              config={"component": "serving-sim",
                                      "seed": seed, "scale": scale})
    rng = _random.Random(seed)
    runner = FakeRunner(num_blocks=p["blocks"], block_size=4)
    eng = ServingEngine(runner, clock=clock, tracer=tracer,
                        name="sim-engine", max_batch=p["batch"],
                        prefill_chunk_tokens=p["chunk"],
                        max_waiting=p["waiting"],
                        profiler=profiler, recorder=recorder,
                        prefix_sharing=True,
                        draft=ArithmeticDraft(runner,
                                              accuracy=p["draft_acc"],
                                              seed=seed),
                        spec_k=p["spec_k"])
    events: list = []
    outcomes = {"done": 0, "shed": 0, "busy": 0}
    finished: list = []

    def emit(seq, toks, done, info):
        if done:
            key = "shed" if info.get("code") else "done"
            outcomes[key] += 1
            if key == "done":
                finished.append(seq)
            events.append((round(clock.monotonic(), 6), key,
                           seq.tenant, info.get("finish_reason")
                           or info.get("code"), len(seq.tokens)))

    # seeded burst schedule: each tenant wakes at a random instant and
    # fires a short burst of requests (intermittent, mostly idle);
    # prompts share system prefixes drawn from a small pool
    sys_prompts = [[rng.randrange(1, 97) for _ in range(p["sys_len"])]
                   for _ in range(p["sysprompts"])]
    arrivals = []
    for i in range(p["tenants"]):
        tenant = f"tenant-{i:04d}"
        qos = ("low", "medium", "high", "critical")[rng.randrange(4)]
        t_wake = rng.random() * p["window_s"]
        for j in range(p["reqs"]):
            prompt = list(sys_prompts[rng.randrange(p["sysprompts"])])
            # some requests ARE the bare system prompt (the
            # block-aligned full-prefix match that forces CoW)
            if rng.randrange(4):
                prompt += [rng.randrange(1, 97)
                           for _ in range(rng.randrange(p["prompt"]))]
            arrivals.append((round(t_wake + j * 0.02, 6), tenant, qos,
                             prompt, 1 + rng.randrange(p["tokens"]),
                             120.0 + rng.random() * 600.0))
    arrivals.sort(key=lambda a: (a[0], a[1]))

    submitted = 0
    i = 0
    while True:
        now = clock.monotonic()
        while i < len(arrivals) and arrivals[i][0] <= now:
            _, tenant, qos, prompt, max_new, dl = arrivals[i]
            i += 1
            submitted += 1
            trace = {"trace_id": f"sb-{submitted:05d}", "span_id": "",
                     "sampled": True}
            try:
                eng.submit(prompt, max_new, tenant=tenant, qos=qos,
                           deadline_ms=dl, emit=emit, trace=trace)
                events.append((round(now, 6), "submit", tenant, qos,
                               len(prompt)))
            except BusyError:
                outcomes["busy"] += 1
                events.append((round(now, 6), "busy", tenant, qos,
                               len(prompt)))
        did = eng.step()
        if did:
            clock.sleep(0.01)           # one engine step = 10 sim-ms
        elif i < len(arrivals):
            clock.advance_to(arrivals[i][0])   # idle: jump to next burst
        else:
            break

    snap = eng.snapshot()
    violations = {"lost_sequences": [], "kv_reclaimed": [],
                  "spec_greedy_exact": []}
    accounted = outcomes["done"] + outcomes["shed"] + outcomes["busy"]
    if accounted != len(arrivals):
        violations["lost_sequences"].append(
            f"{len(arrivals)} submitted but only {accounted} accounted "
            f"(done={outcomes['done']} shed={outcomes['shed']} "
            f"busy={outcomes['busy']})")
    if snap["kv"]["used"] != 0 or snap["kv"]["owners"] != 0 or \
            snap["kv"]["registered_keys"] != 0:
        violations["kv_reclaimed"].append(
            f"{snap['kv']['used']} blocks / {snap['kv']['owners']} "
            f"owners / {snap['kv']['registered_keys']} registry "
            f"entries still held at quiescence")
    # speculative decode must be token-EXACT vs the closed-form greedy
    # chain (FakeRunner's next token is a pure function of (token,
    # position), so the non-speculative stream is computable directly)
    for seq in finished:
        expect, tok = [], seq.prompt[-1]
        pos = len(seq.prompt) - 1
        while len(expect) < seq.max_new_tokens:
            tok = runner._next(tok, pos)
            expect.append(tok)
            pos += 1
        if seq.tokens != expect:
            violations["spec_greedy_exact"].append(
                f"seq {seq.sid} ({seq.tenant}): spec stream "
                f"{seq.tokens} != greedy {expect}")
    log_digest = hashlib.sha256(
        _json.dumps(events, sort_keys=True).encode()).hexdigest()
    spans = tracer.finished()
    ok = not any(violations.values())
    out = {
        "scenario": "serving-burst-storm",
        "seed": seed,
        "scale": scale,
        "ok": ok,
        "sim_seconds": round(clock.monotonic(), 3),
        "wall_seconds": round(_wall_now() - t0, 3),
        "store_events": len(events),
        "log_digest": log_digest,
        "trace_spans": len(spans),
        "trace_digest": trace_digest(spans),
        "profile_digest": profiler.digest(),
        "pods_scheduled": 0,
        "sched_failures": 0,
        "pump_exhausted": 0,
        "invariants": {k: v[:10] for k, v in violations.items()},
        "tenants": p["tenants"],
        "requests": len(arrivals),
        "outcomes": outcomes,
        "tokens": snap["tokens"],
        "preempted": snap["preempted"],
        "kv_evictions": snap["kv"]["evicted_total"],
        "kv_peak_used": snap["kv"]["peak_used"],
        "kv_prefix_hits": snap["kv"]["prefix_hits_total"],
        "kv_prefix_hit_tokens": snap["kv"]["prefix_hit_tokens_total"],
        "kv_cow_copies": snap["kv"]["cow_copies_total"],
        "spec_accept_rate": snap["spec"]["accept_rate"],
        "spec_steps": snap["spec"]["steps"],
        "batch_occupancy_pct": snap["batch_occupancy_pct"],
        "ttft_p99_ms": snap["ttft"]["p99_ms"],
    }
    if not ok:
        _, bd = recorder.build_bundle(
            "invariant-serving-burst-storm", tracers=(tracer,),
            extra={"profile": profiler.snapshot(bins=10 ** 9),
                   "invariants": violations})
        out["bundle_digest"] = bd
    LAST_TRACE["spans"] = spans
    LAST_TRACE["meta"] = {"scenario": "serving-burst-storm",
                          "seed": seed, "scale": scale,
                          "sim_seconds": out["sim_seconds"]}
    LAST_PROFILE["snapshots"] = [profiler.snapshot(bins=10 ** 9)]
    LAST_PROFILE["meta"] = dict(LAST_TRACE["meta"])
    return out


@scenario("skew-lease-storm")
def skew_lease_storm(seed: int = 0, scale: str = "small") -> dict:
    """Clock skew beyond the lease TTL hits the cluster mid-churn
    while store writes also pay a latency spike.  Wall time jumps;
    monotonic time must not, lease bookkeeping must survive, and the
    churn must still converge."""
    p = SCALES[scale]
    t0 = _wall_now()
    with SimHarness(seed=seed) as h:
        tg = TraceGenerator(h)
        tg.build_cluster(p["nodes"], p["chips"])
        tg.seeded_churn(duration_s=25.0, workloads=p["churn"],
                        max_replicas=p["replicas"])
        mono_samples: List[float] = []
        h.every(1.0, lambda: mono_samples.append(h.clock.monotonic()))
        ClockSkew(at=6.0, duration_s=20.0, delta_s=45.0).schedule(h)
        StoreLatency(at=10.0, duration_s=10.0,
                     latency_s=0.02).schedule(h)
        h.run_for(80.0)
        violations = []
        if any(b < a for a, b in zip(mono_samples, mono_samples[1:])):
            violations.append("monotonic clock regressed under skew")
        result = _result(h, "skew-lease-storm", seed, scale, t0)
        result["invariants"]["monotonic"] = violations
        result["ok"] = result["ok"] and not violations
        return result


@scenario("shard-owner-failover")
def shard_owner_failover(seed: int = 0, scale: str = "small") -> dict:
    """A sharded control plane (N store partitions, one lease-owning
    operator per shard — docs/control-plane-scale.md) loses one shard
    owner mid-churn.  The victim's journal is what survived on disk;
    a successor replays it into a fresh partition, the ShardedStore
    router resyncs every cross-shard consumer informer-style, the
    successor takes the shard's ownership lease with a HIGHER fencing
    token, and resumes the controller stack — while the other shards
    keep scheduling throughout.  Judged by the standard invariants
    (no lost pods / no double bind / no leaked allocations /
    converged) plus: fencing-token monotonicity across the failover,
    exactly one settled owner per shard, and a cross-shard StoreCache
    replica that is coherent with the router at the end."""
    import os as _os
    import shutil
    import tempfile

    from ..api.types import ALL_KINDS, TPUPool, TPUWorkload
    from ..api import ResourceAmount
    from ..store import ObjectStore, mutate
    from ..storecache import StoreCache
    from ..utils.leader import ShardLeaseElector
    from .trace import make_chip

    p = SHARD_SCALES[scale]
    shards = p["shards"]
    t0 = _wall_now()
    persist_root = tempfile.mkdtemp(prefix="tpf_shard_sim_")
    try:
        with SimHarness(seed=seed, shards=shards,
                        persist_dir=persist_root) as h:
            # -- per-shard cells: pool-sI + ns-sI live on shard I ------
            def make_wl(name, ns, pool, replicas):
                wl = TPUWorkload.new(name, namespace=ns)
                wl.spec.pool = pool
                wl.spec.replicas = replicas
                wl.spec.chip_count = 1
                wl.spec.qos = "medium"
                wl.spec.resources.requests = ResourceAmount(
                    tflops=20.0, hbm_bytes=2 ** 30)
                wl.spec.resources.limits = ResourceAmount(
                    tflops=40.0, hbm_bytes=2 ** 30)
                return wl

            for i in range(shards):
                op, store = h.owner(i), h.shard_store(i)
                pool = TPUPool.new(f"pool-s{i}")
                pool.spec.name = f"pool-s{i}"
                store.create(pool)
                for n in range(p["nodes"]):
                    node = f"s{i}-node-{n:03d}"
                    op.register_host(node, [
                        make_chip(f"{node}-chip-{c}", node,
                                  pool=f"pool-s{i}")
                        for c in range(p["chips"])])
            h.pump()

            # -- one ownership lease per shard, ticked in sim time -----
            electors = [
                ShardLeaseElector(h.shard_store(i), i, f"owner-s{i}",
                                  lease_duration_s=p["lease_s"],
                                  renew_interval_s=p["renew_s"],
                                  clock=h.clock)
                for i in range(shards)]
            live_tick = set(range(shards))

            def tick(i, e):
                def fire():
                    if i in live_tick:
                        e.campaign_tick()
                return fire
            for i, e in enumerate(electors):
                h.every(p["renew_s"], tick(i, e))

            # -- cross-shard read path: one StoreCache replica fed from
            #    every shard's ring through the router
            gcache = StoreCache(h.store,
                                kinds=("Node", "Pod", "TPUWorkload"))
            gcache.start()

            # -- seeded churn per shard (skips a dark shard, exactly
            #    like clients bouncing off a dead apiserver) ----------
            def submit(i, name):
                def fire():
                    if i in h.dead_shards:
                        return
                    h.shard_store(i).create(
                        make_wl(name, f"ns-s{i}", f"pool-s{i}",
                                p["replicas"]))
                return fire

            def rescale(i, name, replicas):
                def fire():
                    if i in h.dead_shards:
                        return
                    def set_replicas(wl):
                        if wl.spec.replicas == replicas:
                            return False
                        wl.spec.replicas = replicas
                    mutate(h.shard_store(i), TPUWorkload, name,
                           set_replicas, namespace=f"ns-s{i}")
                return fire

            for i in range(shards):
                for w in range(p["workloads"]):
                    name = f"wl-s{i}-{w:04d}"
                    t_sub = 1.0 + h.rng.uniform(0.0, 5.0)
                    h.at(t_sub, submit(i, name))
                    h.at(t_sub + h.rng.uniform(2.0, 22.0),
                         rescale(i, name,
                                 1 + h.rng.randrange(p["replicas"])))

            h.run_for(7.0)                  # converge the baseline

            # -- kill one shard owner mid-churn ------------------------
            victim = h.rng.randrange(shards)
            state = {"old_token": 0, "successor": None,
                     "replayed": 0, "took_over_at": -1.0}

            def kill():
                state["old_token"] = electors[victim].fencing_token
                live_tick.discard(victim)
                h.kill_owner(victim)
            h.at(8.0, kill)

            def successor_boot():
                # replay what the dead owner's journal left on disk
                # tpflint: disable=shard-routing -- failover successor replays the dead shard's journal into a fresh partition
                new_store = ObjectStore(persist_dir=_os.path.join(
                    persist_root, f"shard-{victim:02d}"))
                new_store.load(ALL_KINDS)
                state["replayed"] = len(new_store.snapshot_objects())
                h.install_owner(victim, new_store)
                e = ShardLeaseElector(new_store, victim,
                                      f"successor-s{victim}",
                                      lease_duration_s=p["lease_s"],
                                      renew_interval_s=p["renew_s"],
                                      clock=h.clock,
                                      on_started_leading=lambda:
                                      (state.__setitem__(
                                          "took_over_at",
                                          round(h.clock.monotonic(),
                                                3)),
                                       h.start_owner(victim)))
                state["successor"] = e
                h.every(p["renew_s"], e.campaign_tick)
            h.at(8.5, successor_boot)

            h.run_for(45.0)

            # -- failover-specific invariants --------------------------
            violations = []
            succ = state["successor"]
            if succ is None or not succ.is_leader:
                violations.append("successor never took the shard "
                                  "lease")
            elif succ.fencing_token <= state["old_token"]:
                violations.append(
                    f"fencing token did not grow across failover "
                    f"({state['old_token']} -> {succ.fencing_token})")
            settled = [e for i, e in enumerate(electors)
                       if i != victim and not e.is_leader]
            if settled:
                violations.append(
                    f"{len(settled)} surviving shard owners lost "
                    f"their lease")
            for cls in ("Node", "Pod", "TPUWorkload"):
                from ..api import types as _types
                kind_cls = {"Node": _types.Node, "Pod": _types.Pod,
                            "TPUWorkload": _types.TPUWorkload}[cls]
                want = {(o.KIND, o.key(),
                         o.metadata.resource_version)
                        for o in h.store.list(kind_cls)}
                got = {(o.KIND, o.key(), o.metadata.resource_version)
                       for o in gcache.list(kind_cls)}
                if want != got:
                    violations.append(
                        f"cross-shard StoreCache incoherent for "
                        f"{cls}: {len(want ^ got)} records differ")
            gcache.stop()

            result = _result(
                h, "shard-owner-failover", seed, scale, t0, {
                    "shards": shards,
                    "victim_shard": victim,
                    "fencing_token_before": state["old_token"],
                    "fencing_token_after":
                        succ.fencing_token if succ else 0,
                    "journal_replayed_objects": state["replayed"],
                    "took_over_at_sim_s": state["took_over_at"],
                    "cache_shard_feed_rvs": {
                        str(k): v for k, v in
                        sorted(gcache.shard_feed_rvs().items())},
                    "per_shard_scheduled": [
                        op.scheduler.scheduled_count for op in h.ops],
                })
            result["invariants"]["failover"] = violations
            result["ok"] = result["ok"] and not violations
            return result
    finally:
        shutil.rmtree(persist_root, ignore_errors=True)


@scenario("rolling-pool-upgrade")
def rolling_pool_upgrade(seed: int = 0, scale: str = "small") -> dict:
    """Streaming-migrate EVERY worker of a serving pool, one at a
    time, under sustained mixed-QoS traffic (docs/migration.md) — the
    twin proof of the ROADMAP-2 acceptance: zero failed requests,
    bounded p99 TTFT, double-run digest-determinism.

    Each slot runs a REAL continuous-batching engine (FakeRunner,
    SimClock); its upgrade is driven by the REAL controller logic:
    :class:`~...controllers.defrag.StreamingConvergence` decides from
    the paged pool's dirty-page hooks (``BlockAccount.dirty_since``)
    when the predicted final round fits the slot's pause budget — the
    strictest budget among its live tenants' QoS classes
    (``migration_pause_budget_ms``).  Pre-copy rounds advance the sim
    clock by shipped-bytes/bandwidth while the engine KEEPS DECODING
    (that is the point); only the frozen final round is tenant-dark.
    The drained sequences move with their generated prefix and finish
    on the upgraded engine suffix-identically (the preemption
    re-admission proof, applied across engines).

    Invariants: NO FAILED REQUESTS (every submission retires with a
    finish reason — nothing shed, BUSY-rejected, or lost across any
    migration), GREEDY-EXACT TOKENS across the migration (each
    finished stream equals the closed-form chain), KV RECLAIMED on
    every engine generation (retired and live), every slot UPGRADED
    within the window with its realized pause <= its budget, and p99
    TTFT bounded."""
    import hashlib
    import json as _json
    import random as _random

    from ..controllers.defrag import (StreamingConvergence,
                                      migration_pause_budget_ms)
    from ..profiling.profiler import Profiler
    from ..profiling.recorder import FlightRecorder
    from ..serving.engine import ServingEngine
    from ..serving.runner import FakeRunner
    from ..tracing import Tracer
    from ..tracing.export import trace_digest
    from .clock import SimClock

    p = MIGRATION_SCALES[scale]
    t0 = _wall_now()
    clock = SimClock()
    tracer = Tracer(service="migration-sim", clock=clock,
                    id_prefix="ru")
    profiler = Profiler(name="sim-pool", clock=clock, bin_s=0.1)
    recorder = FlightRecorder(clock=clock,
                              config={"component": "migration-sim",
                                      "seed": seed, "scale": scale})
    rng = _random.Random(seed)
    events: list = []
    outcomes = {"done": 0, "shed": 0, "busy": 0}
    finished: list = []

    def emit(seq, toks, done, info):
        if done:
            key = "shed" if info.get("code") else "done"
            outcomes[key] += 1
            if key == "done":
                finished.append(seq)
            events.append((round(clock.monotonic(), 6), key,
                           seq.tenant, info.get("finish_reason")
                           or info.get("code"), len(seq.tokens)))

    gen_counter = [0]

    def make_engine(slot: int) -> ServingEngine:
        gen_counter[0] += 1
        return ServingEngine(
            FakeRunner(num_blocks=p["blocks"], block_size=4),
            clock=clock, tracer=tracer,
            name=f"w{slot}g{gen_counter[0]}", max_batch=p["batch"],
            prefill_chunk_tokens=p["chunk"],
            max_waiting=p["waiting"], profiler=profiler,
            recorder=recorder, prefix_sharing=True)

    slots = [make_engine(i) for i in range(p["workers"])]
    retired_engines: list = []
    slot_qos: Dict[int, set] = {i: set() for i in range(p["workers"])}

    # seeded mixed-QoS arrival schedule, tenants pinned round-robin to
    # pool slots; no deadlines — the zero-failed criterion means
    # nothing may legitimately shed
    arrivals = []
    for i in range(p["tenants"]):
        tenant = f"tenant-{i:04d}"
        slot = i % p["workers"]
        qos = ("low", "medium", "high", "critical")[rng.randrange(4)]
        t_wake = rng.random() * p["window_s"]
        for j in range(p["reqs"]):
            prompt = [rng.randrange(1, 97)
                      for _ in range(2 + rng.randrange(p["prompt"]))]
            arrivals.append((round(t_wake + j * 0.03, 6), slot, tenant,
                             qos, prompt,
                             1 + rng.randrange(p["tokens"])))
    arrivals.sort(key=lambda a: (a[0], a[2]))

    # rolling-upgrade schedule: one slot at a time, spread across the
    # window so migrations overlap live traffic
    upgrade_at = [round((k + 0.5) * p["window_s"] / p["workers"], 6)
                  for k in range(p["workers"])]
    upgraded: list = []
    violations = {"lost_requests": [], "greedy_exact": [],
                  "kv_reclaimed": [], "pause_budget": [],
                  "rolled_all": []}

    def step_pool() -> bool:
        did = False
        for eng in slots:
            did = eng.step() or did
        return did

    def ship_time_s(blocks: int) -> float:
        return blocks * p["block_bytes"] / p["bandwidth"]

    def migrate_slot(slot: int) -> None:
        src = slots[slot]
        budget_ms = min([migration_pause_budget_ms(q)
                         for q in slot_qos[slot]] or
                        [migration_pause_budget_ms("medium")])
        policy = StreamingConvergence(budget_ms, max_rounds=8)
        shipped_gen = 0
        rounds = 0
        while True:
            dirty = src.account.dirty_since(shipped_gen)
            gen_now = src.account.write_gen
            # the copy runs CONCURRENTLY with serving: step the pool
            # through the ship window instead of going dark
            t_end = clock.monotonic() + max(ship_time_s(len(dirty)),
                                            1e-4)
            while clock.monotonic() < t_end:
                if not step_pool():
                    clock.sleep(0.001)
                else:
                    clock.sleep(0.001)
            rounds += 1
            shipped_gen = gen_now
            left = src.account.dirty_since(shipped_gen)
            stats = {"round": rounds, "buffers": len(dirty),
                     "raw_bytes": len(dirty) * p["block_bytes"],
                     "dirty_left": len(left),
                     "bandwidth_bps": p["bandwidth"]}
            verdict = policy.decide(stats)
            if verdict == "continue":
                continue
            # "fallback" degenerates to an immediate freeze here: a
            # stop-and-copy of the whole pool state, same mechanics
            # with a full final round — the pause then reflects it
            break
        # bounded final pause: freeze, ship the remainder dark, flip
        src.freeze()
        final_dirty = src.account.dirty_since(shipped_gen)
        pause_s = ship_time_s(len(final_dirty)) + \
            StreamingConvergence.FREEZE_OVERHEAD_MS / 1e3
        clock.sleep(pause_s)          # tenant-dark window
        moved = src.export_sequences()
        standby = make_engine(slot)
        standby.import_sequences(moved)
        retired_engines.append(src)
        slots[slot] = standby
        upgraded.append({"slot": slot, "rounds": rounds,
                         "pause_ms": round(pause_s * 1e3, 3),
                         "budget_ms": budget_ms,
                         "moved": len(moved),
                         "final_blocks": len(final_dirty)})
        events.append((round(clock.monotonic(), 6), "upgrade",
                       f"w{slot}", rounds, len(moved)))

    submitted = 0
    i = 0
    next_upgrade = 0
    while True:
        now = clock.monotonic()
        if next_upgrade < len(upgrade_at) and \
                now >= upgrade_at[next_upgrade]:
            migrate_slot(next_upgrade)
            next_upgrade += 1
        while i < len(arrivals) and arrivals[i][0] <= now:
            _, slot, tenant, qos, prompt, max_new = arrivals[i]
            i += 1
            submitted += 1
            slot_qos[slot].add(qos)
            trace = {"trace_id": f"ru-{submitted:05d}", "span_id": "",
                     "sampled": True}
            try:
                slots[slot].submit(prompt, max_new, tenant=tenant,
                                   qos=qos, emit=emit, trace=trace)
                events.append((round(now, 6), "submit", tenant, qos,
                               len(prompt)))
            except Exception as e:  # noqa: BLE001 - counted as failure
                outcomes["busy"] += 1
                events.append((round(now, 6), "busy", tenant, qos,
                               str(e)[:60]))
        did = step_pool()
        if did:
            clock.sleep(0.01)
        elif i < len(arrivals):
            clock.advance_to(arrivals[i][0])
        elif next_upgrade < len(upgrade_at):
            clock.advance_to(upgrade_at[next_upgrade])
        else:
            break

    # -- judgment ----------------------------------------------------------
    if outcomes["done"] != submitted or outcomes["shed"] or \
            outcomes["busy"]:
        violations["lost_requests"].append(
            f"{submitted} submitted but done={outcomes['done']} "
            f"shed={outcomes['shed']} busy={outcomes['busy']}")
    runner0 = slots[0].runner
    for seq in finished:
        expect, tok, pos = [], seq.prompt[-1], len(seq.prompt) - 1
        while len(expect) < seq.max_new_tokens:
            tok = runner0._next(tok, pos)
            expect.append(tok)
            pos += 1
        if seq.tokens != expect:
            violations["greedy_exact"].append(
                f"{seq.tenant} sid={seq.sid}: {seq.tokens} != "
                f"{expect}")
    for eng in retired_engines + slots:
        snap = eng.account.snapshot()
        if snap["used"] != 0 or snap["owners"] != 0:
            violations["kv_reclaimed"].append(
                f"{eng.name}: {snap['used']} blocks / "
                f"{snap['owners']} owners still held")
    for up in upgraded:
        if up["pause_ms"] > up["budget_ms"] + \
                StreamingConvergence.FREEZE_OVERHEAD_MS:
            violations["pause_budget"].append(
                f"slot {up['slot']}: pause {up['pause_ms']}ms > "
                f"budget {up['budget_ms']}ms")
    if len(upgraded) != p["workers"]:
        violations["rolled_all"].append(
            f"only {len(upgraded)}/{p['workers']} slots upgraded")
    if not sum(u["moved"] for u in upgraded):
        # the whole point is migrating LIVE sequences: a roll that
        # only ever moved idle engines proved nothing
        violations["rolled_all"].append(
            "no live sequence ever rode a migration (pool idle at "
            "every upgrade — scenario shape too sparse)")
    ttfts = sorted(s.ttft_ms for s in finished
                   if s.ttft_ms is not None)
    p99 = ttfts[min(len(ttfts) - 1,
                    int(0.99 * len(ttfts)))] if ttfts else 0.0
    if p99 > p["ttft_p99_bound_ms"]:
        violations["lost_requests"].append(
            f"p99 TTFT {p99}ms > bound {p['ttft_p99_bound_ms']}ms")

    log_digest = hashlib.sha256(
        _json.dumps(events, sort_keys=True).encode()).hexdigest()
    spans = tracer.finished()
    ok = not any(violations.values())
    out = {
        "scenario": "rolling-pool-upgrade",
        "seed": seed,
        "scale": scale,
        "ok": ok,
        "sim_seconds": round(clock.monotonic(), 3),
        "wall_seconds": round(_wall_now() - t0, 3),
        "store_events": len(events),
        "log_digest": log_digest,
        "trace_spans": len(spans),
        "trace_digest": trace_digest(spans),
        "profile_digest": profiler.digest(),
        "pods_scheduled": 0,
        "sched_failures": 0,
        "pump_exhausted": 0,
        "invariants": {k: v[:10] for k, v in violations.items()},
        "workers": p["workers"],
        "tenants": p["tenants"],
        "requests": submitted,
        "outcomes": outcomes,
        "upgrades": upgraded,
        "migrated_sequences": sum(u["moved"] for u in upgraded),
        "rounds_total": sum(u["rounds"] for u in upgraded),
        "pause_ms_max": max((u["pause_ms"] for u in upgraded),
                            default=0.0),
        "ttft_p99_ms": p99,
    }
    if not ok:
        _, bd = recorder.build_bundle(
            "invariant-rolling-pool-upgrade", tracers=(tracer,),
            extra={"invariants": violations, "upgrades": upgraded})
        out["bundle_digest"] = bd
    LAST_TRACE["spans"] = spans
    LAST_TRACE["meta"] = {"scenario": "rolling-pool-upgrade",
                          "seed": seed, "scale": scale,
                          "sim_seconds": out["sim_seconds"]}
    LAST_PROFILE["snapshots"] = [profiler.snapshot(bins=10 ** 9)]
    LAST_PROFILE["meta"] = dict(LAST_TRACE["meta"])
    return out
