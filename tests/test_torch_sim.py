"""The port's digital twin (tensorfusion_tpu_torch/sim/) against the
reference's.

The reference's own cases (tests/test_sim.py whole, and the SimClock cases
of test_tracing.py, test_profiling.py, test_ha_leader.py, test_sharding.py
and test_serving.py's burst-storm pair) run here as one parametrised test
each, over both packages (``m``).  Beside them: every scenario at ``small``,
seed 42, giving the port the reference's log, trace and profile digests in
one process.  The ``medium`` scale is in tests/test_torch_sim_medium.py,
the campaigns and the hash-seed fault in tests/test_torch_twin.py.
"""

import contextlib
import functools
import importlib
import json
import os
import threading
import time
import types

import pytest

pytest.importorskip("torch")

pytestmark = pytest.mark.sim

_NAMES = {
    'ClockSkew': ('sim.faults', 'ClockSkew'),
    'Container': ('api.types', 'Container'),
    'FlightRecorder': ('profiling.recorder', 'FlightRecorder'),
    'Node': ('api.types', 'Node'),
    'NodeCrash': ('sim.faults', 'NodeCrash'),
    'NodeExpander': ('scheduler.expander', 'NodeExpander'),
    'NodeFlap': ('sim.faults', 'NodeFlap'),
    'ObjectStore': ('store', 'ObjectStore'),
    'Partition': ('sim.faults', 'Partition'),
    'Pod': ('api.types', 'Pod'),
    'Profiler': ('profiling.profiler', 'Profiler'),
    'ResourceAmount': ('api', 'ResourceAmount'),
    'SCENARIOS': ('sim.scenarios', 'SCENARIOS'),
    'ServingEngine': ('serving.engine', 'ServingEngine'),
    'SimClock': ('sim', 'SimClock'),
    'SimHarness': ('sim', 'SimHarness'),
    'SkewedClock': ('clock', 'SkewedClock'),
    'StoreLatency': ('sim.faults', 'StoreLatency'),
    'StoreLeaderElector': ('utils.leader', 'StoreLeaderElector'),
    'TPUNodeClaim': ('api.types', 'TPUNodeClaim'),
    'TPUPool': ('api.types', 'TPUPool'),
    'TPUWorkload': ('api.types', 'TPUWorkload'),
    'TraceGenerator': ('sim.trace', 'TraceGenerator'),
    'WallClock': ('clock', 'WallClock'),
    'WatchStall': ('sim.faults', 'WatchStall'),
    'constants': ('', 'constants'),
    'default_clock': ('clock', 'default_clock'),
    'dumps': ('tracing.export', 'dumps'),
    'make_chip': ('sim.trace', 'make_chip'),
    'result': ('sim.scenarios', '_result'),
    'run_scenario': ('sim.scenarios', 'run_scenario'),
    'to_chrome': ('tracing', 'to_chrome'),
    'use_clock': ('clock', 'use_clock'),
    'verify_bundle': ('profiling.recorder', 'verify_bundle'),
}


def _namespace(root):
    out = {}
    for name, (mod, attr) in _NAMES.items():
        module = importlib.import_module(f"{root}.{mod}" if mod else root)
        try:
            out[name] = getattr(module, attr)
        except AttributeError:
            out[name] = importlib.import_module(f"{module.__name__}.{attr}")
    return types.SimpleNamespace(pkg=root, **out)


PKGS = {"ref": _namespace("tensorfusion_tpu"),
        "port": _namespace("tensorfusion_tpu_torch")}


@pytest.fixture(params=sorted(PKGS))
def m(request):
    return PKGS[request.param]


@functools.lru_cache(maxsize=None)
def _scenario(root, name, seed=42, scale="small"):
    """One scenario run of the package ``root``, shared by the cases that
    read it."""
    m = next(ns for ns in PKGS.values() if ns.pkg == root)
    return m.run_scenario(name, seed=seed, scale=scale)


SCENARIO_NAMES = sorted(PKGS["ref"].SCENARIOS)


# -- SimClock ---------------------------------------------------------------

def test_simclock_sleep_advances_virtual_time_only(m):
    c = m.SimClock()
    t0 = c.now()
    c.sleep(30.0)
    assert c.monotonic() == pytest.approx(30.0)
    assert c.now() - t0 == pytest.approx(30.0)


def test_simclock_timers_fire_in_time_then_seq_order(m):
    c = m.SimClock()
    fired = []
    c.call_later(2.0, lambda: fired.append("b"))
    c.call_later(1.0, lambda: fired.append("a"))
    c.call_later(2.0, lambda: fired.append("c"))   # same due as "b"
    h = c.call_later(1.5, lambda: fired.append("x"))
    h.cancel()
    c.advance(3.0)
    assert fired == ["a", "b", "c"]
    assert c.next_timer() is None


def test_simclock_timer_cascade_fires_within_one_advance(m):
    c = m.SimClock()
    fired = []

    def first():
        fired.append(("first", c.monotonic()))
        c.call_later(1.0, lambda: fired.append(("second",
                                                c.monotonic())))
    c.call_later(1.0, first)
    c.advance(5.0)
    assert fired == [("first", 1.0), ("second", 2.0)]
    assert c.monotonic() == 5.0


def test_simclock_wait_honors_event_and_rejects_unbounded(m):
    c = m.SimClock()
    ev = threading.Event()
    assert c.wait(ev, timeout=1.0) is False
    assert c.monotonic() == pytest.approx(1.0)
    ev.set()
    assert c.wait(ev, timeout=1.0) is True
    assert c.monotonic() == pytest.approx(1.0)   # no advance when set
    with pytest.raises(RuntimeError):
        c.wait(threading.Event())


def test_simclock_monotonic_never_regresses_under_skew(m):
    c = m.SimClock()
    samples = []
    for skew in (0.0, 120.0, -300.0, 45.0, 0.0):
        c.set_skew(skew)
        c.advance(1.0)
        samples.append(c.monotonic())
    assert samples == sorted(samples)
    c.set_skew(-1e6)
    assert c.monotonic() == samples[-1]          # unaffected by skew
    assert c.now() < 0 + 1_700_000_000.0         # wall DID jump


def test_skewed_clock_shifts_wall_not_monotonic(m):
    base = m.SimClock()
    skewed = m.SkewedClock(base, skew_s=90.0)
    assert skewed.now() - base.now() == pytest.approx(90.0)
    assert skewed.monotonic() == base.monotonic()


def test_default_clock_swap_is_scoped(m):
    wall = m.default_clock()
    sim = m.SimClock()
    with m.use_clock(sim):
        assert m.default_clock() is sim
    assert m.default_clock() is wall
    assert isinstance(wall, m.WallClock) or wall is not sim


# -- determinism ------------------------------------------------------------

def _small_run(m, seed):
    with m.SimHarness(seed=seed) as h:
        tg = m.TraceGenerator(h)
        tg.build_cluster(4, 4)
        tg.seeded_churn(duration_s=10.0, workloads=6, max_replicas=3)
        m.NodeCrash(at=6.0, duration_s=5.0,
                    node=tg.node_names[0]).schedule(h)
        h.run_for(30.0)
        return h.log_digest(), len(h.events)


def test_same_seed_identical_event_log_twice(m):
    d1, n1 = _small_run(m, seed=1234)
    d2, n2 = _small_run(m, seed=1234)
    assert (d1, n1) == (d2, n2)
    d3, _ = _small_run(m, seed=1235)
    assert d3 != d1


def test_seeded_churn_gives_the_reference_log():
    assert _small_run(PKGS["port"], 1234) == _small_run(PKGS["ref"], 1234)


# -- fault primitives fire and heal ----------------------------------------

@pytest.fixture()
def loaded_harness(m):
    with m.SimHarness(seed=11) as h:
        tg = m.TraceGenerator(h)
        tg.build_cluster(4, 4)
        for i in range(3):
            tg.submit_workload(tg.make_workload(f"wl-{i}", 2))
        h.run_for(3.0)
        yield h, tg


def test_node_crash_fires_and_heals(m, loaded_harness):
    h, tg = loaded_harness
    node = tg.node_names[0]
    m.NodeCrash(at=5.0, duration_s=10.0, node=node).schedule(h)
    h.run_for(4.0)          # t=7: crashed
    assert h.store.get(m.Node, node).status.phase == \
        m.constants.PHASE_FAILED
    assert node not in h.live_nodes()
    h.run_for(12.0)         # t=19: healed
    assert h.store.get(m.Node, node).status.phase == \
        m.constants.PHASE_RUNNING
    notes = [e for e in h.events if e[1] == "fault"]
    assert [n[3] for n in notes] == ["inject", "heal"]


def test_node_flap_schedules_repeated_cycles(m, loaded_harness):
    h, tg = loaded_harness
    m.NodeFlap(at=4.0, period_s=4.0, count=3,
               node=tg.node_names[1]).schedule(h)
    h.run_for(20.0)
    notes = [e[3] for e in h.events
             if e[1] == "fault" and "node-crash" in e[2]]
    assert notes.count("inject") == 3 and notes.count("heal") == 3


def test_watch_stall_pauses_then_drains(m, loaded_harness):
    h, tg = loaded_harness
    ann = m.constants.ANN_WORKLOAD
    m.WatchStall(at=4.0, duration_s=8.0,
                 controllers=["workload"]).schedule(h)
    h.run_for(2.0)
    tg.submit_workload(tg.make_workload("late-wl", 2))
    h.run_for(4.0)          # t=9: stalled — no workers expanded
    assert "workload" in h.paused
    pods = h.store.list(
        m.Pod, selector=lambda p: p.metadata.annotations.get(ann) == "late-wl")
    assert pods == []
    h.run_for(8.0)          # t=17: healed — backlog drained
    assert "workload" not in h.paused
    pods = h.store.list(
        m.Pod, selector=lambda p: p.metadata.annotations.get(ann) == "late-wl")
    assert len(pods) == 2 and all(p.spec.node_name for p in pods)


def test_partition_freezes_operator_and_heals(m, loaded_harness):
    h, tg = loaded_harness
    ann = m.constants.ANN_WORKLOAD
    m.Partition(at=4.0, duration_s=10.0).schedule(h)
    h.run_for(2.0)
    tg.submit_workload(tg.make_workload("during-part", 2))
    h.run_for(4.0)          # t=10: partitioned — nothing reconciles
    assert h.partitioned
    assert h.store.list(
        m.Pod, selector=lambda p: p.metadata.annotations.get(ann)
        == "during-part") == []
    h.run_for(20.0)         # healed: reconverges from the backlog
    assert not h.partitioned
    assert h.check_converged() == []


def test_store_latency_slows_writes_in_sim_time(m, loaded_harness):
    h, tg = loaded_harness
    m.StoreLatency(at=4.0, duration_s=5.0, latency_s=0.5).schedule(h)
    h.run_for(2.0)          # t=5: latency active
    t0 = h.clock.monotonic()
    tg.submit_workload(tg.make_workload("slow-wl", 1))
    assert h.clock.monotonic() - t0 >= 0.5
    h.run_for(10.0)         # healed
    t0 = h.clock.monotonic()
    tg.submit_workload(tg.make_workload("fast-wl", 1))
    assert h.clock.monotonic() == t0


def test_clock_skew_fault_steps_wall_and_heals(m, loaded_harness):
    h, _ = loaded_harness                    # fixture ends at t=3
    m.ClockSkew(at=6.0, duration_s=6.0, delta_s=3600.0).schedule(h)
    h.run_for(2.0)          # t=5: not yet skewed
    wall_before = h.clock.now()
    h.run_for(2.0)          # t=7: skewed (+3600 on 2s of sim time)
    assert h.clock.now() - wall_before > 3600.0
    h.run_for(6.0)          # t=13: healed
    assert h.clock.skew_s == 0.0


# -- invariants trip on a seeded known-bad mutation ------------------------

@contextlib.contextmanager
def _bad_bind_run(m, seed=21):
    """A harness whose every bind lands on a node that is not live."""
    with m.SimHarness(seed=seed) as h:
        tg = m.TraceGenerator(h)
        tg.build_cluster(3, 4)
        original = h.op._bind_pod

        def bad_bind(pod, node):
            original(pod, "dead-node-x")
        h.op._bind_pod = bad_bind
        h.op.scheduler.bind_fn = bad_bind
        tg.submit_workload(tg.make_workload("bad-wl", 2))
        h.run_for(5.0)
        yield h


def test_invariants_trip_on_seeded_bad_bind(m):
    with _bad_bind_run(m) as h:
        lost = h.check_no_lost_pods()
        assert any("dead node" in v or "bound to dead" in v
                   for v in lost), lost


@contextlib.contextmanager
def _leaked_allocation_run(m, seed):
    with m.SimHarness(seed=seed) as h:
        tg = m.TraceGenerator(h)
        tg.build_cluster(2, 2)
        tg.submit_workload(tg.make_workload("leak-wl", 1))
        h.run_for(3.0)
        # sever the dealloc path, then delete the workload: the allocation
        # record outlives its pod
        h.op.allocator.dealloc = lambda key: None
        tg.delete_workload("leak-wl")
        h.run_for(5.0)
        yield h


def test_invariants_trip_on_leaked_allocation(m):
    with _leaked_allocation_run(m, 22) as h:
        assert h.check_no_leaked_allocations() != []


# -- regression: the real bugs the twin found ------------------------------

def test_dead_node_pods_are_evicted_and_rescheduled(m):
    with m.SimHarness(seed=7) as h:
        tg = m.TraceGenerator(h)
        tg.build_cluster(6, 4)
        for i in range(4):
            tg.submit_workload(tg.make_workload(f"wl-{i}", 3))
        h.run_for(5.0)
        bound_nodes = {p.spec.node_name for p in h.store.list(m.Pod)}
        victim = sorted(bound_nodes)[0]
        m.NodeCrash(at=8.0, duration_s=None, node=victim).schedule(h)
        h.run_for(60.0)
        stranded = [p.key() for p in h.store.list(m.Pod)
                    if p.spec.node_name == victim]
        assert stranded == []
        assert h.check_no_lost_pods() == []
        assert h.check_converged() == []
        node_ctrl = next(c for c in h.op.manager._controllers
                         if c.name == "node")
        assert node_ctrl.evicted_from_dead   # the new path did the work


def test_deleted_workload_workers_are_garbage_collected(m):
    with m.SimHarness(seed=22) as h:
        tg = m.TraceGenerator(h)
        tg.build_cluster(2, 2)
        tg.submit_workload(tg.make_workload("gc-wl", 2))
        h.run_for(3.0)
        assert len(h.store.list(m.Pod)) == 2
        assert len(list(h.op.allocator.allocations())) == 2
        tg.delete_workload("gc-wl")
        h.run_for(10.0)
        assert h.store.list(m.Pod) == []
        assert list(h.op.allocator.allocations()) == []
        assert h.check_no_leaked_allocations() == []


def test_expander_same_second_expansions_do_not_wedge(m):
    c = m.constants

    def miss_pod(name):
        pod = m.Pod.new(name, namespace="default")
        ann = pod.metadata.annotations
        ann[c.ANN_POOL] = "pool-a"
        ann[c.ANN_TFLOPS_REQUEST] = "10"
        ann[c.ANN_HBM_REQUEST] = str(2**28)
        ann[c.ANN_IS_LOCAL_TPU] = "true"
        pod.spec.containers = [m.Container(name="main")]
        return pod

    sim = m.SimClock()
    store = m.ObjectStore()
    ex = m.NodeExpander(store, clock=sim)
    reason = "no eligible chips on any node (insufficient HBM)"

    first = ex.handle_failure(miss_pod("p1"), reason)
    assert first is not None
    ex.clear_inflight("pool-a", "v5e")
    second = ex.handle_failure(miss_pod("p2"), reason)
    assert second is not None and second != first    # no name collision
    assert store.try_get(m.TPUNodeClaim, second) is not None

    ex.clear_inflight("pool-a", "v5e")
    clash = m.TPUNodeClaim.new(f"expand-pool-a-v5e-{int(sim.now())%100000}"
                               f"-{ex._seq + 1}")
    store.create(clash)
    assert ex.handle_failure(miss_pod("p3"), reason) is None  # collided
    third = ex.handle_failure(miss_pod("p4"), reason)
    assert third is not None                 # NOT refused-until-TTL


def test_gang_quorum_completion_requeues_gated_members(m):
    with m.SimHarness(seed=3, sync_interval_s=3600.0) as h:
        tg = m.TraceGenerator(h)
        tg.build_cluster(4, 4)
        h.run_for(1.0)
        tg.submit_workload(tg.make_workload("gang-wl", 4, gang=True,
                                            strict=True))
        h.run_for(10.0)     # event-driven only: no sync side channel
        pods = h.store.list(m.Pod)
        assert len(pods) == 4
        assert all(p.spec.node_name for p in pods), \
            [(p.key(), p.spec.node_name) for p in pods]
        assert h.op.scheduler.scheduled_count == 4


# -- scenario suite at small scale -------------------------------------------

@pytest.mark.parametrize("name", SCENARIO_NAMES)
def test_scenario_passes_at_small_scale(m, name):
    r = _scenario(m.pkg, name)
    assert r["ok"], r["invariants"]
    assert r["pump_exhausted"] == 0


def test_scenario_registry_has_the_named_five(m):
    assert {"rolling-node-failure", "thundering-herd-rescale",
            "partition-heal-reconvergence", "slow-watcher-storm",
            "leader-flap"} <= set(m.SCENARIOS)


def test_the_port_registers_the_reference_scenarios():
    assert sorted(PKGS["port"].SCENARIOS) == SCENARIO_NAMES


@pytest.mark.parametrize("name", SCENARIO_NAMES)
def test_scenario_digests_equal_the_reference_at_small_scale(name):
    ref = _scenario("tensorfusion_tpu", name)
    port = _scenario("tensorfusion_tpu_torch", name)
    for key in ("ok", "log_digest", "trace_digest", "profile_digest",
                "store_events", "trace_spans", "pods_scheduled",
                "sched_failures", "sim_seconds"):
        assert port[key] == ref[key], key


# -- the SimClock cases of the other suites -----------------------------------

def _sim_trace(m, seed):
    """tests/test_tracing.py's virtual-time trace of a small harness run."""
    with m.SimHarness(seed=seed) as h:
        tg = m.TraceGenerator(h)
        tg.build_cluster(4, 4)
        for i in range(3):
            tg.submit_workload(tg.make_workload(f"wl-{i}", 2))
        h.run_for(10.0)
        assert h.trace_spans(), "sim run recorded no spans"
        return m.dumps(m.to_chrome(h.trace_spans()))


def test_sim_same_seed_byte_identical_trace(m):
    a = _sim_trace(m, 7)
    b = _sim_trace(m, 7)
    assert a == b
    doc = json.loads(a)
    ts = [e["ts"] for e in doc["traceEvents"]]
    assert ts and all(1.69e15 < t < 1.71e15 for t in ts)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"workload.spawn", "scheduler.schedule",
            "scheduler.bind"} <= names


def test_sim_trace_is_the_references_byte_for_byte():
    assert _sim_trace(PKGS["port"], 7) == _sim_trace(PKGS["ref"], 7)


def test_serving_scenario_profile_digest_deterministic(m):
    a = m.run_scenario("serving-burst-storm", seed=5, scale="small")
    b = m.run_scenario("serving-burst-storm", seed=5, scale="small")
    assert a["profile_digest"] == b["profile_digest"]
    assert "profile_digest" in a and a["ok"]
    c = m.run_scenario("serving-burst-storm", seed=6, scale="small")
    assert c["profile_digest"] != a["profile_digest"]


def test_harness_scenario_carries_profile_digest(m):
    a = m.run_scenario("thundering-herd-rescale", seed=9, scale="small")
    b = m.run_scenario("thundering-herd-rescale", seed=9, scale="small")
    assert a["profile_digest"] == b["profile_digest"]
    assert a["ok"] and "bundle_digest" not in a


def test_seeded_invariant_failure_attaches_stable_bundle(m):
    def broken_run():
        with _bad_bind_run(m) as h:
            return m.result(h, "unit-broken", 21, "small", time.perf_counter())
    a, b = broken_run(), broken_run()
    assert not a["ok"]
    assert a["bundle_digest"] == b["bundle_digest"]
    assert a["profile_digest"] == b["profile_digest"]


def test_seeded_invariant_bundle_is_the_references():
    def broken_run(m):
        with _bad_bind_run(m) as h:
            return m.result(h, "unit-broken", 21, "small", time.perf_counter())
    ref, port = broken_run(PKGS["ref"]), broken_run(PKGS["port"])
    assert port["bundle_digest"] == ref["bundle_digest"]
    assert port["log_digest"] == ref["log_digest"]


def test_invariant_bundle_written_when_dir_configured(m, tmp_path, monkeypatch):
    monkeypatch.setenv("TPF_SIM_BUNDLE_DIR", str(tmp_path))
    with _leaked_allocation_run(m, 4) as h:
        r = m.result(h, "unit-leak", 4, "small", time.perf_counter())
    assert not r["ok"]
    assert "bundle_path" in r
    assert m.verify_bundle(r["bundle_path"]) == []
    with open(os.path.join(r["bundle_path"], "extra.json")) as f:
        extra = json.load(f)
    assert extra["invariants"]["no_leaked_allocations"]


def test_lease_expiry_across_clock_skew_sim_time(m):
    sim = m.SimClock()
    store = m.ObjectStore()
    a = m.StoreLeaderElector(store, "a", lease_duration_s=10.0,
                             renew_interval_s=2.0, clock=sim)
    a.campaign_tick()
    assert a.is_leader
    behind = m.StoreLeaderElector(store, "slow", lease_duration_s=10.0,
                                  renew_interval_s=2.0,
                                  clock=m.SkewedClock(sim, skew_s=-30.0))
    sim.advance(11.0)               # a silent past the TTL
    behind.campaign_tick()
    assert not behind.is_leader     # its skewed view: lease is fresh
    a.campaign_tick()               # a recovers and renews
    assert a.is_leader
    ahead = m.StoreLeaderElector(store, "fast", lease_duration_s=10.0,
                                 renew_interval_s=2.0,
                                 clock=m.SkewedClock(sim, skew_s=30.0))
    token_before = a.fencing_token
    ahead.campaign_tick()
    assert ahead.is_leader          # premature takeover (skew hazard)
    assert ahead.fencing_token > token_before
    a.campaign_tick()               # a's renew hits the version check
    assert not a.is_leader          # ...and demotes: no split brain


def test_sharded_harness_runs_and_converges(m, tmp_path):
    with m.SimHarness(seed=3, shards=2,
                      persist_dir=str(tmp_path / "cell")) as h:
        for i in range(2):
            op, store = h.owner(i), h.shard_store(i)
            pool = m.TPUPool.new(f"pool-s{i}")
            pool.spec.name = f"pool-s{i}"
            store.create(pool)
            node = f"s{i}-node-0"
            op.register_host(node, [m.make_chip(f"{node}-chip-{c}", node,
                                                pool=f"pool-s{i}")
                                    for c in range(2)])
            wl = m.TPUWorkload.new(f"wl-s{i}", namespace=f"ns-s{i}")
            wl.spec.pool = f"pool-s{i}"
            wl.spec.replicas = 2
            wl.spec.chip_count = 1
            wl.spec.resources.requests = m.ResourceAmount(
                tflops=10.0, hbm_bytes=2 ** 30)
            store.create(wl)
        h.run_for(10.0)
        checks = h.check_all()
        assert not any(checks.values()), checks
        assert len(h.store.list(m.Pod)) == 4
        assert all(p.spec.node_name for p in h.store.list(m.Pod))
        assert [p.shard for p in h.profilers] == ["0", "1"]


# -- the serving engine's storm (tests/test_serving.py) -----------------------

def test_serving_burst_storm_deterministic(m):
    r1 = m.run_scenario("serving-burst-storm", seed=42, scale="small")
    r2 = m.run_scenario("serving-burst-storm", seed=42, scale="small")
    assert r1["ok"], r1["invariants"]
    assert r1["log_digest"] == r2["log_digest"]
    assert r1["trace_digest"] == r2["trace_digest"]
    r3 = m.run_scenario("serving-burst-storm", seed=7, scale="small")
    assert r3["log_digest"] != r1["log_digest"]
    assert r1["preempted"] > 0 and r1["kv_evictions"] > 0


def test_serving_burst_storm_invariants_trip_on_leak(m):
    """The kv-reclaimed invariant can fail in either package: a sequence
    retired without releasing its blocks is caught.  The port's engine
    keeps the names the sabotage patches."""
    engine_cls = m.ServingEngine
    original = engine_cls._maybe_finish

    def leaky(self, seq, events):
        release, self.account.release = (self.account.release,
                                         lambda *a, **k: 0)
        try:
            return original(self, seq, events)
        finally:
            self.account.release = release

    engine_cls._maybe_finish = leaky
    try:
        r = m.run_scenario("serving-burst-storm", seed=42, scale="small")
    finally:
        engine_cls._maybe_finish = original
    assert not r["ok"]
    assert r["invariants"]["kv_reclaimed"]
