"""The port's scheduler (tensorfusion_tpu_torch.scheduler) against the
reference's (tensorfusion_tpu.scheduler).

The reference's own cases (tests/test_scheduler.py) run here as one
parametrised test each, over both packages.  Beside them: one seeded
stream of pods, gangs among them, with priorities, deletions and permit
timeouts, admitted by each package's webhook onto one v5e inventory, gives
both packages the same bindings and the same availability; topology plans
over seeded v5e meshes are equal; and on chips as the NVML provider
publishes them the port ranks by link tier, never by NVML index.
"""

import dataclasses
import time
import types

import numpy as np
import pytest

import tensorfusion_tpu.allocator as ref_allocator
import tensorfusion_tpu.allocator.core as ref_core
import tensorfusion_tpu.api as ref_api
import tensorfusion_tpu.api.types as ref_types
import tensorfusion_tpu.scheduler as ref_scheduler
import tensorfusion_tpu.scheduler.framework as ref_framework
import tensorfusion_tpu.scheduler.topo as ref_topo
import tensorfusion_tpu.scheduler.tpuresources as ref_tpuresources
import tensorfusion_tpu.store as ref_store
import tensorfusion_tpu.webhook as ref_webhook
import tensorfusion_tpu_torch.allocator as port_allocator
import tensorfusion_tpu_torch.allocator.core as port_core
import tensorfusion_tpu_torch.api as port_api
import tensorfusion_tpu_torch.api.types as port_types
import tensorfusion_tpu_torch.scheduler as port_scheduler
import tensorfusion_tpu_torch.scheduler.framework as port_framework
import tensorfusion_tpu_torch.scheduler.topo as port_topo
import tensorfusion_tpu_torch.scheduler.tpuresources as port_tpuresources
import tensorfusion_tpu_torch.store as port_store
import tensorfusion_tpu_torch.webhook as port_webhook
from tensorfusion_tpu import constants as ref_constants
from tensorfusion_tpu_torch import constants as port_constants
from test_torch_allocator import V5E_HBM, V5E_TFLOPS, make_chip

PKGS = {
    "ref": types.SimpleNamespace(
        allocator=ref_allocator, core=ref_core, api=ref_api, types=ref_types,
        scheduler=ref_scheduler, framework=ref_framework, topo=ref_topo,
        tpuresources=ref_tpuresources, store=ref_store, webhook=ref_webhook,
        constants=ref_constants),
    "port": types.SimpleNamespace(
        allocator=port_allocator, core=port_core, api=port_api, types=port_types,
        scheduler=port_scheduler, framework=port_framework, topo=port_topo,
        tpuresources=port_tpuresources, store=port_store, webhook=port_webhook,
        constants=port_constants),
}

@pytest.fixture(params=sorted(PKGS))
def m(request):
    return PKGS[request.param]


class Harness:
    """The reference tests' harness (tests/test_scheduler.py), over ``m``."""

    def __init__(self, m, chips_per_node=4, nodes=2, oversell=100.0, clock=None):
        self.m = m
        self.allocator = m.allocator.TPUAllocator(clock=clock)
        self.allocator.set_pool_oversell("pool-a", oversell)
        self.pods = {}
        self.bound = {}
        self.evicted = []
        idx = 0
        for n in range(nodes):
            for c in range(chips_per_node):
                chip = make_chip(m, f"chip-{idx}", node=f"node-{n}")
                chip.status.mesh = m.types.MeshCoords(x=c % 2, y=c // 2)
                self.allocator.upsert_chip(chip)
                idx += 1
        self.gang = m.scheduler.GangManager(clock=clock)
        self.fit = m.scheduler.TPUResourcesFit(
            self.allocator, gang=self.gang, ports=m.allocator.PortAllocator(),
            indices=m.allocator.IndexAllocator(), pods_on_node=self.pods_on_node,
            evict=self.evict, clock=clock)
        self.scheduler = m.scheduler.Scheduler(
            nodes_fn=lambda: [f"node-{n}" for n in range(nodes)], bind_fn=self.bind,
            clock=clock)
        self.gang.bind_scheduler(self.scheduler)
        self.scheduler.register(self.fit)
        self.scheduler.register(m.scheduler.ICITopologyPlugin())

    def bind(self, pod, node):
        self.bound[pod.key()] = node

    def pods_on_node(self, node):
        return [p for p in self.pods.values() if p.spec.node_name == node]

    def evict(self, pod):
        self.evicted.append(pod.key())
        self.allocator.dealloc(pod.key())
        pod.spec.node_name = ""
        pod.status.phase = self.m.constants.PHASE_PENDING

    def make_pod(self, name, tflops=50.0, hbm=2 * 2**30, count=1, ns="default", priority=0,
                 **ann_extra):
        c = self.m.constants
        pod = self.m.types.Pod.new(name, namespace=ns)
        pod.spec.priority = priority
        ann = pod.metadata.annotations
        ann[c.ANN_POOL] = "pool-a"
        ann[c.ANN_TFLOPS_REQUEST] = str(tflops)
        ann[c.ANN_HBM_REQUEST] = str(hbm)
        ann[c.ANN_CHIP_COUNT] = str(count)
        ann.update(ann_extra)
        self.pods[pod.key()] = pod
        return pod


def _wait(pred, timeout):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.02)
    return pred()


# -- the reference's cases (tests/test_scheduler.py), both packages ----------

def test_schedule_one_basic(m):
    h = Harness(m)
    pod = h.make_pod("p1")
    st = h.scheduler.schedule_one(pod)
    assert st.ok
    assert pod.key() in h.bound
    assert pod.spec.node_name in ("node-0", "node-1")
    ann = pod.metadata.annotations
    assert ann[m.constants.ANN_CHIP_IDS]
    assert ann[m.constants.ANN_POD_INDEX] == "0"
    rec = h.allocator.allocation(pod.key())
    assert rec is not None and not rec.assumed


def test_unschedulable_reports_reasons(m):
    h = Harness(m)
    pod = h.make_pod("big", tflops=5000.0)
    st = h.scheduler.schedule_one(pod)
    assert st.code == m.scheduler.Code.UNSCHEDULABLE
    assert "insufficient tflops" in st.reason or "no eligible" in st.reason
    assert h.allocator.allocation(pod.key()) is None


def test_host_port_assignment(m):
    c = m.constants
    h = Harness(m)
    pod = h.make_pod("svc")
    pod.metadata.labels[c.LABEL_HOST_PORT] = c.LABEL_HOST_PORT_AUTO
    assert h.scheduler.schedule_one(pod).ok
    port = int(pod.metadata.annotations[c.ANN_PORT_NUMBER])
    assert c.NODE_PORT_RANGE[0] <= port < c.NODE_PORT_RANGE[1]


def test_topology_prefers_contiguous_submesh(m):
    h = Harness(m, chips_per_node=4, nodes=1)
    pod = h.make_pod("pair", count=2, tflops=10.0, hbm=2**30)
    assert h.scheduler.schedule_one(pod).ok
    rec = h.allocator.allocation(pod.key())
    coords = [h.allocator.get_chip(c).chip.status.mesh for c in rec.chip_ids]
    dist = abs(coords[0].x - coords[1].x) + abs(coords[0].y - coords[1].y)
    assert dist == 1


def test_plan_least_damage_avoids_shattering_the_mesh(m):
    chips = []
    for i in range(4):
        chip = make_chip(m, f"line-{i}", node="n")
        chip.status.mesh = m.types.MeshCoords(x=i, y=0)
        chips.append(m.core.ChipState(chip))
    plan = m.scheduler.plan_for_node(chips, 2)
    assert plan is not None and plan.contiguous and plan.max_hops == 1
    taken = {int(name.split("-")[1]) for name in plan.chip_names}
    assert taken != {1, 2}, "middle pair shatters the remaining mesh"


def test_plan_for_node_rectangle_detection(m):
    chips = []
    for i in range(8):  # 2x4 mesh
        chip = make_chip(m, f"m-{i}", node="n")
        chip.status.mesh = m.types.MeshCoords(x=i % 2, y=i // 2)
        chips.append(m.core.ChipState(chip))
    plan = m.scheduler.plan_for_node(chips, 4)
    assert plan is not None
    assert plan.contiguous          # 2x2 square exists
    assert plan.max_hops == 2       # corners of the 2x2 square
    plan8 = m.scheduler.plan_for_node(chips, 8)
    assert plan8.contiguous and len(plan8.chip_names) == 8


def test_gang_all_or_nothing(m):
    c = m.constants
    h = Harness(m, chips_per_node=4, nodes=2)
    h.scheduler.start()
    try:
        gang_ann = {c.ANN_WORKLOAD: "trainer", c.ANN_GANG_ENABLED: "true",
                    c.ANN_GANG_DESIRED_MEMBERS: "3", c.ANN_GANG_REQUIRED_MEMBERS: "3",
                    c.ANN_GANG_TIMEOUT: "30"}
        pods = [h.make_pod(f"g{i}", tflops=20.0, hbm=2**30, **gang_ann) for i in range(2)]
        for p in pods:
            h.scheduler.enqueue(p)
        time.sleep(0.3)
        assert not h.bound          # quorum 3 not met: nothing bound, pods gated

        third = h.make_pod("g2", tflops=20.0, hbm=2**30, **gang_ann)
        h.scheduler.enqueue(third)
        h.scheduler.activate()
        assert _wait(lambda: len(h.bound) == 3, 5)
        for p in pods + [third]:
            rec = h.allocator.allocation(p.key())
            assert rec is not None and not rec.assumed
    finally:
        h.scheduler.stop()


def test_gang_permit_timeout_rejects(m):
    c = m.constants
    h = Harness(m, chips_per_node=2, nodes=1)
    h.scheduler.start()
    try:
        gang_ann = {c.ANN_WORKLOAD: "timeout-gang", c.ANN_GANG_ENABLED: "true",
                    c.ANN_GANG_DESIRED_MEMBERS: "2", c.ANN_GANG_REQUIRED_MEMBERS: "2",
                    c.ANN_GANG_TIMEOUT: "0.3"}
        p1 = h.make_pod("t1", tflops=20.0, hbm=2**30, **gang_ann)
        p2 = h.make_pod("t2", tflops=5000.0, hbm=2**30, **gang_ann)
        h.scheduler.enqueue(p1)
        h.scheduler.enqueue(p2)
        h.scheduler.activate()
        assert _wait(lambda: h.scheduler.waiting_pods(), 2)
        assert h.scheduler.waiting_pods() == [p1.key()]
        rec = h.allocator.allocation(p1.key())
        assert rec is not None and rec.assumed  # held during the wait

        assert _wait(lambda: not h.scheduler.waiting_pods(), 3)   # permit timeout fired
        assert h.allocator.allocation(p1.key()) is None  # unreserved
        assert not h.bound
    finally:
        h.scheduler.stop()


def test_gang_group_cleanup_and_exponential_backoff(m):
    c = m.constants
    gm = m.scheduler.GangManager()
    bounced = []

    def reject(key, reason):
        bounced.append(key)
        gm.on_permit_rejected(key, reason)
        return True

    gm.reject_fn = reject

    def gpod(name):
        pod = m.types.Pod.new(name, namespace="d")
        ann = pod.metadata.annotations
        ann[c.ANN_WORKLOAD] = "wl"
        ann[c.ANN_GANG_ENABLED] = "true"
        ann[c.ANN_GANG_DESIRED_MEMBERS] = "3"
        ann[c.ANN_GANG_MIN_MEMBERS] = "3"
        return pod

    p1, p2, p3 = gpod("a"), gpod("b"), gpod("c")
    for p in (p1, p2, p3):
        gm.observe(p)
    g = gm.group_of(p1.key())
    assert g.strict

    st, _ = gm.permit(p1)
    assert st.code == m.scheduler.Code.WAIT
    st, _ = gm.permit(p2)
    assert st.code == m.scheduler.Code.WAIT

    gm.on_permit_rejected(p1.key(), "permit timeout")
    assert bounced == [p2.key()]          # group-level cleanup, no waiting
    assert not g.waiting
    assert g.reject_count == 1
    assert g.rejected_until > time.time()

    gm._backoff(g)
    gm._backoff(g)
    assert g.reject_count == 3
    assert g.rejected_until - time.time() > 6.0   # 2*2^2 = 8s, capped at 60

    gm.observe(gpod("d"))
    assert g.rejected_until == 0.0


def test_preemption_with_eviction_protection(m):
    h = Harness(m, chips_per_node=1, nodes=1)
    low1 = h.make_pod("low1", tflops=100.0, hbm=4 * 2**30, priority=1)
    low2 = h.make_pod("low2", tflops=90.0, hbm=4 * 2**30, priority=2)
    assert h.scheduler.schedule_one(low1).ok
    assert h.scheduler.schedule_one(low2).ok
    for p in (low1, low2):
        p.spec.node_name = h.bound[p.key()]
    low1.metadata.annotations[m.constants.ANN_EVICTION_PROTECTION] = "true"

    high = h.make_pod("high", tflops=95.0, hbm=4 * 2**30, priority=100)
    h.scheduler.schedule_one(high)
    assert h.evicted == ["default/low2"]
    assert high.status.nominated_node_name == "node-0"
    assert h.scheduler.schedule_one(high).ok
    assert h.allocator.allocation("default/high") is not None


def test_preemption_per_chip_fit(m):
    c = m.constants
    h = Harness(m, chips_per_node=2, nodes=1)
    v1 = h.make_pod("v1", tflops=50.0, hbm=15 * 2**30, priority=1,
                    **{c.ANN_CHIP_INDICES: "0"})
    v2 = h.make_pod("v2", tflops=187.0, hbm=6 * 2**30, priority=2,
                    **{c.ANN_CHIP_INDICES: "1"})
    assert h.scheduler.schedule_one(v1).ok
    assert h.scheduler.schedule_one(v2).ok
    for p in (v1, v2):
        p.spec.node_name = h.bound[p.key()]

    high = h.make_pod("high", tflops=100.0, hbm=5 * 2**30, priority=100)
    h.scheduler.schedule_one(high)
    assert h.evicted == ["default/v1"]      # lowest priority, frees chip-0
    assert high.status.nominated_node_name == "node-0"
    assert h.scheduler.schedule_one(high).ok


def test_nominated_node_reserved_against_lower_priority(m):
    h = Harness(m, chips_per_node=1, nodes=1)
    low = h.make_pod("low", tflops=150.0, hbm=4 * 2**30, priority=1)
    assert h.scheduler.schedule_one(low).ok
    low.spec.node_name = h.bound[low.key()]

    high = h.make_pod("high", tflops=150.0, hbm=4 * 2**30, priority=100)
    h.scheduler.schedule_one(high)
    assert h.evicted == ["default/low"]
    assert high.status.nominated_node_name == "node-0"

    thief = h.make_pod("thief", tflops=150.0, hbm=2 * 2**30, priority=5)
    assert not h.scheduler.schedule_one(thief).ok
    assert thief.key() not in h.bound

    small = h.make_pod("small", tflops=30.0, hbm=2 * 2**30, priority=5)
    assert h.scheduler.schedule_one(small).ok

    assert h.scheduler.schedule_one(high).ok
    assert h.bound[high.key()] == "node-0"


def test_dry_run_fit_is_pool_scoped(m):
    h = Harness(m, chips_per_node=1, nodes=1)
    h.allocator.upsert_chip(make_chip(m, "dev-9", node="node-0", pool="pool-dev"))

    victim = h.make_pod("victim", tflops=150.0, hbm=4 * 2**30, priority=1)
    assert h.scheduler.schedule_one(victim).ok
    victim.spec.node_name = h.bound[victim.key()]

    high = h.make_pod("high", tflops=150.0, hbm=4 * 2**30, priority=100)
    h.scheduler.schedule_one(high)
    assert h.evicted == ["default/victim"]
    assert high.status.nominated_node_name == "node-0"


def test_unreserve_restores_nomination(m):
    h = Harness(m, chips_per_node=1, nodes=1)
    low = h.make_pod("low", tflops=150.0, hbm=4 * 2**30, priority=1)
    assert h.scheduler.schedule_one(low).ok
    low.spec.node_name = h.bound[low.key()]

    high = h.make_pod("high", tflops=150.0, hbm=4 * 2**30, priority=100)
    h.scheduler.schedule_one(high)
    assert high.key() in h.fit._nominations

    state = m.framework.CycleState()
    state[m.tpuresources.STATE_ALLOC_REQUEST] = m.tpuresources.compose_alloc_request(high)
    assert h.fit.pre_filter(state, high).ok
    assert h.fit.reserve(state, high, "node-0").ok
    assert high.key() not in h.fit._nominations   # suspended while assumed
    h.fit.unreserve(state, high, "node-0")
    assert high.key() in h.fit._nominations       # restored on failure


def test_scheduler_loop_end_to_end(m):
    h = Harness(m)
    h.scheduler.start()
    try:
        pods = [h.make_pod(f"loop{i}", tflops=20.0, hbm=2**30) for i in range(8)]
        for p in pods:
            h.scheduler.enqueue(p)
        assert _wait(lambda: len(h.bound) == 8, 5)
    finally:
        h.scheduler.stop()


def test_a_preemptor_is_parked_before_its_reason_is_reported(m):
    """The loop reports a preemptor's reason only once the pod is parked,
    so an activate() after the report requeues it and it binds: the order
    a caller that requeues on the victim's deletion relies on."""
    h = Harness(m, chips_per_node=1, nodes=1)
    low = h.make_pod("low", tflops=150.0, hbm=4 * 2**30, priority=1)
    assert h.scheduler.schedule_one(low).ok
    low.spec.node_name = h.bound[low.key()]
    reported = {}

    def failed(pod, reason):
        reported[pod.key()] = (reason, pod.key() in h.scheduler._unschedulable)

    h.scheduler.failure_handler = failed
    high = h.make_pod("high", tflops=150.0, hbm=4 * 2**30, priority=100)
    h.scheduler.start()
    try:
        h.scheduler.enqueue(high)
        assert _wait(lambda: high.key() in reported, 5)
        reason, parked = reported[high.key()]
        assert "after preemption" in reason and parked
        assert h.evicted == ["default/low"] and high.key() not in h.bound
        h.scheduler.activate()
        assert _wait(lambda: high.key() in h.bound, 5)
        assert h.bound[high.key()] == "node-0"
    finally:
        h.scheduler.stop()


def test_compose_native_request_for_proxied_pod(m):
    compose = m.tpuresources.compose_alloc_request
    pod = m.types.Pod.new("native-proxy", namespace="default")
    pod.spec.containers = [m.types.Container(name="a", chip_count=3),
                           m.types.Container(name="b", chip_count=1)]
    assert compose(pod) is None
    req = compose(pod, include_native=True)
    assert req is not None
    assert req.chip_count == 4
    assert req.request.duty_percent == 100.0
    assert req.isolation == m.constants.ISOLATION_SHARED
    empty = m.types.Pod.new("plain", namespace="default")
    empty.spec.containers = [m.types.Container(name="main")]
    assert compose(empty, include_native=True) is None


def test_gang_slice_affinity_keeps_members_on_one_fabric(m):
    c = m.constants
    h = Harness(m, chips_per_node=1, nodes=4)
    for chip in h.allocator.chips():
        node = chip.chip.status.node_name
        chip.chip.status.slice_id = "slice-A" if node in ("node-0", "node-1") else "slice-B"
    h.scheduler.plugins = [p for p in h.scheduler.plugins
                           if not isinstance(p, m.scheduler.ICITopologyPlugin)]
    h.scheduler.register(m.scheduler.ICITopologyPlugin(
        gang_slices=h.allocator.gang_slice_ids, node_slices=h.allocator.node_slice_ids))

    gang_ann = {c.ANN_WORKLOAD: "spmd", c.ANN_GANG_GROUP_KEY: "default/spmd",
                c.ANN_GANG_ENABLED: "true"}
    first = h.make_pod("m0", tflops=150.0, hbm=2**30, **gang_ann)
    assert h.scheduler.schedule_one(first).ok
    first_slice = h.allocator.get_chip(
        h.allocator.allocation(first.key()).chip_ids[0]).chip.status.slice_id

    second = h.make_pod("m1", tflops=150.0, hbm=2**30, **gang_ann)
    assert h.scheduler.schedule_one(second).ok
    second_slice = h.allocator.get_chip(
        h.allocator.allocation(second.key()).chip_ids[0]).chip.status.slice_id
    assert second_slice == first_slice
    assert second.spec.node_name != first.spec.node_name
    assert h.allocator.gang_slice_ids("default/spmd") == {first_slice}


# -- a seeded pod stream, gangs and priorities, on one v5e inventory ---------

class _StepClock:
    """A hand-driven clock: monotonic() ticks a microsecond a read, so the
    queue's ties are broken in submission order in both packages."""

    def __init__(self):
        self.t = 5000.0

    def now(self):
        return self.t

    def monotonic(self):
        self.t += 1e-6
        return self.t


def _stream_events(seed, n):
    rng = np.random.default_rng(seed)
    events, live, gangs = [], [], 0
    i = 0
    while len(events) < n:
        r = rng.random()
        if r < 0.12:
            # a gang: its members arrive together, one of them too big
            # now and then (a strict gang then binds none)
            gangs += 1
            size = int(rng.integers(2, 4))
            big = rng.random() < 0.3
            for j in range(size):
                ann = {ref_constants.ANN_WORKLOAD: f"gang-{gangs}",
                       ref_constants.ANN_GANG_ENABLED: "true",
                       ref_constants.ANN_GANG_MIN_MEMBERS: str(size),
                       ref_constants.ANN_GANG_TIMEOUT: "5",
                       ref_constants.ANN_TFLOPS_REQUEST: "2000" if big and j == 0 else "30",
                       ref_constants.ANN_HBM_REQUEST: "1Gi",
                       ref_constants.ANN_QOS: str(rng.choice(["low", "high"]))}
                events.append(("submit", f"g{gangs}-{j}", ann))
                live.append(f"g{gangs}-{j}")
        elif r < 0.75:
            ann = {ref_constants.ANN_HBM_REQUEST: f"{int(rng.integers(1, 9))}Gi",
                   ref_constants.ANN_QOS: str(rng.choice(ref_constants.QOS_LEVELS)),
                   ref_constants.ANN_CHIP_COUNT: str(int(rng.choice([1, 1, 1, 2, 4])))}
            if rng.random() < 0.5:
                ann[ref_constants.ANN_TFLOPS_REQUEST] = str(int(rng.integers(10, 190)))
            else:
                ann[ref_constants.ANN_DUTY_REQUEST] = str(int(rng.integers(5, 95)))
                ann[ref_constants.ANN_CHIP_GENERATION] = "v5e"
            events.append(("submit", f"p{i}", ann))
            live.append(f"p{i}")
        elif r < 0.9 and live:
            events.append(("delete", live.pop(int(rng.integers(len(live)))), None))
        else:
            events.append(("tick", float(rng.choice([0.5, 3.0, 7.0])), None))
        i += 1
    return events


class _World:
    """One package's webhook, allocator and scheduler over an in-memory
    store, stepped without threads (run_until_idle)."""

    def __init__(self, m):
        self.m = m
        self.clock = _StepClock()
        self.store = m.store.ObjectStore()
        chip_models = {"v5e": m.types.ChipModelInfo(generation="v5e", bf16_tflops=V5E_TFLOPS,
                                                    hbm_bytes=V5E_HBM)}
        self.mutator = m.webhook.PodMutator(
            self.store, m.webhook.WorkloadParser(self.store, chip_models=chip_models,
                                                 default_pool="pool-a"), clock=self.clock)
        self.h = Harness(m, chips_per_node=4, nodes=3, oversell=200.0, clock=self.clock)
        self.h.evict = self.evict
        self.h.fit.evict = self.evict

    def evict(self, pod):
        self.h.evicted.append(pod.key())
        self.h.allocator.dealloc(pod.key())
        self.h.bound.pop(pod.key(), None)
        pod.spec.node_name = ""
        pod.status.phase = self.m.constants.PHASE_PENDING

    def apply(self, event):
        kind, arg, ann = event
        sched, gang, alloc = self.h.scheduler, self.h.gang, self.h.allocator
        if kind == "submit":
            pod = self.m.types.Pod.new(arg, namespace="default")
            pod.metadata.annotations.update(ann)
            pod.spec.containers = [self.m.types.Container(name="main")]
            pod = self.mutator.handle(pod)
            self.h.pods[pod.key()] = pod
            sched.enqueue(pod)
        elif kind == "delete":
            key = f"default/{arg}"
            self.h.pods.pop(key, None)
            sched.forget(key)
            gang.on_pod_deleted(key)
            alloc.dealloc(key)
            self.h.bound.pop(key, None)
            sched.activate()
        else:
            self.clock.t += arg
            sched.check_permit_timeouts()
            alloc.sweep_assumed()
            sched.activate()
        sched.run_until_idle()
        for key, node in self.h.bound.items():
            self.h.pods[key].spec.node_name = node

    def state(self):
        alloc = self.h.allocator
        return {
            "bound": dict(sorted(self.h.bound.items())),
            "chips": {k: alloc.allocation(k).chip_ids for k in sorted(self.h.bound)},
            "evicted": list(self.h.evicted),
            "waiting": sorted(self.h.scheduler.waiting_pods()),
            "available": {c.chip.name: dataclasses.asdict(c.available())
                          for c in sorted(alloc.chips(), key=lambda s: s.chip.name)},
        }


def test_seeded_pod_stream_gives_equal_bindings_in_both_packages():
    events = _stream_events(1414, 160)
    worlds = {name: _World(m) for name, m in PKGS.items()}
    for step, event in enumerate(events):
        for w in worlds.values():
            w.apply(event)
        ref, port = worlds["ref"].state(), worlds["port"].state()
        assert port == ref, (step, event)
    final = worlds["port"].state()
    gang_keys = [k for k in final["bound"] if k.startswith("default/g")]
    assert len(final["bound"]) > 10 and gang_keys and final["evicted"]
    assert worlds["port"].h.scheduler.scheduled_count == \
        worlds["ref"].h.scheduler.scheduled_count > 20


# -- topology: the reference's meshes, then chips as NVML publishes them -----

def _mesh_states(m, rng, n, links=False):
    xs, ys = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    states = []
    cells = [(x, y) for y in range(ys) for x in range(xs)]
    for i, (x, y) in enumerate(cells[:n]):
        chip = make_chip(m, f"c{i}", node="n")
        chip.status.mesh = m.types.MeshCoords(x=x, y=y)
        states.append(chip)
    if links:
        for a in states:
            for b in states:
                d = abs(a.status.mesh.x - b.status.mesh.x) + abs(a.status.mesh.y
                                                                 - b.status.mesh.y)
                if a is not b and d == 1:
                    a.status.ici_links.append(m.types.ICILink(
                        peer_chip_id=b.metadata.name, kind="ici", hops=1))
    return [m.core.ChipState(c) for c in states]


def test_topology_plans_on_v5e_meshes_equal_the_reference():
    rng = np.random.default_rng(5)
    cases = 0
    for _ in range(40):
        seed = int(rng.integers(1 << 30))
        n = int(rng.integers(2, 17))
        links = bool(rng.random() < 0.5)
        plans = {}
        for name, m in PKGS.items():
            states = _mesh_states(m, np.random.default_rng(seed), n, links)
            count = int(np.random.default_rng(seed + 1).integers(1, len(states) + 1))
            plan = m.scheduler.plan_for_node(states, count)
            plans[name] = None if plan is None else dataclasses.asdict(plan)
        assert plans["port"] == plans["ref"], seed
        cases += plans["ref"] is not None
    assert cases > 30


def _nvml_chips(m, n, nvlink_pairs=(), routed="ici-routed", generation="h100-pcie"):
    """Chips as the node agent publishes the NVML provider's: vendor
    nvidia, mesh_x the NVML index, NVLink peers at 1 hop, every other peer
    of the card a routed (or cross-socket) link at hops -1."""
    chips = []
    for i in range(n):
        chip = make_chip(m, f"GPU-{i:04d}", node="box", generation=generation,
                         vendor="nvidia", tflops=756.0, hbm=80 << 30)
        chip.status.mesh = m.types.MeshCoords(x=i, y=0, z=0)
        chip.status.host_index = i
        chips.append(chip)
    nv = {frozenset(p) for p in nvlink_pairs}
    for a in chips:
        for b in chips:
            if a is b:
                continue
            pair = frozenset((a.status.host_index, b.status.host_index))
            if pair in nv:
                link = m.types.ICILink(peer_chip_id=b.metadata.name,
                                       peer_index=b.status.host_index, kind="ici", hops=1,
                                       gbps=300.0)
            elif routed:
                link = m.types.ICILink(peer_chip_id=b.metadata.name,
                                       peer_index=b.status.host_index, kind=routed, hops=-1,
                                       gbps=64.0)
            else:
                continue
            a.status.ici_links.append(link)
    return [m.core.ChipState(c) for c in chips]


def _indices(plan):
    return sorted(int(n.split("-")[1]) for n in plan.chip_names)


def test_nvidia_pcie_box_prefers_the_nvlink_bridged_pair():
    # three PCIe cards behind one switch; only 0 and 2 share an NVLink bridge
    port_plan = port_scheduler.plan_for_node(_nvml_chips(PKGS["port"], 3, [(0, 2)]), 2)
    assert _indices(port_plan) == [0, 2]
    assert port_plan.contiguous and port_plan.max_hops == 1
    # the reference's arithmetic takes the index run {0, 1} as 1 hop apart
    ref_plan = ref_scheduler.plan_for_node(_nvml_chips(PKGS["ref"], 3, [(0, 2)]), 2)
    assert _indices(ref_plan) == [0, 1] and ref_plan.contiguous

    # four cards, bridges {0, 2} and {1, 3}: a pair is always a bridged one,
    # and four cards are no clique
    chips = _nvml_chips(PKGS["port"], 4, [(0, 2), (1, 3)])
    assert _indices(port_scheduler.plan_for_node(chips, 2)) in ([0, 2], [1, 3])
    four = port_scheduler.plan_for_node(chips, 4)
    assert not four.contiguous and four.max_hops == port_topo.LINK_TIER_STEPS["ici-routed"]
    # a routed pair beats a cross-socket one
    cross = _nvml_chips(PKGS["port"], 3, [], routed="dcn")
    cross[0].chip.status.ici_links[0].kind = "ici-routed"        # 0 -> 1 routed
    assert _indices(port_scheduler.plan_for_node(cross, 2)) == [0, 1]


def test_nvidia_sxm_node_counts_any_set_as_contiguous():
    chips = _nvml_chips(PKGS["port"], 8, [(a, b) for a in range(8) for b in range(a + 1, 8)],
                        generation="h100-sxm")
    for count in (2, 3, 5, 8):
        plan = port_scheduler.plan_for_node(chips, count)
        assert plan.contiguous and plan.max_hops == 1 and plan.score == 90.0
    # any subset the filter leaves is a clique too, however scattered its indices
    scattered = [chips[i] for i in (0, 3, 6, 7)]
    plan = port_scheduler.plan_for_node(scattered, 3)
    assert plan.contiguous and plan.max_hops == 1


def test_nvidia_chips_without_links_are_not_adjacent_by_index():
    chips = _nvml_chips(PKGS["port"], 4, [], routed=None)
    plan = port_scheduler.plan_for_node(chips, 2)
    assert not plan.contiguous and plan.max_hops == port_topo.NO_LINK_STEPS
    assert plan.score == 0.0
    # the reference calls the index run a 1-hop rectangle
    ref_plan = ref_scheduler.plan_for_node(_nvml_chips(PKGS["ref"], 4, [], routed=None), 2)
    assert ref_plan.contiguous and ref_plan.max_hops == 1

    # through the plugin: no published link means unknown topology, not a mesh
    plugin = port_scheduler.ICITopologyPlugin()
    state = port_framework.CycleState()
    req = port_api.AllocRequest(pool="pool-a", namespace="default", pod_name="p",
                                request=port_api.ResourceAmount(tflops=10.0), chip_count=2)
    state[port_topo.STATE_ALLOC_REQUEST] = req
    state[port_topo.STATE_CANDIDATES] = {"box": chips}
    assert plugin.pre_filter(state, port_types.Pod.new("p", namespace="default")).ok
    assert state[port_topo.STATE_TOPO_PLANS]["box"].contiguous is False


def test_nvidia_topology_through_the_scheduler():
    """A 2-card pod on a PCIe box is bound to the NVLink-bridged pair."""
    m = PKGS["port"]
    alloc = m.allocator.TPUAllocator()
    for st in _nvml_chips(m, 4, [(0, 2), (1, 3)]):
        st.chip.status.pool = "pool-a"
        alloc.upsert_chip(st.chip)
    bound = {}
    sched = m.scheduler.Scheduler(nodes_fn=lambda: ["box"],
                                  bind_fn=lambda pod, node: bound.update({pod.key(): node}))
    sched.register(m.scheduler.TPUResourcesFit(alloc))
    sched.register(m.scheduler.ICITopologyPlugin())
    pod = m.types.Pod.new("pair", namespace="default")
    pod.metadata.annotations.update({
        m.constants.ANN_POOL: "pool-a", m.constants.ANN_TFLOPS_REQUEST: "100",
        m.constants.ANN_HBM_REQUEST: str(1 << 30), m.constants.ANN_CHIP_COUNT: "2"})
    assert sched.schedule_one(pod).ok
    ids = sorted(alloc.allocation(pod.key()).chip_ids)
    assert ids in (["GPU-0000", "GPU-0002"], ["GPU-0001", "GPU-0003"])


@pytest.mark.parametrize("ann,reason", [
    ({port_constants.ANN_PARTITION_NAME: "h100-pcie-full"}, "core partitioning"),
    ({port_constants.ANN_ISOLATION: port_constants.ISOLATION_HARD}, "hard isolation"),
])
def test_nvml_chips_refuse_what_the_provider_cannot_grant(ann, reason):
    """The NVML provider publishes the whole card only (no core
    partitioning, no hard caps): a partitioned or hard-isolated pod is
    admitted, then refused by the scheduler with a reason, never bound."""
    m = PKGS["port"]
    alloc = m.allocator.TPUAllocator()
    for st in _nvml_chips(m, 2, [(0, 1)]):
        st.chip.status.pool = "pool-a"
        st.chip.status.capabilities = {"core_partitioning": False, "soft_isolation": True,
                                       "hard_isolation": False}
        alloc.upsert_chip(st.chip)
    bound = {}
    sched = m.scheduler.Scheduler(nodes_fn=lambda: ["box"],
                                  bind_fn=lambda pod, node: bound.update({pod.key(): node}))
    sched.register(m.scheduler.TPUResourcesFit(alloc))
    store = m.store.ObjectStore()
    mutator = m.webhook.PodMutator(store, m.webhook.WorkloadParser(store,
                                                                   default_pool="pool-a"))
    pod = m.types.Pod.new("part", namespace="default")
    pod.metadata.annotations.update({m.constants.ANN_TFLOPS_REQUEST: "100",
                                     m.constants.ANN_HBM_REQUEST: "1Gi", **ann})
    pod.spec.containers = [m.types.Container(name="main")]
    st = sched.schedule_one(mutator.handle(pod))
    assert st.code == m.scheduler.Code.UNSCHEDULABLE and reason in st.reason
    assert not bound and alloc.allocation(pod.key()) is None
