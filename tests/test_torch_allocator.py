"""The port's allocator (tensorfusion_tpu_torch.allocator) against the
reference's (tensorfusion_tpu.allocator).

The reference's own cases (tests/test_allocator.py) run here as one
parametrised test each, over both packages.  Beside them: a pod stamped by
one package's allocator loads through the other's ``parse_pod`` into an
equal record, and one seeded stream of allocations, releases, resizes,
quota changes, assumes and sweeps gives both packages equal records, equal
availability and equal synced TPUChip and TPUResourceQuota objects.
"""

import dataclasses
import types

import numpy as np
import pytest

import tensorfusion_tpu.allocator as ref_allocator
import tensorfusion_tpu.allocator.core as ref_core
import tensorfusion_tpu.allocator.partition_planner as ref_planner
import tensorfusion_tpu.allocator.vecview as ref_vecview
import tensorfusion_tpu.api as ref_api
import tensorfusion_tpu.api.types as ref_types
import tensorfusion_tpu.store as ref_store
import tensorfusion_tpu_torch.allocator as port_allocator
import tensorfusion_tpu_torch.allocator.core as port_core
import tensorfusion_tpu_torch.allocator.partition_planner as port_planner
import tensorfusion_tpu_torch.allocator.vecview as port_vecview
import tensorfusion_tpu_torch.api as port_api
import tensorfusion_tpu_torch.api.types as port_types
import tensorfusion_tpu_torch.store as port_store
from tensorfusion_tpu import constants as ref_constants
from tensorfusion_tpu_torch import constants as port_constants

PKGS = {
    "ref": types.SimpleNamespace(allocator=ref_allocator, core=ref_core, planner=ref_planner,
                                 vecview=ref_vecview, api=ref_api, types=ref_types,
                                 store=ref_store, constants=ref_constants),
    "port": types.SimpleNamespace(allocator=port_allocator, core=port_core,
                                  planner=port_planner, vecview=port_vecview, api=port_api,
                                  types=port_types, store=port_store,
                                  constants=port_constants),
}

#: the reference tests' chip (tests/helpers.py), built in either package
V5E_TFLOPS = 197.0
V5E_HBM = 16 * 2**30


@pytest.fixture(params=sorted(PKGS))
def m(request):
    return PKGS[request.param]


def make_chip(m, name, node="node-a", pool="pool-a", generation="v5e", cores=1, caps=None,
              vendor="mock-tpu", tflops=V5E_TFLOPS, hbm=V5E_HBM):
    """The reference tests' chip (tests/helpers.py), built in package ``m``
    (the scheduler tests import it too)."""
    chip = m.types.TPUChip.new(name)
    st = chip.status
    st.phase = m.constants.PHASE_RUNNING
    st.capacity = m.api.ResourceAmount(tflops=tflops, duty_percent=100, hbm_bytes=hbm)
    st.available = st.capacity
    st.generation = generation
    st.vendor = vendor
    st.node_name = node
    st.pool = pool
    st.core_count = cores
    st.host_index = int(name[-1]) if name[-1].isdigit() else 0
    st.capabilities = caps or {"core_partitioning": cores > 1, "soft_isolation": True,
                               "hard_isolation": True}
    return chip


def make_allocator(m, n_chips=4, nodes=2, oversell=100.0, store=None):
    alloc = m.allocator.TPUAllocator(store=store)
    alloc.set_pool_oversell("pool-a", oversell)
    for i in range(n_chips):
        node = f"node-{chr(ord('a') + i * nodes // n_chips)}"
        alloc.upsert_chip(make_chip(m, f"chip-{i}", node=node))
    return alloc


def req(m, pod="p1", tflops=50.0, hbm=2 * 2**30, count=1, ns="default", **kw):
    amt = m.api.ResourceAmount
    return m.api.AllocRequest(pool="pool-a", namespace=ns, pod_name=pod,
                              request=amt(tflops=tflops, hbm_bytes=hbm),
                              limit=amt(tflops=tflops * 2, hbm_bytes=hbm),
                              chip_count=count, **kw)


# -- the reference's cases (tests/test_allocator.py), both packages ----------

def test_filter_and_alloc_basic(m):
    alloc = make_allocator(m)
    record = alloc.alloc(req(m))
    assert len(record.chip_ids) == 1
    assert not record.assumed
    state = alloc.get_chip(record.chip_ids[0])
    assert state.allocated.tflops == 50.0
    alloc.dealloc(record.key)
    assert alloc.get_chip(record.chip_ids[0]).allocated.tflops == 0


def test_filter_rejections_reported(m):
    alloc = make_allocator(m)
    by_node, rejections = alloc.check_quota_and_filter(req(m, tflops=1000.0))
    assert not by_node
    assert len(rejections) == 4
    assert "insufficient tflops" in next(iter(rejections.values()))

    by_node, rejections = alloc.check_quota_and_filter(req(m, generation="v9x"))
    assert not by_node
    assert all("generation" in r for r in rejections.values())


def test_same_node_multi_chip(m):
    alloc = make_allocator(m, n_chips=4, nodes=2)  # 2 chips per node
    by_node, rejections = alloc.check_quota_and_filter(req(m, count=3))
    assert not by_node  # no node has 3 chips
    assert any("same-node" in r for r in rejections.values())

    record = alloc.alloc(req(m, count=2))
    nodes = {alloc.get_chip(c).chip.status.node_name for c in record.chip_ids}
    assert len(nodes) == 1


def test_oversell_allows_overcommit_of_tflops_not_hbm(m):
    alloc = make_allocator(m, n_chips=1, nodes=1, oversell=500.0)
    for i in range(5):
        alloc.alloc(req(m, pod=f"p{i}", tflops=150.0, hbm=2 * 2**30))
    with pytest.raises(m.core.InsufficientResourcesError):
        alloc.alloc(req(m, pod="p9", tflops=150.0, hbm=8 * 2**30))
    with pytest.raises(m.core.InsufficientResourcesError):
        alloc.alloc(req(m, pod="p10", tflops=1.0, hbm=8 * 2**30))


def test_upsert_chip_pool_and_node_migration(m):
    alloc = make_allocator(m)
    alloc.upsert_chip(make_chip(m, "mover", node="node-a", pool="pool-a"))
    assert any(c.chip.name == "mover" for c in alloc.chips("pool-a"))

    alloc.upsert_chip(make_chip(m, "mover", node="node-b", pool="pool-b"))
    assert not any(c.chip.name == "mover" for c in alloc.chips("pool-a"))
    assert any(c.chip.name == "mover" for c in alloc.chips("pool-b"))

    alloc.remove_chip("mover")
    assert not any(c.chip.name == "mover" for c in alloc.chips("pool-a"))
    assert not any(c.chip.name == "mover" for c in alloc.chips("pool-b"))


def test_partition_planner_best_fit_and_fragmentation(m):
    planner = m.planner.TPUCorePlanner
    used = 0b00001100                     # cores 2,3 busy of 8
    p = planner.place(8, used, 2)
    assert (p.start_core, p.core_count) == (0, 2)   # smallest gap first
    assert planner.place(8, used, 4).start_core == 4
    assert planner.place(8, used, 5) is None

    state = m.core.ChipState(make_chip(m, "c4", cores=4))
    amt = m.api.ResourceAmount(tflops=1.0)
    state.hold("a", amt, "t-1c")
    state.hold("b", amt, "t-2c")
    assert state.partition_placements["b"].start_core == 2   # aligned
    state.hold("c", amt, "t-1c")                             # takes core 1
    with pytest.raises(m.core.InsufficientResourcesError):
        state.hold("d", amt, "t-1c")                         # chip full
    state.drop("a", "t-1c")
    assert state.plan_partition("t-2c") is None              # {0} alone
    state.drop("c", "t-1c")
    assert state.plan_partition("t-2c").start_core == 0


def test_partition_isolation_groups_do_not_mix(m):
    reg = m.planner.PartitionPlanRegistry()
    reg.register(m.planner.TemplateSpec("secure-1c", 1, isolation_group="secure"))
    reg.register(m.planner.TemplateSpec("shared-1c", 1, isolation_group="shared"))
    state = m.core.ChipState(make_chip(m, "c4", cores=4), partition_registry=reg)
    state.hold("a", m.api.ResourceAmount(tflops=1.0), "secure-1c")
    assert state.plan_partition("secure-1c") is not None
    assert state.plan_partition("shared-1c") is None


def test_hbm_host_expansion_extends_schedulable_hbm(m):
    alloc = make_allocator(m)
    big = int(V5E_HBM * 1.25)           # > physical 16 GiB
    with pytest.raises(m.core.InsufficientResourcesError):
        alloc.alloc(req(m, pod="nope", hbm=big))

    alloc.set_pool_hbm_expansion("pool-a", 50, 70)    # x2.2 schedulable
    record = alloc.alloc(req(m, pod="spill", hbm=big))
    state = alloc.get_chip(record.chip_ids[0])
    assert state.virtual_capacity().hbm_bytes == pytest.approx(V5E_HBM * 2.2)
    assert state.hbm_spill_bytes() == pytest.approx(big - V5E_HBM)
    alloc.alloc(req(m, pod="second", hbm=int(V5E_HBM * 0.9),
                    chip_indices=[state.chip.status.host_index]))
    assert state.hbm_spill_bytes() > big - V5E_HBM


def test_assume_commit_unassume(m):
    alloc = make_allocator(m)
    r = req(m)
    by_node, _ = alloc.check_quota_and_filter(r)
    chips = next(iter(by_node.values()))
    record = alloc.assume(r, alloc.select(r, chips))
    assert record.assumed
    with pytest.raises(m.core.AllocationConflictError):
        alloc.assume(r, chips)
    alloc.unassume(record.key)
    assert alloc.allocation(record.key) is None

    record = alloc.assume(r, alloc.select(r, chips))
    alloc.commit(record.key)
    assert not alloc.allocation(record.key).assumed


def test_assumed_ttl_sweep_with_gang_probe(m):
    alloc = make_allocator(m)
    alloc.assume_ttl_s = 0.0
    r = req(m)
    by_node, _ = alloc.check_quota_and_filter(r)
    record = alloc.assume(r, alloc.select(r, next(iter(by_node.values()))))

    alloc.set_gang_waiting_probe(lambda key: True)
    assert alloc.sweep_assumed() == []          # gang member: kept
    alloc.set_gang_waiting_probe(lambda key: False)
    assert alloc.sweep_assumed() == [record.key]
    assert alloc.allocation(record.key) is None


def test_quota_enforcement_and_two_phase(m):
    store = m.store.ObjectStore()
    amt = m.api.ResourceAmount
    quota = m.api.TPUResourceQuota.new("q", namespace="team-a")
    quota.spec.total.requests = amt(tflops=100.0, hbm_bytes=8 * 2**30)
    quota.spec.single.requests = amt(tflops=60.0)
    quota.spec.total.max_workers = 2
    store.create(quota)

    alloc = make_allocator(m, store=store)
    alloc.quota.set_quota(quota)

    with pytest.raises(m.allocator.QuotaExceededError) as ei:
        alloc.alloc(req(m, ns="team-a", tflops=80.0))     # single cap 60
    assert ei.value.unresolvable

    alloc.alloc(req(m, ns="team-a", pod="a", tflops=60.0))
    with pytest.raises(m.allocator.QuotaExceededError) as ei:
        alloc.alloc(req(m, ns="team-a", pod="b", tflops=50.0))  # total cap 100
    assert not ei.value.unresolvable
    alloc.alloc(req(m, ns="team-a", pod="c", tflops=40.0))
    with pytest.raises(m.allocator.QuotaExceededError):     # worker cap 2
        alloc.alloc(req(m, ns="team-a", pod="d", tflops=1.0, hbm=1))

    alloc.dealloc("team-a/a")
    alloc.alloc(req(m, ns="team-a", pod="d", tflops=1.0, hbm=1))

    alloc.quota.sync_to_store()
    synced = store.get(m.api.TPUResourceQuota, "q", "team-a")
    assert synced.status.used_workers == 2
    assert synced.status.used_requests.tflops == pytest.approx(41.0)


def test_adjust_allocation_live_resize(m):
    alloc = make_allocator(m, n_chips=1, nodes=1)
    record = alloc.alloc(req(m, tflops=50.0, hbm=2 * 2**30))
    amt = m.api.ResourceAmount
    delta = alloc.adjust_allocation(m.api.AdjustRequest(
        namespace="default", pod_name="p1",
        new_request=amt(tflops=80.0, hbm_bytes=3 * 2**30),
        new_limit=amt(tflops=160.0, hbm_bytes=3 * 2**30)), dry_run=True)
    assert delta.tflops == pytest.approx(30.0)
    state = alloc.get_chip(record.chip_ids[0])
    assert state.allocated.tflops == 50.0  # dry run did not mutate

    alloc.adjust_allocation(m.api.AdjustRequest(
        namespace="default", pod_name="p1",
        new_request=amt(tflops=80.0, hbm_bytes=3 * 2**30),
        new_limit=amt(tflops=160.0, hbm_bytes=3 * 2**30)))
    assert state.allocated.tflops == pytest.approx(80.0)

    with pytest.raises(m.core.InsufficientResourcesError):
        alloc.adjust_allocation(m.api.AdjustRequest(
            namespace="default", pod_name="p1",
            new_request=amt(tflops=500.0, hbm_bytes=3 * 2**30)))


def test_partitioned_fit_filter(m):
    alloc = m.allocator.TPUAllocator()
    alloc.upsert_chip(make_chip(m, "pchip-0", cores=2))
    r = req(m, isolation=m.constants.ISOLATION_PARTITIONED)
    r.partition_template = "v5p-1c"
    rec1 = alloc.alloc(r)
    assert rec1.chip_ids == ["pchip-0"]

    r2 = req(m, pod="p2", isolation=m.constants.ISOLATION_PARTITIONED)
    r2.partition_template = "v5p-2c"  # needs 2 cores, only 1 free
    with pytest.raises(m.core.InsufficientResourcesError):
        alloc.alloc(r2)

    r3 = req(m, pod="p3", isolation=m.constants.ISOLATION_PARTITIONED)
    r3.partition_template = "v5p-1c"
    alloc.alloc(r3)
    alloc.bind_partition("default/p3", "pchip-0", "pchip-0-p1")
    assert alloc.allocation("default/p3").partitions["pchip-0"] == "pchip-0-p1"


def test_reconcile_from_pod_annotations(m):
    alloc = make_allocator(m)
    record = alloc.alloc(req(m, count=2, tflops=40.0))
    pod = m.types.Pod.new("p1", namespace="default")
    alloc.stamp_pod(pod, record)
    assert pod.metadata.annotations[m.constants.ANN_CHIP_IDS]

    alloc2 = make_allocator(m)
    restored = alloc2.reconcile([pod])
    assert restored == 1
    rec2 = alloc2.allocation("default/p1")
    assert rec2.chip_ids == record.chip_ids
    assert not rec2.assumed
    for c in rec2.chip_ids:
        assert alloc2.get_chip(c).allocated.tflops == pytest.approx(40.0)

    pod_done = m.types.Pod.new("p2", namespace="default")
    alloc.stamp_pod(pod_done, record)
    pod_done.status.phase = m.constants.PHASE_SUCCEEDED
    alloc3 = make_allocator(m)
    assert alloc3.reconcile([pod_done]) == 0


def test_sync_to_store(m):
    store = m.store.ObjectStore()
    alloc = m.allocator.TPUAllocator(store=store)
    alloc.set_pool_oversell("pool-a", 100.0)
    chip = make_chip(m, "sync-chip")
    store.create(chip)
    alloc.upsert_chip(chip)
    alloc.alloc(req(m, tflops=97.0))
    n = alloc.sync_to_store()
    assert n == 1
    synced = store.get(m.api.TPUChip, "sync-chip")
    assert synced.status.available.tflops == pytest.approx(100.0)
    assert synced.status.running_apps == ["default/p1"]


def test_strategies_pack_vs_spread(m):
    alloc = make_allocator(m, n_chips=2, nodes=1)
    alloc.set_pool_strategy("pool-a", "CompactFirst")
    a = alloc.alloc(req(m, pod="p1", tflops=50.0))
    b = alloc.alloc(req(m, pod="p2", tflops=50.0))
    assert a.chip_ids == b.chip_ids  # packed onto the same chip

    alloc2 = make_allocator(m, n_chips=2, nodes=1)
    alloc2.set_pool_strategy("pool-a", "LowLoadFirst")
    a = alloc2.alloc(req(m, pod="p1", tflops=50.0))
    b = alloc2.alloc(req(m, pod="p2", tflops=50.0))
    assert a.chip_ids != b.chip_ids  # spread across chips


def test_port_allocator(m):
    pa = m.allocator.PortAllocator(node_range=(100, 103), cluster_range=(200, 202))
    p1 = pa.assign_node_port("n1", "default/p1")
    p2 = pa.assign_node_port("n1", "default/p2")
    assert {p1, p2} == {100, 101}
    assert pa.assign_node_port("n2", "default/p3") == 100  # per-node ranges
    pa.assign_node_port("n1", "default/p4")
    with pytest.raises(m.allocator.PortExhaustedError):
        pa.assign_node_port("n1", "default/p5")
    assert pa.release_owner("default/p1") == 1
    assert pa.assign_node_port("n1", "default/p6") == p1

    c = pa.assign_cluster_port("default/p7")
    assert c == 200
    assert pa.release_cluster_port(c)
    assert not pa.release_cluster_port(c)  # double release

    pa2 = m.allocator.PortAllocator(node_range=(100, 103), cluster_range=(200, 202))
    pa2.reconcile([("n1", 100, "default/p1"), (None, 201, "default/p8")])
    assert pa2.assign_node_port("n1", "x") == 101
    assert pa2.assign_cluster_port("y") == 200


def test_index_allocator(m):
    ia = m.allocator.IndexAllocator(max_index=3)
    assert ia.assign("a") == 0
    assert ia.assign("b") == 1
    assert ia.assign("a") == 0  # idempotent
    assert ia.release("a") == 0
    assert ia.assign("c") == 0
    ia.assign("d")
    with pytest.raises(m.allocator.IndexExhaustedError):
        ia.assign("e")
    ia.reconcile({"x": 2})
    assert ia.assign("y") == 0


def test_index_allocator_reconcile_deduplicates(m):
    ia = m.allocator.IndexAllocator(max_index=10)
    ia.reconcile({"a": 2, "b": 2, "c": 5})
    by_owner = {o: ia.assign(o) for o in ("a", "b", "c")}
    assert by_owner["a"] == 2          # first (lexicographic) keeps it
    assert by_owner["c"] == 5
    assert by_owner["b"] not in (2, 5)
    assert len(set(by_owner.values())) == 3


def test_vectorized_filter_path_matches_python_chain(m):
    n = m.core.VECTORIZE_THRESHOLD + 36           # 100 chips over 25 nodes
    alloc = m.allocator.TPUAllocator()
    alloc.set_pool_oversell("pool-a", 200.0)
    for i in range(n):
        chip = make_chip(m, f"v-{i}", node=f"vn-{i // 4}")
        if i % 7 == 0:
            chip.status.generation = "v5p"
        if i % 11 == 0:
            chip.status.phase = "Pending"      # filtered out
        alloc.upsert_chip(chip)
    for i in range(0, 30, 3):
        alloc.alloc(req(m, pod=f"occ{i}", tflops=300.0, hbm=10 * 2**30,
                        chip_indices=[alloc.chips("pool-a")[i].chip.status.host_index],
                        same_node=False))

    r = req(m, pod="probe", tflops=150.0, hbm=8 * 2**30)
    by_node_vec, _ = alloc.check_quota_and_filter(r)
    assert isinstance(by_node_vec, m.vecview.CandidateMap)
    by_node_py, _ = alloc.check_quota_and_filter(r, explain=True)

    vec_chips = {c.chip.name for node in by_node_vec for c in by_node_vec[node]}
    py_chips = {c.chip.name for chips in by_node_py.values() for c in chips}
    assert vec_chips == py_chips
    assert set(by_node_vec) == set(by_node_py)

    r2 = req(m, pod="gen", tflops=10.0, hbm=2**30, generation="v5p",
             isolation=m.constants.ISOLATION_SOFT)
    v2, _ = alloc.check_quota_and_filter(r2)
    p2, _ = alloc.check_quota_and_filter(r2, explain=True)
    assert {c.chip.name for nd in v2 for c in v2[nd]} == \
        {c.chip.name for chips in p2.values() for c in chips}

    scores = alloc.score_nodes(r, by_node_vec)
    assert set(scores) == set(by_node_vec)
    record = alloc.alloc(req(m, pod="vec-alloc", tflops=50.0, hbm=2**30))
    assert record.chip_ids
    chip_state = alloc.get_chip(record.chip_ids[0])
    remaining = chip_state.available().tflops
    v3, _ = alloc.check_quota_and_filter(
        req(m, pod="probe2", tflops=remaining + 1.0, hbm=2**30,
            chip_indices=[chip_state.chip.status.host_index]))
    assert record.chip_ids[0] not in {c.chip.name for nd in v3 for c in v3[nd]}, \
        "vectorized view served stale capacity"


def _duty_req(m, pod, duty, **kw):
    amt = m.api.ResourceAmount
    return m.api.AllocRequest(pool="pool-a", namespace="default", pod_name=pod,
                              request=amt(duty_percent=duty), limit=amt(duty_percent=duty),
                              chip_count=1, **kw)


def test_duty_and_tflops_are_fungible_on_hold(m):
    alloc = make_allocator(m, n_chips=1, nodes=1)
    rec = alloc.alloc(_duty_req(m, "native", 100.0))
    st = alloc.get_chip(rec.chip_ids[0])
    assert st.allocated.duty_percent == 100.0
    assert st.allocated.tflops == pytest.approx(V5E_TFLOPS)
    by_node, rej = alloc.check_quota_and_filter(req(m, pod="p2", tflops=10.0))
    assert not by_node
    alloc.dealloc(rec.key)

    rec2 = alloc.alloc(req(m, pod="p3", tflops=V5E_TFLOPS, hbm=0))
    st2 = alloc.get_chip(rec2.chip_ids[0])
    assert st2.allocated.duty_percent == pytest.approx(100.0)
    by_node2, _ = alloc.check_quota_and_filter(_duty_req(m, "p4", 50.0))
    assert not by_node2


def test_duty_fit_in_vectorized_path(m):
    alloc = make_allocator(m, n_chips=2, nodes=1)
    rec = alloc.alloc(_duty_req(m, "native", 100.0))
    view = m.vecview.PoolVectorView([alloc.get_chip(f"chip-{i}") for i in range(2)])
    mask = view.survivors(_duty_req(m, "p2", 50.0))
    held = view.index[rec.chip_ids[0]]
    assert not mask[held]
    assert mask.sum() == 1


def test_exclusive_hold_blocks_oversubscription(m):
    alloc = make_allocator(m, n_chips=1, nodes=1, oversell=500.0)
    rec = alloc.alloc(_duty_req(m, "native", 100.0, exclusive=True))
    by_node, rej = alloc.check_quota_and_filter(req(m, pod="p2", tflops=10.0))
    assert not by_node
    assert "exclusively held" in next(iter(rej.values()))
    alloc.dealloc(rec.key)

    small = alloc.alloc(req(m, pod="tiny", tflops=1.0, hbm=2**20))
    by_node2, rej2 = alloc.check_quota_and_filter(_duty_req(m, "excl", 100.0, exclusive=True))
    assert not by_node2
    assert "needs an empty chip" in next(iter(rej2.values()))
    alloc.dealloc(small.key)

    amt = m.api.ResourceAmount
    st = alloc.get_chip("chip-0")
    st.hold("a", amt(tflops=1.0))
    with pytest.raises(m.core.InsufficientResourcesError):
        st.hold("b", amt(duty_percent=10.0), exclusive=True)
    st.drop("a")
    st.hold("x", amt(duty_percent=100.0), exclusive=True)
    with pytest.raises(m.core.InsufficientResourcesError):
        st.hold("y", amt(tflops=1.0))
    st.drop("x")
    assert not st.exclusive_keys


def test_vectorized_exclusivity_matches_python_chain(m):
    alloc = make_allocator(m, n_chips=3, nodes=1)
    amt = m.api.ResourceAmount
    excl = m.api.AllocRequest(
        pool="pool-a", namespace="default", pod_name="own",
        request=amt(tflops=10.0, hbm_bytes=2**20), limit=amt(tflops=10.0, hbm_bytes=2**20),
        chip_count=1, exclusive=True)
    rec = alloc.alloc(excl)
    held = rec.chip_ids[0]
    view = m.vecview.PoolVectorView([alloc.get_chip(f"chip-{i}") for i in range(3)])
    mask = view.survivors(excl)
    assert mask[view.index[held]]
    m2 = view.survivors(req(m, pod="other", tflops=1.0, hbm=2**20))
    assert not m2[view.index[held]] and m2.sum() == 2


# -- objects carried across: pods and allocation records ---------------------

def _record(rec):
    """An AllocRecord as plain data, without the wall stamp of its load."""
    d = dataclasses.asdict(rec)
    d.pop("assumed_at")
    return d


def _stamped_pod(m, rng, i):
    """An allocation made and stamped onto a pod in package ``m``."""
    alloc = make_allocator(m, n_chips=4, nodes=2, oversell=200.0)
    kw = {}
    if rng.random() < 0.4:
        kw["generation"] = "v5e"
    if rng.random() < 0.3:
        kw["vendor"] = "mock-tpu"
    if rng.random() < 0.3:
        kw["chip_indices"] = [int(x) for x in sorted(rng.choice(4, 2, replace=False))]
    r = req(m, pod=f"carried-{i}", tflops=float(rng.integers(1, 150)),
            hbm=int(rng.integers(1, 8)) << 28, count=int(rng.integers(1, 3)),
            qos=str(rng.choice(["low", "medium", "high", "critical"])),
            isolation=str(rng.choice(["soft", "hard", "shared"])), **kw)
    r.request.duty_percent = float(rng.choice([0.0, 10.0, 25.5]))
    r.limit.duty_percent = float(rng.choice([0.0, 50.0]))
    r.workload_name = f"wl-{i}"
    record = alloc.alloc(r)
    if rng.random() < 0.3:
        alloc.bind_partition(record.key, record.chip_ids[0], f"{record.chip_ids[0]}-p0")
    pod = m.types.Pod.new(f"carried-{i}", namespace="default")
    alloc.stamp_pod(pod, record)
    return pod, record


@pytest.mark.parametrize("src,dst", [("ref", "port"), ("port", "ref")])
def test_stamped_pod_parses_to_an_equal_record_in_the_other_package(src, dst):
    a, b = PKGS[src], PKGS[dst]
    rng = np.random.default_rng(7)
    for i in range(24):
        pod, record = _stamped_pod(a, rng, i)
        other = b.types.Pod.new(pod.metadata.name, namespace=pod.metadata.namespace)
        other.metadata.annotations.update(pod.metadata.annotations)
        got = b.allocator.TPUAllocator.parse_pod(other)
        own = a.allocator.TPUAllocator.parse_pod(pod)
        assert _record(got) == _record(own)
        assert got.chip_ids == record.chip_ids
        assert _record(got)["request"]["request"] == dataclasses.asdict(record.request.request)
        # and the record stamps back onto an equal pod
        again = b.types.Pod.new(pod.metadata.name, namespace=pod.metadata.namespace)
        b.allocator.TPUAllocator().stamp_pod(again, got)
        assert again.metadata.annotations == pod.metadata.annotations


class _Clock:
    """A wall clock advanced by hand (the stream's sweeps read it)."""

    def __init__(self):
        self.t = 1000.0

    def now(self):
        return self.t

    def monotonic(self):
        return self.t


def _outcome(fn):
    try:
        got = fn()
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return ("raised", type(e).__name__)
    if isinstance(got, list):
        return ("ok", list(got))
    if hasattr(got, "chip_ids"):
        return ("ok", _record(got))
    if got is None or isinstance(got, (int, float)):
        return ("ok", got)
    return ("ok", dataclasses.asdict(got))


def _stream_world(m, clock):
    store = m.store.ObjectStore()
    alloc = m.allocator.TPUAllocator(store=store, clock=clock, assume_ttl_s=30.0)
    alloc.set_pool_oversell("pool-a", 300.0)
    for i in range(8):
        chip = make_chip(m, f"chip-{i}", node=f"node-{i // 4}")
        store.create(chip)
        alloc.upsert_chip(chip)
    quota = m.api.TPUResourceQuota.new("q", namespace="team")
    quota.spec.total.requests = m.api.ResourceAmount(tflops=900.0, hbm_bytes=40 * 2**30)
    quota.spec.total.max_workers = 6
    store.create(quota)
    alloc.quota.set_quota(store.get(m.api.TPUResourceQuota, "q", "team"))
    return store, alloc


def _stream_op(m, alloc, store, clock, op, args):
    amt = m.api.ResourceAmount
    if op == "alloc":
        pod, ns, tflops, hbm, count, duty = args
        r = req(m, pod=pod, ns=ns, tflops=tflops, hbm=hbm, count=count)
        r.request.duty_percent = duty
        return _outcome(lambda: alloc.alloc(r))
    if op == "assume":
        pod, ns, tflops, hbm, count, _ = args
        r = req(m, pod=pod, ns=ns, tflops=tflops, hbm=hbm, count=count)

        def assume():
            by_node, _ = alloc.check_quota_and_filter(r)
            node = sorted(by_node)[0]
            return alloc.assume(r, alloc.select(r, list(by_node[node])))
        return _outcome(assume)
    if op == "dealloc":
        return _outcome(lambda: alloc.dealloc(args))
    if op == "unassume":
        return _outcome(lambda: alloc.unassume(args))
    if op == "commit":
        return _outcome(lambda: alloc.commit(args))
    if op == "adjust":
        key, tflops, hbm = args
        ns, _, pod = key.partition("/")
        return _outcome(lambda: alloc.adjust_allocation(m.api.AdjustRequest(
            namespace=ns, pod_name=pod, new_request=amt(tflops=tflops, hbm_bytes=hbm),
            new_limit=amt(tflops=2 * tflops, hbm_bytes=hbm))))
    if op == "quota":
        tflops, workers = args
        q = store.get(m.api.TPUResourceQuota, "q", "team").thaw()
        q.spec.total.requests = amt(tflops=tflops, hbm_bytes=40 * 2**30)
        q.spec.total.max_workers = workers
        store.update(q)
        alloc.quota.set_quota(store.get(m.api.TPUResourceQuota, "q", "team"))
        return ("ok", None)
    if op == "sweep":
        clock.t += args
        return _outcome(lambda: sorted(alloc.sweep_assumed()))
    if op == "sync":
        return _outcome(alloc.sync_to_store)
    raise AssertionError(op)


def _stream_ops(seed, n):
    rng = np.random.default_rng(seed)
    keys, ops = [], []
    for i in range(n):
        kind = rng.choice(["alloc", "alloc", "assume", "dealloc", "unassume", "commit",
                           "adjust", "quota", "sweep", "sync"])
        if kind in ("alloc", "assume"):
            ns = str(rng.choice(["default", "team"]))
            args = (f"p{i}", ns, float(rng.integers(5, 400)), int(rng.integers(1, 12)) << 28,
                    int(rng.integers(1, 4)), float(rng.choice([0.0, 0.0, 20.0, 60.0])))
            keys.append(f"{ns}/p{i}")
        elif kind in ("dealloc", "unassume", "commit"):
            args = str(rng.choice(keys)) if keys else "default/none"
        elif kind == "adjust":
            args = (str(rng.choice(keys)) if keys else "default/none",
                    float(rng.integers(5, 300)), int(rng.integers(1, 10)) << 28)
        elif kind == "quota":
            args = (float(rng.integers(200, 1500)), int(rng.integers(2, 9)))
        elif kind == "sweep":
            args = float(rng.choice([1.0, 10.0, 40.0]))
        else:
            args = None
        ops.append((str(kind), args))
    return ops


def test_seeded_operation_stream_gives_equal_state_in_both_packages():
    ops = _stream_ops(2024, 200)
    worlds = {}
    for name, m in PKGS.items():
        clock = _Clock()
        worlds[name] = (m, clock) + _stream_world(m, clock)
    kinds = set()
    for step, (op, args) in enumerate(ops):
        outs = {}
        for name, (m, clock, store, alloc) in worlds.items():
            outs[name] = _stream_op(m, alloc, store, clock, op, args)
        assert outs["ref"] == outs["port"], (step, op, args, outs)
        kinds.add((op, outs["ref"][0]))
        recs = {name: sorted((_record(r) for r in w[3].allocations()), key=lambda d: str(d))
                for name, w in worlds.items()}
        assert recs["ref"] == recs["port"], (step, op)
        avail = {name: {c.chip.name: dataclasses.asdict(c.available()) for c in w[3].chips()}
                 for name, w in worlds.items()}
        assert avail["ref"] == avail["port"], (step, op)
    # the stream exercised every kind, and both outcomes of the fallible ones
    assert {k for k, _ in kinds} == {"alloc", "assume", "dealloc", "unassume", "commit",
                                     "adjust", "quota", "sweep", "sync"}
    for op in ("alloc", "adjust"):
        assert {(op, "ok"), (op, "raised")} <= kinds, op
    for name, (m, clock, store, alloc) in worlds.items():
        alloc.sync_to_store()
    chips = {name: [c.to_dict()["status"] for c in w[2].list(w[0].api.TPUChip)]
             for name, w in worlds.items()}
    assert chips["ref"] == chips["port"]
    assert any(s["running_apps"] for s in chips["port"])
    quotas = {name: w[2].get(w[0].api.TPUResourceQuota, "q", "team").to_dict()["status"]
              for name, w in worlds.items()}
    assert quotas["ref"] == quotas["port"]
