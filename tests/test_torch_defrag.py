"""The port's defrag, compaction and live migration
(tensorfusion_tpu_torch/controllers/defrag.py, wired into its Operator) and
its TPU-VM provider against the reference's.

The reference's own cases (tests/test_defrag_migration.py, the controller
cases of test_migration_streaming.py and
test_lifecycle_components.py::test_tpu_vm_provider_queued_resource_flow)
run here as one parametrised test each, over both packages (``m``).
Beside them: one seeded stream of pods, drains and moves (stop-and-copy,
streaming over a scripted transport, gangs) giving both operators the same
bindings, chip phases and counters; and the path the H100 runs, rehearsed
on the CPU: two of the port's node agents, each with a co-hosted
``RemoteVTPUWorker(device="cpu")``, and the port's operator with its policy
engine moving a tenant with the default ``HypervisorMigrationTransport``.
"""

import importlib
import random
import threading
import time
import types

import numpy as np
import pytest

pytest.importorskip("torch")

_NAMES = {
    'Container': ('api.types', 'Container'),
    'LiveMigrator': ('controllers.defrag', 'LiveMigrator'),
    'ObjectStore': ('store', 'ObjectStore'),
    'Operator': ('operator', 'Operator'),
    'Pod': ('api.types', 'Pod'),
    'StreamingConvergence': ('controllers.defrag', 'StreamingConvergence'),
    'TPUChip': ('api.types', 'TPUChip'),
    'TPUNode': ('api.types', 'TPUNode'),
    'TPUNodeClaim': ('api.types', 'TPUNodeClaim'),
    'TPUPool': ('api.types', 'TPUPool'),
    'TPUVMError': ('cloudprovider.tpu_vm', 'TPUVMError'),
    'TPUVMProvider': ('cloudprovider.tpu_vm', 'TPUVMProvider'),
    'constants': ('', 'constants'),
    'migration_pause_budget_ms': ('controllers.defrag', 'migration_pause_budget_ms'),
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


# -- tests/test_defrag_migration.py ------------------------------------------


def make_operator(m, hosts=2, compaction=False, grace_s=0.3, **kw):
    op = m.Operator(**kw)
    pool = m.TPUPool.new("pool-a")
    pool.spec.name = "pool-a"
    if compaction:
        pool.spec.compaction.enabled = True
        pool.spec.compaction.period_seconds = grace_s
        pool.spec.compaction.defrag_util_threshold_percent = 30.0
    op.store.create(pool)
    for i in range(hosts):
        claim = m.TPUNodeClaim.new(f"host-{i}")
        claim.spec.pool = "pool-a"
        claim.spec.generation = "v5e"
        claim.spec.chip_count = 4
        op.store.create(claim)
    op.start()
    deadline = time.time() + 5
    while len(op.allocator.chips()) < hosts * 4 and time.time() < deadline:
        time.sleep(0.02)
    return op


def _pod(m, name, tflops, hbm, extra=None):
    pod = m.Pod.new(name, namespace="default")
    ann = pod.metadata.annotations
    ann[m.constants.ANN_POOL] = "pool-a"
    ann[m.constants.ANN_TFLOPS_REQUEST] = str(tflops)
    ann[m.constants.ANN_HBM_REQUEST] = str(hbm)
    ann[m.constants.ANN_IS_LOCAL_TPU] = "true"
    ann.update(extra or {})
    pod.spec.containers = [m.Container(name="main")]
    return pod


def submit(m, op, name, tflops=50.0, hbm=2 * 2**30, protect=False, qos=None):
    extra = {}
    if protect:
        extra[m.constants.ANN_EVICTION_PROTECTION] = "true"
    if qos:
        extra[m.constants.ANN_QOS] = qos
    op.submit_pod(_pod(m, name, tflops, hbm, extra))
    bound = op.wait_for_binding(name)
    assert bound is not None
    return bound


def _submit_excluded(m, op, name, node):
    """A pod placed off ``node`` by exclusion, which is then dropped so
    ``node`` is a legal target again."""
    c = m.constants
    op.submit_pod(_pod(m, name, "10", 2**30, {c.ANN_EXCLUDED_NODES: node}))
    bound = op.wait_for_binding(name)
    assert bound.spec.node_name != node
    pod = op.store.get(m.Pod, name, "default").thaw()
    del pod.metadata.annotations[c.ANN_EXCLUDED_NODES]
    op.store.update(pod)
    return bound.spec.node_name


def test_defrag_migrates_pods_off_low_util_node(m):
    op = make_operator(m, hosts=2)
    try:
        node1 = submit(m, op, "busy").spec.node_name
        node2 = _submit_excluded(m, op, "lonely", node1)
        # node2 runs only the tiny pod -> low utilization -> defrag it
        assert op.compaction.defrag_node("pool-a", node2) == 1
        deadline = time.time() + 5
        moved = None
        while time.time() < deadline:
            moved = op.store.try_get(m.Pod, "lonely", "default")
            if moved is not None and moved.spec.node_name == node1:
                break
            time.sleep(0.05)
        assert moved is not None and moved.spec.node_name == node1
        assert moved.metadata.labels[m.constants.LABEL_DEFRAG_EVICTED] == "true"
        tnode = op.store.get(m.TPUNode, node2)
        assert tnode.metadata.labels.get(m.constants.LABEL_DEFRAG_SOURCE) == "true"
    finally:
        op.stop()


def test_defrag_respects_eviction_protection_and_no_alternative(m):
    op = make_operator(m, hosts=1)  # single node: nothing can move anywhere
    try:
        node = submit(m, op, "pinned", tflops=20.0).spec.node_name
        assert op.compaction.defrag_node("pool-a", node) == 0
        assert op.store.try_get(m.Pod, "pinned", "default") is not None
        tnode = op.store.get(m.TPUNode, node)
        assert tnode.metadata.labels.get(m.constants.LABEL_DEFRAG_SKIP) == "true"
        # an eviction-protected pod is never a candidate
        submit(m, op, "guarded", tflops=20.0, protect=True)
        assert op.compaction.defrag_node("pool-a", node) == 0
        assert op.store.try_get(m.Pod, "guarded", "default") is not None
    finally:
        op.stop()


def _submit_gang(m, op, names, tflops=30.0, timeout="30"):
    """A strict gang (min == desired); waits for every member to bind."""
    c = m.constants
    for name in names:
        op.submit_pod(_pod(m, name, tflops, 2**30, {
            c.ANN_WORKLOAD: "gangwl", c.ANN_GANG_ENABLED: "true",
            c.ANN_GANG_DESIRED_MEMBERS: str(len(names)),
            c.ANN_GANG_MIN_MEMBERS: str(len(names)),
            c.ANN_GANG_REQUIRED_MEMBERS: str(len(names)),
            c.ANN_GANG_TIMEOUT: timeout}))
    out = []
    for name in names:
        bound = op.wait_for_binding(name)
        assert bound is not None, f"gang member {name} never bound"
        out.append(bound)
    return out


def test_defrag_drains_strict_gang_atomically(m):
    op = make_operator(m, hosts=2)
    try:
        drained = _submit_gang(m, op, ["g0", "g1"])[0].spec.node_name
        assert op.compaction.defrag_node("pool-a", drained) == 2
        deadline = time.time() + 10
        rebound = {}
        while time.time() < deadline:
            rebound = {n: op.store.try_get(m.Pod, n, "default") for n in ("g0", "g1")}
            if all(p is not None and p.spec.node_name and p.spec.node_name != drained
                   for p in rebound.values()):
                break
            time.sleep(0.05)
        for name, p in rebound.items():
            assert p is not None and p.spec.node_name, f"{name} stuck after gang drain"
            assert p.spec.node_name != drained
            assert op.allocator.allocation(f"default/{name}") is not None
    finally:
        op.stop()


def test_defrag_skips_gang_with_no_atomic_placement(m):
    op = make_operator(m, hosts=1)   # nowhere else to go
    try:
        node = _submit_gang(m, op, ["s0", "s1"])[0].spec.node_name
        assert op.compaction.defrag_node("pool-a", node) == 0
        for name in ("s0", "s1"):
            assert op.store.try_get(m.Pod, name, "default") is not None
        tnode = op.store.get(m.TPUNode, node)
        assert tnode.metadata.labels.get(m.constants.LABEL_DEFRAG_SKIP) == "true"
        assert "atomic" in tnode.metadata.annotations.get(
            m.constants.ANN_DEFRAG_SKIP_REASON, "")
    finally:
        op.stop()


def test_gang_live_migration_moves_all_members_atomically(m):
    op = make_operator(m, hosts=2)
    try:
        drained = _submit_gang(m, op, ["m0", "m1"])[0].spec.node_name
        # per-pod migration of a gang member is refused
        assert op.migrator.migrate("default", "m0") is None
        assert op.store.try_get(m.Pod, "m0", "default") is not None
        placed = op.migrator.migrate_gang("default", "m0")
        assert placed is not None and len(placed) == 2
        assert all(node != drained for node in placed.values())
        for name in ("m0", "m1"):
            cur = op.store.get(m.Pod, name, "default")
            assert cur.spec.node_name and cur.spec.node_name != drained
            assert op.allocator.allocation(f"default/{name}") is not None
    finally:
        op.stop()


def test_gang_live_migration_refuses_without_atomic_placement(m):
    op = make_operator(m, hosts=1)
    try:
        node = _submit_gang(m, op, ["s0", "s1"])[0].spec.node_name
        assert op.migrator.migrate_gang("default", "s0") is None
        for name in ("s0", "s1"):
            assert op.store.get(m.Pod, name, "default").spec.node_name == node
    finally:
        op.stop()


def test_drain_marks_expire_after_ttl(m):
    c = m.constants
    op = make_operator(m, hosts=2)
    try:
        pool = op.store.get(m.TPUPool, "pool-a").thaw()
        pool.spec.compaction.enabled = True
        pool.spec.compaction.defrag_eviction_ttl_seconds = 0.5
        op.store.update(pool)
        node1 = submit(m, op, "busy2").spec.node_name
        node2 = _submit_excluded(m, op, "roamer", node1)
        assert op.compaction.defrag_node("pool-a", node2) == 1
        moved = None
        deadline = time.time() + 40
        while time.time() < deadline:
            moved = op.store.try_get(m.Pod, "roamer", "default")
            if moved is not None and moved.spec.node_name == node1:
                break
            op.scheduler.activate()     # force requeue under load
            time.sleep(0.1)
        assert moved is not None and moved.spec.node_name == node1
        assert moved.metadata.annotations.get(c.ANN_EXCLUDED_NODES)
        assert op.store.get(m.TPUNode, node2).metadata.labels.get(c.LABEL_DEFRAG_SOURCE)
        # the TTL lapses: backdate the marks, freeze further defrag churn
        # and drive the expiry pass directly, as the reference's case does
        cur = op.store.get(m.Pod, "roamer", "default").thaw()
        cur.metadata.annotations[c.ANN_DEFRAG_EVICTED_SINCE] = str(time.time() - 3600)
        op.store.update(cur)
        tnode = op.store.get(m.TPUNode, node2).thaw()
        tnode.metadata.annotations[c.ANN_DEFRAG_SOURCE_SINCE] = str(time.time() - 3600)
        op.store.update(tnode)
        pool = op.store.get(m.TPUPool, "pool-a").thaw()
        pool.spec.compaction.enabled = False
        op.store.update(pool)
        deadline = time.time() + 20
        cleared = False
        while time.time() < deadline:
            op.compaction._expire_drain_marks({"pool-a": 0.5})
            cur = op.store.get(m.Pod, "roamer", "default")
            tnode = op.store.get(m.TPUNode, node2)
            if not cur.metadata.annotations.get(c.ANN_EXCLUDED_NODES) and \
                    not tnode.metadata.labels.get(c.LABEL_DEFRAG_SOURCE):
                cleared = True
                break
            time.sleep(0.2)
        assert cleared, "drain marks never expired"
    finally:
        op.stop()


def test_compaction_releases_empty_node(m):
    op = make_operator(m, hosts=2, compaction=True, grace_s=0.2)
    try:
        busy = submit(m, op, "anchor").spec.node_name
        deadline = time.time() + 10
        while time.time() < deadline:
            if len({ch.chip.status.node_name for ch in op.allocator.chips("pool-a")}) == 1:
                break
            time.sleep(0.1)
        assert {ch.chip.status.node_name for ch in op.allocator.chips("pool-a")} == {busy}
        assert len(op.allocator.chips("pool-a")) == 4
        assert op.compaction.compacted_nodes
        assert busy not in op.compaction.compacted_nodes
    finally:
        op.stop()


def test_live_migration_moves_pod_and_cycles_chip_phase(m):
    op = make_operator(m, hosts=2)
    try:
        source = submit(m, op, "hot", tflops=30.0).spec.node_name
        chips_before = list(op.allocator.allocation("default/hot").chip_ids)
        new_node = op.migrator.migrate("default", "hot")
        assert new_node is not None and new_node != source
        assert op.store.get(m.Pod, "hot", "default").spec.node_name == new_node
        rec = op.allocator.allocation("default/hot")
        assert rec is not None
        assert all(op.allocator.get_chip(ch).chip.status.node_name == new_node
                   for ch in rec.chip_ids)
        for name in chips_before:
            assert op.store.get(m.TPUChip, name).status.phase == m.constants.PHASE_RUNNING
    finally:
        op.stop()


# -- tests/test_migration_streaming.py, the controller's cases ---------------


def test_convergence_policy_decisions(m):
    pol = m.StreamingConvergence(pause_budget_ms=100.0, max_rounds=4)
    fits = {"round": 1, "buffers": 10, "raw_bytes": 10 * 4096,
            "dirty_left": 1, "bandwidth_bps": 10 << 20}
    assert pol.decide(fits) == "freeze"
    hot = {"round": 2, "buffers": 4, "raw_bytes": 4 << 20,
           "dirty_left": 2000, "bandwidth_bps": 1 << 20}
    assert pol.decide(hot) == "fallback"  # round 2 with dirty_left >= buffers
    assert pol.decide(dict(hot, round=1)) == "continue"
    assert pol.decide(dict(hot, round=4, dirty_left=1)) == "fallback"
    assert m.migration_pause_budget_ms("critical") < m.migration_pause_budget_ms("low")
    assert pol.predicted_pause_ms(fits) == \
        PKGS["ref"].StreamingConvergence(100.0, 4).predicted_pause_ms(fits)


class FakeTransport:
    """Scripted migrate_streaming transport: per-round stats, plus hooks
    to kill the target or delete the pod mid-round."""

    def __init__(self, rounds, commit=None, freeze=None, on_delta=None):
        self.rounds = list(rounds)
        self.commit_reply = commit if commit is not None else \
            {"pause_ms": 7.5, "rounds": len(rounds), "buffers": 3,
             "raw_bytes": 3 << 20, "wire_bytes": 1 << 20}
        self.freeze_reply = freeze if freeze is not None else \
            {"frozen": True, "dirty_buffers": 0, "dirty_bytes": 0}
        self.on_delta = on_delta
        self.calls = []

    def target_worker_url(self, node):
        return f"tcp://fake-{node}:1"

    def delta(self, ns, pod, source, target_url, final=False):
        self.calls.append(("delta", final))
        if self.on_delta is not None:
            self.on_delta(len([c for c in self.calls if c[0] == "delta"]))
        if not self.rounds:
            return None
        return self.rounds.pop(0)

    def freeze(self, ns, pod, source):
        self.calls.append(("freeze",))
        return self.freeze_reply

    def commit(self, ns, pod, source, abort=False):
        self.calls.append(("commit", abort))
        return {"aborted": True} if abort else self.commit_reply


def _chip_phases(m, op):
    return {ch.name: ch.status.phase for ch in op.store.list(m.TPUChip)}


def test_migrate_streaming_commits_and_rebinds(m):
    op = make_operator(m, hosts=2)
    try:
        source = submit(m, op, "hot", qos="high").spec.node_name
        tr = FakeTransport(rounds=[
            {"round": 1, "buffers": 8, "raw_bytes": 8 << 20, "dirty_left": 4,
             "bandwidth_bps": 64 << 20, "wire_bytes": 2 << 20},
            {"round": 2, "buffers": 4, "raw_bytes": 1 << 20, "dirty_left": 0,
             "bandwidth_bps": 64 << 20, "wire_bytes": 1 << 20}])
        result = op.migrator.migrate_streaming("default", "hot", transport=tr)
        assert result is not None and result["mode"] == "streaming"
        assert result["new_node"] and result["new_node"] != source
        assert result["pause_ms"] == 7.5
        assert ("freeze",) in tr.calls and ("commit", False) in tr.calls
        assert set(_chip_phases(m, op).values()) == {"Running"}
        assert op.migrator.streaming_committed == 1
    finally:
        op.stop()


def test_migrate_streaming_falls_back_for_hot_tenant(m):
    op = make_operator(m, hosts=2)
    try:
        source = submit(m, op, "hot").spec.node_name
        hot = {"buffers": 4, "raw_bytes": 4 << 20, "dirty_left": 500,
               "bandwidth_bps": 1 << 20, "wire_bytes": 1 << 20}
        tr = FakeTransport(rounds=[dict(hot, round=1), dict(hot, round=2)])
        result = op.migrator.migrate_streaming("default", "hot", transport=tr)
        assert result is not None and result["mode"] == "stop-and-copy"
        assert result["new_node"] != source
        assert ("commit", True) in tr.calls       # session aborted
        assert op.migrator.streaming_fallback == 1
        assert set(_chip_phases(m, op).values()) == {"Running"}
    finally:
        op.stop()


def test_migrate_streaming_target_dies_between_rounds(m):
    op = make_operator(m, hosts=2)
    try:
        submit(m, op, "hot")
        tr = FakeTransport(rounds=[
            {"round": 1, "buffers": 8, "raw_bytes": 8 << 20, "dirty_left": 100,
             "bandwidth_bps": 1 << 20, "wire_bytes": 2 << 20}])  # then None
        result = op.migrator.migrate_streaming("default", "hot", transport=tr)
        assert result is not None and result["mode"] == "stop-and-copy"
        assert ("commit", True) in tr.calls
        assert set(_chip_phases(m, op).values()) == {"Running"}
    finally:
        op.stop()


def test_migrate_streaming_pod_deleted_mid_round_aborts(m):
    op = make_operator(m, hosts=2)
    try:
        submit(m, op, "hot")

        def kill_pod(n_deltas):
            if n_deltas == 1:
                op.store.delete(m.Pod, "hot", "default")

        slow = {"buffers": 8, "raw_bytes": 8 << 20, "dirty_left": 100,
                "bandwidth_bps": 1 << 20, "wire_bytes": 2 << 20}
        tr = FakeTransport(rounds=[dict(slow, round=r) for r in (1, 2, 3)],
                           on_delta=kill_pod)
        assert op.migrator.migrate_streaming("default", "hot", transport=tr) is None
        assert ("commit", True) in tr.calls       # deltas discarded
        assert op.migrator.streaming_aborted == 1
        assert set(_chip_phases(m, op).values()) == {"Running"}
    finally:
        op.stop()


def test_migrate_streaming_refuses_strict_gang_member(m):
    op = make_operator(m, hosts=2)
    try:
        _submit_gang(m, op, ["g0", "g1"])
        tr = FakeTransport(rounds=[])
        assert op.migrator.migrate_streaming("default", "g0", transport=tr) is None
        assert not tr.calls     # refused before any transport traffic
    finally:
        op.stop()


def test_double_migration_conflict_skips(m):
    op = make_operator(m, hosts=2)
    try:
        submit(m, op, "hot")
        with op.migrator._state_lock:
            op.migrator._inflight.add("default/hot")
        assert op.migrator.migrate_streaming("default", "hot") is None
        assert op.migrator.migrate("default", "hot") is None
        with op.migrator._state_lock:
            op.migrator._inflight.discard("default/hot")
    finally:
        op.stop()


def test_post_retries_transient_hypervisor_hiccup(m, monkeypatch):
    calls = []

    def flaky(url, method="GET", data=None, timeout_s=10.0):
        calls.append(url)
        if len(calls) == 1:
            raise OSError("connection refused")
        return None

    monkeypatch.setattr(f"{m.pkg}.utils.tlsutil.hypervisor_urlopen", flaky)
    mig = m.LiveMigrator(store=None, allocator=None)
    assert mig._post("http://hv/api/v1/workers/ns/p/snapshot") is True
    assert len(calls) == 2       # one transient failure, one success


def test_post_gives_up_after_bounded_attempts(m, monkeypatch):
    calls = []

    def dead(url, method="GET", data=None, timeout_s=10.0):
        calls.append(url)
        raise OSError("connection refused")

    monkeypatch.setattr(f"{m.pkg}.utils.tlsutil.hypervisor_urlopen", dead)
    mig = m.LiveMigrator(store=None, allocator=None)
    assert mig._post("http://hv/x") is False
    assert len(calls) == m.LiveMigrator.POST_ATTEMPTS == 2


def test_deferred_resume_exits_on_close_without_touching_store(m):
    """close() stops and joins the deferred-resume watcher, after which
    the store can die safely."""

    class Store:
        def __init__(self):
            self.dead = False
            self.lock = threading.Lock()

        def try_get(self, cls, name, namespace=""):
            with self.lock:
                assert not self.dead, "deferred resume touched a dead store"
            pod = m.Pod.new(name, namespace=namespace)
            pod.spec.node_name = "src-node"    # never rebinds
            return pod

    store = Store()
    mig = m.LiveMigrator(store=store, allocator=None)
    mig._spawn_deferred_resume("default", "pod-x", "src-node")
    time.sleep(0.2)
    mig.close()
    with mig._state_lock:
        threads = list(mig._resume_threads)
    assert threads and all(not t.is_alive() for t in threads)
    with store.lock:
        store.dead = True
    time.sleep(0.3)     # would assert inside try_get if still polling


def test_operator_stop_joins_the_migrators_watchers(m):
    """The operator's stop() closes its migrator: a deferred resume left
    by a rebind that had not landed ends with it (no thread of the
    migrator outlives the operator), and start() re-arms it."""
    op = make_operator(m, hosts=1)
    try:
        submit(m, op, "parked", tflops=10.0)
        op.migrator._spawn_deferred_resume("default", "parked",
                                           op.store.get(m.Pod, "parked", "default").spec.node_name)
        assert any(t.name == "tpf-migrate-parked" for t in threading.enumerate())
    finally:
        op.stop()
    assert op.migrator._stopped.is_set()
    assert not any(t.name == "tpf-migrate-parked" and t.is_alive()
                   for t in threading.enumerate())
    op.migrator.reopen()
    assert not op.migrator._stopped.is_set()


# -- test_lifecycle_components.py --------------------------------------------


def test_tpu_vm_provider_queued_resource_flow(m):
    """Provisions through queued resources (CREATING -> ACTIVE), registers
    the host inventory, maps node states and pricing; with no transport it
    fails loudly."""
    calls = []
    state = {"polls": 0}

    def fake_api(method, path, body):
        calls.append((method, path))
        if method == "POST" and "queuedResources" in path:
            return {"name": path}
        if method == "GET" and "queuedResources/" in path:
            state["polls"] += 1
            return {"state": {"state": "ACTIVE" if state["polls"] >= 2 else "CREATING"}}
        if method == "GET" and "/nodes/" in path:
            return {"state": "READY"}
        return {}

    store = m.ObjectStore()
    prov = m.TPUVMProvider(store, project="proj", zone="us-central2-b",
                           transport=fake_api, poll_interval_s=0.01)
    claim = m.TPUNodeClaim.new("claim-1")
    claim.spec.pool = "pool-a"
    claim.spec.generation = "v5e"
    claim.spec.chip_count = 8
    node_name, instance_id = prov.provision(claim)
    assert node_name == "claim-1-node"
    assert "projects/proj" in instance_id
    assert state["polls"] >= 2
    chips = store.list(m.TPUChip)
    assert len(chips) == 8
    assert all(ch.status.vendor == "gcp-tpu" for ch in chips)
    assert prov.node_status(node_name) == "Running"
    assert prov.instance_pricing("ct5lp-hightpu-8t") > 0
    prov.terminate(node_name)
    assert calls[-1] == ("DELETE", f"projects/proj/locations/us-central2-b/nodes/{node_name}")
    with pytest.raises(m.TPUVMError, match="no transport"):
        m.TPUVMProvider(m.ObjectStore()).test_connection()


# -- one seeded stream over both packages -------------------------------------


class _ManualClock:
    """The policy engine's and its ledger's clock in the stream: what
    they stamp is set by the test, as the reference's policy tests do."""

    def __init__(self, t):
        self.t = t

    def now(self):
        return self.t


def _stream(m, seed):
    """Pods on three v5e hosts, then a seeded sequence of defrags, a
    stop-and-copy move, a streaming move (scripted transport), a gang
    move, a streaming fallback and policy firings (the default catalog
    and actuators, on alerts the test feeds at set times); what the store
    says after each, the migrator's counters and the policy engine's
    lines and digest."""
    rng = random.Random(seed)
    c = m.constants
    op = make_operator(m, hosts=3, enable_policy=True)
    # the engine, its alerts and the recorder feeding them run here, on
    # the test's clock, not on their threads
    for component in (op.policy, op.alerts, op.metrics):
        component.stop()
    clock = _ManualClock(5000.0)
    op.policy.clock = op.policy.ledger.clock = clock
    trace = []
    try:
        def state():
            pods = sorted((p.key(), p.spec.node_name, p.metadata.labels.get(
                c.LABEL_DEFRAG_EVICTED, ""), p.metadata.annotations.get(
                c.ANN_EXCLUDED_NODES, "")) for p in op.store.list(m.Pod))
            nodes = sorted((n.name, n.metadata.labels.get(c.LABEL_DEFRAG_SOURCE, ""),
                            n.metadata.labels.get(c.LABEL_DEFRAG_SKIP, ""))
                           for n in op.store.list(m.TPUNode))
            return pods, nodes, sorted(set(_chip_phases(m, op).values()))

        def settle():
            deadline = time.time() + 10
            while time.time() < deadline:
                if all(p.spec.node_name for p in op.store.list(m.Pod)):
                    return
                op.scheduler.activate()
                time.sleep(0.05)

        names = [f"p{i}" for i in range(6)]
        for name in names:
            submit(m, op, name, tflops=rng.choice([10.0, 20.0, 40.0]),
                   qos=rng.choice(["low", "medium", "high"]))
        _submit_gang(m, op, ["g0", "g1"])
        trace.append(("placed", state()))
        nodes = sorted({p.spec.node_name for p in op.store.list(m.Pod)})
        drained = op.compaction.defrag_node("pool-a", rng.choice(nodes))
        settle()
        trace.append(("defrag", drained, state()))
        moved = op.migrator.migrate("default", rng.choice(names)) is not None
        settle()
        trace.append(("stop-and-copy", moved, state()))
        rounds = [{"round": r, "buffers": 8, "raw_bytes": 8 << 20,
                   "dirty_left": rng.choice([0, 1, 2]), "bandwidth_bps": 64 << 20,
                   "wire_bytes": 2 << 20} for r in (1, 2, 3)]
        res = op.migrator.migrate_streaming("default", rng.choice(names),
                                            transport=FakeTransport(rounds))
        settle()
        trace.append(("streaming", res and (res["mode"], res["rounds"], res["pause_ms"]),
                      state()))
        placed = op.migrator.migrate_gang("default", "g0")
        settle()
        trace.append(("gang", placed is not None and len(placed), state()))
        hot = {"buffers": 4, "raw_bytes": 4 << 20, "dirty_left": 500,
               "bandwidth_bps": 1 << 20, "wire_bytes": 1 << 20}
        res = op.migrator.migrate_streaming(
            "default", rng.choice(names),
            transport=FakeTransport([dict(hot, round=1), dict(hot, round=2)]))
        settle()
        trace.append(("fallback", res and res["mode"], state()))
        trace.append(("policy", _policy_firings(m, op, clock, rng, names), state()))
        trace.append(("counters", op.migrator.streaming_committed,
                      op.migrator.streaming_fallback, op.migrator.streaming_aborted,
                      op.migrator.streaming_rounds_total,
                      op.migrator.streaming_delta_bytes_total,
                      op.compaction.evicted_for_defrag))
    finally:
        op.stop()
    return trace


def _policy_firings(m, op, clock, rng, names):
    """Unschedulable pods scale the pool by a node claim; two tenants
    skew the device share: a pod's key migrates it (stop-and-copy, the
    v5e hosts' agents host no worker), the worker's own connection name
    fails as not an ns/pod key; cooldowns suppress refires; the alerts
    resolve.  The ledger's decisions, and the engine's
    lines and digest."""
    from importlib import import_module

    export = import_module(f"{m.pkg}.policy.export")
    tsdb, alerts, engine = op.tsdb, op.alerts, op.policy

    def step(t):
        clock.t = t
        alerts.evaluate_once(now=t)
        return engine.evaluate_once(now=t)

    tsdb.insert("tpf_scheduler", {}, {"pending_pods": 3.0}, 5000.0)
    step(5000.0)
    made = step(5005.0)                        # pods-pending held 4 s: scale
    deadline = time.time() + 10
    while len(op.allocator.chips("pool-a")) < 16 and time.time() < deadline:
        time.sleep(0.02)
    assert len(op.allocator.chips("pool-a")) == 16
    tenant = f"default/{rng.choice(names)}"
    for tag, share in ((tenant, 70.0), ("cn1:", 55.0)):
        tsdb.insert("tpf_prof_tenant", {"tenant": tag, "node": "operator", "qos": "low"},
                    {"device_share_pct": share}, 5010.0, exemplar=f"trace-{share:.0f}")
    step(5010.0)
    made += step(5013.0)                       # tenant-skew held 2 s: migrate
    made += step(5020.0)                       # within the cooldowns
    tsdb.insert("tpf_scheduler", {}, {"pending_pods": 0.0}, 5030.0)
    for tag in (tenant, "cn1:"):
        tsdb.insert("tpf_prof_tenant", {"tenant": tag, "node": "operator", "qos": "low"},
                    {"device_share_pct": 0.0}, 5030.0)
    step(5030.0)
    step(5031.0)
    return ([(d.rule, d.action, list(d.group), d.actuation["ok"], d.actuation["error"],
              d.outcome["state"]) for d in engine.ledger.decisions()],
            [(d.id, d.rule) for d in made], engine.suppressed_total,
            export.policy_lines(engine, "operator", 0),
            export.policy_digest(engine.snapshot()))


@pytest.mark.parametrize("seed", [3, 17])
def test_a_seeded_drain_and_move_stream_gives_both_packages_one_result(seed):
    """Equal bindings, drain marks, chip phases, migrator counters and
    policy ledgers (lines and digest) from both packages' operators on the
    same seeded stream.  Placement among
    equally good hosts follows the allocator's own order in each, so the
    check is on what both packages decide, host names included."""
    ref, port = _stream(PKGS["ref"], seed), _stream(PKGS["port"], seed)
    assert [t[0] for t in port] == ["placed", "defrag", "stop-and-copy", "streaming",
                                    "gang", "fallback", "policy", "counters"]
    assert port == ref
    assert port[3][1][0] == "streaming" and port[5][1] == "stop-and-copy"
    decisions, _, suppressed, lines, digest = port[6][1]
    # scale at 5005 and again past its 10 s cooldown at 5020; migrate at
    # 5013, within its 30 s cooldown at 5020
    assert [d[:2] for d in decisions] == [("scale-on-burn", "scale_pool"),
                                          ("migrate-on-skew", "migrate_tenant"),
                                          ("migrate-on-skew", "migrate_tenant"),
                                          ("scale-on-burn", "scale_pool")]
    assert [d[5] for d in decisions] == ["resolved", "failed", "resolved", "resolved"]
    failed = [d for d in decisions if not d[3]]
    assert len(failed) == 1 and failed[0][2] == ["cn1:"] and \
        "not an ns/pod key" in failed[0][4]
    assert suppressed >= 1 and lines and len(digest) == 64


# -- the H100's path, rehearsed on the CPU -----------------------------------


def _agent(tmp, name, store_url, pool, provider, limiter):
    """One of the port's node agents joined to the store, with a
    co-hosted ``RemoteVTPUWorker(device="cpu")`` registered on its server
    and its metrics recorder (the topology streaming migration assumes)."""
    from tensorfusion_tpu_torch.testing import fresh_library
    from tensorfusion_tpu_torch.hypervisor.__main__ import HypervisorDaemon, build_parser
    from tensorfusion_tpu_torch.remoting import RemoteVTPUWorker

    d = tmp / name
    d.mkdir()
    args = build_parser().parse_args([
        "--provider", fresh_library(provider, name), "--limiter",
        fresh_library(limiter, name), "--shm-base", str(d / "shm"),
        "--state-dir", str(d / "state"), "--snapshot-dir", str(d / "snap"),
        "--port", "0", "--operator-url", store_url, "--node-name", name,
        "--pool", pool, "--metrics-interval-s", "0.5"])
    daemon = HypervisorDaemon(args)
    worker = RemoteVTPUWorker(device="cpu")
    worker.start()
    daemon.server.register_remote_worker(worker)
    daemon.metrics.remote_workers.append(worker)
    daemon.start()
    return types.SimpleNamespace(daemon=daemon, worker=worker)


def _wait(fn, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _tenant_fn(p, x):
    import torch

    return torch.tanh(x @ p["w"] + p["b"])


def test_a_running_tenant_moves_between_two_agents_through_the_operator(
        tmp_path, monkeypatch, mock_provider_lib, limiter_lib):
    """Two port node agents, each with a co-hosted CPU worker, join a
    state store: node-a over the reference's mock provider, node-b over
    the NVML provider on the stand-in NVML (two stand-in cards in one
    process would share a UUID).  The port's operator, policy engine on,
    binds a pod on node-a, whose client has PUT weights and compiled a
    program on node-a's worker and keeps calling it.  The pool then opts
    into compaction with streaming migration: the defrag pass moves the
    tenant with the default ``HypervisorMigrationTransport`` in
    ``streaming`` mode, the pod is bound on node-b, node-b's worker holds
    the buffers byte for byte and runs the program to node-a's result,
    node-a's holds nothing, and every chip is Running again."""
    import torch

    from tensorfusion_tpu_torch import constants as c
    from tensorfusion_tpu_torch.api.types import Container, Pod, TPUChip, TPUPool
    from tensorfusion_tpu_torch.hypervisor import _build
    from tensorfusion_tpu_torch.operator import Operator
    from tensorfusion_tpu_torch.remote_store import RemoteStore
    from tensorfusion_tpu_torch.remoting import RemoteDevice, RemoteExecutionError
    from tensorfusion_tpu_torch.remoting.client import RemoteBuffer
    from tensorfusion_tpu_torch.statestore import StateStoreServer
    from tensorfusion_tpu_torch.store import ObjectStore

    for k in list(__import__("os").environ):
        if k.startswith(("TPF_FAKE_NVML_", "TPF_MOCK_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("TPF_MOCK_CHIPS", "1")
    monkeypatch.setenv(c.ENV_NVML_LIB, str(_build.build_fake_nvml(tmp_path / "nvml")))
    pool = "pool-h100"
    server = StateStoreServer(ObjectStore())
    server.start()
    rs = RemoteStore(server.url)
    agents, op, devs, caller = [], None, [], None
    stop_calls = threading.Event()
    try:
        tp = TPUPool.new(pool)
        tp.spec.name = pool
        rs.create(tp)
        agents.append(_agent(tmp_path, "node-a", server.url, pool, mock_provider_lib,
                             limiter_lib))
        op = Operator(store=rs, enable_policy=True)
        op.start()
        _wait(lambda: op.allocator.chips(pool), "node-a's chip")
        pod = Pod.new("tenant", namespace="default")
        pod.metadata.annotations.update({
            c.ANN_POOL: pool, c.ANN_TFLOPS_REQUEST: "20", c.ANN_HBM_REQUEST: str(2**30),
            c.ANN_IS_LOCAL_TPU: "true", c.ANN_QOS: c.QOS_LOW})
        pod.spec.containers = [Container(name="main")]
        op.submit_pod(pod)
        assert op.wait_for_binding("tenant").spec.node_name == "node-a"

        # the tenant's client on node-a's worker: weights, a program, calls
        src, tgt_worker = agents[0].worker, None
        rng = np.random.default_rng(7)
        host = {"w": torch.from_numpy(rng.standard_normal((64, 64), dtype=np.float32)),
                "b": torch.from_numpy(rng.standard_normal(64, dtype=np.float32))}
        x = torch.from_numpy(rng.standard_normal((8, 64), dtype=np.float32))
        ten = RemoteDevice(src.url, timeout_s=30)
        devs.append(ten)
        params = {k: ten.put(v) for k, v in host.items()}
        remote = ten.remote_jit(_tenant_fn)
        want = remote(params, x)
        calls = {"ok": 0, "error": None}

        def keep_calling():
            while not stop_calls.is_set():
                try:
                    remote(params, x)
                    calls["ok"] += 1
                except RemoteExecutionError as e:   # the state left node-a
                    calls["error"] = str(e)
                    return

        caller = threading.Thread(target=keep_calling, daemon=True)
        caller.start()

        agents.append(_agent(tmp_path, "node-b", server.url, pool,
                             str(_build.provider_path()), limiter_lib))
        tgt_worker = agents[1].worker
        _wait(lambda: len(op.allocator.chips(pool)) == 2, "node-b's chip")
        _wait(lambda: calls["ok"] >= 2, "the tenant's calls on node-a")
        tp = rs.get(TPUPool, pool).thaw()
        cc = tp.spec.compaction
        cc.enabled, cc.streaming_migration = True, True
        cc.defrag_cron, cc.defrag_util_threshold_percent = "* * * * *", 90.0
        cc.period_seconds = 3600.0
        rs.update(tp)
        _wait(lambda: op.compaction.streamed_for_defrag, "the defrag's streaming move")
        moved = _wait(lambda: (lambda p: p if p and p.spec.node_name else None)(
            rs.try_get(Pod, "tenant", "default")), "the tenant rebound")
        stop_calls.set()
        caller.join(timeout=10)
        assert op.compaction.streamed_for_defrag == ["default/tenant"]
        assert moved.spec.node_name == "node-b"
        mig = op.migrator
        assert (mig.streaming_committed, mig.streaming_fallback, mig.streaming_aborted) \
            == (1, 0, 0) and mig.streaming_rounds_total >= 1
        assert src.migration_stats()["streaming_total"] == 1
        assert src.resident_bytes == 0
        assert tgt_worker.migration_stats()["installed_total"] >= 2
        tdev = RemoteDevice(tgt_worker.url, timeout_s=30)
        devs.append(tdev)
        for k, v in host.items():
            got = RemoteBuffer(tdev, params[k].buf_id, tuple(v.shape), "float32").fetch()
            assert got.numpy().tobytes() == v.numpy().tobytes()
        tparams = {k: RemoteBuffer(tdev, b.buf_id, tuple(host[k].shape), "float32")
                   for k, b in params.items()}
        assert torch.equal(remote.on(tdev)(tparams, x), want)
        _wait(lambda: {ch.status.phase for ch in rs.list(TPUChip)} == {c.PHASE_RUNNING},
              "every chip Running")
        assert calls["ok"] >= 2
    finally:
        stop_calls.set()
        if caller is not None:
            caller.join(timeout=10)
        for d in devs:
            d.close()
        if op is not None:
            op.stop()
        for a in agents:
            a.daemon.stop()
            a.worker.stop()
        rs.close()
        server.stop()


# -- what the tenant sees of a pre-copy round ---------------------------------


@pytest.mark.parametrize("side", sorted(PKGS))
def test_a_pre_copy_round_holds_the_tenants_calls_in_either_package(side):
    """A SNAPSHOT_DELTA round runs as one deferred flush on the source
    worker's dispatcher thread, so the tenant's calls queued behind it
    wait out the whole round: the longest wait between two of its call
    completions spans most of the round, in both packages (ROADMAP queue 3
    fault 14; on the H100 a 3.8 GB round held the tenant 10.65 s of the
    10.77 s from the decision to the bind, against a pause_ms of 12.9)."""
    mod = importlib.import_module(f"{PKGS[side].pkg}.remoting")
    kw = {"device": "cpu"} if side == "port" else {}
    src, tgt = mod.RemoteVTPUWorker(**kw), mod.RemoteVTPUWorker(**kw)
    src.start()
    tgt.start()
    ten = mod.RemoteDevice(src.url, timeout_s=60)
    orch = mod.RemoteDevice(src.url, timeout_s=60)
    stop, done = threading.Event(), []
    try:
        ten.put(np.ones(32 << 20, dtype=np.float32))        # 128 MB to ship
        fn = ten.remote_jit(lambda x: x * 2.0)
        x = np.ones(16, dtype=np.float32)
        fn(x)

        def keep_calling():
            while not stop.is_set():
                fn(x)
                done.append(time.monotonic())

        caller = threading.Thread(target=keep_calling, daemon=True)
        caller.start()
        _wait(lambda: len(done) >= 20, "the tenant's calls")
        t0 = time.monotonic()
        stats = orch.snapshot_delta(tgt.url)
        t1 = time.monotonic()
        _wait(lambda: done and done[-1] > t1, "a call after the round")
        stop.set()
        caller.join(timeout=30)
        orch.migrate_commit(abort=True)
    finally:
        stop.set()
        for d in (ten, orch):
            d.close()
        src.stop()
        tgt.stop()
    assert stats["raw_bytes"] >= 128 << 20
    window = [t for t in done if t0 <= t <= t1 + 1.0]
    edges = [t0] + window
    longest = max(b - a for a, b in zip(edges, edges[1:]))
    assert longest >= 0.6 * (t1 - t0), (longest, t1 - t0)
