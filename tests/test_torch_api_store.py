"""The port's API objects and object store (tensorfusion_tpu_torch.api,
.store, .storecache) against the reference's (tensorfusion_tpu.api, .store,
.storecache).

The reference's own cases (tests/test_api_store.py, test_watch_semantics.py)
run here as one parametrised test each, over both packages.  Beside them:
every kind's JSON form loads through the other package's ``from_dict``
into an equal object; one seeded sequence of creates, updates and deletes
gives both stores equal objects, resource versions and watch streams; and
a journal written by one package replays in the other.
"""

import dataclasses
import threading
import time
import types

import numpy as np
import pytest

import tensorfusion_tpu.api as ref_api
import tensorfusion_tpu.api.meta as ref_meta
import tensorfusion_tpu.api.types as ref_types
import tensorfusion_tpu.clock as ref_clock
import tensorfusion_tpu.store as ref_store
import tensorfusion_tpu.storecache as ref_storecache
import tensorfusion_tpu_torch.api as port_api
import tensorfusion_tpu_torch.api.meta as port_meta
import tensorfusion_tpu_torch.api.types as port_types
import tensorfusion_tpu_torch.clock as port_clock
import tensorfusion_tpu_torch.store as port_store
import tensorfusion_tpu_torch.storecache as port_storecache
from tensorfusion_tpu import constants as ref_constants
from tensorfusion_tpu_torch import constants as port_constants

PKGS = {
    "ref": types.SimpleNamespace(api=ref_api, meta=ref_meta, types=ref_types,
                                 store=ref_store, storecache=ref_storecache,
                                 constants=ref_constants, clock=ref_clock),
    "port": types.SimpleNamespace(api=port_api, meta=port_meta, types=port_types,
                                  store=port_store, storecache=port_storecache,
                                  constants=port_constants, clock=port_clock),
}


@pytest.fixture(params=sorted(PKGS))
def m(request):
    return PKGS[request.param]


def _mk(m, store, name, ns="d", ann=None):
    pod = m.types.Pod.new(name, namespace=ns)
    if ann:
        pod.metadata.annotations.update(ann)
    return store.create(pod)


def _drain(w, timeout=0.3):
    out = []
    while True:
        ev = w.get(timeout=timeout)
        if ev is None:
            return out
        out.append(ev)


# -- the reference's cases (tests/test_api_store.py), both packages ----------

def test_parse_quantity(m):
    parse = m.api.parse_quantity
    assert parse("16Gi") == 16 * 2**30
    assert parse("1.5T") == 1.5e12
    assert parse("100") == 100.0
    assert parse(42) == 42.0
    with pytest.raises(ValueError):
        parse("12xyz")


def test_resource_roundtrip(m):
    t = m.types
    chip = t.TPUChip.new("v5e-c0")
    chip.status.capacity = m.api.ResourceAmount(tflops=197.0, hbm_bytes=16 * 2**30)
    chip.status.mesh = t.MeshCoords(x=1, y=0)
    chip.status.ici_links.append(t.ICILink(peer_chip_id="v5e-c1", hops=1))
    d = chip.to_dict()
    assert d["kind"] == "TPUChip"
    back = m.api.from_dict(t.TPUChip, {k: v for k, v in d.items() if k != "kind"})
    assert back.status.capacity.tflops == 197.0
    assert back.status.mesh.x == 1
    assert back.status.ici_links[0].peer_chip_id == "v5e-c1"


def test_store_crud_and_conflict(m):
    s, t = m.store, m.types
    store = s.ObjectStore()
    created = store.create(t.TPUPool.new("pool-a"))
    assert created.metadata.resource_version > 0
    with pytest.raises(s.AlreadyExistsError):
        store.create(t.TPUPool.new("pool-a"))
    got = store.get(t.TPUPool, "pool-a").thaw()
    got.status.total_chips = 8
    store.update(got, check_version=True)
    stale = created.thaw()
    stale.status.total_chips = 99
    with pytest.raises(s.ConflictError):
        store.update(stale, check_version=True)
    assert store.get(t.TPUPool, "pool-a").status.total_chips == 8
    store.delete(t.TPUPool, "pool-a")
    with pytest.raises(s.NotFoundError):
        store.get(t.TPUPool, "pool-a")


def test_store_namespaced_list_and_watch(m):
    s, t = m.store, m.types
    store = s.ObjectStore()
    w = store.watch("TPUWorkload")
    store.create(t.TPUWorkload.new("wl1", namespace="team-a"))
    store.create(t.TPUWorkload.new("wl1", namespace="team-b"))
    assert len(store.list(t.TPUWorkload)) == 2
    assert len(store.list(t.TPUWorkload, namespace="team-a")) == 1
    ev = w.get(timeout=1)
    assert ev.type == s.ADDED and ev.obj.metadata.namespace == "team-a"
    ev = w.get(timeout=1)
    assert ev.type == s.ADDED and ev.obj.metadata.namespace == "team-b"
    got = store.get(t.TPUWorkload, "wl1", "team-a").thaw()
    got.spec.replicas = 3
    store.update(got)
    ev = w.get(timeout=1)
    assert ev.type == s.MODIFIED and ev.obj.spec.replicas == 3
    store.delete(t.TPUWorkload, "wl1", "team-b")
    assert w.get(timeout=1).type == s.DELETED
    w.stop()


def test_store_persistence_roundtrip(m, tmp_path):
    t = m.types
    store = m.store.ObjectStore(persist_dir=str(tmp_path))
    profile = t.WorkloadProfile.new("prof", namespace="default")
    profile.spec.resources.requests = m.api.ResourceAmount(tflops=50, hbm_bytes=2**30)
    profile.spec.isolation = m.constants.ISOLATION_SOFT
    store.create(profile)
    store2 = m.store.ObjectStore(persist_dir=str(tmp_path))
    assert store2.load([t.WorkloadProfile]) == 1
    back = store2.get(t.WorkloadProfile, "prof", "default")
    assert back.spec.resources.requests.tflops == 50
    assert back.spec.isolation == m.constants.ISOLATION_SOFT


def test_alloc_request_defaults(m):
    req = m.api.AllocRequest(pool="pool-a", namespace="default", pod_name="p1",
                             request=m.api.ResourceAmount(tflops=10, hbm_bytes=2**30))
    assert req.chip_count == 1
    assert req.isolation == "soft"
    assert req.key() == "default/p1"


def test_watch_conflation_keeps_only_newest_per_object(m):
    Pod = m.types.Pod
    store = m.store.ObjectStore()
    store.enable_event_log()
    rv0 = store.current_rv
    a = Pod.new("a", namespace="d")
    b = Pod.new("b", namespace="d")
    store.create(a)
    store.create(b)
    for i in range(20):
        a.metadata.annotations["i"] = str(i)
        a = store.update(a).thaw()
    b.metadata.annotations["final"] = "1"
    store.update(b)
    store.delete(Pod, "b", "d")
    _, events, reset = store.events_since(rv0, ["Pod"])
    assert not reset and len(events) == 24
    _, conflated, reset = store.events_since(rv0, ["Pod"], conflate=True)
    assert not reset
    by_name = {e[3]["metadata"]["name"]: e for e in conflated}
    assert set(by_name) == {"a", "b"}
    assert by_name["a"][0] == "MODIFIED"
    assert by_name["a"][3]["metadata"]["annotations"]["i"] == "19"
    assert by_name["b"][0] == "DELETED"
    _, frags, _ = store.events_since(rv0, ["Pod"], conflate=True, serialized=True)
    assert len(frags) == 2


# -- the reference's cases (tests/test_watch_semantics.py), both packages -----

def test_reads_share_one_frozen_snapshot(m):
    store = m.store.ObjectStore()
    w = store.watch("Pod", replay=False)
    created = _mk(m, store, "a")
    got = store.get(m.types.Pod, "a", "d")
    listed = store.list(m.types.Pod)[0]
    ev = w.get(timeout=1)
    assert got is created and listed is created and ev.obj is created
    for mutation in (lambda: setattr(got.status, "phase", "Running"),
                     lambda: got.metadata.annotations.update({"x": "1"}),
                     lambda: got.metadata.finalizers.append("z")):
        with pytest.raises(m.meta.FrozenResourceError):
            mutation()
    w.stop()


def test_thaw_gives_private_mutable_copy_and_mutate_thaws(m):
    store = m.store.ObjectStore()
    _mk(m, store, "a")
    snap = store.get(m.types.Pod, "a", "d")
    private = snap.thaw()
    private.metadata.annotations["k"] = "v"
    assert "k" not in snap.metadata.annotations
    out = m.store.mutate(store, m.types.Pod, "a",
                         lambda p: p.metadata.annotations.__setitem__("m", "1"),
                         namespace="d")
    assert out.metadata.annotations["m"] == "1"
    assert store.get(m.types.Pod, "a", "d").metadata.annotations["m"] == "1"


def test_replay_then_live_events_in_order(m):
    store = m.store.ObjectStore()
    for i in range(5):
        _mk(m, store, f"p{i}")
    w = store.watch("Pod")
    assert [w.get(timeout=1).obj.metadata.name for _ in range(5)] == \
        [f"p{i}" for i in range(5)]
    _mk(m, store, "live")
    ev = w.get(timeout=1)
    assert ev.type == m.store.ADDED and ev.obj.metadata.name == "live"
    w.stop()


def test_resource_version_monotonic_across_mixed_burst(m):
    store = m.store.ObjectStore()
    w = store.watch("Pod", replay=False)
    for i in range(10):
        _mk(m, store, f"p{i}")
    for i in range(0, 10, 2):
        m.store.mutate(store, m.types.Pod, f"p{i}",
                       lambda p: p.metadata.annotations.__setitem__("t", "1"),
                       namespace="d")
    store.delete(m.types.Pod, "p3", "d")
    rvs = [ev.rv for ev in _drain(w)]
    assert len(rvs) == 16 and rvs == sorted(rvs) and len(set(rvs)) == len(rvs)
    w.stop()


def test_conflate_collapses_burst_to_final_state(m):
    store = m.store.ObjectStore()
    w = store.watch("Pod", conflate=True, replay=False)
    store.create(m.types.Pod.new("churn", namespace="d"))
    for i in range(50):
        m.store.mutate(store, m.types.Pod, "churn",
                       lambda p, i=i: p.metadata.annotations.__setitem__("i", str(i)),
                       namespace="d")
    events = _drain(w)
    assert len(events) < 51
    assert events[-1].obj.metadata.annotations["i"] == "49"
    assert events[0].type == m.store.ADDED
    w.stop()


def test_conflation_preserves_delete_then_recreate(m):
    store = m.store.ObjectStore()
    first = _mk(m, store, "x", ann={"gen": "1"})
    w = store.watch("Pod", conflate=True)
    ev = w.get(timeout=1)
    assert ev.type == m.store.ADDED and ev.obj.metadata.annotations["gen"] == "1"
    store.delete(m.types.Pod, "x", "d")
    second = _mk(m, store, "x", ann={"gen": "2"})
    assert [w.get(timeout=1).type, w.get(timeout=1).type] == \
        [m.store.DELETED, m.store.ADDED]
    assert first.metadata.uid != second.metadata.uid
    w.stop()


def test_conflation_nets_out_create_then_delete(m):
    store = m.store.ObjectStore()
    w = store.watch("Pod", conflate=True, replay=False)
    _mk(m, store, "flash")
    store.delete(m.types.Pod, "flash", "d")
    _mk(m, store, "keeper")
    assert w.get(timeout=1).obj.metadata.name == "keeper"
    assert w.get(timeout=0.2) is None
    w.stop()


def test_slow_watcher_auto_conflates_past_backlog(m, monkeypatch):
    monkeypatch.setattr(m.store, "WATCH_CONFLATE_BACKLOG", 16)
    store = m.store.ObjectStore()
    w = store.watch("Pod", replay=False)
    store.create(m.types.Pod.new("churn", namespace="d"))
    for i in range(100):
        m.store.mutate(store, m.types.Pod, "churn",
                       lambda p, i=i: p.metadata.annotations.__setitem__("i", str(i)),
                       namespace="d")
    events = _drain(w)
    assert len(events) < 101
    assert events[-1].obj.metadata.annotations["i"] == "99"
    w.stop()


def test_watcher_past_ring_resyncs_with_synthetic_deletes(m):
    store = m.store.ObjectStore()
    _mk(m, store, "keep")
    _mk(m, store, "gone")
    w = store.watch("Pod")
    assert {w.get(timeout=1).obj.metadata.name for _ in range(2)} == {"keep", "gone"}
    store.delete(m.types.Pod, "gone", "d")
    _mk(m, store, "new")
    with store._lock:
        drop = len(store._ring)
        del store._ring[:drop]
        store._ring_base += drop
    seen = [(ev.type, ev.obj.metadata.name) for ev in _drain(w)]
    assert w.resyncs == 1
    assert (m.store.DELETED, "gone") in seen
    assert (m.store.ADDED, "new") in seen
    assert (m.store.ADDED, "keep") in seen
    w.stop()


def test_stop_wakes_blocked_get_promptly(m):
    store = m.store.ObjectStore()
    w = store.watch("Pod", replay=False)
    out = []
    t = threading.Thread(target=lambda: out.append(w.get()), daemon=True)
    t.start()
    time.sleep(0.1)
    w.stop()
    t.join(timeout=2)
    assert not t.is_alive() and out == [None]


def test_stop_mid_iteration_drains_buffered_then_ends(m):
    store = m.store.ObjectStore()
    for i in range(3):
        _mk(m, store, f"p{i}")
    w = store.watch("Pod")
    assert w.get(timeout=1) is not None
    w.stop()
    assert [e.obj.metadata.name for e in list(w)] == ["p1", "p2"]
    assert w.get(timeout=0.1) is None


def test_stop_is_idempotent_and_unregisters(m):
    store = m.store.ObjectStore()
    w = store.watch("Pod")
    w.stop()
    w.stop()
    assert w not in store._watches


def test_storecache_read_your_writes_and_churn_coherence(m):
    Pod = m.types.Pod
    store = m.store.ObjectStore()
    cache = m.storecache.StoreCache(store, kinds=("Pod", "Node"), indexers={
        "Pod": {"node": lambda p: p.spec.node_name or None}})
    cache.start()
    assert cache.wait_synced(2)
    _mk(m, store, "a")
    assert cache.get(Pod, "a", "d") is not None

    def churn(tid):
        for i in range(30):
            name = f"p{tid}-{i % 7}"
            try:
                pod = Pod.new(name, namespace="d")
                pod.spec.node_name = f"n{i % 3}"
                store.create(pod)
            except Exception:
                try:
                    m.store.mutate(store, Pod, name, lambda p, i=i: setattr(
                        p.spec, "node_name", f"n{i % 3}"), namespace="d")
                except Exception:
                    pass
            if i % 5 == 4:
                try:
                    store.delete(Pod, name, "d")
                except KeyError:
                    pass

    threads = [threading.Thread(target=churn, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    want = {p.key(): p.metadata.resource_version for p in store.list(Pod)}
    assert {p.key(): p.metadata.resource_version for p in cache.list(Pod)} == want
    indexed = {p.key() for n in ("n0", "n1", "n2") for p in cache.by_index(Pod, "node", n)}
    assert indexed == {p.key() for p in store.list(Pod) if p.spec.node_name}
    cache.stop()


def test_journal_group_commit_loses_nothing_and_keeps_order(m, tmp_path):
    Pod = m.types.Pod
    store = m.store.ObjectStore(persist_dir=str(tmp_path))
    for i in range(300):
        _mk(m, store, f"p{i}", ns="ns")
    for i in range(0, 300, 3):
        m.store.mutate(store, Pod, f"p{i}",
                       lambda p: p.metadata.annotations.__setitem__("u", "1"), namespace="ns")
    for i in range(0, 300, 10):
        store.delete(Pod, f"p{i}", "ns")
    store.close()
    fresh = m.store.ObjectStore(persist_dir=str(tmp_path))
    assert fresh.load([Pod]) == 270
    assert fresh.try_get(Pod, "p0", "ns") is None
    assert fresh.get(Pod, "p3", "ns").metadata.annotations["u"] == "1"
    assert "u" not in fresh.get(Pod, "p1", "ns").metadata.annotations
    fresh.close()


def test_journal_isolated_write_is_immediately_durable(m, tmp_path):
    store = m.store.ObjectStore(persist_dir=str(tmp_path))
    store.create(m.types.TPUPool.new("solo"))
    fresh = m.store.ObjectStore(persist_dir=str(tmp_path))
    assert fresh.load([m.types.TPUPool]) == 1
    store.close()
    fresh.close()


# -- the port against the reference ----------------------------------------

def test_kinds_constants_and_chip_info():
    assert [c.KIND for c in port_types.ALL_KINDS] == [c.KIND for c in ref_types.ALL_KINDS]
    for name in ("ANN_TFLOPS_REQUEST", "ANN_HBM_REQUEST", "ANN_DUTY_REQUEST", "ANN_QOS",
                 "ANN_ISOLATION", "ANN_CHIP_IDS", "ANN_PARTITION_NAME", "ENV_POOL_NAME",
                 "ENV_STORE_TOKEN", "CHIP_USED_BY_TPU_FUSION",
                 "CHIP_USED_BY_EXTERNAL_PLUGIN", "PHASE_RUNNING", "PHASE_PENDING",
                 "PHASE_MIGRATING", "DEFAULT_TFLOPS_OVERSELL_PERCENT",
                 "DEFAULT_HBM_EXPAND_HOST_MEM_PERCENT",
                 "DEFAULT_HBM_EXPAND_HOST_DISK_PERCENT"):
        assert getattr(port_constants, name) == getattr(ref_constants, name), name
    from tensorfusion_tpu.config import CHIP_INFO_DB as REF_CHIP_INFO_DB
    from tensorfusion_tpu_torch import hardware
    from tensorfusion_tpu_torch.config import chip_info
    for gen, info in REF_CHIP_INFO_DB.items():
        assert dataclasses.asdict(chip_info(gen)) == dataclasses.asdict(info)
    # the H100 rows: the NVML provider's generation strings, hardware.PEAKS' rates
    for match, bf16, int8, mem in hardware.PEAKS:
        gen = {"H100 PCIe": "h100-pcie", "H100 NVL": "h100-nvl", "H100": "h100-sxm"}[match]
        row = chip_info(gen)
        assert (row.generation, row.bf16_tflops, row.int8_tops, row.hbm_gbps) == \
            (gen, bf16 / 1e12, int8 / 1e12, mem / 1e9)
        assert row.hbm_bytes >= 80 << 30 and row.cost_per_hour == 0.0
    src = open(hardware.__file__.replace("hardware.py", "hypervisor/csrc/provider_nvml.c")).read()
    for gen in ("h100-sxm", "h100-pcie", "h100-nvl"):
        assert f'"{gen}"' in src


def _fill(value, path=""):
    """A to_dict() form with every leaf set to a value of its own: the
    JSON a populated object of that kind would have."""
    if isinstance(value, dict):
        return {k: _fill(v, f"{path}.{k}") for k, v in value.items()}
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return 7 + len(path)
    if isinstance(value, float):
        return 0.5 + len(path)
    if isinstance(value, str):
        return f"s{path}" if path != ".kind" else value
    return value


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("kind", [c.KIND for c in ref_types.ALL_KINDS])
def test_json_forms_load_across_packages(kind, direction):
    """Every kind, each leaf of its JSON form set: the one package's
    to_dict() loads through the other's from_dict() into an object whose
    to_dict() is the same JSON."""
    src, dst = (ref_types, port_types) if direction == "ref_to_port" else (port_types, ref_types)
    src_cls = next(c for c in src.ALL_KINDS if c.KIND == kind)
    dst_cls = next(c for c in dst.ALL_KINDS if c.KIND == kind)
    src_meta = ref_meta if src is ref_types else port_meta
    dst_meta = port_meta if src is ref_types else ref_meta
    data = _fill(src_cls.new("obj", namespace="ns").to_dict())
    data.pop("kind")
    obj = src_meta.from_dict(src_cls, data)
    d = obj.to_dict()
    back = dst_meta.from_dict(dst_cls, {k: v for k, v in d.items() if k != "kind"})
    assert back.to_dict() == d
    assert back.to_dict() == dict(data, kind=kind)


def _chip(t, api, name, i):
    chip = t.TPUChip.new(name)
    st = chip.status
    st.capacity = api.ResourceAmount(tflops=989.0, duty_percent=100.0, hbm_bytes=85e9)
    st.available = st.capacity
    st.generation, st.vendor, st.node_name, st.pool = "h100-sxm", "nvidia", "n0", "p"
    st.mesh = t.MeshCoords(x=i)
    st.ici_links = [t.ICILink(peer_chip_id="gpu-x", peer_index=1, kind="ici", hops=1,
                              gbps=450.0)]
    return chip


def _norm(d):
    d = dict(d)
    d["metadata"] = {k: v for k, v in d["metadata"].items() if k != "uid"}
    return d


def _run_ops(pkg, seed, clock):
    """One seeded sequence of creates, updates and deletes of pods, chips
    and pools on a fresh store of ``pkg``, with a replaying watch and a
    conflating one; returns what both watches saw and the final state."""
    t, s = pkg.types, pkg.store
    rng = np.random.default_rng(seed)
    with pkg.clock.use_clock(clock):
        store = s.ObjectStore()
        store.create(t.Pod.new("pre", namespace="d"))
        w_all = store.watch("Pod", "TPUChip", "TPUPool")
        w_conf = store.watch("Pod", conflate=True, replay=False)
        for step in range(200):
            kind = ("Pod", "TPUChip", "TPUPool")[int(rng.integers(0, 3))]
            i = int(rng.integers(0, 6))
            op = int(rng.integers(0, 3))
            cls = getattr(t, kind)
            ns = "d" if kind == "Pod" else ""
            name = f"{kind.lower()}-{i}"
            cur = store.try_get(cls, name, ns)
            if cur is None and op != 2:
                obj = _chip(t, pkg.api, name, i) if kind == "TPUChip" else cls.new(name, namespace=ns)
                store.create(obj)
            elif cur is not None and op == 0:
                obj = cur.thaw()
                obj.metadata.annotations["step"] = str(step)
                obj.status.phase = ("Pending", "Running")[step % 2]
                store.update(obj, check_version=bool(step % 2))
            elif cur is not None and op == 2:
                store.delete(cls, name, ns)
        events = [(e.type, e.rv, _norm(e.obj.to_dict())) for e in _drain(w_all, 0.2)]
        conflated = [(e.type, _norm(e.obj.to_dict())) for e in _drain(w_conf, 0.2)]
        w_all.stop()
        w_conf.stop()
        state = sorted((o.KIND, o.key(), _norm(o.to_dict()))
                       for c in (t.Pod, t.TPUChip, t.TPUPool) for o in store.list(c))
        return events, conflated, state, store.current_rv


class _FixedClock:
    def now(self):
        return 1.7e9

    def monotonic(self):
        return 100.0

    def sleep(self, seconds):
        time.sleep(seconds)

    def wait(self, event, timeout=None):
        return event.wait(timeout)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_operations_give_equal_objects_versions_and_events(seed):
    ref = _run_ops(PKGS["ref"], seed, _FixedClock())
    port = _run_ops(PKGS["port"], seed, _FixedClock())
    assert len(ref[0]) > 50
    assert port == ref


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_journal_written_by_one_package_replays_in_the_other(writer, tmp_path):
    w = PKGS[writer]
    r = PKGS["port" if writer == "ref" else "ref"]
    store = w.store.ObjectStore(persist_dir=str(tmp_path))
    for i in range(40):
        _mk(w, store, f"p{i}", ns="ns", ann={"i": str(i)})
        store.create(_chip(w.types, w.api, f"gpu-{i}", i))
    for i in range(0, 40, 4):
        w.store.mutate(store, w.types.Pod, f"p{i}",
                       lambda p: p.metadata.labels.__setitem__("u", "1"), namespace="ns")
        store.delete(w.types.TPUChip, f"gpu-{i}")
    store.close()
    want = sorted(o.to_dict()["metadata"]["name"] for c in (w.types.Pod, w.types.TPUChip)
                  for o in store.list(c))
    fresh = r.store.ObjectStore(persist_dir=str(tmp_path))
    assert fresh.load(r.types.ALL_KINDS) == 70
    got = {o.metadata.name: o.to_dict() for c in (r.types.Pod, r.types.TPUChip)
           for o in fresh.list(c)}
    assert sorted(got) == want
    for o in list(store.list(w.types.Pod)) + list(store.list(w.types.TPUChip)):
        assert got[o.metadata.name] == o.to_dict()
    # the replaying package appends, and the writer's package reads it back
    fresh.create(r.types.Pod.new("after", namespace="ns"))
    fresh.close()
    again = w.store.ObjectStore(persist_dir=str(tmp_path))
    assert again.load(w.types.ALL_KINDS) == 71
    assert again.get(w.types.Pod, "after", "ns").metadata.resource_version > 0
    again.close()
