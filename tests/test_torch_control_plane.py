"""The port's networked control plane, part 1 (tensorfusion_tpu_torch.
gateway, .statestore, .remote_store, .shardedstore, hypervisor.
control_plane and the daemon's ``--operator-url``) against the reference's.

The reference's cases of tests/test_networked_control_plane.py that need
no ``Operator`` run over both packages, with the state store's server in
place of the operator's.  The reference's ``RemoteStore`` works against
the port's ``StateStoreServer`` and the reverse.  The node agent's backend
publishes what the reference's publishes, turns pods into the same worker
specs, and marks a chip as used by a foreign plugin only for a pid it can
map to a process holding the chip's device node.  The port's daemon,
joined to a state store over the stand-in NVML, publishes an H100
``TPUChip`` that a reference ``RemoteStore`` reads unchanged, turns a
bound pod into a worker whose segment holds the pod's 25% contract,
pushes metrics lines into the store, survives the store's restart, and
reclaims the worker when the pod is deleted.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

import tensorfusion_tpu.api.types as ref_types
import tensorfusion_tpu.clock as ref_clock
import tensorfusion_tpu.hypervisor as ref_hv
import tensorfusion_tpu.hypervisor.control_plane as ref_cp
import tensorfusion_tpu.remote_store as ref_remote
import tensorfusion_tpu.shardedstore as ref_sharded
import tensorfusion_tpu.statestore as ref_statestore
import tensorfusion_tpu.store as ref_store
import tensorfusion_tpu_torch.api.types as port_types
import tensorfusion_tpu_torch.clock as port_clock
import tensorfusion_tpu_torch.hypervisor as port_hv
import tensorfusion_tpu_torch.hypervisor.control_plane as port_cp
import tensorfusion_tpu_torch.remote_store as port_remote
import tensorfusion_tpu_torch.shardedstore as port_sharded
import tensorfusion_tpu_torch.statestore as port_statestore
import tensorfusion_tpu_torch.store as port_store
from tensorfusion_tpu import constants as ref_constants
from tensorfusion_tpu.testing import fresh_library
from tensorfusion_tpu_torch import constants
from tensorfusion_tpu_torch.hypervisor import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "ref": types.SimpleNamespace(
        name="ref", types=ref_types, store=ref_store, remote=ref_remote,
        statestore=ref_statestore, sharded=ref_sharded, cp=ref_cp, hv=ref_hv,
        clock=ref_clock, constants=ref_constants),
    "port": types.SimpleNamespace(
        name="port", types=port_types, store=port_store, remote=port_remote,
        statestore=port_statestore, sharded=port_sharded, cp=port_cp, hv=port_hv,
        clock=port_clock, constants=constants),
}
#: (client package, server package): the port alone, and each against the other
COMBOS = [("port", "port"), ("ref", "port"), ("port", "ref")]


@pytest.fixture(params=sorted(PKGS))
def m(request):
    return PKGS[request.param]


@pytest.fixture(params=COMBOS, ids=["-".join(c) for c in COMBOS])
def cs(request):
    """(client package, server package, a started StateStoreServer of the
    server's package over its ObjectStore)."""
    client, server_pkg = (PKGS[n] for n in request.param)
    store = server_pkg.store.ObjectStore()
    server = server_pkg.statestore.StateStoreServer(store)
    server.start()
    yield client, server_pkg, server
    server.stop()


def _wait(fn, timeout=60, interval=0.1, desc="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {desc}")


# -- the reference's networked cases, both packages and across them ---------

def test_remote_store_crud_roundtrip(cs):
    client, srv, server = cs
    Pod = client.types.Pod
    s = client.store
    rs = client.remote.RemoteStore(server.url)
    pod = Pod.new("p1", namespace="ns1")
    pod.metadata.annotations["a"] = "1"
    assert rs.create(pod).metadata.resource_version > 0
    got = rs.get(Pod, "p1", "ns1")
    assert got.metadata.annotations["a"] == "1"
    assert rs.try_get(Pod, "missing", "ns1") is None
    with pytest.raises(s.NotFoundError):
        rs.get(Pod, "missing", "ns1")
    with pytest.raises(s.AlreadyExistsError):
        rs.create(pod)
    got = got.thaw()
    got.metadata.annotations["a"] = "2"
    assert rs.update(got).metadata.generation == 2
    stale = got.deepcopy()
    stale.metadata.annotations["a"] = "3"
    stale.metadata.resource_version = 1
    with pytest.raises(s.ConflictError):
        rs.update(stale, check_version=True)
    up = rs.update_or_create(Pod.new("p2", namespace="ns1")).thaw()
    up.metadata.labels["x"] = "y"
    rs.update_or_create(up)
    assert {p.metadata.name for p in rs.list(Pod, namespace="ns1")} == {"p1", "p2"}
    rs.delete(Pod, "p1", "ns1")
    with pytest.raises(s.NotFoundError):
        rs.delete(Pod, "p1", "ns1")
    assert {p.metadata.name for p in rs.list(Pod)} == {"p2"}
    # the server's store holds what the gateway wrote, in its own types
    held = server.store.get(srv.types.Pod, "p2", "ns1")
    assert held.to_dict() == rs.get(Pod, "p2", "ns1").to_dict()


def test_remote_store_watch_replay_then_live_events(cs):
    client, srv, server = cs
    rs = client.remote.RemoteStore(server.url)
    rs.create(client.types.Pod.new("pre", namespace="d"))
    w = rs.watch("Pod")
    try:
        ev = w.get(timeout=10)
        assert ev.type == client.store.ADDED and ev.obj.metadata.name == "pre"
        live = srv.types.Pod.new("live", namespace="d")
        server.store.create(live)
        ev = w.get(timeout=10)
        assert ev.type == client.store.ADDED and ev.obj.metadata.name == "live"
        live.metadata.annotations["touched"] = "1"
        server.store.update(live)
        ev = w.get(timeout=10)
        assert ev.type == client.store.MODIFIED
        assert ev.obj.metadata.annotations["touched"] == "1"
        server.store.delete(srv.types.Pod, "live", "d")
        assert w.get(timeout=10).type == client.store.DELETED
        server.store.create(srv.types.TPUPool.new("noise"))
        assert w.get(timeout=0.5) is None
    finally:
        w.stop()


def test_gateway_token_roles(cs):
    """The shared token, and the node and client roles: what each may do
    through the other package's client."""
    client, srv, _ = cs
    store = srv.store.ObjectStore()
    server = srv.statestore.StateStoreServer(
        store, token="sekrit", tokens={"node": "nodetok", "client": "clienttok"})
    server.start()
    try:
        Pod, Chip = client.types.Pod, client.types.TPUChip
        with pytest.raises(PermissionError):
            client.remote.RemoteStore(server.url, token="wrong").list(Pod)
        with pytest.raises(PermissionError):
            client.remote.RemoteStore(server.url).list(Pod)
        admin = client.remote.RemoteStore(server.url, token="sekrit")
        assert admin.list(Pod) == []
        # a role's refusal is a 403, which the client raises as its error
        refused = pytest.raises(client.remote.RemoteStoreError, match="403|may not")
        node = client.remote.RemoteStore(server.url, token="nodetok")
        node.create(Chip.new("gpu-0"))
        node.create(Pod.new("p", namespace="d"))
        with refused:
            node.create(client.types.TPUPool.new("pool"))
        assert node.push_metrics(["m,node=n0 v=1i 1"]) == 1
        with pytest.raises(client.remote.RemoteStoreError, match="may not"):
            node.drain_metrics()
        reader = client.remote.RemoteStore(server.url, token="clienttok")
        assert [c.metadata.name for c in reader.list(Chip)] == ["gpu-0"]
        with pytest.raises(client.remote.RemoteStoreError, match="may not"):
            reader.create(Pod.new("q", namespace="d"))
        seq, lines, dropped, _ = admin.drain_metrics()
        assert (seq, lines, dropped) == (1, ["m,node=n0 v=1i 1"], 0)
        with urllib.request.urlopen(server.url + "/healthz", timeout=5) as r:
            assert r.status == 200
    finally:
        server.stop()


def test_remote_watch_conflation_over_http(cs):
    client, srv, server = cs
    rs = client.remote.RemoteStore(server.url, timeout_s=10)
    w = rs.watch("Pod", conflate=True)
    try:
        pod = srv.types.Pod.new("churny", namespace="d")
        server.store.create(pod)
        for i in range(30):
            pod.metadata.annotations["i"] = str(i)
            pod = server.store.update(pod).thaw()
        deadline = time.time() + 10
        latest, n = None, 0
        while time.time() < deadline:
            ev = w.get(timeout=0.5)
            if ev is None:
                if latest is not None and latest.metadata.annotations.get("i") == "29":
                    break
                continue
            n += 1
            latest = ev.obj
        assert latest.metadata.annotations["i"] == "29"
        assert n < 31
    finally:
        w.stop()


def test_remote_store_multi_window_watch_on_4_shard_cell(cs):
    client, srv, _ = cs
    router = srv.sharded.ShardedStore(shards=[srv.store.ObjectStore() for _ in range(4)])
    for i in range(4):
        router.create(srv.types.TPUPool.new(f"seed-{i}"))
    server = srv.statestore.StateStoreServer(router)
    server.start()
    try:
        w = client.remote.RemoteStore(server.url).watch("TPUPool", replay=True)
        seen = {}
        deadline = time.time() + 15
        while len(seen) < 4 and time.time() < deadline:
            ev = w.get(timeout=1.0)
            if ev is not None:
                seen[ev.obj.metadata.name] = ev.type
        assert set(seen) == {f"seed-{i}" for i in range(4)} and w.shards == 4
        for i in range(8):
            router.create(srv.types.TPUPool.new(f"live-{i}"))
        assert len({router.shard_for(srv.types.TPUPool, f"live-{i}") for i in range(8)}) > 1
        got = set()
        deadline = time.time() + 15
        while len(got) < 8 and time.time() < deadline:
            ev = w.get(timeout=1.0)
            if ev is not None and ev.type == "ADDED" and ev.obj.metadata.name.startswith("live-"):
                got.add(ev.obj.metadata.name)
        assert got == {f"live-{i}" for i in range(8)}
        router.delete(srv.types.TPUPool, "live-3")
        _wait(lambda: (lambda ev: ev is not None and ev.type == "DELETED"
                       and ev.obj.metadata.name == "live-3")(w.get(timeout=1.0)),
              timeout=15, interval=0, desc="live-3 deleted")
        w.stop()
    finally:
        server.stop()


def test_watch_reset_after_log_compaction(m):
    store = m.store.ObjectStore()
    store.enable_event_log()
    base_rv = store.create(m.types.Pod.new("a", namespace="d")).metadata.resource_version
    for i in range(8):
        store.create(m.types.Pod.new(f"p{i}", namespace="d"))
    with store._lock:
        drop = len(store._ring) - 4
        del store._ring[:drop]
        store._ring_base += drop
    rv, events, reset = store.events_since(base_rv, ["Pod"])
    assert reset is True and events == []
    _, events2, reset2 = store.events_since(rv - 2, ["Pod"])
    assert reset2 is False and len(events2) == 2


def test_watcher_ahead_of_restarted_store_gets_reset(m):
    store = m.store.ObjectStore()
    store.enable_event_log()
    for i in range(3):
        store.create(m.types.Pod.new(f"p{i}", namespace="d"))
    restarted = m.store.ObjectStore()
    restarted.enable_event_log()
    rv, events, reset = restarted.events_since(store.current_rv, ["Pod"])
    assert reset is True and events == []


@pytest.mark.parametrize("client", sorted(PKGS))
def test_remote_watch_reset_synthesizes_deletions(client, tmp_path):
    """The port's store restarts from its journal while a watcher of
    either package is away, and the events it missed age out: the
    watcher's next poll is told to re-list, and the re-replay, diffed
    against what it had seen, yields a DELETED for the object that
    vanished meanwhile (a partitioned node agent must still reclaim the
    workers of deleted pods).  The server's stop() shuts the watcher's
    connection, so its next poll reaches the restarted store."""
    m = types.SimpleNamespace(**{**vars(PKGS["port"]), "remote": PKGS[client].remote})
    Pod = m.types.Pod
    persist = str(tmp_path / "p")
    store = m.store.ObjectStore(persist_dir=persist)
    server = m.statestore.StateStoreServer(store)
    server.start()
    port = server.port
    store.create(Pod.new("doomed", namespace="d"))
    w = m.remote.RemoteStore(server.url).watch("Pod")
    try:
        ev = w.get(timeout=10)
        assert ev.type == m.store.ADDED and ev.obj.metadata.name == "doomed"
        server.stop()
        store.create(Pod.new("blip", namespace="d"))     # while the server is down
        store.close()
        fresh = m.store.ObjectStore(persist_dir=persist)
        assert fresh.load([Pod]) == 2
        fresh.delete(Pod, "doomed", "d")
        for i in range(8):
            fresh.create(Pod.new(f"filler{i}", namespace="d"))
        with fresh._lock:
            drop = len(fresh._ring)
            del fresh._ring[:drop]
            fresh._ring_base += drop
        server = m.statestore.StateStoreServer(fresh, port=port)
        server.start()
        got = set()
        deadline = time.time() + 20
        while time.time() < deadline and not {
                (m.store.DELETED, "doomed"), (m.store.ADDED, "filler7")} <= got:
            ev = w.get(timeout=1)
            if ev is not None:
                got.add((ev.type, ev.obj.metadata.name))
        assert (m.store.DELETED, "doomed") in got, got
        assert {(m.store.ADDED, "filler7"), (m.store.ADDED, "blip")} <= got
    finally:
        w.stop()
        server.stop()


def test_store_journal_append_compact_and_replay(m, tmp_path):
    Pod = m.types.Pod
    d = str(tmp_path / "persist")
    store = m.store.ObjectStore(persist_dir=d)
    pods = [store.create(Pod.new(f"p{i}", namespace="ns")) for i in range(20)]
    store.flush_journal()
    path = tmp_path / "persist" / "Pod.jsonl"
    assert len(path.read_text().splitlines()) == 20
    p0 = pods[0].thaw()
    p0.metadata.labels["x"] = "1"
    store.update(p0)
    store.flush_journal()
    assert len(path.read_text().splitlines()) == 21
    store.delete(Pod, "p1", "ns")
    store.flush_journal()
    assert json.loads(path.read_text().splitlines()[-1])["op"] == "del"
    store.close()
    fresh = m.store.ObjectStore(persist_dir=d)
    assert fresh.load([Pod]) == 19
    assert fresh.try_get(Pod, "p1", "ns") is None
    assert fresh.get(Pod, "p0", "ns").metadata.labels["x"] == "1"
    fresh.JOURNAL_SLACK = 2
    fresh.JOURNAL_MIN = 8
    for i in range(90):
        p = fresh.get(Pod, "p2", "ns").thaw()
        p.metadata.labels["n"] = str(i)
        fresh.update(p)
    assert len(path.read_text().splitlines()) <= 2 * 19 + 1
    fresh.close()
    again = m.store.ObjectStore(persist_dir=d)
    assert again.load([Pod]) == 19
    assert again.get(Pod, "p2", "ns").metadata.labels["n"] == "89"


def test_journal_replay_survives_torn_trailing_line(m, tmp_path):
    Pod = m.types.Pod
    d = str(tmp_path / "p")
    store = m.store.ObjectStore(persist_dir=d)
    for i in range(3):
        store.create(Pod.new(f"t{i}", namespace="d"))
    store.close()
    path = tmp_path / "p" / "Pod.jsonl"
    with open(path, "a") as f:
        f.write('{"op": "put", "obj": {"metadata": {"na')
    fresh = m.store.ObjectStore(persist_dir=d)
    assert fresh.load([Pod]) == 3
    fresh.create(Pod.new("t3", namespace="d"))
    fresh.close()
    again = m.store.ObjectStore(persist_dir=d)
    assert again.load([Pod]) == 4
    again.close()
    lines = path.read_text().splitlines()
    lines.insert(1, "garbage{{{")
    path.write_text("\n".join(lines) + "\n")
    with pytest.raises(json.JSONDecodeError):
        m.store.ObjectStore(persist_dir=d).load([Pod])


def test_statestore_server_in_process(m, tmp_path):
    Pod = m.types.Pod
    store = m.store.ObjectStore(persist_dir=str(tmp_path / "persist"))
    server = m.statestore.StateStoreServer(store, token="sekrit")
    server.start()
    try:
        with urllib.request.urlopen(server.url + "/healthz", timeout=5) as r:
            assert r.status == 200
        with pytest.raises(PermissionError):
            m.remote.RemoteStore(server.url).list(Pod)
        rs = m.remote.RemoteStore(server.url, token="sekrit")
        rs.create(Pod.new("sp", namespace="d"))
        assert [p.metadata.name for p in rs.list(Pod)] == ["sp"]
        w = rs.watch("Pod")
        try:
            ev = w.get(timeout=10)
            assert ev.type == m.store.ADDED and ev.obj.metadata.name == "sp"
        finally:
            w.stop()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(server.url + "/nope", timeout=5)
        assert err.value.code == 404
    finally:
        server.stop()
    store2 = m.store.ObjectStore(persist_dir=str(tmp_path / "persist"))
    assert store2.load([Pod]) == 1


def test_remote_store_errors_without_operator(m):
    rs = m.remote.RemoteStore("http://127.0.0.1:1", timeout_s=1)
    assert rs.ping() is False
    with pytest.raises(m.remote.RemoteStoreError):
        rs._request("GET", "/api/v1/store/list", query={"kind": "Pod"})


def test_statestore_main_in_process(m, tmp_path):
    persist = tmp_path / "persist"
    seed = m.store.ObjectStore(persist_dir=str(persist))
    seed.create(m.types.Pod.new("seeded", namespace="d"))
    seed.close()
    pf = tmp_path / "port"
    stop = threading.Event()
    rc = []
    th = threading.Thread(target=lambda: rc.append(m.statestore.main(
        ["--port", "0", "--persist-dir", str(persist), "--token", "tok",
         "--port-file", str(pf)], stop_event=stop)))
    th.start()
    try:
        _wait(pf.exists, timeout=30, desc="port file")
        url = f"http://127.0.0.1:{pf.read_text().strip()}"
        rs = m.remote.RemoteStore(url, token="tok")
        _wait(lambda: rs.ping(), desc="healthz")
        assert [p.metadata.name for p in rs.list(m.types.Pod)] == ["seeded"]
        with pytest.raises(PermissionError):
            m.remote.RemoteStore(url).list(m.types.Pod)
    finally:
        stop.set()
        th.join(timeout=10)
    assert rc == [0]


def test_statestore_daemon_main_serves_the_reference_client(tmp_path):
    """``python -m tensorfusion_tpu_torch.statestore`` as a process: its
    flags, port file, persisted journal across a SIGTERM and a restart,
    read by the reference's RemoteStore."""
    pf = tmp_path / "port"

    def spawn():
        pf.unlink(missing_ok=True)
        return subprocess.Popen(
            [sys.executable, "-m", "tensorfusion_tpu_torch.statestore", "--port", "0",
             "--port-file", str(pf), "--persist-dir", str(tmp_path / "p")],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    proc = spawn()
    try:
        _wait(pf.exists, timeout=30, desc="statestore port file")
        rs = ref_remote.RemoteStore(f"http://127.0.0.1:{pf.read_text().strip()}")
        _wait(lambda: rs.ping(), desc="statestore healthz")
        rs.create(ref_types.Pod.new("persisted", namespace="d"))
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 0
    proc = spawn()
    try:
        _wait(pf.exists, timeout=30, desc="statestore restart port file")
        rs = ref_remote.RemoteStore(f"http://127.0.0.1:{pf.read_text().strip()}")
        _wait(lambda: rs.ping(), desc="statestore healthz after restart")
        assert rs.get(ref_types.Pod, "persisted", "d").metadata.name == "persisted"
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_statestore_over_tls(cs, tmp_path, monkeypatch):
    """A self-signed pair from the server package's tlsutil, the store
    served over TLS, and the client package's RemoteStore trusting it
    through TPF_TLS_CA; a client that does not trust it is refused."""
    pytest.importorskip("cryptography")
    client, srv, _ = cs
    tlsutil = sys.modules[srv.statestore.__name__.replace("statestore", "utils.tlsutil")]
    cert, key = str(tmp_path / "cert.pem"), str(tmp_path / "key.pem")
    tlsutil.generate_self_signed(cert, key)
    server = srv.statestore.StateStoreServer(srv.store.ObjectStore(), token="admin",
                                             tokens={"node": "node"}, tls_cert=cert,
                                             tls_key=key)
    server.start()
    try:
        assert server.url.startswith("https://")
        monkeypatch.setenv("TPF_TLS_CA", cert)
        rs = client.remote.RemoteStore(server.url, token="node", timeout_s=10)
        assert rs.ping()
        chip = client.types.TPUChip.new("gpu-tls")
        chip.status.generation = "h100-sxm"
        rs.create(chip)
        assert rs.get(client.types.TPUChip, "gpu-tls").status.generation == "h100-sxm"
        monkeypatch.delenv("TPF_TLS_CA")
        with pytest.raises(client.remote.RemoteStoreError):
            client.remote.RemoteStore(server.url, token="node", timeout_s=10).list(
                client.types.TPUChip)
    finally:
        server.stop()


def test_stop_ends_the_watch_threads_at_once():
    """A watch's stop() shuts the socket of its poll in flight: its thread
    ends at once instead of at the end of the 20 s long-poll, and the
    client holds no connection after close()."""
    store = port_store.ObjectStore()
    server = port_statestore.StateStoreServer(store)
    server.start()
    try:
        rs = port_remote.RemoteStore(server.url)
        w = rs.watch("Pod")
        store.create(port_types.Pod.new("a", namespace="d"))
        assert w.get(timeout=10).obj.metadata.name == "a"
        time.sleep(0.3)                 # the next long-poll is waiting
        with w._threads_lock:
            threads = list(w._threads)
        t0 = time.monotonic()
        w.stop()
        assert time.monotonic() - t0 < 3
        assert not any(t.is_alive() for t in threads)
        rs.list(port_types.Pod)
        rs.close()
        assert rs.list(port_types.Pod)[0].metadata.name == "a"    # dials afresh
    finally:
        server.stop()


# -- the node agent's backend, port against reference ------------------------

class _FixedClock:
    def now(self):
        return 1.7e9

    def monotonic(self):
        return 100.0

    def sleep(self, seconds):
        time.sleep(seconds)

    def wait(self, event, timeout=None):
        return event.wait(timeout)


def _norm(d):
    d = dict(d)
    d["metadata"] = {k: v for k, v in d["metadata"].items() if k != "uid"}
    return d


@pytest.fixture()
def mock_devices(mock_provider_lib, monkeypatch):
    """Each package's DeviceController over its own copy of the mock
    provider (8 v5e chips)."""
    for k in list(os.environ):
        if k.startswith("TPF_MOCK_"):
            monkeypatch.delenv(k)
    out = {}
    for name, pkg in PKGS.items():
        dev = pkg.hv.DeviceController(pkg.hv.Provider(fresh_library(mock_provider_lib,
                                                                    f"cp{name}")))
        dev.start()
        out[name] = dev
    yield out
    for dev in out.values():
        dev.stop()


def test_published_inventory_equal(mock_devices):
    """register_node + publish_chips: the Node, TPUNode and TPUChips the
    port's backend writes are the reference's, field for field."""
    got = {}
    for name, pkg in PKGS.items():
        store = pkg.store.ObjectStore()
        with pkg.clock.use_clock(_FixedClock()):
            backend = pkg.cp.ControlPlaneBackend(
                store, mock_devices[name], node_name="n0", pool="pool-a",
                hypervisor_url="http://n0:8000", known_pids=set)
            backend.register_node()
            backend.publish_chips()
            backend.publish_chips()
        got[name] = sorted((o.KIND, o.key(), _norm(o.to_dict()))
                           for c in (pkg.types.Node, pkg.types.TPUNode, pkg.types.TPUChip)
                           for o in store.list(c))
    assert len(got["port"]) == 10
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("ann", [
    {"tflops": "49.25", "hbm": str(2 << 30)},
    {"duty": "30", "hbm": "4Gi", "isolation": "hard", "qos": "high"},
    {"hbm": str(1 << 30)},
    {"tflops": "1000", "partition": "v5e-1c"},
], ids=["tflops", "duty", "hbm_only", "over_peak"])
def test_pod_annotations_become_equal_worker_specs(mock_devices, ann):
    specs = {}
    for name, pkg in PKGS.items():
        backend = pkg.cp.ControlPlaneBackend(pkg.store.ObjectStore(), mock_devices[name],
                                             node_name="n0")
        chips = [e.info.chip_id for e in mock_devices[name].devices()]
        pod = pkg.types.Pod.new("p", namespace="team")
        pod.spec.node_name = "n0"
        c = pkg.constants
        keys = {"tflops": c.ANN_TFLOPS_REQUEST, "hbm": c.ANN_HBM_REQUEST,
                "duty": c.ANN_DUTY_REQUEST, "isolation": c.ANN_ISOLATION,
                "qos": c.ANN_QOS, "partition": c.ANN_PARTITION_NAME}
        pod.metadata.annotations.update({keys[k]: v for k, v in ann.items()})
        pod.metadata.annotations[c.ANN_CHIP_IDS] = ",".join(chips[:2])
        specs[name] = dataclasses.asdict(backend._worker_spec(pod))
    assert specs["port"] == specs["ref"]


@pytest.mark.parametrize("side", sorted(PKGS))
def test_external_usage_marks_chips(mock_devices, side):
    """The reference's case (tests/test_hypervisor.py), with the probe
    injected: a chip a foreign runtime uses is published as used by an
    external plugin, and reverts once it is gone."""
    pkg = PKGS[side]
    store = pkg.store.ObjectStore()
    chip_ids = [e.info.chip_id for e in mock_devices[side].devices()]
    foreign = {chip_ids[0]}
    backend = pkg.cp.ControlPlaneBackend(store, mock_devices[side], node_name="n0",
                                         pool="pool-a", external_probe=lambda: foreign)
    backend.register_node()
    backend.publish_chips()
    used = {c.metadata.name: c.status.used_by for c in store.list(pkg.types.TPUChip)}
    assert used[chip_ids[0]] == pkg.constants.CHIP_USED_BY_EXTERNAL_PLUGIN
    assert all(v == pkg.constants.CHIP_USED_BY_TPU_FUSION
               for k, v in used.items() if k != chip_ids[0])
    foreign.clear()
    backend.publish_chips()
    assert store.get(pkg.types.TPUChip, chip_ids[0]).status.used_by == \
        pkg.constants.CHIP_USED_BY_TPU_FUSION


class _ProcDevices:
    """A device controller whose chips have the given device paths and
    whose provider reports the given (pid, chip) processes."""

    def __init__(self, paths, procs):
        self.paths, self.procs = paths, procs

    def devices(self):
        return [types.SimpleNamespace(info=types.SimpleNamespace(chip_id=c, device_path=p))
                for c, p in self.paths.items()]

    def proc_stats(self):
        return [types.SimpleNamespace(pid=pid, chip_id=chip) for pid, chip in self.procs]


def test_external_probe_marks_only_pids_it_can_map(tmp_path):
    """The default probe: a pid the provider reports marks its chip only
    where it is a process of this namespace holding the chip's device node
    open.  NVML under some container runtimes reports every process as
    pid 1 (here, a pid holding no such node), and a container's NVML pids
    of another namespace (here, one that does not exist): neither marks
    the chip.
    A process of ours (a worker's pid) never does."""
    node = tmp_path / "nvidia0"
    node.write_bytes(b"")
    holder = subprocess.Popen([sys.executable, "-c",
                               "import sys, time; f = open(sys.argv[1], 'rb'); "
                               "print('open', flush=True); time.sleep(60)", str(node)],
                              stdout=subprocess.PIPE, text=True)
    try:
        assert holder.stdout.readline().strip() == "open"
        paths = {"gpu-0": str(node), "gpu-1": str(tmp_path / "nvidia1")}
        missing = 2 ** 22 + 12345
        while os.path.exists(f"/proc/{missing}"):
            missing += 1

        def probe(procs, known=()):
            backend = port_cp.ControlPlaneBackend(
                port_store.ObjectStore(), _ProcDevices(paths, procs), node_name="n0",
                known_pids=lambda: set(known))
            return backend._probe_external_chips()

        assert probe([(1, "gpu-0"), (1, "gpu-1")]) == set()
        assert probe([(missing, "gpu-0")]) == set()
        assert probe([(holder.pid, "gpu-1")]) == set()       # not that chip's node
        assert probe([(holder.pid, "gpu-0")]) == {"gpu-0"}
        assert probe([(holder.pid, "gpu-0")], known=[holder.pid]) == set()
        assert port_cp.holds_device(holder.pid, str(node))
        assert not port_cp.holds_device(1, str(node))
    finally:
        holder.kill()
        holder.wait()


@pytest.mark.parametrize("side", sorted(PKGS))
def test_pod_watch_adds_and_removes_workers(mock_devices, side):
    """A pod bound to this node with chip ids becomes one worker add; an
    unbound or other node's pod none; its deletion one remove; and stop()
    ends the backend's threads."""
    pkg = PKGS[side]
    store = pkg.store.ObjectStore()
    added, removed = [], []
    backend = pkg.cp.ControlPlaneBackend(store, mock_devices[side], node_name="n0",
                                         known_pids=set)
    backend.start(added.append, removed.append)
    chip = mock_devices[side].devices()[0].info.chip_id
    try:
        for name, node in (("mine", "n0"), ("theirs", "n1"), ("unbound", "")):
            pod = pkg.types.Pod.new(name, namespace="d")
            pod.spec.node_name = node
            pod.metadata.annotations[pkg.constants.ANN_CHIP_IDS] = chip
            pod.metadata.annotations[pkg.constants.ANN_TFLOPS_REQUEST] = "49.25"
            store.create(pod)
        _wait(lambda: added, timeout=10, desc="worker added")
        time.sleep(0.3)
        assert [s.key for s in added] == ["d/mine"]
        assert added[0].devices[0].duty_percent == pytest.approx(25.0)
        store.delete(pkg.types.Pod, "mine", "d")
        _wait(lambda: removed, timeout=10, desc="worker removed")
        assert removed == ["d/mine"]
    finally:
        backend.stop()
    if side == "port":
        assert not backend._thread.is_alive() and not backend._status_thread.is_alive()


# -- the daemon with --operator-url over the stand-in NVML --------------------

@pytest.fixture(scope="module")
def fake_nvml(tmp_path_factory):
    out = tmp_path_factory.mktemp("fake_nvml")
    _build.build_fake_nvml(out)
    return out / "libnvidia-ml.so.1"


def _nvml_env(monkeypatch, fake_nvml):
    for k in list(os.environ):
        if k.startswith("TPF_FAKE_NVML_") or k.startswith("TPF_MOCK_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv(constants.ENV_NVML_LIB, str(fake_nvml))
    monkeypatch.setenv("TPF_FAKE_NVML_COUNT", "2")
    monkeypatch.setenv("TPF_FAKE_NVML_NVLINK", "0-1")
    monkeypatch.setenv("TPF_FAKE_NVML_UNSUPPORTED", "process_utilization")


def _daemon(tmp_path, limiter_lib, url, tag, token="sekrit"):
    from tensorfusion_tpu_torch.hypervisor.__main__ import HypervisorDaemon, build_parser

    args = build_parser().parse_args([
        "--provider", fresh_library(str(_build.provider_path()), tag),
        "--limiter", fresh_library(limiter_lib, tag),
        "--shm-base", str(tmp_path / "shm"), "--state-dir", str(tmp_path / "state"),
        "--snapshot-dir", str(tmp_path / "snap"), "--port", "0",
        "--operator-url", url, "--node-name", "gpu-node-0", "--pool", "pool-h100",
        "--store-token", token, "--metrics-interval-s", "0.2"])
    return HypervisorDaemon(args)


def _tenant_pod(types_mod, c, name, chip, hbm):
    pod = types_mod.Pod.new(name, namespace="default")
    pod.spec.node_name = "gpu-node-0"
    pod.metadata.annotations.update({
        c.ANN_CHIP_IDS: chip, c.ANN_TFLOPS_REQUEST: "247.25",
        c.ANN_HBM_REQUEST: str(hbm), c.ANN_ISOLATION: c.ISOLATION_SOFT,
        c.ANN_QOS: c.QOS_LOW})
    return pod


@pytest.mark.parametrize("server_side", sorted(PKGS))
def test_daemon_joins_a_store_and_serves_a_pod(fake_nvml, limiter_lib, tmp_path, monkeypatch,
                                               server_side):
    """``--operator-url`` to a state store of either package: the node,
    its TPUNode and two H100s as TPUChips, read back by the reference's
    RemoteStore into objects equal to the port's; a pod bound to the node
    at 247.25 TFLOPs becomes a worker whose segment holds 2500 bp and the
    pod's HBM; metrics lines reach the store; deleting the pod removes the
    worker and its segment, the chip still Running; stop() ends the
    daemon's store threads."""
    _nvml_env(monkeypatch, fake_nvml)
    srv = PKGS[server_side]
    store = srv.store.ObjectStore()
    server = srv.statestore.StateStoreServer(store, token="sekrit")
    server.start()
    daemon = _daemon(tmp_path, limiter_lib, server.url, f"join{server_side}")
    before = set(threading.enumerate())
    try:
        t0 = time.monotonic()
        daemon.start()
        ref_rs = ref_remote.RemoteStore(server.url, token="sekrit")
        port_rs = port_remote.RemoteStore(server.url, token="sekrit")
        chips = _wait(lambda: len(ref_rs.list(ref_types.TPUChip)) == 2
                      and ref_rs.list(ref_types.TPUChip), desc="chips published")
        assert time.monotonic() - t0 < 30
        node = ref_rs.get(ref_types.Node, "gpu-node-0")
        tnode = ref_rs.get(ref_types.TPUNode, "gpu-node-0")
        assert node.status.phase == "Running"
        assert tnode.spec.pool == "pool-h100" and tnode.status.phase == "Running"
        assert tnode.status.hypervisor_url == daemon.server.url
        by_index = sorted(chips, key=lambda c: c.status.host_index)
        for i, chip in enumerate(by_index):
            st = chip.status
            assert chip.metadata.name == f"GPU-00000000-0000-0000-0000-00000000000{i}"
            assert (st.generation, st.vendor, st.used_by, st.pool, st.phase) == (
                "h100-sxm", "nvidia", "tpu-fusion", "pool-h100", "Running")
            assert (st.capacity.tflops, st.capacity.duty_percent,
                    st.capacity.hbm_bytes) == (989.0, 100.0, 85520809984.0)
            assert (st.mesh.x, st.mesh.y, st.mesh.z) == (i, 0, 0)
            # NVLink is an ICI link, as the provider maps it
            assert [(l.peer_index, l.kind, l.hops, l.gbps) for l in st.ici_links
                    if l.kind != "self"] == [(1 - i, "ici", 1, 450.0)]
            # the reference's objects are the port's, field for field
            port_chip = port_rs.get(port_types.TPUChip, chip.metadata.name)
            assert port_chip.to_dict() == chip.to_dict()
        chip_id = by_index[0].metadata.name

        ref_rs.create(_tenant_pod(ref_types, ref_constants, "tenant", chip_id, 8 << 30))
        tracked = _wait(lambda: (lambda w: w if w is not None and constants.ENV_SHM_PATH
                                 in w.status.env else None)(daemon.workers.get("default/tenant")),
                        desc="worker")
        dev = port_hv.ShmView(tracked.shm_path).read().devices[0]
        assert (dev.chip_id, dev.duty_limit_bp, dev.hbm_limit_bytes) == (chip_id, 2500, 8 << 30)
        env = tracked.status.env
        assert env[constants.ENV_SHM_PATH] == tracked.shm_path
        assert env[constants.ENV_LD_PRELOAD].split(":")[0] == str(_build.cuda_hook_path())

        seq = _wait(lambda: ref_rs.drain_metrics()[0], timeout=30, desc="metrics pushed")
        _, lines, _, _ = ref_rs.drain_metrics()
        assert seq > 0 and any("gpu-node-0" in l for l in lines)

        ref_rs.delete(ref_types.Pod, "tenant", "default")
        _wait(lambda: daemon.workers.get("default/tenant") is None, desc="worker removed")
        assert not os.path.exists(tracked.shm_path)
        assert port_hv.list_worker_segments(str(tmp_path / "shm")) == []
        assert ref_rs.get(ref_types.TPUChip, chip_id).status.phase == "Running"
    finally:
        daemon.stop()
        server.stop()
    left = [t.name for t in threading.enumerate() if t not in before
            and t.name in ("tpf-remote-watch", "tpf-cp-backend", "tpf-cp-status")]
    assert not left, left


def _bind_fn(rs, c):
    """The reference operator's bind (operator.py ``_bind_pod``): a
    version-checked update that sets the node, merges the stamped
    annotations and marks the pod Running, retried on conflict."""
    def bind(pod, node):
        for attempt in range(5):
            current = rs.get(port_types.Pod, pod.metadata.name, pod.metadata.namespace).thaw()
            current.spec.node_name = node
            current.metadata.annotations.update(pod.metadata.annotations)
            current.status.phase = c.PHASE_RUNNING
            current.status.host_ip = node
            try:
                rs.update(current, check_version=True)
                return
            except port_store.ConflictError:
                if attempt == 4:
                    raise
    return bind


def test_a_pod_submitted_through_webhook_and_scheduler_reaches_the_agent(
        fake_nvml, limiter_lib, tmp_path, monkeypatch):
    """The platform's own path over the fake NVML: the port's webhook
    admits a pod with user annotations only (h100-sxm, duty 25, HBM, soft,
    QoS low), the port's scheduler binds it to the node over an allocator
    fed the store's TPUChips, and the node agent turns it into a worker
    whose segment holds 2500 bp.  The allocator's availability survives
    the agent's next inventory write, and deleting the pod frees both."""
    from tensorfusion_tpu_torch.allocator import IndexAllocator, PortAllocator, TPUAllocator
    from tensorfusion_tpu_torch.config.chip_info import mock_chip_info
    from tensorfusion_tpu_torch.scheduler import (GangManager, ICITopologyPlugin, Scheduler,
                                                  TPUResourcesFit)
    from tensorfusion_tpu_torch.webhook import PodMutator, WorkloadParser

    c = constants
    _nvml_env(monkeypatch, fake_nvml)
    server = port_statestore.StateStoreServer(port_store.ObjectStore(), token="sekrit")
    server.start()
    daemon = _daemon(tmp_path, limiter_lib, server.url, "admit")
    rs = port_remote.RemoteStore(server.url, token="sekrit")
    try:
        daemon.start()
        chips = _wait(lambda: len(rs.list(port_types.TPUChip)) == 2
                      and rs.list(port_types.TPUChip), desc="chips published")
        alloc = TPUAllocator(store=rs)
        for chip in chips:
            alloc.upsert_chip(chip)
        gang = GangManager()
        mutator = PodMutator(rs, WorkloadParser(rs, chip_models=mock_chip_info(),
                                                default_pool="pool-h100"))
        sched = Scheduler(nodes_fn=lambda: [n.metadata.name for n in rs.list(port_types.Node)
                                            if n.status.phase == c.PHASE_RUNNING],
                          bind_fn=_bind_fn(rs, c))
        gang.bind_scheduler(sched)
        sched.register(TPUResourcesFit(alloc, gang=gang, ports=PortAllocator(),
                                       indices=IndexAllocator()))
        sched.register(ICITopologyPlugin())

        pod = port_types.Pod.new("tenant", namespace="default")
        pod.metadata.annotations.update({
            c.ANN_CHIP_GENERATION: "h100-sxm", c.ANN_DUTY_REQUEST: "25",
            c.ANN_HBM_REQUEST: str(8 << 30), c.ANN_ISOLATION: c.ISOLATION_SOFT,
            c.ANN_QOS: c.QOS_LOW})
        pod.spec.containers = [port_types.Container(name="main")]
        pod = rs.create(mutator.handle(pod)).thaw()
        assert pod.metadata.annotations[c.ANN_TFLOPS_REQUEST] == "247.25"
        assert sched.schedule_one(pod).ok
        stored = rs.get(port_types.Pod, "tenant", "default")
        chip_id = stored.metadata.annotations[c.ANN_CHIP_IDS]
        assert stored.spec.node_name == "gpu-node-0" and chip_id in {
            ch.metadata.name for ch in chips}
        assert stored.status.phase == c.PHASE_RUNNING
        tracked = _wait(lambda: (lambda w: w if w is not None and c.ENV_SHM_PATH
                                 in w.status.env else None)(daemon.workers.get("default/tenant")),
                        desc="worker")
        dev = port_hv.ShmView(tracked.shm_path).read().devices[0]
        assert (dev.chip_id, dev.duty_limit_bp, dev.hbm_limit_bytes) == (chip_id, 2500, 8 << 30)

        # the allocator's fields and the agent's: neither reverts the other
        assert alloc.sync_to_store() == 1
        daemon.backend.publish_chips()
        st = rs.get(port_types.TPUChip, chip_id).status
        assert st.available.tflops == pytest.approx(989.0 - 247.25)
        assert st.available.hbm_bytes == st.capacity.hbm_bytes - (8 << 30)
        assert st.running_apps == ["default/tenant"] and st.generation == "h100-sxm"

        rs.delete(port_types.Pod, "tenant", "default")
        alloc.dealloc("default/tenant")
        _wait(lambda: daemon.workers.get("default/tenant") is None, desc="worker removed")
        assert alloc.sync_to_store() == 1
        st = rs.get(port_types.TPUChip, chip_id).status
        assert st.available == st.capacity and st.running_apps == []
    finally:
        rs.close()
        daemon.stop()
        server.stop()


def test_daemon_survives_a_store_restart(fake_nvml, limiter_lib, tmp_path, monkeypatch):
    """The store stops and comes back on its port from its journal: the
    agent's watch resets, its objects are still there, and a pod created
    after the restart reaches it."""
    _nvml_env(monkeypatch, fake_nvml)
    persist = str(tmp_path / "persist")
    server = port_statestore.StateStoreServer(port_store.ObjectStore(persist_dir=persist),
                                              token="sekrit")
    server.start()
    port = server.port
    daemon = _daemon(tmp_path, limiter_lib, server.url, "restart")
    try:
        daemon.start()
        rs = port_remote.RemoteStore(server.url, token="sekrit")
        chips = _wait(lambda: rs.list(port_types.TPUChip), desc="chips published")
        chip_id = chips[0].metadata.name
        rs.create(_tenant_pod(port_types, constants, "first", chip_id, 1 << 30))
        _wait(lambda: daemon.workers.get("default/first"), desc="first worker")
        server.stop()
        server.store.close()
        time.sleep(0.5)
        t0 = time.monotonic()
        store = port_store.ObjectStore(persist_dir=persist)
        assert store.load(port_types.ALL_KINDS) == 5     # node, TPUNode, 2 chips, pod
        server = port_statestore.StateStoreServer(store, port=port, token="sekrit")
        server.start()
        rs.create(_tenant_pod(port_types, constants, "second", chip_id, 1 << 30))
        _wait(lambda: daemon.workers.get("default/second"), timeout=60,
              desc="second worker after the restart")
        assert time.monotonic() - t0 < 60
        assert rs.get(port_types.TPUNode, "gpu-node-0").status.hypervisor_ready
        for name in ("first", "second"):
            rs.delete(port_types.Pod, name, "default")
        _wait(lambda: not daemon.workers.list(), desc="workers removed")
    finally:
        daemon.stop()
        server.stop()
