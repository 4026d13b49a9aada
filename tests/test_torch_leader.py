"""The port's leader election (tensorfusion_tpu_torch.utils.leader) against
the reference's (tensorfusion_tpu.utils.leader).

The reference's tick-driven cases (tests/test_ha_leader.py) run over both
packages under one manual clock; the port's and the reference's electors
give equal leases, fencing tokens and hand-offs for one sequence of ticks;
a port elector and a reference elector contend for one lease in one store
(an operator replica of either package behind a shared state store), also
over HTTP; the shard leases (tests/test_sharding.py) keep their tokens
across a journal replay; and the file-lock elector hands leadership over.
"""

import threading
import time
import types

import pytest

import tensorfusion_tpu.api.types as ref_types
import tensorfusion_tpu.remote_store as ref_remote
import tensorfusion_tpu.store as ref_store
import tensorfusion_tpu.utils.leader as ref_leader
import tensorfusion_tpu_torch.api.types as port_types
import tensorfusion_tpu_torch.remote_store as port_remote
import tensorfusion_tpu_torch.statestore as port_statestore
import tensorfusion_tpu_torch.store as port_store
import tensorfusion_tpu_torch.utils.leader as port_leader

PKGS = {
    "ref": types.SimpleNamespace(types=ref_types, store=ref_store, leader=ref_leader,
                                 remote=ref_remote),
    "port": types.SimpleNamespace(types=port_types, store=port_store, leader=port_leader,
                                  remote=port_remote),
}


@pytest.fixture(params=sorted(PKGS))
def m(request):
    return PKGS[request.param]


class ManualClock:
    """Wall and monotonic time that move only when advanced."""

    def __init__(self, t=1000.0):
        self.t = t

    def now(self):
        return self.t

    def monotonic(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds

    def wait(self, event, timeout=None):
        if timeout:
            self.t += timeout
        return event.is_set()

    def advance(self, seconds):
        self.t += seconds


class Skewed(ManualClock):
    """A view of another clock whose wall time is off by ``skew_s``."""

    def __init__(self, base, skew_s):
        self.base, self.skew_s = base, skew_s

    def now(self):
        return self.base.now() + self.skew_s

    def monotonic(self):
        return self.base.monotonic()


def test_store_elector_single_winner_and_handoff(m):
    sim = ManualClock()
    store = m.store.ObjectStore()
    events = []
    a = m.leader.StoreLeaderElector(store, "a", endpoint="http://a", lease_duration_s=2.0,
                                    renew_interval_s=0.1, clock=sim,
                                    on_started_leading=lambda: events.append("a+"))
    b = m.leader.StoreLeaderElector(store, "b", endpoint="http://b", lease_duration_s=2.0,
                                    renew_interval_s=0.1, clock=sim,
                                    on_started_leading=lambda: events.append("b+"))
    a.campaign_tick()
    assert a.is_leader
    for _ in range(5):
        sim.advance(0.1)
        a.campaign_tick()
        b.campaign_tick()
    assert not b.is_leader
    token_a = a.fencing_token
    assert a.leader_info()["identity"] == "a"
    assert b.leader_info()["endpoint"] == "http://a"
    a.stop()
    b.campaign_tick()
    assert b.is_leader and b.fencing_token > token_a
    lease = store.get(m.types.Lease, m.leader.StoreLeaderElector.LEASE_NAME)
    assert lease.spec.holder == "b" and lease.spec.transitions >= 1
    assert events == ["a+", "b+"]
    b.stop()


def test_store_elector_crash_takeover_after_ttl(m):
    sim = ManualClock()
    store = m.store.ObjectStore()
    a = m.leader.StoreLeaderElector(store, "a", lease_duration_s=0.6,
                                    renew_interval_s=0.1, clock=sim)
    a.campaign_tick()
    assert a.is_leader
    b = m.leader.StoreLeaderElector(store, "b", lease_duration_s=0.6,
                                    renew_interval_s=0.1, clock=sim)
    b.campaign_tick()
    assert not b.is_leader
    sim.advance(0.5)
    b.campaign_tick()
    assert not b.is_leader
    sim.advance(0.2)
    b.campaign_tick()
    assert b.is_leader
    assert a._renew() is False


def test_lease_expiry_across_clock_skew(m):
    sim = ManualClock()
    store = m.store.ObjectStore()
    a = m.leader.StoreLeaderElector(store, "a", lease_duration_s=10.0,
                                    renew_interval_s=2.0, clock=sim)
    a.campaign_tick()
    behind = m.leader.StoreLeaderElector(store, "slow", lease_duration_s=10.0,
                                         renew_interval_s=2.0, clock=Skewed(sim, -30.0))
    sim.advance(11.0)
    behind.campaign_tick()
    assert not behind.is_leader
    a.campaign_tick()
    assert a.is_leader
    ahead = m.leader.StoreLeaderElector(store, "fast", lease_duration_s=10.0,
                                        renew_interval_s=2.0, clock=Skewed(sim, 30.0))
    token_before = a.fencing_token
    ahead.campaign_tick()
    assert ahead.is_leader and ahead.fencing_token > token_before
    a.campaign_tick()
    assert not a.is_leader


def test_shard_lease_failover_journal_replay_bumps_fencing_token(m, tmp_path):
    root = str(tmp_path / "shard-00")
    store = m.store.ObjectStore(persist_dir=root)
    owner = m.leader.ShardLeaseElector(store, 0, "owner-a", lease_duration_s=0.05)
    owner.campaign_tick()
    assert owner.is_leader and owner.fencing_token == 1
    store.create(m.types.Pod.new("survivor", namespace="ns"))
    store.close()
    successor_store = m.store.ObjectStore(persist_dir=root)
    assert successor_store.load(m.types.ALL_KINDS) >= 2
    successor = m.leader.ShardLeaseElector(successor_store, 0, "owner-b",
                                           lease_duration_s=0.05)
    time.sleep(0.06)
    successor.campaign_tick()
    assert successor.is_leader and successor.fencing_token == 2
    owners = [m.leader.ShardLeaseElector(successor_store, i, f"op-{i}") for i in range(1, 4)]
    for e in owners:
        e.campaign_tick()
    assert all(e.is_leader for e in owners)
    assert [e.lease_name for e in owners] == [m.leader.shard_lease_name(i) for i in range(1, 4)]
    successor_store.close()


def test_file_lock_elector_hands_over(m, tmp_path):
    lock = str(tmp_path / "leader.lock")
    started = []
    a = m.leader.LeaderElector(lock, "a", endpoint="http://a", retry_interval_s=0.05,
                               on_started_leading=lambda: started.append("a"))
    b = m.leader.LeaderElector(lock, "b", endpoint="http://b", retry_interval_s=0.05,
                               on_started_leading=lambda: started.append("b"))
    a.start()
    assert a.wait_for_leadership(10)
    b.start()
    time.sleep(0.2)
    assert not b.is_leader
    assert m.leader.LeaderElector.read_leader_info(lock)["identity"] == "a"
    a.stop()
    assert b.wait_for_leadership(10)
    assert m.leader.LeaderElector.read_leader_info(lock)["endpoint"] == "http://b"
    b.stop()
    assert started == ["a", "b"]


def _lease_trace(pkg, clock):
    """Three electors of ``pkg`` on one store through a fixed schedule of
    ticks, crashes and resignations: each step's leader, token and lease."""
    store = pkg.store.ObjectStore()
    el = {n: pkg.leader.StoreLeaderElector(store, n, endpoint=f"http://{n}",
                                           lease_duration_s=1.0, renew_interval_s=0.2,
                                           clock=clock) for n in "abc"}
    alive = set("abc")
    trace = []
    for step in range(60):
        clock.advance(0.25)
        if step == 20:
            alive.discard("a")       # the holder crashes: no more ticks
        if step == 40:
            el["b"].stop()           # a graceful resignation
            alive.discard("b")
        for n in sorted(alive):
            el[n].campaign_tick()
        lease = store.get(pkg.types.Lease, pkg.leader.StoreLeaderElector.LEASE_NAME).to_dict()
        lease["metadata"] = {k: v for k, v in lease["metadata"].items()
                             if k not in ("uid", "creation_timestamp")}
        trace.append(([n for n in "abc" if el[n].is_leader and n in alive],
                      {n: el[n].fencing_token for n in "abc"}, lease))
    return trace


def test_electors_give_equal_leases_and_tokens():
    ref = _lease_trace(PKGS["ref"], ManualClock())
    port = _lease_trace(PKGS["port"], ManualClock())
    assert [t[0] for t in port][-1] == ["c"]
    assert port == ref


@pytest.mark.parametrize("over", ["store", "http"])
def test_a_port_and_a_reference_replica_share_one_lease(over):
    """A port elector and a reference elector contend for one lease, in one
    in-process store or through the port's state store over HTTP (each
    package's RemoteStore): one leads at a time, the other takes over once
    its lease lapses, with a higher fencing token."""
    server = None
    if over == "store":
        store = port_store.ObjectStore()
        stores = {"ref": store, "port": store}
    else:
        server = port_statestore.StateStoreServer(port_store.ObjectStore())
        server.start()
        stores = {n: PKGS[n].remote.RemoteStore(server.url) for n in PKGS}
    try:
        sim = ManualClock(time.time())
        el = {n: PKGS[n].leader.StoreLeaderElector(stores[n], n, lease_duration_s=2.0,
                                                   renew_interval_s=0.5, clock=sim)
              for n in ("port", "ref")}
        el["port"].campaign_tick()
        el["ref"].campaign_tick()
        assert el["port"].is_leader and not el["ref"].is_leader
        assert el["ref"].leader_info()["identity"] == "port"
        sim.advance(1.0)
        el["port"].campaign_tick()
        el["ref"].campaign_tick()
        assert not el["ref"].is_leader
        sim.advance(2.5)                     # the port's replica stops renewing
        el["ref"].campaign_tick()
        assert el["ref"].is_leader
        assert el["ref"].fencing_token > el["port"].fencing_token
        el["port"].campaign_tick()
        assert not el["port"].is_leader
        el["ref"].stop()
        el["port"].campaign_tick()
        assert el["port"].is_leader
    finally:
        if server is not None:
            server.stop()


def test_store_elector_thread_campaigns_and_stops():
    """The port's elector with its own campaign thread on the wall clock:
    it leads within a renew interval, and stop() resigns and ends it."""
    store = port_store.ObjectStore()
    led = threading.Event()
    e = port_leader.StoreLeaderElector(store, "solo", lease_duration_s=1.0,
                                       renew_interval_s=0.05,
                                       on_started_leading=led.set)
    e.start()
    try:
        assert e.wait_for_leadership(10) and led.is_set()
    finally:
        e.stop()
    assert not e.is_leader
    lease = store.get(port_types.Lease, port_leader.StoreLeaderElector.LEASE_NAME)
    assert lease.spec.renew_time == 0
