"""The port's peer fabric (protocol v9) over loopback, on the CPU.

Ports of the reference's fabric tests (tests/test_fabric.py) that the
link-pool tests of tests/test_torch_remote_serving.py do not cover: the
zero-relay ring (no collective payload through the client, proven by
frame taps), the client-relayed ring for v7/v8 members, pinned older
peers that never see a v9 kind, each smuggled v9 kind refused, migration
rounds on a pooled link, model parallelism against one worker and within
the q8 bound, the fallbacks, and the metrics and INFO.  Then what the
port adds: a ring of port, reference and port workers whose total equals
an all-reference ring's, hop timeouts, and the pool's quantize key.
Workers run with ``device="cpu"`` on port 0.
"""

import json
import logging
import socket
import struct
import threading

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensorfusion_tpu.remoting import FederatedDevice as JFederatedDevice  # noqa: E402
from tensorfusion_tpu.remoting import RemoteVTPUWorker as JWorker  # noqa: E402
from tensorfusion_tpu_torch.remoting import (FederatedDevice,  # noqa: E402
                                             RemoteDevice,
                                             RemoteExecutionError,
                                             RemoteVTPUWorker, protocol,
                                             worker as worker_mod)
from tensorfusion_tpu_torch.remoting.fabric import PeerLinkPool  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 30

#: every v9 kind, both directions
V9_KINDS = ("FABRIC_OPEN", "FABRIC_ALLREDUCE", "PEER_REDUCE", "PEER_INSTALL",
            "FABRIC_OPEN_OK", "FABRIC_ALLREDUCE_OK", "PEER_REDUCE_OK",
            "PEER_INSTALL_OK")
V9_REQUEST_KINDS = ("FABRIC_OPEN", "FABRIC_ALLREDUCE", "PEER_REDUCE",
                    "PEER_INSTALL")


def _workers(n, **kw):
    ws = [RemoteVTPUWorker(device="cpu", **kw) for _ in range(n)]
    for w in ws:
        w.start()
    return ws


def _stop(ws):
    for w in ws:
        w.stop()


@pytest.fixture()
def worker():
    ws = _workers(1)
    yield ws[0]
    _stop(ws)


@pytest.fixture()
def workers2():
    ws = _workers(2)
    yield ws
    _stop(ws)


@pytest.fixture()
def workers3():
    ws = _workers(3)
    yield ws
    _stop(ws)


class FrameTap:
    """A TCP forwarder that records the kind and payload bytes of every
    frame both ways while forwarding the exact bytes.  ``close`` severs
    live connections too, so it models a dead peer."""

    def __init__(self, target_port: int):
        self.target_port = target_port
        self.frames_up = []      # (kind, payload bytes) client -> worker
        self.frames_down = []    # worker -> client
        self._listen = socket.socket()
        self._listen.bind(("127.0.0.1", 0))
        self._listen.listen(8)
        self.port = self._listen.getsockname()[1]
        self.url = f"tcp://127.0.0.1:{self.port}"
        self._alive = True
        self._socks = []
        threading.Thread(target=self._accept, daemon=True).start()

    @property
    def kinds_up(self):
        return [k for k, _ in self.frames_up]

    @property
    def kinds_down(self):
        return [k for k, _ in self.frames_down]

    def _accept(self):
        while self._alive:
            try:
                cli, _ = self._listen.accept()
            except OSError:
                return
            if not self._alive:
                cli.close()
                return
            srv = socket.create_connection(("127.0.0.1", self.target_port))
            self._socks += [cli, srv]
            threading.Thread(target=self._pump,
                             args=(cli, srv, self.frames_up),
                             daemon=True).start()
            threading.Thread(target=self._pump,
                             args=(srv, cli, self.frames_down),
                             daemon=True).start()

    @staticmethod
    def _read_exact(sock, n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("closed")
            buf += chunk
        return buf

    def _pump(self, src, dst, frames):
        try:
            while True:
                head = self._read_exact(src, 12)
                _, hlen = struct.unpack("<II", head[4:])
                header = self._read_exact(src, hlen)
                parsed = json.loads(header)
                body = b"".join(self._read_exact(src, d["nbytes"])
                                for d in parsed["buffers"])
                frames.append((parsed["kind"], len(body)))
                dst.sendall(head + header + body)
        except (OSError, ConnectionError, ValueError):
            try:
                dst.shutdown(2)
            except OSError:
                pass

    def close(self):
        self._alive = False
        try:
            self._listen.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listen.close()
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass


def _ring_sum(parts):
    """The accumulator ring's f32 order, ((p0 + p1) + p2) ..."""
    total = np.asarray(parts[0], np.float32).copy()
    for p in parts[1:]:
        total = total + np.asarray(p, np.float32)
    return total


def _np(t):
    """A port tensor as numpy (bf16 as ml_dtypes.bfloat16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _fed(urls_or_devs, **kw):
    return FederatedDevice(urls_or_devs, timeout_s=TIMEOUT, **kw)


# -- the zero-relay ring ------------------------------------------------------


def test_fabric_ring_zero_client_relay_bytes(workers3):
    """Port of test_fabric.py::test_fabric_ring_zero_client_relay_bytes:
    the total is right on every member, the client's wires carry the
    FABRIC control frames with zero payload bytes and no PEER frame, and
    the peers' wires carry the reduce and install payloads."""
    client_taps = [FrameTap(w.port) for w in workers3]
    peer_taps = [FrameTap(w.port) for w in workers3]
    devs = [RemoteDevice(ct.url, peer_url=pt.url, timeout_s=TIMEOUT)
            for ct, pt in zip(client_taps, peer_taps)]
    try:
        fed = _fed(devs, ring=True)
        assert fed.fabric_supported()
        rng = np.random.default_rng(19)
        parts = [rng.standard_normal((64, 48)).astype(np.float32)
                 for _ in range(3)]
        handles = [dev.put(p) for dev, p in zip(devs, parts)]
        out = fed.all_reduce(handles, free_src=True, install=True,
                             fetch_value=False)
        assert out["value"] is None and len(out["handles"]) == 3
        want = _ring_sum(parts)
        for h in out["handles"]:
            np.testing.assert_array_equal(h.fetch().numpy(), want)
        snap = fed.fed_snapshot()
        assert snap["fabric_rings_total"] == 1
        assert snap["client_relay_bytes"] == 0
        assert out["raw_bytes"] > 0
        for h in out["handles"]:
            h.free()
        peer_kinds = {"PEER_REDUCE", "PEER_INSTALL", "PEER_REDUCE_OK",
                      "PEER_INSTALL_OK"}
        for tap in client_taps:
            assert "FABRIC_OPEN" in tap.kinds_up
            assert "FABRIC_ALLREDUCE" in tap.kinds_up
            assert "FABRIC_ALLREDUCE_OK" in tap.kinds_down
            assert not (set(tap.kinds_up + tap.kinds_down) & peer_kinds)
            assert sum(n for k, n in tap.frames_up + tap.frames_down
                       if k in V9_KINDS) == 0
        reduce_payload = sum(n for t in peer_taps for k, n in t.frames_up
                             if k == "PEER_REDUCE")
        install_payload = sum(n for t in peer_taps for k, n in t.frames_up
                              if k == "PEER_INSTALL")
        assert reduce_payload > 0 and install_payload > 0
    finally:
        for dev in devs:
            dev.close()
        for t in client_taps + peer_taps:
            t.close()


def test_legacy_ring_relays_through_client(workers3):
    """Port of test_fabric.py::test_legacy_ring_relays_through_client:
    the client-relayed ring counts every accumulator byte as relay and
    sums bit for bit like the sequential ring."""
    fed = _fed([w.url for w in workers3], ring=True)
    rng = np.random.default_rng(20)
    parts = [rng.standard_normal((32, 32)).astype(np.float32)
             for _ in range(3)]
    handles = [dev.put(p) for dev, p in zip(fed.workers, parts)]
    out = fed.all_reduce(handles, free_src=True, prefer_fabric=False)
    np.testing.assert_array_equal(out["value"].numpy(), _ring_sum(parts))
    snap = fed.fed_snapshot()
    assert snap["allreduce_total"] == 1 and snap["fabric_rings_total"] == 0
    assert snap["client_relay_bytes"] > 0
    fed.close()


def test_pinned_v8_federation_uses_legacy_ring_bit_compat(caplog):
    """Port of test_fabric.py::
    test_pinned_v8_federation_uses_legacy_ring_bit_compat."""
    ws = _workers(3, protocol_version=8)
    try:
        fed = _fed([w.url for w in ws], ring=True)
        with caplog.at_level(logging.WARNING,
                             logger="tpf_torch.remoting.federation"):
            assert not fed.fabric_supported()
        assert "deprecated" in caplog.text
        assert fed.fed_supported()
        rng = np.random.default_rng(21)
        parts = [rng.standard_normal((48, 16)).astype(np.float32)
                 for _ in range(3)]
        handles = [dev.put(p) for dev, p in zip(fed.workers, parts)]
        out = fed.all_reduce(handles, free_src=True)
        np.testing.assert_array_equal(out["value"].numpy(),
                                      _ring_sum(parts))
        snap = fed.fed_snapshot()
        assert snap["fabric_rings_total"] == 0
        assert snap["client_relay_bytes"] > 0
        fed.close()
    finally:
        _stop(ws)


@pytest.mark.parametrize("old_version", [2, 3, 4, 5, 6, 7, 8])
def test_pinned_old_peers_never_see_v9_opcodes(old_version):
    """Port of test_fabric.py::test_pinned_old_peers_never_see_v9_opcodes:
    federated traffic over a pre-v9 mesh puts no v9 frame on the wire
    either way."""
    ws = _workers(2, protocol_version=old_version)
    taps = [FrameTap(w.port) for w in ws]
    try:
        fed = _fed([t.url for t in taps], ring=True)
        assert not fed.fabric_supported()
        rng = np.random.default_rng(22)
        if old_version >= protocol.FED_MIN_VERSION:
            parts = [rng.standard_normal((16, 16)).astype(np.float32)
                     for _ in range(2)]
            handles = [dev.put(p) for dev, p in zip(fed.workers, parts)]
            out = fed.all_reduce(handles, free_src=True)
            np.testing.assert_array_equal(out["value"].numpy(),
                                          parts[0] + parts[1])
        else:
            x = rng.standard_normal((8, 8)).astype(np.float32)
            got = fed.federated_jit(lambda a: a * 2.0, in_axes=0)(x)
            np.testing.assert_array_equal(got.numpy(), x * 2.0)
        fed.close()
        seen = set()
        for t in taps:
            seen |= set(t.kinds_up + t.kinds_down)
        assert not (seen & set(V9_KINDS)), seen
    finally:
        for t in taps:
            t.close()
        _stop(ws)


@pytest.mark.parametrize("kind", V9_REQUEST_KINDS)
def test_worker_gate_rejects_each_smuggled_v9_kind(worker, kind):
    """Port of test_fabric.py::test_worker_gate_rejects_each_smuggled_v9_kind."""
    s = socket.create_connection(("127.0.0.1", worker.port))
    try:
        protocol.send_message(s, "HELLO", {"max_version": 8, "seq": 1}, [],
                              version=protocol.HELLO_VERSION)
        k, meta, _ = protocol.recv_message(s)
        assert k == "HELLO_OK" and meta["version"] == 8
        protocol.send_message(s, kind, {"cid": "z", "step": 0, "seq": 2},
                              [], version=8)
        k, meta, _ = protocol.recv_message(s)
        assert k == "ERROR" and "protocol >= 9" in meta["error"]
    finally:
        s.close()


def test_pinned_client_refuses_fabric_kinds(worker):
    """Port of test_fabric.py::test_pinned_client_refuses_fabric_kinds."""
    dev = RemoteDevice(worker.url, protocol_version=8, timeout_s=TIMEOUT)
    with pytest.raises(RemoteExecutionError, match="protocol v9"):
        dev.fabric_open("c0")
    with pytest.raises(RemoteExecutionError, match="protocol v9"):
        dev.fabric_allreduce("c0", [], [{"url": dev.url}], 0, "c-r0")
    dev.close()


# -- pooled links -------------------------------------------------------------


def test_migration_rounds_reuse_pooled_link(workers2):
    """Port of test_fabric.py::test_migration_rounds_reuse_pooled_link:
    two migrations to one target lease the same pooled link."""
    src, tgt = workers2
    ten = RemoteDevice(src.url, timeout_s=TIMEOUT)
    orch = RemoteDevice(src.url, timeout_s=TIMEOUT)
    try:
        ten.put(np.arange(2048, dtype=np.float32))
        orch.snapshot_delta(tgt.url)
        orch.migrate_freeze()
        orch.migrate_commit()
        pool = orch.info()["fabric"]["pool"]
        assert pool["dials"] == 1 and pool["leases"] == 1
        ten.put(np.full(1024, 3.0, dtype=np.float32))
        orch.snapshot_delta(tgt.url)
        pool = orch.info()["fabric"]["pool"]
        assert pool["dials"] == 1
        assert pool["leases"] == 2 and pool["hits"] == 1
        orch.migrate_commit(abort=True)
    finally:
        ten.close()
        orch.close()


def test_pool_keys_links_by_quantize(worker):
    """The pool's key holds ``quantize`` as the reference's does: a q8
    lease never reuses a raw link (its connection negotiated no q8)."""
    pool = PeerLinkPool()
    try:
        raw = pool.lease(worker.url)
        raw.device.info()
        pool.release(raw)
        q8 = pool.lease(worker.url, quantize=True)
        assert q8 is not raw and q8.quantize and q8.device.quantize
        pool.release(q8)
        again = pool.lease(worker.url)
        assert again is raw
        pool.release(again)
        assert pool.snapshot()["dials"] == 2
    finally:
        pool.close()


def test_peer_link_pool_idle_ttl_reaps_under_sim_clock(worker):
    """The idle-TTL reap on the injectable clock seam, under the port's
    SimClock: a link idle past the TTL (the port's fixed 60 s) is closed by
    the next sweep, a link inside it survives."""
    from tensorfusion_tpu_torch.remoting import fabric
    from tensorfusion_tpu_torch.sim.clock import SimClock

    assert fabric.PEER_LINK_IDLE_TTL_S == 60.0
    clk = SimClock()
    pool = PeerLinkPool(clock=clk)
    try:
        l1 = pool.lease(worker.url)
        l1.device.info()
        pool.release(l1)                       # parked at t=0
        clk.advance(59.0)
        other = pool.lease(worker.url, quantize=True)
        pool.release(other)                    # sweep: l1 idle 59s <= TTL
        assert pool.snapshot()["expired"] == 0
        clk.advance(2.0)                       # l1 now idle 61s > TTL
        other = pool.lease(worker.url, quantize=True)
        pool.release(other)                    # sweep reaps l1 only
        assert pool.snapshot()["expired"] == 1
        l3 = pool.lease(worker.url)
        assert l3 is not l1
        pool.release(l3)
    finally:
        pool.close()


def test_peer_link_pool_verify_fresh_window_under_sim_clock(worker, monkeypatch):
    """A link re-leased within the fresh window skips the worker_uid round
    trip; past the window it verifies again, under the port's SimClock
    (the window widened to 5 s, as the reference's case sets it)."""
    from tensorfusion_tpu_torch.remoting import fabric
    from tensorfusion_tpu_torch.sim.clock import SimClock

    monkeypatch.setattr(fabric, "PEER_LINK_VERIFY_FRESH_S", 5.0)
    clk = SimClock()
    pool = PeerLinkPool(clock=clk)
    try:
        l1 = pool.lease(worker.url)
        l1.device.info()
        pool.release(l1)                       # last used t=0
        calls = []
        orig_verify = l1.verify
        l1.verify = lambda: (calls.append(1) or orig_verify())
        clk.advance(4.0)                       # inside the window
        l2 = pool.lease(worker.url)
        assert l2 is l1 and calls == []
        pool.release(l2)                       # last used t=4
        clk.advance(6.0)                       # 6s idle > 5s window
        l3 = pool.lease(worker.url)
        assert l3 is l1 and len(calls) == 1
        pool.release(l3)
    finally:
        pool.close()


# -- model parallelism ----------------------------------------------------------


def _stage1(w, x):
    return x @ w


def _stage2(a):
    return torch.tanh(a) + 1.0


def test_model_parallel_matches_single_worker(workers2):
    """Port of test_fabric.py::test_model_parallel_matches_single_worker
    (rtol 1e-4, atol 1e-5 against f64, as the reference)."""
    fed = _fed([w.url for w in workers2])
    mp = fed.model_parallel_jit(_stage1, _stage2, stage1_in_axes=(0, 1))
    rng = np.random.default_rng(23)
    W = rng.standard_normal((33, 24)).astype(np.float32) * 0.05
    x = rng.standard_normal((16, 33)).astype(np.float32)
    got = mp(W, x).numpy()
    want = np.tanh(x.astype(np.float64) @ W.astype(np.float64)) + 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    snap = fed.fed_snapshot()
    assert snap["fabric_rings_total"] == 1
    assert snap["client_relay_bytes"] == 0
    assert snap["shard_execs_total"] >= 2
    fed.close()


def test_model_parallel_q8_bounded(workers2):
    """Port of test_fabric.py::test_model_parallel_q8_bounded: q8 uploads
    and hops stay under the reference's worst-case linear bound."""
    fed = _fed([w.url for w in workers2], quantize=True)
    mp = fed.model_parallel_jit(_stage1, _stage2, stage1_in_axes=(0, 1))
    rng = np.random.default_rng(24)
    W = rng.standard_normal((33, 24)).astype(np.float32) * 0.05
    x = rng.standard_normal((16, 33)).astype(np.float32)
    got = mp(W, x).numpy()
    pre = x @ W
    want = np.tanh(pre) + 1.0
    K = W.shape[0]
    s_x = float(np.abs(x).max()) / 127.0
    s_w = float(np.abs(W).max()) / 127.0
    s_pre = float(np.abs(pre).max()) / 127.0
    s_out = float(np.abs(want).max()) / 127.0
    bound = (K * (s_x / 2) * float(np.abs(W).max())
             + K * (s_w / 2) * float(np.abs(x).max())
             + 2 * (s_pre / 2) + s_out / 2) * 2.0
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)
    assert bound < 1.0
    snap = fed.fed_snapshot()
    assert snap["fabric_rings_total"] == 1
    assert snap["client_relay_bytes"] == 0
    fed.close()


def test_model_parallel_falls_back_without_fabric():
    """Port of test_fabric.py::test_model_parallel_falls_back_without_fabric:
    v8 members psum through client-coordinated collectives, v6 members
    run both stages on worker 0."""
    rng = np.random.default_rng(25)
    W = rng.standard_normal((32, 16)).astype(np.float32) * 0.05
    x = rng.standard_normal((8, 32)).astype(np.float32)
    want = np.tanh(x @ W) + 1.0
    ws = _workers(2, protocol_version=8)
    try:
        fed = _fed([w.url for w in ws])
        mp = fed.model_parallel_jit(_stage1, _stage2, stage1_in_axes=(0, 1))
        np.testing.assert_allclose(mp(W, x).numpy(), want, rtol=1e-4,
                                   atol=1e-5)
        snap = fed.fed_snapshot()
        assert snap["allreduce_total"] == 1
        assert snap["fabric_rings_total"] == 0
        assert snap["client_relay_bytes"] > 0
        fed.close()
    finally:
        _stop(ws)
    ws = _workers(2, protocol_version=6)
    try:
        fed = _fed([w.url for w in ws])
        mp = fed.model_parallel_jit(_stage1, _stage2, stage1_in_axes=(0, 1))
        np.testing.assert_allclose(mp(W, x).numpy(), want, rtol=1e-4,
                                   atol=1e-5)
        snap = fed.fed_snapshot()
        assert snap["fallback_calls_total"] >= 1
        assert snap["allreduce_total"] == 0
        fed.close()
    finally:
        _stop(ws)


# -- observability ----------------------------------------------------------------


def test_fabric_metrics_and_info(workers3):
    """Port of test_fabric.py::test_fabric_metrics_and_info: the
    federation line conforms to the reference's schema and equals the
    reference's encoding of the same ledger; every worker's INFO carries
    the fabric counters (2(n-1) hops of each kind fleet-wide, one ring),
    its pool and its uid; the span is tagged fabric=1."""
    from tensorfusion_tpu.hypervisor.metrics import \
        federation_lines as jfederation_lines
    from tensorfusion_tpu.metrics.schema import METRICS_SCHEMA
    from tensorfusion_tpu_torch.hypervisor.metrics import federation_lines
    from tensorfusion_tpu_torch.tracing.core import Tracer
    from tensorfusion_tpu_torch.tracing.registry import SPAN_SCHEMA

    tracer = Tracer(service="fab-test", sample=1.0)
    fed = _fed([w.url for w in workers3], ring=True, tracer=tracer)
    rng = np.random.default_rng(26)
    parts = [rng.standard_normal((16, 16)).astype(np.float32)
             for _ in range(3)]
    handles = [dev.put(p) for dev, p in zip(fed.workers, parts)]
    out = fed.all_reduce(handles, free_src=True)
    np.testing.assert_array_equal(out["value"].numpy(), _ring_sum(parts))

    snap = fed.fed_snapshot()
    lines = federation_lines(fed, "n1", 123, snap=snap)
    assert lines == jfederation_lines(fed, "n1", 123, snap=snap)
    schema = METRICS_SCHEMA["tpf_fed_collective"]
    head, fields, _ = lines[0].split(" ")
    tags = dict(kv.split("=") for kv in head.split(",")[1:])
    assert set(tags) == set(schema["tags"])
    fvals = dict(kv.split("=") for kv in fields.split(","))
    assert set(fvals) <= set(schema["fields"])
    assert fvals["fabric_rings_total"].rstrip("i") == "1"
    assert fvals["client_relay_bytes_total"].rstrip("i") == "0"

    rings = reduce_hops = install_hops = 0
    for dev in fed.workers:
        info = dev.info()
        fab = info["fabric"]
        assert fab["session"] is None
        assert fab["pool"]["leases"] >= 1
        assert info["worker_uid"].startswith("w-")
        rings += fab["rings_total"]
        reduce_hops += fab["reduce_hops_total"]
        install_hops += fab["install_hops_total"]
    assert rings == 1 and reduce_hops == 2 and install_hops == 2
    spans = [s for s in tracer.finished() if s["name"] == "fed.collective"]
    assert spans and spans[-1]["attrs"].get("fabric") == 1
    assert spans[-1]["attrs"].get("ring") == 0
    assert "hops" in SPAN_SCHEMA["fabric.ring"]["attrs"]
    fed.close()


# -- what the port adds -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_mixed_ring_equals_an_all_reference_ring(dtype):
    """A fabric ring of port, reference and port workers (hops cross
    both packages' workers both ways) installs the same total, bit for
    bit, as a ring of three reference workers on the same numpy
    partials; bf16 is summed in f32 and rounded once a hop on both."""
    rng = np.random.default_rng(27)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    if dtype == "int32":
        parts = [rng.integers(-1000, 1000, (40, 24)).astype(np.int32)
                 for _ in range(3)]
    else:
        parts = [(rng.standard_normal((40, 24)) * 3).astype(np_dtype)
                 for _ in range(3)]
    jws = [JWorker() for _ in range(3)]
    for w in jws:
        w.start()
    try:
        jfed = JFederatedDevice([w.url for w in jws], ring=True)
        assert jfed.fabric_supported()
        handles = [dev.put(p) for dev, p in zip(jfed.workers, parts)]
        want = np.asarray(jfed.all_reduce(handles, free_src=True)["value"])
        jfed.close()
    finally:
        for w in jws:
            w.stop()

    port_ws = _workers(2)
    ref_w = JWorker()
    ref_w.start()
    try:
        urls = [port_ws[0].url, ref_w.url, port_ws[1].url]
        fed = _fed(urls, ring=True)
        assert fed.fabric_supported()
        handles = [dev.put(p if dtype != "bfloat16" else
                           torch.from_numpy(p.view(np.uint16))
                           .view(torch.bfloat16))
                   for dev, p in zip(fed.workers, parts)]
        out = fed.all_reduce(handles, free_src=True, install=True)
        got = _np(out["value"])
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
        for h in out["handles"]:
            assert _np(h.fetch()).tobytes() == want.tobytes()
        assert fed.fed_snapshot()["client_relay_bytes"] == 0
        fed.close()
    finally:
        ref_w.stop()
        _stop(port_ws)


def test_a_ring_member_that_never_launches_times_the_hop_out(workers2,
                                                              monkeypatch):
    """A leg whose predecessor never ships errors after the hop timeout,
    clears its session and counts an abort; the worker keeps serving.
    The hop timeout sits below the freeze's, so a dead ring cannot wedge
    a migration freeze."""
    assert worker_mod.FABRIC_HOP_TIMEOUT_S < worker_mod.MIGRATE_FREEZE_MAX_S
    monkeypatch.setattr(worker_mod, "FABRIC_HOP_TIMEOUT_S", 0.3)
    devs = [RemoteDevice(w.url, timeout_s=TIMEOUT) for w in workers2]
    try:
        for dev in devs:
            dev.fabric_open("c9")
        ref = devs[1].put(np.ones(8, np.float32))
        fut = devs[1].fabric_allreduce(
            "c9", [ref.buf_id], [{"url": d.url} for d in devs], 1,
            devs[1].mint_buf_id("fab"))
        with pytest.raises(RemoteExecutionError, match="timed out"):
            devs[1].finish_collective(fut)
        fab = devs[1].info()["fabric"]
        assert fab["session"] is None and fab["aborted_total"] == 1
        np.testing.assert_array_equal(ref.fetch().numpy(), np.ones(8))
    finally:
        for dev in devs:
            dev.close()
