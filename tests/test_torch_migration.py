"""State on the port's workers, on the CPU: streaming live migration
(protocol v8) and SNAPSHOT / RESTORE.

Ports of the worker-level tests of tests/test_migration_streaming.py
(end to end, dirty generations, freeze, abort, target death, the
low-QoS tenant, the version gates, frame taps, the engine's freeze /
export / import, ``dirty_since`` and INFO), each named in its docstring.
Then what the port adds: the write generation on every install path, a
hosted engine frozen mid-stream (no token while frozen, the same tokens
as an unfrozen stream), SNAPSHOT / RESTORE round trips, snapshot files
byte-equal to the reference worker's, ``state_dir`` held inside
``state_root``, and tampered archives refused at RESTORE and at a
migration install.  Workers run with ``device="cpu"`` on port 0.
"""

import json
import os
import socket
import threading
import time

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensorfusion_tpu.remoting import RemoteDevice as JRemoteDevice  # noqa: E402
from tensorfusion_tpu.remoting import RemoteVTPUWorker as JWorker  # noqa: E402
from tensorfusion_tpu_torch import constants  # noqa: E402
from tensorfusion_tpu_torch.remoting import (RemoteBuffer,  # noqa: E402
                                             RemoteDevice,
                                             RemoteExecutionError,
                                             RemoteVTPUWorker, program,
                                             protocol)
from tensorfusion_tpu_torch.serving import FakeRunner, ServingEngine  # noqa: E402
from tensorfusion_tpu_torch.serving.kvpool import BlockAccount  # noqa: E402
from test_torch_fabric import FrameTap  # noqa: E402
from test_torch_remoting import _bad_blobs, _good_blob  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 30

MIG_KINDS = ("SNAPSHOT_DELTA", "MIGRATE_FREEZE", "MIGRATE_COMMIT",
             "SNAPSHOT_DELTA_OK", "MIGRATE_FREEZE_OK", "MIGRATE_COMMIT_OK")


def _dev(worker_or_url, **kw) -> RemoteDevice:
    return RemoteDevice(getattr(worker_or_url, "url", worker_or_url),
                        timeout_s=TIMEOUT, **kw)


@pytest.fixture()
def pair(tmp_path):
    src = RemoteVTPUWorker(device="cpu", state_root=str(tmp_path))
    tgt = RemoteVTPUWorker(device="cpu", state_root=str(tmp_path))
    src.start()
    tgt.start()
    yield src, tgt
    src.stop()
    tgt.stop()


def _fetch(dev, buf_id, shape=(), dtype="float32"):
    return RemoteBuffer(dev, buf_id, shape, dtype).fetch()


def _tanh2(x):
    return torch.tanh(x) * 2.0


# -- ports of tests/test_migration_streaming.py --------------------------------


def test_streaming_migration_end_to_end(pair):
    """Port of test_migration_streaming.py::
    test_streaming_migration_end_to_end: rounds ship only the dirty set,
    commit publishes the state exactly on the target with a warm
    executable cache and drops it on the source."""
    src, tgt = pair
    ten = _dev(src)
    a = ten.put(np.arange(4096, dtype=np.float32))
    out1 = ten.remote_jit(_tanh2)(np.ones(2048, dtype=np.float32))
    orch = _dev(src)
    r1 = orch.snapshot_delta(tgt.url)
    assert r1["round"] == 1 and r1["buffers"] == 1 and r1["executables"] == 1
    b = ten.put(np.full(1024, 7.0, dtype=np.float32))
    r2 = orch.snapshot_delta(tgt.url)
    assert r2["round"] == 2 and r2["buffers"] == 1
    fr = orch.migrate_freeze()
    assert fr["frozen"] is True and fr["dirty_buffers"] == 0
    cm = orch.migrate_commit()
    assert cm["buffers"] == 2 and cm["executables"] == 1
    assert cm["pause_ms"] < 5000
    t = _dev(tgt)
    np.testing.assert_array_equal(_fetch(t, a.buf_id).numpy(),
                                  np.arange(4096, dtype=np.float32))
    np.testing.assert_array_equal(_fetch(t, b.buf_id).numpy(),
                                  np.full(1024, 7.0, dtype=np.float32))
    assert t.info()["cached_executables"] == 1
    assert torch.equal(out1, t.remote_jit(_tanh2)(np.ones(2048, np.float32)))
    with pytest.raises(RemoteExecutionError):
        a.fetch()
    stats = src.migration_stats()
    assert stats["streaming_total"] == 1 and stats["session"] is None
    assert tgt.migration_stats()["installed_total"] == 2
    # the archive keeps its charge on the target
    assert tgt._exe_costs == src._exe_costs and len(src._exe_costs) == 1
    assert src.resident_bytes == 0
    assert tgt.resident_bytes == (4096 + 1024) * 4
    for d in (ten, orch, t):
        d.close()


def test_dirty_generation_tracks_every_install_path(pair):
    """Port of test_migration_streaming.py::
    test_dirty_generation_tracks_every_install_path (PUT, FREE), and the
    port's other install paths: keep_results, a collective install and
    RESTORE each dirty exactly the buffer they install."""
    src, tgt = pair
    ten = _dev(src)
    orch = _dev(src)
    a = ten.put(np.ones(512, dtype=np.float32))
    assert orch.snapshot_delta(tgt.url)["buffers"] == 1
    a.free()
    c = ten.put(np.full(256, 3.0, dtype=np.float32))
    assert orch.snapshot_delta(tgt.url)["buffers"] == 1
    # keep_results
    (h,) = ten.remote_jit(lambda x: (x + 1.0,)).step_resident(
        np.ones(64, np.float32), wait=True)
    assert orch.snapshot_delta(tgt.url)["buffers"] == 1
    # a collective install under a client-minted id
    rid = ten.mint_buf_id()
    ten.allreduce_ship([c.buf_id], result_id=rid, receipt_only=True)
    assert orch.snapshot_delta(tgt.url)["buffers"] == 1
    # RESTORE of a snapshot (of the same source) re-installs every buffer
    ten.snapshot("snap")
    assert orch.snapshot_delta(tgt.url)["buffers"] == 0
    assert ten.restore("snap")["buffers"] == 3
    assert orch.snapshot_delta(tgt.url)["buffers"] == 3
    orch.migrate_freeze()
    assert orch.migrate_commit()["buffers"] == 3
    t = _dev(tgt)
    np.testing.assert_array_equal(_fetch(t, c.buf_id).numpy(),
                                  np.full(256, 3.0, np.float32))
    # client-minted ids moved to a fresh namespace on the target; the
    # tenant reads its own from INFO on its source connection
    moved = ten.info()["migration"]["moved"]
    assert moved["target_url"] == tgt.url
    assert sorted(moved["ids"]) == sorted([h.buf_id, rid])
    assert orch.info()["migration"]["moved"]["ids"] == {}
    for cid, want in ((h.buf_id, np.full(64, 2.0, np.float32)),
                      (rid, np.full(256, 3.0, np.float32))):
        np.testing.assert_array_equal(
            _fetch(t, moved["ids"][cid], want.shape).numpy(), want)
    with pytest.raises(RemoteExecutionError):
        _fetch(t, a.buf_id)
    for d in (ten, orch, t):
        d.close()


def test_migration_install_dirties_the_target(pair):
    """The migration install is an install path too: the target's
    published buffers are dirty for its own next migration."""
    src, tgt = pair
    ten, orch = _dev(src), _dev(src)
    ten.put(np.ones(128, np.float32))
    orch.snapshot_delta(tgt.url)
    orch.migrate_freeze()
    orch.migrate_commit()
    third = RemoteVTPUWorker(device="cpu")
    third.start()
    try:
        orch2 = _dev(tgt)
        assert orch2.snapshot_delta(third.url)["buffers"] == 1
        orch2.migrate_commit(abort=True)
        orch2.close()
    finally:
        third.stop()
    ten.close()
    orch.close()


def test_freeze_blocks_mutations_until_commit(pair):
    """Port of test_migration_streaming.py::
    test_freeze_blocks_mutations_until_commit."""
    src, tgt = pair
    ten = _dev(src)
    ten.put(np.ones(128, dtype=np.float32))
    orch = _dev(src)
    orch.snapshot_delta(tgt.url)
    orch.migrate_freeze()
    done_at = {}

    def late_put():
        ten.put(np.zeros(64, dtype=np.float32))
        done_at["t"] = time.monotonic()

    t = threading.Thread(target=late_put, daemon=True)
    t.start()
    time.sleep(0.3)
    assert "t" not in done_at, "PUT completed during the freeze"
    assert orch.info()["migration"]["frozen"] is True   # reads still flow
    commit_at = time.monotonic()
    orch.migrate_commit()
    t.join(timeout=10)
    assert done_at["t"] >= commit_at
    ten.close()
    orch.close()


def test_abort_leaves_source_intact(pair):
    """Port of test_migration_streaming.py::test_abort_leaves_source_intact."""
    src, tgt = pair
    ten = _dev(src)
    a = ten.put(np.arange(128, dtype=np.float32))
    orch = _dev(src)
    orch.snapshot_delta(tgt.url)
    orch.migrate_freeze()
    assert orch.migrate_commit(abort=True)["aborted"] is True
    np.testing.assert_array_equal(a.fetch().numpy(),
                                  np.arange(128, dtype=np.float32))
    deadline = time.time() + 5
    while time.time() < deadline and tgt.resident_bytes:
        time.sleep(0.05)
    assert tgt.resident_bytes == 0
    assert src.migration_stats()["aborted_total"] == 1
    assert src.resident_bytes == 128 * 4
    ten.close()
    orch.close()


def test_target_death_mid_session_keeps_source_serving(pair):
    """Port of test_migration_streaming.py::
    test_target_death_mid_session_keeps_source_serving."""
    src, tgt = pair
    link = FrameTap(tgt.port)
    ten = _dev(src)
    a = ten.put(np.ones(2048, dtype=np.float32))
    orch = _dev(src)
    orch.snapshot_delta(link.url)
    link.close()
    ten.put(np.zeros(512, dtype=np.float32))
    fn = ten.remote_jit(lambda x: x * 3.0)
    np.testing.assert_array_equal(fn(np.ones(8, np.float32)).numpy(), 3.0)
    with pytest.raises(RemoteExecutionError):
        orch.snapshot_delta(link.url)
    np.testing.assert_array_equal(a.fetch().numpy(), np.ones(2048))
    assert orch.migrate_commit(abort=True)["aborted"] is True
    ten.close()
    orch.close()


def test_migration_rides_low_qos_dispatch_tenant(pair):
    """Port of test_migration_streaming.py::
    test_migration_rides_low_qos_dispatch_tenant."""
    src, tgt = pair
    ten = _dev(src)
    ten.put(np.ones(1024, dtype=np.float32))
    orch = _dev(src)
    orch.snapshot_delta(tgt.url)
    mig = src.dispatcher.snapshot()["tenants"].get("migration")
    assert mig is not None and mig["qos"] == constants.QOS_LOW
    orch.migrate_commit(abort=True)
    ten.close()
    orch.close()


@pytest.mark.parametrize("old_version", [2, 5, 7])
def test_pinned_old_client_refuses_v8_kinds(pair, old_version):
    """Port of test_migration_streaming.py::
    test_pinned_old_client_refuses_v8_kinds."""
    src, tgt = pair
    tap = FrameTap(src.port)
    try:
        dev = _dev(tap.url, protocol_version=old_version)
        dev.put(np.ones(64, dtype=np.float32))
        for call in (lambda: dev.snapshot_delta(tgt.url),
                     dev.migrate_freeze, dev.migrate_commit):
            with pytest.raises(RemoteExecutionError, match="protocol v8"):
                call()
        assert not (set(tap.kinds_up) | set(tap.kinds_down)) & set(MIG_KINDS)
        dev.close()
    finally:
        tap.close()


def test_worker_gate_rejects_smuggled_v8_frame(pair):
    """Port of test_migration_streaming.py::
    test_worker_gate_rejects_smuggled_v8_frame, for each v8 kind."""
    src, tgt = pair
    sock = socket.create_connection(("127.0.0.1", src.port))
    try:
        protocol.send_message(sock, "HELLO", {"max_version": 7, "seq": 1}, [],
                              version=protocol.HELLO_VERSION)
        kind, meta, _ = protocol.recv_message(sock)
        assert kind == "HELLO_OK" and meta["version"] == 7
        for k in ("SNAPSHOT_DELTA", "MIGRATE_FREEZE", "MIGRATE_COMMIT"):
            protocol.send_message(sock, k, {"target_url": tgt.url,
                                            "seq": 2}, [], version=7)
            kind, meta, _ = protocol.recv_message(sock)
            assert kind == "ERROR" and "protocol >= 8" in meta["error"]
        assert src.migration_stats()["frozen"] is False
    finally:
        sock.close()


def test_taps_see_v8_kinds_and_worker_to_worker_deltas(pair):
    """Port of test_migration_streaming.py::
    test_taps_see_v8_kinds_and_worker_to_worker_deltas."""
    src, tgt = pair
    orch_tap, tgt_tap = FrameTap(src.port), FrameTap(tgt.port)
    try:
        ten = _dev(src)
        ten.put(np.ones(1024, dtype=np.float32))
        orch = _dev(orch_tap.url)
        orch.snapshot_delta(tgt_tap.url)
        orch.migrate_freeze()
        orch.migrate_commit()
        assert "SNAPSHOT_DELTA" in orch_tap.kinds_up
        assert "SNAPSHOT_DELTA_OK" in orch_tap.kinds_down
        assert "MIGRATE_COMMIT" in orch_tap.kinds_up
        assert "PUT" not in orch_tap.kinds_up
        assert "PUT" in tgt_tap.kinds_up
        assert "MIGRATE_COMMIT" in tgt_tap.kinds_up
        assert "MIGRATE_COMMIT_OK" in tgt_tap.kinds_down
        ten.close()
        orch.close()
    finally:
        orch_tap.close()
        tgt_tap.close()


def test_migration_between_port_and_reference_workers():
    """The wire is the reference's: a reference source migrates buffers
    to a port target and a port source to a reference target, exactly."""
    arrays = [np.arange(300, dtype=np.float32),
              (np.arange(64) * 0.37).astype(ml_dtypes.bfloat16)]
    for src_cls, tgt_cls in ((JWorker, RemoteVTPUWorker),
                             (RemoteVTPUWorker, JWorker)):
        kw = lambda cls: {"device": "cpu"} if cls is RemoteVTPUWorker else {}
        src, tgt = src_cls(**kw(src_cls)), tgt_cls(**kw(tgt_cls))
        src.start()
        tgt.start()
        try:
            ten = JRemoteDevice(src.url, timeout_s=TIMEOUT)
            refs = [ten.put(a) for a in arrays]
            orch = JRemoteDevice(src.url, timeout_s=TIMEOUT)
            orch.snapshot_delta(tgt.url)
            orch.migrate_freeze()
            assert orch.migrate_commit()["buffers"] == 2
            t = JRemoteDevice(tgt.url, timeout_s=TIMEOUT)
            for ref, a in zip(refs, arrays):
                got = np.asarray(type(ref)(t, ref.buf_id, a.shape,
                                           a.dtype.name).fetch())
                assert got.dtype == a.dtype and got.tobytes() == a.tobytes()
            for d in (ten, orch, t):
                d.close()
        finally:
            src.stop()
            tgt.stop()


# -- the engine under a freeze ------------------------------------------------------


def test_engine_freeze_export_import_suffix_identical():
    """Port of test_migration_streaming.py::
    test_engine_freeze_export_import_suffix_identical."""
    src_r = FakeRunner(num_blocks=32, block_size=4)
    tgt_r = FakeRunner(num_blocks=32, block_size=4)
    src = ServingEngine(src_r, name="src", max_batch=4)
    tgt = ServingEngine(tgt_r, name="tgt", max_batch=4)
    done = {}

    def emit(seq, toks, d, info):
        done.setdefault(seq.tenant, []).extend(toks)

    seqs = [src.submit([5 + i, 9, 11], 8, tenant=f"t{i}", emit=emit)
            for i in range(3)]
    for _ in range(4):
        src.step()
    assert any(s.tokens for s in seqs)
    src.freeze()
    assert src.step() is False
    moved = src.export_sequences()
    assert len(moved) == 3 and src.account.snapshot()["used"] == 0
    tgt.import_sequences(moved)
    for _ in range(80):
        if not tgt.step():
            break
    for s in seqs:
        expect, tok, pos = [], s.prompt[-1], len(s.prompt) - 1
        while len(expect) < s.max_new_tokens:
            tok = tgt_r._next(tok, pos)
            expect.append(tok)
            pos += 1
        assert s.tokens == expect and done[s.tenant] == expect
    assert tgt.account.snapshot()["used"] == 0
    assert src.snapshot()["migrated_out"] == 3
    assert tgt.snapshot()["migrated_in"] == 3


def test_kvpool_dirty_since_tracks_writes():
    """Port of test_migration_streaming.py::test_kvpool_dirty_since_tracks_writes."""
    acct = BlockAccount(num_blocks=16, block_size=4)
    gen0 = acct.write_gen
    assert acct.ensure("s1", 8)
    assert len(acct.dirty_since(gen0)) == 2
    gen1 = acct.write_gen
    assert acct.dirty_since(gen1) == []
    blk, cow = acct.writable("s1", 0)
    assert cow is None and acct.dirty_since(gen1) == [blk]
    acct.publish("s1", 1, key=1234)
    assert acct.adopt_block("s2", 1234) is not None
    gen2 = acct.write_gen
    new, src_blk = acct.writable("s2", 0)
    assert src_blk is not None and acct.dirty_since(gen2) == [new]
    acct.release("s1")
    acct.release("s2")
    assert acct.dirty_since(0) == [] and acct.snapshot()["used"] == 0


class _SlowRunner(FakeRunner):
    """A FakeRunner whose decode takes 50 ms and says when it runs."""

    def __init__(self):
        super().__init__(num_blocks=64, block_size=4)
        self.in_decode = threading.Event()

    def decode(self, tokens, positions, tables):
        self.in_decode.set()
        time.sleep(0.05)
        out = super().decode(tokens, positions, tables)
        self.in_decode.clear()
        return out


def test_freeze_pauses_a_hosted_engine_between_steps():
    """MIGRATE_FREEZE on a worker hosting an engine returns only once the
    step in flight has ended; no token is made or arrives while frozen;
    a GENERATE sent meanwhile waits at the handler; abort thaws both, and
    the tokens equal an unfrozen stream's."""
    def stream(worker, freeze_at=None):
        dev, orch = _dev(worker), _dev(worker)
        got, times = [], []

        def on_token(t):
            got.append(t)
            times.append(time.monotonic())

        result = {}
        th = threading.Thread(target=lambda: result.update(
            dev.generate([5, 9, 11], 40, on_token=on_token)), daemon=True)
        th.start()
        window = None
        if freeze_at is not None:
            while len(got) < freeze_at:
                time.sleep(0.005)
            orch.migrate_freeze()
            assert not worker.engine.runner.in_decode.is_set()
            made = worker.engine.snapshot()["tokens"]
            while len(got) < made:        # frames sent before the freeze
                time.sleep(0.005)
            n0, t0 = len(got), time.monotonic()
            late = _dev(worker)
            side = threading.Thread(target=lambda: result.update(
                late=late.generate([7], 2)), daemon=True)
            side.start()
            time.sleep(0.3)
            window = (len(got) - n0, worker.engine.snapshot()["tokens"] - made,
                      "late" in result)
            orch.migrate_commit(abort=True)
            side.join(TIMEOUT)
            late.close()
            assert min(times[n0:], default=t0 + 1) > t0 + 0.3
        th.join(TIMEOUT)
        dev.close()
        orch.close()
        return result["tokens"], window

    outs = []
    for freeze_at in (None, 8):
        engine = ServingEngine(_SlowRunner(), name="e", max_batch=4)
        w = RemoteVTPUWorker(device="cpu", engine=engine)
        w.start()
        try:
            outs.append(stream(w, freeze_at))
        finally:
            w.stop()
    (plain, _), (frozen, window) = outs
    assert window == (0, 0, False)
    assert frozen == plain and len(plain) == 40


def test_info_reports_migration_state(pair):
    """Port of test_migration_streaming.py::test_info_reports_migration_state,
    and the port's migration line equals the reference's encoding."""
    from tensorfusion_tpu.hypervisor.metrics import \
        migration_lines as jmigration_lines
    from tensorfusion_tpu_torch.hypervisor.metrics import migration_lines

    src, tgt = pair
    dev = _dev(src)
    info = dev.info()
    assert info["migration"]["frozen"] is False
    assert info["migration"]["session"] is None
    assert info["protocol_version"] == 9
    assert info["fabric"]["session"] is None
    assert info["worker_uid"].startswith("w-")
    dev.put(np.ones(16, np.float32))
    dev.snapshot_delta(tgt.url)
    snap = src.migration_stats()
    assert snap["session"]["round"] == 1
    assert migration_lines(src, "n1", 7, snap=snap) == \
        jmigration_lines(src, "n1", 7, snap=snap)
    dev.migrate_commit(abort=True)
    dev.close()


# -- SNAPSHOT / RESTORE --------------------------------------------------------------


def _puts():
    rng = np.random.default_rng(40)
    return [rng.standard_normal((33, 7)).astype(np.float32),
            (rng.standard_normal(300) * 4).astype(ml_dtypes.bfloat16),
            rng.integers(-9, 9, (5, 6)).astype(np.int32),
            rng.integers(0, 2, 11).astype(bool),
            np.array(2.5, np.float32)]


def _raw(t):
    """A port tensor's bytes."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.uint16)
    return t.numpy().tobytes()


def _as_port(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def test_snapshot_restore_round_trip(tmp_path):
    """SNAPSHOT persists resident buffers (every dtype, a kept result)
    and executables; RESTORE into a fresh worker re-materializes them,
    charged on its budget, and the same program on the same buffer ids
    gives the same result bit for bit."""
    a = RemoteVTPUWorker(device="cpu", state_root=str(tmp_path))
    b = RemoteVTPUWorker(device="cpu", state_root=str(tmp_path))
    a.start()
    b.start()
    try:
        dev = _dev(a)
        refs = [dev.put(_as_port(x)) for x in _puts()]
        fn = dev.remote_jit(lambda x, y: torch.tanh(x) * y)
        (h,) = dev.remote_jit(lambda x: (x * 3.0,)).step_resident(
            refs[0], wait=True)
        want = fn(refs[0], h)
        snap = dev.snapshot("s1")
        assert snap["buffers"] == 6 and snap["executables"] == 2
        assert snap["bytes"] == a.resident_bytes
        d2 = _dev(b)
        got = d2.restore("s1")
        assert got["buffers"] == 6 and got["executables"] == 2
        assert b.resident_bytes == a.resident_bytes
        for ref, x in zip(refs, _puts()):
            out = _fetch(d2, ref.buf_id)
            assert out.dtype == _as_port(x).dtype
            assert tuple(out.shape) == x.shape
            assert _raw(out) == _raw(_as_port(x))
        # the restored cache serves the same program without a COMPILE
        assert d2.info()["cached_executables"] == 2
        r2 = d2.remote_jit(lambda x, y: torch.tanh(x) * y)
        hb = RemoteBuffer(d2, h.buf_id, h.shape, h.dtype)
        rb = RemoteBuffer(d2, refs[0].buf_id, refs[0].shape, refs[0].dtype)
        assert torch.equal(r2(rb, hb), want)
        assert b.executions == 1
        # worker-minted ids continue past the restored ones
        assert int(d2.put(np.ones(2, np.float32)).buf_id.split("-")[1]) > 5
        dev.close()
        d2.close()
    finally:
        a.stop()
        b.stop()


def test_snapshot_files_byte_equal_to_the_reference_worker(tmp_path):
    """The port's manifest and buffer files of the same PUT buffers equal
    the reference worker's, byte for byte (raw little-endian buffers,
    shape and dtype name in manifest.json, bf16 as raw bytes).  Arrays of
    rank >= 1: the reference's client frames a 0-d array as shape [1]
    (``np.ascontiguousarray``), the port's client a 0-d tensor as []."""
    port = RemoteVTPUWorker(device="cpu", state_root=str(tmp_path))
    ref = JWorker()
    port.start()
    ref.start()
    try:
        pdev = _dev(port)
        jdev = JRemoteDevice(ref.url, timeout_s=TIMEOUT)
        for x in _puts()[:4]:
            pdev.put(_as_port(x))
            jdev.put(x)
        pdev.snapshot("port")
        jdev.snapshot(str(tmp_path / "ref"))
        names = sorted(os.listdir(tmp_path / "ref"))
        assert names == sorted(os.listdir(tmp_path / "port"))
        assert "manifest.json" in names and len(names) == 5
        for name in names:
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "ref" / name).read_bytes(), name
        pdev.close()
        jdev.close()
    finally:
        port.stop()
        ref.stop()


def test_state_dir_outside_state_root_refused(tmp_path):
    """``state_dir`` comes off the wire: SNAPSHOT and RESTORE refuse a
    directory that resolves outside the worker's state_root (``..``, an
    absolute path, a symlink out), and both refuse without a root."""
    root = tmp_path / "root"
    root.mkdir()
    outside = tmp_path / "outside"
    outside.mkdir()
    os.symlink(outside, root / "link")
    w = RemoteVTPUWorker(device="cpu", state_root=str(root))
    bare = RemoteVTPUWorker(device="cpu")
    w.start()
    bare.start()
    try:
        dev = _dev(w)
        dev.put(np.ones(4, np.float32))
        for bad in ("../outside", str(outside), "link", "link/x"):
            for call in (dev.snapshot, dev.restore):
                with pytest.raises(RemoteExecutionError,
                                   match="outside the worker's state_root"):
                    call(bad)
        assert os.listdir(outside) == []
        assert dev.snapshot("ok/nested")["buffers"] == 1
        b = _dev(bare)
        for call in (b.snapshot, b.restore):
            with pytest.raises(RemoteExecutionError, match="state_root"):
                call(str(root / "ok/nested"))
        dev.close()
        b.close()
    finally:
        w.stop()
        bare.stop()


def _exe_id(blob):
    import hashlib

    return hashlib.sha256(blob).hexdigest()[:32]


def test_tampered_archive_refused_at_restore(tmp_path):
    """A snapshot directory is no more trusted than a tenant: an archive
    that fails the program check is refused at RESTORE before anything
    of it unpickles (even named by its own hash), one that does not hash
    to its id is refused, and a refused snapshot installs nothing."""
    marker = tmp_path / "pwned"
    w = RemoteVTPUWorker(device="cpu", state_root=str(tmp_path))
    w.start()
    try:
        dev = _dev(w)
        dev.put(np.ones(8, np.float32))
        dev.remote_jit(_tanh2)(np.ones(4, np.float32))
        dev.snapshot("good")
        manifest = json.loads((tmp_path / "good/manifest.json").read_text())
        (good_id,) = manifest["executables"]
        bad = _bad_blobs(marker)
        cases = {"pickled_example_inputs": bad["pickled_example_inputs"],
                 "aten_from_file": bad["aten_from_file"]}
        for case, blob in cases.items():
            d = tmp_path / case
            d.mkdir()
            eid = _exe_id(blob)
            (d / f"{eid}.pt2").write_bytes(blob)
            m = dict(manifest, executables={eid: {"mflops": 1}})
            (d / "manifest.json").write_text(json.dumps(m))
            for name in manifest["buffers"]:
                (d / f"{name}.npy").write_bytes(
                    (tmp_path / "good" / f"{name}.npy").read_bytes())
        swapped = tmp_path / "swapped"
        swapped.mkdir()
        (swapped / f"{good_id}.pt2").write_bytes(_good_blob())
        (swapped / "manifest.json").write_text(json.dumps(manifest))
        fresh = RemoteVTPUWorker(device="cpu", state_root=str(tmp_path))
        fresh.start()
        try:
            d2 = _dev(fresh)
            for case in list(cases) + ["swapped"]:
                with pytest.raises(RemoteExecutionError):
                    d2.restore(case)
                assert not marker.exists(), case
            info = d2.info()
            assert info["cached_executables"] == 0
            assert info["resident_bytes"] == 0
            assert d2.restore("good")["executables"] == 1
            d2.close()
        finally:
            fresh.stop()
        dev.close()
    finally:
        w.stop()


def test_tampered_archive_refused_at_migration_install(pair, tmp_path):
    """A migrating peer's archives are no more trusted than a tenant's:
    those staged for a MIGRATE_COMMIT install are refused unless they
    hash to their id and pass the program check, and staged ids must be
    the connection's own ``c-`` ids (a peer cannot rename another
    client's buffer)."""
    _, tgt = pair
    marker = tmp_path / "pwned"
    other = _dev(tgt)
    victim = other.put(np.ones(4, np.float32))
    peer = _dev(tgt)
    try:
        bad = _bad_blobs(marker)
        for case in ("pickled_example_inputs", "aten_from_file"):
            blob = bad[case]
            sid = f"c-x{case}"
            peer._submit("PUT", {"buf_id": sid, "quiet": True},
                         [np.frombuffer(blob, np.uint8)], want_reply=False)
            with pytest.raises(RemoteExecutionError):
                peer._rpc("MIGRATE_COMMIT", {
                    "manifest": {}, "exes": {_exe_id(blob): sid},
                    "drops": [], "buf_seq": 0, "prepare": True}, [])
            assert not marker.exists(), case
        good = _good_blob()
        peer._submit("PUT", {"buf_id": "c-good", "quiet": True},
                     [np.frombuffer(good, np.uint8)], want_reply=False)
        with pytest.raises(RemoteExecutionError, match="hash"):
            peer._rpc("MIGRATE_COMMIT", {
                "manifest": {}, "exes": {"0" * 32: "c-good"}, "drops": [],
                "buf_seq": 0, "prepare": True}, [])
        with pytest.raises(RemoteExecutionError, match="c- id"):
            peer._rpc("MIGRATE_COMMIT", {
                "manifest": {"stolen": victim.buf_id}, "exes": {},
                "drops": [], "buf_seq": 0}, [])
        np.testing.assert_array_equal(victim.fetch().numpy(), np.ones(4))
        assert peer.info()["cached_executables"] == 0
        assert tgt.resident_bytes == 16
        assert program.check_archive(good) is None
    finally:
        other.close()
        peer.close()


def test_migration_install_never_replaces_a_resident_buffer(pair):
    """A MIGRATE_COMMIT manifest naming a buffer already resident on the
    target is refused whole, so no connection can publish its own staged
    bytes over another client's buffer; a manifest naming another
    connection's client-minted id lands in a fresh namespace instead."""
    _, tgt = pair
    other = _dev(tgt)
    victim = other.put(np.ones(4, np.float32))
    (mine,) = other.remote_jit(lambda x: (x + 1.0,)).step_resident(
        np.ones(3, np.float32), wait=True)
    peer = _dev(tgt)
    try:
        peer._submit("PUT", {"buf_id": "c-s1", "quiet": True},
                     [np.zeros(4, np.float32)], want_reply=False)
        with pytest.raises(RemoteExecutionError, match="already name"):
            peer._rpc("MIGRATE_COMMIT", {
                "manifest": {victim.buf_id: "c-s1"}, "exes": {},
                "drops": [], "buf_seq": 0}, [])
        np.testing.assert_array_equal(victim.fetch().numpy(), np.ones(4))
        # the other connection's full id names no buffer of the peer's
        # namespace: it is published under a fresh one
        full = "cn1:" + mine.buf_id
        assert full in tgt._buffers
        rmeta = peer._rpc("MIGRATE_COMMIT", {
            "manifest": {full: "c-s1"}, "exes": {}, "drops": [],
            "buf_seq": 0}, [])[1]
        new = rmeta["ids"][full]
        assert new != full and new.endswith(":" + mine.buf_id)
        np.testing.assert_array_equal(mine.fetch().numpy(), np.full(3, 2.0))
        np.testing.assert_array_equal(_fetch(peer, new, (4,)).numpy(),
                                      np.zeros(4))
    finally:
        other.close()
        peer.close()


def test_migrated_client_ids_do_not_meet_the_targets_own(pair):
    """The source's first connection and the target's are both ``cn1``,
    and both clients mint ``c-r1-0``: after the migration each id still
    reads its own tenant's bytes, and the migrated tenant finds its id on
    the target through INFO on its source connection."""
    src, tgt = pair
    local = _dev(tgt)
    ten = _dev(src)
    step = lambda x: (x * 2.0,)   # noqa: E731
    (theirs,) = local.remote_jit(step).step_resident(
        np.full(5, 1.0, np.float32), wait=True)
    (ours,) = ten.remote_jit(step).step_resident(
        np.full(5, 3.0, np.float32), wait=True)
    assert theirs.buf_id == ours.buf_id
    orch = _dev(src)
    try:
        orch.snapshot_delta(tgt.url)
        orch.migrate_freeze()
        cm = orch.migrate_commit()
        moved = ten.info()["migration"]["moved"]
        assert moved["target_url"] == tgt.url
        assert cm["ids"] == {"cn1:" + ours.buf_id: moved["ids"][ours.buf_id]}
        np.testing.assert_array_equal(theirs.fetch().numpy(), np.full(5, 2.0))
        np.testing.assert_array_equal(
            _fetch(local, moved["ids"][ours.buf_id], (5,)).numpy(),
            np.full(5, 6.0))
    finally:
        for d in (local, ten, orch):
            d.close()
