"""The port's QoS dispatcher (tests/test_remoting_dispatch.py for the
port): the scheduler's unit tests on crafted work items, then the worker
on the CPU over loopback — QoS negotiation, a micro-batched burst from
two connections charged k times on the meter, BUSY backpressure and
deadlines."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensorfusion_tpu_torch import bench_train, constants  # noqa: E402
from tensorfusion_tpu_torch.remoting import (RemoteBusyError,  # noqa: E402
                                             RemoteDeadlineError,
                                             RemoteDevice, RemoteVTPUWorker,
                                             protocol)
from tensorfusion_tpu_torch.remoting.dispatch import (  # noqa: E402
    BusyError, DeviceDispatcher, WorkItem, qos_weight)

torch.set_num_threads(1)
TIMEOUT = 60


def _item(cost=1.0, exe="e", batch_key=None, deadline_t=None, reply=None):
    return WorkItem("EXECUTE", {}, [], reply or (lambda *a, **k: None),
                    cost, exe, batch_key, deadline_t)


def _wait_for(pred, seconds=20):
    deadline = time.monotonic() + seconds
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)


# -- scheduler unit tests (no sockets: deterministic) ---------------------


def test_wfq_serves_in_weight_proportion():
    """Two backlogged tenants at weights 4:1 and equal cost are served
    4:1 (on the virtual-time order, not wall time)."""
    served = []

    def executor(items, peek):
        served.extend(i.tenant.conn_id for i in items)

    disp = DeviceDispatcher(executor)
    a = disp.register_tenant("A", qos=constants.QOS_HIGH)      # weight 4
    b = disp.register_tenant("B", qos=constants.QOS_LOW)       # weight 1
    for _ in range(50):
        disp.submit(a, _item(), block=True)
        disp.submit(b, _item(), block=True)
    disp.start()
    _wait_for(lambda: len(served) >= 100)
    disp.stop()
    assert len(served) == 100
    n_a = served[:40].count("A")
    assert 30 <= n_a <= 34, f"high-QoS share off: {n_a}/40"


def test_fifo_mode_ignores_weights():
    served = []
    disp = DeviceDispatcher(lambda items, peek: served.extend(
        i.tenant.conn_id for i in items), mode="fifo")
    a = disp.register_tenant("A", qos=constants.QOS_CRITICAL)
    b = disp.register_tenant("B", qos=constants.QOS_LOW)
    for _ in range(20):
        disp.submit(a, _item(), block=True)
        disp.submit(b, _item(), block=True)
    disp.start()
    _wait_for(lambda: len(served) >= 40)
    disp.stop()
    assert served == ["A", "B"] * 20


def test_microbatch_collects_across_tenants_in_fifo_order():
    batches = []

    def executor(items, peek):
        batches.append([i.exe_id for i in items])

    disp = DeviceDispatcher(executor, max_microbatch=4)
    a = disp.register_tenant("A")
    b = disp.register_tenant("B")
    for t in (a, b):
        disp.submit(t, _item(exe="m", batch_key="m"), block=True)
        disp.submit(t, _item(exe="m", batch_key="m"), block=True)
        disp.submit(t, _item(exe="solo"), block=True)
    disp.start()
    _wait_for(lambda: sum(len(b_) for b_ in batches) >= 6)
    disp.stop()
    fused = [b_ for b_ in batches if len(b_) > 1]
    assert fused and all(set(b_) == {"m"} for b_ in fused)
    assert max(len(b_) for b_ in fused) <= 4
    assert all(b_ == ["solo"] for b_ in batches if "solo" in b_)


def test_busy_bounds_and_blocking_submit():
    started, release = threading.Event(), threading.Event()

    def executor(items, peek):
        started.set()
        release.wait(10)

    disp = DeviceDispatcher(executor, max_queue_per_tenant=4,
                            max_queue_global=100)
    t = disp.register_tenant("A")
    disp.start()
    try:
        disp.submit(t, _item(), block=False)
        assert started.wait(10)
        for _ in range(4):
            disp.submit(t, _item(), block=False)
        with pytest.raises(BusyError) as ei:
            disp.submit(t, _item(), block=False)
        assert ei.value.retry_after_ms >= 1
        assert disp.busy_rejected == 1
        done = []

        def blocked():
            disp.submit(t, _item(), block=True)
            done.append(1)

        th = threading.Thread(target=blocked, daemon=True)
        th.start()
        time.sleep(0.2)
        assert not done
        release.set()
        th.join(timeout=10)
        assert done
    finally:
        release.set()
        disp.stop()


def test_deadline_expires_in_queue():
    replies = []
    release = threading.Event()

    def executor(items, peek):
        release.wait(10)

    disp = DeviceDispatcher(executor)
    t = disp.register_tenant("A")
    disp.start()
    try:
        disp.submit(t, _item(), block=True)          # occupies the executor
        time.sleep(0.05)
        dead = _item(deadline_t=time.monotonic() + 0.05,
                     reply=lambda kind, meta, bufs: replies.append((kind, meta)))
        disp.submit(t, dead, block=True)
        time.sleep(0.3)                              # deadline passes queued
        release.set()
        _wait_for(lambda: replies, 10)
    finally:
        release.set()
        disp.stop()
    assert replies and replies[0][0] == "ERROR"
    assert replies[0][1]["code"] == "DEADLINE_EXCEEDED"
    assert disp.deadline_exceeded == 1


def test_barrier_waits_for_tenant_completion():
    started, release = threading.Event(), threading.Event()

    def executor(items, peek):
        started.set()
        release.wait(10)

    disp = DeviceDispatcher(executor)
    t = disp.register_tenant("A")
    disp.start()
    try:
        disp.submit(t, _item(), block=True)
        started.wait(5)
        state = {}

        def barrier():
            disp.barrier(t)
            state["done"] = True

        th = threading.Thread(target=barrier, daemon=True)
        th.start()
        time.sleep(0.2)
        assert "done" not in state     # item still in flight
        release.set()
        th.join(timeout=10)
        assert state.get("done")
    finally:
        release.set()
        disp.stop()


def test_qos_weight_ladder_matches_constants():
    for qos, w in constants.QOS_DISPATCH_WEIGHTS.items():
        assert qos_weight(qos) == w
    assert qos_weight(None) == \
        constants.QOS_DISPATCH_WEIGHTS[constants.DEFAULT_QOS]
    assert qos_weight("nonsense") == \
        constants.QOS_DISPATCH_WEIGHTS[constants.DEFAULT_QOS]


def test_ladder_and_queue_defaults_match_the_reference():
    from tensorfusion_tpu import constants as jc
    from tensorfusion_tpu.remoting import dispatch as jd
    from tensorfusion_tpu_torch.remoting import dispatch as td

    assert constants.QOS_DISPATCH_WEIGHTS == jc.QOS_DISPATCH_WEIGHTS
    assert constants.QOS_QUEUE_WAIT_SLO_MS == jc.QOS_QUEUE_WAIT_SLO_MS
    for name in ("DEFAULT_MAX_QUEUE_PER_TENANT", "DEFAULT_MAX_QUEUE_GLOBAL",
                 "DEFAULT_MAX_MICROBATCH"):
        assert getattr(td, name) == getattr(jd, name)
    for name in ("ENV_REMOTING_QOS", "ENV_REMOTING_DISPATCH",
                 "ENV_REMOTING_QUANT", "ENV_REMOTING_PREFETCH_DEPTH",
                 "ENV_TRACE_SAMPLE", "ENV_PROF", "ENV_PROF_BIN_S",
                 "ENV_PROF_BUNDLE_DIR"):
        assert getattr(constants, name) == getattr(jc, name)


# -- worker integration ---------------------------------------------------


@pytest.fixture()
def worker():
    w = RemoteVTPUWorker(device="cpu")
    w.start()
    try:
        yield w
    finally:
        w.stop()


def test_hello_negotiates_qos_weight(worker):
    dev = RemoteDevice(worker.url, qos=constants.QOS_CRITICAL,
                       timeout_s=TIMEOUT)
    try:
        info = dev.info()
        assert dev._wire_version == protocol.VERSION
        assert dev.qos_weight == constants.QOS_DISPATCH_WEIGHTS["critical"]
        assert info["dispatch"]["mode"] == "wfq"
        assert any(t["qos"] == "critical"
                   for t in info["dispatch"]["tenants"].values())
    finally:
        dev.close()


def test_microbatch_fuses_same_executable_burst(worker, limiter_lib,
                                                tmp_path):
    """Two tenants bursting the SAME opted-in executable behind a heavy
    plug: the worker runs compatible requests in fused dispatches
    (dispatches < requests) with per-request results intact, and
    charges the meter once per dispatch, k times the executable's
    MFLOPs for a batch of k."""
    with bench_train.worker_segment(limiter_lib, tmp_path / "seg", "mb",
                                    "cpu") as meter:
        worker.meter_client = meter
        devs = [RemoteDevice(worker.url, qos=q, timeout_s=TIMEOUT)
                for q in ("high", "low")]
        try:
            remotes = [d.remote_jit(lambda w, x: torch.tanh(x @ w),
                                    microbatch=True) for d in devs]
            plug_fn = devs[0].remote_jit(lambda a: (a @ a) @ a)
            plug_arg = torch.ones(768, 768) * 1e-3
            rng = np.random.default_rng(0)
            W = torch.from_numpy(rng.standard_normal((256, 256))
                                 .astype(np.float32))
            xs = [torch.from_numpy(rng.standard_normal((32, 256))
                                   .astype(np.float32)) for _ in range(8)]
            for r in remotes:
                r(W, xs[0])               # compile (one content hash)
            plug_fn(plug_arg)
            with worker._lock:
                costs = dict(worker._exe_costs)
            assert len(costs) == 2
            for attempt in range(5):
                base = devs[0].info()["dispatch"]
                launches0, mflops0 = meter.launches, meter.charged_mflops
                plug = plug_fn.submit(plug_arg)
                futs = [(r.submit(W, x), x) for x in xs for r in remotes]
                for fut, x in futs:
                    torch.testing.assert_close(fut.result(timeout=TIMEOUT),
                                               torch.tanh(x @ W),
                                               rtol=1e-4, atol=1e-4)
                plug.result(timeout=TIMEOUT)
                d = devs[0].info()["dispatch"]
                executed = d["executed"] - base["executed"]
                launches = d["launches"] - base["launches"]
                assert executed == len(futs) + 1
                # one charge per dispatch; every request charged in full
                assert meter.launches - launches0 == launches
                assert meter.charged_mflops - mflops0 == sum(costs.values()) \
                    + (len(futs) - 1) * min(costs.values())
                if launches < executed:
                    break
            assert launches < executed, (launches, executed)
            assert d["microbatched_requests"] > 0
        finally:
            for dev in devs:
                dev.close()
            worker.meter_client = None


def test_busy_backpressure_surfaces_and_sync_path_retries():
    w = RemoteVTPUWorker(max_queue_per_tenant=2, max_queue_global=4,
                         device="cpu")
    w.start()
    try:
        dev = RemoteDevice(w.url, timeout_s=TIMEOUT)
        remote = dev.remote_jit(lambda x: x @ x)
        x = torch.ones(256, 256)
        remote(x)
        futs = [remote.submit(x) for _ in range(32)]
        busy = ok = 0
        for f in futs:
            try:
                f.result(timeout=TIMEOUT)
                ok += 1
            except RemoteBusyError as e:
                assert e.retry_after_ms >= 1
                busy += 1
        assert busy > 0 and ok > 0
        results = []

        def pound():
            results.append(remote(x).sum().item())

        threads = [threading.Thread(target=pound) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert len(results) == 6
        assert dev.info()["dispatch"]["busy_rejected"] >= busy
        dev.close()
    finally:
        w.stop()


def test_deadline_ms_rejected_when_exceeded(worker):
    dev = RemoteDevice(worker.url, timeout_s=TIMEOUT)
    try:
        remote = dev.remote_jit(lambda x: x * 2.0)
        x = torch.ones(64, 64)
        remote(x)
        futs = [remote.submit(x) for _ in range(16)]
        with pytest.raises(RemoteDeadlineError):
            remote(x, deadline_ms=0)
        for f in futs:
            f.result(timeout=TIMEOUT)
        assert dev.info()["dispatch"]["deadline_exceeded"] >= 1
    finally:
        dev.close()


def test_traced_execute_returns_worker_spans(worker):
    """A sampled trace context rides the EXECUTE (v5) and the worker's
    queue, launch, upload and flush spans come back for adoption."""
    from tensorfusion_tpu_torch.tracing import Tracer

    tracer = Tracer(service="client")
    dev = RemoteDevice(worker.url, tracer=tracer, timeout_s=TIMEOUT)
    try:
        remote = dev.remote_jit(lambda x: x + 1)
        remote(torch.ones(4))
        names = {s["name"] for s in tracer.finished()}
        assert {"client.remote_jit", "client.wire", "dispatcher.queue",
                "device.launch", "worker.upload",
                "worker.flush"} <= names, names
        prof = dev.info()["profile"]
        assert prof["totals"]["launches"] >= 1
    finally:
        dev.close()
