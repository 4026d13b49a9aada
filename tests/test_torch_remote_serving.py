"""Serving over the wire in the port, on the CPU: GENERATE streaming and
KV_SHIP into a worker-hosted ``ServingEngine``, against the reference's
own tests of this path (tests/test_serving.py) and the reference's
worker and client.

Both packages get the same numpy weights (the JAX package's
``init_params`` at ``LlamaConfig.tiny()``, carried to the port by
``convert.params_from_numpy``).  Greedy tokens are held exactly: the
port's streamed tokens equal the reference worker's and ``generate``'s;
KV_SHIP equals GENERATE; q8 equals raw.  Interop runs both ways (each
package's client against the other's worker) for GENERATE and for
KV_SHIP with f32 pages inline and bf16 pages as ephemeral PUTs.  The
hypervisor's ``serving_engine_lines`` must equal the reference's line
for line under one manual clock.  Every worker runs on the CPU on port
0 and stops in a ``finally``; every client waits at most ``TIMEOUT``
seconds for a frame.
"""

import dataclasses
import itertools
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")
import jax.numpy as jnp  # noqa: E402

from tensorfusion_tpu.hypervisor.metrics import serving_engine_lines as j_lines  # noqa: E402
from tensorfusion_tpu.metrics.encoder import parse_line  # noqa: E402
from tensorfusion_tpu.metrics.schema import METRICS_SCHEMA  # noqa: E402
from tensorfusion_tpu.models import llama as jl  # noqa: E402
from tensorfusion_tpu.remoting import RemoteDevice as JDevice  # noqa: E402
from tensorfusion_tpu.remoting import RemoteVTPUWorker as JWorker  # noqa: E402
from tensorfusion_tpu.remoting import client as jclient  # noqa: E402
from tensorfusion_tpu import serving as jserving  # noqa: E402
from tensorfusion_tpu.serving.disagg import _Job as JJob  # noqa: E402
from tensorfusion_tpu.tracing.export import to_chrome as j_to_chrome  # noqa: E402
from tensorfusion_tpu.tracing.export import validate as j_validate  # noqa: E402
from tensorfusion_tpu_torch.hypervisor.metrics import serving_engine_lines  # noqa: E402
from tensorfusion_tpu_torch.models import convert  # noqa: E402
from tensorfusion_tpu_torch.models import llama as tl  # noqa: E402
from tensorfusion_tpu_torch.remoting import (RemoteDevice,  # noqa: E402
                                             RemoteDeadlineError,
                                             RemoteExecutionError,
                                             RemoteVTPUWorker, client, protocol)
from tensorfusion_tpu_torch.remoting.fabric import PeerLinkPool  # noqa: E402
from tensorfusion_tpu_torch.serving import (FakeRunner, LlamaRunner,  # noqa: E402
                                            PrefillPool, RemoteKVShipper,
                                            ServingEngine)
from tensorfusion_tpu_torch.serving.disagg import _Job  # noqa: E402
from tensorfusion_tpu_torch.tracing import Tracer  # noqa: E402
from tensorfusion_tpu_torch.tracing.export import to_chrome, validate  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 60
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(dtype="float32"):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=DTYPES[dtype][0])
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tl.LlamaConfig)}
    fields["dtype"] = DTYPES[dtype][1]
    return jcfg, tl.LlamaConfig(**fields)


@pytest.fixture(scope="module")
def models():
    """dtype -> (jax config, port config, jax params, port params), the
    same numpy weights on both sides."""
    out = {}
    for dtype in DTYPES:
        jcfg, tcfg = _configs(dtype)
        jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
        tp = convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        out[dtype] = (jcfg, tcfg, jp, tp)
    return out


@pytest.fixture(scope="module")
def model(models):
    return models["float32"]


def _engine(tp, tcfg, num_blocks=64, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_chunk_tokens", 8)
    return ServingEngine(LlamaRunner(tp, tcfg, num_blocks=num_blocks,
                                     block_size=4, device="cpu"), **kw)


def _jengine(jp, jcfg, num_blocks=64, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_chunk_tokens", 8)
    return jserving.ServingEngine(
        jserving.LlamaRunner(jp, jcfg, num_blocks=num_blocks, block_size=4),
        **kw)


class _Worker:
    """A started worker (either package's), stopped on exit."""

    def __init__(self, worker):
        self.worker = worker

    def __enter__(self):
        self.worker.start()
        return self.worker

    def __exit__(self, *exc):
        self.worker.stop()


@pytest.fixture()
def serving_worker(model):
    _, tcfg, _, tp = model
    with _Worker(RemoteVTPUWorker(engine=_engine(tp, tcfg), device="cpu")) as w:
        yield w


def _dev(worker, **kw) -> RemoteDevice:
    return RemoteDevice(worker.url, timeout_s=TIMEOUT, **kw)


def _ref_tokens(model, prompt, n):
    """The port's local ``generate`` (held to the reference's in
    tests/test_torch_llama.py, and here in the first test)."""
    _, tcfg, _, tp = model
    return tl.generate(tp, torch.tensor([prompt]), n, tcfg,
                       device="cpu")[0].tolist()


def _payload(pool, prompt, owner):
    """Prefill ``prompt`` on the inline pool's first worker; its payload."""
    w = pool.workers[0]
    job = (JJob if isinstance(pool, jserving.PrefillPool) else _Job)(
        None, prompt, owner)
    st = w.advance(job)
    while st is False:
        st = w.advance(job)
    return w.payload(job)


def _port_pool(tp, tcfg):
    return PrefillPool([LlamaRunner(tp, tcfg, num_blocks=64, block_size=4,
                                    device="cpu")], inline=True)


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _ship(dev, prompt, n, payload, convert_pages=None):
    k, v = payload["k"], payload["v"]
    if convert_pages is not None:
        k, v = convert_pages(k), convert_pages(v)
    return dev.ship_kv(prompt, n, payload["keys"], k, v,
                       payload["first_token"], payload["n_tokens"])


# -- GENERATE ----------------------------------------------------------------


def test_generate_streams_tokens_over_tcp(serving_worker, model):
    """Streamed tokens equal ``generate``'s and the reference worker's
    for the same prompt and weights."""
    jcfg, _, jp, _ = model
    prompt = [3, 1, 4, 1, 5, 9]
    want = [int(x) for x in np.asarray(jl.generate(
        jp, jnp.asarray([prompt], jnp.int32), 7, jcfg))[0]]
    dev = _dev(serving_worker)
    streamed = []
    try:
        r = dev.generate(prompt, 7, on_token=streamed.append)
    finally:
        dev.close()
    assert r["tokens"] == want and streamed == want
    assert r["finish_reason"] == "length" and r["n_tokens"] == 7
    assert r["ttft_ms"] is not None and r["ttft_ms"] >= 0
    assert _ref_tokens(model, prompt, 7) == want
    with _Worker(JWorker(engine=_jengine(jp, jcfg))) as jw:
        jdev = JDevice(jw.url, timeout_s=TIMEOUT)
        try:
            assert jdev.generate(prompt, 7)["tokens"] == r["tokens"]
        finally:
            jdev.close()


def test_generate_concurrent_tenants_share_the_batch(serving_worker, model):
    prompt = [2, 7, 1, 8]
    want = _ref_tokens(model, prompt, 6)
    devs = [_dev(serving_worker, qos=q)
            for q in ("low", "medium", "high", "critical")]
    out = {}

    def run(i, d):
        out[i] = d.generate(prompt, 6)["tokens"]

    threads = [threading.Thread(target=run, args=(i, d))
               for i, d in enumerate(devs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    for d in devs:
        d.close()
    assert all(out.get(i) == want for i in range(4)), out
    snap = serving_worker.engine.snapshot()
    assert snap["retired"] >= 4
    # each connection is its own serving tenant, with its HELLO QoS
    assert {"low", "medium", "high", "critical"} <= \
        {t["qos"] for t in snap["tenants"].values()}


def test_generate_non_streaming_single_frame(serving_worker, model):
    """``stream=False``: every token arrives with the one final frame."""
    import queue as _queue

    prompt = [1, 2, 3]
    want = _ref_tokens(model, prompt, 5)
    dev = _dev(serving_worker)
    try:
        seen = []
        r = dev.generate(prompt, 5, stream=False, on_token=seen.append)
        q = _queue.Queue()
        dev._submit("GENERATE", {"prompt": prompt, "max_tokens": 5,
                                 "stream": False}, [], stream=q)
        kind, meta, _ = q.get(timeout=TIMEOUT)
    finally:
        dev.close()
    assert r["tokens"] == want and seen == want
    assert kind == "GENERATE_OK" and meta["done"] and meta["tokens"] == want
    assert q.empty()


def test_generate_busy_and_deadline_codes(model):
    """A saturated engine answers BUSY (the client retries, bounded) and
    a 0 ms admission deadline comes back as RemoteDeadlineError."""
    _, tcfg, _, tp = model
    eng = _engine(tp, tcfg, max_batch=1, prefill_chunk_tokens=4,
                  max_waiting=1)
    with _Worker(RemoteVTPUWorker(engine=eng, device="cpu")) as w:
        hog = _dev(w)
        slow = threading.Thread(target=lambda: hog.generate([1, 2, 3, 4], 40))
        slow.start()
        late = _dev(w)
        deadline_errors = 0
        for _ in range(6):
            try:
                late.generate([5, 6], 3, deadline_ms=0.0)
            except RemoteDeadlineError:
                deadline_errors += 1
            except RemoteExecutionError:     # BUSY past its retries
                pass
        slow.join(timeout=TIMEOUT)
        hog.close()
        late.close()
    assert deadline_errors > 0
    assert eng.snapshot()["shed"] >= deadline_errors


def test_generate_without_engine_errors():
    with _Worker(RemoteVTPUWorker(device="cpu")) as w:
        dev = _dev(w)
        try:
            with pytest.raises(RemoteExecutionError, match="no serving"):
                dev.generate([1, 2], 3)
            with pytest.raises(RemoteExecutionError, match="no serving"):
                dev.ship_kv([1, 2], 3, [1], None, None, 1, 2)
            assert dev.info()["serving"] is None
        finally:
            dev.close()


def test_generate_requires_v5():
    with _Worker(RemoteVTPUWorker(protocol_version=4, device="cpu")) as w:
        dev = _dev(w)
        try:
            with pytest.raises(RemoteExecutionError, match="protocol v5"):
                dev.generate([1, 2], 3)
        finally:
            dev.close()


def test_dead_client_socket_does_not_stop_the_engine(serving_worker, model):
    """A tenant whose socket dies mid-stream loses its tokens; the engine
    keeps serving the others."""
    dead = _dev(serving_worker)
    first = threading.Event()

    def run():
        try:
            dead.generate([4, 4, 4], 30, on_token=lambda t: first.set())
        except (ConnectionError, RemoteExecutionError):
            pass
    t = threading.Thread(target=run)
    t.start()
    assert first.wait(TIMEOUT)
    dead._sock.shutdown(socket.SHUT_RDWR)   # the session dies mid-stream
    t.join(timeout=TIMEOUT)
    dev = _dev(serving_worker)
    try:
        assert dev.generate([1, 2, 3], 4)["tokens"] == \
            _ref_tokens(model, [1, 2, 3], 4)
    finally:
        dev.close()
        dead.close()
    deadline = time.monotonic() + TIMEOUT
    while serving_worker.engine.snapshot()["active"] and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert serving_worker.engine.snapshot()["kv"]["used"] == 0


# -- tracing -----------------------------------------------------------------


def test_generate_assembles_serving_trace(serving_worker):
    """The client's span and the engine's join one trace, which both
    packages' ``validate`` accept."""
    tr = Tracer(service="client")
    dev = _dev(serving_worker, tracer=tr)
    try:
        r = dev.generate([1, 2, 3, 4], 5)
    finally:
        dev.close()
    assert len(r["tokens"]) == 5
    spans = tr.finished()
    assert {"client.generate", "serving.admit", "serving.prefill_chunk",
            "serving.step"} <= {d["name"] for d in spans}
    (root,) = [d for d in spans if d["name"] == "client.generate"]
    assert all(d["trace_id"] == root["trace_id"] for d in spans
               if d["name"].startswith("serving."))
    assert validate(to_chrome(spans)) == []
    assert j_validate(j_to_chrome(spans)) == []
    admits = [d for d in spans if d["name"] == "serving.admit"]
    assert admits[0]["attrs"]["prompt_tokens"] == 4


def test_generate_unsampled_creates_no_server_spans(model):
    _, tcfg, _, tp = model
    eng = _engine(tp, tcfg, num_blocks=32, max_batch=2)
    with _Worker(RemoteVTPUWorker(engine=eng, device="cpu")) as w:
        tr = Tracer(service="client", sample=0.0)
        dev = _dev(w, tracer=tr)
        try:
            assert len(dev.generate([1, 2, 3], 4)["tokens"]) == 4
        finally:
            dev.close()
        assert tr.finished() == []
        assert w.tracer.finished() == []


# -- metrics, memory, numerics ----------------------------------------------


class ManualClock:
    """The engines' clock, advanced by hand: both stacks see one time."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def now(self):
        return self.t


def _lines(make_engine, runner, lines_fn):
    clock = ManualClock()
    eng = make_engine(runner(num_blocks=64), clock=clock, max_batch=2,
                      name="unit")
    done = []

    def emit(seq, toks, is_done, info):
        if is_done:
            done.append(seq.tenant)
    trace = {"trace_id": "tr-1", "span_id": "", "sampled": True}
    eng.submit([1, 2, 3], 4, tenant="alice", qos="high", emit=emit,
               trace=trace)
    eng.submit([5, 6, 7, 8, 9], 6, tenant="bob", qos="low", emit=emit)
    for _ in range(60):
        if len(done) == 2:
            break
        eng.step()
        clock.t += 0.005
    clock.t += 0.5
    return lines_fn(eng, "node-x", 123456789)


def test_serving_engine_lines_equal_the_reference():
    """Line for line the reference's, for the same FakeRunner schedule
    under one manual clock, and within the reference's METRICS_SCHEMA."""
    got = _lines(ServingEngine, FakeRunner, serving_engine_lines)
    want = _lines(jserving.ServingEngine, jserving.FakeRunner, j_lines)
    assert got == want and len(got) == 3
    for line in got:
        measurement, tags, fields, _ = parse_line(line)
        schema = METRICS_SCHEMA[measurement]
        assert set(tags) == set(schema["tags"])
        assert set(fields) <= set(schema["fields"])
    _, tags, fields, _ = parse_line(got[1])
    assert tags["tenant"] == "alice" and fields["tokens_total"] == 4


class _Meter:
    """The metered client's HBM and launch charges, recorded."""

    def __init__(self):
        self.hbm = 0
        self.launches = 0

    def charge_hbm(self, nbytes):
        self.hbm += nbytes
        return True

    def charge_launch(self, mflops):
        self.launches += 1


def test_kv_pool_charges_resident_hbm_budget(model):
    """The pool's footprint is charged against the resident budget and on
    the meter at start, visible in INFO, released at stop; no compute is
    charged for engine steps; a pool larger than the budget refuses to
    start."""
    _, tcfg, _, tp = model
    runner = LlamaRunner(tp, tcfg, num_blocks=32, block_size=4, device="cpu")
    assert runner.nbytes > 0
    meter = _Meter()
    w = RemoteVTPUWorker(engine=ServingEngine(runner, max_batch=2),
                         meter_client=meter,
                         max_resident_bytes=runner.nbytes + (1 << 20),
                         device="cpu")
    with _Worker(w):
        assert meter.hbm == runner.nbytes
        dev = _dev(w)
        try:
            assert dev.info()["resident_bytes"] == runner.nbytes
            assert len(dev.generate([1, 2, 3], 4)["tokens"]) == 4
        finally:
            dev.close()
    assert w.resident_bytes == 0 and meter.hbm == 0
    assert meter.launches == 0

    small = RemoteVTPUWorker(engine=_engine(tp, tcfg, num_blocks=32),
                             max_resident_bytes=1024, device="cpu")
    with pytest.raises(RuntimeError, match="resident-HBM"):
        small.start()
    small._server.server_close()


def test_worker_refuses_an_engine_on_another_device(model):
    class CudaRunner(FakeRunner):
        device = torch.device("cuda")
    with pytest.raises(ValueError, match="runner is on cuda"):
        RemoteVTPUWorker(engine=ServingEngine(CudaRunner()), device="cpu")


def test_generate_token_parity_q8_vs_raw(serving_worker, model):
    """Token frames carry no float buffers: a q8-negotiated connection
    gives the raw connection's tokens, and generate's."""
    prompt = [3, 1, 4, 1, 5]
    raw = _dev(serving_worker)
    q8 = _dev(serving_worker, quantize=True)
    try:
        want = raw.generate(prompt, 6)["tokens"]
        got = q8.generate(prompt, 6)
        assert q8._wire_version >= 6 and q8.info()["quant_on"]
    finally:
        raw.close()
        q8.close()
    assert got["tokens"] == want == _ref_tokens(model, prompt, 6)


# -- KV_SHIP -------------------------------------------------------------------


def test_kv_ship_over_tcp_token_exact(serving_worker, model):
    """Prefill on a local prefill-tier runner, ship the pages inline,
    decode on the worker: the tokens of a plain GENERATE."""
    _, tcfg, _, tp = model
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]
    dev = _dev(serving_worker)
    try:
        want = dev.generate(prompt, 8)["tokens"]
        payload = _payload(_port_pool(tp, tcfg), prompt, 1)
        out = _ship(dev, prompt, 8, payload)
    finally:
        dev.close()
    assert out["tokens"] == want == _ref_tokens(model, prompt, 8)
    assert out["ship"]["blocks"] == len(payload["keys"])
    snap = serving_worker.engine.snapshot()
    assert snap["kv_ship"]["ships"] == 1
    assert snap["kv_ship"]["bytes"] == payload["bytes"] > 0


def test_kv_ship_large_pages_ride_ephemeral_puts(serving_worker, model,
                                                 monkeypatch):
    """Pages at or above SHARD_PUT_MIN_BYTES go as two quiet ephemeral
    PUTs ahead of the KV_SHIP frame; the worker consumes them at the
    KV_SHIP, so only the pool stays charged."""
    monkeypatch.setattr(client, "SHARD_PUT_MIN_BYTES", 0)
    _, tcfg, _, tp = model
    prompt = [9, 8, 7, 6, 5, 4, 3]
    pool_bytes = serving_worker.engine.runner.nbytes
    dev = _dev(serving_worker)
    try:
        dev.info()
        frames0 = dev.wire_stats["frames"]
        out = _ship(dev, prompt, 5, _payload(_port_pool(tp, tcfg), prompt, 1))
        assert dev.wire_stats["frames"] - frames0 == 3   # PUT, PUT, KV_SHIP
        assert dev.info()["resident_bytes"] == pool_bytes
    finally:
        dev.close()
    assert out["tokens"] == _ref_tokens(model, prompt, 5)
    assert serving_worker._ephemeral == set()
    assert not serving_worker._buffers


def test_kv_ship_requires_protocol_v6(serving_worker):
    """A v5 client refuses to send KV_SHIP, and the worker refuses one
    forged down a v5 connection."""
    import queue as _queue

    dev5 = RemoteDevice(serving_worker.url, timeout_s=TIMEOUT,
                        protocol_version=5)
    try:
        with pytest.raises(RemoteExecutionError, match="protocol v6"):
            dev5.ship_kv([1, 2, 3], 4, [1], None, None, 1, 3)
        q = _queue.Queue()
        dev5._submit("KV_SHIP", {"prompt": [1, 2, 3], "max_tokens": 2,
                                 "keys": [1], "first_token": 1,
                                 "n_tokens": 3}, [], stream=q)
        kind, meta, _ = q.get(timeout=TIMEOUT)
        assert kind == "ERROR" and "protocol >= 6" in meta["error"]
        assert dev5.info()["serving"]["kv_ship"]["ships"] == 0
    finally:
        dev5.close()
    assert protocol.KV_SHIP_MIN_VERSION == 6


def test_kv_ship_dedupes_against_decode_registry(serving_worker, model):
    """Two ships sharing a prompt prefix: the second ingest adopts the
    blocks the first registered instead of writing new pages."""
    _, tcfg, _, tp = model
    sysp = [3, 1, 4, 1, 5, 9, 2, 6]
    pool = _port_pool(tp, tcfg)
    dev = _dev(serving_worker)
    ids = itertools.count(1)

    def ship(prompt, steps):
        return _ship(dev, prompt, steps, _payload(pool, prompt, next(ids)))

    # the long-lived first tenant keeps its blocks registered while the
    # second ships the same system prompt
    first = {}
    t = threading.Thread(target=lambda: first.update(ship(sysp + [7, 3], 24)))
    t.start()
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline and \
            serving_worker.engine.snapshot()["kv_ship"]["ships"] < 1:
        time.sleep(0.01)
    second = ship(sysp + [8, 4], 4)
    t.join(timeout=TIMEOUT)
    dev.close()
    snap = serving_worker.engine.snapshot()
    assert snap["kv_ship"]["ships"] == 2
    assert snap["kv_ship"]["dedup_blocks"] >= 2
    for prompt, out in ((sysp + [7, 3], first), (sysp + [8, 4], second)):
        assert out["tokens"] == _ref_tokens(model, prompt, len(out["tokens"]))


def test_kv_ship_span_recorded(serving_worker, model):
    _, tcfg, _, tp = model
    tracer = Tracer(service="unit-client")
    prompt = [2, 7, 1, 8, 2, 8]
    dev = _dev(serving_worker, tracer=tracer)
    try:
        _ship(dev, prompt, 4, _payload(_port_pool(tp, tcfg), prompt, 1))
    finally:
        dev.close()
    spans = tracer.finished()
    assert "serving.kv_ship" in {s["name"] for s in spans}
    assert validate(to_chrome(spans)) == []


def test_remote_kv_shipper_reuses_a_pooled_link(serving_worker, model):
    """RemoteKVShipper ships two payloads over one leased-and-released
    link, token-exact; a None payload passes through."""
    _, tcfg, _, tp = model
    pool = _port_pool(tp, tcfg)
    shipper = RemoteKVShipper(serving_worker.url)
    try:
        outs = [shipper.ship(p, _payload(pool, p, i), max_tokens=5)
                for i, p in enumerate(([5, 3, 5, 8, 9], [2, 4, 6, 8, 10, 12]))]
        assert shipper.ship([1, 2], None) is None
        snap = shipper.snapshot()
    finally:
        shipper.close()
    assert snap["shipped_jobs"] == 2 and snap["shipped_bytes"] > 0
    assert snap["pool"]["dials"] == 1 and snap["pool"]["hits"] == 1
    for p, out in zip(([5, 3, 5, 8, 9], [2, 4, 6, 8, 10, 12]), outs):
        assert out["tokens"] == _ref_tokens(model, p, 5)


# -- interop ---------------------------------------------------------------------

ROUTES = [("float32", "inline"), ("bfloat16", "put")]


@pytest.mark.parametrize("dtype,route", ROUTES)
def test_port_client_against_reference_worker(models, dtype, route,
                                              monkeypatch):
    """The port's client drives the reference's worker: GENERATE equals
    the reference client's, and a KV_SHIP of the reference prefill tier's
    pages (f32 inline, bf16 as ephemeral PUTs) equals the reference
    client's ship of the same payload (and, in f32, GENERATE)."""
    if route == "put":
        monkeypatch.setattr(client, "SHARD_PUT_MIN_BYTES", 0)
        monkeypatch.setattr(jclient, "SHARD_PUT_MIN_BYTES", 0)
    jcfg, _, jp, _ = models[dtype]
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]
    payload = _payload(jserving.PrefillPool([jserving.LlamaRunner(
        jp, jcfg, num_blocks=64, block_size=4)], inline=True), prompt, 1)
    with _Worker(JWorker(engine=_jengine(jp, jcfg))) as jw:
        dev = _dev(jw)
        jdev = JDevice(jw.url, timeout_s=TIMEOUT)
        try:
            gen = dev.generate(prompt, 6)
            assert gen["tokens"] == jdev.generate(prompt, 6)["tokens"]
            got = _ship(dev, prompt, 6, payload, _to_torch)
            want = _ship(jdev, prompt, 6, payload)
            snap = dev.info()["serving"]["kv_ship"]
        finally:
            dev.close()
            jdev.close()
    assert got["tokens"] == want["tokens"]
    assert got["ship"] == want["ship"]
    assert snap["ships"] == 2 and snap["bytes"] == 2 * payload["bytes"]
    if dtype == "float32":
        assert got["tokens"] == gen["tokens"]


@pytest.mark.parametrize("dtype,route", ROUTES)
def test_reference_client_against_port_worker(models, dtype, route,
                                              monkeypatch):
    """The reference's client drives the port's worker: GENERATE equals
    the port client's, and a KV_SHIP of the port prefill tier's pages
    (f32 inline, bf16 as ephemeral PUTs) equals the port client's ship of
    the same payload (and, in f32, GENERATE and ``generate``)."""
    if route == "put":
        monkeypatch.setattr(client, "SHARD_PUT_MIN_BYTES", 0)
        monkeypatch.setattr(jclient, "SHARD_PUT_MIN_BYTES", 0)
    _, tcfg, _, tp = models[dtype]
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]
    payload = _payload(_port_pool(tp, tcfg), prompt, 1)
    w = RemoteVTPUWorker(engine=_engine(tp, tcfg), device="cpu")
    with _Worker(w):
        dev = _dev(w)
        jdev = JDevice(w.url, timeout_s=TIMEOUT)
        try:
            gen = jdev.generate(prompt, 6)
            assert gen["tokens"] == dev.generate(prompt, 6)["tokens"]
            got = _ship(jdev, prompt, 6, payload, _to_numpy)
            want = _ship(dev, prompt, 6, payload)
            # the page uploads were consumed; only the pool stays charged
            assert not w._buffers
            assert w.resident_bytes == w.engine.runner.nbytes
        finally:
            dev.close()
            jdev.close()
    assert got["tokens"] == want["tokens"]
    assert got["ship"] == want["ship"]
    if dtype == "float32":
        assert got["tokens"] == gen["tokens"] == \
            _ref_tokens(models[dtype], prompt, 6)


# -- peer links and ephemeral buffers ------------------------------------------


def test_peer_link_pool_lease_release_sweep_and_redial(model):
    """Lease dials, release parks, a lease within the fresh window is a
    hit without a round trip, a later one re-verifies the worker_uid; a
    worker restarted on the same port is noticed and re-dialed one
    generation on; links idle past the TTL are swept."""
    clock = ManualClock()
    pool = PeerLinkPool(clock=clock)
    w = RemoteVTPUWorker(device="cpu")
    port = w.port
    try:
        with _Worker(w):
            link = pool.lease(w.url)
            assert link.device.info()["worker_uid"] == w.worker_uid
            pool.release(link)
            assert link.worker_uid == w.worker_uid
            again = pool.lease(w.url)               # fresh: no round trip
            assert again is link
            pool.release(again)
            clock.t += 5.0                          # stale: verified
            again = pool.lease(w.url)
            assert again is link and again.generation == 0
            pool.release(again)
        # the restart ends the TCP session the pooled link holds
        link.device._sock.shutdown(socket.SHUT_RDWR)
        w2 = RemoteVTPUWorker(port=port, device="cpu")
        with _Worker(w2):
            clock.t += 5.0
            fresh = pool.lease(w2.url)
            assert fresh is not link and fresh.generation == 1
            assert fresh.device.info()["worker_uid"] == w2.worker_uid
            pool.release(fresh)
            other = pool.lease(w2.url, token="o")       # another key: dial
            pool.release(other)
            clock.t += 61.0
            extra = pool.lease(w2.url, token="t")       # sweeps the two
            pool.release(extra)
            snap = pool.snapshot()
    finally:
        pool.close()
    assert snap == {"leases": 6, "hits": 2, "dials": 3, "redials": 1,
                    "expired": 2, "idle_links": 1}


def test_ephemeral_put_is_consumed_by_its_first_use(serving_worker):
    """An ephemeral PUT leaves the table and releases its resident bytes
    when taken (``_take_shard``); a plain PUT stays; FREE of an
    ephemeral one forgets it."""
    pool_bytes = serving_worker.engine.runner.nbytes
    dev = _dev(serving_worker)
    try:
        x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        for name, extra in (("c-e1", {"ephemeral": True}), ("c-p1", {}),
                            ("c-e2", {"ephemeral": True})):
            dev._submit("PUT", {"buf_id": name, "quiet": True, **extra}, [x],
                        want_reply=False)
        info = dev.info()
        assert info["resident_bytes"] == pool_bytes + 3 * x.nbytes
        ns = next(iter(serving_worker._buffers)).split(":")[0] + ":"
        assert serving_worker._ephemeral == {ns + "c-e1", ns + "c-e2"}
        got = serving_worker._take_shard(ns + "c-e1")
        torch.testing.assert_close(got, x)
        with pytest.raises(KeyError):
            serving_worker._take_shard(ns + "c-e1")
        torch.testing.assert_close(serving_worker._take_shard(ns + "c-p1"), x)
        dev._rpc("FREE", {"buf_ids": ["c-e2"]}, [])
        assert serving_worker._ephemeral == set()
        assert dev.info()["resident_bytes"] == pool_bytes + x.nbytes
        assert set(serving_worker._buffers) == {ns + "c-p1"}
    finally:
        dev.close()


def test_kv_ship_receipt_after_the_final_frame_is_kept():
    """The worker sends KV_SHIP_OK once the engine holds the pages, and
    the engine may finish a short generation first: a receipt that
    follows the final frame still lands in the result."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    seen = []

    def serve():
        conn, _ = srv.accept()
        with conn:
            protocol.recv_message(conn)                       # HELLO
            protocol.send_message(conn, "HELLO_OK",
                                  {"version": 6, "worker_uid": "w-x"}, [])
            while True:
                kind, meta, _ = protocol.recv_message(conn, accept=(6,))
                seen.append(kind)
                if kind != "INFO":
                    break
                protocol.send_message(conn, "INFO_OK", {"seq": meta["seq"]},
                                      [], version=6)
            for reply, rmeta in (
                    ("GENERATE_OK", {"tokens": [7], "done": True,
                                     "n_tokens": 1, "ttft_ms": 1.0,
                                     "finish_reason": "length"}),
                    ("KV_SHIP_OK", {"blocks": 2, "n_tokens": 5})):
                protocol.send_message(conn, reply, dict(rmeta, seq=meta["seq"]),
                                      [], version=6)
            conn.recv(1)                                      # until close

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    dev = RemoteDevice(f"tcp://127.0.0.1:{srv.getsockname()[1]}",
                       timeout_s=TIMEOUT)
    try:
        out = dev.ship_kv([1, 2, 3, 4, 5], 1, [11, 12], None, None,
                          first_token=7, n_tokens=5)
    finally:
        dev.close()
        t.join(TIMEOUT)
        srv.close()
    assert seen == ["INFO", "KV_SHIP"]
    assert out["tokens"] == [7] and out["ship"] == {"blocks": 2, "n_tokens": 5}
    assert dev._streams == {}


def test_failed_engine_start_releases_the_pool_charge(model):
    """An engine that fails to start leaves nothing charged: the pool's
    bytes go back to the resident budget and the meter."""
    _, tcfg, _, tp = model
    engine = _engine(tp, tcfg, num_blocks=32)

    def broken_start():
        raise RuntimeError("engine start failed")

    engine.start = broken_start
    meter = _Meter()
    w = RemoteVTPUWorker(engine=engine, meter_client=meter, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="engine start failed"):
            w.start()
    finally:
        w._server.server_close()
    assert w.resident_bytes == 0 and meter.hbm == 0
    assert w._engine_pool_bytes == 0


def test_profile_lines_equal_the_reference(serving_worker):
    """The worker's attribution after serving, as ``tpf_prof_*`` lines:
    the port's ``profile_lines`` equal the reference's for the same
    snapshot, and the reference's artifact check accepts them."""
    from tensorfusion_tpu.profiling.export import profile_lines as j_profile_lines
    from tensorfusion_tpu.profiling.export import validate_profile
    from tensorfusion_tpu_torch.profiling import profile_lines

    dev = _dev(serving_worker, qos="high")
    try:
        dev.generate([1, 2, 3, 4], 4)
        snap = dev.info()["profile"]
    finally:
        dev.close()
    lines = profile_lines(snap, "node-x", 123)
    assert lines == j_profile_lines(snap, "node-x", 123) and len(lines) >= 2
    assert validate_profile({"snapshots": [snap], "lines": lines}) == []
