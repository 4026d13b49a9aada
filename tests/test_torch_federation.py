"""Federated meshes of the port's workers (protocol v7), on the CPU.

First the fault this part repairs: a reference ``FederatedDevice`` over
port workers, which negotiate v9, used to get ``unknown kind`` for every
collective instead of the reference workers' service.  Then ports of the
reference's federation tests (tests/test_federation.py, each named in its
docstring) onto port workers, and the port's ``federated_jit`` (concat,
sum, first), ``all_reduce`` and ``all_gather`` held to the reference's
``FederatedDevice`` over reference workers on the same numpy inputs.
Workers run with ``device="cpu"`` on port 0.
"""

import socket

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensorfusion_tpu.remoting import FederatedDevice as JFederatedDevice  # noqa: E402
from tensorfusion_tpu.remoting import RemoteVTPUWorker as JWorker  # noqa: E402
from tensorfusion_tpu_torch.remoting import (FederatedDevice,  # noqa: E402
                                             RemoteDevice,
                                             RemoteExecutionError,
                                             RemoteVTPUWorker, protocol)
from test_torch_fabric import FrameTap  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 30
#: f32 tolerance of the reference's tests for split-and-sum paths
F32 = dict(rtol=1e-5, atol=1e-5)

FED_KINDS = ("ALLREDUCE_SHIP", "ALLGATHER_SHIP", "ALLREDUCE_SHIP_OK",
             "ALLGATHER_SHIP_OK")


def _workers(n, **kw):
    ws = [RemoteVTPUWorker(device="cpu", **kw) for _ in range(n)]
    for w in ws:
        w.start()
    return ws


def _stop(ws):
    for w in ws:
        w.stop()


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


@pytest.fixture()
def jworkers2():
    ws = [JWorker(), JWorker()]
    for w in ws:
        w.start()
    yield ws
    for w in ws:
        w.stop()


def _fed(urls, **kw):
    return FederatedDevice(urls, timeout_s=TIMEOUT, **kw)


def _grad_fn(w, x):
    return x.transpose(0, 1) @ torch.tanh(x @ w)


def _jgrad_fn(w, x):
    return x.T @ jnp.tanh(x @ w)


def _arrays():
    rng = np.random.default_rng(30)
    return {"float32": [rng.standard_normal((64, 40)).astype(np.float32)
                        for _ in range(2)],
            "bfloat16": [(rng.standard_normal((64, 40)) * 3)
                         .astype(ml_dtypes.bfloat16) for _ in range(2)],
            "int32": [rng.integers(-999, 999, (64, 40)).astype(np.int32)
                      for _ in range(2)]}


# -- the fault first ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_reference_federation_over_port_workers(workers2, jworkers2, dtype):
    """A reference FederatedDevice over two port workers (which negotiate
    v9, so it decides the federation is live) runs all_reduce and
    all_gather over PUT buffers and gets the same arrays, byte for byte,
    as over two reference workers."""
    parts = _arrays()[dtype]

    def run(ws):
        fed = JFederatedDevice([w.url for w in ws])
        assert fed.fed_supported()
        handles = [dev.put(p) for dev, p in zip(fed.workers, parts)]
        red = np.asarray(fed.all_reduce(handles, free_src=True)["value"])
        handles = [dev.put(p) for dev, p in zip(fed.workers, parts)]
        gat = np.asarray(fed.all_gather(handles, axis=1, free_src=True))
        fed.close()
        return red, gat

    red, gat = run(workers2)
    jred, jgat = run(jworkers2)
    for got, want in ((red, jred), (gat, jgat)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    assert all(w.resident_bytes == 0 for w in workers2)


# -- ports of tests/test_federation.py -----------------------------------------


def test_federated_concat_bit_exact_vs_single_worker(workers2):
    """Port of test_federation.py::
    test_federated_concat_bit_exact_vs_single_worker (uneven split)."""
    fed = _fed([w.url for w in workers2])
    single = RemoteDevice(workers2[0].url, timeout_s=TIMEOUT)

    def fn(x):
        return torch.tanh(x * 1.01)

    x = np.random.default_rng(3).standard_normal((17, 32)).astype(np.float32)
    got = fed.federated_jit(fn, in_axes=0)(x)
    assert torch.equal(got, single.remote_jit(fn)(x))
    assert fed.fed_supported()
    fed.close()
    single.close()


def test_federated_sum_and_first_modes(workers2, jworkers2):
    """Port of test_federation.py::test_federated_sum_and_first_modes, and
    both modes held to the reference's FederatedDevice over reference
    workers on the same numpy inputs (f32, rtol / atol 1e-5)."""
    rng = np.random.default_rng(4)
    W = rng.standard_normal((16, 16)).astype(np.float32)
    x = rng.standard_normal((12, 16)).astype(np.float32)
    fed = _fed([w.url for w in workers2])
    got = fed.federated_jit(_grad_fn, in_axes=(None, 0), out_modes="sum")(W, x)
    rep = fed.federated_jit(lambda w: w * 2.0, in_axes=None,
                            out_modes="first")(W)
    fed.close()
    local = _grad_fn(torch.from_numpy(W), torch.from_numpy(x))
    torch.testing.assert_close(got, local, **F32)
    np.testing.assert_array_equal(rep.numpy(), W * 2.0)

    jfed = JFederatedDevice([w.url for w in jworkers2])
    jgot = np.asarray(jfed.federated_jit(jax.jit(_jgrad_fn), in_axes=(None, 0),
                                         out_modes="sum")(W, x))
    jrep = np.asarray(jfed.federated_jit(jax.jit(lambda w: w * 2.0),
                                         in_axes=None, out_modes="first")(W))
    jfed.close()
    np.testing.assert_allclose(got.numpy(), jgot, **F32)
    np.testing.assert_array_equal(rep.numpy(), jrep)


def test_federated_concat_matches_the_reference(workers3, jworkers2):
    """concat over three port workers equals the reference's
    FederatedDevice over two reference workers on the same input
    (elementwise rows: the split moves no bit; f32 rtol / atol 1e-6
    between the two packages' tanh)."""
    x = np.random.default_rng(31).standard_normal((19, 24)).astype(np.float32)
    fed = _fed([w.url for w in workers3])
    got = fed.federated_jit(lambda a: torch.tanh(a) * 2.0 + 1.0)(x)
    fed.close()
    jfed = JFederatedDevice([w.url for w in jworkers2])
    want = np.asarray(jfed.federated_jit(
        jax.jit(lambda a: jnp.tanh(a) * 2.0 + 1.0))(x))
    jfed.close()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_resident_step_allreduce_install_and_free(workers2):
    """Port of test_federation.py::
    test_resident_step_allreduce_install_and_free."""
    fed = _fed([w.url for w in workers2])
    rng = np.random.default_rng(5)
    W = rng.standard_normal((16, 16)).astype(np.float32)
    x = rng.standard_normal((10, 16)).astype(np.float32)
    ffn = fed.federated_jit(_grad_fn, in_axes=(None, 0), out_modes="sum")
    wh = ffn.upload_arg(0, W, W, x)
    step = ffn.step_resident(wh, x)
    out = fed.all_reduce(step.handles, free_src=True, overlap_with=step,
                         install=True)
    want = _grad_fn(torch.from_numpy(W), torch.from_numpy(x))
    torch.testing.assert_close(out["value"], want, **F32)
    assert out["handles"] is not None and len(out["handles"]) == 2
    for h in out["handles"]:
        assert torch.equal(h.fetch(), out["value"])
    with pytest.raises(RemoteExecutionError):
        step.handles[0].fetch()
    for h in out["handles"]:
        h.free()
    snap = fed.fed_snapshot()
    assert snap["allreduce_total"] == 1 and snap["collective_raw_bytes"] > 0
    fed.close()


def test_ring_reduce_three_workers(workers3):
    """Port of test_federation.py::test_ring_reduce_three_workers: ring=True
    over v9 members takes the fabric ring (rtol / atol 1e-4)."""
    fed = _fed([w.url for w in workers3], ring=True)
    assert fed.n_workers == 3 and fed.fabric_supported()
    rng = np.random.default_rng(6)
    W = rng.standard_normal((8, 8)).astype(np.float32)
    x = rng.standard_normal((9, 8)).astype(np.float32)
    ffn = fed.federated_jit(_grad_fn, in_axes=(None, 0), out_modes="sum")
    wh = ffn.upload_arg(0, W, W, x)
    step = ffn.step_resident(wh, x)
    out = fed.all_reduce(step.handles, free_src=True)
    torch.testing.assert_close(
        out["value"], _grad_fn(torch.from_numpy(W), torch.from_numpy(x)),
        rtol=1e-4, atol=1e-4)
    snap = fed.fed_snapshot()
    assert snap["fabric_rings_total"] == 1 and snap["client_relay_bytes"] == 0
    fed.close()


def test_all_gather_concatenates_in_mesh_order(workers2):
    """Port of test_federation.py::test_all_gather_concatenates_in_mesh_order."""
    fed = _fed([w.url for w in workers2])
    parts = [np.full((2, 3), i, np.float32) for i in range(2)]
    handles = [dev.put(p) for dev, p in zip(fed.workers, parts)]
    got = fed.all_gather(handles, axis=0, free_src=True)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(parts, axis=0))
    with pytest.raises(RemoteExecutionError):
        handles[0].fetch()
    assert fed.fed_snapshot()["allgather_total"] == 1
    fed.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_collectives_match_the_reference_federation(workers2, jworkers2,
                                                    dtype):
    """The port's all_reduce (flat) and all_gather over port workers equal
    the reference's over reference workers on the same partials, byte
    for byte (bf16 summed in f32 and rounded once, integers exact)."""
    parts = _arrays()[dtype]
    fed = _fed([w.url for w in workers2])
    to_port = (lambda p: torch.from_numpy(p.view(np.uint16))
               .view(torch.bfloat16)) if dtype == "bfloat16" else (lambda p: p)
    handles = [dev.put(to_port(p)) for dev, p in zip(fed.workers, parts)]
    red = fed.all_reduce(handles, free_src=True)["value"]
    handles = [dev.put(to_port(p)) for dev, p in zip(fed.workers, parts)]
    gat = fed.all_gather(handles, axis=0, free_src=True)
    fed.close()
    jfed = JFederatedDevice([w.url for w in jworkers2])
    jh = [dev.put(p) for dev, p in zip(jfed.workers, parts)]
    jred = np.asarray(jfed.all_reduce(jh, free_src=True)["value"])
    jh = [dev.put(p) for dev, p in zip(jfed.workers, parts)]
    jgat = np.asarray(jfed.all_gather(jh, axis=0, free_src=True))
    jfed.close()
    for got, want in ((red, jred), (gat, jgat)):
        raw = got.view(torch.uint16).numpy() if got.dtype == torch.bfloat16 \
            else got.numpy()
        assert tuple(got.shape) == want.shape
        assert raw.tobytes() == want.tobytes()


def test_allreduce_int_data_exact_path(workers2):
    """Port of test_federation.py::test_allreduce_int_data_exact_path."""
    fed = _fed([w.url for w in workers2], quantize=True)
    rng = np.random.default_rng(7)
    parts = [rng.integers(-1000, 1000, (64, 64)).astype(np.int32)
             for _ in range(2)]
    handles = [dev.put(p) for dev, p in zip(fed.workers, parts)]
    out = fed.all_reduce(handles, free_src=True)
    np.testing.assert_array_equal(out["value"].numpy(), parts[0] + parts[1])
    fed.close()


@pytest.mark.parametrize("dtype,shape", [("float32", (300, 41)),
                                         ("float16", (4097,)),
                                         ("bfloat16", (123, 35))])
def test_q8_collective_roundtrip_error_bounded_per_hop(dtype, shape):
    """Port of test_federation.py::
    test_q8_collective_roundtrip_error_bounded_per_hop, through the port's
    q8 codec: R hops stay within R * (s_max / 2 + the dtype's rounding)."""
    tdtype = protocol.TORCH_DTYPES[dtype]
    rng = np.random.default_rng(8)
    x = (torch.from_numpy(rng.standard_normal(shape) * 3.0)
         .to(torch.float32).to(tdtype))
    hops = 3
    cur = x.float()
    worst_scale = 0.0
    for _ in range(hops):
        arr = cur.to(tdtype)
        wire = protocol.q8_encode(arr)
        desc = {"shape": list(arr.shape), "dtype": dtype,
                "nbytes": len(wire), "raw_nbytes": arr.numel() *
                arr.element_size(), "enc": "q8",
                "q8_block": protocol.Q8_BLOCK}
        out = protocol.q8_decode(bytes(wire), desc)
        worst_scale = max(worst_scale, float(cur.abs().max()) / 127.0)
        cur = out.float()
    err = float((cur - x.float()).abs().max())
    half_eps = {"float32": 0.0, "float16": 2e-3, "bfloat16": 1.6e-2}[dtype]
    bound = hops * (worst_scale / 2 + half_eps *
                    max(float(x.float().abs().max()), 1.0)) * 1.2
    assert err <= bound, (err, bound)


def test_q8_federated_forward_bounded_and_fewer_wire_bytes(workers2):
    """Port of test_federation.py::
    test_q8_federated_forward_bounded_and_fewer_wire_bytes."""
    rng = np.random.default_rng(9)
    W = rng.standard_normal((256, 256)).astype(np.float32) * 0.05
    x = rng.standard_normal((512, 256)).astype(np.float32)
    results = {}
    for mode, quant in (("raw", False), ("q8", True)):
        fed = _fed([w.url for w in workers2], quantize=quant)
        ffn = fed.federated_jit(_grad_fn, in_axes=(None, 0), out_modes="sum")
        wh = ffn.upload_arg(0, W, W, x)
        step = ffn.step_resident(wh, x)
        results[mode] = fed.all_reduce(step.handles, free_src=True,
                                       overlap_with=step)
        fed.close()
    raw_v = results["raw"]["value"].numpy()
    q8_v = results["q8"]["value"].numpy()
    s = max(float(np.abs(raw_v).max()), 1e-9) / 127.0
    assert np.abs(q8_v - raw_v).max() <= 2 * s * 1.5
    assert results["raw"]["wire_bytes"] >= 2 * results["q8"]["wire_bytes"]
    assert results["q8"]["raw_bytes"] >= 2 * results["q8"]["wire_bytes"]


@pytest.mark.parametrize("old_version", [2, 3, 4, 5, 6])
def test_fed_falls_back_on_old_workers_zero_new_frames(old_version):
    """Port of test_federation.py::
    test_fed_falls_back_on_old_workers_zero_new_frames."""
    ws = _workers(2, protocol_version=old_version)
    taps = [FrameTap(w.port) for w in ws]
    try:
        fed = _fed([t.url for t in taps])
        assert not fed.fed_supported()

        def fn(x):
            return x * 2.0 + 1.0

        x = np.random.default_rng(10).standard_normal((8, 8)).astype(
            np.float32)
        got = fed.federated_jit(fn, in_axes=0)(x)
        np.testing.assert_allclose(got.numpy(), x * 2.0 + 1.0, rtol=1e-6)
        ffn = fed.federated_jit(fn, in_axes=0, out_modes="sum")
        if old_version >= 3:
            step = ffn.step_resident(x)
            out = fed.all_reduce(step.handles, free_src=True)
            np.testing.assert_allclose(out["value"].numpy(), x * 2.0 + 1.0,
                                       rtol=1e-6)
        snap = fed.fed_snapshot()
        assert snap["fallback_calls_total"] >= 1
        assert snap["allreduce_total"] == 0
        fed.close()
        seen = set(taps[0].kinds_up + taps[0].kinds_down
                   + taps[1].kinds_up + taps[1].kinds_down)
        assert not (seen & set(FED_KINDS)), seen
        assert "EXECUTE" not in taps[1].kinds_up
    finally:
        for t in taps:
            t.close()
        _stop(ws)


def test_fed_v7_opcodes_actually_on_wire(workers2):
    """Port of test_federation.py::test_fed_v7_opcodes_actually_on_wire."""
    taps = [FrameTap(w.port) for w in workers2]
    try:
        fed = _fed([t.url for t in taps])
        parts = [np.ones((8, 8), np.float32) * (i + 1) for i in range(2)]
        handles = [dev.put(p) for dev, p in zip(fed.workers, parts)]
        out = fed.all_reduce(handles, free_src=True)
        np.testing.assert_array_equal(out["value"].numpy(),
                                      parts[0] + parts[1])
        fed.close()
        for tap in taps:
            assert "ALLREDUCE_SHIP" in tap.kinds_up
            assert "ALLREDUCE_SHIP_OK" in tap.kinds_down
    finally:
        for t in taps:
            t.close()


def test_client_gate_pinned_v6_client_refuses(workers2):
    """Port of test_federation.py::test_client_gate_pinned_v6_client_refuses."""
    dev = RemoteDevice(workers2[0].url, protocol_version=6,
                       timeout_s=TIMEOUT)
    ref = dev.put(np.ones((4, 4), np.float32))
    with pytest.raises(RemoteExecutionError, match="protocol v7"):
        dev.allreduce_ship([ref.buf_id])
    with pytest.raises(RemoteExecutionError, match="protocol v7"):
        dev.allgather_ship([ref.buf_id])
    ref.free()
    dev.close()


def test_worker_gate_rejects_smuggled_frame_below_v7(workers2):
    """Port of test_federation.py::
    test_worker_gate_rejects_smuggled_frame_below_v7."""
    s = socket.create_connection(("127.0.0.1", workers2[0].port))
    try:
        protocol.send_message(s, "HELLO", {"max_version": 6, "seq": 1}, [],
                              version=protocol.HELLO_VERSION)
        kind, meta, _ = protocol.recv_message(s)
        assert kind == "HELLO_OK" and meta["version"] == 6
        for k in ("ALLREDUCE_SHIP", "ALLGATHER_SHIP"):
            protocol.send_message(s, k, {"buf_ids": [], "seq": 2}, [],
                                  version=6)
            kind, meta, _ = protocol.recv_message(s)
            assert kind == "ERROR" and "protocol >= 7" in meta["error"]
    finally:
        s.close()


def test_collective_bytes_attributed_to_owning_tenant(workers2):
    """Port of test_federation.py::
    test_collective_bytes_attributed_to_owning_tenant."""
    dev = RemoteDevice(workers2[0].url, timeout_s=TIMEOUT)
    part = np.ones((128, 128), np.float32)
    ref = dev.put(part)
    rmeta, total = dev.allreduce_ship([ref.buf_id], free_src=True)
    np.testing.assert_array_equal(total.numpy(), part)
    d = dev.info()["dispatch"]
    assert d["collective_ops"] == 1 and d["collective_bytes"] == part.nbytes
    assert any(t["collective_ops"] == 1 and
               t["collective_bytes"] == part.nbytes
               for t in d["tenants"].values())
    dev.close()


def test_fed_metrics_lines_conform_to_schema(workers2):
    """Port of test_federation.py::test_fed_metrics_lines_conform_to_schema:
    the port's line conforms to the reference's schema and equals the
    reference's encoding of the same ledger."""
    from tensorfusion_tpu.hypervisor.metrics import \
        federation_lines as jfederation_lines
    from tensorfusion_tpu.metrics.schema import METRICS_SCHEMA
    from tensorfusion_tpu_torch.hypervisor.metrics import federation_lines

    fed = _fed([w.url for w in workers2])
    handles = [dev.put(np.ones((4, 4), np.float32)) for dev in fed.workers]
    fed.all_reduce(handles, free_src=True)
    snap = fed.fed_snapshot()
    lines = federation_lines(fed, "n1", 123, snap=snap)
    assert lines == jfederation_lines(fed, "n1", 123, snap=snap)
    assert len(lines) == 1 and lines[0].startswith("tpf_fed_collective,")
    schema = METRICS_SCHEMA["tpf_fed_collective"]
    head, fields, _ = lines[0].split(" ")
    assert set(dict(kv.split("=") for kv in head.split(",")[1:])) == \
        set(schema["tags"])
    keys = {kv.split("=")[0] for kv in fields.split(",")}
    assert keys <= set(schema["fields"]) and "allreduce_total" in keys
    fed.close()


def test_fed_spans_recorded_and_overlap_ledger_fed(workers2):
    """Port of test_federation.py::test_fed_spans_recorded_and_overlap_ledger_fed."""
    from tensorfusion_tpu_torch.profiling.profiler import Profiler
    from tensorfusion_tpu_torch.tracing.core import Tracer

    tracer = Tracer(service="fed-test", sample=1.0)
    prof = Profiler(name="fed-test")
    fed = _fed([w.url for w in workers2], tracer=tracer, profiler=prof,
               tenant="fedA")
    ffn = fed.federated_jit(lambda x: x + 1.0, in_axes=0, out_modes="sum")
    step = ffn.step_resident(np.ones((8, 4), np.float32))
    fed.all_reduce(step.handles, free_src=True, overlap_with=step)
    names = {s["name"] for s in tracer.finished()}
    assert "fed.collective" in names and "fed.shard_exec" in names
    t = prof.snapshot()["tenants"].get("fedA")
    assert t is not None and t["transfer_s"] > 0
    fed.close()


def test_federated_jit_exports_once_per_signature(workers3, monkeypatch):
    """Every member runs one export of a signature (the archive is the
    same bytes), COMPILEd on each; a second signature exports once more,
    and the wrapper ``.on`` gives for another connection reuses them."""
    from tensorfusion_tpu_torch.remoting import program

    calls = []
    real = program.export_program
    monkeypatch.setattr(program, "export_program",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fed = _fed([w.url for w in workers3])

    def fn(x):
        return x * 2.0

    ffn = fed.federated_jit(fn)
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    np.testing.assert_array_equal(ffn(x).numpy(), x * 2.0)
    assert len(calls) == 1
    assert all(w.executions == 1 for w in workers3)
    np.testing.assert_array_equal(ffn(x[:3]).numpy(), x[:3] * 2.0)
    assert len(calls) == 2
    other = RemoteDevice(workers3[0].url, timeout_s=TIMEOUT)
    got = ffn.on(other)(x[:2])
    np.testing.assert_array_equal(got.numpy(), x[:2] * 2.0)
    assert len(calls) == 2
    other.close()
    fed.close()
