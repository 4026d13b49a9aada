"""The port's remote worker and client over loopback, on the CPU.

Mirrors of the reference's single-device tests (tests/test_remoting.py),
interop of each package's client with the other package's worker, the
parity of a remote tiny Llama forward (the flash op, its plain version
on the CPU) with the port's local forward and the reference's remote
one, and the worker's refusals: later-part kinds, and programs that ask
to unpickle or to call an operator a tenant may not.  Every worker runs
with ``device="cpu"`` on port 0 and stops in a ``finally``; every client
waits at most ``TIMEOUT`` seconds for a reply.
"""

import io
import json
import os
import pickle
import socket
import struct
import time
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensorfusion_tpu_torch import bench_train  # noqa: E402
from tensorfusion_tpu_torch.models import llama as tl  # noqa: E402
from tensorfusion_tpu_torch.remoting import (RemoteBuffer,  # noqa: E402
                                             RemoteDevice,
                                             RemoteExecutionError,
                                             RemoteVTPUWorker, program,
                                             protocol)

torch.set_num_threads(1)
TIMEOUT = 30
F32 = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture()
def worker():
    w = RemoteVTPUWorker(device="cpu")
    w.start()
    try:
        yield w
    finally:
        w.stop()


def _dev(worker_or_url, **kw) -> RemoteDevice:
    url = getattr(worker_or_url, "url", worker_or_url)
    return RemoteDevice(url, timeout_s=TIMEOUT, **kw)


def _randn(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_worker_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RemoteVTPUWorker()


def test_info_over_loopback(worker):
    dev = _dev(worker)
    try:
        info = dev.info()
        assert info["platform"] == "cpu" and info["n_devices"] == 1
        assert info["protocol_version"] == protocol.VERSION
        assert dev._wire_version == protocol.VERSION
        assert [d["id"] for d in info["devices"]] == [0]
        assert info["dispatch"]["mode"] == "wfq"
    finally:
        dev.close()


def test_remote_jit_matches_local(worker):
    dev, dev2 = _dev(worker), _dev(worker)
    try:
        def fn(a, b):
            return torch.tanh(a @ b) + 1.0

        remote = dev.remote_jit(fn)
        a, b = _randn(64, 64, seed=0), _randn(64, 64, seed=1)
        got = remote(a, b)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        torch.testing.assert_close(got, fn(a, b), rtol=1e-5, atol=1e-5)
        assert worker.executions == 1
        remote(a, b)                      # same shapes: no recompile
        assert worker.executions == 2
        remote(torch.ones(32, 64), b)     # a second executable
        assert dev2.info()["cached_executables"] == 2
        # numpy arguments are the same signature as tensors
        torch.testing.assert_close(remote(a.numpy(), b.numpy()), fn(a, b),
                                   rtol=1e-5, atol=1e-5)
        assert dev2.info()["cached_executables"] == 2
    finally:
        dev.close()
        dev2.close()


def test_remote_pytree_outputs(worker):
    dev = _dev(worker)
    try:
        remote = dev.remote_jit(lambda x: {"double": x * 2,
                                           "stats": (x.sum(), x.max())})
        x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        out = remote(x)
        torch.testing.assert_close(out["double"], x * 2)
        assert out["stats"][0].item() == x.sum().item()
        assert out["stats"][1].item() == 11.0
    finally:
        dev.close()


def test_remote_jit_of_a_module_with_weights(worker):
    """An nn.Module's parameters ride the archive as raw tensors."""
    dev = _dev(worker)
    try:
        torch.manual_seed(0)
        mod = torch.nn.Sequential(torch.nn.Linear(16, 8), torch.nn.Tanh())
        x = _randn(4, 16, seed=2)
        with torch.no_grad():
            want = mod(x)
        torch.testing.assert_close(dev.remote_jit(mod)(x), want,
                                   rtol=1e-5, atol=1e-6)
    finally:
        dev.close()


def test_remote_unknown_executable_needs_compile(worker):
    dev = _dev(worker)
    try:
        with pytest.raises(RemoteExecutionError, match="unknown executable"):
            dev._rpc("EXECUTE", {"exe_id": "deadbeef"}, [])
        kind, meta, _ = dev._submit("EXECUTE", {"exe_id": "deadbeef"},
                                    []).result(TIMEOUT)
        assert kind == "ERROR" and meta["code"] == "needs_compile"
    finally:
        dev.close()


def test_remote_auth_token_required():
    w = RemoteVTPUWorker(token="s3cret", device="cpu")
    w.start()
    try:
        bad = _dev(w, token="wrong")
        with pytest.raises(RemoteExecutionError, match="bad token"):
            bad.info()
        bad.close()
        good = _dev(w, token="s3cret")
        assert good.info()["platform"] == "cpu"
        good.close()
        # a non-HELLO first frame is refused before anything is read
        s = socket.create_connection(("127.0.0.1", w.port), timeout=TIMEOUT)
        protocol.send_message(s, "INFO", {"seq": 1}, [])
        kind, meta, _ = protocol.recv_message(s)
        assert kind == "ERROR" and "authentication" in meta["error"]
        s.close()
        # an oversized header is dropped without a reply
        s = socket.create_connection(("127.0.0.1", w.port), timeout=TIMEOUT)
        s.sendall(protocol.MAGIC + struct.pack(
            "<II", protocol.VERSION, protocol.MAX_HEADER_BYTES + 1))
        try:
            assert s.recv(1) == b""
        except ConnectionResetError:
            pass
        s.close()
    finally:
        w.stop()


def test_close_fails_pending_futures(worker):
    import concurrent.futures

    dev = _dev(worker)
    assert dev.info()["platform"] == "cpu"
    futs = [dev._submit("INFO", {}, []) for _ in range(4)]
    dev.close()
    t0 = time.monotonic()
    failures = 0
    for f in futs:
        try:
            f.result(timeout=5)
        except (ConnectionError, concurrent.futures.CancelledError):
            failures += 1
        except Exception:
            pass   # a response that raced the close is fine too
    assert time.monotonic() - t0 < 5
    assert failures >= 1 or all(f.done() for f in futs)


def test_remote_pipelined_submit(worker):
    dev = _dev(worker)
    try:
        remote = dev.remote_jit(lambda x: x * 2.0)
        remote(torch.ones(8))
        futures = [remote.submit(torch.full((8,), float(i)))
                   for i in range(16)]
        for i, fut in enumerate(futures):
            torch.testing.assert_close(fut.result(timeout=TIMEOUT),
                                       torch.full((8,), 2.0 * i))
        assert worker.executions == 17
    finally:
        dev.close()


def test_remote_resident_hbm_budget(worker):
    worker.max_resident_bytes = 3000
    dev = _dev(worker)
    try:
        ref = dev.put(torch.zeros(500))                 # 2000 bytes
        with pytest.raises(RemoteExecutionError, match="budget exceeded"):
            dev.put(torch.zeros(500))                   # 4000 > 3000
        assert dev.info()["resident_bytes"] == 2000
        ref.free()
        assert dev.info()["resident_bytes"] == 0
        dev.put(torch.zeros(500))                       # fits again
    finally:
        dev.close()


def test_remote_resident_buffers_and_step_resident(worker):
    """Weights uploaded once; per-call traffic is the activations; a
    step_resident chain streams without round trips and frees as it
    goes."""
    dev = _dev(worker)
    try:
        w = _randn(64, 64, seed=3) * 0.1
        w_ref = dev.put(w)
        step = dev.remote_jit(lambda w, x: torch.tanh(x @ w))
        x = torch.ones(8, 64)
        torch.testing.assert_close(step(w_ref, x), torch.tanh(x @ w),
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(w_ref.fetch(), w)
        w_up = step.upload_arg(0, w)          # the signature is known
        torch.testing.assert_close(step(w_up, x), torch.tanh(x @ w),
                                   rtol=1e-5, atol=1e-5)
        w_up.free()
        state, want = dev.put(x), x
        for _ in range(8):
            state = step.step_resident(w_ref, state, free=state)
            want = torch.tanh(want @ w)
        assert isinstance(state, RemoteBuffer) and state.dtype == "float32"
        torch.testing.assert_close(state.fetch(), want, rtol=1e-5, atol=1e-5)
        assert dev.info()["resident_bytes"] == w.nbytes + want.nbytes
        state.free()
        w_ref.free()
        assert dev.info()["resident_bytes"] == 0
        with pytest.raises(RemoteExecutionError, match="unknown buffer"):
            step(w_ref, x)
    finally:
        dev.close()


def test_remote_metering(worker, limiter_lib, tmp_path):
    """The worker charges its meter client like a local tenant's: one
    launch of the client's FLOP estimate per EXECUTE (within the
    reference's rel=0.5 of 2n^3), and the resident bytes of PUTs, given
    back at FREE."""
    with bench_train.worker_segment(limiter_lib, tmp_path / "seg", "remote",
                                    "cpu") as meter:
        worker.meter_client = meter
        dev = _dev(worker)
        try:
            remote = dev.remote_jit(lambda a, b: a @ b)
            n = 128
            a = torch.ones(n, n)
            remote(a, a)
            assert meter.launches == 1
            assert meter.charged_mflops == pytest.approx(2 * n ** 3 / 1e6,
                                                         rel=0.5)
            ref = dev.put(a)
            assert meter.hbm_charged_bytes == a.nbytes
            remote(ref, a)
            assert meter.launches == 2
            ref.free()
            assert meter.hbm_charged_bytes == 0
        finally:
            dev.close()
            worker.meter_client = None


@pytest.mark.parametrize("client_v,worker_v",
                         [(2, 9), (9, 2), (5, 6), (9, 6), (9, 5)])
def test_interop_versions(client_v, worker_v):
    """Mixed versions negotiate down and complete PUT / EXECUTE / FETCH /
    FREE; an opted-in q8 client ships q8 only on a v6+ connection, and
    a v5 client never gets a q8 reply."""
    w = RemoteVTPUWorker(protocol_version=worker_v, device="cpu")
    w.start()
    try:
        dev = _dev(w, protocol_version=client_v, quantize=True)
        x = _randn(128, 128, seed=4)
        ref = dev.put(x)
        assert dev._wire_version == min(client_v, worker_v)
        assert torch.equal(ref.fetch(), x) or dev._wire_version >= 6
        remote = dev.remote_jit(lambda a: a * 2.0 + 1.0)
        got = remote(ref)
        if dev._wire_version >= 6:
            assert dev.wire_stats.get("buffers_q8", 0) >= 1
            assert (got - (x * 2 + 1)).abs().max() < 0.2
        else:
            assert "buffers_q8" not in dev.wire_stats
            assert "buffers_q8" not in dev.rx_stats
            torch.testing.assert_close(got, x * 2 + 1)
        ref.free()
        assert dev.info()["resident_bytes"] == 0
        dev.close()
    finally:
        w.stop()


def test_worker_prefetch_depth_accounting(worker):
    """The prefetch runs ``prefetch_depth`` queued items deep: prefetched
    items get their copies stamped, in-flight accounting drains back to
    zero as they are consumed."""
    from tensorfusion_tpu_torch.remoting.dispatch import WorkItem

    dev = _dev(worker)
    try:
        remote = dev.remote_jit(lambda a: a * 3.0)
        x = torch.ones(8, 8)
        remote(x)
        with worker._lock:
            exe_id = next(iter(worker._exe_cache))
        items = [WorkItem("EXECUTE", {"exe_id": exe_id}, [x + i],
                          lambda *a, **k: None, 1.0, exe_id, None, None)
                 for i in range(3)]
        worker.dispatcher.peek_next_n = lambda n: items[:n]
        try:
            worker._prefetch_next(lambda: items[0])
            stamped = [i for i in items if i.meta.get("_dev_args")]
            assert len(stamped) == min(worker.prefetch_depth, len(items))
            stats = worker.upload_stats()
            assert stats["prefetched_total"] >= len(stamped)
            assert stats["inflight"] == len(stamped)
            assert stats["high_water"] >= len(stamped)
            for item in stamped:
                args = worker._inline_args(item)
                assert torch.equal(args[0], item.buffers[0])
            assert worker.upload_stats()["inflight"] == 0
        finally:
            del worker.dispatcher.peek_next_n
        assert dev.info()["upload_overlap"]["depth"] == worker.prefetch_depth
    finally:
        dev.close()


LATER_KINDS = ["COMPILE_MLIR"]
#: the kinds of state and peers, each served behind its version gate
#: (tests/test_torch_federation.py, test_torch_fabric.py and
#: test_torch_migration.py)
STATE_AND_PEER_KINDS = ["SNAPSHOT", "RESTORE", "ALLREDUCE_SHIP",
                        "ALLGATHER_SHIP", "SNAPSHOT_DELTA", "MIGRATE_FREEZE",
                        "MIGRATE_COMMIT", "FABRIC_OPEN", "FABRIC_ALLREDUCE",
                        "PEER_REDUCE", "PEER_INSTALL"]


def test_later_part_kinds_get_unknown_kind(worker):
    """Every registered kind the worker does not serve (COMPILE_MLIR, the
    reference's raw-StableHLO path) gets the reference's ``unknown kind``
    ERROR, never a silent success; the connection keeps serving after
    it."""
    assert set(LATER_KINDS) | set(STATE_AND_PEER_KINDS) | {
        "HELLO", "INFO", "COMPILE", "PUT", "FREE", "FETCH", "EXECUTE",
        "GENERATE", "KV_SHIP"} == set(protocol.REQUEST_KINDS)
    dev = _dev(worker)
    try:
        for kind in LATER_KINDS:
            with pytest.raises(RemoteExecutionError,
                               match=f"unknown kind {kind}"):
                dev._rpc(kind, {"state_dir": "x", "prompt": [1],
                                "max_tokens": 1}, [])
        assert dev.info()["platform"] == "cpu"
    finally:
        dev.close()


# -- programs from an untrusted peer ------------------------------------


class _Pwn:
    """A pickle that runs a shell command when loaded."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return (os.system, (f"touch {self.marker}",))


def _rewrite(blob: bytes, replace=None, add=None) -> bytes:
    """The archive with members replaced (name -> bytes, or a function
    of the old bytes) and added, all stored."""
    src = zipfile.ZipFile(io.BytesIO(blob))
    root = src.namelist()[0].split("/")[0]
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as dst:
        for name in src.namelist():
            data = src.read(name)
            new = (replace or {}).get(name[len(root) + 1:], data)
            dst.writestr(name, new(data) if callable(new) else new)
        for name, data in (add or {}).items():
            dst.writestr(f"{root}/{name}", data)
    return out.getvalue()


def _good_blob():
    x = torch.ones(4, 4)
    leaves, treedef = torch.utils._pytree.tree_flatten((x,))
    blob, _, _ = program.export_program(lambda a: torch.tanh(a) + 1,
                                        [((4, 4), torch.float32)], treedef)
    return blob


def _with_first_node(blob: bytes, target: str, inputs=None) -> bytes:
    """``blob`` with its first graph node (``tanh``) retargeted, and its
    inputs replaced when ``inputs`` is given."""
    def fix(data):
        model = json.loads(data)
        node = model["graph_module"]["graph"]["nodes"][0]
        node["target"] = target
        if inputs is not None:
            node["inputs"] = inputs
        return json.dumps(model).encode()
    return _rewrite(blob, replace={"models/model.json": fix})


def _from_file_blob(path) -> bytes:
    """A program whose first node reads 16 f32 from ``path`` with
    ``aten.from_file`` (its string argument rides the export format)."""
    def arg(name, value):
        return {"name": name, "arg": value, "kind": 1}
    return _with_first_node(_good_blob(), "torch.ops.aten.from_file.default", [
        arg("filename", {"as_string": str(path)}),
        arg("shared", {"as_none": True}), arg("size", {"as_int": 16})])


def _arg(name, value):
    return {"name": name, "arg": value, "kind": 1}


def _bad_blobs(marker):
    pwn = pickle.dumps(_Pwn(marker))
    good = _good_blob()

    def operator_argument(data):
        model = json.loads(data)
        model["graph_module"]["graph"]["nodes"][1]["inputs"].append(
            {"name": "op", "arg": {"as_operator":
                                   "torch.ops.aten.from_file.default"},
             "kind": 1})
        return json.dumps(model).encode()

    def weights_config(_):
        return json.dumps({"config": {"w": {
            "path_name": "weight_0", "is_param": True, "use_pickle": True,
            "tensor_meta": None}}}).encode()

    return {
        "not_a_zip": b"PK\x03\x04 nothing",
        "pickled_example_inputs": _rewrite(
            good, replace={"data/sample_inputs/model.pt": pwn}),
        "pickled_weight": _rewrite(
            good, replace={"data/weights/model_weights_config.json":
                           weights_config},
            add={"data/weights/weight_0": pwn}),
        "unreferenced_payload": _rewrite(
            good, add={"data/constants/tensor_9": pwn}),
        "foreign_member": _rewrite(
            good, add={"aotinductor/model/model.so": b"\x7fELF"}),
        "target_outside_torch_ops": _rewrite(
            good, replace={"models/model.json": lambda d: d.replace(
                b"torch.ops.aten.tanh.default", b"torch.os.system")}),
        "aten_from_file": _from_file_blob(marker),
        # writes to the worker's output
        "aten_print": _with_first_node(good, "torch.ops.aten._print.default", [
            _arg("s", {"as_string": "a tenant wrote this"})]),
        # process-wide state every tenant shares
        "cufft_plan_cache": _with_first_node(
            good, "torch.ops.aten._cufft_set_plan_cache_max_size.default", [
                _arg("device_index", {"as_int": 0}),
                _arg("max_size", {"as_int": 0})]),
        # draws from the worker's process-wide random generator
        "seeded_random": _with_first_node(
            good, "torch.ops.aten.bernoulli.default"),
        "unchecked_index": _with_first_node(
            good, "torch.ops.aten._unsafe_index.Tensor"),
        "uninitialized_memory": _with_first_node(
            good, "torch.ops.aten.empty_like.default"),
        "foreign_namespace": _with_first_node(
            good, "torch.ops.profiler._record_function_enter_new.default"),
        "unlisted_higher_order": _with_first_node(
            good, "torch.ops.higher_order.auto_functionalized"),
        "operator_argument": _rewrite(
            good, replace={"models/model.json": operator_argument}),
        "deflated_member": _deflated(good),
    }


def _deflated(blob: bytes) -> bytes:
    src = zipfile.ZipFile(io.BytesIO(blob))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as dst:
        for name in src.namelist():
            dst.writestr(name, src.read(name))
    return out.getvalue()


def test_compile_refuses_unsafe_programs(worker, tmp_path):
    """A program that asks to unpickle anything, carries a member the
    format does not name, or calls a target a tenant may not (outside
    ``torch.ops``, another namespace, an unlisted higher-order operator,
    file I/O, printing, process-wide cuFFT state, the process's random
    generator, unchecked indexing, uninitialized memory, also when
    passed as an operator argument) is refused with ERROR before a byte
    of it is deserialized; the same program unaltered compiles."""
    marker = tmp_path / "pwned"
    dev = _dev(worker)
    try:
        for case, blob in _bad_blobs(marker).items():
            with pytest.raises(RemoteExecutionError):
                dev._rpc("COMPILE", {}, [np.frombuffer(blob, np.uint8)])
            assert not marker.exists(), case
            with pytest.raises(ValueError):
                program.check_archive(blob)
        _, meta, _ = dev._rpc("COMPILE", {}, [np.frombuffer(_good_blob(),
                                                            np.uint8)])
        assert len(meta["exe_id"]) == 32
        assert dev.info()["cached_executables"] == 1
    finally:
        dev.close()


def test_from_file_program_reads_the_file_unless_refused(tmp_path):
    """The ``aten.from_file`` blob of the refused set is a working
    attack: loaded without the check it returns the bytes of a file the
    process can read; ``check_archive`` refuses it."""
    secret = torch.arange(16, dtype=torch.float32)
    path = tmp_path / "secret"
    path.write_bytes(secret.numpy().tobytes())
    blob = _from_file_blob(path)
    (leaked,) = torch.export.load(io.BytesIO(blob)).module()(
        torch.ones(4, 4))
    torch.testing.assert_close(leaked, secret + 1)
    with pytest.raises(ValueError, match="from_file"):
        program.check_archive(blob)


def _shipped_programs():
    """(name, function, example arguments) of every program the port
    ships: the 2-layer Llama forward and chip_smoke.py's last-position
    forward with flash and full attention, the decoder layer step of
    ``step_resident`` chains, in f32 and bf16, and the tests' programs."""
    import dataclasses

    import chip_smoke

    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for impl in ("flash", "full"):
            cfg = dataclasses.replace(tl.LlamaConfig.tiny(), n_layers=2,
                                      attn_impl=impl, dtype=dtype)
            p = tl.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
            toks = torch.zeros((2, 16), dtype=torch.int32)
            tag = f"{impl}-{str(dtype)[6:]}"
            out += [
                (f"forward-{tag}",
                 lambda p, t, cfg=cfg: tl.forward(p, t, cfg)[:, -1], (p, toks)),
                (f"last_logits-{tag}", chip_smoke._last_logits(tl, cfg),
                 (p, toks)),
                (f"layer_step-{tag}",
                 lambda layer, x, cfg=cfg: tl._layer(cfg, layer, x),
                 (p["layers"][0], p["tok_emb"][toks.long()]))]
    a, w = torch.ones(4, 4), torch.ones(4, 4)
    out += [("tanh_plus_one", lambda x: torch.tanh(x) + 1, (a,)),
            ("tanh_matmul_plus_one", lambda a, b: torch.tanh(a @ b) + 1.0,
             (a, w)),
            ("pytree_outputs",
             lambda x: {"double": x * 2, "stats": (x.sum(), x.max())}, (a,)),
            ("module_with_weights", torch.nn.Sequential(
                torch.nn.Linear(4, 3), torch.nn.Tanh()), (a,)),
            ("tanh_matmul", lambda w, x: torch.tanh(x @ w), (w, a)),
            ("cube", lambda x: (x @ x) @ x, (a,)),
            ("affine", lambda x: x * 2.0 + 1.0, (a,))]
    return out


@pytest.mark.parametrize("name,fn,args", _shipped_programs(),
                         ids=[p[0] for p in _shipped_programs()])
def test_shipped_programs_pass_the_check(name, fn, args):
    """Every program the port ships calls only the closed operator set:
    the export of each passes ``check_archive`` (and the ones with a
    non-core op do so through the written list)."""
    leaves, treedef = torch.utils._pytree.tree_flatten(args)
    blob, _, _ = program.export_program(
        fn, [(tuple(l.shape), l.dtype) for l in leaves], treedef)
    program.check_archive(blob)


def test_export_is_canonical():
    """Two exports of one function at one signature give one blob, so
    one exe_id (the shared executable cache depends on it)."""
    assert _good_blob() == _good_blob()


# -- cross-package interop and parity -----------------------------------

jax = pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")

from tensorfusion_tpu.models import llama as jl  # noqa: E402
from tensorfusion_tpu.remoting import RemoteDevice as JRemoteDevice  # noqa: E402
from tensorfusion_tpu.remoting import RemoteVTPUWorker as JWorker  # noqa: E402
from tensorfusion_tpu_torch.models import convert  # noqa: E402


def _arrays():
    rng = np.random.default_rng(5)
    return [rng.standard_normal((64, 33)).astype(np.float32),
            (rng.standard_normal(1000) * 4).astype(ml_dtypes.bfloat16),
            rng.integers(-9, 9, (7, 5)).astype(np.int32),
            rng.integers(0, 2, 17).astype(bool)]


def _as_numpy(t, like):
    if like.dtype == ml_dtypes.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def test_reference_client_against_port_worker(worker):
    dev = JRemoteDevice(worker.url, timeout_s=TIMEOUT)
    try:
        info = dev.info()
        assert info["platform"] == "cpu" and dev._wire_version == 9
        refs = [dev.put(a) for a in _arrays()]
        assert dev.info()["resident_bytes"] == sum(a.nbytes for a in _arrays())
        for ref, a in zip(refs, _arrays()):
            got = ref.fetch()
            assert got.dtype == a.dtype and got.shape == a.shape
            assert got.tobytes() == a.tobytes()
            ref.free()
        assert dev.info()["resident_bytes"] == 0
    finally:
        dev.close()


def test_port_client_against_reference_worker():
    w = JWorker()
    w.start()
    try:
        dev = _dev(w)
        assert dev.info()["platform"] == "cpu" and dev._wire_version == 9
        for a in _arrays():
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
                if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a)
            ref = dev.put(t)
            got = ref.fetch()
            assert got.dtype == t.dtype and tuple(got.shape) == a.shape
            assert _as_numpy(got, a).tobytes() == a.tobytes()
            ref.free()
        assert dev.info()["resident_bytes"] == 0
        dev.close()
    finally:
        w.stop()


def test_remote_llama_forward_matches_local_and_reference(worker):
    """A tiny-config Llama forward through the port's worker
    (attn_impl="flash": the kernel op, its plain version here) equals the
    port's local forward and the reference's remote_jit of ``jl.forward``
    (its dense path) through the reference's worker, on the same numpy
    weights and tokens, at f32 rtol 2e-4 / atol 2e-5."""
    import dataclasses

    jcfg = jl.LlamaConfig.tiny()
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), attn_impl="flash")
    np_params = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = convert.params_from_numpy(np_params, device="cpu")
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)

    dev = _dev(worker)
    try:
        rparams = torch.utils._pytree.tree_map(dev.put, tp)
        remote = dev.remote_jit(lambda p, t: tl.forward(p, t, tcfg)[:, -1])
        got = remote(rparams, torch.from_numpy(toks))
        assert worker.executions == 1
    finally:
        dev.close()
    local = tl.forward(tp, torch.from_numpy(toks), tcfg)[:, -1]
    torch.testing.assert_close(got, local, **F32)

    jw = JWorker()
    jw.start()
    try:
        jdev = JRemoteDevice(jw.url, timeout_s=TIMEOUT)
        # the reference's worker calls its programs on flat arguments
        leaves, treedef = jax.tree_util.tree_flatten(np_params)
        want = np.asarray(jdev.remote_jit(
            lambda t, *flat: jl.forward(jax.tree_util.tree_unflatten(
                treedef, flat), t, jcfg)[:, -1])(toks, *leaves))
        jdev.close()
    finally:
        jw.stop()
    np.testing.assert_allclose(got.numpy(), want, **F32)
