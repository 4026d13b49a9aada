"""The sharded remote EXECUTE of the port (protocol v3) on the CPU: a
worker over ``ranks=n`` gloo ranks (``remoting/sharded.py``) against the
reference's layouts and its oracle programs.

The reference's own sharded tests fail under jax 0.9.0 (its worker names
its mesh ``_tpf_flat``, which ``jax.export`` refuses), but what they
check still runs here: ``_wire_layout`` over a ``NamedSharding`` of the
8 virtual CPU devices (tests/conftest.py), and the local ``jax.jit`` call
the results are held to, at the reference tests' tolerance (1e-5).  The
flash op's DTensor rule runs on gloo ranks through its plain version and
is held to the JAX flash forward in interpret mode.  Each worker runs
with ``device="cpu"`` on port 0 and stops in a ``finally``.
"""

import dataclasses
import os
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_rank_tasks as tasks  # noqa: E402
from tensorfusion_tpu.models import llama as jl  # noqa: E402
from tensorfusion_tpu.ops import flash_attention as jax_flash_attention  # noqa: E402
from tensorfusion_tpu.remoting.worker import RemoteVTPUWorker as JWorker  # noqa: E402
from tensorfusion_tpu_torch.models import convert  # noqa: E402
from tensorfusion_tpu_torch.models import llama as tl  # noqa: E402
from tensorfusion_tpu_torch.parallel import RankGroup  # noqa: E402
from tensorfusion_tpu_torch.remoting import (RemoteDevice,  # noqa: E402
                                             RemoteExecutionError,
                                             RemoteVTPUWorker, client, program)
from tensorfusion_tpu_torch.remoting.client import ShardedRemoteBuffer  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 120
# the reference's sharded tests' tolerance (tests/test_remoting.py:378)
ORACLE = dict(rtol=1e-5, atol=1e-5)
# f32 tolerance of tests/test_ops.py:19-20
F32 = dict(rtol=2e-4, atol=2e-5)

SPECS = {"batch": ("b",), "columns": (None, "m"), "rows": ("m", None),
         "replicated": None}


def _worker(n):
    w = RemoteVTPUWorker(device="cpu", ranks=n)
    w.start()
    return w


@pytest.fixture(scope="module")
def workers():
    started = {}
    try:
        for n in (2, 4):
            started[n] = _worker(n)
        yield started
    finally:
        for w in started.values():
            w.stop()


def _dev(worker, **kw) -> RemoteDevice:
    return RemoteDevice(worker.url, timeout_s=TIMEOUT, **kw)


def _np(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mesh(n, axis):
    return Mesh(np.array(jax.devices()[:n]), (axis,))


# -- layouts -------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_compile_layouts_equal_the_references(workers, n, spec):
    """COMPILE's layouts for an argument and a result under each spec
    equal the reference's ``_wire_layout`` for the same spec and shape
    over a NamedSharding of the virtual CPU devices."""
    shape = (8 * n, 4 * n)
    s = SPECS[spec]
    dev = _dev(workers[n])
    try:
        # (None,): a replicated spec, where None for both is a plain call
        remote = dev.remote_jit(lambda x: x * 2.0, in_specs=s or (None,),
                                out_specs=s or (None,))
        _, _, _, arg_layouts, out_layouts = remote.compile_for(torch.zeros(shape))
        assert dev.info()["n_devices"] == n
    finally:
        dev.close()
    axis = "m" if spec in ("columns", "rows") else "b"
    want = JWorker._wire_layout(NamedSharding(_mesh(n, axis), P(*(s or ()))), shape)
    assert arg_layouts == [want] and out_layouts == [want]


# -- the reference's oracle programs -------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_batch_sharded_tanh_matches_local_jit(workers, n):
    """``tanh(x @ w)`` with x batch-sharded (the reference's
    ``_sharded_fn``): one call and pipelined submits equal the local
    ``jax.jit``."""
    mesh = _mesh(n, "b")
    sh = NamedSharding(mesh, P("b"))
    fn = jax.jit(lambda w, x: jnp.tanh(x @ w), in_shardings=(None, sh), out_shardings=sh)
    w, x = _np(64, 64, seed=7), _np(8 * n, 64, seed=8)
    dev = _dev(workers[n])
    try:
        remote = dev.remote_jit(lambda w, x: torch.tanh(x @ w),
                                in_specs=(None, ("b",)), out_specs=("b",))
        np.testing.assert_allclose(remote(_t(w), _t(x)).numpy(),
                                   np.asarray(fn(w, x)), **ORACLE)
        futs = [remote.submit(_t(w), _t(x * i)) for i in range(4)]
        for i, fut in enumerate(futs):
            np.testing.assert_allclose(fut.result(timeout=TIMEOUT).numpy(),
                                       np.asarray(fn(w, x * i)), **ORACLE)
    finally:
        dev.close()


def test_column_sharded_resident_weights_and_shard_fetch(workers):
    """``x @ w`` with w column-sharded and resident (``upload_arg``): the
    result equals the local jit; each shard fetched from its device is its
    slice; the whole reassembles; free leaves no resident byte."""
    mesh = _mesh(4, "m")
    col = NamedSharding(mesh, P(None, "m"))
    fn = jax.jit(lambda w, x: x @ w, in_shardings=(col, None), out_shardings=col)
    w, x = _np(32, 64, seed=9), _np(8, 32, seed=10)
    dev = _dev(workers[4])
    try:
        remote = dev.remote_jit(lambda w, x: x @ w, in_specs=((None, "m"), None),
                                out_specs=(None, "m"))
        w_ref = remote.upload_arg(0, _t(w), _t(w), _t(x))
        assert isinstance(w_ref, ShardedRemoteBuffer) and len(w_ref.shard_ids) == 4
        assert dev.info()["resident_bytes_per_device"] == {str(d): w.nbytes // 4
                                                           for d in range(4)}
        np.testing.assert_allclose(remote(w_ref, _t(x)).numpy(), np.asarray(fn(w, x)),
                                   **ORACLE)
        ent = w_ref.layout[1]
        _, fmeta, fbufs = dev._rpc("FETCH", {"buf_id": w_ref.shard_ids[1],
                                             "device_id": ent["device"]}, [])
        assert fmeta["device_id"] == ent["device"]
        assert np.array_equal(fbufs[0].numpy(), w[client._slices(ent)])
        with pytest.raises(RemoteExecutionError, match="no shard on device 2"):
            dev._rpc("FETCH", {"buf_id": w_ref.shard_ids[1], "device_id": 2}, [])
        assert np.array_equal(w_ref.fetch().numpy(), w)
        w_ref.free()
        assert dev.info()["resident_bytes"] == 0
    finally:
        dev.close()


@pytest.mark.parametrize("n", [2, 4])
def test_row_sharded_product_reduces_its_partial_sums(workers, n):
    """``x @ w`` with x column-sharded and w row-sharded: each rank holds
    a partial sum of the whole product, which the result's replicated
    spec reduces across the ranks."""
    mesh = _mesh(n, "m")
    fn = jax.jit(lambda x, w: x @ w,
                 in_shardings=(NamedSharding(mesh, P(None, "m")),
                               NamedSharding(mesh, P("m", None))),
                 out_shardings=NamedSharding(mesh, P()))
    x, w = _np(8, 16 * n, seed=11), _np(16 * n, 24, seed=12)
    dev = _dev(workers[n])
    try:
        remote = dev.remote_jit(lambda x, w: x @ w,
                                in_specs=((None, "m"), ("m", None)), out_specs=None)
        np.testing.assert_allclose(remote(_t(x), _t(w)).numpy(), np.asarray(fn(x, w)),
                                   **ORACLE)
        last = [r["last_execute"] for r in dev.info(ranks=True)["ranks"]["ranks"]]
    finally:
        dev.close()
    # each rank multiplied its own [8, 16] x [16, 24] block
    assert all(e["args"] == [[8, 16], [16, 24]] and e["outs"] == [[8, 24]]
               for e in last)


def test_each_rank_runs_its_shard_only(workers):
    """The ranks record the local shapes their program ran on: each holds
    a quarter of the batch in and out, none the whole, and no exchange
    happened inside the program."""
    dev = _dev(workers[4])
    try:
        remote = dev.remote_jit(lambda w, x: torch.tanh(x @ w),
                                in_specs=(None, ("b",)), out_specs=("b",))
        remote(_t(_np(64, 64, seed=1)), _t(_np(32, 64, seed=2)))
        ranks = dev.info(ranks=True)["ranks"]
    finally:
        dev.close()
    pids = [r["pid"] for r in ranks["ranks"]]
    assert len(set(pids)) == 4 and ranks["worker"]["pid"] not in pids
    for r in ranks["ranks"]:
        assert r["last_execute"] == {"args": [[64, 64], [8, 64]], "outs": [[8, 64]],
                                     "implicit_comms": 0}


def test_ephemeral_shards_are_freed(workers):
    """Per-call shards of at least SHARD_PUT_MIN_BYTES ride quiet
    ephemeral PUTs and are consumed by the EXECUTE: nothing stays resident
    across three calls, on any device."""
    dev = _dev(workers[4])
    try:
        remote = dev.remote_jit(lambda w, x: torch.tanh(x @ w),
                                in_specs=(None, ("b",)), out_specs=("b",))
        w, x = torch.ones(64, 64), torch.ones(1024 * 4, 64)
        assert x.numel() * 4 // 4 >= client.SHARD_PUT_MIN_BYTES
        puts0 = dev.wire_stats.get("frames", 0)
        for _ in range(3):
            remote(w, x)
        assert dev.wire_stats["frames"] - puts0 >= 3 * 5     # 4 PUTs + EXECUTE
        info = dev.info()
        assert info["resident_bytes"] == 0
        assert all(v == 0 for v in info["resident_bytes_per_device"].values())
    finally:
        dev.close()


def test_step_resident_returns_sharded_handles(workers):
    """A chain of ``step_resident`` calls keeps a sharded result on the
    ranks, one shard a device, and feeds it back without a byte on the
    wire; the fetched result equals the local chain, and freeing every
    handle leaves nothing resident."""
    w = _np(64, 64, seed=3) * 0.1
    x = _np(16, 64, seed=4)
    dev = _dev(workers[2])
    try:
        remote = dev.remote_jit(lambda w, x: torch.tanh(x @ w),
                                in_specs=(None, ("b",)), out_specs=("b",))
        w_ref = dev.put(_t(w))
        state = remote.step_resident(w_ref, _t(x))
        for _ in range(3):
            state = remote.step_resident(w_ref, state, free=state)
        assert isinstance(state, ShardedRemoteBuffer)
        assert [e["device"] for e in state.layout] == [0, 1]
        want = x
        for _ in range(4):
            want = np.tanh(want @ w)
        np.testing.assert_allclose(state.fetch().numpy(), want, **ORACLE)
        state.free()
        w_ref.free()
        assert dev.info()["resident_bytes"] == 0
    finally:
        dev.close()


def test_info_advertises_the_mesh(workers):
    """INFO lists the devices from the worker's own table; the per-rank
    block, a call on every rank, comes only when asked for."""
    dev = _dev(workers[4])
    try:
        info = dev.info()
        assert info["protocol_version"] >= 3 and info["n_devices"] == 4
        assert [d["id"] for d in info["devices"]] == [0, 1, 2, 3]
        assert [d["coords"] for d in info["devices"]] == [[0], [1], [2], [3]]
        assert sorted(info["resident_bytes_per_device"]) == ["0", "1", "2", "3"]
        assert info["ranks"] is None
        assert len(dev.info(ranks=True)["ranks"]["ranks"]) == 4
    finally:
        dev.close()


def _live_bytes(worker) -> int:
    return sum(r.nbytes * len(r.ranks) for r in worker.rank_devices.placed.values())


def test_refused_results_leave_the_count_of_live_buffers():
    """A ``step_resident`` whose results the budget refuses charges
    nothing and releases nothing it did not admit: ``resident_bytes``
    stays the sum of the live buffers, and the budget still holds."""
    w = _np(64, 64, seed=5)
    # room for w on both ranks and 4 KiB more; the results take 16 KiB
    worker = RemoteVTPUWorker(device="cpu", ranks=2,
                              max_resident_bytes=2 * w.nbytes + 4096)
    worker.start()
    dev = _dev(worker)
    try:
        w_ref = dev.put(_t(w))
        remote = dev.remote_jit(lambda w, x: x @ w, in_specs=(None, ("b",)),
                                out_specs=("b",))
        x = _t(_np(64, 64, seed=6))
        np.testing.assert_allclose(remote(w_ref, x).numpy(), x.numpy() @ w, **F32)
        with pytest.raises(RemoteExecutionError, match="budget exceeded"):
            remote.step_resident(w_ref, x, wait=True)
        info = dev.info()
        assert info["resident_bytes"] == _live_bytes(worker) == 2 * w.nbytes
        assert sum(info["resident_bytes_per_device"].values()) == 2 * w.nbytes
        with pytest.raises(RemoteExecutionError, match="budget exceeded"):
            dev.put(np.zeros(4096 // 4 + 1, np.float32))
        w_ref.free()
        assert dev.info()["resident_bytes"] == 0
    finally:
        dev.close()
        worker.stop()


def test_failed_replication_releases_its_bytes(workers, monkeypatch):
    """A broadcast of a replicated argument that fails on a rank gives
    back the bytes it admitted for the copies: ``resident_bytes`` stays the
    sum of the live buffers."""
    from tensorfusion_tpu_torch.remoting import sharded

    worker = workers[2]
    ranks = worker.rank_devices
    each = ranks._each

    def failing(task, args):
        if task is sharded._rank_replicate:
            raise sharded.RankError("rank 1 failed in _rank_replicate")
        return each(task, args)

    w = _np(64, 64, seed=5)
    dev = _dev(worker)
    try:
        w_ref = dev.put(_t(w))
        remote = dev.remote_jit(lambda w, x: x @ w, in_specs=(None, ("b",)),
                                out_specs=("b",))
        monkeypatch.setattr(ranks, "_each", failing)
        with pytest.raises(RemoteExecutionError, match="_rank_replicate"):
            remote(w_ref, _t(_np(16, 64, seed=6)))
        monkeypatch.undo()
        assert dev.info()["resident_bytes"] == _live_bytes(worker) == w.nbytes
        np.testing.assert_allclose(remote(w_ref, _t(_np(16, 64, seed=6))).numpy(),
                                   _np(16, 64, seed=6) @ w, **F32)
        assert dev.info()["resident_bytes"] == _live_bytes(worker) == 2 * w.nbytes
        w_ref.free()
        assert dev.info()["resident_bytes"] == 0
    finally:
        dev.close()


def test_v2_client_and_fields_below_v3(workers):
    """A v2 client completes a plain PUT / EXECUTE / FETCH against the
    worker over ranks (the program runs on device 0); each v3 field it
    sends is refused, and so is a sharded program."""
    v2 = _dev(workers[2], protocol_version=2)
    try:
        assert v2.info()["n_devices"] == 2 and v2._wire_version == 2
        ref = v2.put(np.arange(16, dtype=np.float32))
        out = v2.remote_jit(lambda a: a * 2.0 + 1.0)(ref)
        np.testing.assert_allclose(out.numpy(), np.arange(16) * 2.0 + 1.0)
        np.testing.assert_allclose(ref.fetch().numpy(), np.arange(16))
        for kind, meta, bufs in (
                ("PUT", {"device_id": 1}, [np.zeros(4, np.float32)]),
                ("FETCH", {"buf_id": ref.buf_id, "device_id": 0}, [])):
            with pytest.raises(RemoteExecutionError, match="protocol >= 3"):
                v2._rpc(kind, meta, bufs)
        sharded_fn = v2.remote_jit(lambda x: x * 2.0, in_specs=("b",), out_specs=("b",))
        with pytest.raises(RemoteExecutionError, match="needs protocol v3"):
            sharded_fn(torch.zeros(4, 4))            # the client's half
        leaves, treedef = torch.utils._pytree.tree_flatten((torch.zeros(4, 4),))
        blob, _, _ = program.export_program(lambda x: x * 2.0, [((4, 4), torch.float32)],
                                            treedef, ("b",), ("b",), nr_devices=2)
        with pytest.raises(RemoteExecutionError, match="protocol >= 3"):
            v2._rpc("COMPILE", {}, [np.frombuffer(blob, dtype=np.uint8)])  # the worker's
        ref.free()
    finally:
        v2.close()


@pytest.mark.parametrize("kind", ["GENERATE", "KV_SHIP", "ALLREDUCE_SHIP",
                                  "ALLGATHER_SHIP", "SNAPSHOT", "RESTORE",
                                  "SNAPSHOT_DELTA", "MIGRATE_FREEZE", "MIGRATE_COMMIT",
                                  "FABRIC_OPEN", "FABRIC_ALLREDUCE", "PEER_REDUCE",
                                  "PEER_INSTALL"])
def test_one_device_kinds_are_refused_by_name(workers, kind):
    dev = _dev(workers[2])
    try:
        with pytest.raises(RemoteExecutionError,
                           match=f"{kind} is not served by a worker over 2 ranks"):
            dev._rpc(kind, {}, [])
    finally:
        dev.close()


def test_sharded_llama_forward_matches_reference_and_local(workers):
    """The slice as a whole: a tiny Llama's last-position logits (flash
    attention, the kernel op's plain version here) with tokens
    batch-sharded over 2 ranks and the weights resident and replicated
    equal the JAX forward of the same numpy weights and tokens and the
    port's local forward."""
    jcfg = jl.LlamaConfig.tiny()
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), attn_impl="flash")
    np_params = jax.tree_util.tree_map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = convert.params_from_numpy(np_params, device="cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    dev = _dev(workers[2])
    try:
        rparams = torch.utils._pytree.tree_map(dev.put, tp)
        remote = dev.remote_jit(lambda p, t: tl.forward(p, t, tcfg)[:, -1],
                                in_specs=(None, ("b",)), out_specs=("b",))
        got = remote(rparams, _t(toks))
        last = [r["last_execute"] for r in dev.info(ranks=True)["ranks"]["ranks"]]
        for leaf in torch.utils._pytree.tree_leaves(rparams):
            leaf.free()
        assert dev.info()["resident_bytes"] == 0
    finally:
        dev.close()
    assert all(e["args"][-1] == [2, 32] and e["outs"] == [[2, jcfg.vocab_size]]
               and e["implicit_comms"] == 0 for e in last)
    want = np.asarray(jax.jit(lambda p, t: jl.forward(p, t, jcfg)[:, -1])(np_params, toks))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    torch.testing.assert_close(got, tl.forward(tp, _t(toks), tcfg)[:, -1], **F32)


# -- the flash op's DTensor rule -----------------------------------------------


@pytest.fixture(scope="module")
def ranks():
    with RankGroup(2, device="cpu", backend="gloo", timeout_s=120) as group:
        yield group


@pytest.mark.parametrize("dim", [0, 1], ids=["batch", "heads"])
def test_flash_on_dtensors_matches_the_jax_kernel(ranks, dim):
    """q, k, v [B, H, T, D] sharded alike on the batch or the head
    dimension: each rank runs the op on its own rows, the output keeps the
    placement, and the shards assembled equal the JAX flash forward (the
    Pallas kernel in interpret mode)."""
    q, k, v = (_np(2, 4, 128, 32, seed=s) for s in (20, 21, 22))
    got = ranks.run(tasks.flash_on_dtensors, q, k, v, dim)
    assert all(g["placements"] == f"(Shard(dim={dim}),)" for g in got)
    assert all(g["local_shape"] == [2 // (2 - dim), 4 // (1 + dim), 128, 32] for g in got)
    out = np.concatenate([g["local"] for g in got], axis=dim)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=True, backend="interpret")
    np.testing.assert_allclose(out, np.asarray(want), **F32)
    assert all("needs q, k and v sharded alike" in g["mixed_error"] for g in got)


def test_a_dead_rank_fails_the_request_by_name():
    """A rank killed under the worker: the next request fails at once,
    naming the rank, and the worker refuses work from then on."""
    w = _worker(2)
    try:
        dev = _dev(w)
        remote = dev.remote_jit(lambda x: x + 1.0, in_specs=("b",), out_specs=("b",))
        remote(torch.zeros(4, 4))
        victim = dev.info(ranks=True)["ranks"]["ranks"][1]["pid"]
        os.kill(victim, signal.SIGKILL)
        t0 = time.monotonic()
        with pytest.raises(RemoteExecutionError, match=r"no answer from \[1\]"):
            remote(torch.zeros(4, 4))
        assert time.monotonic() - t0 < 5
        with pytest.raises(RemoteExecutionError, match="closed"):
            remote(torch.zeros(4, 4))
        dev.close()
    finally:
        w.stop()


def _with_shardings(blob, edit):
    """``blob`` with its shardings.json replaced by ``edit(shardings)``."""
    import io
    import json
    import zipfile

    src = zipfile.ZipFile(io.BytesIO(blob))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as dst:
        for info in src.infolist():
            data = src.read(info)
            if info.filename.endswith("/extra/" + program.SHARDINGS):
                data = json.dumps(edit(json.loads(data))).encode()
            dst.writestr(info, data)
    return out.getvalue()


@pytest.mark.parametrize("case", ["one_device", "too_long", "two_dims", "uneven",
                                  "two_axes", "count", "shapes"])
def test_program_check_refuses_specs_that_do_not_fit(case):
    """``check_archive`` refuses shardings that do not fit their shapes
    over the flat mesh, and ``load_program`` shapes that are not the
    program's own."""
    x = torch.zeros(8, 4)
    _, treedef = torch.utils._pytree.tree_flatten((x, x))
    blob, _, _ = program.export_program(lambda a, b: a + b, [((8, 4), torch.float32)] * 2,
                                        treedef, ("b",), ("b",), nr_devices=2)
    assert program.check_archive(blob)["in_specs"] == [["b"], ["b"]]
    edit = {"one_device": lambda s: dict(s, nr_devices=1),
            "too_long": lambda s: dict(s, in_specs=[["b", None, None], ["b"]]),
            "two_dims": lambda s: dict(s, in_specs=[["b", "b"], ["b"]]),
            "uneven": lambda s: dict(s, nr_devices=3),
            "two_axes": lambda s: dict(s, in_specs=[["b"], [None, "m"]]),
            "count": lambda s: dict(s, out_specs=[]),
            "shapes": lambda s: dict(s, in_shapes=[[4, 8], [4, 8]],
                                     out_shapes=[[4, 8]])}[case]
    bad = _with_shardings(blob, edit)
    if case == "shapes":
        program.check_archive(bad)
        with pytest.raises(ValueError, match="the program's are"):
            program.load_program(bad, torch.device("cpu"))
    else:
        with pytest.raises(ValueError, match="shardings"):
            program.check_archive(bad)


def test_profile_shard_splits_an_execute_on_the_cpu():
    """``profile_shard`` at a tiny size on the CPU: the EXECUTE round trip,
    each rank's traced call split into its host events (the flash op among
    them, as many as the layers), and the plain forward on every rank."""
    from tensorfusion_tpu_torch import profile_shard

    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), attn_impl="flash", n_layers=2)
    lines = profile_shard.run(cfg, ranks=2, calls=2, device="cpu", emit=lambda _: None)
    assert lines["execute"]["execute_ms_median"] > 0
    assert all(t > 0 for t in lines["execute"]["in_rank_ms_mean_per_rank"])
    for rank in lines["trace"]["per_rank"]:
        assert 0 < rank["top_level_host_ms"] <= rank["in_rank_ms"]
        flash = [e for e in rank["top"] if e["event"] == "tpf_torch::flash_attn_fwd"]
        assert flash and flash[0]["count"] == cfg.n_layers
    assert len(lines["plain"]["all_ranks_ms_per_rank"]) == 2
    assert lines["plain"]["rank0_alone_ms"] > 0
