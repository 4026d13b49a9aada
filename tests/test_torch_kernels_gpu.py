"""The port's Hopper kernels on the card.  Without a CUDA device every test
here skips; run them on an H100 with

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu

This file imports no JAX, so it runs where JAX is not installed.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from tensorfusion_tpu_torch import ops  # noqa: E402
from tensorfusion_tpu_torch.models import llama  # noqa: E402
from tensorfusion_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd_plain, flash_attention_plain,
    flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_fwd_cuda)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, shape, dtype):
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,d", [(100, 16), (128, 32), (300, 64), (512, 128)])
def test_kernel_matches_plain(gen, dtype, causal, t, d):
    """Ragged T (100, 300) exercises the kernel's edge masking; the
    tolerances are chip_smoke.py's."""
    q, k, v = _qkv(gen, (3, t, d), dtype)
    before = flash_fwd_cuda.launches
    out, lse = flash_fwd_cuda(q, k, v, d ** -0.5, causal)
    ref, ref_lse = flash_attention_plain(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert flash_fwd_cuda.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.bfloat16:
        assert (out.float() - ref.float()).abs().max().item() < 2e-2
    else:
        torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)


def test_kernel_refuses_what_it_does_not_take(gen):
    q, k, v = _qkv(gen, (2, 64, 48), torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd_cuda(q, k, v, 1.0, True)
    q, k, v = _qkv(gen, (2, 64, 64), torch.float16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        flash_fwd_cuda(q, k, v, 1.0, True)


def _bwd_inputs(gen, bh, t, d, dtype, causal):
    """q, k, v, dO random; lse and Δ from the plain forward."""
    q, k, v = _qkv(gen, (bh, t, d), dtype)
    do = torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)
    out, lse = flash_attention_plain(q, k, v, d ** -0.5, causal)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,d", [(100, 16), (128, 32), (300, 64), (512, 128)])
def test_backward_kernels_match_plain(gen, dtype, causal, t, d):
    """dq and dk/dv against the plain backward, at ragged (100, 300) and
    tiled T; the tolerances are chip_smoke.py's: f32 rtol 2e-4 atol 2e-4,
    bf16 mean|err| / mean|ref| < 2e-2 per output."""
    args = _bwd_inputs(gen, 3, t, d, dtype, causal)
    scale = d ** -0.5
    before = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
    dq = flash_bwd_dq_cuda(*args, scale, causal)
    dk, dv = flash_bwd_dkv_cuda(*args, scale, causal)
    refs = flash_attention_bwd_plain(*args, scale, causal)
    torch.cuda.synchronize()
    assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.isfinite(got).all(), name
        if dtype == torch.bfloat16:
            rel = ((got.float() - ref.float()).abs().mean()
                   / ref.float().abs().mean()).item()
            assert rel < 2e-2, f"{name}: mean relative error {rel}"
        else:
            torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", [1000, 1100])
def test_ring_kernels_at_ragged_t(gen, t, d, causal):
    """The TMA-ring kernels (bf16 forward, dQ and dK/dV at D = 64 and 128)
    at a T that is no multiple of a tile and spans several ring stages:
    chip_smoke.py's tolerances."""
    q, k, v = _qkv(gen, (2, t, d), torch.bfloat16)
    out, lse = flash_fwd_cuda(q, k, v, d ** -0.5, causal)
    ref, ref_lse = flash_attention_plain(q, k, v, d ** -0.5, causal)
    args = _bwd_inputs(gen, 2, t, d, torch.bfloat16, causal)
    dq = flash_bwd_dq_cuda(*args, d ** -0.5, causal)
    dk, dv = flash_bwd_dkv_cuda(*args, d ** -0.5, causal)
    ref_dq, ref_dk, ref_dv = flash_attention_bwd_plain(*args, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() < 2e-2
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    for name, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        assert torch.isfinite(got).all(), name
        rel = ((got.float() - want.float()).abs().mean()
               / want.float().abs().mean()).item()
        assert rel < 2e-2, f"{name}: mean relative error {rel}"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_ring_kernels_read_nothing_of_the_next_head(gen, d, causal):
    """bh = 2 at a ragged T, head 1 holding values 1e4 times larger: head
    0's out, lse, dq, dk and dv equal those of head 0 run alone, bit for
    bit.  A tile that runs past T must be zero-filled, not read from head
    1."""
    t = 1000
    q, k, v, do, _, _ = _bwd_inputs(gen, 2, t, d, torch.bfloat16, causal)
    big = torch.tensor([1.0, 1e4], device="cuda")[:, None, None]
    q, k, v, do = ((x.float() * big).to(torch.bfloat16) for x in (q, k, v, do))
    ref_out, lse = flash_attention_plain(q, k, v, d ** -0.5, causal)
    delta = (do.float() * ref_out.float()).sum(-1)
    scale = d ** -0.5
    both = (*flash_fwd_cuda(q, k, v, scale, causal),
            flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal),
            *flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal))
    head0 = (q[:1], k[:1], v[:1], do[:1], lse[:1], delta[:1], scale, causal)
    alone = (*flash_fwd_cuda(q[:1], k[:1], v[:1], scale, causal),
             flash_bwd_dq_cuda(*head0), *flash_bwd_dkv_cuda(*head0))
    torch.cuda.synchronize()
    for name, b, a in zip(("out", "lse", "dq", "dk", "dv"), both, alone):
        assert torch.isfinite(a).all(), name
        assert torch.equal(b[:1], a), name


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_through_the_kernels_matches_plain(gen, causal):
    """[B, H, T, D] through flash_attention's autograd rule (forward, dq
    and dkv kernels) against autograd through the plain version, f32."""
    q, k, v = _qkv(gen, (2, 3, 256, 64), torch.float32)
    w = torch.sin(torch.arange(q.numel(), device="cuda",
                               dtype=torch.float32)).reshape(q.shape)

    def grads(backend):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out = flash_attention(*xs, causal=causal, backend=backend)
        return torch.autograd.grad((out * w).sum(), xs)

    ops.reset_launch_counts()
    got = grads("cuda")
    assert ops.launch_counts() == {"flash_attn_fwd": 1, "flash_attn_bwd_dq": 1,
                                   "flash_attn_bwd_dkv": 1}
    for g, r in zip(got, grads("plain")):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=2e-4)


def test_f32_train_step_gradients_match_full(gen):
    """A train step's gradients through the kernels against the dense
    attention path, f32: max|Δ| <= 1e-4 · max|full| per leaf."""
    cfg = llama.LlamaConfig(vocab_size=1024, dim=256, n_layers=2, n_heads=2,
                            n_kv_heads=1, ffn_dim=512, dtype=torch.float32,
                            attn_impl="flash")
    params = llama.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen,
                         device="cuda")
    batch = {"tokens": toks, "targets": toks.roll(-1, dims=1)}
    ops.reset_launch_counts()
    loss, got = llama.value_and_grad(params, batch, cfg)
    assert ops.launch_counts()["flash_attn_bwd_dq"] == cfg.n_layers
    assert ops.launch_counts()["flash_attn_bwd_dkv"] == cfg.n_layers
    loss_f, want = llama.value_and_grad(params, batch,
                                        dataclasses.replace(cfg, attn_impl="full"))
    torch.testing.assert_close(loss, loss_f, rtol=1e-5, atol=0)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()
    step, init = llama.make_train_step(cfg)
    state = init(params)
    before = params["lm_head"].clone()
    _, _, loss2 = step(params, state, batch)
    assert torch.isfinite(loss2) and not torch.equal(params["lm_head"], before)


def test_backward_kernels_refuse_what_they_do_not_take(gen):
    args = _bwd_inputs(gen, 2, 64, 64, torch.bfloat16, True)
    bad_d = _bwd_inputs(gen, 2, 64, 48, torch.bfloat16, True)
    bad_dtype = [x.half() if x.dtype == torch.bfloat16 else x for x in args]
    for fn in (flash_bwd_dq_cuda, flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="head_dim"):
            fn(*bad_d, 1.0, True)
        with pytest.raises(ValueError, match="bf16 or f32"):
            fn(*bad_dtype, 1.0, True)
        with pytest.raises(ValueError, match="lse and delta"):
            fn(*args[:4], args[4][:, :32], args[5], 1.0, True)


def test_flash_generate_matches_full_in_f32(gen):
    cfg = llama.LlamaConfig(vocab_size=1024, dim=256, n_layers=2, n_heads=2,
                            n_kv_heads=1, ffn_dim=512, dtype=torch.float32,
                            attn_impl="flash")
    params = llama.init_params(cfg, gen)
    prompt = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen,
                           device="cuda")
    ops.reset_launch_counts()
    got = llama.generate(params, prompt, 6, cfg)
    assert ops.launch_counts()["flash_attn_fwd"] == cfg.n_layers
    want = llama.generate(params, prompt, 6,
                          dataclasses.replace(cfg, attn_impl="full"))
    assert torch.equal(got, want)


def test_w8a8_product_on_the_card_is_exact(gen):
    """torch._int_mm with the operands padded up to its shape limits
    gives the same int32 sums as the exact CPU product."""
    from tensorfusion_tpu_torch.models import quantize

    a = torch.randint(-127, 128, (3, 5, 60), generator=gen, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (60, 36), generator=gen, device="cuda",
                      dtype=torch.int8)
    got = quantize._int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (3, 5, 36)
    assert torch.equal(got.cpu(), quantize._int8_matmul(a.cpu(), b.cpu()))


def test_memory_is_charged_once_and_released(gen, limiter_lib, tmp_path):
    import gc
    import os
    import shutil

    from tensorfusion_tpu_torch.client import VTPUClient
    from tensorfusion_tpu_torch.hypervisor import DeviceQuota, Limiter

    libs = []
    for face in ("host", "cli"):
        (tmp_path / face).mkdir()
        libs.append(shutil.copy2(limiter_lib, tmp_path / face))
    host = Limiter(str(libs[0]))
    host.init(str(tmp_path / "shm"))
    host.create_worker("ns", "w", [DeviceQuota(0, "gpu-0", 10000, 8 << 30,
                                               10**9, 10**9)])
    client = VTPUClient(limiter_lib=str(libs[1]),
                        shm_path=os.path.join(tmp_path, "shm", "ns", "w"))
    metered = client.meter(lambda x: (x @ x).relu())
    x = torch.randn((1024, 1024), generator=gen, device="cuda")
    metered(x)
    charged = client.hbm_charged_bytes
    assert charged >= 1024 * 1024 * 4     # at least the output
    metered(x)                            # same shape: charged once
    assert client.hbm_charged_bytes == charged and client.launches == 2
    del metered
    gc.collect()
    assert client.hbm_charged_bytes == 0
    client.close()


HOOKED_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from tensorfusion_tpu_torch.hypervisor import ShmView, cuda_hook_binding

x = torch.randn(4096, 4096, device="cuda")
for _ in range(20):
    y = (x @ x).relu_()
torch.cuda.synchronize()
y.sum().item()                       # a last launch: the earlier windows are read
hook = cuda_hook_binding.loaded()
view = ShmView(sys.argv[2])
print(json.dumps({"reserved": torch.cuda.memory_reserved(), "hook": hook.report(),
                  "segment_hbm_used": view.read().devices[0].hbm_used_bytes}))
"""


def test_hook_meters_an_unmodified_torch_child(gen, limiter_lib, tmp_path):
    """A torch process that knows nothing of metering, started as the
    node agent starts a worker (the launch hook preloaded, a live
    segment): its launches and device time are charged, its device memory
    covers what torch reserved, and its pid is registered (the reference's
    tests/test_tpu_live.py test_proxy_meters_unmodified_jax_on_tpu)."""
    import json
    import os
    import shutil
    import subprocess
    import sys

    from tensorfusion_tpu_torch.hypervisor import DeviceQuota, Limiter, ShmView, _build

    (tmp_path / "host").mkdir()
    host = Limiter(str(shutil.copy2(limiter_lib, tmp_path / "host")))
    host.init(str(tmp_path / "shm"))
    host.create_worker("ns", "w", [DeviceQuota(0, "gpu-0", 10000, 0, 10**15, 10**15)])
    shm = str(tmp_path / "shm" / "ns" / "w")
    env = {**os.environ, "LD_PRELOAD": str(_build.cuda_hook_path()), "TPF_SHM_PATH": shm,
           "TPF_LIMITER_LIB": str(limiter_lib), "TPF_DEVICE_INDEX": "0",
           "TPF_PEAK_MFLOPS": "989000000"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", HOOKED_CHILD, repo, shm], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, out + err
    got = json.loads(out.strip().splitlines()[-1])
    hook = got["hook"]
    assert hook["metered"] == 1
    assert hook["launches"] > 0 and hook["device_us"] > 0 and hook["charged_mflops"] > 0
    assert got["segment_hbm_used"] >= got["reserved"] > 0
    state = ShmView(shm).read()
    assert state.devices[0].launches == hook["charges"]
    assert proc.pid in state.pids


def _paged_setup(gen, dtype=torch.float32):
    """A small f32 model and a LlamaRunner on the card with three ragged
    sequences prefilled (tables of block size 4)."""
    from tensorfusion_tpu_torch.serving import LlamaRunner

    cfg = llama.LlamaConfig(vocab_size=1024, dim=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, ffn_dim=512, dtype=dtype)
    params = llama.init_params(cfg, gen)
    runner = LlamaRunner(params, cfg, num_blocks=32, block_size=4)
    lens = [5, 11, 8]
    # room for 3 decode steps and a 3-token verify past each prompt
    tables = [[1, 2, 3], [4, 5, 6, 7, 16], [8, 9, 10, 17]]
    firsts = []
    for n, table in zip(lens, tables):
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                               device="cuda").tolist()
        firsts.append(runner.prefill(prompt, table, 0))
    return cfg, params, runner, lens, tables, firsts


def _clone(cache):
    return {kind: [t.clone() for t in layers] for kind, layers in cache.items()}


def _assert_pages_close(got, want):
    for kind in ("k", "v"):
        for a, b in zip(got[kind], want[kind]):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


def _padded(runner, tables, b):
    tab = runner._pad_tables(tables, b)
    return torch.from_numpy(tab).cuda()


def test_graphed_decode_and_verify_match_eager_paged_steps(gen):
    """LlamaRunner.decode / verify replay one CUDA graph per bucket; each
    equals kvpool's eager step on a copy of the same pool: tokens equal,
    written pages within f32 rtol 2e-4 / atol 2e-5."""
    from tensorfusion_tpu_torch.serving import kvpool

    cfg, params, runner, lens, tables, toks = _paged_setup(gen)
    for step in range(3):
        ref = _clone(runner.cache)
        got = runner.decode(toks, lens, tables)
        tok = torch.tensor(toks + [0], dtype=torch.int32, device="cuda")
        pos = torch.tensor(lens + [0], dtype=torch.int32, device="cuda")
        logits, _ = kvpool.paged_decode_step(params, tok, ref,
                                             _padded(runner, tables, 4), pos, cfg)
        assert got == logits.argmax(-1)[:3].tolist(), step
        _assert_pages_close(runner.cache, ref)
        toks, lens = got, [n + 1 for n in lens]
    assert set(runner.graphs) == {("decode", 4, 8)}
    ref = _clone(runner.cache)
    rows = [[t, 7, 9] for t in toks]
    got = runner.verify(rows, lens, tables)
    tok = torch.tensor(rows + [[0, 0, 0]], dtype=torch.int32, device="cuda")
    pos = torch.tensor(lens + [0], dtype=torch.int32, device="cuda")
    logits, _ = kvpool.paged_verify_step(params, tok, ref,
                                         _padded(runner, tables, 4), pos, cfg)
    assert got == logits.argmax(-1)[:3].tolist()
    _assert_pages_close(runner.cache, ref)
    assert ("verify", 4, 3, 8) in runner.graphs and runner.capture_s > 0


def test_graph_replays_see_copied_and_written_pages(gen):
    """copy_blocks and write_blocks write the pool in place, so a later
    replay of an already captured graph reads them: a sequence decoded
    from copied (or shipped) pages gives the token of its original."""
    cfg, params, runner, lens, tables, toks = _paged_setup(gen)
    runner.warmup(max_batch=4, prompt_len=16, chunk=8)
    captured = dict(runner.graphs)
    assert ("decode", 4, 8) in captured
    ptrs = [t.data_ptr() for t in runner.cache["k"] + runner.cache["v"]]
    want = runner.decode(toks, lens, tables)
    runner.copy_blocks([(4, 12), (5, 13), (6, 14), (7, 15), (16, 18)])
    k, v = runner.read_blocks(tables[2])
    runner.write_blocks([20, 21, 22, 23], k, v)
    assert torch.equal(runner.read_blocks([20, 21, 22, 23])[0], k)
    assert [t.data_ptr() for t in runner.cache["k"] + runner.cache["v"]] == ptrs
    # the decode above wrote position lens[i] of each original; the copies
    # hold it too, so decode them from the same position again
    got = runner.decode(toks, lens, [tables[0], [12, 13, 14, 15, 18],
                                     [20, 21, 22, 23]])
    assert got == want
    assert runner.graphs == captured       # replays of the warm-up graphs


def test_threaded_prefill_pool_with_lazily_captured_verify_graphs(gen):
    """The worker topology: the engine's stepper on its own thread, and a
    threaded PrefillPool launching eager prefill chunks on its threads,
    while the stepper captures verify (and wider decode) buckets lazily,
    since warmup captures decode buckets only.  Requests arrive in waves
    so later prompts prefill while earlier ones verify.  No thread may
    fail, and every request's tokens must equal generate's, in f32."""
    import random
    import threading
    import time

    from tensorfusion_tpu_torch.serving import (LlamaRunner, NGramDraft,
                                                PrefillPool, ServingEngine)

    cfg = llama.LlamaConfig(vocab_size=1024, dim=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, ffn_dim=512, dtype=torch.float32)
    params = llama.init_params(cfg, gen)
    runner = LlamaRunner(params, cfg, num_blocks=512, block_size=4)
    pool = PrefillPool([LlamaRunner(params, cfg, num_blocks=512, block_size=4)
                        for _ in range(2)], chunk_tokens=16)
    engine = ServingEngine(runner, max_batch=4, prefill_chunk_tokens=32,
                           draft=NGramDraft(n=2), spec_k=3, prefill_pool=pool)
    rng = random.Random(3)
    # repeated phrases, so the n-gram draft proposes and verify steps run
    requests = [(f"r{i}", [rng.randrange(cfg.vocab_size) for _ in range(8)]
                 * rng.randrange(4, 12), rng.randrange(12, 24))
                for i in range(12)]
    outs, failures = {}, []

    def emit(seq, toks, done, info):
        if done:
            outs[seq.tenant] = list(seq.tokens)

    hook = threading.excepthook
    threading.excepthook = lambda args: failures.append(
        f"{args.thread.name}: {args.exc_type.__name__}: {args.exc_value}")
    runner.warmup(max_batch=1, prompt_len=16, chunk=16)
    pool.start()
    engine.start()
    try:
        for i in range(0, len(requests), 3):
            for tenant, prompt, new in requests[i:i + 3]:
                engine.submit(prompt, new, tenant=tenant, emit=emit)
            time.sleep(0.05)
        deadline = time.monotonic() + 180
        while len(outs) < len(requests) and not failures and \
                time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        engine.stop()
        pool.stop()
        threading.excepthook = hook
    assert not failures, failures
    assert len(outs) == len(requests)
    assert any(k[0] == "verify" for k in runner.graphs)
    assert pool.snapshot()["shipped_jobs"] == len(requests)
    assert engine.snapshot()["spec"]["steps"] > 0
    for tenant, prompt, new in requests:
        want = llama.generate(params, torch.tensor([prompt], device="cuda"),
                              new, cfg)[0].tolist()
        assert outs[tenant] == want, tenant


def test_remote_execute_launches_the_flash_kernel_per_layer(gen):
    """A remote EXECUTE of an exported flash forward on a worker that owns
    the card: one flash-forward launch per layer per call, the result
    equal to the local forward's, resident weights charged and freed."""
    from tensorfusion_tpu_torch.remoting import RemoteDevice, RemoteVTPUWorker

    cfg = llama.LlamaConfig(vocab_size=1024, dim=512, n_layers=3, n_heads=4,
                            n_kv_heads=2, ffn_dim=1024, dtype=torch.bfloat16,
                            attn_impl="flash")
    params = llama.init_params(cfg, gen)
    host = torch.utils._pytree.tree_map(lambda t: t.cpu(), params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                           device="cuda")

    def last_logits(p, t):
        return llama.forward(p, t, cfg)[:, -1]

    worker = RemoteVTPUWorker(device="cuda")
    worker.start()
    try:
        dev = RemoteDevice(worker.url, timeout_s=120)
        try:
            remote_params = torch.utils._pytree.tree_map(dev.put, host)
            nbytes = sum(t.numel() * t.element_size()
                         for t in torch.utils._pytree.tree_leaves(params))
            assert dev.info()["resident_bytes"] == nbytes
            remote = dev.remote_jit(last_logits)
            remote.compile_for(remote_params, tokens.cpu())
            ops.reset_launch_counts()
            got = remote(remote_params, tokens.cpu())
            launches = ops.launch_counts()["flash_attn_fwd"]
            want = last_logits(params, tokens)
            assert launches == cfg.n_layers
            # the same ops and kernels on the same card as the local call
            assert got.dtype == torch.float32 and torch.equal(got, want.cpu())
            for leaf in torch.utils._pytree.tree_leaves(remote_params):
                leaf.free()
            assert dev.info()["resident_bytes"] == 0
        finally:
            dev.close()
    finally:
        worker.stop()


def test_worker_device_work_beside_a_hosted_engine_capturing_lazily(gen):
    """One worker process: an engine with an n-gram draft (so verify and
    wider decode buckets are captured lazily, on the engine's stepper
    thread) streams speculative GENERATEs to one connection while another
    loops PUT, EXECUTE and FETCH of a small exported program, whose
    copies, module calls and fetches run on the worker's copy pool,
    dispatcher thread and handler thread.  The loop is running before the
    first request arrives, and a short switch interval interleaves the
    threads finely.  No thread may fail, every request's tokens equal
    generate's in f32, and every EXECUTE equals the same product on the
    card."""
    import random
    import sys
    import threading
    import time

    from tensorfusion_tpu_torch.remoting import RemoteDevice, RemoteVTPUWorker
    from tensorfusion_tpu_torch.serving import (LlamaRunner, NGramDraft,
                                                ServingEngine)

    cfg = llama.LlamaConfig(vocab_size=1024, dim=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, ffn_dim=512, dtype=torch.float32)
    params = llama.init_params(cfg, gen)
    runner = LlamaRunner(params, cfg, num_blocks=512, block_size=4)
    runner.warmup(max_batch=1, prompt_len=16, chunk=16)   # decode, batch 1
    engine = ServingEngine(runner, max_batch=4, prefill_chunk_tokens=32,
                           draft=NGramDraft(n=2), spec_k=3)
    rng = random.Random(4)
    # repeated phrases, so the draft proposes and verify steps run
    requests = [([rng.randrange(cfg.vocab_size) for _ in range(8)]
                 * rng.randrange(4, 12), rng.randrange(12, 24))
                for _ in range(12)]
    w = torch.randn((256, 256), generator=gen, device="cuda")
    outs, failures = {}, []
    looping, done = threading.Event(), threading.Event()
    executes = [0]

    hook, interval = threading.excepthook, sys.getswitchinterval()
    threading.excepthook = lambda args: failures.append(
        f"{args.thread.name}: {args.exc_type.__name__}: {args.exc_value}")
    worker = RemoteVTPUWorker(engine=engine, device="cuda")
    worker.start()
    gen_dev = RemoteDevice(worker.url, timeout_s=120)
    exec_dev = RemoteDevice(worker.url, timeout_s=120)

    def generate(i):
        prompt, new = requests[i]
        try:
            outs[i] = gen_dev.generate(prompt, new)["tokens"]
        except Exception as e:  # noqa: BLE001 - reported below
            failures.append(f"generate {i}: {type(e).__name__}: {e}")

    def execute_loop():
        try:
            remote = exec_dev.remote_jit(lambda w, x: torch.tanh(x @ w))
            wref = exec_dev.put(w.cpu())
            while not done.is_set():
                x = torch.randn((64, 256), generator=gen, device="cuda")
                xref = exec_dev.put(x.cpu())
                got = remote(wref, xref)
                torch.testing.assert_close(xref.fetch(), x.cpu(), rtol=0, atol=0)
                xref.free()
                torch.testing.assert_close(got, torch.tanh(x @ w).cpu(),
                                           rtol=1e-4, atol=1e-5)
                executes[0] += 1
                if executes[0] == 20:
                    looping.set()
            wref.free()
        except Exception as e:  # noqa: BLE001 - reported below
            failures.append(f"execute loop: {type(e).__name__}: {e}")
        finally:
            looping.set()

    looper = threading.Thread(target=execute_loop)
    try:
        looper.start()
        assert looping.wait(120)
        sys.setswitchinterval(1e-4)
        threads = []
        for i in range(len(requests)):
            threads.append(threading.Thread(target=generate, args=(i,)))
            threads[-1].start()
            if i % 3 == 2:
                time.sleep(0.05)      # waves: later prompts join verifying ones
        for t in threads:
            t.join(timeout=180)
    finally:
        sys.setswitchinterval(interval)
        done.set()
        looper.join(timeout=60)
        gen_dev.close()
        exec_dev.close()
        worker.stop()
        threading.excepthook = hook
    assert not failures, failures
    assert not looper.is_alive() and not any(t.is_alive() for t in threads)
    assert len(outs) == len(requests) and executes[0] > 20
    assert any(k[0] == "verify" for k in runner.graphs)
    assert engine.snapshot()["spec"]["steps"] > 0
    for i, (prompt, new) in enumerate(requests):
        want = llama.generate(params, torch.tensor([prompt], device="cuda"),
                              new, cfg)[0].tolist()
        assert outs[i] == want, i


def test_worker_hosted_engine_serves_generate_and_kv_ship_on_the_card(gen):
    """GENERATE and KV_SHIP into a worker-hosted engine on the card, at
    bf16 page size large enough for the ephemeral-PUT route: f32 tokens
    equal generate's, KV_SHIP's equal GENERATE's, the pool is charged
    while the worker serves and released at stop, and the page uploads
    leave nothing resident."""
    from tensorfusion_tpu_torch.remoting import RemoteDevice, RemoteVTPUWorker
    from tensorfusion_tpu_torch.serving import (LlamaRunner, PrefillPool,
                                                RemoteKVShipper, ServingEngine)
    from tensorfusion_tpu_torch.serving.disagg import _Job

    cfg = llama.LlamaConfig(vocab_size=1024, dim=512, n_layers=2, n_heads=4,
                            n_kv_heads=2, ffn_dim=1024, dtype=torch.float32)
    params = llama.init_params(cfg, gen)
    runner = LlamaRunner(params, cfg, num_blocks=257, block_size=16)
    engine = ServingEngine(runner, max_batch=4, prefill_chunk_tokens=64)
    pool = PrefillPool([LlamaRunner(params, cfg, num_blocks=257,
                                    block_size=16)], inline=True)
    prompt = torch.randint(0, cfg.vocab_size, (300,), generator=gen,
                           device="cuda").tolist()
    want = llama.generate(params, torch.tensor([prompt], device="cuda"), 12,
                          cfg)[0].tolist()
    worker = RemoteVTPUWorker(engine=engine, device="cuda")
    worker.start()
    try:
        assert worker.resident_bytes == runner.nbytes
        dev = RemoteDevice(worker.url, timeout_s=120)
        try:
            assert dev.generate(prompt, 12)["tokens"] == want
            job = _Job(None, prompt, 1)
            while pool.workers[0].advance(job) is False:
                pass
            payload = pool.workers[0].payload(job)
            assert payload["k"].numel() * 4 >= 256 << 10   # rides PUTs
            shipper = RemoteKVShipper(worker.url)
            try:
                assert shipper.ship(prompt, payload, 12)["tokens"] == want
            finally:
                shipper.close()
            assert dev.info()["resident_bytes"] == runner.nbytes
        finally:
            dev.close()
    finally:
        worker.stop()
    assert worker.resident_bytes == 0
    assert engine.snapshot()["kv"]["used"] == 0


def test_fabric_rings_beside_a_hosted_engine_capturing_lazily(gen):
    """Three workers on the card in one process: the first hosts an
    engine with an n-gram draft (verify and wider decode buckets captured
    lazily on its stepper thread) that streams speculative GENERATEs,
    while fabric rings over all three run back to back.  Each ring's
    flush waits on peer deposits and acks that arrive on other handler
    threads, never inside the device gate, so no capture can deadlock
    against it.  Every ring's total equals its arithmetic (f32 adds in
    ring order), every request's tokens equal generate's in f32, and no
    thread fails."""
    import random
    import threading

    from tensorfusion_tpu_torch.remoting import (FederatedDevice,
                                                 RemoteDevice,
                                                 RemoteVTPUWorker)
    from tensorfusion_tpu_torch.serving import (LlamaRunner, NGramDraft,
                                                ServingEngine)

    cfg = llama.LlamaConfig(vocab_size=1024, dim=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, ffn_dim=512, dtype=torch.float32)
    params = llama.init_params(cfg, gen)
    runner = LlamaRunner(params, cfg, num_blocks=512, block_size=4)
    engine = ServingEngine(runner, max_batch=4, prefill_chunk_tokens=32,
                           draft=NGramDraft(n=2), spec_k=3)
    rng = random.Random(5)
    requests = [([rng.randrange(cfg.vocab_size) for _ in range(8)]
                 * rng.randrange(4, 12), rng.randrange(12, 24))
                for _ in range(9)]
    workers = [RemoteVTPUWorker(engine=engine, device="cuda")] + \
        [RemoteVTPUWorker(device="cuda") for _ in range(2)]
    for w in workers:
        w.start()
    gen_dev = RemoteDevice(workers[0].url, timeout_s=120)
    fed = FederatedDevice([w.url for w in workers], ring=True, timeout_s=120)
    outs, failures, rings = {}, [], [0]
    done = threading.Event()

    def generate(i):
        prompt, new = requests[i]
        try:
            outs[i] = gen_dev.generate(prompt, new)["tokens"]
        except Exception as e:  # noqa: BLE001 - reported below
            failures.append(f"generate {i}: {type(e).__name__}: {e}")

    def ring_loop():
        # a client that holds no device: its partials and their expected
        # total live on the CPU (device work on this thread would itself
        # race the engine's captures), and IEEE f32 adds agree bit for bit
        host_gen = torch.Generator().manual_seed(6)
        try:
            assert fed.fabric_supported()
            while not done.is_set() or rings[0] < 3:
                parts = [torch.randn((256, 1024), generator=host_gen)
                         for _ in workers]
                want = parts[0]
                for p in parts[1:]:
                    want = p + want
                handles = [dev.put(p) for dev, p in zip(fed.workers, parts)]
                out = fed.all_reduce(handles, free_src=True)
                assert torch.equal(out["value"], want)
                rings[0] += 1
        except Exception as e:  # noqa: BLE001 - reported below
            failures.append(f"ring loop: {type(e).__name__}: {e}")

    looper = threading.Thread(target=ring_loop)
    try:
        looper.start()
        threads = [threading.Thread(target=generate, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    finally:
        done.set()
        looper.join(timeout=120)
        gen_dev.close()
        fed.close()
        for w in workers:
            w.stop()
    assert not failures, failures
    assert not looper.is_alive() and rings[0] >= 3
    assert fed.fed_snapshot()["client_relay_bytes"] == 0
    assert any(k[0] == "verify" for k in runner.graphs)
    for i, (prompt, new) in enumerate(requests):
        want = llama.generate(params, torch.tensor([prompt], device="cuda"),
                              new, cfg)[0].tolist()
        assert outs[i] == want, i


def test_migration_between_cuda_workers_executes_bit_equal(gen):
    """A tenant's weights, compiled flash forward and a step_resident
    state migrate between two workers on the card (two pre-copy rounds,
    freeze, commit); the same program on the same buffer ids gives the
    source's pre-freeze result bit for bit, the state arrives exactly,
    and the source holds nothing after commit."""
    from tensorfusion_tpu_torch.remoting import (RemoteBuffer, RemoteDevice,
                                                 RemoteVTPUWorker)

    cfg = llama.LlamaConfig(vocab_size=1024, dim=512, n_layers=3, n_heads=4,
                            n_kv_heads=2, ffn_dim=1024, dtype=torch.bfloat16,
                            attn_impl="flash")
    params = llama.init_params(cfg, gen)
    host = torch.utils._pytree.tree_map(lambda t: t.cpu(), params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                           device="cuda").cpu()

    def last_logits(p, t):
        return llama.forward(p, t, cfg)[:, -1]

    src, tgt = RemoteVTPUWorker(device="cuda"), RemoteVTPUWorker(device="cuda")
    for w in (src, tgt):
        w.start()
    ten, orch, tdev = (RemoteDevice(u, timeout_s=120)
                       for u in (src.url, src.url, tgt.url))
    try:
        rparams = torch.utils._pytree.tree_map(ten.put, host)
        layer_fn = ten.remote_jit(lambda layer, x: llama._layer(cfg, layer, x))
        state = ten.put(params["tok_emb"][tokens.cuda().long()].cpu())
        state = layer_fn.step_resident(rparams["layers"][0], state, free=state)
        state.fetch()
        assert orch.snapshot_delta(tgt.url)["round"] == 1
        state = layer_fn.step_resident(rparams["layers"][0], state, free=state)
        want_state = state.fetch()
        assert orch.snapshot_delta(tgt.url)["buffers"] == 1
        ops.reset_launch_counts()
        want = ten.remote_jit(last_logits)(rparams, tokens)
        assert ops.launch_counts()["flash_attn_fwd"] == cfg.n_layers
        assert orch.migrate_freeze()["dirty_buffers"] == 0
        assert orch.migrate_commit()["rounds"] == 3
        assert src.resident_bytes == 0
        moved = torch.utils._pytree.tree_map(
            lambda h: RemoteBuffer(tdev, h.buf_id, h.shape, h.dtype), rparams)
        ops.reset_launch_counts()
        got = tdev.remote_jit(last_logits)(moved, tokens)
        assert ops.launch_counts()["flash_attn_fwd"] == cfg.n_layers
        assert torch.equal(got, want)
        sid = ten.info()["migration"]["moved"]["ids"][state.buf_id]
        assert torch.equal(RemoteBuffer(tdev, sid, state.shape,
                                        state.dtype).fetch(), want_state)
        assert tgt.resident_bytes == sum(
            t.numel() * t.element_size()
            for t in torch.utils._pytree.tree_leaves(host)) + \
            want_state.numel() * want_state.element_size()
    finally:
        for d in (ten, orch, tdev):
            d.close()
        for w in (src, tgt):
            w.stop()


# -- the mesh: ranks share the one card over gloo --------------------------------


@pytest.fixture(scope="module")
def cuda_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensorfusion_tpu_torch.parallel import RankGroup

    with RankGroup(4, device="cuda", backend="gloo", timeout_s=600) as group:
        yield group


def _mesh_cfg():
    return dataclasses.replace(llama.LlamaConfig.tiny("flash"), dim=256, n_heads=4,
                               n_kv_heads=2, ffn_dim=512, vocab_size=512,
                               dtype=torch.bfloat16)


def test_sharded_train_step_on_one_card_over_gloo(cuda_ranks):
    """fsdp2 x tp2 on four ranks of cuda:0: the flash kernels run on each
    rank's local heads, and the losses follow one device's (bf16)."""
    import torch_rank_tasks as tasks

    cfg = _mesh_cfg()
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 129), generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                               device="cuda")
    step, init_opt = llama.make_train_step(cfg, device="cuda")
    opt = init_opt(params)
    want = [float(step(params, opt, batch)[2]) for _ in range(2)]
    got = cuda_ranks.run(tasks.gpu_train_losses, {"fsdp": 2, "tp": 2}, cfg, 0,
                         {k: v.cpu() for k, v in batch.items()}, 2)
    for res in got:
        assert res["launches"] == {k.name: cfg.n_layers * 2 for k in ops.KERNELS}
        for a, b in zip(res["losses"], want):
            assert abs(a - b) <= 2e-2 * abs(b), (res["losses"], want)


def test_ring_attention_on_one_card_matches_the_flash_kernels(cuda_ranks):
    import torch_rank_tasks as tasks

    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, w = (torch.randn((1, 4, 1024, 64), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    qf, kf, vf = (x.clone().requires_grad_(True) for x in (q, k, v))
    ref = flash_attention(qf, kf, vf, causal=True)
    ref_grads = torch.autograd.grad(ref, (qf, kf, vf), grad_outputs=w)
    got = cuda_ranks.run(tasks.gpu_ring, {"sp": 4}, q.cpu(), k.cpu(), v.cpu(), w.cpu())
    for out, *grads in got:
        assert (out.float() - ref.cpu().float()).abs().max().item() < 2e-2
        for g, r in zip(grads, ref_grads):
            r = r.cpu().float()
            assert ((g.float() - r).abs().mean() / r.abs().mean()).item() < 2e-2


def test_expert_parallel_moe_on_one_card_matches_one_device(cuda_ranks):
    import torch_rank_tasks as tasks
    from tensorfusion_tpu_torch.models import moe

    cfg = dataclasses.replace(moe.MoEConfig.tiny(n_experts=8), capacity_factor=0.5,
                              dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64),
                           generator=torch.Generator(device="cuda").manual_seed(3),
                           device="cuda")
    params = moe.init_moe_params(cfg, torch.Generator(device="cuda").manual_seed(4),
                                 device="cuda")
    stats = {}
    with torch.no_grad():
        want = moe.moe_forward(params, tokens, cfg, stats=stats).cpu()
    got = cuda_ranks.run(tasks.gpu_moe, {"ep": 4}, cfg, 4, tokens.cpu())
    assert stats["dropped"] > 0
    for res in got:
        assert res["dropped"] == stats["dropped"]
        err = (res["logits"] - want).abs().max().item()
        assert err <= 2e-2 * want.abs().max().item(), err


def test_nccl_with_more_ranks_than_cards_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tensorfusion_tpu_torch.parallel import RankGroup

    with pytest.raises(ValueError, match="one card a rank"):
        RankGroup(torch.cuda.device_count() + 1, device="cuda", backend="nccl")


# -- the node agent over the real NVML -------------------------------------------


def test_nvml_provider_agrees_with_torch(gen):
    from tensorfusion_tpu_torch.hypervisor import Provider, _build

    p = Provider(str(_build.provider_path()))
    p.init()
    try:
        chips = p.enumerate()
        assert len(chips) == torch.cuda.device_count()
        for i, chip in enumerate(chips):
            name = torch.cuda.get_device_name(i)
            assert p.partition_templates(chip.chip_id)[0].name == f"{name} whole card"
            total = torch.cuda.get_device_properties(i).total_memory
            assert abs(chip.hbm_bytes - total) <= 0.01 * total
        metrics = p.chip_metrics([c.chip_id for c in chips])
        assert all(m.power_watts > 0 and m.extra["power_limit_w"] > 0 for m in metrics)
    finally:
        p.shutdown()


_TENANT = """
import json, os, sys, time
sys.path.insert(0, {repo!r})
import torch
from tensorfusion_tpu_torch.client.runtime import VTPUClient
from tensorfusion_tpu_torch.hypervisor import cuda_hook_binding
log = open(sys.argv[1] + ".log", "a", buffering=1)   # the backend gives no stdout
os.dup2(log.fileno(), 1)
os.dup2(log.fileno(), 2)
client = VTPUClient()
hook = cuda_hook_binding.loaded()
out = open(sys.argv[1], "a", buffering=1)
if not client.attached:
    out.write(json.dumps({{"attached": False}}) + "\\n")
    sys.exit(3)
step = client.meter(lambda x: (x @ x).relu())
x = torch.randn(2048, 2048, device="cuda")
out.write(json.dumps({{"by_hook": client.hook is not None}}) + "\\n")
stop = sys.argv[1] + ".stop"
while not os.path.exists(stop):
    step(x)
    torch.cuda.synchronize()
    out.write(json.dumps({{"launches": client.launches}}) + "\\n")
    time.sleep(0.02)
report = hook.report()
out.write(json.dumps({{"stopped": client.launches, "charges": report["charges"],
                      "charged_mflops": report["charged_mflops"]}}) + "\\n")
while True:
    time.sleep(1)
"""


def test_soft_tenant_through_the_daemon_is_charged_for_every_call(gen, limiter_lib,
                                                                  tmp_path):
    """The port's daemon over NVML spawns a soft tenant with its
    allocation env, the launch hook preloaded; told to stop after a few
    calls, its segment holds exactly the hook's charges for them (every
    call's launches, in device time), while the client counted every call
    and charged the limiter nothing."""
    import json
    import os
    import subprocess
    import sys
    import time
    import urllib.request

    from tensorfusion_tpu_torch.hypervisor import ShmView

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (tmp_path / "tenant.py").write_text(_TENANT.format(repo=repo))
    calls = tmp_path / "calls.jsonl"
    daemon = subprocess.Popen(
        [sys.executable, "-m", "tensorfusion_tpu_torch.hypervisor",
         "--limiter", limiter_lib, "--shm-base", str(tmp_path / "shm"),
         "--state-dir", str(tmp_path / "state"), "--snapshot-dir", str(tmp_path / "snap"),
         "--port", "0", "--port-file", str(tmp_path / "port"), "--api-token", "t"],
        cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)

    def api(path, method="GET", body=None):
        url = f"http://127.0.0.1:{(tmp_path / 'port').read_text()}"
        req = urllib.request.Request(url + path, method=method,
                                     data=json.dumps(body).encode() if body else None,
                                     headers={"X-TPF-Token": "t"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    def why():
        """The tenant's records and its own log, for a failing assertion."""
        return "\n".join(p.read_text()[-3000:] for p in (calls, tmp_path / "calls.jsonl.log")
                         if p.exists())

    def lines():
        out = []
        for line in calls.read_text().splitlines() if calls.exists() else []:
            try:
                out.append(json.loads(line))
            except ValueError:      # a line still being written
                pass
        return out

    try:
        deadline = time.time() + 120
        while not ((tmp_path / "port").exists() and (tmp_path / "port").read_text()):
            assert time.time() < deadline and daemon.poll() is None
            time.sleep(0.2)
        time.sleep(0.5)
        chip = api("/api/v1/devices")[0]["info"]["chip_id"]
        env = api("/api/v1/workers", "POST", {
            "namespace": "t", "name": "w", "isolation": "soft",
            "devices": [{"chip_id": chip, "duty_percent": 50, "hbm_bytes": 4 << 30}],
            "command": [sys.executable, str(tmp_path / "tenant.py"), str(calls)]})[
                "status"]["env"]
        view = ShmView(env["TPF_SHM_PATH"])
        while len(lines()) < 6:
            assert time.time() < deadline, why()
            time.sleep(0.2)
        (tmp_path / "calls.jsonl.stop").touch()
        # the tenant launches only inside its calls: once it has stopped, its
        # segment and its last record describe the same launches
        while not any("stopped" in line for line in lines()):
            assert time.time() < deadline, why()
            time.sleep(0.1)
        dev = view.read().devices[0]
        last = lines()[-1]
        made = [line for line in lines() if "launches" in line]
        assert lines()[0] == {"by_hook": True}, why()
        assert last["stopped"] == len(made) == made[-1]["launches"], why()
        assert dev.launches == last["charges"] >= 2 * len(made), (dev, why())
        assert dev.total_charged_mflop == last["charged_mflops"] > 0, (dev, why())
        view.close()
        api("/api/v1/workers/t/w", "DELETE")
        assert not os.path.exists(env["TPF_SHM_PATH"])
    finally:
        daemon.terminate()
        daemon.wait(timeout=30)


def test_sharded_worker_under_the_daemon_on_the_card(gen, limiter_lib, tmp_path):
    """The sharded remote EXECUTE as one metered tenant on the card: the
    daemon spawns ``python -m tensorfusion_tpu_torch.remoting --ranks 2``
    with the launch hook preloaded.  (a) A bf16 flash Llama's last-position
    logits, weights resident and replicated, tokens batch-sharded, within
    the remote phase's bf16 rule of the local call, with the flash kernel
    launched on both ranks; (b) an MLP with column- and row-sharded
    resident weights within the same rule, a shard fetched per device bit
    for bit, nothing resident after free and per-call shards; (c) the
    segment lists the worker and both ranks and holds exactly their hook
    reports' charges."""
    import json
    import os
    import subprocess
    import sys
    import time
    import urllib.request

    from tensorfusion_tpu_torch import remoting
    from tensorfusion_tpu_torch.hypervisor import ShmView

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    daemon = subprocess.Popen(
        [sys.executable, "-m", "tensorfusion_tpu_torch.hypervisor",
         "--limiter", limiter_lib, "--shm-base", str(tmp_path / "shm"),
         "--state-dir", str(tmp_path / "state"), "--snapshot-dir", str(tmp_path / "snap"),
         "--port", "0", "--port-file", str(tmp_path / "port"), "--api-token", "t"],
        cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)

    def api(path, method="GET", body=None):
        url = f"http://127.0.0.1:{(tmp_path / 'port').read_text()}"
        req = urllib.request.Request(url + path, method=method,
                                     data=json.dumps(body).encode() if body else None,
                                     headers={"X-TPF-Token": "t"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), attn_impl="flash",
                              dtype=torch.bfloat16, dim=256, n_heads=2, n_kv_heads=2,
                              ffn_dim=512, max_seq_len=256)
    params = llama.init_params(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen, device="cuda")

    def last(p, t, c=cfg):
        return llama.forward(p, t, c)[:, -1].float()

    want = last(params, tokens)
    exact = last(torch.utils._pytree.tree_map(lambda t: t.float(), params), tokens,
                 dataclasses.replace(cfg, dtype=torch.float32, attn_impl="full"))
    full = last(params, tokens, dataclasses.replace(cfg, attn_impl="full"))
    host = torch.utils._pytree.tree_map(lambda t: t.cpu(), params)
    try:
        deadline = time.time() + 240
        while not ((tmp_path / "port").exists() and (tmp_path / "port").read_text()):
            assert time.time() < deadline and daemon.poll() is None
            time.sleep(0.2)
        time.sleep(0.5)
        chip = api("/api/v1/devices")[0]["info"]["chip_id"]
        env = api("/api/v1/workers", "POST", {
            "namespace": "t", "name": "ranks", "isolation": "soft",
            "devices": [{"chip_id": chip, "duty_percent": 100, "hbm_bytes": 16 << 30}],
            "command": [sys.executable, "-m", "tensorfusion_tpu_torch.remoting",
                        "--ranks", "2", "--host", "127.0.0.1", "--port", "0",
                        "--port-file", str(tmp_path / "worker.port")]})["status"]["env"]
        while not (tmp_path / "worker.port").exists():
            assert time.time() < deadline and daemon.poll() is None
            time.sleep(0.2)
        dev = remoting.RemoteDevice(f"tcp://127.0.0.1:{(tmp_path / 'worker.port').read_text()}",
                                    timeout_s=300)
        view = ShmView(env["TPF_SHM_PATH"])
        try:
            rparams = torch.utils._pytree.tree_map(dev.put, host)
            remote = dev.remote_jit(last, in_specs=(None, ("b",)), out_specs=("b",))
            got = remote(rparams, tokens.cpu()).cuda()
            assert rel(got, exact) <= 1.5 * rel(full, exact), (rel(got, exact),
                                                                rel(full, exact))
            for leaf in torch.utils._pytree.tree_leaves(rparams):
                leaf.free()
            mlp = dev.remote_jit(
                lambda w1, w3, w2, x: llama._mlp({"w_gate": w1, "w_up": w3, "w_down": w2}, x),
                in_specs=((None, "m"), (None, "m"), ("m", None), None), out_specs=None)
            ws = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) / 16
                  for s in ((256, 1024), (256, 1024), (1024, 256))]
            x = torch.randn((128, 256), generator=gen, device="cuda").to(torch.bfloat16)
            local = llama._mlp({"w_gate": ws[0], "w_up": ws[1], "w_down": ws[2]}, x)
            exact_mlp = llama._mlp({"w_gate": ws[0].float(), "w_up": ws[1].float(),
                                    "w_down": ws[2].float()}, x.float())
            hw = [w.cpu() for w in ws]
            refs = [mlp.upload_arg(i, w, *hw, x.cpu()) for i, w in enumerate(hw)]
            got = mlp(*refs, x.cpu()).cuda()
            assert rel(got, exact_mlp) <= 1.5 * rel(local, exact_mlp)
            ent = refs[2].layout[1]
            _, meta, bufs = dev._rpc("FETCH", {"buf_id": refs[2].shard_ids[1],
                                               "device_id": 1}, [])
            assert torch.equal(bufs[0], hw[2][tuple(slice(a, b) for a, b in ent["slices"])])
            for ref in refs:
                ref.free()
            mlp(*hw, x.cpu())
            info = dev.info(ranks=True)
            assert not any(info["resident_bytes_per_device"].values())
            ranks = info["ranks"]
            assert all(r["launch_counts"]["flash_attn_fwd"] == cfg.n_layers
                       for r in ranks["ranks"])
            seg = view.read()
            reports = [ranks["worker"]["hook"]] + [r["hook"] for r in ranks["ranks"]]
            assert sorted(seg.pids) == sorted([ranks["worker"]["pid"]]
                                              + [r["pid"] for r in ranks["ranks"]])
            assert seg.devices[0].launches == sum(r["charges"] for r in reports) > 0
            assert seg.devices[0].total_charged_mflop == sum(
                r["charged_mflops"] for r in reports)
        finally:
            view.close()
            dev.close()
        api("/api/v1/workers/t/ranks", "DELETE")
    finally:
        daemon.terminate()
        daemon.wait(timeout=30)
