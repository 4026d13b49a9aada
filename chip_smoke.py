#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (tensorfusion_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one Hopper card, nvcc
and make.  It builds the kernels (flash forward, flash backward) and
libtpf_limiter.so from the checkout (failing if ptxas reports a spill),
holds every kernel against its plain PyTorch version on the card and
times it at the main path's shape and at a long one, then drives the
port's two paths at Llama-3-8B width (random weights from fixed seeds),
each through the
metered client with the kernel launch counts set to 0 just before it and
read just after: serving (greedy requests, 32 layers) and training
(AdamW steps, 8 layers, batch 4 x 1024).  It checks the answers of both
(tokens and logits; gradients against the dense attention path) and ends
with the metered train-step bench (``tensorfusion_tpu_torch.bench_train``).
Each phase prints one JSON line; any failure raises and exits non-zero.
The line before the last two is the kernel table, the line before the
last is nvidia-smi's name and power limit, and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Without a CUDA device, or outside a checkout, it exits non-zero and
prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"
DEVICE = "cuda"

MAIN_SHAPES = ((4, 1024), (8, 512))        # serving requests: batch x prompt
STEPS = 32
TRAIN_LAYERS = 8                           # AdamW state of 32 would not fit
TRAIN_SHAPE = (4, 1024)                    # train batch x sequence
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
LONG_SHAPE = (32, 4096, 128)               # [B*H, T, D]: more tiles per block


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(torch, fn, iters: int = 10) -> float:
    """Mean device time of one call, CUDA events around ``iters`` calls."""
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phases -------------------------------------------------------------------


def phase_device(torch, build, hardware):
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"{name} has capability {cap}; the kernels are sm_90a")
    smi = hardware.nvidia_smi()
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=name, capability=list(cap), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         nvcc=[l for l in nvcc.splitlines() if "release" in l][0].strip())
    return name, smi


def phase_build(torch, build, fa):
    """The kernels (one nvcc each, in parallel) and the limiter, together;
    then what each kernel holds (ptxas, dynamic shared memory) and what a
    launch's tensor maps cost on the host."""
    t0 = time.perf_counter()
    make = subprocess.Popen(["make", "-C", str(REPO / "native"),
                             "build/libtpf_limiter.so"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    limiter = {}

    def wait_make():
        limiter["log"], _ = make.communicate()
        limiter["s"] = time.perf_counter() - t0

    waiter = threading.Thread(target=wait_make)
    waiter.start()
    try:
        kernel_s = build.build_all()
    finally:
        waiter.join()
    if make.returncode != 0:
        raise RuntimeError(f"libtpf_limiter.so did not build:\n{limiter['log']}")
    ptxas = {n: build.ptxas_summary(build.ptxas_report(n)) for n in build.SOURCES}
    spills = {f"{n}: {k}": v["spill_bytes"] for n, kernels in ptxas.items()
              for k, v in kernels.items() if v["spill_bytes"]}
    emit("build", kernels_s=kernel_s, limiter_s=limiter["s"],
         libraries=[str(build.library_path(n).relative_to(REPO))
                    for n in build.SOURCES], ptxas=ptxas,
         dynamic_smem_bf16=_dynamic_smem(fa),
         tensor_map_encode_us=_encode_us(torch, fa))
    if spills:
        raise RuntimeError(f"kernels spill registers (bytes): {spills}")
    return REPO / "native" / "build" / "libtpf_limiter.so"


def _dynamic_smem(fa):
    """Dynamic shared memory of one block of each bf16 kernel per head
    dim, as the libraries report it (ptxas counts static memory only)."""
    fwd, bwd = fa._library("flash_attn_fwd"), fa._library("flash_attn_bwd")
    dims = (16, 32, 64, 128)
    return {"flash_attn_fwd": {d: fwd.tpf_flash_attn_fwd_smem(d) for d in dims},
            "flash_attn_bwd_dq": {d: bwd.tpf_flash_attn_bwd_smem(d, 0) for d in dims},
            "flash_attn_bwd_dkv": {d: bwd.tpf_flash_attn_bwd_smem(d, 1) for d in dims}}


def _encode_us(torch, fa):
    """Host microseconds of one tensor-map encode of a [128, 1024, 128]
    bf16 tensor, the mean of 1000 (a forward launch encodes 3, a dQ or
    dK/dV launch 4)."""
    x = torch.empty((128, 1024, 128), dtype=torch.bfloat16, device="cuda")
    ns = fa._library("flash_attn_fwd").tpf_tensor_map_encode_ns(x.data_ptr(), 128, 1024, 128, 1000)
    if ns < 0:
        raise RuntimeError("cuTensorMapEncodeTiled failed")
    return ns / 1e3


def phase_kernels(torch, fa, rates):
    """The kernel against its plain version on the card (out and lse), then
    times at the main-path shape and at LONG_SHAPE."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(bh, t, d, dtype):
        return [torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)
                for _ in range(3)]

    # T = 1000 is ragged and spans several stages of the kernels' rings
    cases = [(bh, t, d, causal, dtype)
             for dtype in (torch.bfloat16, torch.float32)
             for t, bh in ((128, 8), (1000, 4), (1024, 4), (4096, 2))
             for d in (64, 128) for causal in (True, False)]
    # the main path's own shapes: batch * heads, prompt, head_dim
    cases += [(b * 32, t, 128, True, torch.bfloat16) for b, t in MAIN_SHAPES]
    worst = {"bf16_out": 0.0, "f32_out_excess": 0.0, "lse": 0.0}
    for bh, t, d, causal, dtype in cases:
        q, k, v = qkv(bh, t, d, dtype)
        out, lse = fa.flash_fwd_cuda(q, k, v, d ** -0.5, causal)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, d ** -0.5, causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        lse_err = (lse - ref_lse).abs().max().item()
        label = f"bh={bh} t={t} d={d} causal={causal} {dtype}"
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
            raise RuntimeError(f"kernel gave non-finite values at {label}")
        if dtype == torch.bfloat16:
            # bf16 rounding floor, tests/test_ops.py:35-50
            worst["bf16_out"] = max(worst["bf16_out"], err.max().item())
            ok = err.max().item() < 2e-2
        else:
            # f32 at rtol 2e-4 / atol 2e-5, tests/test_ops.py:13-20
            excess = (err - (2e-5 + 2e-4 * ref.abs())).max().item()
            worst["f32_out_excess"] = max(worst["f32_out_excess"], excess)
            ok = excess <= 0
        worst["lse"] = max(worst["lse"], lse_err)
        if not ok or lse_err >= 1e-4:
            raise RuntimeError(f"kernel disagrees with its plain version at "
                               f"{label}: out {err.max().item():.3g}, lse {lse_err:.3g}")
    emit("kernels_check", cases=len(cases), worst=worst,
         tolerance="bf16 max|out err| < 2e-2; f32 rtol 2e-4 atol 2e-5; lse atol 1e-4")

    # times at the first request's shape, [B*H, T, D] = [128, 1024, 128],
    # which the kernels line carries, then at the long shape
    b, t = MAIN_SHAPES[0]
    rows = [_fwd_time_row(torch, fa, rates, qkv, shape)
            for shape in ((b * 32, t, 128), LONG_SHAPE)]
    for row in rows:
        emit("kernels_time", **row)
    return rows[0]


def _fwd_time_row(torch, fa, rates, qkv, shape):
    """The forward's kernels-line row at a bf16 causal [B*H, T, D], B*H
    taken as B x 32 heads for the library call."""
    bh, t, d = shape
    q, k, v = qkv(bh, t, d, torch.bfloat16)
    scale = d ** -0.5
    out, _ = fa.flash_fwd_cuda(q, k, v, scale, True)
    ref, _ = fa.flash_attention_plain(q, k, v, scale, True)
    max_abs_err = (out.float() - ref.float()).abs().max().item()
    del out, ref
    ms = time_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, scale, True), 20)
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, scale, True), 5)
    q4, k4, v4 = (x.view(bh // 32, 32, t, d) for x in (q, k, v))
    library_ms = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 20)
    return _time_row("flash_attn_fwd", [bh, t, d], rates, ms, plain_ms,
                     library_ms, max_abs_err, per_pair=4,
                     moved=4 * bh * t * d * 2 + bh * t * 4,
                     plain="flash_attention_plain (out, lse)",
                     library="scaled_dot_product_attention (out)")


def _time_row(name, shape, rates, ms, plain_ms, library_ms, max_abs_err,
              per_pair, moved, plain, library):
    """A kernels-line row at a bf16 causal shape [BH, T, D]: the least
    time for the same work is the larger of ``moved`` bytes (each input
    read once, each output written once) over the memory rate and
    ``per_pair``·D FLOPs for each of the T(T+1)/2 visible query-key pairs
    over the bf16 rate.  ``plain`` and ``library`` name the calls timed
    for ``plain_ms`` and ``library_ms`` and what each computes."""
    bh, t, d = shape
    flops = per_pair * bh * d * t * (t + 1) // 2
    bytes_ms = moved / rates["bytes"] * 1e3
    ops_ms = flops / rates["bf16"] * 1e3
    return {"name": name, "shape": list(shape), "dtype": "bf16", "causal": True,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "plain": plain, "library": library,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "tflops": flops / ms / 1e9}


def phase_bwd_kernels(torch, fa, rates):
    """The dq and dk/dv kernels against the plain backward on the card,
    on the forward's case grid plus the train shape, then times at the
    train shape [B*H, T, D] = [128, 1024, 128] and at LONG_SHAPE."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def inputs(bh, t, d, dtype, causal):
        """q, k, v, dO random; lse and Δ = rowsum(dO·O) from the plain
        forward."""
        q, k, v, do = (torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        out, lse = fa.flash_attention_plain(q, k, v, d ** -0.5, causal)
        delta = (do.float() * out.float()).sum(-1)
        return q, k, v, do, lse, delta

    def run(args, scale, causal):
        dq = fa.flash_bwd_dq_cuda(*args, scale, causal)
        dk, dv = fa.flash_bwd_dkv_cuda(*args, scale, causal)
        return dq, dk, dv

    b, t = TRAIN_SHAPE
    h, d = 32, 128
    cases = [(bh, t_, d_, causal, dtype)
             for dtype in (torch.bfloat16, torch.float32)
             for t_, bh in ((128, 8), (1000, 4), (1024, 4), (4096, 2))
             for d_ in (64, 128) for causal in (True, False)]
    cases.append((b * h, t, d, True, torch.bfloat16))
    worst = {"bf16_mean_rel": 0.0, "f32_excess": 0.0}
    for bh, t_, d_, causal, dtype in cases:
        args = inputs(bh, t_, d_, dtype, causal)
        got = run(args, d_ ** -0.5, causal)
        refs = fa.flash_attention_bwd_plain(*args, d_ ** -0.5, causal)
        torch.cuda.synchronize()
        label = f"bh={bh} t={t_} d={d_} causal={causal} {dtype}"
        for out_name, g, r in zip(("dq", "dk", "dv"), got, refs):
            if not torch.isfinite(g).all():
                raise RuntimeError(f"{out_name} kernel gave non-finite values at {label}")
            err = (g.float() - r.float()).abs()
            if dtype == torch.bfloat16:
                rel = (err.mean() / r.float().abs().mean()).item()
                worst["bf16_mean_rel"] = max(worst["bf16_mean_rel"], rel)
                ok = rel < 2e-2
            else:
                excess = (err - (2e-4 + 2e-4 * r.abs())).max().item()
                worst["f32_excess"] = max(worst["f32_excess"], excess)
                ok = excess <= 0
            if not ok:
                raise RuntimeError(f"{out_name} kernel disagrees with the plain "
                                   f"backward at {label}: max err {err.max().item():.3g}")
    emit("bwd_kernels_check", cases=len(cases), worst=worst,
         tolerance="bf16 mean|err|/mean|ref| < 2e-2 per output, all finite; "
                   "f32 rtol 2e-4 atol 2e-4")

    # times at the train shape, which the kernels line carries, then at
    # the long shape
    rows = _bwd_time_rows(torch, fa, rates, inputs, run, (b * h, t, d))
    long_rows = _bwd_time_rows(torch, fa, rates, inputs, run, LONG_SHAPE)
    for row in [*rows.values(), *long_rows.values()]:
        emit("kernels_time", **row)
    return rows


def _bwd_time_rows(torch, fa, rates, inputs, run, shape):
    """The dq and dK/dV kernels-line rows at a bf16 causal [B*H, T, D], B*H
    taken as B x 32 heads for the library call."""
    bh, t, d = shape
    b, h = bh // 32, 32
    scale = d ** -0.5
    args = inputs(bh, t, d, torch.bfloat16, True)
    dq, dk, dv = run(args, scale, True)
    ref_dq, ref_dk, ref_dv = fa.flash_attention_bwd_plain(*args, scale, True)
    err = {"dq": (dq.float() - ref_dq.float()).abs().max().item(),
           "dkv": max((dk.float() - ref_dk.float()).abs().max().item(),
                      (dv.float() - ref_dv.float()).abs().max().item())}
    del dq, dk, dv, ref_dq, ref_dk, ref_dv
    dq_ms = time_ms(torch, lambda: fa.flash_bwd_dq_cuda(*args, scale, True), 20)
    dkv_ms = time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(*args, scale, True), 20)
    # the plain version computes dq, dk and dv in one call
    plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_plain(*args, scale, True), 5)
    # yardstick: one call of SDPA's flash backward (aten op), which gives
    # dq, dk and dv together, on the same inputs in [B, H, T, D]
    q4, k4, v4, do4 = (x.view(b, h, t, d) for x in args[:4])
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        q4, k4, v4, 0.0, True, False, scale=scale)
    library_ms = time_ms(torch, lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, fwd[0], fwd[1], fwd[2], fwd[3], fwd[4], fwd[5], 0.0, True,
        fwd[6], fwd[7], scale=scale), 20)
    tile = bh * t * d * 2
    # the plain and library calls each give dq, dk and dv at once, so
    # both rows carry the pair's time beside them
    covers = {"plain": "flash_attention_bwd_plain (dq, dk, dv)",
              "library": "aten._scaled_dot_product_flash_attention_backward "
                         "(dq, dk, dv)"}
    rows = {
        "flash_attn_bwd_dq": _time_row(
            "flash_attn_bwd_dq", [bh, t, d], rates, dq_ms, plain_ms, library_ms,
            err["dq"], per_pair=6, moved=5 * tile + 2 * bh * t * 4, **covers),
        "flash_attn_bwd_dkv": _time_row(
            "flash_attn_bwd_dkv", [bh, t, d], rates, dkv_ms, plain_ms, library_ms,
            err["dkv"], per_pair=8, moved=6 * tile + 2 * bh * t * 4, **covers),
    }
    for row in rows.values():
        row["pair_ms"] = dq_ms + dkv_ms
    return rows


def phase_serve(torch, ops, llama, bench_train, limiter_lib, cfg):
    """Greedy requests at Llama-3-8B width, full depth, through the metered
    client and the flash kernel."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    requests = []
    calls = 0
    with bench_train.worker_segment(limiter_lib, WORK / "serve", "serve",
                                    DEVICE) as client:
        serve = client.meter(llama.generate)
        ops.reset_launch_counts()
        for b, t in MAIN_SHAPES:
            prompt = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                                   device=DEVICE)
            timed = {}
            # each signature's first call traces its cost; the second is timed
            for steps in (STEPS, 1):
                for _ in range(2):
                    torch.cuda.synchronize()
                    s0 = time.perf_counter()
                    toks = serve(params, prompt, steps, cfg, device=DEVICE)
                    torch.cuda.synchronize()
                    timed[steps] = time.perf_counter() - s0
                    calls += 1
                    if toks.shape != (b, steps) or not (
                            (toks >= 0) & (toks < cfg.vocab_size)).all():
                        raise RuntimeError(f"bad tokens {tuple(toks.shape)} for "
                                           f"batch {b} x {t}")
            requests.append({
                "batch": b, "prompt": t, "steps": STEPS,
                "prefill_tok_s": b * t / timed[1],
                "decode_tok_s": b * (STEPS - 1) / (timed[STEPS] - timed[1]),
                "request_s": timed[STEPS]})
        launches = ops.launch_counts()
    if launches["flash_attn_fwd"] < cfg.n_layers * calls:
        raise RuntimeError(f"flash kernel ran {launches} times over {calls} "
                           f"requests of {cfg.n_layers} layers")
    if client.launches != calls or client.charged_mflops <= 0:
        raise RuntimeError("requests were not metered")
    emit("serve", dim=cfg.dim, n_layers=cfg.n_layers, vocab=cfg.vocab_size,
         dtype=str(cfg.dtype), attn_impl=cfg.attn_impl, init_s=init_s, requests=requests,
         generate_calls=calls, kernel_launches=launches,
         launches_per_request=launches["flash_attn_fwd"] / calls,
         metered_launches=client.launches, charged_mflops=client.charged_mflops,
         blocked_s=client.blocked_time_s, hbm_charged_bytes=client.hbm_charged_bytes,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return params, launches


def _float(tree):
    if isinstance(tree, dict):
        return {k: _float(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float(v) for v in tree]
    return tree.float()


def phase_serve_check(torch, llama, params, cfg):
    # bf16, full width and depth: the kernel's last-position prefill
    # logits against the dense attention path's, and both against the same
    # weights run in f32 with dense attention.  At 32 layers every bf16
    # path lands about 2e-2 (max |d| / max |logits|) from f32, so the
    # kernel is held to the dense path's own error, with 1.5x room.
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen, device=DEVICE)
    flash, _ = llama.prefill(params, prompt, cfg, cache_len=256)
    full, _ = llama.prefill(params, prompt,
                            dataclasses.replace(cfg, attn_impl="full"), cache_len=256)
    exact, _ = llama.prefill(_float(params), prompt,
                             dataclasses.replace(cfg, dtype=torch.float32,
                                                 attn_impl="full"), cache_len=256)
    if not torch.isfinite(flash).all():
        raise RuntimeError("non-finite prefill logits")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    bf16 = {"flash_vs_full": rel(flash, full), "flash_vs_f32": rel(flash, exact),
            "full_vs_f32": rel(full, exact)}
    if not bf16["flash_vs_f32"] <= 1.5 * bf16["full_vs_f32"]:
        raise RuntimeError(f"bf16 prefill logits: the kernel path is further "
                           f"from f32 than the dense path allows: {bf16}")

    # f32, full width, 2 layers: greedy tokens exactly equal
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=2)
    p32 = llama.init_params(cfg32, torch.Generator(device=DEVICE).manual_seed(2),
                            device=DEVICE)
    prompt = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen, device=DEVICE)
    want = llama.generate(p32, prompt, 8, dataclasses.replace(cfg32, attn_impl="full"),
                          device=DEVICE)
    got = llama.generate(p32, prompt, 8, cfg32, device=DEVICE)
    if not torch.equal(got, want):
        raise RuntimeError(f"f32 greedy tokens differ: {got.tolist()} vs {want.tolist()}")
    emit("serve_check", bf16_prefill_logits_rel=bf16,
         bf16_rule="flash_vs_f32 <= 1.5 * full_vs_f32",
         f32_tokens_equal=True, f32_tokens=got.tolist())


def _train_batch(torch, vocab, shape, seed):
    """Random tokens from ``seed``; the targets are the next tokens."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    b, t = shape
    toks = torch.randint(0, vocab, (b, t + 1), generator=gen, device=DEVICE)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _matmul_params(llama, params) -> int:
    """Parameters of the matrix products: every 2-D weight but tok_emb."""
    return sum(p.numel() for p in llama._leaves(params) if p.dim() == 2) \
        - params["tok_emb"].numel()


def phase_train(torch, ops, llama, bench_train, limiter_lib, cfg, rates):
    """AdamW steps at Llama-3-8B width, 8 layers, batch 4 x 1024, through
    make_train_step, metered on a fresh worker segment: the forward and
    both backward kernels run once per layer per step."""
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(3),
                               device=DEVICE)
    step, init_opt_state = llama.make_train_step(cfg, device=DEVICE)
    opt_state = init_opt_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = _train_batch(torch, cfg.vocab_size, TRAIN_SHAPE, 4)
    probe = params["layers"][0]["attn"]["wq"][:8, :8].clone()
    losses = []
    with bench_train.worker_segment(limiter_lib, WORK / "train", "train",
                                    DEVICE) as client:
        metered = client.meter(step)
        ops.reset_launch_counts()
        s0 = time.perf_counter()
        for _ in range(TRAIN_WARMUP):    # the first call also traces the cost
            params, opt_state, loss = metered(params, opt_state, batch)
            losses.append(loss)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - s0
        s0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            params, opt_state, loss = metered(params, opt_state, batch)
            losses.append(loss)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - s0) / TRAIN_STEPS
        launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [x.item() for x in losses]
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    per_step = {name: n / n_steps for name, n in launches.items()}
    charged = client.charged_mflops // max(client.launches, 1)
    floor = 6 * _matmul_params(llama, params) * TRAIN_SHAPE[0] * TRAIN_SHAPE[1] // 10**6
    row = {"dim": cfg.dim, "n_layers": cfg.n_layers, "vocab": cfg.vocab_size,
           "dtype": str(cfg.dtype), "attn_impl": cfg.attn_impl,
           "batch": TRAIN_SHAPE[0], "seq": TRAIN_SHAPE[1], "init_s": init_s,
           "warmup_steps": TRAIN_WARMUP, "warmup_s": warmup_s,
           "steps": TRAIN_STEPS, "step_ms": step_s * 1e3,
           "tokens_per_s": TRAIN_SHAPE[0] * TRAIN_SHAPE[1] / step_s,
           "charged_mflops_per_step": charged, "floor_mflops_6NT": floor,
           "mfu_pct": charged * 1e6 / step_s / rates["bf16"] * 100.0,
           "kernel_launches": launches, "launches_per_step": per_step,
           "metered_launches": client.launches, "blocked_s": client.blocked_time_s,
           "hbm_charged_bytes": client.hbm_charged_bytes,
           "peak_memory_gb": peak_gb, "losses": losses}
    emit("train", **row)

    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite train loss: {losses}")
    if torch.equal(params["layers"][0]["attn"]["wq"][:8, :8], probe):
        raise RuntimeError("the train steps left the parameters unchanged")
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        if launches[name] != cfg.n_layers * n_steps:
            raise RuntimeError(f"{name} ran {launches[name]} times over {n_steps} "
                               f"steps of {cfg.n_layers} layers")
    if client.launches != n_steps or charged < floor:
        raise RuntimeError(f"train steps metered {client.launches} times at "
                           f"{charged} MFLOPs a step, below 6·N·tokens = {floor}")
    del opt_state
    return params, launches


def phase_train_check(torch, llama, params, cfg):
    """Gradients through the kernels against the dense attention path."""

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    # bf16 on the train phase's 8-layer weights: the losses and named
    # gradient leaves through flash, through full, and through full in f32
    # (the same weights cast).  Held as serve_check holds the logits: the
    # kernel path's distance from f32 at most 1.5x the dense path's.  The
    # losses are held per token: the mean's error is a sum of rounding
    # errors of both signs, and how far they cancel is chance (it is
    # printed, not held).
    batch = _train_batch(torch, cfg.vocab_size, (2, 256), 5)
    leaves = llama._leaves(params)
    picks = {"tok_emb": params["tok_emb"],
             "layers.0.attn.wq": params["layers"][0]["attn"]["wq"],
             f"layers.{cfg.n_layers - 1}.mlp.w_down":
                 params["layers"][-1]["mlp"]["w_down"],
             "lm_head": params["lm_head"]}
    index = {name: next(i for i, p in enumerate(leaves) if p is t)
             for name, t in picks.items()}

    def picked(p, c):
        loss, grads = llama.value_and_grad(p, batch, c)
        with torch.no_grad():
            logits = llama.forward(p, batch["tokens"], c)
            nll = torch.logsumexp(logits, dim=-1) - torch.gather(
                logits, -1, batch["targets"][..., None])[..., 0]
        return {"mean_loss": loss, "token_losses": nll,
                **{name: grads[i] for name, i in index.items()}}

    flash = picked(params, cfg)
    full = picked(params, dataclasses.replace(cfg, attn_impl="full"))
    exact = picked(_float(params), dataclasses.replace(cfg, dtype=torch.float32,
                                                       attn_impl="full"))
    bf16 = {}
    for name in flash:
        if not torch.isfinite(flash[name]).all():
            raise RuntimeError(f"non-finite bf16 {name} through the kernels")
        bf16[name] = {"flash_vs_full": rel(flash[name], full[name]),
                      "flash_vs_f32": rel(flash[name], exact[name]),
                      "full_vs_f32": rel(full[name], exact[name])}
    del flash, full, exact
    bad = {n: d for n, d in bf16.items() if n != "mean_loss"
           and not d["flash_vs_f32"] <= 1.5 * d["full_vs_f32"]}
    if bad:
        raise RuntimeError(f"bf16 gradients: the kernel path is further from f32 "
                           f"than the dense path allows: {bad}")

    # f32, full width, 2 layers: every gradient leaf
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=2)
    p32 = llama.init_params(cfg32, torch.Generator(device=DEVICE).manual_seed(6),
                            device=DEVICE)
    batch = _train_batch(torch, cfg.vocab_size, (2, 256), 7)
    loss, got = llama.value_and_grad(p32, batch, cfg32)
    loss_full, want = llama.value_and_grad(p32, batch,
                                           dataclasses.replace(cfg32, attn_impl="full"))
    ratios = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
    if not max(ratios) <= 1e-4:
        raise RuntimeError(f"f32 gradients through the kernels differ from the "
                           f"dense path: worst max|Δ|/max|full| {max(ratios):.3g}")
    emit("train_check", bf16_rel=bf16,
         bf16_rule="flash_vs_f32 <= 1.5 * full_vs_f32, every entry but mean_loss",
         f32_leaves=len(ratios), f32_worst_rel=max(ratios),
         f32_rule="max|Δ| <= 1e-4 · max|full| per leaf",
         f32_loss=[loss.item(), loss_full.item()])


def phase_bench_train(bench_train, limiter_lib):
    """The metered train-step bench at its own configuration."""
    result = bench_train.run(limiter_lib=str(limiter_lib))
    if not (result["native_step_ms"] > 0 and result["metered_step_ms"] > 0
            and result["charged_mflops_per_step"] > 0):
        raise RuntimeError(f"bench_train gave no result: {result}")
    emit("bench_train", **result)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "tensorfusion_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from tensorfusion_tpu_torch import bench_train, hardware, ops
    from tensorfusion_tpu_torch.models import llama
    from tensorfusion_tpu_torch.ops import _build as build

    # the module; the package re-exports a function of the same name
    fa = sys.modules["tensorfusion_tpu_torch.ops.flash_attention"]
    t0 = time.perf_counter()
    name, smi = phase_device(torch, build, hardware)
    rates = hardware.peak_rates(name)
    limiter_lib = phase_build(torch, build, fa)
    rows = {"flash_attn_fwd": phase_kernels(torch, fa, rates)}
    rows.update(phase_bwd_kernels(torch, fa, rates))

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), attn_impl="flash")
    params, serve_launches = phase_serve(torch, ops, llama, bench_train,
                                         limiter_lib, cfg)
    phase_serve_check(torch, llama, params, cfg)
    del params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    params, train_launches = phase_train(torch, ops, llama, bench_train,
                                         limiter_lib, cfg, rates)
    phase_train_check(torch, llama, params, cfg)
    del params
    torch.cuda.empty_cache()
    phase_bench_train(bench_train, limiter_lib)

    kernels = [{"name": k.name, "route": k.route, "source": k.source,
                "replaces": k.replaces,
                "launches": serve_launches[k.name] + train_launches[k.name],
                "launches_by_path": {"serve": serve_launches[k.name],
                                     "train": train_launches[k.name]},
                **{key: rows[k.name][key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "plain", "library", "pair_ms")
                   if key in rows[k.name]}}
               for k in ops.KERNELS]
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
