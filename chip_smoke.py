#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (tensorfusion_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one Hopper card, nvcc
and make.  It builds the kernels (flash forward, flash backward),
libtpf_limiter.so, the reference's provider_conformance, the port's NVML
provider and its launch and memory hook from the checkout (failing if
ptxas reports a spill, or if the hand-declared NVML or CUDA driver types
disagree with the toolkit's nvml.h or cuda.h), holds every kernel against
its plain PyTorch version on the card and times it at the main path's
shape and at a long one, then drives the port's twelve paths at Llama-3-8B
width (random weights from fixed seeds), each with the kernel launch
counts set to 0 just before it and read just after (a tenant's, in its
own processes, count from 0 at their start):

- the node agent (first, while this process holds almost nothing):
  provider_conformance against the NVML provider over the real NVML; the
  port's hypervisor daemon (``python -m tensorfusion_tpu_torch.hypervisor``)
  over it, its inventory against torch and nvidia-smi; two soft tenants
  (``default/lo`` at 25% duty, QoS low; ``default/hi`` at 75%, QoS high)
  submitted through its API and spawned by its single-node backend with
  the launch hook preloaded, each ``python3 chip_smoke.py --tenant DIR``:
  Llama-3-8B at 32 layers, the first metered forward bit-equal to an
  unmetered one, then the metered forward on 4 x 1024 tokens in a loop
  under the 10 Hz ERL loop, while both segments are sampled; ``hi``
  frozen for 3 s and resumed; each segment holding exactly the hook's
  charges (the client, which also counts every call, charges nothing
  under the hook), the token-bucket bound, and nothing left after
  DELETE.  Its launches are the tenants' own;
- interception: tenants that never import the client runtime, metered
  by the launch hook alone.  (a) A probe child under the hook: the
  driver entries a 2-layer forward, a train step, graph capture and
  replay (``LlamaRunner``) and direct flash calls reach, with counts,
  and the flash output bit-equal to the same call without the hook; (b)
  tiny launches and the 32-layer forward without and with the hook, in
  four children; (c) one raw tenant (``chip_smoke.py --tenant-raw DIR``)
  alone for 10 s: charged device-seconds against its time in calls; (d)
  ``lo`` and ``hi`` as raw tenants under the daemon for 30 s, no freeze:
  the split of device time, NVML duty (at least 90%: the node agent
  raises each refill by its part of the card's overcharge), tokens/s,
  memory charged against ``torch.cuda.memory_reserved``, the daemon's
  tick times.  In (c), (d) and the node phase no launch goes untimed for
  want of a window or uncharged for a capture.  Its launches are those of
  the tenants of (c) and (d);
- multi-rank tenants (``shard``): the daemon spawns the sharded remote
  worker (``python -m tensorfusion_tpu_torch.remoting --ranks 4``, its
  devices the 4 ranks of a rank group on the card) as one soft tenant at
  100% duty, and a client here runs (a) the 8-layer last-position
  forward with the weights resident and replicated and the 4 x 1024
  tokens batch-sharded, against the local call, with the flash kernel
  launched on every rank; (b) Llama-3-8B's MLP with w1 / w3
  column-sharded and w2 row-sharded and resident (one partial-sum
  reduction), a shard fetched per device bit for bit, nothing resident
  after the frees and three calls with per-call shards; (c) the tenant's
  segment against its five processes' hook reports, exactly; then (d)
  the mesh's fsdp2 x tp2 train step (4 layers, 4 x 1024) as a second
  multi-rank tenant (``chip_smoke.py --mesh-tenant DIR``) for 3 steps,
  its charges against its ranks' time outside gloo, and a rank waiting
  in a host-staged all-reduce.  Its launches are the tenants' ranks';
- the control plane (``control_plane``): the port's state store
  (``python -m tensorfusion_tpu_torch.statestore``, persisted, with a
  token) and the daemon joined to it with ``--operator-url``; the Node,
  TPUNode and the card's TPUChip read back over a ``RemoteStore``; the
  platform composed in this process over that store (the webhook, the
  scheduler with its fit and topology plugins, an allocator fed the
  store's TPUChip); a pod with user annotations only (h100-sxm, duty 25,
  HBM, soft, QoS low) admitted at 247.25 TFLOPs, bound to the node and
  turned by the daemon into a worker whose segment holds 2500 bp; the
  unmodified 32-layer tenant (``chip_smoke.py --tenant-raw DIR``) under
  the worker's env for about 20 s, its segment against its hook report,
  while a pod asking for more HBM than is left and a pod over its
  namespace's quota are refused; a gang of two bound whole and a gang of
  three that cannot form bound not at all; a QoS-critical pod preempting
  a QoS-low one, worker for worker; the daemon's metrics lines in the
  store; the store killed and restarted from its journal, a pod admitted
  and scheduled after it, and an allocator rebuilt from the store equal
  to the live one; every pod deleted and its worker and segment gone;
  then the scheduler alone on the host over 64 nodes of 8 cards and 512
  pods.  Its launches are the tenant's;

- serving: greedy ``generate`` requests, 32 layers, through the metered
  client;
- the engine: continuous batching (``serving.ServingEngine`` over a
  ``serving.LlamaRunner`` pool of 1024 16-token blocks, one CUDA graph
  per decode bucket) at 32 layers on the serving weights, three waves of
  ragged requests joining a running batch, a shared system prefix and
  speculative (n-gram) requests, with the pool's footprint charged on a
  metered client while it serves; then one decode step replayed and run
  eagerly, beside its bytes bound.  The paged path launches none of the
  kernels (its attention is gather and einsum, as the reference's);
- serving over the wire: a metered ``remoting.RemoteVTPUWorker``
  hosting that engine at 32 layers, three ``RemoteDevice`` connections
  (QoS high, medium, low) streaming the engine's 24 requests as
  GENERATEs, then four 1024-token prompts prefilled by a
  ``serving.PrefillPool`` in this process and shipped to the worker by
  ``serving.RemoteKVShipper`` (KV_SHIP), with the pool charged on the
  meter while the worker serves and no compute charged for its steps;
- training: AdamW steps, 8 layers, batch 4 x 1024, metered;
- the mesh: 4 ranks spawned once on the one card over gloo (NCCL refuses
  two ranks on one card; gloo stages the ring's send/recv through the
  host): a sharded train step (fsdp2 x tp2, 4 layers, 4 x 1024, flash, 3
  steps) against the same steps on one device; its step-3 state saved by
  ``models.Checkpointer`` and restored onto a fresh state of the same
  placements, whose step 4 must equal the uninterrupted one bit for bit;
  ring attention (sp4, causal, 8192 tokens) against the flash kernels on
  the whole sequence, forward and gradients; a 2-layer ``attn_impl="ring"``
  Llama loss against one device's flash loss; a 4-stage pipeline (a
  decoder layer a stage, 8 microbatches of 1 x 1024) against the layers
  in order; the reference's default MoE config expert-parallel over ep4
  against one device, outputs and dropped entries;
- remote execution: a ``remoting.RemoteVTPUWorker`` that owns the card,
  metered, and a ``RemoteDevice`` over loopback; the 8-layer weights PUT
  resident, a ``remote_jit`` last-position forward (flash) called at
  each serving shape, a ``step_resident`` chain and a micro-batched
  burst from two connections;
- federation: three metered workers on the card; a
  ``remoting.FederatedDevice`` runs the last-position forward split over
  two of them (a replica of the 8-layer weights on each), a fabric-ring
  all-reduce of one decoder layer's bytes over all three (worker to
  worker, raw and q8) and a model-parallel MLP split along its hidden
  width;
- migration: the 8-layer weights and a tenant's resident state move
  between two metered workers in two pre-copy rounds, a freeze and a
  commit (and once more, aborted); a worker-hosted engine is frozen
  mid-stream; the target is SNAPSHOTted into its state root and RESTOREd
  into a fresh worker.

It checks the answers of each: tokens and logits (the engine's f32
tokens against ``generate``, its graphed step against the eager one, its
bf16 logits against f32; the remote logits' argmax against the local
forward's and their bf16 distance from f32; the f32 tokens of a
worker-hosted engine against ``generate``, of KV_SHIP against GENERATE
and of a q8 connection against a raw one; the federated halves, the
migrated and the restored calls bit for bit against the local or source
call, the raw ring against its own arithmetic and the q8 ring within its
per-hop bound, no collective byte through the client), gradients against
the dense attention path, the remote worker's charges against the local
FLOP estimate and the resident bytes, and ends with the metered
train-step bench (``tensorfusion_tpu_torch.bench_train``).  Each phase
prints one JSON line; any failure raises and exits non-zero.  The line
before the last two is the kernel table (its ``launches_by_path`` has
``serve``, ``engine``, ``train``, ``remote``, ``remote_serve``,
``federation``, ``migrate``, ``mesh``, ``node``, ``intercept``,
``shard`` and ``control_plane``), each phase is preceded by a ``memory`` line (what this
process holds, before and after collecting garbage), the
line before the last is nvidia-smi's name and power limit, and the last
line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Without a CUDA device, or outside a checkout, it exits non-zero and
prints no result.  It imports nothing of JAX.

``python3 chip_smoke.py --control-plane N`` runs the device and build
phases and then the control-plane phase alone, N times in one process
(each preceded by its ``memory`` line), to look for a rare failure of
that phase; it prints no kernel table and no result line.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import random
import shutil
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
ENGINE_POOL = (1025, 16)                   # blocks (1024 + scratch) x block size
ENGINE_BATCH, ENGINE_CHUNK = 8, 256        # max batch, prefill tokens a step
ENGINE_WAVES = (0, 20, 40)                 # engine steps at which waves arrive
REMOTE_CALLS = 12                          # timed remote EXECUTEs per shape
REMOTE_QOS = ("high", "medium", "low")     # the remote serving connections
REMOTE_WAVE_GAP_S = 1.0                    # seconds between remote request waves
PREFILL_POOL = (257, 16)                   # prefill tier: blocks x block size
FED_CALLS = 4                              # timed federated forward calls
FREEZE_POOL = (17, 16)                     # frozen engine: blocks x block size
FREEZE_NEW = 96                            # tokens of the frozen stream
FREEZE_AT = 24                             # tokens streamed before the freeze
FREEZE_S = 0.5                             # seconds the engine stays frozen
MESH_RANKS = 4                             # ranks sharing the card over gloo
MESH_AXES = {"fsdp": 2, "tp": 2}           # the sharded train step's mesh
MESH_LAYERS, MESH_STEPS = 4, 3             # its depth and steps
MESH_SHAPE = (4, 1024)                     # its batch x sequence
RING_SEQ, RING_LAYERS = 8192, 2            # ring attention: tokens, Llama depth
PIPE_MICRO, PIPE_SEQ = 8, 1024             # pipeline: microbatches of 1 x PIPE_SEQ
MOE_BATCH = (8, 512)                       # MoE batch: overflows an expert
MOE_CONFIG = {}                            # MoEConfig fields over its defaults
BF16_REL = 2e-2                            # bf16 tolerance of the mesh checks
NODE_TENANTS = (("lo", 25.0, "low"), ("hi", 75.0, "high"))  # pod, duty %, QoS
NODE_SHAPE = (4, 1024)                     # a tenant's forward: batch x tokens
NODE_SEED = 13                             # the tenants' weights and tokens
NODE_HBM_BYTES = 30 << 30                  # a tenant's device-memory budget
NODE_WINDOW_S = 40.0                       # sampling window after both start
NODE_SAMPLE_S = 0.1                        # segment sampling period
NODE_FREEZE_AT_S, NODE_FREEZE_S = 20.0, 3.0  # hi frozen from, for (s)
NODE_START_TIMEOUT_S = 300.0               # tenants' weights built, first call
NODE_TOKEN = "chip-smoke-node"             # the daemon's API token
NODE_STOP_TIMEOUT_S = 120.0                # tenants' last call and record
PROBE_LAYERS, PROBE_SHAPE = 2, (2, 512)    # the probe's model depth, tokens
PROBE_SEED = 21                            # the probe's weights and inputs
PROBE_BLOCKS, PROBE_DECODES = 17, 16       # its paged pool, graphed decode steps
PROBE_FLASH_SHAPE = (128, 1024, 128)       # direct flash calls: [B*H, T, D]
PROBE_FLASH_CALLS = 4
OVERHEAD_TINY, OVERHEAD_ROUNDS = 20000, 5  # tiny launches timed in part b
OVERHEAD_CALLS = 5                         # forwards timed in part b
INTERCEPT_ALONE_S = 10.0                   # part c: one raw tenant alone
INTERCEPT_WINDOW_S = 30.0                  # part d: two raw tenants
INTERCEPT_LO_BAND = (0.15, 0.35)           # lo's share of device time (25%)
INTERCEPT_MIN_DUTY = 90.0                  # part d: NVML's duty of the card, %


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


def phase_build(torch, build, fa, hv_build):
    """The kernels (one nvcc each, in parallel), the limiter and the
    provider conformance check, together; the NVML provider and the launch
    hook, and their driver declarations held against the toolkit's nvml.h
    and cuda.h; then what each kernel
    holds (ptxas, dynamic shared memory) and what a launch's tensor maps
    cost on the host."""
    t0 = time.perf_counter()
    make = subprocess.Popen(["make", "-C", str(REPO / "native"),
                             "build/libtpf_limiter.so", "build/provider_conformance"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    limiter = {}

    def wait_make():
        limiter["log"], _ = make.communicate()
        limiter["s"] = time.perf_counter() - t0

    waiter = threading.Thread(target=wait_make)
    waiter.start()
    try:
        t_provider = time.perf_counter()
        provider_lib = hv_build.provider_path()
        nvml_header = hv_build.check_nvml_layout()
        hook_lib = hv_build.cuda_hook_path()
        cuda_header = hv_build.check_cuda_layout()
        provider_s = time.perf_counter() - t_provider
        kernel_s = build.build_all()
    finally:
        waiter.join()
    if make.returncode != 0:
        raise RuntimeError(f"the limiter or provider_conformance did not build:\n"
                           f"{limiter['log']}")
    ptxas = {n: build.ptxas_summary(build.ptxas_report(n)) for n in build.SOURCES}
    spills = {f"{n}: {k}": v["spill_bytes"] for n, kernels in ptxas.items()
              for k, v in kernels.items() if v["spill_bytes"]}
    emit("build", kernels_s=kernel_s, limiter_s=limiter["s"], provider_s=provider_s,
         nvml_provider=str(provider_lib.relative_to(REPO)), nvml_header=str(nvml_header),
         cuda_hook=str(hook_lib.relative_to(REPO)), cuda_header=str(cuda_header),
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


def _rel(a, b):
    """max |a - b| over max |b|, in f32."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def phase_serve_check(torch, llama, params, cfg):
    # bf16, full width and depth: the kernel's last-position prefill
    # logits against the dense attention path's, and both against the same
    # weights run in f32 with dense attention.  At 32 layers every bf16
    # path lands about 2e-2 (max |d| / max |logits|) from f32, so the
    # kernel is held to the dense path's own error, with 1.5x room.
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    prompt = prompt1 = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                                     device=DEVICE)
    flash, _ = llama.prefill(params, prompt, cfg, cache_len=256)
    full, _ = llama.prefill(params, prompt,
                            dataclasses.replace(cfg, attn_impl="full"), cache_len=256)
    exact, _ = llama.prefill(_float(params), prompt,
                             dataclasses.replace(cfg, dtype=torch.float32,
                                                 attn_impl="full"), cache_len=256)
    if not torch.isfinite(flash).all():
        raise RuntimeError("non-finite prefill logits")

    bf16 = {"flash_vs_full": _rel(flash, full), "flash_vs_f32": _rel(flash, exact),
            "full_vs_f32": _rel(full, exact)}
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
    # the bf16 check of the paged path holds its logits to the same two
    return {"prompt": prompt1, "full": full, "exact": exact}


# -- the paged-KV engine ------------------------------------------------------


def _engine_traffic(vocab):
    """The engine phase's requests, from fixed seeds: three waves of 8
    (tenant, prompt, max_new_tokens), prompts ragged over 64-1024 tokens,
    8 of them on one 512-token system prefix (one of those is the bare
    system prompt, a full-prompt registry hit), max_new_tokens 32-128;
    then 4 prompts of a repeated 16-token phrase for the speculative
    run."""
    rng = random.Random(5)

    def tokens(n):
        return [rng.randrange(vocab) for _ in range(n)]

    system = tokens(512)
    waves = []
    for w in range(len(ENGINE_WAVES)):
        wave = []
        for i in range(8):
            n, new = rng.randrange(64, 1025), rng.randrange(32, 129)
            if (w, i) == (2, 7):
                prompt = list(system)
            elif i % 3 == 0:
                prompt = system + tokens(max(n - 512, 1))
            else:
                prompt = tokens(n)
            wave.append((f"w{w}r{i}", prompt, new))
        waves.append(wave)
    spec = [(f"s{i}", tokens(16) * 8, 32) for i in range(4)]
    return waves, spec


def _run_engine(torch, engine, waves, at_steps):
    """Submit ``waves[k]`` when the engine has taken ``at_steps[k]`` steps,
    step it on this thread until every request is done; returns each
    request's tokens by tenant and the wall seconds."""
    outs = {}

    def emit(seq, toks, done, info):
        if done:
            outs[seq.tenant] = (list(seq.tokens), info.get("finish_reason"))
    pending = list(zip(at_steps, waves))
    total = sum(len(w) for w in waves)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while len(outs) < total:
        while pending and engine.steps >= pending[0][0]:
            for tenant, prompt, new in pending.pop(0)[1]:
                engine.submit(prompt, new, tenant=tenant, emit=emit)
        engine.step()
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def _spec_vs_plain(torch, serving, runner, requests, vocab):
    """``requests`` through two engines on ``runner``: plain, then with
    an n-gram draft (``spec_k`` 3, so verify steps of 4 tokens).  Returns
    the speculative engine's counters and, per request, the index of the
    first token where the two runs differ (None where they agree)."""
    outs = []
    for draft in (None, serving.NGramDraft(n=2)):
        engine = serving.ServingEngine(runner, max_batch=ENGINE_BATCH,
                                       prefill_chunk_tokens=ENGINE_CHUNK,
                                       draft=draft, spec_k=3)
        got, wall = _run_engine(torch, engine, [requests], [0])
        _check_outs(got, requests, vocab, "speculative engine" if draft else "engine")
        if engine.snapshot()["kv"]["used"] != 0:
            raise RuntimeError(f"the pool kept blocks: {engine.snapshot()['kv']}")
        outs.append(got)
    spec = engine.snapshot()["spec"]
    if spec["steps"] == 0 or not any(k[0] == "verify" for k in runner.graphs):
        raise RuntimeError(f"no verify step ran: {spec}")
    first_diff = {t: next((i for i, (a, b) in enumerate(zip(outs[0][t][0], outs[1][t][0]))
                           if a != b), None) for t, _, _ in requests}
    return {**spec, "wall_s": wall, "first_diff": first_diff,
            "tokens_equal_plain": all(d is None for d in first_diff.values())}


def _check_outs(outs, requests, vocab, label):
    for tenant, prompt, new in requests:
        toks, reason = outs[tenant]
        if reason != "length" or len(toks) != new or not all(
                0 <= t < vocab for t in toks):
            raise RuntimeError(f"{label}: request {tenant} ended {reason} with "
                               f"{len(toks)} of {new} tokens")


def _decode_bound(llama_leaves, cfg, params, positions, rates):
    """Least time of one decode step of ``len(positions)`` rows: the bytes
    it must move (every weight read once, the K/V of each row's context
    read and this step's written) over the memory rate, against its
    FLOPs over the bf16 rate."""
    item = params["lm_head"].element_size()
    weights = llama_leaves({k: v for k, v in params.items() if k != "tok_emb"})
    b = len(positions)
    per_token_kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * item
    context = sum(p + 1 for p in positions)
    # every weight, the b embedding rows, each row's K/V read, this step's written
    moved = (sum(p.numel() * p.element_size() for p in weights)
             + b * cfg.dim * item + per_token_kv * (context + b))
    matmul = sum(p.numel() for p in weights if p.dim() == 2)
    flops = 2 * matmul * b + 4 * cfg.n_layers * cfg.n_heads * cfg.head_dim * context
    bytes_ms, ops_ms = moved / rates["bytes"] * 1e3, flops / rates["bf16"] * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_moved": moved, "flops": flops}


def phase_engine(torch, ops, llama, serving, bench_train, limiter_lib, params, cfg,
                 rates, smi):
    """Continuous batching through ServingEngine + LlamaRunner at
    Llama-3-8B width and depth, bf16, on the serving phase's weights: a
    pool of ENGINE_POOL blocks charged on a metered client while it
    serves, decode buckets captured as CUDA graphs up front, three waves
    of requests joining a running batch, then four requests speculative
    (n-gram draft) and not, compared token by token.  (The comparison is
    held exactly in f32, in engine_check: in bf16 the logits come out of
    the lm_head product rounded to bf16, so a decode step's 8-row product
    and a verify step's 32-row one may break a near-tie differently.)
    Then one decode step of the fullest batch, replayed and run eagerly,
    against its bound."""
    kvpool = serving.kvpool
    num_blocks, block_size = ENGINE_POOL
    waves, spec_reqs = _engine_traffic(cfg.vocab_size)
    runner = serving.LlamaRunner(params, cfg, num_blocks=num_blocks,
                                 block_size=block_size, device=DEVICE)
    steps = []
    decode = runner.decode

    def recorded(tokens, positions, tables):
        t0 = time.perf_counter()
        out = decode(tokens, positions, tables)
        steps.append((time.perf_counter() - t0, tokens, positions, tables))
        return out
    runner.decode = recorded
    with bench_train.worker_segment(limiter_lib, WORK / "engine", "engine",
                                    DEVICE) as client:
        if not client.charge_hbm(runner.nbytes):
            raise RuntimeError("the KV pool's footprint was refused")
        try:
            ops.reset_launch_counts()
            runner.warmup(ENGINE_BATCH, 1024, ENGINE_CHUNK)
            warm = {"graphs": len(runner.graphs), "capture_s": runner.capture_s}
            engine = serving.ServingEngine(runner, max_batch=ENGINE_BATCH,
                                           prefill_chunk_tokens=ENGINE_CHUNK)
            outs, wall = _run_engine(torch, engine, waves, ENGINE_WAVES)
            snap = engine.snapshot()
            requests = [r for w in waves for r in w]
            _check_outs(outs, requests, cfg.vocab_size, "engine")
            spec = _spec_vs_plain(torch, serving, runner, spec_reqs, cfg.vocab_size)
            launches = ops.launch_counts()
            held = client.hbm_charged_bytes
        finally:
            client.charge_hbm(-runner.nbytes)
        released = client.hbm_charged_bytes
    del runner.decode
    if held != runner.nbytes or released != 0:
        raise RuntimeError(f"pool footprint {runner.nbytes} B: client held "
                           f"{held} while serving and {released} after")
    if snap["kv"]["used"] != 0:
        raise RuntimeError(f"the pool kept blocks: {snap['kv']}")

    # one decode step of the fullest batch, replayed and eager
    _, tokens, positions, tables = max(
        (s for s in steps if len(s[1]) == ENGINE_BATCH), key=lambda s: sum(s[2]))
    bp = kvpool.pow2_bucket(len(tokens))
    tab = runner._pad_tables(tables, bp)
    graph = runner.graphs[("decode", bp, tab.shape[1])]
    graphed = runner.decode(tokens, positions, tables)
    replay_ms = time_ms(torch, graph.graph.replay, 20)
    s0 = time.perf_counter()
    for _ in range(10):
        runner.decode(tokens, positions, tables)
    call_ms = (time.perf_counter() - s0) * 1e3 / 10
    tok, pos, tabt = (torch.from_numpy(a).to(DEVICE) for a in (
        _pad(tokens, bp), _pad(positions, bp), tab))
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    logits, _ = kvpool.paged_decode_step(params, tok, runner.cache, tabt, pos, cfg)
    eager = logits.argmax(-1)[:len(tokens)].tolist()
    eager_ms = (time.perf_counter() - s0) * 1e3
    if eager != graphed:
        raise RuntimeError("the eager decode step disagrees with the graph's")
    host_ms = sorted(s[0] * 1e3 for s in steps)
    emit("engine", nvidia_smi=smi, dim=cfg.dim, n_layers=cfg.n_layers,
         dtype=str(cfg.dtype),
         pool={"num_blocks": num_blocks, "block_size": block_size,
               "nbytes": runner.nbytes},
         max_batch=ENGINE_BATCH, prefill_chunk_tokens=ENGINE_CHUNK,
         requests=len(requests), waves_at_steps=list(ENGINE_WAVES),
         wall_s=wall, tokens=snap["tokens"], tokens_per_s=snap["tokens"] / wall,
         ttft_ms=snap["ttft"], batch_occupancy_pct=snap["batch_occupancy_pct"],
         steps=snap["steps"], decode_steps=snap["decode_steps"],
         prefill_chunks=snap["prefill_chunks"],
         step_ms=engine.step_time.snapshot(),
         decode_call_ms={"p50": host_ms[len(host_ms) // 2], "max": host_ms[-1]},
         kv={k: snap["kv"][k] for k in ("peak_used", "prefix_hits_total",
                                        "prefix_hit_tokens_total", "cow_copies_total",
                                        "allocated_total", "released_total")},
         spec=spec,
         warmup=warm, graphs_captured=len(runner.graphs),
         capture_s=runner.capture_s,
         decode_step={"batch": len(tokens), "bucket": [bp, tab.shape[1]],
                      "context_tokens": sum(p + 1 for p in positions),
                      "graph_replay_ms": replay_ms, "graph_call_ms": call_ms,
                      "eager_ms": eager_ms,
                      **_decode_bound(llama._leaves, cfg, params, positions,
                                      rates)},
         hbm_charged_while_serving=held, hbm_charged_after=released,
         kernel_launches=launches, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, {t: toks for t, (toks, _) in outs.items()}


def _pad(values, n):
    import numpy as np

    out = np.zeros((n,), np.int32)
    out[:len(values)] = values
    return out


def phase_engine_check(torch, llama, serving, params, cfg, ref):
    """f32 at full width, 2 layers: engine tokens equal generate's for
    ragged requests joining mid-flight; speculative tokens (verify graphs)
    equal plain decode's; one graphed decode step equal to
    kvpool's eager step on a copy of the pool; bf16 at 32 layers: the
    paged prefill's last-position logits against the f32 dense run, held
    to 1.5x the dense bf16 path's own distance (as serve_check holds the
    kernel)."""
    kvpool = serving.kvpool
    # bf16, the serving weights: one 256-token chunk through a fresh pool
    cache = kvpool.init_paged_cache(cfg, 17, 16, device=DEVICE)
    table = torch.arange(1, 17, dtype=torch.int32, device=DEVICE)
    paged, _ = kvpool.paged_prefill_chunk(params, ref["prompt"][0], cache, table,
                                          0, cfg)
    del cache

    bf16 = {"paged_vs_f32": _rel(paged, ref["exact"][0]),
            "full_vs_f32": _rel(ref["full"][0], ref["exact"][0]),
            "paged_vs_full": _rel(paged, ref["full"][0])}
    if not (torch.isfinite(paged).all() and
            bf16["paged_vs_f32"] <= 1.5 * bf16["full_vs_f32"]):
        raise RuntimeError(f"bf16 paged prefill logits too far from f32: {bf16}")

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=2,
                                attn_impl="full")
    p32 = llama.init_params(cfg32, torch.Generator(device=DEVICE).manual_seed(8),
                            device=DEVICE)
    rng = random.Random(9)
    requests = [(f"r{i}", [rng.randrange(cfg.vocab_size) for _ in range(n)], new)
                for i, (n, new) in enumerate(((100, 12), (333, 8), (64, 20),
                                              (700, 10), (257, 16)))]
    runner32 = serving.LlamaRunner(p32, cfg32, num_blocks=257, block_size=16,
                                   device=DEVICE)
    engine = serving.ServingEngine(runner32, max_batch=4, prefill_chunk_tokens=128)
    # one request joins every third step, while the others decode
    outs, _ = _run_engine(torch, engine, [[r] for r in requests],
                          [3 * i for i in range(len(requests))])
    _check_outs(outs, requests, cfg.vocab_size, "f32 engine")
    for tenant, prompt, new in requests:
        want = llama.generate(p32, torch.tensor([prompt], device=DEVICE), new, cfg32,
                              device=DEVICE)[0].tolist()
        if outs[tenant][0] != want:
            raise RuntimeError(f"f32 engine tokens of {tenant} differ from "
                               f"generate: {outs[tenant][0]} vs {want}")

    # speculative decoding through the verify graphs, token for token
    spec = _spec_vs_plain(torch, serving, runner32, _engine_traffic(cfg.vocab_size)[1],
                          cfg.vocab_size)
    if not spec["tokens_equal_plain"]:
        raise RuntimeError(f"f32 speculative tokens differ from plain decode: {spec}")

    # a graphed decode step against the eager one on a copy of the pool
    acct = kvpool.BlockAccount(257, 16)
    toks, positions, tables = [], [], []
    for tenant, prompt, _ in requests[:3]:
        acct.ensure(tenant, len(prompt) + 1)
        tables.append(acct.table(tenant))
        toks.append(runner32.prefill(prompt, tables[-1], 0))
        positions.append(len(prompt))
    copy = {kind: [t.clone() for t in layers] for kind, layers in runner32.cache.items()}
    graphed = runner32.decode(toks, positions, tables)
    bp = kvpool.pow2_bucket(len(toks))
    tab = torch.from_numpy(runner32._pad_tables(tables, bp)).to(DEVICE)
    logits, _ = kvpool.paged_decode_step(
        p32, torch.from_numpy(_pad(toks, bp)).to(DEVICE), copy, tab,
        torch.from_numpy(_pad(positions, bp)).to(DEVICE), cfg32)
    eager = logits.argmax(-1)[:len(toks)].tolist()
    page_err = max(((a - b).abs() - (2e-5 + 2e-4 * b.abs())).max().item()
                   for kind in ("k", "v")
                   for a, b in zip(runner32.cache[kind], copy[kind]))
    if graphed != eager or page_err > 0:
        raise RuntimeError(f"graphed decode differs from the eager step: tokens "
                           f"{graphed} vs {eager}, page excess {page_err:.3g}")
    emit("engine_check", bf16_prefill_logits_rel=bf16,
         bf16_rule="paged_vs_f32 <= 1.5 * full_vs_f32",
         f32_engine_tokens_equal_generate=True,
         f32_requests=[[len(p), new] for _, p, new in requests],
         f32_graphs=sorted(map(list, runner32.graphs)), f32_spec=spec,
         graph_vs_eager={"tokens_equal": True, "page_excess_over_tol": page_err,
                         "tolerance": "rtol 2e-4, atol 2e-5"})


def _timed_stream(call):
    """``call(on_token)`` timed: (result, send time, token arrival times)."""
    stamps = []
    t_send = time.perf_counter()
    return call(lambda t: stamps.append(time.perf_counter())), t_send, stamps


def _client_threads(devs, requests, wave_of, gap_s, stream_fn):
    """Send ``requests`` [(tenant, prompt, new)] as streaming calls from
    one client thread each, request i on connection ``devs[i % len]``,
    wave ``wave_of(i)`` starting ``gap_s`` seconds after the one before;
    ``stream_fn(dev, prompt, new, on_token)`` makes the call.  Returns,
    by tenant, (result, send time, token arrival times), the failures,
    and the wall seconds from the first send to the last final frame."""
    results, failures = {}, []

    def run(i, tenant, prompt, new):
        try:
            results[tenant] = _timed_stream(
                lambda cb: stream_fn(devs[i % len(devs)], prompt, new, cb))
        except Exception as e:  # noqa: BLE001 - raised by the caller
            failures.append(f"{tenant}: {type(e).__name__}: {e}")
    threads = [threading.Thread(target=run, args=(i, *req))
               for i, req in enumerate(requests)]
    t0 = time.perf_counter()
    for i, t in enumerate(threads):
        delay = t0 + wave_of(i) * gap_s - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t.start()
    for t in threads:
        t.join(timeout=900)
    end = max((s[-1] for _, _, s in results.values() if s), default=t0)
    return results, failures, end - t0


def _stream_stats(results):
    """Client-side latency of streamed requests: TTFT (send to first
    token) and the gaps between consecutive tokens, p50 / p99 in ms."""
    ttft = [s[0] - t for _, t, s in results.values() if s]
    gaps = [b - a for _, _, s in results.values() for a, b in zip(s, s[1:])]
    return {"client_ttft_ms": _quantiles_ms(ttft),
            "inter_token_ms": _quantiles_ms(gaps)}


def _prefill_tier(serving, runner, prompts):
    """KV payloads of ``prompts`` [(tag, tokens)] from a PrefillPool over
    ``runner`` (inline, 256-token chunks, prefix sharing), by tag."""
    pool = serving.PrefillPool([runner], chunk_tokens=ENGINE_CHUNK, inline=True)
    payloads = {}
    pool.attach(lambda tag, payload: payloads.__setitem__(tag, payload))
    for tag, tokens in prompts:
        pool.submit(tag, tokens)
    while pool.pump():
        pass
    missing = [tag for tag, _ in prompts if payloads.get(tag) is None]
    if missing:
        raise RuntimeError(f"the prefill tier could not hold {missing}")
    return payloads, pool.snapshot()


def _ship_prompts(vocab):
    """KV_SHIP's four 1024-token prompts from a fixed seed: two on the
    engine traffic's 512-token system prefix, two unshared."""
    rng = random.Random(5)
    system = [rng.randrange(vocab) for _ in range(512)]
    rng = random.Random(12)

    def tokens(n):
        return [rng.randrange(vocab) for _ in range(n)]
    return [("k0", system + tokens(512)), ("k1", system + tokens(512)),
            ("k2", tokens(1024)), ("k3", tokens(1024))]


def phase_remote_serve(torch, ops, remoting, serving, bench_train, limiter_lib,
                       params, cfg, smi, engine_outs):
    """Serving over the wire at Llama-3-8B width and depth, bf16, on the
    serving weights: a metered RemoteVTPUWorker hosting a ServingEngine
    (the engine phase's pool and batch, decode graphs captured up front)
    owns the card; three RemoteDevice connections over loopback (HELLO
    QoS high, medium, low) stream the engine phase's 24 requests as
    GENERATEs from client threads, in three waves REMOTE_WAVE_GAP_S
    apart.  Then a prefill tier in this process (a PrefillPool over a
    second runner on the same weights) ships four 1024-token prompts to
    the worker through RemoteKVShipper: the first alone, the other three
    together while it decodes (one shares its system prefix).  The kernel
    launch counts and the meter's compute charges are read over both;
    the pool must be charged on the meter while serving and released
    after stop, and left empty."""
    t_phase = time.perf_counter()
    num_blocks, block_size = ENGINE_POOL
    waves, _ = _engine_traffic(cfg.vocab_size)
    requests = [r for w in waves for r in w]
    runner = serving.LlamaRunner(params, cfg, num_blocks=num_blocks,
                                 block_size=block_size, device=DEVICE)
    runner.warmup(ENGINE_BATCH, 1024, ENGINE_CHUNK)
    engine = serving.ServingEngine(runner, max_batch=ENGINE_BATCH,
                                   prefill_chunk_tokens=ENGINE_CHUNK)
    ship_prompts = _ship_prompts(cfg.vocab_size)
    prefill = serving.LlamaRunner(params, cfg, num_blocks=PREFILL_POOL[0],
                                  block_size=PREFILL_POOL[1], device=DEVICE)
    payloads, tier = _prefill_tier(serving, prefill, ship_prompts)
    del prefill
    torch.cuda.empty_cache()

    with bench_train.worker_segment(limiter_lib, WORK / "remote_serve",
                                    "remote_serve", DEVICE) as meter:
        worker = remoting.RemoteVTPUWorker(engine=engine, meter_client=meter,
                                           device=DEVICE)
        worker.start()
        try:
            held = meter.hbm_charged_bytes
            devs = [remoting.RemoteDevice(worker.url, qos=q, timeout_s=900)
                    for q in REMOTE_QOS]
            shipper = serving.RemoteKVShipper(worker.url)
            try:
                for d in devs:
                    d.info()          # dial and HELLO before the counted run
                wire0 = [(d.wire_stats.get("frame_bytes", 0),
                          d.rx_stats.get("frame_bytes", 0),
                          d.rx_stats.get("frames", 0)) for d in devs]
                launches0, mflops0 = meter.launches, meter.charged_mflops
                ops.reset_launch_counts()
                results, failures, wall = _client_threads(
                    devs, requests, lambda i: i // 8, REMOTE_WAVE_GAP_S,
                    lambda d, p, n, cb: d.generate(p, n, on_token=cb))
                if failures:
                    raise RuntimeError(f"remote GENERATEs failed: {failures}")
                wire = {"out_bytes": sum(d.wire_stats.get("frame_bytes", 0) - w[0]
                                         for d, w in zip(devs, wire0)),
                        "in_bytes": sum(d.rx_stats.get("frame_bytes", 0) - w[1]
                                        for d, w in zip(devs, wire0)),
                        "generate_ok_frames": sum(d.rx_stats.get("frames", 0) - w[2]
                                                  for d, w in zip(devs, wire0))}
                serving_info = devs[0].info()["serving"]
                step_ms = engine.step_time.snapshot()

                # KV_SHIP: the first prompt alone (128 new tokens, so it
                # decodes while the others arrive), then the other three
                ships, ship_failures = {}, []

                def ship(tag, prompt, new):
                    try:
                        ships[tag] = _timed_stream(lambda cb: shipper.ship(
                            prompt, payloads[tag], new, on_token=cb))
                    except Exception as e:  # noqa: BLE001 - raised below
                        ship_failures.append(f"{tag}: {type(e).__name__}: {e}")
                        return
                    if not ships[tag][0].get("ship", {}).get("blocks"):
                        ship_failures.append(f"{tag}: no KV_SHIP_OK receipt")
                threads = [threading.Thread(target=ship, args=(*ship_prompts[0], 128))]
                threads[0].start()
                deadline = time.monotonic() + 300
                while engine.snapshot()["kv_ship"]["ships"] < 1 and \
                        threads[0].is_alive() and time.monotonic() < deadline:
                    time.sleep(0.002)
                for tag, prompt in ship_prompts[1:]:
                    threads.append(threading.Thread(target=ship, args=(tag, prompt, 32)))
                    threads[-1].start()
                for t in threads:
                    t.join(timeout=900)
                if ship_failures or len(ships) != len(ship_prompts):
                    raise RuntimeError(f"KV_SHIPs failed: {ship_failures}")
                launches = ops.launch_counts()
                charged = {"launches": meter.launches - launches0,
                           "mflops": meter.charged_mflops - mflops0}
                ship_snap = engine.snapshot()["kv_ship"]
                # GENERATE of the first shipped prompt, alone on the engine
                gen_k0 = _timed_stream(lambda cb: devs[0].generate(
                    ship_prompts[0][1], 128, on_token=cb))
            finally:
                shipper.close()
                for d in devs:
                    d.close()
        finally:
            worker.stop()
        released = meter.hbm_charged_bytes
    final = engine.snapshot()

    tokens = sum(len(r["tokens"]) for r, _, _ in results.values())
    per_qos = {}
    for i, (tenant, _, _) in enumerate(requests):
        r, t_send, stamps = results[tenant]
        q = per_qos.setdefault(REMOTE_QOS[i % len(REMOTE_QOS)], {"tokens": 0, "ttft": []})
        q["tokens"] += len(r["tokens"])
        q["ttft"].append(stamps[0] - t_send)
    per_qos = {q: {"requests": len(v["ttft"]), "tokens": v["tokens"],
                   "client_ttft_ms": _quantiles_ms(v["ttft"])}
               for q, v in per_qos.items()}
    equal_local = sum(results[t][0]["tokens"] == engine_outs.get(t)
                      for t, _, _ in requests)
    kv_ship = {}
    for tag, prompt in ship_prompts:
        r, t_send, stamps = ships[tag]
        p = payloads[tag]
        first_s = stamps[0] - t_send
        kv_ship[tag] = {"prompt": len(prompt), "new_tokens": len(r["tokens"]),
                        "blocks": r["ship"]["blocks"], "bytes": p["bytes"],
                        "ship_to_first_token_ms": first_s * 1e3,
                        "ship_gb_s": p["bytes"] / first_s / 1e9,
                        "engine_ttft_ms": r["ttft_ms"]}
    kv_ship["k0"]["generate_ttft_ms"] = (gen_k0[2][0] - gen_k0[1]) * 1e3
    kv_ship["k0"]["tokens_equal_generate"] = \
        ships["k0"][0]["tokens"] == gen_k0[0]["tokens"]
    snap = {k: serving_info[k] for k in ("tokens", "steps", "decode_steps",
                                         "prefill_chunks", "batch_occupancy_pct",
                                         "ttft", "admitted", "retired")}
    snap["kv"] = {k: serving_info["kv"][k] for k in (
        "peak_used", "prefix_hits_total", "prefix_hit_tokens_total",
        "cow_copies_total")}
    row = {"nvidia_smi": smi, "dim": cfg.dim, "n_layers": cfg.n_layers,
           "dtype": str(cfg.dtype), "requests": len(requests),
           "connections": list(REMOTE_QOS), "wave_gap_s": REMOTE_WAVE_GAP_S,
           "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
           **_stream_stats(results),
           "engine_ttft_ms": _quantiles_ms([r["ttft_ms"] / 1e3
                                            for r, _, _ in results.values()]),
           "per_qos": per_qos, "wire": wire, "serving": snap,
           "step_ms": step_ms,
           "tokens_equal_engine_phase": equal_local,
           "kv_ship": kv_ship, "kv_ship_engine": ship_snap,
           "prefill_tier": tier,
           "pool_nbytes": runner.nbytes, "hbm_charged_while_serving": held,
           "hbm_charged_after_stop": released, "compute_charged": charged,
           "kernel_launches": launches,
           "graphs_captured": len(runner.graphs), "capture_s": runner.capture_s,
           "phase_s": time.perf_counter() - t_phase}
    emit("remote_serve", **row)

    problems = []
    for tenant, prompt, new in requests:
        r = results[tenant][0]
        if r["finish_reason"] != "length" or len(r["tokens"]) != new or not all(
                0 <= t < cfg.vocab_size for t in r["tokens"]):
            problems.append(f"{tenant} ended {r['finish_reason']} with "
                            f"{len(r['tokens'])} of {new} tokens")
    for tag, want in zip(kv_ship, (128, 32, 32, 32)):
        if kv_ship[tag]["new_tokens"] != want or kv_ship[tag]["blocks"] != 64:
            problems.append(f"KV_SHIP {tag}: {kv_ship[tag]}")
    if ship_snap["ships"] != len(ship_prompts) or ship_snap["dedup_blocks"] <= 0:
        problems.append(f"KV_SHIP counters {ship_snap}: want {len(ship_prompts)} "
                        f"ships and the shared prefix deduplicated")
    if held != runner.nbytes or released != 0:
        problems.append(f"pool of {runner.nbytes} B: the meter held {held} while "
                        f"serving and {released} after stop")
    if charged != {"launches": 0, "mflops": 0}:
        problems.append(f"compute charged for engine steps: {charged}")
    if any(launches.values()):
        problems.append(f"kernels launched on the paged path: {launches}")
    if final["kv"]["used"] != 0:
        problems.append(f"the pool kept blocks: {final['kv']}")
    if problems:
        raise RuntimeError("remote_serve phase: " + "; ".join(problems))
    return launches


def phase_remote_serve_check(torch, llama, remoting, serving, cfg):
    """f32 at full width, 2 layers, through a worker-hosted engine: remote
    GENERATE tokens equal ``generate``'s for 5 ragged requests sent from 3
    concurrent connections; a KV_SHIP of a prefill tier's pages gives the
    GENERATE tokens of the same prompt; a q8-negotiated connection gives
    the raw connection's tokens."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=2,
                                attn_impl="full")
    p32 = llama.init_params(cfg32, torch.Generator(device=DEVICE).manual_seed(8),
                            device=DEVICE)
    rng = random.Random(13)
    requests = [(f"r{i}", [rng.randrange(cfg.vocab_size) for _ in range(n)], new)
                for i, (n, new) in enumerate(((100, 12), (333, 8), (64, 20),
                                              (700, 10), (257, 16)))]
    engine = serving.ServingEngine(
        serving.LlamaRunner(p32, cfg32, num_blocks=257, block_size=16, device=DEVICE),
        max_batch=4, prefill_chunk_tokens=128)
    worker = remoting.RemoteVTPUWorker(engine=engine, device=DEVICE)
    worker.start()
    try:
        devs = [remoting.RemoteDevice(worker.url, timeout_s=600) for _ in range(3)]
        q8 = remoting.RemoteDevice(worker.url, timeout_s=600, quantize=True)
        shipper = serving.RemoteKVShipper(worker.url)
        try:
            results, failures, _ = _client_threads(
                devs, requests, lambda i: i, 0.05,
                lambda d, p, n, cb: d.generate(p, n, on_token=cb))
            if failures:
                raise RuntimeError(f"f32 remote GENERATEs failed: {failures}")
            _, prompt, new = requests[3]
            payloads, _ = _prefill_tier(serving, serving.LlamaRunner(
                p32, cfg32, num_blocks=257, block_size=16, device=DEVICE),
                [("ship", prompt)])
            shipped = shipper.ship(prompt, payloads["ship"], new)["tokens"]
            quantized = q8.generate(prompt, new)["tokens"]
            q8_on = q8.info()["quant_on"]
        finally:
            shipper.close()
            q8.close()
            for d in devs:
                d.close()
    finally:
        worker.stop()
    problems = []
    for tenant, p, n in requests:
        want = llama.generate(p32, torch.tensor([p], device=DEVICE), n, cfg32,
                              device=DEVICE)[0].tolist()
        if results[tenant][0]["tokens"] != want:
            problems.append(f"remote tokens of {tenant} differ from generate")
    raw = results[requests[3][0]][0]["tokens"]
    if shipped != raw:
        problems.append(f"KV_SHIP tokens {shipped} differ from GENERATE's {raw}")
    if quantized != raw or not q8_on:
        problems.append(f"q8 tokens {quantized} (q8 on: {q8_on}) differ from raw {raw}")
    if engine.snapshot()["kv"]["used"] != 0:
        problems.append("the f32 pool kept blocks")
    if problems:
        raise RuntimeError("remote_serve_check: " + "; ".join(problems))
    emit("remote_serve_check", f32_requests=[[len(p), n] for _, p, n in requests],
         connections=len(devs), f32_remote_tokens_equal_generate=True,
         kv_ship_tokens_equal_generate=True, q8_tokens_equal_raw=True)


def _train_batch(torch, vocab, shape, seed, device=None):
    """Random tokens from ``seed`` on ``device`` (default DEVICE); the
    targets are the next tokens."""
    device = device or DEVICE
    gen = torch.Generator(device=device).manual_seed(seed)
    b, t = shape
    toks = torch.randint(0, vocab, (b, t + 1), generator=gen, device=device)
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
        bf16[name] = {"flash_vs_full": _rel(flash[name], full[name]),
                      "flash_vs_f32": _rel(flash[name], exact[name]),
                      "full_vs_f32": _rel(full[name], exact[name])}
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


def _last_logits(llama, cfg):
    """The remote path's function: a forward of ``cfg`` that returns the
    last position's f32 logits [B, vocab] (the lm_head product of that
    position alone)."""

    def last_logits(params, tokens):
        x = params["tok_emb"][tokens.long()]
        for layer in params["layers"]:
            x = llama._layer(cfg, layer, x)
        x = llama._rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
        return llama._mm(x, params["lm_head"]).float()

    return last_logits


def _quantiles_ms(samples):
    s = sorted(samples)
    return {"p50": s[len(s) // 2] * 1e3,
            "p99": s[min(int(0.99 * (len(s) - 1)), len(s) - 1)] * 1e3,
            "n": len(s)}


def phase_remote(torch, ops, llama, remoting, estimate_flops, bench_train,
                 limiter_lib, cfg, smi):
    """Remote execution on the card: a RemoteVTPUWorker that owns it,
    metered on a fresh limiter segment, and a RemoteDevice in this
    process over loopback.  The 8-layer Llama-3-8B-width weights (bf16,
    from a fixed seed) are PUT resident; ``remote_jit`` of the
    last-position forward (flash attention) runs REMOTE_CALLS times at
    each MAIN_SHAPES shape, its kernel launches counted from 0 over
    those calls alone.  Each shape's result is held against the local
    forward on the same weights (argmax equal; logits no further from
    an f32 dense run than 1.5x the bf16 dense path's own distance), the
    worker's charge against the local estimate_flops, and the resident
    bytes against the weights'.  Then a step_resident chain of 8
    decoder-layer steps against the local chain, and a micro-batched
    burst of 4 submits from two connections against the unfused
    results; at the end every buffer is freed and the charge is 0."""
    t_phase = time.perf_counter()
    tree_map = torch.utils._pytree.tree_map
    leaves = torch.utils._pytree.tree_leaves
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    params = llama.init_params(cfg, gen, device=DEVICE)
    host = tree_map(lambda t: t.cpu(), params)
    weights_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    fn = _last_logits(llama, cfg)
    shapes = [(b, t, torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                                   device=DEVICE)) for b, t in MAIN_SHAPES]

    # local references, before the counted window: the same call on the
    # card (timed), the dense bf16 path, and the dense path in f32
    local = {}
    full = _last_logits(llama, dataclasses.replace(cfg, attn_impl="full"))
    exact_fn = _last_logits(llama, dataclasses.replace(
        cfg, dtype=torch.float32, attn_impl="full"))
    p32 = _float(params)
    for b, t, tokens in shapes:
        want = fn(params, tokens)
        local_s = []
        for _ in range(5):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            fn(params, tokens)
            torch.cuda.synchronize()
            local_s.append(time.perf_counter() - s0)
        local[(b, t)] = {
            "logits": want, "ms": sorted(local_s)[2] * 1e3,
            "full": full(params, tokens), "exact": exact_fn(p32, tokens),
            "mflops": max(int(estimate_flops(fn, (params, tokens), {}) / 1e6), 1)}
    del p32
    torch.cuda.empty_cache()

    with bench_train.worker_segment(limiter_lib, WORK / "remote", "remote",
                                    DEVICE) as meter:
        worker = remoting.RemoteVTPUWorker(meter_client=meter,
                                           max_resident_bytes=4 * weights_bytes,
                                           device=DEVICE)
        worker.start()
        try:
            dev = remoting.RemoteDevice(worker.url, timeout_s=600)
            dev2 = remoting.RemoteDevice(worker.url, timeout_s=600)
            try:
                s0 = time.perf_counter()
                rparams = tree_map(dev.put, host)
                put_s = time.perf_counter() - s0
                charged_resident = meter.hbm_charged_bytes
                # micro-batchable: the counted calls, one at a time, run
                # alone; the burst below fuses behind a plug
                remote = dev.remote_jit(fn, microbatch=True)
                compile_s = {}
                for b, t, tokens in shapes:
                    s0 = time.perf_counter()
                    remote.compile_for(rparams, tokens.cpu())
                    compile_s[f"{b}x{t}"] = time.perf_counter() - s0
                # the counted window: the remote calls alone
                wire0, rx0 = dict(dev.wire_stats), dict(dev.rx_stats)
                launches0, mflops0 = meter.launches, meter.charged_mflops
                got, round_trips = {}, {}
                ops.reset_launch_counts()
                for b, t, tokens in shapes:
                    host_tokens = tokens.cpu()
                    round_trips[(b, t)] = []
                    for _ in range(REMOTE_CALLS):
                        s0 = time.perf_counter()
                        got[(b, t)] = remote(rparams, host_tokens)
                        round_trips[(b, t)].append(time.perf_counter() - s0)
                launches = ops.launch_counts()
                calls = REMOTE_CALLS * len(shapes)
                out_bytes = dev.wire_stats["wire_bytes"] - wire0.get("wire_bytes", 0)
                in_bytes = dev.rx_stats["wire_bytes"] - rx0.get("wire_bytes", 0)
                charged = {"launches": meter.launches - launches0,
                           "mflops": meter.charged_mflops - mflops0}

                # where a call's time goes: the client's and the worker's
                # spans (mean ms) of 3 traced calls at the first shape
                from tensorfusion_tpu_torch.tracing import Tracer

                dev.tracer = Tracer(service="chip-smoke")
                for _ in range(3):
                    remote(rparams, shapes[0][2].cpu())
                spans = {}
                for span in dev.tracer.finished():
                    spans.setdefault(span["name"], []).append(span["dur_us"] / 1e3)
                span_ms = {name: sum(v) / len(v) for name, v in spans.items()}
                dev.tracer = None

                # step_resident: 8 decoder-layer steps on layer 0's weights,
                # the hidden state resident, each step freeing the last
                layer_fn = dev.remote_jit(lambda layer, x: llama._layer(cfg, layer, x))
                tokens = shapes[0][2]
                x0 = params["tok_emb"][tokens.long()]
                state = dev.put(x0.cpu())
                want_x = x0
                chain_launch0 = ops.launch_counts()["flash_attn_fwd"]
                s0 = time.perf_counter()
                for _ in range(8):
                    state = layer_fn.step_resident(rparams["layers"][0], state,
                                                   free=state)
                chained = state.fetch()
                chain_s = time.perf_counter() - s0
                chain_launches = ops.launch_counts()["flash_attn_fwd"] - chain_launch0
                for _ in range(8):
                    want_x = llama._layer(cfg, params["layers"][0], want_x)
                chain_rel = _rel(chained, want_x.cpu())
                state.free()

                # micro-batched burst: a plug, then 4 submits alternating
                # between two connections, of one opted-in executable
                b, t, _ = shapes[1]
                burst_tokens = [torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                                              device=DEVICE).cpu() for _ in range(4)]
                mbs = [remote, dev2.remote_jit(fn, microbatch=True)]
                mbs[1].compile_for(rparams, burst_tokens[0])
                unfused = [remote(rparams, tk) for tk in burst_tokens]
                d0 = dev.info()["dispatch"]
                mflops_b0 = meter.charged_mflops
                plug = remote.submit(rparams, shapes[0][2].cpu())
                futs = [mbs[i % 2].submit(rparams, tk)
                        for i, tk in enumerate(burst_tokens)]
                fused = [f.result(timeout=600) for f in futs]
                plug.result(timeout=600)
                d1 = dev.info()["dispatch"]
                burst = {"requests": len(futs) + 1,
                         "dispatches": d1["launches"] - d0["launches"],
                         "microbatched_requests": d1["microbatched_requests"]
                         - d0["microbatched_requests"],
                         "charged_mflops": meter.charged_mflops - mflops_b0,
                         "results_equal_unfused": all(
                             torch.equal(f, u) for f, u in zip(fused, unfused))}
                want_burst_mflops = local[shapes[0][:2]]["mflops"] + \
                    len(futs) * local[(b, t)]["mflops"]

                for leaf in leaves(rparams):
                    leaf.free()
                info = dev.info()
                released = meter.hbm_charged_bytes
            finally:
                dev.close()
                dev2.close()
        finally:
            worker.stop()

    rows = []
    for b, t, _ in shapes:
        ref = local[(b, t)]
        out = got[(b, t)].to(DEVICE)
        bf16 = {"remote_vs_local": _rel(out, ref["logits"]),
                "remote_vs_f32": _rel(out, ref["exact"]),
                "full_vs_f32": _rel(ref["full"], ref["exact"])}
        rows.append({"batch": b, "prompt": t,
                     "equal_local": torch.equal(out, ref["logits"]),
                     "argmax_equal_local": torch.equal(out.argmax(-1),
                                                       ref["logits"].argmax(-1)),
                     "max_abs_logit_diff_vs_local":
                         (out - ref["logits"]).abs().max().item(),
                     "bf16_rel": bf16, "local_ms": ref["ms"],
                     "execute_ms": _quantiles_ms(round_trips[(b, t)]),
                     "local_mflops": ref["mflops"]})
    row = {"nvidia_smi": smi, "dim": cfg.dim, "n_layers": cfg.n_layers,
           "vocab": cfg.vocab_size, "dtype": str(cfg.dtype), "attn_impl": cfg.attn_impl,
           "weights_bytes": weights_bytes, "put_s": put_s,
           "upload_gb_s": weights_bytes / put_s / 1e9,
           "resident_bytes_charged": charged_resident,
           "resident_bytes_after_free": released,
           "worker_resident_bytes_after_free": info["resident_bytes"],
           "compile_s": compile_s, "calls": calls, "calls_per_shape": REMOTE_CALLS,
           "kernel_launches": launches,
           "launches_per_call": launches["flash_attn_fwd"] / calls,
           "charged": charged,
           "local_estimate_mflops": REMOTE_CALLS * sum(r["local_mflops"] for r in rows),
           "wire_bytes_per_call": {"out": out_bytes / calls, "in": in_bytes / calls},
           "shapes": rows,
           "traced_call_span_ms": span_ms,
           "step_resident": {"steps": 8, "s": chain_s, "flash_launches": chain_launches,
                             "rel_vs_local": chain_rel},
           "burst": burst, "burst_expected_mflops": want_burst_mflops,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "phase_s": time.perf_counter() - t_phase}
    emit("remote", **row)

    want_mflops = row["local_estimate_mflops"]
    problems = []
    if charged_resident != weights_bytes or released != 0 or info["resident_bytes"]:
        problems.append(f"resident bytes charged {charged_resident} of {weights_bytes}, "
                        f"{released} after FREE (worker {info['resident_bytes']})")
    if launches["flash_attn_fwd"] != cfg.n_layers * calls:
        problems.append(f"flash kernel ran {launches} times over {calls} remote "
                        f"calls of {cfg.n_layers} layers")
    if charged != {"launches": calls, "mflops": want_mflops}:
        problems.append(f"worker charged {charged}, the local estimate is "
                        f"{want_mflops} MFLOPs over {calls} launches")
    for r in rows:
        # the same ops and kernel on the same card: the wire adds nothing
        if not r["equal_local"]:
            problems.append(f"remote logits differ from local at {r['batch']}x"
                            f"{r['prompt']}: max abs {r['max_abs_logit_diff_vs_local']}")
        if not r["argmax_equal_local"]:
            problems.append(f"remote argmax differs from local at {r['batch']}x{r['prompt']}")
        if not r["bf16_rel"]["remote_vs_f32"] <= 1.5 * r["bf16_rel"]["full_vs_f32"]:
            problems.append(f"remote logits too far from f32: {r['bf16_rel']}")
    if chain_launches != 8 or not chain_rel <= 1e-2:
        problems.append(f"step_resident chain: {chain_launches} launches, "
                        f"rel {chain_rel:.3g} vs local")
    if not burst["results_equal_unfused"] or \
            burst["charged_mflops"] != want_burst_mflops:
        problems.append(f"micro-batched burst: {burst}, want {want_burst_mflops} MFLOPs")
    if problems:
        raise RuntimeError("remote phase: " + "; ".join(problems))
    return launches


def _replica(torch, remoting, dev, tree):
    """The handles of ``tree`` (RemoteBuffers of one worker) bound to the
    connection ``dev`` under the same buffer ids: a tenant rebinding to
    another worker after a migration or a restore."""
    return torch.utils._pytree.tree_map(
        lambda h: remoting.RemoteBuffer(dev, h.buf_id, h.shape, h.dtype), tree)


def _meter_row(meter):
    return {"launches": meter.launches, "mflops": meter.charged_mflops,
            "hbm_bytes": meter.hbm_charged_bytes}


def phase_federation(torch, ops, llama, remoting, bench_train, limiter_lib, cfg,
                     params, host, smi):
    """Federated execution over three metered workers on the card, each on
    its own limiter segment, reached over loopback:

    (a) ``federated_jit`` of the last-position forward (flash) over two of
        them, each holding a replica of the 8-layer weights; a 4 x 1024
        batch splits 2 + 2 and gathers by concat.  Each half must equal the
        local forward of that half bit for bit (same card, same shapes), and
        the whole keep the local argmax and the 1.5x rule against f32.
    (b) a fabric-ring ``all_reduce`` over all three of per-worker bf16
        partials the size of one decoder layer's weights, raw and then q8,
        installed on every member: raw bit-equal to the ring's own
        arithmetic (f32 adds, one bf16 rounding a hop) done locally, q8
        within the per-hop bound, no payload through the client.
    (c) ``model_parallel_jit`` of layer 0's SwiGLU MLP split along the
        hidden 14336 over the three workers: the [4, 1024, 4096] bf16
        partials go through the ring; the result must equal the local
        emulation (the same shards on the card, the ring's sum) bit for bit
        and sit within bf16 mean|err|/mean|ref| < 2e-2 of the f32 MLP.

    ``fed_supported()`` and ``fabric_supported()`` must hold, so the card
    run cannot take the protocol fallback.  The flash launches of (a)-(c)
    are counted from 0."""
    import contextlib

    from tensorfusion_tpu_torch.remoting.federation import _split_points

    t_phase = time.perf_counter()
    fn = _last_logits(llama, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    b, t = MAIN_SHAPES[0]
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device=DEVICE)
    points = _split_points(b, 2)
    halves = [(points[i], points[i + 1]) for i in range(2)]

    # local references, before the counted window
    want = fn(params, tokens)
    want_halves = [fn(params, tokens[lo:hi]) for lo, hi in halves]
    full = _last_logits(llama, dataclasses.replace(cfg, attn_impl="full"))(
        params, tokens)
    p32 = _float(params)
    exact = _last_logits(llama, dataclasses.replace(
        cfg, dtype=torch.float32, attn_impl="full"))(p32, tokens)
    del p32
    layer0 = params["layers"][0]
    layer_numel = sum(v.numel() for v in torch.utils._pytree.tree_leaves(layer0))
    parts = [torch.randn(layer_numel, generator=gen, device=DEVICE,
                         dtype=torch.float32).to(cfg.dtype) for _ in range(3)]
    ring_want = parts[0]
    # the largest magnitude any hop ships: a partial, a running sum, the total
    ring_max = float(ring_want.float().abs().max())
    for p in parts[1:]:
        ring_want = (p.float() + ring_want.float()).to(cfg.dtype)
        ring_max = max(ring_max, float(ring_want.float().abs().max()))
    parts_host = [p.cpu() for p in parts]
    ring_want = ring_want.cpu()
    del parts
    mlp_x = torch.randn((b, t, cfg.dim), generator=gen, device=DEVICE,
                        dtype=torch.float32).to(cfg.dtype)
    wg, wu, wd = (layer0["mlp"][k] for k in ("w_gate", "w_up", "w_down"))
    hidden = _split_points(wg.shape[1], 3)

    def stage1(w_gate, w_up, w_down, x):
        return llama._mlp({"w_gate": w_gate, "w_up": w_up, "w_down": w_down}, x)

    def stage2(a):
        return a.float()

    mlp_parts = [stage1(wg[:, lo:hi].contiguous(), wu[:, lo:hi].contiguous(),
                        wd[lo:hi].contiguous(), mlp_x)
                 for lo, hi in zip(hidden, hidden[1:])]
    mlp_emul = mlp_parts[0]
    for p in mlp_parts[1:]:
        mlp_emul = (p.float() + mlp_emul.float()).to(cfg.dtype)
    mlp_emul = mlp_emul.float().cpu()
    mlp_local = stage1(wg, wu, wd, mlp_x).float().cpu()
    mlp_f32 = stage1(wg.float(), wu.float(), wd.float(), mlp_x.float()).cpu()
    mlp_args = [w.cpu() for w in (wg, wu, wd)] + [mlp_x.cpu()]
    del mlp_parts
    torch.cuda.empty_cache()

    host_tokens = tokens.cpu()
    with contextlib.ExitStack() as stack:
        meters = [stack.enter_context(bench_train.worker_segment(
            limiter_lib, WORK / f"fed{i}", f"fed{i}", DEVICE)) for i in range(3)]
        workers = [remoting.RemoteVTPUWorker(meter_client=m, device=DEVICE)
                   for m in meters]
        for w in workers:
            w.start()
            stack.callback(w.stop)
        fed2 = remoting.FederatedDevice([w.url for w in workers[:2]], timeout_s=900)
        stack.callback(fed2.close)
        fed3 = remoting.FederatedDevice([w.url for w in workers], ring=True,
                                        timeout_s=900)
        stack.callback(fed3.close)
        fed3q = remoting.FederatedDevice([w.url for w in workers], ring=True,
                                         quantize=True, timeout_s=900)
        stack.callback(fed3q.close)
        supported = {"fed2": fed2.fed_supported(), "fed3": fed3.fed_supported(),
                     "fabric3": fed3.fabric_supported(),
                     "fabric3_q8": fed3q.fabric_supported()}
        if not all(supported.values()):
            raise RuntimeError(f"federation phase would take the protocol "
                               f"fallback: {supported}")

        # (a) data parallel: a replica per member, the batch split 2 + 2
        s0 = time.perf_counter()
        replicas = [torch.utils._pytree.tree_map(dev.put, host)
                    for dev in fed2.workers]
        put_s = time.perf_counter() - s0
        ffn = fed2.federated_jit(fn, in_axes=(None, 0), out_modes="concat")
        s0 = time.perf_counter()
        ffn(replicas, host_tokens)          # export and COMPILE on both
        compile_s = time.perf_counter() - s0
        # beside the federated call: one member's call of its half alone,
        # and the local call of that half (outside the counted window)
        lo, hi = halves[0]
        member = ffn.on(fed2.workers[0])
        member_s = []
        for _ in range(FED_CALLS):
            s0 = time.perf_counter()
            member(replicas[0], host_tokens[lo:hi])
            member_s.append(time.perf_counter() - s0)
        local_half_s = []
        for _ in range(FED_CALLS):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            fn(params, tokens[lo:hi])
            torch.cuda.synchronize()
            local_half_s.append(time.perf_counter() - s0)

        ops.reset_launch_counts()
        call_s = []
        for _ in range(FED_CALLS):
            s0 = time.perf_counter()
            got = ffn(replicas, host_tokens)
            call_s.append(time.perf_counter() - s0)
        calls_launches = ops.launch_counts()["flash_attn_fwd"]

        # (b) the fabric ring, raw then q8, on the same partials
        handles = [dev.put(p) for dev, p in zip(fed3.workers, parts_host)]
        ring = {}
        for tag, fed in (("raw", fed3), ("q8", fed3q)):
            s0 = time.perf_counter()
            out = fed.all_reduce(handles, install=True, fetch_value=False)
            wall = time.perf_counter() - s0
            totals = [h.fetch() for h in out["handles"]]
            for h in out["handles"]:
                h.free()
            errs = [(tot.float() - ring_want.float()).abs().max().item()
                    for tot in totals]
            # the hops run one after another, so bytes over the wall
            # time is each leg's rate
            ring[tag] = {"wall_s": wall, "raw_bytes": out["raw_bytes"],
                         "wire_bytes": out["wire_bytes"],
                         "hops": 2 * (len(workers) - 1),
                         "leg_gb_s": out["raw_bytes"] / wall / 1e9,
                         "equal_on_every_member": all(torch.equal(tot, ring_want)
                                                      for tot in totals),
                         "max_abs_err": max(errs),
                         "client_relay_bytes": fed.fed_snapshot()["client_relay_bytes"]}
        for h in handles:
            h.free()
        # the q8 ring against the raw one on member 0's path (n-1 reduce
        # hops, then n-1 install hops): each hop's codec is off by at most
        # half a block scale (max|block| / 254), the received value is
        # stored as bf16 (half an ulp, at most 2^-8 of the magnitude), and
        # a reduce hop's sum, rounded once to bf16, may land one ulp (two
        # half ulps) from the raw ring's
        n_hops = len(workers) - 1
        half_ulp = ring_max * 2.0 ** -8
        q8_bound = 2 * n_hops * ring_max / 254 + (3 * n_hops + n_hops) * half_ulp

        # (c) model parallel MLP over the ring
        mp = fed3.model_parallel_jit(stage1, stage2,
                                     stage1_in_axes=(1, 1, 0, None))
        mp(*mlp_args)                      # export and COMPILE
        s0 = time.perf_counter()
        mlp_got = mp(*mlp_args)
        mp_s = time.perf_counter() - s0
        launches = ops.launch_counts()

        infos = [dev.info() for dev in fed3.workers]
        charges = [_meter_row(m) for m in meters]
        fed_snaps = {"fed2": fed2.fed_snapshot(), "fed3": fed3.fed_snapshot(),
                     "fed3_q8": fed3q.fed_snapshot()}
        for rep in replicas:
            for h in torch.utils._pytree.tree_leaves(rep):
                h.free()
        resident_after = [w.resident_bytes for w in workers]

    got_dev = got.to(DEVICE)
    halves_equal = [torch.equal(got_dev[lo:hi], w)
                    for (lo, hi), w in zip(halves, want_halves)]
    bf16 = {"fed_vs_local": _rel(got_dev, want), "fed_vs_f32": _rel(got_dev, exact),
            "full_vs_f32": _rel(full, exact)}
    mlp_mean_rel = ((mlp_got - mlp_f32).abs().mean() / mlp_f32.abs().mean()).item()
    row = {"nvidia_smi": smi, "dim": cfg.dim, "n_layers": cfg.n_layers,
           "dtype": str(cfg.dtype), "workers": len(workers),
           "supported": supported,
           "data_parallel": {
               "members": 2, "batch": b, "prompt": t, "split": points,
               "replica_bytes": 2 * sum(x.numel() * x.element_size()
                                        for x in torch.utils._pytree.tree_leaves(host)),
               "put_s": put_s, "compile_s": compile_s,
               "call_ms": _quantiles_ms(call_s), "calls": FED_CALLS,
               "member_half_call_ms": _quantiles_ms(member_s),
               "local_half_ms": _quantiles_ms(local_half_s),
               "flash_launches": calls_launches,
               "halves_equal_local": halves_equal,
               "argmax_equal_local": torch.equal(got_dev.argmax(-1), want.argmax(-1)),
               "bf16_rel": bf16},
           "ring": {"elements": layer_numel, "bytes_per_partial":
                    layer_numel * parts_host[0].element_size(), **ring,
                    "q8_bound": q8_bound},
           "model_parallel": {"split": hidden, "s": mp_s,
                              "equal_local_emulation": torch.equal(mlp_got, mlp_emul),
                              "mean_rel_vs_f32": mlp_mean_rel,
                              "single_worker_mean_rel_vs_f32": (
                                  (mlp_local - mlp_f32).abs().mean()
                                  / mlp_f32.abs().mean()).item(),
                              "max_abs_vs_single_worker":
                                  (mlp_got - mlp_local).abs().max().item()},
           "kernel_launches": launches, "charges": charges,
           "fed_snapshot": fed_snaps,
           "fabric": [i["fabric"] for i in infos],
           "resident_bytes_after_free": resident_after,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "phase_s": time.perf_counter() - t_phase}
    emit("federation", **row)

    problems = []
    if calls_launches != 2 * cfg.n_layers * FED_CALLS:
        problems.append(f"{calls_launches} flash launches over {FED_CALLS} "
                        f"federated calls of 2 x {cfg.n_layers} layers")
    if not all(halves_equal):
        problems.append(f"federated halves differ from the local forward: {halves_equal}")
    if not row["data_parallel"]["argmax_equal_local"]:
        problems.append("federated argmax differs from local")
    if not bf16["fed_vs_f32"] <= 1.5 * bf16["full_vs_f32"]:
        problems.append(f"federated logits too far from f32: {bf16}")
    if not ring["raw"]["equal_on_every_member"]:
        problems.append(f"raw ring total differs: max abs {ring['raw']['max_abs_err']}")
    if not ring["q8"]["max_abs_err"] <= q8_bound:
        problems.append(f"q8 ring error {ring['q8']['max_abs_err']} > bound {q8_bound}")
    if ring["raw"]["client_relay_bytes"] or ring["q8"]["client_relay_bytes"] or \
            fed_snaps["fed3"]["client_relay_bytes"]:
        problems.append(f"collective bytes through the client: {fed_snaps}")
    if not ring["q8"]["wire_bytes"] < ring["raw"]["wire_bytes"]:
        problems.append(f"q8 ring moved no fewer bytes: {ring}")
    if not row["model_parallel"]["equal_local_emulation"] or not mlp_mean_rel < 2e-2:
        problems.append(f"model-parallel MLP: {row['model_parallel']}")
    if any(resident_after):
        problems.append(f"resident bytes left after FREE: {resident_after}")
    if problems:
        raise RuntimeError("federation phase: " + "; ".join(problems))
    return launches


def _engine_freeze(torch, remoting, serving, params, cfg):
    """A worker hosting a one-request engine (one sequence, so every step
    has the same batch shape and bf16 tokens are comparable): one
    streamed GENERATE runs through, then the same prompt again with a
    MIGRATE_FREEZE after FREEZE_AT tokens, FREEZE_S seconds frozen and an
    abort.  Returns the window's token counts and both streams."""
    gen = torch.Generator().manual_seed(41)
    prompt = torch.randint(0, cfg.vocab_size, (64,), generator=gen).tolist()
    out = {}
    for tag in ("plain", "frozen"):
        runner = serving.LlamaRunner(params, cfg, num_blocks=FREEZE_POOL[0],
                                     block_size=FREEZE_POOL[1], device=DEVICE)
        engine = serving.ServingEngine(runner, max_batch=1)
        worker = remoting.RemoteVTPUWorker(engine=engine, device=DEVICE)
        worker.start()
        dev = remoting.RemoteDevice(worker.url, timeout_s=600)
        orch = remoting.RemoteDevice(worker.url, timeout_s=600)
        try:
            got, result, failure = [], {}, []

            def run():
                try:
                    result.update(dev.generate(prompt, FREEZE_NEW,
                                               on_token=got.append))
                except Exception as e:  # noqa: BLE001 - raised below
                    failure.append(f"{type(e).__name__}: {e}")

            th = threading.Thread(target=run)
            th.start()
            row = {}
            if tag == "frozen":
                deadline = time.monotonic() + 300
                while len(got) < FREEZE_AT and th.is_alive() and \
                        time.monotonic() < deadline:
                    time.sleep(0.001)
                s0 = time.perf_counter()
                orch.migrate_freeze()
                row["freeze_ms"] = (time.perf_counter() - s0) * 1e3
                made = engine.snapshot()["tokens"]
                while len(got) < made and time.monotonic() < deadline:
                    time.sleep(0.001)       # frames sent before the freeze
                n0, t0 = len(got), time.perf_counter()
                time.sleep(FREEZE_S)
                row.update(tokens_at_freeze=n0,
                           client_tokens_while_frozen=len(got) - n0,
                           engine_tokens_while_frozen=engine.snapshot()["tokens"] - made,
                           frozen_s=time.perf_counter() - t0)
                s0 = time.perf_counter()
                orch.migrate_commit(abort=True)
                row["thaw_ms"] = (time.perf_counter() - s0) * 1e3
            th.join(timeout=600)
            if failure or "tokens" not in result:
                raise RuntimeError(f"{tag} GENERATE failed: {failure}")
            row["tokens"] = result["tokens"]
            row["graphs"] = len(runner.graphs)
            out[tag] = row
        finally:
            dev.close()
            orch.close()
            worker.stop()
        del runner, engine
        torch.cuda.empty_cache()
    return out


def phase_migrate(torch, ops, llama, remoting, serving, bench_train, limiter_lib,
                  cfg, params, host, smi):
    """Streaming live migration and SNAPSHOT / RESTORE on the card, all
    workers metered on their own segments.  A source worker holds the
    8-layer weights resident and the compiled last-position forward; a
    tenant's ``step_resident`` chain (decoder layer 0 over a resident
    hidden state) rewrites its state buffer between pre-copy rounds.
    Two SNAPSHOT_DELTA rounds go to a target on the same card (the first
    carries the weights, the second only what was dirtied), then
    MIGRATE_FREEZE and MIGRATE_COMMIT; the tenant calls the same program
    on the same buffer ids on the target, which must equal the source's
    pre-freeze result bit for bit, the source must hold and be charged 0
    bytes and the target be charged the state.  An aborted migration
    must leave its source intact.  A worker hosting a one-request engine
    is frozen mid-stream (no token may be made or arrive, the tokens must
    equal an unfrozen stream's).  Last the target SNAPSHOTs into its
    state root and a fresh worker RESTOREs it and executes bit-equal.
    The flash launches of the whole phase are counted from 0."""
    import contextlib
    import shutil

    t_phase = time.perf_counter()
    tree_map = torch.utils._pytree.tree_map
    leaves = torch.utils._pytree.tree_leaves
    fn = _last_logits(llama, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    b, t = MAIN_SHAPES[0]
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                           device=DEVICE)
    x0 = params["tok_emb"][tokens.long()].cpu()
    tokens = tokens.cpu()
    weights_bytes = sum(x.numel() * x.element_size() for x in leaves(host))
    state_root = WORK / "state_root"
    shutil.rmtree(state_root, ignore_errors=True)
    state_root.mkdir(parents=True)
    need = int(weights_bytes * 1.1) + (2 << 30)
    free = shutil.disk_usage(state_root).free
    if free < need:
        raise RuntimeError(f"migrate phase: {free / 1e9:.1f} GB free under "
                           f"{state_root}, the snapshot needs {need / 1e9:.1f} GB")

    with contextlib.ExitStack() as stack:
        stack.callback(shutil.rmtree, state_root, True)
        m_src, m_tgt, m_new = [stack.enter_context(bench_train.worker_segment(
            limiter_lib, WORK / f"mig{i}", f"mig{i}", DEVICE)) for i in range(3)]
        src = remoting.RemoteVTPUWorker(meter_client=m_src, device=DEVICE)
        tgt = remoting.RemoteVTPUWorker(meter_client=m_tgt, device=DEVICE,
                                        state_root=str(state_root))
        for w in (src, tgt):
            w.start()
            stack.callback(w.stop)
        ten = remoting.RemoteDevice(src.url, timeout_s=900)
        orch = remoting.RemoteDevice(src.url, timeout_s=900)
        stack.callback(ten.close)
        stack.callback(orch.close)
        s0 = time.perf_counter()
        rparams = tree_map(ten.put, host)
        put_s = time.perf_counter() - s0
        # one export, shared (``remote.on``) by the tenant's wrappers on the
        # target and on the restored worker
        remote = ten.remote_jit(fn)
        remote.compile_for(rparams, tokens)
        layer_fn = ten.remote_jit(lambda layer, x: llama._layer(cfg, layer, x))
        state = ten.put(x0)
        layer_fn.compile_for(rparams["layers"][0], state)

        ops.reset_launch_counts()
        # the chain's steps are fire-and-forget; a FETCH on the tenant's
        # connection waits for them and their FREEs, so each round sees
        # a settled dirty set
        state = layer_fn.step_resident(rparams["layers"][0], state, free=state)
        state.fetch()
        rounds = [orch.snapshot_delta(tgt.url)]
        for _ in range(2):
            state = layer_fn.step_resident(rparams["layers"][0], state, free=state)
        want_state = state.fetch()
        rounds.append(orch.snapshot_delta(tgt.url))
        want = remote(rparams, tokens)          # the source's pre-freeze result
        freeze = orch.migrate_freeze()
        commit = orch.migrate_commit()
        after = {"source_resident_bytes": src.resident_bytes,
                 "source_charged_bytes": m_src.hbm_charged_bytes,
                 "target_resident_bytes": tgt.resident_bytes,
                 "target_charged_bytes": m_tgt.hbm_charged_bytes}

        # the tenant rebinds to the target: the same ids, the same program
        tdev = remoting.RemoteDevice(tgt.url, timeout_s=900)
        stack.callback(tdev.close)
        tparams = _replica(torch, remoting, tdev, rparams)
        s0 = time.perf_counter()
        got = remote.on(tdev)(tparams, tokens)
        target_call_s = time.perf_counter() - s0
        # the chain's client-minted id moved to a fresh namespace there:
        # the tenant reads it from INFO on its source connection
        moved = ten.info()["migration"]["moved"]
        if moved["target_url"] != tgt.url:
            raise RuntimeError(f"migrate phase: INFO moved names {moved['target_url']}")
        got_state = remoting.RemoteBuffer(tdev, moved["ids"][state.buf_id],
                                          state.shape, state.dtype).fetch()

        # an aborted migration leaves its source intact
        tgt_before = tgt.resident_bytes
        small = ten.put(x0)
        abort_round = orch.snapshot_delta(tgt.url)
        orch.migrate_freeze()
        aborted = orch.migrate_commit(abort=True)
        deadline = time.monotonic() + 30
        while tgt.resident_bytes != tgt_before and time.monotonic() < deadline:
            time.sleep(0.01)
        abort = {"round": abort_round, "reply": aborted,
                 "source_intact": torch.equal(small.fetch(), x0),
                 "source_resident_bytes": src.resident_bytes,
                 "target_staged_freed": tgt.resident_bytes == tgt_before}
        small.free()

        engine = _engine_freeze(torch, remoting, serving, params, cfg)

        # SNAPSHOT the target, RESTORE into a fresh worker, EXECUTE there
        s0 = time.perf_counter()
        snap = tdev.snapshot("snapshot")
        write_s = time.perf_counter() - s0
        fresh = remoting.RemoteVTPUWorker(meter_client=m_new, device=DEVICE,
                                          state_root=str(state_root))
        fresh.start()
        stack.callback(fresh.stop)
        fdev = remoting.RemoteDevice(fresh.url, timeout_s=900)
        stack.callback(fdev.close)
        s0 = time.perf_counter()
        restored_meta = fdev.restore("snapshot")
        read_s = time.perf_counter() - s0
        restored = remote.on(fdev)(
            _replica(torch, remoting, fdev, rparams), tokens)
        launches = ops.launch_counts()
        fresh_charged = m_new.hbm_charged_bytes

    state_bytes = x0.numel() * x0.element_size()
    row = {"nvidia_smi": smi, "dim": cfg.dim, "n_layers": cfg.n_layers,
           "dtype": str(cfg.dtype), "weights_bytes": weights_bytes,
           "state_bytes": state_bytes, "put_s": put_s,
           "rounds": [{k: r[k] for k in ("round", "buffers", "executables",
                                         "raw_bytes", "wire_bytes", "elapsed_ms",
                                         "dirty_left")}
                      | {"gb_s": r["raw_bytes"] / max(r["elapsed_ms"], 1e-6) / 1e6}
                      for r in rounds],
           "freeze": {k: freeze[k] for k in ("dirty_buffers", "dirty_bytes")},
           "commit": {k: commit[k] for k in ("pause_ms", "rounds", "buffers",
                                             "executables", "raw_bytes")},
           "after_commit": after,
           "target_call_s": target_call_s,
           "migrated_equal_source": torch.equal(got, want),
           "migrated_state_equal": torch.equal(got_state, want_state),
           "abort": {k: v for k, v in abort.items() if k != "round"}
           | {"round_buffers": abort["round"]["buffers"]},
           "engine_freeze": {
               "plain_tokens": len(engine["plain"]["tokens"]),
               "frozen": {k: v for k, v in engine["frozen"].items() if k != "tokens"},
               "tokens_equal_unfrozen":
                   engine["frozen"]["tokens"] == engine["plain"]["tokens"]},
           "snapshot": {"layers": cfg.n_layers, "buffers": snap["buffers"],
                        "executables": snap["executables"], "bytes": snap["bytes"],
                        "write_s": write_s, "write_gb_s": snap["bytes"] / write_s / 1e9,
                        "read_s": read_s,
                        "read_gb_s": restored_meta["bytes"] / read_s / 1e9,
                        "restored_charged_bytes": fresh_charged,
                        "restored_equal_source": torch.equal(restored, want)},
           "kernel_launches": launches,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "phase_s": time.perf_counter() - t_phase}
    emit("migrate", **row)

    problems = []
    r1, r2 = rounds
    if r1["raw_bytes"] < weights_bytes or r2["buffers"] != 1 or \
            r2["raw_bytes"] != state_bytes:
        problems.append(f"pre-copy rounds: {row['rounds']}")
    if freeze["dirty_buffers"] != 0:
        problems.append(f"dirty at freeze: {freeze}")
    if not row["migrated_equal_source"] or not row["migrated_state_equal"]:
        problems.append("the migrated EXECUTE or state differs from the source's")
    if after["source_resident_bytes"] or after["source_charged_bytes"]:
        problems.append(f"source still holds state after commit: {after}")
    if after["target_charged_bytes"] != weights_bytes + state_bytes or \
            after["target_resident_bytes"] != weights_bytes + state_bytes:
        problems.append(f"target not charged the state: {after}")
    if not (abort["reply"].get("aborted") and abort["source_intact"]
            and abort["target_staged_freed"]
            and abort["source_resident_bytes"] == state_bytes):
        problems.append(f"abort: {row['abort']}")
    fz = engine["frozen"]
    if fz["client_tokens_while_frozen"] or fz["engine_tokens_while_frozen"] or \
            not fz["tokens_at_freeze"] < FREEZE_NEW or \
            not row["engine_freeze"]["tokens_equal_unfrozen"]:
        problems.append(f"engine freeze: {row['engine_freeze']}")
    if not row["snapshot"]["restored_equal_source"] or \
            fresh_charged != weights_bytes + state_bytes:
        problems.append(f"snapshot / restore: {row['snapshot']}")
    if launches["flash_attn_fwd"] <= 0:
        problems.append(f"no flash launch on the migrate path: {launches}")
    if problems:
        raise RuntimeError("migrate phase: " + "; ".join(problems))
    return launches


# -- the mesh: 4 ranks on the one card over gloo ------------------------------
#
# The rank bodies below run in the spawned ranks (parallel/launch.py), which
# import this file by path, as __mp_main__, and call them by name.  Each
# returns plain values; CUDA tensors stay in the rank.


def _rank_env():
    import torch
    import torch.distributed as dist
    from tensorfusion_tpu_torch import ops
    from tensorfusion_tpu_torch.parallel import collectives

    return torch, dist, ops, collectives


def _synced(torch, dist):
    """Every rank's queued work done, and every rank here."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dist.barrier()
    return time.perf_counter()


def _peak_gb(torch):
    return torch.cuda.max_memory_allocated() / 1e9 if torch.cuda.is_initialized() else 0.0


def _mesh_plan() -> dict:
    """The mesh phase's knobs, passed to the rank bodies (a spawned rank
    imports this file afresh)."""
    return {"device": DEVICE, "ranks": MESH_RANKS, "axes": MESH_AXES, "steps": MESH_STEPS,
            "shape": MESH_SHAPE, "ring_seq": RING_SEQ, "pipe_micro": PIPE_MICRO,
            "pipe_seq": PIPE_SEQ, "moe_batch": MOE_BATCH,
            "moe_config": MOE_CONFIG, "ckpt_dir": str(WORK / "mesh_ckpt")}


def _one_rank_at_a_time(torch, dist, build):
    """``build()`` on each rank in turn, its transient memory (a whole
    tree before sharding) released before the next rank starts."""
    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = build()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def _nbytes(tree_leaves):
    return sum(t.to_local().numel() * t.element_size() if hasattr(t, "to_local")
               else t.numel() * t.element_size() for t in tree_leaves)


def _mesh_rank_train(plan, cfg, seed, batch_seed):
    """MESH_STEPS sharded AdamW steps (fsdp2 x tp2), then the checkpoint
    contract: save, the uninterrupted next step, a fresh state restored
    from the save and its next step."""
    torch, dist, ops, collectives = _rank_env()
    from tensorfusion_tpu_torch.models import Checkpointer, llama
    from tensorfusion_tpu_torch.parallel import make_mesh

    dev, ckpt_dir = plan["device"], plan["ckpt_dir"]
    mesh = make_mesh(plan["axes"], device=dev)
    params = _one_rank_at_a_time(torch, dist, lambda: llama.shard_params(llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev), mesh, cfg))
    step, init_opt = llama.make_train_step(cfg, device=dev, mesh=mesh)
    opt = init_opt(params)
    batch = _train_batch(torch, cfg.vocab_size, plan["shape"], batch_seed, dev)
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    collectives.STATS.reset()
    losses, step_ms = [], []
    for _ in range(plan["steps"]):
        t0 = _synced(torch, dist)
        params, opt, loss = step(params, opt, batch)
        losses.append(loss.item())
        step_ms.append((_synced(torch, dist) - t0) * 1e3)
    launches = ops.launch_counts()
    comm = collectives.STATS.as_dict()
    peak_gb = _peak_gb(torch)

    ck = Checkpointer(ckpt_dir, max_to_keep=1)
    state_bytes = _nbytes(llama._leaves(params) + llama._leaves(opt["mu"])
                          + llama._leaves(opt["nu"]))
    t0 = _synced(torch, dist)
    ck.save(plan["steps"], params, opt)
    save_s = _synced(torch, dist) - t0
    _, _, continued = step(params, opt, batch)
    continued = continued.item()
    del params, opt
    fresh = _one_rank_at_a_time(torch, dist, lambda: llama.shard_params(llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed + 1), device=dev), mesh, cfg))
    target = {"params": fresh, "opt_state": init_opt(fresh)}
    t0 = _synced(torch, dist)
    restored = ck.restore(target=target)
    restore_s = _synced(torch, dist) - t0
    count = int(restored["opt_state"]["count"])
    _, _, resumed = step(restored["params"], restored["opt_state"], batch)
    resumed = resumed.item()
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"losses": losses, "step_ms": step_ms, "launches": launches, "comm": comm,
            "peak_memory_gb": peak_gb, "state_bytes": state_bytes, "save_s": save_s,
            "restore_s": restore_s, "continued": continued, "resumed": resumed,
            "restored_count": count}


def _mesh_rank_ring(plan, seed):
    """Ring attention over sp=4 on this rank's block of one causal
    [1, 32, RING_SEQ, 128] bf16 sequence, forward and backward, then (rank
    0) the flash kernels on the whole sequence for the check."""
    torch, dist, ops, collectives = _rank_env()
    from tensorfusion_tpu_torch.parallel import make_mesh, ring_attention
    from tensorfusion_tpu_torch.parallel.collectives import all_gather_axes

    dev, n, seq = plan["device"], plan["ranks"], plan["ring_seq"]
    mesh = make_mesh({"sp": n}, device=dev)
    i = mesh.get_local_rank("sp")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, w = (torch.randn((1, 32, seq, 128), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    tl = seq // n
    ql, kl, vl = (x[:, :, i * tl:(i + 1) * tl].clone().requires_grad_(True)
                  for x in (q, k, v))
    wl = w[:, :, i * tl:(i + 1) * tl]
    times = {}
    for rep in range(2):            # the first call warms the allocator
        collectives.STATS.reset()
        t0 = _synced(torch, dist)
        out = ring_attention(ql, kl, vl, mesh, "sp", causal=True)
        t1 = _synced(torch, dist)
        grads = torch.autograd.grad(out, (ql, kl, vl), grad_outputs=wl)
        t2 = _synced(torch, dist)
        times = {"fwd_ms": (t1 - t0) * 1e3, "bwd_ms": (t2 - t1) * 1e3,
                 "staged_bytes": collectives.STATS.staged_bytes,
                 "comm_s": collectives.STATS.seconds}
    whole = [all_gather_axes(x.detach(), mesh, "sp", 2) for x in (out, *grads)]
    res = {**times, "rank": dist.get_rank()}
    if dist.get_rank() == 0:
        from tensorfusion_tpu_torch.ops import flash_attention

        qf, kf, vf = (x.clone().requires_grad_(True) for x in (q, k, v))
        ref = flash_attention(qf, kf, vf, causal=True)
        ref_grads = torch.autograd.grad(ref, (qf, kf, vf), grad_outputs=w)
        res["out_max_abs_err"] = (whole[0].float() - ref.float()).abs().max().item()
        res["grad_rel"] = [((g.float() - r.float()).abs().mean()
                            / r.float().abs().mean()).item()
                           for g, r in zip(whole[1:], ref_grads)]
        res["finite"] = all(bool(torch.isfinite(x).all()) for x in whole)
    return res


def _mesh_rank_ring_llama(plan, cfg, seed, batch_seed):
    """The loss of a 2-layer attn_impl="ring" model over sp=4."""
    torch, dist, ops, collectives = _rank_env()
    from tensorfusion_tpu_torch.models import llama
    from tensorfusion_tpu_torch.parallel import make_mesh

    dev = plan["device"]
    mesh = make_mesh({"sp": plan["ranks"]}, device=dev)
    params = _one_rank_at_a_time(torch, dist, lambda: llama.shard_params(llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev), mesh, cfg))
    batch = _train_batch(torch, cfg.vocab_size, (1, plan["ring_seq"]), batch_seed, dev)
    t0 = _synced(torch, dist)
    with torch.no_grad():
        loss = llama.loss_fn(params, batch, cfg, mesh).item()
    return {"loss": loss, "ms": (_synced(torch, dist) - t0) * 1e3}


def _mesh_rank_pipeline(plan, cfg, seed, x_seed):
    """One 8B-width decoder layer a stage over pp=4, PIPE_MICRO
    microbatches of 1 x 1024; then (rank 0) the four layers in order on
    one device for the check."""
    torch, dist, ops, collectives = _rank_env()
    from torch.distributed.tensor import DTensor, Shard

    from tensorfusion_tpu_torch.models import llama
    from tensorfusion_tpu_torch.parallel import make_mesh, pipeline_apply

    dev, n = plan["device"], plan["ranks"]
    mesh = make_mesh({"pp": n}, device=dev)
    rank = mesh.get_local_rank("pp")
    one = dataclasses.replace(cfg, n_layers=1, vocab_size=8)   # a layer, no tables

    def layer_of(stage):
        gen = torch.Generator(device=dev).manual_seed(seed + stage)
        return llama.init_params(one, gen, device=dev)["layers"][0]

    stacked = torch.utils._pytree.tree_map(
        lambda t: DTensor.from_local(t[None], mesh, [Shard(0)], run_check=False),
        layer_of(rank))
    xs = torch.randn((plan["pipe_micro"], 1, plan["pipe_seq"], cfg.dim),
                     generator=torch.Generator(device=dev).manual_seed(x_seed),
                     device=dev).to(cfg.dtype)
    busy = [0.0]
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)

    def stage(layer, x):
        sync()
        s0 = time.perf_counter()
        y = llama._layer(cfg, layer, x)
        sync()
        busy[0] += time.perf_counter() - s0
        return y

    with torch.no_grad():
        pipeline_apply(stage, stacked, xs, mesh)         # warm-up
        busy[0] = 0.0
        collectives.STATS.reset()
        ops.reset_launch_counts()
        t0 = _synced(torch, dist)
        out = pipeline_apply(stage, stacked, xs, mesh)
        wall = _synced(torch, dist) - t0
        launches = ops.launch_counts()
        res = {"wall_ms": wall * 1e3, "busy_ms": busy[0] * 1e3, "launches": launches,
               "comm": collectives.STATS.as_dict()}
        if dist.get_rank() == 0:
            layers = [layer_of(s) for s in range(n)]
            want = xs
            for layer in layers:
                want = torch.stack([llama._layer(cfg, layer, x) for x in want])
            res["max_abs_err"] = (out.float() - want.float()).abs().max().item()
            res["ref_max_abs"] = want.float().abs().max().item()
            res["finite"] = bool(torch.isfinite(out).all())
    return res


def _mesh_rank_moe(plan, seed, tok_seed):
    """The reference's default MoEConfig expert-parallel over ep=4, and
    (rank 0) the same forward on one device for the check."""
    torch, dist, ops, collectives = _rank_env()
    from tensorfusion_tpu_torch.models import moe
    from tensorfusion_tpu_torch.parallel import make_mesh

    dev, batch = plan["device"], plan["moe_batch"]
    cfg = moe.MoEConfig(**plan["moe_config"])
    mesh = make_mesh({"ep": plan["ranks"]}, device=dev)
    full = moe.init_moe_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                               device=dev)
    params = moe.shard_moe_params(full, mesh, cfg)
    tokens = torch.randint(0, cfg.vocab_size, batch, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(tok_seed))
    stats = {}
    with torch.no_grad():
        moe.moe_forward(params, tokens, cfg, mesh)           # warm-up
        collectives.STATS.reset()
        t0 = _synced(torch, dist)
        logits = moe.moe_forward(params, tokens, cfg, mesh, stats=stats)
        ms = (_synced(torch, dist) - t0) * 1e3
        res = {"ms": ms, "dropped": stats["dropped"], "comm": collectives.STATS.as_dict(),
               "config": {"dim": cfg.dim, "n_layers": cfg.n_layers,
                          "n_experts": cfg.n_experts, "top_k": cfg.top_k,
                          "capacity": cfg.capacity(batch[0] * batch[1])}}
        if dist.get_rank() == 0:
            ref_stats = {}
            ref = moe.moe_forward(full, tokens, cfg, stats=ref_stats)
            res["ref_dropped"] = ref_stats["dropped"]
            res["max_abs_err"] = (logits - ref).abs().max().item()
            res["ref_max_abs"] = ref.abs().max().item()
            res["bit_equal"] = bool(torch.equal(logits, ref))
            res["finite"] = bool(torch.isfinite(logits).all())
    return res


def _one_device_train_losses(torch, llama, cfg, seed, batch_seed):
    params = llama.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                               device=DEVICE)
    step, init_opt = llama.make_train_step(cfg, device=DEVICE)
    opt = init_opt(params)
    batch = _train_batch(torch, cfg.vocab_size, MESH_SHAPE, batch_seed)
    losses = []
    for _ in range(MESH_STEPS):
        params, opt, loss = step(params, opt, batch)
        losses.append(loss.item())
    return losses


def _one_device_loss(torch, llama, cfg, seed, batch_seed):
    params = llama.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                               device=DEVICE)
    batch = _train_batch(torch, cfg.vocab_size, (1, RING_SEQ), batch_seed)
    with torch.no_grad():
        return llama.loss_fn(params, batch, cfg).item()


def _close(a, b, rel=BF16_REL) -> bool:
    return abs(a - b) <= rel * abs(b)


def phase_mesh(torch, ops, llama, parallel, cfg, smi):
    """The multi-device layer at Llama-3-8B width: MESH_RANKS ranks share
    the one card over gloo (NCCL refuses two ranks on one card), spawned
    once and kept for every step.  Returns the flash launches of the
    path's runs (the sharded train steps and the pipeline), summed over
    the ranks; the one-device references and checks launch outside them."""
    from tensorfusion_tpu_torch.parallel import collectives

    t_phase = time.perf_counter()
    # the earlier phases' engines and workers may sit in reference cycles
    # that still hold their weights and graph pools: the ranks need the card
    held_gb = torch.cuda.memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    plan = _mesh_plan()
    cfg4 = dataclasses.replace(cfg, n_layers=MESH_LAYERS)
    cfg2 = dataclasses.replace(cfg, n_layers=RING_LAYERS)
    # the one-device references first, so the ranks find the card free
    ref_losses = _one_device_train_losses(torch, llama, cfg4, 21, 22)
    ref_ring_loss = _one_device_loss(torch, llama, cfg2, 23, 24)
    torch.cuda.empty_cache()
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    emit("mesh_backend", backend="gloo", ranks=MESH_RANKS, device="cuda:0, shared",
         parent_allocated_gb={"before_gc": held_gb,
                              "now": torch.cuda.memory_allocated() / 1e9},
         card_free_gb=free_gb,
         host_staged_ops=sorted(collectives.HOST_STAGED["gloo"]),
         note="gloo moves CUDA tensors through the host: collective times here "
              "say nothing about NVLink", nvidia_smi=smi)
    launches = {k.name: 0 for k in ops.KERNELS}
    t0 = time.perf_counter()
    with parallel.RankGroup(MESH_RANKS, device=DEVICE, backend="gloo",
                            timeout_s=900) as ranks:
        spawn_s = time.perf_counter() - t0

        # 1 and 6: the sharded train step, then the checkpoint
        train = ranks.run(_mesh_rank_train, plan, cfg4, 21, 22)
        for res in train:
            for name, n in res["launches"].items():
                launches[name] += n
        step_ms = [max(r["step_ms"][i] for r in train) for i in range(MESH_STEPS)]
        losses = train[0]["losses"]
        emit("mesh_train", axes=MESH_AXES, n_layers=MESH_LAYERS, batch=MESH_SHAPE[0],
             seq=MESH_SHAPE[1], attn_impl=cfg.attn_impl, dtype=str(cfg.dtype),
             losses=losses, one_device_losses=ref_losses,
             loss_rel=[abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)],
             rule=f"|loss - one device| <= {BF16_REL} x |one device| a step",
             step_ms=step_ms, tokens_per_s=MESH_SHAPE[0] * MESH_SHAPE[1]
             / (sum(step_ms[1:]) / (MESH_STEPS - 1) / 1e3),
             peak_memory_gb_per_rank=[r["peak_memory_gb"] for r in train],
             collective_bytes_per_rank=[r["comm"]["bytes"] for r in train],
             collective_s_per_rank=[r["comm"]["seconds"] for r in train],
             collective_ops_per_rank=[r["comm"]["ops"] for r in train],
             flash_launches_per_rank=[r["launches"] for r in train], nvidia_smi=smi)
        if any(r["losses"] != losses for r in train):
            raise RuntimeError("ranks disagree on the sharded loss")
        if not all(_close(a, b) for a, b in zip(losses, ref_losses)):
            raise RuntimeError(f"sharded losses {losses} differ from one device's "
                               f"{ref_losses}")
        want = MESH_LAYERS * MESH_STEPS
        if any(n != want for r in train for n in r["launches"].values()):
            raise RuntimeError(f"flash kernels ran {[r['launches'] for r in train]} "
                               f"times a rank, not {want}")
        gb = sum(r["state_bytes"] for r in train) / 1e9
        emit("mesh_checkpoint", step=MESH_STEPS, state_gb=gb,
             save_gb_s=gb / max(r["save_s"] for r in train),
             restore_gb_s=gb / max(r["restore_s"] for r in train),
             continued=[r["continued"] for r in train],
             resumed=[r["resumed"] for r in train],
             restored_count=train[0]["restored_count"], nvidia_smi=smi)
        if any(r["resumed"] != r["continued"] for r in train) \
                or train[0]["restored_count"] != MESH_STEPS:
            raise RuntimeError("the restored state's step differs from the "
                               "uninterrupted one")

        # 2: ring attention against the flash kernels on the whole sequence
        ring = ranks.run(_mesh_rank_ring, plan, 25)
        r0 = ring[0]
        emit("mesh_ring", sp=MESH_RANKS, batch=1, seq=RING_SEQ, heads=32, head_dim=128,
             causal=True, dtype="bf16", out_max_abs_err=r0["out_max_abs_err"],
             grad_rel=dict(zip(("dq", "dk", "dv"), r0["grad_rel"])),
             rule=f"out max|err| < {BF16_REL}; grads mean|err|/mean|ref| < {BF16_REL}",
             fwd_ms=max(r["fwd_ms"] for r in ring), bwd_ms=max(r["bwd_ms"] for r in ring),
             host_staged_bytes_per_rank=[r["staged_bytes"] for r in ring],
             collective_s_per_rank=[r["comm_s"] for r in ring], nvidia_smi=smi)
        if not (r0["finite"] and r0["out_max_abs_err"] < BF16_REL
                and max(r0["grad_rel"]) < BF16_REL):
            raise RuntimeError(f"ring attention disagrees with the flash kernels: {r0}")

        # 3: Llama with attn_impl="ring" against the one-device flash loss
        ring_cfg = dataclasses.replace(cfg2, attn_impl="ring")
        rl = ranks.run(_mesh_rank_ring_llama, plan, ring_cfg, 23, 24)
        emit("mesh_ring_llama", sp=MESH_RANKS, n_layers=RING_LAYERS, seq=RING_SEQ,
             loss=rl[0]["loss"], one_device_flash_loss=ref_ring_loss,
             loss_rel=abs(rl[0]["loss"] - ref_ring_loss) / abs(ref_ring_loss),
             rule=f"|loss - one device| <= {BF16_REL} x |one device|",
             ms=max(r["ms"] for r in rl), nvidia_smi=smi)
        if len({r["loss"] for r in rl}) != 1 or not _close(rl[0]["loss"], ref_ring_loss):
            raise RuntimeError(f"ring Llama loss {[r['loss'] for r in rl]} against "
                               f"one device's {ref_ring_loss}")

        # 4: the pipeline against the sequential composition
        pipe = ranks.run(_mesh_rank_pipeline, plan, cfg, 26, 27)
        for res in pipe:
            for name, n in res["launches"].items():
                launches[name] += n
        ticks = PIPE_MICRO + MESH_RANKS - 1
        wall = max(r["wall_ms"] for r in pipe)
        p0 = pipe[0]
        emit("mesh_pipeline", pp=MESH_RANKS, microbatches=PIPE_MICRO,
             microbatch=[1, PIPE_SEQ], ticks=ticks, wall_ms=wall, tick_ms=wall / ticks,
             bubble_share=1 - sum(r["busy_ms"] for r in pipe) / (MESH_RANKS * wall),
             schedule_bubble_share=(MESH_RANKS - 1) / ticks,
             max_abs_err=p0["max_abs_err"], ref_max_abs=p0["ref_max_abs"],
             rule=f"max|err| <= {BF16_REL} x max|sequential|",
             collective_bytes_per_rank=[r["comm"]["bytes"] for r in pipe],
             flash_launches_per_rank=[r["launches"]["flash_attn_fwd"] for r in pipe],
             nvidia_smi=smi)
        if not (p0["finite"] and p0["max_abs_err"] <= BF16_REL * p0["ref_max_abs"]):
            raise RuntimeError(f"pipeline disagrees with the sequential layers: {p0}")

        # 5: the expert-parallel MoE against one device
        moe_res = ranks.run(_mesh_rank_moe, plan, 28, 29)
        m0 = moe_res[0]
        emit("mesh_moe", ep=MESH_RANKS, batch=list(MOE_BATCH),
             **m0["config"], dropped=m0["dropped"], one_device_dropped=m0["ref_dropped"],
             max_abs_err=m0["max_abs_err"], ref_max_abs=m0["ref_max_abs"],
             bit_equal=m0["bit_equal"], rule=f"dropped equal and > 0; max|err| <= "
             f"{BF16_REL} x max|one device|", ms=max(r["ms"] for r in moe_res),
             collective_bytes_per_rank=[r["comm"]["bytes"] for r in moe_res],
             nvidia_smi=smi)
        if not (m0["finite"] and m0["dropped"] == m0["ref_dropped"] > 0
                and m0["max_abs_err"] <= BF16_REL * m0["ref_max_abs"]):
            raise RuntimeError(f"expert-parallel MoE disagrees with one device: {m0}")
    emit("mesh_done", spawn_s=spawn_s, seconds=time.perf_counter() - t_phase,
         launches=launches)
    return launches


# -- the node agent: two metered tenants under the port's hypervisor ----------


def _tenant_log(out: Path):
    """A spawned child's own log (the backend gives its workers no stdout)
    and its record writer: a JSON line per record in ``out/calls.jsonl``."""
    import os

    out.mkdir(parents=True, exist_ok=True)
    log = open(out / "tenant.log", "a", buffering=1)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    calls = open(out / "calls.jsonl", "a", buffering=1)
    return lambda **fields: calls.write(json.dumps(fields) + "\n")


HOOK_FIELDS = ("launches", "charges", "charged_mflops", "device_us", "blocked_us",
               "hbm_charged_bytes", "hbm_denied", "captured", "graph_launches", "windows",
               "untimed", "unwindowed")


def _all_windowed(hook):
    """No launch went unwindowed (the hook's stream table full) or
    uncharged for a capture: a tenant that captures no graph has every
    launch charged."""
    return hook["unwindowed"] == 0 and hook["captured"] == 0


def _hooked():
    """The launch and memory hook preloaded into this process, attached to
    its segment; a process that should be metered and is not raises."""
    from tensorfusion_tpu_torch.hypervisor import cuda_hook_binding

    hook = cuda_hook_binding.loaded()
    if hook is None or not hook.metered():
        raise RuntimeError("this process runs without the node agent's launch hook")
    return hook


def _hook_counts(hook):
    report = hook.report()
    return {k: report[k] for k in HOOK_FIELDS}


def _tenant_loop(out, record, call, torch, ops, hook, fields=dict):
    """Call until ``out/stop`` appears, a record after each call (its span,
    the flash launches, the reserved memory, the hook's counts and
    ``fields()``); then a last record, and idle until terminated (the
    backend restarts a worker that exits)."""
    while not (out / "stop").exists():
        t0 = time.monotonic()
        call()
        torch.cuda.synchronize()
        t1 = time.monotonic()
        record(t0=t0, t1=t1, flash=ops.launch_counts()["flash_attn_fwd"],
               reserved=torch.cuda.memory_reserved(), hook=_hook_counts(hook), **fields())
    record(stopped=time.monotonic(), flash=ops.launch_counts()["flash_attn_fwd"],
           reserved=torch.cuda.memory_reserved(), hook=_hook_counts(hook), **fields())
    while True:
        time.sleep(3600)


def _tenant_model(torch, llama):
    """Llama-3-8B (bf16, flash) from NODE_SEED, and its NODE_SHAPE tokens."""
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), attn_impl="flash")
    gen = torch.Generator(device=DEVICE).manual_seed(NODE_SEED)
    params = llama.init_params(cfg, gen, device=DEVICE)
    tokens = torch.randint(0, cfg.vocab_size, NODE_SHAPE, generator=gen, device=DEVICE)
    return cfg, params, tokens


def tenant_main(out: Path) -> int:
    """One tenant of ``phase_node``, spawned by the hypervisor's single-node
    backend with its allocation env, the launch hook preloaded: attach the
    metering client from that env (which leaves the charging to the hook),
    build Llama-3-8B, check one metered forward bit for bit against an
    unmetered one, then loop the metered forward until told to stop."""
    import os

    record = _tenant_log(out)
    import torch

    sys.path.insert(0, str(REPO))
    from tensorfusion_tpu_torch import ops
    from tensorfusion_tpu_torch.client.runtime import VTPUClient, estimate_flops
    from tensorfusion_tpu_torch.models import llama

    record(start=os.getpid(), t=time.monotonic())
    hook = _hooked()
    client = VTPUClient(device=DEVICE)
    if not client.attached:
        raise RuntimeError("the tenant found no limiter segment: it would run unmetered")
    cfg, params, tokens = _tenant_model(torch, llama)
    forward = client.meter(llama.forward)
    want = llama.forward(params, tokens, cfg)
    got = forward(params, tokens, cfg)
    equal = torch.equal(got, want)
    del want, got
    # the client's estimate of one call, as its meter computes it
    per_call = max(int(estimate_flops(llama.forward, (params, tokens, cfg), {}) / 1e6), 1)
    record(check={"bit_equal": equal, "mflop_per_call": per_call,
                  "client_by_hook": client.hook is not None,
                  "config": {"dim": cfg.dim, "n_layers": cfg.n_layers,
                             "dtype": str(cfg.dtype), "attn_impl": cfg.attn_impl},
                  "shape": list(NODE_SHAPE)})
    if not equal:
        raise RuntimeError("a metered forward differs from an unmetered one")
    _tenant_loop(out, record, lambda: forward(params, tokens, cfg), torch, ops, hook,
                 lambda: {"launches": client.launches, "mflop": client.charged_mflops,
                          "blocked_s": client.blocked_time_s})


def tenant_raw_main(out: Path) -> int:
    """An unmodified tenant (``phase_intercept``): the Llama-3-8B forward in
    a loop, in plain torch, never importing the client runtime; only the
    preloaded launch hook meters it."""
    import os

    record = _tenant_log(out)
    import torch

    sys.path.insert(0, str(REPO))
    from tensorfusion_tpu_torch import ops
    from tensorfusion_tpu_torch.models import llama

    record(start=os.getpid(), t=time.monotonic())
    hook = _hooked()
    cfg, params, tokens = _tenant_model(torch, llama)
    settings = hook.report()
    record(check={"client_runtime_imported": "tensorfusion_tpu_torch.client.runtime"
                  in sys.modules, "config": {"dim": cfg.dim, "n_layers": cfg.n_layers},
                  "shape": list(NODE_SHAPE), "peak_mflops": settings["peak_mflops"]})
    _tenant_loop(out, record, lambda: llama.forward(params, tokens, cfg), torch, ops, hook)


def _probe_inputs(torch):
    gen = torch.Generator(device=DEVICE).manual_seed(PROBE_SEED)
    return [torch.randn(PROBE_FLASH_SHAPE, generator=gen, device=DEVICE).to(torch.bfloat16)
            for _ in range(3)]


def probe_main(out: Path) -> int:
    """``phase_intercept`` part a, in a child under the hook: which driver
    entries a Llama forward, a train step, CUDA-graph capture and replay
    (``LlamaRunner``) and direct calls of the flash forward library reach,
    with counts; and the flash output, for a bit-for-bit comparison."""
    out.mkdir(parents=True, exist_ok=True)
    import torch

    sys.path.insert(0, str(REPO))
    from tensorfusion_tpu_torch.models import llama
    from tensorfusion_tpu_torch.serving import LlamaRunner

    fa = sys.modules["tensorfusion_tpu_torch.ops.flash_attention"]
    hook = _hooked()
    parts = {}

    def part(name, fn):
        before = hook.report()
        fn()
        torch.cuda.synchronize()
        after = hook.report()
        entries = {k: after["entries"][k] - before["entries"][k] for k in after["entries"]}
        parts[name] = {"entries": {k: v for k, v in entries.items() if v},
                       **{k: after[k] - before[k] for k in HOOK_FIELDS}}

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), attn_impl="flash",
                              n_layers=PROBE_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(PROBE_SEED)
    params = llama.init_params(cfg, gen, device=DEVICE)
    tokens = torch.randint(0, cfg.vocab_size, PROBE_SHAPE, generator=gen, device=DEVICE)
    part("forward", lambda: llama.forward(params, tokens, cfg))
    step, init = llama.make_train_step(cfg, device=DEVICE)
    state = init(params)
    batch = {"tokens": tokens, "targets": tokens.roll(-1, dims=1)}
    part("train_step", lambda: step(params, state, batch))
    del state
    runner = LlamaRunner(params, cfg, num_blocks=PROBE_BLOCKS, block_size=16, device=DEVICE)
    prompt = tokens[0, :64].tolist()
    table = list(range(1, PROBE_BLOCKS))
    first = runner.prefill(prompt, table, 0)
    part("graph_capture", lambda: runner.warmup(max_batch=1, prompt_len=64, chunk=64))

    def replays():
        toks, pos = [first], [len(prompt)]
        for _ in range(PROBE_DECODES):
            toks, pos = runner.decode(toks, pos, [table]), [pos[0] + 1]

    part("graph_replay", replays)
    q, k, v = _probe_inputs(torch)
    outs = []
    part("flash_direct", lambda: outs.extend(
        fa.flash_fwd_cuda(q, k, v, PROBE_FLASH_SHAPE[-1] ** -0.5, True)[0]
        for _ in range(PROBE_FLASH_CALLS)))
    torch.save(outs[0].cpu(), out / "flash_out.pt")
    (out / "probe.json").write_text(json.dumps({
        "parts": parts, "report": hook.report(), "graphs": [list(k) for k in runner.graphs]}))
    return 0


def overhead_main(out: Path) -> int:
    """``phase_intercept`` part b, in a child with or without the hook:
    host microseconds a launch of a tiny kernel, and the wall time of the
    Llama-3-8B forward on NODE_SHAPE tokens."""
    out.mkdir(parents=True, exist_ok=True)
    import torch

    sys.path.insert(0, str(REPO))
    from tensorfusion_tpu_torch.hypervisor import cuda_hook_binding
    from tensorfusion_tpu_torch.models import llama

    hook = cuda_hook_binding.loaded()
    x = torch.zeros(1, device=DEVICE)
    for _ in range(1000):
        x.add_(1)
    torch.cuda.synchronize()
    rounds = []                          # the best round: the host's own noise is large
    for _ in range(OVERHEAD_ROUNDS):
        t0 = time.perf_counter()
        for _ in range(OVERHEAD_TINY // OVERHEAD_ROUNDS):
            x.add_(1)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / (OVERHEAD_TINY // OVERHEAD_ROUNDS) * 1e6)
    tiny_us = min(rounds)
    cfg, params, tokens = _tenant_model(torch, llama)
    walls = []
    for i in range(2 + OVERHEAD_CALLS):
        t0 = time.perf_counter()
        llama.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    (out / "overhead.json").write_text(json.dumps({
        "hooked": hook is not None and hook.metered(), "tiny_us": tiny_us,
        "tiny_us_rounds": rounds,
        "forward_ms": walls, "report": hook.report() if hook else None}))
    return 0


def _tenant_lines(out: Path):
    path = out / "calls.jsonl"
    if not path.exists():
        return []
    lines = []
    for line in path.read_text().splitlines():
        try:
            lines.append(json.loads(line))
        except ValueError:       # a line cut by the tenant's termination
            pass
    return lines


def _api(url, path, method="GET", body=None, token=NODE_TOKEN, timeout=30):
    import urllib.request

    req = urllib.request.Request(
        url + path, method=method, headers={"X-TPF-Token": token,
                                            "Content-Type": "application/json"},
        data=json.dumps(body).encode() if body is not None else None)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _conformance(provider_lib):
    """The reference's compiled ABI check against the NVML provider."""
    r = subprocess.run([str(REPO / "native" / "build" / "provider_conformance"),
                        str(provider_lib)], capture_output=True, text=True, timeout=120)
    if r.returncode != 0 or "PASS" not in r.stdout:
        raise RuntimeError(f"provider_conformance failed (exit {r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    return r.stdout.strip()


def _start_daemon(provider_lib, limiter_lib, work, extra=()):
    port_file = work / "port"
    log = open(work / "daemon.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorfusion_tpu_torch.hypervisor",
         "--provider", str(provider_lib), "--limiter", str(limiter_lib),
         "--shm-base", str(work / "shm"), "--state-dir", str(work / "state"),
         "--snapshot-dir", str(work / "snap"), "--port", "0",
         "--port-file", str(port_file), "--api-token", NODE_TOKEN, *extra],
        cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT)
    log.close()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            break
        if port_file.exists() and port_file.read_text().strip():
            url = f"http://127.0.0.1:{port_file.read_text().strip()}"
            try:
                if _api(url, "/healthz", token="")["ok"]:
                    return proc, url
            except OSError:
                pass
        time.sleep(0.2)
    proc.kill()
    proc.wait()
    raise RuntimeError("the hypervisor did not come up:\n"
                       + (work / "daemon.log").read_text()[-3000:])


def _stop(proc, timeout=30):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _node_inventory(torch, hardware, provider, url, name, smi):
    """/api/v1/devices, /node and /topology against torch and nvidia-smi;
    the device's name is not a field of the provider ABI's chip info, so
    it is read from the provider's partition template ("<name> whole
    card")."""
    devs = _api(url, "/api/v1/devices")
    node = _api(url, "/api/v1/node")
    topo = _api(url, "/api/v1/topology")
    rates = hardware.peak_rates(name)
    total = torch.cuda.get_device_properties(0).total_memory
    info, metrics = devs[0]["info"], devs[0]["metrics"]
    template = provider.partition_templates(info["chip_id"])[0].name
    limit_w = float(smi.split(",")[-1].strip().split()[0])
    checks = {
        "count": len(devs) == torch.cuda.device_count() == node["chip_count"],
        "name": template == f"{name} whole card",
        "hbm_within_1pct": abs(info["hbm_bytes"] - total) <= 0.01 * total,
        "peak_bf16": info["peak_bf16_tflops"] * 1e12 == rates["bf16"],
        "peak_int8": info["peak_int8_tops"] * 1e12 == rates["int8"],
        "hbm_gbps": info["hbm_gbps"] * 1e9 == rates["bytes"],
        "power_and_temp": metrics["power_watts"] > 0 and metrics["temp_celsius"] > 0,
        "power_limit_w": abs(metrics["extra"]["power_limit_w"] - limit_w) < 0.5,
        "platform": info["platform"] == "gpu",
        "topology_self": [l["kind"] for l in topo["links"][info["chip_id"]]] == ["self"],
    }
    inventory = {"chip_id": info["chip_id"], "generation": info["generation"],
                 "template": template, "hbm_bytes": info["hbm_bytes"],
                 "torch_total_memory": total, "peak_bf16_tflops": info["peak_bf16_tflops"],
                 "peak_int8_tops": info["peak_int8_tops"], "hbm_gbps": info["hbm_gbps"],
                 "numa_node": info["numa_node"], "driver": info["driver_version"],
                 "power_watts": metrics["power_watts"], "temp_celsius": metrics["temp_celsius"],
                 "power_limit_w": metrics["extra"]["power_limit_w"],
                 "mesh_shape": topo["mesh_shape"], "checks": checks}
    if not all(checks.values()):
        raise RuntimeError(f"the hypervisor's inventory disagrees with torch: {inventory}")
    return info["chip_id"], inventory


def _bucket_bound(samples, per_call):
    """The most a tenant's bucket can admit over the sampled window, from
    limiter.cc's rule: a charge is admitted only from tokens, and tokens
    grow only by refill credits (elapsed time x the refill rate in force at
    the refill, capped at the capacity).  So the charges between the first
    and the last sample are at most the tokens at the first sample, plus
    the credit pending then (since the segment's last refill), plus each
    sample interval at the larger of its two sampled rates; one call's
    charge covers a rate that lived between two samples."""
    first = samples[0]
    bound = first["tokens"] + per_call
    rate0 = max(samples[0]["refill"], samples[1]["refill"])
    bound += rate0 * max(0.0, first["t"] - first["last_refill_us"] / 1e6)
    for a, b in zip(samples, samples[1:]):
        bound += max(a["refill"], b["refill"]) * (b["t"] - a["t"])
    return bound


def _settle_s(series):
    """Seconds until a (t, value) series stays within 5% of its last value."""
    last = series[-1][1]
    t_settled = series[0][0]
    for t, v in series:
        if abs(v - last) > 0.05 * abs(last):
            t_settled = t
    return t_settled - series[0][0]


def _read_segment(view):
    state = view.read()
    d = state.devices[0]
    return {"t": time.monotonic(), "tokens": d.tokens_mflop, "capacity": d.capacity_mflop,
            "refill": d.refill_mflop_per_s, "last_refill_us": d.last_refill_us,
            "charged": d.total_charged_mflop, "launches": d.launches,
            "blocked": d.blocked_events, "pod_hbm": d.pod_hbm_used_bytes,
            "hbm_used": d.hbm_used_bytes, "pids": list(state.pids), "frozen": state.frozen}


def _node_wait_for_calls(tenants, daemon):
    """Until each tenant has made its first call of the loop."""
    deadline = time.monotonic() + NODE_START_TIMEOUT_S
    while True:
        ready = True
        for pod, t in tenants.items():
            lines = _tenant_lines(t["out"])
            if sum("start" in l for l in lines) > 1 or daemon.poll() is not None:
                raise RuntimeError(f"tenant {pod} restarted or the hypervisor died:\n"
                                   + _tail(t["out"] / "tenant.log"))
            ready &= any("t1" in l for l in lines)
        if ready:
            return
        if time.monotonic() > deadline:
            raise RuntimeError("the tenants made no call in time:\n" + "\n".join(
                f"{pod}: " + _tail(t["out"] / "tenant.log") for pod, t in tenants.items()))
        time.sleep(0.5)


def _tail(path, n=3000):
    return path.read_text()[-n:] if path.exists() else f"<no {path.name}>"


def _node_window(url, provider, tenants, window_s=NODE_WINDOW_S, freeze_pod="hi"):
    """``window_s`` of samples: the segments every NODE_SAMPLE_S, the API's
    workers and devices and NVML's processes every second; ``freeze_pod``
    (if any) frozen from NODE_FREEZE_AT_S for NODE_FREEZE_S."""
    t_start = time.monotonic()
    samples, api_samples, freeze = [], [], {}
    next_api = t_start
    while True:
        now = time.monotonic()
        if now >= t_start + window_s:
            break
        samples.append({pod: _read_segment(t["view"]) for pod, t in tenants.items()})
        if freeze_pod and "t_freeze" not in freeze and now >= t_start + NODE_FREEZE_AT_S:
            _api(url, f"/api/v1/workers/default/{freeze_pod}/freeze", "POST", {})
            freeze["t_freeze"] = time.monotonic()
            # the daemon freezes between two ticks: what the bucket holds
            # now is what its last tick before the freeze left
            freeze["at_freeze"] = _read_segment(tenants[freeze_pod]["view"])
            freeze["launches_at_freeze"] = freeze["at_freeze"]["launches"]
        elif "t_resume" not in freeze and "t_freeze" in freeze \
                and now >= freeze["t_freeze"] + NODE_FREEZE_S:
            freeze["launches_at_resume"] = _read_segment(tenants[freeze_pod]["view"])["launches"]
            _api(url, f"/api/v1/workers/default/{freeze_pod}/resume", "POST", {})
            freeze["t_resume"] = time.monotonic()
        if now >= next_api:
            api_samples.append({
                "t": now, "workers": _api(url, "/api/v1/workers"),
                "devices": _api(url, "/api/v1/devices"),
                "nvml_procs": [(p.pid, p.duty_cycle_pct, p.hbm_used_bytes)
                               for p in provider.proc_stats()]})
            next_api += 1.0
        time.sleep(max(0.0, NODE_SAMPLE_S - (time.monotonic() - now)))
    return t_start, time.monotonic(), samples, api_samples, freeze


def _node_stop(daemon, tenants):
    """Tell each tenant to stop after its call in flight and wait for its
    last record: a tenant launches only inside its calls, so then its
    segment and its records describe the same launches."""
    for t in tenants.values():
        (t["out"] / "stop").touch()
    deadline = time.monotonic() + NODE_STOP_TIMEOUT_S
    while True:
        final = {}
        for pod, t in tenants.items():
            lines = _tenant_lines(t["out"])
            if any("stopped" in l for l in lines):
                final[pod] = {"segment": _read_segment(t["view"]), "lines": lines,
                              "stopped": next(l for l in lines if "stopped" in l)}
        if len(final) == len(tenants):
            return final
        if daemon.poll() is not None or time.monotonic() > deadline:
            raise RuntimeError(f"the tenants did not stop: {sorted(final)}:\n" + "\n".join(
                f"{pod}: " + _tail(t["out"] / "tenant.log") for pod, t in tenants.items()))
        time.sleep(0.2)


def _submit_tenants(url, chip, work, mode, hook_lib):
    """Submit NODE_TENANTS as soft workers running ``chip_smoke.py mode
    DIR``; each one's env must preload the launch hook."""
    from tensorfusion_tpu_torch.hypervisor import ShmView

    tenants = {}
    for pod, duty, qos in NODE_TENANTS:
        out = work / "tenants" / pod
        spec = {"namespace": "default", "name": pod, "isolation": "soft", "qos": qos,
                "devices": [{"chip_id": chip, "duty_percent": duty,
                             "hbm_bytes": NODE_HBM_BYTES}],
                "command": [sys.executable, str(REPO / "chip_smoke.py"), mode, str(out)]}
        got = _api(url, "/api/v1/workers", "POST", spec)["status"]["env"]
        for key, want in (("CUDA_VISIBLE_DEVICES", "0"), ("CUDA_DEVICE_ORDER", "PCI_BUS_ID"),
                          ("LD_PRELOAD", str(hook_lib))):
            if got.get(key, "").split(":")[0] != want:
                raise RuntimeError(f"{pod}'s env has {key}={got.get(key)!r}")
        tenants[pod] = {"out": out, "duty": duty, "qos": qos,
                        "view": ShmView(got["TPF_SHM_PATH"])}
    return tenants


def phase_node(torch, hardware, hv_build, limiter_lib, name, smi):
    """The node agent on the card: conformance of the NVML provider, the
    port's hypervisor daemon over it, and two soft tenants (``default/lo``
    at 25% duty, QoS low; ``default/hi`` at 75%, QoS high) spawned by its
    single-node backend with the launch hook preloaded, each looping the
    metered Llama-3-8B forward under the 10 Hz ERL loop, ``hi`` frozen for
    NODE_FREEZE_S mid-window.  Returns the tenants' kernel launches."""
    from tensorfusion_tpu_torch.hypervisor import Provider, list_worker_segments

    t_phase = time.perf_counter()
    work = WORK / "node"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    provider_lib = hv_build.provider_path()
    conformance = _conformance(provider_lib)
    provider = Provider(str(provider_lib))
    provider.init()
    daemon, url = _start_daemon(provider_lib, limiter_lib, work)
    tenants = {}
    try:
        chip, inventory = _node_inventory(torch, hardware, provider, url, name, smi)
        tenants = _submit_tenants(url, chip, work, "--tenant", hv_build.cuda_hook_path())
        _node_wait_for_calls(tenants, daemon)
        t_start, t_end, samples, api_samples, freeze = _node_window(url, provider, tenants)
        final = _node_stop(daemon, tenants)
        pids = {p for s in samples for seg in s.values() for p in seg["pids"]}
        pids |= {l["start"] for f in final.values() for l in f["lines"] if "start" in l}
        for pod in tenants:
            _api(url, f"/api/v1/workers/default/{pod}", "DELETE")
    finally:
        for t in tenants.values():
            t["view"].close()
        _stop(daemon)
        provider.shutdown()
    left = list_worker_segments(str(work / "shm"))
    alive = sorted(p for p in pids if Path(f"/proc/{p}").exists())
    if left or alive:
        raise RuntimeError(f"after DELETE: segments {left}, tenant processes {alive}")
    peak_mflops = inventory["peak_bf16_tflops"] * 1e6
    report = _node_report(tenants, t_start, t_end, samples, api_samples, freeze,
                          final, peak_mflops)
    emit("node", conformance=conformance, inventory=inventory, **report,
         nvidia_smi=smi, seconds=time.perf_counter() - t_phase)
    launches = {k: 0 for k in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")}
    launches["flash_attn_fwd"] = sum(t["flash_launches"] for t in report["tenants"].values())
    return launches


def _node_report(tenants, t_start, t_end, samples, api_samples, freeze, final,
                 peak_mflops):
    """The node line's numbers, and its checks (each failure raises).  The
    launch hook charges the tenants' device time, so the client's own
    estimate no longer reaches the segment: each segment must hold exactly
    the hook's admitted charges, while the client counted every call."""
    window = t_end - t_start
    out, checks = {}, {}
    nvml_pids = {pid for a in api_samples for pid, _, _ in a["nvml_procs"]}
    for pod, t in tenants.items():
        lines = final[pod]["lines"]
        seg, stopped = final[pod]["segment"], final[pod]["stopped"]
        check = next(l["check"] for l in lines if "check" in l)
        calls = [l for l in lines if "t1" in l]
        per_call = check["mflop_per_call"]
        series = [s[pod] for s in samples]
        in_window = [l for l in calls if l["t1"] > t_start and l["t0"] < t_end]
        busy = sum(min(l["t1"], t_end) - max(l["t0"], t_start) for l in in_window)
        charged = series[-1]["charged"] - series[0]["charged"]
        # the hook pays a call's device time at the call's next launches:
        # one charge is at most a call's wall time at the peak
        bound = _bucket_bound(series, max(l["t1"] - l["t0"] for l in calls) * peak_mflops)
        shares = [s["refill"] / peak_mflops for s in series]
        statuses = [w["status"] for a in api_samples for w in a["workers"]
                    if w["spec"]["name"] == pod]
        tenant_pids = {p for s in series for p in s["pids"]}
        n_calls = sum(1 for l in calls if t_start <= l["t1"] <= t_end)
        made = len(calls) + 1               # the loop's calls and the checked one
        out[pod] = {
            "duty_percent": t["duty"], "qos": t["qos"], "pids": sorted(tenant_pids),
            "starts": sum("start" in l for l in lines),
            "bit_equal_first_call": check["bit_equal"], "mflop_per_call": per_call,
            "calls_total": made, "calls_in_window": n_calls,
            "tokens_per_s": n_calls * NODE_SHAPE[0] * NODE_SHAPE[1] / window,
            "charged_tflop_per_s": charged / window / 1e6,
            "wall_share_in_calls": busy / window,
            "segment_launches": seg["launches"], "segment_charged_mflop": seg["charged"],
            "hook": stopped["hook"], "client_by_hook": check["client_by_hook"],
            "client_launches": stopped["launches"],
            "client_charged_mflop": stopped["mflop"],
            "reserved_bytes": stopped["reserved"], "segment_hbm_used_bytes": seg["hbm_used"],
            "blocked_events_in_window": series[-1]["blocked"] - series[0]["blocked"],
            "blocked_s": stopped["blocked_s"],
            "window_charged_mflop": charged, "bucket_bound_mflop": bound,
            "refill_share": {"first": shares[0], "median": sorted(shares)[len(shares) // 2],
                             "last": shares[-1], "min": min(shares), "max": max(shares)},
            "erl_settle_s": _settle_s([(s["t"] - t_start, s["refill"]) for s in series]),
            "capacity_mflop": {"min": min(s["capacity"] for s in series),
                               "max": max(s["capacity"] for s in series)},
            "nvml_duty_pct_mean": sum(s["duty_cycle_pct"] for s in statuses) / len(statuses),
            "nvml_hbm_bytes_max": max(s["hbm_used_bytes"] for s in statuses),
            "nvml_pids_match": bool(tenant_pids & nvml_pids),
            "flash_launches": stopped["flash"],
        }
        checks[f"{pod}_one_start"] = out[pod]["starts"] == 1
        checks[f"{pod}_bit_equal"] = check["bit_equal"] is True
        checks[f"{pod}_charged_once"] = (
            check["client_by_hook"] and stopped["launches"] == made
            and seg["launches"] == stopped["hook"]["charges"] > 0
            and seg["charged"] == stopped["hook"]["charged_mflops"] > 0)
        checks[f"{pod}_all_windowed"] = _all_windowed(stopped["hook"])
        checks[f"{pod}_bucket_bound"] = charged <= bound
    hi_after = [l for l in final["hi"]["lines"] if "t0" in l and l["t0"] >= freeze["t_resume"]]
    checks["hi_frozen"] = freeze["launches_at_resume"] - freeze["launches_at_freeze"] <= 1
    checks["hi_resumed"] = len(hi_after) > 0
    # a freeze is not hunger: hi's bucket keeps its pre-freeze refill and
    # capacity while the limiter refuses its charges.  Pre-freeze is the
    # bucket read as the freeze returned: a tick between the last sample
    # and the freeze may still move it, as it may any tick of a running
    # tenant
    hi_series = [s["hi"] for s in samples]
    sampled = [s for s in hi_series if s["t"] < freeze["t_freeze"]][-1]
    before = freeze["at_freeze"]
    during = [s for s in hi_series if freeze["t_freeze"] <= s["t"] <= freeze["t_resume"]]
    checks["hi_refill_held_while_frozen"] = max(s["refill"] for s in during) <= before["refill"]
    checks["hi_capacity_held_while_frozen"] = \
        max(s["capacity"] for s in during) <= before["capacity"]
    hbm = [a["devices"][0]["metrics"]["hbm_used_bytes"] for a in api_samples]
    checks["device_memory_above_32gb"] = max(hbm) > 32e9
    lo_calls, hi_calls = out["lo"]["calls_in_window"], out["hi"]["calls_in_window"]
    metrics = [a["devices"][0]["metrics"] for a in api_samples]
    report = {
        "tenants": out,
        "split_lo_hi": [lo_calls / max(lo_calls + hi_calls, 1),
                        hi_calls / max(lo_calls + hi_calls, 1)],
        "split_basis": "completed calls in the window (every call is the same forward)",
        "freeze": {"launches_while_frozen": freeze["launches_at_resume"]
                   - freeze["launches_at_freeze"], "calls_after_resume": len(hi_after),
                   "seconds": freeze["t_resume"] - freeze["t_freeze"],
                   "hi_refill_share_last_sample_before": sampled["refill"] / peak_mflops,
                   "hi_refill_share_before": before["refill"] / peak_mflops,
                   "hi_refill_share_while_frozen_max":
                       max(s["refill"] for s in during) / peak_mflops,
                   "hi_capacity_before_mflop": before["capacity"],
                   "hi_capacity_while_frozen_max_mflop": max(s["capacity"] for s in during),
                   "hi_blocked_while_frozen": during[-1]["blocked"] - before["blocked"]},
        "nvml": {"pids_seen": sorted(nvml_pids),
                 "proc_samples": api_samples[len(api_samples) // 2]["nvml_procs"]},
        "device": {"proc_util_supported": metrics[-1]["extra"]["proc_util_supported"],
                   "duty_pct_mean": sum(m["duty_cycle_pct"] for m in metrics) / len(metrics),
                   "power_w_mean": sum(m["power_watts"] for m in metrics) / len(metrics),
                   "hbm_used_gb_max": max(hbm) / 1e9},
        "window_s": window, "samples": len(samples), "api_samples": len(api_samples),
        "checks": checks}
    if not all(checks.values()):
        raise RuntimeError(f"node phase checks failed: {report}")
    return report


# -- interception: unmodified tenants metered by the launch hook alone --------


def _host_segment(limiter_lib, work, pods):
    """Uncontended worker segments ``intercept/<pod>`` under ``work`` (full
    duty, a bucket no call empties, no memory limit), made through the
    limiter's hypervisor face from a copy of the library; their paths."""
    from tensorfusion_tpu_torch.hypervisor import DeviceQuota, Limiter

    (work / "host").mkdir(parents=True, exist_ok=True)
    host = Limiter(str(shutil.copy2(limiter_lib, work / "host" / Path(limiter_lib).name)))
    host.init(str(work / "shm"))
    for pod in pods:
        host.create_worker("intercept", pod, [DeviceQuota(0, "gpu-0", 10000, 0, 10**15,
                                                          10**15)])
    return {pod: str(work / "shm" / "intercept" / pod) for pod in pods}


def _hook_env(hook_lib, limiter_lib, shm_path, peak_mflops):
    """What the node agent gives a soft worker for the launch hook
    (``WorkerController._inject_mandatory_metering``)."""
    import os

    return {**os.environ, "LD_PRELOAD": str(hook_lib), "TPF_SHM_PATH": shm_path,
            "TPF_LIMITER_LIB": str(limiter_lib), "TPF_DEVICE_INDEX": "0",
            "TPF_PEAK_MFLOPS": repr(peak_mflops)}


def _child(mode, out, env, timeout=600):
    """``chip_smoke.py mode out`` in a child process; it must succeed."""
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), mode, str(out)], env=env,
                       cwd=str(REPO), capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"{mode} failed (exit {r.returncode}):\n{r.stdout[-3000:]}"
                           f"{r.stderr[-3000:]}")


def _intercept_probe(torch, fa, hook_lib, limiter_lib, work, peak_mflops):
    """Part a: the driver entries a forward, a train step, graph capture
    and replay and direct flash calls reach under the hook; the flash
    output under the hook against the same call in this process."""
    from tensorfusion_tpu_torch.hypervisor import ShmView

    out = work / "probe"
    shm = _host_segment(limiter_lib, out, ["probe"])["probe"]
    _child("--probe", out, _hook_env(hook_lib, limiter_lib, shm, peak_mflops))
    probe = json.loads((out / "probe.json").read_text())
    parts = probe["parts"]

    def reached(part, prefix):
        return sum(n for entry, n in parts[part]["entries"].items() if entry.startswith(prefix))

    q, k, v = _probe_inputs(torch)
    want = fa.flash_fwd_cuda(q, k, v, PROBE_FLASH_SHAPE[-1] ** -0.5, True)[0].cpu()
    view = ShmView(shm)
    seg = _read_segment(view)
    view.close()
    report = probe["report"]
    checks = {
        "flash_reached": reached("flash_direct", "cuLaunchKernel") >= PROBE_FLASH_CALLS,
        "replays_reached": reached("graph_replay", "cuGraphLaunch") >= PROBE_DECODES,
        "flash_bit_equal": torch.equal(torch.load(out / "flash_out.pt"), want),
        "forward_reached": parts["forward"]["launches"] > 0,
        "train_step_reached": parts["train_step"]["launches"] > 0,
        "capture_not_charged": parts["graph_capture"]["captured"] > 0,
        "segment_is_the_hook": (seg["launches"] == report["charges"]
                                and seg["charged"] == report["charged_mflops"] > 0),
    }
    result = {"parts": parts, "graphs": probe["graphs"],
              "resolution": {k: report[k] for k in ("wrapped_by_gpa", "wrapped_by_dlsym")},
              "totals": {k: report[k] for k in HOOK_FIELDS}, "checks": checks}
    if not all(checks.values()):
        raise RuntimeError(f"the probe failed: {result}")
    return result


def _intercept_overhead(hook_lib, limiter_lib, work, peak_mflops):
    """Part b: tiny launches and the Llama-3-8B forward without and with
    the hook (uncontended), in four children: plain, hooked, hooked,
    plain."""
    import os
    import statistics

    shm = _host_segment(limiter_lib, work / "overhead", ["overhead"])["overhead"]
    runs = []
    for hooked in (False, True, True, False):
        out = work / "overhead" / f"run{len(runs)}"
        env = _hook_env(hook_lib, limiter_lib, shm, peak_mflops) if hooked else dict(os.environ)
        _child("--overhead", out, env)
        run = json.loads((out / "overhead.json").read_text())
        if run["hooked"] != hooked:
            raise RuntimeError(f"overhead run {len(runs)} hooked={run['hooked']}, not {hooked}")
        runs.append(run)
    side = {h: [r for r in runs if r["hooked"] == h] for h in (False, True)}
    tiny = {h: statistics.median(r["tiny_us"] for r in side[h]) for h in side}
    fwd = {h: statistics.median(ms for r in side[h] for ms in r["forward_ms"]) for h in side}
    result = {"tiny_us": {"plain": tiny[False], "hooked": tiny[True]},
              "hook_us_per_launch": tiny[True] - tiny[False],
              "forward_ms": {"plain": fwd[False], "hooked": fwd[True]},
              "forward_ratio": fwd[True] / fwd[False],
              "runs": [{k: r[k] for k in ("hooked", "tiny_us", "tiny_us_rounds", "forward_ms")}
                       for r in runs],
              "hooked_launches": [r["report"]["launches"] for r in side[True]],
              "order": "plain, hooked, hooked, plain"}
    if result["forward_ratio"] > 1.03:
        raise RuntimeError(f"the hook slows the forward more than 3%: {result}")
    return result


def _intercept_alone(hook_lib, limiter_lib, work, peak_mflops):
    """Part c: one raw tenant alone under an uncontended segment for
    INTERCEPT_ALONE_S: its charged device-seconds against its time in
    calls."""
    from tensorfusion_tpu_torch.hypervisor import ShmView

    shm = _host_segment(limiter_lib, work / "alone", ["alone"])["alone"]
    out = work / "alone" / "tenant"
    proc = subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--tenant-raw",
                             str(out)], env=_hook_env(hook_lib, limiter_lib, shm, peak_mflops),
                            cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    view = ShmView(shm)
    try:
        deadline = time.monotonic() + NODE_START_TIMEOUT_S
        while not any("t1" in l for l in _tenant_lines(out)):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError("the lone tenant made no call:\n" + _tail(out / "tenant.log"))
            time.sleep(0.5)
        time.sleep(INTERCEPT_ALONE_S)
        (out / "stop").touch()
        deadline = time.monotonic() + NODE_STOP_TIMEOUT_S
        while not any("stopped" in l for l in _tenant_lines(out)):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError("the lone tenant did not stop:\n" + _tail(out / "tenant.log"))
            time.sleep(0.2)
        seg = _read_segment(view)
    finally:
        view.close()
        proc.kill()
        proc.wait()
    lines = _tenant_lines(out)
    check = next(l["check"] for l in lines if "check" in l)
    stopped = next(l for l in lines if "stopped" in l)
    calls = [l for l in lines if "t1" in l]
    # the charges between the first call's record and the last one's pay
    # for the calls between them, one call late (a call's windows are read
    # at the next call's launches)
    in_calls = sum(l["t1"] - l["t0"] for l in calls[1:])
    charged_s = (calls[-1]["hook"]["charged_mflops"] - calls[0]["hook"]["charged_mflops"]) \
        / peak_mflops
    result = {"calls": len(calls), "time_in_calls_s": in_calls, "charged_device_s": charged_s,
              "charged_over_calls": charged_s / in_calls,
              "device_s_read": (calls[-1]["hook"]["device_us"]
                                - calls[0]["hook"]["device_us"]) / 1e6,
              "call_ms_median": sorted((l["t1"] - l["t0"]) * 1e3 for l in calls)[len(calls) // 2],
              "hook": stopped["hook"], "reserved_bytes": stopped["reserved"],
              "segment_hbm_used_bytes": seg["hbm_used"], "flash_launches": stopped["flash"],
              "checks": {"unmodified": check["client_runtime_imported"] is False,
                         "within_10pct": abs(charged_s / in_calls - 1.0) <= 0.10,
                         "segment_is_the_hook": (
                             seg["launches"] == stopped["hook"]["charges"]
                             and seg["charged"] == stopped["hook"]["charged_mflops"] > 0),
                         "memory_covers_reserved": (stopped["hook"]["hbm_charged_bytes"]
                                                    >= stopped["reserved"] > 0),
                         "all_windowed": _all_windowed(stopped["hook"])}}
    if not all(result["checks"].values()):
        raise RuntimeError(f"the lone tenant's charges failed: {result}")
    return result


def _intercept_pair(hv_build, limiter_lib, work, peak_mflops, solo_call_s):
    """Part d: ``default/lo`` (25%, low) and ``default/hi`` (75%, high), raw
    tenants spawned by the daemon, metered by the hook alone for
    INTERCEPT_WINDOW_S with no freeze; the daemon's tick times.  A call's
    device time alone (``solo_call_s``, from part c) prices the work each
    tenant did, against what it was charged."""
    from tensorfusion_tpu_torch.hypervisor import Provider, list_worker_segments

    work.mkdir(parents=True, exist_ok=True)
    provider_lib = hv_build.provider_path()
    provider = Provider(str(provider_lib))
    provider.init()
    daemon, url = _start_daemon(provider_lib, limiter_lib, work)
    tenants = {}
    try:
        chip = _api(url, "/api/v1/devices")[0]["info"]["chip_id"]
        tenants = _submit_tenants(url, chip, work, "--tenant-raw", hv_build.cuda_hook_path())
        _node_wait_for_calls(tenants, daemon)
        t_start, t_end, samples, api_samples, _ = _node_window(
            url, provider, tenants, INTERCEPT_WINDOW_S, freeze_pod=None)
        ticks = _api(url, "/api/v1/ticks")
        final = _node_stop(daemon, tenants)
        pids = {l["start"] for f in final.values() for l in f["lines"] if "start" in l}
        for pod in tenants:
            _api(url, f"/api/v1/workers/default/{pod}", "DELETE")
    finally:
        for t in tenants.values():
            t["view"].close()
        _stop(daemon)
        provider.shutdown()
    left = list_worker_segments(str(work / "shm"))
    alive = sorted(p for p in pids if Path(f"/proc/{p}").exists())
    if left or alive:
        raise RuntimeError(f"after DELETE: segments {left}, tenant processes {alive}")
    return _intercept_report(tenants, t_start, t_end, samples, api_samples, final, ticks,
                             peak_mflops, solo_call_s)


def _intercept_report(tenants, t_start, t_end, samples, api_samples, final, ticks,
                      peak_mflops, solo_call_s):
    """Part d's numbers, and its checks (each failure raises): the card's
    NVML duty is held to INTERCEPT_MIN_DUTY; the split is recorded."""
    window = t_end - t_start
    out, checks = {}, {}
    for pod, t in tenants.items():
        lines = final[pod]["lines"]
        seg, stopped = final[pod]["segment"], final[pod]["stopped"]
        check = next(l["check"] for l in lines if "check" in l)
        calls = [l for l in lines if "t1" in l]
        series = [s[pod] for s in samples]
        in_window = [l for l in calls if l["t1"] > t_start and l["t0"] < t_end]
        busy = sum(min(l["t1"], t_end) - max(l["t0"], t_start) for l in in_window)
        charged = series[-1]["charged"] - series[0]["charged"]
        shares = [s["refill"] / peak_mflops for s in series]
        statuses = [w["status"] for a in api_samples for w in a["workers"]
                    if w["spec"]["name"] == pod]
        n_calls = sum(1 for l in calls if t_start <= l["t1"] <= t_end)
        out[pod] = {
            "duty_percent": t["duty"], "qos": t["qos"],
            "starts": sum("start" in l for l in lines),
            "client_runtime_imported": check["client_runtime_imported"],
            "peak_mflops": check["peak_mflops"],
            "calls_in_window": n_calls,
            "tokens_per_s": n_calls * NODE_SHAPE[0] * NODE_SHAPE[1] / window,
            "wall_share_in_calls": busy / window,
            "charged_device_s": charged / peak_mflops,
            "charged_share_of_window": charged / peak_mflops / window,
            # the card time its calls would take alone, and what it paid for it
            "work_device_s": n_calls * solo_call_s,
            "charged_over_work": charged / peak_mflops / max(n_calls * solo_call_s, 1e-9),
            "segment_launches": seg["launches"], "segment_charged_mflop": seg["charged"],
            "hook": stopped["hook"],
            "blocked_events_in_window": series[-1]["blocked"] - series[0]["blocked"],
            "reserved_bytes": stopped["reserved"], "segment_hbm_used_bytes": seg["hbm_used"],
            "refill_share": {"first": shares[0], "median": sorted(shares)[len(shares) // 2],
                             "last": shares[-1], "min": min(shares), "max": max(shares)},
            "erl_settle_s": _settle_s([(s["t"] - t_start, s["refill"]) for s in series]),
            "nvml_duty_pct_mean": sum(s["duty_cycle_pct"] for s in statuses) / len(statuses),
            "flash_launches": stopped["flash"],
        }
        checks[f"{pod}_one_start"] = out[pod]["starts"] == 1
        checks[f"{pod}_unmodified"] = check["client_runtime_imported"] is False
        checks[f"{pod}_metered_by_hook"] = (
            seg["launches"] == stopped["hook"]["charges"] > 0
            and seg["charged"] == stopped["hook"]["charged_mflops"] > 0
            and stopped["hook"]["device_us"] > 0)
        checks[f"{pod}_memory_charged"] = (
            seg["hbm_used"] > 0 and stopped["hook"]["hbm_charged_bytes"] >= stopped["reserved"])
        checks[f"{pod}_all_windowed"] = _all_windowed(stopped["hook"])
    lo_calls, hi_calls = out["lo"]["calls_in_window"], out["hi"]["calls_in_window"]
    metrics = [a["devices"][0]["metrics"] for a in api_samples]
    duty = sum(m["duty_cycle_pct"] for m in metrics) / len(metrics)
    split_lo = lo_calls / max(lo_calls + hi_calls, 1)
    tick_ms = sorted(ms for t, ms in ticks if t_start <= t <= t_end)
    checks["duty_at_least_90"] = duty >= INTERCEPT_MIN_DUTY
    report = {
        "tenants": out,
        "split_lo_hi": [split_lo, 1.0 - split_lo],
        "split_basis": "completed calls in the window (every call is the same forward)",
        "charged_split_lo": out["lo"]["charged_device_s"]
        / max(out["lo"]["charged_device_s"] + out["hi"]["charged_device_s"], 1e-9),
        "work_share_of_window": (out["lo"]["work_device_s"] + out["hi"]["work_device_s"])
        / window,
        "lo_in_band": INTERCEPT_LO_BAND[0] <= split_lo <= INTERCEPT_LO_BAND[1],
        "device": {"duty_pct_mean": duty,
                   "power_w_mean": sum(m["power_watts"] for m in metrics) / len(metrics)},
        "tick_ms": {"p50": tick_ms[len(tick_ms) // 2],
                    "p99": tick_ms[min(int(0.99 * (len(tick_ms) - 1)), len(tick_ms) - 1)],
                    "max": tick_ms[-1], "n": len(tick_ms)},
        "window_s": window, "samples": len(samples), "api_samples": len(api_samples),
        "checks": checks}
    if not all(checks.values()) or not tick_ms:
        raise RuntimeError(f"intercept checks failed: {report}")
    return report


def phase_intercept(torch, fa, hardware, hv_build, limiter_lib, name, smi):
    """Mandatory metering by the launch hook (``hypervisor/csrc/cuda_hook.c``)
    of tenants that never import the client runtime: a probe of what it
    intercepts (a), its overhead (b), its charge accuracy alone (c), and
    two raw tenants under the daemon (d).  Returns the tenants' kernel
    launches (parts c and d)."""
    t_phase = time.perf_counter()
    work = WORK / "intercept"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    peak_mflops = hardware.peak_rates(name)["bf16"] / 1e6
    hook_lib = hv_build.cuda_hook_path()
    probe = _intercept_probe(torch, fa, hook_lib, limiter_lib, work, peak_mflops)
    emit("intercept_probe", **probe)
    overhead = _intercept_overhead(hook_lib, limiter_lib, work, peak_mflops)
    alone = _intercept_alone(hook_lib, limiter_lib, work, peak_mflops)
    pair = _intercept_pair(hv_build, limiter_lib, work / "pair", peak_mflops,
                           alone["call_ms_median"] / 1e3)
    emit("intercept", overhead=overhead, alone=alone, **pair, peak_mflops=peak_mflops,
         nvidia_smi=smi, seconds=time.perf_counter() - t_phase)
    launches = {k: 0 for k in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")}
    launches["flash_attn_fwd"] = alone["flash_launches"] + sum(
        t["flash_launches"] for t in pair["tenants"].values())
    return launches


# -- multi-rank tenants: the sharded remote EXECUTE and the mesh under the daemon

SHARD_RANKS = 4                            # the sharded worker's devices (ranks)
SHARD_LAYERS = 8                           # part a: phase_remote's forward depth
SHARD_SHAPE = (4, 1024)                    # its tokens: one sequence a rank
SHARD_CALLS = 12                           # timed sharded EXECUTEs
SHARD_MLP_ROWS = 4096                      # part b: [rows, dim] replicated input
SHARD_EPHEMERAL_CALLS = 3                  # part b: calls with per-call shards
SHARD_HBM_BYTES = 70 << 30                 # a multi-rank tenant's memory budget
SHARD_START_TIMEOUT_S = 300.0              # the worker's ranks up, the port written
SHARD_COLLECTIVE_MB = 256                  # part d: one host-staged all-reduce


def _mlp_fn(llama):
    """Llama's MLP with its weights as arguments: w1 / w3 column-sharded
    and w2 row-sharded over the ranks make one partial-sum reduction."""
    def mlp(w1, w3, w2, x):
        return llama._mlp({"w_gate": w1, "w_up": w3, "w_down": w2}, x)
    return mlp


def _submit_multi_rank(url, chip, pod, command):
    """``default/<pod>``: a soft worker at 100% duty whose command starts a
    rank group; its env must preload the launch hook.  Returns its env."""
    spec = {"namespace": "default", "name": pod, "isolation": "soft", "qos": "high",
            "devices": [{"chip_id": chip, "duty_percent": 100.0,
                         "hbm_bytes": SHARD_HBM_BYTES}],
            "command": command}
    env = _api(url, "/api/v1/workers", "POST", spec)["status"]["env"]
    if not env.get("LD_PRELOAD", "").startswith(str(REPO)):
        raise RuntimeError(f"{pod}'s env does not preload the hook: {env.get('LD_PRELOAD')!r}")
    return env


def _segment_vs_hooks(seg, reports):
    """The segment's launches and charges against the processes' hook
    reports, which must add up to them exactly."""
    return {"segment_launches": seg["launches"], "segment_charged_mflop": seg["charged"],
            "hook_charges": sum(r["charges"] for r in reports),
            "hook_charged_mflops": sum(r["charged_mflops"] for r in reports),
            "equal": seg["launches"] == sum(r["charges"] for r in reports)
            and seg["charged"] == sum(r["charged_mflops"] for r in reports),
            "unwindowed": sum(r["unwindowed"] for r in reports),
            "captured": sum(r["captured"] for r in reports)}


def _shard_forward(torch, llama, dev, cfg):
    """Part a: the 8-layer last-position forward, weights resident and
    replicated, tokens batch-sharded one sequence a rank, against the
    local call on the same weights."""
    tree_map = torch.utils._pytree.tree_map
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    params = llama.init_params(cfg, gen, device=DEVICE)
    tokens = torch.randint(0, cfg.vocab_size, SHARD_SHAPE, generator=gen, device=DEVICE)
    fn = _last_logits(llama, cfg)
    want = fn(params, tokens)
    local_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        fn(params, tokens)
        torch.cuda.synchronize()
        local_s.append(time.perf_counter() - s0)
    full = _last_logits(llama, dataclasses.replace(cfg, attn_impl="full"))(params, tokens)
    p32 = _float(params)
    exact = _last_logits(llama, dataclasses.replace(
        cfg, dtype=torch.float32, attn_impl="full"))(p32, tokens)
    del p32
    host = tree_map(lambda t: t.cpu(), params)
    weights_bytes = sum(t.numel() * t.element_size()
                        for t in torch.utils._pytree.tree_leaves(host))
    del params
    torch.cuda.empty_cache()

    s0 = time.perf_counter()
    rparams = tree_map(dev.put, host)
    put_s = time.perf_counter() - s0
    remote = dev.remote_jit(fn, in_specs=(None, ("b",)), out_specs=("b",))
    host_tokens = tokens.cpu()
    s0 = time.perf_counter()
    layouts = remote.compile_for(rparams, host_tokens)
    compile_s = time.perf_counter() - s0
    s0 = time.perf_counter()
    remote(rparams, host_tokens)          # the first call replicates the weights
    first_s = time.perf_counter() - s0
    resident = dev.info()["resident_bytes_per_device"]
    round_trips = []
    for _ in range(SHARD_CALLS):
        s0 = time.perf_counter()
        got = remote(rparams, host_tokens)
        round_trips.append(time.perf_counter() - s0)
    out = got.to(DEVICE)
    for leaf in torch.utils._pytree.tree_leaves(rparams):
        leaf.free()
    bf16 = {"remote_vs_local": _rel(out, want), "remote_vs_f32": _rel(out, exact),
            "full_vs_f32": _rel(full, exact)}
    row = {"dim": cfg.dim, "n_layers": cfg.n_layers, "dtype": str(cfg.dtype),
           "tokens": list(SHARD_SHAPE), "arg_layout_tokens": layouts[3][-1],
           "out_layout": layouts[4][0], "weights_bytes": weights_bytes, "put_s": put_s,
           "compile_s": compile_s, "first_call_s": first_s,
           "resident_bytes_per_device_after_first_call": resident,
           "execute_ms": _quantiles_ms(round_trips), "local_ms": sorted(local_s)[2] * 1e3,
           "equal_local": torch.equal(out, want),
           "argmax_equal_local": torch.equal(out.argmax(-1), want.argmax(-1)),
           "max_abs_logit_diff_vs_local": (out - want).abs().max().item(),
           "bf16_rel": bf16, "rule": "remote_vs_f32 <= 1.5 x full_vs_f32 (phase_remote's)"}
    ok = bf16["remote_vs_f32"] <= 1.5 * bf16["full_vs_f32"] and bool(
        torch.isfinite(out).all())
    replicated = all(v >= weights_bytes for v in resident.values())
    return row, ok and replicated


def _shard_mlp(torch, llama, dev, cfg):
    """Part b: Llama-3-8B's MLP, w1 / w3 column-sharded and w2 row-sharded
    and resident, the input replicated: one partial-sum reduction."""
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    dim, ffn = cfg.dim, cfg.ffn_dim

    def w(shape):
        return (torch.randn(shape, generator=gen, device=DEVICE) / shape[0] ** 0.5
                ).to(cfg.dtype)

    w1, w3, w2 = w((dim, ffn)), w((dim, ffn)), w((ffn, dim))
    x = torch.randn((SHARD_MLP_ROWS, dim), generator=gen, device=DEVICE).to(cfg.dtype)
    mlp = _mlp_fn(llama)
    want = mlp(w1, w3, w2, x)
    exact = mlp(*(t.float() for t in (w1, w3, w2, x)))
    hw = [t.cpu() for t in (w1, w3, w2)]
    hx = x.cpu()
    del w1, w3, w2
    torch.cuda.empty_cache()
    remote = dev.remote_jit(mlp, in_specs=((None, "m"), (None, "m"), ("m", None), None),
                            out_specs=None)
    refs = [remote.upload_arg(i, t, *hw, hx) for i, t in enumerate(hw)]
    resident_s = []
    for _ in range(3):
        s0 = time.perf_counter()
        got = remote(*refs, hx)
        resident_s.append(time.perf_counter() - s0)
    got = got.to(DEVICE)
    # one resident shard a device, fetched from its device, against its slice
    fetched = []
    for sid, ent in zip(refs[0].shard_ids, refs[0].layout):
        _, meta, bufs = dev._rpc("FETCH", {"buf_id": sid, "device_id": ent["device"]}, [])
        fetched.append(meta.get("device_id") == ent["device"] and torch.equal(
            bufs[0], hw[0][tuple(slice(lo, hi) for lo, hi in ent["slices"])]))
    for ref in refs:
        ref.free()
    after_free = dev.info()["resident_bytes_per_device"]
    s0 = time.perf_counter()
    for _ in range(SHARD_EPHEMERAL_CALLS):
        per_call = remote(*hw, hx)
    ephemeral_s = (time.perf_counter() - s0) / SHARD_EPHEMERAL_CALLS
    after_calls = dev.info()["resident_bytes_per_device"]
    rel = {"remote_vs_local": _rel(got, want), "remote_vs_f32": _rel(got, exact),
           "local_vs_f32": _rel(want, exact),
           "per_call_shards_vs_resident": _rel(per_call.to(DEVICE), got)}
    row = {"dim": dim, "ffn": ffn, "rows": SHARD_MLP_ROWS, "dtype": str(cfg.dtype),
           "w1_layout": refs[0].layout, "w2_layout": refs[2].layout, "bf16_rel": rel,
           "rule": "remote_vs_f32 <= 1.5 x local_vs_f32", "shard_fetch_bit_equal": fetched,
           "resident_after_free": after_free, "resident_after_ephemeral_calls": after_calls,
           "resident_call_s": sorted(resident_s)[1], "ephemeral_call_s": ephemeral_s,
           "shard_bytes": [hw[0].numel() * 2 // SHARD_RANKS, hw[2].numel() * 2 // SHARD_RANKS]}
    ok = (rel["remote_vs_f32"] <= 1.5 * rel["local_vs_f32"] and all(fetched)
          and not any(after_free.values()) and not any(after_calls.values())
          and rel["per_call_shards_vs_resident"] == 0.0)
    return row, ok


def _shard_metering(seg, ranks_info, peak_mflops):
    """Part c: the tenant's segment against its processes' hook reports,
    and its charged device-seconds against its ranks' time in calls."""
    reports = [ranks_info["worker"]["hook"]] + [r["hook"] for r in ranks_info["ranks"]]
    pids = [ranks_info["worker"]["pid"]] + [r["pid"] for r in ranks_info["ranks"]]
    in_calls = sum(r["call_s"] for r in ranks_info["ranks"])
    row = {"pids_registered": seg["pids"], "pids": pids,
           **_segment_vs_hooks(seg, reports),
           "charged_device_s": seg["charged"] / peak_mflops,
           "ranks_s_in_calls": in_calls,
           "charged_over_time_in_calls": seg["charged"] / peak_mflops / max(in_calls, 1e-9),
           "per_rank": [{"pid": r["pid"], "calls": r["calls"], "call_s": r["call_s"],
                         "charges": r["hook"]["charges"],
                         "charged_s": r["hook"]["charged_mflops"] / peak_mflops,
                         "flash_launches": r["launch_counts"]["flash_attn_fwd"]}
                        for r in ranks_info["ranks"]]}
    ok = (sorted(seg["pids"]) == sorted(pids) and row["equal"]
          and row["unwindowed"] == 0 and row["captured"] == 0
          and all(p["flash_launches"] > 0 for p in row["per_rank"]))
    return row, ok


def _mesh_rank_tenant(plan, cfg, seed, batch_seed, collective_mb):
    """A rank of the mesh tenant: the mesh phase's sharded train step (no
    checkpoint), with the launch hook's report before and after the
    steps, and one host-staged all-reduce between two reports."""
    import os

    torch, dist, ops, collectives = _rank_env()
    from tensorfusion_tpu_torch.hypervisor import cuda_hook_binding
    from tensorfusion_tpu_torch.models import llama
    from tensorfusion_tpu_torch.parallel import make_mesh

    hook = cuda_hook_binding.loaded()
    if hook is None or not hook.metered():
        raise RuntimeError("a rank of the mesh tenant runs without the launch hook")
    dev = plan["device"]
    mesh = make_mesh(plan["axes"], device=dev)
    params = _one_rank_at_a_time(torch, dist, lambda: llama.shard_params(llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev), mesh, cfg))
    step, init_opt = llama.make_train_step(cfg, device=dev, mesh=mesh)
    opt = init_opt(params)
    batch = _train_batch(torch, cfg.vocab_size, plan["shape"], batch_seed, dev)
    torch.cuda.empty_cache()
    tick = torch.zeros(1, device=dev)

    def charged():
        tick.add_(1)             # a launch: the hook pays the last window
        torch.cuda.synchronize()
        return hook.report()["charged_mflops"]

    collectives.STATS.reset()
    c0 = charged()
    losses, step_s, gloo_s, blocked_s = [], [], [], []
    for _ in range(plan["steps"]):
        g0 = collectives.STATS.seconds
        b0 = hook.report()["blocked_us"]
        t0 = _synced(torch, dist)
        params, opt, loss = step(params, opt, batch)
        losses.append(loss.item())
        step_s.append(_synced(torch, dist) - t0)
        gloo_s.append(collectives.STATS.seconds - g0)
        blocked_s.append((hook.report()["blocked_us"] - b0) / 1e6)
    c1 = charged()
    del params, opt
    torch.cuda.empty_cache()
    x = torch.ones(collective_mb << 19, dtype=torch.bfloat16, device=dev)
    c2 = charged()
    t0 = _synced(torch, dist)
    collectives.all_reduce(x, dist.group.WORLD)
    coll_s = _synced(torch, dist) - t0
    c3 = charged()
    return {"pid": os.getpid(), "losses": losses, "step_s": step_s,
            "gloo_s": gloo_s, "blocked_s": blocked_s, "comm": collectives.STATS.as_dict(),
            "launches": ops.launch_counts(), "steps_charged_mflops": c1 - c0,
            "collective_s": coll_s, "collective_charged_mflops": c3 - c2,
            "peak_memory_gb": _peak_gb(torch), "hook": hook.report()}


def mesh_tenant_main(out: Path) -> int:
    """The mesh tenant of ``phase_shard`` (part d), spawned by the daemon
    with the launch hook preloaded: MESH_RANKS ranks on the card over
    gloo run the mesh phase's fsdp2 x tp2 train step at 8B width; a record of every
    rank and of this process, then idle until terminated."""
    import os

    record = _tenant_log(out)
    import torch

    sys.path.insert(0, str(REPO))
    from tensorfusion_tpu_torch import parallel
    from tensorfusion_tpu_torch.models import llama

    record(start=os.getpid(), t=time.monotonic())
    hook = _hooked()
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), attn_impl="flash",
                              n_layers=MESH_LAYERS)
    with parallel.RankGroup(MESH_RANKS, device=DEVICE, backend="gloo",
                            timeout_s=900) as ranks:
        res = ranks.run(_mesh_rank_tenant, _mesh_plan(), cfg, 21, 22, SHARD_COLLECTIVE_MB)
    record(stopped=time.monotonic(), ranks=res,
           parent={"pid": os.getpid(), "hook": hook.report()})
    while True:
        time.sleep(3600)


UNION_FIELDS = ("window_us", "device_us", "union_on", "union_windows", "unanchored", "anchors",
                "anchor_misses", "anchor_err_us_max")


def _mesh_tenant(url, chip, work, peak_mflops):
    """Part d: the mesh tenant under the daemon, its record and its
    segment once it has stopped."""
    from tensorfusion_tpu_torch.hypervisor import ShmView

    out = work / "mesh"
    env = _submit_multi_rank(url, chip, "mesh", [
        sys.executable, str(REPO / "chip_smoke.py"), "--mesh-tenant", str(out)])
    view = ShmView(env["TPF_SHM_PATH"])
    try:
        deadline = time.monotonic() + 900
        while True:
            lines = _tenant_lines(out)
            if any("stopped" in l for l in lines):
                break
            if time.monotonic() > deadline or sum("start" in l for l in lines) > 1:
                raise RuntimeError("the mesh tenant did not finish:\n"
                                   + _tail(out / "tenant.log"))
            time.sleep(1.0)
        seg = _read_segment(view)
    finally:
        view.close()
    _api(url, "/api/v1/workers/default/mesh", "DELETE")
    rec = next(l for l in lines if "stopped" in l)
    ranks = rec["ranks"]
    reports = [rec["parent"]["hook"]] + [r["hook"] for r in ranks]
    step_s = [sum(r["step_s"]) for r in ranks]
    gloo_s = [sum(r["gloo_s"]) for r in ranks]
    charged_s = [r["steps_charged_mflops"] / peak_mflops for r in ranks]
    row = {"axes": MESH_AXES, "n_layers": MESH_LAYERS, "shape": list(MESH_SHAPE),
           "steps": MESH_STEPS, "losses": ranks[0]["losses"],
           "step_ms": [max(r["step_s"][i] for r in ranks) * 1e3 for i in range(MESH_STEPS)],
           # the time each rank slept in the launch hook, refused by the
           # tenant's bucket, in each step
           "blocked_ms_per_rank": [[b * 1e3 for b in r["blocked_s"]] for r in ranks],
           "gloo_share_per_rank": [g / s for g, s in zip(gloo_s, step_s)],
           "steps_charged_device_s_per_rank": charged_s,
           "steps_outside_gloo_s_per_rank": [s - g for s, g in zip(step_s, gloo_s)],
           "charged_over_outside_gloo": sum(charged_s) / max(
               sum(s - g for s, g in zip(step_s, gloo_s)), 1e-9),
           "collective": {"mb": SHARD_COLLECTIVE_MB,
                          "s_per_rank": [r["collective_s"] for r in ranks],
                          "charged_device_s_per_rank": [
                              r["collective_charged_mflops"] / peak_mflops for r in ranks]},
           "launches_per_rank": [r["launches"] for r in ranks],
           # the ranks charge the union of their windows (csrc/cuda_hook.c,
           # "Several processes of one worker"): window_us is what their
           # windows summed, device_us what they were charged
           "union_per_rank": [{k: r["hook"][k] for k in UNION_FIELDS} for r in ranks],
           "charged_over_windows": sum(r["hook"]["device_us"] for r in ranks) / max(
               sum(r["hook"]["window_us"] for r in ranks), 1),
           "peak_memory_gb_per_rank": [r["peak_memory_gb"] for r in ranks],
           "pids_registered": seg["pids"], **_segment_vs_hooks(seg, reports)}
    ok = (row["equal"] and sorted(seg["pids"]) == sorted(
        [rec["parent"]["pid"]] + [r["pid"] for r in ranks])
        and all(r["hook"]["union_on"] == 1 for r in ranks)
        and all(n > 0 for r in ranks for n in r["launches"].values())
        and all(math.isfinite(l) for l in row["losses"])
        and all(r["losses"] == row["losses"] for r in ranks))
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    return row, ok, launches


def phase_shard(torch, llama, remoting, hardware, hv_build, limiter_lib, name, smi):
    """Multi-rank tenants under the node agent.  The daemon spawns the
    sharded remote worker (``python -m tensorfusion_tpu_torch.remoting
    --ranks 4``) as one soft tenant, ``default/shard``, at 100% duty; a
    client in this process runs (a) the 8-layer 8B-width flash forward,
    weights resident and replicated, tokens batch-sharded, (b) Llama-3-8B's
    MLP with column- and row-sharded resident weights, and reads (c) the
    tenant's segment against its five processes' hook reports.  Then (d)
    the daemon spawns the mesh phase's fsdp2 x tp2 train step (4 layers, 8B width)
    as a second multi-rank tenant for MESH_STEPS steps.  Returns the
    kernel launches of the tenants' ranks."""
    from tensorfusion_tpu_torch.hypervisor import ShmView, list_worker_segments

    t_phase = time.perf_counter()
    work = WORK / "shard"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    peak_mflops = hardware.peak_rates(name)["bf16"] / 1e6
    provider_lib = hv_build.provider_path()
    daemon, url = _start_daemon(provider_lib, limiter_lib, work)
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), attn_impl="flash",
                              n_layers=SHARD_LAYERS)
    checks = {}
    try:
        chip = _api(url, "/api/v1/devices")[0]["info"]["chip_id"]
        port_file = work / "worker.port"
        env = _submit_multi_rank(url, chip, "shard", [
            sys.executable, "-m", "tensorfusion_tpu_torch.remoting", "--ranks",
            str(SHARD_RANKS), "--device", DEVICE, "--host", "127.0.0.1", "--port", "0",
            "--port-file", str(port_file)])
        t0 = time.monotonic()
        while not port_file.exists():
            if time.monotonic() - t0 > SHARD_START_TIMEOUT_S or daemon.poll() is not None:
                raise RuntimeError("the sharded worker did not come up:\n"
                                   + _tail(work / "daemon.log"))
            time.sleep(0.5)
        start_s = time.monotonic() - t0
        view = ShmView(env["TPF_SHM_PATH"])
        dev = remoting.RemoteDevice(f"tcp://127.0.0.1:{port_file.read_text()}",
                                    timeout_s=900)
        try:
            info = dev.info()
            fwd, checks["forward"] = _shard_forward(torch, llama, dev, cfg)
            emit("shard_forward", ranks=SHARD_RANKS, worker_start_s=start_s,
                 n_devices=info["n_devices"], devices=info["devices"], **fwd,
                 nvidia_smi=smi)
            torch.cuda.empty_cache()
            mlp, checks["mlp"] = _shard_mlp(torch, llama, dev, cfg)
            emit("shard_mlp", **mlp, nvidia_smi=smi)
            ranks_info = dev.info(ranks=True)["ranks"]
            meter, checks["metering"] = _shard_metering(_read_segment(view), ranks_info,
                                                        peak_mflops)
            emit("shard_metering", **meter, nvidia_smi=smi)
        finally:
            dev.close()
            view.close()
        _api(url, "/api/v1/workers/default/shard", "DELETE")
        torch.cuda.empty_cache()
        mesh, checks["mesh_tenant"], mesh_launches = _mesh_tenant(url, chip, work,
                                                                  peak_mflops)
        emit("shard_mesh_tenant", **mesh, nvidia_smi=smi)
    finally:
        _stop(daemon)
    left = list_worker_segments(str(work / "shm"))
    checks["segments_removed"] = not left
    launches = {k: mesh_launches.get(k, 0) for k in mesh_launches}
    launches["flash_attn_fwd"] += sum(p["flash_launches"] for p in meter["per_rank"])
    emit("shard_done", checks=checks, launches=launches,
         seconds=time.perf_counter() - t_phase)
    if not all(checks.values()):
        raise RuntimeError(f"shard phase checks failed: {checks}")
    return launches


# -- the control plane: the store, the node agent, admission and scheduling ---

CP_TOKEN = "chip-smoke-store"              # the state store's admin token
CP_NODE = "chip-smoke-node"                # the node agent's name in the store
CP_POOL = "pool-h100"
CP_GENERATION = "h100-sxm"
CP_DUTY = "25"                             # the tenant's request: a quarter of the card
CP_TFLOPS = "247.25"                       # what admission makes of it: 25% of 989 TFLOP/s
CP_WINDOW_S = 20.0                         # the tenant's calls after its first
CP_TIMEOUT_S = 60.0                        # an object or a worker to appear
CP_GANG_TIMEOUT_S = 2.0                    # the refused gang's permit timeout
CP_QUOTA_TFLOPS = 300.0                    # the quota namespace: one 25% pod, not two
CP_SCALE = (64, 8, 512)                    # the host-only step: nodes, cards a node, pods
CP_SCALE_SEED = 64


def _cp_wait(fn, what, timeout=CP_TIMEOUT_S, procs=()):
    """fn()'s first true value, polled; raises at the timeout or when one
    of ``procs`` ((name, Popen) pairs) has exited."""
    deadline = time.monotonic() + timeout
    while True:
        got = fn()
        if got:
            return got
        for who, proc in procs:
            if proc.poll() is not None:
                raise RuntimeError(f"{who} exited ({proc.returncode}) before {what}")
        if time.monotonic() > deadline:
            raise RuntimeError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _start_statestore(work, port=0):
    """``python -m tensorfusion_tpu_torch.statestore`` persisted under
    ``work/persist``, on ``port`` (0: any); the process and its port."""
    port_file = work / "statestore.port"
    port_file.unlink(missing_ok=True)
    log = open(work / "statestore.log", "a")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorfusion_tpu_torch.statestore", "--port", str(port),
         "--port-file", str(port_file), "--persist-dir", str(work / "persist"),
         "--token", CP_TOKEN], cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT)
    log.close()
    _cp_wait(lambda: port_file.exists() and port_file.read_text().strip(),
             "the state store's port", procs=[("the state store", proc)])
    return proc, int(port_file.read_text())


class _Platform:
    """The control plane composed in this process, as the reference's own
    scheduler tests compose it, over the store: an allocator fed the
    store's TPUChips, the port, index and gang managers, the webhook
    (parser and mutator, the port's chip table) and the scheduler with the
    fit and topology plugins.  ``bind`` does what the reference operator's
    bind does (a version-checked update that sets the node, merges the
    stamped annotations and marks the pod Running); ``evict`` deletes the
    pod and releases its allocation.  It records when each pod was
    submitted, bound and evicted, and the scheduler's reasons."""

    def __init__(self, rs, chips, nodes_fn):
        from tensorfusion_tpu_torch import constants
        from tensorfusion_tpu_torch.allocator import (IndexAllocator, PortAllocator,
                                                      TPUAllocator)
        from tensorfusion_tpu_torch.api import types as api_types
        from tensorfusion_tpu_torch.config.chip_info import mock_chip_info
        from tensorfusion_tpu_torch.scheduler import (GangManager, ICITopologyPlugin, Scheduler,
                                                      TPUResourcesFit)
        from tensorfusion_tpu_torch.store import ConflictError
        from tensorfusion_tpu_torch.webhook import PodMutator, WorkloadParser

        self.c, self.types, self.rs, self._conflict = constants, api_types, rs, ConflictError
        self.alloc = TPUAllocator(store=rs)
        for chip in chips:
            self.alloc.upsert_chip(chip)
        self.gang = GangManager()
        self.mutator = PodMutator(rs, WorkloadParser(rs, chip_models=mock_chip_info(),
                                                     default_pool=CP_POOL))
        self.sched = Scheduler(nodes_fn=nodes_fn, bind_fn=self.bind,
                               failure_handler=self._failed)
        self.gang.bind_scheduler(self.sched)
        self.sched.permit_reject_listeners.append(
            lambda key, reason: self.permit_rejects.append((key, reason)))
        self.sched.register(TPUResourcesFit(
            self.alloc, gang=self.gang, ports=PortAllocator(), indices=IndexAllocator(),
            pods_on_node=self.pods_on_node, evict=self.evict))
        self.sched.register(ICITopologyPlugin())
        self.submitted, self.bound, self.evicted = {}, {}, {}
        self.reasons, self.permit_rejects, self.bind_conflicts = {}, [], 0

    def submit(self, name, ann, ns="default"):
        """A pod with user annotations only, through the webhook into the
        store and the scheduler's queue; its key."""
        pod = self.types.Pod.new(name, namespace=ns)
        pod.metadata.annotations.update(ann)
        pod.spec.containers = [self.types.Container(name="main")]
        self.submitted[pod.key()] = time.monotonic()
        pod = self.rs.create(self.mutator.handle(pod)).thaw()
        self.sched.enqueue(pod)
        return pod.key()

    def bind(self, pod, node):
        for attempt in range(5):
            current = self.rs.get(self.types.Pod, pod.metadata.name,
                                  pod.metadata.namespace).thaw()
            current.spec.node_name = node
            current.metadata.annotations.update(pod.metadata.annotations)
            current.status.phase = self.c.PHASE_RUNNING
            current.status.host_ip = node
            try:
                self.rs.update(current, check_version=True)
                break
            except self._conflict:
                self.bind_conflicts += 1
                if attempt == 4:
                    raise
        self.bound[pod.key()] = time.monotonic()

    def _failed(self, pod, reason):
        self.reasons[pod.key()] = reason

    def pods_on_node(self, node):
        return [p for p in self.rs.list(self.types.Pod) if p.spec.node_name == node]

    def evict(self, pod):
        self.evicted[pod.key()] = time.monotonic()
        self.delete(pod.key())

    def delete(self, key):
        """Delete a pod from the store and forget it everywhere (what the
        operator does on the pod's DELETED event)."""
        ns, name = key.split("/", 1)
        self.rs.delete(self.types.Pod, name, ns)
        self.sched.forget(key)
        self.gang.on_pod_deleted(key)
        self.alloc.dealloc(key)

    def chip_ids(self, key):
        ns, name = key.split("/", 1)
        return self.rs.get(self.types.Pod, name, ns).metadata.annotations.get(
            self.c.ANN_CHIP_IDS, "")

    def available(self):
        return {s.chip.name: dataclasses.asdict(s.available()) for s in self.alloc.chips()}

    def sync(self, what):
        """Flush the allocator's chip status into the store until the store
        holds it: a write that conflicts with the agent's inventory write
        goes back on the allocator's dirty list and is retried, and a
        field the agent reverted would never match."""
        def synced():
            self.alloc.sync_to_store()
            for state in self.alloc.chips():
                st = self.rs.get(self.types.TPUChip, state.chip.name).status
                if (dataclasses.asdict(st.available) != dataclasses.asdict(state.available())
                        or sorted(st.running_apps) != sorted(state.holders)):
                    return False
            return True
        _cp_wait(synced, f"the allocator's chip status in the store ({what})")


def _cp_worker(url, key):
    """The daemon's worker ``key`` once its segment exists (its path is
    the last variable of its env the daemon sets), else None."""
    import os

    for w in _api(url, "/api/v1/workers"):
        shm = w["status"]["env"].get("TPF_SHM_PATH", "")
        if f"{w['spec']['namespace']}/{w['spec']['name']}" == key and os.path.exists(shm):
            return w
    return None


def _cp_gone(url, key, shm_path):
    """The daemon lists no worker ``key`` and its segment is unlinked."""
    import os

    return not os.path.exists(shm_path) and not any(
        f"{w['spec']['namespace']}/{w['spec']['name']}" == key
        for w in _api(url, "/api/v1/workers"))


def _cp_tenant(env, out, view, during=None):
    """The unmodified 32-layer tenant under a worker's env for CP_WINDOW_S
    after its first call, ``during()`` run once that call is done (it
    costs no device time); the tenant's records, the segment once it
    stopped, and what ``during`` returned."""
    import os

    proc = subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--tenant-raw",
                             str(out)], env={**os.environ, **env}, cwd=str(REPO),
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        _cp_wait(lambda: any("t1" in l for l in _tenant_lines(out)), "the tenant's first call",
                 timeout=NODE_START_TIMEOUT_S, procs=[("the tenant", proc)])
        t_first = time.monotonic()
        extra = during() if during is not None else None
        time.sleep(max(0.0, CP_WINDOW_S - (time.monotonic() - t_first)))
        (out / "stop").touch()
        _cp_wait(lambda: any("stopped" in l for l in _tenant_lines(out)), "the tenant's stop",
                 timeout=NODE_STOP_TIMEOUT_S, procs=[("the tenant", proc)])
        seg = _read_segment(view)
    except RuntimeError as e:
        raise RuntimeError(f"{e}:\n{_tail(out / 'tenant.log')}") from None
    finally:
        proc.kill()
        proc.wait()
    lines = _tenant_lines(out)
    return ([l for l in lines if "t1" in l], next(l for l in lines if "stopped" in l),
            next(l["check"] for l in lines if "check" in l), seg, proc.pid, extra)


def _cp_user_ann(c, duty, hbm, qos, **extra):
    """A user's request: the generation, a duty share, HBM, soft isolation
    and a QoS; nothing the webhook or the scheduler writes."""
    return {c.ANN_CHIP_GENERATION: CP_GENERATION, c.ANN_DUTY_REQUEST: str(duty),
            c.ANN_HBM_REQUEST: str(int(hbm)), c.ANN_ISOLATION: c.ISOLATION_SOFT,
            c.ANN_QOS: qos, **extra}


def _cp_refusals(pf, url, chip_name):
    """While the tenant runs: a pod asking for more HBM than the card has
    left, and a namespace quota that admits one 25% pod and refuses the
    second.  Both refused pods stay unbound, reach no worker and leave the
    chip's published availability as it was."""
    c, t = pf.c, pf.types
    row, checks = {}, {}
    left = pf.alloc.get_chip(chip_name).available().hbm_bytes
    before = dataclasses.asdict(pf.rs.get(t.TPUChip, chip_name).status.available)
    big = pf.submit("over-hbm", _cp_user_ann(c, 10, left + (1 << 30), c.QOS_LOW))
    reason = _cp_wait(lambda: pf.reasons.get(big), "the over-HBM pod's refusal")
    time.sleep(1.0)         # the agent would have had the time to act on a bind
    row["hbm"] = {"asked": left + (1 << 30), "left": left, "reason": reason}
    checks["refused_hbm"] = ("HBM" in reason and big not in pf.bound
                             and not pf.chip_ids(big) and _cp_worker(url, big) is None)
    pf.delete(big)

    quota = t.TPUResourceQuota.new("quota", namespace="team-q")
    quota.spec.total.requests.tflops = CP_QUOTA_TFLOPS
    pf.alloc.quota.set_quota(pf.rs.create(quota))
    first = pf.submit("q1", _cp_user_ann(c, 25, 1 << 30, c.QOS_LOW), ns="team-q")
    _cp_wait(lambda: first in pf.bound, "the quota namespace's first pod bound")
    w1 = _cp_wait(lambda: _cp_worker(url, first), "the quota namespace's first worker")
    pf.sync("q1 bound")
    with_q1 = dataclasses.asdict(pf.rs.get(t.TPUChip, chip_name).status.available)
    second = pf.submit("q2", _cp_user_ann(c, 25, 1 << 30, c.QOS_LOW), ns="team-q")
    reason = _cp_wait(lambda: pf.reasons.get(second), "the over-quota pod's refusal")
    pf.sync("q2 refused")
    after = dataclasses.asdict(pf.rs.get(t.TPUChip, chip_name).status.available)
    row["quota"] = {"tflops": CP_QUOTA_TFLOPS, "reason": reason,
                    "available_with_q1": with_q1, "available_after_refusal": after}
    checks["refused_quota"] = ("quota" in reason and second not in pf.bound
                               and not pf.chip_ids(second) and after == with_q1
                               and with_q1 != before and _cp_worker(url, second) is None)
    for key in (first, second):
        pf.delete(key)
    _cp_wait(lambda: _cp_gone(url, first, w1["status"]["env"]["TPF_SHM_PATH"]),
             "the quota pod's worker removed")
    pf.alloc.quota.remove_quota("team-q")
    pf.rs.delete(t.TPUResourceQuota, "quota", "team-q")
    pf.sync("quota pods deleted")
    checks["refusals_left_no_trace"] = (
        dataclasses.asdict(pf.rs.get(t.TPUChip, chip_name).status.available) == before)
    return row, checks


def _cp_gangs(pf, url):
    """A gang of two 25% pods (min-members 2) binds whole and gets two
    workers; a gang of three (min-members 3, a 2 s timeout) whose third
    member cannot fit binds none, and the holds its members took in
    Permit are rolled back."""
    c = pf.c
    row, checks = {}, {}
    before = pf.available()
    ann = dict(_cp_user_ann(c, 25, 1 << 30, c.QOS_LOW), **{
        c.ANN_WORKLOAD: "gang-ok", c.ANN_GANG_ENABLED: "true", c.ANN_GANG_MIN_MEMBERS: "2",
        c.ANN_GANG_TIMEOUT: str(CP_GANG_TIMEOUT_S)})
    t0 = time.monotonic()
    keys = [pf.submit(f"gang-ok-{i}", ann) for i in range(2)]
    _cp_wait(lambda: all(k in pf.bound for k in keys), "the gang bound")
    row["gang_bind_ms"] = (max(pf.bound[k] for k in keys) - t0) * 1e3
    workers = [_cp_wait(lambda k=k: _cp_worker(url, k), f"{k}'s worker") for k in keys]
    row["gang_workers_ms"] = (time.monotonic() - t0) * 1e3
    checks["gang_bound_whole"] = len(workers) == 2 and bool(_cp_wait(lambda: all(
        pf.alloc.allocation(k) is not None and not pf.alloc.allocation(k).assumed
        for k in keys), "the gang's allocations committed", timeout=10))
    for k in keys:
        pf.delete(k)
    for k, w in zip(keys, workers):
        _cp_wait(lambda k=k, w=w: _cp_gone(url, k, w["status"]["env"]["TPF_SHM_PATH"]),
                 f"{k}'s worker removed")

    ann = dict(_cp_user_ann(c, 25, 1 << 30, c.QOS_LOW), **{
        c.ANN_WORKLOAD: "gang-short", c.ANN_GANG_ENABLED: "true",
        c.ANN_GANG_MIN_MEMBERS: "3", c.ANN_GANG_TIMEOUT: str(CP_GANG_TIMEOUT_S)})
    too_big = dict(ann, **{c.ANN_HBM_REQUEST: str(int(
        pf.alloc.chips()[0].available().hbm_bytes) + (1 << 30))})
    t0 = time.monotonic()
    keys = [pf.submit("gang-short-0", ann), pf.submit("gang-short-1", ann),
            pf.submit("gang-short-2", too_big)]
    small = set(keys[:2])

    def rolled_back():
        rejected = {k for k, _ in pf.permit_rejects} & small
        return (rejected == small and keys[2] in pf.reasons
                and all(pf.alloc.allocation(k) is None for k in keys)
                and not pf.sched.waiting_pods())
    _cp_wait(rolled_back, "the short gang's holds rolled back",
             timeout=CP_GANG_TIMEOUT_S + 10)
    row["gang_refused_rollback_ms"] = (time.monotonic() - t0) * 1e3
    row["gang_refused_rejects"] = sorted(r for k, r in pf.permit_rejects if k in small)
    time.sleep(0.5)
    checks["gang_refused_none_bound"] = (not any(k in pf.bound for k in keys)
                                         and pf.available() == before
                                         and all(_cp_worker(url, k) is None for k in keys))
    for k in keys:
        pf.delete(k)
    pf.sync("gangs deleted")
    return row, checks


def _cp_preempt(pf, url, chip_name):
    """A QoS-low pod takes all the HBM the card has left; a QoS-critical
    pod that does not fit beside it evicts it; the agent removes the low
    pod's worker and segment, and the critical pod's worker appears."""
    c = pf.c
    row = {}
    left = pf.alloc.get_chip(chip_name).available().hbm_bytes
    low = pf.submit("filler", _cp_user_ann(c, 25, left, c.QOS_LOW))
    w_low = _cp_wait(lambda: _cp_worker(url, low), "the low pod's worker")
    pf.sync("the low pod bound")
    crit = pf.submit("critical", _cp_user_ann(c, 25, 20 << 30, c.QOS_CRITICAL))
    _cp_wait(lambda: low in pf.evicted, "the low pod's eviction")
    t_evict = pf.evicted[low]
    # the operator requeues on the victim's deletion.  The eviction runs
    # inside the critical pod's cycle, which parks the pod only after it;
    # an activate() before that finds nothing to requeue and the pod stays
    # parked.  Its reason is recorded once it is parked.
    _cp_wait(lambda: "after preemption" in pf.reasons.get(crit, ""),
             "the critical pod parked after its preemption")
    pf.sched.activate()
    shm_low = w_low["status"]["env"]["TPF_SHM_PATH"]
    _cp_wait(lambda: _cp_gone(url, low, shm_low), "the low pod's worker and segment removed")
    row["evict_to_segment_ms"] = (time.monotonic() - t_evict) * 1e3
    w_crit = _cp_wait(lambda: _cp_worker(url, crit), "the critical pod's worker")
    row["evict_to_critical_worker_ms"] = (time.monotonic() - t_evict) * 1e3
    pf.sync("the critical pod bound")
    row["victims"] = sorted(pf.evicted)
    check = (sorted(pf.evicted) == [low] and pf.chip_ids(crit) == chip_name
             and _cp_worker(url, low) is None and w_crit is not None
             and pf.rs.try_get(pf.types.Pod, "filler", "default") is None)
    return crit, w_crit, row, check


def _cp_scale():
    """The scheduler layer alone, on the host, with no store: 64 nodes of
    8 h100-sxm cards, each node an NVLink clique, and 512 pods of 1-8
    cards at 10-100% duty and mixed QoS, each admitted by the webhook and
    given one scheduling cycle (preemption included)."""
    from tensorfusion_tpu_torch import constants as c
    from tensorfusion_tpu_torch.allocator import IndexAllocator, PortAllocator, TPUAllocator
    from tensorfusion_tpu_torch.api import types as t
    from tensorfusion_tpu_torch.api.resources import ResourceAmount
    from tensorfusion_tpu_torch.config.chip_info import CHIP_INFO_DB, mock_chip_info
    from tensorfusion_tpu_torch.scheduler import (GangManager, ICITopologyPlugin, Scheduler,
                                                  TPUResourcesFit)
    from tensorfusion_tpu_torch.store import ObjectStore
    from tensorfusion_tpu_torch.webhook import PodMutator, WorkloadParser

    n_nodes, per_node, n_pods = CP_SCALE
    model = CHIP_INFO_DB[CP_GENERATION]
    alloc = TPUAllocator()
    nodes = [f"scale-{n:02d}" for n in range(n_nodes)]
    for node in nodes:
        names = [f"{node}-gpu{i}" for i in range(per_node)]
        for i, name in enumerate(names):
            chip = t.TPUChip.new(name)
            st = chip.status
            st.phase, st.used_by = c.PHASE_RUNNING, c.CHIP_USED_BY_TPU_FUSION
            st.capacity = ResourceAmount(tflops=model.bf16_tflops, duty_percent=100.0,
                                         hbm_bytes=float(model.hbm_bytes))
            st.available = st.capacity
            st.generation, st.vendor, st.node_name = CP_GENERATION, c.VENDOR_NVIDIA, node
            st.pool, st.host_index, st.mesh = CP_POOL, i, t.MeshCoords(x=i)
            st.capabilities = {"soft_isolation": True}
            st.ici_links = [t.ICILink(peer_chip_id=o, peer_index=j, kind="ici", hops=1,
                                      gbps=model.ici_gbps)
                            for j, o in enumerate(names) if o != name]
            alloc.upsert_chip(chip)
    store = ObjectStore()
    mutator = PodMutator(store, WorkloadParser(store, chip_models=mock_chip_info(),
                                               default_pool=CP_POOL))
    pods, bound, evicted = {}, {}, []

    def evict(pod):
        evicted.append(pod.key())
        alloc.dealloc(pod.key())
        bound.pop(pod.key(), None)
        pods[pod.key()].spec.node_name = ""

    sched = Scheduler(nodes_fn=lambda: nodes, bind_fn=lambda p, n: bound.update({p.key(): n}))
    gang = GangManager()
    gang.bind_scheduler(sched)
    sched.register(TPUResourcesFit(
        alloc, gang=gang, ports=PortAllocator(), indices=IndexAllocator(), evict=evict,
        pods_on_node=lambda node: [p for p in pods.values() if p.spec.node_name == node]))
    sched.register(ICITopologyPlugin())
    rng = random.Random(CP_SCALE_SEED)
    cycles, t0 = [], time.perf_counter()
    for i in range(n_pods):
        pod = t.Pod.new(f"s{i}", namespace="scale")
        pod.metadata.annotations.update(_cp_user_ann(
            c, rng.randint(10, 100), rng.randint(1, 40) << 30, rng.choice(c.QOS_LEVELS),
            **{c.ANN_CHIP_COUNT: str(rng.randint(1, per_node))}))
        pod.spec.containers = [t.Container(name="main")]
        pod = mutator.handle(pod)
        pods[pod.key()] = pod
        t1 = time.perf_counter()
        if sched.schedule_one(pod).ok:
            pod.spec.node_name = bound[pod.key()]
        cycles.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    q = _quantiles_ms(cycles)
    multi = [k for k in bound if int(pods[k].metadata.annotations[c.ANN_CHIP_COUNT]) > 1]
    same_node = all(len({alloc.get_chip(x).chip.status.node_name
                         for x in alloc.allocation(k).chip_ids}) == 1 for k in multi)
    return {"nodes": n_nodes, "cards_per_node": per_node, "pods": n_pods,
            "bound": len(bound), "preempted": len(evicted), "multi_card_bound": len(multi),
            "pods_per_s": n_pods / sum(cycles), "cycle_ms_p50": q["p50"],
            "cycle_ms_p99": q["p99"], "seconds": wall, "multi_card_on_one_node": same_node}


def phase_control_plane(torch, hardware, hv_build, limiter_lib, name, smi):
    """The control plane on the card: the port's state store, the daemon
    joined to it with ``--operator-url`` over the NVML provider, the card
    published as a TPUChip; then the platform's own path, composed here:
    a pod with user annotations only (h100-sxm, duty 25, HBM, soft, QoS
    low) admitted by the webhook (247.25 TFLOPs), scheduled and bound to
    the node by the scheduler over an allocator fed the store's TPUChip,
    and turned by the agent into a worker whose segment holds 2500 bp; the
    unmodified Llama-3-8B tenant under that worker's env (the launch hook
    preloaded) while an over-HBM pod and an over-quota pod are refused;
    gangs bound whole or not at all; a preemption from a low pod's worker
    to a critical pod's; the daemon's metrics lines in the store; a
    restart of the store from its journal, a pod admitted and scheduled
    after it, and a fresh allocator rebuilt from the store equal to the
    live one; every pod deleted; and the scheduler at inventory scale on
    the host.  Returns the tenant's kernel launches."""
    import threading as _threading

    from tensorfusion_tpu_torch import constants
    from tensorfusion_tpu_torch.allocator import TPUAllocator
    from tensorfusion_tpu_torch.api import types as api_types
    from tensorfusion_tpu_torch.hypervisor import ShmView, list_worker_segments
    from tensorfusion_tpu_torch.remote_store import RemoteStore

    c = constants
    t_phase = time.perf_counter()
    work = WORK / "control_plane"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    peak = hardware.peak_rates(name)["bf16"]
    checks, row = {}, {}
    store_proc, port = _start_statestore(work)
    store_url = f"http://127.0.0.1:{port}"
    rs = RemoteStore(store_url, token=CP_TOKEN, timeout_s=30)
    daemon = pf = None
    try:
        _cp_wait(rs.ping, "the state store's healthz", procs=[("the state store", store_proc)])
        t0 = time.monotonic()
        daemon, url = _start_daemon(hv_build.provider_path(), limiter_lib, work, extra=(
            "--operator-url", store_url, "--node-name", CP_NODE, "--pool", CP_POOL,
            "--store-token", CP_TOKEN, "--metrics-interval-s", "1"))
        procs = [("the daemon", daemon), ("the state store", store_proc)]
        chips = _cp_wait(lambda: rs.list(api_types.TPUChip), "the card's TPUChip", procs=procs)
        row["chip_published_s"] = time.monotonic() - t0
        chip, dev = chips[0], _api(url, "/api/v1/devices")[0]["info"]
        chip_name, st = chip.metadata.name, chip.status
        node = rs.get(api_types.Node, CP_NODE)
        tnode = rs.get(api_types.TPUNode, CP_NODE)
        total = torch.cuda.get_device_properties(0).total_memory
        row["chip"] = {"name": chip_name, "generation": st.generation,
                       "vendor": st.vendor, "used_by": st.used_by, "phase": st.phase,
                       "pool": st.pool, "tflops": st.capacity.tflops,
                       "duty_percent": st.capacity.duty_percent,
                       "hbm_bytes": st.capacity.hbm_bytes, "torch_total_memory": total,
                       "mesh": [st.mesh.x, st.mesh.y, st.mesh.z],
                       "links": [[l.peer_index, l.kind, l.gbps] for l in st.ici_links]}
        row["node"] = {"phase": node.status.phase, "pool": tnode.spec.pool,
                       "tpunode_phase": tnode.status.phase,
                       "hypervisor_url": tnode.status.hypervisor_url}
        checks["inventory"] = (
            len(chips) == 1 and chip_name == dev["chip_id"]
            and (st.generation, st.vendor, st.used_by, st.phase, st.pool) == (
                CP_GENERATION, c.VENDOR_NVIDIA, c.CHIP_USED_BY_TPU_FUSION,
                c.PHASE_RUNNING, CP_POOL)
            and (st.capacity.tflops, st.capacity.duty_percent) == (peak / 1e12, 100.0)
            and st.capacity.hbm_bytes == dev["hbm_bytes"] and abs(dev["hbm_bytes"] / total - 1)
            < 0.05 and [st.mesh.x, st.mesh.y, st.mesh.z] == list(dev["mesh"])
            and node.status.phase == c.PHASE_RUNNING and tnode.spec.pool == CP_POOL
            and tnode.status.hypervisor_url == url and tnode.status.hypervisor_ready)

        pf = _Platform(rs, chips, lambda: [n.metadata.name for n in rs.list(api_types.Node)
                                           if n.status.phase == c.PHASE_RUNNING])
        rtt = []
        for _ in range(10):
            t1 = time.perf_counter()
            rs.get(api_types.TPUChip, chip_name)
            rtt.append(time.perf_counter() - t1)
        row["store_get_ms"] = _quantiles_ms(rtt)
        pf.sched.start()
        tenant = pf.submit("tenant", _cp_user_ann(c, CP_DUTY, NODE_HBM_BYTES, c.QOS_LOW))
        _cp_wait(lambda: tenant in pf.bound or pf.reasons.get(tenant), "the tenant pod bound",
                 procs=procs)
        if tenant not in pf.bound:
            raise RuntimeError(f"the tenant pod was not scheduled: {pf.reasons[tenant]}")
        worker = _cp_wait(lambda: _cp_worker(url, tenant), "the pod's worker", procs=procs)
        row["pod_to_segment_ms"] = (time.monotonic() - pf.bound[tenant]) * 1e3
        stored = rs.get(api_types.Pod, "tenant", "default")
        ann = stored.metadata.annotations
        row["admitted"] = {k.split("/")[-1]: ann.get(k) for k in (
            c.ANN_TFLOPS_REQUEST, c.ANN_DUTY_REQUEST, c.ANN_HBM_REQUEST, c.ANN_QOS,
            c.ANN_ISOLATION, c.ANN_CHIP_IDS, c.ANN_POOL, c.ANN_WORKLOAD)}
        row["admitted"]["priority"] = stored.spec.priority
        row["admitted"]["node"] = stored.spec.node_name
        checks["admitted_and_bound"] = (
            ann[c.ANN_TFLOPS_REQUEST] == CP_TFLOPS and ann[c.ANN_CHIP_IDS] == chip_name
            and stored.spec.node_name == CP_NODE and stored.status.phase == c.PHASE_RUNNING
            and stored.spec.scheduler_name == c.SCHEDULER_NAME)
        pf.sync("the tenant bound")
        env = worker["status"]["env"]
        view = ShmView(env["TPF_SHM_PATH"])
        try:
            quota = view.read().devices[0]
            row["segment"] = {"chip_id": quota.chip_id, "duty_limit_bp": quota.duty_limit_bp,
                              "hbm_limit_bytes": quota.hbm_limit_bytes}
            checks["contract"] = (quota.chip_id, quota.duty_limit_bp, quota.hbm_limit_bytes) \
                == (chip_name, 2500, NODE_HBM_BYTES)
            calls, stopped, check, seg, pid, (refusals, refusal_checks) = _cp_tenant(
                env, work / "tenant", view, lambda: _cp_refusals(pf, url, chip_name))
        finally:
            view.close()
        row["refusals"] = refusals
        checks.update(refusal_checks)
        wall = calls[-1]["t1"] - calls[0]["t1"]
        device_s = (calls[-1]["hook"]["device_us"] - calls[0]["hook"]["device_us"]) / 1e6
        flash = [l["flash"] for l in calls]
        row["tenant"] = {
            "calls": len(calls), "shape": list(NODE_SHAPE), "n_layers": check["config"]["n_layers"],
            "tokens_per_s": (len(calls) - 1) * NODE_SHAPE[0] * NODE_SHAPE[1] / wall,
            "device_share": device_s / wall, "contract_share": float(CP_TFLOPS) * 1e12 / peak,
            "call_ms_median": sorted((l["t1"] - l["t0"]) * 1e3 for l in calls)[len(calls) // 2],
            "hook": stopped["hook"], "segment": {k: seg[k] for k in (
                "launches", "charged", "blocked", "hbm_used", "pids", "refill", "capacity")}}
        checks["tenant_unmodified"] = check["client_runtime_imported"] is False
        checks["segment_is_the_hook"] = (
            seg["launches"] == stopped["hook"]["charges"]
            and seg["charged"] == stopped["hook"]["charged_mflops"] > 0 and pid in seg["pids"])
        checks["flash_every_call"] = all(
            b - a == check["config"]["n_layers"] for a, b in zip([0] + flash, flash))

        _, lines, _, _ = rs.drain_metrics()
        row["metrics_lines"] = len(lines)
        checks["metrics"] = any(CP_NODE in l for l in lines)

        gang_row, gang_checks = _cp_gangs(pf, url)
        row.update(gang_row)
        checks.update(gang_checks)

        # the tenant's work is done: its pod goes, and the card is free for
        # the preemption
        pf.delete(tenant)
        _cp_wait(lambda: _cp_gone(url, tenant, env["TPF_SHM_PATH"]),
                 "the tenant's worker removed", procs=procs)
        crit, w_crit, pre_row, checks["preemption"] = _cp_preempt(pf, url, chip_name)
        row.update(pre_row)
        checks["critical_contract"] = (
            w_crit["spec"]["devices"][0]["duty_percent"] == 25.0
            and w_crit["spec"]["qos"] == c.QOS_CRITICAL)

        t_kill = time.monotonic()
        store_proc.kill()
        store_proc.wait()
        store_proc, _ = _start_statestore(work, port)
        procs = [("the daemon", daemon), ("the state store", store_proc)]
        _cp_wait(rs.ping, "the restarted state store", procs=procs)
        row["store_restart_s"] = time.monotonic() - t_kill
        survived = {kind.KIND: rs.try_get(kind, key, ns) is not None for kind, key, ns in (
            (api_types.Node, CP_NODE, ""), (api_types.TPUNode, CP_NODE, ""),
            (api_types.TPUChip, chip_name, ""), (api_types.Pod, "critical", "default"))}
        second = pf.submit("second", _cp_user_ann(c, 10, 1 << 30, c.QOS_LOW))
        _cp_wait(lambda: _cp_worker(url, second), "the second pod's worker", procs=procs)
        row["restart_recover_s"] = time.monotonic() - t_kill
        row["survived_restart"] = survived
        checks["restart"] = all(survived.values())
        pf.sync("after the restart")
        rebuilt = TPUAllocator()
        for ch in rs.list(api_types.TPUChip):
            rebuilt.upsert_chip(ch)
        restored = rebuilt.reconcile([p for p in rs.list(api_types.Pod) if p.spec.node_name])
        rebuilt_avail = {s.chip.name: dataclasses.asdict(s.available()) for s in rebuilt.chips()}
        row["rebuilt_allocator"] = {"pods": restored, "available": rebuilt_avail[chip_name]}
        live = pf.available()
        checks["rebuilt_allocator"] = (
            restored == 2 and rebuilt_avail.keys() == live.keys()
            and all(math.isclose(rebuilt_avail[k][f], live[k][f], abs_tol=1e-6)
                    for k in live for f in live[k])
            and sorted(rebuilt.get_chip(chip_name).holders) == sorted([crit, second]))

        submit_ms = sorted((pf.bound[k] - pf.submitted[k]) * 1e3 for k in pf.bound)
        row["submit_to_bound_ms"] = {"p50": submit_ms[len(submit_ms) // 2],
                                     "max": submit_ms[-1], "pods": len(submit_ms)}
        row["bind_conflicts"] = pf.bind_conflicts
        for key in (crit, second):
            pf.delete(key)
        _cp_wait(lambda: not _api(url, "/api/v1/workers"), "the workers' removal", procs=procs)
        pf.sync("every pod deleted")
        left = list_worker_segments(str(work / "shm"))
        end = rs.get(api_types.TPUChip, chip_name).status
        checks["reclaimed"] = (not left and end.phase == c.PHASE_RUNNING
                               and end.available == end.capacity and not end.running_apps
                               and end.generation == CP_GENERATION
                               and end.capacity.tflops == peak / 1e12)
    except RuntimeError as e:
        raise RuntimeError(f"{e}\nthe daemon's log:\n{_tail(work / 'daemon.log')}\n"
                           f"the state store's log:\n{_tail(work / 'statestore.log')}") from None
    finally:
        if pf is not None:
            pf.sched.stop()
        rs.close()
        if daemon is not None:
            _stop(daemon)
        _stop(store_proc)
    checks["stopped"] = (daemon.poll() is not None and store_proc.poll() is not None
                         and not any(t.name in ("tpf-sched", "tpf-sched-permit")
                                     for t in _threading.enumerate()))
    row["scale"] = _cp_scale()
    checks["scale"] = (row["scale"]["seconds"] < 30 and row["scale"]["bound"] > 0
                       and row["scale"]["multi_card_on_one_node"])
    emit("control_plane", **row, checks=checks, nvidia_smi=smi,
         seconds=time.perf_counter() - t_phase)
    if not all(checks.values()):
        raise RuntimeError(f"control_plane phase checks failed: {checks}")
    return {"flash_attn_fwd": stopped["flash"], "flash_attn_bwd_dq": 0,
            "flash_attn_bwd_dkv": 0}


def _memory(torch, phase, t0):
    """The card memory this process holds as ``phase`` starts: what the
    earlier phases left allocated, then what is left once reference cycles
    (an engine and its runner, a worker and its dispatcher) are collected
    and the cache is emptied; and the smoke's seconds since ``t0``."""
    held = torch.cuda.memory_allocated() / 1e9
    reserved = torch.cuda.memory_reserved() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    emit("memory", before=phase, allocated_gb=held, reserved_gb=reserved,
         allocated_gb_after_gc=torch.cuda.memory_allocated() / 1e9,
         reserved_gb_after_gc=torch.cuda.memory_reserved() / 1e9,
         elapsed_s=time.perf_counter() - t0)


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
    children = {"--tenant": tenant_main, "--tenant-raw": tenant_raw_main,
                "--probe": probe_main, "--overhead": overhead_main,
                "--mesh-tenant": mesh_tenant_main}
    if sys.argv[1:2] and sys.argv[1] in children:
        return children[sys.argv[1]](Path(sys.argv[2]))
    from tensorfusion_tpu_torch import (bench_train, hardware, ops, parallel, remoting,
                                        serving)
    from tensorfusion_tpu_torch.hypervisor import _build as hv_build
    from tensorfusion_tpu_torch.client.runtime import estimate_flops
    from tensorfusion_tpu_torch.models import llama
    from tensorfusion_tpu_torch.ops import _build as build

    # the module; the package re-exports a function of the same name
    fa = sys.modules["tensorfusion_tpu_torch.ops.flash_attention"]
    t0 = time.perf_counter()
    name, smi = phase_device(torch, build, hardware)
    rates = hardware.peak_rates(name)
    limiter_lib = phase_build(torch, build, fa, hv_build)
    if sys.argv[1:2] == ["--control-plane"]:
        for i in range(int(sys.argv[2])):
            _memory(torch, f"control_plane {i + 1}", t0)
            phase_control_plane(torch, hardware, hv_build, limiter_lib, name, smi)
        _memory(torch, "end", t0)
        return 0
    rows = {"flash_attn_fwd": phase_kernels(torch, fa, rates)}
    rows.update(phase_bwd_kernels(torch, fa, rates))
    torch.cuda.empty_cache()
    # while this process holds almost nothing: the tenants share the card
    _memory(torch, "node", t0)
    node_launches = phase_node(torch, hardware, hv_build, limiter_lib, name, smi)
    _memory(torch, "intercept", t0)
    intercept_launches = phase_intercept(torch, fa, hardware, hv_build, limiter_lib, name, smi)
    _memory(torch, "shard", t0)
    shard_launches = phase_shard(torch, llama, remoting, hardware, hv_build, limiter_lib,
                                 name, smi)
    _memory(torch, "control_plane", t0)
    cp_launches = phase_control_plane(torch, hardware, hv_build, limiter_lib, name, smi)

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), attn_impl="flash")
    _memory(torch, "serve", t0)
    params, serve_launches = phase_serve(torch, ops, llama, bench_train,
                                         limiter_lib, cfg)
    ref = phase_serve_check(torch, llama, params, cfg)
    _memory(torch, "engine", t0)
    engine_launches, engine_outs = phase_engine(torch, ops, llama, serving,
                                                bench_train, limiter_lib, params,
                                                cfg, rates, smi)
    phase_engine_check(torch, llama, serving, params, cfg, ref)
    _memory(torch, "remote_serve", t0)
    remote_serve_launches = phase_remote_serve(torch, ops, remoting, serving,
                                               bench_train, limiter_lib, params,
                                               cfg, smi, engine_outs)
    del params, ref
    _memory(torch, "remote_serve_check", t0)
    phase_remote_serve_check(torch, llama, remoting, serving, cfg)

    cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    _memory(torch, "train", t0)
    params, train_launches = phase_train(torch, ops, llama, bench_train,
                                         limiter_lib, cfg, rates)
    phase_train_check(torch, llama, params, cfg)
    del params
    _memory(torch, "mesh", t0)
    mesh_launches = phase_mesh(torch, ops, llama, parallel, cfg, smi)
    _memory(torch, "remote", t0)
    remote_launches = phase_remote(torch, ops, llama, remoting, estimate_flops,
                                   bench_train, limiter_lib, cfg, smi)
    _memory(torch, "federation", t0)
    params = llama.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(13),
                               device=DEVICE)
    host = torch.utils._pytree.tree_map(lambda t: t.cpu(), params)
    fed_launches = phase_federation(torch, ops, llama, remoting, bench_train,
                                    limiter_lib, cfg, params, host, smi)
    _memory(torch, "migrate", t0)
    mig_launches = phase_migrate(torch, ops, llama, remoting, serving, bench_train,
                                 limiter_lib, cfg, params, host, smi)
    del params, host
    _memory(torch, "bench_train", t0)
    phase_bench_train(bench_train, limiter_lib)

    kernels = [{"name": k.name, "route": k.route, "source": k.source,
                "replaces": k.replaces,
                "launches": serve_launches[k.name] + train_launches[k.name]
                + engine_launches[k.name] + remote_launches[k.name]
                + remote_serve_launches[k.name] + fed_launches[k.name]
                + mig_launches[k.name] + mesh_launches[k.name]
                + node_launches[k.name] + intercept_launches[k.name]
                + shard_launches[k.name] + cp_launches[k.name],
                "launches_by_path": {"serve": serve_launches[k.name],
                                     "train": train_launches[k.name],
                                     "engine": engine_launches[k.name],
                                     "remote": remote_launches[k.name],
                                     "remote_serve": remote_serve_launches[k.name],
                                     "federation": fed_launches[k.name],
                                     "migrate": mig_launches[k.name],
                                     "mesh": mesh_launches[k.name],
                                     "node": node_launches[k.name],
                                     "intercept": intercept_launches[k.name],
                                     "shard": shard_launches[k.name],
                                     "control_plane": cp_launches[k.name]},
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
