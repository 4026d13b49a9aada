"""Where the time of serving goes in the port, on the card.

    python -m tensorfusion_tpu_torch.profile_serve --batch 4 --prompt 1024
    python -m tensorfusion_tpu_torch.profile_serve --paged --batch 8 --prompt 1024

Builds Llama-3-8B random weights (full width and depth, flash attention).
By default it runs one request through ``generate`` to warm up, then
traces the prefill and eight decode steps of the contiguous cache.  With
``--paged`` it prefills ``batch`` sequences into a ``serving.LlamaRunner``
pool (16-token blocks, 256-token chunks), traces the first sequence's
last prefill chunk again (eager, as the engine runs it), and one decode
step of the whole batch twice: run eagerly through
``kvpool.paged_decode_step``, and replayed from the runner's CUDA graph
(``LlamaRunner.decode``, host copies in and out included).  Prints one JSON line per phase: wall time,
device busy time (the sum of CUDA kernel time), the device's idle share,
kernel launches, the kernels that took the most time, and the device
time grouped by kind (``GROUPS``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .models import llama

STEPS = 8     # decode steps traced
TOP = 8       # kernels listed per phase
BLOCK, CHUNK = 16, 256    # --paged: pool block size, prefill chunk

#: device-time groups, by a substring of the kernel's name: the attention
#: kernels of this package (every kernel of ``ops/csrc/``, whatever its
#: head-dim path), the matrix products, the paged pool's gathers and
#: scatters, and (matching none of these) "other"; the first match wins
GROUPS = (
    ("flash_fwd", "flash_fwd_"),
    ("flash_bwd_dq", "dq_"),
    ("flash_bwd_dkv", "dkv_"),
    ("matmul", "gemm"),
    ("matmul", "nvjet"),
    ("matmul", "cutlass"),
    ("kv_index", "index"),
    ("kv_index", "gather"),
)


def _group(name: str) -> str:
    return next((group for group, key in GROUPS if key in name), "other")


def _trace(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    groups: dict = {}
    for e in kernels:
        g = groups.setdefault(_group(e.key), {"ms": 0.0, "launches": 0})
        g["ms"] += e.self_device_time_total / 1e3
        g["launches"] += e.count
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "idle_share": max(0.0, 1 - busy_us / 1e6 / wall),
            "kernel_launches": sum(e.count for e in kernels), "groups": groups,
            "top": [{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3,
                     "count": e.count} for e in kernels[:TOP]]}


def _contiguous(args, cfg, params, prompt, shape):
    llama.generate(params, prompt, 2, cfg)                  # warm-up
    cache_len = args.prompt + STEPS + 1
    state = {}

    def prefill():
        state["logits"], state["cache"] = llama.prefill(params, prompt, cfg, cache_len)

    def decode():
        tok = torch.argmax(state["logits"], dim=-1)
        for i in range(STEPS):
            logits, _ = llama.decode_step(params, tok, state["cache"],
                                          args.prompt + i, cfg)
            tok = torch.argmax(logits, dim=-1)

    print(json.dumps({"phase": "prefill", **shape, **_trace(prefill)}))
    row = _trace(decode)
    row["ms_per_step"] = row["wall_ms"] / STEPS
    print(json.dumps({"phase": "decode", "steps": STEPS, **shape, **row}))


def _paged(args, cfg, params, prompt, shape):
    from .serving import LlamaRunner, kvpool

    per_seq = -(-(args.prompt + 1) // BLOCK)
    runner = LlamaRunner(params, cfg, num_blocks=1 + args.batch * per_seq,
                         block_size=BLOCK)
    tables = [list(range(1 + i * per_seq, 1 + (i + 1) * per_seq))
              for i in range(args.batch)]
    toks = []
    for row, table in zip(prompt.tolist(), tables):
        for lo in range(0, args.prompt, CHUNK):
            nxt = runner.prefill(row[lo:lo + CHUNK], table, lo,
                                 last=lo + CHUNK >= args.prompt)
        toks.append(nxt)
    positions = [args.prompt] * args.batch
    runner.decode(toks, positions, tables)          # captures the bucket's graph
    bp = kvpool.pow2_bucket(args.batch)
    pad = [0] * (bp - args.batch)
    tok, pos = (torch.tensor(x + pad, dtype=torch.int32, device="cuda")
                for x in (toks, positions))
    tab = torch.from_numpy(runner._pad_tables(tables, bp)).cuda()

    def eager():
        logits, _ = kvpool.paged_decode_step(params, tok, runner.cache, tab, pos, cfg)
        torch.argmax(logits, dim=-1)

    eager()                                         # warm-up
    paged = {**shape, "block_size": BLOCK, "bucket": list(tab.shape)}
    last = (args.prompt - 1) // CHUNK * CHUNK       # the first row's last chunk
    row0 = prompt[0].tolist()
    print(json.dumps({"phase": "paged_prefill_chunk", **paged, "start": last,
                      "tokens": args.prompt - last, **_trace(
                          lambda: runner.prefill(row0[last:], tables[0], last))}))
    print(json.dumps({"phase": "paged_decode_eager", **paged, **_trace(eager)}))
    print(json.dumps({"phase": "paged_decode_graph", **paged, **_trace(
        lambda: runner.decode(toks, positions, tables))}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--paged", action="store_true",
                    help="one decode step of the paged runner, eager and graphed")
    args = ap.parse_args()

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(cfg, gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                           generator=gen, device="cuda")
    shape = {"batch": args.batch, "prompt": args.prompt,
             "device": torch.cuda.get_device_name(0)}
    (_paged if args.paged else _contiguous)(args, cfg, params, prompt, shape)


if __name__ == "__main__":
    main()
