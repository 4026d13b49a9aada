"""The metered train-step bench of the port: ``bench.py``'s ``child_main``
restated in torch, on the card.

    python -m tensorfusion_tpu_torch.bench_train

The workload is ``bench.py``'s large configuration (vocab 32000, dim 1024,
8 layers, 8 heads, 8 kv heads, ffn 4096, bf16, flash attention, batch
8 x 512), with random weights and tokens from a fixed seed.  The step is
``bench.py``'s: loss, gradient, and ``p - 1e-4 * g`` on every leaf; steps
are chained, step N's parameters feeding step N+1.  It runs natively and
through ``VTPUClient.meter`` on a fresh limiter worker segment
(``worker_segment``), in 7 interleaved rounds (``bench.py``'s
``_time_chain``, ``_time_interleaved``, ``_median`` and
``_paired_overhead``, synced on ``loss.item()``), and prints one JSON line
with ``bench.py``'s keys: the signed metering overhead with its noise
band, native and metered step ms, the model TFLOP per step (the count the
client charges, from ``estimate_flops`` on fake tensors), the MFLOPs
charged per step, and the MFU of each path on the card's datasheet bf16
peak, beside the card's ``nvidia-smi`` name and power limit.

Left out: ``proxy_launch_overhead_ns`` and ``vtpu_proxy_overhead_pct``
(the PJRT interception proxy has no CUDA counterpart until the NVIDIA
device and node layer of ``ROADMAP.md``) and ``write_artifact``.

``device="cuda"`` is the default; ``run(device="cpu", ...)`` runs the same
code on the CPU (at a small configuration), where no device metric is
reported.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

from . import hardware
from .client import VTPUClient
from .client.runtime import estimate_flops
from .device import DeviceLike, resolve_device
from .hypervisor.limiter_binding import DeviceQuota, Limiter
from .models import llama

REPO = Path(__file__).resolve().parents[1]
LIMITER_LIB = REPO / "native" / "build" / "libtpf_limiter.so"

SHAPE = (8, 512)   # batch x sequence, as bench.py
STEPS = 28         # 7 interleaved rounds of 4, as bench.py
ROUNDS = 7
_K_SMALL = 2


def bench_config() -> llama.LlamaConfig:
    """``bench.py:343-349``'s large configuration."""
    return llama.LlamaConfig(vocab_size=32000, dim=1024, n_layers=8, n_heads=8,
                             n_kv_heads=8, ffn_dim=4096, max_seq_len=1024,
                             dtype=torch.bfloat16, attn_impl="flash")


def make_step(config: llama.LlamaConfig):
    """``bench.py``'s step: (params, batch) -> (new params, loss)."""

    def train_step(params: Dict, batch: Dict):
        loss, grads = llama.value_and_grad(params, batch, config)
        new = (p - 1e-4 * g.to(p.dtype)
               for p, g in zip(llama._leaves(params), grads))
        return llama._unflatten(params, new), loss

    return train_step


def _time_chain(step, params, batch, k) -> float:
    """Wall time of ``k`` chained steps, synced by the loss's fetch to the
    host (independent steps would overlap in the launch queue)."""
    t0 = time.perf_counter()
    loss = None
    for _ in range(k):
        params, loss = step(params, batch)
    loss.item()
    return time.perf_counter() - t0


def _time_interleaved(native, metered, params, batch, steps, rounds):
    """Per-round per-step times of each path by the two-point slope
    (T(k_big) - T(k_small)) / (k_big - k_small), which cancels the
    constant cost of a sync.  Rounds interleave the paths and alternate
    which runs first, so neither is credited with a warm-up trend."""
    k_big = _K_SMALL + max(steps // rounds, 1)
    native(params, batch)[1].item()      # warm-up
    metered(params, batch)[1].item()

    def slope(step):
        t = (_time_chain(step, params, batch, k_big)
             - _time_chain(step, params, batch, _K_SMALL))
        return t / (k_big - _K_SMALL)

    n_times, m_times = [], []
    for r in range(rounds):
        if r % 2 == 0:
            tn = slope(native)
            tm = slope(metered)
        else:
            tm = slope(metered)
            tn = slope(native)
        n_times.append(tn)
        m_times.append(tm)
    return n_times, m_times


def _median(xs):
    s = sorted(xs)
    return s[len(s) // 2]


def _paired_overhead(n_times, m_times):
    """Median and interquartile half-spread of the per-round paired
    overheads (m_i - n_i) / n_i, in percent."""
    per_round = sorted((m - n) / n * 100.0 for n, m in zip(n_times, m_times))
    k = len(per_round)
    return per_round[k // 2], (per_round[(3 * k) // 4] - per_round[k // 4]) / 2.0


def _limiter_lib() -> Path:
    if not LIMITER_LIB.exists():
        subprocess.run(["make", "-C", str(REPO / "native"), "build/libtpf_limiter.so"],
                       check=True, capture_output=True)
    return LIMITER_LIB


@contextlib.contextmanager
def worker_segment(limiter_lib, work_dir, name: str,
                   device: DeviceLike = "cuda") -> Iterator[VTPUClient]:
    """A fresh limiter worker segment ``name`` under ``work_dir``, and a
    ``VTPUClient`` on ``device`` attached to it; yields the client.

    The quota is uncontended: full duty, a token bucket far larger than
    any call's charge, and no device-memory limit (the limiter reads 0 as
    none), so metering costs only its own bookkeeping.  The library keeps
    one worker per process, so the hypervisor face and the client each
    load their own copy of it.  On exit the client detaches, the worker
    is removed and ``work_dir`` is deleted."""
    lib, work = Path(limiter_lib), Path(work_dir)
    shutil.rmtree(work, ignore_errors=True)
    copies = {}
    for face in ("host", "client"):
        (work / face).mkdir(parents=True)
        copies[face] = str(shutil.copy2(lib, work / face / lib.name))
    try:
        host = Limiter(copies["host"])
        host.init(str(work / "shm"))
        host.create_worker("bench", name, [DeviceQuota(
            device_index=0, chip_id="gpu-0", duty_limit_bp=10000,
            hbm_limit_bytes=0, capacity_mflop=10**12,
            refill_mflop_per_s=10**12)])
        try:
            client = VTPUClient(limiter_lib=copies["client"],
                                shm_path=str(work / "shm" / "bench" / name),
                                device=device)
            try:
                if not client.attached:
                    raise RuntimeError("client did not attach to the limiter segment")
                yield client
            finally:
                client.close()
        finally:
            host.remove_worker("bench", name)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(config: Optional[llama.LlamaConfig] = None, batch: int = SHAPE[0],
        seq: int = SHAPE[1], steps: int = STEPS, rounds: int = ROUNDS,
        device: DeviceLike = "cuda", limiter_lib: Optional[str] = None) -> Dict:
    """Time the step natively and metered; returns the result line."""
    dev = resolve_device(device)
    config = config or bench_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.init_params(config, gen, device=dev)
    tokens = torch.randint(0, config.vocab_size, (batch, seq), generator=gen,
                           device=dev)
    data = {"tokens": tokens, "targets": tokens}
    step = make_step(config)
    flops = estimate_flops(step, (params, data), {})

    work = REPO / "build" / "bench_train" / str(os.getpid())
    with worker_segment(limiter_lib or _limiter_lib(), work, "bench_train",
                        dev) as client:
        n_times, m_times = _time_interleaved(step, client.meter(step), params,
                                             data, steps, rounds)

    t_native, t_metered = _median(n_times), _median(m_times)
    overhead_pct, noise_band = _paired_overhead(n_times, m_times)
    result = {
        "metric": "vtpu_soft_isolation_overhead_pct",
        "value": overhead_pct,
        "unit": "%",
        "noise_band_pct": noise_band,
        "device": dev.type,
        "native_step_ms": t_native * 1e3,
        "metered_step_ms": t_metered * 1e3,
        "model_tflops_per_step": flops / 1e12,
        "charged_mflops_per_step": client.charged_mflops // max(client.launches, 1),
        "steps": steps, "rounds": rounds,
        "config": {"dim": config.dim, "n_layers": config.n_layers,
                   "vocab": config.vocab_size, "dtype": str(config.dtype),
                   "attn_impl": config.attn_impl, "batch": batch, "seq": seq},
        # device metrics: only from a run on the card
        "device_kind": None, "nvidia_smi": None, "chip_peak_tflops": None,
        "mfu_native_pct": None, "mfu_metered_pct": None,
    }
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        peak = hardware.peak_rates(name)["bf16"]
        result.update(device_kind=name, nvidia_smi=hardware.nvidia_smi(),
                      chip_peak_tflops=peak / 1e12,
                      mfu_native_pct=flops / t_native / peak * 100.0,
                      mfu_metered_pct=flops / t_metered / peak * 100.0)
    return result


def main() -> None:
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
