"""Where the time of a sharded remote EXECUTE goes in the port, on the card.

    python -m tensorfusion_tpu_torch.profile_shard

Starts a remote worker over 4 ranks sharing the card in this process,
parks random weights of Llama-3-8B's width at 8 layers resident, and runs the last-position forward with the tokens
batch-sharded, one 1024-token sequence a rank: the shape of
``chip_smoke.py``'s shard phase.  After a first call, which replicates the
weights to every rank, it prints one JSON line each:

- ``execute``: the client's EXECUTE round trip over 12 calls,
  beside each rank's time inside its program (the ranks' ``call_s``); the
  rest is the worker's, the task queues' and the wire's;
- ``trace``: one EXECUTE with ``torch.profiler`` on every rank: per rank,
  its time in the program, the device time of its CUDA kernels, the host
  time of its top-level events (an operator on DTensors holds DTensor's
  dispatch, and the local operators and launches nest under it), of the
  synchronisation at the call's end among them, and the events that took
  the most host time;
- ``plain``: each rank runs the same forward eagerly on plain tensors (its
  own sequence, the resident weights, no DTensor), all ranks at once and
  rank 0 alone, so that DTensor's part and the card's time-slicing among
  the ranks come apart.

``run(cfg, ranks, calls, device="cpu")`` does the same on the CPU (the
tests run it at ``LlamaConfig.tiny``).
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time

import torch

from .models import llama
from .parallel.launch import rank_store

SEQ = 1024    # tokens a rank
TOP = 8       # host events listed per rank


def forward(cfg):
    """The forward the shard phase serves: the last position's f32
    logits [B, vocab] of ``cfg`` (the lm_head product of that position
    alone)."""

    def last_logits(params, tokens):
        x = params["tok_emb"][tokens.long()]
        for layer in params["layers"]:
            x = llama._layer(cfg, layer, x)
        x = llama._rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
        return llama._mm(x, params["lm_head"]).float()

    return last_logits


# -- rank tasks ------------------------------------------------------------


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_trace_start() -> None:
    from torch.profiler import ProfilerActivity, profile

    dev = rank_store()["sharded"]["device"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    rank_store()["profile"] = prof


def _rank_trace_stop() -> dict:
    """The split of what the profiler saw since :func:`_rank_trace_start`."""
    prof = rank_store().pop("profile")
    prof.stop()
    cpu = torch.autograd.DeviceType.CPU
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top = [e for e in prof.events() if e.cpu_parent is None and e.device_type == cpu]
    by_name: dict = {}
    for e in top:
        got = by_name.setdefault(e.name, [0.0, 0])
        got[0] += e.cpu_time_total / 1e3
        got[1] += 1
    nested = sum(1 for e in prof.events() if e.cpu_parent is not None
                 and e.device_type == cpu and e.name.startswith("aten::"))
    return {"device_busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "kernel_launches": sum(e.count for e in kernels),
            "top_level_events": len(top),
            "top_level_host_ms": sum(e.cpu_time_total for e in top) / 1e3,
            "nested_aten_ops": nested,
            "sync_ms": sum(e.cpu_time_total for e in top if "Synchronize" in e.name) / 1e3,
            "top": [{"event": k, "host_ms": v[0], "count": v[1]} for k, v in
                    sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]]}


def _rank_plain(cfg, buf_ids, tokens: torch.Tensor, calls: int) -> float:
    """Median seconds of the forward on plain tensors: this rank's
    resident copies of the weights and ``tokens``."""
    st = rank_store()["sharded"]
    params = torch.utils._pytree.tree_map(lambda b: st["bufs"][b], buf_ids)
    x, fn, dev = tokens.to(st["device"]), forward(cfg), st["device"]
    times = []
    with torch.no_grad():
        for _ in range(calls):
            _sync(dev)
            t0 = time.perf_counter()
            fn(params, x)
            _sync(dev)
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


# -- driver ----------------------------------------------------------------


def _call_s(worker) -> list:
    return [r["call_s"] for r in worker.rank_devices.stats()]


def run(cfg, ranks: int = 4, calls: int = 12, device: str = "cuda", emit=print) -> dict:
    """Profile the sharded forward of ``cfg`` over ``ranks`` ranks;
    ``emit`` gets each line's JSON text.  Returns the lines by name."""
    from .remoting import RemoteDevice, RemoteVTPUWorker

    tree_map = torch.utils._pytree.tree_map
    gen = torch.Generator(device=device).manual_seed(0)
    params = tree_map(lambda t: t.cpu(), llama.init_params(cfg, gen, device=device))
    tokens = torch.randint(0, cfg.vocab_size, (ranks, SEQ), generator=gen,
                           device=device).cpu()
    if device == "cuda":
        torch.cuda.empty_cache()
    shape = {"dim": cfg.dim, "n_layers": cfg.n_layers, "tokens": [ranks, SEQ],
             "dtype": str(cfg.dtype), "ranks": ranks,
             "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu"}
    lines = {}

    def line(name, **row):
        lines[name] = row
        emit(json.dumps({"phase": name, **shape, **row}))

    worker = RemoteVTPUWorker(device=device, ranks=ranks)
    worker.start()
    dev = RemoteDevice(worker.url, timeout_s=900)
    try:
        rparams = tree_map(dev.put, params)
        remote = dev.remote_jit(forward(cfg), in_specs=(None, ("b",)), out_specs=("b",))
        remote(rparams, tokens)                 # replicates the weights
        c0, walls = _call_s(worker), []
        for _ in range(calls):
            t0 = time.perf_counter()
            remote(rparams, tokens)
            walls.append(time.perf_counter() - t0)
        in_rank = [(c - b) / calls * 1e3 for b, c in zip(c0, _call_s(worker))]
        line("execute", calls=calls, execute_ms_median=statistics.median(walls) * 1e3,
             execute_ms=[w * 1e3 for w in walls], in_rank_ms_mean_per_rank=in_rank)

        group = worker.rank_devices.group
        group.run_each(_rank_trace_start, [()] * ranks)
        c0 = _call_s(worker)
        t0 = time.perf_counter()
        remote(rparams, tokens)
        wall = time.perf_counter() - t0
        c1 = _call_s(worker)
        split = group.run_each(_rank_trace_stop, [()] * ranks)
        for s, b, c in zip(split, c0, c1):
            s["in_rank_ms"] = (c - b) * 1e3
            s["device_idle_share"] = max(0.0, 1 - s["device_busy_ms"] / s["in_rank_ms"])
        line("trace", execute_ms=wall * 1e3, per_rank=split)

        ids = tree_map(lambda b: b.buf_id, rparams)
        together = group.run_each(_rank_plain, [(cfg, ids, tokens[r:r + 1], calls)
                                                for r in range(ranks)])
        alone = group.call(0, _rank_plain, cfg, ids, tokens[:1], calls)
        line("plain", calls=calls, all_ranks_ms_per_rank=[t * 1e3 for t in together],
             rank0_alone_ms=alone * 1e3)
    finally:
        dev.close()
        worker.stop()
    return lines


def main() -> None:
    run(dataclasses.replace(llama.LlamaConfig.llama3_8b(), attn_impl="flash", n_layers=8))


if __name__ == "__main__":
    main()
