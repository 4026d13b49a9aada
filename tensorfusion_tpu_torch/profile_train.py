"""Where the time of one train step goes in the port, on the card.

    python -m tensorfusion_tpu_torch.profile_train
    python -m tensorfusion_tpu_torch.profile_train --config bench

``llama3_8b`` (the default) builds Llama-3-8B-width random weights (8
layers, bf16, flash attention, batch 4 x 1024: ``chip_smoke.py``'s train
phase), runs one ``make_train_step`` step to warm up, then traces with
``torch.profiler`` the loss and gradient of one step and, apart, its
AdamW update.  ``bench`` traces one step of ``bench_train`` at its
configuration (8 x 512; loss, gradient and ``p - 1e-4 * g``).  Prints one
JSON line per part with
``profile_serve``'s fields: wall time, device busy time, idle share,
launches, the kernels that took the most time, and the device time
grouped by kind (the attention kernels of this package, the matrix
products, the rest).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from . import bench_train
from .models import llama
from .profile_serve import _trace


LAYERS = 8            # AdamW state of 32 layers would not fit in 80 GB
SHAPE = (4, 1024)     # train batch x sequence


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("llama3_8b", "bench"), default="llama3_8b")
    args = ap.parse_args()

    bench = args.config == "bench"
    if bench:
        cfg, (b, t) = bench_train.bench_config(), bench_train.SHAPE
    else:
        cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=LAYERS,
                                  attn_impl="flash")
        b, t = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(cfg, gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (b, t + 1), generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    shape = {"config": args.config, "layers": cfg.n_layers, "batch": b, "seq": t,
             "device": torch.cuda.get_device_name(0)}

    if bench:
        step = bench_train.make_step(cfg)
        params, _ = step(params, batch)                      # warm-up
        print(json.dumps({"phase": "bench_step", **shape,
                          **_trace(lambda: step(params, batch))}))
        return

    step, init_opt_state = llama.make_train_step(cfg)
    opt_state = init_opt_state(params)
    step(params, opt_state, batch)                           # warm-up
    state = {}

    def loss_and_grad():
        state["loss"], state["grads"] = llama.value_and_grad(params, batch, cfg)

    def update():
        llama.adamw_update_(llama._leaves(params), state["grads"], opt_state, 3e-4)

    print(json.dumps({"phase": "loss_and_grad", **shape, **_trace(loss_and_grad)}))
    print(json.dumps({"phase": "adamw", **shape, **_trace(update)}))


if __name__ == "__main__":
    main()
