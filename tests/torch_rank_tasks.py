"""Bodies that the multi-rank tests run on spawned gloo ranks (CPU).

A spawned rank imports the module of the function it runs, so this file
imports only torch, numpy and the port: a body defined in a test file
would make every rank import JAX and the reference package.  Inputs
arrive as numpy trees and results go back as numpy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tensorfusion_tpu_torch.models import Checkpointer, llama, moe
from tensorfusion_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from tensorfusion_tpu_torch.models.quantize import quantize_weights_int8
from tensorfusion_tpu_torch.parallel import (make_mesh, pipeline_apply,
                                             ring_attention_sharded)


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _np(t):
    return _whole(t).detach().cpu().numpy()


def _batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _tree_np(tree):
    return params_to_numpy(torch.utils._pytree.tree_map(_whole, tree))


def _placements(t):
    return [str(p) for p in t.placements]


def mesh_layout(axes):
    """The mesh's names, shape and this rank's coordinates."""
    mesh = make_mesh(axes, device="cpu")
    return {"names": list(mesh.mesh_dim_names), "shape": list(mesh.mesh.shape),
            "coords": {n: mesh.get_local_rank(n) for n in mesh.mesh_dim_names},
            "rank": dist.get_rank()}


def llama_train_steps(axes, cfg, params_np, batch_np, steps, lr):
    """The loss and gradients of the first batch, then ``steps`` sharded
    AdamW steps: their losses, the final parameters (whole) and the
    placements of wq before and after."""
    mesh = make_mesh(axes, device="cpu")
    params = llama.shard_params(params_from_numpy(params_np, device="cpu"), mesh, cfg)
    before = _placements(params["layers"][0]["attn"]["wq"])
    batch = _batch(batch_np)
    loss, grads = llama.value_and_grad(params, batch, cfg, mesh)
    grad_placements = [(_placements(g), _placements(q))
                       for g, q in zip(grads, llama._leaves(params))]
    grads = [_np(g) for g in grads]
    step, init_opt = llama.make_train_step(cfg, learning_rate=lr, device="cpu",
                                           mesh=mesh)
    opt = init_opt(params)
    losses = []
    for _ in range(steps):
        params, opt, step_loss = step(params, opt, batch)
        losses.append(float(step_loss))
    return {"loss": float(loss), "grads": grads, "grad_placements": grad_placements,
            "losses": losses, "params": _tree_np(params),
            "placements": (before, _placements(params["layers"][0]["attn"]["wq"]),
                           _placements(opt["mu"]["layers"][0]["attn"]["wq"]))}


def llama_forward(axes, cfg, params_np, tokens, quantize=False):
    """Whole logits of the sharded forward of ``tokens[:, :-1]`` (and the
    loss of its next tokens)."""
    mesh = make_mesh(axes, device="cpu")
    params = params_from_numpy(params_np, device="cpu")
    if quantize:
        params = quantize_weights_int8(params)
    params = llama.shard_params(params, mesh, cfg)
    tokens = torch.from_numpy(np.asarray(tokens))
    logits = llama.forward(params, tokens[:, :-1], cfg, mesh)
    out = {"logits": logits.numpy()}
    if quantize:
        wq = params["layers"][0]["attn"]["wq"]
        out["placements"] = (_placements(wq.q), _placements(wq.s))
    else:
        batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
        out["loss"] = float(llama.loss_fn(params, batch, cfg, mesh))
    return out


def ring(axes, q, k, v, causal, w):
    """ring_attention_sharded's output and the gradients of sum(out * w);
    with ``w`` "bf16", q/k/v come as uint16 bits of bf16 and only the
    output (as f32) and its dtype go back."""
    mesh = make_mesh(axes, device="cpu")
    if isinstance(w, str):
        q, k, v = (torch.from_numpy(np.asarray(x).astype(np.int16)).view(torch.bfloat16)
                   for x in (q, k, v))
        out = ring_attention_sharded(q, k, v, mesh, causal=causal)
        return {"out": out.float().numpy(), "dtype": str(out.dtype)}
    q, k, v = (torch.from_numpy(np.asarray(x)).requires_grad_(True) for x in (q, k, v))
    out = ring_attention_sharded(q, k, v, mesh, causal=causal)
    if w is None:
        return {"out": out.detach().numpy()}
    grads = torch.autograd.grad((out * torch.from_numpy(np.asarray(w))).sum(), (q, k, v))
    return {"out": out.detach().numpy(), "grads": [g.numpy() for g in grads]}


def _tanh_stage(w, x):
    return torch.tanh(x @ w)


def pipeline(axes, ws, xs):
    mesh = make_mesh(axes, device="cpu")
    out = pipeline_apply(_tanh_stage, torch.from_numpy(np.asarray(ws)),
                         torch.from_numpy(np.asarray(xs)), mesh)
    return out.numpy()


def moe_ep_forward(axes, cfg, params_np, tokens):
    """Whole logits of the expert-parallel forward, this rank's dropped
    entries, and its data and ep coordinates."""
    mesh = make_mesh(axes, device="cpu")
    params = moe.shard_moe_params(params_from_numpy(params_np, device="cpu"), mesh, cfg)
    stats = {}
    logits = moe.moe_forward(params, torch.from_numpy(np.asarray(tokens)), cfg, mesh,
                             stats=stats)
    return {"logits": logits.numpy(), "dropped": stats["dropped"],
            "ep": mesh.get_local_rank("ep"),
            "w_gate": _placements(params["layers"][0]["moe"]["w_gate"])}


def moe_train_steps(axes, cfg, params_np, batch_np, steps, lr):
    mesh = make_mesh(axes, device="cpu")
    params = moe.shard_moe_params(params_from_numpy(params_np, device="cpu"), mesh, cfg)
    step, init_opt = moe.make_moe_train_step(cfg, learning_rate=lr, device="cpu",
                                             mesh=mesh)
    opt = init_opt(params)
    batch = _batch(batch_np)
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    return {"losses": losses, "params": _tree_np(params)}


def checkpoint_resume(axes, cfg, params_np, fresh_np, batch_np, directory):
    """The resume contract: 3 steps, save, one more step (continued);
    a fresh state sharded alike, one step, restored from the save, one
    step (resumed)."""
    mesh = make_mesh(axes, device="cpu")
    step, init_opt = llama.make_train_step(cfg, learning_rate=1e-2, device="cpu",
                                           mesh=mesh)
    batch = _batch(batch_np)
    params = llama.shard_params(params_from_numpy(params_np, device="cpu"), mesh, cfg)
    opt = init_opt(params)
    for _ in range(3):
        params, opt, _ = step(params, opt, batch)
    ck = Checkpointer(directory)
    ck.save(3, params, opt, extra={"data_position": 3})
    latest = ck.latest_step()
    _, _, continued = step(params, opt, batch)
    p2 = llama.shard_params(params_from_numpy(fresh_np, device="cpu"), mesh, cfg)
    o2 = init_opt(p2)
    p2, o2, _ = step(p2, o2, batch)
    restored = ck.restore(target={"params": p2, "opt_state": o2})
    count = int(restored["opt_state"]["count"])
    _, _, resumed = step(restored["params"], restored["opt_state"], batch)
    ck.close()
    return {"latest": latest, "continued": float(continued), "resumed": float(resumed),
            "extra": restored["extra"], "count": count,
            "placements": _placements(restored["params"]["layers"][0]["attn"]["wq"])}


def checkpoint_keep(axes, cfg, params_np, directory, max_to_keep):
    """Save steps 1..5 of sharded parameters (scaled by the step); the
    steps left on disk and the whole latest restore without a target."""
    mesh = make_mesh(axes, device="cpu")
    params = llama.shard_params(params_from_numpy(params_np, device="cpu"), mesh, cfg)
    ck = Checkpointer(directory, max_to_keep=max_to_keep)
    for s in range(1, 6):
        with torch.no_grad():
            for p in llama._leaves(params):
                p.to_local().mul_(2.0 if s > 1 else 1.0)
        ck.save(s, params)
    dist.barrier()
    restored = ck.restore()
    return {"steps": ck._steps(), "latest": ck.latest_step(),
            "restored": params_to_numpy(restored["params"]),
            "saved": _tree_np(params)}


def fail_on(rank):
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return dist.get_rank()


def spec_placements(axes, specs):
    mesh = make_mesh(axes, device="cpu")
    from tensorfusion_tpu_torch.parallel.mesh import placements
    return [[str(p) for p in placements(mesh, tuple(s))] for s in specs]


def collective(axes, name):
    """One differentiable collective of parallel/collectives.py over the
    mesh axis "tp": this rank's input is arange(16).reshape(8, 2) + 100·r,
    the upstream gradient arange(out.numel()) + r; returns (out, grad)."""
    from tensorfusion_tpu_torch.parallel import collectives as c

    mesh = make_mesh(axes, device="cpu")
    r = mesh.get_local_rank("tp")
    x = (torch.arange(16, dtype=torch.float32).reshape(8, 2) + 100 * r).requires_grad_(True)
    out = {"copy_to": lambda: c.copy_to(x, mesh, "tp"),
           "reduce_from": lambda: c.reduce_from(x, mesh, "tp"),
           "gather_from": lambda: c.gather_from(x, mesh, "tp", 0),
           "scatter_to": lambda: c.scatter_to(x, mesh, "tp", 0),
           "gather_rs": lambda: c.gather_rs(x, mesh, "tp", 0),
           "shift": lambda: c.shift_along(x, mesh, "tp", 1, wrap=True),
           "shift_nowrap": lambda: c.shift_along(x, mesh, "tp", 1, wrap=False),
           "all_to_all": lambda: c.all_to_all(x, mesh, "tp", 0, 1)}[name]()
    g = (torch.arange(out.numel(), dtype=torch.float32) + r).reshape(out.shape)
    (grad,) = torch.autograd.grad((out * g).sum(), (x,))
    return out.detach().numpy(), grad.numpy()


# -- on the card (tests/test_torch_kernels_gpu.py): ranks share cuda:0 --------


def gpu_train_losses(axes, cfg, seed, batch, steps):
    """``steps`` sharded steps on CUDA from weights made by a CUDA
    generator seeded with ``seed``; the losses and this rank's kernel
    launches over them."""
    from tensorfusion_tpu_torch import ops

    mesh = make_mesh(axes, device="cuda")
    params = llama.shard_params(llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda"), mesh, cfg)
    step, init_opt = llama.make_train_step(cfg, device="cuda", mesh=mesh)
    opt = init_opt(params)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    ops.reset_launch_counts()
    losses = [float(step(params, opt, batch)[2]) for _ in range(steps)]
    return {"losses": losses, "launches": ops.launch_counts()}


def gpu_ring(axes, q, k, v, w):
    """Ring attention on CUDA: this rank's output and gradients, gathered
    whole (as CPU tensors)."""
    mesh = make_mesh(axes, device="cuda")
    q, k, v = (torch.as_tensor(x, device="cuda").requires_grad_(True) for x in (q, k, v))
    out = ring_attention_sharded(q, k, v, mesh, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), grad_outputs=torch.as_tensor(w, device="cuda"))
    return [x.detach().cpu() for x in (out, *grads)]


def gpu_moe(axes, cfg, seed, tokens):
    """Expert-parallel MoE logits on CUDA (CPU copy) and this rank's drops."""
    mesh = make_mesh(axes, device="cuda")
    params = moe.shard_moe_params(moe.init_moe_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda"), mesh, cfg)
    stats = {}
    with torch.no_grad():
        logits = moe.moe_forward(params, torch.as_tensor(tokens, device="cuda"), cfg,
                                 mesh, stats=stats)
    return {"logits": logits.cpu(), "dropped": stats["dropped"]}


def die_on(rank):
    """Rank ``rank`` exits at once, as a crashed rank does."""
    import os

    if dist.get_rank() == rank:
        os._exit(3)
    return dist.get_rank()


def flash_on_dtensors(q_np, k_np, v_np, dim):
    """q, k, v [B, H, T, D] sharded on ``dim`` (0 batch, 1 heads) over a
    1-D mesh of the ranks, through the port's flash attention: the
    output's placement, this rank's output shard and its shape, and the
    error of a call whose q, k and v are not sharded alike."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from tensorfusion_tpu_torch.ops import flash_attention, flash_attention_fwd

    r, n = dist.get_rank(), dist.get_world_size()
    mesh = init_device_mesh("cpu", (n,))
    q, k, v = (DTensor.from_local(torch.from_numpy(x).chunk(n, dim)[r].contiguous(),
                                  mesh, [Shard(dim)], run_check=False)
               for x in (q_np, k_np, v_np))
    out = flash_attention(q, k, v, causal=True)
    flat = DTensor.from_local(torch.from_numpy(k_np[0]), mesh, [Replicate()],
                              run_check=False)
    try:
        flash_attention_fwd(flat, flat, flat, 0.1, True)
        mixed = ""
    except RuntimeError as e:       # DTensor's dispatch wraps the rule's error
        mixed = str(e)
    return {"placements": str(out.placements), "local": out.to_local().numpy(),
            "local_shape": list(out.to_local().shape), "mixed_error": mixed}


#: what the node agent puts in a soft worker's env for the launch hook
HOOK_ENV = ("LD_PRELOAD", "TPF_SHM_PATH", "TPF_LIMITER_LIB", "TPF_DEVICE_INDEX",
            "TPF_PEAK_MFLOPS")


def hooked_launches(n_launches):
    """``n_launches`` kernels through the stand-in driver, reached as
    CUDA's runtime reaches it (``cuGetProcAddress_v2``), under the launch
    hook: this rank's pid, the hook's report and the hook's variables
    this rank inherited."""
    import ctypes as C
    import os

    from tensorfusion_tpu_torch.hypervisor import cuda_hook_binding

    cuda = C.CDLL("libcuda.so.1")
    gpa = cuda.cuGetProcAddress_v2
    gpa.argtypes = [C.c_char_p, C.POINTER(C.c_void_p), C.c_int, C.c_uint64,
                    C.POINTER(C.c_int)]
    fn, status = C.c_void_p(), C.c_int()
    if gpa(b"cuLaunchKernel", C.byref(fn), 12080, 0, C.byref(status)) != 0:
        raise RuntimeError("cuGetProcAddress_v2(cuLaunchKernel) failed")
    launch = C.CFUNCTYPE(C.c_int, *([C.c_void_p] + [C.c_uint] * 7 + [C.c_void_p] * 3))(
        fn.value)
    for _ in range(n_launches):
        if launch(None, 1, 1, 1, 32, 1, 1, 0, None, None, None) != 0:
            raise RuntimeError("cuLaunchKernel failed")
    hook = cuda_hook_binding.loaded()
    return {"pid": os.getpid(), "hook": hook.report() if hook is not None else None,
            "env": {k: os.environ.get(k) for k in HOOK_ENV}}
