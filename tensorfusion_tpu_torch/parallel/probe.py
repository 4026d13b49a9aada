"""Which ``torch.distributed`` operations gloo does on a device.

    python -m tensorfusion_tpu_torch.parallel.probe [--device cuda] [--world 4]
        [--dtype float32|bfloat16]

Spawns ``--world`` ranks (``parallel/launch.py``; on CUDA they share the
card when there are fewer cards than ranks) and tries, on tensors of the
rank's device, each operation the collective layer uses, and the
``DTensor`` and ``torch.distributed.checkpoint`` calls the models and the
checkpointer make.  It prints one JSON line per operation: ``ok`` (the
answer was right), ``wrong`` (it ran and gave another answer) or the
error's first line, then the torch version.  ``parallel/collectives.py``
keys its host-staging table on what this prints for CUDA tensors.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from typing import Callable, Dict

import torch
import torch.distributed as dist


def _cases(dev: torch.device, dtype: torch.dtype) -> Dict[str, Callable[[], bool]]:
    r, n = dist.get_rank(), dist.get_world_size()

    def full(value, size=4):
        return torch.full((size,), float(value), device=dev, dtype=dtype)

    def all_reduce_sum():
        x = full(r + 1)
        dist.all_reduce(x)
        return bool((x == n * (n + 1) / 2).all())

    def all_reduce_max():
        x = full(r)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return bool((x == n - 1).all())

    def all_gather_into_tensor():
        out = torch.empty(4 * n, device=dev, dtype=dtype)
        dist.all_gather_into_tensor(out, full(r))
        return bool((out == torch.arange(n, device=dev).repeat_interleave(4)).all())

    def all_gather():
        outs = [torch.empty(4, device=dev, dtype=dtype) for _ in range(n)]
        dist.all_gather(outs, full(r))
        return all(bool((o == i).all()) for i, o in enumerate(outs))

    def reduce_scatter_tensor():
        out = torch.empty(4, device=dev, dtype=dtype)
        dist.reduce_scatter_tensor(out, torch.arange(4 * n, device=dev, dtype=dtype))
        want = torch.arange(4 * r, 4 * r + 4, device=dev, dtype=dtype) * n
        return bool((out == want).all())

    def all_to_all_single():
        out = torch.empty(4 * n, device=dev, dtype=dtype)
        dist.all_to_all_single(out, full(r, 4 * n))
        return bool((out == torch.arange(n, device=dev).repeat_interleave(4)).all())

    def broadcast():
        x = full(r)
        dist.broadcast(x, src=n - 1)
        return bool((x == n - 1).all())

    def send_recv():
        got = torch.empty(4, device=dev, dtype=dtype)
        if r % 2 == 0:
            dist.send(full(r), dst=(r + 1) % n)
            dist.recv(got, src=(r + 1) % n)
        else:
            dist.recv(got, src=(r - 1) % n)
            dist.send(full(r), dst=(r - 1) % n)
        return bool((got == (r + 1 if r % 2 == 0 else r - 1) % n).all())

    def batch_isend_irecv():
        got = torch.empty(4, device=dev, dtype=dtype)
        ops = [dist.P2POp(dist.isend, full(r), (r + 1) % n),
               dist.P2POp(dist.irecv, got, (r - 1) % n)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return bool((got == (r - 1) % n).all())

    def dtensor_full_tensor():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Shard

        mesh = init_device_mesh(dev.type, (n,), mesh_dim_names=("x",))
        d = DTensor.from_local(full(r), mesh, [Shard(0)], run_check=False)
        return bool((d.full_tensor() == torch.arange(n, device=dev)
                     .repeat_interleave(4)).all())

    def _mesh():
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(dev.type, (n,), mesh_dim_names=("x",))

    def dtensor_shard_to_replicate():
        from torch.distributed.tensor import DTensor, Replicate, Shard

        d = DTensor.from_local(full(r), _mesh(), [Shard(0)], run_check=False)
        got = d.redistribute(placements=[Replicate()]).to_local()
        return bool((got == torch.arange(n, device=dev).repeat_interleave(4)).all())

    def dtensor_partial_to_replicate():
        from torch.distributed.tensor import DTensor, Partial, Replicate

        d = DTensor.from_local(full(r + 1), _mesh(), [Partial()], run_check=False)
        got = d.redistribute(placements=[Replicate()]).to_local()
        return bool((got == n * (n + 1) / 2).all())

    def dtensor_replicate_to_shard():
        from torch.distributed.tensor import DTensor, Replicate, Shard

        whole = torch.arange(4 * n, device=dev, dtype=dtype)
        d = DTensor.from_local(whole, _mesh(), [Replicate()], run_check=False)
        got = d.redistribute(placements=[Shard(0)]).to_local()
        return bool((got == whole[4 * r:4 * r + 4]).all())

    def checkpoint_reshard():
        import torch.distributed.checkpoint as dcp
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = init_device_mesh(dev.type, (n,), mesh_dim_names=("x",))
        path = [tempfile.mkdtemp(prefix="tpf-probe-") if r == 0 else None]
        dist.broadcast_object_list(path, src=0)
        d = DTensor.from_local(full(r), mesh, [Shard(0)], run_check=False)
        dcp.save({"w": d}, checkpoint_id=path[0])
        back = DTensor.from_local(torch.zeros(4 * n, device=dev, dtype=dtype), mesh,
                                  [Replicate()], run_check=False)
        dcp.load({"w": back}, checkpoint_id=path[0])
        return bool((back.to_local() == torch.arange(n, device=dev)
                     .repeat_interleave(4)).all())

    return {f.__name__: f for f in (
        all_reduce_sum, all_reduce_max, all_gather_into_tensor, all_gather,
        reduce_scatter_tensor, all_to_all_single, broadcast, send_recv,
        batch_isend_irecv, dtensor_full_tensor, dtensor_shard_to_replicate,
        dtensor_partial_to_replicate, dtensor_replicate_to_shard, checkpoint_reshard)}


CASES = ("all_reduce_sum", "all_reduce_max", "all_gather_into_tensor",
         "all_gather", "reduce_scatter_tensor", "all_to_all_single",
         "broadcast", "send_recv", "batch_isend_irecv", "dtensor_full_tensor",
         "dtensor_shard_to_replicate", "dtensor_partial_to_replicate",
         "dtensor_replicate_to_shard", "checkpoint_reshard")


def probe_case(device: str, dtype: str, name: str) -> str:
    """Run one case on this rank; its verdict."""
    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    try:
        ok = _cases(dev, getattr(torch, dtype))[name]()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return "ok" if ok else "wrong"
    except Exception as e:      # the verdict is the error's first line
        return f"{type(e).__name__}: {(str(e).splitlines() or [''])[0][:160]}"


def main() -> int:
    from .launch import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    a = ap.parse_args()
    # one group a case: an operation the backend cannot do on a device
    # may abort its ranks rather than raise
    for name in CASES:
        try:
            verdicts = sorted(set(launch(probe_case, a.world, a.device, a.dtype, name,
                                         device=a.device, backend="gloo",
                                         timeout_s=120)))
        except RuntimeError as e:
            last = [l for l in str(e).splitlines() if l.strip()][-1]
            verdicts = [f"ranks failed: {last.strip()[:160]}"]
        print(json.dumps({"op": name, "device": a.device, "backend": "gloo",
                          "world": a.world, "dtype": a.dtype, "verdict": verdicts}), flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
