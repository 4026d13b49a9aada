"""The devices of a ``ranks=n`` remote worker: the ranks of one
``parallel.launch.RankGroup``.

The reference's worker serves every local device of one process as a
mesh (protocol v3): it compiles a sharded ``jax.export`` against a
worker-local mesh, returns a wire layout per argument and result, and
assembles the client's shards into global arrays.  In the port "n
devices" are the n ranks of a rank group (``cuda:(r % count)``, or the
CPU), so this module is the worker's side of that: rank r is device r.

- **Rank side** (the ``_rank_*`` tasks, run by the group): each rank
  keeps its buffers and loaded programs in its ``rank_store()`` between
  tasks.  A sharded program runs its export's graph on ``DTensor``s
  built from the rank's local shards over the group's 1-D
  ``DeviceMesh`` (plain tensors the graph makes count as replicated),
  so every rank computes on its own shard only; its results are then
  redistributed to the program's ``out_specs`` by the port's own
  collectives (``parallel/collectives.py``): gloo's functional
  all-gather aborts the ranks on CUDA tensors (``parallel.probe``), so
  no result goes through ``DTensor.redistribute``.  A partial sum is
  reduced in f32 and cast back once.  A one-device program runs on rank
  0 on plain tensors.
- **Worker side** (:class:`RankDevices`): the table of what each rank
  holds (a buffer lives on one rank, or on all of them once a
  replicated argument used it: the owner broadcasts it, once), the
  layouts, and the per-rank argument lists of an EXECUTE.  Bytes move
  between the worker and a rank as CPU tensors through the group's task
  queues (shared memory), never through gloo's send / recv.

A rank that raises answers with its error (the group stays up); a rank
that dies or overruns the group's timeout fails the call, names the
rank, and closes the group, after which every request is refused.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..parallel.launch import RankGroup, rank_store
from . import program

#: seconds one task on the ranks may take before the group is given up
RANK_TIMEOUT_S = 300.0


# -- layouts -----------------------------------------------------------------


def wire_layout(spec, shape, n: int) -> Optional[List[dict]]:
    """The reference's ``_wire_layout`` for a spec over a flat mesh of
    ``n`` devices: ``{"device": id, "slices": [[lo, hi], ...]}`` per
    device in mesh order, or None for a replicated value."""
    dim = program.spec_dim(spec)
    if dim is None:
        return None
    step = shape[dim] // n
    return [{"device": r, "slices": [[r * step, (r + 1) * step] if i == dim else [0, d]
                                     for i, d in enumerate(shape)]}
            for r in range(n)]


def _index(slices) -> tuple:
    return tuple(slice(lo, hi) for lo, hi in slices)


# -- rank side ---------------------------------------------------------------


class RankError(RuntimeError):
    """A task that raised on a rank (the group is still up)."""


def _guarded(fn):
    """Run a rank task, answering with its error instead of raising, so one
    tenant's bad program does not stop the group."""
    def task(*args):
        try:
            return {"ok": fn(*args)}
        except Exception:  # noqa: BLE001 - reported to the worker, by rank
            return {"error": traceback.format_exc(limit=6)}
    # pickled by name: the module-level alias without "_impl"
    task.__name__ = task.__qualname__ = fn.__name__[:-len("_impl")]
    return task


def _store() -> Dict[str, Any]:
    return rank_store()["sharded"]


def _rank_init_impl(device_type: str) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .. import ops  # noqa: F401 - the flash op and its DTensor rule

    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")
    mesh = init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("_tpf_flat",))
    rank_store()["sharded"] = {"device": dev, "mesh": mesh, "bufs": {}, "exes": {},
                               "last": None, "call_s": 0.0, "calls": 0}
    return {"pid": os.getpid(), "device": str(dev),
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}


def _rank_load_impl(exe_id: str, blob: bytes) -> None:
    st = _store()
    if exe_id in st["exes"]:
        return
    module, shardings = program.load_program(blob, st["device"])
    if shardings is not None:
        # DTensor has no rule for export's metadata assertions (each
        # checks a dtype and device the worker's own placement sets)
        graph = module.graph
        for node in list(graph.nodes):
            if node.op == "call_function" and \
                    node.target is torch.ops.aten._assert_tensor_metadata.default:
                graph.erase_node(node)
        module.recompile()
    st["exes"][exe_id] = (module, shardings)


def _rank_put_impl(buf_id: str, host: torch.Tensor) -> None:
    st = _store()
    st["bufs"][buf_id] = host.to(st["device"])


def _rank_replicate_impl(buf_id: str, src: int, shape, dtype_name: str) -> None:
    """Every rank gets rank ``src``'s copy of ``buf_id`` (a broadcast)."""
    import torch.distributed as dist

    st = _store()
    if dist.get_rank() == src:
        t = st["bufs"][buf_id].contiguous()
    else:
        t = torch.empty(shape, dtype=getattr(torch, dtype_name), device=st["device"])
    dist.broadcast(t, src=src, group=st["mesh"].get_group())
    st["bufs"][buf_id] = t


def _rank_fetch_impl(buf_id: str) -> torch.Tensor:
    return _store()["bufs"][buf_id].detach().cpu()


def _rank_free_impl(buf_ids: Sequence[str]) -> int:
    bufs = _store()["bufs"]
    return sum(bufs.pop(b, None) is not None for b in buf_ids)


def _placement(spec):
    from torch.distributed.tensor import Replicate, Shard

    dim = program.spec_dim(spec)
    return Replicate() if dim is None else Shard(dim)


def _local_arg(st, desc) -> torch.Tensor:
    kind = desc[0]
    if kind == "host":
        return desc[1].to(st["device"])
    t = st["bufs"][desc[1]]
    return t if kind == "buf" else t[_index(desc[2])]


def _redistribute(out, spec, group) -> torch.Tensor:
    """One result's local tensor under ``spec``, from its DTensor: the
    exchanges a sharded program's results need, through the port's
    collectives (host-staged where gloo needs it)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..parallel import collectives

    if not isinstance(out, DTensor):
        # a value the graph made from no argument: the same on every rank
        out = DTensor.from_local(out, _store()["mesh"], [Replicate()], run_check=False)
    (have,), local = out.placements, out.to_local()
    want = _placement(spec)
    if have == want:
        return local
    if isinstance(have, Partial):
        if have.reduce_op != "sum":
            raise ValueError(f"a result reduced by {have.reduce_op} is not supported")
        local = collectives.all_reduce(local.float(), group).to(local.dtype)
    elif isinstance(have, Shard):
        local = collectives.all_gather(local, group, have.dim)
    if isinstance(want, Shard):
        local = local.chunk(group.size(), dim=want.dim)[group.rank()].contiguous()
    return local


def _rank_execute_impl(exe_id: str, args: list, result_ids: Optional[list]) -> dict:
    """Run one program on this rank's part of its arguments.  Results are
    kept under ``result_ids`` (their shapes return), or returned: each
    rank its shard of a sharded result, rank 0 alone a replicated one."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    st = _store()
    t0 = time.perf_counter()
    module, shardings = st["exes"][exe_id]
    # the call consumes its ephemeral shards whatever becomes of it
    taken = {d[1]: st["bufs"].pop(d[1]) for d in args if d[0] == "take"}
    local = [taken[d[1]] if d[0] == "take" else _local_arg(st, d) for d in args]
    rank = dist.get_rank()
    comms = 0
    with torch.no_grad():
        if shardings is None:
            outs = list(module(*local))
        else:
            mesh = st["mesh"]
            dargs = [DTensor.from_local(x, mesh, [_placement(spec)], run_check=False)
                     for x, spec in zip(local, shardings["in_specs"])]
            with implicit_replication(), CommDebugMode() as comm:
                douts = list(module(*dargs))
            comms = comm.get_total_counts()
            group = mesh.get_group()
            outs = [_redistribute(o, spec, group)
                    for o, spec in zip(douts, shardings["out_specs"])]
    specs = shardings["out_specs"] if shardings else [None] * len(outs)
    if result_ids is not None and len(result_ids) != len(outs):
        raise ValueError(f"result_ids count {len(result_ids)} != {len(outs)} results")
    st["last"] = {"args": [list(x.shape) for x in local],
                  "outs": [list(x.shape) for x in outs], "implicit_comms": comms}
    if result_ids is not None:
        for rid, out in zip(result_ids, outs):
            st["bufs"][rid] = out
        reply = {"shapes": [list(o.shape) for o in outs], "dtypes": [o.dtype for o in outs]}
    else:
        reply = {"results": [o.detach().cpu() if program.spec_dim(spec) is not None
                             or rank == 0 else None for o, spec in zip(outs, specs)]}
    if st["device"].type == "cuda":
        torch.cuda.synchronize(st["device"])
    st["call_s"] += time.perf_counter() - t0
    st["calls"] += 1
    return reply


def _rank_stats_impl() -> dict:
    """This rank's pid, device, resident bytes, kernel launches, time in
    programs, its last program's local shapes, and the launch hook's
    report where the node agent preloaded one."""
    from .. import ops
    from ..hypervisor import cuda_hook_binding

    st = _store()
    hook = cuda_hook_binding.loaded()
    return {"pid": os.getpid(), "device": str(st["device"]),
            "resident_bytes": sum(t.numel() * t.element_size() for t in st["bufs"].values()),
            "launch_counts": ops.launch_counts(), "calls": st["calls"],
            "call_s": st["call_s"], "last_execute": st["last"],
            "hook": hook.report() if hook is not None else None}


_rank_init = _guarded(_rank_init_impl)
_rank_load = _guarded(_rank_load_impl)
_rank_put = _guarded(_rank_put_impl)
_rank_replicate = _guarded(_rank_replicate_impl)
_rank_fetch = _guarded(_rank_fetch_impl)
_rank_free = _guarded(_rank_free_impl)
_rank_execute = _guarded(_rank_execute_impl)
_rank_stats = _guarded(_rank_stats_impl)


# -- worker side ---------------------------------------------------------------


@dataclasses.dataclass
class Placed:
    """A resident buffer of a rank worker: where its copies live."""

    ranks: set
    shape: tuple
    dtype: torch.dtype
    nbytes: int               # of one copy
    ephemeral: bool = False


class RankDevices:
    """The ``n`` ranks of one group as a worker's devices.  The worker
    owns the accounting (its lock, admission and meter): ``admit(nbytes)``
    returns an error or None and ``release(nbytes)`` gives bytes back,
    both called with the worker's lock held, which also guards
    :attr:`placed`."""

    def __init__(self, n: int, device: torch.device, lock: threading.Lock,
                 admit, release):
        self.n = n
        self._lock, self._admit, self._release = lock, admit, release
        self.group = RankGroup(n, backend="gloo", device=device.type,
                               timeout_s=RANK_TIMEOUT_S)
        try:
            self.infos = self._each(_rank_init, [(device.type,)] * n)
        except BaseException:
            self.group.close(wait=False)
            raise
        #: buf_id -> its copies; guarded by the worker's lock
        self.placed: Dict[str, Placed] = {}
        #: exe_id -> shardings (None: a one-device program on rank 0)
        self.exes: Dict[str, Optional[dict]] = {}

    def close(self) -> None:
        self.group.close()

    # -- rank calls ----------------------------------------------------------

    @staticmethod
    def _answer(rank: int, reply: dict, task: str):
        if "error" in reply:
            raise RankError(f"rank {rank} failed in {task}:\n{reply['error']}")
        return reply["ok"]

    def _each(self, task, args: List[tuple]) -> list:
        replies = self.group.run_each(task, args)
        return [self._answer(r, reply, task.__name__) for r, reply in enumerate(replies)]

    def _one(self, rank: int, task, *args):
        return self._answer(rank, self.group.call(rank, task, *args), task.__name__)

    # -- buffers ---------------------------------------------------------------

    def check_device(self, device_id: int) -> Optional[str]:
        if 0 <= device_id < self.n:
            return None
        return f"no device {device_id} (worker has {self.n})"

    def put(self, buf_id: str, host: torch.Tensor, device_id: int,
            ephemeral: bool) -> Optional[str]:
        """Place ``host`` on rank ``device_id``; an error string when the
        budget refuses it."""
        nbytes = host.numel() * host.element_size()
        with self._lock:
            err = self._admit(nbytes)
        if err:
            return err
        try:
            self._one(device_id, _rank_put, buf_id, host.contiguous())
        except BaseException:
            with self._lock:
                self._release(nbytes)
            raise
        with self._lock:
            old = self.placed.pop(buf_id, None)
            self.placed[buf_id] = Placed({device_id}, tuple(host.shape), host.dtype,
                                         nbytes, ephemeral)
        if old is not None:
            self._drop(buf_id, old)
        return None

    def _drop(self, buf_id: str, rec: Placed, admitted: bool = True) -> None:
        """Free a record's copies (it is out of the table already) and
        release their bytes, if they were admitted."""
        try:
            for r in sorted(rec.ranks):
                self._one(r, _rank_free, [buf_id])
        finally:
            if admitted:
                with self._lock:
                    self._release(rec.nbytes * len(rec.ranks))

    def free(self, buf_ids: Sequence[str]) -> int:
        freed = 0
        for buf_id in buf_ids:
            with self._lock:
                rec = self.placed.pop(buf_id, None)
            if rec is not None:
                self._drop(buf_id, rec)
                freed += 1
        return freed

    def fetch(self, buf_id: str, device_id: Optional[int] = None
              ) -> Tuple[torch.Tensor, int]:
        """A buffer's bytes (from ``device_id``, which must hold a copy,
        or from its first copy) and the device they came from."""
        with self._lock:
            rec = self.placed.get(buf_id)
        if rec is None:
            raise KeyError(f"unknown buffer {buf_id}")
        if device_id is not None and device_id not in rec.ranks:
            raise KeyError(f"buffer {buf_id} has no shard on device {device_id}")
        rank = min(rec.ranks) if device_id is None else device_id
        return self._one(rank, _rank_fetch, buf_id), rank

    def _replicate(self, buf_id: str) -> None:
        """Copy ``buf_id`` to every rank (once; the copies stay until it is
        freed and are charged as resident)."""
        with self._lock:
            rec = self.placed.get(buf_id)
            if rec is None:
                raise KeyError(f"unknown buffer {buf_id}")
            if len(rec.ranks) == self.n:
                return
            extra = rec.nbytes * (self.n - len(rec.ranks))
            err = self._admit(extra)
        if err:
            raise KeyError(err)
        src = min(rec.ranks)
        try:
            self._each(_rank_replicate,
                       [(buf_id, src, rec.shape, str(rec.dtype)[6:])] * self.n)
        except BaseException as e:
            with self._lock:
                self._release(extra)
            if isinstance(e, RankError):    # the group is up: drop the copies it made
                for r in sorted(set(range(self.n)) - rec.ranks):
                    self._one(r, _rank_free, [buf_id])
            raise
        with self._lock:
            rec.ranks = set(range(self.n))

    def resident_per_device(self) -> Dict[str, int]:
        per = {str(r): 0 for r in range(self.n)}
        with self._lock:
            for rec in self.placed.values():
                for r in rec.ranks:
                    per[str(r)] += rec.nbytes
        return per

    # -- programs ----------------------------------------------------------

    def compile(self, exe_id: str, blob: bytes) -> dict:
        """Check the archive here, load it on every rank; the COMPILE
        reply's layouts (empty for a one-device program)."""
        shardings = program.check_archive(blob)
        if shardings is not None and shardings["nr_devices"] != self.n:
            raise ValueError(f"executable is sharded over {shardings['nr_devices']} "
                             f"devices but this worker has {self.n}")
        self._each(_rank_load, [(exe_id, blob)] * self.n)
        with self._lock:
            self.exes[exe_id] = shardings
        return self.layouts(exe_id)

    def layouts(self, exe_id: str) -> dict:
        sh = self.exes[exe_id]
        if sh is None:
            return {}
        return {"nr_devices": self.n,
                "arg_layouts": [wire_layout(s, shp, self.n)
                                for s, shp in zip(sh["in_specs"], sh["in_shapes"])],
                "out_layouts": [wire_layout(s, shp, self.n)
                                for s, shp in zip(sh["out_specs"], sh["out_shapes"])]}

    def _args(self, exe_id: str, arg_refs, arg_shards, inline) -> Tuple[list, list]:
        """Each rank's argument descriptors, and the ephemeral shards the
        call consumes.  Raises KeyError for a reference the call cannot
        take."""
        sh = self.exes[exe_id]
        n_args = len(sh["in_shapes"]) if sh else len(arg_refs or inline)
        ranks = range(self.n) if sh else (0,)
        per_rank: List[list] = [[None] * n_args for _ in range(self.n)]
        taken: list = []
        lays = self.layouts(exe_id).get("arg_layouts") or [None] * n_args
        it = iter(inline)
        for i in range(n_args):
            group = arg_shards[i] if arg_shards is not None and i < len(arg_shards) else None
            ref = arg_refs[i] if arg_refs is not None and i < len(arg_refs) else None
            lay = lays[i]
            if group is not None:
                if lay is None or len(group) != len(lay):
                    raise KeyError(f"argument {i}: shard group of {len(group)} does not "
                                   f"match the executable's layout")
                for ent, sid in zip(lay, group):
                    d = ent["device"]
                    if sid is None:
                        per_rank[d][i] = ("host", next(it))
                        continue
                    with self._lock:
                        rec = self.placed.get(sid)
                    if rec is None or d not in rec.ranks:
                        raise KeyError(f"argument {i}: no buffer {sid} on device {d}")
                    if rec.ephemeral:
                        taken.append(sid)
                    per_rank[d][i] = ("take" if rec.ephemeral else "buf", sid)
            elif ref is not None:
                with self._lock:
                    rec = self.placed.get(ref)
                if rec is None:
                    raise KeyError(f"unknown buffer {ref}")
                if sh is not None:
                    self._replicate(ref)
                elif 0 not in rec.ranks:
                    raise KeyError(f"buffer {ref} is on device {min(rec.ranks)}; a "
                                   f"one-device program runs on device 0")
                for r in ranks:
                    per_rank[r][i] = ("buf", ref) if lay is None else \
                        ("slice", ref, lay[r]["slices"])
            else:
                host = next(it)
                for r in ranks:
                    per_rank[r][i] = ("host", host if lay is None else
                                      host[_index(lay[r]["slices"])].contiguous())
        return per_rank, taken

    def execute(self, exe_id: str, arg_refs, arg_shards, inline,
                result_ids: Optional[List[str]]) -> dict:
        """One EXECUTE on the ranks.  Without ``result_ids`` returns
        ``{"results": [global tensor, ...]}`` (sharded results assembled by
        their layout, replicated ones from rank 0); with them the results
        stay resident (a sharded one as a shard a device, ``<id>#<device>``)
        and it returns ``{"refs", "shapes", "dtypes"}``."""
        with self._lock:
            if exe_id not in self.exes:
                raise KeyError(f"unknown executable {exe_id}")
        sh = self.exes[exe_id]
        per_rank, taken = self._args(exe_id, arg_refs, arg_shards, inline)
        out_lays = self.layouts(exe_id).get("out_layouts")
        ranks = list(range(self.n)) if sh else [0]
        try:
            if result_ids is None:
                replies = self._run(exe_id, ranks, per_rank, None)
                return {"results": self._assemble(replies, out_lays, sh)}
            n_out = len(result_ids)
            lays = out_lays or [None] * n_out
            rank_ids = [[rid if lay is None else f"{rid}#{r}"
                         for rid, lay in zip(result_ids, lays)] for r in range(self.n)]
            replies = self._run(exe_id, ranks, per_rank, rank_ids)
            return self._keep(result_ids, lays, replies, ranks)
        finally:
            if taken:
                self._consumed(taken)

    def _run(self, exe_id, ranks, per_rank, rank_ids) -> list:
        if len(ranks) == 1:
            return [self._one(0, _rank_execute, exe_id, per_rank[0],
                              None if rank_ids is None else rank_ids[0])]
        return self._each(_rank_execute, [
            (exe_id, per_rank[r], None if rank_ids is None else rank_ids[r])
            for r in range(self.n)])

    def _consumed(self, taken: list) -> None:
        """Ephemeral shards an EXECUTE took: out of the table, their bytes
        released (the ranks dropped them as they took them)."""
        with self._lock:
            for sid in taken:
                rec = self.placed.pop(sid, None)
                if rec is not None:
                    self._release(rec.nbytes * len(rec.ranks))

    @staticmethod
    def _assemble(replies, out_lays, sh) -> list:
        outs = []
        for j, first in enumerate(replies[0]["results"]):
            lay = out_lays[j] if out_lays else None
            if lay is None:
                outs.append(first)
                continue
            shape = sh["out_shapes"][j]
            full = torch.empty(shape, dtype=first.dtype)
            for ent in lay:
                full[_index(ent["slices"])] = replies[ent["device"]]["results"][j]
            outs.append(full)
        return outs

    def _keep(self, result_ids, lays, replies, ranks) -> dict:
        """Table the results the ranks kept, once their bytes are
        admitted; refused, the ranks drop them and nothing is charged."""
        refs, shapes, dtypes = [], [], []
        kept: Dict[str, Placed] = {}
        for j, (rid, lay) in enumerate(zip(result_ids, lays)):
            local = replies[0]["shapes"][j]
            dtype = replies[0]["dtypes"][j]
            nbytes = _nbytes(local, dtype)
            if lay is None:
                kept[rid] = Placed(set(ranks), tuple(local), dtype, nbytes)
                refs.append(rid)
                shape = local
            else:
                ids = [f"{rid}#{ent['device']}" for ent in lay]
                for ent, sid in zip(lay, ids):
                    kept[sid] = Placed({ent["device"]}, tuple(local), dtype, nbytes)
                refs.append(ids)
                shape = [hi for _, hi in lay[-1]["slices"]]
            shapes.append(list(shape))
            dtypes.append(dtype)
        with self._lock:
            err = self._admit(sum(r.nbytes * len(r.ranks) for r in kept.values()))
            if not err:
                self.placed.update(kept)
        if err:
            for sid, rec in kept.items():
                self._drop(sid, rec, admitted=False)
            raise KeyError(err)
        return {"refs": refs, "shapes": shapes, "dtypes": dtypes}

    def stats(self) -> List[dict]:
        """Each rank's :func:`_rank_stats_impl`."""
        return self._each(_rank_stats, [()] * self.n)


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()
