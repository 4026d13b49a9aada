"""Spawn the ranks of a ``torch.distributed`` job and run functions on them.

JAX's mesh is single-controller: one process drives every device and XLA
inserts the collectives.  The port runs one process per rank, as
PyTorch does, and this module is the plumbing that XLA's runtime was for
the reference: it starts ``world_size`` processes (the ``spawn`` start
method, since CUDA cannot fork), joins them into one process group, and
runs a function on all of them, returning each rank's result in rank
order.

- ``device="cuda"`` places rank r on ``cuda:(r % device_count)``;
  ``device="cpu"`` keeps every rank on the CPU.
- ``backend`` is the caller's, with no default: ``"gloo"`` (CPU tensors, and CUDA
  tensors through the host where ``parallel/collectives.py``'s table says
  so) or ``"nccl"`` (CUDA only, one card a rank: fewer cards than ranks
  raises, as NCCL refuses two ranks on one card).  Nothing switches it.
- The group meets through a ``file://`` store in a fresh temporary
  directory, so concurrent jobs on one machine never share a port.

A function run on the ranks must be importable by name (a module-level
function of a module that imports only torch and the port), and its
arguments and result must pickle; return CPU tensors, numpy arrays or
plain values.  CPU tensors cross through shared memory
(``torch.multiprocessing``), never through a collective.  A rank that
raises fails the whole call: the other ranks are stopped and the call
raises with the rank's traceback.

A group kept open serves as the devices of one process: ``run`` calls a
function on every rank, ``run_each`` with each rank's own arguments,
``call`` on one rank, one call at a time (a lock serialises callers),
and :func:`rank_store` is a rank's dict that outlives its tasks (the
remote worker keeps its shards and loaded programs there).
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

BACKENDS = ("gloo", "nccl")
#: seconds a rank waits in one collective before its group times out
GROUP_TIMEOUT_S = 600.0
#: seconds the other ranks get to report after one rank has failed
FAIL_GRACE_S = 5.0

#: this rank's state between tasks (set in each spawned rank)
_STORE: Optional[Dict[str, Any]] = None


def rank_store() -> Dict[str, Any]:
    """The calling rank's dict that outlives its tasks; raises outside a
    rank of a :class:`RankGroup`."""
    if _STORE is None:
        raise RuntimeError("rank_store() is for functions run on a rank")
    return _STORE


def check_backend(world_size: int, device: str, backend: str) -> torch.device:
    """The rank device type for ``device``; raises for an unknown backend,
    for ``nccl`` off CUDA, and for ``nccl`` with fewer cards than ranks."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")
    if world_size < 1:
        raise ValueError(f"world_size must be at least 1, got {world_size}")
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend='nccl' needs device='cuda'")
        cards = torch.cuda.device_count()
        if cards < world_size:
            raise ValueError(f"backend='nccl' needs one card a rank: {world_size} "
                             f"ranks, {cards} card(s); ask for backend='gloo' to "
                             f"share a card")
    return dev


def _rank_main(rank: int, world_size: int, device: str, backend: str,
               init_method: str, tasks, results) -> None:
    global _STORE
    _STORE = {}
    torch.set_num_threads(1)
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        return
    results.put((rank, "ready", None))
    parent = os.getppid()
    try:
        while True:
            try:
                task = tasks.get(timeout=1.0)
            except queue.Empty:
                if os.getppid() != parent:      # orphaned: the group is gone
                    break
                continue
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, "ok", fn(*args)))
            except BaseException:
                results.put((rank, "error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankGroup:
    """``world_size`` spawned ranks in one process group, kept for many
    ``run`` calls; ``close()`` (or leaving the ``with``) stops them."""

    def __init__(self, world_size: int, *, backend: str, device: str = "cuda",
                 timeout_s: float = GROUP_TIMEOUT_S):
        dev = check_backend(world_size, device, backend)
        self.world_size, self.device, self.backend = world_size, dev.type, backend
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._dir = tempfile.mkdtemp(prefix="tpf-ranks-")
        ctx = torch.multiprocessing.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(world_size)]
        self._results = ctx.Queue()
        init_method = "file://" + os.path.join(self._dir, "store")
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, world_size, dev.type, backend,
                                         init_method, self._tasks[r], self._results))
                       for r in range(world_size)]
        try:
            for p in self._procs:
                p.start()
            self._collect(range(world_size))
        except BaseException:
            self.close()
            raise

    @property
    def pids(self) -> List[int]:
        """The ranks' process ids, in rank order."""
        return [p.pid for p in self._procs]

    def _collect(self, ranks) -> List[Any]:
        """One message from each of ``ranks`` (ready, or a result), by rank
        (None for the others); raises when a rank fails, dies or overruns
        the timeout."""
        procs = self._procs
        out: List[Any] = [None] * self.world_size
        pending = set(ranks)
        deadline = time.monotonic() + self.timeout_s
        errors = {}
        while pending:
            left = deadline - time.monotonic()
            if errors:
                left = min(left, FAIL_GRACE_S)
            try:
                # short waits, so a rank that died is seen at once
                rank, kind, value = self._results.get(timeout=min(max(left, 0.01), 1.0))
            except queue.Empty:
                dead = [r for r in pending if not procs[r].is_alive()]
                if errors or dead or time.monotonic() >= deadline:
                    break
                continue
            pending.discard(rank)
            if kind == "error":
                errors[rank] = value
            else:
                out[rank] = value
        if errors or pending:
            self.close(wait=False)
            detail = "\n".join(f"rank {r}:\n{tb}" for r, tb in sorted(errors.items()))
            raise RuntimeError(f"ranks failed ({sorted(errors)}; no answer from "
                               f"{sorted(pending - set(errors))}):\n{detail}")
        return out

    def run(self, fn: Callable, *args) -> List[Any]:
        """``fn(*args)`` on every rank; the results in rank order."""
        return self.run_each(fn, [args] * self.world_size)

    def run_each(self, fn: Callable, args: Sequence[tuple]) -> List[Any]:
        """``fn(*args[r])`` on each rank r; the results in rank order."""
        if len(args) != self.world_size:
            raise ValueError(f"{len(args)} argument tuples for {self.world_size} ranks")
        with self._lock:
            if not self._procs:
                raise RuntimeError("the rank group is closed")
            for q, a in zip(self._tasks, args):
                q.put((fn, tuple(a)))
            return self._collect(range(self.world_size))

    def call(self, rank: int, fn: Callable, *args) -> Any:
        """``fn(*args)`` on rank ``rank`` alone; its result."""
        if not 0 <= rank < self.world_size:
            raise ValueError(f"no rank {rank} in a group of {self.world_size}")
        with self._lock:
            if not self._procs:
                raise RuntimeError("the rank group is closed")
            self._tasks[rank].put((fn, args))
            return self._collect([rank])[rank]

    def close(self, wait: bool = True) -> None:
        """Stop the ranks: let them leave their group and exit, or (after a
        failure, when some may sit in a collective) terminate them."""
        procs = [p for p in self._procs if p.pid is not None]   # started
        self._procs = []
        if wait:
            for p, q in zip(procs, self._tasks):
                if p.is_alive():
                    q.put(None)
            for p in procs:
                p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def launch(fn: Callable, world_size: int, *args, backend: str, device: str = "cuda",
           timeout_s: Optional[float] = None) -> List[Any]:
    """Spawn ``world_size`` ranks, run ``fn(*args)`` on each, stop them and
    return the results in rank order."""
    with RankGroup(world_size, device=device, backend=backend,
                   timeout_s=timeout_s or GROUP_TIMEOUT_S) as group:
        return group.run(fn, *args)
