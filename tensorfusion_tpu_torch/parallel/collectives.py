"""Collectives of the port's parallel layer, plain and differentiable.

Under ``shard_map`` the reference names collectives (``ppermute``,
``psum``) and leaves the rest to XLA's partitioner, which also
differentiates them.  The port runs one process a rank, so every
exchange is explicit, and the ones on a gradient path are
``torch.autograd.Function``s in Megatron's pairs (a plain
``dist.all_reduce`` has no gradient, and a missing pair gives wrong
gradients silently):

- ``copy_to``      identity forward,   all-reduce backward;
- ``reduce_from``  all-reduce forward, identity backward;
- ``gather_from``  all-gather forward, split backward (the consumer is
  replicated over the axis, so each rank already holds the whole
  gradient);
- ``scatter_to``   split forward,      all-gather backward;
- ``gather_rs``    all-gather forward, reduce-scatter backward (FSDP: each
  rank's gradient is a partial sum of its own data);
- ``shift``        send to the next rank, receive from the previous one
  (optionally without wraparound); backward shifts the other way;
- ``all_to_all``   backward is the inverse all-to-all.

Each takes ``(mesh, axes)``: one axis name or a tuple of them, major
first, as a spec entry names them; an axis of size 1 costs nothing.

Host staging.  gloo moves CUDA tensors only for some operations
(``python -m tensorfusion_tpu_torch.parallel.probe`` on the card;
``PERF.md`` holds its table).  ``HOST_STAGED`` lists, per backend, the
operations that copy a CUDA tensor to pinned host memory, run there and
copy back; the rule is fixed by backend and operation and never chosen
by catching an error.  Staged bytes say nothing about NVLink.

``STATS`` counts, per process, the operations, the bytes each rank sends
into them, the host-staged bytes and the host seconds spent inside them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .mesh import axis_index, axis_size, spec_axes

#: backend -> operations whose CUDA tensors go through pinned host memory.
#: gloo on torch 2.11 with CUDA tensors (the probe on an H100): all-reduce,
#: all-gather, reduce-scatter, all-to-all and broadcast work; send / recv
#: and batch_isend_irecv crash the ranks (gloo writes from the device
#: pointer), so the ring shift goes through the host
HOST_STAGED = {
    "gloo": frozenset({"shift"}),
    "nccl": frozenset(),
}

Axes = Union[str, Sequence[str], None]


@dataclasses.dataclass
class CommStats:
    ops: int = 0
    bytes: int = 0
    staged_bytes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.ops, self.bytes, self.staged_bytes, self.seconds = 0, 0, 0, 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


STATS = CommStats()


class _Timed:
    """Counts one operation on ``t`` in ``STATS``; ``staged`` says whether
    it goes through the host (then its bytes count as staged too)."""

    def __init__(self, op: str, t: torch.Tensor, group):
        self.staged = t.is_cuda and op in HOST_STAGED[dist.get_backend(group)]
        self.nbytes = t.numel() * t.element_size()

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        STATS.ops += 1
        STATS.bytes += self.nbytes
        STATS.staged_bytes += self.nbytes if self.staged else 0
        STATS.seconds += time.perf_counter() - self.t0


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


@contextlib.contextmanager
def _renamed():
    """Quiet torch 2.13's notice that the ``*_tensor`` collectives are now
    ``*_single``; torch 2.11 (the card's) has only the old names."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield


def _size(group) -> int:
    return dist.get_world_size(group)


# -- plain collectives on one process group ------------------------------------


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum (or max) of ``t`` over the group, as a new tensor.  gloo has no
    AVG: callers sum and divide."""
    if _size(group) == 1:
        return t
    out = t.contiguous().clone()
    with _Timed("all_reduce", out, group):
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=group)
    return out


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in group-rank order."""
    n = _size(group)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    with _Timed("all_gather", src, group) as op:
        work = _host(src) if op.staged else src
        out = work.new_empty((n * src.shape[0], *src.shape[1:]))
        with _renamed():
            dist.all_gather_into_tensor(out, work, group=group)
        out = out.to(t.device)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group-wide sum of ``t``, this rank's chunk along ``dim``."""
    n = _size(group)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split into {n}")
    src = t.movedim(dim, 0).contiguous()
    with _Timed("reduce_scatter", src, group) as op:
        work = _host(src) if op.staged else src
        out = work.new_empty((src.shape[0] // n, *src.shape[1:]))
        with _renamed():
            dist.reduce_scatter_tensor(out, work, group=group)
        out = out.to(t.device)
    return out.movedim(0, dim)


def _all_to_all(t: torch.Tensor, group, split_dim: int, cat_dim: int) -> torch.Tensor:
    """Split ``t`` into group-size chunks along ``split_dim``, send chunk
    i to group rank i, and concatenate what arrives along ``cat_dim``."""
    n = _size(group)
    if n == 1:
        return t
    if t.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {t.shape[split_dim]} does not "
                         f"split into {n}")
    src = t.movedim(split_dim, 0).contiguous()
    with _Timed("all_to_all", src, group) as op:
        work = _host(src) if op.staged else src
        out = torch.empty_like(work)
        dist.all_to_all_single(out, work, group=group)
        out = out.to(t.device)
    # out[i] is rank i's chunk meant for us: put the chunks along cat_dim
    chunks = out.movedim(0, split_dim).chunk(n, dim=split_dim)
    return torch.cat(chunks, dim=cat_dim)


def shift(t: torch.Tensor, group, offset: int = 1, wrap: bool = True) -> torch.Tensor:
    """Send ``t`` to group rank ``r + offset`` and return what group rank
    ``r - offset`` sent.  Without ``wrap`` nothing crosses the ends: the
    first ranks receive zeros, the last ones send nothing."""
    n = _size(group)
    if wrap and offset % n == 0:
        return t
    r = dist.get_group_rank(group, dist.get_rank())
    dst, src = r + offset, r - offset
    if wrap:
        dst, src = dst % n, src % n
    send_to = dst if 0 <= dst < n else None
    recv_from = src if 0 <= src < n else None
    payload = t.contiguous()
    with _Timed("shift", payload, group) as op:
        work = _host(payload) if op.staged else payload
        got = torch.zeros_like(work)
        ops = []
        if send_to is not None:
            ops.append(dist.P2POp(dist.isend, work, dist.get_global_rank(group, send_to),
                                  group=group))
        if recv_from is not None:
            ops.append(dist.P2POp(dist.irecv, got, dist.get_global_rank(group, recv_from),
                                  group=group))
        for w in dist.batch_isend_irecv(ops) if ops else ():
            w.wait()
        got = got.to(t.device)
    return got


# -- over mesh axes ---------------------------------------------------------------


def _axes(mesh, axes: Axes) -> Tuple[str, ...]:
    """The named axes of size > 1, major first."""
    names = spec_axes(tuple(axes) if isinstance(axes, list) else axes)
    return tuple(a for a in names if axis_size(mesh, a) > 1)


def _groups(mesh, axes: Axes):
    return [mesh.get_group(a) for a in _axes(mesh, axes)]


def all_reduce_axes(t: torch.Tensor, mesh, axes: Axes, op: str = "sum") -> torch.Tensor:
    for g in _groups(mesh, axes):
        t = all_reduce(t, g, op)
    return t


def all_gather_axes(t, mesh, axes, dim):
    # innermost axis first, so the chunks land major-first
    for g in reversed(_groups(mesh, axes)):
        t = all_gather(t, g, dim)
    return t


def _split_axes(t, mesh, axes, dim):
    for a in _axes(mesh, axes):
        n = axis_size(mesh, a)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split "
                             f"over {a}={n}")
        t = t.chunk(n, dim=dim)[axis_index(mesh, a)]
    return t


def _reduce_scatter_axes(t, mesh, axes, dim):
    # the transpose of _gather_axes: outermost axis first
    for g in _groups(mesh, axes):
        t = reduce_scatter(t, g, dim)
    return t


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_axes(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_axes(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather_axes(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _split_axes(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _split_axes(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_axes(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _GatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather_axes(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_axes(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset, wrap):
        ctx.group, ctx.offset, ctx.wrap = group, offset, wrap
        return shift(x, group, offset, wrap)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.group, -ctx.offset, ctx.wrap), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.group, ctx.split_dim, ctx.cat_dim = group, split_dim, cat_dim
        return _all_to_all(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.cat_dim, ctx.split_dim), None, None, None


def _differentiable(fn, x, mesh, axes, *more):
    if mesh is None or not _axes(mesh, axes):
        return x
    return fn.apply(x, mesh, axes, *more)


def copy_to(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    return _differentiable(_CopyTo, x, mesh, axes)


def reduce_from(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    return _differentiable(_ReduceFrom, x, mesh, axes)


def gather_from(x: torch.Tensor, mesh, axes: Axes, dim: int) -> torch.Tensor:
    return _differentiable(_GatherFrom, x, mesh, axes, dim)


def scatter_to(x: torch.Tensor, mesh, axes: Axes, dim: int) -> torch.Tensor:
    return _differentiable(_ScatterTo, x, mesh, axes, dim)


def gather_rs(x: torch.Tensor, mesh, axes: Axes, dim: int) -> torch.Tensor:
    return _differentiable(_GatherRS, x, mesh, axes, dim)


def shift_along(x: torch.Tensor, mesh, axis: str, offset: int = 1,
                wrap: bool = True) -> torch.Tensor:
    """``shift`` over the mesh axis ``axis``, differentiable."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return x if wrap or offset == 0 else torch.zeros_like(x)
    return _Shift.apply(x, mesh.get_group(axis), offset, wrap)


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               cat_dim: int) -> torch.Tensor:
    """``_all_to_all`` over the mesh axis ``axis``, differentiable."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return x
    return _AllToAll.apply(x, mesh.get_group(axis), split_dim, cat_dim)
