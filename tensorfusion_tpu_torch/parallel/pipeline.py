"""Pipeline parallelism over a ``pp`` mesh axis.

Counterpart of ``tensorfusion_tpu/parallel/pipeline.py``: GPipe-style
microbatch pipelining.  Each pp rank holds one stage's parameters; a
batch of M microbatches drains through P stages in M + P - 1 ticks, so
the bubble is (P-1)/(M+P-1) of the schedule.  At tick t rank 0 feeds
microbatch t, every stage passes its result to the next one (no
wraparound: the last stage sends nothing, rank 0 receives nothing), and
the last stage collects microbatch t - (P-1).

The reference runs every stage at every tick and masks what is not a
microbatch (one static program); the port runs a stage only at the
ticks where it holds one, which gives the same outputs.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from .collectives import reduce_from, shift_along
from .mesh import axis_index, axis_size


def pipeline_stages(stage_fn: Callable, params, x: torch.Tensor, mesh,
                    axis_name: str = "pp") -> torch.Tensor:
    """Rank-local body: drain the microbatches ``x`` [M, ...] (the same on
    every rank; only rank 0 reads them) through the pipeline with this
    rank's stage ``params``.  ``stage_fn(params, mb)`` keeps ``mb``'s shape.
    Returns [M, ...] outputs, valid on the last rank (zeros elsewhere)."""
    n = axis_size(mesh, axis_name)
    rank = axis_index(mesh, axis_name)
    m = x.shape[0]
    outs = [torch.zeros_like(x[0]) for _ in range(m)]
    state = torch.zeros_like(x[0])
    for t in range(m + n - 1):
        mb = t - rank                    # the microbatch at this stage now
        if 0 <= mb < m:
            y = stage_fn(params, x[mb] if rank == 0 else state)
            if rank == n - 1:
                outs[mb] = y
        else:
            y = torch.zeros_like(state)
        if t < m + n - 2:                # the last tick's results stay put
            state = shift_along(y, mesh, axis_name, 1, wrap=False)
    return torch.stack(outs)


def _stage(leaf, rank: int):
    """This rank's stage of a stacked leaf: a ``DTensor`` sharded over the
    stage axis holds it locally, a whole tensor is indexed."""
    if isinstance(leaf, DTensor):
        return leaf.to_local()[0]
    return leaf[rank]


def pipeline_apply(stage_fn: Callable, stacked_params, x: torch.Tensor, mesh,
                   axis_name: str = "pp") -> torch.Tensor:
    """Whole-array entry: run ``stage_fn`` as a P-stage pipeline.
    ``stacked_params``: a tree whose leaves have a leading stage axis of
    size P (= the mesh's ``axis_name``), whole or as ``DTensor``s sharded
    one stage a rank; ``x``: [M, ...] microbatches.  Returns [M, ...]
    outputs on every rank (the last stage's, summed over the axis as the
    reference's ``psum`` does: the other ranks add zeros)."""
    rank = axis_index(mesh, axis_name)
    params = torch.utils._pytree.tree_map(lambda a: _stage(a, rank), stacked_params)
    outs = pipeline_stages(stage_fn, params, x, mesh, axis_name)
    return reduce_from(outs, mesh, axis_name)
