"""Device-mesh construction and sharding helpers on ``torch.distributed``.

Counterpart of ``tensorfusion_tpu/parallel/mesh.py``, with the same axes:

- ``dp``   — pure data parallelism (gradients all-reduced);
- ``fsdp`` — fully-sharded data parallelism (parameters sharded,
  all-gathered a layer at a time, gradients reduce-scattered);
- ``tp``   — tensor parallelism (attention heads / FFN hidden sharded);
- ``sp``   — sequence parallelism (ring attention neighbours);
- ``ep``   — expert parallelism (MoE experts sharded);
- ``pp``   — pipeline parallelism (one stage per rank).

Where the reference's ``Mesh`` is one process over many devices, the
port's is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the initialised process group (one process a rank,
``parallel/launch.py``).  ``make_mesh`` keeps size-1 dims, so every spec
can name every axis.  Passing any axis outside the default dp/fsdp/sp/tp
order switches to an explicit layout: the axes dict, in insertion order,
is the mesh shape.  A spec is a tuple with one entry per tensor dim:
``None``, an axis name or a tuple of axis names (the reference's
``PartitionSpec``); ``placements`` turns it into ``DTensor`` placements.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard

AXIS_ORDER = ("dp", "fsdp", "sp", "tp")

#: one entry per tensor dim: unsharded, one axis, or several (major first)
SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]


def mesh_shape_for(n_devices: int,
                   want: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """Choose a mesh shape: honor explicit axis sizes, spread the rest
    over fsdp."""
    shape = {a: 1 for a in AXIS_ORDER}
    if want:
        for a, s in want.items():
            if a not in shape:
                raise ValueError(f"unknown mesh axis {a!r}")
            shape[a] = s
    used = math.prod(shape.values())
    if n_devices % used != 0:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"requested axes {want}")
    shape["fsdp"] *= n_devices // used
    return shape


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[int]] = None,
              device: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` over ``devices`` (ranks of the initialised group;
    default all of them), laid out as the reference lays out its devices.
    ``device`` is the ranks' device type, "cuda" or "cpu"."""
    if devices is None:
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs an initialised process group "
                               "(parallel/launch.py) or explicit devices")
        devices = range(dist.get_world_size())
    ranks = list(devices)
    if axes and any(a not in AXIS_ORDER for a in axes):
        # explicit layout: axes in insertion order are the mesh shape
        names = tuple(axes)
        dims = [axes[a] for a in names]
        if math.prod(dims) != len(ranks):
            raise ValueError(f"axes {axes} need {math.prod(dims)} devices,"
                             f" have {len(ranks)}")
    else:
        shape = mesh_shape_for(len(ranks), axes)
        names, dims = AXIS_ORDER, [shape[a] for a in AXIS_ORDER]
    return DeviceMesh(device, torch.tensor(ranks).reshape(dims),
                      mesh_dim_names=names)


def logical_mesh(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    """Size of axis ``name``; 1 for an axis the mesh lacks or no mesh."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.mesh.shape[mesh.mesh_dim_names.index(name)]


def axis_index(mesh: Optional[DeviceMesh], name: str) -> int:
    """This rank's coordinate along ``name`` (0 where the axis is absent)."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_local_rank(name)


def spec_axes(entry: SpecEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def prune_spec(mesh: DeviceMesh, spec: Spec) -> Spec:
    """``spec`` without the axes the mesh does not have."""
    names = set(mesh.mesh_dim_names)
    out = []
    for entry in spec:
        kept = tuple(a for a in spec_axes(entry) if a in names)
        out.append(None if not kept else kept[0] if len(kept) == 1 else kept)
    return tuple(out)


def placements(mesh: DeviceMesh, spec: Spec) -> List[Placement]:
    """The ``DTensor`` placements of ``spec`` on ``mesh`` (the counterpart
    of ``named_sharding``): ``Shard(d)`` on each mesh dim that a spec
    entry of tensor dim ``d`` names, ``Replicate()`` on the rest.  Several
    mesh dims on one tensor dim shard it in mesh order, as a
    ``PartitionSpec`` tuple does when its axes follow mesh order."""
    out: List[Placement] = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        missing = [a for a in spec_axes(entry) if a not in mesh.mesh_dim_names]
        if missing:
            raise ValueError(f"spec {spec} names axes {missing}, not in mesh "
                             f"{mesh.mesh_dim_names}")
        dims = [mesh.mesh_dim_names.index(a) for a in spec_axes(entry)]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} must follow mesh order "
                             f"{mesh.mesh_dim_names}")
        for i in dims:
            out[i] = Shard(d)
    return out


def named_sharding(mesh: DeviceMesh, *spec: SpecEntry) -> List[Placement]:
    return placements(mesh, tuple(spec))


def batch_spec() -> Spec:
    """Batch dims shard over both data axes."""
    return (("dp", "fsdp"),)


def shard_index(mesh: Optional[DeviceMesh], entry: SpecEntry) -> Tuple[int, int]:
    """(this rank's chunk, the number of chunks) of a tensor dim sharded
    over ``entry``'s axes, major first."""
    index, count = 0, 1
    for a in spec_axes(entry):
        n = axis_size(mesh, a)
        index, count = index * n + axis_index(mesh, a), count * n
    return index, count


def local_shard(x: torch.Tensor, mesh: Optional[DeviceMesh], spec: Spec
                ) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec`` (a view;
    every sharded dim must divide evenly)."""
    for d, entry in enumerate(spec):
        index, count = shard_index(mesh, entry)
        if count == 1:
            continue
        if x.shape[d] % count:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split "
                             f"into {count} shards ({entry})")
        x = x.narrow(d, index * (x.shape[d] // count), x.shape[d] // count)
    return x
