"""Mesh parallelism on ``torch.distributed``: sharding recipes, ring
attention and a pipeline, one process a rank.

Counterpart of ``tensorfusion_tpu/parallel``, the workload layer that lets
the platform be exercised with realistic SPMD jobs: DP/FSDP/TP shardings
over a ``DeviceMesh`` and ring attention for sequence parallelism.  Where
the reference's mesh is one process over many devices and GSPMD inserts
the collectives, the port spawns one process a rank (``launch.py``) and
exchanges explicitly (``collectives.py``).
"""

from .launch import RankGroup, launch
from .mesh import (AXIS_ORDER, batch_spec, logical_mesh, make_mesh,
                   mesh_shape_for, named_sharding)
from .pipeline import pipeline_apply, pipeline_stages
from .ring_attention import ring_attention, ring_attention_sharded

__all__ = ["AXIS_ORDER", "RankGroup", "batch_spec", "launch", "logical_mesh",
           "make_mesh", "mesh_shape_for", "named_sharding", "pipeline_apply",
           "pipeline_stages", "ring_attention", "ring_attention_sharded"]
