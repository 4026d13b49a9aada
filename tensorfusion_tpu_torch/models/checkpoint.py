"""Training checkpoint save/restore for hosted workloads.

Counterpart of ``tensorfusion_tpu/models/checkpoint.py`` (orbax) on
``torch.distributed.checkpoint``.  A checkpoint carries the parameter
and optimizer trees and the step counter; every rank writes only its own
shards, and a restore onto a sharded target reads back into the target's
placements (so a gang member the platform reschedules rejoins from the
last complete step, on the same or another layout).

Layout: ``<directory>/<step>/`` holds the DCP files of the flattened
tree (keys are the leaves' paths, ``params/layers/0/attn/wq``) and
``tree.json``, the tree's shape and ``extra``.  Rank 0 writes
``tree.json`` after every rank has written its shards, so a step without
it is incomplete and ``latest_step`` skips it.  Works in one process too
(no process group).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from .quantize import QuantizedWeight, is_quantized

log = logging.getLogger("tpf_torch.models.checkpoint")

TREE_FILE = "tree.json"


def _flatten(tree: Any, prefix: str = "") -> Tuple[Dict[str, torch.Tensor], Any]:
    """({path: tensor}, the tree's shape as JSON: dicts and lists as they
    are, a tensor as "T", a quantized weight as ["Q", mode])."""
    if isinstance(tree, dict):
        flat, shape = {}, {}
        for k, v in tree.items():
            f, shape[k] = _flatten(v, f"{prefix}{k}/")
            flat.update(f)
        return flat, shape
    if isinstance(tree, (list, tuple)):
        flat, shape = {}, []
        for i, v in enumerate(tree):
            f, s = _flatten(v, f"{prefix}{i}/")
            flat.update(f)
            shape.append(s)
        return flat, shape
    if is_quantized(tree):
        return {f"{prefix}q": tree.q, f"{prefix}s": tree.s}, ["Q", tree.mode]
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"checkpoint leaves are tensors, got {type(tree).__name__} "
                        f"at {prefix!r}")
    return {prefix.rstrip("/"): tree}, "T"


def _unflatten(shape: Any, flat: Dict[str, torch.Tensor], prefix: str = "") -> Any:
    if shape == "T":
        return flat[prefix.rstrip("/")]
    if isinstance(shape, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/") for k, v in shape.items()}
    if shape and shape[0] == "Q" and len(shape) == 2 and isinstance(shape[1], str):
        return QuantizedWeight(q=flat[f"{prefix}q"], s=flat[f"{prefix}s"], mode=shape[1])
    return [_unflatten(v, flat, f"{prefix}{i}/") for i, v in enumerate(shape)]


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank0() -> bool:
    return not _distributed() or dist.get_rank() == 0


def _barrier() -> None:
    if _distributed():
        dist.barrier()


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        # absolute, as the reference's (orbax needs it; here it keeps every
        # rank on one path whatever its working directory)
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _steps(self) -> List[int]:
        """The complete steps on disk, oldest first."""
        steps = [int(n) for n in os.listdir(self.directory) if n.isdigit()
                 and os.path.exists(os.path.join(self.directory, n, TREE_FILE))]
        return sorted(steps)

    def save(self, step: int, params: Dict, opt_state: Any = None,
             extra: Optional[Dict] = None) -> None:
        """Write ``params`` (and ``opt_state``, and ``extra``, a JSON-able
        dict) as ``step``; on every rank of the group together.  Only
        ``max_to_keep`` steps stay on disk."""
        state = {"params": params}
        if opt_state is not None:
            state["opt_state"] = opt_state
        flat, shape = _flatten(state)
        path = self._step_dir(step)
        dcp.save(flat, checkpoint_id=path)
        _barrier()
        if _rank0():
            tmp = os.path.join(path, TREE_FILE + ".tmp")
            with open(tmp, "w") as f:
                json.dump({"tree": shape, "extra": extra}, f)
            os.replace(tmp, os.path.join(path, TREE_FILE))
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        _barrier()

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                target: Optional[Dict] = None) -> Dict:
        """Restore ``step`` (default: the latest) as ``{"params": ...,
        "opt_state": ..., "extra": ...}``.  With ``target`` (a tree of that
        form), each rank reads its shards into the target's tensors in
        place, in their placements, and the target comes back; without
        one, whole tensors on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        path = self._step_dir(step)
        with open(os.path.join(path, TREE_FILE)) as f:
            meta = json.load(f)
        if target is not None:
            out = {k: v for k, v in target.items() if k != "extra"}
            flat, _ = _flatten(out)
        else:
            md = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
            flat = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                    for k, m in md.items()}
            out = None
        dcp.load(flat, checkpoint_id=path)
        if out is None:
            out = _unflatten(meta["tree"], flat)
        if meta["extra"] is not None:
            out["extra"] = meta["extra"]
        return out

    def close(self) -> None:
        """Nothing stays open between calls; kept for the reference's API."""
