"""Parameter trees between numpy and the port.

``params_from_numpy`` takes the JAX package's parameter tree with its
leaves as numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and
returns the port's tree of torch tensors on ``device``.  The trees have
the same structure, so this is a copy.  Quantized leaves may come as any
object with ``q``, ``s`` and ``mode`` attributes or as a ``{"q", "s",
"mode"}`` dict, and become ``QuantizedWeight``.  bfloat16 arrays (numpy's
``ml_dtypes`` dtype) cross as a uint16 view of the same bits.

``params_to_numpy`` is the way back: the port's tree (plain tensors, on
any device) as numpy arrays, bf16 again through a uint16 view, as
``ml_dtypes.bfloat16``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .quantize import QuantizedWeight

_QUANT_KEYS = frozenset(("q", "s", "mode"))


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device: DeviceLike = "cuda") -> Any:
    dev = resolve_device(device)

    def quantized(q, s, mode):
        return QuantizedWeight(q=_tensor(q, dev), s=_tensor(s, dev),
                               mode=str(mode))

    def walk(node):
        if isinstance(node, dict):
            if set(node) == _QUANT_KEYS:
                return quantized(node["q"], node["s"], node["mode"])
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        if all(hasattr(node, a) for a in _QUANT_KEYS):
            return quantized(node.q, node.s, node.mode)
        return _tensor(node, dev)

    return walk(tree)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # numpy's bfloat16; imported only for bf16 leaves

        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(tree: Any) -> Any:
    """The port's tree of tensors as the same tree of numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return _array(tree)
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(x) for x in tree)
    return tree
