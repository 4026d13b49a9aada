"""Attention ops of the port, and the registry of its hand-written kernels."""

from __future__ import annotations

import dataclasses
from typing import Callable, List

from .chunked_attention import chunked_attention
from .flash_attention import (flash_attention, flash_attention_bwd_plain,
                              flash_attention_fwd, flash_attention_plain,
                              flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
                              flash_fwd_cuda)

__all__ = ["KERNELS", "Kernel", "chunked_attention", "flash_attention",
           "flash_attention_bwd_plain", "flash_attention_fwd",
           "flash_attention_plain", "flash_bwd_dkv_cuda", "flash_bwd_dq_cuda",
           "flash_fwd_cuda", "launch_counts", "reset_launch_counts"]


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One hand-written kernel: its wrapper (which counts its launches in
    ``wrapper.launches``), its source and the TPU kernel it replaces."""

    name: str
    route: str            # "cuda" | "triton"
    source: str           # path in the repository
    replaces: str         # file:line of the Pallas kernel
    wrapper: Callable


KERNELS: List[Kernel] = [
    Kernel(name="flash_attn_fwd", route="cuda",
           source="tensorfusion_tpu_torch/ops/csrc/flash_attn_fwd.cu",
           replaces="tensorfusion_tpu/ops/flash_attention.py:60",
           wrapper=flash_fwd_cuda),
    Kernel(name="flash_attn_bwd_dq", route="cuda",
           source="tensorfusion_tpu_torch/ops/csrc/flash_attn_bwd.cu",
           replaces="tensorfusion_tpu/ops/flash_attention.py:158",
           wrapper=flash_bwd_dq_cuda),
    Kernel(name="flash_attn_bwd_dkv", route="cuda",
           source="tensorfusion_tpu_torch/ops/csrc/flash_attn_bwd.cu",
           replaces="tensorfusion_tpu/ops/flash_attention.py:202",
           wrapper=flash_bwd_dkv_cuda),
]


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.wrapper.launches = 0


def launch_counts() -> dict:
    return {k.name: k.wrapper.launches for k in KERNELS}
