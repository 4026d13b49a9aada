"""Flash attention, forward and backward: hand-written Hopper kernels and
their plain PyTorch versions.

Counterpart of ``tensorfusion_tpu/ops/flash_attention.py``.  The TPU
kernel ``_attn_kernel`` becomes ``csrc/flash_attn_fwd.cu``; the backward
pair ``_dq_kernel`` and ``_dkv_kernel`` becomes ``csrc/flash_attn_bwd.cu``
(each file's header says how it is laid out on the GPU).  Inputs are
``[BH, T, D]`` with batch and heads folded, as the TPU kernels take them.

``flash_attention`` dispatches:

- a CUDA tensor   -> the Hopper kernel (built at first use; a failed build
                     or launch raises);
- a CPU tensor    -> the plain version, same math in f32;
- ragged T        -> the chunked blockwise path (ops/chunked_attention.py),
                     with one warning, never dense;
- backend="plain" -> the plain version on any device.

Each kernel is one ``torch.library`` custom op (``tpf_torch::flash_attn_fwd``,
``flash_attn_bwd_dq``, ``flash_attn_bwd_dkv``) with a fake and a registered
FLOP formula, so ``torch.utils.flop_counter`` (and the client runtime's
metering, which counts on fake tensors) sees the work a ctypes kernel
does.  The forward op carries an autograd rule, the counterpart of
``_flash_core``'s custom VJP: it saves q, k, v, out and lse, computes
``delta = rowsum(dO * O)`` in f32, casts dO to q's dtype and launches the
dq and dkv ops.  lse has no gradient.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build

log = logging.getLogger("tpf_torch.ops.flash")

NEG_INF = -1e30

BLOCK_Q = 128

#: warn-once latch for the ragged-T reroute
_warned_ragged = False

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, causal: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: [BH, T, D] -> (out in q's dtype,
    lse [BH, T] f32).  Dense f32 math, as ``_flash_reference`` computes
    it, plus the per-row logsumexp."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
    return out, lse


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor,
                              delta: torch.Tensor, scale: float, causal: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' plain version: [BH, T, D] q, k, v, do and
    [BH, T] f32 lse, delta -> (dq, dk, dv) in q's, k's and v's dtypes.
    Dense f32 math: P = exp(scale·QKᵀ (masked) − lse), dS = P∘(dO·Vᵀ − Δ),
    dQ = scale·dS·K, dK = scale·dSᵀ·Q, dV = Pᵀ·dO."""
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bqd,bkd->bqk", q32, k32) * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do32, v32)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bqk,bkd->bqd", ds, k32) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q32) * scale
    dv = torch.einsum("bqk,bqd->bkd", p, do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _checked(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             *more: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The checks every kernel wrapper makes on its [BH, T, D] operands
    (q, k, v and the extra ones of the backward, all of q's shape and
    dtype); returns them contiguous."""
    if not all(x.is_cuda for x in (q, k, v, *more)):
        raise ValueError(f"{name} needs CUDA tensors")
    if q.dim() != 3 or any(x.shape != q.shape for x in (k, v, *more)):
        raise ValueError(f"{name}: q, k, v{', do' if more else ''} must share one "
                         f"[BH, T, D] shape, got "
                         f"{[tuple(x.shape) for x in (q, k, v, *more)]}")
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in (k, v, *more)):
        raise ValueError(f"{name} takes bf16 or f32, got "
                         f"{[x.dtype for x in (q, k, v, *more)]}")
    if q.shape[2] not in _HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {_HEAD_DIMS}, got {q.shape[2]}")
    out = tuple(x.contiguous() for x in (q, k, v, *more))
    if any(x.data_ptr() % 16 for x in out):
        raise ValueError(f"{name} needs 16-byte aligned inputs")
    return out


def _checked_rows(name: str, q: torch.Tensor, *rows: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """lse and delta: f32 [BH, T] on q's device, contiguous."""
    for x in rows:
        if x.shape != q.shape[:2] or x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"{name}: lse and delta must be f32 {tuple(q.shape[:2])} "
                             f"on {q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    return tuple(x.contiguous() for x in rows)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, causal: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on CUDA tensors [BH, T, D] (bf16 or f32,
    D in 16/32/64/128).  Raises on anything it does not take, and when
    the launch is refused.  ``flash_fwd_cuda.launches`` counts launches."""
    q, k, v = _checked("flash kernel", q, k, v)
    bh, t, d = q.shape
    lib = _library("flash_attn_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.tpf_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, t, d, float(scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype], _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0


def flash_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                      scale: float, causal: bool) -> torch.Tensor:
    """Launch the dQ kernel on CUDA tensors: q, k, v, do [BH, T, D] of one
    dtype (bf16 or f32, D in 16/32/64/128), lse and delta [BH, T] f32.
    Returns dq in q's dtype.  Raises on anything it does not take, and
    when the launch is refused.  ``flash_bwd_dq_cuda.launches`` counts
    launches."""
    q, k, v, do = _checked("flash dq kernel", q, k, v, do)
    lse, delta = _checked_rows("flash dq kernel", q, lse, delta)
    bh, t, d = q.shape
    lib = _library("flash_attn_bwd")
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.tpf_flash_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, t, d,
            float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
            _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_dq launch failed: CUDA error {err}")
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                       scale: float, causal: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel; the same inputs and checks as
    ``flash_bwd_dq_cuda``.  Returns (dk, dv) in k's and v's dtype.
    ``flash_bwd_dkv_cuda.launches`` counts launches."""
    q, k, v, do = _checked("flash dkv kernel", q, k, v, do)
    lse, delta = _checked_rows("flash dkv kernel", q, lse, delta)
    bh, t, d = q.shape
    lib = _library("flash_attn_bwd")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.tpf_flash_attn_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, t, d, float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
            _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_dkv launch failed: CUDA error {err}")
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0

# ctypes argument types per C entry point: every pointer and the stream as
# c_void_p, or ctypes cuts them to 32-bit ints
_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "tpf_flash_attn_fwd": [_VP] * 5 + [_CI] * 3 + [_CF, _CI, _CI, _VP],
    "tpf_flash_attn_bwd_dq": [_VP] * 7 + [_CI] * 3 + [_CF, _CI, _CI, _VP],
    "tpf_flash_attn_bwd_dkv": [_VP] * 8 + [_CI] * 3 + [_CF, _CI, _CI, _VP],
    "tpf_flash_attn_fwd_smem": [_CI],
    "tpf_flash_attn_bwd_smem": [_CI, _CI],
    "tpf_tensor_map_encode_ns": [_VP] + [_CI] * 4,
}


def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    for fn_name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, fn_name, None)
        if fn is not None and fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = _CI
    return lib


@torch.library.custom_op("tpf_torch::flash_attn_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, scale, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal)
    raise ValueError(f"flash_attn_fwd: no implementation for {q.device}")


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, scale, causal):
    return (torch.empty_like(q),
            q.new_empty((q.shape[0], q.shape[1]), dtype=torch.float32))


@register_flop_formula(torch.ops.tpf_torch.flash_attn_fwd)
def _flash_fwd_flops(q_shape, k_shape, v_shape, scale, causal, *args,
                     out_shape=None, **kwargs) -> int:
    """Q Kᵀ and P V, 2·BH·T²·D each."""
    return _attn_flops(4, q_shape, causal)


@torch.library.custom_op("tpf_torch::flash_attn_bwd_dq", mutates_args=())
def _flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                     scale: float, causal: bool) -> torch.Tensor:
    if q.device.type == "cuda":
        return flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, scale, causal)[0]
    raise ValueError(f"flash_attn_bwd_dq: no implementation for {q.device}")


@_flash_bwd_dq_op.register_fake
def _flash_bwd_dq_fake(q, k, v, do, lse, delta, scale, causal):
    return torch.empty_like(q)


@torch.library.custom_op("tpf_torch::flash_attn_bwd_dkv", mutates_args=())
def _flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                      scale: float, causal: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cuda":
        return flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal)
    if q.device.type == "cpu":
        _, dk, dv = flash_attention_bwd_plain(q, k, v, do, lse, delta, scale, causal)
        return dk, dv
    raise ValueError(f"flash_attn_bwd_dkv: no implementation for {q.device}")


@_flash_bwd_dkv_op.register_fake
def _flash_bwd_dkv_fake(q, k, v, do, lse, delta, scale, causal):
    return torch.empty_like(k), torch.empty_like(v)


def _attn_flops(per_pair: int, q_shape, causal: bool) -> int:
    """``per_pair``·D FLOPs for each of the BH·T² query-key pairs; the
    causal kernels skip half."""
    bh, t, d = q_shape
    flops = per_pair * bh * t * t * d
    return flops // 2 if causal else flops


@register_flop_formula(torch.ops.tpf_torch.flash_attn_bwd_dq)
def _flash_bwd_dq_flops(q_shape, k_shape, v_shape, do_shape, lse_shape,
                        delta_shape, scale, causal, *args, out_shape=None,
                        **kwargs) -> int:
    """Q Kᵀ, dO Vᵀ and dS K, 2·BH·T²·D each."""
    return _attn_flops(6, q_shape, causal)


@register_flop_formula(torch.ops.tpf_torch.flash_attn_bwd_dkv)
def _flash_bwd_dkv_flops(q_shape, k_shape, v_shape, do_shape, lse_shape,
                         delta_shape, scale, causal, *args, out_shape=None,
                         **kwargs) -> int:
    """Q Kᵀ, dO Vᵀ, Pᵀ dO and dSᵀ Q, 2·BH·T²·D each."""
    return _attn_flops(8, q_shape, causal)


def _flash_fwd_setup_context(ctx, inputs, output):
    q, k, v, scale, causal = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.scale, ctx.causal = scale, causal
    ctx.mark_non_differentiable(lse)


def _flash_fwd_backward(ctx, dout, _dlse):
    """``_flash_core_bwd``: Δ = rowsum(dO·O) in f32 and dO cast to q's
    dtype outside the kernels, then the dq and dkv kernels."""
    q, k, v, out, lse = ctx.saved_tensors
    delta = (dout.float() * out.float()).sum(dim=-1)
    do = dout.to(q.dtype)
    dq = torch.ops.tpf_torch.flash_attn_bwd_dq(q, k, v, do, lse, delta,
                                               ctx.scale, ctx.causal)
    dk, dv = torch.ops.tpf_torch.flash_attn_bwd_dkv(q, k, v, do, lse, delta,
                                                    ctx.scale, ctx.causal)
    return dq, dk, dv, None, None


_flash_fwd_op.register_autograd(_flash_fwd_backward,
                                setup_context=_flash_fwd_setup_context)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``_flash_fwd_pallas``: [BH, T, D] -> (out [BH, T, D]
    in q's dtype, lse [BH, T] f32).  The kernel for CUDA tensors, the
    plain version for CPU tensors."""
    return torch.ops.tpf_torch.flash_attn_fwd(q, k, v, float(scale),
                                              bool(causal))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    backend: Optional[str] = None) -> torch.Tensor:
    """q/k/v: [B, H, T, D] or [BH, T, D]; returns the attention output in
    the input layout.  backend: None (the kernel on CUDA, the plain
    version on CPU) | "cuda" | "plain"."""
    if backend not in (None, "cuda", "plain"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "cuda" and not q.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; got "
                         f"{q.device}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # The TPU kernel needs T to tile evenly into equal q/k blocks; other
    # lengths take the chunked path at the same block size, which pads
    # internally and never materializes [T, T].
    t = q.shape[-2]
    if backend != "plain" and t % min(BLOCK_Q, t) != 0:
        global _warned_ragged
        if not _warned_ragged:
            _warned_ragged = True
            log.warning(
                "flash_attention: T=%d does not tile into %d-row blocks; "
                "routing to the chunked blockwise path (pads internally). "
                "Pad sequences to a multiple of %d to use the kernel "
                "directly.", t, min(BLOCK_Q, t), BLOCK_Q)
        from .chunked_attention import chunked_attention
        if q.dim() == 4:
            return chunked_attention(q, k, v, causal=causal, scale=scale,
                                     block=BLOCK_Q)
        return chunked_attention(q[:, None], k[:, None], v[:, None],
                                 causal=causal, scale=scale,
                                 block=BLOCK_Q)[:, 0]

    four_d = q.dim() == 4
    if four_d:
        b, h, t, d = q.shape
        q, k, v = (x.reshape(b * h, t, d) for x in (q, k, v))
    if backend == "plain":
        out, _ = flash_attention_plain(q, k, v, scale, causal)
    else:
        out, _ = flash_attention_fwd(q, k, v, scale, causal)
    if four_d:
        out = out.reshape(b, h, t, d)
    return out
