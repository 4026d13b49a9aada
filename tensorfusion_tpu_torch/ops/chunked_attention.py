"""Chunked (blockwise) causal attention: exact attention one block pair at
a time with an online softmax, so memory stays O(block^2) per pair and
never [T, T], in the forward and in the backward.

Counterpart of ``tensorfusion_tpu/ops/chunked_attention.py``
(``chunked_attention``, ``_attn_fwd_blocks`` and the custom VJP
``_attn_core``).  The reference is plain JAX that XLA compiled, not a
Pallas kernel, so plain torch is its port.  Autograd through the Python
loop would keep every block's probabilities; instead a
``torch.autograd.Function`` saves only q, k, v, out and the per-row
logsumexp, and its backward recomputes each block's probabilities in two
blockwise passes (dq; dk and dv), as the reference's custom VJP does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .flash_attention import NEG_INF

__all__ = ["chunked_attention"]


def _block(x: torch.Tensor, i: int, block: int) -> torch.Tensor:
    """Block ``i`` along T of a [B, H, T, ...] tensor."""
    return x[:, :, i * block:(i + 1) * block]


def _scores(qblk, kblk, qi: int, ki: int, causal: bool, scale: float,
            block: int, valid_len: int, t: int) -> torch.Tensor:
    """Masked f32 scores [B, H, block, block] of one block pair."""
    s = torch.einsum("bhqd,bhkd->bhqk", qblk.float(), kblk.float()) * scale
    pos = torch.arange(block, device=qblk.device)
    if causal:
        visible = (qi * block + pos)[:, None] >= (ki * block + pos)[None, :]
        s = s.masked_fill(~visible, NEG_INF)
    elif valid_len < t:
        # padded keys of a non-causal call (causal masking already
        # excludes end-padding)
        s = s.masked_fill((ki * block + pos) >= valid_len, NEG_INF)
    return s


def _attn_fwd_blocks(q, k, v, causal: bool, scale: float, block: int,
                     valid_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inputs [B, H, T, D] padded to a block multiple.  Returns (out in
    q's dtype, lse [B, H, T] f32)."""
    b, h, t, d = q.shape
    nb = t // block
    outs, lses = [], []
    for qi in range(nb):
        qblk = _block(q, qi, block)
        m = torch.full((b, h, block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, block), dtype=torch.float32, device=q.device)
        o = torch.zeros((b, h, block, d), dtype=torch.float32, device=q.device)
        # causal: strictly-future key blocks cost nothing
        for ki in range(qi + 1 if causal else nb):
            s = _scores(qblk, _block(k, ki, block), qi, ki, causal, scale,
                        block, valid_len, t)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, _block(v, ki, block).float())
            m = m_new
        safe_l = torch.where(l == 0, torch.ones_like(l), l)   # fully-masked rows -> 0
        outs.append((o / safe_l[..., None]).to(q.dtype))
        lses.append(m + torch.log(safe_l))
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def _attn_bwd_blocks(q, k, v, out, lse, dout, causal: bool, scale: float,
                     block: int, valid_len: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward of ``_attn_fwd_blocks``: p recomputed per block pair
    from q, k and the saved lse; dq, then dk and dv, accumulated in f32 in
    two blockwise passes with the causal block skip."""
    b, h, t, d = q.shape
    nb = t // block
    # guard fully-masked rows once before blocking: exp(s - lse) would
    # otherwise be exp(0) = 1 for their masked entries
    lse = torch.where(lse <= NEG_INF / 2, -lse, lse)
    do32 = dout.float()
    # Δ_i = dout_i · out_i, the softmax-jacobian row constant
    delta = (do32 * out.float()).sum(dim=-1)

    def p_ds(qi, ki):
        s = _scores(_block(q, qi, block), _block(k, ki, block), qi, ki,
                    causal, scale, block, valid_len, t)
        p = torch.exp(s - _block(lse, qi, block)[..., None])
        dp = torch.einsum("bhqd,bhkd->bhqk", _block(do32, qi, block),
                          _block(v, ki, block).float())
        return p, p * (dp - _block(delta, qi, block)[..., None])

    # pass 1: dq, outer over query blocks, inner over key blocks <= qi
    dq = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    for qi in range(nb):
        acc = _block(dq, qi, block)
        for ki in range(qi + 1 if causal else nb):
            _, ds = p_ds(qi, ki)
            acc += torch.einsum("bhqk,bhkd->bhqd", ds,
                                _block(k, ki, block).float()) * scale

    # pass 2: dk and dv, outer over key blocks, inner over query blocks >= ki
    dk = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for ki in range(nb):
        acc_k, acc_v = _block(dk, ki, block), _block(dv, ki, block)
        for qi in range(ki if causal else 0, nb):
            p, ds = p_ds(qi, ki)
            acc_v += torch.einsum("bhqk,bhqd->bhkd", p, _block(do32, qi, block))
            acc_k += torch.einsum("bhqk,bhqd->bhkd", ds,
                                  _block(q, qi, block).float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _ChunkedAttention(torch.autograd.Function):
    """``_attn_core``'s custom VJP: inputs padded to a block multiple,
    ``valid_len`` the unpadded length."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block, valid_len):
        out, lse = _attn_fwd_blocks(q, k, v, causal, scale, block, valid_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, block, valid_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _attn_bwd_blocks(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, scale: Optional[float] = None,
                      block: int = 512) -> torch.Tensor:
    """q/k/v: [B, H, T, D] -> attention output [B, H, T, D] (q's dtype).

    T is padded to a block multiple internally; padded keys are masked
    out and padded queries dropped on return (their zero output rows get
    a zero cotangent from the slice).  Differentiable with O(block^2)
    memory per block pair."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    t = q.shape[2]
    block = min(block, t)
    pad = (-t) % block
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
    out = _ChunkedAttention.apply(q, k, v, causal, scale, block, t)
    return out[:, :, :t] if pad else out
