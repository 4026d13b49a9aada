"""Ring attention: sequence parallelism over the ``sp`` mesh axis.

Counterpart of ``tensorfusion_tpu/parallel/ring_attention.py``.  Each
rank holds a local block of Q, K and V; the K/V blocks rotate around the
ring (send to the next rank, receive from the previous one) while every
rank accumulates its Q block's attention online, flash-style, with the
running max, denominator and output in f32 whatever the input dtype.  The
[T, T] score matrix never exists; memory stays O(T_local²) per rank.

Causal masking is in global coordinates: at ring step ``s`` the rank
holding query block ``i`` sees key block ``(i - s) mod n``.  Blocks
wholly in a query block's future contribute nothing: the reference masks
them to -1e30 and adds exp(-1e30 - m) = 0; the port skips their
arithmetic, which adds the same zeros.

The backward is not autograd through the ring loop (that would keep
every step's probabilities): ``_RingAttention.backward`` is the
reference's ``_ring_local_bwd``, a second ring pass that recomputes the
probabilities from q, the rotating K/V and the saved row logsumexp, with
each block's dK/dV riding the ring home beside it.

The block math is plain torch, as it was XLA in the reference
(Liu et al., "Ring Attention with Blockwise Transformers for
Near-Infinite Context", arXiv:2310.01889).
"""

from __future__ import annotations

from typing import Optional

import torch

from .collectives import gather_from, scatter_to, shift
from .mesh import axis_index, axis_size

NEG_INF = -1e30


def _masked_scores(q, k, q_off, k_off, causal, scale):
    """f32 scaled QKᵀ scores with global-coordinate causal masking, shared
    by the forward and the backward."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_off + torch.arange(q.shape[2], device=q.device)
        k_pos = k_off + torch.arange(k.shape[2], device=q.device)
        s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), NEG_INF)
    return s


def _block(q, k, v, m, l, o, q_off, k_off, causal, scale):
    """One online-softmax accumulation step for a K/V block (f32 state)."""
    s = _masked_scores(q, k, q_off, k_off, causal, scale)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return m_new, l_new, o_new


def _future(causal, q_off, k_off, t_local) -> bool:
    """Whether the key block lies wholly after the query block."""
    return causal and k_off > q_off + t_local - 1


def _rotate(x, group, n):
    """The next rank's block: what the previous rank held."""
    return shift(x, group) if n > 1 else x


def _ring_forward(q, k, v, group, n, idx, causal, scale):
    """(out [B,H,Tl,D] in q's dtype, lse [B,H,Tl] f32)."""
    t_local = q.shape[2]
    q_off = idx * t_local
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for s in range(n):
        k_off = ((idx - s) % n) * t_local
        if not _future(causal, q_off, k_off, t_local):
            m, l, o = _block(q, kv[0], kv[1], m, l, o, q_off, k_off, causal, scale)
        if s < n - 1:           # the last rotation would only bring it home
            kv = _rotate(kv, group, n)
    # fully-masked rows have l == 0; emit zeros there
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    return (o / safe_l[..., None]).to(q.dtype), m + torch.log(safe_l)


def _ring_backward(q, k, v, out, lse, dout, group, n, idx, causal, scale):
    t_local = q.shape[2]
    q_off = idx * t_local
    do32 = dout.float()
    q32 = q.float()
    # rowwise softmax-jacobian constant D_i = dout_i . out_i
    delta = (do32 * out.float()).sum(dim=-1)
    lse_safe = torch.where(lse <= NEG_INF / 2, -lse, lse)
    kv = torch.stack([k, v])
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for s in range(n):
        k_off = ((idx - s) % n) * t_local
        if not _future(causal, q_off, k_off, t_local):
            k32, v32 = kv[0].float(), kv[1].float()
            sc = _masked_scores(q, kv[0], q_off, k_off, causal, scale)
            p = torch.exp(sc - lse_safe[..., None])
            dp = torch.einsum("bhqd,bhkd->bhqk", do32, v32)
            ds = p * (dp - delta[..., None])
            dq += torch.einsum("bhqk,bhkd->bhqd", ds, k32) * scale
            dkv[0] += torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale
            dkv[1] += torch.einsum("bhqk,bhqd->bhkd", p, do32)
        # the block's gradient rides the ring with it and is home after n
        # rotations; the block itself is not needed after the last step
        if s < n - 1:
            kv = _rotate(kv, group, n)
        dkv = _rotate(dkv, group, n)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, n, idx, causal, scale):
        out, lse = _ring_forward(q, k, v, group, n, idx, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, n, idx, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = "sp", causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Rank-local entry: q/k/v are this rank's sequence blocks
    [B, H, T_local, D] of an ``axis_name``-sharded sequence (rank i holds
    tokens i·T_local ... (i+1)·T_local - 1); returns its output block."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = axis_size(mesh, axis_name)
    group = mesh.get_group(axis_name) if n > 1 else None
    return _RingAttention.apply(q, k, v, group, n, axis_index(mesh, axis_name),
                                causal, float(scale))


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mesh, axis_name: str = "sp", causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Whole-array entry: q/k/v are [B, H, T, D], the same on every rank;
    the batch splits over the data axes, the heads over ``tp`` and the
    sequence over ``axis_name``, as the reference's shard_map specs do,
    and every rank gets the whole output back (differentiably)."""
    dims = (("dp", "fsdp"), "tp", axis_name)
    for d, axes in enumerate(dims):
        q, k, v = (scatter_to(x, mesh, axes, d) for x in (q, k, v))
    out = ring_attention(q, k, v, mesh, axis_name, causal, scale)
    for d, axes in reversed(list(enumerate(dims))):
        out = gather_from(out, mesh, axes, d)
    return out
