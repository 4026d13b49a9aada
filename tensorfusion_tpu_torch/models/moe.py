"""Mixture-of-Experts decoder: the expert-parallel workload.

Counterpart of ``tensorfusion_tpu/models/moe.py``: Mixtral-style sparse
MoE with top-k routing and a static per-expert capacity.  Tokens past an
expert's capacity fall through the residual connection.  Two dispatches
share the routing semantics exactly, as in the reference:

- ``scatter`` (default): one stable argsort and two scatters build an
  [E*C] slot -> token map;
- ``dense``: GShard one-hot [T, E, C] dispatch and combine tensors, kept
  as the reference semantics.

With a ``mesh`` the block is expert-parallel over ``ep``: each rank holds
``n_experts / ep`` experts (``moe_param_specs``: ``("ep", None, None)``),
the ranks of one ``ep`` line see the same tokens and each runs only its
own experts on them, and the partial outputs are all-reduced over ``ep``.
Capacity is global, as under the reference's ``jit``, which sees the
logical batch: each rank gathers the [T, k] expert choices of every data
rank, so which entries an expert keeps (first come, first served in the
order of the whole batch) does not depend on how the batch is split.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..parallel.collectives import all_gather_axes, copy_to, gather_from, reduce_from
from ..parallel.mesh import axis_index, axis_size, shard_index
from . import llama


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    dim: int = 1024
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 8
    ffn_dim: int = 2048
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    attn_impl: str = "full"
    # "scatter" (default) or "dense" (the reference semantics)
    dispatch_impl: str = "scatter"
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def capacity(self, tokens: int) -> int:
        """Static per-expert token capacity for a batch of `tokens`."""
        cap = int(self.capacity_factor * tokens * self.top_k / self.n_experts)
        return max(cap, 1)

    @staticmethod
    def tiny(n_experts: int = 4) -> "MoEConfig":
        return MoEConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, ffn_dim=128, n_experts=n_experts,
                         top_k=2, max_seq_len=128, dtype=torch.float32)


# -- parameters -------------------------------------------------------------


def init_moe_params(config: MoEConfig, generator: torch.Generator,
                    device: DeviceLike = "cuda") -> Dict:
    """Random weights from ``generator`` (on ``device``); the reference's
    tree and scales, other numbers."""
    dev = resolve_device(device)

    def randn(shape):
        return torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)

    def dense(shape, scale=None):
        return (randn(shape) * (scale or shape[-2] ** -0.5)).to(config.dtype)

    def ones():
        return torch.ones((config.dim,), dtype=config.dtype, device=dev)

    hd, e = config.head_dim, config.n_experts
    layers = []
    for _ in range(config.n_layers):
        layers.append({
            "attn": {
                "wq": dense((config.dim, config.n_heads * hd)),
                "wk": dense((config.dim, config.n_kv_heads * hd)),
                "wv": dense((config.dim, config.n_kv_heads * hd)),
                "wo": dense((config.n_heads * hd, config.dim)),
            },
            "moe": {
                # replicated and f32: routing must agree across shards
                "router": randn((config.dim, e)) * config.dim ** -0.5,
                "w_gate": dense((e, config.dim, config.ffn_dim)),
                "w_up": dense((e, config.dim, config.ffn_dim)),
                "w_down": dense((e, config.ffn_dim, config.dim)),
            },
            "attn_norm": ones(),
            "moe_norm": ones(),
        })
    return {
        "tok_emb": dense((config.vocab_size, config.dim), 0.02),
        "layers": layers,
        "final_norm": ones(),
        "lm_head": dense((config.dim, config.vocab_size)),
    }


def moe_param_specs(config: MoEConfig) -> Dict:
    """Experts sharded over ep; attention over fsdp/tp like llama."""
    layer = {
        "attn": {"wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"),
                 "wv": ("fsdp", "tp"), "wo": ("tp", "fsdp")},
        "moe": {"router": (None, None), "w_gate": ("ep", None, None),
                "w_up": ("ep", None, None), "w_down": ("ep", None, None)},
        "attn_norm": (None,),
        "moe_norm": (None,),
    }
    return {
        "tok_emb": ("fsdp", None),
        "layers": [layer] * config.n_layers,
        "final_norm": (None,),
        "lm_head": ("fsdp", None),
    }


# -- the MoE block ----------------------------------------------------------


def _route(config: MoEConfig, p: Dict, xf: torch.Tensor):
    """Shared router: normalized top-k weights + expert indices [T, k]."""
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)       # [T, E]
    top_w, top_i = torch.topk(probs, config.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_i


def _positions(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each entry's rank among the earlier entries of its expert (the
    dense path's cumsum rank, the scatter path's stable-sort rank)."""
    onehot = F.one_hot(flat_e, n_experts)
    rank = torch.cumsum(onehot, dim=0) - onehot
    return torch.gather(rank, 1, flat_e[:, None])[:, 0]


def _expert_ffn(config: MoEConfig, p: Dict, expert_in: torch.Tensor):
    """[E, C, D] -> [E, C, D]."""
    h = llama._silu(torch.einsum("ecd,edf->ecf", expert_in, p["w_gate"])) \
        * torch.einsum("ecd,edf->ecf", expert_in, p["w_up"])
    return torch.einsum("ecf,efd->ecd", h, p["w_down"])


def _moe_block_dense(config: MoEConfig, p: Dict, xf: torch.Tensor,
                     cap: int) -> torch.Tensor:
    """Dense GShard dispatch: one-hot [T, E, C] dispatch/combine tensors."""
    t, d = xf.shape
    e, k = config.n_experts, config.top_k
    top_w, top_i = _route(config, p, xf)
    onehot = F.one_hot(top_i, e).float()                          # [T, k, E]
    pos = torch.cumsum(onehot.reshape(t * k, e), dim=0).reshape(t, k, e) - onehot
    pos = torch.einsum("tke,tke->tk", pos, onehot)                # rank in expert
    keep = pos < cap
    pos = torch.clamp(pos, 0, cap - 1).long()
    cap_onehot = F.one_hot(pos, cap).float() * keep[..., None]     # [T, k, C]
    dispatch = torch.einsum("tke,tkc->tec", onehot, cap_onehot)
    combine = torch.einsum("tk,tke,tkc->tec", top_w.float(), onehot, cap_onehot)
    expert_in = torch.einsum("tec,td->ecd", dispatch, xf.float()).to(config.dtype)
    out_e = _expert_ffn(config, p, expert_in)
    return torch.einsum("tec,ecd->td", combine, out_e.float())


def _moe_block_scatter(config: MoEConfig, p: Dict, xf: torch.Tensor,
                       cap: int) -> torch.Tensor:
    """Sorted-scatter dispatch: the dense path's routing and capacity
    semantics through an [E*C] slot -> token index."""
    t, d = xf.shape
    e, k = config.n_experts, config.top_k
    n = t * k
    top_w, top_i = _route(config, p, xf)
    flat_e = top_i.reshape(n)
    flat_w = top_w.reshape(n).float()
    perm = torch.argsort(flat_e, stable=True)            # token order within expert
    sorted_e = flat_e[perm]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=xf.device))
    pos = torch.arange(n, device=xf.device) - starts[sorted_e]
    keep = pos < cap
    # overflow entries land in slot E*C, which is cut off (mode="drop")
    slot = torch.where(keep, sorted_e * cap + pos, torch.full_like(pos, e * cap))
    tok = perm // k
    slot_tok = torch.full((e * cap + 1,), t, dtype=torch.long, device=xf.device) \
        .scatter(0, slot, tok)[:e * cap]
    slot_w = torch.zeros((e * cap + 1,), dtype=torch.float32, device=xf.device) \
        .scatter(0, slot, flat_w[perm])[:e * cap]
    xpad = torch.cat([xf, xf.new_zeros((1, d))])
    expert_in = xpad[slot_tok].reshape(e, cap, d).to(config.dtype)
    out_e = _expert_ffn(config, p, expert_in)
    # combine: weighted scatter-add back to tokens; the pad row swallows
    # empty slots
    y = torch.zeros((t + 1, d), dtype=torch.float32, device=xf.device).index_add(
        0, slot_tok, out_e.reshape(e * cap, d).float() * slot_w[:, None])
    return y[:t]


def _moe_block_ep(config: MoEConfig, p: Dict, xf: torch.Tensor, mesh,
                  stats: Optional[Dict]) -> torch.Tensor:
    """This rank's tokens through its ``ep`` share of the experts, with
    the capacity of the whole batch, in the scatter path's [E, C, D] slot
    layout cut to the local experts (the reference's expert-sharded
    ``expert_in``); the partial outputs are summed over ``ep``."""
    t, d = xf.shape
    e, k = config.n_experts, config.top_k
    data = ("dp", "fsdp")
    index, count = shard_index(mesh, data)
    cap = config.capacity(t * count)
    top_w, top_i = _route(config, p, xf)
    # slots are first come, first served over the whole batch, whose
    # tokens are the data ranks' blocks in rank order
    pos = _positions(all_gather_axes(top_i, mesh, data, 0).reshape(-1), e)
    pos = pos[index * t * k:(index + 1) * t * k]
    flat_e = top_i.reshape(t * k)
    keep = pos < cap
    if stats is not None:
        stats["dropped"] = stats.get("dropped", 0) + int((~keep).sum())
    # the ep ranks share these tokens; each adds its experts' share
    top_w, xf = copy_to(top_w, mesh, "ep"), copy_to(xf, mesh, "ep")
    e_local = p["w_gate"].shape[0]
    local_e = flat_e - axis_index(mesh, "ep") * e_local
    mine = keep & (local_e >= 0) & (local_e < e_local)
    # another rank's entries and overflow land in slot E_local*C, cut off
    slot = torch.where(mine, local_e * cap + pos, torch.full_like(pos, e_local * cap))
    tok = torch.arange(t * k, device=xf.device) // k
    slot_tok = torch.full((e_local * cap + 1,), t, dtype=torch.long, device=xf.device) \
        .scatter(0, slot, tok)[:e_local * cap]
    slot_w = torch.zeros((e_local * cap + 1,), dtype=torch.float32, device=xf.device) \
        .scatter(0, slot, top_w.reshape(t * k).float())[:e_local * cap]
    xpad = torch.cat([xf, xf.new_zeros((1, d))])
    expert_in = xpad[slot_tok].reshape(e_local, cap, d).to(config.dtype)
    out_e = _expert_ffn(config, p, expert_in)
    y = torch.zeros((t + 1, d), dtype=torch.float32, device=xf.device).index_add(
        0, slot_tok, out_e.reshape(e_local * cap, d).float() * slot_w[:, None])
    return reduce_from(y[:t], mesh, "ep")


def _moe_block(config: MoEConfig, p: Dict, x: torch.Tensor, mesh=None,
               stats: Optional[Dict] = None) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] via top-k experts with static capacity.
    ``stats``, when given, gains the count of (token, choice) entries
    dropped past capacity under "dropped" (this rank's share with a
    mesh)."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    if mesh is not None:
        y = _moe_block_ep(config, p, xf, mesh, stats)
        return y.to(x.dtype).reshape(b, s, d)
    cap = config.capacity(t)
    if config.dispatch_impl == "scatter":
        impl = _moe_block_scatter
    elif config.dispatch_impl == "dense":
        impl = _moe_block_dense
    else:
        raise ValueError(f"unknown dispatch_impl {config.dispatch_impl!r} "
                         f"(expected 'scatter' or 'dense')")
    if stats is not None:
        _, top_i = _route(config, p, xf)
        dropped = _positions(top_i.reshape(-1), config.n_experts) >= cap
        stats["dropped"] = stats.get("dropped", 0) + int(dropped.sum())
    return impl(config, p, xf, cap).to(x.dtype).reshape(b, s, d)


@dataclasses.dataclass(frozen=True)
class _AttnView:
    """The llama-attention config surface of a MoEConfig."""
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float
    attn_impl: str
    attn_block: int = 512


def _attn_view(config: MoEConfig) -> _AttnView:
    return _AttnView(config.n_heads, config.n_kv_heads, config.head_dim,
                     config.rope_theta, config.attn_impl)


def _layer(config: MoEConfig, layer: Dict, x: torch.Tensor, mesh=None,
           stats: Optional[Dict] = None) -> torch.Tensor:
    x = x + llama._attention(_attn_view(config), layer["attn"],
                             llama._rms_norm(x, layer["attn_norm"], config.norm_eps),
                             mesh=mesh)
    return x + _moe_block(config, layer["moe"],
                          llama._rms_norm(x, layer["moe_norm"], config.norm_eps),
                          mesh, stats)


def _check_mesh(mesh) -> None:
    if axis_size(mesh, "sp") > 1:
        raise ValueError("the MoE model does not shard the sequence (sp > 1): "
                         "its capacity order is the batch's token order")


def _hidden(config, params, tokens, mesh, stats):
    """Final-norm hidden states of ``tokens`` (this rank's block)."""
    specs = moe_param_specs(config)
    x = llama._embed(params["tok_emb"], specs["tok_emb"], tokens, mesh)
    for layer in params["layers"]:
        if config.remat:
            x = checkpoint(_layer, config, layer, x, mesh, stats, use_reentrant=False)
        else:
            x = _layer(config, layer, x, mesh, stats)
    return llama._rms_norm(x, params["final_norm"], config.norm_eps)


def moe_forward(params: Dict, tokens: torch.Tensor, config: MoEConfig,
                mesh=None, stats: Optional[Dict] = None) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, vocab] f32.  With a ``mesh``,
    ``params`` is ``shard_moe_params``' tree, ``tokens`` the whole batch
    on every rank, and every rank gets the whole logits.  ``stats``: see
    ``_moe_block``."""
    if mesh is None:
        x = _hidden(config, params, tokens, None, stats)
        return (x @ params["lm_head"]).float()
    _check_mesh(mesh)
    local = llama._local_tree(params)
    specs = moe_param_specs(config)
    x = _hidden(config, local, llama._local_batch(tokens, mesh), mesh, stats)
    logits = llama._head(x, local["lm_head"], specs["lm_head"], mesh)
    return gather_from(logits, mesh, ("dp", "fsdp"), 0)


def _sharded_moe_loss(local, batch, config, mesh):
    specs = moe_param_specs(config)
    x = _hidden(config, local, llama._local_batch(batch["tokens"], mesh), mesh, None)
    logits = llama._head(x, local["lm_head"], specs["lm_head"], mesh)
    nll = llama._nll(logits, llama._local_batch(batch["targets"], mesh), (), mesh)
    return llama._masked_mean(nll, {"targets": batch["targets"]}, mesh)


def moe_loss_fn(params: Dict, batch: Dict, config: MoEConfig,
                mesh=None) -> torch.Tensor:
    if mesh is not None:
        _check_mesh(mesh)
        return _sharded_moe_loss(llama._local_tree(params), batch, config, mesh)
    logits = moe_forward(params, batch["tokens"], config)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, batch["targets"].long()[..., None])[..., 0].mean()


def make_moe_train_step(config: MoEConfig, learning_rate: float = 3e-4,
                        device: DeviceLike = "cuda", mesh=None
                        ) -> Tuple[Callable, Callable]:
    """(train_step, init_opt_state): AdamW as ``llama.make_train_step``'s,
    on the MoE loss; with a ``mesh``, over ``shard_moe_params``' tree."""
    dev = resolve_device(device)

    def train_step(params: Dict, opt_state: Dict, batch: Dict):
        if params["tok_emb"].device.type != dev.type:
            raise ValueError(f"parameters are on {params['tok_emb'].device}, "
                             f"the train step was made for {dev}")
        if mesh is None:
            loss, grads = llama.dense_value_and_grad(
                params, lambda p: moe_loss_fn(p, batch, config))
        else:
            _check_mesh(mesh)
            loss, grads = llama.sharded_value_and_grad(
                params, moe_param_specs(config),
                lambda local: _sharded_moe_loss(local, batch, config, mesh), mesh)
        llama.adamw_update_(llama._leaves(params), grads, opt_state, learning_rate)
        return params, opt_state, loss

    return train_step, llama.init_adamw_state


def shard_moe_params(params: Dict, mesh, config: MoEConfig) -> Dict:
    """Place a MoE tree on ``mesh`` by ``moe_param_specs``, dropping the
    spec axes the mesh does not have (e.g. fsdp on a dp/ep mesh)."""
    return llama.shard_tree(params, moe_param_specs(config), mesh)
