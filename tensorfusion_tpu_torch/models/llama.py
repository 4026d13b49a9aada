"""Llama-style decoder-only transformer: the functional PyTorch port of
``tensorfusion_tpu/models/llama.py``, serving and training.

Same parameter tree as the reference (``init_params``), with ``[in, out]``
weights used as ``x @ w``, so a JAX tree converts by a plain copy
(models/convert.py).  Grouped-query attention with ``attn_impl`` of
"full" (dense), "flash" (the Hopper kernels of ops/flash_attention.py on
CUDA tensors, forward and backward), "chunked" (blockwise, O(T x block)
memory, differentiable) or "ring" (ring attention over the mesh's ``sp``
axis, parallel/ring_attention.py; dense without a mesh, as in the
reference).  Serving: a
preallocated KV cache (optionally int8), batched ``prefill``,
``decode_step`` and greedy ``generate``.
Training: ``loss_fn`` (logsumexp cross-entropy) and ``make_train_step``
(AdamW as ``optax.adamw``), with ``remat`` through
``torch.utils.checkpoint`` where the reference uses ``jax.checkpoint``.

Where the reference is pure (``lax.dynamic_update_slice``, optax's new
trees), the port writes the KV cache and the parameters and optimizer
moments in place, which saves a copy of each per step; ``lax.scan``
loops become Python loops.

Sharding (``param_specs``, ``shard_params``, ``mesh=`` through
``forward``, ``loss_fn``, ``value_and_grad`` and ``make_train_step``)
runs one process a rank on a ``DeviceMesh`` of parallel/mesh.py, where
the reference lets GSPMD partition one program.  Parameters are
``DTensor``s with the specs' placements; the model runs on their local
shards with explicit collectives (parallel/collectives.py): FSDP weights
all-gathered a layer at a time (gradients reduce-scattered), Megatron
column-parallel wq/wk/wv/w_gate/w_up and row-parallel wo/w_down with an
all-reduce over ``tp``, the batch split over ``("dp", "fsdp")`` and the
sequence over ``sp`` (global RoPE positions), a vocab-parallel
cross-entropy whose max, sum of exponentials and target logit reduce over
``tp``, and gradients of replicated leaves all-reduced over the data
axes.  The result equals the unsharded one, as GSPMD's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
# imported before any call, not lazily: the ops register their FLOP
# formulas on import, and a FlopCounterMode (the client's cost estimate)
# sees only those registered before it was made
from ..ops import chunked_attention, flash_attention
from ..parallel.collectives import (all_gather_axes, all_reduce_axes, copy_to,
                                    gather_from, gather_rs, reduce_from)
from ..parallel.mesh import (axis_index, axis_size, local_shard, placements,
                             prune_spec, shard_index, spec_axes)
from ..parallel.ring_attention import ring_attention
from .quantize import QuantizedWeight, is_quantized
from .quantize import matmul as _mm


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    attn_impl: str = "full"   # "full" | "flash" | "chunked" | "ring" (dense without a mesh)
    attn_block: int = 512     # KV block for attn_impl="chunked"
    #: recompute each layer's activations in the backward
    #: (torch.utils.checkpoint) instead of keeping them
    remat: bool = False
    #: int8 KV cache with per-(token, head) f32 scales
    kv_quant: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, dim=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, ffn_dim=14336,
                           rope_theta=500000.0)

    @staticmethod
    def tiny(attn_impl: str = "full") -> "LlamaConfig":
        return LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                           dtype=torch.float32, attn_impl=attn_impl)


# -- parameters -------------------------------------------------------------


def init_params(config: LlamaConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Dict:
    """Random weights from ``generator``, which must live on ``device``.
    Same tree and scales as the reference; the numbers differ, since the
    two frameworks' generators differ."""
    dev = resolve_device(device)

    def dense(shape, scale=None):
        scale = scale or (shape[0] ** -0.5)
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * scale).to(config.dtype)

    def ones():
        return torch.ones((config.dim,), dtype=config.dtype, device=dev)

    hd = config.head_dim
    layers = []
    for _ in range(config.n_layers):
        layers.append({
            "attn": {
                "wq": dense((config.dim, config.n_heads * hd)),
                "wk": dense((config.dim, config.n_kv_heads * hd)),
                "wv": dense((config.dim, config.n_kv_heads * hd)),
                "wo": dense((config.n_heads * hd, config.dim)),
            },
            "mlp": {
                "w_gate": dense((config.dim, config.ffn_dim)),
                "w_up": dense((config.dim, config.ffn_dim)),
                "w_down": dense((config.ffn_dim, config.dim)),
            },
            "attn_norm": ones(),
            "mlp_norm": ones(),
        })
    return {
        "tok_emb": dense((config.vocab_size, config.dim), 0.02),
        "layers": layers,
        "final_norm": ones(),
        "lm_head": dense((config.dim, config.vocab_size)),
    }


# -- model ------------------------------------------------------------------


def _rms_norm(x, weight, eps):
    # variance in f32; the rsqrt is cast to x's dtype before the multiply
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * weight


def _rope(x, theta, pos: int = 0):
    """x: [B, T, H, D]; rotate interleaved pairs (0,1), (2,3), ... along D.
    Positions are ``pos + arange(T)`` (``pos`` an int, default 0: the
    decode path passes the single cache position)."""
    b, t, h, d = x.shape
    # made on the device: a Python int copied to the card would make the
    # host wait for the queued work at every layer of every decode step
    pos = torch.arange(t, dtype=torch.float32, device=x.device) + pos
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = pos[:, None] * freqs[None, :]                 # [T, D/2]
    cos = torch.cos(angles)[None, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rx1 = x1 * cos - x2 * sin
    rx2 = x1 * sin + x2 * cos
    return torch.stack([rx1, rx2], dim=-1).reshape(x.shape)


#: where each layer weight's dims shard (parallel/mesh.py specs)
_LAYER_SPECS = {"wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
                "wo": ("tp", "fsdp"), "w_gate": ("fsdp", "tp"),
                "w_up": ("fsdp", "tp"), "w_down": ("tp", "fsdp")}
#: axes that split a weight's work; any other axis in a spec only splits
#: its storage (FSDP), and the forward gathers it back
_WORK_AXES = ("tp", "ep")
#: axes whose ranks see different tokens
_DATA_AXES = ("dp", "fsdp", "sp")


def _storage_axes(entry) -> Tuple[str, ...]:
    return tuple(a for a in spec_axes(entry) if a not in _WORK_AXES)


def _work_axes(entry) -> Tuple[str, ...]:
    return tuple(a for a in spec_axes(entry) if a in _WORK_AXES)


def _gathered(w, spec, mesh):
    """This rank's working copy of a local weight shard: gathered over the
    spec's storage (FSDP) axes, differentiably (reduce-scatter backward);
    its ``tp`` shard stays local.  Identity without a mesh."""
    if mesh is None:
        return w
    if is_quantized(w):
        if w.mode == "w8a8" and _work_axes(spec[0]) and axis_size(mesh, "tp") > 1:
            raise ValueError("w8a8 quantizes a whole input row: a row-parallel "
                             "weight cannot shard over tp")
        q = w.q
        for d, entry in enumerate(spec):
            q = all_gather_axes(q, mesh, _storage_axes(entry), d)
        s = all_gather_axes(w.s, mesh, _storage_axes(spec[1]), 0)
        return QuantizedWeight(q=q, s=s, mode=w.mode)
    for d, entry in enumerate(spec):
        w = gather_rs(w, mesh, _storage_axes(entry), d)
    return w


def _attention(config: LlamaConfig, p, x, return_kv: bool = False, mesh=None):
    """Causal self-attention over a full sequence.  With ``return_kv``
    also returns the post-rope, pre-GQA-repeat K/V ([B, T, n_kv, D]),
    which prefill caches.  With a ``mesh``, ``x`` is this rank's tokens
    (its sequence block under ``sp``), the heads are its ``tp`` share and
    the output is all-reduced over ``tp``."""
    b, t, _ = x.shape
    hd = config.head_dim
    tp = axis_size(mesh, "tp")
    if config.n_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide n_kv_heads={config.n_kv_heads}")
    if axis_size(mesh, "sp") > 1 and config.attn_impl != "ring":
        raise ValueError("a sequence-sharded mesh (sp > 1) needs attn_impl='ring'")
    n_heads, n_kv = config.n_heads // tp, config.n_kv_heads // tp
    w = {name: _gathered(p[name], _LAYER_SPECS[name], mesh)
         for name in ("wq", "wk", "wv", "wo")}
    x = copy_to(x, mesh, "tp")
    q = _mm(x, w["wq"]).reshape(b, t, n_heads, hd)
    k = _mm(x, w["wk"]).reshape(b, t, n_kv, hd)
    v = _mm(x, w["wv"]).reshape(b, t, n_kv, hd)
    # global positions: rank i of sp holds tokens i*t ... (i+1)*t - 1
    pos = axis_index(mesh, "sp") * t
    q = _rope(q, config.rope_theta, pos)
    k = _rope(k, config.rope_theta, pos)
    k_pre, v_pre = k, v
    # GQA: repeat kv heads before attention, so the kernel sees
    # [B * n_heads, T, D] as the TPU kernel does.  Column shards keep the
    # pairing: tp rank r holds q heads r*n_heads ... and kv heads r*n_kv
    # ..., and q head j reads kv head j // rep on both sides of the split
    rep = n_heads // n_kv
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    q, k, v = (z.transpose(1, 2) for z in (q, k, v))      # [B, H, T, D]

    # "ring" takes the sequence-parallel path only with a mesh; with none
    # it is the dense branch below, as in the reference
    if config.attn_impl == "ring" and mesh is not None:
        out = ring_attention(q, k, v, mesh, "sp", causal=True)
    elif config.attn_impl == "flash":
        out = flash_attention(q, k, v, causal=True)
    elif config.attn_impl == "chunked":
        out = chunked_attention(q, k, v, causal=True, block=config.attn_block)
    else:
        scale = hd ** -0.5
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
        mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~mask, -1e30)
        probs = torch.softmax(scores.float(), dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    out = out.transpose(1, 2).reshape(b, t, n_heads * hd)
    out = reduce_from(_mm(out, w["wo"]), mesh, "tp")
    if return_kv:
        return out, k_pre, v_pre
    return out


def _silu(x):
    # jax.nn.silu's own expression, so bf16 rounds at the same steps
    return x * (1 / (1 + torch.exp(-x)))


def _mlp(p, x, mesh=None):
    w = {name: _gathered(p[name], _LAYER_SPECS[name], mesh)
         for name in ("w_gate", "w_up", "w_down")}
    x = copy_to(x, mesh, "tp")
    h = _silu(_mm(x, w["w_gate"])) * _mm(x, w["w_up"])
    return reduce_from(_mm(h, w["w_down"]), mesh, "tp")


def _layer(config: LlamaConfig, layer, x, return_kv=False, mesh=None):
    h = _rms_norm(x, layer["attn_norm"], config.norm_eps)
    if return_kv:
        attn, k, v = _attention(config, layer["attn"], h, return_kv=True, mesh=mesh)
    else:
        attn = _attention(config, layer["attn"], h, mesh=mesh)
    x = x + attn
    x = x + _mlp(layer["mlp"], _rms_norm(x, layer["mlp_norm"], config.norm_eps),
                 mesh)
    return (x, k, v) if return_kv else x


def _layers(config, layer_fn, layers, x, mesh):
    for layer in layers:
        if config.remat:
            x = checkpoint(layer_fn, config, layer, x, False, mesh,
                           use_reentrant=False)
        else:
            x = layer_fn(config, layer, x, False, mesh)
    return x


# -- the sharded model: this rank's shards, explicit collectives ---------------


def _local(x):
    """A ``DTensor``'s local shard (differentiable into it); a plain tensor
    or a quantized weight of local shards as it is."""
    if isinstance(x, DTensor):
        return x.to_local()
    if is_quantized(x):
        return QuantizedWeight(q=_local(x.q), s=_local(x.s), mode=x.mode)
    return x


def _local_tree(tree):
    if isinstance(tree, dict):
        return {k: _local_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_local_tree(v) for v in tree]
    return _local(tree)


def _local_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of a global [B, T, ...] batch tensor: rows over
    the data axes, positions over ``sp``."""
    return local_shard(x, mesh, (("dp", "fsdp"), "sp"))


def _embed(table, spec, tokens, mesh):
    """Embedding lookup on a table sharded by ``spec`` (rows over storage
    axes, columns possibly over ``tp``); returns [b, t, dim] replicated
    over ``tp``."""
    x = _gathered(table, spec, mesh)[tokens.long()]
    return gather_from(x, mesh, _work_axes(spec[1]), 2)


def _head(x, w, spec, mesh):
    """f32 logits of this rank's vocab share (``spec[1]``'s tp axes)."""
    x = copy_to(x, mesh, _work_axes(spec[1]))
    return _mm(x, _gathered(w, spec, mesh)).float()


def _nll(logits, targets, vocab_axes, mesh):
    """-log softmax(logits)[target] of vocab-sharded f32 logits: the max,
    the sum of exponentials and the target logit reduce over
    ``vocab_axes``."""
    m = all_reduce_axes(logits.detach().amax(dim=-1), mesh, vocab_axes, "max")
    sumexp = reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1), mesh,
                         vocab_axes)
    lse = m + torch.log(sumexp)
    index, count = shard_index(mesh, vocab_axes)
    v_local = logits.shape[-1]
    rel = targets.long() - index * v_local
    mine = (rel >= 0) & (rel < v_local)
    tgt = torch.gather(logits, -1, rel.clamp(0, v_local - 1)[..., None])[..., 0]
    tgt = reduce_from(torch.where(mine, tgt, torch.zeros_like(tgt)), mesh, vocab_axes)
    return lse - tgt


def _masked_mean(nll_local, batch, mesh):
    """The batch's (masked) mean of per-token values, from this rank's
    block: a local sum over the global count, summed over the data axes."""
    mask = batch.get("mask")
    if mask is None:
        total = nll_local.sum()
        count = batch["targets"].numel()
    else:
        total = (nll_local * _local_batch(mask, mesh).to(nll_local.dtype)).sum()
        count = torch.clamp(mask.to(nll_local.dtype).sum(), min=1)
    return reduce_from(total / count, mesh, _DATA_AXES)


def _sharded_loss(local, batch, config, mesh):
    tokens = _local_batch(batch["tokens"], mesh)
    spec = param_specs(config)
    x = _embed(local["tok_emb"], spec["tok_emb"], tokens, mesh)
    x = _layers(config, _layer, local["layers"], x, mesh)
    x = _rms_norm(x, local["final_norm"], config.norm_eps)
    logits = _head(x, local["lm_head"], spec["lm_head"], mesh)
    nll = _nll(logits, _local_batch(batch["targets"], mesh),
               _work_axes(spec["lm_head"][1]), mesh)
    return _masked_mean(nll, batch, mesh)


def forward(params: Dict, tokens: torch.Tensor, config: LlamaConfig,
            mesh=None) -> torch.Tensor:
    """tokens [B, T] integer -> logits [B, T, vocab] f32.  With a ``mesh``,
    ``params`` is ``shard_params``' tree, ``tokens`` the whole batch on
    every rank, and every rank gets the whole logits."""
    if mesh is not None:
        local = _local_tree(params)
        spec = param_specs(config)
        x = _embed(local["tok_emb"], spec["tok_emb"], _local_batch(tokens, mesh), mesh)
        x = _layers(config, _layer, local["layers"], x, mesh)
        x = _rms_norm(x, local["final_norm"], config.norm_eps)
        logits = _head(x, local["lm_head"], spec["lm_head"], mesh)
        logits = gather_from(logits, mesh, _work_axes(spec["lm_head"][1]), 2)
        logits = gather_from(logits, mesh, "sp", 1)
        return gather_from(logits, mesh, ("dp", "fsdp"), 0)
    x = params["tok_emb"][tokens.long()]
    x = _layers(config, _layer, params["layers"], x, None)
    x = _rms_norm(x, params["final_norm"], config.norm_eps)
    return _mm(x, params["lm_head"]).float()


def loss_fn(params: Dict, batch: Dict, config: LlamaConfig,
            mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "targets"}
    [B, T] integers, optional "mask" [B, T]) as a 0-d f32 tensor.  The
    logsumexp form never builds the [B, T, vocab] log-probabilities.
    With a ``mesh`` (``shard_params``' tree, the whole batch on every
    rank) the logits stay vocab-sharded and every rank returns the loss
    of the whole batch."""
    if mesh is not None:
        return _sharded_loss(_local_tree(params), batch, config, mesh)
    logits = forward(params, batch["tokens"], config)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, batch["targets"].long()[..., None])[..., 0]
    nll = lse - tgt
    mask = batch.get("mask")
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def param_specs(config: LlamaConfig) -> Dict:
    """Specs matching init_params' tree: FSDP on dim 0, TP on the
    head/hidden dim (the reference's PartitionSpecs, as tuples)."""
    layer = {
        "attn": {k: _LAYER_SPECS[k] for k in ("wq", "wk", "wv", "wo")},
        "mlp": {k: _LAYER_SPECS[k] for k in ("w_gate", "w_up", "w_down")},
        "attn_norm": (None,),
        "mlp_norm": (None,),
    }
    return {
        "tok_emb": ("fsdp", "tp"),
        "layers": [layer] * config.n_layers,
        "final_norm": (None,),
        "lm_head": ("fsdp", "tp"),
    }


def shard_tree(params: Dict, specs: Dict, mesh) -> Dict:
    """Place a tree of whole tensors on ``mesh``: each leaf becomes a
    ``DTensor`` holding this rank's block (a copy, so the whole tensor can
    go) with its spec's placements, the axes the mesh lacks dropped.  A
    ``QuantizedWeight`` counts as one leaf: its int8 matrix takes the
    spec, its [out] scale vector the spec's output axis."""
    def place(x, spec):
        spec = prune_spec(mesh, spec)
        return DTensor.from_local(local_shard(x, mesh, spec).contiguous().clone(),
                                  mesh, placements(mesh, spec), run_check=False)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, sp) for v, sp in zip(node, spec, strict=True)]
        if is_quantized(node):
            return QuantizedWeight(q=place(node.q, spec),
                                   s=place(node.s, spec[1:2] or (None,)),
                                   mode=node.mode)
        return place(node, spec)

    return walk(params, specs)


def shard_params(params: Dict, mesh, config: LlamaConfig) -> Dict:
    """Place a parameter tree (plain or int8-quantized) on the mesh, by
    ``param_specs``; the counterpart of ``device_put`` with a
    ``NamedSharding`` per leaf."""
    return shard_tree(params, param_specs(config), mesh)


# -- training ---------------------------------------------------------------


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a parameter tree in a fixed order (dicts in their
    insertion order, lists in order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [x for v in tree for x in _leaves(v)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its tensors taken, in ``_leaves`` order,
    from the iterable ``leaves``."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]

    return walk(tree)


def _grad_reduce_axes(spec) -> Tuple[str, ...]:
    """The data axes a leaf's gradient still sums over after the backward:
    those its spec does not shard (a storage axis in the spec was summed
    by the gather's reduce-scatter)."""
    named = {a for entry in spec for a in spec_axes(entry)}
    return tuple(a for a in _DATA_AXES if a not in named)


def sharded_value_and_grad(params, specs, loss_local: Callable, mesh
                           ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, gradients in ``_leaves`` order) of ``loss_local(local_tree)``
    over ``shard_params``-style ``params``: the backward runs on the local
    shards, each gradient is then summed over the data axes its leaf does
    not shard, and comes back as a ``DTensor`` with its leaf's placements."""
    leaves = _leaves(params)
    local = [p.to_local() if isinstance(p, DTensor) else p for p in leaves]
    local = [x.detach().requires_grad_(True) for x in local]
    loss = loss_local(_unflatten(params, local))
    grads = torch.autograd.grad(loss, local)
    out = []
    for p, g, spec in zip(leaves, grads, _leaves_of_specs(params, specs), strict=True):
        g = all_reduce_axes(g, mesh, _grad_reduce_axes(spec))
        if isinstance(p, DTensor):
            g = DTensor.from_local(g, p.device_mesh, p.placements, run_check=False)
        out.append(g)
    return loss.detach(), out


def _leaves_of_specs(params, specs) -> List:
    """The spec of every leaf of ``params``, in ``_leaves`` order."""
    out = []

    def walk(node, spec):
        if isinstance(node, torch.Tensor):
            out.append(spec)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, spec[k])
        else:
            for v, sp in zip(node, spec, strict=True):
                walk(v, sp)

    walk(params, specs)
    return out


def value_and_grad(params: Dict, batch: Dict, config: LlamaConfig, mesh=None
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, gradient of every leaf in ``_leaves`` order).  The leaves'
    ``requires_grad`` is set for the call and restored after it.  With a
    ``mesh`` the gradients are ``DTensor``s placed as the parameters."""
    if mesh is not None:
        return sharded_value_and_grad(
            params, param_specs(config),
            lambda local: _sharded_loss(local, batch, config, mesh), mesh)
    return dense_value_and_grad(params, lambda p: loss_fn(p, batch, config))


def dense_value_and_grad(params, loss_of: Callable
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(``loss_of(params)``, its gradient for every leaf in ``_leaves``
    order), on whole tensors."""
    leaves = _leaves(params)
    before = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_of(params)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p, flag in zip(leaves, before):
            p.requires_grad_(flag)
    return loss.detach(), list(grads)


@torch.no_grad()
def adamw_update_(params: List[torch.Tensor], grads: List[torch.Tensor],
                  state: Dict, learning_rate: float, b1: float = 0.9,
                  b2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.1) -> None:
    """One ``optax.adamw`` step, in place on ``params`` and on the state's
    moments (lists in ``params`` order) and step count.

    mu = (1-b1)·g + b1·mu; nu = (1-b2)·g² + b2·nu; with the bias
    corrections c1 = 1-b1^n, c2 = 1-b2^n (n the new count, in f32 and
    cast to each moment's dtype), p -= lr·((mu/c1) / (sqrt(nu/c2) + eps)
    + weight_decay·p), on every leaf.  ``DTensor`` leaves update their
    local shards: the update is elementwise and has no global-norm term,
    so the sharded update equals the whole one."""
    state["count"] += 1
    c1 = 1 - b1 ** state["count"]
    c2 = 1 - b2 ** state["count"]
    for p, g, mu, nu in zip(params, grads, _leaves(state["mu"]),
                            _leaves(state["nu"])):
        p, g, mu, nu = (x.to_local() if isinstance(x, DTensor) else x
                        for x in (p, g, mu, nu))
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        update = (mu / c1.to(mu.dtype)).div_(
            (nu / c2.to(nu.dtype)).sqrt_().add_(eps))
        p.sub_(update.add_(p, alpha=weight_decay), alpha=learning_rate)


def make_train_step(config: LlamaConfig, learning_rate: float = 3e-4,
                    device: DeviceLike = "cuda", mesh=None
                    ) -> Tuple[Callable, Callable]:
    """Returns (train_step, init_opt_state), the reference's pair:
    ``train_step(params, opt_state, batch) -> (params, opt_state, loss)``,
    an AdamW step as ``optax.adamw(lr, b1=0.9, b2=0.95,
    weight_decay=0.1)`` (eps 1e-8, bias correction, decoupled decay on
    every leaf, moments in the parameters' dtype).

    The step updates ``params`` and ``opt_state`` in place and returns the
    same objects: at Llama-3-8B width a fresh copy of every parameter and
    moment would cost about 17 GB.  It is a function of its arguments
    alone (the state is a plain tree, no ``torch.optim`` object), so the
    client runtime can estimate it on fake copies of them, and it returns
    the loss as a 0-d tensor, with no host sync.  The step runs on
    ``device``, where the parameters must live.  With a ``mesh``, the
    parameters are ``shard_params``' tree, the moments ``DTensor``s placed
    alike, the batch the whole batch on every rank, and the loss that of
    the whole batch."""
    dev = resolve_device(device)

    def train_step(params: Dict, opt_state: Dict, batch: Dict):
        if params["tok_emb"].device.type != dev.type:
            raise ValueError(f"parameters are on {params['tok_emb'].device}, "
                             f"the train step was made for {dev}")
        loss, grads = value_and_grad(params, batch, config, mesh)
        adamw_update_(_leaves(params), grads, opt_state, learning_rate)
        return params, opt_state, loss

    return train_step, init_adamw_state


def init_adamw_state(params: Dict) -> Dict:
    """AdamW's state for ``params``: a step count and two moment trees of
    zeros shaped (and, for ``DTensor``s, placed) as the parameters."""
    return {"count": torch.zeros((), dtype=torch.int32, device=params["tok_emb"].device),
            "mu": _unflatten(params, map(torch.zeros_like, _leaves(params))),
            "nu": _unflatten(params, map(torch.zeros_like, _leaves(params)))}


# -- serving: KV-cache decode + generation ----------------------------------


def init_kv_cache(config: LlamaConfig, batch: int,
                  max_len: Optional[int] = None,
                  device: DeviceLike = "cuda") -> Dict:
    """Preallocated KV cache: [layer][B, n_kv_heads, T, D].  With
    ``config.kv_quant`` the cache holds int8 values plus per-(token, head)
    f32 scales."""
    dev = resolve_device(device)
    t = max_len or config.max_seq_len
    shape = (batch, config.n_kv_heads, t, config.head_dim)

    def zeros(shp, dtype):
        return [torch.zeros(shp, dtype=dtype, device=dev)
                for _ in range(config.n_layers)]

    if config.kv_quant:
        sshape = (batch, config.n_kv_heads, t)
        return {"k": zeros(shape, torch.int8), "ks": zeros(sshape, torch.float32),
                "v": zeros(shape, torch.int8), "vs": zeros(sshape, torch.float32)}
    return {"k": zeros(shape, config.dtype), "v": zeros(shape, config.dtype)}


def _kv_quantize(x):
    """[..., D] -> (int8 [..., D], f32 scale [...]): symmetric per
    (token, head) over the head dim."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def _attention_decode(config: LlamaConfig, p, x, lc: Dict, pos: int):
    """One-token attention against the cache.  x: [B, 1, dim]; ``lc`` is
    one layer's cache ({"k","v"}, or {"k","ks","v","vs"} int8 with
    per-(token, head) scales), written in place at ``pos``.  Returns
    (out, lc).

    GQA stays grouped: the query reshapes to [B, n_kv, rep, D] and
    attends against the n_kv-head cache directly.  In the int8 path the
    per-token scales factor out of both products (scores *= ks; probs *=
    vs before the V product)."""
    b = x.shape[0]
    hd = config.head_dim
    quant = "ks" in lc
    q = _mm(x, p["wq"]).reshape(b, 1, config.n_heads, hd)
    k = _mm(x, p["wk"]).reshape(b, 1, config.n_kv_heads, hd)
    v = _mm(x, p["wv"]).reshape(b, 1, config.n_kv_heads, hd)
    q = _rope(q, config.rope_theta, pos=pos)
    k = _rope(k, config.rope_theta, pos=pos)
    k_t = k[:, 0]                                 # [B, n_kv, D]
    v_t = v[:, 0]
    # in place where the reference uses lax.dynamic_update_slice
    if quant:
        kq, ks = _kv_quantize(k_t)
        vq, vs = _kv_quantize(v_t)
        lc["k"][:, :, pos] = kq
        lc["ks"][:, :, pos] = ks
        lc["v"][:, :, pos] = vq
        lc["vs"][:, :, pos] = vs
    else:
        lc["k"][:, :, pos] = k_t
        lc["v"][:, :, pos] = v_t
    rep = config.n_heads // config.n_kv_heads
    qg = q[:, 0].reshape(b, config.n_kv_heads, rep, hd)
    if quant:
        scores = torch.einsum("bgrd,bgkd->bgrk", qg, lc["k"].to(qg.dtype)) \
            * lc["ks"][:, :, None, :] * hd ** -0.5
    else:
        scores = torch.einsum("bgrd,bgkd->bgrk", qg, lc["k"]) * hd ** -0.5
    t = lc["k"].shape[2]
    mask = torch.arange(t, device=x.device) <= pos   # positions written so far
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores.float(), dim=-1)
    if quant:
        out = torch.einsum("bgrk,bgkd->bgrd",
                           (probs * lc["vs"][:, :, None, :]).to(x.dtype),
                           lc["v"].to(x.dtype))
    else:
        out = torch.einsum("bgrk,bgkd->bgrd", probs.to(lc["v"].dtype), lc["v"])
    out = out.reshape(b, 1, config.n_heads * hd)
    return _mm(out, p["wo"]), lc


def decode_step(params: Dict, token: torch.Tensor, cache: Dict, pos: int,
                config: LlamaConfig) -> Tuple[torch.Tensor, Dict]:
    """token [B] + cache + position -> (logits [B, vocab] f32, cache).  The
    cache is updated in place and returned."""
    x = params["tok_emb"][token.long()][:, None, :]     # [B, 1, dim]
    for i, layer in enumerate(params["layers"]):
        h = _rms_norm(x, layer["attn_norm"], config.norm_eps)
        lc = {k: cache[k][i] for k in cache}
        attn, _ = _attention_decode(config, layer["attn"], h, lc, pos)
        x = x + attn
        x = x + _mlp(layer["mlp"],
                     _rms_norm(x, layer["mlp_norm"], config.norm_eps))
    x = _rms_norm(x, params["final_norm"], config.norm_eps)
    logits = _mm(x[:, 0, :], params["lm_head"]).float()
    return logits, cache


def prefill(params: Dict, prompt: torch.Tensor, config: LlamaConfig,
            cache_len: int) -> Tuple[torch.Tensor, Dict]:
    """Batched prefill: one full-sequence causal forward that also fills a
    KV cache of capacity ``cache_len``.  Returns (last-position logits
    [B, vocab] f32, cache)."""
    b, t = prompt.shape
    x = params["tok_emb"][prompt.long()]
    cache = init_kv_cache(config, b, max_len=cache_len, device=x.device)
    for i, layer in enumerate(params["layers"]):
        # the same layer body as forward() (honouring attn_impl), with the
        # post-rope K/V captured for the cache
        x, k, v = _layer(config, layer, x, return_kv=True)
        k_t = k.transpose(1, 2)                    # [B, n_kv, T, D]
        v_t = v.transpose(1, 2)
        if config.kv_quant:
            kq, ksc = _kv_quantize(k_t)
            vq, vsc = _kv_quantize(v_t)
            cache["k"][i][:, :, :t] = kq
            cache["ks"][i][:, :, :t] = ksc
            cache["v"][i][:, :, :t] = vq
            cache["vs"][i][:, :, :t] = vsc
        else:
            cache["k"][i][:, :, :t] = k_t.to(config.dtype)
            cache["v"][i][:, :, :t] = v_t.to(config.dtype)
    x = _rms_norm(x, params["final_norm"], config.norm_eps)
    logits = _mm(x[:, -1, :], params["lm_head"]).float()
    return logits, cache


def generate(params: Dict, prompt, steps: int, config: LlamaConfig,
             device: DeviceLike = "cuda") -> torch.Tensor:
    """Greedy generation: a batched prefill fills the cache, then
    ``steps - 1`` decode steps.  prompt: [B, T] integers -> [B, steps]
    tokens on ``device``, where the parameters must live too."""
    dev = resolve_device(device)
    emb = params["tok_emb"]
    if emb.device.type != dev.type:
        raise ValueError(f"parameters are on {emb.device}, generate was "
                         f"asked to run on {dev}")
    prompt = torch.as_tensor(prompt, device=emb.device)
    batch, prompt_len = prompt.shape
    logits, cache = prefill(params, prompt, config,
                            cache_len=prompt_len + steps)
    tok = torch.argmax(logits, dim=-1).to(prompt.dtype)
    out = [tok]
    # steps - 1 decode passes: the first generated token came from prefill
    for i in range(steps - 1):
        logits, cache = decode_step(params, tok, cache, prompt_len + i, config)
        tok = torch.argmax(logits, dim=-1).to(prompt.dtype)
        out.append(tok)
    return torch.stack(out, dim=1)[:, :steps]
