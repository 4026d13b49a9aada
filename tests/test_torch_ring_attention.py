"""The port's ring attention (tensorfusion_tpu_torch/parallel/
ring_attention.py) and Llama with attn_impl="ring" on a sequence-sharded
mesh, on 8 spawned gloo ranks, against the JAX reference on its 8-device
CPU mesh (tests/test_workloads.py:82-127, tests/test_ops.py:53)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensorfusion_tpu.models import LlamaConfig as JaxConfig  # noqa: E402
from tensorfusion_tpu.models import forward as jax_forward  # noqa: E402
from tensorfusion_tpu.models import init_params as jax_init  # noqa: E402
from tensorfusion_tpu.models import loss_fn as jax_loss_fn  # noqa: E402
from tensorfusion_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from tensorfusion_tpu.parallel import ring_attention_sharded as jax_ring  # noqa: E402
from tensorfusion_tpu_torch.models import llama  # noqa: E402
from tensorfusion_tpu_torch.parallel import RankGroup  # noqa: E402

import torch_rank_tasks as tasks  # noqa: E402

N = 8


@pytest.fixture(scope="module")
def ranks():
    with RankGroup(N, device="cpu", backend="gloo", timeout_s=180) as group:
        yield group


def _qkv(seed, shape, dtype=jnp.float32):
    return [np.asarray(jax.random.normal(k, shape, dtype))
            for k in jax.random.split(jax.random.PRNGKey(seed), 3)]


def _dense(q, k, v, causal):
    d = q.shape[-1]
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * d ** -0.5
    if causal:
        t = q.shape[2]
        s = jnp.where(jnp.tril(jnp.ones((t, t), bool))[None, None], s, -1e30)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1), v)


@pytest.mark.parametrize("axes,shape,causal,seed", [
    ({"sp": 4}, (2, 4, 64, 16), True, 0),
    ({"sp": 8}, (1, 2, 64, 8), False, 7),
    ({"sp": 2, "tp": 2}, (2, 4, 32, 16), True, 3),
], ids=["sp4-causal", "sp8-full", "sp2-tp2-fsdp2"])
def test_ring_attention_matches_reference(ranks, axes, shape, causal, seed):
    """tests/test_workloads.py:82 and :102: ring against full attention at
    rtol 2e-4 / atol 2e-5, on every rank; and against the reference's
    ring."""
    q, k, v = _qkv(seed, shape)
    want = np.asarray(_dense(q, k, v, causal))
    ref_ring = np.asarray(jax_ring(q, k, v, jax_make_mesh(axes), causal=causal))
    got = ranks.run(tasks.ring, axes, q, k, v, causal, None)
    for res in got:
        np.testing.assert_allclose(res["out"], want, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(res["out"], ref_ring, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_gradients_match_the_reference_vjp(ranks, causal):
    """The second ring pass (dK/dV riding home) against the reference's
    custom VJP and against dense gradients, at the reference's ring
    gradient tolerance (tests/test_ops.py: rtol 5e-4, atol 5e-5)."""
    b, h, t, d = 2, 2, 64, 16
    q, k, v = _qkv(3, (b, h, t, d))
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (b, h, t, d)))
    mesh = jax_make_mesh({"sp": 4})
    ref = jax.grad(lambda q, k, v: (jax_ring(q, k, v, mesh, causal=causal) * w).sum(),
                   argnums=(0, 1, 2))(q, k, v)
    dense = jax.grad(lambda q, k, v: (_dense(q, k, v, causal) * w).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    got = ranks.run(tasks.ring, {"sp": 4}, q, k, v, causal, w)
    for res in got:
        for g, r, dn in zip(res["grads"], ref, dense):
            np.testing.assert_allclose(g, np.asarray(r), rtol=5e-4, atol=5e-5)
            np.testing.assert_allclose(g, np.asarray(dn), rtol=5e-4, atol=5e-5)


def test_ring_bf16_at_scale_tracks_f32(ranks):
    """tests/test_ops.py:53: the f32 running state holds across 8 ring
    steps in bf16."""
    q, k, v = _qkv(8, (2, 4, 1024, 64), jnp.bfloat16)
    full = np.asarray(_dense(*(jnp.asarray(x, jnp.float32) for x in (q, k, v)), True))
    got = ranks.run(tasks.ring, {"dp": 1, "fsdp": 1, "sp": 8, "tp": 1},
                    *(x.view(np.uint16) for x in (q, k, v)), True, "bf16")
    for res in got:
        assert res["dtype"] == "torch.bfloat16"
        err = np.abs(res["out"] - full).max()
        assert err < 2e-2, f"ring bf16 error {err} across 8 ring steps"


def _port_config(jax_cfg):
    fields = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)}
    return llama.LlamaConfig(**{**fields, "dtype": torch.float32})


def test_llama_with_ring_attention_matches_full(ranks):
    """tests/test_workloads.py:115: the sequence-sharded forward (global
    RoPE positions, causal ring) equals the full one at 5e-4, and so does
    its loss."""
    cfg_full = JaxConfig.tiny(attn_impl="full")
    params = jax_init(cfg_full, jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 65), 0, 256))
    want = jax_forward(params, jnp.asarray(toks[:, :-1]), cfg_full)
    got = ranks.run(tasks.llama_forward, {"sp": 4},
                    _port_config(JaxConfig.tiny(attn_impl="ring")),
                    jax.tree_util.tree_map(np.asarray, params), toks)
    want_loss = jax_loss_fn(params, {"tokens": jnp.asarray(toks[:, :-1]),
                                     "targets": jnp.asarray(toks[:, 1:])}, cfg_full)
    for res in got:
        np.testing.assert_allclose(res["logits"], np.asarray(want), rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(res["loss"], float(want_loss), rtol=5e-4)


def test_llama_ring_attention_trains_like_full(ranks):
    """Gradients flow through the ring inside the model: the sp4 (x fsdp2)
    loss and gradients equal the reference's full-attention ones."""
    cfg_full = JaxConfig.tiny(attn_impl="full")
    params = jax_init(cfg_full, jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 33), 0, 256))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "targets": toks[:, 1:].astype(np.int32)}
    loss, grads = jax.value_and_grad(jax_loss_fn)(
        params, {k: jnp.asarray(x) for k, x in batch.items()}, cfg_full)
    got = ranks.run(tasks.llama_train_steps, {"sp": 4},
                    _port_config(JaxConfig.tiny(attn_impl="ring")),
                    jax.tree_util.tree_map(np.asarray, params), batch, 1, 1e-2)
    res = got[0]
    np.testing.assert_allclose(res["loss"], float(loss), rtol=5e-4)
    for g, want in zip(res["grads"], jax.tree_util.tree_leaves(grads), strict=True):
        np.testing.assert_allclose(g, np.asarray(want), rtol=5e-4, atol=5e-4)
