"""The port's MoE (tensorfusion_tpu_torch/models/moe.py): unsharded
against the JAX reference for both dispatches, the capacity semantics,
and expert parallelism on 8 spawned gloo ranks with an overflowing
expert (tests/test_workloads.py:129-189, 327)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensorfusion_tpu.models import MoEConfig as JaxMoEConfig  # noqa: E402
from tensorfusion_tpu.models import init_moe_params as jax_init  # noqa: E402
from tensorfusion_tpu.models import moe_forward as jax_moe_forward  # noqa: E402
from tensorfusion_tpu.models import moe_loss_fn as jax_moe_loss_fn  # noqa: E402
from tensorfusion_tpu.models.moe import _moe_block as jax_moe_block  # noqa: E402
from tensorfusion_tpu.models.moe import _route as jax_route  # noqa: E402
from tensorfusion_tpu_torch.models import moe  # noqa: E402
from tensorfusion_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from tensorfusion_tpu_torch.parallel import RankGroup  # noqa: E402

import torch_rank_tasks as tasks  # noqa: E402

N = 8


@pytest.fixture(scope="module")
def ranks():
    with RankGroup(N, device="cpu", backend="gloo", timeout_s=180) as group:
        yield group


def _cfg(**over):
    return dataclasses.replace(JaxMoEConfig.tiny(n_experts=4), **over)


def _port_cfg(jax_cfg):
    fields = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)}
    return moe.MoEConfig(**{**fields, "dtype": torch.float32})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(shape, seed=1):
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, 256))


def _jax_dropped(cfg, p, x):
    """Entries past capacity, from the reference's own routing."""
    t = x.shape[0] * x.shape[1]
    _, top_i = jax_route(cfg, p, x.reshape(t, -1))
    flat = np.asarray(top_i).reshape(-1)
    seen, dropped = {}, 0
    for e in flat:
        dropped += seen.get(e, 0) >= cfg.capacity(t)
        seen[e] = seen.get(e, 0) + 1
    return dropped


@pytest.mark.parametrize("dispatch", ["scatter", "dense"])
@pytest.mark.parametrize("cap", [1.25, 0.5, 0.25], ids=["roomy", "overflow", "tight"])
def test_moe_block_matches_reference(dispatch, cap):
    """Routing, first-come capacity slots and the combine equal the
    reference's for each dispatch, with and without overflow; the
    dropped count equals the reference routing's."""
    cfg = _cfg(capacity_factor=cap, dispatch_impl=dispatch)
    params = jax_init(cfg, jax.random.PRNGKey(0))
    p = params["layers"][0]["moe"]
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 16, cfg.dim)))
    want = jax_moe_block(cfg, p, jnp.asarray(x))
    port_p = params_from_numpy(_np_tree(p), device="cpu")
    stats = {}
    got = moe._moe_block(_port_cfg(cfg), port_p, torch.from_numpy(x), stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert stats["dropped"] == _jax_dropped(cfg, p, jnp.asarray(x))
    assert (stats["dropped"] > 0) == (cap < 1.25)


@pytest.mark.parametrize("cap", [1.25, 0.5])
def test_scatter_dispatch_matches_dense_through_the_gradient(cap):
    """tests/test_workloads.py:327 in the port: the two dispatches agree
    in value (1e-5) and in every parameter's gradient (2e-4)."""
    cfg = _port_cfg(_cfg(capacity_factor=cap))
    params = moe.init_moe_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p = params["layers"][0]["moe"]
    x = torch.randn((2, 16, cfg.dim), generator=torch.Generator().manual_seed(1))
    dense = dataclasses.replace(cfg, dispatch_impl="dense")
    np.testing.assert_allclose(moe._moe_block(cfg, p, x).numpy(),
                               moe._moe_block(dense, p, x).numpy(), rtol=1e-5, atol=1e-5)
    leaves = list(p.values())

    def grads(c):
        for w in leaves:
            w.requires_grad_(True)
        try:
            return torch.autograd.grad(moe._moe_block(c, p, x).sum(), leaves)
        finally:
            for w in leaves:
                w.requires_grad_(False)

    for name, gs, gd in zip(p, grads(cfg), grads(dense)):
        np.testing.assert_allclose(gs.numpy(), gd.numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("dispatch", ["scatter", "dense"])
def test_moe_forward_and_loss_match_reference(dispatch):
    cfg = _cfg(dispatch_impl=dispatch)
    params = jax_init(cfg, jax.random.PRNGKey(0))
    toks = _tokens((2, 17))
    want = jax_moe_forward(params, jnp.asarray(toks[:, :-1]), cfg)
    want_loss = jax_moe_loss_fn(params, {"tokens": jnp.asarray(toks[:, :-1]),
                                         "targets": jnp.asarray(toks[:, 1:])}, cfg)
    port = params_from_numpy(_np_tree(params), device="cpu")
    t = torch.from_numpy(toks)
    got = moe.moe_forward(port, t[:, :-1], _port_cfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    loss = moe.moe_loss_fn(port, {"tokens": t[:, :-1], "targets": t[:, 1:]}, _port_cfg(cfg))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=2e-4)


def test_capacity_drops_overflow_tokens():
    """tests/test_workloads.py:175: with a tiny capacity the block still
    gives finite outputs (dropped entries ride the residual)."""
    cfg = _port_cfg(_cfg(n_experts=2, capacity_factor=0.25))
    params = moe.init_moe_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((2, 8, cfg.dim), generator=torch.Generator().manual_seed(1))
    stats = {}
    y = moe._moe_block(cfg, params["layers"][0]["moe"], x, stats=stats)
    assert y.shape == x.shape and torch.isfinite(y).all()
    # 32 entries, capacity 2 for each of the 2 experts: 28 dropped
    assert stats["dropped"] == 2 * 16 - 2 * cfg.capacity(16)


def test_unsharded_train_step_learns():
    cfg = _port_cfg(_cfg())
    params = moe.init_moe_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    step, init_opt = moe.make_moe_train_step(cfg, learning_rate=1e-2, device="cpu")
    opt = init_opt(params)
    toks = torch.from_numpy(_tokens((4, 16)))
    batch = {"tokens": toks, "targets": toks}
    losses = []
    for _ in range(5):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("axes", [{"dp": 2, "ep": 4}, {"fsdp": 2, "ep": 4},
                                  {"ep": 8}], ids=["dp2-ep4", "fsdp2-ep4", "ep8"])
def test_moe_expert_parallel_matches_unsharded_with_overflow(ranks, axes):
    """tests/test_workloads.py:129 with an overflowing expert: the
    expert-parallel forward equals the reference's unsharded one at 2e-4,
    and the entries dropped over the whole batch equal the unsharded
    count: capacity is global, not per data shard."""
    cfg = _cfg(capacity_factor=0.5, n_experts=8 if axes.get("ep") == 8 else 4)
    params = jax_init(cfg, jax.random.PRNGKey(0))
    toks = _tokens((4, 16))
    want = jax_moe_forward(params, jnp.asarray(toks), cfg)
    stats = {}
    moe.moe_forward(params_from_numpy(_np_tree(params), device="cpu"),
                    torch.from_numpy(toks), _port_cfg(cfg), stats=stats)
    assert stats["dropped"] > 0
    got = ranks.run(tasks.moe_ep_forward, axes, _port_cfg(cfg), _np_tree(params), toks)
    for res in got:
        np.testing.assert_allclose(res["logits"], np.asarray(want), rtol=2e-4, atol=2e-4)
    # the ranks of one ep line share their tokens: count each data rank once
    assert sum(r["dropped"] for r in got if r["ep"] == 0) == stats["dropped"]
    # experts shard over ep, the mesh's last axis here, and nothing else
    assert got[0]["w_gate"] == ["R"] * (len(axes) - 1) + ["S(0)"]


def test_moe_train_step_learns_expert_parallel(ranks):
    """tests/test_workloads.py:151: dp2 x ep4, the loss falls; the first
    loss equals the reference's."""
    cfg = _cfg()
    params = jax_init(cfg, jax.random.PRNGKey(0))
    toks = _tokens((4, 16)).astype(np.int32)
    batch = {"tokens": toks, "targets": toks}
    want = jax_moe_loss_fn(params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    got = ranks.run(tasks.moe_train_steps, {"dp": 2, "ep": 4}, _port_cfg(cfg),
                    _np_tree(params), batch, 5, 1e-2)
    for res in got:
        np.testing.assert_allclose(res["losses"][0], float(want), rtol=2e-4)
        assert res["losses"][-1] < res["losses"][0], res["losses"]
