"""The port's sharded Llama (param_specs, shard_params, mesh= through
forward, loss_fn, value_and_grad and make_train_step) on 8 spawned gloo
ranks, against the JAX reference on its 8-device CPU mesh
(tests/test_workloads.py:57) and unsharded: the sharded result equals the
unsharded one, as GSPMD's does."""

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
from tensorfusion_tpu.models import make_train_step as jax_make_train_step  # noqa: E402
from tensorfusion_tpu.models.quantize import quantize_weights_int8 as jax_quantize  # noqa: E402
from tensorfusion_tpu_torch.models import llama  # noqa: E402
from tensorfusion_tpu_torch.parallel import RankGroup  # noqa: E402

import torch_rank_tasks as tasks  # noqa: E402

N = 8
RTOL = ATOL = 2e-4


@pytest.fixture(scope="module")
def ranks():
    with RankGroup(N, device="cpu", backend="gloo", timeout_s=180) as group:
        yield group


def _port_config(jax_cfg, **over):
    fields = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)}
    fields["dtype"] = torch.float32
    fields.update(over)
    return llama.LlamaConfig(**fields)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(masked):
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 17), 0, 256))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "targets": toks[:, 1:].astype(np.int32)}
    if masked:
        mask = np.ones((8, 16), np.float32)
        mask[:, 11:] = 0.0
        mask[3] = 0.0
        batch["mask"] = mask
    return batch


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_sharded_train_step_dp_fsdp_tp_matches_jax(ranks, masked):
    """dp2/fsdp2/tp2: the loss and gradients of the first batch and the
    parameters after two AdamW steps equal the reference's at 2e-4, and
    the parameters keep their placements through the steps."""
    cfg = JaxConfig.tiny()
    params = jax_init(cfg, jax.random.PRNGKey(0))
    batch = _batch(masked)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(jax_loss_fn)(params, jbatch, cfg)
    step, init_opt = jax_make_train_step(cfg, learning_rate=1e-2)
    step = jax.jit(step)
    p, o, losses = params, init_opt(params), []
    for _ in range(2):
        p, o, step_loss = step(p, o, jbatch)
        losses.append(float(step_loss))

    got = ranks.run(tasks.llama_train_steps, {"dp": 2, "fsdp": 2, "tp": 2},
                    _port_config(cfg), _np_tree(params), batch, 2, 1e-2)
    for res in got:         # every rank reports the loss of the whole batch
        np.testing.assert_allclose(res["loss"], float(loss), rtol=RTOL)
        np.testing.assert_allclose(res["losses"], losses, rtol=RTOL)
    res = got[0]
    for g, want in zip(res["grads"], jax.tree_util.tree_leaves(grads), strict=True):
        np.testing.assert_allclose(g, np.asarray(want), rtol=RTOL, atol=ATOL)
    # AdamW's first step moves an element by lr·g/(|g| + 1e-8): where the
    # reference's gradient is under 1e-6 (a few hundred times eps) the
    # direction is set by f32 rounding of a near-zero sum (the unsharded
    # port misses the reference there as much), so those elements are
    # held to the optimizer's step bound, lr a step, and the rest to 2e-4
    for (path, want), q, g in zip(jax.tree_util.tree_leaves_with_path(p),
                                  jax.tree_util.tree_leaves(res["params"]),
                                  jax.tree_util.tree_leaves(grads), strict=True):
        want, g = np.asarray(want), np.abs(np.asarray(g))
        resolved = (g >= 1e-6) | (g == 0)      # a zero gradient is exact
        np.testing.assert_allclose(q[resolved], want[resolved], rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))
        assert np.all(np.abs(q - want)[~resolved] <= 2 * 2 * 1e-2), path
        assert resolved.mean() > 0.99, path
    wq = ["R", "S(0)", "R", "S(1)"]          # (dp, fsdp, sp, tp): P("fsdp", "tp")
    assert res["placements"] == (wq, wq, wq)
    # every gradient is a DTensor placed as its parameter
    assert all(g == q for g, q in res["grad_placements"])
    assert ["R", "S(1)", "R", "S(0)"] in [q for _, q in res["grad_placements"]]   # wo


@pytest.mark.parametrize("axes", [{"dp": 2, "fsdp": 2, "tp": 2}, {"fsdp": 8},
                                  {"dp": 4, "tp": 2}, {"dp": 8}],
                         ids=["dp2-fsdp2-tp2", "fsdp8", "dp4-tp2", "dp8"])
def test_sharded_forward_and_loss_match_jax(ranks, axes):
    cfg = JaxConfig.tiny()
    params = jax_init(cfg, jax.random.PRNGKey(2))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (8, 13), 0, 256))
    want = jax_forward(params, jnp.asarray(toks[:, :-1]), cfg)
    want_loss = jax_loss_fn(params, {"tokens": jnp.asarray(toks[:, :-1]),
                                     "targets": jnp.asarray(toks[:, 1:])}, cfg)
    got = ranks.run(tasks.llama_forward, axes, _port_config(cfg), _np_tree(params), toks)
    for res in got:
        np.testing.assert_allclose(res["logits"], np.asarray(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res["loss"], float(want_loss), rtol=RTOL)


def test_quantized_params_shard_on_mesh(ranks):
    """tests/test_workloads.py:477: a quantized tree places like a plain
    one (the int8 matrix by the weight's spec, the scale by its output
    axis) and its sharded forward equals the reference's quantized one."""
    cfg = JaxConfig.tiny()
    params = jax_init(cfg, jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 9), 0, 256))
    want = jax_forward(jax_quantize(params), jnp.asarray(toks[:, :-1]), cfg)
    got = ranks.run(tasks.llama_forward, {"fsdp": 2, "tp": 2}, _port_config(cfg),
                    _np_tree(params), toks, True)
    # the mesh {"fsdp": 2, "tp": 2} on 8 ranks is dp1 fsdp4 sp1 tp2
    assert got[0]["placements"] == (["R", "S(0)", "R", "S(1)"], ["R", "R", "R", "S(0)"])
    for res in got:
        np.testing.assert_allclose(res["logits"], np.asarray(want), rtol=RTOL, atol=ATOL)


def test_tp_must_divide_kv_heads(ranks):
    cfg = JaxConfig.tiny()          # 2 kv heads
    params = jax_init(cfg, jax.random.PRNGKey(0))
    toks = np.zeros((8, 9), np.int32)
    with pytest.raises(RuntimeError, match="must divide n_kv_heads"):
        ranks.run(tasks.llama_forward, {"tp": 4}, _port_config(cfg), _np_tree(params), toks)


def test_ranks_are_back_after_a_failure():
    """A failed call closes its group (the fixture's group above is gone
    after test_tp_must_divide_kv_heads), and a new group starts cleanly."""
    cfg = JaxConfig.tiny()
    params = jax_init(cfg, jax.random.PRNGKey(4))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (2, 9), 0, 256))
    want = jax_forward(params, jnp.asarray(toks[:, :-1]), cfg)
    with RankGroup(2, device="cpu", backend="gloo", timeout_s=120) as group:
        got = group.run(tasks.llama_forward, {"tp": 2}, _port_config(cfg),
                        _np_tree(params), toks)
    for res in got:
        np.testing.assert_allclose(res["logits"], np.asarray(want), rtol=RTOL, atol=ATOL)
