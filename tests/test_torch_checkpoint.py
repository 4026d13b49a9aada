"""The port's Checkpointer (tensorfusion_tpu_torch/models/checkpoint.py,
on torch.distributed.checkpoint): the resume-exactly contract of
tests/test_workloads.py:282 on a dp2/fsdp2/tp2 mesh of spawned gloo
ranks, max_to_keep, and the one-process use."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensorfusion_tpu.models import LlamaConfig as JaxConfig  # noqa: E402
from tensorfusion_tpu.models import init_params as jax_init  # noqa: E402
from tensorfusion_tpu.models import make_train_step as jax_make_train_step  # noqa: E402
from tensorfusion_tpu_torch.models import Checkpointer, llama  # noqa: E402
from tensorfusion_tpu_torch.parallel import RankGroup  # noqa: E402

import torch_rank_tasks as tasks  # noqa: E402

N = 8
AXES = {"fsdp": 2, "tp": 2, "dp": 2}


@pytest.fixture(scope="module")
def ranks():
    with RankGroup(N, device="cpu", backend="gloo", timeout_s=180) as group:
        yield group


def _port_config(jax_cfg):
    fields = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)}
    return llama.LlamaConfig(**{**fields, "dtype": torch.float32})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_checkpoint_save_restore_resumes_exactly(ranks, tmp_path):
    """Save params and optimizer state at step 3, restore onto a
    like-sharded target that took a step from another init, and the
    resumed step's loss equals the uninterrupted run's: bit for bit here,
    and the reference's fourth step at 2e-4."""
    cfg = JaxConfig.tiny()
    params = jax_init(cfg, jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, 256))
    batch = {"tokens": toks, "targets": toks}
    step, init_opt = jax_make_train_step(cfg, learning_rate=1e-2)
    step = jax.jit(step)
    p, o = params, init_opt(params)
    for _ in range(4):
        p, o, loss = step(p, o, {k: jnp.asarray(v) for k, v in batch.items()})
    got = ranks.run(tasks.checkpoint_resume, AXES, _port_config(cfg), _np_tree(params),
                    _np_tree(jax_init(cfg, jax.random.PRNGKey(9))), batch,
                    str(tmp_path / "ckpt"))
    for res in got:
        assert res["latest"] == 3
        assert res["resumed"] == res["continued"]
        np.testing.assert_allclose(res["continued"], float(loss), rtol=2e-4)
        assert res["extra"] == {"data_position": 3} and res["count"] == 3
        assert res["placements"] == ["R", "S(0)", "R", "S(1)"]    # P("fsdp", "tp")


def test_checkpoint_keeps_the_last_steps_and_restores_whole(ranks, tmp_path):
    cfg = JaxConfig.tiny()
    params = _np_tree(jax_init(cfg, jax.random.PRNGKey(0)))
    got = ranks.run(tasks.checkpoint_keep, AXES, _port_config(cfg), params,
                    str(tmp_path / "keep"), 2)
    res = got[0]
    assert res["steps"] == [4, 5] and res["latest"] == 5
    assert sorted(os.listdir(tmp_path / "keep")) == ["4", "5"]
    for a, b in zip(jax.tree_util.tree_leaves(res["restored"]),
                    jax.tree_util.tree_leaves(res["saved"]), strict=True):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_in_one_process(tmp_path, monkeypatch):
    """No process group: plain tensors, a relative directory made
    absolute, restore with and without a target, and an empty directory
    raising."""
    monkeypatch.chdir(tmp_path)
    cfg = _port_config(JaxConfig.tiny())
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, init_opt = llama.make_train_step(cfg, device="cpu")
    opt = init_opt(params)
    opt["count"] += 7
    ck = Checkpointer("relative")
    assert os.path.isabs(ck.directory) and ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()
    ck.save(7, params, opt)
    whole = ck.restore()
    assert "extra" not in whole and int(whole["opt_state"]["count"]) == 7
    target = {"params": llama.init_params(cfg, torch.Generator().manual_seed(1),
                                          device="cpu"),
              "opt_state": init_opt(params)}
    back = ck.restore(7, target=target)
    assert back["params"]["tok_emb"] is target["params"]["tok_emb"]
    for a, b, c in zip(llama._leaves(whole["params"]), llama._leaves(back["params"]),
                       llama._leaves(params), strict=True):
        assert torch.equal(a, c) and torch.equal(b, c)
    ck.close()
