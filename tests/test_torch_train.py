"""The port's Llama training path against the JAX package's, on the CPU.

Weights come from the JAX package's ``init_params`` and cross to the port
through numpy; tokens, masks and gradients are numpy.  The JAX side runs
its flash path through the Pallas kernels in interpret mode (its
``attn_impl="flash"`` picks the dense reference off a TPU, so the tests
hand its ``flash_attention`` the interpret backend), the port its plain
versions.  "f32" means max|port − jax| <= 1e-4 · max|jax| per leaf.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import tensorfusion_tpu.ops as jax_ops  # noqa: E402
from tensorfusion_tpu.models import llama as jl  # noqa: E402
from tensorfusion_tpu_torch import bench_train  # noqa: E402
from tensorfusion_tpu_torch.models import convert  # noqa: E402
from tensorfusion_tpu_torch.models import llama as tl  # noqa: E402

torch.set_num_threads(1)

TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _configs(**kw):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), **kw)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tl.LlamaConfig)}
    fields["dtype"] = TORCH_DTYPES[jcfg.dtype]
    return jcfg, tl.LlamaConfig(**fields)


def _params(jcfg, seed=0):
    jp = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")
    return jp, tp


def _batch(shape, vocab, seed=1, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, shape).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    if mask:
        batch["mask"] = (rng.random(shape) < 0.7).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _assert_f32(got, want, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), f"{name}: max|Δ| {err}"


def _assert_trees(got_tree, want_tree, check):
    """``check`` on every leaf of two trees of one structure, by path."""
    def walk(g, w, path):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for key in w:
                walk(g[key], w[key], f"{path}/{key}")
        elif isinstance(w, (list, tuple)):
            assert len(g) == len(w), path
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{path}/{i}")
        else:
            check(g, w, path)
    walk(got_tree, want_tree, "")


@pytest.fixture()
def interpret_flash(monkeypatch):
    """JAX's flash path through its Pallas kernels in interpret mode."""
    monkeypatch.setattr(jax_ops, "flash_attention", functools.partial(
        jax_ops.flash_attention, backend="interpret"))


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("attn_impl,shape", [("full", (2, 16)), ("flash", (1, 128)),
                                             ("chunked", (2, 40))])
def test_loss_and_every_gradient_leaf_match_jax(attn_impl, shape, mask,
                                                interpret_flash):
    jcfg, tcfg = _configs(attn_impl=attn_impl, attn_block=16)
    jp, tp = _params(jcfg)
    jb, tb = _batch(shape, jcfg.vocab_size, mask=mask)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        functools.partial(jl.loss_fn, config=jcfg)))(jp, jb)
    loss, grads = tl.value_and_grad(tp, tb, tcfg)
    assert loss.shape == () and loss.dtype == torch.float32
    _assert_f32(loss.numpy(), want_loss, "loss")
    _assert_trees(convert.params_to_numpy(tl._unflatten(tp, grads)),
                  jax.tree_util.tree_map(np.asarray, want_grads),
                  lambda g, w, path: _assert_f32(g, w, path))


def test_loss_fn_matches_jax_without_grad():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, seed=2)
    jb, tb = _batch((2, 16), jcfg.vocab_size, seed=3, mask=True)
    want = jax.jit(functools.partial(jl.loss_fn, config=jcfg))(jp, jb)
    _assert_f32(tl.loss_fn(tp, tb, tcfg).numpy(), want)


@pytest.mark.parametrize("attn_impl", ["full", "flash"])
def test_remat_gives_the_same_loss_and_gradients(attn_impl):
    _, tcfg = _configs(attn_impl=attn_impl)
    jcfg, _ = _configs()
    _, tp = _params(jcfg, seed=4)
    _, tb = _batch((2, 32), tcfg.vocab_size, seed=5)
    loss, grads = tl.value_and_grad(tp, tb, tcfg)
    loss_r, grads_r = tl.value_and_grad(tp, tb, dataclasses.replace(tcfg, remat=True))
    torch.testing.assert_close(loss_r, loss, rtol=1e-6, atol=0)
    for g, r in zip(grads, grads_r):
        torch.testing.assert_close(r, g, rtol=1e-5, atol=1e-7)
    assert not any(p.requires_grad for p in tl._leaves(tp))


def test_adamw_matches_optax():
    """The same params and numpy gradients through the port's update and
    optax.adamw's, 3 steps: params and both moments at rtol 1e-5."""
    import optax

    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, seed=6)
    rng = np.random.default_rng(7)
    tx = optax.adamw(1e-2, b1=0.9, b2=0.95, weight_decay=0.1)
    jstate = tx.init(jp)
    _, init = tl.make_train_step(tcfg, learning_rate=1e-2, device="cpu")
    tstate = init(tp)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), jp)
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                    jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tgrads = tl._leaves(convert.params_from_numpy(grads, device="cpu"))
        tl.adamw_update_(tl._leaves(tp), tgrads, tstate, 1e-2)
    assert int(tstate["count"]) == 3

    def close(g, w, path):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=path)

    adam = jstate[0]
    for got, want in ((tp, jp), (tstate["mu"], adam.mu), (tstate["nu"], adam.nu)):
        _assert_trees(convert.params_to_numpy(got),
                      jax.tree_util.tree_map(np.asarray, want), close)


def test_train_step_matches_jax_over_five_steps():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, seed=8)
    jb, tb = _batch((4, 16), jcfg.vocab_size, seed=9)
    jstep, jinit = jl.make_train_step(jcfg, learning_rate=1e-2)
    tstep, tinit = tl.make_train_step(tcfg, learning_rate=1e-2, device="cpu")
    jstep = jax.jit(jstep)
    jo, to = jinit(jp), tinit(tp)
    for i in range(5):
        jp, jo, jloss = jstep(jp, jo, jb)
        tp2, to2, tloss = tstep(tp, to, tb)
        assert tp2 is tp and to2 is to, "the step updates in place"
        _assert_f32(tloss.numpy(), jloss, f"loss at step {i}")


def test_train_step_learns():
    """tests/test_workloads.py:41-54 for the port."""
    jcfg, tcfg = _configs()
    _, tp = _params(jcfg)
    step, init = tl.make_train_step(tcfg, learning_rate=1e-2, device="cpu")
    state = init(tp)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (4, 16)))
    batch = {"tokens": toks, "targets": toks}
    losses = []
    for _ in range(10):
        tp, state, loss = step(tp, state, batch)
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.5, f"no learning: {losses}"


def _matmul_params(params):
    """Parameters of the matrix products: every 2-D weight but tok_emb."""
    return sum(p.numel() for p in tl._leaves(params) if p.dim() == 2) \
        - params["tok_emb"].numel()


def test_metered_train_step_is_charged_once_per_call(limiter_lib, tmp_path):
    jcfg, tcfg = _configs(attn_impl="flash")
    _, tp = _params(jcfg)
    step, init = tl.make_train_step(tcfg, device="cpu")
    state = init(tp)
    _, tb = _batch((4, 16), tcfg.vocab_size)
    before = tp["lm_head"].clone()
    with bench_train.worker_segment(limiter_lib, tmp_path / "segment", "w",
                                    device="cpu") as client:
        metered = client.meter(step)
        for _ in range(3):
            tp, state, loss = metered(tp, state, tb)
    assert not (tmp_path / "segment").exists()
    assert client.launches == 3 and int(state["count"]) == 3
    assert not torch.equal(tp["lm_head"], before)
    per_step = client.charged_mflops // 3
    assert client.charged_mflops == 3 * per_step
    floor = 6 * _matmul_params(tp) * 4 * 16 / 1e6
    assert per_step >= floor > 1, (per_step, floor)


def test_bench_train_runs_on_cpu(limiter_lib, capsys):
    _, tcfg = _configs(attn_impl="flash")
    result = bench_train.run(config=tcfg, batch=2, seq=32, steps=4, rounds=2,
                             device="cpu", limiter_lib=limiter_lib)
    line = json.loads(json.dumps(result))
    for key in ("metric", "value", "noise_band_pct", "native_step_ms",
                "metered_step_ms", "model_tflops_per_step",
                "charged_mflops_per_step", "mfu_native_pct", "mfu_metered_pct",
                "chip_peak_tflops", "nvidia_smi"):
        assert key in line
    assert line["metric"] == "vtpu_soft_isolation_overhead_pct"
    assert line["device"] == "cpu" and line["mfu_native_pct"] is None
    assert line["native_step_ms"] > 0 and line["metered_step_ms"] > 0
    assert line["charged_mflops_per_step"] == int(line["model_tflops_per_step"] * 1e6)


def test_bench_step_is_bench_py_s():
    """Loss, gradient and p - 1e-4·g, returning new parameters."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, seed=10)
    jb, tb = _batch((2, 16), jcfg.vocab_size, seed=11)
    new, loss = bench_train.make_step(tcfg)(tp, tb)
    want_loss, grads = jax.jit(jax.value_and_grad(
        functools.partial(jl.loss_fn, config=jcfg)))(jp, jb)
    want = jax.tree_util.tree_map(lambda p, g: p - 1e-4 * g, jp, grads)
    _assert_f32(loss.numpy(), want_loss, "loss")
    _assert_trees(convert.params_to_numpy(new),
                  jax.tree_util.tree_map(np.asarray, want),
                  lambda g, w, path: np.testing.assert_allclose(
                      g, w, rtol=1e-5, atol=1e-7, err_msg=path))


def test_params_to_numpy_round_trips_bf16_and_f32():
    for dtype in (jnp.float32, jnp.bfloat16):
        jcfg, _ = _configs(dtype=dtype)
        jp, tp = _params(jcfg)
        back = convert.params_to_numpy(tp)
        assert back["tok_emb"].dtype == np.asarray(jp["tok_emb"]).dtype
        _assert_trees(back, jax.tree_util.tree_map(np.asarray, jp),
                      lambda g, w, path: np.testing.assert_array_equal(
                          g.astype(np.float32), w.astype(np.float32), err_msg=path))


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.make_train_step(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_train.run(config=tcfg)
    step, init = tl.make_train_step(tcfg, device="cpu")
    assert callable(step) and callable(init)
