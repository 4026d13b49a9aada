"""The port's attention backward against the JAX package's, on the CPU.

The same numpy inputs go to both: the JAX side runs its Pallas kernels in
interpret mode (as tests/test_ops.py does), the port its plain versions
(which CPU tensors take).  "f32" means max|port − jax| <= 1e-4 · max|jax|
per tensor: the gradients sum over time in another order than XLA's, and
the JAX package's own gradient tolerance, 2e-3 (tests/test_ops.py:206-208),
is the ceiling.  The Hopper kernels themselves run only on the card:
tests/test_torch_kernels_gpu.py and chip_smoke.py hold them against the
plain version there.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tensorfusion_tpu.ops import chunked_attention as jax_chunked  # noqa: E402
from tensorfusion_tpu.ops import flash_attention as jax_flash  # noqa: E402
from tensorfusion_tpu.ops.flash_attention import (  # noqa: E402
    _flash_bwd_pallas, _flash_fwd_pallas)
from tensorfusion_tpu_torch.ops import (chunked_attention,  # noqa: E402
                                        flash_attention, flash_attention_fwd)

# the modules (the package re-exports functions of the same names)
port_flash_mod = importlib.import_module("tensorfusion_tpu_torch.ops.flash_attention")
port_chunked_mod = importlib.import_module(
    "tensorfusion_tpu_torch.ops.chunked_attention")

torch.set_num_threads(1)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qkv(shape, seed=0):
    return [_randn(shape, seed + i) for i in range(3)]


def _assert_f32(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), f"{name}: max|Δ| {err}"


def _cotangent(shape):
    """The non-uniform cotangent of tests/test_ops.py:192-197."""
    size = int(np.prod(shape))
    return np.sin(np.arange(size, dtype=np.float32)).reshape(shape)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,d", [(128, 32), (256, 64), (100, 32)])
def test_plain_bwd_matches_pallas_kernels(causal, t, d):
    q, k, v = _qkv((2, t, d))
    do = _randn((2, t, d), 9)
    scale = d ** -0.5
    out, lse = _flash_fwd_pallas(*(jnp.asarray(x) for x in (q, k, v)), scale,
                                 causal, interpret=True)
    lse = np.array(lse)     # a writable copy, as torch.from_numpy wants
    delta = (do * np.asarray(out)).sum(-1)
    want = _flash_bwd_pallas(*(jnp.asarray(x) for x in (q, k, v, do, lse, delta)),
                             scale, causal, interpret=True)
    got = port_flash_mod.flash_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, do, lse, delta)), scale, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        _assert_f32(g.numpy(), w, name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 128, 32), (1, 2, 128, 32)])
def test_autograd_through_flash_matches_jax_grad(causal, shape):
    """The port's autograd rule (forward op, then the dq and dkv ops)
    against jax.grad through the Pallas custom VJP, 3-D and 4-D layouts."""
    q, k, v = _qkv(shape, seed=3)
    w = _cotangent(shape)

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, backend="interpret") * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*xs, causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), xs)
    for name, g, wnt in zip("qkv", got, want):
        _assert_f32(g.numpy(), wnt, f"d{name}")


def test_bf16_gradients_track_f32():
    """bf16 through the autograd rule against the f32 dense gradients,
    on the rule of tests/test_ops.py:211-231 (mean|err| / mean|ref| <
    0.1 per gradient)."""
    qf, kf, vf = (x * 0.5 for x in _qkv((4, 256, 64), seed=11))

    def jloss(q, k, v):
        return jnp.mean(jax_flash(q, k, v, backend="ref").astype(jnp.float32) ** 2)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (qf, kf, vf)))
    xs = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (qf, kf, vf)]
    out = flash_attention(*xs)
    got = torch.autograd.grad((out.float() ** 2).mean(), xs)
    for name, g, r in zip("qkv", got, ref):
        assert g.dtype == torch.bfloat16
        err = np.abs(g.float().numpy() - np.asarray(r))
        scale = np.abs(np.asarray(r)).mean() + 1e-6
        assert err.mean() / scale < 0.1, f"d{name} drift {err.mean() / scale}"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,block", [(128, 32), (100, 32)])
def test_chunked_backward_matches_jax(causal, t, block):
    """The chunked custom backward against jax.grad through the
    reference's custom VJP; ragged T = 100 exercises the padding and the
    non-causal valid_len key mask."""
    shape = (1, 2, t, 16)
    q, k, v = _qkv(shape, seed=5)
    w = _cotangent(shape)

    def jloss(q, k, v):
        return jnp.sum(jax_chunked(q, k, v, causal=causal, block=block) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = chunked_attention(*xs, causal=causal, block=block)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), xs)
    for name, g, wnt in zip("qkv", got, want):
        _assert_f32(g.numpy(), wnt, f"d{name}")


def test_chunked_backward_keeps_no_block_probabilities():
    """Autograd saves q, k, v, out and lse, not the blocks' scores."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv((1, 2, 128, 16), seed=6))
    out = chunked_attention(q, k, v, block=32)
    saved = out.grad_fn.saved_tensors
    assert [tuple(x.shape) for x in saved] == [(1, 2, 128, 16)] * 4 + [(1, 2, 128)]


def test_ragged_flash_reroute_is_differentiable(monkeypatch):
    """T = 130 takes the chunked path (tests/test_ops.py:102-108), and
    its gradients match JAX's through the same reroute."""
    calls = []
    real = port_chunked_mod.chunked_attention

    def spy(*a, **kw):
        calls.append(kw.get("block"))
        return real(*a, **kw)

    monkeypatch.setattr(port_chunked_mod, "chunked_attention", spy)
    monkeypatch.setattr(port_flash_mod, "_warned_ragged", False)
    q, k, v = _qkv((2, 130, 32), seed=7)
    w = _cotangent(q.shape)
    want = jax.grad(lambda q: jnp.sum(jax_flash(
        q, jnp.asarray(k), jnp.asarray(v), backend="interpret") * w))(jnp.asarray(q))
    xq = torch.from_numpy(q).requires_grad_()
    out = flash_attention(xq, torch.from_numpy(k), torch.from_numpy(v))
    (got,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [xq])
    assert calls == [128]
    _assert_f32(got.numpy(), want, "dq")


@pytest.mark.parametrize("causal", [True, False])
def test_flop_counter_counts_forward_dq_and_dkv(causal):
    """FlopCounterMode over torch.autograd.grad of the flash op counts
    exactly the forward (4·BH·T²·D), dq (6·) and dkv (8·) formulas, halved
    when causal: the client meters a train step by this count."""
    from torch.utils.flop_counter import FlopCounterMode

    bh, t, d = 4, 128, 32
    xs = [torch.from_numpy(x).requires_grad_() for x in _qkv((bh, t, d))]
    with FlopCounterMode(display=False) as counter:
        out, _ = flash_attention_fwd(*xs, d ** -0.5, causal)
        torch.autograd.grad(out.sum(), xs)
    full = (4 + 6 + 8) * bh * t * t * d
    assert counter.get_total_flops() == (full // 2 if causal else full)
    by_op = {str(op): n for op, n in counter.get_flop_counts()["Global"].items()}
    assert set(by_op) == {"tpf_torch.flash_attn_fwd", "tpf_torch.flash_attn_bwd_dq",
                          "tpf_torch.flash_attn_bwd_dkv"}


def test_lse_has_no_gradient_and_ops_take_plain_on_cpu():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv((2, 64, 16)))
    out, lse = flash_attention_fwd(q, k, v, 0.25, True)
    assert out.requires_grad and not lse.requires_grad
    do = torch.ones_like(out)
    delta = (do * out.detach()).sum(-1)
    args = (q.detach(), k.detach(), v.detach(), do, lse, delta, 0.25, True)
    dq = torch.ops.tpf_torch.flash_attn_bwd_dq(*args)
    dk, dv = torch.ops.tpf_torch.flash_attn_bwd_dkv(*args)
    for g, w in zip((dq, dk, dv), port_flash_mod.flash_attention_bwd_plain(*args)):
        assert torch.equal(g, w)


def test_backward_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 64, 16))
    rows = torch.zeros((2, 64))
    for fn in (port_flash_mod.flash_bwd_dq_cuda, port_flash_mod.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, x, x, x, rows, rows, 1.0, True)


def test_flash_trains_in_a_jax_style_loss():
    """A scalar loss of a 4-D flash call with the interpret backend's
    default scale: the port's value and gradients match JAX's."""
    q, k, v = _qkv((1, 2, 128, 16), seed=8)
    jfn = functools.partial(jax_flash, backend="interpret")
    want_v, want_g = jax.value_and_grad(
        lambda q: jnp.mean(jfn(q, jnp.asarray(k), jnp.asarray(v)) ** 2))(jnp.asarray(q))
    xq = torch.from_numpy(q).requires_grad_()
    loss = (flash_attention(xq, torch.from_numpy(k), torch.from_numpy(v)) ** 2).mean()
    (g,) = torch.autograd.grad(loss, [xq])
    _assert_f32(loss.detach().numpy(), want_v, "loss")
    _assert_f32(g.numpy(), want_g, "dq")
