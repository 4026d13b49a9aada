"""The port's Llama serving path against the JAX package's, on the CPU.

Weights come from the JAX package's ``init_params`` and cross to the port
through numpy (``params_from_numpy``); prompts are numpy.  f32 is held
tight; greedy tokens must be exact; bf16 uses the 5e-2 / 5e-3 of
tests/test_ops.py:263-271.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tensorfusion_tpu.models import llama as jl  # noqa: E402
from tensorfusion_tpu.models import quantize as jq  # noqa: E402
from tensorfusion_tpu_torch.models import convert, quantize as tq  # noqa: E402
from tensorfusion_tpu_torch.models import llama as tl  # noqa: E402

torch.set_num_threads(1)

F32 = dict(rtol=2e-4, atol=2e-5)
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


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_forward_logits_match():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg)
    toks = _tokens((2, 16), jcfg.vocab_size)
    want = jl.forward(jp, jnp.asarray(toks), jcfg)
    got = tl.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 16, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_logits_and_cache_match(kv_quant):
    jcfg, tcfg = _configs(kv_quant=kv_quant)
    jp, tp = _params(jcfg)
    toks = _tokens((2, 12), jcfg.vocab_size, seed=2)
    jlog, jcache = jl.prefill(jp, jnp.asarray(toks), jcfg, cache_len=20)
    tlog, tcache = tl.prefill(tp, torch.from_numpy(toks), tcfg, cache_len=20)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
    assert set(tcache) == set(jcache)
    for name in jcache:
        for a, b in zip(tcache[name], jcache[name]):
            b = np.asarray(b)
            assert tuple(a.shape) == b.shape
            if a.dtype == torch.int8:
                # int8 codes may differ by one where a value sits on a
                # rounding boundary
                assert np.abs(a.numpy().astype(int) - b.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(a.numpy(), b, **F32)


def test_decode_step_teacher_forced_matches_forward():
    """tests/test_workloads.py:211-232 for the port."""
    _, tcfg = _configs()
    jcfg, _ = _configs()
    _, tp = _params(jcfg)
    toks = torch.from_numpy(_tokens((2, 12), tcfg.vocab_size))
    full = tl.forward(tp, toks, tcfg)
    cache = tl.init_kv_cache(tcfg, 2, max_len=12, device="cpu")
    outs = []
    for t in range(12):
        logits, cache = tl.decode_step(tp, toks[:, t], cache, t, tcfg)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_generate_tokens_exact(kv_quant):
    jcfg, tcfg = _configs(kv_quant=kv_quant)
    jp, tp = _params(jcfg, seed=3)
    prompt = _tokens((2, 10), jcfg.vocab_size, seed=4)
    want = jl.generate(jp, jnp.asarray(prompt), 8, jcfg)
    got = tl.generate(tp, torch.from_numpy(prompt), 8, tcfg, device="cpu")
    assert got.shape == (2, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("attn_impl,seq", [("flash", 32), ("chunked", 40)])
def test_attn_impls_match_jax(attn_impl, seq):
    """flash: the kernel op (its plain version on the CPU) against JAX's
    flash path; chunked: 16-key blocks over a ragged 40-token prompt."""
    jcfg, tcfg = _configs(attn_impl=attn_impl, attn_block=16)
    jp, tp = _params(jcfg)
    toks = _tokens((2, seq), jcfg.vocab_size, seed=5)
    want = jl.forward(jp, jnp.asarray(toks), jcfg)
    got = tl.forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_array_equal(
        tl.generate(tp, torch.from_numpy(toks), 4, tcfg, device="cpu").numpy(),
        np.asarray(jl.generate(jp, jnp.asarray(toks), 4, jcfg)))


@pytest.mark.parametrize("seq", [16, 33])
def test_ring_attention_without_a_mesh_matches_jax(seq):
    """The reference takes the ring path only with a mesh
    (tensorfusion_tpu/models/llama.py:173) and is dense otherwise; so is
    the port, for forward and for generate's prefill and decode."""
    jcfg, tcfg = _configs(attn_impl="ring")
    jp, tp = _params(jcfg, seed=11)
    toks = _tokens((2, seq), jcfg.vocab_size, seed=12)
    want = jl.forward(jp, jnp.asarray(toks), jcfg)
    got = tl.forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_array_equal(
        tl.generate(tp, torch.from_numpy(toks), 6, tcfg, device="cpu").numpy(),
        np.asarray(jl.generate(jp, jnp.asarray(toks), 6, jcfg)))


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_quantized_matmul_matches_jax(mode):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64, 40)).astype(np.float32)
    jw = jq.quantize_weights_int8({"wq": jnp.asarray(w)}, mode)["wq"]
    tw = tq.quantize_weights_int8({"wq": torch.from_numpy(w)}, mode)["wq"]
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_allclose(tw.s.numpy(), np.asarray(jw.s), rtol=1e-6)
    # the JAX weight converted, so both sides multiply the same int8 codes
    nw = jax.tree_util.tree_map(np.asarray, jw)
    want = np.asarray(jq.matmul(jnp.asarray(x), jw))
    # the QuantizedWeight object and its {q, s, mode} dict form
    for leaf in (nw, {"q": nw.q, "s": nw.s, "mode": nw.mode}):
        cw = convert.params_from_numpy({"w": leaf}, device="cpu")["w"]
        assert tq.is_quantized(cw) and cw.mode == mode
        got = tq.matmul(torch.from_numpy(x), cw).numpy()
        np.testing.assert_allclose(got, want, **F32)


def test_int8_matmul_is_exact_on_cpu():
    rng = np.random.default_rng(7)
    a = rng.integers(-127, 128, (3, 7, 24)).astype(np.int8)
    b = rng.integers(-127, 128, (24, 9)).astype(np.int8)
    got = tq._int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_quantized_params_generate_like_jax():
    jcfg, tcfg = _configs()
    jp, _ = _params(jcfg, seed=8)
    jpq = jq.quantize_weights_int8(jp, "w8a16")
    tpq = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jpq),
                                    device="cpu")
    assert tq.is_quantized(tpq["layers"][0]["attn"]["wq"])
    prompt = _tokens((2, 8), jcfg.vocab_size, seed=9)
    np.testing.assert_array_equal(
        tl.generate(tpq, torch.from_numpy(prompt), 5, tcfg, device="cpu").numpy(),
        np.asarray(jl.generate(jpq, jnp.asarray(prompt), 5, jcfg)))


@pytest.mark.parametrize("seed", [10, 12])
def test_bf16_logits_track_jax(seed):
    """bf16 cannot match bit for bit: the two frameworks sum matrix
    products and the f32 variance of _rms_norm in other orders; where that
    flips a bf16 rounding (of a whole row, when it is the row's rsqrt),
    the difference compounds over layers.  So the bound is the 5e-2 / 5e-3 of
    tests/test_ops.py:263-271 taken on the logits' scale (5e-2 of the
    largest logit at most, 5e-3 on average), and the port may stray from
    JAX's bf16 logits no further than those stray from the f32 logits."""
    jcfg, tcfg = _configs(dtype=jnp.bfloat16)
    jp, tp = _params(jcfg)
    assert tp["tok_emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["tok_emb"].float().numpy(), np.asarray(jp["tok_emb"], np.float32))
    toks = _tokens((2, 16), jcfg.vocab_size, seed=seed)
    want = np.asarray(jl.forward(jp, jnp.asarray(toks), jcfg))
    got = tl.forward(tp, torch.from_numpy(toks), tcfg).numpy()
    jcfg32 = dataclasses.replace(jcfg, dtype=jnp.float32)
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    want32 = np.asarray(jl.forward(jp32, jnp.asarray(toks), jcfg32))
    err = np.abs(got - want)
    assert err.max() < 5e-2 * np.abs(want).max()
    assert err.mean() < 5e-3
    assert err.max() <= np.abs(want - want32).max()


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy({"w": np.zeros(2, np.float32)})
    params = tl.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.generate(params, torch.zeros((1, 4), dtype=torch.int64), 2, tcfg)
    out = tl.generate(params, torch.zeros((1, 4), dtype=torch.int64), 2, tcfg,
                      device="cpu")
    assert out.shape == (1, 2)
