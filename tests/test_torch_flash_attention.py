"""The port's attention ops against the JAX package's, on the CPU.

The same numpy inputs go to both: the JAX side runs the Pallas kernel in
interpret mode (as tests/test_ops.py does), the port its plain version
(which a CPU tensor takes).  The Hopper kernel itself runs only on the
card: tests/test_torch_kernels_gpu.py and chip_smoke.py hold it against
the plain version there.
"""

import importlib
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tensorfusion_tpu.ops import chunked_attention as jax_chunked  # noqa: E402
from tensorfusion_tpu.ops import flash_attention as jax_flash  # noqa: E402
from tensorfusion_tpu.ops.flash_attention import _flash_fwd_pallas  # noqa: E402
from tensorfusion_tpu_torch.ops import (chunked_attention,  # noqa: E402
                                        flash_attention, flash_attention_fwd)

# the modules (the package re-exports functions of the same names)
port_flash_mod = importlib.import_module("tensorfusion_tpu_torch.ops.flash_attention")
port_chunked_mod = importlib.import_module(
    "tensorfusion_tpu_torch.ops.chunked_attention")

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

# f32 tolerance of tests/test_ops.py:19-20
F32 = dict(rtol=2e-4, atol=2e-5)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,d", [(128, 32), (256, 64)])
def test_plain_fwd_matches_pallas_kernel(causal, t, d):
    q, k, v = _qkv((2, t, d))
    scale = d ** -0.5
    out_j, lse_j = _flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), scale, causal,
                                     interpret=True)
    out_t, lse_t = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), scale, causal)
    assert out_t.dtype == torch.float32 and lse_t.shape == (2, t)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **F32)


def test_4d_layout_matches_jax():
    q, k, v = _qkv((2, 2, 128, 32), seed=1)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     backend="interpret")
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v))
    assert got.shape == (2, 2, 128, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_bf16_at_scale_tracks_f32():
    """bf16 at T=1024 stays within the bf16 rounding floor of the f32
    result (tests/test_ops.py:35-50)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((2, 1024, 64), seed=7))
    out = flash_attention(*(x.bfloat16() for x in (q, k, v)))
    ref = flash_attention(q, k, v, backend="plain")
    assert out.dtype == torch.bfloat16
    err = (out.float() - ref).abs().max().item()
    assert err < 2e-2, f"bf16 error {err} beyond the rounding floor"


@pytest.mark.parametrize("t", [130, 192])
def test_ragged_t_routes_to_chunked(t, monkeypatch):
    calls = []
    real = port_chunked_mod.chunked_attention

    def spy(*a, **kw):
        calls.append(kw.get("block"))
        return real(*a, **kw)

    monkeypatch.setattr(port_chunked_mod, "chunked_attention", spy)
    monkeypatch.setattr(port_flash_mod, "_warned_ragged", False)
    q, k, v = _qkv((2, t, 32), seed=t)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     backend="interpret")
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v))
    assert calls == [128], "ragged T must take the chunked path"
    assert port_flash_mod._warned_ragged
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_matches_jax_with_padding(causal):
    q, k, v = _qkv((1, 2, 100, 16), seed=3)
    want = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, block=32)
    got = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal, block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_backend_cuda_on_cpu_tensor_raises():
    q, k, v = (torch.from_numpy(x) for x in _qkv((2, 128, 32)))
    with pytest.raises(ValueError, match="cuda"):
        flash_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        port_flash_mod.flash_fwd_cuda(q, k, v, 1.0, True)
    with pytest.raises(ValueError, match="backend"):
        flash_attention(q, k, v, backend="pallas")


@pytest.mark.parametrize("causal", [True, False])
def test_flop_formula_counts_the_kernel_op(causal):
    from torch.utils.flop_counter import FlopCounterMode

    bh, t, d = 4, 128, 32
    q, k, v = (torch.from_numpy(x) for x in _qkv((bh, t, d)))
    with FlopCounterMode(display=False) as counter:
        flash_attention_fwd(q, k, v, d ** -0.5, causal)
    full = 4 * bh * t * t * d
    assert counter.get_total_flops() == (full // 2 if causal else full)


_PORT_FILES = sorted((REPO / "tensorfusion_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
# "tensorfusion_tpu" followed by "." or the end of the name -- the port's
# own name starts with the same prefix
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax\b|tensorfusion_tpu(\.|\s|$))", re.M)


def test_port_sources_import_no_jax_and_no_reference_package():
    assert len(_PORT_FILES) > 10
    assert REPO / "tensorfusion_tpu_torch" / "remoting" / "sharded.py" in _PORT_FILES
    assert REPO / "tensorfusion_tpu_torch" / "profile_shard.py" in _PORT_FILES
    for new in ("api/types.py", "store.py", "storecache.py", "shardedstore.py", "gateway.py",
                "statestore.py", "remote_store.py", "utils/leader.py", "utils/tlsutil.py",
                "config/chip_info.py", "config/global_config.py",
                "hypervisor/control_plane.py", "tracing/core.py",
                "allocator/__init__.py", "allocator/partition_planner.py",
                "allocator/strategy.py", "allocator/indexalloc.py", "allocator/portalloc.py",
                "allocator/filters.py", "allocator/vecview.py", "allocator/quota.py",
                "allocator/core.py", "webhook/__init__.py", "webhook/parser.py",
                "webhook/auto_migration.py", "webhook/mutator.py", "scheduler/__init__.py",
                "scheduler/framework.py", "scheduler/gang.py", "scheduler/topo.py",
                "scheduler/tpuresources.py"):
        assert REPO / "tensorfusion_tpu_torch" / new in _PORT_FILES, new
    # the expander waits for the operator's cloud providers
    assert REPO / "tensorfusion_tpu_torch" / "scheduler" / "expander.py" not in _PORT_FILES
    bad = [str(p.relative_to(REPO)) for p in _PORT_FILES
           if _FORBIDDEN.search(p.read_text())]
    assert not bad, f"port files importing jax or tensorfusion_tpu: {bad}"


def test_importing_the_port_loads_no_jax():
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in _PORT_FILES]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import importlib, re, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or re.fullmatch(r'tensorfusion_tpu(\\..*)?', m)]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
