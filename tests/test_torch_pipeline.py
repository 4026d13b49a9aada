"""The port's GPipe pipeline (tensorfusion_tpu_torch/parallel/pipeline.py)
on 8 spawned gloo ranks, against the sequential composition and the JAX
reference's pipeline_apply on its 8-device CPU mesh
(tests/test_workloads.py:191)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensorfusion_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from tensorfusion_tpu.parallel import pipeline_apply as jax_pipeline_apply  # noqa: E402
from tensorfusion_tpu_torch.parallel import RankGroup  # noqa: E402

import torch_rank_tasks as tasks  # noqa: E402

N = 8


@pytest.fixture(scope="module")
def ranks():
    with RankGroup(N, device="cpu", backend="gloo", timeout_s=120) as group:
        yield group


def _stage(w, x):
    return jnp.tanh(x @ w)


@pytest.mark.parametrize("axes,microbatches", [
    ({"pp": 4, "dp": 2}, 6),
    ({"pp": 8}, 3),
    ({"dp": 4, "pp": 2}, 5),
    ({"pp": 4, "dp": 2}, 1),
], ids=["pp4-dp2-m6", "pp8-m3", "dp4-pp2-m5", "pp4-dp2-m1"])
def test_pipeline_matches_sequential_composition(ranks, axes, microbatches):
    """M microbatches through P stages in M + P - 1 ticks: every rank's
    outputs equal the stages applied in order at 1e-5, and the
    reference's pipeline."""
    p, dim = axes["pp"], 32
    ws = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (p, dim, dim)) / dim ** 0.5)
    xs = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (microbatches, 4, dim)))
    want = jnp.asarray(xs)
    for i in range(p):
        want = _stage(ws[i], want)
    ref = jax_pipeline_apply(_stage, jnp.asarray(ws), jnp.asarray(xs), jax_make_mesh(axes))
    for got in ranks.run(tasks.pipeline, axes, ws, xs):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
