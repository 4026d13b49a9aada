"""The port's mesh rules, rank launcher and differentiable collectives
(tensorfusion_tpu_torch/parallel/{mesh,launch,collectives}.py), held to the
reference's mesh rules (tests/test_workloads.py:17) on spawned gloo ranks."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensorfusion_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from tensorfusion_tpu.parallel import mesh_shape_for as jax_mesh_shape_for  # noqa: E402
from tensorfusion_tpu_torch.parallel import (AXIS_ORDER, RankGroup, batch_spec,  # noqa: E402
                                             launch, make_mesh, mesh_shape_for)
from tensorfusion_tpu_torch.parallel.launch import check_backend  # noqa: E402

import torch_rank_tasks as tasks  # noqa: E402

N = 8


@pytest.fixture(scope="module")
def ranks():
    with RankGroup(N, device="cpu", backend="gloo", timeout_s=120) as group:
        yield group


@pytest.mark.parametrize("want", [None, {"tp": 2}, {"tp": 2, "dp": 2},
                                  {"sp": 4}, {"dp": 8}, {"fsdp": 2, "tp": 2, "dp": 2}])
def test_mesh_shape_for_matches_reference(want):
    assert mesh_shape_for(N, want) == jax_mesh_shape_for(N, want)


@pytest.mark.parametrize("axes", [{"tp": 3}, {"bogus": 2}, {"pp": 4, "dp": 4},
                                  {"dp": 16}])
def test_make_mesh_errors_match_reference(axes):
    with pytest.raises(ValueError) as ref:
        jax_make_mesh(axes)
    with pytest.raises(ValueError) as port:
        make_mesh(axes, devices=range(N), device="cpu")
    assert str(port.value) == str(ref.value)


def test_mesh_construction(ranks):
    """tests/test_workloads.py:17: {"tp": 2, "dp": 2} on 8 devices is
    dp2 fsdp2 sp1 tp2; an axis outside the default order switches to the
    explicit layout, in insertion order."""
    got = ranks.run(tasks.mesh_layout, {"tp": 2, "dp": 2})
    ref = jax_make_mesh({"tp": 2, "dp": 2})
    assert got[0]["names"] == list(ref.axis_names) == list(AXIS_ORDER)
    assert got[0]["shape"] == list(ref.devices.shape) == [2, 2, 1, 2]
    # rank r sits where device r sits in the reference's mesh
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    for r, res in enumerate(got):
        where = dict(zip(ref.axis_names, map(int, np.argwhere(ids == r)[0])))
        assert res["coords"] == where
    explicit = ranks.run(tasks.mesh_layout, {"pp": 4, "dp": 2})
    assert explicit[0]["names"] == ["pp", "dp"] and explicit[0]["shape"] == [4, 2]
    assert explicit[5]["coords"] == {"pp": 2, "dp": 1}


def test_spec_placements(ranks):
    specs = [("fsdp", "tp"), ("tp", "fsdp"), (None,), batch_spec(), (("dp", "fsdp"), "sp")]
    got = ranks.run(tasks.spec_placements, {"dp": 2, "fsdp": 2, "tp": 2}, specs)[0]
    assert got == [["R", "S(0)", "R", "S(1)"], ["R", "S(1)", "R", "S(0)"], ["R"] * 4,
                   ["S(0)", "S(0)", "R", "R"], ["S(0)", "S(0)", "S(1)", "R"]]


def _expected(name, n=N):
    x = [np.arange(16, dtype=np.float32).reshape(8, 2) + 100 * r for r in range(n)]

    def g(r, shape):
        return (np.arange(int(np.prod(shape)), dtype=np.float32) + r).reshape(shape)

    out, grad = [], []
    for r in range(n):
        if name == "copy_to":
            o = x[r]
            gr = sum(g(s, o.shape) for s in range(n))
        elif name == "reduce_from":
            o = sum(x)
            gr = g(r, o.shape)
        elif name == "gather_from":
            o = np.concatenate(x)
            gr = g(r, o.shape)[8 * r:8 * r + 8]
        elif name == "scatter_to":
            o = x[r][r:r + 1]
            gr = np.concatenate([g(s, o.shape) for s in range(n)])
        elif name == "gather_rs":
            o = np.concatenate(x)
            gr = sum(g(s, o.shape) for s in range(n))[8 * r:8 * r + 8]
        elif name == "shift":
            o = x[(r - 1) % n]
            gr = g((r + 1) % n, o.shape)
        elif name == "shift_nowrap":
            o = x[r - 1] if r > 0 else np.zeros_like(x[r])
            gr = g(r + 1, o.shape) if r < n - 1 else np.zeros_like(x[r])
        elif name == "all_to_all":
            o = np.concatenate([x[s][r:r + 1] for s in range(n)], axis=1)
            gr = np.concatenate([g(s, o.shape)[:, 2 * r:2 * r + 2] for s in range(n)])
        out.append(o)
        grad.append(gr)
    return out, grad


@pytest.mark.parametrize("name", ["copy_to", "reduce_from", "gather_from", "scatter_to",
                                  "gather_rs", "shift", "shift_nowrap", "all_to_all"])
def test_differentiable_collectives(ranks, name):
    """Each Megatron pair's forward and backward over 8 ranks."""
    got = ranks.run(tasks.collective, {"tp": N}, name)
    want_out, want_grad = _expected(name)
    for r, (out, grad) in enumerate(got):
        np.testing.assert_array_equal(out, want_out[r], err_msg=f"{name} out, rank {r}")
        np.testing.assert_array_equal(grad, want_grad[r], err_msg=f"{name} grad, rank {r}")


def test_a_failing_rank_fails_the_call():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch(tasks.fail_on, 2, 1, device="cpu", backend="gloo", timeout_s=60)


def test_a_dead_rank_fails_the_call_at_once():
    """A rank that dies (a crash in native code, say) fails the call within
    seconds, not at the group's timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"no answer from \[1\]"):
        launch(tasks.die_on, 2, 1, device="cpu", backend="gloo", timeout_s=600)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("args,error", [
    ((2, "cpu", "mpi"), ValueError),
    ((2, "cpu", "nccl"), ValueError),
    ((0, "cpu", "gloo"), ValueError),
])
def test_backend_is_the_callers_and_checked(args, error):
    with pytest.raises(error):
        check_backend(*args)


def test_cuda_ranks_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("has a card: tests/test_torch_kernels_gpu.py covers it")
    with pytest.raises(RuntimeError, match="cuda"):
        check_backend(2, "cuda", "gloo")
