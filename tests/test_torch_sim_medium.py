"""The port's digital twin at the scale the reference's suite runs by
default: at ``medium``, ``thundering-herd-rescale``, ``shard-owner-failover``
and ``leader-flap`` (the last two restart operators, whose recovery reads
more in the port) give the port the reference's log, trace and profile
digests in one process.  (``small``, every scenario: tests/test_torch_sim.py.)
"""

import importlib

import pytest

pytest.importorskip("torch")

pytestmark = pytest.mark.sim


def _run(root, name):
    scenarios = importlib.import_module(f"{root}.sim.scenarios")
    return scenarios.run_scenario(name, seed=42, scale="medium")


@pytest.mark.parametrize("name", ["thundering-herd-rescale", "shard-owner-failover",
                                  "leader-flap"])
def test_scenario_digests_equal_the_reference_at_medium_scale(name):
    ref = _run("tensorfusion_tpu", name)
    port = _run("tensorfusion_tpu_torch", name)
    assert ref["ok"] and port["ok"], (ref["invariants"], port["invariants"])
    for key in ("log_digest", "trace_digest", "profile_digest", "store_events",
                "pods_scheduled", "sched_failures", "sim_seconds"):
        assert port[key] == ref[key], key
