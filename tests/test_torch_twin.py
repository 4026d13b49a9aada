"""The port's digital twin: its policy campaigns, and a fault of the design
that both packages share.

- The campaigns (tests/test_policy.py's sim cases, over both packages):
  each policy arm beats its baseline by the campaign's criteria, with full
  provenance; a double run replays; the port's campaign log is read by the
  reference's unchanged ``tools/tpfpolicy.py``.  Beside them, all six arms
  give both packages equal log and ledger digests and decision counts.
- Fault 15 (ROADMAP queue 3): a scenario's digests depend on the process's
  string-hash seed, in either package, because the scheduler and the
  allocator iterate sets of names into binding order.  Under one fixed
  seed the digests replay across processes and across packages.
"""

import functools
import importlib
import json
import os
import subprocess
import sys

import pytest

from conftest import REPO_ROOT

pytest.importorskip("torch")

pytestmark = pytest.mark.sim

ROOTS = {"ref": "tensorfusion_tpu", "port": "tensorfusion_tpu_torch"}
CAMPAIGNS = ["burst-overload", "noisy-neighbor", "admission-storm"]


def _sim(pkg, mod):
    return importlib.import_module(f"{ROOTS[pkg]}.sim.{mod}")


@pytest.fixture(params=sorted(ROOTS))
def pkg(request):
    return request.param


@functools.lru_cache(maxsize=None)
def _campaign(pkg, name, policies, seed=42):
    r = _sim(pkg, "campaign").run_campaign(name, seed=seed, scale="small",
                                           policies=policies)
    return r, json.loads(json.dumps(_sim(pkg, "campaign").LAST_POLICY_LOG,
                                    default=str))


# -- campaigns -------------------------------------------------------------------

@pytest.mark.parametrize("name", CAMPAIGNS)
def test_campaign_policy_beats_baseline(pkg, name):
    base, _ = _campaign(pkg, name, False)
    pol, _ = _campaign(pkg, name, True)
    assert base["ok"], base["invariants"]
    assert pol["ok"], (pol["invariants"], pol["provenance"])
    assert _sim(pkg, "campaign").CRITERIA[name](pol, base) == []
    assert pol["decisions"] >= 1
    assert pol["provenance"]["ok"], pol["provenance"]["missing"]


@pytest.mark.parametrize("policies", [False, True])
@pytest.mark.parametrize("name", CAMPAIGNS)
def test_campaign_arms_equal_the_reference(name, policies):
    ref, ref_log = _campaign("ref", name, policies)
    port, port_log = _campaign("port", name, policies)
    for key in ("ok", "log_digest", "ledger_digest", "decisions",
                "actuation_failures", "resolved", "score", "store_events",
                "sim_seconds"):
        assert port[key] == ref[key], key
    assert port_log["snapshot"] == ref_log["snapshot"]


def test_campaign_deterministic_double_run(pkg):
    run = _sim(pkg, "campaign").run_campaign
    r1 = run("burst-overload", seed=42, scale="small", policies=True)
    r2 = run("burst-overload", seed=42, scale="small", policies=True)
    assert r1["log_digest"] == r2["log_digest"]
    assert r1["ledger_digest"] == r2["ledger_digest"]
    r3 = run("burst-overload", seed=7, scale="small", policies=True)
    assert r3["log_digest"] != r1["log_digest"]


def test_campaign_ledger_decisions_resolve_via_cli(pkg, tmp_path, capsys):
    """Campaign -> exported tpfpolicy log -> every actuated decision
    explains to its alert, exemplar trace ids and profiler evidence, read
    by the reference's CLI."""
    import tools.tpfpolicy as cli

    _sim(pkg, "campaign").run_campaign("noisy-neighbor", seed=42, scale="small",
                                       policies=True)
    path = str(tmp_path / "campaign-policy.json")
    with open(path, "w") as f:
        json.dump(_sim(pkg, "campaign").LAST_POLICY_LOG, f, default=str)
    assert cli.main(["check", path]) == 0
    with open(path) as f:
        decisions = json.load(f)["snapshot"]["ledger"]["decisions"]
    assert decisions
    for d in decisions:
        assert cli.main(["explain", path, str(d["id"])]) == 0
        out = capsys.readouterr().out
        assert d["rule"] in out
        assert d["evidence"]["exemplars"]
        assert d["evidence"]["profile"]


# -- fault 15: digests that depend on the string-hash seed -----------------------

_DIGESTS = """
import logging, sys
logging.disable(logging.WARNING)
from {root}.sim.scenarios import run_scenario
r = run_scenario("thundering-herd-rescale", seed=42, scale="small")
assert r["ok"], r["invariants"]
print(r["log_digest"], r["trace_digest"], r["profile_digest"])
"""


def _digests_under(pkg, hash_seed):
    env = {**os.environ, "PYTHONHASHSEED": str(hash_seed), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", _DIGESTS.format(root=ROOTS[pkg])],
                       cwd=REPO_ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return tuple(r.stdout.split())


def test_scenario_digests_depend_on_the_hash_seed_in_either_package(pkg):
    """The gang's quorum releases its parked members in the order of a set
    of pod keys (scheduler/gang.py), and the candidate nodes, a pool's
    chips and the chips written back come from sets of names
    (scheduler/tpuresources.py, allocator/core.py): so the same scenario
    seed gives another run under another PYTHONHASHSEED.  Fixed, the hash
    seed gives the same run in every process."""
    first, other, again = (_digests_under(pkg, s) for s in (0, 1, 0))
    assert first[0] != other[0]
    assert first == again


def test_a_fixed_hash_seed_gives_both_packages_one_run():
    assert _digests_under("port", 0) == _digests_under("ref", 0)
