"""Policy-regression campaigns: seeded traffic traces through the twin,

The port's copy of ``tensorfusion_tpu/sim/campaign.py``.
policies ON vs the no-op baseline, scored — not demoed.

Each campaign drives the REAL control plane (operator + webhook +
scheduler + controllers + metrics recorder + alert evaluator + policy
engine, all on SimClock timers) through a traffic story where a human
operator would have to act, twice per run:

- **baseline**: the policy engine runs with an EMPTY rule set — every
  alert still fires, every metric still ships, nothing acts;
- **policies on**: the campaign's closed-loop rules actuate through
  the real machinery (node claims, LiveMigrator, webhook admission
  control).

Both are scored on **SLO attainment** (pods bound / tenants served
within their deadline), **utilization**, and **action counts**
(migrations, nodes added, admission sheds), and the policy run must
BEAT the baseline by each campaign's criteria (:data:`CRITERIA`) —
a regression gate (``make verify-campaign``), because a policy that
stops beating the baseline is a policy that should not ship.

Determinism: same contract as scenarios.py — all randomness from the
seed, all time virtual, and the run's fingerprints (store-event log
digest + decision-ledger digest) must be byte-identical across a
double run.  Campaign scale "large" replays 100k+ pod-event traces;
"small" is the seconds-fast CI shape.
"""

from __future__ import annotations

import time as _wall_time   # wall-clock cost reporting only
from typing import Callable, Dict, List, Optional

from .. import constants
from ..api.types import Container, Pod, TPUResourceQuota
from ..policy import (ActuationError, AlertPolicyRule, MetricPolicyRule,
                      alert_rules_for_policies)
from ..profiling.profiler import Profiler
from ..store import NotFoundError
from ..webhook import AdmissionShedError
from .harness import SimHarness
from .trace import TraceGenerator

#: campaign registry: name -> fn(seed, scale, policies) -> result dict
CAMPAIGNS: Dict[str, Callable] = {}

#: per-campaign policy-beats-baseline criteria:
#: name -> fn(policy_result, baseline_result) -> [violation strings]
CRITERIA: Dict[str, Callable] = {}

#: tpfpolicy-v1 doc of the most recent run's policy engine (captured
#: by _result while the harness is still alive) — ``sim_campaign.py
#: --export-policy-log`` writes it for ``tpfpolicy log/explain/check``;
#: same lifetime contract as scenarios.LAST_TRACE
LAST_POLICY_LOG: Dict[str, object] = {}

V5E_TFLOPS = 197.0

#: pods request in VIRTUAL tflops (the allocator oversubscribes duty:
#: a v5e chip's virtual capacity is ~5x its 197 physical peak), so a
#: 900-tflops request occupies one chip and a small cluster genuinely
#: exhausts.  The noisy-neighbor contention model instead works in
#: fractions of a node's PHYSICAL duty (what a tenant actually burns).
SCALES = {
    # verify-campaign / CI: seconds of wall time per run
    "small": {
        "burst-overload": dict(
            nodes=3, chips=4, tenants=6, burst=5, tflops=900.0,
            hbm_gib=0.5, burst_at=10.0, slo_s=40.0, run_s=120.0,
            nodes_per_action=2),
        "noisy-neighbor": dict(
            nodes=4, chips=4, goods=15, tflops=450.0, hbm_gib=0.5,
            good_duty=0.11, overdraft=3.0, served_slo=0.98,
            warmup_s=10.0, run_s=90.0),
        "admission-storm": dict(
            nodes=4, chips=4, tflops=900.0, hbm_gib=0.5,
            good_period=2.0, good_life=8.0, storm_period=0.4,
            storm_life=16.0, storm_start=8.0, storm_end=60.0,
            quota_tflops=20000.0, quota_threshold_pct=25.0,
            slo_s=6.0, run_s=100.0),
    },
    # bench default: minutes-scale stories, thousands of pod events
    "medium": {
        "burst-overload": dict(
            nodes=8, chips=4, tenants=32, burst=5, tflops=900.0,
            hbm_gib=0.5, burst_at=15.0, slo_s=60.0, run_s=300.0,
            nodes_per_action=4),
        "noisy-neighbor": dict(
            nodes=12, chips=4, goods=87, tflops=450.0, hbm_gib=0.5,
            good_duty=0.11, overdraft=3.0, served_slo=0.98,
            warmup_s=12.0, run_s=240.0),
        "admission-storm": dict(
            nodes=8, chips=4, tflops=900.0, hbm_gib=0.5,
            good_period=1.0, good_life=10.0, storm_period=0.15,
            storm_life=16.0, storm_start=10.0, storm_end=180.0,
            quota_tflops=40000.0, quota_threshold_pct=20.0,
            slo_s=8.0, run_s=260.0),
    },
    # the 100k+ pod-event trace shape (minutes of wall time: the
    # thousand-tenant admission storm submits tens of thousands of
    # pods, each with admit/workload/bind/delete store events)
    "large": {
        "burst-overload": dict(
            nodes=48, chips=4, tenants=300, burst=6, tflops=900.0,
            hbm_gib=0.5, burst_at=20.0, slo_s=120.0, run_s=900.0,
            nodes_per_action=16),
        "noisy-neighbor": dict(
            nodes=48, chips=4, goods=375, tflops=450.0, hbm_gib=0.5,
            good_duty=0.11, overdraft=3.0, served_slo=0.98,
            warmup_s=15.0, run_s=600.0),
        "admission-storm": dict(
            nodes=32, chips=4, tflops=900.0, hbm_gib=0.5,
            good_period=0.2, good_life=10.0, storm_period=0.02,
            storm_life=16.0, storm_start=15.0, storm_end=1200.0,
            quota_tflops=160000.0, quota_threshold_pct=20.0,
            slo_s=10.0, run_s=1300.0),
    },
}


def campaign(name: str):
    def register(fn):
        CAMPAIGNS[name] = fn
        fn.campaign_name = name
        return fn
    return register


def run_campaign(name: str, seed: int = 0, scale: str = "small",
                 policies: bool = True) -> dict:
    return CAMPAIGNS[name](seed, scale, policies)


# -- shared plumbing -------------------------------------------------------


def _make_harness(seed: int, alert_rules, policy_rules,
                  policies: bool) -> SimHarness:
    """Twin with the full observability loop on virtual-time timers.
    The baseline run keeps EVERYTHING identical except the policy rule
    set (empty list -> the engine evaluates, nothing ever fires)."""
    h = SimHarness(
        seed=seed, metrics_interval_s=2.0,
        operator_kwargs=dict(
            enable_metrics=True,
            alert_rules=alert_rules,
            policy_rules=(list(policy_rules) if policies else [])))
    h.op.alerts.interval_s = 2.0
    h.op.policy.interval_s = 2.0
    # the control-plane profiler's digest is part of every decision's
    # evidence (tpfprof attribution at decision time)
    h.op.policy.profilers.append(h.profiler)
    return h


def _client_pod(name: str, namespace: str, tflops: float,
                hbm_gib: float, pool: str = "pool-a") -> Pod:
    """A standalone tpu-fusion pod that enters through the webhook
    (``Operator.submit_pod``) — so it carries a lifecycle-trace
    annotation the policy engine can cite as exemplar evidence."""
    pod = Pod.new(name, namespace=namespace)
    ann = pod.metadata.annotations
    ann[constants.ANN_POOL] = pool
    ann[constants.ANN_TFLOPS_REQUEST] = str(tflops)
    ann[constants.ANN_HBM_REQUEST] = str(int(hbm_gib * 2**30))
    ann[constants.ANN_IS_LOCAL_TPU] = "true"
    pod.spec.containers = [Container(name="main")]
    return pod


def _bind_latencies(h: SimHarness) -> Dict[str, tuple]:
    """pod key -> (created_t, first_bound_t or None) from the
    deterministic store-event log (first bind episode per key)."""
    out: Dict[str, list] = {}
    for entry in h.events:
        if len(entry) < 5 or entry[2] != "Pod":
            continue
        t, etype, _kind, key, node = entry[:5]
        rec = out.get(key)
        if rec is None:
            out[key] = rec = [t, None]
        if node and rec[1] is None:
            rec[1] = t
    return {k: (v[0], v[1]) for k, v in out.items()}


def _attainment(h: SimHarness, namespace: str, slo_s: float,
                prefix: str = "") -> dict:
    """Bind-latency SLO attainment for pods of one namespace."""
    total = attained = 0
    for key, (t0, t1) in sorted(_bind_latencies(h).items()):
        ns, name = key.split("/", 1)
        if ns != namespace or not name.startswith(prefix):
            continue
        total += 1
        if t1 is not None and t1 - t0 <= slo_s:
            attained += 1
    pct = 100.0 * attained / total if total else 0.0
    return {"pods": total, "attained": attained,
            "slo_attainment_pct": round(pct, 2)}


def _sample_utilization(h: SimHarness, samples: List[float],
                        interval_s: float = 2.0) -> None:
    def sample():
        chips = h.op.allocator.chips()
        cap = sum(c.virtual_capacity().tflops for c in chips)
        used = cap - sum(c.available().tflops for c in chips)
        samples.append(used / cap if cap else 0.0)
    h.every(interval_s, sample)


def _provenance(h: SimHarness) -> dict:
    """The acceptance contract, checked in-run: every actuated
    decision must carry its trigger, exemplar trace ids and profiler
    evidence (what ``tpfpolicy explain`` renders)."""
    missing = []
    ledger = h.op.policy.ledger
    for d in ledger.decisions():
        ev = d.evidence
        if not ev.get("trigger"):
            missing.append(f"decision {d.id}: no trigger evidence")
        if not ev.get("exemplars"):
            missing.append(f"decision {d.id}: no exemplar trace ids")
        if not ev.get("profile"):
            missing.append(f"decision {d.id}: no profiler evidence")
        if not d.actuation.get("actuator"):
            missing.append(f"decision {d.id}: no actuation record")
    return {"ok": not missing, "missing": missing[:10]}


def _result(h: SimHarness, name: str, seed: int, scale: str,
            policies: bool, t0: float, score: dict,
            invariant_names=("no_double_bind",
                             "no_leaked_allocations")) -> dict:
    checks = h.check_all()
    invariants = {k: checks[k] for k in invariant_names}
    prov = _provenance(h)
    eng = h.op.policy
    from ..policy.export import to_doc
    LAST_POLICY_LOG.clear()
    LAST_POLICY_LOG.update(to_doc(
        eng, node_name="sim",
        meta={"campaign": name, "seed": seed, "scale": scale,
              "policies": policies}))
    ok = not any(invariants.values()) and h.pump_exhausted == 0 \
        and prov["ok"]
    return {
        "campaign": name,
        "seed": seed,
        "scale": scale,
        "policies": policies,
        "ok": ok,
        "sim_seconds": round(h.clock.monotonic(), 3),
        "wall_seconds": round(_wall_time.perf_counter() - t0, 3),
        "store_events": len(h.events),
        "log_digest": h.log_digest(),
        "ledger_digest": eng.ledger.digest(),
        "decisions": eng.decisions_total,
        "actuation_failures": eng.actuation_failures_total,
        "resolved": eng.resolved_total,
        "score": score,
        "provenance": prov,
        "invariants": {k: v[:10] for k, v in invariants.items()},
        "pump_exhausted": h.pump_exhausted,
    }


# -- campaign 1: burst-overload -> scale-on-burn ---------------------------


@campaign("burst-overload")
def burst_overload(seed: int = 0, scale: str = "small",
                   policies: bool = True) -> dict:
    """Demand bursts past the pool's capacity: every tenant multiplies
    its standalone-pod count in the same minute, pods pend, the
    ``pods-pending`` alert fires — and the **scale-on-burn** policy
    adds one node claim per cooldown window until the alert resolves.
    Baseline: the burst stays pending to the end of the story."""
    p = SCALES[scale]["burst-overload"]
    t0 = _wall_time.perf_counter()
    rules = [AlertPolicyRule(
        name="scale-on-burn", alert_rule="pods-pending",
        action="scale_pool",
        static_args={"pool": "pool-a",
                     "nodes": p["nodes_per_action"],
                     "generation": "v5e", "chip_count": p["chips"]},
        cooldown_s=8.0,
        summary="unschedulable-pod pressure: +N nodes per window")]
    h = _make_harness(seed, alert_rules_for_policies(), rules,
                      policies)
    utils: List[float] = []
    try:
        h.start()
        tg = TraceGenerator(h)
        tg.build_cluster(p["nodes"], p["chips"])
        _sample_utilization(h, utils)

        def submit(tenant: int, idx: int):
            def fire():
                try:
                    h.op.submit_pod(_client_pod(
                        f"burst-t{tenant:03d}-{idx}", "default",
                        p["tflops"], p["hbm_gib"]))
                except AdmissionShedError:
                    pass
            return fire

        # steady state: one pod per tenant, then the burst — arrival
        # instants carry seeded jitter so the TRACE (not just the
        # story) is a function of the seed
        for i in range(p["tenants"]):
            h.at(1.0 + 0.05 * i + h.rng.uniform(0.0, 0.04),
                 submit(i, 0))
        for i in range(p["tenants"]):
            for j in range(1, p["burst"]):
                h.at(p["burst_at"] + 0.05 * i + 0.01 * j
                     + h.rng.uniform(0.0, 0.04), submit(i, j))
        h.run_for(p["run_s"])

        nodes_added = sum(
            len((d.actuation.get("result") or {}).get("claims", ()))
            for d in h.op.policy.ledger.decisions()
            if d.actuation.get("ok"))
        score = dict(
            _attainment(h, "default", p["slo_s"]),
            utilization_pct=round(
                100.0 * sum(utils) / len(utils), 2) if utils else 0.0,
            nodes_added=nodes_added,
            migrations=0,
            admission_sheds=0)
        return _result(h, "burst-overload", seed, scale, policies,
                       t0, score)
    finally:
        h.stop()


def _crit_burst(pol: dict, base: dict) -> List[str]:
    v = []
    ps, bs = pol["score"], base["score"]
    if ps["slo_attainment_pct"] < bs["slo_attainment_pct"] + 20.0:
        v.append(f"burst-overload: policy attainment "
                 f"{ps['slo_attainment_pct']}% does not beat baseline "
                 f"{bs['slo_attainment_pct']}% by >=20pp")
    if ps["slo_attainment_pct"] < 85.0:
        v.append(f"burst-overload: policy attainment "
                 f"{ps['slo_attainment_pct']}% < 85%")
    if pol["decisions"] < 1:
        v.append("burst-overload: policy never actuated")
    if pol["decisions"] > 8:
        v.append(f"burst-overload: overshoot — {pol['decisions']} "
                 f"scale decisions (cooldown not holding)")
    if pol["actuation_failures"]:
        v.append(f"burst-overload: {pol['actuation_failures']} "
                 f"actuation failures")
    return v


CRITERIA["burst-overload"] = _crit_burst


# -- campaign 2: noisy-neighbor -> migrate-on-skew -------------------------


@campaign("noisy-neighbor")
def noisy_neighbor(seed: int = 0, scale: str = "small",
                   policies: bool = True) -> dict:
    """One tenant draws far more device time than it requested
    (overdraft), throttling every co-tenant on its node.  Per-node
    tpfprof profilers attribute served compute AND the unserved
    overflow (queue seconds); the **migrate-on-skew** policy watches
    the per-device queue-time delta and migrates that device's
    noisiest tenant off it — the defrag controller's machinery driven
    by attribution instead of a cron.  Scored on the co-tenants'
    served-fraction SLO; baseline never migrates and the victims stay
    throttled."""
    p = SCALES[scale]["noisy-neighbor"]
    t0 = _wall_time.perf_counter()
    rules = [MetricPolicyRule(
        name="migrate-on-skew", measurement="tpf_prof_device",
        metric_field="queue_s_total", counter_delta=True,
        op=">", threshold=0.3, window_s=6.0, group_by=["device"],
        action="migrate_noisiest", arg_tags={"device": "device"},
        cooldown_s=12.0,
        summary="device accruing unserved (queue) time: migrate its "
                "top-share tenant")]
    h = _make_harness(seed, alert_rules_for_policies(), rules,
                      policies)
    utils: List[float] = []
    migrations: List[dict] = []
    try:
        h.start()
        tg = TraceGenerator(h)
        tg.build_cluster(p["nodes"], p["chips"])

        # one tpfprof profiler per node: the attribution evidence AND
        # the policy trigger (its series ship via the metrics recorder)
        profs: Dict[str, Profiler] = {
            node: Profiler(name=node, clock=h.clock, bin_s=1.0)
            for node in tg.node_names}
        for prof in profs.values():
            h.op.metrics.register_profiler(prof)
            h.op.policy.profilers.append(prof)

        def migrate_noisiest(device: str = "", **_ignored):
            prof = profs.get(device)
            if prof is None:
                raise ActuationError(f"unknown device {device!r}")
            tenants = prof.snapshot(bins=0)["tenants"]
            if not tenants:
                raise ActuationError(f"no tenants attributed on "
                                     f"{device!r}")
            top = max(sorted(tenants),
                      key=lambda t: tenants[t]["compute_s"])
            ns, pod = top.split("/", 1)
            new_node = h.op.migrator.migrate(ns, pod,
                                             wait_rebind_s=5.0)
            if new_node is None:
                raise ActuationError(
                    f"migration of {top} off {device} did not rebind")
            migrations.append({"tenant": top, "from": device,
                               "to": new_node})
            return {"tenant": top, "from": device, "to": new_node}
        h.op.policy.actuators["migrate_noisiest"] = migrate_noisiest

        # evidence fallback: a device-grouped trigger cites the pods
        # bound to that node (their admission traces)
        def exemplars(group_tags: dict) -> list:
            node = group_tags.get("device", "")
            out = []
            for pod in sorted(h.op.store.list(Pod),
                              key=lambda q: q.key()):
                if pod.spec.node_name != node:
                    continue
                raw = pod.metadata.annotations.get(
                    constants.ANN_TRACE_CONTEXT, "")
                tid = raw.split(":", 1)[0]
                if tid and tid not in out:
                    out.append(tid)
                if len(out) >= 3:
                    break
            return out
        h.op.policy.exemplar_source = exemplars

        # submit: noisy first (packs onto node 0 with its victims)
        def submit(name: str):
            def fire():
                try:
                    h.op.submit_pod(_client_pod(
                        name, "default", p["tflops"], p["hbm_gib"]))
                except AdmissionShedError:
                    pass
            return fire
        h.at(1.0, submit("noisy-0"))
        for i in range(p["goods"]):
            h.at(1.5 + 0.05 * i + h.rng.uniform(0.0, 0.04),
                 submit(f"good-{i:03d}"))

        # the demand/contention model, attributed into the per-node
        # profilers each second: every tenant burns ``good_duty`` of a
        # node's PHYSICAL capacity — except the noisy one, which burns
        # overdraft x that; an oversubscribed node serves everyone the
        # same throttled fraction (duty fair-sharing)
        served_samples: List[tuple] = []

        def attribute_tick():
            now_m = h.clock.monotonic()
            by_node: Dict[str, list] = {}
            for pod in h.op.store.list(Pod):
                if pod.spec.node_name:
                    by_node.setdefault(pod.spec.node_name,
                                       []).append(pod)
            for node in sorted(by_node):
                demands = []
                for pod in sorted(by_node[node],
                                  key=lambda q: q.key()):
                    mult = p["overdraft"] \
                        if pod.metadata.name.startswith("noisy") \
                        else 1.0
                    demands.append((pod, p["good_duty"] * mult))
                total = sum(d for _, d in demands)
                served = min(1.0, 1.0 / total) if total else 1.0
                prof = profs.get(node)
                for pod, frac in demands:
                    prof.attribute(pod.key(), "compute",
                                   frac * served, end_m=now_m)
                    unserved = frac * (1.0 - served)
                    if unserved > 0:
                        prof.attribute(pod.key(), "queue", unserved,
                                       end_m=now_m)
                    if pod.metadata.name.startswith("good") and \
                            now_m > p["warmup_s"]:
                        served_samples.append(
                            (pod.key(), served >= p["served_slo"]))
        h.every(1.0, attribute_tick)
        _sample_utilization(h, utils)
        h.run_for(p["run_s"])

        ok_samples = sum(1 for _, ok in served_samples if ok)
        attainment = 100.0 * ok_samples / len(served_samples) \
            if served_samples else 0.0
        score = {
            "pods": p["goods"],
            "attained": ok_samples,
            "slo_attainment_pct": round(attainment, 2),
            "utilization_pct": round(
                100.0 * sum(utils) / len(utils), 2) if utils else 0.0,
            "migrations": len(migrations),
            "nodes_added": 0,
            "admission_sheds": 0,
        }
        return _result(h, "noisy-neighbor", seed, scale, policies,
                       t0, score)
    finally:
        h.stop()


def _crit_noisy(pol: dict, base: dict) -> List[str]:
    v = []
    ps, bs = pol["score"], base["score"]
    if ps["slo_attainment_pct"] < bs["slo_attainment_pct"] + 10.0:
        v.append(f"noisy-neighbor: policy attainment "
                 f"{ps['slo_attainment_pct']}% does not beat baseline "
                 f"{bs['slo_attainment_pct']}% by >=10pp")
    if not 1 <= ps["migrations"] <= 4:
        v.append(f"noisy-neighbor: {ps['migrations']} migrations "
                 f"(want 1..4 — the loop must converge, not flap)")
    if bs["migrations"] != 0:
        v.append("noisy-neighbor: baseline migrated?!")
    return v


CRITERIA["noisy-neighbor"] = _crit_noisy


# -- campaign 3: admission-storm -> admit-control-on-shed ------------------


@campaign("admission-storm")
def admission_storm(seed: int = 0, scale: str = "small",
                    policies: bool = True) -> dict:
    """A runaway namespace floods pod submissions far past anything it
    can use, starving the well-behaved tenants' bind-latency SLO.  Its
    quota's alertThresholdPercent fires the stock ``quota-pressure``
    alert; the **admit-control-on-shed** policy answers by admission-
    blocking the namespace at the webhook for a TTL — new storm pods
    are shed at the cheapest point (BUSY-style, with retry-after)
    while bound ones churn out.  Baseline: the storm holds the whole
    pool and the good tenants queue behind it."""
    p = SCALES[scale]["admission-storm"]
    t0 = _wall_time.perf_counter()
    rules = [AlertPolicyRule(
        name="admit-control-on-shed", alert_rule="quota-pressure",
        action="admit_control", arg_tags={"namespace": "namespace"},
        static_args={"ttl_s": 10.0}, cooldown_s=8.0,
        summary="namespace burning through its quota threshold: shed "
                "its new pods at admission")]
    # quota-pressure is a stock evaluator rule: pass None so the
    # defaults (plus the policy trigger rules) apply
    h = _make_harness(seed, None, rules, policies)
    utils: List[float] = []
    counters = {"storm_submitted": 0, "storm_shed": 0, "good": 0}
    try:
        h.start()
        tg = TraceGenerator(h)
        tg.build_cluster(p["nodes"], p["chips"])

        # the storm namespace's quota: a generous cap, but an
        # alertThresholdPercent low enough that the stock
        # quota-pressure alert fires long before the cap
        quota = TPUResourceQuota.new("storm-quota", namespace="storm")
        quota.spec.total.requests.tflops = p["quota_tflops"]
        quota.spec.total.alert_threshold_percent = \
            p["quota_threshold_pct"]
        h.store.create(quota)
        h.pump()

        seq = {"good": 0, "storm": 0}

        def submit_good():
            i = seq["good"]
            seq["good"] += 1
            name = f"good-{i:05d}"
            try:
                h.op.submit_pod(_client_pod(name, "default",
                                            p["tflops"],
                                            p["hbm_gib"]))
                counters["good"] += 1
            except AdmissionShedError:
                return
            h.at(h.clock.monotonic() + p["good_life"],
                 lambda: tg_delete("default", name))

        def submit_storm():
            i = seq["storm"]
            seq["storm"] += 1
            name = f"storm-{i:05d}"
            counters["storm_submitted"] += 1
            try:
                h.op.submit_pod(_client_pod(name, "storm",
                                            p["tflops"],
                                            p["hbm_gib"]))
            except AdmissionShedError:
                counters["storm_shed"] += 1
                return
            h.at(h.clock.monotonic() + p["storm_life"],
                 lambda: tg_delete("storm", name))

        def tg_delete(ns: str, name: str):
            try:
                h.op.delete_pod(name, ns)
            except NotFoundError:
                pass      # already churned out: nothing to delete

        # seeded jitter on both arrival processes: the trace, not just
        # the story, is a function of the seed
        h.every(p["good_period"], submit_good,
                jitter_s=p["good_period"] * 0.1)

        def storm_tick():
            now = h.clock.monotonic()
            if p["storm_start"] <= now <= p["storm_end"]:
                submit_storm()
        h.every(p["storm_period"], storm_tick,
                jitter_s=p["storm_period"] * 0.1)
        _sample_utilization(h, utils)
        h.run_for(p["run_s"])

        score = dict(
            _attainment(h, "default", p["slo_s"], prefix="good-"),
            utilization_pct=round(
                100.0 * sum(utils) / len(utils), 2) if utils else 0.0,
            migrations=0,
            nodes_added=0,
            admission_sheds=counters["storm_shed"],
            storm_submitted=counters["storm_submitted"],
            webhook_sheds=h.op.mutator.admission_shed_total)
        return _result(h, "admission-storm", seed, scale, policies,
                       t0, score)
    finally:
        h.stop()


def _crit_storm(pol: dict, base: dict) -> List[str]:
    v = []
    ps, bs = pol["score"], base["score"]
    if ps["slo_attainment_pct"] < bs["slo_attainment_pct"] + 20.0:
        v.append(f"admission-storm: policy attainment "
                 f"{ps['slo_attainment_pct']}% does not beat baseline "
                 f"{bs['slo_attainment_pct']}% by >=20pp")
    if ps["slo_attainment_pct"] < 80.0:
        v.append(f"admission-storm: policy attainment "
                 f"{ps['slo_attainment_pct']}% < 80%")
    if ps["admission_sheds"] < 1:
        v.append("admission-storm: the webhook never shed a storm pod")
    if bs["admission_sheds"] != 0:
        v.append("admission-storm: baseline shed pods?!")
    return v


CRITERIA["admission-storm"] = _crit_storm
