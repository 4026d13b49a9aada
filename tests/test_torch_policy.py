"""The port's policy engine (tensorfusion_tpu_torch/policy/) against the
reference's.

The reference's own cases (tests/test_policy.py from the ledger to the
operator's wiring, its hypervisor case with the TUI's policy pane, its
tpfpolicy CLI case, and test_observability.py::
test_resolve_refire_does_not_flap_policy_actuator) run here as one
parametrised test each, over both packages (``m``).  The reference's CLI
(tools/tpfpolicy.py) reads the port's exported log.  Beside them: the
ledgers of both packages' engines on the same alerts, byte-equal, and
the tenant tag a co-hosted worker's profiler gives the ``tenant-skew``
alert, which the ``migrate_tenant`` actuator refuses in both packages
(ROADMAP queue 3, fault 12).
"""

import importlib
import json
import time
import types
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

_NAMES = {
    'ActuationError': ('policy', 'ActuationError'),
    'AdmissionShedError': ('webhook', 'AdmissionShedError'),
    'AlertEvaluator': ('alert.evaluator', 'AlertEvaluator'),
    'AlertPolicyRule': ('policy', 'AlertPolicyRule'),
    'AlertRule': ('alert.evaluator', 'AlertRule'),
    'Clock': ('clock', 'Clock'),
    'ConflictError': ('store', 'ConflictError'),
    'Container': ('api.types', 'Container'),
    'DecisionLedger': ('policy', 'DecisionLedger'),
    'FlightRecorder': ('profiling.recorder', 'FlightRecorder'),
    'HypervisorServer': ('hypervisor.server', 'HypervisorServer'),
    'METRICS_SCHEMA': ('metrics.schema', 'METRICS_SCHEMA'),
    'MetricPolicyRule': ('policy', 'MetricPolicyRule'),
    'ObjectStore': ('store', 'ObjectStore'),
    'Operator': ('operator', 'Operator'),
    'Pod': ('api.types', 'Pod'),
    'PodMutator': ('webhook', 'PodMutator'),
    'PolicyEngine': ('policy', 'PolicyEngine'),
    'RemoteDevice': ('remoting', 'RemoteDevice'),
    'RemoteVTPUWorker': ('remoting', 'RemoteVTPUWorker'),
    'TSDB': ('metrics.tsdb', 'TSDB'),
    'Tracer': ('tracing', 'Tracer'),
    'WorkloadParser': ('webhook', 'WorkloadParser'),
    'constants': ('', 'constants'),
    'default_actuators': ('policy', 'default_actuators'),
    'default_policies': ('policy', 'default_policies'),
    'load_policy_log': ('policy', 'load_policy_log'),
    'tui': ('hypervisor', 'tui'),
    'parse_line': ('metrics.encoder', 'parse_line'),
    'policy_digest': ('policy', 'policy_digest'),
    'policy_lines': ('policy', 'policy_lines'),
    'profile_lines': ('profiling.export', 'profile_lines'),
    'validate_policy_log': ('policy', 'validate_policy_log'),
    'verify_bundle': ('profiling.recorder', 'verify_bundle'),
    'write_policy_log': ('policy', 'write_policy_log'),
}


def _namespace(root):
    out = {}
    for name, (mod, attr) in _NAMES.items():
        module = importlib.import_module(f"{root}.{mod}" if mod else root)
        try:
            out[name] = getattr(module, attr)
        except AttributeError:
            out[name] = importlib.import_module(f"{module.__name__}.{attr}")
    return types.SimpleNamespace(pkg=root, **out)


PKGS = {"ref": _namespace("tensorfusion_tpu"),
        "port": _namespace("tensorfusion_tpu_torch")}


@pytest.fixture(params=sorted(PKGS))
def m(request):
    return PKGS[request.param]


def fake_clock(m, t0=1000.0):
    """A settable clock for cooldown and TTL arithmetic, of ``m``'s Clock."""

    class FakeClock(m.Clock):
        def __init__(self):
            self.t = t0

        def now(self):
            return self.t

        def now_ns(self):
            return int(self.t * 1e9)

        def monotonic(self):
            return self.t

        def sleep(self, seconds):
            self.t += seconds

        def wait(self, event, timeout=None):
            return event.wait(0)

    return FakeClock()


def _pending_rule(m, **kw):
    defaults = dict(name="pods-pending", measurement="tpf_scheduler",
                    metric_field="pending_pods", agg="last", op=">",
                    threshold=0.0, window_s=60.0, for_s=0.0)
    defaults.update(kw)
    return m.AlertRule(**defaults)


def _engine(m, tsdb, alerts, rules, actuators, **kw):
    return m.PolicyEngine(tsdb, alerts=alerts, rules=rules, actuators=actuators, **kw)


def _firing(m, clock, pending=1):
    """A TSDB with unschedulable pods and an evaluator that has fired on it."""
    tsdb = m.TSDB(clock=clock)
    tsdb.insert("tpf_scheduler", {}, {"pending_pods": pending}, clock.now())
    ev = m.AlertEvaluator(tsdb, rules=[_pending_rule(m)], clock=clock)
    ev.evaluate_once()
    return tsdb, ev


# -- ledger ------------------------------------------------------------------


def test_ledger_bounded_ring_conflates_oldest_and_digests(m):
    led = m.DecisionLedger(clock=fake_clock(m), maxlen=4)
    for i in range(7):
        d = led.record(f"r{i}", "a", "t")
        led.actuated(d.id, "a", {}, ok=True)
    snap = led.snapshot()
    assert [d["id"] for d in snap["decisions"]] == [4, 5, 6, 7]
    assert snap["dropped"] == 3
    assert snap["total_recorded"] == 7
    led2 = m.DecisionLedger(clock=fake_clock(m), maxlen=4)
    for i in range(7):
        d = led2.record(f"r{i}", "a", "t")
        led2.actuated(d.id, "a", {}, ok=True)
    assert led.digest() == led2.digest()
    # and the same history gives the same digest in the other package
    other = PKGS["ref" if m.pkg != "tensorfusion_tpu" else "port"]
    led3 = other.DecisionLedger(clock=fake_clock(other), maxlen=4)
    for i in range(7):
        d = led3.record(f"r{i}", "a", "t")
        led3.actuated(d.id, "a", {}, ok=True)
    assert led3.digest() == led.digest()


def test_ledger_settle_only_moves_pending(m):
    led = m.DecisionLedger(clock=fake_clock(m))
    d = led.record("r", "a", "t")
    led.actuated(d.id, "a", {}, ok=False, error="boom")
    assert led.get(d.id).outcome["state"] == "failed"
    led.settle(d.id, "resolved")          # failed stays failed
    assert led.get(d.id).outcome["state"] == "failed"


# -- trigger shapes + cooldown -----------------------------------------------


def test_alert_rule_fires_actuates_and_settles(m):
    clock = fake_clock(m)
    tsdb, ev = _firing(m, clock, pending=7)
    calls = []
    eng = _engine(m, tsdb, ev,
                  [m.AlertPolicyRule(name="scale-on-burn", alert_rule="pods-pending",
                                     action="scale_pool", static_args={"nodes": 2},
                                     cooldown_s=30.0)],
                  {"scale_pool": lambda **kw: calls.append(kw) or {"ok": True}},
                  clock=clock)
    made = eng.evaluate_once()
    assert len(made) == 1 and calls == [{"nodes": 2}]
    d = made[0]
    assert d.trigger == "pods-pending"
    assert d.evidence["trigger"]["value"] == 7
    assert d.actuation["ok"] is True
    assert d.outcome["state"] == "pending"
    clock.t += 10                          # cooldown suppresses the refire
    assert eng.evaluate_once() == []
    assert eng.suppressed_total == 1
    tsdb.insert("tpf_scheduler", {}, {"pending_pods": 0}, clock.now())
    ev.evaluate_once()
    eng.evaluate_once()
    assert eng.ledger.get(d.id).outcome["state"] == "resolved"
    assert eng.resolved_total == 1


def test_alert_refire_after_cooldown_actuates_again(m):
    clock = fake_clock(m)
    tsdb, ev = _firing(m, clock, pending=3)
    calls = []
    eng = _engine(m, tsdb, ev,
                  [m.AlertPolicyRule(name="scale-on-burn", alert_rule="pods-pending",
                                     action="a", cooldown_s=20.0)],
                  {"a": lambda **kw: calls.append(1)}, clock=clock)
    eng.evaluate_once()
    clock.t += 21
    tsdb.insert("tpf_scheduler", {}, {"pending_pods": 4}, clock.now())
    ev.evaluate_once(now=clock.now())
    eng.evaluate_once()
    assert len(calls) == 2          # still firing past cooldown: act


def test_metric_rule_counter_delta_reset_safe(m):
    clock = fake_clock(m)
    tsdb = m.TSDB(clock=clock)
    rule = m.MetricPolicyRule(
        name="admit-control-on-busy", measurement="tpf_serving_engine",
        metric_field="busy_rejected_total", counter_delta=True, op=">",
        threshold=10.0, window_s=60.0, group_by=["node"], action="admit",
        static_args={"namespace": "storm"}, cooldown_s=1.0)
    calls = []
    eng = _engine(m, tsdb, None, [rule], {"admit": lambda **kw: calls.append(kw)},
                  clock=clock)
    tags = {"node": "n1", "engine": "e"}
    tsdb.insert("tpf_serving_engine", tags, {"busy_rejected_total": 100}, clock.now() - 70)
    tsdb.insert("tpf_serving_engine", tags, {"busy_rejected_total": 105}, clock.now())
    assert eng.evaluate_once() == []
    tsdb.insert("tpf_serving_engine", tags, {"busy_rejected_total": 140}, clock.now())
    assert len(eng.evaluate_once()) == 1
    assert calls[-1]["namespace"] == "storm"
    clock.t += 70                          # a counter reset past the window
    tsdb.insert("tpf_serving_engine", tags, {"busy_rejected_total": 2}, clock.now())
    assert eng.evaluate_once() == []
    tsdb.insert("tpf_serving_engine", tags, {"busy_rejected_total": 30}, clock.now())
    assert len(eng.evaluate_once()) == 1


# -- actuation failure postmortems ---------------------------------------------


def test_actuator_raise_records_failure_and_bundles(m, tmp_path):
    clock = fake_clock(m)
    tsdb, ev = _firing(m, clock)
    rec = m.FlightRecorder(clock=clock, bundle_dir=str(tmp_path))

    def broken(**kw):
        raise m.ActuationError("no placement anywhere")

    eng = _engine(m, tsdb, ev,
                  [m.AlertPolicyRule(name="r", alert_rule="pods-pending", action="x",
                                     cooldown_s=0.0)],
                  {"x": broken}, clock=clock, recorder=rec)
    d = eng.evaluate_once()[0]
    assert d.actuation["ok"] is False
    assert "no placement" in d.actuation["error"]
    assert d.outcome["state"] == "failed"
    assert eng.actuation_failures_total == 1
    bundles = sorted(tmp_path.glob("bundle-*"))
    assert len(bundles) == 1 and "policy-actuate-r" in bundles[0].name
    assert m.verify_bundle(str(bundles[0])) == []
    extra = json.loads((bundles[0] / "extra.json").read_text())
    assert extra["decision"]["id"] == d.id
    kinds = [e["kind"] for e in
             json.loads((bundles[0] / "rings.json").read_text())["policy"]["events"]]
    assert "actuate-failed" in kinds


def test_conflict_exhausted_store_write_bundles(m, tmp_path):
    clock = fake_clock(m)
    tsdb, ev = _firing(m, clock)
    rec = m.FlightRecorder(clock=clock, bundle_dir=str(tmp_path))

    def conflicted(**kw):
        raise m.ConflictError("version 4 != 7 after 4 retries")

    eng = _engine(m, tsdb, ev,
                  [m.AlertPolicyRule(name="r", alert_rule="pods-pending", action="x",
                                     cooldown_s=0.0)],
                  {"x": conflicted}, clock=clock, recorder=rec)
    d = eng.evaluate_once()[0]
    assert d.outcome["state"] == "failed"
    assert "ConflictError" in d.actuation["error"]
    assert len(list(tmp_path.glob("bundle-*"))) == 1


def test_missing_actuator_is_a_failure_not_a_crash(m):
    clock = fake_clock(m)
    tsdb, ev = _firing(m, clock)
    eng = _engine(m, tsdb, ev,
                  [m.AlertPolicyRule(name="r", alert_rule="pods-pending", action="nope",
                                     cooldown_s=0.0)],
                  {}, clock=clock)
    d = eng.evaluate_once()[0]
    assert d.actuation["ok"] is False
    assert "no actuator registered" in d.actuation["error"]


# -- spans + metrics schema ----------------------------------------------------


def test_policy_spans_decide_actuate_pair(m):
    clock = fake_clock(m)
    tsdb, ev = _firing(m, clock)
    tracer = m.Tracer(service="policy-test", clock=clock, sample=1.0)
    eng = _engine(m, tsdb, ev,
                  [m.AlertPolicyRule(name="r", alert_rule="pods-pending", action="a",
                                     cooldown_s=0.0)],
                  {"a": lambda **kw: None}, clock=clock, tracer=tracer)
    eng.evaluate_once()
    spans = {s["name"]: s for s in tracer.finished()}
    assert {"policy.decide", "policy.actuate"} <= set(spans)
    assert spans["policy.actuate"]["trace_id"] == spans["policy.decide"]["trace_id"]
    assert spans["policy.decide"]["attrs"]["rule"] == "r"
    assert spans["policy.actuate"]["attrs"]["decision"] == 1


def test_policy_lines_conform_to_metrics_schema(m):
    clock = fake_clock(m)
    tsdb, ev = _firing(m, clock)
    eng = _engine(m, tsdb, ev,
                  [m.AlertPolicyRule(name="r", alert_rule="pods-pending", action="a",
                                     cooldown_s=0.0)],
                  {"a": lambda **kw: None}, clock=clock)
    eng.evaluate_once()
    lines = m.policy_lines(eng, "node-x", 123)
    assert len(lines) == 2          # engine + one rule line
    for line in lines:
        measurement, tags, fields, _ = m.parse_line(line)
        entry = m.METRICS_SCHEMA[measurement]
        assert set(tags) == set(entry["tags"])
        assert set(fields) <= set(entry["fields"])
    name, _, fields, _ = m.parse_line(lines[0])
    assert name == "tpf_policy_engine"
    assert fields["decisions_total"] == 1


def test_default_policies_reference_declared_series(m):
    for rule in m.default_policies():
        if isinstance(rule, m.MetricPolicyRule):
            assert rule.measurement in m.METRICS_SCHEMA
            assert rule.metric_field in m.METRICS_SCHEMA[rule.measurement]["fields"]
    assert [vars(r) for r in m.default_policies()] == \
        [vars(r) for r in PKGS["ref"].default_policies()]


# -- webhook admission control --------------------------------------------------


def test_webhook_admission_block_sheds_then_expires(m):
    c = m.constants
    clock = fake_clock(m)
    store = m.ObjectStore()
    mutator = m.PodMutator(store, m.WorkloadParser(store), clock=clock)

    def pod(name, ns="storm"):
        p = m.Pod.new(name, namespace=ns)
        p.metadata.annotations[c.ANN_POOL] = "pool-a"
        p.metadata.annotations[c.ANN_TFLOPS_REQUEST] = "10"
        p.metadata.annotations[c.ANN_IS_LOCAL_TPU] = "true"
        p.spec.containers = [m.Container(name="main")]
        return p

    mutator.handle(pod("ok-before"))
    until = mutator.set_admission_block("storm", ttl_s=30.0)
    assert until == pytest.approx(clock.now() + 30.0)
    with pytest.raises(m.AdmissionShedError) as ei:
        mutator.handle(pod("shed-1"))
    assert ei.value.namespace == "storm"
    assert 0 < ei.value.retry_after_s <= 30.0
    snap = mutator.admission_control_snapshot()
    assert snap["shed_total"] == 1 and snap["sheds"]["storm"] == 1
    mutator.set_admission_block("storm", ttl_s=5.0)      # extends, never shortens
    assert mutator.admission_blocked("storm") == pytest.approx(30.0)
    mutator.handle(pod("other", ns="default"))
    clock.t += 31.0
    mutator.handle(pod("ok-after"))
    assert mutator.admission_blocked("storm") == 0.0


# -- operator wiring + surfaces --------------------------------------------------


def test_operator_enable_policy_wires_engine_alerts_actuators(m):
    op = m.Operator(enable_policy=True)
    try:
        assert op.policy is not None and op.alerts is not None and op.metrics is not None
        assert {"pods-pending", "tenant-skew", "quota-pressure"} <= \
            {r.name for r in op.alerts.rules}
        assert {"scale_pool", "migrate_tenant", "admit_control", "defrag_node",
                "autoscale"} <= set(op.policy.actuators)
        assert {r.name for r in op.policy.rules} == {r.name for r in m.default_policies()}
        assert op.migrator is not None and op.compaction.migrator is op.migrator
    finally:
        op.stop()


def test_hypervisor_policy_endpoint(m):
    """The reference's hypervisor case: the policy endpoint, and the TUI's
    policy pane and view over what it served."""
    clock = fake_clock(m)
    tsdb, ev = _firing(m, clock)
    eng = _engine(m, tsdb, ev,
                  [m.AlertPolicyRule(name="scale-on-burn", alert_rule="pods-pending",
                                     action="a", cooldown_s=0.0)],
                  {"a": lambda **kw: {"claims": ["c1"]}}, clock=clock)
    eng.evaluate_once()
    srv = m.HypervisorServer(devices=None, workers=None, port=0, policy_engines=[eng])
    srv.start()
    try:
        with urllib.request.urlopen(f"{srv.url}/api/v1/policy", timeout=5) as r:
            snaps = json.loads(r.read())
        assert len(snaps) == 1
        assert snaps[0]["counters"]["decisions_total"] == 1
        assert snaps[0]["ledger"]["decisions"][0]["rule"] == "scale-on-burn"
        pane = m.tui.render_policy(snaps)
        assert "scale-on-burn" in pane and "decisions=1" in pane
        state = m.tui.TuiState()
        state.update_policy(snaps)
        assert state.key("o") and state.view == "policy"
        assert "scale-on-burn" in state.render()
    finally:
        srv.stop()


def test_tpfpolicy_cli_log_explain_check(m, tmp_path, capsys):
    """The reference's tools/tpfpolicy.py over a log each package wrote."""
    import tools.tpfpolicy as cli

    clock = fake_clock(m)
    tsdb, ev = _firing(m, clock, pending=2)
    eng = _engine(m, tsdb, ev,
                  [m.AlertPolicyRule(name="scale-on-burn", alert_rule="pods-pending",
                                     action="a", cooldown_s=0.0)],
                  {"a": lambda **kw: {"claims": ["c"]}}, clock=clock, profilers=[])
    eng.evaluate_once()
    path = str(tmp_path / "policy.json")
    m.write_policy_log(path, eng, meta={"test": True})
    doc = m.load_policy_log(path)
    assert m.validate_policy_log(doc) == []
    assert PKGS["ref"].validate_policy_log(doc) == []
    assert cli.main(["log", path]) == 0
    assert cli.main(["explain", path, "1"]) == 0
    out = capsys.readouterr().out
    assert "scale-on-burn" in out and "pods-pending" in out
    assert cli.main(["check", path]) == 0
    assert cli.main(["explain", path, "99"]) == 1
    doc["snapshot"]["counters"]["decisions_total"] = 42
    with open(path, "w") as f:
        json.dump(doc, f)
    assert cli.main(["check", path]) == 1


# -- test_observability.py -------------------------------------------------------


def test_resolve_refire_does_not_flap_policy_actuator(m):
    """Each firing cycle may actuate at most once per cooldown window,
    however many times the alert resolves and refires inside it."""
    db = m.TSDB()
    ev = m.AlertEvaluator(db, rules=[m.AlertRule(
        name="flap", measurement="m", metric_field="v", agg="last",
        op=">", threshold=10.0, window_s=600.0)])
    calls = []
    eng = m.PolicyEngine(db, alerts=ev,
                         rules=[m.AlertPolicyRule(name="act-on-flap", alert_rule="flap",
                                                  action="a", cooldown_s=100.0)],
                         actuators={"a": lambda **kw: calls.append(1)})
    t0 = time.time()
    for k in range(4):                    # 4 fire/resolve cycles
        db.insert("m", {}, {"v": 99.0}, t0 + 20 * k + 1)
        ev.evaluate_once(now=t0 + 20 * k + 2)
        eng.evaluate_once(now=t0 + 20 * k + 2)
        db.insert("m", {}, {"v": 0.0}, t0 + 20 * k + 10)
        ev.evaluate_once(now=t0 + 20 * k + 11)
        eng.evaluate_once(now=t0 + 20 * k + 11)
    assert len(calls) == 1
    assert eng.suppressed_total == 3


# -- both packages on the same alerts ----------------------------------------------


def _ledger_run(m):
    """The default catalog over scripted alerts under a manual clock, the
    actuators recording their calls: (lines, digest, calls)."""
    from importlib import import_module

    evaluator = import_module(f"{m.pkg}.alert.evaluator")
    engine_mod = import_module(f"{m.pkg}.policy.engine")
    clock = fake_clock(m, 2000.0)
    tsdb = m.TSDB(clock=clock)
    rules = evaluator.default_rules()
    rules += engine_mod.alert_rules_for_policies()
    ev = m.AlertEvaluator(tsdb, rules=rules, clock=clock)
    calls = []

    def act(name):
        def fn(**kw):
            calls.append((name, sorted(kw.items())))
            if kw.get("tenant", "x/y").count("/") != 1:
                raise m.ActuationError(f"tenant {kw['tenant']!r} is not an ns/pod key")
            return {"ok": name}
        return fn

    eng = m.PolicyEngine(tsdb, alerts=ev, rules=m.default_policies(),
                         actuators={a: act(a) for a in (
                             "scale_pool", "migrate_tenant", "admit_control",
                             "defrag_node", "autoscale")}, clock=clock)
    for t, pending, shares, busy in (
            (2000.0, 2, {"ns/a": 10.0}, 0), (2005.0, 2, {"ns/a": 60.0, "cn3:": 45.0}, 5),
            (2008.0, 2, {"ns/a": 61.0, "cn3:": 50.0}, 40), (2016.0, 0, {"ns/a": 5.0}, 41),
            (2050.0, 0, {"ns/a": 70.0, "cn3:": 70.0}, 90), (2053.0, 0, {"ns/a": 70.0}, 91),
            (2090.0, 0, {}, 91)):
        clock.t = t
        tsdb.insert("tpf_scheduler", {}, {"pending_pods": pending}, t)
        for tenant, share in shares.items():
            tsdb.insert("tpf_prof_tenant", {"tenant": tenant, "node": "n", "qos": "low"},
                        {"device_share_pct": share}, t, exemplar=f"tr-{tenant}")
        tsdb.insert("tpf_serving_engine", {"node": "n", "engine": "e"},
                    {"busy_rejected_total": busy}, t)
        ev.evaluate_once(now=t)
        eng.evaluate_once(now=t)
    return (m.policy_lines(eng, "operator", 7), m.policy_digest(eng.snapshot()), calls,
            eng.snapshot()["counters"])


def test_both_packages_keep_one_ledger_on_the_same_alerts():
    ref, port = _ledger_run(PKGS["ref"]), _ledger_run(PKGS["port"])
    assert port == ref
    counters = port[3]
    assert counters["decisions_total"] >= 4 and counters["actuation_failures_total"] >= 1
    assert counters["resolved_total"] >= 1 and counters["suppressed_total"] >= 1
    assert {name for name, _ in port[2]} >= {"scale_pool", "migrate_tenant",
                                              "admit_control"}


# -- the tenant tag the worker's profiler gives ------------------------------------


def test_a_workers_tenant_tag_names_no_pod_in_either_package(m):
    """What the reference's own loop would name: a co-hosted worker's
    profiler attributes device time to the dispatcher's connection
    (``cn<seq>:``), so the ``tpf_prof_tenant`` series the ``tenant-skew``
    alert groups by carries no ``ns/pod`` key, and ``migrate-on-skew``'s
    actuator refuses it.  Neither package can name the pod: ROADMAP
    queue 3 fault 12."""
    worker = m.RemoteVTPUWorker(**({"device": "cpu"} if m.pkg.endswith("_torch") else {}))
    worker.start()
    dev = m.RemoteDevice(worker.url, timeout_s=30)
    try:
        dev.remote_jit(lambda x: x * 2.0)(np.ones(1024, dtype=np.float32))
        lines = m.profile_lines(worker.profiler.snapshot(), "node-a", 0)
    finally:
        dev.close()
        worker.stop()
    tenants = [m.parse_line(l)[1]["tenant"] for l in lines
               if m.parse_line(l)[0] == "tpf_prof_tenant"]
    assert tenants and all("/" not in t and t.startswith("cn") for t in tenants)
    op = types.SimpleNamespace(migrator=None, store=m.ObjectStore())
    with pytest.raises(m.ActuationError, match="not an ns/pod key"):
        m.default_actuators(op)["migrate_tenant"](tenant=tenants[0])
