"""The port's TSDB, metrics recorder, autoscaler, alert evaluator and cloud
pricing (tensorfusion_tpu_torch.metrics, .autoscaler, .alert,
.cloudprovider) against the reference's.

The reference's own cases (tests/test_observability.py, without the policy
engine's case, and the recorder push of test_metrics_shipping.py) run here
as one parametrised test each, over both packages (``m``).  Beside them:
one seeded stream of series gives both TSDBs, alert evaluators and
recommenders the same answers, and the port's autoscaler converts an
H100's duty at the H100's own peak.
"""

import http.server
import importlib
import json
import os
import threading
import time
import types

import numpy as np
import pytest

from tensorfusion_tpu_torch.testing import fresh_library

_NAMES = {
    'AlertEvaluator': ('alert', 'AlertEvaluator'),
    'AlertRule': ('alert', 'AlertRule'),
    'AllocationController': ('hypervisor', 'AllocationController'),
    'AutoScaler': ('autoscaler', 'AutoScaler'),
    'BurnRateRule': ('alert.evaluator', 'BurnRateRule'),
    'Container': ('api.types', 'Container'),
    'CronRecommender': ('autoscaler.recommender', 'CronRecommender'),
    'DecayingHistogram': ('autoscaler', 'DecayingHistogram'),
    'DeviceController': ('hypervisor', 'DeviceController'),
    'ExternalRecommender': ('autoscaler.recommender', 'ExternalRecommender'),
    'HypervisorMetricsRecorder': ('hypervisor.metrics', 'HypervisorMetricsRecorder'),
    'Limiter': ('hypervisor', 'Limiter'),
    'MetricsRecorder': ('metrics.recorder', 'MetricsRecorder'),
    'Operator': ('operator', 'Operator'),
    'PercentileRecommender': ('autoscaler', 'PercentileRecommender'),
    'OperatorServer': ('server', 'OperatorServer'),
    'TPUChip': ('api.types', 'TPUChip'),
    'Pod': ('api.types', 'Pod'),
    'Provider': ('hypervisor', 'Provider'),
    'QosPricing': ('api.types', 'QosPricing'),
    'ResourceAmount': ('api.resources', 'ResourceAmount'),
    'TPUNodeClaim': ('api.types', 'TPUNodeClaim'),
    'TPUPool': ('api.types', 'TPUPool'),
    'TPUResourceQuota': ('api.types', 'TPUResourceQuota'),
    'TSDB': ('metrics.tsdb', 'TSDB'),
    'WorkerController': ('hypervisor', 'WorkerController'),
    'WorkerDeviceRequest': ('hypervisor', 'WorkerDeviceRequest'),
    'WorkerSpec': ('hypervisor', 'WorkerSpec'),
    'constants': ('', 'constants'),
    'cron_matches': ('autoscaler', 'cron_matches'),
    'default_rules': ('alert', 'default_rules'),
    'encode_line': ('metrics.encoder', 'encode_line'),
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


# -- the reference's cases, both packages ------------------------------------


def test_tsdb_insert_query_aggregate(m):
    db = m.TSDB()
    now = time.time()
    for i in range(10):
        db.insert("m", {"chip": "c0"}, {"duty": float(i * 10)},
                  ts=now - 100 + i * 10)
    db.insert("m", {"chip": "c1"}, {"duty": 500.0}, ts=now)

    series = db.query("m", "duty", tags={"chip": "c0"})
    assert len(series) == 1 and len(series[0][1]) == 10
    assert db.aggregate("m", "duty", tags={"chip": "c0"},
                        agg="max", window_s=1000) == 90.0
    assert db.aggregate("m", "duty", tags={"chip": "c0"},
                        agg="mean", window_s=1000) == pytest.approx(45.0)
    assert db.aggregate("m", "duty", agg="p90", window_s=1000) in (90.0,
                                                                   500.0)
    assert db.aggregate("m", "duty", tags={"chip": "zz"}) is None


def test_tsdb_ingest_file_tail(m, tmp_path):
    db = m.TSDB()
    path = tmp_path / "metrics.log"
    path.write_text(m.encode_line("tpf_worker", {"worker": "w1"},
                                {"duty_cycle_pct": 42.0}) + "\n")
    off = db.ingest_file(str(path))
    assert db.aggregate("tpf_worker", "duty_cycle_pct", agg="last") == 42.0
    with open(path, "a") as f:
        f.write(m.encode_line("tpf_worker", {"worker": "w1"},
                            {"duty_cycle_pct": 77.0}) + "\n")
    off = db.ingest_file(str(path), off)
    assert db.aggregate("tpf_worker", "duty_cycle_pct", agg="last") == 77.0


def test_decaying_histogram_percentile_shifts(m):
    h = m.DecayingHistogram(first_bucket=1.0, half_life_s=60.0)
    now = time.time()
    for _ in range(100):
        h.add(10.0, ts=now - 120)     # old usage: 10 (2 half-lives ago)
    for _ in range(20):
        h.add(100.0, ts=now)          # recent spike: 100
    # decay: old mass 100*0.25=25 vs recent 20 -> spike owns the top
    assert h.percentile(90) >= 90.0
    # but the bottom still reflects the old usage level
    assert h.percentile(20) <= 12.0


def test_cron_matching(m):
    # Tuesday 2026-07-28 14:30 local
    when = time.mktime((2026, 7, 28, 14, 30, 0, 0, 0, -1))
    assert m.cron_matches("* * * * *", when)
    assert m.cron_matches("30 14 * * *", when)
    assert m.cron_matches("*/15 9-17 * * *", when)
    assert not m.cron_matches("0 3 * * *", when)
    with pytest.raises(ValueError):
        m.cron_matches("* * *", when)


def _operator_with_host(m):
    op = m.Operator()
    pool = m.TPUPool.new("pool-a")
    pool.spec.name = "pool-a"
    pool.spec.qos_pricing = [m.QosPricing(qos="medium",
                                        requests_per_tflops_hour=0.01,
                                        requests_per_gib_hour=0.005)]
    op.store.create(pool)
    claim = m.TPUNodeClaim.new("m-host")
    claim.spec.pool = "pool-a"
    claim.spec.generation = "v5e"
    claim.spec.chip_count = 8
    op.store.create(claim)
    op.start()
    deadline = time.time() + 5
    while len(op.allocator.chips()) < 8 and time.time() < deadline:
        time.sleep(0.02)
    return op


def _submit(m, op, name, tflops, hbm, autoscale=False):
    pod = m.Pod.new(name, namespace="default")
    ann = pod.metadata.annotations
    ann[m.constants.ANN_POOL] = "pool-a"
    ann[m.constants.ANN_TFLOPS_REQUEST] = str(tflops)
    ann[m.constants.ANN_HBM_REQUEST] = str(hbm)
    ann[m.constants.ANN_IS_LOCAL_TPU] = "true"
    if autoscale:
        ann[m.constants.ANN_AUTOSCALE] = "true"
    pod.spec.containers = [m.Container(name="main")]
    op.submit_pod(pod)
    assert op.wait_for_binding(name) is not None
    return pod


def test_metrics_recorder_and_billing(m):
    op = _operator_with_host(m)
    try:
        _submit(m, op, "bill-1", 98.5, 4 * 2**30)
        tsdb = m.TSDB()
        rec = m.MetricsRecorder(op, tsdb=tsdb)
        n = rec.record_once()
        assert n > 8
        util = tsdb.aggregate("tpf_pool", "utilization",
                              tags={"pool": "pool-a"}, agg="last")
        assert util is not None and util > 0
        cost = tsdb.aggregate("tpf_billing", "hourly_cost",
                              tags={"namespace": "default"}, agg="last")
        # 98.5 tflops * 0.01 + 4 GiB * 0.005 = 1.005/h
        assert cost == pytest.approx(1.005, rel=0.01)
    finally:
        op.stop()


def test_autoscaler_percentile_resize(m):
    op = _operator_with_host(m)
    try:
        _submit(m, op, "auto-1", 20.0, 2 * 2**30, autoscale=True)
        tsdb = m.TSDB()
        scaler = m.AutoScaler(op, tsdb)
        wl_key = "default/auto-1"
        # feed observed usage well above the current 20-tflops request
        now = time.time()
        for i in range(50):
            scaler.observe(wl_key, tflops=35.0, hbm_bytes=2 * 2**30,
                           ts=now - 50 + i)
        adjusted = scaler.run_once()
        assert adjusted == 1
        rec = op.allocator.allocation("default/auto-1")
        # p90(35) * 1.15 margin ~ 40, clamped to <= 2x current
        assert 30.0 <= rec.request.request.tflops <= 40.5
    finally:
        op.stop()


def test_autoscaler_rejects_on_capacity(m):
    op = _operator_with_host(m)
    try:
        _submit(m, op, "auto-2", 150.0, 14 * 2**30, autoscale=True)
        tsdb = m.TSDB()
        scaler = m.AutoScaler(op, tsdb)
        now = time.time()
        for i in range(50):
            # usage implies > the chip's host-EXPANDED HBM budget
            # (16 GiB * 2.2 with the default pool expansion); the resize
            # must be rejected gracefully
            scaler.observe("default/auto-2", tflops=180.0,
                           hbm_bytes=40 * 2**30, ts=now - 50 + i)
        scaler.run_once()
        rec = op.allocator.allocation("default/auto-2")
        assert rec.request.request.hbm_bytes == 14 * 2**30  # unchanged
    finally:
        op.stop()


def test_alert_evaluator_fire_and_resolve_with_webhook(m):
    received = []

    class Hook(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            received.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        db = m.TSDB()
        ev = m.AlertEvaluator(
            db, rules=[m.AlertRule(name="pool-hot", measurement="tpf_pool",
                                 metric_field="utilization", agg="last",
                                 op=">", threshold=0.9,
                                 severity="critical")],
            webhook_url=f"http://127.0.0.1:{server.server_address[1]}/")
        db.insert("tpf_pool", {"pool": "p"}, {"utilization": 0.95})
        changed = ev.evaluate_once()
        assert len(changed) == 1 and changed[0].state == "firing"
        assert "pool-hot" in ev.active_names()
        # duplicate evaluation: no re-fire
        assert ev.evaluate_once() == []

        db.insert("tpf_pool", {"pool": "p"}, {"utilization": 0.2})
        changed = ev.evaluate_once()
        assert changed and changed[0].state == "resolved"
        assert not ev.active
        time.sleep(0.1)
        assert len(received) == 2
        assert received[0][0]["state"] == "firing"
        assert received[1][0]["state"] == "resolved"
    finally:
        server.shutdown()


def test_cron_and_external_recommenders(m):
    """Cron windows fire by schedule; the external recommender round-trips
    a webhook and tolerates failure (autoscaler.go recommender trio)."""
    import http.server
    import json as _json
    import threading


    cron = m.CronRecommender()
    # schedule matching every minute -> fires; impossible minute -> None
    hit = cron.recommend_from_rules(
        [{"schedule": "* * * * *", "tflops": 99.0}])
    assert hit is not None and hit.target.tflops == 99.0
    # no matching rule
    assert cron.recommend_from_rules([]) is None

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            body = _json.loads(self.rfile.read(n))
            assert body["workload"] == "ns/wl"
            out = _json.dumps({"tflops": body["current"]["tflops"] * 2})
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out.encode())

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        ext = m.ExternalRecommender()
        rec = ext.recommend(f"http://127.0.0.1:{srv.server_port}",
                            "ns/wl", m.ResourceAmount(tflops=40.0))
        assert rec is not None and rec.target.tflops == 80.0
        # unreachable endpoint: graceful None, not an exception
        assert m.ExternalRecommender(timeout_s=0.3).recommend(
            "http://127.0.0.1:1/none", "ns/wl",
            m.ResourceAmount(tflops=40.0)) is None
    finally:
        srv.shutdown()


def test_autoscaler_feeds_from_tsdb_series(m):
    """The production metrics path: worker duty/hbm series land in the
    TSDB (as the vector-shipping analog tails them in) and the autoscaler
    pass converts them into percentile observations and a resize —
    covering _feed_observations, which the direct-observe tests skip."""
    op = _operator_with_host(m)
    try:
        _submit(m, op, "tsdb-wl", 20.0, 2 * 2**30, autoscale=True)
        tsdb = m.TSDB()
        now = time.time()
        for i in range(50):
            # worker tag starts with the workload name (worker pod naming)
            tsdb.insert("tpf_worker",
                        {"namespace": "default", "worker": "tsdb-wl"},
                        {"duty_cycle_pct": 20.0},   # 20% of 197 ~ 39.4TF
                        ts=now - 50 + i)
        scaler = m.AutoScaler(op, tsdb)
        adjusted = scaler.run_once()
        assert adjusted == 1
        rec = op.allocator.allocation("default/tsdb-wl")
        # p90(39.4) * 1.15 margin ~ 45, clamped to <= 2x current (40)
        assert 30.0 <= rec.request.request.tflops <= 41.0
    finally:
        op.stop()


def test_quota_pressure_metric_and_default_alert(m):
    """The configured alertThresholdPercent is actually evaluated
    (gpuresourcequota_types.go:26-131): usage crossing the namespace's
    threshold emits over_threshold on tpf_quota, and the shipped default
    rule fires a per-namespace alert that resolves when usage drops."""

    op = _operator_with_host(m)
    try:
        quota = m.TPUResourceQuota.new("q", namespace="default")
        quota.spec.total.requests = m.ResourceAmount(tflops=100.0)
        quota.spec.total.alert_threshold_percent = 95.0
        op.store.create(quota)
        deadline = time.time() + 5
        while op.allocator.quota.get_usage("default") is None and \
                time.time() < deadline:
            time.sleep(0.02)

        tsdb = m.TSDB()
        rec = m.MetricsRecorder(op, tsdb=tsdb)
        ev = m.AlertEvaluator(tsdb, rules=m.default_rules())

        # 80% usage: pressure series exists but no alert
        _submit(m, op, "q-a", 80.0, 2 * 2**30)
        rec.record_once()
        assert tsdb.aggregate("tpf_quota", "pressure_pct",
                              tags={"namespace": "default"},
                              agg="last") == pytest.approx(80.0)
        assert ev.evaluate_once() == []

        # crossing the 95% threshold fires a namespace-named alert
        _submit(m, op, "q-b", 16.0, 2 * 2**30)
        rec.record_once()
        changed = ev.evaluate_once()
        assert [a.rule for a in changed] == ["quota-pressure[default]"]
        assert changed[0].state == "firing"

        # dropping back below resolves it (agg=last sees the new point)
        op.delete_pod("q-b")
        deadline = time.time() + 5
        while op.allocator.allocation("default/q-b") is not None and \
                time.time() < deadline:
            time.sleep(0.02)
        rec.record_once()
        changed = ev.evaluate_once()
        assert [(a.rule, a.state) for a in changed] \
            == [("quota-pressure[default]", "resolved")]
    finally:
        op.stop()


def test_grouped_alert_rule_fires_per_tag_combination(m):
    """group_by evaluates one rule per distinct tag value: two hot
    namespaces fire two alerts; one cooling down resolves only its own."""

    db = m.TSDB()
    ev = m.AlertEvaluator(db, rules=[m.AlertRule(
        name="hot", measurement="m", metric_field="v", agg="max", op=">",
        threshold=50.0, window_s=60.0, group_by=["ns"])])
    t0 = time.time() - 100
    db.insert("m", {"ns": "a"}, {"v": 90.0}, ts=t0)
    db.insert("m", {"ns": "b"}, {"v": 70.0}, ts=t0)
    db.insert("m", {"ns": "c"}, {"v": 10.0}, ts=t0)
    changed = ev.evaluate_once(now=t0 + 10)
    assert sorted(a.rule for a in changed) == ["hot[a]", "hot[b]"]

    # 'a' cools off, 'b' stays hot (fresh points; old ones age out)
    db.insert("m", {"ns": "a"}, {"v": 5.0}, ts=t0 + 70)
    db.insert("m", {"ns": "b"}, {"v": 95.0}, ts=t0 + 70)
    changed = ev.evaluate_once(now=t0 + 75)
    assert [(a.rule, a.state) for a in changed] == [("hot[a]", "resolved")]
    assert ev.active_names() == {"hot[b]"}

    # a group that vanishes from the window entirely also resolves
    changed = ev.evaluate_once(now=t0 + 500)
    assert [(a.rule, a.state) for a in changed] == [("hot[b]", "resolved")]
    assert not ev.active


def test_alert_ownership_is_structural_not_name_prefix(m):
    """A grouped rule 'hot' must never claim/resolve alerts of a distinct
    rule whose literal name happens to start with 'hot[' — ownership is
    tracked by (rule, group) keys, not by parsing rendered names."""

    db = m.TSDB()
    ev = m.AlertEvaluator(db, rules=[
        m.AlertRule(name="hot", measurement="m", metric_field="v",
                  agg="last", op=">", threshold=50.0, window_s=60.0,
                  group_by=["ns"]),
        m.AlertRule(name="hot[b]", measurement="other", metric_field="v",
                  agg="last", op=">", threshold=0.0, window_s=60.0),
    ])
    t0 = time.time()
    db.insert("other", {}, {"v": 1.0}, ts=t0)      # flat rule breaches
    changed = ev.evaluate_once(now=t0 + 1)
    assert [(a.rule, a.state) for a in changed] == [("hot[b]", "firing")]
    # grouped rule 'hot' has no breaching groups; before the fix its
    # resolution pass would string-match and resolve the flat alert
    changed = ev.evaluate_once(now=t0 + 2)
    assert changed == []
    assert ev.active_names() == {"hot[b]"}


def test_flat_rule_honors_evaluation_time(m):
    """The flat-rule path windows on the caller's `now`, consistent with
    the group_by path (not wall-clock time.time())."""

    db = m.TSDB()
    ev = m.AlertEvaluator(db, rules=[m.AlertRule(
        name="old-hot", measurement="m", metric_field="v", agg="max",
        op=">", threshold=50.0, window_s=60.0)])
    t0 = time.time() - 600          # well outside the real-time window
    db.insert("m", {}, {"v": 90.0}, ts=t0)
    changed = ev.evaluate_once(now=t0 + 10)
    assert [(a.rule, a.state) for a in changed] == [("old-hot", "firing")]
    # and outside the simulated window it does not fire
    ev2 = m.AlertEvaluator(db, rules=ev.rules)
    assert ev2.evaluate_once(now=t0 + 500) == []


def test_burn_rate_counter_reset_mid_window_does_not_fire(m):
    """A worker restart resets its good/total counters mid-window.
    The reset-aware delta must neither fire on the negative step (the
    old clamp was safe there) nor GO DEAF afterwards: before this
    round the pre-reset baseline dominated last-minus-baseline until
    it aged out of retention, silencing any genuine post-restart burn
    — a policy riding this rule would have sat on its hands."""

    db = m.TSDB()
    ev = m.AlertEvaluator(db, rules=[m.BurnRateRule(
        name="burn", measurement="m", good_field="good",
        total_field="total", objective=0.99,
        windows=((300.0, 14.4),))])
    now = time.time()
    tags = {"tenant": "a"}
    # healthy history, then a restart: counters drop, traffic healthy
    db.insert("m", tags, {"good": 990.0, "total": 1000.0}, now - 400)
    db.insert("m", tags, {"good": 6.0, "total": 6.0}, now - 50)
    assert ev.evaluate_once(now=now) == []
    # post-restart traffic resumes INSIDE the window and genuinely
    # burns: it must fire even though the pre-reset baseline is still
    # in retention (reset-awareness, not just clamping)
    db.insert("m", tags, {"good": 10.0, "total": 106.0}, now - 1)
    changed = ev.evaluate_once(now=now)
    assert [(a.rule, a.state) for a in changed] == [("burn", "firing")]


def test_burn_exactly_at_threshold_does_not_fire(m):
    """The multi-window burn comparison is strictly greater-than: a
    burn landing exactly ON the threshold holds fire (the SRE-workbook
    pairing pages on breach, not on touch) — and one epsilon past it
    pages."""

    db = m.TSDB()
    rule = m.BurnRateRule(name="edge", measurement="m",
                        good_field="good", total_field="total",
                        objective=0.99, windows=((300.0, 14.4),))
    now = time.time()
    tags = {"tenant": "a"}
    # bad rate exactly 0.144 -> burn exactly 14.4x the 1% budget
    db.insert("m", tags, {"good": 0.0, "total": 0.0}, now - 299)
    db.insert("m", tags, {"good": 8560.0, "total": 10000.0}, now - 1)
    ev = m.AlertEvaluator(db, rules=[rule])
    assert ev.evaluate_once(now=now) == []
    # one more bad request tips strictly past the threshold
    db.insert("m", tags, {"good": 8560.0, "total": 10001.0}, now)
    changed = ev.evaluate_once(now=now)
    assert [(a.rule, a.state) for a in changed] == [("edge", "firing")]


def test_alert_resolve_then_refire_cycles_cleanly(m):
    """Breach -> fire -> recover -> resolve -> breach again -> a FRESH
    firing alert (same structural key, new history entry).  The state
    machine must not wedge after a resolve, and for_s hysteresis must
    re-apply on the second cycle."""

    db = m.TSDB()
    ev = m.AlertEvaluator(db, rules=[m.AlertRule(
        name="cyc", measurement="m", metric_field="v", agg="last",
        op=">", threshold=10.0, window_s=120.0, for_s=5.0)])
    t0 = time.time()
    db.insert("m", {}, {"v": 50.0}, t0)
    assert ev.evaluate_once(now=t0 + 1) == []       # for_s gating
    changed = ev.evaluate_once(now=t0 + 7)
    assert [(a.rule, a.state) for a in changed] == [("cyc", "firing")]
    db.insert("m", {}, {"v": 1.0}, t0 + 10)
    changed = ev.evaluate_once(now=t0 + 11)
    assert [(a.rule, a.state) for a in changed] == [("cyc", "resolved")]
    # refire: hysteresis applies again (no instant flap on one sample)
    db.insert("m", {}, {"v": 60.0}, t0 + 20)
    assert ev.evaluate_once(now=t0 + 21) == []
    changed = ev.evaluate_once(now=t0 + 27)
    assert [(a.rule, a.state) for a in changed] == [("cyc", "firing")]
    assert [a.state for a in ev.history] == ["firing", "resolved",
                                             "firing"]


def test_recorder_push_buffers_through_outage(m, tmp_path, mock_provider_lib,
                                              limiter_lib):

    devices = m.DeviceController(m.Provider(fresh_library(mock_provider_lib)))
    devices.start()
    workers = m.WorkerController(devices, m.AllocationController(devices),
                               m.Limiter(fresh_library(limiter_lib)),
                               str(tmp_path / "shm"))
    entry = devices.devices()[0]
    workers.add_worker(m.WorkerSpec(
        namespace="m", name="w", isolation=m.constants.ISOLATION_SOFT,
        devices=[m.WorkerDeviceRequest(chip_id=entry.info.chip_id,
                                     duty_percent=50.0,
                                     hbm_bytes=2**30)]))
    shipped = []
    fail = {"on": True}

    def push(lines):
        if fail["on"]:
            raise OSError("operator unreachable")
        shipped.extend(lines)

    rec = m.HypervisorMetricsRecorder(devices, workers, node_name="n0",
                                    push=push)
    rec.record_once()          # push fails, lines buffer
    assert not shipped and len(rec._backlog) > 0
    first_batch = len(rec._backlog)
    rec.record_once()          # still failing, backlog grows
    assert len(rec._backlog) > first_batch
    fail["on"] = False
    rec.record_once()          # recovery ships the whole backlog
    assert len(rec._backlog) == 0
    assert len(shipped) >= 2 * first_batch
    assert any(line.startswith("tpf_chip") for line in shipped)
    # worker lines carry the generation tag the autoscaler converts with
    worker_lines = [ln for ln in shipped if ln.startswith("tpf_worker")]
    assert worker_lines and all("generation=v5e" in ln
                                for ln in worker_lines)
    workers.remove_worker("m/w")
    devices.stop()



# -- the port's own cases ------------------------------------------------------

PORT = PKGS["port"]


def _seeded_series(m, seed=5):
    """One seeded stream of duty points for three workers, some of them
    hot, read back through the TSDB, an alert evaluator and the percentile
    recommender at fixed evaluation times."""
    rng = np.random.default_rng(seed)
    # whole seconds, recent: the recommender's decay is anchored at now
    t0 = float(int(time.time()) - 200)
    db = m.TSDB()
    ev = m.AlertEvaluator(db, rules=[
        m.AlertRule(name="hot", measurement="tpf_worker",
                    metric_field="duty_cycle_pct", agg="p90", op=">",
                    threshold=60.0, window_s=30.0, for_s=4.0,
                    group_by=["worker"])])
    rec = m.PercentileRecommender()
    out = {"alerts": []}
    for step in range(120):
        now = t0 + step
        for w in ("w0", "w1", "w2"):
            hot = w == "w1" and 30 <= step < 70
            duty = float(rng.uniform(70, 95) if hot else rng.uniform(5, 40))
            db.insert("tpf_worker", {"worker": w, "namespace": "d"},
                      {"duty_cycle_pct": duty}, ts=now)
            rec.observe(f"d/{w}", tflops=duty / 100 * 989.0, hbm_bytes=2e9, ts=now)
        out["alerts"] += [(step, a.rule, a.state) for a in ev.evaluate_once(now=now)]
    out["aggs"] = [db.aggregate("tpf_worker", "duty_cycle_pct", tags={"worker": w},
                                agg=agg, window_s=1000.0)
                   for w in ("w0", "w1", "w2")
                   for agg in ("mean", "max", "min", "p50", "p90", "last", "count")]
    out["recommend"] = [rec.recommend(f"d/{w}", m.ResourceAmount(tflops=100.0)).target.tflops
                        for w in ("w0", "w1", "w2")]
    return out


def test_seeded_series_give_both_packages_the_same_answers():
    ref, port = _seeded_series(PKGS["ref"]), _seeded_series(PORT)
    assert [a[1:] for a in ref["alerts"]] == [("hot[w1]", "firing"), ("hot[w1]", "resolved")]
    assert port == ref


def _h100_operator():
    m = PORT
    op = m.Operator(enable_expander=False, enable_autoscaler=True)
    pool = m.TPUPool.new("pool-a")
    pool.spec.name = "pool-a"
    op.store.create(pool)
    op.start()
    chip = m.TPUChip.new("gpu-0")
    chip.status.phase = m.constants.PHASE_RUNNING
    chip.status.capacity = m.ResourceAmount(tflops=989.0, duty_percent=100,
                                            hbm_bytes=80 << 30)
    chip.status.pool = "pool-a"
    chip.status.generation = "h100-sxm"
    chip.status.vendor = m.constants.VENDOR_NVIDIA
    op.register_host("gpu-node", [chip])
    return op


def test_autoscaler_converts_an_h100_duty_at_the_h100_peak():
    """The port's chip table carries h100-sxm at 989 TFLOP/s: a 25% pod's
    20% duty series is read at that peak, not at the v5e's 197 default,
    by the dry-run recommendation the operator API serves."""
    from tensorfusion_tpu_torch.config.chip_info import chip_info

    peak = chip_info("h100-sxm").bf16_tflops
    op = _h100_operator()
    try:
        deadline = time.time() + 5
        while not op.allocator.chips() and time.time() < deadline:
            time.sleep(0.02)
        pod = PORT.Pod.new("tenant", namespace="default")
        pod.metadata.annotations.update({
            PORT.constants.ANN_POOL: "pool-a",
            PORT.constants.ANN_TFLOPS_REQUEST: str(0.25 * peak),
            PORT.constants.ANN_HBM_REQUEST: str(8 << 30),
            PORT.constants.ANN_IS_LOCAL_TPU: "true"})
        pod.spec.containers = [PORT.Container(name="main")]
        op.submit_pod(pod)
        assert op.wait_for_binding("tenant") is not None
        now = time.time()
        for i in range(40):
            op.tsdb.insert("tpf_worker", {"namespace": "default", "worker": "tenant"},
                           {"duty_cycle_pct": 20.0}, ts=now - 40 + i)
        got = op.observability("default/tenant")
        assert got["tsdb"] == {"series": 1, "points": 40, "workload_duty_points": 40}
        rec = got["autoscaler"]
        assert rec["peak_tflops"] == {"tenant": peak}
        assert rec["current_tflops"] == pytest.approx(0.25 * peak)
        # p90 of (20% x 989) x 1.15, to the histogram's bucket
        assert rec["target_tflops"] == pytest.approx(0.20 * peak * 1.15, rel=0.06)
        # a dry run: the allocation is as it was
        assert op.allocator.allocation("default/tenant").request.request.tflops \
            == pytest.approx(0.25 * peak)
        assert op.observability("default/nope")["autoscaler"] is None
    finally:
        op.stop()


def test_operator_api_serves_the_observability_view():
    """``/allocator-info?observability=`` adds the view; without the
    parameter the reply has the reference's keys only."""
    op = _h100_operator()
    server = PORT.OperatorServer(op)
    server.start()
    try:
        op.ingest_metrics_lines([PORT.encode_line(
            "tpf_worker", {"namespace": "d", "worker": "w"}, {"duty_cycle_pct": 5.0})])
        import urllib.request

        with urllib.request.urlopen(server.url + "/allocator-info") as r:
            assert sorted(json.loads(r.read())) == ["allocations", "chips"]
        with urllib.request.urlopen(server.url + "/allocator-info?observability=") as r:
            got = json.loads(r.read())["observability"]
        assert got == {"tsdb": {"series": 1, "points": 1},
                       "metrics_drain": {"seq": 0, "epoch": ""}, "autoscaler": None}
        with urllib.request.urlopen(server.url + "/allocator-info?observability=d/w") as r:
            got = json.loads(r.read())["observability"]
        assert got["tsdb"]["workload_duty_points"] == 1
    finally:
        server.stop()
        op.stop()


def test_alert_interval_comes_from_the_global_config(tmp_path):
    """The config's ``extra.alert_interval_s`` sets the evaluator's pass
    interval at boot and on a reload; a running loop starts over on it."""
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"extra": {"alert_interval_s": "0.2"}}))
    op = PORT.Operator(enable_expander=False, config_path=str(cfg), alert_rules=[])
    op.start()
    try:
        assert op.alerts.interval_s == 0.2
        first = op.alerts._thread
        assert first.is_alive()
        cfg.write_text(json.dumps({"extra": {"alert_interval_s": 3}}))
        future = time.time() + 5
        os.utime(cfg, (future, future))
        assert op.config_watcher.reload()
        assert op.alerts.interval_s == 3.0
        assert op.alerts._thread is not first and op.alerts._thread.is_alive()
        assert not first.is_alive()
    finally:
        op.stop()
    assert not op.alerts._thread.is_alive()
