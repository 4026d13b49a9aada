"""The port's node-agent TUI (tensorfusion_tpu_torch/hypervisor/tui.py)
against the reference's.

The reference's own TUI cases (tests/test_lifecycle_components.py's
renderers and navigation, the dispatch pane of test_tracing.py, the serving
pane of test_serving.py and the sharded profile pane of test_sharding.py;
the policy pane rides with tests/test_torch_policy.py) run here as one
parametrised test each, over both packages (``m``).  Beside them: every
renderer, the chart and each view of ``TuiState`` give both packages
identical strings on the same input dicts and the same segment directory,
and the port's ``snapshot`` and ``--once`` entry point read the port's
node agent (``HypervisorServer`` over the mock provider, with an API
token) and its segments.
"""

import importlib
import json
import os
import subprocess
import sys
import types
import urllib.request

import pytest

from conftest import REPO_ROOT

pytest.importorskip("torch")

_NAMES = {
    'AllocationController': ('hypervisor', 'AllocationController'),
    'DeviceController': ('hypervisor', 'DeviceController'),
    'DeviceQuota': ('hypervisor', 'DeviceQuota'),
    'FakeRunner': ('serving.runner', 'FakeRunner'),
    'HypervisorServer': ('hypervisor.server', 'HypervisorServer'),
    'Limiter': ('hypervisor', 'Limiter'),
    'Profiler': ('profiling.profiler', 'Profiler'),
    'Provider': ('hypervisor', 'Provider'),
    'RemoteVTPUWorker': ('remoting', 'RemoteVTPUWorker'),
    'ServingEngine': ('serving.engine', 'ServingEngine'),
    'SimClock': ('sim', 'SimClock'),
    'WorkerController': ('hypervisor', 'WorkerController'),
    'WorkerDeviceRequest': ('hypervisor', 'WorkerDeviceRequest'),
    'WorkerSpec': ('hypervisor', 'WorkerSpec'),
    'fresh_library': ('testing', 'fresh_library'),
    'tui': ('hypervisor', 'tui'),
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
REF, PORT = PKGS["ref"], PKGS["port"]


@pytest.fixture(params=sorted(PKGS))
def m(request):
    return PKGS[request.param]


def _worker(m, **kw):
    """A remoting worker of ``m`` on the CPU (the port's default is the card)."""
    return m.RemoteVTPUWorker(**kw) if m is REF else m.RemoteVTPUWorker(device="cpu", **kw)


# -- the reference's cases ------------------------------------------------------

def test_tui_renderers(m, tmp_path, limiter_lib):
    devices = [{"info": {"chip_id": "v5e-c0", "generation": "v5e"},
                "metrics": {"duty_cycle_pct": 62.5,
                            "hbm_used_bytes": 8 * 2**30,
                            "power_watts": 180.0, "temp_celsius": 55.0},
                "partitions": []}]
    out = m.tui.render_devices(devices)
    assert "v5e-c0" in out and "62.5%" in out and "8.0GiB" in out

    workers = [{"spec": {"namespace": "ml", "name": "w0",
                         "isolation": "soft", "qos": "high"},
                "status": {"duty_cycle_pct": 41.0,
                           "hbm_used_bytes": 2**30, "pids": [1, 2],
                           "frozen": False}}]
    out = m.tui.render_workers(workers)
    assert "ml/w0" in out and "41.0%" in out and "no" in out

    # shm inspector against a real segment
    host = m.Limiter(m.fresh_library(limiter_lib, "tui"))
    base = str(tmp_path / "shm")
    host.init(base)
    host.create_worker("ns", "w", [m.DeviceQuota(0, "chipX", 2500, 2**30, 1000, 500)])
    out = m.tui.render_shm(base)
    assert "ns/w" in out and "chipX" in out and "25.0%" in out

    # unreachable hypervisor: snapshot degrades gracefully
    out = m.tui.snapshot("http://127.0.0.1:1", base)
    assert "unreachable" in out and "ns/w" in out


def _dev(chip, duty, partitions=()):
    return {"info": {"chip_id": chip, "generation": "v5e",
                     "hbm_bytes": 16 * 2**30, "core_count": 1,
                     "peak_bf16_tflops": 197},
            "metrics": {"duty_cycle_pct": duty, "hbm_used_bytes": 4 * 2**30,
                        "power_watts": 100.0, "temp_celsius": 50.0},
            "partitions": list(partitions)}


def _wkr(name, duty, chip):
    # /api/v1/workers' form: WorkerSpec.devices as WorkerDeviceRequest
    # dicts, partitions as id strings
    return {"spec": {"namespace": "ml", "name": name, "isolation": "soft",
                     "qos": "high",
                     "devices": [{"chip_id": chip, "duty_percent": 50.0,
                                  "tflops": 10.0, "hbm_bytes": 2**30}]},
            "status": {"duty_cycle_pct": duty, "hbm_used_bytes": 2**20,
                       "pids": [7], "frozen": False, "chip_ids": [chip]}}


def test_tui_charts_and_navigation(m):
    t = m.tui
    chart = t.TimeSeriesChart("duty", unit="%", max_points=4)
    assert "(no data)" in chart.render()
    for v in (10, 50, 90, 120, 30):     # 120 forces auto-scale re-max
        chart.add(v)
    assert len(chart.data) == 4         # ring buffer dropped the oldest
    out = chart.render()
    assert "cur=30.0%" in out and "max=120.0%" in out
    assert "132.0" in out               # 120 * 1.1 headroom on the y-axis

    st = t.TuiState()
    for tick in range(3):               # history accumulates across ticks
        st.update([_dev("c0", 10.0 * tick, ["p0"]), _dev("c1", 5.0)],
                  [_wkr("w0", 2.0 * tick, "c0"), _wkr("w1", 1.0, "c1")])
    assert st.device_history["c0"].charts["duty"].data == [0.0, 10.0, 20.0]

    assert st.view == t.VIEW_DEVICES
    st.key("j")
    assert st.sel_device == 1
    st.key("j")                         # clamped at the end of the list
    assert st.sel_device == 1
    st.key("enter")
    assert st.view == t.VIEW_DEVICE_DETAIL
    out = st.render()
    assert "== device c1 ==" in out and "p0" not in out
    assert "cores=1" in out
    assert "ml/w1" in out and "duty" in out
    st.key("esc")
    assert st.view == t.VIEW_DEVICES

    st.key("w")
    assert st.view == t.VIEW_WORKERS
    st.key("enter")
    assert st.view == t.VIEW_WORKER_DETAIL
    out = st.render()
    assert "== worker ml/w0 ==" in out and "duty<=50.0%" in out
    assert "chips: c0" in out
    st.key("esc")

    st.key("m")
    assert st.view == t.VIEW_METRICS
    out = st.render()
    assert "devices: 2" in out and "workers: 2" in out and "high=2" in out
    assert t.render_metrics([], []).startswith("== cluster metrics ==")

    assert st.key("x") is True
    assert st.key("q") is False


class _FakeRemoteWorker:
    class _D:
        @staticmethod
        def snapshot():
            return {"mode": "wfq", "depth": 1, "executed": 9,
                    "launches": 7, "busy_rejected": 0,
                    "deadline_exceeded": 0, "last_trace_id": "t9",
                    "queue_wait": {"p50_ms": 1.0, "p99_ms": 3.0},
                    "service": {"p50_ms": 2.0, "p99_ms": 4.0},
                    "tenants": {"cn1:": {
                        "qos": "high", "weight": 4.0, "queued": 0,
                        "completed": 9, "slo_good": 8, "slo_total": 9,
                        "slo_ms": 200.0, "last_trace_id": "t9",
                        "queue_wait": {"p50_ms": 1.0, "p99_ms": 3.0}}}}

    dispatcher = _D()


def test_hypervisor_dispatch_endpoint_and_tui_pane(m):
    server = m.HypervisorServer(devices=None, workers=None, port=0,
                                remote_workers=[_FakeRemoteWorker()])
    server.start()
    try:
        with urllib.request.urlopen(f"{server.url}/api/v1/dispatch", timeout=5) as r:
            snaps = json.loads(r.read())
        assert len(snaps) == 1 and snaps[0]["last_trace_id"] == "t9"
    finally:
        server.stop()
    pane = m.tui.render_dispatch(snaps)
    assert "cn1:" in pane and "t9" in pane and "88.9%" in pane
    state = m.tui.TuiState()
    state.update_dispatch(snaps)
    assert state.key("r") is True
    assert "last trace: t9" in state.render()
    assert "[r]emote-dispatch" in state.header()
    assert m.tui.render_dispatch([]).startswith("(no remote-vTPU workers")


def _collect():
    done = {}

    def emit(seq, toks, d, info):
        if d:
            done[seq.sid] = (list(seq.tokens), dict(info))
    return done, emit


def test_serving_api_endpoint_and_tui_pane(m):
    eng = m.ServingEngine(m.FakeRunner(), max_batch=2, name="api-eng")
    done, emit = _collect()
    eng.submit([1, 2, 3], 4, tenant="al", emit=emit)
    for _ in range(2000):
        if done:
            break
        eng.step()
    rw = _worker(m, engine=eng)
    srv = m.HypervisorServer(devices=None, workers=None, remote_workers=[rw])
    srv.start()
    try:
        with urllib.request.urlopen(f"{srv.url}/api/v1/serving", timeout=5) as r:
            snaps = json.loads(r.read())
        assert len(snaps) == 1 and snaps[0]["name"] == "api-eng"
        assert "kv_ship" in snaps[0] and "spec" in snaps[0]
        pane = m.tui.render_serving(snaps)
        assert "api-eng" in pane and "kv:" in pane
    finally:
        srv.stop()


def test_tui_profile_pane_shows_shard(m):
    p = m.Profiler(name="control-plane-s3", shard="3")
    p.attribute("tenant", "compute", 0.1)
    out = m.tui.render_profile([p.snapshot()])
    assert "shard=3" in out


# -- identical strings on the same inputs ----------------------------------------

def _profile_snapshots():
    """Two profilers' snapshots under a virtual clock (one sharded)."""
    clk = REF.SimClock()
    out = []
    for name, shard in (("worker", ""), ("control-plane-s1", "1")):
        p = REF.Profiler(name=name, clock=clk, bin_s=1.0, shard=shard)
        for i, (tenant, kind) in enumerate((("cn1:", "compute"), ("cn2:", "transfer"),
                                            ("cn1:", "queue"))):
            p.attribute(tenant, kind, 0.05 * (i + 1), qos="high")
            clk.advance(0.7)
        out.append(p.snapshot())
    return out


_SERVING = [{
    "name": "eng-a", "tokens_per_s": 1234.5, "active": 3, "waiting": 2,
    "batch_occupancy_pct": 75.0, "ttft": {"p50_ms": 12.5, "p99_ms": 80.25},
    "kv": {"used": 40, "usable": 64, "utilization_pct": 62.5, "shared_blocks": 5,
           "logical_blocks": 48, "cow_copies_total": 2, "prefix_hit_tokens_total": 96,
           "evicted_total": 1},
    "spec": {"k": 3, "accept_rate": 0.7, "accepted": 21, "proposed": 30, "steps": 10},
    "kv_ship": {"ships": 2, "blocks": 12, "dedup_blocks": 3, "bytes": 3 * 2**20},
    "tenants": {"bob": {"qos": "high", "tokens": 200, "ttft": {"p50_ms": 10.0,
                                                               "p99_ms": 40.0},
                        "slo_good": 9, "slo_total": 10, "prefix_hit_tokens": 48,
                        "spec_proposed": 12, "spec_accept_rate": 0.75},
                "al": {"qos": "", "tokens": 5, "ttft": {}, "slo_total": 0}}}]

_POLICY = [{
    "node": "operator", "counters": {"decisions_total": 3, "actuations_total": 2,
                                     "actuation_failures_total": 1, "resolved_total": 1,
                                     "pending": 1, "suppressed_total": 4},
    "per_rule": {"scale-on-burn": {"action": "scale_pool", "fired": 2, "actuated": 2,
                                   "failed": 0, "resolved": 1, "last_value": 18.0},
                 "migrate-on-skew": {"action": "migrate_tenant", "fired": 1,
                                     "actuated": 0, "failed": 1, "resolved": 0,
                                     "last_value": 0.42}},
    "ledger": {"decisions": [
        {"id": i, "t": 10.0 * i, "rule": rule, "trigger": trigger,
         "evidence": {"exemplars": ["tr-%d" % i, "tr-x"]},
         "outcome": {"state": state}, "actuation": {"ok": ok}}
        for i, (rule, trigger, state, ok) in enumerate((
            ("scale-on-burn", "alert pods-pending (18.000 > 0.000)", "resolved", True),
            ("scale-on-burn", "alert pods-pending", "pending", True),
            ("migrate-on-skew", "alert tenant-skew cn3:", "failed", False)))]}}]


def _state_renders(t):
    """Every view of a TuiState fed the same snapshots, keyed in order."""
    st = t.TuiState()
    for tick in range(3):
        st.update([_dev("c0", 10.0 * tick, ["p0"]), _dev("c1", 5.0)],
                  [_wkr("w0", 2.0 * tick, "c0"), _wkr("w1", 1.0, "c1")])
    st.update_dispatch([_FakeRemoteWorker.dispatcher.snapshot()])
    st.update_profile(_profile_snapshots())
    st.update_serving(_SERVING)
    st.update_policy(_POLICY)
    out = []
    for key in ("d", "j", "enter", "esc", "w", "enter", "esc", "m", "r", "p", "v", "o"):
        st.key(key)
        out.append((key, st.view, st.render()))
    return out


def _chart(t):
    chart = t.TimeSeriesChart("hbm", unit="GiB", max_points=8, max_value=1.0)
    for v in (0.1, 0.5, 2.5, 0.25, 1.0):
        chart.add(v)
    return chart.render()


RENDERS = {
    "devices": lambda t: t.render_devices([_dev("c0", 62.5, ["p0"]), _dev("c1", 0.0)], 1),
    "workers": lambda t: t.render_workers([_wkr("w0", 41.0, "c0"), _wkr("w1", 0.0, "c1")],
                                          0),
    "metrics": lambda t: t.render_metrics([_dev("c0", 62.5), _dev("c1", 5.0)],
                                          [_wkr("w0", 41.0, "c0")]),
    "device_detail": lambda t: t.render_device_detail(_dev("c0", 62.5, ["p0"]), None,
                                                      [_wkr("w0", 41.0, "c0")]),
    "worker_detail": lambda t: t.render_worker_detail(_wkr("w0", 41.0, "c0"), None),
    "dispatch": lambda t: t.render_dispatch([_FakeRemoteWorker.dispatcher.snapshot()]),
    "serving": lambda t: t.render_serving(_SERVING),
    "profile": lambda t: t.render_profile(_profile_snapshots()),
    "policy": lambda t: t.render_policy(_POLICY),
    "empty": lambda t: [f([]) for f in (t.render_dispatch, t.render_serving,
                                        t.render_profile, t.render_policy)],
    "chart": _chart,
    "views": _state_renders,
}


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_renderers_give_the_references_strings(name):
    assert RENDERS[name](PORT.tui) == RENDERS[name](REF.tui)


def test_shm_inspector_gives_the_references_strings(tmp_path, limiter_lib):
    host = PORT.Limiter(PORT.fresh_library(limiter_lib, "tui-eq"))
    base = str(tmp_path / "shm")
    host.init(base)
    host.create_worker("ns", "lo", [PORT.DeviceQuota(0, "GPU-0", 2500, 2**30, 1000, 500)])
    host.create_worker("ns", "hi", [PORT.DeviceQuota(0, "GPU-0", 7500, 2**31, 3000, 1500)])
    for sel in (-1, 0, 1):
        assert PORT.tui.render_shm(base, sel) == REF.tui.render_shm(base, sel)
    frame = PORT.tui.render_shm(base)
    assert "25.0%" in frame and "75.0%" in frame
    unreachable = "http://127.0.0.1:1"
    assert PORT.tui.snapshot(unreachable, base) == REF.tui.snapshot(unreachable, base)


# -- the port's snapshot of the port's node agent ----------------------------------

@pytest.fixture()
def agent(tmp_path, mock_provider_lib, limiter_lib, monkeypatch):
    """The port's node agent over the mock provider: two soft workers on one
    chip, its API behind a token."""
    for k in list(os.environ):
        if k.startswith("TPF_MOCK_"):
            monkeypatch.delenv(k)
    provider = PORT.Provider(PORT.fresh_library(mock_provider_lib, "tui-agent"))
    devices = PORT.DeviceController(provider)
    devices.start()
    workers = PORT.WorkerController(
        devices, PORT.AllocationController(devices),
        PORT.Limiter(PORT.fresh_library(limiter_lib, "tui-agent")),
        str(tmp_path / "shm"))
    chip = devices.devices()[0].info.chip_id
    for name, duty, qos in (("lo", 25.0, "low"), ("hi", 75.0, "high")):
        workers.add_worker(PORT.WorkerSpec(
            namespace="default", name=name, isolation="soft", qos=qos,
            devices=[PORT.WorkerDeviceRequest(chip_id=chip, duty_percent=duty,
                                              hbm_bytes=1 << 30)]))
    workers.freeze_worker("default/hi")
    server = PORT.HypervisorServer(devices, workers, port=0, token="tui-secret",
                                   remote_workers=[_FakeRemoteWorker()])
    server.start()
    try:
        yield types.SimpleNamespace(url=server.url, chip=chip, shm=str(tmp_path / "shm"))
    finally:
        server.stop()
        for w in workers.list():
            workers.remove_worker(w.spec.key)
        devices.stop()


def _check_frame(frame, agent):
    assert "unreachable" not in frame
    rows = frame.splitlines()
    assert any(agent.chip in r and "v5e" in r for r in rows)
    workers = {r.split()[0]: r for r in rows if r.startswith("  default/")}
    assert workers["default/hi"].rstrip().endswith("yes")
    assert workers["default/lo"].rstrip().endswith("no")
    shm = frame[frame.index("-- shm inspector --"):]
    assert "segment default/hi  [FROZEN]" in shm and "segment default/lo  [active]" in shm
    assert "duty= 25.0%" in shm and "duty= 75.0%" in shm
    assert "cn1:" in frame and "t9" in frame          # the dispatch pane


def test_snapshot_reads_the_port_node_agent(agent, monkeypatch):
    monkeypatch.setenv("TPF_HYPERVISOR_TOKEN", "tui-secret")
    _check_frame(PORT.tui.snapshot(agent.url, agent.shm), agent)
    monkeypatch.delenv("TPF_HYPERVISOR_TOKEN")
    assert "unreachable" in PORT.tui.snapshot(agent.url, agent.shm)   # no token


def test_tui_once_prints_the_port_node_agents_frame(agent):
    r = subprocess.run(
        [sys.executable, "-m", "tensorfusion_tpu_torch.hypervisor.tui", "--once",
         "--url", agent.url, "--shm-base", agent.shm],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=60,
        env={**os.environ, "TPF_HYPERVISOR_TOKEN": "tui-secret"})
    assert r.returncode == 0, r.stderr[-2000:]
    _check_frame(r.stdout, agent)
    assert "jax" not in r.stderr
