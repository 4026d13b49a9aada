"""The port's node agent (tensorfusion_tpu_torch.hypervisor) against the
reference's (tensorfusion_tpu.hypervisor), both over the reference's mock
provider and the limiter: provider reads, discovery, the ERL controller,
allocation, the worker tick's segment contents, auto-freeze and orphan
cleanup, the HTTP API, the single-node backend and the daemon.
"""

import dataclasses
import importlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import tensorfusion_tpu.hypervisor as ref
import tensorfusion_tpu_torch.hypervisor as port
from tensorfusion_tpu import constants as ref_constants
from tensorfusion_tpu.api.types import AutoFreezeRule as RefAutoFreezeRule
from tensorfusion_tpu.api.types import ERLParameters as RefERLParameters
from tensorfusion_tpu.testing import MockProviderControl, fresh_library
from tensorfusion_tpu_torch import constants
from tensorfusion_tpu_torch.hypervisor import _build
from tensorfusion_tpu_torch.hypervisor.erl import AutoFreezeRule, ERLParameters
from tensorfusion_tpu_torch.hypervisor.mounts import DeviceMountPolicy, DeviceMountRule
from tensorfusion_tpu_torch.hypervisor.provider_binding import ChipMetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5P = {"TPF_MOCK_GEN": "v5p", "TPF_MOCK_CHIPS": "4", "TPF_MOCK_MESH": "2x2"}
MOCKS = {"v5e-8": {}, "v5p-4": V5P}
SIDES = (("ref", ref), ("port", port))


class ManualClock:
    """One clock for both worker controllers: same dt, same stamps."""

    def __init__(self):
        self.t = 1000.0

    def now(self):
        return self.t

    def now_ns(self):
        return int(self.t * 1e9)

    def monotonic(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


def _asdict(x):
    if isinstance(x, list):
        return [_asdict(v) for v in x]
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def _mock_env(monkeypatch, name):
    for k in list(os.environ):
        if k.startswith("TPF_MOCK_"):
            monkeypatch.delenv(k)
    for k, v in MOCKS[name].items():
        monkeypatch.setenv(k, v)


def _providers(mock_provider_lib, tag):
    return {side: pkg.Provider(fresh_library(mock_provider_lib, f"{tag}{side}"))
            for side, pkg in SIDES}


def _reference_mount_policy():
    """The reference's default mount rules in the port's types: with it
    the two allocators mount the same paths."""
    return DeviceMountPolicy([
        DeviceMountRule(expression="not partitioned",
                        host_paths=["/dev/accel{host_index}"]),
        DeviceMountRule(expression="partitioned",
                        host_paths=["{grant_device_nodes}"], partitioned_only=True)])


class Stack:
    def __init__(self, pkg, provider, limiter_lib, shm, clock, tag, **worker_kw):
        self.provider = provider
        self.devices = pkg.DeviceController(provider)
        self.devices.start()
        self.limiter = pkg.Limiter(fresh_library(limiter_lib, tag))
        policy = {"mount_policy": _reference_mount_policy()} if pkg is port else {}
        self.alloc = pkg.AllocationController(self.devices, **policy)
        self.workers = pkg.WorkerController(self.devices, self.alloc, self.limiter,
                                            shm, clock=clock, **worker_kw)
        self.shm = shm


@pytest.fixture()
def clock():
    return ManualClock()


@pytest.fixture()
def stacks(mock_provider_lib, limiter_lib, tmp_path, clock, monkeypatch):
    _mock_env(monkeypatch, "v5e-8")
    provs = _providers(mock_provider_lib, "stk")
    out = {side: Stack(pkg, provs[side], limiter_lib, str(tmp_path / side / "shm"),
                       clock, f"stk{side}")
           for side, pkg in SIDES}
    yield out
    for s in out.values():
        for w in s.workers.list():
            s.workers.remove_worker(w.spec.key)
        s.devices.stop()


def _spec(pkg, name, chip, duty=50.0, isolation="soft", qos="medium", hbm=1 << 30,
          template=""):
    return pkg.WorkerSpec(namespace="ns", name=name, isolation=isolation, qos=qos,
                          devices=[pkg.WorkerDeviceRequest(
                              chip_id=chip, duty_percent=duty, hbm_bytes=hbm,
                              partition_template=template)])


def _port_env(ref_env):
    """The reference's worker env as the port spells it."""
    env = dict(ref_env)
    if ref_constants.ENV_VISIBLE_CHIPS in env:
        env[constants.ENV_VISIBLE_DEVICES] = env.pop(ref_constants.ENV_VISIBLE_CHIPS)
        env[constants.ENV_DEVICE_ORDER] = constants.DEVICE_ORDER_PCI
    return env


HOOK_ENV = (constants.ENV_LD_PRELOAD, constants.ENV_DEVICE_INDEX,
            constants.ENV_PEAK_MFLOPS, constants.ENV_LIVE_HBM_INTERVAL)


def _without_hook_env(port_env):
    """A port worker's env without what preloads the launch and memory
    hook, which the reference's env has no counterpart of here (it points
    PJRT at its proxy only where a vendor plugin is configured); a soft
    worker's must preload the built hook."""
    env = dict(port_env)
    if constants.ENV_SHM_PATH in env:
        assert env[constants.ENV_LD_PRELOAD].split(":")[0] == str(_build.cuda_hook_path())
        assert float(env[constants.ENV_PEAK_MFLOPS]) > 0
        assert env[constants.ENV_LIVE_HBM_INTERVAL] == "10"
    return {k: v for k, v in env.items() if k not in HOOK_ENV}


# -- provider and discovery ----------------------------------------------------


@pytest.mark.parametrize("mock", sorted(MOCKS))
def test_provider_reads_equal(mock_provider_lib, monkeypatch, mock):
    _mock_env(monkeypatch, mock)
    provs = _providers(mock_provider_lib, f"prov{mock}")
    seen = {}
    for side, p in provs.items():
        p.init()
        chips = p.enumerate()
        chip = chips[0].chip_id
        templates = p.partition_templates(chip)
        grant = p.partition_create(templates[0].template_id, chip)
        p.partition_destroy(grant.partition_id, chip)
        seen[side] = {"abi": p.abi_version(), "count": p.chip_count(),
                      "chips": _asdict(chips), "topology": _asdict(p.topology()),
                      "templates": _asdict(templates), "grant": _asdict(grant),
                      "metrics": _asdict(p.chip_metrics([c.chip_id for c in chips])),
                      "procs": _asdict(p.proc_stats()), "mounts": p.mounts()}
        with pytest.raises(side == "ref" and ref.ProviderError or port.ProviderError) as e:
            p.partition_destroy(grant.partition_id, chip)
        seen[side]["second_destroy"] = e.value.status
        p.shutdown()
    assert seen["port"] == seen["ref"]


@pytest.mark.parametrize("mock", sorted(MOCKS))
def test_discovery_and_node_info_equal(mock_provider_lib, monkeypatch, mock):
    _mock_env(monkeypatch, mock)
    provs = _providers(mock_provider_lib, f"disc{mock}")
    seen = {}
    for side, pkg in SIDES:
        ctrl = pkg.DeviceController(provs[side])
        ctrl.start()
        try:
            ctrl.refresh_metrics()
            seen[side] = {"node": _asdict(ctrl.node_info()),
                          "topology": _asdict(ctrl.topology()),
                          "devices": [{"info": _asdict(e.info), "metrics": _asdict(e.metrics),
                                       "partitions": list(e.partitions)}
                                      for e in ctrl.devices()]}
        finally:
            ctrl.stop()
    assert seen["port"] == seen["ref"]
    assert seen["port"]["node"]["chip_count"] == (4 if mock == "v5p-4" else 8)


def test_shm_layout_matches_the_limiter(limiter_lib):
    """The port's ShmView mirror against the limiter's own layout."""
    import struct

    from tensorfusion_tpu_torch.hypervisor import limiter_binding as lb

    layout = port.Limiter(fresh_library(limiter_lib, "layout")).layout()
    assert layout["segment_bytes"] == lb.SEGMENT_BYTES
    assert layout["header_bytes"] == lb.HEADER_BYTES
    assert layout["device_bytes"] == lb.DEVICE_BYTES
    assert layout["max_devices"] == lb.MAX_DEVICES
    assert layout["max_pids"] == lb.MAX_PIDS
    assert layout["header"]["pids"] == lb._HEADER_PIDS_OFF
    assert struct.calcsize(lb._HEADER_FMT) == layout["header"]["pid_count"] + 8
    assert struct.calcsize(lb._DEVICE_FMT) == layout["device"]["hbm_denied_events"] + 8


# -- the ERL controller ----------------------------------------------------------

QOS = ("low", "medium", "high", "critical")

#: name -> (workers as (chip, quota bp, qos), ERL parameters or None)
ERL_CASES = {
    "two_chips_mixed_qos": ([("c0", 2500, "low"), ("c0", 7500, "high"),
                             ("c1", 3000, "medium"), ("c1", 3000, "critical"),
                             ("c1", 1000, "low")], None),
    "oversubscribed": ([("c0", 6000, "high"), ("c0", 5000, "medium"),
                        ("c0", 4000, "low")], None),
    "every_qos_custom_params": ([("c0", 2000, q) for q in QOS],
                                dict(kp=0.6, ki=0.2, kd=0.05, integral_decay=0.9,
                                     slew_max_step_percent=15.0,
                                     burst_window_seconds=1.0,
                                     min_refill_fraction=0.1, max_burst_multiple=2.0)),
    "one_worker": ([("c0", 10000, "medium")], None),
}


@pytest.mark.parametrize("case", sorted(ERL_CASES))
def test_erl_updates_identical(case):
    """200 steps of seeded random observations (measured duty, blocked
    deltas, dt) give identical QuotaUpdate lists."""
    workers, params = ERL_CASES[case]
    rng = np.random.default_rng(sorted(ERL_CASES).index(case))
    ctl = {"ref": ref.ERLQuotaController(RefERLParameters(**params) if params else None),
           "port": port.ERLQuotaController(ERLParameters(**params) if params else None)}
    peak = 989e6
    for step in range(200):
        duty = rng.uniform(0, 100, len(workers))
        duty[rng.random(len(workers)) < 0.3] = 0.0
        blocked = rng.integers(0, 4, len(workers)) * (rng.random(len(workers)) < 0.4)
        dt = float(rng.uniform(0.05, 0.2))
        got = {}
        for side, pkg in SIDES:
            obs = [pkg.Observation(f"ns/w{i}", 0, chip, bp, peak, float(duty[i]),
                                   int(blocked[i]), qos=qos)
                   for i, (chip, bp, qos) in enumerate(workers)]
            got[side] = _asdict(ctl[side].step(obs, dt))
        assert got["port"] == got["ref"], f"step {step}"
    for i in range(len(workers)):
        assert ctl["port"].share(f"ns/w{i}", 0) == ctl["ref"].share(f"ns/w{i}", 0)
    ctl["port"].forget("ns/w0")
    assert ctl["port"].share("ns/w0", 0) is None


def test_erl_keeps_a_quarter_share_above_one_forward_charge():
    """The chip smoke's two tenants (25% low, 75% high, on an H100's 989e6
    MFLOP/s): whatever measured duty and blocked deltas arrive, the ERL
    never pushes ``lo``'s bucket capacity below one Llama-3-8B forward on
    4 x 1024 tokens (62.6e6 MFLOP charged), which would leave the tenant
    blocked for good."""
    peak, one_call = 989e6, 62_577_673
    rng = np.random.default_rng(7)
    erl = port.ERLQuotaController()
    lowest = float("inf")
    for _ in range(3000):
        obs = [port.Observation("default/lo", 0, "gpu", 2500, peak,
                                float(rng.choice([0.0, rng.uniform(0, 100)])),
                                int(rng.integers(0, 3)), qos="low"),
               port.Observation("default/hi", 0, "gpu", 7500, peak,
                                float(rng.choice([0.0, rng.uniform(0, 100)])),
                                int(rng.integers(0, 3)), qos="high")]
        for up in erl.step(obs, float(rng.uniform(0.05, 0.3))):
            if up.worker_key == "default/lo":
                lowest = min(lowest, up.capacity_mflop)
    assert lowest > 3 * one_call


# -- allocation ----------------------------------------------------------------


@pytest.mark.parametrize("isolation", ["soft", "hard", "partitioned"])
def test_allocation_bindings_and_env_equal(mock_provider_lib, monkeypatch, isolation):
    _mock_env(monkeypatch, "v5p-4")
    provs = _providers(mock_provider_lib, f"alloc{isolation}")
    seen = {}
    for side, pkg in SIDES:
        devices = pkg.DeviceController(provs[side])
        devices.start()
        try:
            policy = {"mount_policy": _reference_mount_policy()} if pkg is port else {}
            alloc = pkg.AllocationController(devices, **policy)
            chips = [e.info.chip_id for e in devices.devices()]
            template = "v5p-1c" if isolation == "partitioned" else ""
            a = alloc.allocate(pkg.WorkerSpec(
                namespace="ns", name="w", isolation=isolation,
                devices=[pkg.WorkerDeviceRequest(chip_id=chips[1], duty_percent=30,
                                                 hbm_bytes=2 << 30,
                                                 partition_template=template),
                         pkg.WorkerDeviceRequest(duty_percent=40, hbm_bytes=200 << 30,
                                                 partition_template=template)]))
            ctl = MockProviderControl(provs[side])
            env = a.env
            if pkg is ref and isolation == "partitioned":
                # the mock's grants carry TPU_VISIBLE_CHIPS themselves: the
                # port adds CUDA's index list and order beside them
                env.update({constants.ENV_VISIBLE_DEVICES: "1,0",
                            constants.ENV_DEVICE_ORDER: constants.DEVICE_ORDER_PCI})
            elif pkg is ref:
                env = _port_env(env)
            seen[side] = {"bindings": _asdict(a.bindings), "mounts": a.mounts, "env": env,
                          "limits": (ctl.hbm_hard_limit(chips[1]),
                                     ctl.duty_hard_limit(chips[1])),
                          "partitions": ctl.partition_count(chips[1])}
            alloc.release("ns/w")
            seen[side]["after_release"] = (ctl.hbm_hard_limit(chips[1]),
                                           ctl.duty_hard_limit(chips[1]),
                                           ctl.partition_count(chips[1]))
        finally:
            devices.stop()
    assert seen["port"] == seen["ref"]
    env = seen["port"]["env"]
    assert env[constants.ENV_DEVICE_ORDER] == "PCI_BUS_ID"
    assert env[constants.ENV_VISIBLE_DEVICES] == "1,0"
    assert ("TPU_VISIBLE_CHIPS" in env) == (isolation == "partitioned")


def test_allocation_rollback_equal(mock_provider_lib, monkeypatch):
    """A worker whose second partition cannot be split rolls back its
    first, on both sides alike."""
    _mock_env(monkeypatch, "v5p-4")
    provs = _providers(mock_provider_lib, "rollback")
    seen = {}
    for side, pkg in SIDES:
        devices = pkg.DeviceController(provs[side])
        devices.start()
        try:
            ctl = MockProviderControl(provs[side])
            chip = devices.devices()[0].info.chip_id
            alloc = pkg.AllocationController(devices)
            alloc.allocate(_spec(pkg, "p1", chip, isolation="partitioned",
                                 template="v5p-1c"))
            bad = pkg.WorkerSpec(namespace="ns", name="p2", isolation="partitioned",
                                 devices=[pkg.WorkerDeviceRequest(
                                     chip_id=chip, partition_template=t, hbm_bytes=1)
                                     for t in ("v5p-1c", "v5p-2c")])
            with pytest.raises(Exception) as e:
                alloc.allocate(bad)
            seen[side] = {"error": type(e.value).__name__, "status": e.value.status,
                          "after": ctl.partition_count(chip),
                          "allocated": sorted(a.spec.key for a in alloc.list())}
            alloc.release("ns/p1")
            seen[side]["released"] = ctl.partition_count(chip)
        finally:
            devices.stop()
    assert seen["port"] == seen["ref"]
    assert seen["port"]["after"] == 1 and seen["port"]["released"] == 0


def test_default_mount_rules_name_the_nvidia_nodes():
    policy = DeviceMountPolicy(DeviceMountPolicy.default_rules())
    b = port.allocation.DeviceBinding(chip_id="c", device_index=0, duty_percent=50,
                                      hbm_bytes=1, host_index=3)
    soft = port.WorkerSpec(name="w", isolation="soft")
    assert policy.mounts_for(soft, [b]) == ["/dev/nvidia3", "/dev/nvidiactl",
                                            "/dev/nvidia-uvm"]
    b.host_index = -1
    assert policy.mounts_for(soft, [b]) == ["/dev/nvidiactl", "/dev/nvidia-uvm"]


@pytest.mark.parametrize("expr", [
    "().__class__.__mro__[1].__subclasses__()", "qos.__class__", "(lambda: 1)()",
    "10**10**10", "[x for x in (1,)]", "__import__('os')", "chip_count + 1 > 2"])
def test_mount_rules_refuse_general_python(expr):
    ctx = {"partitioned": False, "qos": "high", "chip_count": 2, "isolation": "soft"}
    assert DeviceMountPolicy._eval(expr, ctx) is False
    assert DeviceMountPolicy._eval("qos in ('high', 'critical') and 1 < chip_count <= 2",
                                   ctx)


# -- the worker controller's tick ------------------------------------------------


def _segments(stack):
    """Every worker's segment, without what the limiter's own clock sets:
    the refill stamp, and the tokens a charge's refill credits by it."""
    out = {}
    for w in stack.workers.list():
        state = dataclasses.asdict(w.view.read())
        for d in state["devices"]:
            d.pop("last_refill_us")
            d.pop("tokens_mflop")
        out[w.spec.key] = state
    return out


def test_worker_tick_leaves_equal_segments(stacks, clock):
    """Two soft workers on one chip and one on another, processes injected
    through the mock, a client face charging more than the bucket holds
    (blocked events drive the ERL's hunger): after each of 20 ticks under
    one manual clock the segments are equal."""
    rng = np.random.default_rng(3)
    clients = {}
    for side, pkg in SIDES:
        s = stacks[side]
        chips = [e.info.chip_id for e in s.devices.devices()]
        for name, chip, duty, qos in (("a", chips[0], 25.0, "low"),
                                      ("b", chips[0], 75.0, "high"),
                                      ("c", chips[1], 40.0, "medium")):
            s.workers.add_worker(_spec(pkg, name, chip, duty=duty, qos=qos))
        client = pkg.Limiter(fresh_library(s.limiter.lib_path, f"client{side}"))
        client.attach(s.workers.get("ns/a").shm_path)
        clients[side] = client
        for pid, name in ((101, "a"), (102, "b"), (103, "c")):
            s.workers.register_pid(f"ns/{name}", pid)
    for tick in range(20):
        duties = rng.uniform(0, 60, 3)
        hbm = rng.integers(0, 4 << 30, 3)
        blocked = int(rng.integers(0, 3))
        for side, pkg in SIDES:
            s = stacks[side]
            ctl = MockProviderControl(s.provider)
            chips = [e.info.chip_id for e in s.devices.devices()]
            for pid, chip, d, h in zip((101, 102, 103), (chips[0], chips[0], chips[1]),
                                       duties, hbm):
                ctl.proc_set(pid, chip, float(d), int(h))
            for _ in range(blocked):
                assert not clients[side].charge_compute(0, 10**15).allowed
        clock.advance(0.1)
        for side in ("ref", "port"):
            stacks[side].workers.tick()
        assert _segments(stacks["port"]) == _segments(stacks["ref"]), f"tick {tick}"
        for key in ("ns/a", "ns/b", "ns/c"):
            got = {side: dataclasses.asdict(stacks[side].workers.get(key).status)
                   for side in ("ref", "port")}
            assert (_port_env(got["ref"].pop("env")).keys()
                    == _without_hook_env(got["port"].pop("env")).keys())
            assert got["port"] == got["ref"]


HOOKED_TENANT = r"""
import ctypes as C, sys
cuda = C.CDLL("libcuda.so.1")
gpa = cuda.cuGetProcAddress_v2
gpa.argtypes = [C.c_char_p, C.POINTER(C.c_void_p), C.c_int, C.c_uint64, C.POINTER(C.c_int)]
fn, status = C.c_void_p(), C.c_int()
assert gpa(b"cuLaunchKernel", C.byref(fn), 12080, 0, C.byref(status)) == 0
launch = C.CFUNCTYPE(C.c_int, *([C.c_void_p] + [C.c_uint] * 7 + [C.c_void_p] * 3))(fn.value)
for _ in range(int(sys.argv[1])):
    assert launch(None, 1, 1, 1, 32, 1, 1, 0, None, None, None) == 0
hook = C.CDLL(None)
buf = C.create_string_buffer(1 << 14)
assert hook.tpf_cuda_hook_report(buf, 1 << 14) > 0
print(buf.value.decode())
"""


def test_a_hooked_single_process_worker_charges_and_ticks_as_before(stacks, clock, tmp_path):
    """A port worker's one process, spawned with the worker's env (the
    launch hook preloaded) over the stand-in driver, each launch a window
    of 100 us: it is charged its windows' sum, one charge a launch, as
    before the hook charged a worker's several processes their union.  The
    same charges made through the reference worker's client face leave
    equal segments and worker status after each of 10 ticks."""
    fake = tmp_path / "fake_cuda"
    fake.mkdir()
    _build.build_fake_cuda(fake)
    for side, pkg in SIDES:
        chip = stacks[side].devices.devices()[0].info.chip_id
        stacks[side].workers.add_worker(_spec(pkg, "a", chip, duty=25.0, qos="low"))
    wenv = stacks["port"].workers.get("ns/a").status.env
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPF_")}
    env.update(wenv, LD_LIBRARY_PATH=str(fake), TPF_FAKE_CUDA_LAUNCH_US="100")
    n = 40
    child = subprocess.Popen([sys.executable, "-c", HOOKED_TENANT, str(n)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out, err = child.communicate(timeout=60)
    assert child.returncode == 0, err
    hook = json.loads(out.strip().splitlines()[-1])
    assert hook["metered"] == 1 and hook["charges"] == n and hook["union_on"] == 0
    assert hook["device_us"] == hook["window_us"] == (n - 1) * 100
    # launch k pays the device time read since launch k - 1: none, then one window each
    peak = float(wenv[constants.ENV_PEAK_MFLOPS])
    gathered = [int(float(k * 100_000) * peak / 1e9) for k in range(n)]
    dues = [0] + [b - a for a, b in zip(gathered, gathered[1:])]
    assert sum(dues) == hook["charged_mflops"]
    s = stacks["ref"]
    client = ref.Limiter(fresh_library(s.limiter.lib_path, "hookedref"))
    client.attach(s.workers.get("ns/a").shm_path)
    for due in dues:
        assert client.charge_compute(0, due).allowed
    for side in ("ref", "port"):
        stacks[side].workers.register_pid("ns/a", child.pid)
    for tick in range(10):
        clock.advance(0.1)
        for side in ("ref", "port"):
            stacks[side].workers.tick()
        assert _segments(stacks["port"]) == _segments(stacks["ref"]), f"tick {tick}"
        got = {side: dataclasses.asdict(stacks[side].workers.get("ns/a").status)
               for side in ("ref", "port")}
        assert (_port_env(got["ref"].pop("env")).keys()
                == _without_hook_env(got["port"].pop("env")).keys())
        assert got["port"] == got["ref"]
    side_file = port.limiter_binding.hook_side_file(wenv[constants.ENV_SHM_PATH])
    assert os.path.exists(side_file)
    stacks["port"].workers.remove_worker("ns/a")
    assert not os.path.exists(side_file)


class _Duty:
    """A device controller whose one card reports a fixed NVML duty, and
    whether NVML can tell a process's."""

    def __init__(self, duty_pct, proc_util_supported):
        self.duty_pct = duty_pct
        self.extra = {"proc_util_supported": 1.0 if proc_util_supported else 0.0}

    def refresh_metrics(self):
        pass

    def get(self, chip_id):
        return port.DeviceEntry(info=None, metrics=ChipMetrics(
            chip_id=chip_id, duty_cycle_pct=self.duty_pct, hbm_bw_util_pct=0.0,
            hbm_used_bytes=0, power_watts=0.0, temp_celsius=0.0, ici_tx_bytes=0,
            ici_rx_bytes=0, extra=self.extra))


@pytest.mark.parametrize("case", ["time_sliced", "under_busy", "no_reading",
                                  "one_worker_two_streams"])
def test_worker_refill_covers_the_cards_overcharge(limiter_lib, tmp_path, case):
    """Charges (device-time shares a tick) against the card's NVML duty:
    what the tick adds to each worker-device's refill, once the smoothing
    has settled, and the duty it gives the ERL where NVML cannot tell a
    process's.  Two tenants that time-slice a fully busy card, charged
    0.5 and 1.0 of it, overpay 0.5 together and each is given 0.25;
    charges under the busy time, or no duty reading, add nothing; a lone
    worker charged twice the busy time (two streams' windows overlap) is
    given the difference, an idle one nothing."""
    duty, supported, shares, want, want_duty = {
        "time_sliced": (100.0, False, {"a": 0.5, "b": 1.0}, {"a": 0.25, "b": 0.25},
                        {"a": 50.0, "b": 100.0}),
        "under_busy": (90.0, True, {"a": 0.2, "b": 0.6}, {}, {}),
        "no_reading": (0.0, False, {"a": 0.5, "b": 1.0}, {}, {}),
        "one_worker_two_streams": (50.0, False, {"a": 1.0, "b": 0.0}, {"a": 0.5},
                                   {"a": 100.0, "b": 0.0}),
    }[case]
    peak = 989e6
    workers = port.WorkerController(_Duty(duty, supported), None,
                                    port.Limiter(fresh_library(limiter_lib, f"ov{case}")),
                                    str(tmp_path / "shm"))
    for _ in range(120):
        extra, got_duty = workers._card_shares(
            {"gpu-0": {(f"ns/{k}", 0): v for k, v in shares.items()}}, {"gpu-0": peak})
    assert sorted(extra) == sorted((f"ns/{k}", 0) for k in want)
    for k, share in want.items():
        assert extra[(f"ns/{k}", 0)] == pytest.approx(share * peak, rel=1e-3)
    assert sorted(got_duty) == sorted((f"ns/{k}", 0) for k in want_duty)
    for k, pct in want_duty.items():
        assert got_duty[(f"ns/{k}", 0)] == pytest.approx(pct, rel=1e-3, abs=1e-6)


def test_worker_tick_pushes_the_overcharge_into_the_refill(stacks, clock, monkeypatch):
    """The tick adds a worker-device's part of its card's overcharge to the
    refill the ERL gives it, and scales the bucket's capacity alike (the
    same seconds of burst); a worker with no part keeps the ERL's.  A duty
    read from the charges replaces the provider's in the ERL's
    observation."""
    s = stacks["port"]
    chip = s.devices.devices()[0].info.chip_id
    for name, duty in (("a", 25.0), ("b", 75.0)):
        s.workers.add_worker(_spec(port, name, chip, duty=duty))
    monkeypatch.setattr(s.workers, "_card_shares",
                        lambda charged, peaks: ({("ns/a", 0): 1e6}, {("ns/b", 0): 42.0}))
    erl_step = s.workers.erl.step
    pushed = []
    observed = []
    monkeypatch.setattr(s.workers.erl, "step", lambda obs, dt: observed.append(obs)
                        or pushed.append(erl_step(obs, dt)) or pushed[-1])
    clock.advance(0.1)
    s.workers.tick()
    ups = {up.worker_key: up for up in pushed[-1]}
    assert [ob.measured_duty_pct for ob in observed[-1]] == [0.0, 42.0]
    seg = {k: s.workers.get(k).view.read().devices[0] for k in ("ns/a", "ns/b")}
    a = ups["ns/a"]
    assert seg["ns/a"].refill_mflop_per_s == int(a.refill_mflop_per_s + 1e6)
    assert seg["ns/a"].capacity_mflop == int(
        a.capacity_mflop * (a.refill_mflop_per_s + 1e6) / a.refill_mflop_per_s)
    assert seg["ns/b"].refill_mflop_per_s == ups["ns/b"].refill_mflop_per_s
    assert seg["ns/b"].capacity_mflop == ups["ns/b"].capacity_mflop
    # a removed worker leaves no charges behind on its card
    s.workers._cards[chip] = port.worker._CardCharges(
        charged={("ns/a", 0): 0.5, ("ns/b", 0): 0.5})
    s.workers.remove_worker("ns/a")
    assert list(s.workers._cards[chip].charged) == [("ns/b", 0)]


def test_frozen_workers_refused_charges_are_not_hunger(stacks, clock):
    """A tenant frozen while it keeps trying to launch (the limiter refuses
    and counts each charge as blocked) keeps the refill and capacity it
    had before the freeze, and resumes at its earlier ERL share.
    Counting those refusals as hunger
    gave the frozen tenant the card's spare share and a larger burst."""
    s = stacks["port"]
    chip = s.devices.devices()[0].info.chip_id
    for name, duty, qos in (("lo", 25.0, "low"), ("hi", 75.0, "high")):
        s.workers.add_worker(_spec(port, name, chip, duty=duty, qos=qos))
    client = port.Limiter(fresh_library(s.limiter.lib_path, "frozenclient"))
    client.attach(s.workers.get("ns/hi").shm_path)

    def hi_bucket():
        d = s.workers.get("ns/hi").view.read().devices[0]
        return d.refill_mflop_per_s, d.capacity_mflop

    for _ in range(5):
        clock.advance(0.1)
        s.workers.tick()
    before, share = hi_bucket(), s.workers.erl.share("ns/hi", 0)
    s.workers.freeze_worker("ns/hi")
    blocked0 = s.workers.get("ns/hi").view.read().devices[0].blocked_events
    for _ in range(20):
        for _ in range(3):
            result = client.charge_compute(0, 1000)
            assert not result.allowed and result.frozen
        clock.advance(0.1)
        s.workers.tick()
        assert hi_bucket() == before
    assert s.workers.get("ns/hi").view.read().devices[0].blocked_events == blocked0 + 60
    assert s.workers.erl.share("ns/hi", 0) == share
    s.workers.resume_worker("ns/hi")
    clock.advance(0.1)
    s.workers.tick()
    assert s.workers.erl.share("ns/hi", 0) == share


def test_orphan_cleanup_keeps_a_segment_made_while_it_runs(stacks, monkeypatch):
    """An agent with no worker cleans orphan segments on every tick.  A
    worker added while that runs, its segment made between the cleanup's
    listing of the directory and its reading of the worker map, keeps its
    segment."""
    s = stacks["port"]
    worker_module = importlib.import_module("tensorfusion_tpu_torch.hypervisor.worker")
    chip = s.devices.devices()[0].info.chip_id
    listing = worker_module.list_worker_segments
    added = []

    def listed(base):
        if not added:
            added.append(s.workers.add_worker(_spec(port, "new", chip)))
        return listing(base)

    monkeypatch.setattr(worker_module, "list_worker_segments", listed)
    s.workers.tick()
    assert added and os.path.exists(s.workers.get("ns/new").shm_path)
    s.workers.tick()
    assert os.path.exists(s.workers.get("ns/new").shm_path)


def test_a_freeze_waits_for_the_tick_in_flight(stacks, clock, monkeypatch):
    """A tick that read a hungry tenant as running, and is frozen before it
    pushes the quota it computed, would still move the frozen bucket.  A
    freeze waits for the tick in flight, so the bucket it leaves is the
    one the tenant keeps while frozen."""
    s = stacks["port"]
    chip = s.devices.devices()[0].info.chip_id
    for name, duty, qos in (("lo", 25.0, "low"), ("hi", 75.0, "high")):
        s.workers.add_worker(_spec(port, name, chip, duty=duty, qos=qos))
    client = port.Limiter(fresh_library(s.limiter.lib_path, "inflightclient"))
    client.attach(s.workers.get("ns/hi").shm_path)

    def hi_bucket():
        d = s.workers.get("ns/hi").view.read().devices[0]
        return d.refill_mflop_per_s, d.capacity_mflop

    for _ in range(5):
        clock.advance(0.1)
        s.workers.tick()
    before = hi_bucket()
    # hi hits its bucket's wall: the next tick reads it as hungry
    assert not client.charge_compute(0, 10**15).allowed
    inside, release = threading.Event(), threading.Event()
    card_shares = s.workers._card_shares

    def held(charged, peaks):
        inside.set()
        release.wait(10)
        return card_shares(charged, peaks)

    monkeypatch.setattr(s.workers, "_card_shares", held)
    clock.advance(0.1)
    ticker = threading.Thread(target=s.workers.tick)
    ticker.start()
    assert inside.wait(10)
    at_freeze = []
    freezer = threading.Thread(
        target=lambda: (s.workers.freeze_worker("ns/hi"), at_freeze.append(hi_bucket())))
    freezer.start()
    freezer.join(0.3)
    release.set()
    ticker.join(10)
    freezer.join(10)
    assert hi_bucket() != before            # the tick in flight raised hi's share
    assert at_freeze == [hi_bucket()]
    for _ in range(10):
        assert not client.charge_compute(0, 1000).allowed
        clock.advance(0.1)
        s.workers.tick()
        assert hi_bucket() == at_freeze[0]


def test_auto_freeze_and_orphan_cleanup_equal(stacks, clock, tmp_path):
    seen = {}
    for side, pkg in SIDES:
        s = stacks[side]
        rule = (RefAutoFreezeRule if pkg is ref else AutoFreezeRule)(
            qos="low", freeze_to_mem_ttl_seconds=5.0)
        s.workers.auto_freeze_rules = {"low": rule}
        chip = s.devices.devices()[3].info.chip_id
        s.workers.add_worker(_spec(pkg, "idle", chip, duty=10.0, qos="low"))
        s.workers.add_worker(_spec(pkg, "busy", chip, duty=10.0, qos="medium"))
        stray = tmp_path / side / "shm" / "ghost" / "pod-x"
        stray.parent.mkdir(parents=True, exist_ok=True)
        stray.write_bytes(b"\0" * 3072)
    states = {"ref": [], "port": []}
    for step in range(8):
        clock.advance(1.0)
        for side in ("ref", "port"):
            s = stacks[side]
            s.workers.tick()
            w = s.workers.get("ns/idle")
            states[side].append((w.status.frozen, w.auto_frozen,
                                 w.view.read().auto_frozen,
                                 (tmp_path / side / "shm" / "ghost" / "pod-x").exists()))
    assert states["port"] == states["ref"]
    assert states["port"][-1][:3] == (True, True, True)
    assert not states["port"][-1][3]
    for side in ("ref", "port"):
        stacks[side].workers.resume_worker("ns/idle")
        seen[side] = stacks[side].workers.get("ns/idle").view.read().auto_frozen
    assert seen == {"ref": False, "port": False}


# -- the HTTP API ----------------------------------------------------------------


def _get(url, path, token=""):
    req = urllib.request.Request(url + path, headers={"X-TPF-Token": token})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _normalise(payload, stack):
    text = json.dumps(payload).replace(stack.shm, "<shm>").replace(
        stack.limiter.lib_path, "<limiter>")
    return json.loads(text)


@pytest.fixture()
def servers(stacks, tmp_path):
    out = {}
    for side, pkg in SIDES:
        s = stacks[side]
        chips = [e.info.chip_id for e in s.devices.devices()]
        s.workers.add_worker(_spec(pkg, "api", chips[0], duty=40.0))
        s.workers.add_worker(_spec(pkg, "hard", chips[2], duty=30.0, isolation="hard"))
        (tmp_path / side / "snap").mkdir(parents=True)
        server = pkg.HypervisorServer(s.devices, s.workers,
                                      snapshot_dir=str(tmp_path / side / "snap"),
                                      port=0, token="secret")
        server.start()
        out[side] = server
    yield out
    for server in out.values():
        server.stop()


@pytest.mark.parametrize("route", ["/api/v1/devices", "/api/v1/node", "/api/v1/topology",
                                   "/api/v1/workers", "/api/v1/allocations"])
def test_http_json_equal(stacks, servers, route):
    got = {}
    for side in ("ref", "port"):
        code, body = _get(servers[side].url, route, token="secret")
        assert code == 200
        got[side] = _normalise(body, stacks[side])
    if route == "/api/v1/workers":
        for w in got["ref"]:
            w["status"]["env"] = _port_env(w["status"]["env"])
        for w in got["port"]:
            w["status"]["env"] = _without_hook_env(w["status"]["env"])
    assert got["port"] == got["ref"]


def test_http_token_refusals_equal(servers):
    for path, token in (("/api/v1/devices", ""), ("/api/v1/devices", "wrong"),
                        ("/healthz", ""), ("/limiter?namespace=ns&pod=api", ""),
                        ("/limiter?namespace=ns&pod=nobody", ""), ("/nowhere", "secret")):
        codes = {side: _get(servers[side].url, path, token)[0] for side in servers}
        assert codes["port"] == codes["ref"], path
    assert _get(servers["port"].url, "/api/v1/devices")[0] == 401


def test_http_worker_lifecycle(stacks, servers, tmp_path):
    """Submit, register a pid, freeze, snapshot, resume, delete."""
    url = servers["port"].url
    chip = stacks["port"].devices.devices()[1].info.chip_id

    def call(path, method="POST", body=None):
        req = urllib.request.Request(url + path, method=method,
                                     data=json.dumps(body or {}).encode(),
                                     headers={"X-TPF-Token": "secret"})
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    reply = call("/api/v1/workers", body={
        "namespace": "api", "name": "w9", "isolation": "soft",
        "devices": [{"chip_id": chip, "duty_percent": 40, "hbm_bytes": 1 << 30}]})
    assert reply["status"]["env"][constants.ENV_VISIBLE_DEVICES] == "1"
    lim = _get(url, "/limiter?namespace=api&pod=w9")[1]
    call("/process", body={"namespace": "api", "pod": "w9", "pid": 777})
    assert 777 in port.ShmView(lim["shm_path"]).read().pids
    call("/api/v1/workers/api/w9/freeze")
    assert port.ShmView(lim["shm_path"]).read().frozen
    call("/api/v1/workers/api/w9/snapshot")
    assert (tmp_path / "port" / "snap" / f"{chip}.tpfsnap").exists()
    call("/api/v1/workers/api/w9/resume")
    assert not stacks["port"].workers.get("api/w9").status.frozen
    assert call("/api/v1/workers/api/w9", method="DELETE")["deleted"] == "api/w9"
    assert not os.path.exists(lim["shm_path"])


def test_http_routes_of_a_co_hosted_remote_worker(stacks, tmp_path):
    """/api/v1/dispatch, /profile, /serving and /migrate_target read the
    port's RemoteVTPUWorker as the reference's server reads its own; the
    recorder ships its dispatch lines."""
    from tensorfusion_tpu_torch.hypervisor.metrics import (
        HypervisorMetricsRecorder, remote_dispatch_lines)
    from tensorfusion_tpu_torch.remoting import RemoteVTPUWorker

    s = stacks["port"]
    rw = RemoteVTPUWorker(device="cpu")
    rw.start()
    server = port.HypervisorServer(s.devices, s.workers, snapshot_dir=str(tmp_path),
                                   port=0)
    server.start()
    try:
        assert _get(server.url, "/api/v1/migrate_target")[0] == 409
        server.register_remote_worker(rw)
        code, dispatch = _get(server.url, "/api/v1/dispatch")
        assert code == 200 and len(dispatch) == 1 and "queue_wait" in dispatch[0]
        assert _get(server.url, "/api/v1/serving") == (200, [])
        assert _get(server.url, "/api/v1/profile")[0] == 200
        assert _get(server.url, "/api/v1/policy") == (200, [])
        assert _get(server.url, "/api/v1/migrate_target")[1] == {
            "worker_url": rw.url, "protocol_version": rw.protocol_version}
        lines = remote_dispatch_lines(rw, "n0", 1)
        assert lines[0].startswith("tpf_remote_dispatch,mode=wfq,node=n0 ")
        pushed = []
        HypervisorMetricsRecorder(s.devices, s.workers, push=pushed.extend,
                                  remote_workers=[rw]).record_once()
        assert any(l.startswith("tpf_remote_dispatch,") for l in pushed)
    finally:
        server.stop()
        rw.stop()


def test_metrics_lines_equal(stacks, tmp_path):
    """The recorder's tpf_chip and tpf_worker lines, timestamps aside."""
    from tensorfusion_tpu.hypervisor.metrics import \
        HypervisorMetricsRecorder as RefRecorder
    from tensorfusion_tpu_torch.hypervisor.metrics import HypervisorMetricsRecorder

    lines = {}
    for side, pkg in SIDES:
        s = stacks[side]
        chip = s.devices.devices()[0].info.chip_id
        s.workers.add_worker(_spec(pkg, "m", chip))
        path = tmp_path / f"{side}.log"
        pushed = []
        rec = (RefRecorder if pkg is ref else HypervisorMetricsRecorder)(
            s.devices, s.workers, str(path), node_name="n0", push=pushed.extend)
        rec.record_once()
        lines[side] = [l.rsplit(" ", 1)[0] for l in path.read_text().splitlines()]
        assert [l.rsplit(" ", 1)[0] for l in pushed] == lines[side]
    assert lines["port"] == lines["ref"]
    assert any(l.startswith("tpf_worker,") for l in lines["port"])


# -- the single-node backend and the daemon ---------------------------------------


def test_single_node_backend_recovery(tmp_path):
    state = str(tmp_path / "state")
    b1 = port.SingleNodeBackend(state, spawn=False)
    added = []
    b1.start(lambda s: added.append(s), lambda k: None)
    spec = _spec(port, "w", "chip-0", duty=30.0)
    spec.command = ["true"]
    b1.submit_worker(spec)
    b1.stop()
    b2 = port.SingleNodeBackend(state, spawn=False)
    recovered = []
    b2.start(lambda s: recovered.append(s), lambda k: None)
    assert recovered == [spec] and added == [spec]
    b2.delete_worker("ns/w")
    b2.stop()
    b3 = port.SingleNodeBackend(state, spawn=False)
    again = []
    b3.start(lambda s: again.append(s), lambda k: None)
    assert again == []
    b3.stop()


def test_single_node_backend_restarts_dead_process(tmp_path):
    b = port.SingleNodeBackend(str(tmp_path / "st"), reconcile_interval_s=0.05)
    b.start(lambda s: None, lambda k: None)
    spec = port.WorkerSpec(namespace="d", name="sleepy", command=["sleep", "30"])
    b.submit_worker(spec, env={"X": "1"})
    pid1 = b.worker_pid("d/sleepy")
    assert pid1 is not None
    assert b.resolve_process(pid1).pod_name == "sleepy"
    os.kill(pid1, 9)
    deadline = time.time() + 5
    while time.time() < deadline and b.worker_pid("d/sleepy") in (None, pid1):
        time.sleep(0.05)
    pid2 = b.worker_pid("d/sleepy")
    assert pid2 not in (None, pid1)
    b.delete_worker("d/sleepy")
    b.stop()
    assert b.worker_pid("d/sleepy") is None


def _daemon_argv(tmp_path, provider, limiter_lib, tag):
    return ["--provider", provider, "--limiter", fresh_library(limiter_lib, tag),
            "--shm-base", str(tmp_path / "shm"), "--state-dir", str(tmp_path / "state"),
            "--snapshot-dir", str(tmp_path / "snap"), "--port", "0",
            "--port-file", str(tmp_path / "port")]


def test_daemon_wiring_in_process(mock_provider_lib, limiter_lib, tmp_path, monkeypatch):
    from tensorfusion_tpu_torch.hypervisor.__main__ import HypervisorDaemon, build_parser

    monkeypatch.setenv(constants.ENV_PROVIDER_LIB, "/from/env.so")
    assert build_parser().parse_args([]).provider == "/from/env.so"
    _mock_env(monkeypatch, "v5e-8")
    argv = _daemon_argv(tmp_path, fresh_library(mock_provider_lib, "wire"),
                        limiter_lib, "wire")
    daemon = HypervisorDaemon(build_parser().parse_args(
        argv + ["--metrics-path", str(tmp_path / "m.log"), "--metrics-interval-s", "60"]))
    daemon.start()
    try:
        assert (tmp_path / "port").read_text() == str(daemon.server.port)
        assert len(daemon.devices.devices()) == 8
        daemon._on_added(port.WorkerSpec(namespace="d", name="wired",
                                         devices=[port.WorkerDeviceRequest(
                                             duty_percent=50, hbm_bytes=1 << 30)]))
        tracked = daemon.workers.get("d/wired")
        assert constants.ENV_SHM_PATH in tracked.status.env
        assert daemon.backend._env["d/wired"] == tracked.status.env
        assert daemon.metrics is not None
    finally:
        daemon.stop()


def test_operator_url_is_refused(mock_provider_lib, limiter_lib, tmp_path, monkeypatch):
    """An --operator-url that no state store answers is refused when the
    daemon starts: it cannot register its node, so it raises rather than
    serving without the control plane (the flag itself is ported: see
    tests/test_torch_control_plane.py), and it stops cleanly."""
    from tensorfusion_tpu_torch.hypervisor.__main__ import HypervisorDaemon, build_parser
    from tensorfusion_tpu_torch.remote_store import RemoteStoreError

    _mock_env(monkeypatch, "v5e-8")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    args = build_parser().parse_args(
        _daemon_argv(tmp_path, fresh_library(mock_provider_lib, "opurl"), limiter_lib,
                     "opurl")
        + ["--operator-url", f"http://127.0.0.1:{dead}", "--pool", "pool-a",
           "--store-token", "t"])
    daemon = HypervisorDaemon(args)
    assert (args.pool, args.store_token) == ("pool-a", "t")
    try:
        with pytest.raises(RemoteStoreError, match="Connection refused"):
            daemon.start()
    finally:
        daemon.stop()
    assert daemon.workers.list() == []


def test_daemon_boots_and_adopts_a_worker(native_build, tmp_path):
    """``python -m tensorfusion_tpu_torch.hypervisor`` over the mock
    provider serves the devices API and adopts a persisted worker, whose
    spawned command sees the allocation env."""
    state = tmp_path / "state"
    state.mkdir()
    seen = tmp_path / "seen.json"
    spec = {"namespace": "d", "name": "w1", "isolation": "soft", "qos": "medium",
            "devices": [{"chip_id": "", "duty_percent": 50.0, "hbm_bytes": 1 << 30}],
            "command": [sys.executable, "-c",
                        "import json, os, sys, time; json.dump(dict(os.environ), "
                        f"open({str(seen)!r}, 'w')); time.sleep(30)"]}
    (state / "d__w1.worker.json").write_text(json.dumps(spec))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPF_MOCK_")}
    log = open(tmp_path / "daemon.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorfusion_tpu_torch.hypervisor",
         "--provider", str(native_build / "libtpf_provider_mock.so"),
         "--limiter", str(native_build / "libtpf_limiter.so"),
         "--shm-base", str(tmp_path / "shm"), "--state-dir", str(state),
         "--snapshot-dir", str(tmp_path / "snap"), "--port", str(free)],
        env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 60
        devices = None
        while time.time() < deadline and not seen.exists():
            try:
                devices = _get(f"http://127.0.0.1:{free}", "/api/v1/devices")[1]
            except OSError:
                pass
            time.sleep(0.3)
        time.sleep(0.3)
        tail = (tmp_path / "daemon.log").read_text()[-2000:]
        assert devices is not None and len(devices) == 8, tail
        wenv = json.loads(seen.read_text())
        assert wenv[constants.ENV_VISIBLE_DEVICES] == "0"
        assert wenv[constants.ENV_DEVICE_ORDER] == "PCI_BUS_ID"
        assert wenv[constants.ENV_DEVICE_MOUNTS].startswith("/dev/nvidia0")
        assert os.path.isabs(wenv[constants.ENV_LIMITER_LIB])
        assert os.path.exists(wenv[constants.ENV_SHM_PATH])
        assert (wenv[constants.ENV_POD_NAMESPACE], wenv[constants.ENV_POD_NAME]) == ("d", "w1")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
        log.close()
