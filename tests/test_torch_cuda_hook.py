"""The launch and memory hook (tensorfusion_tpu_torch/hypervisor/csrc/
cuda_hook.c) on the CPU, over its stand-in driver (csrc/fake_cuda.c),
both built with cc, each case in a subprocess with the hook in
LD_PRELOAD: the C selftest's cases (the behaviours of the reference's
native/test/pjrt_proxy_selftest.cc, reached through cuGetProcAddress as
CUDA's runtime reaches the driver) held against the worker's segment, its
launch overhead, the client runtime charging once under the hook, the
node agent's worker env preloading it, Python and torch loading under it,
and the layout check of its hand-declared driver types.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

pytest.importorskip("torch")

from tensorfusion_tpu.testing import fresh_library  # noqa: E402
from tensorfusion_tpu_torch import constants  # noqa: E402
from tensorfusion_tpu_torch import hypervisor as port  # noqa: E402
from tensorfusion_tpu_torch.hypervisor import _build  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    out = tmp_path_factory.mktemp("cuda_hook")
    _build.build_fake_cuda(out)
    return {"hook": str(_build.cuda_hook_path()), "fake_dir": str(out),
            "selftest": str(_build.build_cuda_hook_selftest(out))}


def _env(built, preload=True, **extra):
    """This process's environment without the node agent's variables, the
    stand-in driver first on the library path, and the hook preloaded."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPF_") and k != constants.ENV_LD_PRELOAD}
    env["LD_LIBRARY_PATH"] = os.pathsep.join(
        filter(None, (built["fake_dir"], os.environ.get("LD_LIBRARY_PATH"))))
    if preload:
        env[constants.ENV_LD_PRELOAD] = built["hook"]
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _segment(path):
    view = port.ShmView(str(path))
    try:
        return view.read()
    finally:
        view.close()


SELFTEST_CASES = ["block", "charge", "window", "sync", "capture", "capture_modes", "streams",
                  "memory", "passthrough", "freeze", "rtld_next"]


@pytest.mark.parametrize("case", SELFTEST_CASES)
def test_selftest_case(built, limiter_lib, tmp_path, case):
    """One case of the C selftest; then the worker's segment holds exactly
    what the hook says it charged, and the selftest's pid."""
    proc = subprocess.Popen([built["selftest"], limiter_lib, str(tmp_path / "shm"), case],
                            env=_env(built), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, out + err
    assert f"PASS {case}" in out
    if case == "rtld_next":
        return
    report = json.loads(out.strip().splitlines()[-1])
    segment = tmp_path / "shm" / "t" / "w"
    if case == "passthrough":
        assert report["metered"] == 0 and not segment.exists()
        return
    state = _segment(segment)
    dev = state.devices[0]
    assert report["metered"] == 1
    assert dev.launches == report["charges"] == report["launches"]
    assert dev.total_charged_mflop == report["charged_mflops"]
    assert proc.pid in state.pids
    # one process alone on its worker charges its windows' sum
    assert report["union_on"] == 0 and report["device_us"] == report["window_us"]
    if case == "memory":
        assert dev.hbm_used_bytes == 0 and dev.hbm_denied_events == 1
    if case in ("block", "freeze"):
        assert dev.blocked_events > 0


@pytest.mark.parametrize("case", ["union", "union_other"])
def test_selftest_two_processes_on_one_card(built, limiter_lib, tmp_path, case):
    """Two processes under the hook launch on the card over the same 300 ms
    (the stand-in's events on the host's clock).  Of one worker they are
    charged the union of their windows, about one process's windows and
    far from their sum, and the segment holds what both hooks charged; of
    two workers each is charged its own windows' sum.  The hook's side
    files are no segments to the node agent."""
    r = subprocess.run([built["selftest"], limiter_lib, str(tmp_path / "shm"), case],
                       env=_env(built), capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.strip().splitlines()
    assert f"PASS {case}" in r.stdout
    child = json.loads(next(l for l in lines if l.startswith("CHILD "))[len("CHILD "):])
    parent = json.loads(lines[-1])
    both = (parent, child)
    base = tmp_path / "shm" / "t"
    if case == "union":
        dev = _segment(base / "w").devices[0]
        assert dev.launches == sum(h["charges"] for h in both)
        assert dev.total_charged_mflop == sum(h["charged_mflops"] for h in both)
        assert all(h["union_on"] == 1 and h["anchors"] >= 1 for h in both)
        charged = sum(h["device_us"] for h in both)
        windows = [h["window_us"] for h in both]
        assert max(windows) <= charged < 0.75 * sum(windows)
        pods = ["w"]
    else:
        for name, hook in (("w", parent), ("w2", child)):
            dev = _segment(base / name).devices[0]
            assert dev.launches == hook["charges"]
            assert dev.total_charged_mflop == hook["charged_mflops"]
            assert hook["union_on"] == 0 and hook["device_us"] == hook["window_us"]
        pods = ["w", "w2"]
    assert sorted(p.name for p in base.iterdir()) == sorted(pods + [f".{p}.hook" for p in pods])
    assert port.list_worker_segments(str(tmp_path / "shm")) == [
        ("t", p, str(base / p)) for p in pods]


def test_launch_overhead(built, limiter_lib, tmp_path):
    """The hook's cost per launch at the driver boundary, uncontended: far
    below a microsecond-scale launch budget (the reference's proxy bench
    holds it under 10 us)."""
    r = subprocess.run([built["selftest"], limiter_lib, str(tmp_path / "shm"), "--bench"],
                       env=_env(built), capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["metric"] == "cuda_hook_launch_overhead_ns"
    assert 0 <= result["value"] < 10_000


CLIENT_CHILD = r"""
import ctypes as C, json, sys
sys.path.insert(0, sys.argv[1])
import torch
from tensorfusion_tpu_torch.client.runtime import VTPUClient
from tensorfusion_tpu_torch.hypervisor import cuda_hook_binding

cuda = C.CDLL("libcuda.so.1")
gpa = cuda.cuGetProcAddress_v2
gpa.argtypes = [C.c_char_p, C.POINTER(C.c_void_p), C.c_int, C.c_uint64, C.POINTER(C.c_int)]
fn, status = C.c_void_p(), C.c_int()
assert gpa(b"cuLaunchKernel", C.byref(fn), 12080, 0, C.byref(status)) == 0
launch = C.CFUNCTYPE(C.c_int, *([C.c_void_p] + [C.c_uint] * 7 + [C.c_void_p] * 3))(fn.value)

client = VTPUClient(device="cpu")

def step(x):
    for _ in range(4):
        assert launch(None, 1, 1, 1, 32, 1, 1, 0, None, None, None) == 0
    return x * 2

metered = client.meter(step)
x = torch.ones(64, 64)
for _ in range(5):
    metered(x)
assert launch(None, 1, 1, 1, 32, 1, 1, 0, None, None, None) == 0  # reads the last window
hook = cuda_hook_binding.loaded()
print(json.dumps({"by_hook": client.hook is not None, "launches": client.launches,
                  "mflop": client.charged_mflops, "frozen": client.frozen(),
                  "hook": hook.report() if hook else None}))
"""


@pytest.mark.parametrize("preloaded", [True, False])
def test_client_under_the_hook_charges_the_segment_once(built, limiter_lib, tmp_path,
                                                        preloaded):
    """A metered callable that launches 4 fake kernels (1 ms each) a call.
    Under the hook the segment holds the hook's device-time charges alone,
    while the client still counts its own estimates; without the hook the
    client's charges are the segment's."""
    host = port.Limiter(fresh_library(limiter_lib, f"host{preloaded}"))
    host.init(str(tmp_path / "shm"))
    host.create_worker("t", "w", [port.DeviceQuota(0, "gpu-0", 10000, 1 << 30,
                                                   1 << 50, 1 << 50)])
    shm = str(tmp_path / "shm" / "t" / "w")
    r = subprocess.run(
        [sys.executable, "-c", CLIENT_CHILD, REPO], capture_output=True, text=True, timeout=120,
        env=_env(built, preload=preloaded, TPF_SHM_PATH=shm, TPF_LIMITER_LIB=limiter_lib,
                 TPF_PEAK_MFLOPS=1000, TPF_FAKE_CUDA_LAUNCH_US=1000))
    assert r.returncode == 0, r.stdout + r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    dev = _segment(shm).devices[0]
    assert got["launches"] == 5 and got["mflop"] >= 5 and got["frozen"] is False
    assert got["by_hook"] is preloaded
    if preloaded:
        hook = got["hook"]
        # 4 launches a call, the estimate's trace and the last one
        assert hook["launches"] == hook["charges"] == dev.launches
        assert hook["launches"] >= 21
        assert dev.total_charged_mflop == hook["charged_mflops"] == hook["device_us"] // 1000
        assert hook["device_us"] == (hook["launches"] - 1) * 1000
    else:
        assert got["hook"] is None
        assert dev.launches == got["launches"]
        assert dev.total_charged_mflop == got["mflop"]


def test_worker_env_preloads_the_hook(mock_provider_lib, limiter_lib, built, tmp_path,
                                      monkeypatch):
    """The node agent's env for a soft worker (the reference's
    worker.py:193-210 for PJRT): the hook first in LD_PRELOAD, before what
    the spec preloads; the limiter, device slot and peak beside it.  A
    process started with that env finds the hook attached to its segment,
    with its pid registered."""
    for k in list(os.environ):
        if k.startswith("TPF_MOCK_"):
            monkeypatch.delenv(k)
    provider = port.Provider(fresh_library(mock_provider_lib, "hookenv"))
    devices = port.DeviceController(provider)
    devices.start()
    try:
        limiter = port.Limiter(fresh_library(limiter_lib, "hookenv"))
        workers = port.WorkerController(devices, port.AllocationController(devices), limiter,
                                        str(tmp_path / "shm"))
        chip = devices.devices()[0].info
        spec = port.WorkerSpec(namespace="ns", name="w", isolation="soft",
                               devices=[port.WorkerDeviceRequest(chip_id=chip.chip_id,
                                                                 duty_percent=25.0,
                                                                 hbm_bytes=1 << 30)],
                               env={constants.ENV_LD_PRELOAD: "libm.so.6"})
        env = workers.add_worker(spec).status.env
        assert env[constants.ENV_LD_PRELOAD] == f"{built['hook']}:libm.so.6"
        assert os.path.isabs(built["hook"]) and os.path.exists(built["hook"])
        assert env[constants.ENV_LIMITER_LIB] == os.path.abspath(limiter.lib_path)
        assert env[constants.ENV_DEVICE_INDEX] == "0"
        assert float(env[constants.ENV_PEAK_MFLOPS]) == chip.peak_bf16_tflops * 1e6
        assert env[constants.ENV_LIVE_HBM_INTERVAL] == "10"
        child = ("import json, sys; sys.path.insert(0, sys.argv[1]);"
                 "from tensorfusion_tpu_torch.hypervisor import cuda_hook_binding as b;"
                 "h = b.loaded(); print(json.dumps([h is not None, h.metered()]))")
        r = subprocess.run([sys.executable, "-c", child, REPO], capture_output=True,
                           text=True, timeout=60, env={**_env(built, preload=False), **env})
        assert r.returncode == 0, r.stdout + r.stderr
        assert json.loads(r.stdout.strip().splitlines()[-1]) == [True, True]
        state = _segment(env[constants.ENV_SHM_PATH])
        assert len(state.pids) == 1
        workers.remove_worker("ns/w")
    finally:
        devices.stop()


RANK_TENANT = r"""
import json, os, sys, time
sys.path[:0] = [sys.argv[1], os.path.join(sys.argv[1], "tests")]
import torch_rank_tasks
from tensorfusion_tpu_torch.hypervisor import cuda_hook_binding
from tensorfusion_tpu_torch.parallel import RankGroup

hook = cuda_hook_binding.loaded()
assert hook is not None and hook.metered()     # this process joins the segment
with RankGroup(int(sys.argv[3]), device="cpu", backend="gloo", timeout_s=120) as group:
    ranks = group.run(torch_rank_tasks.hooked_launches, 7)
parent = {"pid": os.getpid(), "hook": hook.report(),
          "env": {k: os.environ.get(k) for k in torch_rank_tasks.HOOK_ENV}}
with open(sys.argv[2] + ".tmp", "w") as f:
    json.dump({"parent": parent, "ranks": ranks}, f)
os.replace(sys.argv[2] + ".tmp", sys.argv[2])
time.sleep(600)      # the backend restarts a worker that exits
"""


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_daemon_spawned_rank_group_is_metered_as_one_tenant(built, native_build, tmp_path,
                                                            n_ranks):
    """A soft worker spawned by the daemon (``python -m
    tensorfusion_tpu_torch.hypervisor`` over the mock provider) whose
    command starts a rank group, each rank launching through the stand-in
    driver: every rank inherits the hook's variables and registers its
    pid in the one segment beside the worker's own, and the segment's
    launches and charges are the sum of the processes' hook reports."""
    out = tmp_path / "tenant.json"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    env = {k: v for k, v in _env(built, preload=False).items()
           if not k.startswith("TPF_MOCK_")}
    log = open(tmp_path / "daemon.log", "w")
    daemon = subprocess.Popen(
        [sys.executable, "-m", "tensorfusion_tpu_torch.hypervisor",
         "--provider", str(native_build / "libtpf_provider_mock.so"),
         "--limiter", str(native_build / "libtpf_limiter.so"),
         "--shm-base", str(tmp_path / "shm"), "--state-dir", str(tmp_path / "state"),
         "--snapshot-dir", str(tmp_path / "snap"), "--port", str(free),
         "--api-token", "t"],
        env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{free}"

    def api(path, method="GET", body=None):
        req = urllib.request.Request(url + path, method=method, headers={
            "X-TPF-Token": "t", "Content-Type": "application/json"},
            data=None if body is None else json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    try:
        deadline = time.time() + 60
        while True:
            try:
                chip = api("/api/v1/devices")[0]["info"]["chip_id"]
                break
            except OSError:
                assert time.time() < deadline and daemon.poll() is None, \
                    (tmp_path / "daemon.log").read_text()[-2000:]
                time.sleep(0.3)
        spec = {"namespace": "d", "name": "ranks", "isolation": "soft", "qos": "medium",
                "devices": [{"chip_id": chip, "duty_percent": 50.0, "hbm_bytes": 1 << 30}],
                "env": {"LD_LIBRARY_PATH": built["fake_dir"],
                        "TPF_FAKE_CUDA_LAUNCH_US": "500"},
                "command": [sys.executable, "-c", RANK_TENANT, REPO, str(out),
                            str(n_ranks)]}
        wenv = api("/api/v1/workers", "POST", spec)["status"]["env"]
        deadline = time.time() + 120
        while not out.exists():
            assert time.time() < deadline and daemon.poll() is None, \
                (tmp_path / "daemon.log").read_text()[-2000:]
            time.sleep(0.3)
        got = json.loads(out.read_text())
        state = _segment(wenv[constants.ENV_SHM_PATH])
        api("/api/v1/workers/d/ranks", "DELETE")
    finally:
        daemon.terminate()
        try:
            daemon.wait(timeout=10)
        except subprocess.TimeoutExpired:
            daemon.kill()
        log.close()
    procs = [got["parent"]] + got["ranks"]
    assert len(got["ranks"]) == n_ranks
    assert sorted(state.pids) == sorted(p["pid"] for p in procs)
    for p in got["ranks"]:
        assert p["env"] == got["parent"]["env"]
        assert p["env"]["LD_PRELOAD"].split(":")[0] == built["hook"]
        assert p["hook"]["metered"] == 1 and p["hook"]["launches"] == 7
    assert got["parent"]["hook"]["launches"] == 0
    dev = state.devices[0]
    assert dev.launches == sum(p["hook"]["charges"] for p in procs) > 0
    assert dev.total_charged_mflop == sum(p["hook"]["charged_mflops"] for p in procs) > 0


def test_python_and_torch_load_under_the_hook(built):
    """The hook interposes dlsym for the whole process: the interpreter,
    its extension modules and torch load and run under it."""
    child = ("import ctypes, json, numpy, torch; x = torch.arange(6.0).reshape(2, 3);"
             "print(json.dumps([float((x @ x.T).sum()), ctypes.CDLL(None).getpid() > 0]))")
    r = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                       timeout=120, env=_env(built))
    assert r.returncode == 0, r.stdout + r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == [83.0, True]


@pytest.mark.parametrize("layout", ["same", "shifted"])
def test_cuda_layout_check_holds_the_declarations_to_a_header(tmp_path, monkeypatch, layout):
    """The check compiles against whatever cuda.h it finds: one that
    matches cuda_types.h passes, one with a field moved fails the build."""
    config = ("unsigned int sharedMemBytes; CUstream hStream;" if layout == "same"
              else "CUstream hStream; unsigned int sharedMemBytes;")
    header = f"""
    #include <stdint.h>
    typedef enum {{ CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1,
      CUDA_ERROR_NOT_FOUND = 500, CUDA_ERROR_NOT_READY = 600 }} CUresult;
    typedef unsigned long long CUdeviceptr;
    typedef struct CUstream_st* CUstream;
    typedef struct CUfunc_st* CUfunction;
    typedef struct CUgraphExec_st* CUgraphExec;
    typedef struct CUgraph_st* CUgraph;
    typedef struct CUevent_st* CUevent;
    typedef struct CUmemPoolHandle_st* CUmemoryPool;
    typedef unsigned long long CUmemGenericAllocationHandle;
    typedef uint64_t cuuint64_t;
    typedef enum {{ CU_STREAM_CAPTURE_STATUS_NONE = 0, CU_STREAM_CAPTURE_STATUS_ACTIVE = 1,
      CU_STREAM_CAPTURE_STATUS_INVALIDATED = 2 }} CUstreamCaptureStatus;
    typedef enum {{ CU_STREAM_CAPTURE_MODE_GLOBAL = 0, CU_STREAM_CAPTURE_MODE_THREAD_LOCAL = 1,
      CU_STREAM_CAPTURE_MODE_RELAXED = 2 }} CUstreamCaptureMode;
    typedef enum {{ CU_GET_PROC_ADDRESS_SUCCESS = 0, CU_GET_PROC_ADDRESS_SYMBOL_NOT_FOUND = 1,
      CU_GET_PROC_ADDRESS_VERSION_NOT_SUFFICIENT = 2 }} CUdriverProcAddressQueryResult;
    enum {{ CU_GET_PROC_ADDRESS_DEFAULT = 0, CU_GET_PROC_ADDRESS_LEGACY_STREAM = 1,
      CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM = 2, CU_EVENT_DEFAULT = 0 }};
    #define CU_STREAM_LEGACY ((CUstream)0x1)
    #define CU_STREAM_PER_THREAD ((CUstream)0x2)
    typedef struct CUlaunchAttribute_st CUlaunchAttribute;
    typedef struct {{ unsigned int gridDimX, gridDimY, gridDimZ, blockDimX, blockDimY,
      blockDimZ; {config} CUlaunchAttribute* attrs; unsigned int numAttrs; }} CUlaunchConfig;
    """
    (tmp_path / "include").mkdir()
    (tmp_path / "include" / "cuda.h").write_text(header)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if layout == "same":
        assert _build.check_cuda_layout() == tmp_path / "include" / "cuda.h"
    else:
        with pytest.raises(_build.ProviderBuildError, match="CUlaunchConfig"):
            _build.check_cuda_layout()
