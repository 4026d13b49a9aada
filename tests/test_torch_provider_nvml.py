"""The port's NVML provider (tensorfusion_tpu_torch/hypervisor/csrc/
provider_nvml.c) over its stand-in NVML (csrc/fake_nvml.c), both built
with cc: the reference's compiled conformance check, the reference's and
the port's bindings reading what the fake was given, the link mapping over
four cards, per-process utilization, the failures of tpf_init, partitions,
snapshots, the layout check, and the port's daemon on it.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

import tensorfusion_tpu.hypervisor as ref
import tensorfusion_tpu_torch.hypervisor as port
from tensorfusion_tpu_torch.testing import fresh_library
from tensorfusion_tpu_torch import constants, hardware
from tensorfusion_tpu_torch.hypervisor import _build
from tensorfusion_tpu_torch.hypervisor.provider_binding import (TPF_ERR_EXHAUSTED,
                                                                TPF_ERR_FAILED,
                                                                TPF_ERR_INVALID_ARG,
                                                                TPF_ERR_NOT_FOUND)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"
UUID0 = "GPU-00000000-0000-0000-0000-000000000000"
SIDES = (("ref", ref), ("port", port))


@pytest.fixture(scope="module")
def fakes(tmp_path_factory):
    out = tmp_path_factory.mktemp("fake_nvml")
    return {"full": str(_build.build_fake_nvml(out)),
            "nouuid": str(_build.build_fake_nvml(out, omit_uuid=True))}


@pytest.fixture(scope="module")
def provider_lib():
    return str(_build.provider_path())


@pytest.fixture()
def nvml(fakes, monkeypatch):
    """Sets the fake's environment; returns a setter for more of it."""
    for k in list(os.environ):
        if k.startswith("TPF_FAKE_NVML_") or k == "TPF_NVML_SYSFS":
            monkeypatch.delenv(k)
    monkeypatch.setenv(constants.ENV_NVML_LIB, fakes["full"])

    def set_env(**kw):
        for k, v in kw.items():
            monkeypatch.setenv(k if k.startswith("TPF_") else f"TPF_FAKE_NVML_{k}", str(v))
    return set_env


def _open(provider_lib, pkg=port, tag="nvml"):
    logs = []
    p = pkg.Provider(fresh_library(provider_lib, tag),
                     log_fn=lambda lvl, msg: logs.append((lvl, msg)))
    return p, logs


def _reads(p):
    chips = p.enumerate()
    return {"chips": [dataclasses.asdict(c) for c in chips],
            "topology": dataclasses.asdict(p.topology()),
            "templates": [dataclasses.asdict(t)
                          for t in p.partition_templates(chips[0].chip_id)],
            "metrics": [dataclasses.asdict(m)
                        for m in p.chip_metrics([c.chip_id for c in chips])],
            "mounts": p.mounts()}


@pytest.mark.parametrize("cards", [1, 4])
def test_reference_conformance_passes(native_build, provider_lib, nvml, cards):
    nvml(COUNT=cards, NVLINK="0-1,2-3", NUMA="0,0,1,1")
    r = subprocess.run([str(native_build / "provider_conformance"), provider_lib],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith(f"PASS: {cards} chips, 1 templates")


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe",
                                  "NVIDIA H100 NVL"])
def test_bindings_read_the_fake_card(provider_lib, nvml, name):
    nvml(NAME=name, MEMORY=81559289856)
    seen = {}
    for side, pkg in SIDES:
        p, _ = _open(provider_lib, pkg, f"read{side}")
        p.init()
        seen[side] = _reads(p)
        p.shutdown()
    assert seen["port"] == seen["ref"]
    chip, = seen["port"]["chips"]
    rates = hardware.peak_rates(name)
    gen = {"H100 PCIe": "h100-pcie", "H100 NVL": "h100-nvl"}.get(name[7:], "h100-sxm")
    assert (chip["chip_id"], chip["platform"], chip["generation"]) == (UUID0, "gpu", gen)
    assert chip["hbm_bytes"] == 81559289856
    assert chip["peak_bf16_tflops"] * 1e12 == rates["bf16"]
    assert chip["peak_int8_tops"] * 1e12 == rates["int8"]
    assert chip["hbm_gbps"] * 1e9 == rates["bytes"]
    assert (chip["core_count"], chip["host_index"], chip["mesh"]) == (1, 0, (0, 0, 0))
    assert (chip["device_path"], chip["driver_version"]) == ("/dev/nvidia0", "580.00.fake")
    assert chip["caps"]["soft_isolation"] and not chip["caps"]["core_partitioning"]
    tmpl, = seen["port"]["templates"]
    assert (tmpl["template_id"], tmpl["name"]) == (f"{gen}-full", f"{name} whole card")
    assert (tmpl["slots"], tmpl["is_default"]) == (1, True)
    m, = seen["port"]["metrics"]
    assert (m["duty_cycle_pct"], m["hbm_bw_util_pct"], m["power_watts"],
            m["temp_celsius"], m["extra"]["power_limit_w"]) == (37, 12, 312.5, 41, 700)
    assert seen["port"]["mounts"] == [("/dev/nvidiactl", "/dev/nvidiactl"),
                                      ("/dev/nvidia-uvm", "/dev/nvidia-uvm")]


@pytest.mark.parametrize("support", ["full", "no_pci_or_topology"])
def test_four_card_link_mapping(provider_lib, nvml, tmp_path, support):
    """NVLink peers are ICI (1 hop), a shared host bridge ICI_ROUTED,
    across NUMA nodes DCN; NUMA nodes from sysfs.  An NVML that gives
    neither PCI info nor common ancestors leaves the NUMA nodes unknown and
    the non-NVLink links NONE."""
    for card, node in enumerate((0, 0, 1, 1)):
        d = tmp_path / "bus" / "pci" / "devices" / f"0000:{0x10 + card:02x}:00.0"
        d.mkdir(parents=True)
        (d / "numa_node").write_text(f"{node}\n")
    nvml(COUNT=4, NVLINK="0-1", NUMA="0,0,1,1", TPF_NVML_SYSFS=tmp_path)
    if support != "full":
        nvml(UNSUPPORTED="pci,topology")
    seen = {}
    for side, pkg in SIDES:
        p, _ = _open(provider_lib, pkg, f"links{side}")
        p.init()
        seen[side] = _reads(p)
        p.shutdown()
    assert seen["port"] == seen["ref"]
    chips = [c["chip_id"] for c in seen["port"]["chips"]]
    links = seen["port"]["topology"]["links"]
    kinds = [[links[a][j]["kind"] for j in range(4)] for a in chips]
    numa = [c["numa_node"] for c in seen["port"]["chips"]]
    if support == "full":
        assert numa == [0, 0, 1, 1]
        assert kinds == [["self", "ici", "dcn", "dcn"], ["ici", "self", "dcn", "dcn"],
                         ["dcn", "dcn", "self", "ici-routed"],
                         ["dcn", "dcn", "ici-routed", "self"]]
    else:
        assert numa == [-1] * 4
        assert kinds[0] == ["self", "ici", "none", "none"]
        assert kinds[2] == ["none", "none", "self", "none"]
    assert links[chips[0]][1]["hops"] == 1 and links[chips[0]][1]["gbps"] == 450.0
    assert seen["port"]["topology"]["mesh_shape"] == (4, 1, 1)


def test_proc_stats_average_samples_and_read_no_sample_as_zero(provider_lib, nvml):
    nvml(PROCS="4242:0:1073741824:20@1000/40@2000/90@3000;4343:0:2147483648:")
    provs = {side: _open(provider_lib, pkg, f"procs{side}")[0] for side, pkg in SIDES}
    reads = {side: [] for side in provs}
    for side, p in provs.items():
        p.init()
        reads[side].append([dataclasses.asdict(s) for s in p.proc_stats()])
        reads[side].append([dataclasses.asdict(s) for s in p.proc_stats()])
    nvml(PROCS="4242:0:1073741824:20@1000/40@2000/90@3000/10@4000;4343:0:2147483648:")
    for side, p in provs.items():
        reads[side].append([dataclasses.asdict(s) for s in p.proc_stats()])
        p.shutdown()
    assert reads["port"] == reads["ref"]
    duty = [[(s["pid"], s["duty_cycle_pct"], s["hbm_used_bytes"]) for s in r]
            for r in reads["port"]]
    assert duty == [[(4242, 50.0, 1 << 30), (4343, 0.0, 2 << 30)],
                    [(4242, 0.0, 1 << 30), (4343, 0.0, 2 << 30)],
                    [(4242, 10.0, 1 << 30), (4343, 0.0, 2 << 30)]]
    assert all(s["chip_id"] == UUID0 and s["programs_launched"] == 0
               for r in reads["port"] for s in r)


def test_unsupported_process_utilization_reads_zero_and_says_so(provider_lib, nvml):
    nvml(PROCS="1:0:5000:50@1000;1:0:5000:", UNSUPPORTED="process_utilization")
    p, logs = _open(provider_lib)
    p.init()
    assert p.chip_metrics([UUID0])[0].extra["proc_util_supported"] == 1.0
    stats = [(s.pid, s.duty_cycle_pct, s.hbm_used_bytes) for s in p.proc_stats()]
    assert stats == [(1, 0.0, 5000), (1, 0.0, 5000)]
    assert p.chip_metrics([UUID0])[0].extra["proc_util_supported"] == 0.0
    p.proc_stats()
    warned = [m for lvl, m in logs if "no per-process utilization" in m]
    assert len(warned) == 1 and all(lvl == "warn" for lvl, m in logs if m in warned)
    p.shutdown()


@pytest.mark.parametrize("case, needle", [
    ("no_library", "cannot load NVML"),
    ("missing_symbol", "has no symbol nvmlDeviceGetUUID"),
    ("unknown_card", "NVIDIA A100-SXM4-80GB: no datasheet peaks"),
    ("init_fails", "nvmlInit_v2 failed: Driver Not Loaded"),
    ("no_gpu", "NVML reports 0 GPUs"),
])
def test_init_fails_with_a_log_line(provider_lib, nvml, fakes, tmp_path, case, needle):
    if case == "no_library":
        nvml(TPF_NVML_LIB=tmp_path / "libnvidia-ml.so.1")
    elif case == "missing_symbol":
        nvml(TPF_NVML_LIB=fakes["nouuid"])
    elif case == "unknown_card":
        nvml(NAME="NVIDIA A100-SXM4-80GB")
    elif case == "init_fails":
        nvml(FAIL_INIT=1)
    else:
        nvml(COUNT=0)
    p, logs = _open(provider_lib, tag=case)
    with pytest.raises(port.ProviderError) as e:
        p.init()
    assert e.value.status == TPF_ERR_FAILED
    assert any(lvl == "error" and needle in m for lvl, m in logs), logs
    with pytest.raises(port.ProviderError):
        p.chip_count()          # still not initialised


def test_whole_card_partition_grant(provider_lib, nvml):
    nvml()
    p, _ = _open(provider_lib)
    p.init()
    grant = p.partition_create("h100-sxm-full", UUID0)
    assert grant.env == {"CUDA_VISIBLE_DEVICES": UUID0,
                         "TPF_PARTITION_ID": grant.partition_id,
                         "TPF_PARTITION_HBM_BYTES": "85520809984"}
    for args, status in ((("h100-sxm-full", UUID0), TPF_ERR_EXHAUSTED),
                         (("h100-sxm-2g", UUID0), TPF_ERR_INVALID_ARG),
                         (("h100-sxm-full", "GPU-none"), TPF_ERR_NOT_FOUND)):
        with pytest.raises(port.ProviderError) as e:
            p.partition_create(*args)
        assert e.value.status == status
    p.partition_destroy(grant.partition_id, UUID0)
    with pytest.raises(port.ProviderError) as e:
        p.partition_destroy(grant.partition_id, UUID0)
    assert e.value.status == TPF_ERR_NOT_FOUND
    p.shutdown()


def test_hard_limits_snapshot_and_restore(provider_lib, nvml, tmp_path):
    nvml(PROCS="77:0:3000000000:")
    p, _ = _open(provider_lib, tag="snap")
    p.init()
    p.set_hbm_hard_limit(UUID0, 8 << 30)
    p.set_duty_hard_limit(UUID0, 40)
    with pytest.raises(port.ProviderError):
        p.set_duty_hard_limit(UUID0, 101)
    grant = p.partition_create("h100-sxm-full", UUID0)
    p.snapshot(str(tmp_path), chip_id=UUID0)
    extra = p.chip_metrics([UUID0])[0].extra
    assert (extra["hbm_hard_limit_bytes"], extra["duty_hard_limit_pct"],
            extra["frozen"]) == (8 << 30, 40, 1.0)
    manifest = (tmp_path / f"{UUID0}.tpfsnap").read_text().splitlines()
    assert manifest[:2] == [f"chip {UUID0}", f"kind {H100}"]
    assert "hbm_in_use 3000000000" in manifest
    assert f"partition {grant.partition_id} h100-sxm-full 0 1" in manifest
    p.snapshot(str(tmp_path), pids=[5, 6])
    assert (tmp_path / "procs.tpfsnap").read_text() == "pid 5\npid 6\n"
    p.shutdown()

    q, _ = _open(provider_lib, tag="restore")   # a restarted node agent
    q.init()
    q.restore(str(tmp_path), chip_id=UUID0)
    assert q.chip_metrics([UUID0])[0].extra["frozen"] == 0.0
    with pytest.raises(port.ProviderError) as e:       # the grant was re-adopted
        q.partition_create("h100-sxm-full", UUID0)
    assert e.value.status == TPF_ERR_EXHAUSTED
    q.partition_destroy(grant.partition_id, UUID0)
    assert q.partition_create("h100-sxm-full", UUID0).partition_id.endswith("-p1")
    q.shutdown()


def test_partitioned_allocation_grants_the_card_by_uuid(provider_lib, nvml):
    nvml(COUNT=2)
    p, _ = _open(provider_lib, tag="alloc")
    devices = port.DeviceController(p)
    devices.start()
    try:
        alloc = port.AllocationController(devices)
        a = alloc.allocate(port.WorkerSpec(
            namespace="ns", name="w", isolation="partitioned",
            devices=[port.WorkerDeviceRequest(chip_id=UUID0[:-1] + "1",
                                              partition_template="h100-sxm-full")]))
        assert a.env[constants.ENV_VISIBLE_DEVICES] == UUID0[:-1] + "1"
        assert a.env[constants.ENV_DEVICE_ORDER] == "PCI_BUS_ID"
        soft = alloc.allocate(port.WorkerSpec(
            namespace="ns", name="s", devices=[port.WorkerDeviceRequest()]))
        assert soft.env[constants.ENV_VISIBLE_DEVICES] == "0"   # least loaded
        assert soft.mounts == ["/dev/nvidia0", "/dev/nvidiactl", "/dev/nvidia-uvm"]
        alloc.release("ns/w")
    finally:
        devices.stop()


def test_daemon_serves_the_fake_card(provider_lib, limiter_lib, nvml, tmp_path):
    nvml()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorfusion_tpu_torch.hypervisor",
         "--provider", fresh_library(provider_lib, "daemon"), "--limiter", limiter_lib,
         "--shm-base", str(tmp_path / "shm"), "--state-dir", str(tmp_path / "state"),
         "--snapshot-dir", str(tmp_path / "snap"), "--port", "0",
         "--port-file", str(tmp_path / "port"), "--api-token", "t"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    try:
        deadline, devices = time.time() + 60, None
        while time.time() < deadline and devices is None:
            time.sleep(0.2)
            port_file = tmp_path / "port"
            if not (port_file.exists() and port_file.read_text()):
                continue
            req = urllib.request.Request(
                f"http://127.0.0.1:{port_file.read_text()}/api/v1/devices",
                headers={"X-TPF-Token": "t"})
            try:
                with urllib.request.urlopen(req, timeout=5) as r:
                    devices = json.loads(r.read())
            except OSError:
                pass
        assert devices is not None and len(devices) == 1
        assert devices[0]["info"]["chip_id"] == UUID0
        assert devices[0]["info"]["generation"] == "h100-sxm"
        assert devices[0]["metrics"]["extra"]["power_limit_w"] == 700.0
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_provider_build_is_keyed_by_its_sources(provider_lib):
    assert _build.provider_path() == _build.provider_path()
    assert os.path.basename(provider_lib).startswith("libtpf_provider_nvml-")


@pytest.mark.parametrize("layout", ["same", "shifted"])
def test_layout_check_holds_the_declarations_to_a_header(tmp_path, monkeypatch, layout):
    """The check compiles against whatever nvml.h it finds: one that
    matches nvml_types.h passes, one with a field moved fails the build."""
    memory = ("unsigned long long total, free, used;" if layout == "same"
              else "unsigned long long total, used, reserved, free;")
    header = f"""
    typedef struct nvmlDevice_st* nvmlDevice_t;
    typedef enum {{ NVML_SUCCESS = 0, NVML_ERROR_NOT_SUPPORTED = 3,
      NVML_ERROR_NOT_FOUND = 6, NVML_ERROR_INSUFFICIENT_SIZE = 7,
      NVML_ERROR_DRIVER_NOT_LOADED = 9 }} nvmlReturn_t;
    enum {{ NVML_TEMPERATURE_GPU = 0, NVML_P2P_CAPS_INDEX_NVLINK = 2,
      NVML_P2P_STATUS_OK = 0, NVML_P2P_STATUS_NOT_SUPPORTED = 5,
      NVML_TOPOLOGY_INTERNAL = 0, NVML_TOPOLOGY_SINGLE = 10, NVML_TOPOLOGY_MULTIPLE = 20,
      NVML_TOPOLOGY_HOSTBRIDGE = 30, NVML_TOPOLOGY_NODE = 40, NVML_TOPOLOGY_SYSTEM = 50 }};
    #define NVML_DEVICE_NAME_V2_BUFFER_SIZE 96
    #define NVML_DEVICE_UUID_V2_BUFFER_SIZE 96
    #define NVML_SYSTEM_DRIVER_VERSION_BUFFER_SIZE 80
    #define NVML_VALUE_NOT_AVAILABLE (-1)
    typedef struct {{ {memory} }} nvmlMemory_t;
    typedef struct {{ unsigned int gpu, memory; }} nvmlUtilization_t;
    typedef struct {{ char busIdLegacy[16]; unsigned int domain, bus, device,
      pciDeviceId, pciSubSystemId; char busId[32]; }} nvmlPciInfo_t;
    typedef struct {{ unsigned int pid; unsigned long long usedGpuMemory;
      unsigned int gpuInstanceId, computeInstanceId; }} nvmlProcessInfo_t;
    typedef struct {{ unsigned int pid; unsigned long long timeStamp;
      unsigned int smUtil, memUtil, encUtil, decUtil; }} nvmlProcessUtilizationSample_t;
    """
    (tmp_path / "include").mkdir()
    (tmp_path / "include" / "nvml.h").write_text(header)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if layout == "same":
        assert _build.check_nvml_layout() == tmp_path / "include" / "nvml.h"
    else:
        with pytest.raises(_build.ProviderBuildError, match="nvmlMemory_t"):
            _build.check_nvml_layout()
