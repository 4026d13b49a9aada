"""The port's kernel build cache (``tensorfusion_tpu_torch/ops/_build.py``)
on the CPU: a library's path is a hash of its source, of every shared
header under ``csrc/`` and of the flags, so an edited header never loads a
stale binary.  No nvcc is needed: the tests point ``CSRC`` and
``BUILD_DIR`` at a temporary copy and build with a stand-in compiler."""

import os
import re
import shutil
import stat
import sys

import pytest

pytest.importorskip("torch")

from tensorfusion_tpu_torch.ops import _build  # noqa: E402

SAMPLE_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__a9883fac_17_flash_attn_fwd_cu_6d56c8c05fwd9016flash_fwd_kernelILi128EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16Pfifi' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__a9883fac_17_flash_attn_fwd_cu_6d56c8c05fwd9016flash_fwd_kernelILi128EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16Pfifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__a9883fac_17_flash_attn_fwd_cu_6d56c8c020flash_fwd_f32_kernelILi64EEEvPKfS2_S2_PfS3_ifi' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__a9883fac_17_flash_attn_fwd_cu_6d56c8c020flash_fwd_f32_kernelILi64EEEvPKfS2_S2_PfS3_ifi
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 20608 bytes smem
"""

# A stand-in for nvcc: writes the file named after -o and prints a ptxas
# report; exits 1 when the source holds the word FAIL.
FAKE_NVCC = f"""#!{sys.executable}
import sys
args = sys.argv[1:]
src = open(args[-1]).read()
if "FAIL" in src:
    print("error: the source asked to fail")
    sys.exit(1)
open(args[args.index("-o") + 1], "w").write("built from " + args[-1])
print({SAMPLE_PTXAS!r})
"""


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    """A copy of the real csrc/ and an empty build directory."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


@pytest.fixture()
def fake_nvcc(tmp_path, monkeypatch):
    path = tmp_path / "nvcc"
    path.write_text(FAKE_NVCC)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(path))
    return path


def test_the_sources_include_the_shared_header():
    for source in _build.SOURCES.values():
        assert '#include "hopper.cuh"' in (_build.CSRC / source).read_text()
    assert (_build.CSRC / "hopper.cuh").is_file()


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_library_path_stays_put_when_nothing_changes(csrc, name):
    first = _build.library_path(name)
    assert first.parent == _build.BUILD_DIR
    assert _build.library_path(name) == first
    # touching a file without changing it keeps the path
    os.utime(csrc / "hopper.cuh")
    assert _build.library_path(name) == first


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_library_path_changes_when_a_header_changes(csrc, name):
    before = _build.library_path(name)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(name) != before


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_library_path_changes_when_a_header_is_added(csrc, name):
    before = _build.library_path(name)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path(name) != before


def test_library_path_changes_with_its_source_only(csrc):
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    src = csrc / _build.SOURCES["flash_attn_fwd"]
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("flash_attn_fwd") != paths["flash_attn_fwd"]
    assert _build.library_path("flash_attn_bwd") == paths["flash_attn_bwd"]


def test_build_all_rebuilds_after_a_header_edit(csrc, fake_nvcc):
    seconds = _build.build_all(["flash_attn_fwd"])
    assert seconds["flash_attn_fwd"] > 0.0
    first = _build.library_path("flash_attn_fwd")
    assert first.exists()
    assert _build.ptxas_summary(_build.ptxas_report("flash_attn_fwd"))
    # built already: nothing to do
    assert _build.build_all(["flash_attn_fwd"]) == {"flash_attn_fwd": 0.0}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert not _build.library_path("flash_attn_fwd").exists()
    assert _build.build_all(["flash_attn_fwd"])["flash_attn_fwd"] > 0.0
    assert _build.library_path("flash_attn_fwd").exists() and first.exists()


def test_a_failed_build_raises_and_leaves_no_library(csrc, fake_nvcc):
    src = csrc / _build.SOURCES["flash_attn_bwd"]
    src.write_text(src.read_text() + "\n// FAIL\n")
    with pytest.raises(_build.KernelBuildError, match="flash_attn_bwd"):
        _build.build_all(["flash_attn_fwd", "flash_attn_bwd"])
    assert _build.library_path("flash_attn_fwd").exists()
    assert not _build.library_path("flash_attn_bwd").exists()
    assert not list(_build.BUILD_DIR.glob("*.tmp"))


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_profile_groups_name_every_kernel_of_the_sources(name):
    """profile_serve/profile_train group device time by kernel name: every
    kernel of a source lands in an attention group, whatever its path."""
    from tensorfusion_tpu_torch import profile_serve

    source = (_build.CSRC / _build.SOURCES[name]).read_text()
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", source)
    assert kernels
    for kernel in kernels:
        # as torch.profiler names it
        group = profile_serve._group(f"void (anonymous namespace)::{kernel}<128>(float*)")
        assert group.startswith("flash_"), kernel


def test_ptxas_summary_reads_registers_spills_and_shared_memory():
    got = _build.ptxas_summary(SAMPLE_PTXAS)
    assert got == {
        "fwd90::flash_fwd_kernel<128>": {"registers": 168, "spill_bytes": 0,
                                         "stack": 0, "smem": 0},
        "flash_fwd_f32_kernel<64>": {"registers": 32, "spill_bytes": 12,
                                     "stack": 16, "smem": 20608},
    }
    assert _build.ptxas_summary("") == {}
