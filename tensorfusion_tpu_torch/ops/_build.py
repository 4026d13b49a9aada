"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` compiles on its own into a shared library with
a plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``).  Nothing is built at import: the first call
that needs a library builds it into ``build/kernels/`` at the repository
root (listed in ``.gitignore``), named by a hash of its source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header never
loads a stale binary.  ``build_all()`` starts one
nvcc per source, all at once, and waits for them together.

A missing nvcc or a failed compile raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: library name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "flash_attn_fwd": "flash_attn_fwd.cu",
    "flash_attn_bwd": "flash_attn_bwd.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    """nvcc from ``$CUDA_HOME/bin``, else ``PATH``, else /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where the named library is built: named by a hash of its source,
    of every header under ``csrc/`` (a source may include any of them) and
    of the flags."""
    digest = hashlib.sha256()
    for path in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` said for the library's last build (registers,
    shared memory, spills per kernel), or "" when it was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def ptxas_summary(report: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of a ``-Xptxas -v`` report: registers, spill bytes
    (stores plus loads), stack frame and static shared memory bytes,
    keyed by the kernel's name with its namespaces and head dim
    (``fwd90::flash_fwd_kernel<128>``)."""
    out: Dict[str, Dict[str, int]] = {}
    kernel = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = _short_name(m.group(1))
            out[kernel] = {"registers": 0, "spill_bytes": 0, "stack": 0, "smem": 0}
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[kernel]["stack"] = int(m.group(1))
            out[kernel]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[kernel]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[kernel]["smem"] = int(smem.group(1)) if smem else 0
    return out


def _short_name(mangled: str) -> str:
    """``_ZN<anon>5fwd9016flash_fwd_kernelILi128EE...`` ->
    ``fwd90::flash_fwd_kernel<128>``: the nested names of an Itanium
    mangled name, without the anonymous namespace, and an integer
    template argument."""
    pos = 3 if mangled.startswith("_ZN") else 2
    names = []
    while pos < len(mangled) and mangled[pos].isdigit():
        digits = re.match(r"\d+", mangled[pos:]).group()
        pos += len(digits)
        names.append(mangled[pos:pos + int(digits)])
        pos += int(digits)
    arg = re.match(r"ILi(\d+)E", mangled[pos:])
    return "::".join(n for n in names if not n.startswith("_GLOBAL__N")) + (
        f"<{arg.group(1)}>" if arg else "")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named library not yet built, one nvcc each, all in
    parallel.  Returns seconds per library built (0.0 when it was already
    there); raises KernelBuildError naming every compile that failed."""
    import time

    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        text, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise KernelBuildError("kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
