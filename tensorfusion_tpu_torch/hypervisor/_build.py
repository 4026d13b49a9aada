"""Build the node agent's C libraries with the host C compiler and find
them: the NVML provider (``csrc/provider_nvml.c``) and the launch and
memory hook that metering puts into every worker's ``LD_PRELOAD``
(``csrc/cuda_hook.c``).

``provider_path()`` and ``cuda_hook_path()`` compile at first use with
``cc -std=c11 -O2 -shared -fPIC ... -ldl`` into ``build/hypervisor/`` at
the repository root (listed in ``.gitignore``), named by a hash of their
sources and the flags, as the kernels are (``ops/_build.py``).  A failed
compile raises; there is no fallback.  ``build_fake_nvml`` and
``build_fake_cuda`` build the tests' stand-in NVML and CUDA driver,
``build_cuda_hook_selftest`` the hook's C selftest, and
``check_nvml_layout`` / ``check_cuda_layout`` hold the hand-declared
driver types against the CUDA toolkit's ``nvml.h`` / ``cuda.h`` where one
is installed.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hypervisor"

CFLAGS = ("-std=c11", "-O2", "-Wall", "-shared", "-fPIC")
LIBS = ("-ldl", "-lpthread")

_lock = threading.Lock()


class ProviderBuildError(RuntimeError):
    pass


def cc_path() -> str:
    """The host C compiler, ``cc`` on PATH."""
    cc = shutil.which("cc")
    if not cc:
        raise ProviderBuildError("no C compiler: cc is not on PATH")
    return cc


def _compile(source: Path, out: Path, flags: Iterable[str],
             cflags: Iterable[str] = CFLAGS) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cc_path(), *cflags, *flags, "-o", str(tmp), str(source), *LIBS]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise ProviderBuildError(f"{source.name} did not build:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)


def _built(name: str, source: str, headers: Iterable[str]) -> Path:
    """``build/hypervisor/lib<name>-<hash>.so`` from ``csrc/<source>``,
    compiled unless a build of the same sources and flags is there."""
    digest = hashlib.sha256()
    for path in (CSRC / source, *(CSRC / h for h in headers)):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join(CFLAGS + LIBS).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    with _lock:
        if not out.exists():
            _compile(CSRC / source, out, ())
    return out


def provider_path() -> Path:
    """The NVML provider library, built at first use."""
    return _built("tpf_provider_nvml", "provider_nvml.c", ("provider.h", "nvml_types.h"))


def cuda_hook_path() -> Path:
    """The launch and memory hook (``libtpf_cuda_hook``), built at first
    use."""
    return _built("tpf_cuda_hook", "cuda_hook.c", ("cuda_types.h",))


def build_fake_nvml(out_dir: Path, omit_uuid: bool = False) -> Path:
    """Build ``csrc/fake_nvml.c`` as ``<out_dir>/libnvidia-ml.so.1`` (or,
    with ``omit_uuid``, a copy lacking ``nvmlDeviceGetUUID``)."""
    out = Path(out_dir) / ("libnvidia-ml-nouuid.so.1" if omit_uuid
                           else "libnvidia-ml.so.1")
    _compile(CSRC / "fake_nvml.c", out,
             ("-DFAKE_NVML_OMIT_UUID",) if omit_uuid else ())
    return out


def build_fake_cuda(out_dir: Path) -> Path:
    """Build ``csrc/fake_cuda.c`` as ``<out_dir>/libcuda.so.1``: put the
    directory on ``LD_LIBRARY_PATH`` and it is the process's driver."""
    out = Path(out_dir) / "libcuda.so.1"
    _compile(CSRC / "fake_cuda.c", out, ())
    return out


def build_cuda_hook_selftest(out_dir: Path) -> Path:
    """Build ``csrc/cuda_hook_selftest.c`` as ``<out_dir>/cuda_hook_selftest``."""
    out = Path(out_dir) / "cuda_hook_selftest"
    _compile(CSRC / "cuda_hook_selftest.c", out, (), cflags=("-std=c11", "-O2", "-Wall"))
    return out


def _header(name: str) -> Optional[Path]:
    """The CUDA toolkit's header ``name``, or None where there is none."""
    roots = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in filter(None, roots):
        for sub in ("include", "targets/x86_64-linux/include"):
            header = Path(root) / sub / name
            if header.is_file():
                return header
    return None


def _check_layout(header_name: str, check: str, types: str) -> Path:
    header = _header(header_name)
    if header is None:
        raise ProviderBuildError(f"no {header_name} under $CUDA_HOME or /usr/local/cuda")
    cmd = [cc_path(), "-std=c11", "-fsyntax-only", f"-I{header.parent}", str(CSRC / check)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        raise ProviderBuildError(f"{types} disagrees with {header}:\n{r.stdout}{r.stderr}")
    return header


def check_nvml_layout() -> Path:
    """Compile ``csrc/nvml_layout_check.c`` against the toolkit's
    ``nvml.h``: its static assertions fail on any size, offset or constant
    of ``nvml_types.h`` that differs.  Returns the header's path; raises
    where there is no header or the check fails."""
    return _check_layout("nvml.h", "nvml_layout_check.c", "nvml_types.h")


def check_cuda_layout() -> Path:
    """Compile ``csrc/cuda_layout_check.c`` against the toolkit's
    ``cuda.h``, as ``check_nvml_layout`` does for ``cuda_types.h``."""
    return _check_layout("cuda.h", "cuda_layout_check.c", "cuda_types.h")
