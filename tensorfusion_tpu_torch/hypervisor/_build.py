"""Build the NVML provider (``csrc/provider_nvml.c``) with the host C
compiler and find it.

``provider_path()`` compiles it at first use with ``cc -std=c11 -O2
-shared -fPIC ... -ldl`` into ``build/hypervisor/`` at the repository root
(listed in ``.gitignore``), named by a hash of its sources and the flags,
as the kernels are (``ops/_build.py``).  A failed compile raises; there is
no fallback.  ``build_fake_nvml`` builds the tests' stand-in NVML, and
``check_nvml_layout`` holds the provider's hand-declared NVML types against
the CUDA toolkit's ``nvml.h`` where one is installed.
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


def _compile(source: Path, out: Path, flags: Iterable[str]) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cc_path(), *CFLAGS, *flags, "-o", str(tmp), str(source), *LIBS]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise ProviderBuildError(f"{source.name} did not build:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)


def provider_path() -> Path:
    """The NVML provider library, built at first use."""
    digest = hashlib.sha256()
    for path in (CSRC / "provider_nvml.c", CSRC / "provider.h", CSRC / "nvml_types.h"):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join(CFLAGS + LIBS).encode())
    out = BUILD_DIR / f"libtpf_provider_nvml-{digest.hexdigest()[:16]}.so"
    with _lock:
        if not out.exists():
            _compile(CSRC / "provider_nvml.c", out, ())
    return out


def build_fake_nvml(out_dir: Path, omit_uuid: bool = False) -> Path:
    """Build ``csrc/fake_nvml.c`` as ``<out_dir>/libnvidia-ml.so.1`` (or,
    with ``omit_uuid``, a copy lacking ``nvmlDeviceGetUUID``)."""
    out = Path(out_dir) / ("libnvidia-ml-nouuid.so.1" if omit_uuid
                           else "libnvidia-ml.so.1")
    _compile(CSRC / "fake_nvml.c", out,
             ("-DFAKE_NVML_OMIT_UUID",) if omit_uuid else ())
    return out


def nvml_header() -> Optional[Path]:
    """The CUDA toolkit's ``nvml.h``, or None where there is none."""
    roots = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in filter(None, roots):
        for sub in ("include", "targets/x86_64-linux/include"):
            header = Path(root) / sub / "nvml.h"
            if header.is_file():
                return header
    return None


def check_nvml_layout() -> Path:
    """Compile ``csrc/nvml_layout_check.c`` against the toolkit's
    ``nvml.h``: its static assertions fail on any size, offset or constant
    of ``nvml_types.h`` that differs.  Returns the header's path; raises
    where there is no header or the check fails."""
    header = nvml_header()
    if header is None:
        raise ProviderBuildError("no nvml.h under $CUDA_HOME or /usr/local/cuda")
    cmd = [cc_path(), "-std=c11", "-fsyntax-only", f"-I{header.parent}",
           str(CSRC / "nvml_layout_check.c")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        raise ProviderBuildError(
            f"nvml_types.h disagrees with {header}:\n{r.stdout}{r.stderr}")
    return header
