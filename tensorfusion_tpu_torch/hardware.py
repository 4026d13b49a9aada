"""What the port knows of the card it runs on: the datasheet's peak rates,
and the card's name and power limit as ``nvidia-smi`` reports them.

Both are read only where a result names its device: ``chip_smoke.py``'s
bounds, ``bench_train``'s MFU.
"""

from __future__ import annotations

import subprocess
from typing import Dict

#: (match in the device name, bf16 dense FLOP/s, int8 dense OP/s, memory
#: bytes/s), from NVIDIA's H100 datasheet; the first match wins.  The NVML
#: provider (hypervisor/csrc/provider_nvml.c) carries the same table.
PEAKS = (
    ("H100 PCIe", 756e12, 1513e12, 2.0e12),
    ("H100 NVL", 835e12, 1671e12, 3.9e12),
    ("H100", 989e12, 1979e12, 3.35e12),      # SXM
)


def peak_rates(name: str) -> Dict[str, float]:
    """{"bf16": FLOP/s, "int8": OP/s, "bytes": bytes/s} of the card called
    ``name`` (``torch.cuda.get_device_name``); raises for a card not in the
    table."""
    for key, bf16, int8, mem in PEAKS:
        if key in name:
            return {"bf16": bf16, "int8": int8, "bytes": mem}
    raise RuntimeError(f"no peak rates known for {name!r}")


def nvidia_smi() -> str:
    """The first card's ``name, power.limit`` line from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
