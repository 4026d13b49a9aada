"""Static chip-model metadata DB: the port's copy of
tensorfusion_tpu/config/chip_info.py, with the H100 rows beside the TPU
rows.

Analog of the reference's ``internal/config/gpu_info.go`` (static GPU model
DB with fp16 TFLOPS + cost): per-generation hardware facts used by the
parser's duty<->tflops normalization, the expander's instance choice, and
billing.  ``mock_chip_info`` mirrors the reference's MockGpuInfo test hook.

The H100 rows are keyed by the NVML provider's generation strings
(hypervisor/csrc/provider_nvml.c, ``kGens``) and carry its figures, which
are ``hardware.PEAKS``': NVIDIA's H100 datasheet, dense bf16 and int8, HBM
bandwidth, memory size, and NVLink bandwidth per direction (SXM 900 GB/s,
PCIe and NVL 600 GB/s over their bridges, both directions together).  No
public price list is named here, so their cost_per_hour stays 0.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..api.types import ChipModelInfo

CHIP_INFO_DB: Dict[str, ChipModelInfo] = {
    "v4": ChipModelInfo(generation="v4", cores=2, hbm_bytes=32 << 30,
                        bf16_tflops=275.0, int8_tops=275.0,
                        hbm_gbps=1228.0, ici_gbps=50.0,
                        cost_per_hour=3.22),
    "v5e": ChipModelInfo(generation="v5e", cores=1, hbm_bytes=16 << 30,
                         bf16_tflops=197.0, int8_tops=394.0,
                         hbm_gbps=819.0, ici_gbps=50.0,
                         cost_per_hour=1.20),
    "v5p": ChipModelInfo(generation="v5p", cores=2, hbm_bytes=95 << 30,
                         bf16_tflops=459.0, int8_tops=918.0,
                         hbm_gbps=2765.0, ici_gbps=100.0,
                         cost_per_hour=4.20),
    "v6e": ChipModelInfo(generation="v6e", cores=1, hbm_bytes=32 << 30,
                         bf16_tflops=918.0, int8_tops=1836.0,
                         hbm_gbps=1640.0, ici_gbps=100.0,
                         cost_per_hour=2.70),
    "h100-sxm": ChipModelInfo(generation="h100-sxm", cores=1, hbm_bytes=80 << 30,
                              bf16_tflops=989.0, int8_tops=1979.0,
                              hbm_gbps=3350.0, ici_gbps=450.0),
    "h100-pcie": ChipModelInfo(generation="h100-pcie", cores=1, hbm_bytes=80 << 30,
                               bf16_tflops=756.0, int8_tops=1513.0,
                               hbm_gbps=2000.0, ici_gbps=300.0),
    "h100-nvl": ChipModelInfo(generation="h100-nvl", cores=1, hbm_bytes=94 << 30,
                              bf16_tflops=835.0, int8_tops=1671.0,
                              hbm_gbps=3900.0, ici_gbps=300.0),
}


def chip_info(generation: str) -> Optional[ChipModelInfo]:
    return CHIP_INFO_DB.get(generation)


def mock_chip_info() -> Dict[str, ChipModelInfo]:
    """Test fixture (MockGpuInfo analog)."""
    return dict(CHIP_INFO_DB)
