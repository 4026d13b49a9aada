"""Shared resource primitives.

The port's copy of ``tensorfusion_tpu/api/resources.py``.

TPU analog of the reference's shared CRD primitives
(``api/v1/tensorfusionconnection_types.go:31-40`` ``Resource{Tflops,
ComputePercent, Vram}`` and ``api/v1/gpuresourcequota_types.go:168-229``
``AllocRequest``/``AdjustRequest``): a fractional vTPU is requested as MXU
TFLOPs (or a duty-cycle percentage) plus an HBM byte budget, at 1-TFLOP /
1%-duty / 1-MiB granularity.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_QUANTITY_RE = re.compile(r"^\s*([0-9.]+)\s*([a-zA-Z]*)\s*$")

_SUFFIX = {
    "": 1,
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
}


def parse_quantity(s) -> float:
    """Parse a k8s-style quantity ('16Gi', '100', '1.5T') into a float."""
    if isinstance(s, (int, float)):
        return float(s)
    m = _QUANTITY_RE.match(str(s))
    if not m:
        raise ValueError(f"invalid quantity: {s!r}")
    value, suffix = m.groups()
    if suffix not in _SUFFIX:
        raise ValueError(f"invalid quantity suffix: {s!r}")
    return float(value) * _SUFFIX[suffix]


def format_bytes(n: float) -> str:
    for suffix, mult in (("Ti", 2**40), ("Gi", 2**30), ("Mi", 2**20),
                         ("Ki", 2**10)):
        if n >= mult and n % mult == 0:
            return f"{n // mult:.0f}{suffix}"
    return f"{n:.0f}"


@dataclass
class ResourceAmount:
    """One fractional-vTPU quantity: MXU TFLOPs + duty share + HBM bytes.

    ``tflops`` and ``duty_percent`` are alternative expressions of the same
    compute share; the allocator normalizes whichever was given against the
    chip generation's peak (see allocator/store.py).
    """

    tflops: float = 0.0
    duty_percent: float = 0.0   # 0-100 share of one chip's MXU time
    hbm_bytes: float = 0.0

    def add(self, other: "ResourceAmount") -> "ResourceAmount":
        return ResourceAmount(self.tflops + other.tflops,
                              self.duty_percent + other.duty_percent,
                              self.hbm_bytes + other.hbm_bytes)

    def sub(self, other: "ResourceAmount") -> "ResourceAmount":
        return ResourceAmount(self.tflops - other.tflops,
                              self.duty_percent - other.duty_percent,
                              self.hbm_bytes - other.hbm_bytes)

    def scale(self, k: float) -> "ResourceAmount":
        return ResourceAmount(self.tflops * k, self.duty_percent * k,
                              self.hbm_bytes * k)

    def fits_in(self, other: "ResourceAmount") -> bool:
        return (self.tflops <= other.tflops + 1e-9
                and self.hbm_bytes <= other.hbm_bytes + 1e-9)

    def is_zero(self) -> bool:
        return self.tflops == 0 and self.duty_percent == 0 \
            and self.hbm_bytes == 0


@dataclass
class Resources:
    requests: ResourceAmount = field(default_factory=ResourceAmount)
    limits: ResourceAmount = field(default_factory=ResourceAmount)


@dataclass
class GangConfig:
    """Gang-scheduling knobs (analog of GangSchedulingConfig,
    ``api/v1/workloadprofile_types.go:127-148``)."""

    enabled: bool = False
    min_members: int = 0          # quorum; 0 -> all desired members
    timeout_seconds: float = 0.0  # 0 -> wait indefinitely
    strict: bool = False          # reject whole group when a member fails


@dataclass
class AutoScalingConfig:
    enabled: bool = False
    recommender: str = "percentile"   # percentile | cron | external
    target_resource: str = "all"      # tflops | hbm | all
    percentile: float = 90.0
    margin_fraction: float = 0.15
    cron_rules: List[Dict] = field(default_factory=list)
    external_url: str = ""
    #: dynamic-replica workloads: how long the connection count must stay
    #: at zero before the last worker is released (autoscale-to-zero)
    scale_to_zero_grace_seconds: float = 60.0
    #: serving fan-in: connections one worker absorbs before another is
    #: added (dynamic replicas = ceil(connections / this))
    connections_per_worker: int = 1


@dataclass
class AllocRequest:
    """A single allocation request presented to the allocator
    (analog of ``api/v1/gpuresourcequota_types.go:168-203``)."""

    pool: str = ""
    namespace: str = ""
    workload_name: str = ""
    pod_name: str = ""
    request: ResourceAmount = field(default_factory=ResourceAmount)
    limit: ResourceAmount = field(default_factory=ResourceAmount)
    chip_count: int = 1
    generation: str = ""        # required chip generation ("v5e", ...)
    vendor: str = ""
    chip_indices: List[int] = field(default_factory=list)
    isolation: str = "soft"
    qos: str = "medium"
    partition_template: str = ""
    node_affinity: Dict[str, str] = field(default_factory=dict)
    excluded_nodes: List[str] = field(default_factory=list)  # defrag/migration
    same_node: bool = True      # multi-chip must land on one node
    #: whole-chip exclusivity: nothing may colocate with this hold and it
    #: requires an empty chip (native pods, dedicated-chip workloads) —
    #: overrides oversubscription entirely
    exclusive: bool = False
    gang: GangConfig = field(default_factory=GangConfig)

    def key(self) -> str:
        return f"{self.namespace}/{self.pod_name}"


@dataclass
class AdjustRequest:
    """Live vertical-resize request (analog of AdjustRequest,
    ``api/v1/gpuresourcequota_types.go:205-229``)."""

    namespace: str = ""
    pod_name: str = ""
    new_request: ResourceAmount = field(default_factory=ResourceAmount)
    new_limit: ResourceAmount = field(default_factory=ResourceAmount)
    is_scale_up: bool = True


@dataclass
class QuotaAmounts:
    """Per-namespace quota totals."""

    requests: ResourceAmount = field(default_factory=ResourceAmount)
    limits: ResourceAmount = field(default_factory=ResourceAmount)
    max_workers: int = 0        # 0 = unlimited
    alert_threshold_percent: float = 95.0
