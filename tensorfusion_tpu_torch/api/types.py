"""tpu-fusion API objects — the 12 resource kinds of the platform.

The port's copy of ``tensorfusion_tpu/api/types.py``.

TPU-native re-design of the reference's CRD layer (NexusGPU/tensor-fusion
``api/v1/``, one type per table row in SURVEY.md §2.1):

=====================  ==========================================
reference CRD          tpu-fusion kind
=====================  ==========================================
TensorFusionCluster    TPUCluster
GPUPool                TPUPool
GPU                    TPUChip
GPUNode                TPUNode
GPUNodeClass           TPUNodeClass
GPUNodeClaim           TPUNodeClaim
TensorFusionWorkload   TPUWorkload
TensorFusionConnection TPUConnection
WorkloadProfile        WorkloadProfile
SchedulingConfigTemplate SchedulingConfigTemplate
GPUResourceQuota       TPUResourceQuota
ProviderConfig         ProviderConfig
=====================  ==========================================

Vocabulary changes: VRAM->HBM bytes, SM compute percent->MXU duty share,
NVLink peer matrix->ICI mesh links with (x,y,z) coordinates and hop counts,
MIG profiles->TensorCore partition templates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import constants
from .meta import Condition, ObjectMeta, Resource
from .resources import (AutoScalingConfig, GangConfig, QuotaAmounts,
                        ResourceAmount, Resources)

# --------------------------------------------------------------------------
# Pods / nodes (the platform's own workload model — no external k8s here)
# --------------------------------------------------------------------------


@dataclass
class Container:
    name: str = "main"
    image: str = ""
    command: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    ports: List[int] = field(default_factory=list)
    chip_count: int = 0          # chips this container consumes


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    node_name: str = ""          # bound node ("" until scheduled)
    node_selector: Dict[str, str] = field(default_factory=dict)
    scheduler_name: str = "default"
    priority: int = 0
    preemption_policy: str = "PreemptLowerPriority"


@dataclass
class PodStatus:
    phase: str = constants.PHASE_PENDING
    reason: str = ""
    message: str = ""
    host_ip: str = ""
    pod_ip: str = ""
    start_time: float = 0.0
    conditions: List[Condition] = field(default_factory=list)
    nominated_node_name: str = ""


@dataclass
class Pod(Resource):
    KIND = "Pod"
    NAMESPACED = True
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)


@dataclass
class NodeStatus:
    phase: str = constants.PHASE_PENDING
    allocatable_cpu: float = 0.0
    allocatable_memory_bytes: float = 0.0
    addresses: Dict[str, str] = field(default_factory=dict)
    conditions: List[Condition] = field(default_factory=list)


@dataclass
class Node(Resource):
    KIND = "Node"
    NAMESPACED = False
    labels_selector_hash: str = ""
    status: NodeStatus = field(default_factory=NodeStatus)


@dataclass
class Namespace(Resource):
    """Cluster namespace object — carries the labels the webhook's
    auto-migration namespace selector matches against
    (ref: internal/webhook/v1/auto_migration.go:94-106)."""

    KIND = "Namespace"
    NAMESPACED = False


def native_chip_counts(pod: "Pod") -> Dict[str, int]:
    """Per-container native whole-chip requests — the single definition
    shared by the webhook's migration decision, the parser's conversion
    and the scheduler's proxied-pod accounting
    (``HasGPUResourceRequest`` analog, internal/utils/reconcile.go:200)."""
    return {c.name: c.chip_count for c in (pod.spec.containers or [])
            if c.chip_count > 0}


def native_chip_request(pod: "Pod") -> int:
    """Total native chips requested across containers."""
    return sum(native_chip_counts(pod).values())


# --------------------------------------------------------------------------
# TPUCluster  (ref: api/v1/tensorfusioncluster_types.go:25-199)
# --------------------------------------------------------------------------


@dataclass
class ComputingVendorConfig:
    """Cloud vendor connection for node provisioning."""

    name: str = ""               # "gcp" | "aws" | "alibaba" | "mock"
    type: str = "mock"
    auth_type: str = "env"
    region: str = ""
    params: Dict[str, str] = field(default_factory=dict)


@dataclass
class TPUClusterSpec:
    pools: List["TPUPoolSpec"] = field(default_factory=list)
    pool_names: List[str] = field(default_factory=list)
    computing_vendor: ComputingVendorConfig = field(
        default_factory=ComputingVendorConfig)


@dataclass
class TPUClusterStatus:
    phase: str = constants.PHASE_PENDING
    ready_pools: int = 0
    total_pools: int = 0
    total_chips: int = 0
    conditions: List[Condition] = field(default_factory=list)


@dataclass
class TPUCluster(Resource):
    KIND = "TPUCluster"
    NAMESPACED = False
    spec: TPUClusterSpec = field(default_factory=TPUClusterSpec)
    status: TPUClusterStatus = field(default_factory=TPUClusterStatus)


# --------------------------------------------------------------------------
# TPUPool  (ref: api/v1/gpupool_types.go)
# --------------------------------------------------------------------------


def hbm_expansion_ratio(host_mem_percent: float,
                        host_disk_percent: float) -> float:
    """Schedulable-HBM multiplier from the host-expansion percents — the
    single definition shared by the allocator's chip rating and the pool
    status rollup (gpupool_types.go:64-77 analog)."""
    return 1.0 + max(host_mem_percent, 0.0) / 100.0 \
        + max(host_disk_percent, 0.0) / 100.0


@dataclass
class OversubscriptionConfig:
    """(ref: gpupool_types.go:64-85)"""

    tflops_oversell_percent: int = constants.DEFAULT_TFLOPS_OVERSELL_PERCENT
    hbm_expand_to_host_mem_percent: int = \
        constants.DEFAULT_HBM_EXPAND_HOST_MEM_PERCENT
    hbm_expand_to_host_disk_percent: int = \
        constants.DEFAULT_HBM_EXPAND_HOST_DISK_PERCENT

    def hbm_expand_ratio(self) -> float:
        return hbm_expansion_ratio(self.hbm_expand_to_host_mem_percent,
                                   self.hbm_expand_to_host_disk_percent)


@dataclass
class NodeManagerConfig:
    """(ref: gpupool_types.go:115-124)"""

    mode: str = "AutoSelect"     # Provisioned | AutoSelect | Karpenter
    node_selector: Dict[str, str] = field(default_factory=dict)
    node_class: str = ""
    provisioner: str = "mock"


@dataclass
class QosPricing:
    qos: str = constants.QOS_MEDIUM
    requests_per_tflops_hour: float = 0.0
    requests_per_gib_hour: float = 0.0
    limit_over_request_charging_ratio: float = 0.0


@dataclass
class ComponentConfig:
    """Images/versions of injected components + rolling-update policy
    (ref: gpupool_types.go:285-312, 381-455)."""

    client_image: str = "tpufusion/client:latest"
    worker_image: str = "tpufusion/worker:latest"
    hypervisor_image: str = "tpufusion/hypervisor:latest"
    batch_percent: int = 25           # rolling-update batch size
    batch_interval_seconds: float = 60.0
    auto_update: bool = True


@dataclass
class CompactionConfig:
    """Bin-packing reclaim + cron defrag (ref: gpupool_types.go:218-284)."""

    enabled: bool = False
    period_seconds: float = 300.0
    defrag_cron: str = ""             # "m h dom mon dow"; empty disables
    defrag_util_threshold_percent: float = 30.0
    defrag_eviction_ttl_seconds: float = 600.0
    #: defrag drains pre-copy tenants via LiveMigrator.migrate_streaming
    #: (docs/migration.md) instead of blind eviction — per-tenant pause
    #: budgets from the QoS ladder, low-QoS tenants drained first
    streaming_migration: bool = False


@dataclass
class TPUPoolSpec:
    name: str = ""
    generations: List[str] = field(default_factory=list)  # allowed chip gens
    capacity_config: OversubscriptionConfig = field(
        default_factory=OversubscriptionConfig)
    node_manager: NodeManagerConfig = field(default_factory=NodeManagerConfig)
    qos_pricing: List[QosPricing] = field(default_factory=list)
    default_qos: str = constants.DEFAULT_QOS
    components: ComponentConfig = field(default_factory=ComponentConfig)
    compaction: CompactionConfig = field(default_factory=CompactionConfig)
    scheduling_config_template: str = ""


@dataclass
class PoolCapacity:
    total: ResourceAmount = field(default_factory=ResourceAmount)
    virtual: ResourceAmount = field(default_factory=ResourceAmount)  # oversold
    available: ResourceAmount = field(default_factory=ResourceAmount)


@dataclass
class TPUPoolStatus:
    phase: str = constants.PHASE_PENDING
    ready_nodes: int = 0
    total_nodes: int = 0
    total_chips: int = 0
    running_workers: int = 0
    capacity: PoolCapacity = field(default_factory=PoolCapacity)
    component_status: Dict[str, str] = field(default_factory=dict)
    last_compaction_time: float = 0.0
    conditions: List[Condition] = field(default_factory=list)


@dataclass
class TPUPool(Resource):
    KIND = "TPUPool"
    NAMESPACED = False
    spec: TPUPoolSpec = field(default_factory=TPUPoolSpec)
    status: TPUPoolStatus = field(default_factory=TPUPoolStatus)


# --------------------------------------------------------------------------
# TPUChip  (ref: api/v1/gpu_types.go — status-only device record)
# --------------------------------------------------------------------------


@dataclass
class ICILink:
    """One edge of the ICI mesh (replaces the reference's NvLink peer list,
    gpu_types.go:84-130)."""

    peer_chip_id: str = ""
    peer_index: int = -1
    kind: str = "ici"            # self | same-chip | ici | ici-routed | dcn
    hops: int = -1
    gbps: float = 0.0


@dataclass
class MeshCoords:
    x: int = 0
    y: int = 0
    z: int = 0


@dataclass
class ChipPartition:
    template_id: str = ""
    partition_id: str = ""
    workload_key: str = ""       # "<ns>/<pod>" holding this partition
    core_count: int = 0
    hbm_bytes: float = 0.0
    tflops: float = 0.0


@dataclass
class TPUChipStatus:
    phase: str = constants.PHASE_PENDING   # Pending|Provisioning|Running|...
    capacity: ResourceAmount = field(default_factory=ResourceAmount)
    available: ResourceAmount = field(default_factory=ResourceAmount)
    used_by: str = constants.CHIP_USED_BY_TPU_FUSION
    generation: str = ""
    vendor: str = "google-tpu"
    node_name: str = ""
    pool: str = ""
    slice_id: str = ""
    host_index: int = -1
    numa_node: int = -1
    core_count: int = 1
    mesh: MeshCoords = field(default_factory=MeshCoords)
    ici_links: List[ICILink] = field(default_factory=list)
    running_apps: List[str] = field(default_factory=list)   # "<ns>/<pod>"
    partitions: Dict[str, ChipPartition] = field(default_factory=dict)
    capabilities: Dict[str, bool] = field(default_factory=dict)
    message: str = ""


@dataclass
class TPUChip(Resource):
    KIND = "TPUChip"
    NAMESPACED = False
    status: TPUChipStatus = field(default_factory=TPUChipStatus)


# --------------------------------------------------------------------------
# TPUNode  (ref: api/v1/gpunode_types.go:28-127)
# --------------------------------------------------------------------------


@dataclass
class TPUNodeSpec:
    manage_mode: str = "AutoSelect"   # Provisioned | AutoSelect
    pool: str = ""


@dataclass
class TPUNodeStatus:
    phase: str = constants.PHASE_PENDING
    total_chips: int = 0
    available_chips: int = 0
    total_tflops: float = 0.0
    total_hbm_bytes: float = 0.0
    allocated_tflops: float = 0.0
    allocated_hbm_bytes: float = 0.0
    hypervisor_ready: bool = False
    hypervisor_url: str = ""
    node_info: Dict[str, str] = field(default_factory=dict)
    conditions: List[Condition] = field(default_factory=list)


@dataclass
class TPUNode(Resource):
    KIND = "TPUNode"
    NAMESPACED = False
    spec: TPUNodeSpec = field(default_factory=TPUNodeSpec)
    status: TPUNodeStatus = field(default_factory=TPUNodeStatus)


# --------------------------------------------------------------------------
# TPUNodeClass / TPUNodeClaim  (ref: gpunodeclass_types.go, gpunodeclaim_types.go)
# --------------------------------------------------------------------------


@dataclass
class TPUNodeClassSpec:
    provisioner: str = "mock"          # mock | gcp | aws | alibaba
    machine_family: str = "ct5lp"      # e.g. GCP TPU VM families
    image: str = ""
    zone: str = ""
    capacity_type: str = "on-demand"   # on-demand | spot
    params: Dict[str, str] = field(default_factory=dict)


@dataclass
class TPUNodeClass(Resource):
    KIND = "TPUNodeClass"
    NAMESPACED = False
    spec: TPUNodeClassSpec = field(default_factory=TPUNodeClassSpec)


@dataclass
class TPUNodeClaimSpec:
    node_class: str = ""
    pool: str = ""
    instance_type: str = ""
    generation: str = "v5e"
    chip_count: int = 8
    zone: str = ""
    capacity_type: str = "on-demand"


@dataclass
class TPUNodeClaimStatus:
    phase: str = constants.PHASE_PENDING
    node_name: str = ""
    instance_id: str = ""
    message: str = ""


@dataclass
class TPUNodeClaim(Resource):
    KIND = "TPUNodeClaim"
    NAMESPACED = False
    spec: TPUNodeClaimSpec = field(default_factory=TPUNodeClaimSpec)
    status: TPUNodeClaimStatus = field(default_factory=TPUNodeClaimStatus)


# --------------------------------------------------------------------------
# WorkloadProfile  (ref: api/v1/workloadprofile_types.go:37-174)
# --------------------------------------------------------------------------


@dataclass
class WorkloadProfileSpec:
    pool: str = ""
    resources: Resources = field(default_factory=Resources)
    qos: str = ""                     # low|medium|high|critical
    isolation: str = constants.DEFAULT_ISOLATION
    is_local_tpu: bool = False        # client shares the node with the chips
    sidecar_worker: bool = False
    embedded_worker: bool = False
    dedicated_worker: bool = False
    chip_count: int = 1               # 1..128 chips per worker
    generation: str = ""
    vendor: str = ""
    chip_indices: List[int] = field(default_factory=list)
    partition_template: str = ""
    auto_scaling: AutoScalingConfig = field(default_factory=AutoScalingConfig)
    node_affinity: Dict[str, str] = field(default_factory=dict)
    #: nodes the workload's workers must avoid (stamped by defrag while a
    #: node is being drained; cleared after the eviction TTL)
    excluded_nodes: List[str] = field(default_factory=list)
    gang: GangConfig = field(default_factory=GangConfig)


@dataclass
class WorkloadProfile(Resource):
    KIND = "WorkloadProfile"
    NAMESPACED = True
    spec: WorkloadProfileSpec = field(default_factory=WorkloadProfileSpec)


# --------------------------------------------------------------------------
# TPUWorkload  (ref: api/v1/tensorfusionworkload_types.go)
# --------------------------------------------------------------------------


@dataclass
class TPUWorkloadSpec(WorkloadProfileSpec):
    replicas: int = 1
    dynamic_replicas: bool = False    # replicas follow connection count


@dataclass
class GangStatus:
    group_key: str = ""
    desired_members: int = 0
    required_members: int = 0
    scheduled_members: int = 0
    phase: str = ""                   # Pending | Scheduled | Timeout
    last_transition: float = 0.0


@dataclass
class TPUWorkloadStatus:
    phase: str = constants.PHASE_PENDING
    replicas: int = 0
    ready_replicas: int = 0
    worker_count: int = 0
    gang: GangStatus = field(default_factory=GangStatus)
    conditions: List[Condition] = field(default_factory=list)


@dataclass
class TPUWorkload(Resource):
    KIND = "TPUWorkload"
    NAMESPACED = True
    spec: TPUWorkloadSpec = field(default_factory=TPUWorkloadSpec)
    status: TPUWorkloadStatus = field(default_factory=TPUWorkloadStatus)


# --------------------------------------------------------------------------
# TPUConnection  (ref: api/v1/tensorfusionconnection_types.go:64-104)
# --------------------------------------------------------------------------


@dataclass
class TPUConnectionSpec:
    workload: str = ""
    client_pod: str = ""


@dataclass
class TPUConnectionStatus:
    phase: str = constants.PHASE_PENDING
    worker_name: str = ""
    #: uid of the bound worker POD, not just its name: a worker that is
    #: killed and recreated under the same name is a DIFFERENT peer
    #: (fresh process, possibly a fresh port) — the binding must be
    #: re-picked, which a name-only health check cannot see
    worker_uid: str = ""
    worker_url: str = ""


@dataclass
class TPUConnection(Resource):
    KIND = "TPUConnection"
    NAMESPACED = True
    spec: TPUConnectionSpec = field(default_factory=TPUConnectionSpec)
    status: TPUConnectionStatus = field(default_factory=TPUConnectionStatus)


# --------------------------------------------------------------------------
# SchedulingConfigTemplate  (ref: api/v1/schedulingconfigtemplate_types.go)
# --------------------------------------------------------------------------


@dataclass
class ERLParameters:
    """Elastic-rate-limit PID controller knobs
    (ref: schedulingconfigtemplate_types.go:287-308).

    Defaults chosen by the tuning harness (benchmarks/erl_tuning.py,
    artifact benchmarks/results/erl_tuning.json): across sustained/
    burst/QoS-mix contention sweeps of (kp, ki, kd, burst_window),
    kp=1.0 ki=0.05 kd=0.0 converges every transient in <=0.3s with
    <5% overshoot and stays stable under +-8% measured-duty noise —
    derivative action amplifies that noise (kd=0.05 at kp=1.0 fails to
    settle), so it ships off; the smoothing filter already provides
    the damping."""

    kp: float = 1.0
    ki: float = 0.05
    kd: float = 0.0
    integral_decay: float = 0.95
    slew_max_step_percent: float = 20.0
    burst_window_seconds: float = 2.0
    min_refill_fraction: float = 0.05   # floor as fraction of quota rate
    max_burst_multiple: float = 3.0     # bucket cap = quota * multiple
    update_interval_ms: int = 100


@dataclass
class AutoFreezeRule:
    qos: str = constants.QOS_LOW
    enabled: bool = True
    freeze_to_mem_ttl_seconds: float = 60.0
    freeze_to_disk_ttl_seconds: float = 600.0
    resume_latency_budget_ms: int = 2000


@dataclass
class HypervisorScheduling:
    auto_freeze: List[AutoFreezeRule] = field(default_factory=list)
    multiprocess_queuing_coefficients: Dict[str, float] = field(
        default_factory=lambda: {constants.QOS_LOW: 1.0,
                                 constants.QOS_MEDIUM: 2.0,
                                 constants.QOS_HIGH: 4.0,
                                 constants.QOS_CRITICAL: 8.0})
    erl: ERLParameters = field(default_factory=ERLParameters)


@dataclass
class TopologyConfig:
    """ICI-mesh topology scheduling knobs (replaces the reference's
    NUMA/NVLink GPUNetworkTopologyAwareConfig, internal/config/scheduler_config.go:10-71)."""

    enabled: bool = True
    source: str = "auto"          # auto | mesh | none
    max_allowed_hops: int = -1    # -1 unlimited
    unknown_topology_policy: str = "allow"   # allow | reject
    prefer_contiguous_submesh: bool = True


@dataclass
class VerticalScalingRule:
    metric: str = "tflops"        # tflops | hbm
    scale_up_threshold_percent: float = 90.0
    scale_down_threshold_percent: float = 30.0
    scale_step_percent: float = 20.0


@dataclass
class SchedulingConfigTemplateSpec:
    placement_mode: str = "CompactFirst"  # CompactFirst | LowLoadFirst | NodeCompactChipLowLoad
    topology: TopologyConfig = field(default_factory=TopologyConfig)
    chip_filters: List[Dict] = field(default_factory=list)
    vertical_scaling: List[VerticalScalingRule] = field(default_factory=list)
    rebalancer_enabled: bool = False
    hypervisor: HypervisorScheduling = field(
        default_factory=HypervisorScheduling)


@dataclass
class SchedulingConfigTemplate(Resource):
    KIND = "SchedulingConfigTemplate"
    NAMESPACED = False
    spec: SchedulingConfigTemplateSpec = field(
        default_factory=SchedulingConfigTemplateSpec)


# --------------------------------------------------------------------------
# TPUResourceQuota  (ref: api/v1/gpuresourcequota_types.go:26-131)
# --------------------------------------------------------------------------


@dataclass
class TPUResourceQuotaSpec:
    total: QuotaAmounts = field(default_factory=QuotaAmounts)
    single: QuotaAmounts = field(default_factory=QuotaAmounts)


@dataclass
class TPUResourceQuotaStatus:
    used_requests: ResourceAmount = field(default_factory=ResourceAmount)
    used_limits: ResourceAmount = field(default_factory=ResourceAmount)
    used_workers: int = 0
    conditions: List[Condition] = field(default_factory=list)


@dataclass
class TPUResourceQuota(Resource):
    KIND = "TPUResourceQuota"
    NAMESPACED = True
    spec: TPUResourceQuotaSpec = field(default_factory=TPUResourceQuotaSpec)
    status: TPUResourceQuotaStatus = field(
        default_factory=TPUResourceQuotaStatus)


# --------------------------------------------------------------------------
# ProviderConfig  (ref: api/v1/providerconfig_types.go)
# --------------------------------------------------------------------------


@dataclass
class ChipModelInfo:
    """Hardware metadata per chip generation
    (ref: providerconfig_types.go:133-176)."""

    generation: str = ""
    cores: int = 1
    hbm_bytes: float = 0.0
    bf16_tflops: float = 0.0
    int8_tops: float = 0.0
    hbm_gbps: float = 0.0
    ici_gbps: float = 0.0
    cost_per_hour: float = 0.0


@dataclass
class PartitionTemplateSpec:
    """Virtualization (partition) template (ref: providerconfig_types.go:197-279)."""

    template_id: str = ""
    generation: str = ""
    core_count: int = 1
    hbm_bytes: float = 0.0
    tflops: float = 0.0
    slots: int = 1
    isolation_group: str = ""


@dataclass
class DeviceMountRule:
    """Predicate-gated device-node mount rule (the reference uses CEL,
    providerconfig_types.go:59-114; here a simple expression on the worker
    context evaluated by hypervisor/device mount policy)."""

    expression: str = "True"      # python expression over {isolation, partitioned, qos}
    host_paths: List[str] = field(default_factory=list)
    partitioned_only: bool = False


@dataclass
class ProviderConfigSpec:
    vendor: str = "mock-tpu"
    provider_lib: str = ""        # path/name of libtpf_provider_*.so
    limiter_lib: str = ""
    remote_client_image: str = ""
    remote_worker_image: str = ""
    hypervisor_env: Dict[str, str] = field(default_factory=dict)
    host_path_mounts: List[str] = field(default_factory=list)
    device_mount_rules: List[DeviceMountRule] = field(default_factory=list)
    chip_models: List[ChipModelInfo] = field(default_factory=list)
    partition_templates: List[PartitionTemplateSpec] = field(
        default_factory=list)
    in_use_resource_names: List[str] = field(default_factory=list)


@dataclass
class ProviderConfig(Resource):
    KIND = "ProviderConfig"
    NAMESPACED = False
    spec: ProviderConfigSpec = field(default_factory=ProviderConfigSpec)


@dataclass
class LeaseSpec:
    """Distributed-lease record (coordination.k8s.io/Lease analog) used
    for cross-host leader election through the store gateway
    (cmd/main.go:785-812 leader-info ConfigMap parity).  The fencing
    token increments on every leadership transition, so downstream
    writers can reject actions from a deposed leader that doesn't yet
    know it lost."""

    holder: str = ""
    holder_url: str = ""          # leader endpoint followers redirect to
    lease_duration_s: float = 10.0
    renew_time: float = 0.0       # holder's wall clock at last renewal
    fencing_token: int = 0
    transitions: int = 0


@dataclass
class Lease(Resource):
    KIND = "Lease"
    NAMESPACED = False
    spec: LeaseSpec = field(default_factory=LeaseSpec)


ALL_KINDS = [TPUCluster, TPUPool, TPUChip, TPUNode, TPUNodeClass,
             TPUNodeClaim, TPUWorkload, TPUConnection, WorkloadProfile,
             SchedulingConfigTemplate, TPUResourceQuota, ProviderConfig,
             Pod, Node, Namespace, Lease]
