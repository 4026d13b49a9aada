"""Typed API objects for the tpu-fusion control plane: the port's copy of
``tensorfusion_tpu/api/``, with the same kinds, field names and JSON forms."""

from .meta import Condition, ObjectMeta, Resource, from_dict, set_condition, to_dict
from .resources import (AdjustRequest, AllocRequest, AutoScalingConfig,
                        GangConfig, QuotaAmounts, ResourceAmount, Resources,
                        format_bytes, parse_quantity)
from .types import (ALL_KINDS, AutoFreezeRule, ChipModelInfo, ChipPartition,
                    ComponentConfig, CompactionConfig, ComputingVendorConfig,
                    Container, DeviceMountRule, ERLParameters, GangStatus,
                    HypervisorScheduling, ICILink, MeshCoords, Namespace, Node,
                    NodeManagerConfig, NodeStatus, OversubscriptionConfig,
                    PartitionTemplateSpec, Pod, PodSpec,
                    PodStatus, PoolCapacity, ProviderConfig,
                    ProviderConfigSpec, QosPricing, SchedulingConfigTemplate,
                    SchedulingConfigTemplateSpec, TopologyConfig, TPUChip,
                    TPUChipStatus, TPUCluster, TPUClusterSpec,
                    TPUClusterStatus, TPUConnection, TPUConnectionSpec,
                    TPUConnectionStatus, TPUNode, TPUNodeClaim,
                    TPUNodeClaimSpec, TPUNodeClaimStatus, TPUNodeClass,
                    TPUNodeClassSpec, TPUNodeSpec, TPUNodeStatus, TPUPool,
                    TPUPoolSpec, TPUPoolStatus, TPUResourceQuota,
                    TPUResourceQuotaSpec, TPUResourceQuotaStatus, TPUWorkload,
                    TPUWorkloadSpec, TPUWorkloadStatus, VerticalScalingRule,
                    WorkloadProfile, WorkloadProfileSpec)
