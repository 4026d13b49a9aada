"""Environment names the port's client, remote worker, tracer, profiler
and node agent read, the QoS ladder its serving engine and dispatcher
schedule by, the node agent's isolation modes and worker phases, and the
pod annotations, labels, port ranges and pool defaults its control plane
(node agent, admission webhook, scheduler and allocator) reads and stamps
(the same contract as the JAX package's; see tensorfusion_tpu/constants.py:
these strings cross the wire between the two).  The one name that differs is
the visible-device variable: CUDA's."""

import os

#: the annotation domain, configurable as the reference's is
DOMAIN_PREFIX = os.environ.get("TPF_DOMAIN_PREFIX", "tpu-fusion")
DOMAIN_SUFFIX = os.environ.get("TPF_DOMAIN_SUFFIX", "ai")
DOMAIN = f"{DOMAIN_PREFIX}.{DOMAIN_SUFFIX}"

#: pod annotations the node agent turns into a worker (the webhook and the
#: scheduler write them)
ANN_TFLOPS_REQUEST = f"{DOMAIN}/tflops-request"
ANN_HBM_REQUEST = f"{DOMAIN}/hbm-request"
ANN_DUTY_REQUEST = f"{DOMAIN}/duty-percent-request"   # duty share 0-100
ANN_QOS = f"{DOMAIN}/qos"
ANN_ISOLATION = f"{DOMAIN}/isolation"
ANN_CHIP_IDS = f"{DOMAIN}/chip-ids"              # comma-joined allocated ids
ANN_PARTITION_NAME = f"{DOMAIN}/partition"       # template id, partitioned mode

#: the scheduler a mutated pod is routed to
SCHEDULER_NAME = f"{DOMAIN_PREFIX}-scheduler"

LABEL_MANAGED_BY = f"{DOMAIN}/managed-by"
LABEL_ENABLED = f"{DOMAIN}/enabled"
LABEL_HOST_PORT = f"{DOMAIN}/host-port"          # value "auto" requests one
LABEL_HOST_PORT_AUTO = "auto"

#: the user's request annotations (parsed by admission)
ANN_POOL = f"{DOMAIN}/pool"
ANN_WORKLOAD = f"{DOMAIN}/workload"
ANN_WORKLOAD_PROFILE = f"{DOMAIN}/workload-profile"
ANN_ENABLED_REPLICAS = f"{DOMAIN}/enabled-replicas"
ANN_TFLOPS_LIMIT = f"{DOMAIN}/tflops-limit"
ANN_HBM_LIMIT = f"{DOMAIN}/hbm-limit"
ANN_DUTY_LIMIT = f"{DOMAIN}/duty-percent-limit"
ANN_CHIP_COUNT = f"{DOMAIN}/chip-count"
ANN_CHIP_INDICES = f"{DOMAIN}/chip-indices"
ANN_CHIP_GENERATION = f"{DOMAIN}/generation"     # e.g. "v5e", "h100-sxm"
ANN_VENDOR = f"{DOMAIN}/vendor"
ANN_IS_LOCAL_TPU = f"{DOMAIN}/is-local-tpu"
ANN_DEDICATED_CHIP = f"{DOMAIN}/dedicated-chip"
ANN_DEDICATED_WORKER = f"{DOMAIN}/dedicated-worker"
ANN_EMBEDDED_WORKER = f"{DOMAIN}/embedded-worker"
ANN_SIDECAR_WORKER = f"{DOMAIN}/sidecar-worker"
ANN_INJECT_CONTAINER = f"{DOMAIN}/inject-container"
ANN_EVICTION_PROTECTION = f"{DOMAIN}/eviction-protection"
ANN_EXCLUDED_NODES = f"{DOMAIN}/excluded-nodes"  # defrag/migration rebinds
ANN_AUTOSCALE = f"{DOMAIN}/autoscale"
ANN_AUTOSCALE_TARGET = f"{DOMAIN}/autoscale-target"
ANN_PORT_NUMBER = f"{DOMAIN}/port-number"

#: what the webhook, the scheduler and the allocator stamp
ANN_CONTAINER_CHIP_COUNT = f"{DOMAIN}/container-chip-count"
ANN_POD_INDEX = f"{DOMAIN}/index"
ANN_PARTITION_IDS = f"{DOMAIN}/partition-ids"    # json: chip id -> instance id
ANN_POD_COUNTER_KEY = f"{DOMAIN}/pod-counter-key"
#: pod-lifecycle trace context, ``trace_id:span_id``, stamped by admission
ANN_TRACE_CONTEXT = f"{DOMAIN}/trace"

#: gang scheduling (scheduler/gang.py)
ANN_GANG_ENABLED = f"{DOMAIN}/gang-enabled"
ANN_GANG_MIN_MEMBERS = f"{DOMAIN}/gang-min-members"
ANN_GANG_TIMEOUT = f"{DOMAIN}/gang-timeout"
ANN_GANG_DESIRED_MEMBERS = f"{DOMAIN}/gang-desired-members"
ANN_GANG_REQUIRED_MEMBERS = f"{DOMAIN}/gang-required-members"
ANN_GANG_GROUP_KEY = f"{DOMAIN}/gang-group-key"

#: host-port ranges of the port allocator
NODE_PORT_RANGE = (40000, 42000)
CLUSTER_PORT_RANGE = (42000, 62000)

ENV_SHM_PATH = "TPF_SHM_PATH"                  # worker segment path
ENV_HYPERVISOR_URL = "TPF_HYPERVISOR_URL"      # node-local bootstrap endpoint
ENV_POD_NAME = "TPF_POD_NAME"
ENV_POD_NAMESPACE = "TPF_POD_NAMESPACE"
ENV_LIMITER_LIB = "TPF_LIMITER_LIB"
ENV_REMOTING_QOS = "TPF_REMOTING_QOS"          # remote tenant's QoS class
ENV_REMOTING_DISPATCH = "TPF_REMOTING_DISPATCH"  # worker policy: wfq|fifo
ENV_REMOTING_QUANT = "TPF_REMOTING_QUANT"      # q8 wire encoding: 1 on, 0 off
ENV_REMOTING_PREFETCH_DEPTH = "TPF_REMOTING_PREFETCH_DEPTH"  # worker H2D overlap
ENV_TRACE_SAMPLE = "TPF_TRACE_SAMPLE"          # head-based trace sampling
ENV_PROF = "TPF_PROF"                          # tpfprof attribution: 0 disables
ENV_PROF_BIN_S = "TPF_PROF_BIN_S"              # attribution bin width (s)
ENV_PROF_BUNDLE_DIR = "TPF_PROF_BUNDLE_DIR"    # auto postmortem bundle dir
ENV_FED_QUANT = "TPF_FED_QUANT"                # federated collective q8: 1/0
ENV_OPERATOR_URL = "TPF_OPERATOR_URL"          # control-plane client API
ENV_NODE_NAME = "TPF_NODE_NAME"
ENV_POOL_NAME = "TPF_POOL"                     # pool the node agent joins
ENV_STORE_TOKEN = "TPF_STORE_TOKEN"            # store-gateway shared token
ENV_PROVIDER_LIB = "TPF_PROVIDER_LIB"
ENV_SHM_BASE = "TPF_SHM_BASE"
#: the bound host indices; CUDA orders devices fastest first unless
#: CUDA_DEVICE_ORDER says PCI_BUS_ID, which is NVML's (and the provider's)
#: index order, so the allocation sets both
ENV_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"
ENV_DEVICE_ORDER = "CUDA_DEVICE_ORDER"
DEVICE_ORDER_PCI = "PCI_BUS_ID"
ENV_CHIP_IDS = "TPF_CHIP_IDS"
ENV_ISOLATION = "TPF_ISOLATION"
ENV_DEVICE_MOUNTS = "TPF_DEVICE_MOUNTS"        # mount-policy host paths
ENV_HBM_HOST_SPILL = "TPF_HBM_HOST_SPILL"      # bytes the client must offload
ENV_HYPERVISOR_TOKEN = "TPF_HYPERVISOR_TOKEN"  # the node agent's API token
ENV_NVML_LIB = "TPF_NVML_LIB"                  # NVML provider: libnvidia-ml path
ENV_LIVE_HBM_INTERVAL = "TPF_LIVE_HBM_S"       # live-memory sampling period
#: the launch and memory hook (hypervisor/csrc/cuda_hook.c), preloaded into
#: every soft worker: the segment's device slot, and the card's peak that
#: turns a device-second into MFLOPs (the unit the buckets refill in)
ENV_LD_PRELOAD = "LD_PRELOAD"
ENV_DEVICE_INDEX = "TPF_DEVICE_INDEX"
ENV_PEAK_MFLOPS = "TPF_PEAK_MFLOPS"
#: the reference client's metering switch, which the admission webhook
#: injects as the reference's does.  Nothing in the port reads it: a
#: worker's tenant is metered by the launch hook the node agent preloads
ENV_VTPU_ENABLED = "TPF_VTPU"

DEFAULT_HYPERVISOR_PORT = 8000

ISOLATION_SHARED = "shared"            # no enforcement, best effort
ISOLATION_SOFT = "soft"                # shm token buckets + ERL
ISOLATION_HARD = "hard"                # one-shot provider hard caps
ISOLATION_PARTITIONED = "partitioned"  # whole cards via provider grants
ISOLATION_MODES = (
    ISOLATION_SHARED,
    ISOLATION_SOFT,
    ISOLATION_HARD,
    ISOLATION_PARTITIONED,
)
DEFAULT_ISOLATION = ISOLATION_SOFT

PHASE_PENDING = "Pending"
PHASE_PROVISIONING = "Provisioning"
PHASE_RUNNING = "Running"
PHASE_SUCCEEDED = "Succeeded"
PHASE_FAILED = "Failed"
PHASE_UNKNOWN = "Unknown"
PHASE_DESTROYING = "Destroying"
PHASE_MIGRATING = "Migrating"

#: the vendor a TPUChip of the NVML provider names
VENDOR_NVIDIA = "nvidia"

CHIP_USED_BY_TPU_FUSION = "tpu-fusion"
CHIP_USED_BY_EXTERNAL_PLUGIN = "external-device-plugin"

#: pool defaults (the TPUPool spec's)
DEFAULT_TFLOPS_OVERSELL_PERCENT = 500     # 5x device-time oversubscription
#: HBM expansion is opt-in: admitting placements beyond physical HBM is
#: honest only where the client keeps the spill contract
DEFAULT_HBM_EXPAND_HOST_MEM_PERCENT = 0
DEFAULT_HBM_EXPAND_HOST_DISK_PERCENT = 0

#: remote dispatcher queue depths: deep enough for pipelining clients
#: (depths of 8-32), shallow enough that queue wait stays bounded
DEFAULT_MAX_QUEUE_PER_TENANT = 64
DEFAULT_MAX_QUEUE_GLOBAL = 256
#: ceiling on how many compatible requests fuse into one dispatch
DEFAULT_MAX_MICROBATCH = 8

QOS_LOW = "low"
QOS_MEDIUM = "medium"
QOS_HIGH = "high"
QOS_CRITICAL = "critical"
QOS_LEVELS = (QOS_LOW, QOS_MEDIUM, QOS_HIGH, QOS_CRITICAL)
DEFAULT_QOS = QOS_MEDIUM

#: relative service shares per QoS class: the serving engine admits the
#: highest weight first and preempts the lowest
QOS_DISPATCH_WEIGHTS = {
    QOS_LOW: 1.0,
    QOS_MEDIUM: 2.0,
    QOS_HIGH: 4.0,
    QOS_CRITICAL: 8.0,
}

#: queue-wait SLO per QoS class (ms): the engine judges each admission
#: wait against its tenant's class (the per-tenant good/total rollup)
QOS_QUEUE_WAIT_SLO_MS = {
    QOS_LOW: 1000.0,
    QOS_MEDIUM: 500.0,
    QOS_HIGH: 200.0,
    QOS_CRITICAL: 100.0,
}
