"""Environment names the port's client, remote worker, tracer, profiler
and node agent read, the QoS ladder its serving engine and dispatcher
schedule by, and the node agent's isolation modes and worker phases (the
same contract as the JAX package's; see tensorfusion_tpu/constants.py).
The one name that differs is the visible-device variable: CUDA's."""

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
