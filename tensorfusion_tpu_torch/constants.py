"""Environment names the port's client reads, and the QoS ladder its
serving engine schedules by (the same contract as the JAX package's; see
tensorfusion_tpu/constants.py)."""

ENV_SHM_PATH = "TPF_SHM_PATH"                  # worker segment path
ENV_HYPERVISOR_URL = "TPF_HYPERVISOR_URL"      # node-local bootstrap endpoint
ENV_POD_NAME = "TPF_POD_NAME"
ENV_POD_NAMESPACE = "TPF_POD_NAMESPACE"
ENV_LIMITER_LIB = "TPF_LIMITER_LIB"

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
