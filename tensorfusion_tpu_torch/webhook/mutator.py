"""Admission mutator: the pod-creation entry point of the platform.

The port's copy of ``tensorfusion_tpu/webhook/mutator.py``.

Analog of the reference's mutating webhook
(``internal/webhook/v1/pod_webhook.go:84-265`` + the pod-composition library
``internal/utils/compose.go``): on pod submission it

1. parses annotations into an effective workload spec (parser.py);
2. creates/updates the server-side ``TPUWorkload`` object;
3. stamps the canonical annotation contract back onto the pod (resources,
   gang group/desired/required members, workload name);
4. routes the pod to the tpu-fusion scheduler and maps QoS -> priority;
5. injects the client runtime env (operator URL, vTPU activation) — the
   TPU analog of injecting the CUDA-intercept client container.

With no real kubelet, "containers" are env recipes consumed by whichever
backend runs the pod (single-node spawner or the cluster simulator).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from .. import constants
from ..api.types import Pod, TPUWorkload
from ..clock import Clock, default_clock
from ..store import ObjectStore, mutate
from .auto_migration import (native_chip_request,
                             progressive_migration_enabled,
                             should_auto_migrate)
from .parser import ParseError, WorkloadParser

log = logging.getLogger("tpf.webhook")


class AdmissionShedError(Exception):
    """The namespace is under policy-driven admission control: the pod
    is shed at the webhook instead of entering the scheduler queue
    (the cheapest point to apply backpressure — the admission analog
    of the dispatcher's BUSY + retry_after_ms, docs/policy.md)."""

    def __init__(self, namespace: str, retry_after_s: float):
        super().__init__(
            f"namespace {namespace!r} is admission-controlled; "
            f"retry after {retry_after_s:.1f}s")
        self.namespace = namespace
        self.retry_after_s = retry_after_s


class PodMutator:
    def __init__(self, store: ObjectStore, parser: WorkloadParser,
                 operator_url: str = "", tracer=None,
                 clock: Optional[Clock] = None):
        self.store = store
        self.parser = parser
        self.operator_url = operator_url
        self.clock = clock or default_clock()
        self.mutated_count = 0
        #: optional tracing.Tracer: admission is the ROOT of a pod's
        #: lifecycle trace — the webhook.admit span's context is
        #: stamped onto the pod (ANN_TRACE_CONTEXT) so the scheduler
        #: and bind spans parent under it (docs/tracing.md)
        self.tracer = tracer
        #: hot-reloaded GlobalConfig.auto_migration section
        self.auto_migration: dict = {}
        self._counters: dict = {}
        self._counter_lock = threading.Lock()
        #: policy-driven admission control (tpfpolicy admit_control
        #: actuator): namespace -> block-expiry clock.now() timestamp
        # guarded by: _counter_lock
        self._admission_blocks: dict = {}
        #: pods shed by admission control, total and per namespace
        # guarded by: _counter_lock
        self.admission_shed_total = 0
        # guarded by: _counter_lock
        self.admission_sheds: dict = {}

    # -- policy-driven admission control --------------------------------

    def set_admission_block(self, namespace: str,
                            ttl_s: float = 60.0) -> float:
        """Shed new tpu-fusion pods of ``namespace`` until now+ttl.
        Returns the expiry timestamp (re-arming extends, never
        shortens, so overlapping policy actuations compose)."""
        until = self.clock.now() + max(float(ttl_s), 0.0)
        with self._counter_lock:
            until = max(until, self._admission_blocks.get(namespace,
                                                          0.0))
            self._admission_blocks[namespace] = until
        log.warning("admission control: shedding new pods of %r "
                    "for %.1fs", namespace, ttl_s)
        return until

    def clear_admission_block(self, namespace: str) -> None:
        with self._counter_lock:
            self._admission_blocks.pop(namespace, None)

    def admission_blocked(self, namespace: str) -> float:
        """Seconds of block remaining (0 = not blocked); expired
        entries are reaped on read."""
        now = self.clock.now()
        with self._counter_lock:
            until = self._admission_blocks.get(namespace, 0.0)
            if until and until <= now:
                del self._admission_blocks[namespace]
                return 0.0
            return max(until - now, 0.0)

    def admission_control_snapshot(self) -> dict:
        with self._counter_lock:
            return {"blocked": dict(self._admission_blocks),
                    "shed_total": self.admission_shed_total,
                    "sheds": dict(self.admission_sheds)}

    def _shed_if_blocked(self, pod: Pod) -> None:
        ns = pod.metadata.namespace
        remaining = self.admission_blocked(ns)
        if remaining <= 0.0:
            return
        with self._counter_lock:
            self.admission_shed_total += 1
            self.admission_sheds[ns] = \
                self.admission_sheds.get(ns, 0) + 1
        raise AdmissionShedError(ns, remaining)

    def handle(self, pod: Pod) -> Pod:
        """Mutate a pod on admission; raises ParseError on bad requests."""
        auto_migrated = False
        if not self.parser.is_tpu_fusion_pod(pod):
            # native TPU pod handling (pod_webhook.go:100-134 analog):
            # migrate it into the platform, or at least route it through
            # our scheduler so native and vTPU pods never collide
            if native_chip_request(pod) <= 0:
                return pod
            if should_auto_migrate(pod, self.auto_migration, self.store):
                log.info("auto-migrating native TPU pod %s", pod.key())
                pod.metadata.labels[constants.LABEL_ENABLED] = "true"
                auto_migrated = True
            elif progressive_migration_enabled() and \
                    pod.metadata.labels.get(constants.LABEL_ENABLED) != \
                    "false":
                pod.spec.scheduler_name = constants.SCHEDULER_NAME
                return pod
            else:
                return pod
        try:
            spec = self.parser.parse(pod)
        except ParseError:
            if auto_migrated:
                # migration is best-effort: an unconvertible native pod
                # (e.g. >128 chips) keeps running natively rather than
                # being rejected at admission. It still gets the proxy
                # routing when enabled, so the scheduler accounts its
                # chips even though it stays unmanaged.
                del pod.metadata.labels[constants.LABEL_ENABLED]
                log.warning("auto-migration of %s failed to parse; "
                            "leaving the pod native", pod.key(),
                            exc_info=True)
                if progressive_migration_enabled():
                    pod.spec.scheduler_name = constants.SCHEDULER_NAME
                return pod
            # a pod that explicitly opted in (enabled label or tpu-fusion
            # annotations) but cannot be parsed is rejected at admission,
            # matching the reference (admission.Errored on parse failure,
            # pod_webhook.go:144-147)
            raise
        # policy-driven admission control: a namespace under active
        # admit-control sheds HERE, before any workload/annotation
        # state is created for the pod (AdmissionShedError carries
        # retry_after, mirroring the dispatcher's BUSY contract)
        self._shed_if_blocked(pod)
        ann = pod.metadata.annotations

        # grey release: only mutate the first N replicas of a counter key
        # (pod_webhook.go:148-163 analog)
        counter_key = ann.get(constants.ANN_POD_COUNTER_KEY)
        enabled = ann.get(constants.ANN_ENABLED_REPLICAS)
        if counter_key and enabled is not None:
            count = self._bump_counter(counter_key)
            if count > int(enabled):
                log.info("grey release: pod %s beyond enabled replicas (%s)",
                         pod.key(), enabled)
                return pod

        # pod-lifecycle trace root: the admission span's context rides
        # the pod annotation so every later stage (scheduler cycle,
        # bind) joins the same trace
        span = self.tracer.start_span(
            "webhook.admit", attrs={"pod": pod.key()}) \
            if self.tracer is not None else None
        if span is not None and span.sampled:
            ann[constants.ANN_TRACE_CONTEXT] = \
                f"{span.trace_id}:{span.span_id}"

        workload = self._ensure_workload(pod, spec)

        # canonical annotation contract (scheduler reads these)
        ann[constants.ANN_WORKLOAD] = workload.metadata.name
        ann[constants.ANN_POOL] = spec.pool
        ann[constants.ANN_TFLOPS_REQUEST] = str(spec.resources.requests.tflops)
        ann[constants.ANN_HBM_REQUEST] = \
            str(int(spec.resources.requests.hbm_bytes))
        ann[constants.ANN_TFLOPS_LIMIT] = str(spec.resources.limits.tflops)
        ann[constants.ANN_HBM_LIMIT] = \
            str(int(spec.resources.limits.hbm_bytes))
        if spec.resources.requests.duty_percent:
            ann[constants.ANN_DUTY_REQUEST] = \
                str(spec.resources.requests.duty_percent)
        ann[constants.ANN_CHIP_COUNT] = str(spec.chip_count)
        ann[constants.ANN_QOS] = spec.qos
        ann[constants.ANN_ISOLATION] = spec.isolation
        if spec.generation:
            ann[constants.ANN_CHIP_GENERATION] = spec.generation
        if spec.partition_template:
            ann[constants.ANN_PARTITION_NAME] = spec.partition_template

        # gang stamping (pod_webhook -> gang-desired/required members)
        if spec.gang.enabled:
            ann[constants.ANN_GANG_ENABLED] = "true"
            desired = int(ann.get(constants.ANN_GANG_DESIRED_MEMBERS, 0) or
                          spec.gang.min_members or 1)
            required = spec.gang.min_members or desired
            ann[constants.ANN_GANG_DESIRED_MEMBERS] = str(desired)
            ann[constants.ANN_GANG_REQUIRED_MEMBERS] = str(required)
            ann[constants.ANN_GANG_GROUP_KEY] = \
                f"{pod.metadata.namespace}/{workload.metadata.name}"
            if spec.gang.timeout_seconds:
                ann[constants.ANN_GANG_TIMEOUT] = \
                    str(spec.gang.timeout_seconds)

        # scheduling
        pod.spec.scheduler_name = constants.SCHEDULER_NAME
        pod.spec.priority = self.parser.qos_priority(spec.qos)

        # client runtime injection (compose.go AddTFDefaultClientConf analog).
        # The strings are the reference's, so that a pod mutated by either
        # package compares equal.  No LD_PRELOAD and no second meter: the
        # node agent preloads the launch hook into the worker, and nothing
        # in the port reads ENV_VTPU_ENABLED
        for container in pod.spec.containers or []:
            env = container.env
            env.setdefault(constants.ENV_VTPU_ENABLED, "1")
            env.setdefault(constants.ENV_POD_NAME, pod.metadata.name)
            env.setdefault(constants.ENV_POD_NAMESPACE,
                           pod.metadata.namespace)
            if self.operator_url:
                env.setdefault(constants.ENV_OPERATOR_URL, self.operator_url)
            env.setdefault(constants.ENV_ISOLATION, spec.isolation)
            # the tenant's QoS class rides into the remoting client
            # (RemoteDevice reads TPF_REMOTING_QOS -> HELLO qos), so the
            # worker's dispatcher weight AND the serving engine's
            # admission priority/SLO tier (docs/serving.md) both resolve
            # from the same tpu-fusion.ai/qos annotation this webhook
            # stamped above
            env.setdefault(constants.ENV_REMOTING_QOS, spec.qos)

        if span is not None:
            span.finish(pool=spec.pool, qos=spec.qos,
                        workload=workload.metadata.name)
        self.mutated_count += 1
        return pod

    # ------------------------------------------------------------------

    def _ensure_workload(self, pod: Pod, spec) -> TPUWorkload:
        name = pod.metadata.annotations.get(constants.ANN_WORKLOAD) or \
            pod.metadata.name
        def refresh_profile(existing):
            # admission must not clobber replica management: keep the
            # workload's scaling fields, refresh the resource profile
            spec.replicas = existing.spec.replicas
            spec.dynamic_replicas = existing.spec.dynamic_replicas
            existing.spec = spec

        # version-checked read-modify-write: a workload-controller status
        # rollup landing between our read and write must not be lost
        # (nor may it clobber this admission's resource refresh)
        updated = mutate(self.store, TPUWorkload, name, refresh_profile,
                         namespace=pod.metadata.namespace)
        if updated is not None:
            return updated
        wl = TPUWorkload.new(name, namespace=pod.metadata.namespace)
        wl.spec = spec
        wl.metadata.labels[constants.LABEL_MANAGED_BY] = "tpu-fusion"
        return self.store.create(wl)

    def _bump_counter(self, key: str) -> int:
        with self._counter_lock:
            self._counters[key] = self._counters.get(key, 0) + 1
            return self._counters[key]
