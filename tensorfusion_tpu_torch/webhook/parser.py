"""Annotation -> workload-profile parser.

The port's copy of ``tensorfusion_tpu/webhook/parser.py``.

Analog of the reference's ``internal/webhook/v1/tf_parser.go:40-716``
(``ParseTensorFusionInfo``): resolve the effective WorkloadProfile for a pod
from (1) a referenced profile object, overridden by (2) inline annotations,
with (3) pool/platform defaults; infer vendor/generation; normalize
tflops <-> duty-percent against the chip model DB; derive QoS and gang
settings.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Dict, Optional

from .. import constants
from ..api.meta import thaw_copy
from ..api.resources import GangConfig, ResourceAmount, Resources, parse_quantity
from ..api.types import (ChipModelInfo, Pod, TPUWorkloadSpec, WorkloadProfile,
                         WorkloadProfileSpec, native_chip_counts)
from ..store import ObjectStore

log = logging.getLogger("tpf.webhook.parser")


class ParseError(ValueError):
    pass


def _truthy(v: str) -> bool:
    return str(v).lower() in ("true", "1", "yes", "on")


class WorkloadParser:
    def __init__(self, store: Optional[ObjectStore] = None,
                 chip_models: Optional[Dict[str, ChipModelInfo]] = None,
                 default_pool: str = ""):
        self.store = store
        self.chip_models = chip_models or {}
        self.default_pool = default_pool

    def set_chip_models(self, models: Dict[str, ChipModelInfo]) -> None:
        self.chip_models = models

    # ------------------------------------------------------------------

    def is_tpu_fusion_pod(self, pod: Pod) -> bool:
        ann = pod.metadata.annotations
        labels = pod.metadata.labels
        if labels.get(constants.LABEL_ENABLED) == "false":
            return False
        if labels.get(constants.LABEL_ENABLED) == "true":
            # auto-migrated native pods join via the enabled label alone
            # (IsTensorFusionPod analog, reconcile.go:214)
            return True
        return any(k.startswith(constants.DOMAIN + "/") for k in ann)

    def parse(self, pod: Pod) -> TPUWorkloadSpec:
        """Resolve the effective workload spec for a pod."""
        ann = pod.metadata.annotations
        spec = TPUWorkloadSpec()

        # 1. referenced profile
        profile_name = ann.get(constants.ANN_WORKLOAD_PROFILE, "")
        if profile_name and self.store is not None:
            profile = self.store.try_get(WorkloadProfile, profile_name,
                                         pod.metadata.namespace)
            if profile is None:
                raise ParseError(f"workload profile {profile_name!r} "
                                 f"not found in {pod.metadata.namespace}")
            # the profile is a frozen store snapshot: copy THAWED
            # values — the override/normalization steps below mutate them
            src = thaw_copy(profile.spec)
            for f in dataclasses.fields(WorkloadProfileSpec):
                setattr(spec, f.name, getattr(src, f.name))

        # 2. inline annotation overrides
        spec.pool = ann.get(constants.ANN_POOL, spec.pool or
                            self.default_pool)
        req, lim = spec.resources.requests, spec.resources.limits
        if constants.ANN_TFLOPS_REQUEST in ann:
            req.tflops = parse_quantity(ann[constants.ANN_TFLOPS_REQUEST])
        if constants.ANN_HBM_REQUEST in ann:
            req.hbm_bytes = parse_quantity(ann[constants.ANN_HBM_REQUEST])
        if constants.ANN_DUTY_REQUEST in ann:
            req.duty_percent = float(ann[constants.ANN_DUTY_REQUEST])
        if constants.ANN_TFLOPS_LIMIT in ann:
            lim.tflops = parse_quantity(ann[constants.ANN_TFLOPS_LIMIT])
        if constants.ANN_HBM_LIMIT in ann:
            lim.hbm_bytes = parse_quantity(ann[constants.ANN_HBM_LIMIT])
        if constants.ANN_DUTY_LIMIT in ann:
            lim.duty_percent = float(ann[constants.ANN_DUTY_LIMIT])
        if constants.ANN_CHIP_COUNT in ann:
            spec.chip_count = int(ann[constants.ANN_CHIP_COUNT])
        if not 1 <= spec.chip_count <= 128:
            raise ParseError(f"chip-count {spec.chip_count} out of 1..128")
        if constants.ANN_CHIP_GENERATION in ann:
            spec.generation = ann[constants.ANN_CHIP_GENERATION]
        if constants.ANN_VENDOR in ann:
            spec.vendor = ann[constants.ANN_VENDOR]
        if constants.ANN_CHIP_INDICES in ann:
            spec.chip_indices = [int(x) for x in
                                 ann[constants.ANN_CHIP_INDICES].split(",")
                                 if x]
        if constants.ANN_QOS in ann:
            qos = ann[constants.ANN_QOS]
            if qos not in constants.QOS_LEVELS:
                raise ParseError(f"unknown qos {qos!r}")
            spec.qos = qos
        if constants.ANN_ISOLATION in ann:
            iso = ann[constants.ANN_ISOLATION]
            if iso not in constants.ISOLATION_MODES:
                raise ParseError(f"unknown isolation {iso!r}")
            spec.isolation = iso
        if constants.ANN_PARTITION_NAME in ann:
            spec.partition_template = ann[constants.ANN_PARTITION_NAME]
            spec.isolation = constants.ISOLATION_PARTITIONED
        if constants.ANN_IS_LOCAL_TPU in ann:
            spec.is_local_tpu = _truthy(ann[constants.ANN_IS_LOCAL_TPU])
        if constants.ANN_DEDICATED_WORKER in ann:
            spec.dedicated_worker = _truthy(ann[constants.ANN_DEDICATED_WORKER])
        if constants.ANN_SIDECAR_WORKER in ann:
            spec.sidecar_worker = _truthy(ann[constants.ANN_SIDECAR_WORKER])
        if constants.ANN_EMBEDDED_WORKER in ann:
            spec.embedded_worker = _truthy(ann[constants.ANN_EMBEDDED_WORKER])
        if constants.ANN_AUTOSCALE in ann:
            spec.auto_scaling.enabled = _truthy(ann[constants.ANN_AUTOSCALE])
        if constants.ANN_AUTOSCALE_TARGET in ann:
            spec.auto_scaling.target_resource = \
                ann[constants.ANN_AUTOSCALE_TARGET]

        # gang
        if _truthy(ann.get(constants.ANN_GANG_ENABLED, "")) or \
                spec.chip_count > 1 and _truthy(
                    ann.get(constants.ANN_GANG_ENABLED, "true")) and \
                constants.ANN_GANG_MIN_MEMBERS in ann:
            spec.gang = GangConfig(
                enabled=True,
                min_members=int(ann.get(constants.ANN_GANG_MIN_MEMBERS, 0)
                                or 0),
                timeout_seconds=float(ann.get(constants.ANN_GANG_TIMEOUT, 0)
                                      or 0),
                # min-members present => strict all-or-nothing gang
                strict=bool(ann.get(constants.ANN_GANG_MIN_MEMBERS)))

        # 2b. native chip-quantity conversion (tf_parser.go:444-494
        # analog): a pod migrated from native whole-chip requests —
        # container chip counts set, no tpu-fusion compute annotations —
        # becomes a whole-chip workload: duty 100% per chip, full-chip
        # HBM when the generation's model is known.
        req_amt = spec.resources.requests
        if constants.ANN_CHIP_COUNT not in ann and \
                req_amt.tflops <= 0 and req_amt.hbm_bytes <= 0 and \
                req_amt.duty_percent <= 0:
            per_container = native_chip_counts(pod)
            native_total = sum(per_container.values())
            if native_total > 0:
                if native_total > 128:
                    raise ParseError(f"native chip request {native_total} "
                                     f"out of 1..128")
                spec.chip_count = native_total
                # migrated pods join the SHARED pool at 100% duty — the
                # whole point of seamless migration is converting hoarded
                # whole chips into oversubscribable ones (the reference
                # converts to computePercent 100, tf_parser.go:463-466).
                # Workloads that need true exclusivity keep it via the
                # dedicated-chip annotation instead.
                req_amt.duty_percent = 100.0
                spec.resources.limits.duty_percent = 100.0
                model = self.chip_models.get(spec.generation)
                if model is not None and model.hbm_bytes > 0:
                    req_amt.hbm_bytes = model.hbm_bytes
                ann.setdefault(constants.ANN_INJECT_CONTAINER,
                               ",".join(per_container))
                ann.setdefault(constants.ANN_CONTAINER_CHIP_COUNT,
                               json.dumps(per_container))

        # 3. defaults + normalization
        if not spec.qos:
            spec.qos = constants.DEFAULT_QOS
        self._normalize_compute(spec)

        if not spec.resources.limits.tflops:
            spec.resources.limits.tflops = spec.resources.requests.tflops
        if not spec.resources.limits.hbm_bytes:
            spec.resources.limits.hbm_bytes = spec.resources.requests.hbm_bytes
        if spec.resources.requests.tflops <= 0 and \
                spec.resources.requests.hbm_bytes <= 0 and \
                spec.resources.requests.duty_percent <= 0:
            raise ParseError("pod requests no TPU resources "
                             "(set tflops-request and/or hbm-request)")

        ann.setdefault(constants.ANN_WORKLOAD, pod.metadata.name)
        spec.replicas = 1
        return spec

    def _normalize_compute(self, spec: TPUWorkloadSpec) -> None:
        """tflops <-> duty% against the chip-model DB: a duty share on a
        known generation implies a TFLOPs amount and vice versa."""
        model = self.chip_models.get(spec.generation) if spec.generation \
            else None
        for amt in (spec.resources.requests, spec.resources.limits):
            if model is None or model.bf16_tflops <= 0:
                continue
            if amt.duty_percent > 0 and amt.tflops <= 0:
                amt.tflops = amt.duty_percent / 100.0 * model.bf16_tflops
            elif amt.tflops > 0 and amt.duty_percent <= 0:
                amt.duty_percent = min(
                    100.0, amt.tflops / model.bf16_tflops * 100.0)

    # -- QoS -> scheduling priority (pod_webhook.go:227-235 analog) -------

    QOS_PRIORITY = {constants.QOS_LOW: 0, constants.QOS_MEDIUM: 100,
                    constants.QOS_HIGH: 1000, constants.QOS_CRITICAL: 10000}

    def qos_priority(self, qos: str) -> int:
        return self.QOS_PRIORITY.get(qos, 100)
