"""Auto-migration of native TPU pods into tpu-fusion.

The port's copy of ``tensorfusion_tpu/webhook/auto_migration.py``.

Analog of the reference's ``internal/webhook/v1/auto_migration.go`` +
``pod_webhook.go:100-134``: a pod that requests *native* TPU resources
(``Container.chip_count`` — our model of ``google.com/tpu`` quantities)
but carries no tpu-fusion annotations can be

1. **auto-migrated** — converted into a fully managed vTPU workload —
   when the hot-reloaded GlobalConfig's ``auto_migration`` rules say so
   (enable flag + include/exclude scopes over namespace names, namespace
   label selectors and pod label selectors), or
2. **proxy-scheduled** — left unmanaged but routed through the
   tpu-fusion scheduler so native whole-chip pods and vTPU pods never
   collide on a node (``IsProgressiveMigration`` env analog), or
3. left alone.

A pod can always opt out with the ``tpu-fusion.ai/enabled: "false"``
label (``IsTensorFusionPodDisabled`` analog).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import constants
from ..api.types import Namespace, Pod, native_chip_request
from ..store import ObjectStore
from .parser import _truthy

__all__ = ["ENV_PROGRESSIVE_MIGRATION", "AutoMigrationRules",
           "native_chip_request", "progressive_migration_enabled",
           "should_auto_migrate"]

#: env gate for proxied scheduling of unmigrated native TPU pods
#: (ref: NVIDIA_OPERATOR_PROGRESSIVE_MIGRATION)
ENV_PROGRESSIVE_MIGRATION = "TPF_PROGRESSIVE_MIGRATION"


def progressive_migration_enabled() -> bool:
    return _truthy(os.environ.get(ENV_PROGRESSIVE_MIGRATION, ""))


@dataclass
class AutoMigrationRules:
    """One include/exclude scope (auto_migration.go:85-119)."""

    namespace_names: List[str] = field(default_factory=list)
    namespace_selector: Dict[str, str] = field(default_factory=dict)
    pod_selector: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Optional[Dict]) -> Optional["AutoMigrationRules"]:
        if not d:
            return None
        return cls(
            namespace_names=list(d.get("namespace_names", []) or []),
            namespace_selector=dict(d.get("namespace_selector", {}) or {}),
            pod_selector=dict(d.get("pod_selector", {}) or {}))

    def matches(self, pod: Pod, store: Optional[ObjectStore]) -> bool:
        if self.namespace_names and \
                pod.metadata.namespace in self.namespace_names:
            return True
        if self.namespace_selector and store is not None:
            ns = store.try_get(Namespace, pod.metadata.namespace)
            if ns is not None and _labels_match(self.namespace_selector,
                                                ns.metadata.labels):
                return True
        if self.pod_selector and _labels_match(self.pod_selector,
                                               pod.metadata.labels):
            return True
        return False


def _labels_match(selector: Dict[str, str], labels: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def should_auto_migrate(pod: Pod, auto_migration: Optional[Dict],
                        store: Optional[ObjectStore] = None) -> bool:
    """Decide whether a native TPU pod joins the platform
    (``ShouldAutoMigrateGPUPod`` analog, auto_migration.go:34-82).

    ``auto_migration`` is the GlobalConfig section::

        {"enable": true,
         "scope": {"includes": {"namespace_names": [...],
                                "namespace_selector": {...},
                                "pod_selector": {...}},
                   "excludes": {...}}}

    No scope means migrate every native TPU pod; excludes beat includes.
    """
    if pod.metadata.labels.get(constants.LABEL_ENABLED) == "false":
        return False
    if not auto_migration or not auto_migration.get("enable"):
        return False
    scope = auto_migration.get("scope")
    if not scope:
        return True
    excludes = AutoMigrationRules.from_dict(scope.get("excludes"))
    if excludes is not None and excludes.matches(pod, store):
        return False
    includes = AutoMigrationRules.from_dict(scope.get("includes"))
    if includes is not None:
        return includes.matches(pod, store)
    return True
