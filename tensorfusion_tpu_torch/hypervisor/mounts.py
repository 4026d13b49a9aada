"""Device mount policy: predicate-gated host-path mounts for workers.

The port's copy of tensorfusion_tpu/hypervisor/mounts.py: each
``DeviceMountRule`` carries a predicate over the worker context and a list
of host paths; the allocation controller asks the policy which paths a
worker's container must see.  The one device-specific change is the
default rule's paths: a card's ``/dev/nvidia{host_index}`` with
``/dev/nvidiactl`` and ``/dev/nvidia-uvm``, where the reference mounts
``/dev/accel{host_index}``.

Predicates are restricted boolean expressions evaluated by a small
AST-whitelist interpreter, never ``eval``: a rule's author must not be
able to reach attribute chains, calls, or unbounded arithmetic.
"""

from __future__ import annotations

import ast
import logging
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence

from .. import constants
from .framework import WorkerSpec

log = logging.getLogger("tpf.hypervisor.mounts")


@dataclass
class DeviceMountRule:
    """Predicate-gated device-node mount rule: the port's copy of the
    reference's ``api.types.DeviceMountRule``."""

    expression: str = "True"      # expression over {isolation, partitioned, qos, chip_count}
    host_paths: List[str] = field(default_factory=list)
    partitioned_only: bool = False


class DeviceMountPolicy:
    """Evaluates ProviderConfig mount rules for one worker."""

    def __init__(self, rules: Sequence[DeviceMountRule] = ()):
        self.rules: List[DeviceMountRule] = list(rules)

    @staticmethod
    def default_rules() -> List[DeviceMountRule]:
        """Defaults when no ProviderConfig rule is present:
        non-partitioned workers see their card's device node and the
        control nodes every CUDA process opens; partitioned workers see
        the nodes of their grant."""
        return [
            DeviceMountRule(
                expression="not partitioned",
                host_paths=["/dev/nvidia{host_index}", "/dev/nvidiactl",
                            "/dev/nvidia-uvm"]),
            DeviceMountRule(
                expression="partitioned",
                host_paths=["{grant_device_nodes}"],
                partitioned_only=True),
        ]

    # -- evaluation -------------------------------------------------------

    @staticmethod
    def _eval_node(node: ast.AST, ctx: Dict[str, object]):
        if isinstance(node, ast.Expression):
            return DeviceMountPolicy._eval_node(node.body, ctx)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (bool, int, float, str, type(None))):
                return node.value
            raise ValueError(f"constant {node.value!r} not allowed")
        if isinstance(node, ast.Name):
            if node.id not in ctx:
                raise ValueError(f"unknown name {node.id!r}")
            return ctx[node.id]
        if isinstance(node, ast.BoolOp):
            if isinstance(node.op, ast.And):
                return all(DeviceMountPolicy._eval_node(v, ctx)
                           for v in node.values)
            return any(DeviceMountPolicy._eval_node(v, ctx)
                       for v in node.values)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            return not DeviceMountPolicy._eval_node(node.operand, ctx)
        if isinstance(node, ast.Compare):
            left = DeviceMountPolicy._eval_node(node.left, ctx)
            for op, comp in zip(node.ops, node.comparators):
                right = DeviceMountPolicy._eval_node(comp, ctx)
                if isinstance(op, ast.Eq):
                    ok = left == right
                elif isinstance(op, ast.NotEq):
                    ok = left != right
                elif isinstance(op, ast.Lt):
                    ok = left < right
                elif isinstance(op, ast.LtE):
                    ok = left <= right
                elif isinstance(op, ast.Gt):
                    ok = left > right
                elif isinstance(op, ast.GtE):
                    ok = left >= right
                elif isinstance(op, ast.In):
                    ok = left in right
                elif isinstance(op, ast.NotIn):
                    ok = left not in right
                else:
                    raise ValueError(
                        f"operator {type(op).__name__} not allowed")
                if not ok:
                    return False
                left = right
            return True
        if isinstance(node, (ast.Tuple, ast.List)):
            return tuple(DeviceMountPolicy._eval_node(e, ctx)
                         for e in node.elts)
        raise ValueError(f"syntax {type(node).__name__} not allowed")

    @staticmethod
    def _eval(expression: str, ctx: Dict[str, object]) -> bool:
        try:
            tree = ast.parse(expression, mode="eval")
            return bool(DeviceMountPolicy._eval_node(tree, dict(ctx)))
        except Exception as e:  # noqa: BLE001 - a bad rule must not
            log.warning("mount rule %r failed to evaluate: %s",
                        expression, e)
            return False

    def mounts_for(self, spec: WorkerSpec,
                   bindings: Iterable) -> List[str]:
        """Host paths the worker must have mounted, deduped in rule
        order.  ``bindings`` are the worker's DeviceBindings (for
        per-chip placeholder expansion)."""
        bindings = list(bindings)
        partitioned = spec.isolation == constants.ISOLATION_PARTITIONED
        ctx = {
            "isolation": spec.isolation,
            "partitioned": partitioned,
            "qos": spec.qos,
            "chip_count": len(bindings),
        }
        out: List[str] = []
        seen = set()

        def add(path: str) -> None:
            if path and path not in seen:
                seen.add(path)
                out.append(path)

        for rule in self.rules:
            if rule.partitioned_only and not partitioned:
                continue
            if not self._eval(rule.expression, ctx):
                continue
            for path in rule.host_paths:
                if path == "{grant_device_nodes}":
                    for b in bindings:
                        if b.grant is not None:
                            for node in b.grant.device_nodes:
                                add(node)
                    continue
                if "{" in path:
                    for b in bindings:
                        if "{host_index}" in path and b.host_index < 0:
                            continue  # unknown host slot: no /dev/nvidia-1
                        add(path.format(
                            host_index=b.host_index,
                            chip_id=b.chip_id,
                            device_index=b.device_index))
                else:
                    add(path)
        return out
