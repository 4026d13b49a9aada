"""Cluster digital twin: deterministic discrete-event simulation of the

The port's copy of ``tensorfusion_tpu/sim/__init__.py``.
real control plane (docs/simulation.md).

- :class:`SimClock` — virtual time implementing the
  :class:`~tensorfusion_tpu_torch.clock.Clock` contract.
- :class:`SimHarness` — hosts the real Operator stack with cooperative
  stepping, a deterministic event log, and invariant checks.
- :mod:`~tensorfusion_tpu_torch.sim.faults` — composable seed-scheduled
  fault primitives (node crash/flap, watch stall, store latency,
  partition, clock skew).
- :mod:`~tensorfusion_tpu_torch.sim.trace` — seeded topology + pod-churn
  trace generation.
- :mod:`~tensorfusion_tpu_torch.sim.scenarios` — the named fault scenarios
  ``benchmarks/sim_scenarios.py`` and ``make verify-sim`` run.
"""

from .clock import SIM_EPOCH, SimClock, TimerHandle
from .harness import SimHarness
from . import faults, scenarios, trace

__all__ = ["SIM_EPOCH", "SimClock", "SimHarness", "TimerHandle",
           "faults", "scenarios", "trace"]
