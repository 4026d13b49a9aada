"""Elastic-Rate-Limit (ERL) PID quota controller -- the soft-isolation core.

The port's copy of tensorfusion_tpu/hypervisor/erl.py, unchanged in its
arithmetic (the CPU tests hold the two to identical updates).  The
controller steers the refill rate of each worker-device MFLOP bucket:

- nominal rate  = duty quota% x the card's peak MFLOP/s (the datasheet's
  bf16 rate);
- *elastic* headroom: when the card's aggregate demand is below capacity,
  unused duty is redistributed to hungry workers proportionally to their
  QoS coefficient;
- a PID loop trims each worker's rate so its *measured* duty converges
  to its (elastic) target share, absorbing cost-model error in the
  client's per-call MFLOP estimates;
- bucket capacity = rate x burst window, clamped to a max burst multiple.

The controller is a pure computation (`step(observations, dt) -> updates`);
the worker controller feeds it observations and applies its updates via
the limiter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .. import constants

# the platform-wide QoS share ladder (also the remote dispatch weights)
DEFAULT_QOS_COEFFS = dict(constants.QOS_DISPATCH_WEIGHTS)


@dataclass
class ERLParameters:
    """Elastic-rate-limit PID controller knobs: the port's copy of the
    reference's ``api.types.ERLParameters``, with its defaults (tuned by
    its benchmarks/erl_tuning.py)."""

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
    """Freeze a QoS class's soft workers after this long idle: the port's
    copy of the reference's ``api.types.AutoFreezeRule``."""

    qos: str = constants.QOS_LOW
    enabled: bool = True
    freeze_to_mem_ttl_seconds: float = 60.0
    freeze_to_disk_ttl_seconds: float = 600.0
    resume_latency_budget_ms: int = 2000


@dataclass
class Observation:
    """One worker-device sample for a control step."""

    worker_key: str                 # "<ns>/<pod>"
    device_index: int
    chip_id: str
    quota_duty_bp: int              # contracted duty share (basis points)
    peak_mflops_per_s: float        # chip MXU peak
    measured_duty_pct: float        # observed share of chip MXU time (0-100)
    blocked_delta: int = 0          # new blocked_events since last step
    qos: str = constants.QOS_MEDIUM


@dataclass
class QuotaUpdate:
    worker_key: str
    device_index: int
    duty_limit_bp: int
    refill_mflop_per_s: int
    capacity_mflop: int


@dataclass
class _ShareState:
    smoothed_util: float = 0.0
    integral: float = 0.0
    last_error: float = 0.0
    current_share_pct: float = -1.0   # rate the bucket is refilled at
    hungry: bool = False


class ERLQuotaController:
    def __init__(self, params: Optional[ERLParameters] = None,
                 qos_coeffs: Optional[Dict[str, float]] = None,
                 smoothing_alpha: float = 0.4):
        self.params = params or ERLParameters()
        self.qos_coeffs = qos_coeffs or dict(DEFAULT_QOS_COEFFS)
        self.alpha = smoothing_alpha
        self._state: Dict[Tuple[str, int], _ShareState] = {}

    def forget(self, worker_key: str) -> None:
        for k in [k for k in self._state if k[0] == worker_key]:
            del self._state[k]

    # -- control step -----------------------------------------------------

    def step(self, observations: List[Observation],
             dt: float) -> List[QuotaUpdate]:
        p = self.params
        # Group by chip for elastic redistribution.
        by_chip: Dict[str, List[Observation]] = {}
        for ob in observations:
            by_chip.setdefault(ob.chip_id, []).append(ob)

        updates: List[QuotaUpdate] = []
        for chip_id, obs in by_chip.items():
            # 1. Update smoothed utilization + hunger.
            for ob in obs:
                st = self._state.setdefault((ob.worker_key, ob.device_index),
                                            _ShareState())
                st.smoothed_util = (self.alpha * ob.measured_duty_pct
                                    + (1 - self.alpha) * st.smoothed_util)
                quota_pct = ob.quota_duty_bp / 100.0
                share = st.current_share_pct if st.current_share_pct >= 0 \
                    else quota_pct
                # A worker is hungry if it hit the bucket wall or is using
                # nearly all of its current rate.
                st.hungry = (ob.blocked_delta > 0
                             or st.smoothed_util >= 0.85 * max(share, 1e-9))

            # 2. Elastic redistribution of unused duty on this chip.
            total_quota = sum(ob.quota_duty_bp / 100.0 for ob in obs)
            spare = max(0.0, 100.0 - total_quota)
            # Quota oversubscription: if quotas sum past 100, scale down
            # proportionally (the pool oversold MXU time).
            oversub = 100.0 / total_quota if total_quota > 100.0 else 1.0
            hungry = [ob for ob in obs
                      if self._state[(ob.worker_key, ob.device_index)].hungry]
            coeff_sum = sum(self.qos_coeffs.get(ob.qos, 1.0) for ob in hungry)
            # Idle workers' unused allocation also becomes redistributable.
            idle_unused = 0.0
            for ob in obs:
                st = self._state[(ob.worker_key, ob.device_index)]
                if not st.hungry:
                    quota_pct = ob.quota_duty_bp / 100.0 * oversub
                    idle_unused += max(0.0, quota_pct - st.smoothed_util)
            bonus_pool = spare + idle_unused

            # 3. PID per worker-device toward its elastic target.
            for ob in obs:
                st = self._state[(ob.worker_key, ob.device_index)]
                quota_pct = ob.quota_duty_bp / 100.0 * oversub
                target = quota_pct
                if st.hungry and coeff_sum > 0:
                    coeff = self.qos_coeffs.get(ob.qos, 1.0)
                    target += bonus_pool * coeff / coeff_sum
                target = min(target, 100.0)

                if st.current_share_pct < 0:
                    st.current_share_pct = quota_pct

                # Error is target rate minus granted rate nudged by how far
                # the measured utilization lags the granted rate (a worker
                # that can't consume its grant shouldn't accumulate error).
                error = target - st.current_share_pct
                st.integral = st.integral * p.integral_decay + error * dt
                derivative = (error - st.last_error) / dt if dt > 0 else 0.0
                st.last_error = error
                delta = (p.kp * error + p.ki * st.integral
                         + p.kd * derivative)
                # Slew-rate limit (quota_controller.go:314 analog).
                max_step = p.slew_max_step_percent
                delta = max(-max_step, min(max_step, delta))
                new_share = st.current_share_pct + delta
                floor = quota_pct * p.min_refill_fraction
                new_share = max(floor, min(100.0, new_share))
                st.current_share_pct = new_share

                refill = int(new_share / 100.0 * ob.peak_mflops_per_s)
                capacity = int(min(
                    refill * p.burst_window_seconds,
                    quota_pct / 100.0 * ob.peak_mflops_per_s
                    * p.max_burst_multiple * p.burst_window_seconds))
                capacity = max(capacity, 1)
                updates.append(QuotaUpdate(
                    worker_key=ob.worker_key,
                    device_index=ob.device_index,
                    duty_limit_bp=int(target * 100),
                    refill_mflop_per_s=max(refill, 1),
                    capacity_mflop=capacity))
        return updates

    # -- introspection ----------------------------------------------------

    def share(self, worker_key: str, device_index: int) -> Optional[float]:
        st = self._state.get((worker_key, device_index))
        return None if st is None else st.current_share_pct
