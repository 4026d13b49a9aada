"""The dispatcher's admission vocabulary, copied from
``tensorfusion_tpu/remoting/dispatch.py``: the QoS weight of a class, the
latency reservoir and the BUSY rejection.  The serving engine uses all
three, so a tenant's QoS class means the same thing on both paths; the
dispatcher itself comes with the remote-execution slice.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

from .. import constants


def qos_weight(qos: Optional[str]) -> float:
    """Dispatch weight for a QoS class; unknown/absent -> the default
    tier, never a rejection (an old client simply doesn't send one)."""
    return float(constants.QOS_DISPATCH_WEIGHTS.get(
        qos or constants.DEFAULT_QOS,
        constants.QOS_DISPATCH_WEIGHTS[constants.DEFAULT_QOS]))


class LatencyRecorder:
    """Bounded reservoir + counters for one latency series.

    Keeps the most recent ``maxlen`` samples (seconds) in a ring; p50 /
    p99 are computed on snapshot.  Recent-window quantiles are the
    right shape for saturation alerting — a day-old histogram bucket
    would mask a queue that went bad five minutes ago."""

    def __init__(self, maxlen: int = 2048):
        self._samples: deque = deque(maxlen=maxlen)
        self.count = 0
        self.total_s = 0.0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)
            self.count += 1
            self.total_s += seconds

    def mean_s(self) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            return sum(self._samples) / len(self._samples)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            samples = sorted(self._samples)
            count, total = self.count, self.total_s
        if not samples:
            return {"count": count, "p50_ms": 0.0, "p99_ms": 0.0,
                    "mean_ms": 0.0}
        def q(p):
            return samples[min(int(p * (len(samples) - 1)),
                               len(samples) - 1)]
        return {"count": count,
                "p50_ms": round(q(0.50) * 1e3, 3),
                "p99_ms": round(q(0.99) * 1e3, 3),
                "mean_ms": round(sum(samples) / len(samples) * 1e3, 3)}


class BusyError(Exception):
    """submit() rejection: queue bounds exceeded."""

    def __init__(self, scope: str, depth: int, retry_after_ms: int):
        super().__init__(f"{scope} dispatch queue full ({depth} deep)")
        self.scope = scope
        self.depth = depth
        self.retry_after_ms = retry_after_ms
