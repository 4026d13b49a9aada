"""tpftrace core: dependency-free span recorder with context propagation
(the port's copy of ``tensorfusion_tpu/tracing/core.py``).

The reference platform's observability stops at per-series metrics (the
implicit metrics.go -> Grafana contract PAPER.md's survey notes), so
"why was *this* request slow" has no answer — queue wait under WFQ,
wire serialization, host->device upload and the launch itself all fold
into one number.  This module is the per-request timeline layer:

- :class:`Span` — one named, timed operation with attributes, linked
  into a trace by ``(trace_id, span_id, parent_id)``.
- :class:`Tracer` — mints spans, records finished ones into a bounded
  ring, and owns the **head-based sampling** decision (made once at the
  trace root; every child — including remote ones — inherits it via the
  propagated context, so a trace is always complete or absent, never
  ragged).
- context propagation is explicit: a span's :meth:`Span.ctx` dict
  travels in protocol-v5 ``trace`` meta (remoting) or a pod annotation
  (control plane), and the receiving side parents its spans under it.

Time flows through the injectable :class:`~tensorfusion_tpu_torch.clock.Clock`
seam, so spans recorded under the digital twin's ``SimClock`` carry
virtual timestamps and same-seed runs export byte-identical traces.
Ids come from a per-tracer counter — NOT ``random`` — for the same
reason (``id_prefix`` namespaces tracers when uniqueness across
processes matters).

Span names follow the reference's catalog (docs/tracing.md).
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import os
import threading
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .. import constants
from ..clock import Clock, default_clock

#: head-based sampling knob: fraction of new traces kept (0.0 - 1.0).
#: Read per Tracer at construction; tier-1 determinism needs 1.0 (the
#: default) so every test trace is complete.
ENV_TRACE_SAMPLE = constants.ENV_TRACE_SAMPLE

#: finished-span ring capacity — large enough for a whole sim scenario
#: or a bench window, bounded so a hot serving path cannot grow memory
DEFAULT_MAX_SPANS = 65536

#: Knuth multiplicative hash constant for the deterministic sampling
#: decision (a counter hashed through this spreads keep/drop decisions
#: evenly without ``random``, which would break sim determinism)
_KNUTH = 2654435761


def _env_sample_rate() -> float:
    raw = os.environ.get(ENV_TRACE_SAMPLE, "")
    if not raw:
        return 1.0
    try:
        return min(max(float(raw), 0.0), 1.0)
    except ValueError:
        return 1.0


class Span:
    """One timed operation.  Created by :meth:`Tracer.start_span`,
    closed by :meth:`finish` (or the ``with tracer.span(...)`` form —
    preferred, because an exit path that skips ``finish`` loses the
    span, which is exactly what the ``trace-schema`` lint hunts)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "service",
                 "start_s", "end_s", "attrs", "sampled", "_tracer")

    def __init__(self, tracer: Optional["Tracer"], name: str,
                 trace_id: str, span_id: str, parent_id: str,
                 service: str, start_s: float, sampled: bool,
                 attrs: Optional[Dict[str, Any]] = None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.service = service
        self.start_s = start_s
        self.end_s: Optional[float] = None
        self.sampled = sampled
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def ctx(self) -> Dict[str, Any]:
        """Wire/annotation propagation context for children of this
        span (the protocol-v5 ``trace`` header field shape)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "sampled": self.sampled}

    def finish(self, **attrs: Any) -> "Span":
        """Close the span (idempotent) and record it when sampled."""
        if attrs:
            self.attrs.update(attrs)
        if self.end_s is None:
            tracer = self._tracer
            self.end_s = tracer.clock.now() if tracer is not None \
                else self.start_s
            if tracer is not None and self.sampled:
                tracer._record(self)
        return self

    def duration_ms(self) -> float:
        end = self.end_s if self.end_s is not None else self.start_s
        return max(0.0, (end - self.start_s) * 1e3)

    def to_dict(self) -> Dict[str, Any]:
        """Wire/export form (microsecond integers keep exported traces
        byte-stable across float-formatting differences)."""
        end = self.end_s if self.end_s is not None else self.start_s
        return {"name": self.name, "service": self.service,
                "trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id,
                "start_us": int(round(self.start_s * 1e6)),
                "dur_us": max(int(round((end - self.start_s) * 1e6)), 0),
                "attrs": dict(self.attrs)}


class Tracer:
    """Span factory + bounded finished-span ring for one service."""

    def __init__(self, service: str = "tpf",
                 clock: Optional[Clock] = None,
                 sample: Optional[float] = None,
                 max_spans: int = DEFAULT_MAX_SPANS,
                 id_prefix: str = ""):
        self.service = service
        self.clock = clock or default_clock()
        #: head-based keep fraction; None -> TPF_TRACE_SAMPLE (default 1)
        self.sample = _env_sample_rate() if sample is None \
            else min(max(float(sample), 0.0), 1.0)
        self.id_prefix = id_prefix
        self._lock = threading.Lock()
        #: lock-free id mint (itertools.count.__next__ is atomic under
        #: the GIL) — span creation is on the serving hot path, so it
        #: must not take the ring lock
        self._ids = itertools.count(1)
        # guarded by: _lock
        self._finished_seq = 0      # total spans ever recorded
        # guarded by: _lock
        self._ring: deque = deque(maxlen=max_spans)   # (seq, span dict)
        #: best-effort stats counters (updated lock-free; a lost
        #: increment under a race skews stats, never correctness)
        self._started = 0
        self._dropped_unsampled = 0

    # -- id minting / sampling --------------------------------------------

    def _next_id(self) -> int:
        return next(self._ids)

    def _sample_decision(self, seq: int) -> bool:
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return ((seq * _KNUTH) & 0xFFFFFFFF) / float(1 << 32) < self.sample

    # -- span lifecycle ---------------------------------------------------

    def start_span(self, name: str,
                   parent: "Span | Dict[str, Any] | None" = None,
                   attrs: Optional[Dict[str, Any]] = None) -> Span:
        """Open a span.  ``parent`` is a local :class:`Span`, a
        propagated context dict (:meth:`Span.ctx` shape), or None for a
        new trace root — the sampling decision is made HERE for roots
        and inherited otherwise."""
        seq = self._next_id()
        span_id = f"{self.id_prefix}s{seq:x}"
        if isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
            sampled = parent.sampled
        elif isinstance(parent, dict) and parent.get("trace_id"):
            trace_id = str(parent["trace_id"])
            parent_id = str(parent.get("span_id", "") or "")
            sampled = bool(parent.get("sampled", True))
        else:
            trace_id = f"{self.id_prefix}t{seq:x}"
            parent_id = ""
            sampled = self._sample_decision(seq)
        self._started += 1
        if not sampled:
            self._dropped_unsampled += 1
        return Span(self, name, trace_id, span_id, parent_id,
                    self.service, self.clock.now(), sampled, attrs)

    @contextlib.contextmanager
    def span(self, name: str,
             parent: "Span | Dict[str, Any] | None" = None,
             attrs: Optional[Dict[str, Any]] = None):
        """``with tracer.span("name") as s:`` — finished on every exit
        path; an exception is stamped as ``error`` before the finish."""
        s = self.start_span(name, parent=parent, attrs=attrs)
        try:
            yield s
        except BaseException as e:
            s.finish(error=f"{type(e).__name__}: {e}"[:200])
            raise
        else:
            s.finish()

    def record_span(self, name: str, start_s: float, end_s: float,
                    parent: "Span | Dict[str, Any] | None" = None,
                    attrs: Optional[Dict[str, Any]] = None
                    ) -> Optional[Dict[str, Any]]:
        """Record a retroactively-timed span (queue wait is only known
        at dispatch).  Returns the recorded span dict, or None when the
        parent context is unsampled/absent."""
        if isinstance(parent, Span):
            ctx: Optional[Dict[str, Any]] = parent.ctx()
        else:
            ctx = parent
        if not ctx or not ctx.get("trace_id") \
                or not ctx.get("sampled", True):
            return None
        # hot path (one per server-side span per traced request):
        # build the wire dict directly, no Span object
        self._started += 1
        d = {"name": name, "service": self.service,
             "trace_id": str(ctx["trace_id"]),
             "span_id": f"{self.id_prefix}s{self._next_id():x}",
             "parent_id": str(ctx.get("span_id", "") or ""),
             "start_us": int(round(start_s * 1e6)),
             "dur_us": max(int(round((end_s - start_s) * 1e6)), 0),
             "attrs": dict(attrs) if attrs else {}}
        with self._lock:
            self._finished_seq += 1
            self._ring.append((self._finished_seq, d))
        return d

    def _record(self, span: Span) -> None:
        d = span.to_dict()
        with self._lock:
            self._finished_seq += 1
            self._ring.append((self._finished_seq, d))

    def adopt(self, span_dicts: Iterable[Dict[str, Any]]) -> int:
        """Record spans produced by ANOTHER tracer (the server-side
        span tree riding back in an EXECUTE_OK reply) so client-side
        export assembles the full end-to-end trace.  Returns the count
        adopted."""
        n = 0
        with self._lock:
            for d in span_dicts or ():
                if not isinstance(d, dict) or not d.get("name") \
                        or not d.get("trace_id"):
                    continue
                self._finished_seq += 1
                self._ring.append((self._finished_seq, dict(d)))
                n += 1
        return n

    # -- reading ----------------------------------------------------------

    def finished(self, trace_id: Optional[str] = None
                 ) -> List[Dict[str, Any]]:
        """Snapshot of the finished-span ring (optionally one trace),
        oldest first.  Non-destructive — the sim exporter and the
        metrics drain can both read the same tracer."""
        with self._lock:
            out = [d for _, d in self._ring]
        if trace_id is not None:
            out = [d for d in out if d.get("trace_id") == trace_id]
        return out

    def finished_since(self, seq: int
                       ) -> Tuple[int, List[Dict[str, Any]]]:
        """(new_cursor, spans recorded after ``seq``) — the cursor-based
        drain the metrics recorder uses so repeated passes never
        double-count and never clear the ring under the exporter."""
        with self._lock:
            spans = [d for s, d in self._ring if s > seq]
            return self._finished_seq, spans

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            recorded, ring = self._finished_seq, len(self._ring)
        return {"service": self.service, "sample": self.sample,
                "started": self._started,
                "recorded": recorded,
                "dropped_unsampled": self._dropped_unsampled,
                "ring": ring}



def pod_trace_context(pod) -> Dict[str, Any]:
    """Propagated trace context for a pod's lifecycle trace.

    The admission webhook stamps ``tpu-fusion.ai/trace`` =
    ``trace_id:span_id`` on the pod; scheduler/bind spans parent under
    it.  A pod that skipped admission (controller-created workers, sim
    traffic) still joins ONE stable trace per pod: the trace id is
    derived from the pod key, so every stage of its lifecycle lands on
    the same timeline without any store write."""
    raw = pod.metadata.annotations.get(constants.ANN_TRACE_CONTEXT, "")
    if raw:
        trace_id, _, span_id = raw.partition(":")
        if trace_id:
            return {"trace_id": trace_id, "span_id": span_id,
                    "sampled": True}
    digest = hashlib.sha1(pod.key().encode()).hexdigest()[:12]
    return {"trace_id": f"pod-{digest}", "span_id": "", "sampled": True}
