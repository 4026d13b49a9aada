"""Trace export, the port's copy of ``tensorfusion_tpu/tracing/export.py``:
Chrome/Perfetto trace-event JSON.

One exported file is a complete, self-describing artifact: the
``traceEvents`` list (complete-event ``"ph": "X"`` records, one per
span) loads directly into ``chrome://tracing`` / https://ui.perfetto.dev,
and ``otherData`` carries the span dicts verbatim so they can be
dumped, filtered, diffed and validated without lossy round-trips.

Export is **canonical**: spans sort by (start, trace, span id), JSON
keys sort, timestamps are integral microseconds, so ``trace_digest``
equality is a meaningful determinism check.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Iterable, List, Optional

FORMAT = "tpftrace-chrome-v1"


def _sorted_spans(spans: Iterable[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    return sorted(spans, key=lambda d: (d.get("start_us", 0),
                                        d.get("trace_id", ""),
                                        d.get("span_id", "")))


def to_chrome(spans: Iterable[Dict[str, Any]],
              meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Chrome trace-event document for a span-dict iterable.

    pids group by service (one "process" per service), tids group by
    trace (one "thread" per trace id) — the layout that makes a
    request's end-to-end timeline read left-to-right in Perfetto with
    the server-side subtree nested under the client's wire span."""
    spans = _sorted_spans(spans)
    services: Dict[str, int] = {}
    traces: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for d in spans:
        svc = str(d.get("service", ""))
        pid = services.setdefault(svc, len(services) + 1)
        tid = traces.setdefault(str(d.get("trace_id", "")),
                                len(traces) + 1)
        events.append({
            "name": d.get("name", ""),
            "cat": svc,
            "ph": "X",
            "ts": int(d.get("start_us", 0)),
            "dur": int(d.get("dur_us", 0)),
            "pid": pid,
            "tid": tid,
            "args": dict(d.get("attrs", {}),
                         trace_id=d.get("trace_id", ""),
                         span_id=d.get("span_id", ""),
                         parent_id=d.get("parent_id", "")),
        })
    doc = {
        "format": FORMAT,
        "displayTimeUnit": "ms",
        "traceEvents": events,
        "otherData": {
            "spans": spans,
            "services": {v: k for k, v in services.items()},
            "traces": len(traces),
        },
    }
    if meta:
        doc["otherData"]["meta"] = dict(meta)
    return doc


def dumps(doc: Dict[str, Any]) -> str:
    """Canonical serialization (sorted keys, fixed separators) — the
    byte form digests and determinism checks compare."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n"


def write_trace(path: str, spans: Iterable[Dict[str, Any]],
                meta: Optional[Dict[str, Any]] = None) -> str:
    with open(path, "w", encoding="utf-8") as f:
        f.write(dumps(to_chrome(spans, meta=meta)))
    return path


def load_trace(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not a trace-event JSON document")
    return doc


def spans_of(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Span dicts from a loaded document (native exports carry them in
    otherData; for foreign chrome traces, reconstruct from events)."""
    other = doc.get("otherData") or {}
    if isinstance(other.get("spans"), list):
        return other["spans"]
    out = []
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        out.append({"name": ev.get("name", ""),
                    "service": ev.get("cat", ""),
                    "trace_id": args.get("trace_id", ""),
                    "span_id": args.get("span_id", ""),
                    "parent_id": args.get("parent_id", ""),
                    "start_us": int(ev.get("ts", 0)),
                    "dur_us": int(ev.get("dur", 0)),
                    "attrs": {k: v for k, v in args.items()
                              if k not in ("trace_id", "span_id",
                                           "parent_id")}})
    return out


def trace_digest(spans: Iterable[Dict[str, Any]]) -> str:
    """Digest of the canonical export — the fingerprint two same-seed
    sim runs must agree on (virtual-time determinism)."""
    return hashlib.sha256(
        dumps(to_chrome(spans)).encode()).hexdigest()


def validate(doc: Dict[str, Any],
             schema: Optional[Dict[str, dict]] = None) -> List[str]:
    """Errors for an exported trace vs the span registry: undeclared
    span names, undeclared attribute keys, structural breakage (a
    parent_id naming no span in the same trace).  Empty list = valid."""
    if schema is None:
        from .registry import SPAN_SCHEMA
        schema = SPAN_SCHEMA
    errors: List[str] = []
    spans = spans_of(doc)
    by_trace: Dict[str, set] = {}
    for d in spans:
        by_trace.setdefault(d.get("trace_id", ""), set()).add(
            d.get("span_id", ""))
    for d in spans:
        name = d.get("name", "")
        entry = schema.get(name)
        if entry is None:
            errors.append(f"span name {name!r} is not declared in "
                          f"SPAN_SCHEMA (tracing/registry.py)")
            continue
        declared = set(entry.get("attrs", ())) | {"error"}
        for key in sorted(set(d.get("attrs", {})) - declared):
            errors.append(f"span {name!r} carries undeclared attribute "
                          f"{key!r}")
        parent = d.get("parent_id", "")
        if parent and parent not in by_trace.get(
                d.get("trace_id", ""), ()):
            # a dangling parent is legal only for adopted remote spans
            # whose local parent was trimmed from the ring; flag it so
            # truncated exports are visible
            errors.append(f"span {d.get('span_id')!r} ({name}) parents "
                          f"under {parent!r} which is absent from trace "
                          f"{d.get('trace_id')!r}")
    return sorted(set(errors))

