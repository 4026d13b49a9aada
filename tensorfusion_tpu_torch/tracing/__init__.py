"""tpftrace for the port: spans with context propagation and a pod's
lifecycle trace context (``core``), the span catalog (``registry``) and
the Chrome/Perfetto export with its check against the catalog
(``export``)."""

from .core import ENV_TRACE_SAMPLE, Span, Tracer, pod_trace_context
from .export import load_trace, to_chrome, trace_digest, validate, write_trace
from .registry import SPAN_SCHEMA

__all__ = ["ENV_TRACE_SAMPLE", "SPAN_SCHEMA", "Span", "Tracer", "load_trace",
           "pod_trace_context", "to_chrome", "trace_digest", "validate",
           "write_trace"]
