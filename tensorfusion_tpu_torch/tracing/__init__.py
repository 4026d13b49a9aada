"""tpftrace for the port: spans with context propagation (``core``), the
span catalog (``registry``) and the Chrome/Perfetto export with its
check against the catalog (``export``)."""

from .core import ENV_TRACE_SAMPLE, Span, Tracer
from .export import load_trace, to_chrome, trace_digest, validate, write_trace
from .registry import SPAN_SCHEMA

__all__ = ["ENV_TRACE_SAMPLE", "SPAN_SCHEMA", "Span", "Tracer", "load_trace",
           "to_chrome", "trace_digest", "validate", "write_trace"]
