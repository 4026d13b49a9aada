"""tpftrace for the port: spans with context propagation (``core``).
The exporters and the span registry come with the serving-over-the-wire
part of remote execution."""

from .core import ENV_TRACE_SAMPLE, Span, Tracer

__all__ = ["ENV_TRACE_SAMPLE", "Span", "Tracer"]
