"""tpfprof for the port: per-tenant device-time attribution
(``profiler``) and the always-on flight recorder (``recorder``).  The
artifact exporter comes with the serving-over-the-wire part of remote
execution."""

from .profiler import Profiler
from .recorder import FlightRecorder

__all__ = ["FlightRecorder", "Profiler"]
