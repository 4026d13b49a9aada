"""tpfprof for the port: per-tenant device-time attribution
(``profiler``), the always-on flight recorder (``recorder``) and the
``tpf_prof_*`` influx lines of a snapshot (``export``)."""

from .export import profile_lines
from .profiler import Profiler
from .recorder import FlightRecorder

__all__ = ["FlightRecorder", "Profiler", "profile_lines"]
