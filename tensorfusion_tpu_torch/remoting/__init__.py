"""Remote execution of the port.  Only the dispatcher's admission
vocabulary is here so far (``dispatch.py``), which the serving engine
shares; the worker, client and wire protocol come with a later slice."""

from .dispatch import BusyError, LatencyRecorder, qos_weight

__all__ = ["BusyError", "LatencyRecorder", "qos_weight"]
