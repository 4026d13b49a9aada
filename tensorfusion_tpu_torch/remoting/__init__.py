"""Remote execution of the port, part 1: the TPFR wire protocol
(``protocol``), the QoS dispatcher (``dispatch``), the program format
(``program``), a single-device worker (``worker``) and its client
(``client``).  Serving over the wire, state and peers come with later
parts."""

from .client import (RemoteBuffer, RemoteBusyError, RemoteDeadlineError,
                     RemoteDevice, RemoteExecutionError)
from .dispatch import BusyError, LatencyRecorder, qos_weight
from .worker import RemoteVTPUWorker

__all__ = ["BusyError", "LatencyRecorder", "RemoteBuffer", "RemoteBusyError",
           "RemoteDeadlineError", "RemoteDevice", "RemoteExecutionError",
           "RemoteVTPUWorker", "qos_weight"]
