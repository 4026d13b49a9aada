"""Remote execution of the port: the TPFR wire protocol (``protocol``),
the QoS dispatcher (``dispatch``), the program format (``program``), a
single-device worker (``worker``) that also serves GENERATE and KV_SHIP
through a hosted serving engine, its client (``client``), and pooled
worker-to-worker links (``fabric``).  State, migration and the peer
fabric's collectives come with a later part."""

from .client import (RemoteBuffer, RemoteBusyError, RemoteDeadlineError,
                     RemoteDevice, RemoteExecutionError)
from .dispatch import BusyError, LatencyRecorder, qos_weight
from .worker import RemoteVTPUWorker

__all__ = ["BusyError", "LatencyRecorder", "RemoteBuffer", "RemoteBusyError",
           "RemoteDeadlineError", "RemoteDevice", "RemoteExecutionError",
           "RemoteVTPUWorker", "qos_weight"]
