"""Remote execution of the port: the TPFR wire protocol (``protocol``),
the QoS dispatcher (``dispatch``), the program format (``program``), a
single-device worker (``worker``) that also serves GENERATE and KV_SHIP
through a hosted serving engine, the federated collectives, the peer
fabric, SNAPSHOT / RESTORE and streaming live migration, its client
(``client``), pooled worker-to-worker links (``fabric``) and federated
meshes of workers (``federation``)."""

from .client import (RemoteBuffer, RemoteBusyError, RemoteDeadlineError,
                     RemoteDevice, RemoteExecutionError)
from .dispatch import BusyError, LatencyRecorder, qos_weight
from .federation import (FederatedDevice, FederatedFunction, FedStep,
                         ModelParallelFunction)
from .worker import RemoteVTPUWorker

__all__ = ["BusyError", "FedStep", "FederatedDevice", "FederatedFunction",
           "LatencyRecorder", "ModelParallelFunction", "RemoteBuffer",
           "RemoteBusyError", "RemoteDeadlineError", "RemoteDevice",
           "RemoteExecutionError", "RemoteVTPUWorker", "qos_weight"]
