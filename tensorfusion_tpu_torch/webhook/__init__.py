"""Admission webhook: annotation parsing + pod mutation (the port's copy
of ``tensorfusion_tpu/webhook``)."""

from .mutator import AdmissionShedError, PodMutator
from .parser import ParseError, WorkloadParser
