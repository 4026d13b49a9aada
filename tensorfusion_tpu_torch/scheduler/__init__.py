"""Accelerator-first scheduler: framework, fit plugin, topology, gangs (the
port's copy of ``tensorfusion_tpu/scheduler``, without the expander, which
waits for the operator's cloud providers)."""

from .framework import (Code, CycleState, OK, Plugin, Scheduler, Status,
                        WaitingPod)
from .gang import GangGroup, GangManager, gang_info_from_pod
from .topo import ICITopologyPlugin, NodeTopologyPlan, plan_for_node
from .tpuresources import TPUResourcesFit, compose_alloc_request
