"""Synthetic pod-churn trace generation for the digital twin.

The port's copy of ``tensorfusion_tpu/sim/trace.py``.

Seed-reproducible cluster topologies and workload churn against the
real admission path: nodes + chips register through
``Operator.register_host`` (the same call the hypervisor's control-
plane backend makes), workloads are TPUWorkload objects the real
WorkloadController expands into worker pods, and churn (scale-ups,
scale-downs, deletes) lands as timed store writes.

Scales to 100k-pod traces: generation is O(events) and the harness
replays in virtual time, so trace size is bounded by CPU, not by
wall-clock sleeps.
"""

from __future__ import annotations

from typing import List, Optional

from ..api import ResourceAmount, TPUChip
from ..api.types import TPUWorkload
from ..store import NotFoundError, mutate
from .harness import SimHarness

V5E_TFLOPS = 197.0
V5E_HBM = 16 * 2**30


def make_chip(name: str, node: str, pool: str = "pool-a",
              generation: str = "v5e", cores: int = 1) -> TPUChip:
    chip = TPUChip.new(name)
    st = chip.status
    st.phase = "Running"
    st.capacity = ResourceAmount(tflops=V5E_TFLOPS, duty_percent=100,
                                 hbm_bytes=V5E_HBM)
    st.available = st.capacity
    st.generation = generation
    st.vendor = "sim-tpu"
    st.node_name = node
    st.pool = pool
    st.core_count = cores
    st.host_index = int(name.rsplit("-", 1)[-1]) \
        if name.rsplit("-", 1)[-1].isdigit() else 0
    st.capabilities = {"core_partitioning": cores > 1,
                       "soft_isolation": True, "hard_isolation": True}
    return chip


class TraceGenerator:
    """Builds topology + schedules seeded churn on a harness."""

    def __init__(self, harness: SimHarness, pool: str = "pool-a"):
        self.h = harness
        self.pool = pool
        self.node_names: List[str] = []

    # -- topology ---------------------------------------------------------

    def build_cluster(self, nodes: int, chips_per_node: int = 4,
                      generation: str = "v5e") -> List[str]:
        from ..api.types import TPUPool

        if self.h.store.try_get(TPUPool, self.pool) is None:
            pool = TPUPool.new(self.pool)
            pool.spec.name = self.pool
            self.h.store.create(pool)
        for i in range(nodes):
            node = f"sim-node-{i:04d}"
            chips = [make_chip(f"{node}-chip-{c}", node, pool=self.pool,
                               generation=generation)
                     for c in range(chips_per_node)]
            self.h.op.register_host(node, chips)
            self.node_names.append(node)
        self.h.pump()
        return self.node_names

    # -- workloads --------------------------------------------------------

    def make_workload(self, name: str, replicas: int,
                      tflops: float = 20.0, hbm_gib: float = 1.0,
                      gang: bool = False, strict: bool = False,
                      gang_timeout_s: float = 0.0,
                      namespace: str = "default",
                      qos: str = "medium") -> TPUWorkload:
        wl = TPUWorkload.new(name, namespace=namespace)
        wl.spec.pool = self.pool
        wl.spec.replicas = replicas
        wl.spec.chip_count = 1
        wl.spec.qos = qos
        wl.spec.resources.requests = ResourceAmount(
            tflops=tflops, hbm_bytes=hbm_gib * 2**30)
        wl.spec.resources.limits = ResourceAmount(
            tflops=tflops * 2, hbm_bytes=hbm_gib * 2**30)
        if gang:
            wl.spec.gang.enabled = True
            wl.spec.gang.min_members = replicas if strict else 0
            if gang_timeout_s:
                wl.spec.gang.timeout_seconds = gang_timeout_s
        return wl

    def submit_workload(self, wl: TPUWorkload) -> TPUWorkload:
        return self.h.store.create(wl)

    def scale_workload(self, name: str, replicas: int,
                       namespace: str = "default") -> None:
        def set_replicas(wl):
            if wl.spec.replicas == replicas:
                return False
            wl.spec.replicas = replicas
        mutate(self.h.store, TPUWorkload, name, set_replicas,
               namespace=namespace)

    def delete_workload(self, name: str,
                        namespace: str = "default") -> None:
        try:
            self.h.store.delete(TPUWorkload, name, namespace)
        except NotFoundError:
            pass

    # -- churn ------------------------------------------------------------

    def seeded_churn(self, duration_s: float, workloads: int,
                     max_replicas: int = 4, start_at: float = 1.0,
                     tflops: float = 20.0) -> None:
        """Schedule a seed-reproducible churn trace: ``workloads``
        arrivals spread over ``duration_s``, each rescaled once or
        twice and some deleted before the end."""
        rng = self.h.rng
        for i in range(workloads):
            name = f"churn-wl-{i:05d}"
            t0 = start_at + rng.uniform(0.0, duration_s * 0.5)
            replicas = rng.randint(1, max_replicas)

            def submit(name=name, replicas=replicas):
                self.submit_workload(
                    self.make_workload(name, replicas, tflops=tflops))
            self.h.at(t0, submit)

            t1 = t0 + rng.uniform(1.0, duration_s * 0.3)
            new_replicas = rng.randint(1, max_replicas)

            def rescale(name=name, new_replicas=new_replicas):
                self.scale_workload(name, new_replicas)
            self.h.at(t1, rescale)

            if rng.random() < 0.2:
                t2 = t1 + rng.uniform(1.0, duration_s * 0.3)

                def drop(name=name):
                    self.delete_workload(name)
                self.h.at(t2, drop)
