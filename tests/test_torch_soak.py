"""Cluster churn soak over the port's operator (tests/test_soak.py, whose
operator is the reference's): concurrent submit/delete/defrag/migrate
traffic against a live ``tensorfusion_tpu_torch`` operator, with the
accounting invariants checked at the end.
"""

import random
import threading
import time

import pytest

pytest.importorskip("torch")

from tensorfusion_tpu_torch import constants  # noqa: E402
from tensorfusion_tpu_torch.api.types import (Container, Pod,  # noqa: E402
                                              TPUNodeClaim, TPUPool)
from tensorfusion_tpu_torch.operator import Operator  # noqa: E402


def _make_operator(hosts=3):
    op = Operator()
    pool = TPUPool.new("pool-a")
    pool.spec.name = "pool-a"
    op.store.create(pool)
    for i in range(hosts):
        claim = TPUNodeClaim.new(f"soak-h{i}")
        claim.spec.pool = "pool-a"
        claim.spec.generation = "v5e"
        claim.spec.chip_count = 4
        op.store.create(claim)
    op.start()
    deadline = time.time() + 5
    while len(op.allocator.chips()) < hosts * 4 and time.time() < deadline:
        time.sleep(0.02)
    return op


def _pod(name, tflops, hbm):
    pod = Pod.new(name, namespace="soak")
    ann = pod.metadata.annotations
    ann[constants.ANN_POOL] = "pool-a"
    ann[constants.ANN_TFLOPS_REQUEST] = str(tflops)
    ann[constants.ANN_HBM_REQUEST] = str(hbm)
    ann[constants.ANN_IS_LOCAL_TPU] = "true"
    pod.spec.containers = [Container(name="main")]
    return pod


def test_churn_soak_accounting_invariants():
    op = _make_operator(hosts=3)
    rng = random.Random(42)
    stop = threading.Event()
    errors = []
    submitted = []
    lock = threading.Lock()
    seq = [0]

    def submitter():
        try:
            while not stop.is_set():
                with lock:
                    seq[0] += 1
                    name = f"p{seq[0]}"
                op.submit_pod(_pod(name, rng.choice([10, 25, 60, 120]),
                                   rng.choice([2**28, 2**30, 4 * 2**30])))
                with lock:
                    submitted.append(name)
                time.sleep(rng.uniform(0.005, 0.03))
        except Exception as e:  # noqa: BLE001
            errors.append(("submit", e))

    def deleter():
        try:
            while not stop.is_set():
                with lock:
                    name = submitted.pop(rng.randrange(len(submitted))) \
                        if len(submitted) > 4 else None
                if name:
                    try:
                        op.store.delete(Pod, name, "soak")
                    except Exception:  # noqa: BLE001 - races with rebinds
                        pass
                time.sleep(rng.uniform(0.01, 0.05))
        except Exception as e:  # noqa: BLE001
            errors.append(("delete", e))

    def disruptor():
        try:
            while not stop.is_set():
                nodes = {c.chip.status.node_name
                         for c in op.allocator.chips("pool-a")}
                if nodes:
                    node = rng.choice(sorted(nodes))
                    if rng.random() < 0.5:
                        op.compaction.defrag_node("pool-a", node)
                    else:
                        with lock:
                            name = rng.choice(submitted) if submitted \
                                else None
                        if name:
                            op.migrator.migrate("soak", name,
                                                wait_rebind_s=2.0)
                time.sleep(rng.uniform(0.2, 0.4))
        except Exception as e:  # noqa: BLE001
            errors.append(("disrupt", e))

    threads = [threading.Thread(target=submitter),
               threading.Thread(target=deleter),
               threading.Thread(target=disruptor)]
    try:
        for t in threads:
            t.start()
        time.sleep(12.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)

    try:
        assert not errors, errors
        # settle: let in-flight cycles finish and the TTL sweep run
        op.allocator.sweep_assumed()
        time.sleep(2.0)

        live = {p.metadata.name: p for p in op.store.list(Pod,
                                                          namespace="soak")}
        # 1. every committed allocation belongs to a live pod, and its chips
        #    agree with the pod's binding
        for rec in op.allocator.allocations():
            if rec.assumed:
                continue   # in-flight cycle; TTL sweep owns these
            ns, name = rec.request.key().split("/", 1)
            assert ns == "soak"
            pod = live.get(name)
            assert pod is not None, f"allocation {rec.request.key()} " \
                                    f"outlived its pod"
            if pod.spec.node_name:
                for chip_name in rec.chip_ids:
                    state = op.allocator.get_chip(chip_name)
                    assert state is not None
                    assert state.chip.status.node_name == pod.spec.node_name

        # 2. chip accounting self-consistency: holders sum to allocated,
        #    nothing negative, within virtual capacity
        for state in op.allocator.chips("pool-a"):
            total_t = sum(a.tflops for a in state.holders.values())
            assert state.allocated.tflops == pytest.approx(total_t, abs=1e-6)
            assert state.allocated.tflops >= -1e-6
            assert state.allocated.tflops <= \
                state.virtual_capacity().tflops + 1e-6
            # every holder is a live pod or an assumed in-flight record
            for key in state.holders:
                rec = op.allocator.allocation(key)
                assert rec is not None, f"orphan hold {key} on " \
                                        f"{state.chip.name}"

        # 3. no duplicate pod indices among live pods
        indices = [p.metadata.annotations.get(constants.ANN_POD_INDEX)
                   for p in live.values()
                   if p.metadata.annotations.get(constants.ANN_POD_INDEX)]
        assert len(indices) == len(set(indices)), "duplicate pod indices"

        # 4. the cluster still schedules after the churn, and ghosts of
        #    deleted-while-pending pods never re-enter the cycle
        op.submit_pod(_pod("final-check", 10, 2**28))
        bound = op.wait_for_binding("final-check", namespace="soak")
        assert bound is not None and bound.spec.node_name
        assert not op.scheduler._forgotten or \
            len(op.scheduler._forgotten) < 5   # tombstones get consumed
    finally:
        op.stop()
