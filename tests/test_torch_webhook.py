"""The port's admission webhook (tensorfusion_tpu_torch.webhook) against the
reference's (tensorfusion_tpu.webhook).

The reference's own cases (tests/test_webhook.py) run here as one
parametrised test each, over both packages.  Beside them: a seeded set of
annotation sets mutates into equal pods and equal TPUWorkloads in both
packages, and a duty request on ``h100-sxm`` normalises against the port's
chip table to its TFLOPs (25% of 989 TFLOP/s is 247.25).
"""

import dataclasses
import importlib
import types

import numpy as np
import pytest

import tensorfusion_tpu.api as ref_api
import tensorfusion_tpu.api.types as ref_types
import tensorfusion_tpu.store as ref_store
import tensorfusion_tpu.webhook as ref_webhook
import tensorfusion_tpu.webhook.auto_migration as ref_auto_migration
import tensorfusion_tpu_torch.api as port_api
import tensorfusion_tpu_torch.api.types as port_types
import tensorfusion_tpu_torch.store as port_store
import tensorfusion_tpu_torch.webhook as port_webhook
import tensorfusion_tpu_torch.webhook.auto_migration as port_auto_migration
from tensorfusion_tpu import constants as ref_constants
from tensorfusion_tpu_torch import constants as port_constants

# the packages' ``config`` re-exports a function of the module's name
ref_chip_info = importlib.import_module("tensorfusion_tpu.config.chip_info")
port_chip_info = importlib.import_module("tensorfusion_tpu_torch.config.chip_info")

PKGS = {
    "ref": types.SimpleNamespace(api=ref_api, types=ref_types, store=ref_store,
                                 webhook=ref_webhook, auto_migration=ref_auto_migration,
                                 chip_info=ref_chip_info, constants=ref_constants),
    "port": types.SimpleNamespace(api=port_api, types=port_types, store=port_store,
                                  webhook=port_webhook, auto_migration=port_auto_migration,
                                  chip_info=port_chip_info, constants=port_constants),
}


@pytest.fixture(params=sorted(PKGS))
def m(request):
    return PKGS[request.param]


def make_parser(m, store=None):
    v5e = m.types.ChipModelInfo(generation="v5e", bf16_tflops=197.0, hbm_bytes=16 * 2**30)
    return m.webhook.WorkloadParser(store, chip_models={"v5e": v5e}, default_pool="pool-a")


def pod_with(m, ann, name="p1"):
    pod = m.types.Pod.new(name, namespace="default")
    pod.metadata.annotations.update(ann)
    pod.spec.containers = [m.types.Container(name="main")]
    return pod


# -- the reference's cases (tests/test_webhook.py), both packages ------------

def test_parse_inline_annotations(m):
    c = m.constants
    spec = make_parser(m).parse(pod_with(m, {
        c.ANN_TFLOPS_REQUEST: "50", c.ANN_HBM_REQUEST: "4Gi", c.ANN_QOS: "high",
        c.ANN_ISOLATION: "hard", c.ANN_CHIP_COUNT: "2"}))
    assert spec.resources.requests.tflops == 50.0
    assert spec.resources.requests.hbm_bytes == 4 * 2**30
    assert spec.qos == "high"
    assert spec.isolation == "hard"
    assert spec.chip_count == 2
    assert spec.pool == "pool-a"          # default pool
    assert spec.resources.limits.tflops == 50.0  # limit defaults to request


def test_parse_duty_normalization(m):
    c = m.constants
    p = make_parser(m)
    spec = p.parse(pod_with(m, {c.ANN_DUTY_REQUEST: "25", c.ANN_HBM_REQUEST: "1Gi",
                                c.ANN_CHIP_GENERATION: "v5e"}))
    assert spec.resources.requests.tflops == pytest.approx(49.25)

    spec2 = p.parse(pod_with(m, {c.ANN_TFLOPS_REQUEST: "98.5", c.ANN_HBM_REQUEST: "1Gi",
                                 c.ANN_CHIP_GENERATION: "v5e"}))
    assert spec2.resources.requests.duty_percent == pytest.approx(50.0)


def test_parse_errors(m):
    c = m.constants
    p = make_parser(m)
    with pytest.raises(m.webhook.ParseError):
        p.parse(pod_with(m, {c.ANN_QOS: "platinum", c.ANN_TFLOPS_REQUEST: "1"}))
    with pytest.raises(m.webhook.ParseError):
        p.parse(pod_with(m, {c.ANN_ISOLATION: "bulletproof", c.ANN_TFLOPS_REQUEST: "1"}))
    with pytest.raises(m.webhook.ParseError):
        p.parse(pod_with(m, {c.ANN_CHIP_COUNT: "500", c.ANN_TFLOPS_REQUEST: "1"}))
    with pytest.raises(m.webhook.ParseError):  # no resources at all
        p.parse(pod_with(m, {c.ANN_QOS: "high"}))


def test_parse_profile_reference_with_overrides(m):
    c = m.constants
    store = m.store.ObjectStore()
    profile = m.types.WorkloadProfile.new("base", namespace="default")
    profile.spec.pool = "pool-b"
    profile.spec.resources.requests = m.api.ResourceAmount(tflops=10.0, hbm_bytes=2**30)
    profile.spec.qos = "low"
    store.create(profile)
    p = make_parser(m, store)
    spec = p.parse(pod_with(m, {c.ANN_WORKLOAD_PROFILE: "base", c.ANN_QOS: "critical"}))
    assert spec.pool == "pool-b"
    assert spec.resources.requests.tflops == 10.0
    assert spec.qos == "critical"

    with pytest.raises(m.webhook.ParseError):
        p.parse(pod_with(m, {c.ANN_WORKLOAD_PROFILE: "missing"}))


def test_mutator_stamps_contract_and_workload(m):
    c = m.constants
    store = m.store.ObjectStore()
    mut = m.webhook.PodMutator(store, make_parser(m, store), operator_url="http://op:8080")
    out = mut.handle(pod_with(m, {c.ANN_TFLOPS_REQUEST: "30", c.ANN_HBM_REQUEST: "1Gi"}))
    ann = out.metadata.annotations
    assert out.spec.scheduler_name == c.SCHEDULER_NAME
    assert out.spec.priority == 100       # medium QoS
    assert ann[c.ANN_WORKLOAD] == "p1"
    wl = store.get(m.types.TPUWorkload, "p1", "default")
    assert wl.spec.resources.requests.tflops == 30.0
    env = out.spec.containers[0].env
    assert env[c.ENV_VTPU_ENABLED] == "1"
    assert env[c.ENV_OPERATOR_URL] == "http://op:8080"


def test_mutator_ignores_non_tpu_pods(m):
    store = m.store.ObjectStore()
    out = m.webhook.PodMutator(store, make_parser(m, store)).handle(pod_with(m, {}))
    assert out.spec.scheduler_name == "default"
    assert not store.list(m.types.TPUWorkload)


def native_pod(m, chips=2, name="native", labels=None):
    pod = m.types.Pod.new(name, namespace="default")
    pod.spec.containers = [m.types.Container(name="main", chip_count=chips)]
    if labels:
        pod.metadata.labels.update(labels)
    return pod


def test_native_pod_untouched_by_default(m):
    store = m.store.ObjectStore()
    out = m.webhook.PodMutator(store, make_parser(m, store)).handle(native_pod(m))
    assert out.spec.scheduler_name == "default"
    assert not store.list(m.types.TPUWorkload)


def test_native_pod_progressive_migration_proxies_scheduler(m, monkeypatch):
    monkeypatch.setenv(m.auto_migration.ENV_PROGRESSIVE_MIGRATION, "true")
    store = m.store.ObjectStore()
    mut = m.webhook.PodMutator(store, make_parser(m, store))
    out = mut.handle(native_pod(m))
    assert out.spec.scheduler_name == m.constants.SCHEDULER_NAME
    assert not store.list(m.types.TPUWorkload)
    out2 = mut.handle(native_pod(m, name="optout",
                                 labels={m.constants.LABEL_ENABLED: "false"}))
    assert out2.spec.scheduler_name == "default"


def test_native_pod_auto_migrated_to_whole_chip_workload(m):
    c = m.constants
    store = m.store.ObjectStore()
    mut = m.webhook.PodMutator(store, make_parser(m, store))
    mut.auto_migration = {"enable": True}
    out = mut.handle(native_pod(m, chips=2))
    ann = out.metadata.annotations
    assert out.metadata.labels[c.LABEL_ENABLED] == "true"
    assert out.spec.scheduler_name == c.SCHEDULER_NAME
    assert ann[c.ANN_CHIP_COUNT] == "2"
    assert float(ann[c.ANN_DUTY_REQUEST]) == 100.0
    assert ann[c.ANN_CONTAINER_CHIP_COUNT] == '{"main": 2}'
    wl = store.get(m.types.TPUWorkload, "native", "default")
    assert wl.spec.chip_count == 2
    assert wl.spec.resources.requests.duty_percent == 100.0


def test_auto_migration_scope_rules(m):
    should = m.auto_migration.should_auto_migrate
    store = m.store.ObjectStore()
    ns = m.types.Namespace.new("prod")
    ns.metadata.labels["tier"] = "gpu"
    store.create(ns)

    cfg = {"enable": True,
           "scope": {"includes": {"namespace_names": ["default"]},
                     "excludes": {"pod_selector": {"skip": "me"}}}}
    assert should(native_pod(m), cfg, store)
    assert not should(native_pod(m, labels={"skip": "me"}), cfg, store)

    pod = native_pod(m)
    pod.metadata.namespace = "prod"
    cfg2 = {"enable": True, "scope": {"includes": {"namespace_selector": {"tier": "gpu"}}}}
    assert should(pod, cfg2, store)
    cfg3 = {"enable": True, "scope": {"includes": {"namespace_selector": {"tier": "cpu"}}}}
    assert not should(pod, cfg3, store)

    assert not should(native_pod(m, labels={m.constants.LABEL_ENABLED: "false"}),
                      {"enable": True}, store)
    assert not should(native_pod(m), {"enable": False}, store)
    assert not should(native_pod(m), {}, store)


def test_native_pod_fail_open_when_unconvertible(m):
    store = m.store.ObjectStore()
    mut = m.webhook.PodMutator(store, make_parser(m, store))
    mut.auto_migration = {"enable": True}
    out = mut.handle(native_pod(m, chips=129, name="huge"))
    assert m.constants.LABEL_ENABLED not in out.metadata.labels
    assert out.spec.scheduler_name == "default"
    assert not store.list(m.types.TPUWorkload)


def test_native_pod_fail_open_still_proxies(m, monkeypatch):
    monkeypatch.setenv(m.auto_migration.ENV_PROGRESSIVE_MIGRATION, "1")
    store = m.store.ObjectStore()
    mut = m.webhook.PodMutator(store, make_parser(m, store))
    mut.auto_migration = {"enable": True}
    out = mut.handle(native_pod(m, chips=129, name="huge2"))
    assert m.constants.LABEL_ENABLED not in out.metadata.labels
    assert out.spec.scheduler_name == m.constants.SCHEDULER_NAME


def test_enabled_label_without_resources_rejected(m):
    store = m.store.ObjectStore()
    mut = m.webhook.PodMutator(store, make_parser(m, store))
    pod = m.types.Pod.new("labeled", namespace="default")
    pod.metadata.labels[m.constants.LABEL_ENABLED] = "true"
    pod.spec.containers = [m.types.Container(name="main")]
    with pytest.raises(m.webhook.ParseError):
        mut.handle(pod)


# -- mutated pods carried across ---------------------------------------------

def _annotation_set(c, rng, i):
    """One seeded user request: any mix of TFLOPs or duty, HBM, limits,
    chip count and indices, generation, QoS, isolation, a partition
    template, gang settings and worker flags."""
    ann = {}
    if rng.random() < 0.5:
        ann[c.ANN_TFLOPS_REQUEST] = str(int(rng.integers(1, 400)))
    else:
        ann[c.ANN_DUTY_REQUEST] = str(int(rng.integers(1, 100)))
    ann[c.ANN_HBM_REQUEST] = str(rng.choice(["512Mi", "1Gi", "4Gi", "30Gi", "1500000000"]))
    if rng.random() < 0.3:
        ann[c.ANN_TFLOPS_LIMIT] = str(int(rng.integers(100, 900)))
    if rng.random() < 0.3:
        ann[c.ANN_HBM_LIMIT] = "40Gi"
    if rng.random() < 0.3:
        ann[c.ANN_DUTY_LIMIT] = str(int(rng.integers(50, 100)))
    if rng.random() < 0.4:
        ann[c.ANN_CHIP_COUNT] = str(int(rng.integers(1, 9)))
    if rng.random() < 0.2:
        ann[c.ANN_CHIP_INDICES] = "0,2"
    if rng.random() < 0.7:
        ann[c.ANN_CHIP_GENERATION] = str(rng.choice(["v5e", "v5p", "h100-sxm", "h100-pcie",
                                                     "h100-nvl"]))
    if rng.random() < 0.6:
        ann[c.ANN_QOS] = str(rng.choice(c.QOS_LEVELS))
    if rng.random() < 0.5:
        ann[c.ANN_ISOLATION] = str(rng.choice(c.ISOLATION_MODES))
    if rng.random() < 0.1:
        ann[c.ANN_PARTITION_NAME] = "h100-sxm-full"
    if rng.random() < 0.3:
        ann[c.ANN_POOL] = "pool-h100"
    if rng.random() < 0.3:
        ann[c.ANN_WORKLOAD] = f"wl-{i % 3}"
        ann[c.ANN_GANG_ENABLED] = "true"
        if rng.random() < 0.5:
            ann[c.ANN_GANG_MIN_MEMBERS] = str(int(rng.integers(2, 5)))
        if rng.random() < 0.5:
            ann[c.ANN_GANG_TIMEOUT] = "2"
    for flag in (c.ANN_DEDICATED_WORKER, c.ANN_SIDECAR_WORKER, c.ANN_IS_LOCAL_TPU):
        if rng.random() < 0.1:
            ann[flag] = "true"
    return ann


def _mutated(m, ann_sets):
    store = m.store.ObjectStore()
    # one chip table for both: the port's, H100 rows included
    models = {g: m.types.ChipModelInfo(**dataclasses.asdict(info))
              for g, info in port_chip_info.CHIP_INFO_DB.items()}
    parser = m.webhook.WorkloadParser(store, chip_models=models, default_pool="pool-a")
    mut = m.webhook.PodMutator(store, parser, operator_url="http://store:8080")
    pods, refused = [], []
    for i, ann in enumerate(ann_sets):
        pod = m.types.Pod.new(f"pod-{i}", namespace="default")
        pod.metadata.annotations.update(ann)
        pod.spec.containers = [m.types.Container(name="main")]
        try:
            pods.append(mut.handle(pod).to_dict())
        except m.webhook.ParseError as e:
            refused.append((i, str(e)))
    workloads = sorted((w.to_dict() for w in store.list(m.types.TPUWorkload)),
                       key=lambda d: d["metadata"]["name"])
    for w in workloads:
        for k in ("resource_version", "uid", "creation_timestamp", "generation"):
            w["metadata"].pop(k, None)
    for p in pods:
        for k in ("resource_version", "uid", "creation_timestamp", "generation"):
            p["metadata"].pop(k, None)
    return pods, refused, workloads


def test_seeded_annotation_sets_mutate_into_equal_pods_in_both_packages():
    rng = np.random.default_rng(14)
    # the strings are the same in both packages, so one set serves both
    ann_sets = [_annotation_set(ref_constants, rng, i) for i in range(120)]
    ref_pods, ref_refused, ref_wls = _mutated(PKGS["ref"], ann_sets)
    port_pods, port_refused, port_wls = _mutated(PKGS["port"], ann_sets)
    assert port_refused == ref_refused
    assert port_pods == ref_pods
    assert port_wls == ref_wls
    assert len(ref_pods) > 100 and ref_wls
    # the sets cover gangs, duty normalisation and H100 generations
    stamped = [p["metadata"]["annotations"] for p in ref_pods]
    assert any(a.get(ref_constants.ANN_GANG_GROUP_KEY) for a in stamped)
    assert any(a.get(ref_constants.ANN_CHIP_GENERATION, "").startswith("h100") for a in stamped)


def test_h100_duty_request_normalises_to_tflops_in_the_port():
    c = port_constants
    store = port_store.ObjectStore()
    parser = port_webhook.WorkloadParser(store, chip_models=port_chip_info.mock_chip_info())
    mut = port_webhook.PodMutator(store, parser)
    pod = port_types.Pod.new("tenant", namespace="default")
    pod.metadata.annotations.update({
        c.ANN_CHIP_GENERATION: "h100-sxm", c.ANN_DUTY_REQUEST: "25",
        c.ANN_HBM_REQUEST: str(30 << 30), c.ANN_ISOLATION: c.ISOLATION_SOFT,
        c.ANN_QOS: c.QOS_LOW})
    ann = mut.handle(pod).metadata.annotations
    assert ann[c.ANN_TFLOPS_REQUEST] == "247.25"
    assert float(ann[c.ANN_DUTY_REQUEST]) == 25.0
    assert ann[c.ANN_HBM_REQUEST] == str(30 << 30)
    assert pod.spec.priority == 0 and pod.spec.scheduler_name == c.SCHEDULER_NAME
    # and back: 247.25 TFLOPs on the card is a 25% duty share
    back = port_types.Pod.new("back", namespace="default")
    back.metadata.annotations.update({c.ANN_CHIP_GENERATION: "h100-sxm",
                                      c.ANN_TFLOPS_REQUEST: "247.25",
                                      c.ANN_HBM_REQUEST: "1Gi"})
    spec = parser.parse(back)
    assert spec.resources.requests.duty_percent == pytest.approx(25.0)
    # the same request, with the reference's table, has no H100 row
    ref_parser = ref_webhook.WorkloadParser(chip_models=ref_chip_info.mock_chip_info())
    ref_pod = ref_types.Pod.new("tenant", namespace="default")
    ref_pod.metadata.annotations.update({c.ANN_CHIP_GENERATION: "h100-sxm",
                                         c.ANN_DUTY_REQUEST: "25", c.ANN_HBM_REQUEST: "1Gi"})
    assert ref_parser.parse(ref_pod).resources.requests.tflops == 0.0
