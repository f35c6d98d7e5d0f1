"""PyTorch port parity: the control plane and the operator entry point
against the JAX package's.

The port keeps its own copies of ``controlplane/`` (13 modules) and
``cmd/operator.py``, with one rename: the ``gpu`` driver
(``GpuDriverConfig``, ``spec.driver.gpu``, the ``coraza-gpu-engine-``
Deployment running the ``gpu-engine`` container on ``nvidia.com/gpu``)
takes the place of the reference's ``tpu`` driver. Each case of
``tests/test_controlplane.py``, ``test_cel.py``, ``test_kubeclient.py`` and
``test_operator_cmd.py`` runs on both packages and the outputs are compared
exactly: the istio driver's renders, every RuleSet status, event and cache
entry as they are; the gpu driver's renders, statuses, events and errors
equal to the tpu driver's after ``RENAMES`` and nothing else. The one
deviation, ``maxBatchDelayMs`` defaulting to 100 rather than 2, shows only
where a test leaves it at its default (``test_gpu_defaults_differ_only_in_
batch_delay``). Last, ``gpu-engine``'s ``build_config`` accepts every
argument the controller renders.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import shutil
import ssl
import subprocess
import threading
import time
from datetime import datetime
from types import SimpleNamespace

import pytest
import yaml

RENAMES = (
    ("coraza-tpu-engine-", "coraza-gpu-engine-"),
    ("tpu-engine", "gpu-engine"),
    ("google.com/tpu", "nvidia.com/gpu"),
    ("TpuEngineProvisioned", "GpuEngineProvisioned"),
    ("TPU engine", "GPU engine"),
    ('"tpu"', '"gpu"'),
    ("driver.tpu.", "driver.gpu."),
    ("self.tpu", "self.gpu"),
)
# Fields that differ from run to run (ids, clocks, resource versions).
VOLATILE = {"uid", "resource_version", "creation_timestamp", "last_transition_time", "timestamp",
            "lastTransitionTime", "resourceVersion", "creationTimestamp"}
NS = "test-ns"
FAKE_IMAGE = "oci://fake-registry.io/fake-image:latest"
VALID_RULES = 'SecRule REQUEST_URI "@contains /admin" "id:1,phase:1,deny,status:403"'


def _side(root: str, driver: str):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    cp = mod("controlplane")
    return SimpleNamespace(
        driver=driver, cp=cp, api=mod("controlplane.api_types"), cel=mod("controlplane.cel"),
        crdschema=mod("controlplane.crdschema"), manifests=mod("controlplane.manifests"),
        engine_controller=mod("controlplane.engine_controller"),
        ruleset_controller=mod("controlplane.ruleset_controller"),
        kubeapi_fake=mod("controlplane.kubeapi_fake"), kubeclient=mod("controlplane.kubeclient"),
        operator=mod("cmd.operator"), RuleSetCache=mod("cache").RuleSetCache,
        DriverClass=getattr(cp, f"{driver.capitalize()}DriverConfig"),
    )


J = _side("coraza_kubernetes_operator_tpu", "tpu")
T = _side("coraza_kubernetes_operator_tpu_torch", "gpu")


def dump(x):
    """Plain data of an object graph (dataclasses, dicts, lists), without
    the volatile fields."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: dump(getattr(x, f.name)) for f in dataclasses.fields(x) if f.name not in VOLATILE}
    if isinstance(x, dict):
        return {k: dump(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, (list, tuple)):
        return [dump(v) for v in x]
    if isinstance(x, datetime):
        return "<time>"
    return x


def renamed(x, extra=()):
    s = json.dumps(x, default=str)
    for a, b in RENAMES + tuple(extra):
        s = s.replace(a, b)
    return json.loads(s)


def outcome(fn):
    """``fn()``'s value, or the exception's type name and text."""
    try:
        return {"value": fn()}
    except Exception as err:
        return {"error": f"{type(err).__name__}: {err}"}


def same(scenario, *args, exact=False, extra=()):
    """Run ``scenario(side, *args)`` on both packages; the port's output
    must equal the reference's (after ``RENAMES`` unless ``exact``)."""
    want = dump(scenario(J, *args))
    got = dump(scenario(T, *args))
    if exact:
        assert got == want
    else:
        assert got == renamed(want, extra)
    return got


# -- object builders ------------------------------------------------------


def _ruleset(s, name="rs", refs=("cm",)):
    cp = s.cp
    return cp.RuleSet(metadata=cp.ObjectMeta(name=name, namespace=NS),
                      spec=cp.RuleSetSpec(rules=[cp.RuleSourceReference(r) for r in refs]))


def _configmap(s, name="cm", rules=VALID_RULES, key="rules", annotations=None):
    return s.cp.ConfigMap(metadata=s.cp.ObjectMeta(name=name, namespace=NS, annotations=annotations or {}),
                          data={key: rules})


def _istio(s):
    cp = s.cp
    return cp.DriverConfig(istio=cp.IstioDriverConfig(wasm=cp.IstioWasmConfig(
        image=FAKE_IMAGE, mode="gateway", workload_selector={"matchLabels": {"app": "gw"}},
        rule_set_cache_server=s.api.RuleSetCacheServerConfig(poll_interval_seconds=5))))


def _device(s, **kw):
    """The reference's tpu driver, or the port's gpu driver, with ``kw``."""
    if "gateway_attachment" in kw:
        kw["gateway_attachment"] = s.api.GatewayAttachmentConfig(workload_selector=kw["gateway_attachment"])
    if "poll" in kw:
        kw["rule_set_cache_server"] = s.api.RuleSetCacheServerConfig(poll_interval_seconds=kw.pop("poll"))
    return s.cp.DriverConfig(**{s.driver: s.DriverClass(**kw)})


def _engine(s, name="eng", driver=None):
    cp = s.cp
    return cp.Engine(metadata=cp.ObjectMeta(name=name, namespace=NS),
                     spec=cp.EngineSpec(rule_set=s.api.RuleSetReference("rs"), driver=driver or _istio(s)))


def _env(s):
    return s.cp.ObjectStore(), s.RuleSetCache(), s.cp.FakeRecorder()


def _state(store, recorder, cache=None, keys=()):
    """What a reconcile left: every stored object, every event, and the
    cache entries' rules."""
    objects = {kind: dump(store.list(kind)) for kind in sorted(store._objects)}
    events = [dump(e) for e in recorder.events]
    rules = {k: (cache.get(k).rules if cache.get(k) else None) for k in keys} if cache else {}
    return {"objects": objects, "events": events, "cache": rules}


# -- RuleSet controller ---------------------------------------------------


def _reconcile_ruleset(s, setup):
    store, cache, recorder = _env(s)
    for obj in setup(s):
        store.create(obj)
    r = s.ruleset_controller.RuleSetReconciler(store, cache, recorder)
    result = outcome(lambda: dataclasses.asdict(r.reconcile(NS, "rs")))
    return {"result": result, **_state(store, recorder, cache, [f"{NS}/rs"])}


RULESET_CASES = {
    "happy": lambda s: [_configmap(s), _ruleset(s)],
    "aggregates-in-order": lambda s: [_configmap(s, "cm-a", "SecRuleEngine On"), _configmap(s, "cm-b"),
                                      _ruleset(s, refs=("cm-a", "cm-b"))],
    "missing-configmap": lambda s: [_ruleset(s, refs=("missing-cm",))],
    "missing-rules-key": lambda s: [_configmap(s, key="wrong-key"), _ruleset(s)],
    "invalid-rules": lambda s: [_configmap(s, rules="SecBogusDirective On"), _ruleset(s)],
    "validation-skipped": lambda s: [_configmap(s, annotations={"coraza.io/validation": "false"}),
                                     _ruleset(s)],
    "skipped-then-not-compilable": lambda s: [
        _configmap(s, rules='SecRule ARGS "@rx (" "id:7,phase:2,deny"',
                   annotations={"coraza.io/validation": "false"}), _ruleset(s)],
}


@pytest.mark.parametrize("case", list(RULESET_CASES))
def test_ruleset_reconcile_equal(case):
    got = same(_reconcile_ruleset, RULESET_CASES[case], exact=case != "skipped-then-not-compilable")
    if case == "happy":
        assert got["cache"] == {f"{NS}/rs": VALID_RULES}
        assert any(c["type"] == "Ready" and c["status"] == "True"
                   for c in got["objects"]["RuleSet"][0]["status"]["conditions"])


def test_ruleset_update_rotates_uuid_equal():
    def run(s):
        store, cache, recorder = _env(s)
        cm = store.create(_configmap(s))
        store.create(_ruleset(s))
        r = s.ruleset_controller.RuleSetReconciler(store, cache, recorder)
        r.reconcile(NS, "rs")
        first = cache.get(f"{NS}/rs").uuid
        cm.data["rules"] = 'SecRule REQUEST_URI "@contains /blocked" "id:2,phase:1,deny,status:403"'
        store.update(cm)
        r.reconcile(NS, "rs")
        return {"rotated": cache.get(f"{NS}/rs").uuid != first, **_state(store, recorder, cache, [f"{NS}/rs"])}

    assert same(run, exact=True)["rotated"]


# -- Engine controller ----------------------------------------------------


def _reconcile_engine(s, driver_kw=None, policy=None, cluster="outbound|80||cache.svc", delete=False):
    store, _cache, recorder = _env(s)
    engine = _engine(s, driver=None if driver_kw is None else _device(s, **driver_kw))
    if policy:
        engine.spec.failure_policy = policy
    store.create(engine)
    r = s.engine_controller.EngineReconciler(store, recorder, cache_server_cluster=cluster)
    result = outcome(lambda: dataclasses.asdict(r.reconcile(NS, "eng")))
    if delete:
        store.delete("Engine", NS, "eng")
    return {"result": result, **_state(store, recorder)}


def test_istio_render_equal_exactly():
    """The WasmPlugin, the events and the Engine's status are the
    reference's exactly; the Engine differs only in the name of its unset
    device-driver field."""
    want, got = dump(_reconcile_engine(J)), dump(_reconcile_engine(T))
    for key in ("result", "events", "cache"):
        assert got[key] == want[key]
    assert got["objects"]["WasmPlugin"] == want["objects"]["WasmPlugin"]
    assert got["objects"]["Engine"][0]["status"] == want["objects"]["Engine"][0]["status"]
    assert got["objects"] == renamed(want["objects"])
    plugin = got["objects"]["WasmPlugin"][0]
    assert plugin["spec"]["pluginConfig"]["cache_server_instance"] == f"{NS}/rs"


@pytest.mark.parametrize(
    "driver_kw,policy",
    [
        (dict(poll=7, max_batch_delay_ms=2), None),
        (dict(ext_proc_port=9191, max_batch_delay_ms=2, gateway_attachment={"matchLabels": {"istio": "gw"}}),
         None),
        (dict(max_batch_delay_ms=2, gateway_attachment={"matchLabels": {"istio": "gw"}}), "allow"),
        (dict(replicas=3, max_batch_size=512, max_batch_delay_ms=7, image="registry.local/e:1"), None),
    ],
    ids=["poll-7", "gateway-attachment", "failure-allow", "sized"],
)
def test_gpu_render_equals_tpu_render_renamed(driver_kw, policy):
    got = same(_reconcile_engine, driver_kw, policy)
    dep = got["objects"]["Deployment"][0]
    container = dep["spec"]["template"]["spec"]["containers"][0]
    assert dep["metadata"]["name"] == "coraza-gpu-engine-eng" and container["name"] == "gpu-engine"
    assert container["resources"]["limits"] == {"nvidia.com/gpu": "1"}
    assert set(got["objects"]) >= {"Engine", "Deployment", "Service"}
    assert ("EnvoyFilter" in got["objects"]) is ("gateway_attachment" in driver_kw)


def test_gpu_defaults_differ_only_in_batch_delay():
    """The one deviation: maxBatchDelayMs defaults to 100 on the gpu driver
    (2 on the tpu driver); everything else is the tpu default renamed."""
    got = same(_reconcile_engine, {}, extra=[("--max-batch-delay-ms=2", "--max-batch-delay-ms=100"),
                                             ('"max_batch_delay_ms": 2,', '"max_batch_delay_ms": 100,')])
    args = got["objects"]["Deployment"][0]["spec"]["template"]["spec"]["containers"][0]["args"]
    assert "--max-batch-delay-ms=100" in args and "--extproc-port=9091" in args
    assert J.DriverClass().max_batch_delay_ms == 2 and T.DriverClass().max_batch_delay_ms == 100


@pytest.mark.parametrize("driver", ["istio", "gpu"])
def test_engine_delete_cascades_equal(driver):
    kw = None if driver == "istio" else {"max_batch_delay_ms": 2}
    got = same(_reconcile_engine, kw, None, "c", True)
    assert set(got["objects"]) <= {"Engine", "WasmPlugin", "Deployment", "Service"}
    assert all(not objs for objs in got["objects"].values())


ENGINE_REJECTIONS = {
    "no-driver": lambda s, e: setattr(e.spec.driver, "istio", None),
    "two-drivers": lambda s, e: setattr(e.spec.driver, s.driver, s.DriverClass()),
    "image-scheme": lambda s, e: setattr(e.spec.driver.istio.wasm, "image", "docker://x"),
    "image-length": lambda s, e: setattr(e.spec.driver.istio.wasm, "image", "oci://" + "x" * 1100),
    "no-selector": lambda s, e: setattr(e.spec.driver.istio.wasm, "workload_selector", None),
    "poll-0": lambda s, e: setattr(e.spec.driver.istio.wasm, "rule_set_cache_server",
                                   s.api.RuleSetCacheServerConfig(poll_interval_seconds=0)),
    "failure-policy": lambda s, e: setattr(e.spec, "failure_policy", "sideways"),
    "extproc-port-0": lambda s, e: setattr(e.spec, "driver", _device(s, ext_proc_port=0)),
    "extproc-port-9090": lambda s, e: setattr(e.spec, "driver", _device(s, ext_proc_port=9090)),
    "attachment-no-selector": lambda s, e: setattr(e.spec, "driver", _device(s, gateway_attachment=None)),
    "replicas-0": lambda s, e: setattr(e.spec, "driver", _device(s, replicas=0)),
    "batch-size-0": lambda s, e: setattr(e.spec, "driver", _device(s, max_batch_size=0)),
}


@pytest.mark.parametrize("case", list(ENGINE_REJECTIONS))
def test_engine_validation_rejections_equal(case):
    def run(s):
        store, _c, _r = _env(s)
        engine = _engine(s)
        ENGINE_REJECTIONS[case](s, engine)
        return outcome(lambda: store.create(engine) and None)

    got = same(run)
    assert got["error"].startswith("ValidationError")


def test_ruleset_validation_rejections_equal():
    def run(s):
        store, _c, _r = _env(s)
        return [outcome(lambda: store.create(_ruleset(s, refs=refs)) and None)
                for refs in ((), tuple(f"cm{i}" for i in range(2049)))]

    got = same(run, exact=True)
    assert "at least 1" in got[0]["error"] and "2048" in got[1]["error"]


@pytest.mark.parametrize("attach", [True, False], ids=["attached", "plain"])
def test_manifest_round_trip_equal(attach):
    def run(s):
        kw = dict(ext_proc_port=9191, max_batch_delay_ms=2)
        if attach:
            kw["gateway_attachment"] = {"matchLabels": {"istio": "gw"}}
        doc = s.manifests.object_to_manifest(_engine(s, driver=_device(s, **kw)))
        back = s.manifests.object_from_manifest(doc)
        return {"doc": doc, "back": back.spec, "status": s.manifests.status_to_doc(back)}

    got = same(run)
    assert got["doc"]["spec"]["driver"]["gpu"]["extProcPort"] == 9191
    assert ("gatewayAttachment" in got["doc"]["spec"]["driver"]["gpu"]) is attach


# -- Manager --------------------------------------------------------------


def test_manager_requires_cluster_name_equal():
    same(lambda s: outcome(lambda: s.cp.ControllerManager(*_env(s), cache_server_cluster="") and None),
         exact=True)


@pytest.mark.parametrize("objects", ["ruleset", "istio", "gpu"])
def test_manager_drain_equal(objects):
    def run(s):
        store, cache, recorder = _env(s)
        mgr = s.cp.ControllerManager(store, cache, recorder, cache_server_cluster="c")
        if objects == "ruleset":
            store.create(_configmap(s))
            store.create(_ruleset(s))
            mgr.drain()
            first = cache.get(f"{NS}/rs").uuid
            cm = store.get("ConfigMap", NS, "cm")
            cm.data["rules"] = 'SecRule REQUEST_URI "@contains /v2" "id:9,phase:1,deny,status:403"'
            store.update(cm)
            mgr.drain()
            assert cache.get(f"{NS}/rs").uuid != first
        else:
            # Each apply of an owned object re-queues its Engine (as in the
            # reference), so the queue never empties: drain for a second and
            # compare the distinct events.
            driver = None if objects == "istio" else _device(s, max_batch_delay_ms=2)
            store.create(_engine(s, driver=driver))
            mgr.drain(timeout_s=1.0)
        state = _state(store, recorder, cache, [f"{NS}/rs"])
        state["events"] = sorted({json.dumps(e, sort_keys=True) for e in state["events"]})
        return state

    got = same(run)
    assert got["objects"]


def test_manager_worker_threads_equal():
    def run(s):
        store, cache, recorder = _env(s)
        mgr = s.cp.ControllerManager(store, cache, recorder, cache_server_cluster="c")
        mgr.start()
        try:
            store.create(_configmap(s))
            store.create(_ruleset(s))
            deadline = time.time() + 10
            while cache.get(f"{NS}/rs") is None and time.time() < deadline:
                time.sleep(0.02)
        finally:
            mgr.stop()
        return cache.get(f"{NS}/rs").rules

    assert same(run, exact=True) == VALID_RULES


# -- CEL and the CRDs -----------------------------------------------------

CEL_CASES = [
    ("1 + 2 == 3", {}), ("'a' != 'b'", {}), ("2 > 1 && 1 < 2", {}), ("false || true", {}), ("!false", {}),
    ("true ? 1 : 2", {}), ("'b' in ['a', 'b']", {}),
    ("has(self.istio)", {"istio": {}}), ("has(self.istio)", {}), ("has(self.istio)", {"istio": None}),
    ("has(self.a.b.c)", {"a": {"b": {"c": 1}}}), ("has(self.a.b.c)", {"a": {"b": {}}}),
    ("self.mode != 'gateway' || (has(self.workloadSelector) && has(self.workloadSelector.matchLabels))",
     {"mode": "gateway", "workloadSelector": {"matchLabels": {"a": "b"}}}),
    ("self.mode != 'gateway' || (has(self.workloadSelector) && has(self.workloadSelector.matchLabels))",
     {"mode": "gateway"}),
    ("self.image.startsWith('oci://')", {"image": "oci://x"}), ("self.name.matches('^[a-z]+$')", {"name": "abc"}),
    ("self.msg.contains('boom')", {"msg": "a boom b"}), ("size(self.items) == 2", {"items": [1, 2]}),
    ("self.items.exists(i, i > 1)", {"items": [1, 2]}), ("self.items.all(i, i > 0)", {"items": [1, 2]}),
]


@pytest.mark.parametrize("src,value", CEL_CASES, ids=[f"cel{i}" for i in range(len(CEL_CASES))])
def test_cel_evaluates_equal(src, value):
    same(lambda s: s.cel.compile_rule(src).evaluate(value), exact=True)


@pytest.mark.parametrize("doc", [{"istio": {}}, {"DEV": {}}, {}, {"istio": {}, "DEV": {}}],
                         ids=["istio", "device", "none", "both"])
def test_cel_driver_union_rule_equal(doc):
    def run(s):
        rule = f"[has(self.istio), has(self.{s.driver})].filter(x, x).size() == 1"
        return s.cel.compile_rule(rule).evaluate({k.replace("DEV", s.driver): v for k, v in doc.items()})

    assert same(run, exact=True) is (len(doc) == 1)


@pytest.mark.parametrize("src", ["self.", "has(", "self ~ 3"])
def test_cel_parse_errors_equal(src):
    got = same(lambda s: outcome(lambda: s.cel.compile_rule(src)), exact=True)
    assert got["error"].startswith("CelError")


def test_crds_equal_renamed():
    """The port's CRDs are the repo's with the gpu driver in place of the
    tpu one and the batch delay defaulting to 100: the parsed schemas are
    equal after those renames."""
    want = {k: (c.kind, c.group, c.plural, c.version, c.schema, c.printer_columns)
            for k, c in J.crdschema.load_crds().items()}
    got = json.loads(json.dumps({k: (c.kind, c.group, c.plural, c.version, c.schema, c.printer_columns)
                                 for k, c in T.crdschema.load_crds().items()}))
    want = renamed(want, [("counts and TPU coverage", "counts and device coverage")])
    want["Engine"][4]["properties"]["spec"]["properties"]["driver"]["properties"]["gpu"]["properties"][
        "maxBatchDelayMs"]["default"] = 100
    want["Engine"][4]["description"] = want["Engine"][4]["description"].replace(" tpu ", " gpu ")
    assert got == want


CRD_DOCS = {
    "no-driver": ("Engine", {"metadata": {"name": "x"}, "spec": {"ruleSet": {"name": "rs"}, "driver": {}}}),
    "device-driver": ("Engine", {"metadata": {"name": "x"},
                                 "spec": {"ruleSet": {"name": "rs"}, "driver": {"DEV": {"replicas": 2}}}}),
    "two-drivers": ("Engine", {"metadata": {"name": "x"}, "spec": {"ruleSet": {"name": "rs"}, "driver": {
        "DEV": {}, "istio": {"wasm": {"image": "oci://a", "workloadSelector": {"matchLabels": {"a": "b"}}}}}}}),
    "bad-batch": ("Engine", {"metadata": {"name": "x"},
                             "spec": {"ruleSet": {"name": "rs"}, "driver": {"DEV": {"maxBatchSize": 0}}}}),
    "ruleset-empty": ("RuleSet", {"metadata": {"name": "r"}, "spec": {"rules": []}}),
}


@pytest.mark.parametrize("case", list(CRD_DOCS))
def test_crd_validation_equal(case):
    kind, doc = CRD_DOCS[case]

    def run(s):
        d = json.loads(json.dumps(doc).replace('"DEV"', f'"{s.driver}"'))
        return outcome(lambda: s.crdschema.load_crds()[kind].validate(d))

    got = same(run)
    assert ("error" in got) is (case != "device-driver")


# -- The REST client against the fake API server ---------------------------


def _engine_doc(driver_doc, name="e1"):
    return {"apiVersion": "waf.k8s.coraza.io/v1alpha1", "kind": "Engine",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"ruleSet": {"name": "rs1"}, "driver": driver_doc}}


ISTIO_DOC = {"istio": {"wasm": {"image": "oci://ghcr.io/x/y:1", "mode": "gateway",
                                "workloadSelector": {"matchLabels": {"app": "gw"}}}}}


def _ruleset_doc(name="rs1", rules=("cm1",)):
    return {"apiVersion": "waf.k8s.coraza.io/v1alpha1", "kind": "RuleSet",
            "metadata": {"name": name, "namespace": "default"}, "spec": {"rules": [{"name": r} for r in rules]}}


def _cm_doc(name, rules):
    return {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": name, "namespace": "default"},
            "data": {"rules": rules}}


class Api:
    """A package's fake API server and a client of the same package."""

    def __init__(self, s, **kw):
        self.s = s
        self.srv = s.kubeapi_fake.FakeKubeApiServer(**kw)
        self.srv.start()
        self.client = self.client_for()

    def client_for(self, **kw):
        kc = self.s.kubeclient
        return kc.KubeClient(kc.KubeConfig(host=self.srv.host, port=self.srv.port,
                                           scheme=kw.pop("scheme", "http"), **kw))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.stop()


def _admission(s):
    """Create, read, list, delete, and every admission refusal."""
    with Api(s) as api:
        c = api.client
        out = [dump(c.create("Engine", "default", _engine_doc(ISTIO_DOC))),
               dump(c.get("Engine", "default", "e1")), len(c.list("Engine", "default")["items"])]
        c.delete("Engine", "default", "e1")
        out.append(outcome(lambda: c.get("Engine", "default", "e1")))
        two = _engine_doc({**ISTIO_DOC, s.driver: {"replicas": 1}})
        no_sel = json.loads(json.dumps(_engine_doc(ISTIO_DOC)))
        del no_sel["spec"]["driver"]["istio"]["wasm"]["workloadSelector"]
        bad_image = json.loads(json.dumps(_engine_doc(ISTIO_DOC)).replace("oci://ghcr.io", "docker://x"))
        for kind, doc in (("Engine", two), ("Engine", no_sel), ("Engine", bad_image),
                          ("RuleSet", _ruleset_doc(rules=tuple(f"cm{i}" for i in range(2049)))),
                          ("Engine", _engine_doc({s.driver: {"replicas": 2}}, "e2"))):
            out.append(outcome(lambda: c.create(kind, "default", doc)["metadata"]["name"]))
        return out


def test_kubeclient_admission_equal():
    got = same(_admission)
    assert "404" in got[3]["error"]
    assert "exactly one driver must be configured" in got[4]["error"]
    assert "workloadSelector is required when mode is gateway" in got[5]["error"]
    assert "must match pattern ^oci://" in got[6]["error"]
    assert "must have at most 2048 items" in got[7]["error"]
    assert got[8] == {"value": "e2"}


def test_kubeclient_ssa_and_generation_equal():
    def run(s):
        with Api(s) as api:
            c = api.client
            out = []
            c.server_side_apply("RuleSet", "default", "rs1", _ruleset_doc())
            out.append(c.get("RuleSet", "default", "rs1")["metadata"]["generation"])
            c.server_side_apply("RuleSet", "default", "rs1", _ruleset_doc(rules=("cm1", "cm2")))
            out.append(c.get("RuleSet", "default", "rs1")["metadata"]["generation"])
            c.patch_status("RuleSet", "default", "rs1",
                           {"status": {"conditions": [{"type": "Ready", "status": "True"}]}})
            got = c.get("RuleSet", "default", "rs1")
            out += [got["metadata"]["generation"], got["status"]]
            out.append(outcome(lambda: c.server_side_apply(
                "RuleSet", "default", "rs1", _ruleset_doc(rules=tuple(f"c{i}" for i in range(3000))))))
            return out

    got = same(run, exact=True)
    assert [int(g) for g in got[:3]] == [1, 2, 2] and "error" in got[4]


def _watch(client, kind, **kw):
    """Start a watch of ``kind`` in a thread; returns (the (event, name)
    pairs seen, their lock, the stop event)."""
    seen, lock, stop = [], threading.Lock(), threading.Event()

    def handler(etype, doc):
        with lock:
            seen.append((etype, doc["metadata"]["name"]))

    th = threading.Thread(target=client.watch, args=(kind, handler),
                          kwargs={"namespace": "default", "stop": stop, **kw}, daemon=True)
    th.start()
    return seen, lock, stop


def _wait_for(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and not pred():
        time.sleep(0.05)
    return pred()


def test_kubeclient_watch_equal():
    def run(s):
        with Api(s) as api:
            c = api.client
            seen, lock, stop = _watch(c, "RuleSet")
            time.sleep(0.2)
            c.create("RuleSet", "default", _ruleset_doc("rs-w"))
            assert _wait_for(lambda: ("ADDED", "rs-w") in seen)
            c.delete("RuleSet", "default", "rs-w")
            assert _wait_for(lambda: ("DELETED", "rs-w") in seen)
            stop.set()
            with lock:
                return sorted(set(seen))

    assert same(run, exact=True) == [["ADDED", "rs-w"], ["DELETED", "rs-w"]]


@pytest.mark.parametrize("chaos", ["410-midstream", "rejected-rv", "chunked-list"])
def test_kubeclient_adversarial_apiserver_equal(chaos):
    def run(s):
        kw = {"410-midstream": {"chaos": {"watch_410_after": 3, "bookmark_interval": 0.2}},
              "rejected-rv": {"chaos": {"bookmark_interval": 0.2}}, "chunked-list": {}}[chaos]
        with Api(s, **kw) as api:
            c = api.client
            if chaos == "chunked-list":
                for i in range(23):
                    c.create("ConfigMap", "default", _cm_doc(f"cm-{i:03d}", f"# {i}"))
                return sorted(d["metadata"]["name"] for d in c.list("ConfigMap", "default", limit=5)["items"])
            n = 8 if chaos == "410-midstream" else 3
            if chaos == "rejected-rv":
                for i in range(n):
                    c.create("ConfigMap", "default", _cm_doc(f"cm-{i:03d}", f"# {i}"))
                api.srv.chaos["watch_reject_rv_below"] = 100
                seen, lock, stop = _watch(c, "ConfigMap", resource_version="1")
            else:
                seen, lock, stop = _watch(c, "ConfigMap")
                for i in range(n):
                    c.create("ConfigMap", "default", _cm_doc(f"cm-{i:03d}", f"# {i}"))
                    time.sleep(0.05)
            want = {f"cm-{i:03d}" for i in range(n)}
            ok = _wait_for(lambda: want <= {name for _e, name in seen}, 15)
            stop.set()
            return ok, sorted(want)

    got = same(run, exact=True)
    if chaos == "chunked-list":
        assert len(got) == 23 and got[0] == "cm-000" and got[-1] == "cm-022"
    else:
        assert got[0] is True


def test_kubeclient_ssa_conflict_equal():
    def run(s):
        with Api(s, chaos={"ssa_conflicts": 1}) as api:
            c = api.client
            try:
                c.server_side_apply("ConfigMap", "default", "cm-x", _cm_doc("cm-001", "# 1"))
                first = None
            except s.kubeclient.ApiError as err:
                first = (err.status, "conflict" in str(err).lower())
            second = c.server_side_apply("ConfigMap", "default", "cm-001", _cm_doc("cm-001", "# 1"))
            return first, second["metadata"]["name"]

    assert same(run, exact=True) == [[409, True], "cm-001"]


def test_kubeclient_lease_election_equal():
    def run(s):
        with Api(s) as api:
            el = s.kubeclient.LeaseElector
            a = el(api.client, identity="a", retry_period_s=0.1, lease_duration_s=1)
            b = el(api.client, identity="b", retry_period_s=0.1, lease_duration_s=1)
            a.start()
            out = [a.wait_for_leadership(5)]
            b.start()
            time.sleep(0.3)
            out += [a.is_leader, b.is_leader]
            a.stop()
            out.append(b.wait_for_leadership(5))
            b.stop()
            return out

    assert same(run, exact=True) == [True, True, False, True]


def test_kubeclient_tls_client_certificates_equal(tmp_path):
    openssl = shutil.which("openssl")
    if openssl is None:
        pytest.skip("openssl not available")
    run_ = lambda *a: subprocess.run(a, check=True, capture_output=True)  # noqa: E731
    ca_key, ca_crt = tmp_path / "ca.key", tmp_path / "ca.crt"
    run_(openssl, "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(ca_key), "-out",
         str(ca_crt), "-days", "1", "-subj", "/CN=fake-ca")
    paths = {}
    for who, cn in (("s", "127.0.0.1"), ("c", "operator")):
        key, csr, crt = (tmp_path / f"{who}.{x}" for x in ("key", "csr", "crt"))
        run_(openssl, "req", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key), "-out", str(csr),
             "-subj", f"/CN={cn}")
        run_(openssl, "x509", "-req", "-in", str(csr), "-CA", str(ca_crt), "-CAkey", str(ca_key),
             "-CAcreateserial", "-out", str(crt), "-days", "1")
        paths[who] = (str(crt), str(key))

    def run(s):
        with Api(s, tls=paths["s"], tls_client_ca=str(ca_crt)) as api:
            c = api.client_for(scheme="https", client_cert_file=paths["c"][0], client_key_file=paths["c"][1],
                               insecure_skip_verify=True)
            name = c.create("ConfigMap", "default", _cm_doc("cm-007", "# 7"))["metadata"]["name"]
            bare = api.client_for(scheme="https", insecure_skip_verify=True)
            try:
                bare.list("ConfigMap", "default")
                refused = False
            except (OSError, ssl.SSLError):
                refused = True
            return name, refused

    assert same(run, exact=True) == ["cm-007", True]


def test_controllers_reconcile_cluster_objects_equal():
    """The full loop over the cluster source: rules cached, the driver's
    objects written back to the API server, status patched Ready."""
    def run(s):
        with Api(s) as api:
            c = api.client
            store, cache = s.cp.ObjectStore(), s.RuleSetCache()
            manager = s.cp.ControllerManager(store, cache, cache_server_cluster="outbound|80||cache.local",
                                             workers=2)
            source = s.kubeclient.ClusterSource(store, c, namespace="default")
            manager.start()
            source.start()
            try:
                c.create("ConfigMap", "default",
                         _cm_doc("cm1", 'SecRule ARGS "@contains attack" "id:1,phase:2,deny,status:403"'))
                c.create("RuleSet", "default", _ruleset_doc("rs1", rules=("cm1",)))
                c.create("Engine", "default", _engine_doc(ISTIO_DOC, "e1"))
                c.create("Engine", "default", _engine_doc({s.driver: {"maxBatchDelayMs": 2}}, "e2"))
                name = f"coraza-{s.driver}-engine-e2"
                assert _wait_for(lambda: cache.get("default/rs1") is not None)

                def fetched(kind, obj):
                    return outcome(lambda: c.get(kind, "default", obj)).get("value")

                assert _wait_for(lambda: fetched("WasmPlugin", "coraza-engine-e1") is not None)
                assert _wait_for(lambda: fetched("Deployment", name) is not None)

                def ready():
                    conds = (c.get("RuleSet", "default", "rs1").get("status") or {}).get("conditions") or []
                    return any(x.get("type") == "Ready" and x.get("status") == "True" for x in conds)

                assert _wait_for(ready)
                plugin, dep = fetched("WasmPlugin", "coraza-engine-e1"), fetched("Deployment", name)
                return {"rules": cache.get("default/rs1").rules, "plugin": dump(plugin["spec"]),
                        "deployment": dump(dep["spec"])}
            finally:
                source.stop()
                manager.stop()

    got = same(run)
    assert got["plugin"]["pluginConfig"]["cache_server_cluster"] == "outbound|80||cache.local"


# -- cmd/operator.py --------------------------------------------------------

RULESET_YAML = """\
apiVersion: v1
kind: ConfigMap
metadata:
  name: rules-a
  namespace: default
data:
  rules: |
    SecRuleEngine On
    SecRule ARGS "@contains evil" "id:1,phase:2,deny,status:403"
---
apiVersion: waf.k8s.coraza.io/v1alpha1
kind: RuleSet
metadata:
  name: rs
  namespace: default
spec:
  rules:
    - name: rules-a
"""

ENGINE_YAML = """\
apiVersion: waf.k8s.coraza.io/v1alpha1
kind: Engine
metadata:
  name: eng
  namespace: default
spec:
  ruleSet:
    name: rs
  failurePolicy: allow
  driver:
    DEV:
      replicas: 2
      maxBatchSize: 512
      maxBatchDelayMs: 2
      ruleSetCacheServer:
        pollIntervalSeconds: 5
"""


@pytest.mark.parametrize("text", ["3s", "5m", "24h", "1h30m", "nope", ""])
def test_operator_parse_duration_equal(text):
    got = same(lambda s: outcome(lambda: s.operator.parse_duration(text).total_seconds()), exact=True)
    assert ("error" in got) is (text in ("nope", ""))


def test_operator_parser_equal():
    def run(s):
        p = s.operator.build_parser()
        with pytest.raises(SystemExit):
            p.parse_args([])
        return vars(p.parse_args(["--envoy-cluster-name", "c"]))

    assert same(run, exact=True)["cache_server_port"] == 18080


def test_operator_engine_manifest_equal():
    def run(s):
        eng = s.operator.object_from_manifest(yaml.safe_load(ENGINE_YAML.replace("DEV", s.driver)))
        eng.validate()
        return eng.spec

    got = same(run)
    assert got["driver"]["gpu"]["replicas"] == 2 and got["failure_policy"] == "allow"


@pytest.mark.parametrize("case", ["reconcile-and-edit", "parse-failure-is-not-absence", "deletion"])
def test_operator_manifest_source_equal(case, tmp_path):
    def run(s):
        d = tmp_path / s.driver
        d.mkdir()
        (d / "ruleset.yaml").write_text(RULESET_YAML)
        if case == "reconcile-and-edit":
            (d / "engine.yaml").write_text(ENGINE_YAML.replace("DEV", s.driver))
        store, cache = s.cp.ObjectStore(), s.RuleSetCache()
        manager = s.cp.ControllerManager(store, cache, cache_server_cluster="test-cluster", workers=1)
        manager.start()
        try:
            source = s.operator.ManifestSource(store, d, interval_s=0.1)
            out = [source.sync_once()]
            manager.drain(timeout_s=1.0)  # an Engine keeps the queue busy
            _wait_for(lambda: cache.get("default/rs") is not None)
            out.append(cache.get("default/rs").rules)
            if case == "reconcile-and-edit":
                first = cache.get("default/rs").uuid
                (d / "ruleset.yaml").write_text(RULESET_YAML.replace("evil", "wicked"))
                source.start()
                _wait_for(lambda: cache.get("default/rs").uuid != first)
                source.stop()
                manager.drain(timeout_s=1.0)
                out += [cache.get("default/rs").rules, dump(store.list("Deployment"))]
            elif case == "deletion":
                (d / "ruleset.yaml").unlink()
                source.sync_once()
                out.append(store.try_get("RuleSet", "default", "rs") is None)
            else:
                (d / "ruleset.yaml").write_text("kind: RuleSet\nmetadata: [broken")
                source.sync_once()
                out.append(store.try_get("RuleSet", "default", "rs") is not None)
                (d / "ruleset.yaml").write_text(RULESET_YAML)
                source.sync_once()
                out.append(store.try_get("RuleSet", "default", "rs") is not None)
            return out
        finally:
            manager.stop()

    got = same(run)
    if case == "reconcile-and-edit":
        assert got[0] == 3 and "wicked" in got[2]
        assert [d["metadata"]["name"] for d in got[3]] == ["coraza-gpu-engine-eng"]
    else:
        assert all(x is True for x in got[2:])


def test_operator_main_against_fake_apiserver_equal(tmp_path):
    """main() with a kubeconfig pointing at the fake API server: Lease
    election, watch-driven reconcile and status write-back."""
    def run(s):
        with Api(s) as api:
            kubeconfig = tmp_path / f"kubeconfig-{s.driver}"
            kubeconfig.write_text("\n".join([
                "apiVersion: v1", "kind: Config", "current-context: fake",
                "contexts: [{name: fake, context: {cluster: fake, user: fake}}]",
                f"clusters: [{{name: fake, cluster: {{server: http://{api.srv.host}:{api.srv.port}}}}}]",
                "users: [{name: fake, user: {}}]"]))
            argv = ["--envoy-cluster-name", "outbound|80||cache.local", "--cache-server-port", "0",
                    "--health-probe-bind-address", "127.0.0.1:0", "--kubeconfig", str(kubeconfig),
                    "--leader-elect"]
            stop = threading.Event()
            thread = threading.Thread(target=s.operator.main, args=(argv,), kwargs={"stop": stop}, daemon=True)
            thread.start()
            c = api.client
            try:
                lease = lambda: outcome(lambda: c.get("Lease", "coraza-system", "waf.k8s.coraza.io"))  # noqa
                assert _wait_for(lambda: "value" in lease())
                c.create("ConfigMap", "default",
                         _cm_doc("cm-live", 'SecRule ARGS "@contains evil" "id:9,phase:2,deny,status:403"'))
                c.create("RuleSet", "default", _ruleset_doc("rs-live", rules=("cm-live",)))
                c.create("Engine", "default", _engine_doc({s.driver: {"maxBatchDelayMs": 2}}, "e-live"))

                def ready():
                    conds = (c.get("RuleSet", "default", "rs-live").get("status") or {}).get("conditions") or []
                    return any(x.get("type") == "Ready" and x.get("status") == "True" for x in conds)

                assert _wait_for(ready, 15)
                name = f"coraza-{s.driver}-engine-e-live"
                assert _wait_for(lambda: "value" in outcome(lambda: c.get("Deployment", "default", name)))
                return {"holder": bool(lease()["value"]["spec"]["holderIdentity"]),
                        "deployment": dump(c.get("Deployment", "default", name)["spec"])}
            finally:
                stop.set()
                thread.join(timeout=10)
                assert not thread.is_alive(), "operator main did not shut down"

    assert same(run)["holder"] is True


# -- the controller's args start gpu-engine ---------------------------------


@pytest.mark.parametrize("driver_kw", [{}, {"ext_proc_port": 9191, "poll": 3, "max_batch_size": 64}],
                         ids=["defaults", "set"])
def test_gpu_engine_accepts_every_rendered_arg(driver_kw, monkeypatch):
    """``gpu-engine``'s ``build_config`` parses the args the port's
    controller renders, and each lands in the sidecar's config."""
    from coraza_kubernetes_operator_tpu_torch import native
    from coraza_kubernetes_operator_tpu_torch.cmd import gpu_engine
    from coraza_kubernetes_operator_tpu_torch.ops import kernels

    # build_config wires the build directories from the environment: keep
    # them where they are.
    monkeypatch.delenv("CKO_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    store, _cache, recorder = _env(T)
    engine = _engine(T, driver=_device(T, **driver_kw))
    engine.metadata.namespace = "default"
    engine.spec.rule_set.name = "crs-lite"
    store.create(engine)
    T.engine_controller.EngineReconciler(store, recorder, "cache.svc", 18080).reconcile("default", "eng")
    dep = store.get("Deployment", "default", "coraza-gpu-engine-eng")
    container = dep.spec["template"]["spec"]["containers"][0]
    assert container["resources"]["limits"] == {"nvidia.com/gpu": "1"}
    cfg = gpu_engine.build_config(container["args"])
    gpu = engine.spec.driver.gpu
    assert (cfg.cache_base_url, cfg.instance_key) == ("http://cache.svc:18080", "default/crs-lite")
    assert (cfg.max_batch_size, cfg.max_batch_delay_ms, cfg.extproc_port) == (
        gpu.max_batch_size, gpu.max_batch_delay_ms, gpu.ext_proc_port)
    assert cfg.poll_interval_s == driver_kw.get("poll", 15)
    assert (cfg.failure_policy, cfg.drain_budget_s, cfg.audit_log) == ("fail", 10.0, "-")
    with pytest.raises(SystemExit):
        gpu_engine.build_config(container["args"] + ["--no-such-flag"])
