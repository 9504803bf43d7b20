"""The port's tenancy (``serving/tenancy.py``, the scheduler's tenant
planes and the prediction server's tenant-aware query path) against the
JAX package's, on the CPU.

Mirrors tests/test_tenancy.py: the registry's grammar, bounds, metric-safe
labels, access-key extraction and authentication give the same answers
in both packages on the same inputs; the scheduler's quota shed, weighted
slot caps and flood isolation hold on the port; and both packages'
prediction servers, each on a memory store of its own holding the same
events and an instance trained by its own ``run_train``, answer the same
requests with the same statuses: 401 for a missing, unknown or disabled
key, the per-tenant ``GET /`` block (keys redacted), and a tenant-scoped
``/reload`` that leaves the default deploy alone (404 for an unknown
tenant, 401 without the server key). On the port, ``/reload`` and
``/reload?tenant=X`` swap while clients query, without a failed query.
The capacity report's bin-packing (``obs/capacity``) waits for ROADMAP.md
Queue 1 item 8.
"""

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from incubator_predictionio_tpu.core.params import (
    EngineParams as JEngineParams,
)
from incubator_predictionio_tpu.data.datamap import DataMap as JDataMap
from incubator_predictionio_tpu.data.event import Event as JEvent
from incubator_predictionio_tpu.data.storage import App as JApp
from incubator_predictionio_tpu.data.storage import Storage as JStorage
from incubator_predictionio_tpu.models.recommendation import engine as jeng
from incubator_predictionio_tpu.servers import prediction_server as jps
from incubator_predictionio_tpu.serving import tenancy as jtenancy
from incubator_predictionio_tpu.workflow.workflow import (
    CoreWorkflow as JCoreWorkflow,
)
from incubator_predictionio_tpu_torch.core.params import EngineParams
from incubator_predictionio_tpu_torch.data.datamap import DataMap
from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.data.storage import App, Storage
from incubator_predictionio_tpu_torch.models.recommendation import (
    engine as teng,
)
from incubator_predictionio_tpu_torch.servers import prediction_server as tps
from incubator_predictionio_tpu_torch.serving import tenancy
from incubator_predictionio_tpu_torch.serving.scheduler import (
    BatchScheduler,
    ShedError,
)
from incubator_predictionio_tpu_torch.workflow.workflow import CoreWorkflow

SPEC = ("alpha:alpha-key:weight=4;"
        "beta:beta-key:weight=1,quota=2;"
        "ghost:ghost-key:disabled=1")


def _both(fn):
    """``fn(tenancy module)`` for each package; both gave the same."""
    got, ref = fn(tenancy), fn(jtenancy)
    assert got == ref
    return got


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class and text compared
        return type(e).__name__, str(e), getattr(e, "status", None)
    return None


# -- registry parsing & bounds ----------------------------------------------

def test_registry_parses_full_grammar():
    def parsed(mod):
        reg = mod.TenantRegistry.from_env(SPEC)
        return (reg.tenant_ids(), reg.weights(), reg.quotas(),
                reg.describe(), [t.enabled for t in reg.tenants()])

    ids, weights, quotas, desc, enabled = _both(parsed)
    assert ids == ("alpha", "beta", "ghost")
    assert weights == {"alpha": 4, "beta": 1, "ghost": 1}
    assert quotas == {"alpha": None, "beta": 2, "ghost": None}
    assert enabled == [True, True, False]
    assert "key" not in json.dumps(desc)


def test_registry_empty_and_whitespace_entries():
    assert _both(lambda m: (
        len(m.TenantRegistry.from_env("")),
        len(m.TenantRegistry.from_env(" ; ;")),
        m.TenantRegistry.from_env(" a:k1 ; b:k2 ").tenant_ids())) == \
        (0, 0, ("a", "b"))


@pytest.mark.parametrize("bad", [
    "justanid",                        # no key
    "a:k:mystery=1",                   # unknown option
    "a:k1;a:k2",                       # duplicate tenant id
    "a:k;b:k",                         # duplicate access key
    "bad id!:k",                       # id grammar
    "a:k:weight=0",                    # weight must be >= 1
    "a:",                              # empty key
    "a:k:quota=x",                     # a number that is not one
])
def test_registry_rejects_malformed_entries(bad):
    err = _both(lambda m: _raises(lambda: m.TenantRegistry.from_env(bad)))
    assert err is not None and err[0] == "ValueError"


def test_registry_is_bounded():
    over = ";".join(f"t{i}:k{i}" for i in range(tenancy.MAX_TENANTS + 1))
    at = ";".join(f"t{i}:k{i}" for i in range(tenancy.MAX_TENANTS))
    err, n = _both(lambda m: (
        _raises(lambda: m.TenantRegistry.from_env(over)),
        len(m.TenantRegistry.from_env(at))))
    assert "bounded" in err[1] and n == tenancy.MAX_TENANTS == 64


def test_label_gateway_is_metric_safe():
    labels = _both(lambda m: [
        m.TenantRegistry.from_env(SPEC).label(x)
        for x in ("alpha", "nope' OR 1=1", None)]
        + [m.TenantRegistry().label("alpha")])
    assert labels == ["alpha", "default", "default", "default"]


class _Req:
    def __init__(self, query=None, headers=None):
        self.query = query or {}
        self.headers = headers or {}


def test_extract_access_key_query_param_and_basic():
    basic = base64.b64encode(b"k2:ignored-password").decode()
    reqs = [_Req(query={"accessKey": "k1"}),
            _Req(headers={"authorization": f"Basic {basic}"}),
            _Req(query={"accessKey": "k1"},
                 headers={"authorization": f"Basic {basic}"}),
            _Req(),
            _Req(headers={"authorization": "Basic %%%notb64"})]
    assert _both(lambda m: [m.extract_access_key(r) for r in reqs]) == \
        ["k1", "k2", "k1", None, None]


def test_authenticate_maps_key_to_tenant_or_401():
    reqs = [_Req(query={"accessKey": "alpha-key"}), _Req(),
            _Req(query={"accessKey": "wrong"}),
            _Req(query={"accessKey": "ghost-key"})]

    def auth(m):
        reg = m.TenantRegistry.from_env(SPEC)
        return [_raises(lambda r=r: reg.authenticate(r))
                or reg.authenticate(r) for r in reqs] + [
            m.TenantRegistry().authenticate(_Req())]

    out = _both(auth)
    assert out[0] == "alpha" and out[-1] == "default"
    for err in out[1:4]:
        assert err[0] == "TenantAuthError" and err[2] == 401


def test_registry_singleton_follows_env(monkeypatch):
    def follow(m):
        m.reset_registry()
        monkeypatch.setenv("PIO_TENANTS", "a:k1")
        one = m.get_registry().tenant_ids()
        monkeypatch.setenv("PIO_TENANTS", "a:k1;b:k2")
        two = m.get_registry().tenant_ids()
        monkeypatch.delenv("PIO_TENANTS")
        none = len(m.get_registry())
        m.reset_registry()
        return one, two, none

    assert _both(follow) == (("a",), ("a", "b"), 0)


# -- the scheduler's isolation planes ---------------------------------------

def test_scheduler_quota_sheds_only_the_quota_tenant():
    done = threading.Event()

    def handle(bodies, engine, tenant):
        done.wait(2.0)
        return list(bodies)

    s = BatchScheduler(handle, max_batch=8, workers=1, shed=False,
                       tenant_quotas={"beta": 2})
    try:
        futs = [s.submit(i, tenant="beta") for i in range(2)]
        deadline = time.monotonic() + 2.0
        shed = None
        while time.monotonic() < deadline and shed is None:
            f = s.submit(99, tenant="beta")
            if f.done() and isinstance(f.exception(), ShedError):
                shed = f.exception()
            else:
                futs.append(f)
        assert shed is not None and shed.reason == "quota"
        assert shed.status == 503
        ok = s.submit(1, tenant="alpha")
        assert not (ok.done() and ok.exception())
        futs.append(ok)
        done.set()
        for f in futs:
            f.result(timeout=5)
    finally:
        done.set()
        s.stop()


def test_scheduler_slot_caps_weighted_by_contending_tenants():
    s = BatchScheduler(lambda bodies, engine, tenant: list(bodies),
                       max_batch=8, workers=2,
                       tenant_weights={"victim": 8, "aggressor": 1})
    try:
        with s._cv:
            now = s._clock()
            s._t_last_submit = {"aggressor": now}
            assert s._slot_caps_locked(now) is None
            s._t_last_submit = {"aggressor": now, "victim": now}
            assert s._slot_caps_locked(now) == {"victim": 2,
                                                "aggressor": 1}
            s._t_last_submit["victim"] = now - s.CONTEND_WINDOW_S - 1.0
            assert s._slot_caps_locked(now) is None
    finally:
        s.stop()


def test_scheduler_single_worker_never_caps():
    s = BatchScheduler(lambda bodies, engine, tenant: list(bodies),
                       max_batch=8, workers=1,
                       tenant_weights={"a": 1, "b": 1})
    try:
        with s._cv:
            now = s._clock()
            s._t_last_submit = {"a": now, "b": now}
            assert s._slot_caps_locked(now) is None
    finally:
        s.stop()


def test_scheduler_flooder_never_holds_every_dispatch_slot():
    """Under a closed-loop flood from a low-weight tenant, a contending
    light tenant keeps one dispatcher thread: the flooder's concurrent
    dispatches stay under its weighted slot cap."""
    def handle(bodies, engine, tenant):
        time.sleep(0.02)
        return list(bodies)

    s = BatchScheduler(handle, max_batch=4, workers=2, shed=False,
                       tenant_weights={"victim": 8, "aggressor": 1})
    stop = threading.Event()

    def flood():
        while not stop.is_set():
            try:
                s.submit({"q": 1}, tenant="aggressor").result(timeout=5)
            except Exception:
                return

    threads = [threading.Thread(target=flood, daemon=True)
               for _ in range(6)]
    try:
        for t in threads:
            t.start()
        most = 0
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            s.submit({"q": 1}, tenant="victim").result(timeout=5)
            with s._cv:
                most = max(most, s._tenant_inflight_locked("aggressor"))
        assert most <= 1
    finally:
        stop.set()
        s.stop()
        for t in threads:
            t.join(timeout=5)


# -- both packages' prediction servers --------------------------------------

TENANTS = ("alpha:alpha-key:weight=4;beta:beta-key:quota=8;"
           "ghost:ghost-key:disabled=1")
MEMORY = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}


def _events(event_cls, datamap_cls):
    rng = np.random.default_rng(5)
    return [event_cls(event="rate", entity_type="user", entity_id=f"u{u}",
                      target_entity_type="item", target_entity_id=f"i{i}",
                      properties=datamap_cls(
                          {"rating": float(rng.integers(1, 6))}))
            for u in range(12) for i in range(10) if rng.random() < 0.6]


def _deploy(jax_side: bool):
    storage, eng_mod, wf, params_cls, app_cls, ev, dm, ps = (
        (JStorage, jeng, JCoreWorkflow, JEngineParams, JApp, JEvent,
         JDataMap, jps) if jax_side else
        (Storage, teng, CoreWorkflow, EngineParams, App, Event, DataMap,
         tps))
    storage.configure(dict(MEMORY))
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "tenantapp"))
    storage.get_events().init(app_id)
    for e in _events(ev, dm):
        storage.get_events().insert(e, app_id)
    engine = eng_mod.RecommendationEngine().apply()
    params = params_cls(
        data_source_params=("", eng_mod.DataSourceParams(
            app_name="tenantapp")),
        algorithm_params_list=[("als", eng_mod.ALSAlgorithmParams(
            rank=4, num_iterations=3, lambda_=0.05, seed=7))])
    kw = {} if jax_side else {"device": "cpu"}
    wf.run_train(engine, params, engine_variant="tenants", **kw)
    config = ps.ServerConfig(ip="127.0.0.1", port=0,
                             engine_variant="tenants", server_key="sekrit")
    srv = (ps.PredictionServer(engine, config) if jax_side else
           ps.PredictionServer(engine, device="cpu", config=config))
    return srv, srv.start_background()


@pytest.fixture(scope="module")
def servers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_TENANTS", TENANTS)
        mp.setenv("PIO_RETRAIN_CONTINUE", "0")
        mp.setenv("PIO_SPEED_LAYER", "0")
        # these cases are about auth and the swap: a shed under the load
        # of a parallel test run would be an answer of another kind
        mp.setenv("PIO_SERVE_SHED", "0")
        tenancy.reset_registry()
        jtenancy.reset_registry()
        Storage.reset()
        JStorage.reset()
        pair = {}
        try:
            pair["jax"] = _deploy(jax_side=True)
            pair["port"] = _deploy(jax_side=False)
            yield pair
        finally:
            for srv, _port in pair.values():
                srv.stop()
            Storage.reset()
            JStorage.reset()
            tenancy.reset_registry()
            jtenancy.reset_registry()


def _call(port, path, body=None, headers=None, method="POST"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def test_query_path_requires_access_key(servers):
    basic = base64.b64encode(b"beta-key:").decode()
    cases = [("/queries.json", {}), ("/queries.json?accessKey=wrong", {}),
             ("/queries.json?accessKey=ghost-key", {}),
             ("/queries.json?accessKey=alpha-key", {}),
             ("/queries.json", {"Authorization": f"Basic {basic}"})]
    got = {}
    for side, (_srv, port) in servers.items():
        got[side] = []
        for path, headers in cases:
            status, body = _call(port, path, {"user": "u1", "num": 3},
                                 headers)
            got[side].append((status, len(body["itemScores"])
                              if status == 200 else body["message"]))
    assert got["port"] == got["jax"]
    assert [s for s, _ in got["port"]] == [401, 401, 401, 200, 200]
    assert got["port"][3][1] == 3


def test_status_renders_per_tenant_block(servers):
    blocks = {}
    for side, (_srv, port) in servers.items():
        _call(port, "/queries.json?accessKey=alpha-key",
              {"user": "u2", "num": 2})
        status, info = _call(port, "/", method="GET")
        assert status == 200
        assert "alpha-key" not in json.dumps(info)
        blocks[side] = {
            t: {k: v for k, v in b.items()
                if k not in ("engineInstanceId", "modelStalenessSec",
                             "servingSecP99")}
            for t, b in info["tenants"].items()}
        assert set(info["scheduler"]["tenants"]) >= {"alpha", "beta"}
    assert blocks["port"] == blocks["jax"]
    assert set(blocks["port"]) == {"alpha", "beta", "ghost"}
    assert blocks["port"]["alpha"]["weight"] == 4
    assert blocks["port"]["beta"]["quota"] == 8
    assert blocks["port"]["ghost"]["enabled"] is False
    assert blocks["port"]["alpha"]["sharedDeploy"] is True


def test_tenant_scoped_reload_leaves_default_deploy_alone(servers):
    got = {}
    for side, (srv, port) in servers.items():
        default_instance = srv.engine_instance.id
        out = [_call(port, "/reload?accessKey=sekrit&tenant=alpha", {})]
        assert "alpha" in srv._deploys
        assert srv.engine_instance.id == default_instance
        assert srv._deploys["alpha"]["engine_instance"].id == \
            default_instance  # the variant's latest: the same instance
        status, body = _call(port, "/queries.json?accessKey=alpha-key",
                             {"user": "u3", "num": 4})
        out.append((status, len(body["itemScores"])))
        out.append(_call(port, "/reload?accessKey=sekrit&tenant=nope",
                         {})[0])
        out.append(_call(port, "/reload?accessKey=wrong&tenant=alpha",
                         {})[0])
        out.append(_call(port, "/reload?accessKey=sekrit", {}))
        status, info = _call(port, "/", method="GET")
        out.append(info["tenants"]["alpha"]["sharedDeploy"])
        got[side] = out
    assert got["port"] == got["jax"]
    assert got["port"] == [(200, {"message": "Reloaded tenant alpha."}),
                           (200, 4), 404, 401,
                           (200, {"message": "Reloaded."}), False]


def test_reload_under_load_fails_no_query(servers):
    """Clients of the default tenant and of alpha query throughout a
    ``/reload`` and a ``/reload?tenant=alpha`` on the port: every answer
    is a 200 with its items."""
    srv, port = servers["port"]
    stop = threading.Event()
    seen, bad = [], []

    def client(key, user):
        while not stop.is_set():
            status, body = _call(port, f"/queries.json?accessKey={key}",
                                 {"user": user, "num": 3})
            (seen if status == 200 and len(body["itemScores"]) == 3
             else bad).append((status, body))

    threads = [threading.Thread(target=client, args=(k, f"u{i}"),
                                daemon=True)
               for i, k in enumerate(["alpha-key", "beta-key"] * 2)]
    for t in threads:
        t.start()
    try:
        before = srv.models[0]
        for path in ("/reload?accessKey=sekrit",
                     "/reload?accessKey=sekrit&tenant=alpha",
                     "/reload?accessKey=sekrit"):
            assert _call(port, path, {})[0] == 200
        assert srv.models[0] is not before
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    assert not bad and len(seen) >= 4
