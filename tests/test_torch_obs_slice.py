"""This slice on the CPU: both packages' prediction servers, with the
profiler and the flight recorder on, serving one model.

The JAX package's ``run_train`` stores a recommendation model in one
SQLite store (``PIO_HOME`` under ``tmp_path``); each package's
``PredictionServer`` deploys that instance from the store, the port's
through its checkpoint converter. With ``PIO_PROFILE=1`` both answer the
same single queries over HTTP (the scheduler off: one dispatch a query;
the JAX package's host mirror off, so its answers come from its device
path too) and the same batch through ``_handle_batch`` with the same
ids, and book the same ``serve_topk`` and ``serve_topk_batch`` dispatches
and FLOPs.
Each package's recorder (its sampler stopped, sampled by hand) then
serves a ``GET /recorder`` window holding the same families of the
serving, the profiler and the recorder. Output plugins run on the object
path in the port, as in the JAX package: a blocker rewrites each answer,
a sniffer sees it, ``/plugins.json`` names both.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from incubator_predictionio_tpu.data.storage import Storage as JStorage
from incubator_predictionio_tpu.models.recommendation import engine as jeng
from incubator_predictionio_tpu.obs import profile as jprofile
from incubator_predictionio_tpu.obs import recorder as jrecorder
from incubator_predictionio_tpu.servers import plugins as jplugins
from incubator_predictionio_tpu.servers import prediction_server as jps
from incubator_predictionio_tpu.workflow.workflow import (
    CoreWorkflow as JCoreWorkflow,
)
from incubator_predictionio_tpu_torch.data.storage import Storage
from incubator_predictionio_tpu_torch.models.recommendation import (
    engine as teng,
)
from incubator_predictionio_tpu_torch.obs import profile as obs_profile
from incubator_predictionio_tpu_torch.obs import recorder as obs_recorder
from incubator_predictionio_tpu_torch.servers import plugins
from incubator_predictionio_tpu_torch.servers import prediction_server as tps
from test_torch_workflow import _jax_params, _rating_events

VARIANT = "obs-slice"
USERS = [f"u{k}" for k in (0, 3, 7, 11, 19, 25, 40, 64, 99, 119)]
#: the families both windows must hold: the serving's, the profiler's
#: and the recorder's own
FAMILIES = ("pio_query_latency_seconds", "pio_device_seconds", "pio_device_dispatches_total",
            "pio_device_flops_total", "pio_mfu",
            "pio_recorder_samples_total", "pio_recorder_ring_bytes",
            "pio_http_requests_total")


@pytest.fixture
def store(tmp_path, monkeypatch):
    """One SQLite store for both packages, a JAX-trained instance in it."""
    import os

    monkeypatch.setenv("PIO_HOME", str(tmp_path))
    monkeypatch.setenv("PIO_RETRAIN_CONTINUE", "0")
    monkeypatch.setenv("PIO_SPEED_LAYER", "0")
    monkeypatch.setenv("PIO_PROFILE", "1")
    monkeypatch.setenv("PIO_RECORDER", "1")
    # the JAX package's host mirror off: its answers come from its device
    # path, which its profiler books (the port has no host mirror)
    monkeypatch.setenv("PIO_HOST_SERVE_MAX_ELEMS", "0")
    monkeypatch.delenv("PIO_INCIDENT_DIR", raising=False)
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    Storage.reset()
    JStorage.reset()
    obs_recorder.reset_recorder()
    jrecorder.reset_recorder()
    _rating_events()
    JCoreWorkflow.run_train(jeng.RecommendationEngine().apply(),
                            _jax_params(), engine_variant=VARIANT)
    yield
    obs_recorder.reset_recorder()
    jrecorder.reset_recorder()
    Storage.reset()
    JStorage.reset()


def _servers(port_plugins=None, jax_plugins=None):
    tsrv = tps.PredictionServer(
        teng.RecommendationEngine().apply(), device="cpu",
        config=tps.ServerConfig(ip="127.0.0.1", port=0,
                                engine_variant=VARIANT, micro_batch=0),
        plugin_context=port_plugins)
    jsrv = jps.PredictionServer(
        jeng.RecommendationEngine().apply(),
        jps.ServerConfig(ip="127.0.0.1", port=0, engine_variant=VARIANT,
                         micro_batch=0),
        plugin_context=jax_plugins)
    return {"port": tsrv, "jax": jsrv}


def _post(port, doc):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(doc).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def _booked(mod):
    return {op: (mod.DEVICE_DISPATCHES.labels(op=op).value,
                 mod.DEVICE_FLOPS.labels(op=op).value)
            for op in ("serve_topk", "serve_topk_batch")}


def _ids(body):
    return [s["item"] for s in body["itemScores"]]


def test_both_servers_profile_and_record_the_same_serving(store):
    servers = _servers()
    ports = {name: srv.start_background() for name, srv in servers.items()}
    recs = {"port": obs_recorder.get_recorder(),
            "jax": jrecorder.get_recorder()}
    try:
        for rec in recs.values():
            rec.stop()  # one writer: the samples below are this test's
            rec.sample_now()
        # the JAX server warms up on a thread of its own after it binds
        # (one single-query dispatch); its bookings count from after it
        for t in threading.enumerate():
            if t.name == "pio-serving-warmup":
                t.join(timeout=60)
                assert not t.is_alive()
        before = {"port": _booked(obs_profile), "jax": _booked(jprofile)}
        answers = {name: [_post(p, {"user": u, "num": 7}) for u in USERS]
                   for name, p in ports.items()}
        batch = [json.dumps({"user": u, "num": 5}).encode()
                 for u in USERS[:6]]
        batched = {name: srv._handle_batch(batch, "default", "default")
                   for name, srv in servers.items()}
        after = {"port": _booked(obs_profile), "jax": _booked(jprofile)}
        for rec in recs.values():
            rec.sample_now()
        windows = {name: _get(p, "/recorder?all=1&window=600")
                   for name, p in ports.items()}
        indexes = {name: _get(p, "/recorder") for name, p in ports.items()}
    finally:
        for srv in servers.values():
            srv.stop()
    for got, ref in zip(answers["port"], answers["jax"]):
        assert _ids(got) == _ids(ref) and len(_ids(got)) == 7
        np.testing.assert_allclose([s["score"] for s in got["itemScores"]],
                                   [s["score"] for s in ref["itemScores"]],
                                   rtol=1e-4, atol=1e-5)
    for got, ref in zip(batched["port"], batched["jax"]):
        assert _ids(json.loads(got)) == _ids(json.loads(ref))
    moved = {name: {op: (after[name][op][0] - before[name][op][0],
                         after[name][op][1] - before[name][op][1])
                    for op in after[name]} for name in after}
    assert moved["port"] == moved["jax"]
    # a single query takes the batched entry at B 1 on the fast path
    assert moved["port"]["serve_topk_batch"][0] == len(USERS) + 1
    for name in ("port", "jax"):
        assert windows[name]["samples"] >= 2
        assert set(FAMILIES) <= set(windows[name]["series"]), name
        assert set(FAMILIES) <= set(indexes[name]["series"]), name
    served = windows["port"]["series"]["pio_device_dispatches_total"]
    ops = {ch["labels"]["op"]: ch["points"][-1][1]
           for ch in served["children"]}
    assert ops["serve_topk_batch"] >= len(USERS) + 1


class _Upper(plugins.EngineServerPlugin):
    output_blocker = True

    def process(self, engine_variant, query, prediction, context):
        for s in prediction["itemScores"]:
            s["item"] = s["item"].upper()
        return prediction


class _Seen(plugins.EngineServerPlugin):
    output_sniffer = True

    def __init__(self):
        self.seen = []

    def process(self, engine_variant, query, prediction, context):
        self.seen.append((engine_variant, query["user"],
                          len(prediction["itemScores"])))

    def handle_rest(self, path, params):
        return {"path": path, "seen": len(self.seen)}


class _JUpper(_Upper, jplugins.EngineServerPlugin):
    pass


class _JSeen(_Seen, jplugins.EngineServerPlugin):
    pass


def test_output_plugins_on_both_servers(store):
    sniffers = {"port": _Seen(), "jax": _JSeen()}
    servers = _servers(
        plugins.PluginContext([_Upper(), sniffers["port"]]),
        jplugins.PluginContext([_JUpper(), sniffers["jax"]]))
    ports = {name: srv.start_background() for name, srv in servers.items()}
    try:
        answers = {name: [_post(p, {"user": u, "num": 4})
                          for u in USERS[:3]]
                   for name, p in ports.items()}
        listed = {name: _get(p, "/plugins.json")
                  for name, p in ports.items()}
        rest = {name: _get(p, f"/plugins/{type(sniffers[name]).__name__}"
                              "/a/b?x=1")
                for name, p in ports.items()}
    finally:
        for srv in servers.values():
            srv.stop()
    for got, ref in zip(answers["port"], answers["jax"]):
        assert _ids(got) == _ids(ref)
        assert all(i.startswith("I") for i in _ids(got))
    assert [s[1:] for s in sniffers["port"].seen] == \
        [s[1:] for s in sniffers["jax"].seen] == \
        [(u, 4) for u in USERS[:3]]
    assert sniffers["port"].seen[0][0] == VARIANT
    assert list(listed["port"]["plugins"]["outputblockers"]) == ["_Upper"]
    assert list(listed["port"]["plugins"]["outputsniffers"]) == ["_Seen"]
    assert rest["port"] == {"path": "a/b", "seen": 3}
