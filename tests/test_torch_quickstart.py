"""The README quickstart through the port's CLI on the CPU
(``PIO_DEVICE=cpu``), mirroring ``tests/test_quickstart_e2e.py``:

- ``pio app new`` → REST batch ingest through the port's event server (the
  50-event cap) → ``pio build`` → ``pio train`` → a ``PredictionServer``
  deployed from its config → queries → ``pio export``, with an engine.json
  naming the port's factory;
- the README's own ``examples/recommendation-quickstart/engine.json``,
  unedited (it names the JAX package's factory, mapped by name), with
  ``import_events.py`` run as a subprocess against ``pio eventserver`` and
  ``pio deploy`` / ``pio undeploy`` as child processes, each exiting 0;
  on SQLite, and again with the events on the native log (cpplog);
- an instance the JAX package's CLI trained, deployed by the port's
  server by ``engine_instance_id``: its answers are the JAX server's (ids
  equal, scores rtol 1e-5);
- the sequence engine through ``pio train`` and a deploy from an
  engine.json.
"""

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from datetime import timedelta

import numpy as np
import pytest

from incubator_predictionio_tpu_torch.cli import commands
from incubator_predictionio_tpu_torch.cli.main import main
from incubator_predictionio_tpu_torch.data.storage import Storage
from incubator_predictionio_tpu_torch.servers.event_server import (
    EventServer,
    EventServerConfig,
)
from incubator_predictionio_tpu_torch.servers.prediction_server import (
    PredictionServer,
    ServerConfig,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "recommendation-quickstart")
CLI = [sys.executable, "-m", "incubator_predictionio_tpu_torch.cli.main"]
VARIANT = {
    "id": "default",
    "engineFactory":
        "incubator_predictionio_tpu_torch.models.recommendation:"
        "RecommendationEngine",
    "datasource": {"params": {"appName": "QsApp"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 8, "numIterations": 5, "lambda": 0.05, "seed": 3,
    }}],
}


def post(url, body):
    req = urllib.request.Request(
        url, json.dumps(body).encode(), {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read() or b"null")


def get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture
def sqlite_home(tmp_path, monkeypatch):
    """Both packages on the zero-config SQLite store under a temporary
    ``PIO_HOME`` (child processes read the same), the CLI on the CPU."""
    from incubator_predictionio_tpu.data.storage import Storage as JStorage

    home = tmp_path / "home"
    monkeypatch.setenv("PIO_HOME", str(home))
    monkeypatch.setenv("PIO_DEVICE", "cpu")
    monkeypatch.setenv("PIO_RETRAIN_CONTINUE", "0")
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    Storage.reset()
    JStorage.reset()
    yield home
    Storage.reset()
    JStorage.reset()


def _access_key(out: str) -> str:
    return re.search(r"Access Key: (\S+)", out).group(1)


def _child(argv, cwd, log):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    out = open(log, "w")
    return subprocess.Popen([*CLI, *argv], cwd=cwd, env=env, stdout=out,
                            stderr=subprocess.STDOUT), log


def _wait_port(child, pattern, timeout=120):
    proc, log = child
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        m = re.search(pattern, open(log).read())
        if m:
            return int(m.group(1))
        assert proc.poll() is None, open(log).read()
        time.sleep(0.1)
    proc.kill()
    raise AssertionError(open(log).read())


def test_quickstart_full_pipeline(sqlite_home, tmp_path, monkeypatch,
                                  capsys):
    assert main(["app", "new", "QsApp"]) == 0
    key = _access_key(capsys.readouterr().out)

    es = EventServer(EventServerConfig(ip="127.0.0.1", port=0))
    es_port = es.start_background()
    try:
        rng = np.random.default_rng(0)
        events = [{"event": "rate", "entityType": "user",
                   "entityId": f"u{u}", "targetEntityType": "item",
                   "targetEntityId": f"i{i}",
                   "properties": {"rating": float(rng.integers(1, 6))}}
                  for u in range(25)
                  for i in rng.choice(40, 10, replace=False)]
        base = f"http://127.0.0.1:{es_port}"
        for s in range(0, len(events), 50):
            status, body = post(f"{base}/batch/events.json?accessKey={key}",
                                events[s:s + 50])
            assert status == 200 and {b["status"] for b in body} == {201}
        with pytest.raises(urllib.error.HTTPError) as err:
            post(f"{base}/batch/events.json?accessKey={key}",
                 [events[0]] * 51)
        assert err.value.code == 400
    finally:
        es.stop()

    (tmp_path / "engine.json").write_text(json.dumps(VARIANT))
    monkeypatch.chdir(tmp_path)
    assert main(["build"]) == 0
    assert main(["train"]) == 0
    assert "Engine instance ID:" in capsys.readouterr().out

    engine, _ = commands.engine_from_variant(VARIANT)
    ps = PredictionServer(engine, device="cpu", config=ServerConfig(
        ip="127.0.0.1", port=0,
        engine_id=commands.engine_id_for_variant_path(
            str(tmp_path / "engine.json"), VARIANT)))
    ps_port = ps.start_background()
    try:
        status, body = post(f"http://127.0.0.1:{ps_port}/queries.json",
                            {"user": "u1", "num": 4})
        assert status == 200
        scores = body["itemScores"]
        assert len(scores) == 4
        assert all(s["item"].startswith("i") for s in scores)
        vals = [s["score"] for s in scores]
        assert vals == sorted(vals, reverse=True)
        status, body = post(f"http://127.0.0.1:{ps_port}/queries.json",
                            {"user": "ghost", "num": 4})
        assert status == 200 and body["itemScores"] == []
        status, info = get(f"http://127.0.0.1:{ps_port}/")
        assert info["device"] == "cpu" and info["engineInstanceId"]
    finally:
        ps.stop()

    out_file = tmp_path / "export.jsonl"
    assert main(["export", "--appid-or-name", "QsApp",
                 "--output", str(out_file)]) == 0
    assert len(out_file.read_text().splitlines()) == 250


@pytest.fixture
def cpplog_home(sqlite_home, monkeypatch):
    """The events on a cpplog log under the temporary ``PIO_HOME``;
    metadata and models on SQLite there (child processes read the same)."""
    env = {"PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_SQL_PATH": str(sqlite_home / "pio.db"),
           "PIO_STORAGE_SOURCES_LOG_TYPE": "cpplog",
           "PIO_STORAGE_SOURCES_LOG_PATH": str(sqlite_home / "cpplog")}
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = f"pio_{repo.lower()}"
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = (
            "LOG" if repo == "EVENTDATA" else "SQL")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    Storage.reset()
    yield sqlite_home
    Storage.reset()


def test_readme_quickstart_unedited(sqlite_home, tmp_path, capsys):
    """The README's steps as a user runs them: the example's engine.json
    byte for byte, ``import_events.py`` unchanged, the servers as child
    processes stopped by a signal and by ``pio undeploy``."""
    _readme_quickstart(tmp_path, capsys)


def test_readme_quickstart_on_cpplog(cpplog_home, tmp_path, capsys):
    """The same steps with the events on the native log: the event server
    child appends to it, ``pio train`` reads it, and the log holds every
    event the example posted."""
    from incubator_predictionio_tpu_torch.data.storage import cpplog

    _readme_quickstart(tmp_path, capsys)
    events = Storage.get_events()
    assert isinstance(events, cpplog.CppLogEvents)
    assert (cpplog_home / "cpplog" / "pio_eventdata_app1_ch0.log").exists()
    assert len(list(events.find(app_id=1, event_names=["rate"]))) == 360


def _readme_quickstart(tmp_path, capsys):
    assert main(["app", "new", "MyApp1"]) == 0
    key = _access_key(capsys.readouterr().out)
    Storage.reset()  # a cpplog log is written by one process at a time
    es = _child(["eventserver", "--ip", "127.0.0.1", "--port", "0"],
                str(tmp_path), str(tmp_path / "es.log"))
    try:
        es_port = _wait_port(es, r"running on http://[^:]+:(\d+)")
        seeded = subprocess.run(
            [sys.executable, os.path.join(EXAMPLE, "import_events.py"),
             "--access-key", key, "--url", f"http://127.0.0.1:{es_port}"],
            capture_output=True, text=True, timeout=120)
        assert seeded.returncode == 0, seeded.stderr
        assert "imported 360 rate events" in seeded.stdout
    finally:
        es[0].send_signal(signal.SIGTERM)
        assert es[0].wait(60) == 0, open(es[1]).read()

    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    shutil.copyfile(os.path.join(EXAMPLE, "engine.json"),
                    engine_dir / "engine.json")
    cwd = os.getcwd()
    os.chdir(engine_dir)
    try:
        assert main(["build"]) == 0
        assert main(["train"]) == 0
    finally:
        os.chdir(cwd)
    iid = re.search(r"Engine instance ID: (\S+)",
                    capsys.readouterr().out).group(1)
    instance = Storage.get_meta_data_engine_instances().get(iid)
    assert instance.engine_factory == (
        "incubator_predictionio_tpu.models.recommendation:"
        "RecommendationEngine")

    dep = _child(["deploy", "--ip", "127.0.0.1", "--port", "0",
                  "--server-key", "sk"],
                 str(engine_dir), str(tmp_path / "deploy.log"))
    try:
        port = _wait_port(dep, r"deployed on http://[^:]+:(\d+)")
        status, body = post(f"http://127.0.0.1:{port}/queries.json",
                            {"user": "u1", "num": 4})
        assert status == 200 and len(body["itemScores"]) == 4
        status, info = get(f"http://127.0.0.1:{port}/")
        assert info["device"] == "cpu" and info["engineInstanceId"] == iid
        assert main(["undeploy", "--ip", "127.0.0.1", "--port",
                     str(port), "--server-key", "wrong"]) == 1
        assert main(["undeploy", "--ip", "127.0.0.1", "--port",
                     str(port), "--server-key", "sk"]) == 0
        assert dep[0].wait(60) == 0, open(dep[1]).read()
    finally:
        if dep[0].poll() is None:
            dep[0].kill()


def test_train_and_deploy_refuse_without_the_cpu_switch(sqlite_home,
                                                        tmp_path,
                                                        monkeypatch):
    """Without CUDA and without ``PIO_DEVICE=cpu``, ``pio train`` and ``pio
    deploy`` exit 1 naming the switch; nothing falls back to the CPU."""
    monkeypatch.delenv("PIO_DEVICE")
    (tmp_path / "engine.json").write_text(json.dumps(VARIANT))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join(
               [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    for verb in ("train", "deploy", "status"):
        proc = subprocess.run([*CLI, verb], cwd=tmp_path, capture_output=True,
                              text=True, timeout=120, env=env)
        assert proc.returncode == 1, (verb, proc.stdout, proc.stderr)
        assert "PIO_DEVICE=cpu" in proc.stderr + proc.stdout


def _seed_ratings(app_name, seed=0, n_users=30, n_items=20):
    from incubator_predictionio_tpu.data.datamap import DataMap as JDataMap
    from incubator_predictionio_tpu.data.event import Event as JEvent
    from incubator_predictionio_tpu.data.store import EventStore as JStore

    rng = np.random.default_rng(seed)
    JStore.write([
        JEvent(event="rate", entity_type="user", entity_id=f"u{u}",
               target_entity_type="item", target_entity_id=f"i{i}",
               properties=JDataMap({"rating": float(rng.integers(1, 6))}))
        for u in range(n_users)
        for i in rng.choice(n_items, 8, replace=False)], app_name=app_name)


def test_jax_trained_instance_deployed_by_the_port(sqlite_home, tmp_path,
                                                   monkeypatch, capsys):
    """``pio train`` of the JAX package on one store; both packages'
    servers deploy that instance by id and answer alike."""
    from incubator_predictionio_tpu.cli import commands as jcommands
    from incubator_predictionio_tpu.cli.main import main as jmain
    from incubator_predictionio_tpu.servers.prediction_server import (
        PredictionServer as JPredictionServer,
        ServerConfig as JServerConfig,
    )

    assert jmain(["app", "new", "MyApp1"]) == 0
    _seed_ratings("MyApp1")
    variant = json.load(open(os.path.join(EXAMPLE, "engine.json")))
    (tmp_path / "engine.json").write_text(json.dumps(variant))
    monkeypatch.chdir(tmp_path)
    assert jmain(["train"]) == 0
    iid = re.search(r"Engine instance ID: (\S+)",
                    capsys.readouterr().out).group(1)

    jengine, _ = jcommands.engine_from_variant(variant)
    js = JPredictionServer(jengine, JServerConfig(
        ip="127.0.0.1", port=0, engine_instance_id=iid))
    engine, _ = commands.engine_from_variant(variant)
    ts = PredictionServer(engine, device="cpu", config=ServerConfig(
        ip="127.0.0.1", port=0, engine_instance_id=iid))
    jport, tport = js.start_background(), ts.start_background()
    try:
        for q in ([{"user": f"u{u}", "num": 5} for u in range(0, 30, 3)]
                  + [{"user": "u4", "num": 20}, {"user": "ghost", "num": 3}]):
            _s, jbody = post(f"http://127.0.0.1:{jport}/queries.json", q)
            _s, tbody = post(f"http://127.0.0.1:{tport}/queries.json", q)
            jitems = [x["item"] for x in jbody["itemScores"]]
            titems = [x["item"] for x in tbody["itemScores"]]
            assert titems == jitems, q
            np.testing.assert_allclose(
                [x["score"] for x in tbody["itemScores"]],
                [x["score"] for x in jbody["itemScores"]], rtol=1e-5)
        assert get(f"http://127.0.0.1:{tport}/")[1]["engineInstanceId"] == iid
    finally:
        js.stop()
        ts.stop()
    with pytest.raises(ValueError, match="Invalid engine instance ID"):
        PredictionServer(engine, device="cpu", config=ServerConfig(
            port=0, engine_instance_id="nosuch")).start_background()
    with pytest.raises(ValueError, match="No valid engine instance"):
        PredictionServer(engine, device="cpu", config=ServerConfig(
            port=0, engine_id="nosuch")).start_background()


def test_sequence_engine_through_the_cli(sqlite_home, tmp_path, monkeypatch,
                                         capsys):
    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.data.store import EventStore
    from incubator_predictionio_tpu_torch.utils.times import parse_iso8601
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    assert main(["app", "new", "SeqApp"]) == 0
    t0 = parse_iso8601("2024-01-01T00:00:00Z")
    rng = np.random.default_rng(5)
    EventStore.write([
        Event(event="view", entity_type="user", entity_id=f"s{s}",
              target_entity_type="item",
              target_entity_id=f"i{int(rng.integers(0, 12))}",
              event_time=t0 + timedelta(seconds=j))
        for s in range(6) for j in range(7)], app_name="SeqApp")
    variant = {
        "id": "seq",
        "engineFactory": "incubator_predictionio_tpu_torch.models.sequence:"
                         "SequenceEngine",
        "datasource": {"params": {"appName": "SeqApp"}},
        "preparator": {"params": {"maxLen": 6}},
        "algorithms": [{"name": "sasrec", "params": {
            "appName": "SeqApp", "dModel": 8, "nLayers": 1, "epochs": 1,
            "batchSize": 4, "seed": 0}}],
    }
    (tmp_path / "engine.json").write_text(json.dumps(variant))
    monkeypatch.chdir(tmp_path)
    assert main(["build"]) == 0
    assert main(["train"]) == 0
    iid = re.search(r"Engine instance ID: (\S+)",
                    capsys.readouterr().out).group(1)
    engine, engine_params = commands.engine_from_variant(variant)
    assert engine_params.preparator_params[1].max_len == 6
    deployed = PredictionServer(engine, device="cpu", config=ServerConfig(
        ip="127.0.0.1", port=0,
        engine_id=commands.engine_id_for_variant_path(
            str(tmp_path / "engine.json"), variant),
        engine_variant="seq"))
    by_hand = PredictionServer(
        engine, engine_params,
        CoreWorkflow.load_models(iid, engine, engine_params, device="cpu"),
        device="cpu")
    ports = deployed.start_background(), by_hand.start_background()
    try:
        for q in ({"user": "s1", "num": 3},
                  {"user": "x", "num": 4, "recentItems": ["i1", "i2"]}):
            a, b = (post(f"http://127.0.0.1:{p}/queries.json", q)[1]
                    for p in ports)
            assert a == b and len(a["itemScores"]) == q["num"]
    finally:
        deployed.stop()
        by_hand.stop()
