"""The port's CLI (``incubator_predictionio_tpu_torch.cli.main``) on the
CPU, against the JAX package's: ``tests/test_cli.py``'s app, access key,
import / export, build / train and ``undeploy`` cases run through both
CLIs on stores of their own, with the same outputs (keys and ids aside);
the verbs the port has not ported raise ``NotImplementedError`` naming
their ROADMAP item; ``train`` and ``deploy`` run on the CPU only with the
switch (``PIO_DEVICE=cpu``, set here for every test)."""

import json
import re

import numpy as np
import pytest

from incubator_predictionio_tpu.cli.main import main as jmain
from incubator_predictionio_tpu.data.storage import Storage as JStorage
from incubator_predictionio_tpu_torch.cli import commands
from incubator_predictionio_tpu_torch.cli.main import main
from incubator_predictionio_tpu_torch.data.datamap import DataMap
from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.data.storage import Storage

MEMORY = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}
PORT_FACTORY = ("incubator_predictionio_tpu_torch.models.recommendation:"
                "RecommendationEngine")
JAX_FACTORY = ("incubator_predictionio_tpu.models.recommendation:"
               "RecommendationEngine")


@pytest.fixture(autouse=True)
def stores(monkeypatch):
    monkeypatch.setenv("PIO_DEVICE", "cpu")
    monkeypatch.setenv("PIO_RETRAIN_CONTINUE", "0")
    Storage.configure(dict(MEMORY))
    JStorage.configure(dict(MEMORY))
    yield
    Storage.reset()
    JStorage.reset()


def _masked(text: str) -> str:
    """CLI output with access keys, ids and engine hashes masked."""
    text = re.sub(r"[A-Za-z0-9_-]{40,}", "<key>", text)
    return re.sub(r"\b[0-9a-f]{16,32}\b", "<id>", text)


def _both(capsys, *argv, rc=0):
    """One verb through both CLIs: the same exit code and output lines
    (in any order: listings sort by the random keys)."""
    assert jmain(list(argv)) == rc, argv
    jout = capsys.readouterr().out
    assert main(list(argv)) == rc, argv
    tout = capsys.readouterr().out
    assert sorted(_masked(tout).splitlines()) == \
        sorted(_masked(jout).splitlines()), (argv, jout, tout)
    return tout


def test_version_and_help(capsys):
    assert main(["version"]) == 0
    assert capsys.readouterr().out.startswith("pio-torch ")
    assert main([]) == 1


def test_status(capsys):
    assert main(["status"]) == 0
    out = capsys.readouterr().out
    assert "Storage: OK" in out and "on the CPU (PIO_DEVICE=cpu)" in out


def test_app_lifecycle(capsys):
    _both(capsys, "app", "new", "CliApp", "--description", "d")
    _both(capsys, "app", "new", "CliApp", rc=1)
    _both(capsys, "app", "list")
    _both(capsys, "app", "show", "CliApp")
    _both(capsys, "app", "channel-new", "CliApp", "chan-a")
    _both(capsys, "app", "channel-new", "CliApp", "chan-a", rc=1)
    _both(capsys, "app", "channel-new", "CliApp", "bad name!", rc=1)
    _both(capsys, "app", "show", "CliApp")
    _both(capsys, "app", "channel-delete", "CliApp", "chan-a", "-f")
    _both(capsys, "app", "channel-delete", "CliApp", "ghost", "-f", rc=1)
    _both(capsys, "app", "data-delete", "CliApp", "-f")
    _both(capsys, "app", "delete", "CliApp", "-f")
    _both(capsys, "app", "show", "CliApp", rc=1)


def test_accesskey_lifecycle(capsys):
    _both(capsys, "app", "new", "KeyApp")
    out = _both(capsys, "accesskey", "new", "KeyApp", "--key", "my-key",
                "--events", "rate", "buy")
    assert "my-key" in out
    out = _both(capsys, "accesskey", "list", "KeyApp")
    assert "my-key" in out and "rate, buy" in out
    _both(capsys, "accesskey", "delete", "my-key")
    _both(capsys, "accesskey", "delete", "my-key", rc=1)
    _both(capsys, "accesskey", "new", "GhostApp", rc=1)


def test_import_export_round_trip(tmp_path, capsys):
    _both(capsys, "app", "new", "IOApp")
    src = tmp_path / "events.jsonl"
    events = [
        {"event": "rate", "entityType": "user", "entityId": f"u{i}",
         "targetEntityType": "item", "targetEntityId": "i1",
         "properties": {"rating": i}, "eventTime": "2020-01-01T00:00:00.000Z"}
        for i in range(5)
    ]
    src.write_text("\n".join(json.dumps(e) for e in events))
    _both(capsys, "import", "--appid-or-name", "IOApp", "--input", str(src))
    outs = []
    for cli, name in ((jmain, "jax.jsonl"), (main, "port.jsonl")):
        dst = tmp_path / name
        assert cli(["export", "--appid-or-name", "IOApp",
                    "--output", str(dst)]) == 0
        outs.append(sorted(
            ({k: v for k, v in json.loads(line).items()
              if k not in ("eventId", "creationTime")}
             for line in dst.read_text().splitlines()),
            key=lambda d: d["entityId"]))
    assert outs[0] == outs[1] and len(outs[1]) == 5
    assert {d["entityId"] for d in outs[1]} == {f"u{i}" for i in range(5)}
    capsys.readouterr()
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"entityType": "user"}\n')
    _both(capsys, "import", "--appid-or-name", "IOApp", "--input", str(bad),
          rc=1)
    capsys.readouterr()
    # an app named by its id
    assert main(["export", "--appid-or-name", "1",
                 "--output", str(tmp_path / "by_id.jsonl")]) == 0
    assert main(["export", "--appid-or-name", "99",
                 "--output", str(tmp_path / "none.jsonl")]) == 1


def test_parquet_export_without_pyarrow(tmp_path, capsys):
    """``--format parquet`` needs pyarrow, as in the JAX package: without it
    the verb fails with the reason (exit 1); with it the file is written."""
    main(["app", "new", "PqApp"])
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        assert main(["export", "--appid-or-name", "PqApp", "--output",
                     str(tmp_path / "e.parquet"), "--format",
                     "parquet"]) == 1
        assert "pyarrow" in capsys.readouterr().err
    else:
        assert main(["export", "--appid-or-name", "PqApp", "--output",
                     str(tmp_path / "e.parquet"), "--format",
                     "parquet"]) == 0


def test_import_on_sqlite_matches_jax(tmp_path, capsys):
    """A uniform id-less file, and the same file with event ids, imported
    through both CLIs onto SQLite stores of their own: the same output and
    the same stored events; an imported id keeps its event."""
    for storage, name in ((Storage, "port.db"), (JStorage, "jax.db")):
        storage.reset()
        storage.configure({
            "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(tmp_path / name),
            **{f"PIO_STORAGE_REPOSITORIES_{r}_{f}": v
               for r in ("METADATA", "EVENTDATA", "MODELDATA")
               for f, v in (("NAME", r.lower()), ("SOURCE", "SQL"))}})
    _both(capsys, "app", "new", "SqlApp")
    docs = [
        {"event": "rate", "entityType": "user", "entityId": f"u{i % 7}",
         "targetEntityType": "item", "targetEntityId": f"i{i % 5}",
         "properties": {"rating": float(1 + i % 4)},
         "eventTime": f"2020-01-01T00:00:{i % 60:02d}.000Z"}
        for i in range(60)
    ]
    src = tmp_path / "events.jsonl"
    src.write_text("\n".join(json.dumps(d) for d in docs))
    out = _both(capsys, "import", "--appid-or-name", "SqlApp",
                "--input", str(src))
    assert out == "Imported 60 events.\n"
    src2 = tmp_path / "with_ids.jsonl"
    src2.write_text("\n".join(json.dumps(dict(d, eventId=f"e{i:031d}"))
                              for i, d in enumerate(docs)))
    _both(capsys, "import", "--appid-or-name", "SqlApp", "--input",
          str(src2))

    given = {f"e{i:031d}" for i in range(len(docs))}

    def stored(storage):
        return sorted(
            ({k: v for k, v in e.to_jsonable().items()
              if k != "creationTime"
              and not (k == "eventId" and v not in given)}
             for e in storage.get_events().find(app_id=1)),
            key=json.dumps)

    assert stored(Storage) == stored(JStorage)
    assert len(stored(Storage)) == 120
    assert Storage.get_events().get("e" + "0" * 31, 1) is not None


def _seed_quickstart_events(store_mod, event_cls, datamap_cls, app_name):
    rng = np.random.default_rng(0)
    events = []
    for u in range(30):
        for i in rng.choice(20, size=8, replace=False):
            events.append(event_cls(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties=datamap_cls(
                    {"rating": float(rng.integers(1, 6))}),
            ))
    store_mod.EventStore.write(events, app_name=app_name)


@pytest.mark.parametrize("factory", [PORT_FACTORY, JAX_FACTORY])
def test_build_train_from_engine_json(tmp_path, monkeypatch, capsys,
                                      factory):
    """``pio build`` and ``pio train`` from an engine.json naming the
    port's factory, or the JAX package's (mapped by name): the instance is
    COMPLETED under the engine id the JAX CLI derives from the same
    directory and factory string, and its params read back typed."""
    from incubator_predictionio_tpu.cli import commands as jcommands
    from incubator_predictionio_tpu_torch.data import store

    main(["app", "new", "MyApp1"])
    _seed_quickstart_events(store, Event, DataMap, "MyApp1")
    variant = {
        "id": "cli-test",
        "engineFactory": factory,
        "datasource": {"params": {"appName": "MyApp1"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 8, "numIterations": 5, "lambda": 0.05, "seed": 1,
        }}],
    }
    (tmp_path / "engine.json").write_text(json.dumps(variant))
    monkeypatch.chdir(tmp_path)
    assert main(["build"]) == 0
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["engineFactory"] == factory
    assert main(["train"]) == 0
    out = capsys.readouterr().out
    assert "Engine instance ID:" in out
    engine_id = commands.engine_id_for_variant_path(
        str(tmp_path / "engine.json"), variant)
    assert engine_id == jcommands.engine_id_for_variant_path(
        str(tmp_path / "engine.json"), variant)
    latest = Storage.get_meta_data_engine_instances().get_latest_completed(
        engine_id, "NOT_VERSIONED", "cli-test")
    assert latest is not None and latest.status == "COMPLETED"
    assert latest.engine_factory == factory
    assert '"numIterations": 5' in latest.algorithms_params
    assert "phase.train.algo0_s" in latest.runtime_conf
    engine, _ = commands.engine_from_variant(variant)
    restored = engine.engine_params_from_instance(latest)
    assert restored.algorithm_params_list[0][1].num_iterations == 5
    assert restored.algorithm_params_list[0][1].lambda_ == 0.05
    assert main(["unregister"]) == 0
    assert main(["unregister"]) == 1


def test_train_twice_continues_from_the_first_instance(tmp_path,
                                                      monkeypatch, capsys):
    """``pio train`` twice with continuation on (the default), through
    both CLIs on stores of their own: the first train is fresh, the second,
    after a tail of ratings, continues from the first instance (as the JAX
    CLI's does) and records its ``continue_seed`` phase, and the latest
    COMPLETED instance, the one ``pio deploy`` loads, is the continued
    one."""
    from incubator_predictionio_tpu.data.datamap import DataMap as JDataMap
    from incubator_predictionio_tpu.data.event import Event as JEvent
    from incubator_predictionio_tpu.obs import metrics as jmetrics
    from incubator_predictionio_tpu_torch.data import store
    from incubator_predictionio_tpu_torch.obs import metrics

    monkeypatch.delenv("PIO_RETRAIN_CONTINUE")
    jstore = __import__("incubator_predictionio_tpu.data.store",
                        fromlist=["EventStore"])
    _both(capsys, "app", "new", "MyApp1")
    for mod, ev, dm in ((store, Event, DataMap), (jstore, JEvent, JDataMap)):
        _seed_quickstart_events(mod, ev, dm, "MyApp1")

    def sweeps(registry, mode):
        m = registry.REGISTRY.get("pio_train_sweeps_total")
        return 0.0 if m is None else m.labels(mode=mode).value

    for cli, reg, storage, mod, ev, dm, factory in (
            (main, metrics, Storage, store, Event, DataMap, PORT_FACTORY),
            (jmain, jmetrics, JStorage, jstore, JEvent, JDataMap,
             JAX_FACTORY)):
        variant = {
            "id": "twice", "engineFactory": factory,
            "datasource": {"params": {"appName": "MyApp1"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 8, "numIterations": 4, "lambda": 0.05, "seed": 1}}],
        }
        work = tmp_path / ("port" if cli is main else "jax")
        work.mkdir()
        (work / "engine.json").write_text(json.dumps(variant))
        monkeypatch.chdir(work)
        engine_id = commands.engine_id_for_variant_path(
            str(work / "engine.json"), variant)
        c0, f0 = sweeps(reg, "continue"), sweeps(reg, "fresh")
        assert cli(["build"]) == 0
        assert cli(["train"]) == 0
        assert (sweeps(reg, "continue"), sweeps(reg, "fresh")) == (c0, f0 + 4)
        first = storage.get_meta_data_engine_instances().get_latest_completed(
            engine_id, "NOT_VERSIONED", "twice")
        mod.EventStore.write([ev(
            event="rate", entity_type="user", entity_id=f"u{u}",
            target_entity_type="item", target_entity_id="i20",
            properties=dm({"rating": 4.0})) for u in range(30)],
            app_name="MyApp1")
        assert cli(["train"]) == 0
        assert sweeps(reg, "fresh") == f0 + 4
        assert 1 <= sweeps(reg, "continue") - c0 <= 4
        latest = storage.get_meta_data_engine_instances() \
            .get_latest_completed(engine_id, "NOT_VERSIONED", "twice")
        assert latest.id != first.id
        if cli is main:
            assert "phase.continue_seed_s" in latest.runtime_conf
            from incubator_predictionio_tpu_torch.workflow.workflow import (
                CoreWorkflow,
            )

            [model] = CoreWorkflow.load_models(latest.id)
            assert model.item_factors.shape == (21, 8)
    capsys.readouterr()


def test_train_missing_engine_json(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert main(["train"]) == 1
    assert main(["build"]) == 1


def test_factory_without_a_counterpart_raises(tmp_path, monkeypatch,
                                              capsys):
    for factory, why in (
            ("incubator_predictionio_tpu.models.classification:"
             "ClassificationEngine", "no counterpart in the PyTorch port"),
            ("incubator_predictionio_tpu_torch.models.recommendation:"
             "NoSuchEngine", "has no attribute"),
            ("nosuchmodule:Engine", "Cannot import")):
        with pytest.raises(commands.CommandError, match=why):
            commands.resolve_engine_factory(factory)
    (tmp_path / "engine.json").write_text(json.dumps({
        "engineFactory": "incubator_predictionio_tpu.models.stock:"
                         "StockEngine"}))
    monkeypatch.chdir(tmp_path)
    assert main(["build"]) == 1
    assert "incubator_predictionio_tpu.models.stock" in capsys.readouterr().err


def test_undeploy_nothing_running(capsys):
    _both(capsys, "undeploy", "--port", "59999", rc=1)


@pytest.mark.parametrize("argv,item", [
    (["eval", "evaluation:evaluation"], "item 6"),
    (["adminserver"], "item 8"),
    (["dashboard"], "item 8"),
    (["storageserver"], "item 1.6"),
    (["train", "--hosts", "h1,h2"], "item 9"),
    (["deploy", "--hosts", "h1"], "item 9"),
])
def test_verbs_not_ported_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        main(argv)


@pytest.mark.parametrize("flag,value", [("--feedback", None),
                                        ("--log-url", "http://x")])
def test_deploy_options_not_ported_raise(tmp_path, monkeypatch, flag,
                                         value):
    (tmp_path / "engine.json").write_text(json.dumps({
        "engineFactory": PORT_FACTORY,
        "datasource": {"params": {"appName": "A"}}}))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="item 8"):
        main(["deploy", flag] + ([value] if value else []))


def test_train_model_parallelism_above_one_raises(tmp_path, monkeypatch):
    """Only a model on one device is ported: ``--model-parallelism`` 2
    raises naming the multi-device item before anything is read."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="item 9"):
        main(["train", "--model-parallelism", "2"])


@pytest.mark.parametrize("flag,value", [
    ("--event-server-ip", "127.0.0.1"), ("--event-server-port", "7070"),
    ("--accesskey", "k"), ("--log-prefix", "p")])
def test_deploy_feedback_options_are_refused(capsys, flag, value):
    """The options only the feedback loop and the log shipper read (not
    ported, item 8) are not accepted: argparse refuses them (exit 2)
    instead of ignoring them."""
    with pytest.raises(SystemExit) as e:
        main(["deploy", flag, value])
    assert e.value.code == 2
    assert flag in capsys.readouterr().err


# -- the native event log (cpplog) under the CLI ----------------------------

def _cpplog_env(path):
    """Events on a cpplog log under ``path``; metadata and models in
    memory."""
    return {**MEMORY, "PIO_STORAGE_SOURCES_LOG_TYPE": "cpplog",
            "PIO_STORAGE_SOURCES_LOG_PATH": str(path),
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG"}


def _import_docs(n, timed=True):
    rng = np.random.default_rng(n)
    return [{"event": "rate", "entityType": "user",
             "entityId": f"u{int(rng.integers(0, 40))}",
             "targetEntityType": "item",
             "targetEntityId": f"i{int(rng.integers(0, 25))}",
             "properties": {"rating": float(rng.integers(1, 11)) / 2},
             **({"eventTime": f"2020-01-01T00:{k // 60 % 60:02d}:"
                              f"{k % 60:02d}.{k % 1000:03d}Z"}
                if timed else {})}
            for k in range(n)]


@pytest.mark.parametrize("case,columnar", [
    ("at_the_floor", True), ("below_the_floor", False),
    ("creation_time", False), ("no_event_time", True)])
def test_import_on_cpplog_matches_jax(tmp_path, monkeypatch, capsys, case,
                                      columnar):
    """``pio import`` onto cpplog stores through both CLIs: a uniform file
    of ``_FAST_IMPORT_MIN`` events or more takes the native columnar
    path (its own output line), a smaller one or one carrying
    ``creationTime`` the per-event path, as in the JAX package; the scan
    and the stored events are the JAX package's."""
    from incubator_predictionio_tpu.cli import commands as jcommands

    assert commands._FAST_IMPORT_MIN == jcommands._FAST_IMPORT_MIN == 10_000
    for mod in (commands, jcommands):
        monkeypatch.setattr(mod, "_FAST_IMPORT_MIN", 120)
    n = 119 if case == "below_the_floor" else 150
    docs = _import_docs(n, timed=case != "no_event_time")
    if case == "creation_time":
        docs[3]["creationTime"] = "2020-02-02T00:00:00.000Z"
    src = tmp_path / "events.jsonl"
    src.write_text("\n".join(json.dumps(d) for d in docs))
    for storage, sub in ((Storage, "port"), (JStorage, "jax")):
        storage.configure(_cpplog_env(tmp_path / sub))
    _both(capsys, "app", "new", "LogApp")
    out = _both(capsys, "import", "--appid-or-name", "LogApp", "--input",
                str(src))
    assert out == (f"Imported {n} events (native columnar path).\n"
                   if columnar else f"Imported {n} events.\n")
    kw = dict(app_id=1, event_names=("rate",), value_prop="rating")
    got = Storage.get_events().scan_interactions(**kw)
    ref = JStorage.get_events().scan_interactions(**kw)
    assert list(got.user_ids) == list(ref.user_ids)
    assert list(got.item_ids) == list(ref.item_ids)
    for f in ("user_idx", "item_idx", "values"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    assert len(got) == n

    def stored(storage):
        return sorted((json.dumps({k: v for k, v in e.to_jsonable().items()
                                   if k not in ("eventId", "creationTime")
                                   and not (case == "no_event_time"
                                            and k == "eventTime")},
                                  sort_keys=True)
                       for e in storage.get_events().find(app_id=1)))

    assert stored(Storage) == stored(JStorage)


def test_train_twice_on_cpplog(tmp_path, monkeypatch, capsys):
    """``pio train`` twice on a cpplog store, a tail between: each train's
    read is the sharded scan of the log, as the JAX package's (the
    recommendation read names two events, ``rate`` and ``buy`` at a fixed
    value, which the projection does not serve), the second continues from
    the first; the single-event read the projection does serve gives,
    after the tail, the projection plus exactly the tail's rows, equal to
    a read that bypasses the projection, and the same factors from the
    same seed."""
    from incubator_predictionio_tpu.data.storage import cpplog as jcpplog
    from incubator_predictionio_tpu.data.storage import (
        traincache as jtraincache,
    )
    from incubator_predictionio_tpu_torch.data import store
    from incubator_predictionio_tpu_torch.data.storage import (
        cpplog,
        traincache,
    )
    from incubator_predictionio_tpu_torch.ops import als

    monkeypatch.delenv("PIO_RETRAIN_CONTINUE")
    monkeypatch.setattr(commands, "_FAST_IMPORT_MIN", 100)
    monkeypatch.setattr(traincache, "MIN_NNZ", 100)
    monkeypatch.setattr(jtraincache, "MIN_NNZ", 100)
    Storage.configure(_cpplog_env(tmp_path / "log"))
    assert main(["app", "new", "MyApp1"]) == 0
    src = tmp_path / "events.jsonl"
    src.write_text("\n".join(json.dumps(d) for d in _import_docs(240)))
    assert main(["import", "--appid-or-name", "MyApp1", "--input",
                 str(src)]) == 0
    assert "native columnar path" in capsys.readouterr().out
    dao = Storage.get_events()
    cpath = traincache.path_for(dao.client._file(dao.ns, 1, None))
    assert traincache.load(cpath).raw_count == 240  # written at import

    scans = []
    real = cpplog.CppLogEvents.scan_interactions

    def recording(self, *a, stats=None, **kw):
        stats = {} if stats is None else stats
        out = real(self, *a, stats=stats, **kw)
        scans.append(dict(stats, kw=dict(kw)))
        return out

    monkeypatch.setattr(cpplog.CppLogEvents, "scan_interactions", recording)
    variant = {"id": "log", "engineFactory": PORT_FACTORY,
               "datasource": {"params": {"appName": "MyApp1"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 6, "numIterations": 3, "lambda": 0.05,
                   "seed": 2}}]}
    (tmp_path / "engine.json").write_text(json.dumps(variant))
    monkeypatch.chdir(tmp_path)
    assert main(["build"]) == 0
    assert main(["train"]) == 0
    store.EventStore.write([Event(
        event="rate", entity_type="user", entity_id=f"new{u}",
        target_entity_type="item", target_entity_id=f"i{u % 25}",
        properties=DataMap({"rating": 4.0})) for u in range(6)],
        app_name="MyApp1")
    assert main(["train"]) == 0
    assert [s["scan_source"] for s in scans] == ["scan", "scan"]
    assert [s["scan_rows"] for s in scans] == [240, 246]
    assert scans[0]["kw"]["event_names"] == ("rate", "buy")
    # the JAX package's cpplog takes the same read the same way
    jclient = jcpplog.StorageClient(_JConfig(tmp_path / "log"))
    try:
        jstats = {}
        jcpplog.CppLogEvents(jclient, None, prefix="e_").scan_interactions(
            app_id=1, event_names=("rate", "buy"), value_prop="rating",
            event_values={"buy": 4.0}, stats=jstats)
        assert jstats["scan_source"] == "scan"
    finally:
        jclient.close()
    latest = Storage.get_meta_data_engine_instances().get_latest_completed(
        commands.engine_id_for_variant_path(str(tmp_path / "engine.json"),
                                            variant), "NOT_VERSIONED", "log")
    assert "phase.continue_seed_s" in latest.runtime_conf
    # the read the projection serves: rate alone, its stored value
    monkeypatch.setattr(cpplog.CppLogEvents, "scan_interactions", real)
    stats = {}
    served = store.EventStore.interactions(app_name="MyApp1",
                                           value_prop="rating", stats=stats)
    assert (stats["scan_source"], stats["scan_tail_rows"]) == ("cache", 6)
    bypass = store.EventStore.interactions(app_name="MyApp1",
                                           value_prop="rating",
                                           use_cache=False, seed_cache=False)
    for f in ("user_idx", "item_idx", "values"):
        np.testing.assert_array_equal(getattr(served, f), getattr(bypass, f))
    assert list(served.user_ids) == list(bypass.user_ids)
    assert list(served.item_ids) == list(bypass.item_ids)
    fits = [als.als_train(r.user_idx, r.item_idx, r.values,
                          len(r.user_ids), len(r.item_ids), rank=6,
                          iterations=3, l2=0.05, seed=2, device="cpu")[0]
            for r in (served, bypass)]
    for f in ("user_factors", "item_factors"):
        assert torch_equal(getattr(fits[0], f), getattr(fits[1], f))


def _JConfig(path):
    from incubator_predictionio_tpu.data.storage import StorageClientConfig

    return StorageClientConfig(properties={"PATH": str(path)})


def torch_equal(a, b):
    import torch

    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))
