"""The port stands alone: it imports neither JAX nor the JAX package (every
module of it imports, ``ops/retrain.py``, ``data/storage/cpplog.py``,
``data/storage/traincache.py`` and the native loader among them, and the
served and the stored paths run on the CPU, a second train continuing from
the first, a train on the native event log, with both blocked), and its
entry points refuse to pick the CPU on their own."""

import subprocess
import sys
import textwrap

import pytest
import torch

from incubator_predictionio_tpu_torch import runtime
from incubator_predictionio_tpu_torch.models.recommendation.convert import (
    als_model_from_numpy,
)
from incubator_predictionio_tpu_torch.models.sequence.convert import (
    seqrec_model_from_numpy,
)
from incubator_predictionio_tpu_torch.ops.transformer import transformer_init
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.utils.planted import (
    random_transformer_fields,
)

_ISOLATED = textwrap.dedent('''
    import importlib, importlib.abc, json, pkgutil, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if (name == "incubator_predictionio_tpu"
                    or name.startswith("incubator_predictionio_tpu.")):
                raise ImportError("the port imported " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    import incubator_predictionio_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import numpy as np
    import urllib.request
    from incubator_predictionio_tpu_torch.core.params import EngineParams
    from incubator_predictionio_tpu_torch.models.recommendation import engine
    from incubator_predictionio_tpu_torch.models.recommendation.convert import (
        als_model_from_numpy)
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        PredictionServer)
    rng = np.random.default_rng(0)
    model = als_model_from_numpy(
        rng.standard_normal((5, 4)), rng.standard_normal((9, 4)),
        [f"u{i}" for i in range(5)], [f"i{i}" for i in range(9)],
        device="cpu")
    srv = PredictionServer(engine.RecommendationEngine().apply(),
                           EngineParams(), [model], device="cpu")
    port = srv.start_background()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/queries.json",
            data=b'{"user": "u2", "num": 3}', method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = json.loads(resp.read())
    finally:
        srv.stop()
    from incubator_predictionio_tpu_torch.models.sequence import (
        convert as seq_convert, engine as seq_engine)
    from incubator_predictionio_tpu_torch.utils.planted import (
        random_transformer_fields)
    seq_model = seq_convert.seqrec_model_from_numpy(
        random_transformer_fields(9, 9, 8, 1, seed=0),
        [f"i{i}" for i in range(9)], 2, 9, device="cpu")
    srv = PredictionServer(
        seq_engine.SequenceEngine().apply(),
        EngineParams(algorithm_params_list=[
            ("sasrec", seq_engine.SeqRecAlgorithmParams(app_name="a"))]),
        [seq_model], device="cpu")
    port = srv.start_background()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/queries.json",
            data=b'{"user": "u", "num": 4, "recentItems": ["i1", "i2"]}',
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            seq_body = json.loads(resp.read())
    finally:
        srv.stop()
    # the stored path: events in SQLite under a temporary PIO_HOME →
    # run_train → load_models → /queries.json, then a sequence query
    # answered from the store's history
    import os, tempfile
    from datetime import timedelta
    os.environ["PIO_HOME"] = tempfile.mkdtemp()
    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.data.interactions import (
        Interactions)
    from incubator_predictionio_tpu_torch.data.storage import App, Storage
    from incubator_predictionio_tpu_torch.utils.times import parse_iso8601
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow)
    Storage.reset()
    app_id = Storage.get_meta_data_apps().insert(App(0, "app"))
    Storage.get_events().init(app_id)
    Storage.get_events().import_interactions(Interactions(
        user_idx=rng.integers(0, 5, 40).astype(np.int32),
        item_idx=rng.integers(0, 9, 40).astype(np.int32),
        values=rng.integers(1, 6, 40).astype(np.float32),
        user_ids=[f"u{i}" for i in range(5)],
        item_ids=[f"i{i}" for i in range(9)]), app_id)
    t0 = parse_iso8601("2024-01-01T00:00:00Z")
    Storage.get_events().insert_batch([
        Event(event="view", entity_type="user", entity_id=f"s{u}",
              target_entity_type="item", target_entity_id=f"i{(u + j) % 9}",
              event_time=t0 + timedelta(seconds=j))
        for u in range(4) for j in range(5)], app_id)
    ep = EngineParams(
        data_source_params=("", engine.DataSourceParams(app_name="app")),
        algorithm_params_list=[("als", engine.ALSAlgorithmParams(
            rank=2, num_iterations=2, seed=0))])
    eng = engine.RecommendationEngine().apply()
    CoreWorkflow.run_train(eng, ep, device="cpu")
    # the second train continues from the first (ops/retrain.py)
    iid = CoreWorkflow.run_train(eng, ep, device="cpu")
    from incubator_predictionio_tpu_torch.obs import metrics
    continued = metrics.REGISTRY.get("pio_train_sweeps_total").labels(
        mode="continue").value
    srv = PredictionServer(eng, ep, CoreWorkflow.load_models(
        iid, eng, ep, device="cpu"), device="cpu")
    port = srv.start_background()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/queries.json",
            data=b'{"user": "u1", "num": 2}', method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            stored_body = json.loads(resp.read())
    finally:
        srv.stop()
    seq_ep = EngineParams(
        data_source_params=("", seq_engine.DataSourceParams(app_name="app")),
        preparator_params=("", seq_engine.PreparatorParams(max_len=4)),
        algorithm_params_list=[("sasrec", seq_engine.SeqRecAlgorithmParams(
            app_name="app", d_model=8, n_layers=1, epochs=1, seed=0))])
    seq_eng = seq_engine.SequenceEngine().apply()
    iid = CoreWorkflow.run_train(seq_eng, seq_ep, device="cpu")
    srv = PredictionServer(seq_eng, seq_ep, CoreWorkflow.load_models(
        iid, seq_eng, seq_ep, device="cpu"), device="cpu")
    port = srv.start_background()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/queries.json",
            data=b'{"user": "s1", "num": 3}', method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            seq_stored_body = json.loads(resp.read())
    finally:
        srv.stop()
    # the native event log (cpplog; metadata on SQLite, models on
    # localfs): a columnar import, a train, a tail, and the read its
    # training projection serves
    from incubator_predictionio_tpu_torch.data.storage import traincache
    from incubator_predictionio_tpu_torch.data.store import EventStore
    traincache.MIN_NNZ = 4
    log_home = tempfile.mkdtemp()
    Storage.configure({
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": os.path.join(log_home, "pio.db"),
        "PIO_STORAGE_SOURCES_LOG_TYPE": "cpplog",
        "PIO_STORAGE_SOURCES_LOG_PATH": os.path.join(log_home, "log"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": os.path.join(log_home, "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS"})
    log_app = Storage.get_meta_data_apps().insert(App(0, "app"))
    Storage.get_events().init(log_app)
    Storage.get_events().import_interactions(Interactions(
        user_idx=rng.integers(0, 5, 40).astype(np.int32),
        item_idx=rng.integers(0, 9, 40).astype(np.int32),
        values=rng.integers(1, 6, 40).astype(np.float32),
        user_ids=[f"u{i}" for i in range(5)],
        item_ids=[f"i{i}" for i in range(9)]), log_app,
        times=1_700_000_000_000 + np.arange(40))
    log_iid = CoreWorkflow.run_train(eng, ep, device="cpu")
    from incubator_predictionio_tpu_torch.data.datamap import DataMap
    Storage.get_events().insert(Event(
        event="rate", entity_type="user", entity_id="u9",
        target_entity_type="item", target_entity_id="i1",
        properties=DataMap({"rating": 4.0})), log_app)
    log_stats = {}
    log_rows = len(EventStore.interactions(
        app_name="app", value_prop="rating", stats=log_stats))
    log_models = len(CoreWorkflow.load_models(log_iid, eng, ep,
                                              device="cpu"))
    log_type = type(Storage.get_events()).__module__
    Storage.reset()
    leaked = sorted(m for m in sys.modules
                    if m == "incubator_predictionio_tpu"
                    or m.startswith("incubator_predictionio_tpu."))
    print(json.dumps({"modules": len(names), "items": len(body["itemScores"]),
                      "seq_items": len(seq_body["itemScores"]),
                      "stored_items": len(stored_body["itemScores"]),
                      "seq_stored_items": len(
                          seq_stored_body["itemScores"]),
                      "continued": continued,
                      "log": [log_type, log_stats["scan_source"],
                              log_stats["scan_tail_rows"], log_rows,
                              log_models],
                      "leaked": leaked}))
''')


def test_port_imports_and_serves_without_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _ISOLATED],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["modules"] >= 22
    assert out["items"] == 3
    assert out["seq_items"] == 4
    assert out["stored_items"] == 2
    assert out["seq_stored_items"] == 3
    assert out["continued"] >= 1
    assert out["log"] == ["incubator_predictionio_tpu_torch.data.storage."
                          "cpplog", "cache", 1, 41, 1]
    assert out["leaked"] == []


def test_default_device_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.default_device()
    with pytest.raises(RuntimeError):
        RuntimeContext()
    with pytest.raises(RuntimeError):
        als_model_from_numpy([[1.0]], [[1.0]], ["u"], ["i"])
    fields = random_transformer_fields(3, 4, 8, 1)
    with pytest.raises(RuntimeError):
        seqrec_model_from_numpy(fields, ["a", "b", "c"], 2, 4)
    with pytest.raises(RuntimeError):
        transformer_init(torch.Generator(), 3, 4, 8, 1)
    assert runtime.default_device("cpu") == torch.device("cpu")


def test_cuda_tensor_never_takes_the_plain_version():
    """A kernel wrapper given a non-CPU tensor launches or raises; here
    (no card) the meta device stands in for one it cannot launch on."""
    from incubator_predictionio_tpu_torch.ops import attention_kernels, kernels

    runtime.reset_launch_counts()
    q = torch.empty((1, 8), device="meta")
    items = torch.empty((100, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.score_topk(q, items, None, 5)
    assert kernels.SCORE_TOPK_LAUNCHES.value == 0
    x = torch.empty((1, 64, 2, 32), device="meta")
    valid = torch.ones((1, 64), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        attention_kernels.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):   # mixed devices
        attention_kernels.flash_attention(x, x, x, kv_valid=valid)
    assert sum(runtime.launch_counts().values()) == 0


def test_kernel_resources_reads_the_ptxas_report(tmp_path, monkeypatch):
    """The build keeps each source's ``ptxas -v`` output; the report gives
    registers, spills and static shared memory for each kernel."""
    (tmp_path / "flash_attention_abc.ptxas").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1kIfLi32EEv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z1kIfLi32EEv\n"
        "    0 bytes stack frame, 24 bytes spill stores, 16 bytes spill "
        "loads\n"
        "ptxas info    : Used 127 registers, used 1 barriers, 1024 bytes "
        "smem, 552 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'\n"
        "ptxas info    : Used 8 registers, 368 bytes cmem[0]\n")
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(runtime, "_tag", "abc")
    assert runtime.kernel_resources("flash_attention") == [
        {"function": "_Z1kIfLi32EEv", "spill_stores": 24, "spill_loads": 16,
         "registers": 127, "static_smem": 1024},
        {"function": "_Z1gv", "registers": 8, "static_smem": 0}]
    assert runtime.kernel_resources("score_topk") == []


_RESOLVE_ISOLATED = textwrap.dedent('''
    import importlib.abc, json, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if (name == "incubator_predictionio_tpu"
                    or name.startswith("incubator_predictionio_tpu.")):
                raise ImportError("the port imported " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    from incubator_predictionio_tpu_torch.cli import commands
    variant = {"engineFactory": "incubator_predictionio_tpu.models."
                                "recommendation:RecommendationEngine",
               "datasource": {"params": {"appName": "MyApp1"}},
               "algorithms": [{"name": "als", "params": {"rank": 10}}]}
    engine, params = commands.engine_from_variant(variant)
    leaked = sorted(m for m in sys.modules
                    if m == "incubator_predictionio_tpu"
                    or m.startswith("incubator_predictionio_tpu."))
    print(json.dumps({"engine": type(engine).__module__,
                      "rank": params.algorithm_params_list[0][1].rank,
                      "leaked": leaked}))
''')


def test_a_jax_named_factory_resolves_to_the_port_importing_nothing_of_jax():
    """The README's engine.json names the JAX package's factory; the port
    maps it by name and never imports the JAX package to do so."""
    proc = subprocess.run([sys.executable, "-c", _RESOLVE_ISOLATED],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"engine": "incubator_predictionio_tpu_torch.core.engine",
                   "rank": 10, "leaked": []}


@pytest.mark.parametrize("verb", ["train", "deploy"])
def test_cli_train_and_deploy_refuse_without_cuda(verb, tmp_path,
                                                  monkeypatch, capsys):
    """Without CUDA, ``pio train`` and ``pio deploy`` stop at the device
    check unless ``PIO_DEVICE=cpu`` asks for the CPU; with it they go on
    (here to the missing engine.json)."""
    from incubator_predictionio_tpu_torch.cli.main import main

    def no_cuda():
        raise RuntimeError("Torch not compiled with CUDA enabled")

    monkeypatch.setattr(torch.cuda, "init", no_cuda)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PIO_DEVICE", raising=False)
    assert main([verb]) == 1
    err = capsys.readouterr().err
    assert "accelerator initialization failed" in err
    assert "PIO_DEVICE=cpu" in err
    monkeypatch.setenv("PIO_DEVICE", "cpu")
    assert main([verb]) == 1
    err = capsys.readouterr().err
    assert "engine.json does not exist" in err
    assert "accelerator" not in err


_SPEED_ISOLATED = textwrap.dedent('''
    import importlib, importlib.abc, json, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if (name == "incubator_predictionio_tpu"
                    or name.startswith("incubator_predictionio_tpu.")):
                raise ImportError("the port imported " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    module = sys.argv[1]
    importlib.import_module(module)
    out = {"module": module}
    if module.endswith("ecommerce"):
        # the template trained on a memory store, deployed with its
        # implicit overlay, a cold user folded in and served
        import numpy as np
        from incubator_predictionio_tpu_torch.core.params import EngineParams
        from incubator_predictionio_tpu_torch.data.event import Event
        from incubator_predictionio_tpu_torch.data.storage import App, Storage
        from incubator_predictionio_tpu_torch.data.store import EventStore
        from incubator_predictionio_tpu_torch.models.ecommerce import engine
        from incubator_predictionio_tpu_torch.servers.prediction_server import (
            PredictionServer, ServerConfig)
        from incubator_predictionio_tpu_torch.workflow.workflow import (
            CoreWorkflow)
        Storage.configure({
            "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
            "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "m",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "e",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "d",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
        Storage.get_meta_data_apps().insert(App(0, "shop"))
        rng = np.random.default_rng(0)
        EventStore.write([Event(
            event="view", entity_type="user", entity_id=f"u{k % 7}",
            target_entity_type="item", target_entity_id=f"i{int(i)}")
            for k, i in enumerate(rng.integers(0, 12, 60))], "shop")
        ep = EngineParams(
            data_source_params=("", engine.DataSourceParams(app_name="shop")),
            algorithm_params_list=[("ecomm", engine.ECommAlgorithmParams(
                app_name="shop", rank=3, num_iterations=2, seed=0))])
        eng = engine.ECommerceEngine().apply()
        CoreWorkflow.run_train(eng, ep, device="cpu")
        srv = PredictionServer(eng, device="cpu", config=ServerConfig(port=0))
        srv.load_models()
        EventStore.write([Event(
            event="view", entity_type="user", entity_id="walkin",
            target_entity_type="item", target_entity_id="i3")], "shop")
        out["solved"] = srv._speed_overlays[0].poll()["solved"]
        out["items"] = len(srv._handle_batch(
            [b'{"user": "walkin", "num": 2}'], "default",
            "default")[0]["itemScores"])
        srv.stop()
        Storage.reset()
    out["leaked"] = sorted(
        m for m, mod in sys.modules.items() if mod is not None and (
            m in ("jax", "jaxlib") or m == "incubator_predictionio_tpu"
            or m.startswith("incubator_predictionio_tpu.")))
    print(json.dumps(out))
''')


@pytest.mark.parametrize("module", [
    "incubator_predictionio_tpu_torch.speed",
    "incubator_predictionio_tpu_torch.speed.foldin",
    "incubator_predictionio_tpu_torch.speed.overlay",
    "incubator_predictionio_tpu_torch.obs.freshness",
    "incubator_predictionio_tpu_torch.models.ecommerce",
])
def test_speed_layer_and_ecommerce_import_nothing_of_jax(module):
    """Each module of the speed layer and the ecommerce template imports
    with JAX and the JAX package blocked; the template also trains,
    deploys with its overlay, folds a cold user in and serves it."""
    proc = subprocess.run([sys.executable, "-c", _SPEED_ISOLATED, module],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    if module.endswith("ecommerce"):
        assert (out["solved"], out["items"]) == (1, 2)


_SERVING_ISOLATED = textwrap.dedent('''
    import importlib, importlib.abc, json, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if (name == "incubator_predictionio_tpu"
                    or name.startswith("incubator_predictionio_tpu.")):
                raise ImportError("the port imported " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    importlib.import_module(sys.argv[1])
    out = {}
    if sys.argv[1].endswith("prediction_server"):
        # tenants, the scheduler, the SLO engine and the state seam
        # together: a deploy with PIO_TENANTS serves through the
        # scheduler, refuses a wrong key, and reloads
        import os, threading, urllib.error, urllib.request
        import numpy as np
        os.environ["PIO_TENANTS"] = "acme:acme-key"
        os.environ["PIO_SERVE_SHED"] = "0"  # a loaded host sheds nothing
        from incubator_predictionio_tpu_torch.core.params import EngineParams
        from incubator_predictionio_tpu_torch.models.recommendation import (
            convert, engine)
        from incubator_predictionio_tpu_torch.obs import recorder, slo
        from incubator_predictionio_tpu_torch.servers.prediction_server import (
            PredictionServer)
        rng = np.random.default_rng(0)
        model = convert.als_model_from_numpy(
            rng.standard_normal((5, 4)), rng.standard_normal((9, 4)),
            [f"u{i}" for i in range(5)], [f"i{i}" for i in range(9)],
            device="cpu")
        srv = PredictionServer(engine.RecommendationEngine().apply(),
                               EngineParams(), [model], device="cpu")
        port = srv.start_background()
        codes = []

        def post(key):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/queries.json?accessKey={key}",
                data=b'{"user": "u2", "num": 3}', method="POST")
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    codes.append((resp.status,
                                  len(json.loads(resp.read())["itemScores"])))
            except urllib.error.HTTPError as e:
                codes.append((e.code, 0))

        threads = [threading.Thread(target=post, args=(k,))
                   for k in ["acme-key"] * 6 + ["wrong"]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        out["codes"] = sorted(codes)
        out["state"] = sorted(recorder.collect_state())
        out["specs"] = [s.name for s in slo.default_specs()][-1]
        srv.stop()
    out["leaked"] = sorted(
        m for m, mod in sys.modules.items() if mod is not None and (
            m in ("jax", "jaxlib") or m == "incubator_predictionio_tpu"
            or m.startswith("incubator_predictionio_tpu.")))
    print(json.dumps(out))
''')


@pytest.mark.parametrize("module", [
    "incubator_predictionio_tpu_torch.serving",
    "incubator_predictionio_tpu_torch.serving.scheduler",
    "incubator_predictionio_tpu_torch.serving.tenancy",
    "incubator_predictionio_tpu_torch.obs.slo",
    "incubator_predictionio_tpu_torch.obs.recorder",
    "incubator_predictionio_tpu_torch.servers.prediction_server",
])
def test_serving_scheduler_modules_import_nothing_of_jax(module):
    """Each module of the serving scheduler's slice imports with JAX and
    the JAX package blocked; the prediction server, given ``PIO_TENANTS``,
    answers concurrent queries through the scheduler, refuses a wrong key
    with 401 and publishes the scheduler's state."""
    proc = subprocess.run([sys.executable, "-c", _SERVING_ISOLATED,
                           module],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    if module.endswith("prediction_server"):
        assert out["codes"] == [[200, 3]] * 6 + [[401, 0]]
        assert out["state"] == ["scheduler"]
        assert out["specs"] == "serve_p99@acme"
