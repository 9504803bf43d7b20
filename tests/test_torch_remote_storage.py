"""The port's network storage (``data/storage/{wire,remote,server}.py``
and ``pio storageserver``) against the JAX package's.

- Twins of tests/test_remote_storage.py on the port: two clients share one
  store, metadata and models cross the wire, the registry resolves
  ``TYPE=remote``, the shared key gates the RPC surface, ``find`` streams in
  chunks, typed errors cross the wire, a ``pio storageserver`` child
  (``--port 0``) serves a client in this process and stops with exit 0 on
  SIGTERM, and the columnar insert crosses the wire (a memory box answers
  ``UnsupportedMethodError`` once, cached).
- Across packages: the port's client against a JAX ``StorageServer`` and
  the JAX client against the port's give the answers that the JAX client
  gets from the JAX server; ``wire.pack`` gives the same bytes in both.
- The 64 MiB request cap (``utils/http.MAX_BODY_BYTES``): a model blob
  above it is refused by ``Models.insert`` with a ``StorageError`` in both
  packages and is then absent.
- The event server over a remote store, both packages on the same setups:
  a memory box (no columnar insert) answers the first batch through the
  generic path with 201s and turns the columnar legs off; a box whose
  connection drops after a write's body was sent gives 500s, and the batch
  is not in the store (never written twice).
- The slice on the CPU (``PIO_DEVICE=cpu``): the same events through each
  package's own storage server and remote client, ``pio train`` of each
  from one initial state, the factors within the solvers' 1e-3; then the
  port's ``PredictionServer`` over ``remote`` folds in a user whose events
  a separate ``pio eventserver`` process wrote, and answers the plain top-k
  of the plain fold-in.
"""

import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from incubator_predictionio_tpu.data import datamap as jdatamap
from incubator_predictionio_tpu.data import event as jevent
from incubator_predictionio_tpu.data import storage as jstorage
from incubator_predictionio_tpu.data.storage import base as jbase
from incubator_predictionio_tpu.data.storage import memory as jmemory
from incubator_predictionio_tpu.data.storage import remote as jremote
from incubator_predictionio_tpu.data.storage import server as jserver
from incubator_predictionio_tpu.data.storage import wire as jwire
from incubator_predictionio_tpu_torch.data import datamap as tdatamap
from incubator_predictionio_tpu_torch.data import event as tevent
from incubator_predictionio_tpu_torch.data import storage as tstorage
from incubator_predictionio_tpu_torch.data.storage import base as tbase
from incubator_predictionio_tpu_torch.data.storage import cpplog as tcpplog
from incubator_predictionio_tpu_torch.data.storage import memory as tmemory
from incubator_predictionio_tpu_torch.data.storage import remote as tremote
from incubator_predictionio_tpu_torch.data.storage import server as tserver
from incubator_predictionio_tpu_torch.data.storage import wire as twire
from incubator_predictionio_tpu_torch.utils import http as thttp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = datetime(2022, 1, 1, tzinfo=timezone.utc)


class Pkg:
    """One package's storage modules, so a case can name either."""

    def __init__(self, name, datamap, event, storage, base, memory, remote,
                 server, wire):
        self.name = name
        self.DataMap = datamap.DataMap
        self.PropertyMap = datamap.PropertyMap
        self.Event = event.Event
        self.storage, self.base = storage, base
        self.memory, self.remote = memory, remote
        self.server, self.wire = server, wire
        self.Config = storage.StorageClientConfig
        self.StorageError = storage.StorageError


JAX = Pkg("jax", jdatamap, jevent, jstorage, jbase, jmemory, jremote,
          jserver, jwire)
PORT = Pkg("port", tdatamap, tevent, tstorage, tbase, tmemory, tremote,
           tserver, twire)
PKGS = {"jax": JAX, "port": PORT}


def memory_server(pkg, **kw):
    """A ``StorageServer`` of ``pkg`` over a fresh memory store."""
    config = pkg.Config(test=True, properties={})
    srv = pkg.server.StorageServer(pkg.memory, pkg.memory.StorageClient(
        config), config, host="127.0.0.1", port=0, **kw)
    return srv, srv.start_background()


def remote_client(pkg, port, **props):
    return pkg.remote.StorageClient(pkg.Config(
        test=True, properties={"URL": f"http://127.0.0.1:{port}", **props}))


@pytest.fixture
def shared_server():
    srv, port = memory_server(PORT)
    yield srv, port
    srv.stop()


def ev(name, eid, minutes=0, target=None, props=None, pkg=PORT):
    return pkg.Event(
        event=name, entity_type="user", entity_id=eid,
        target_entity_type="item" if target else None,
        target_entity_id=target, properties=pkg.DataMap(props or {}),
        event_time=T0 + timedelta(minutes=minutes))


# -- twins of tests/test_remote_storage.py -----------------------------------

def test_two_clients_share_one_store(shared_server):
    """Box A (eventserver) writes, box B (trainer) reads — one store."""
    _srv, port = shared_server
    box_a, box_b = remote_client(PORT, port), remote_client(PORT, port)
    try:
        events_a = tremote.RemoteEvents(box_a, box_a.config,
                                        prefix="pio_event_")
        events_b = tremote.RemoteEvents(box_b, box_b.config,
                                        prefix="pio_event_")
        events_a.init(1)
        events_a.insert(ev("rate", "u1", 0, target="i1",
                           props={"rating": 4.0}), 1)
        events_a.insert(ev("rate", "u2", 1, target="i1",
                           props={"rating": 3.0}), 1)
        got = list(events_b.find(app_id=1))
        assert {e.entity_id for e in got} == {"u1", "u2"}
        # the columnar scan crosses the wire as array buffers
        inter = events_b.scan_interactions(
            app_id=1, entity_type="user", target_entity_type="item",
            event_names=("rate",), value_prop="rating")
        assert len(inter) == 2
        assert list(inter.user_ids) == ["u1", "u2"]
        assert inter.values.dtype == np.float32
    finally:
        box_a.close()
        box_b.close()


def test_metadata_and_models_over_the_wire(shared_server):
    _srv, port = shared_server
    client = remote_client(PORT, port)
    try:
        apps = tremote.RemoteApps(client, client.config, prefix="pio_meta_")
        app_id = apps.insert(tbase.App(id=0, name="remoteapp"))
        assert apps.get_by_name("remoteapp").id == app_id
        models = tremote.RemoteModels(client, client.config,
                                      prefix="pio_model_")
        models.insert(tbase.Model(id="m1", models=b"\x00\x01binary"))
        assert models.get("m1").models == b"\x00\x01binary"
    finally:
        client.close()


def test_registry_resolves_remote_type(shared_server):
    _srv, port = shared_server
    tstorage.Storage.configure({
        "PIO_STORAGE_SOURCES_NET_TYPE": "remote",
        "PIO_STORAGE_SOURCES_NET_URL": f"http://127.0.0.1:{port}",
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "pio_meta",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NET",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "pio_event",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NET",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio_model",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "NET",
    })
    try:
        assert tstorage.Storage.verify_all_data_objects()
        apps = tstorage.Storage.get_meta_data_apps()
        assert isinstance(apps, tremote.RemoteApps)
        app_id = apps.insert(tbase.App(id=0, name="viaregistry"))
        assert tstorage.Storage.get_meta_data_apps().get(app_id).name == \
            "viaregistry"
    finally:
        tstorage.Storage.reset()


def test_auth_key_required():
    srv, port = memory_server(PORT, auth_key="s3cret")
    try:
        bad = remote_client(PORT, port)
        apps = tremote.RemoteApps(bad, bad.config, prefix="m_")
        with pytest.raises(tstorage.StorageError):
            apps.get_all()
        bad.close()
        good = remote_client(PORT, port, AUTHKEY="s3cret")
        apps = tremote.RemoteApps(good, good.config, prefix="m_")
        assert apps.get_all() == []
        good.close()
    finally:
        srv.stop()


def test_find_streams_in_chunks(shared_server, monkeypatch):
    """A find larger than one chunk streams through the server's cursor
    protocol instead of one response (server._find_rpc)."""
    monkeypatch.setattr(tserver, "FIND_CHUNK", 4)
    srv, port = shared_server
    client = remote_client(PORT, port)
    try:
        events = tremote.RemoteEvents(client, client.config,
                                      prefix="pio_event_")
        events.init(1)
        for i in range(11):
            events.insert(ev("view", f"u{i}", minutes=i), 1)
        got = list(events.find(app_id=1))
        assert [e.entity_id for e in got] == [f"u{i}" for i in range(11)]
        # abandoning an iteration midway frees the server-side cursor
        it = events.find(app_id=1)
        next(it)
        it.close()
        assert srv._cursors == {}
    finally:
        client.close()


def test_typed_errors_cross_the_wire(shared_server):
    _srv, port = shared_server
    client = remote_client(PORT, port)
    try:
        events = tremote.RemoteEvents(client, client.config,
                                      prefix="pio_event_")
        events.init(1)
        # a method that is not exported → StorageError, not a crash
        with pytest.raises(tstorage.StorageError, match="not exported"):
            client.rpc("Events", "pio_event_", "unknown_method", (), {})
    finally:
        client.close()


def _announced_port(proc, timeout: float = 120.0) -> int:
    """The port of the storage server child's announcement line."""
    holder: list = []

    def read() -> None:
        while True:
            line = proc.stdout.readline().decode(errors="replace")
            if not line:
                return
            m = re.search(r"Storage Server running on http://[^:]+:(\d+)",
                          line)
            if m:
                holder.append(int(m.group(1)))
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout=timeout)
    if not holder:
        proc.kill()
        raise AssertionError("storageserver never announced its port")
    return holder[0]


def test_real_two_process_topology(tmp_path):
    """``pio storageserver`` of the port as a child process (SQLite
    behind it, ``--port 0``), a client in this process: the box-A/box-B
    deployment. SIGTERM stops it with exit 0."""
    env = dict(os.environ,
               PIO_STORAGE_SOURCES_DISK_TYPE="sqlite",
               PIO_STORAGE_SOURCES_DISK_PATH=str(tmp_path / "shared.db"),
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_predictionio_tpu_torch.cli.main",
         "storageserver", "--ip", "127.0.0.1", "--port", "0",
         "--source", "DISK"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    try:
        port = _announced_port(proc)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=30) as resp:
            status = json.loads(resp.read())
        assert status["backend"] == "sqlite"
        assert "Events" in status["interfaces"]
        client = remote_client(PORT, port)
        events = tremote.RemoteEvents(client, client.config,
                                      prefix="pio_event_")
        events.init(1)
        eid = events.insert(ev("buy", "u9", target="i3"), 1)
        got = events.get(eid, 1)
        assert got is not None and got.entity_id == "u9"
        client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert b"Storage Server stopped." in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _columnar(pkg):
    return pkg.base.Interactions(
        user_idx=np.arange(6, dtype=np.int32),
        item_idx=np.arange(6, dtype=np.int32),
        values=np.ones(6, np.float32),
        user_ids=[f"wu{k}" for k in range(6)],
        item_ids=[f"wi{k}" for k in range(6)])


def test_insert_interactions_over_the_wire(tmp_path):
    """The columnar id-returning insert crosses the RPC: over a
    cpplog-backed box it returns the stored ids; over a memory-backed box
    it answers a typed UnsupportedMethodError once and the proxy caches
    the answer (no round trip afterwards)."""
    inter = _columnar(PORT)
    cfg = tbase.StorageClientConfig(test=True,
                                    properties={"PATH": str(tmp_path)})
    srv = tserver.StorageServer(tcpplog, tcpplog.StorageClient(cfg), cfg,
                                host="127.0.0.1", port=0)
    port = srv.start_background()
    try:
        rclient = remote_client(PORT, port)
        events = tremote.RemoteEvents(rclient, rclient.config)
        ids = events.insert_interactions(inter, app_id=1)
        assert len(ids) == 6 and all(len(i) == 32 for i in ids)
        got = events.get(ids[0], app_id=1)
        assert got is not None and got.entity_id == "wu0"
        rclient.close()
    finally:
        srv.stop()

    srv2, port2 = memory_server(PORT)
    try:
        rclient2 = remote_client(PORT, port2)
        events2 = tremote.RemoteEvents(rclient2, rclient2.config)
        with pytest.raises(tstorage.UnsupportedMethodError):
            events2.insert_interactions(inter, app_id=1)
        assert events2._columnar_insert_unsupported
        srv2.stop()  # server gone: a cached answer needs no wire
        with pytest.raises(tstorage.UnsupportedMethodError):
            events2.insert_interactions(inter, app_id=1)
        rclient2.close()
    finally:
        srv2.stop()


def test_unreachable_storage_server_is_an_error():
    """No fallback: a client whose server is gone raises StorageError."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    client = remote_client(PORT, port, TIMEOUT="5")
    try:
        with pytest.raises(tstorage.StorageError, match="never sent"):
            tremote.RemoteApps(client, client.config,
                               prefix="m_").get_all()
    finally:
        client.close()


# -- across packages ---------------------------------------------------------

def _scenario(pkg, port):
    """Every DAO family through ``pkg``'s client against the server at
    ``port``, seeded; the answers as plain values (event ids aside, which
    are random)."""
    client = remote_client(pkg, port)
    r, b = pkg.remote, pkg.base
    out = {}
    try:
        apps = r.RemoteApps(client, client.config, prefix="m_")
        aid = apps.insert(b.App(0, "xapp", "desc"))
        out["apps"] = [(a.id, a.name, a.description) for a in apps.get_all()]
        out["app_by_name"] = apps.get_by_name("xapp").id == aid
        keys = r.RemoteAccessKeys(client, client.config, prefix="m_")
        keys.insert(b.AccessKey("k1", aid, ("rate", "buy")))
        out["key"] = dataclass_values(keys.get("k1"))
        chans = r.RemoteChannels(client, client.config, prefix="m_")
        cid = chans.insert(b.Channel(0, "ch-1", aid))
        out["channels"] = [dataclass_values(c)
                           for c in chans.get_by_appid(aid)]
        insts = r.RemoteEngineInstances(client, client.config, prefix="m_")
        for k, status in enumerate(("COMPLETED", "INIT", "COMPLETED")):
            insts.insert(b.EngineInstance(
                id=f"e{k}", status=status, start_time=T0 + timedelta(k),
                end_time=T0 + timedelta(k, 60), engine_id="eng",
                engine_version="1", engine_variant="default",
                engine_factory="f", env={"a": "b"},
                runtime_conf={"phase.read_s": "0.5"}))
        out["latest"] = dataclass_values(
            insts.get_latest_completed("eng", "1", "default"))
        out["completed"] = [i.id for i in insts.get_completed(
            "eng", "1", "default")]
        events = r.RemoteEvents(client, client.config, prefix="ev_")
        out["init"] = events.init(aid)
        rng = np.random.default_rng(7)
        batch = [ev("rate", f"u{rng.integers(5)}", minutes=int(m),
                    target=f"i{rng.integers(6)}",
                    props={"rating": float(rng.integers(1, 11)) / 2},
                    pkg=pkg) for m in range(30)]
        batch += [pkg.Event(event="$set", entity_type="item",
                            entity_id=f"i{k}",
                            properties=pkg.DataMap({"categories": [f"c{k}"]}),
                            event_time=T0) for k in range(3)]
        cur = events.tail_cursor(aid)
        ids = events.insert_batch(batch, aid)
        out["n_ids"] = len(ids)
        out["get"] = event_key(events.get(ids[3], aid))
        out["find"] = [event_key(e) for e in events.find(
            app_id=aid, event_names=["rate"], limit=7, reversed=True)]
        inter = events.scan_interactions(
            app_id=aid, event_names=("rate",), value_prop="rating")
        out["scan"] = (list(inter.user_ids), list(inter.item_ids),
                       inter.user_idx.tolist(), inter.item_idx.tolist(),
                       inter.values.tolist())
        tail, _times, _append, _new, reset = events.read_interactions_since(
            cur, aid, value_prop="rating")
        out["tail"] = (len(tail), reset)
        props = events.aggregate_properties(app_id=aid, entity_type="item")
        out["props"] = {k: v.to_jsonable() for k, v in props.items()}
        out["delete"] = [events.delete(ids[0], aid),
                         events.delete(ids[0], aid)]
        models = r.RemoteModels(client, client.config, prefix="md_")
        models.insert(b.Model("m1", b"\x00blob\xff"))
        out["model"] = models.get("m1").models
        models.delete("m1")
        out["model_after"] = models.get("m1")
        try:
            client.rpc("Apps", "m_", "drop_everything", (), {})
        except pkg.StorageError as e:
            out["error"] = (type(e).__name__, str(e))
        out["cid"] = cid
    finally:
        client.close()
    return out


def dataclass_values(rec):
    import dataclasses

    return {f.name: getattr(rec, f.name) for f in dataclasses.fields(rec)}


def event_key(e):
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, e.properties.to_jsonable(),
            e.event_time.isoformat())


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_clients_and_servers_of_both_packages_agree(client_pkg, server_pkg):
    """The port's client against the JAX package's server, and the JAX
    client against the port's, answer as the JAX client and server do."""
    answers = []
    for c, s in (("jax", "jax"), (client_pkg, server_pkg)):
        srv, port = memory_server(PKGS[s])
        try:
            answers.append(_scenario(PKGS[c], port))
        finally:
            srv.stop()
    ref, got = answers
    assert got == ref
    assert ref["n_ids"] == 33 and ref["tail"] == (30, False)
    assert ref["error"][0] == "StorageError"


def _records(pkg):
    b = pkg.base
    when = datetime(2023, 5, 6, 7, 8, 9, 123456, tzinfo=timezone.utc)
    pm = pkg.PropertyMap({"a": 1, "b": [1.5, "x"]}, first_updated=when,
                         last_updated=when + timedelta(hours=1))
    inter = b.Interactions(
        user_idx=np.array([0, 1, 1], np.int32),
        item_idx=np.array([1, 0, 2], np.int32),
        values=np.array([4.0, 0.5, 3.5], np.float32),
        user_ids=b.IdTable.from_list(["u0", "ü1"]),
        item_ids=b.IdTable.from_list(["i0", "i1", "i2"]))
    return {
        "app": b.App(3, "name", None),
        "access_key": b.AccessKey("key", 3, ("rate",)),
        "channel": b.Channel(1, "ch-1", 3),
        "engine_instance": b.EngineInstance(
            "iid", "COMPLETED", when, when, "eng", "1", "default", "f",
            env={"k": "v"}, runtime_conf={"phase.read_s": "0.25"}),
        "evaluation_instance": b.EvaluationInstance(
            "eid", "EVALCOMPLETED", when, when, "ev:cls", "gen:cls",
            evaluator_results="0.5"),
        "engine_manifest": b.EngineManifest("e", "1", "n", "f",
                                            files=("engine.json",)),
        "model": b.Model("m", b"\x00\x01\xfe"),
        "event": pkg.Event(event="rate", entity_type="user",
                           entity_id="u1", target_entity_type="item",
                           target_entity_id="i1",
                           properties=pkg.DataMap({"rating": 4.5}),
                           event_time=when, event_id="a" * 32,
                           tags=("t",), pr_id="p", creation_time=when),
        "property_map": pm,
        "interactions": inter,
        "vector_cursor": list(b.VectorCursor((3, 5))),
        "unset": b.UNSET,
        "rpc": {"iface": "Events", "prefix": "p_", "method": "find",
                "args": [1, None, when, (1, 2)],
                "kwargs": {"limit": 5, "set": {3}, "arr": np.arange(
                    4, dtype=np.int64), "f": np.float32(0.5),
                    "keys": {1: "a"}}},
    }


@pytest.mark.parametrize("what", sorted(_records(PORT)))
def test_wire_packs_the_same_bytes_in_both_packages(what):
    """The same record packs to the same bytes in both packages, and each
    package decodes the other's bytes into its own class."""
    ref = jwire.pack(_records(JAX)[what])
    got = twire.pack(_records(PORT)[what])
    assert got == ref
    back = twire.unpack(ref)
    again = jwire.unpack(got)
    assert twire.pack(back) == ref
    assert jwire.pack(again) == got
    if what not in ("rpc", "vector_cursor", "unset", "interactions",
                    "property_map", "event"):
        assert type(back).__module__ == tbase.__name__
        assert type(again).__module__ == jbase.__name__
        assert dataclass_values(back) == dataclass_values(again)


# -- the 64 MiB request cap --------------------------------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_model_above_the_body_cap_is_refused(pkg):
    """A model blob above ``MAX_BODY_BYTES`` cannot be stored through a
    storage server in either package: ``Models.insert`` raises a
    ``StorageError`` and the model is then absent. (A rank-128 ML-20M
    model, ~84.6 MB of factors, is such a blob: MODELDATA stays on a
    shared filesystem for it.)"""
    p = PKGS[pkg]
    assert thttp.MAX_BODY_BYTES == 64 * 1024 * 1024
    srv, port = memory_server(p)
    client = remote_client(p, port)
    try:
        models = p.remote.RemoteModels(client, client.config, prefix="md_")
        models.insert(p.base.Model("small", b"\x01" * 1024))
        with pytest.raises(p.StorageError):
            models.insert(p.base.Model(
                "big", b"\x00" * (thttp.MAX_BODY_BYTES + 1)))
        assert models.get("big") is None
        assert models.get("small").models == b"\x01" * 1024
    finally:
        client.close()
        srv.stop()


# -- the event server over a remote store ------------------------------------

class DropWrites:
    """A proxy in front of a storage server that reads each request whole
    and forwards it, except an event write named in ``drop``: its connection is
    closed after the body arrived, with no answer and without forwarding,
    so the client cannot know whether the write was applied (it was not)."""

    def __init__(self, backend_port: int,
                 drop=("insert", "insert_batch", "insert_interactions")):
        self.backend_port = backend_port
        self.drop = set(drop)
        self.dropped: list = []
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        f = conn.makefile("rb")
        backend = http.client.HTTPConnection("127.0.0.1", self.backend_port,
                                             timeout=30)
        try:
            while True:
                line = f.readline()
                if not line:
                    return
                method, path, _ = line.decode().split(" ", 2)
                headers = {}
                while True:
                    h = f.readline().decode()
                    if h in ("\r\n", "\n", ""):
                        break
                    k, _, v = h.partition(":")
                    headers[k.strip()] = v.strip()
                body = f.read(int(headers.get("Content-Length", "0")))
                msg = twire.unpack(body) if body else {}
                name = msg.get("method", "")
                if msg.get("iface") == "Events" and name in self.drop:
                    self.dropped.append(name)
                    return
                backend.request(method, path, body=body, headers=headers)
                resp = backend.getresponse()
                data = resp.read()
                conn.sendall(
                    f"HTTP/1.1 {resp.status} X\r\nContent-Type: "
                    f"{resp.getheader('Content-Type')}\r\nContent-Length: "
                    f"{len(data)}\r\n\r\n".encode() + data)
        finally:
            backend.close()
            f.close()
            conn.close()

    def close(self):
        self.sock.close()


def _remote_env(port: int) -> dict:
    env = {"PIO_STORAGE_SOURCES_NET_TYPE": "remote",
           "PIO_STORAGE_SOURCES_NET_URL": f"http://127.0.0.1:{port}"}
    for repo, name in (("METADATA", "pio_meta"), ("EVENTDATA", "pio_event"),
                       ("MODELDATA", "pio_model")):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = name
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "NET"
    return env


def _event_server_mod(pkg):
    if pkg is JAX:
        from incubator_predictionio_tpu.servers import event_server
    else:
        from incubator_predictionio_tpu_torch.servers import event_server
    return event_server


def _post(url, docs):
    req = urllib.request.Request(url, json.dumps(docs).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _uniform(n, start=0):
    return [{"event": "rate", "entityType": "user", "entityId": f"u{k}",
             "targetEntityType": "item", "targetEntityId": f"i{k % 3}",
             "properties": {"rating": 4.0}} for k in range(start, start + n)]


def _statuses(body):
    if isinstance(body, list):
        return [d["status"] for d in body]
    return body


def _ingest_over(pkg, store_port, batches):
    """``pkg``'s event server on a remote store at ``store_port``: an app
    and its key, then each batch posted; returns (each answer's status and
    per-event statuses, whether the columnar legs turned off)."""
    storage = pkg.storage.Storage
    storage.configure(_remote_env(store_port))
    es_mod = _event_server_mod(pkg)
    srv = None
    try:
        app_id = storage.get_meta_data_apps().insert(pkg.base.App(0, "app"))
        storage.get_events().init(app_id)
        storage.get_meta_data_access_keys().insert(
            pkg.base.AccessKey("key", app_id, ()))
        srv = es_mod.EventServer(es_mod.EventServerConfig(
            ip="127.0.0.1", port=0))
        url = (f"http://127.0.0.1:{srv.start_background()}"
               "/batch/events.json?accessKey=key")
        answers = []
        for docs in batches:
            status, body = _post(url, docs)
            # the messages name the storage server's port: one per run
            body = json.loads(re.sub(r"127\.0\.0\.1:\d+", "HOST",
                                     json.dumps(body)))
            answers.append((status, _statuses(body)))
        return answers, bool(getattr(srv, "_columnar_unsupported", False)), \
            app_id
    finally:
        if srv is not None:
            srv.stop()
        storage.reset()


def test_event_server_on_a_box_without_columnar_insert_matches_jax():
    """A memory box has no columnar insert: the first batch answers 201s
    through the generic path, the columnar legs turn off for the process,
    and the next batch goes straight to the generic path — as the JAX
    package's event server does."""
    results = {}
    for name, pkg in PKGS.items():
        srv, port = memory_server(pkg)
        try:
            answers, off, app_id = _ingest_over(
                pkg, port, [_uniform(10), _uniform(12, 10)])
            back = pkg.memory.DATA_OBJECTS["Events"](srv.client, srv.config,
                                                     prefix="pio_event_")
            stored = sorted(e.entity_id for e in back.find(app_id=app_id))
            results[name] = (answers, off, stored)
        finally:
            srv.stop()
    assert results["port"] == results["jax"]
    answers, off, stored = results["port"]
    assert answers == [(200, [201] * 10), (200, [201] * 12)]
    assert off and stored == sorted(f"u{k}" for k in range(22))


@pytest.mark.parametrize("leg", ["columnar", "bulk"])
def test_ambiguous_write_is_a_500_and_never_stored_twice(leg):
    """A box whose connection drops after a write's body was sent: the
    columnar leg answers 500 with the message, the bulk leg a 500 for each
    event, never a retry on another path; the store holds none of the
    batch. Equal to the JAX package's event server on the same setup."""
    docs = _uniform(10)
    if leg == "bulk":   # two event names: no columnar leg takes it
        docs[3]["event"] = "buy"
        del docs[3]["properties"]
    results = {}
    for name, pkg in PKGS.items():
        srv, port = memory_server(pkg)
        proxy = DropWrites(port)
        try:
            answers, _off, app_id = _ingest_over(pkg, proxy.port, [docs])
            back = pkg.memory.DATA_OBJECTS["Events"](srv.client, srv.config,
                                                     prefix="pio_event_")
            results[name] = (answers, len(list(back.find(app_id=app_id))),
                             proxy.dropped)
        finally:
            proxy.close()
            srv.stop()
    assert results["port"][:2] == results["jax"][:2]
    answers, stored, dropped = results["port"]
    assert stored == 0
    if leg == "columnar":
        # a memory box has no columnar insert, but the proxy drops the
        # call before the box can say so: the write is ambiguous
        assert dropped == ["insert_interactions"]
        assert answers[0][0] == 500
        assert "may or may not have been applied" in answers[0][1]["message"]
    else:
        assert dropped == ["insert_batch"]
        assert answers == [(200, [500] * 10)]


# -- the slice on the CPU ----------------------------------------------------

RANK, USERS, ITEMS = 6, 40, 30


def _ratings(seed=5, n=400):
    rng = np.random.default_rng(seed)
    keys = rng.choice(USERS * ITEMS, n, replace=False)
    return keys // ITEMS, keys % ITEMS, rng.integers(1, 11, n) / 2.0


def _variant(pkg_name: str) -> dict:
    factory = ("incubator_predictionio_tpu_torch" if pkg_name == "port"
               else "incubator_predictionio_tpu")
    return {"id": "default",
            "engineFactory": f"{factory}.models.recommendation:"
                             "RecommendationEngine",
            "datasource": {"params": {"appName": "RemoteApp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "numIterations": 5, "lambda": 0.05,
                "seed": 3}}]}


def _train_over_remote(pkg_name, port, work, monkeypatch, capsys):
    """``pio train`` of ``pkg_name``'s CLI in this process, its stores
    behind the storage server at ``port``; the events posted first through
    the package's Storage. Returns the trained model."""
    pkg = PKGS[pkg_name]
    storage = pkg.storage.Storage
    for k, v in _remote_env(port).items():
        monkeypatch.setenv(k, v)
    storage.reset()
    users, items, ratings = _ratings()
    app_id = storage.get_meta_data_apps().insert(pkg.base.App(0, "RemoteApp"))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch([
        ev("rate", f"u{u}", minutes=k, target=f"i{i}",
           props={"rating": float(r)}, pkg=pkg)
        for k, (u, i, r) in enumerate(zip(users, items, ratings))], app_id)
    engine_dir = work / pkg_name
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps(_variant(pkg_name)))
    monkeypatch.chdir(engine_dir)
    if pkg is JAX:
        from incubator_predictionio_tpu.cli.main import main
        from incubator_predictionio_tpu.workflow.workflow import CoreWorkflow
    else:
        from incubator_predictionio_tpu_torch.cli.main import main
        from incubator_predictionio_tpu_torch.workflow.workflow import (
            CoreWorkflow,
        )
    capsys.readouterr()
    assert main(["train"]) == 0
    iid = re.search(r"Engine instance ID: (\S+)",
                    capsys.readouterr().out).group(1)
    kw = {} if pkg is JAX else {"device": "cpu"}
    from incubator_predictionio_tpu_torch.cli import commands

    variant = commands.load_variant("engine.json") if pkg is PORT else None
    if pkg is PORT:
        engine, params = commands.engine_from_variant(variant)
        [model] = CoreWorkflow.load_models(iid, engine, params, **kw)
    else:
        from incubator_predictionio_tpu.cli import commands as jcommands

        engine, params = jcommands.engine_from_variant(
            jcommands.load_variant("engine.json"))
        [model] = CoreWorkflow.load_models(iid, engine, params)
    storage.reset()
    return model, iid


def _factors(model):
    uf = np.asarray(model.user_factors, np.float64)
    vf = np.asarray(model.item_factors, np.float64)
    users = [model.user_bimap.inverse[k] for k in range(len(uf))]
    items = [model.item_bimap.inverse[k] for k in range(len(vf))]
    return dict(zip(users, uf)), dict(zip(items, vf))


def _jax_init(monkeypatch):
    """The port's ``als_init`` patched to the JAX package's (as in
    tests/test_torch_evaluation.py)."""
    import jax

    import incubator_predictionio_tpu.ops.als as jals
    from incubator_predictionio_tpu_torch.ops import als

    def init(gen, n_users, n_items, rank, device=None, scale=0.1):
        st = jals.als_init(jax.random.key(int(gen.initial_seed())), n_users,
                           n_items, rank)
        return als.ALSState(
            torch.from_numpy(np.array(st.user_factors)).to(device),
            torch.from_numpy(np.array(st.item_factors)).to(device))

    monkeypatch.setattr(als, "als_init", init)


def test_remote_topology_trains_and_folds_in(tmp_path, monkeypatch, capsys):
    """The README main path across processes on the CPU: each package's
    ``pio train`` over its own storage server from one initial state (the
    port's ``als_init`` patched to the JAX package's), the factors within
    1e-3 of max|x| (the two solvers' agreement, tests/test_torch_als.py);
    then the port's ``PredictionServer`` over ``remote`` with its speed
    layer, and a ``pio eventserver`` child writing a new user's ratings
    through the same storage server: the user is answered from their
    fold-in, the plain top-k of the plain fold-in of the posted ratings."""
    from incubator_predictionio_tpu_torch.core.params import EngineParams
    from incubator_predictionio_tpu_torch.models.recommendation import (
        engine,
    )
    from incubator_predictionio_tpu_torch.ops import kernels
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        PredictionServer,
        ServerConfig,
    )
    from incubator_predictionio_tpu_torch.speed import foldin

    monkeypatch.setenv("PIO_DEVICE", "cpu")
    monkeypatch.setenv("PIO_RETRAIN_CONTINUE", "0")
    _jax_init(monkeypatch)
    servers = {name: memory_server(pkg) for name, pkg in PKGS.items()}
    es = srv = None
    try:
        models = {name: _train_over_remote(name, servers[name][1], tmp_path,
                                           monkeypatch, capsys)
                  for name in ("jax", "port")}
        (ju, jv), (tu, tv) = (_factors(models[n][0]) for n in ("jax", "port"))
        assert set(tu) == set(ju) and set(tv) == set(jv)
        for got, ref in ((tu, ju), (tv, jv)):
            ref_a = np.stack([ref[k] for k in sorted(ref)])
            got_a = np.stack([got[k] for k in sorted(ref)])
            assert np.abs(got_a - ref_a).max() <= 1e-3 * np.abs(ref_a).max()

        # the port's deploy over remote, a separate event server's events
        store_port = servers["port"][1]
        for k, v in _remote_env(store_port).items():
            monkeypatch.setenv(k, v)
        monkeypatch.setenv("PIO_SPEED_POLL_S", "0.2")
        tstorage.Storage.reset()
        model, iid = models["port"]
        key = "remote-key"
        apps = tstorage.Storage.get_meta_data_apps()
        tstorage.Storage.get_meta_data_access_keys().insert(
            tbase.AccessKey(key, apps.get_by_name("RemoteApp").id, ()))
        srv = PredictionServer(
            engine.RecommendationEngine().apply(), device="cpu",
            config=ServerConfig(ip="127.0.0.1", port=0,
                                engine_instance_id=iid))
        base = f"http://127.0.0.1:{srv.start_background()}"
        [ov] = srv._speed_overlays
        assert ov is not None and ov.enabled
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        es = subprocess.Popen(
            [sys.executable, "-m",
             "incubator_predictionio_tpu_torch.cli.main", "eventserver",
             "--ip", "127.0.0.1", "--port", "0"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        holder: list = []

        def read():
            for line in iter(es.stdout.readline, b""):
                m = re.search(rb"running on http://[^:]+:(\d+)", line)
                if m:
                    holder.append(int(m.group(1)))
                    return

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        reader.join(120)
        assert holder, "the event server child announced no port"
        rng = np.random.default_rng(9)
        cols = rng.choice(ITEMS, 8, replace=False)
        vals = (rng.integers(1, 11, 8) / 2.0).astype(np.float32)
        status, body = _post(
            f"http://127.0.0.1:{holder[0]}/batch/events.json?accessKey={key}",
            [{"event": "rate", "entityType": "user", "entityId": "walkin",
              "targetEntityType": "item", "targetEntityId": f"i{c}",
              "properties": {"rating": float(r)}}
             for c, r in zip(cols, vals)])
        assert status == 200 and _statuses(body) == [201] * 8
        deadline = time.monotonic() + 30
        while True:
            status, answer = _post(f"{base}/queries.json",
                                   {"user": "walkin", "num": 5})
            assert status == 200
            if answer["itemScores"] or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        assert len(answer["itemScores"]) == 5
        items_t = model.item_factors.cpu()
        rows = [(np.array([model.item_bimap[f"i{c}"] for c in cols],
                          np.int32), vals)]
        vec = foldin.FoldInSolver(items_t, l2=ov.config.l2).solve(rows)
        ref_s, ref_i = kernels.score_topk_plain(
            torch.as_tensor(vec).reshape(1, -1), items_t, None, 5)
        assert [x["item"] for x in answer["itemScores"]] == [
            model.item_bimap.inverse[int(i)] for i in ref_i[0]]
        np.testing.assert_allclose(
            [x["score"] for x in answer["itemScores"]],
            ref_s[0].numpy(), rtol=1e-5)
        es.send_signal(signal.SIGTERM)
        assert es.wait(timeout=30) == 0
        es = None
    finally:
        if es is not None:
            es.kill()
            es.wait()
        if srv is not None:
            srv.stop()
        tstorage.Storage.reset()
        jstorage.Storage.reset()
        for s, _port in servers.values():
            s.stop()
