"""The port's async replication, twin of tests/test_replication.py: a
follower ``StorageServer`` of the port tails the leader's sharded cpplog
log over the wire (``data/storage/server.py`` ``ReplicationTail``).

The VectorCursor survives the wire round trip, an env-gated follower
catches up and serves byte-parity reads, new leader writes drain
continuously, and the follower resynchronizes through both a leader
restart and a leader compaction (generation/epoch bump). The restart twin
closes the old leader's log handles before the new leader opens the same
log: one log is never open twice in a process."""

from datetime import timedelta

import numpy as np
import pytest

from incubator_predictionio_tpu_torch.data.datamap import DataMap
from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.data.storage import base, cpplog
from incubator_predictionio_tpu_torch.data.storage import remote as remote_backend
from incubator_predictionio_tpu_torch.data.storage.server import StorageServer
from incubator_predictionio_tpu_torch.utils.times import parse_iso8601

T0 = parse_iso8601("2022-01-01T00:00:00Z")

SCAN_KW = dict(app_id=1, entity_type="user", target_entity_type="item",
               event_names=("rate",), value_prop="rating")


def _ev(eid, minutes=0, target="i0", rating=1.0):
    return Event(event="rate", entity_type="user", entity_id=eid,
                 target_entity_type="item", target_entity_id=target,
                 properties=DataMap({"rating": rating}),
                 event_time=T0 + timedelta(minutes=minutes))


def _parity(a, b):
    assert list(a.user_ids) == list(b.user_ids)
    assert np.array_equal(a.user_idx, b.user_idx)
    assert np.array_equal(a.item_idx, b.item_idx)
    assert np.array_equal(a.values, b.values)


@pytest.fixture
def leader(tmp_path, monkeypatch):
    """A 2-writer-shard leader behind a StorageServer, plus a
    RemoteEvents DAO pointed at it."""
    monkeypatch.setenv("PIO_LOG_SHARDS", "2")
    cfg = base.StorageClientConfig(
        parallel=False, test=True,
        properties={"PATH": str(tmp_path / "leader")})
    (tmp_path / "leader").mkdir()
    client = cpplog.StorageClient(cfg)
    server = StorageServer(cpplog, client, cfg, host="127.0.0.1", port=0)
    port = server.start_background()
    rc = remote_backend.StorageClient(base.StorageClientConfig(
        test=True, properties={"URL": f"http://127.0.0.1:{port}"}))
    revents = remote_backend.RemoteEvents(rc, rc.config, prefix="t_")
    revents.init(1)
    yield server, revents, port, tmp_path / "leader", client
    rc.close()
    server.stop()


def _start_follower(tmp_path, monkeypatch, lport):
    monkeypatch.setenv("PIO_REPLICATE_FROM", f"http://127.0.0.1:{lport}")
    monkeypatch.setenv("PIO_REPLICATE_APPS", "1")
    monkeypatch.setenv("PIO_REPLICATE_PREFIX", "t_")
    monkeypatch.setenv("PIO_REPLICATE_INTERVAL_S", "0.05")
    fdir = tmp_path / "follower"
    fdir.mkdir()
    fcfg = base.StorageClientConfig(
        parallel=False, test=True, properties={"PATH": str(fdir)})
    fclient = cpplog.StorageClient(fcfg)
    follower = StorageServer(cpplog, fclient, fcfg,
                             host="127.0.0.1", port=0)
    fport = follower.start_background()
    follower.maybe_start_replication()
    assert follower.replication is not None
    fc = remote_backend.StorageClient(base.StorageClientConfig(
        test=True, properties={"URL": f"http://127.0.0.1:{fport}"}))
    fevents = remote_backend.RemoteEvents(fc, fc.config, prefix="t_")
    return follower, fevents, fc


def test_vector_cursor_survives_the_wire(leader):
    _server, revents, _port, _dir, _client = leader
    ids = revents.insert_batch(
        [_ev(f"u{i}", i, target=f"i{i % 3}", rating=float(i % 5) + 0.5)
         for i in range(40)], 1)
    assert len(ids) == 40
    cur = revents.tail_cursor(app_id=1)
    assert isinstance(cur, base.VectorCursor)
    assert len(cur) == 2  # one component per writer shard
    inter, _times, append_ms, cur2, reset = revents.read_interactions_since(
        base.VectorCursor((0, 0)), **SCAN_KW)
    assert isinstance(cur2, base.VectorCursor) and not reset
    assert len(inter) == 40 and len(append_ms) == 40
    assert cur2 == cur
    inter3, _t, _a, cur3, _r = revents.read_interactions_since(
        cur2, **SCAN_KW)
    assert len(inter3) == 0 and cur3 == cur2


def test_follower_catches_up_and_drains_new_writes(
        leader, tmp_path, monkeypatch):
    _server, revents, lport, _dir, _client = leader
    revents.insert_batch(
        [_ev(f"u{i}", i, target=f"i{i % 3}", rating=float(i % 5) + 0.5)
         for i in range(40)], 1)
    follower, fevents, fc = _start_follower(tmp_path, monkeypatch, lport)
    try:
        assert follower.replication.wait_caught_up(timeout_s=30)
        assert follower.replication._lag_total(1) == 0
        _parity(fevents.scan_interactions(**SCAN_KW),
                revents.scan_interactions(**SCAN_KW))
        # continuous drain: new leader writes appear on the follower
        revents.insert_batch(
            [_ev(f"u{i}", 100 + i) for i in range(40, 55)], 1)
        assert follower.replication.wait_caught_up(timeout_s=30)
        assert len(fevents.scan_interactions(**SCAN_KW)) == 55
    finally:
        fc.close()
        follower.stop()


def test_follower_resyncs_after_leader_restart(
        leader, tmp_path, monkeypatch):
    """Kill the leader mid-replication, bring it back ON THE SAME PORT
    with the same directory, keep writing: the tail must ride through
    the connection errors and converge on the superset (the torn-tail /
    epoch resync path)."""
    server, revents, lport, ldir, lclient = leader
    revents.insert_batch([_ev(f"u{i}", i) for i in range(30)], 1)
    follower, fevents, fc = _start_follower(tmp_path, monkeypatch, lport)
    server2 = None
    try:
        assert follower.replication.wait_caught_up(timeout_s=30)
        server.stop()
        # the old leader's log handles are closed before the new leader
        # opens the same log (stop() closes them too; closing is idempotent)
        lclient.close()
        assert not lclient._handles
        cfg2 = base.StorageClientConfig(
            parallel=False, test=True, properties={"PATH": str(ldir)})
        client2 = cpplog.StorageClient(cfg2)
        server2 = StorageServer(cpplog, client2, cfg2,
                                host="127.0.0.1", port=lport)
        assert server2.start_background() == lport
        rc2 = remote_backend.StorageClient(base.StorageClientConfig(
            test=True, properties={"URL": f"http://127.0.0.1:{lport}"}))
        try:
            rev2 = remote_backend.RemoteEvents(rc2, rc2.config, prefix="t_")
            rev2.insert_batch(
                [_ev(f"u{i}", 200 + i) for i in range(30, 45)], 1)
            assert follower.replication.wait_caught_up(timeout_s=30)
            _parity(fevents.scan_interactions(**SCAN_KW),
                    rev2.scan_interactions(**SCAN_KW))
            assert len(fevents.scan_interactions(**SCAN_KW)) == 45
        finally:
            rc2.close()
    finally:
        fc.close()
        follower.stop()
        if server2 is not None:
            server2.stop()


def test_follower_resyncs_after_leader_compaction(
        leader, tmp_path, monkeypatch):
    """Leader-side compaction renumbers entries under the follower's
    cursor (generation/epoch bump): the tail must detect it, resync the
    affected shards, and converge rather than diverge or wedge."""
    _server, revents, lport, _dir, lclient = leader
    ids = revents.insert_batch([_ev(f"u{i}", i) for i in range(30)], 1)
    follower, fevents, fc = _start_follower(tmp_path, monkeypatch, lport)
    try:
        assert follower.replication.wait_caught_up(timeout_s=30)
        for eid in ids[::3]:
            assert revents.delete(eid, 1)
        # compaction is an operator-side op on the storage host itself
        ldao = cpplog.CppLogEvents(lclient, None, prefix="t_")
        stats = ldao.compact(1)
        assert stats["events"] > 0
        revents.insert_batch(
            [_ev(f"u{i}", 300 + i) for i in range(30, 40)], 1)
        assert follower.replication.wait_caught_up(timeout_s=30)
        _parity(fevents.scan_interactions(**SCAN_KW),
                revents.scan_interactions(**SCAN_KW))
    finally:
        fc.close()
        follower.stop()


def test_a_stopped_leader_answers_nothing_on_a_kept_alive_connection(
        leader):
    """``StorageServer.stop`` closes the connections its clients keep
    alive, as a killed leader would: a request on one after the stop
    fails (a fresh connection is refused), instead of being answered
    from the stopped server's closed log with its stale counts, which
    once let a follower's ``wait_caught_up`` report no lag before it had
    the restarted leader's new events."""
    import http.client
    import time

    server, _revents, lport, _dir, _client = leader
    conn = http.client.HTTPConnection("127.0.0.1", lport, timeout=10)
    conn.request("GET", "/")
    resp = conn.getresponse()
    assert resp.status == 200 and resp.getheader("Connection") != "close"
    resp.read()
    server.stop()
    deadline = time.monotonic() + 10.0
    answered = 0
    while time.monotonic() < deadline:
        try:
            conn.request("GET", "/")
            conn.getresponse().read()
            answered += 1
        except (OSError, http.client.HTTPException):
            break
        time.sleep(0.01)
    else:
        raise AssertionError(f"the stopped server answered {answered} "
                             "requests on a kept-alive connection for 10 s")
    conn.close()
