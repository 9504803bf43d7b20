"""SQLite storage backend — the durable single-box backend.

The port's own copy of incubator_predictionio_tpu/data/storage/sqlite.py,
its imports rewritten to this package.

Parity target: the reference's JDBC driver, which implements the *full*
backend surface (events + all metadata + model blobs) on PostgreSQL/MySQL
(data/.../storage/jdbc/, 1393 LoC: JDBCLEvents, JDBCPEvents, JDBCApps,
JDBCAccessKeys, JDBCChannels, JDBCEngineInstances, JDBCEvaluationInstances,
JDBCModels, JDBCUtils). SQLite gives the same durability contract with zero
service dependencies; the DAO layer is schema-compatible with a Postgres
driver should one be added (SQL here is deliberately generic).

Repository namespaces (``PIO_STORAGE_REPOSITORIES_<REPO>_NAME``) map to an
``ns`` column in every table — the same isolation the reference gets from
per-namespace table names (jdbc/JDBCUtils tableName). Event times are stored
as epoch-millis integers for fast range scans (jdbc/JDBCLEvents.scala:44-66).

Concurrency: one connection per thread for file databases (WAL), one shared
connection for ``:memory:``; ALL statements — reads included — run under the
client lock so no thread observes another's uncommitted transaction on the
shared connection.
"""

from __future__ import annotations

import dataclasses
import json
import sqlite3
import threading
import uuid
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Iterator, Optional, Sequence

from incubator_predictionio_tpu_torch.data.datamap import DataMap
from incubator_predictionio_tpu_torch.data.event import Event, new_event_id, validate_event
from incubator_predictionio_tpu_torch.data.storage import base
from incubator_predictionio_tpu_torch.data.storage.base import UNSET
from incubator_predictionio_tpu_torch.utils.times import from_millis, to_millis


class StorageClient(base.BaseStorageClient):
    """One SQLite database file (``:memory:`` supported for tests)."""

    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        path = config.properties.get("PATH", "")
        if not path or path == ":memory:":
            self._path = ":memory:"
        else:
            p = Path(path).expanduser()
            p.parent.mkdir(parents=True, exist_ok=True)
            self._path = str(p)
        self._local = threading.local()
        self._memory_conn: Optional[sqlite3.Connection] = None
        self._all_conns: list[sqlite3.Connection] = []
        self._lock = threading.RLock()
        self._init_schema()

    @property
    def conn(self) -> sqlite3.Connection:
        # ":memory:" must share one connection; files get one per thread.
        if self._path == ":memory:":
            with self._lock:
                if self._memory_conn is None:
                    self._memory_conn = sqlite3.connect(
                        ":memory:", check_same_thread=False
                    )
                return self._memory_conn
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self._path)
            conn.execute("PRAGMA journal_mode=WAL")
            self._local.conn = conn
            with self._lock:
                self._all_conns.append(conn)
        return conn

    @property
    def lock(self) -> threading.RLock:
        return self._lock

    def _init_schema(self) -> None:
        with self._lock, self.conn as c:
            c.executescript(
                """
                CREATE TABLE IF NOT EXISTS events (
                    ns TEXT NOT NULL,
                    id TEXT NOT NULL,
                    app_id INTEGER NOT NULL,
                    channel_id INTEGER NOT NULL DEFAULT -1,
                    event TEXT NOT NULL,
                    entity_type TEXT NOT NULL,
                    entity_id TEXT NOT NULL,
                    target_entity_type TEXT,
                    target_entity_id TEXT,
                    properties TEXT,
                    event_time INTEGER NOT NULL,
                    event_time_zone TEXT,
                    tags TEXT,
                    pr_id TEXT,
                    creation_time INTEGER NOT NULL,
                    PRIMARY KEY (ns, id, app_id, channel_id)
                );
                CREATE INDEX IF NOT EXISTS idx_events_scan
                    ON events (ns, app_id, channel_id, event_time);
                CREATE TABLE IF NOT EXISTS apps (
                    ns TEXT NOT NULL,
                    id INTEGER NOT NULL,
                    name TEXT NOT NULL,
                    description TEXT,
                    PRIMARY KEY (ns, id),
                    UNIQUE (ns, name)
                );
                CREATE TABLE IF NOT EXISTS access_keys (
                    ns TEXT NOT NULL,
                    key TEXT NOT NULL,
                    app_id INTEGER NOT NULL,
                    events TEXT NOT NULL,
                    PRIMARY KEY (ns, key)
                );
                CREATE TABLE IF NOT EXISTS channels (
                    ns TEXT NOT NULL,
                    id INTEGER NOT NULL,
                    name TEXT NOT NULL,
                    app_id INTEGER NOT NULL,
                    PRIMARY KEY (ns, id),
                    UNIQUE (ns, app_id, name)
                );
                CREATE TABLE IF NOT EXISTS engine_instances (
                    ns TEXT NOT NULL,
                    id TEXT NOT NULL,
                    status TEXT NOT NULL,
                    start_time INTEGER NOT NULL,
                    end_time INTEGER NOT NULL,
                    engine_id TEXT NOT NULL,
                    engine_version TEXT NOT NULL,
                    engine_variant TEXT NOT NULL,
                    engine_factory TEXT NOT NULL,
                    batch TEXT,
                    env TEXT,
                    runtime_conf TEXT,
                    data_source_params TEXT,
                    preparator_params TEXT,
                    algorithms_params TEXT,
                    serving_params TEXT,
                    PRIMARY KEY (ns, id)
                );
                CREATE TABLE IF NOT EXISTS engine_manifests (
                    ns TEXT NOT NULL,
                    id TEXT NOT NULL,
                    version TEXT NOT NULL,
                    name TEXT NOT NULL,
                    description TEXT,
                    files TEXT,
                    engine_factory TEXT NOT NULL,
                    PRIMARY KEY (ns, id, version)
                );
                CREATE TABLE IF NOT EXISTS evaluation_instances (
                    ns TEXT NOT NULL,
                    id TEXT NOT NULL,
                    status TEXT NOT NULL,
                    start_time INTEGER NOT NULL,
                    end_time INTEGER NOT NULL,
                    evaluation_class TEXT,
                    engine_params_generator_class TEXT,
                    batch TEXT,
                    env TEXT,
                    runtime_conf TEXT,
                    evaluator_results TEXT,
                    evaluator_results_html TEXT,
                    evaluator_results_json TEXT,
                    PRIMARY KEY (ns, id)
                );
                CREATE TABLE IF NOT EXISTS models (
                    ns TEXT NOT NULL,
                    id TEXT NOT NULL,
                    models BLOB NOT NULL,
                    PRIMARY KEY (ns, id)
                );
                """
            )

    def close(self) -> None:
        with self._lock:
            if self._memory_conn is not None:
                self._memory_conn.close()
                self._memory_conn = None
            for conn in self._all_conns:
                try:
                    conn.close()
                except Exception:
                    pass
            self._all_conns.clear()
            self._local = threading.local()


def _chan(channel_id: Optional[int]) -> int:
    return -1 if channel_id is None else channel_id


def _row_to_event(row: Sequence[Any]) -> Event:
    (eid, event, etype, entity_id, tetype, teid, props, etime, tags, pr_id,
     ctime) = row
    return Event(
        event=event,
        entity_type=etype,
        entity_id=entity_id,
        target_entity_type=tetype,
        target_entity_id=teid,
        properties=DataMap(json.loads(props) if props else {}),
        event_time=from_millis(etime),
        tags=tuple(json.loads(tags)) if tags else (),
        pr_id=pr_id,
        creation_time=from_millis(ctime),
        event_id=eid,
    )


_EVENT_COLS = (
    "id, event, entity_type, entity_id, target_entity_type, target_entity_id,"
    " properties, event_time, tags, pr_id, creation_time"
)


class _SQLiteDAO:
    def __init__(self, client: StorageClient, config: base.StorageClientConfig,
                 prefix: str = ""):
        self.client = client
        self.ns = prefix

    def _query(self, sql: str, params: Sequence[Any]) -> list:
        with self.client.lock:
            return self.client.conn.execute(sql, params).fetchall()

    def _query_one(self, sql: str, params: Sequence[Any]) -> Optional[Sequence[Any]]:
        with self.client.lock:
            return self.client.conn.execute(sql, params).fetchone()


class SQLiteEvents(_SQLiteDAO, base.Events):
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        return True  # single shared table, schema made at client init

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self.client.lock, self.client.conn as c:
            c.execute(
                "DELETE FROM events WHERE ns = ? AND app_id = ? AND channel_id = ?",
                (self.ns, app_id, _chan(channel_id)),
            )
        return True

    def close(self) -> None:
        pass

    def compact(self, app_id: int,
                channel_id: Optional[int] = None) -> dict:
        """``pio upgrade``'s sqlite leg: VACUUM reclaims the space DELETEd
        rows leave behind (the JDBC store has no other format debt).

        VACUUM rewrites the WHOLE database file, so it runs once per
        client lifetime (`pio upgrade` = one process = one VACUUM however
        many apps/channels it walks); later compact() calls of the same
        run only report their store's live-event count, with zero byte
        deltas."""
        import os

        path = self.client._path

        def size() -> int:
            return (os.path.getsize(path)
                    if path != ":memory:" and os.path.exists(path) else 0)

        with self.client.lock:
            conn = self.client.conn
            (n,) = conn.execute(
                "SELECT COUNT(*) FROM events WHERE ns = ? AND app_id = ? "
                "AND channel_id = ?",
                (self.ns, app_id, _chan(channel_id))).fetchone()
            if getattr(self.client, "_vacuumed", False):
                before = after = size()
            else:
                before = size()
                # VACUUM renumbers the implicit rowids of tables without
                # an INTEGER PRIMARY KEY and only *happens* to preserve
                # their relative order — but find()'s tie-break contract
                # rides on rowid order. Rebuild events in contract order
                # first so the fresh ascending rowids REENCODE that order
                # instead of depending on unspecified behavior. (An
                # out-of-band `sqlite3 db VACUUM` bypasses this rebuild —
                # run compaction through `pio upgrade`. Encoding the order
                # in a schema-level seq column would close that hole but
                # needs an ALTER TABLE migration for existing stores.)
                try:
                    conn.executescript(
                        "BEGIN;"
                        "CREATE TABLE events_compact AS SELECT * FROM"
                        " events ORDER BY event_time, rowid;"
                        "DELETE FROM events;"
                        "INSERT INTO events SELECT * FROM events_compact"
                        " ORDER BY rowid;"
                        "DROP TABLE events_compact;"
                        "COMMIT;")
                except Exception:
                    # a mid-script failure (disk full) leaves the open
                    # transaction holding the DELETE — roll it back or the
                    # next commit on this shared connection persists it
                    conn.rollback()
                    raise
                conn.execute("VACUUM")
                self.client._vacuumed = True
                after = size()
        return {"events": int(n), "bytes_before": before,
                "bytes_after": after}

    @staticmethod
    def _columns(ns: str, eid: str, app_id: int, chan: int, *, event: str,
                 entity_type: str, entity_id: str, target_entity_type,
                 target_entity_id, properties: str, time_ms: int, tz: str,
                 tags: str, pr_id, creation_ms: int) -> tuple:
        """One row of the events table, in the table's column order (the
        one place that order is written)."""
        return (ns, eid, app_id, chan, event, entity_type, entity_id,
                target_entity_type, target_entity_id, properties, time_ms,
                tz, tags, pr_id, creation_ms)

    @staticmethod
    def _row(ns: str, eid: str, app_id: int, channel_id, event: Event):
        return SQLiteEvents._columns(
            ns, eid, app_id, _chan(channel_id),
            event=event.event,
            entity_type=event.entity_type,
            entity_id=event.entity_id,
            target_entity_type=event.target_entity_type,
            target_entity_id=event.target_entity_id,
            properties=json.dumps(event.properties.to_jsonable()),
            time_ms=to_millis(event.event_time),
            tz=str(event.event_time.tzinfo or "UTC"),
            tags=json.dumps(list(event.tags)),
            pr_id=event.pr_id,
            creation_ms=to_millis(event.creation_time),
        )

    _INSERT_SQL = ("INSERT OR REPLACE INTO events VALUES "
                   "(?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)")

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        validate_event(event)
        eid = event.event_id or new_event_id()
        with self.client.lock, self.client.conn as c:
            c.execute(self._INSERT_SQL,
                      self._row(self.ns, eid, app_id, channel_id, event))
        return eid

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> list:
        """One executemany in ONE transaction — genuinely atomic (the
        generic base loop pays a transaction per event and compensates on
        failure; SQLite can simply roll the whole batch back). REPLACE
        keeps last-wins for duplicate explicit ids within the batch."""
        ids = []
        rows = []
        for event in events:
            validate_event(event)
            eid = event.event_id or new_event_id()
            ids.append(eid)
            rows.append(self._row(self.ns, eid, app_id, channel_id, event))
        with self.client.lock, self.client.conn as c:
            c.executemany(self._INSERT_SQL, rows)
        return ids

    def insert_interactions(
        self,
        inter: base.Interactions,
        app_id: int,
        channel_id: Optional[int] = None,
        entity_type: str = "user",
        target_entity_type: str = "item",
        event_name: str = "rate",
        value_prop: str = "rating",
        times: Optional[Any] = None,
    ) -> list:
        """Columnar insert that returns the stored event ids, in one
        transaction: the event server's batch fast path (the native body
        parse and the doc-level gate), with no Event object between the
        wire and the table; the gates have validated the batch. The rows
        are :meth:`insert_batch`'s for the same events (``{value_prop:
        float}`` properties, no tags, no prId). Without ``times`` the
        events are stamped now + k ms, k the slot, so the store keeps the
        wire order.

        The JAX package's SQLite backend has no columnar insert (its
        native log has), so there a batch takes the generic per-event
        path. The stored events are the same but for the value's JSON
        form: a float here (``4.0``) where the generic path keeps the
        wire's literal (``4``); both read back equal."""
        import numpy as np

        n = len(inter)
        now = to_millis(datetime.now(timezone.utc))
        times_ms = (now + np.arange(n, dtype=np.int64) if times is None
                    else np.asarray(times, np.int64))
        user_ids, item_ids = inter.user_ids, inter.item_ids
        chan = _chan(channel_id)
        ids, rows = [], []
        for k in range(n):
            eid = new_event_id()
            ids.append(eid)
            rows.append(self._columns(
                self.ns, eid, app_id, chan, event=event_name,
                entity_type=entity_type,
                entity_id=user_ids[int(inter.user_idx[k])],
                target_entity_type=target_entity_type,
                target_entity_id=item_ids[int(inter.item_idx[k])],
                properties=json.dumps({value_prop: float(inter.values[k])}),
                time_ms=int(times_ms[k]), tz="UTC", tags="[]", pr_id=None,
                creation_ms=now))
        with self.client.lock, self.client.conn as c:
            c.executemany(self._INSERT_SQL, rows)
        return ids

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        row = self._query_one(
            f"SELECT {_EVENT_COLS} FROM events "
            "WHERE ns = ? AND id = ? AND app_id = ? AND channel_id = ?",
            (self.ns, event_id, app_id, _chan(channel_id)),
        )
        return _row_to_event(row) if row else None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        with self.client.lock, self.client.conn as c:
            cur = c.execute(
                "DELETE FROM events "
                "WHERE ns = ? AND id = ? AND app_id = ? AND channel_id = ?",
                (self.ns, event_id, app_id, _chan(channel_id)),
            )
            return cur.rowcount > 0

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        # Same predicate assembly as jdbc/JDBCLEvents.scala:118-165.
        where = ["ns = ?", "app_id = ?", "channel_id = ?"]
        params: list[Any] = [self.ns, app_id, _chan(channel_id)]
        if start_time is not None:
            where.append("event_time >= ?")
            params.append(to_millis(start_time))
        if until_time is not None:
            where.append("event_time < ?")
            params.append(to_millis(until_time))
        if entity_type is not None:
            where.append("entity_type = ?")
            params.append(entity_type)
        if entity_id is not None:
            where.append("entity_id = ?")
            params.append(entity_id)
        if event_names is not None:
            names = list(event_names)
            where.append(
                "event IN (%s)" % ",".join("?" * len(names)) if names else "0"
            )
            params.extend(names)
        if target_entity_type is not UNSET:
            if target_entity_type is None:
                where.append("target_entity_type IS NULL")
            else:
                where.append("target_entity_type = ?")
                params.append(target_entity_type)
        if target_entity_id is not UNSET:
            if target_entity_id is None:
                where.append("target_entity_id IS NULL")
            else:
                where.append("target_entity_id = ?")
                params.append(target_entity_id)
        # tie-break equal event times by rowid = insertion/upsert order
        # (INSERT OR REPLACE assigns a fresh rowid, so an upsert moves the
        # event to the end of its timestamp group — the cross-backend
        # contract shared with the native log and the memory backend);
        # reversed reverses ties too (DESC on both keys)
        order = "DESC" if reversed else "ASC"
        sql = (
            f"SELECT {_EVENT_COLS} FROM events WHERE " + " AND ".join(where)
            + f" ORDER BY event_time {order}, rowid {order}"
        )
        if limit is not None and limit >= 0:
            sql += " LIMIT ?"
            params.append(limit)
        rows = self._query(sql, params)
        return (_row_to_event(r) for r in rows)

    def scan_interactions(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        entity_type: str = "user",
        target_entity_type: str = "item",
        event_names: Sequence[str] = ("rate",),
        value_prop: Optional[str] = None,
        event_values: Optional[Dict[str, float]] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        default_value: float = 1.0,
        batch_rows: int = 500_000,
    ) -> base.Interactions:
        """Columnar scan resolved entirely in SQL — id interning via
        ``dense_rank`` windows and value extraction via ``json_extract``,
        so no :class:`Event` objects (and no Python JSON parsing) exist on
        the training path. Replaces the reference's partitioned
        ``JdbcRDD`` read (jdbc/JDBCPEvents.scala:64-88)."""
        import numpy as np

        fixed = dict(event_values or {})
        names = [str(n) for n in event_names]
        where = ["ns = ?", "app_id = ?", "channel_id = ?",
                 "entity_type = ?", "target_entity_type = ?",
                 "target_entity_id IS NOT NULL"]
        params: list[Any] = [self.ns, app_id, _chan(channel_id),
                             entity_type, target_entity_type]
        if names:
            where.append("event IN (%s)" % ",".join("?" * len(names)))
            params.extend(names)
        else:
            where.append("0")
        if start_time is not None:
            where.append("event_time >= ?")
            params.append(to_millis(start_time))
        if until_time is not None:
            where.append("event_time < ?")
            params.append(to_millis(until_time))

        # value: fixed per event name, else json_extract(value_prop), else
        # the default constant; rows whose value resolves NULL are skipped
        # (the generic scan's "rate event without a rating" rule)
        value_sql = "?"
        value_params: list[Any] = [default_value]
        if value_prop is not None:
            if '"' in value_prop or "\\" in value_prop:
                raise ValueError(
                    f"unsupported value_prop name: {value_prop!r}")
            # json_type guard: CAST('hi' AS REAL) would silently yield 0.0;
            # non-numeric properties must skip the row instead
            path = '\'$."%s"\'' % value_prop
            value_sql = (
                f"CASE WHEN json_type(properties, {path}) IN "
                "('integer','real') THEN "
                f"CAST(json_extract(properties, {path}) AS REAL) END"
            )
            value_params = []
        if fixed:
            cases = " ".join("WHEN ? THEN ?" for _ in fixed)
            value_sql = f"CASE event {cases} ELSE {value_sql} END"
            case_params: list[Any] = []
            for name, v in fixed.items():
                case_params.extend([name, float(v)])
            value_params = case_params + value_params

        cond = " AND ".join(where)
        # one inner row set shared by the COO stream and the id tables, so
        # the dense index space and the id tables always align (a row whose
        # value resolves NULL exists in neither). Materialized ONCE into a
        # temp table: the filter predicates and json_extract evaluate a
        # single time, then the COO stream and both id tables read the
        # materialized rows (previously three full passes).
        inner = (
            f"SELECT entity_id, target_entity_id, {value_sql} AS v,"
            # seq = base-table rowid: the (event_time, insertion/upsert
            # order) tie-break shared with find() and the native log
            f" event_time, rowid AS seq FROM events WHERE {cond}"
        )
        body_params = value_params + params
        u_chunks, i_chunks, v_chunks = [], [], []
        with self.client.lock:
            conn = self.client.conn
            conn.execute("DROP TABLE IF EXISTS temp.pio_scan")
            conn.execute(
                f"CREATE TEMP TABLE pio_scan AS SELECT * FROM ({inner})"
                " WHERE v IS NOT NULL", body_params)
            try:
                # first-seen (event-time, id) order for the id tables — the
                # cross-backend Interactions contract; dense ranks are keyed
                # on each entity's FIRST row in that order
                sql = (
                    "SELECT"
                    " dense_rank() OVER (ORDER BY u_ft, u_fid) - 1,"
                    " dense_rank() OVER (ORDER BY i_ft, i_fid) - 1,"
                    " v FROM ("
                    "SELECT v, event_time, seq,"
                    " FIRST_VALUE(event_time) OVER (PARTITION BY entity_id"
                    "   ORDER BY event_time, seq) AS u_ft,"
                    " FIRST_VALUE(seq) OVER (PARTITION BY entity_id"
                    "   ORDER BY event_time, seq) AS u_fid,"
                    " FIRST_VALUE(event_time) OVER"
                    "   (PARTITION BY target_entity_id"
                    "   ORDER BY event_time, seq) AS i_ft,"
                    " FIRST_VALUE(seq) OVER (PARTITION BY target_entity_id"
                    "   ORDER BY event_time, seq) AS i_fid"
                    " FROM temp.pio_scan)"
                    " ORDER BY event_time, seq"
                )
                cur = conn.execute(sql)
                while True:
                    rows = cur.fetchmany(batch_rows)
                    if not rows:
                        break
                    arr = np.array(rows, np.float64)
                    u_chunks.append(arr[:, 0].astype(np.int32))
                    i_chunks.append(arr[:, 1].astype(np.int32))
                    v_chunks.append(arr[:, 2].astype(np.float32))
                first_seen = (
                    "SELECT {col} FROM (SELECT {col}, event_time, seq,"
                    " ROW_NUMBER() OVER (PARTITION BY {col}"
                    "   ORDER BY event_time, seq) AS rn FROM temp.pio_scan)"
                    " WHERE rn = 1 ORDER BY event_time, seq"
                )
                user_ids = [r[0] for r in conn.execute(
                    first_seen.format(col="entity_id"))]
                item_ids = [r[0] for r in conn.execute(
                    first_seen.format(col="target_entity_id"))]
            finally:
                conn.execute("DROP TABLE IF EXISTS temp.pio_scan")
        empty = np.zeros(0, np.int32)
        return base.Interactions(
            user_idx=np.concatenate(u_chunks) if u_chunks else empty,
            item_idx=np.concatenate(i_chunks) if i_chunks else empty,
            values=(np.concatenate(v_chunks) if v_chunks
                    else np.zeros(0, np.float32)),
            user_ids=user_ids,
            item_ids=item_ids,
        )


class SQLiteApps(_SQLiteDAO, base.Apps):
    def insert(self, app: base.App) -> Optional[int]:
        with self.client.lock, self.client.conn as c:
            try:
                if app.id != 0:
                    app_id = app.id
                else:
                    row = c.execute(
                        "SELECT COALESCE(MAX(id), 0) + 1 FROM apps WHERE ns = ?",
                        (self.ns,),
                    ).fetchone()
                    app_id = row[0]
                c.execute(
                    "INSERT INTO apps (ns, id, name, description) VALUES (?,?,?,?)",
                    (self.ns, app_id, app.name, app.description),
                )
                return app_id
            except sqlite3.IntegrityError:
                return None

    def get(self, app_id: int) -> Optional[base.App]:
        row = self._query_one(
            "SELECT id, name, description FROM apps WHERE ns = ? AND id = ?",
            (self.ns, app_id),
        )
        return base.App(*row) if row else None

    def get_by_name(self, name: str) -> Optional[base.App]:
        row = self._query_one(
            "SELECT id, name, description FROM apps WHERE ns = ? AND name = ?",
            (self.ns, name),
        )
        return base.App(*row) if row else None

    def get_all(self) -> list[base.App]:
        rows = self._query(
            "SELECT id, name, description FROM apps WHERE ns = ?", (self.ns,)
        )
        return [base.App(*r) for r in rows]

    def update(self, app: base.App) -> bool:
        with self.client.lock, self.client.conn as c:
            cur = c.execute(
                "UPDATE apps SET name = ?, description = ? WHERE ns = ? AND id = ?",
                (app.name, app.description, self.ns, app.id),
            )
            return cur.rowcount > 0

    def delete(self, app_id: int) -> bool:
        with self.client.lock, self.client.conn as c:
            return c.execute(
                "DELETE FROM apps WHERE ns = ? AND id = ?", (self.ns, app_id)
            ).rowcount > 0


class SQLiteAccessKeys(_SQLiteDAO, base.AccessKeys):
    def insert(self, k: base.AccessKey) -> Optional[str]:
        key = k.key or base.generate_access_key()
        with self.client.lock, self.client.conn as c:
            try:
                c.execute(
                    "INSERT INTO access_keys (ns, key, app_id, events) "
                    "VALUES (?,?,?,?)",
                    (self.ns, key, k.appid, json.dumps(list(k.events))),
                )
                return key
            except sqlite3.IntegrityError:
                return None

    @staticmethod
    def _row(row: Sequence[Any]) -> base.AccessKey:
        return base.AccessKey(row[0], row[1], tuple(json.loads(row[2])))

    def get(self, key: str) -> Optional[base.AccessKey]:
        row = self._query_one(
            "SELECT key, app_id, events FROM access_keys "
            "WHERE ns = ? AND key = ?",
            (self.ns, key),
        )
        return self._row(row) if row else None

    def get_all(self) -> list[base.AccessKey]:
        rows = self._query(
            "SELECT key, app_id, events FROM access_keys WHERE ns = ?",
            (self.ns,),
        )
        return [self._row(r) for r in rows]

    def get_by_appid(self, appid: int) -> list[base.AccessKey]:
        rows = self._query(
            "SELECT key, app_id, events FROM access_keys "
            "WHERE ns = ? AND app_id = ?",
            (self.ns, appid),
        )
        return [self._row(r) for r in rows]

    def update(self, k: base.AccessKey) -> bool:
        with self.client.lock, self.client.conn as c:
            cur = c.execute(
                "UPDATE access_keys SET app_id = ?, events = ? "
                "WHERE ns = ? AND key = ?",
                (k.appid, json.dumps(list(k.events)), self.ns, k.key),
            )
            return cur.rowcount > 0

    def delete(self, key: str) -> bool:
        with self.client.lock, self.client.conn as c:
            return c.execute(
                "DELETE FROM access_keys WHERE ns = ? AND key = ?",
                (self.ns, key),
            ).rowcount > 0


class SQLiteChannels(_SQLiteDAO, base.Channels):
    def insert(self, channel: base.Channel) -> Optional[int]:
        with self.client.lock, self.client.conn as c:
            try:
                if channel.id != 0:
                    cid = channel.id
                else:
                    row = c.execute(
                        "SELECT COALESCE(MAX(id), 0) + 1 FROM channels "
                        "WHERE ns = ?",
                        (self.ns,),
                    ).fetchone()
                    cid = row[0]
                c.execute(
                    "INSERT INTO channels (ns, id, name, app_id) VALUES (?,?,?,?)",
                    (self.ns, cid, channel.name, channel.appid),
                )
                return cid
            except sqlite3.IntegrityError:
                return None

    def get(self, channel_id: int) -> Optional[base.Channel]:
        row = self._query_one(
            "SELECT id, name, app_id FROM channels WHERE ns = ? AND id = ?",
            (self.ns, channel_id),
        )
        return base.Channel(*row) if row else None

    def get_by_appid(self, appid: int) -> list[base.Channel]:
        rows = self._query(
            "SELECT id, name, app_id FROM channels WHERE ns = ? AND app_id = ?",
            (self.ns, appid),
        )
        return [base.Channel(*r) for r in rows]

    def delete(self, channel_id: int) -> bool:
        with self.client.lock, self.client.conn as c:
            return c.execute(
                "DELETE FROM channels WHERE ns = ? AND id = ?",
                (self.ns, channel_id),
            ).rowcount > 0


_EI_COLS = (
    "id, status, start_time, end_time, engine_id, engine_version,"
    " engine_variant, engine_factory, batch, env, runtime_conf,"
    " data_source_params, preparator_params, algorithms_params, serving_params"
)


def _row_to_engine_instance(row: Sequence[Any]) -> base.EngineInstance:
    return base.EngineInstance(
        id=row[0],
        status=row[1],
        start_time=from_millis(row[2]),
        end_time=from_millis(row[3]),
        engine_id=row[4],
        engine_version=row[5],
        engine_variant=row[6],
        engine_factory=row[7],
        batch=row[8] or "",
        env=json.loads(row[9]) if row[9] else {},
        runtime_conf=json.loads(row[10]) if row[10] else {},
        data_source_params=row[11] or "",
        preparator_params=row[12] or "",
        algorithms_params=row[13] or "",
        serving_params=row[14] or "",
    )


class SQLiteEngineInstances(_SQLiteDAO, base.EngineInstances):
    def insert(self, i: base.EngineInstance) -> str:
        iid = i.id or uuid.uuid4().hex
        if not i.id:
            i = dataclasses.replace(i, id=iid)
        with self.client.lock, self.client.conn as c:
            c.execute(
                "INSERT OR REPLACE INTO engine_instances VALUES "
                "(?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (
                    self.ns, i.id, i.status, to_millis(i.start_time),
                    to_millis(i.end_time), i.engine_id, i.engine_version,
                    i.engine_variant, i.engine_factory, i.batch,
                    json.dumps(i.env), json.dumps(i.runtime_conf),
                    i.data_source_params, i.preparator_params,
                    i.algorithms_params, i.serving_params,
                ),
            )
        return iid

    def get(self, instance_id: str) -> Optional[base.EngineInstance]:
        row = self._query_one(
            f"SELECT {_EI_COLS} FROM engine_instances WHERE ns = ? AND id = ?",
            (self.ns, instance_id),
        )
        return _row_to_engine_instance(row) if row else None

    def get_all(self) -> list[base.EngineInstance]:
        rows = self._query(
            f"SELECT {_EI_COLS} FROM engine_instances WHERE ns = ?", (self.ns,)
        )
        return [_row_to_engine_instance(r) for r in rows]

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[base.EngineInstance]:
        rows = self._query(
            f"SELECT {_EI_COLS} FROM engine_instances "
            "WHERE ns = ? AND status = 'COMPLETED'"
            " AND engine_id = ? AND engine_version = ? AND engine_variant = ?"
            " ORDER BY start_time DESC",
            (self.ns, engine_id, engine_version, engine_variant),
        )
        return [_row_to_engine_instance(r) for r in rows]

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[base.EngineInstance]:
        rows = self.get_completed(engine_id, engine_version, engine_variant)
        return rows[0] if rows else None

    def update(self, i: base.EngineInstance) -> bool:
        if self.get(i.id) is None:
            return False
        self.insert(i)
        return True

    def delete(self, instance_id: str) -> bool:
        with self.client.lock, self.client.conn as c:
            return c.execute(
                "DELETE FROM engine_instances WHERE ns = ? AND id = ?",
                (self.ns, instance_id),
            ).rowcount > 0


class SQLiteEngineManifests(_SQLiteDAO, base.EngineManifests):
    @staticmethod
    def _row(row: Sequence[Any]) -> base.EngineManifest:
        return base.EngineManifest(
            id=row[0], version=row[1], name=row[2],
            engine_factory=row[3], description=row[4],
            files=tuple(json.loads(row[5])) if row[5] else (),
        )

    _COLS = "id, version, name, engine_factory, description, files"

    def insert(self, m: base.EngineManifest) -> None:
        with self.client.lock, self.client.conn as c:
            c.execute(
                "INSERT OR REPLACE INTO engine_manifests "
                "(ns, id, version, name, description, files, engine_factory) "
                "VALUES (?,?,?,?,?,?,?)",
                (self.ns, m.id, m.version, m.name, m.description,
                 json.dumps(list(m.files)), m.engine_factory),
            )

    def get(self, manifest_id: str, version: str) -> Optional[base.EngineManifest]:
        row = self._query_one(
            f"SELECT {self._COLS} FROM engine_manifests "
            "WHERE ns = ? AND id = ? AND version = ?",
            (self.ns, manifest_id, version),
        )
        return self._row(row) if row else None

    def get_all(self) -> list[base.EngineManifest]:
        rows = self._query(
            f"SELECT {self._COLS} FROM engine_manifests WHERE ns = ?",
            (self.ns,),
        )
        return [self._row(r) for r in rows]

    def update(self, m: base.EngineManifest, upsert: bool = False) -> bool:
        if not upsert and self.get(m.id, m.version) is None:
            return False
        self.insert(m)
        return True

    def delete(self, manifest_id: str, version: str) -> bool:
        with self.client.lock, self.client.conn as c:
            return c.execute(
                "DELETE FROM engine_manifests "
                "WHERE ns = ? AND id = ? AND version = ?",
                (self.ns, manifest_id, version),
            ).rowcount > 0


_EVI_COLS = (
    "id, status, start_time, end_time, evaluation_class,"
    " engine_params_generator_class, batch, env, runtime_conf,"
    " evaluator_results, evaluator_results_html, evaluator_results_json"
)


def _row_to_evaluation_instance(row: Sequence[Any]) -> base.EvaluationInstance:
    return base.EvaluationInstance(
        id=row[0],
        status=row[1],
        start_time=from_millis(row[2]),
        end_time=from_millis(row[3]),
        evaluation_class=row[4] or "",
        engine_params_generator_class=row[5] or "",
        batch=row[6] or "",
        env=json.loads(row[7]) if row[7] else {},
        runtime_conf=json.loads(row[8]) if row[8] else {},
        evaluator_results=row[9] or "",
        evaluator_results_html=row[10] or "",
        evaluator_results_json=row[11] or "",
    )


class SQLiteEvaluationInstances(_SQLiteDAO, base.EvaluationInstances):
    def insert(self, i: base.EvaluationInstance) -> str:
        iid = i.id or uuid.uuid4().hex
        if not i.id:
            i = dataclasses.replace(i, id=iid)
        with self.client.lock, self.client.conn as c:
            c.execute(
                "INSERT OR REPLACE INTO evaluation_instances VALUES "
                "(?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (
                    self.ns, i.id, i.status, to_millis(i.start_time),
                    to_millis(i.end_time), i.evaluation_class,
                    i.engine_params_generator_class, i.batch,
                    json.dumps(i.env), json.dumps(i.runtime_conf),
                    i.evaluator_results, i.evaluator_results_html,
                    i.evaluator_results_json,
                ),
            )
        return iid

    def get(self, instance_id: str) -> Optional[base.EvaluationInstance]:
        row = self._query_one(
            f"SELECT {_EVI_COLS} FROM evaluation_instances "
            "WHERE ns = ? AND id = ?",
            (self.ns, instance_id),
        )
        return _row_to_evaluation_instance(row) if row else None

    def get_all(self) -> list[base.EvaluationInstance]:
        rows = self._query(
            f"SELECT {_EVI_COLS} FROM evaluation_instances WHERE ns = ?",
            (self.ns,),
        )
        return [_row_to_evaluation_instance(r) for r in rows]

    def get_completed(self) -> list[base.EvaluationInstance]:
        rows = self._query(
            f"SELECT {_EVI_COLS} FROM evaluation_instances "
            "WHERE ns = ? AND status = 'EVALCOMPLETED' ORDER BY start_time DESC",
            (self.ns,),
        )
        return [_row_to_evaluation_instance(r) for r in rows]

    def update(self, i: base.EvaluationInstance) -> bool:
        if self.get(i.id) is None:
            return False
        self.insert(i)
        return True

    def delete(self, instance_id: str) -> bool:
        with self.client.lock, self.client.conn as c:
            return c.execute(
                "DELETE FROM evaluation_instances WHERE ns = ? AND id = ?",
                (self.ns, instance_id),
            ).rowcount > 0


class SQLiteModels(_SQLiteDAO, base.Models):
    def insert(self, model: base.Model) -> None:
        with self.client.lock, self.client.conn as c:
            c.execute(
                "INSERT OR REPLACE INTO models (ns, id, models) VALUES (?,?,?)",
                (self.ns, model.id, model.models),
            )

    def get(self, model_id: str) -> Optional[base.Model]:
        row = self._query_one(
            "SELECT id, models FROM models WHERE ns = ? AND id = ?",
            (self.ns, model_id),
        )
        return base.Model(row[0], row[1]) if row else None

    def delete(self, model_id: str) -> None:
        with self.client.lock, self.client.conn as c:
            c.execute(
                "DELETE FROM models WHERE ns = ? AND id = ?",
                (self.ns, model_id),
            )


DATA_OBJECTS = {
    "Events": SQLiteEvents,
    "Apps": SQLiteApps,
    "AccessKeys": SQLiteAccessKeys,
    "Channels": SQLiteChannels,
    "EngineInstances": SQLiteEngineInstances,
    "EngineManifests": SQLiteEngineManifests,
    "EvaluationInstances": SQLiteEvaluationInstances,
    "Models": SQLiteModels,
}
