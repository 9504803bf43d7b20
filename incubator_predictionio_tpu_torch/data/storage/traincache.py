"""Training-projection cache — a materialized columnar view of one event log.

The port's own copy of incubator_predictionio_tpu/data/storage/traincache.py,
its import rewritten to this package; the file formats are the same, so a
projection or prep plan written by either package loads in the other.

The reference re-scans HBase region-by-region on every `pio train`
(data/.../storage/hbase/HBPEvents.scala:63-88); on a single host that
re-scan is the dominant cost of the user-visible train wall (the port's
SQLite ``read`` is most of a ``pio train``: PERF.md §5). This module's
answer: the columnar arrays the training read produces —
(user_idx, item_idx, value, time) COO plus the two interned id tables —
are persisted next to the log the moment they exist (at bulk-import time,
or after a full scan), so the next training read is a sequential load
instead of a 20M-record parse.

It is strictly a *cache* with LSM-style invalidation:

- validity is keyed on the log's raw entry count and dead-entry count
  (eventlog.cc pio_evlog_entry_count / pio_evlog_dead_count): any
  tombstone since the write invalidates it (conservative — deletes are
  rare); new appends leave it valid and become the *tail*,
- a scan served from the cache re-scans only the tail (the native scan's
  ``min_entry_idx``), remaps the tail's ids into the cached tables, and
  folds the merged result back into the cache,
- any shape the fold cannot prove equivalent to a fresh full scan
  (non-monotone event times, different filter spec, fixed-value queries)
  falls back to the full native scan — correctness never depends on the
  cache.

The cache serves only "stored-value" queries (single event name, the same
``value_prop`` it was built with): const-/default-valued scans include
records *lacking* the property, which the cache cannot enumerate.

File format: one JSON header line, then raw little-endian sections
(uidx i32[n] | iidx i32[n] | vals f32[n] | times i64[n] | user blob |
user offsets i64[U+1] | item blob | item offsets i64[I+1]), written to a
temp file and atomically renamed; a size mismatch or torn header simply
reads as "no cache".
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from incubator_predictionio_tpu_torch.data.storage.base import IdTable

_MAGIC = "pio-traincache"
_VERSION = 1

#: below this row count a full scan is cheap and the cache write is pure
#: overhead (every unit-test log would grow a sidecar file) — only logs at
#: training scale get the projection
MIN_NNZ = int(os.environ.get("PIO_TRAINCACHE_MIN_NNZ", str(1_000_000)))


@dataclasses.dataclass
class Spec:
    entity_type: str
    target_entity_type: str
    event_name: str
    value_prop: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "Spec":
        return Spec(**d)


@dataclasses.dataclass
class TrainCache:
    spec: Spec
    uidx: np.ndarray      # [n] int32 into user table
    iidx: np.ndarray      # [n] int32 into item table
    vals: np.ndarray      # [n] float32 (spec.value_prop values)
    times: np.ndarray     # [n] int64 ms, non-decreasing
    user_tab: IdTable
    item_tab: IdTable
    raw_count: int        # log entries covered (tail starts here)
    dead_count: int       # log dead entries at write time

    def __len__(self) -> int:
        return len(self.uidx)


def path_for(log_path: str | Path) -> Path:
    return Path(str(log_path) + ".traincache")


def load(path: Path) -> Optional[TrainCache]:
    """Parse + validate the cache file; None on any mismatch (never raises
    for a corrupt/torn file — that just means 'no cache')."""
    try:
        with open(path, "rb") as f:
            header_line = f.readline(1 << 16)
            hdr = json.loads(header_line)
            if hdr.get("magic") != _MAGIC or hdr.get("version") != _VERSION:
                return None
            n = int(hdr["n"])
            nu, ni = int(hdr["n_users"]), int(hdr["n_items"])
            ub, ib = int(hdr["ubytes"]), int(hdr["ibytes"])
            expect = (len(header_line) + n * (4 + 4 + 4 + 8)
                      + ub + (nu + 1) * 8 + ib + (ni + 1) * 8)
            if os.fstat(f.fileno()).st_size != expect:
                return None
            uidx = np.fromfile(f, np.int32, n)
            iidx = np.fromfile(f, np.int32, n)
            vals = np.fromfile(f, np.float32, n)
            times = np.fromfile(f, np.int64, n)
            ublob = f.read(ub)
            uoffs = np.fromfile(f, np.int64, nu + 1)
            iblob = f.read(ib)
            ioffs = np.fromfile(f, np.int64, ni + 1)
        return TrainCache(
            spec=Spec.from_json(hdr["spec"]),
            uidx=uidx, iidx=iidx, vals=vals, times=times,
            user_tab=IdTable(ublob, uoffs),
            item_tab=IdTable(iblob, ioffs),
            raw_count=int(hdr["raw_count"]),
            dead_count=int(hdr["dead_count"]),
        )
    except (OSError, ValueError, KeyError, TypeError):
        return None


class StagedWrite:
    """A cache file serialized to its temp name but not yet published.

    Splits :func:`write` so the O(cache) disk serialization can run
    WITHOUT the storage lock (at training scale the file is hundreds of
    MB — streaming it under the lock would stall every concurrent event
    write, the exact class the sharded-scan lock-narrowing removed),
    while the atomic rename — the only part that needs to serialize with
    other cache writers — runs under the lock after the caller has
    revalidated its snapshot. Exactly one of commit()/abort() must be
    called; abort() after commit() is a no-op."""

    __slots__ = ("_tmp", "_path")

    def __init__(self, tmp: Path, path: Path):
        self._tmp = tmp
        self._path = path

    def commit(self) -> None:
        os.replace(self._tmp, self._path)

    def abort(self) -> None:
        self._tmp.unlink(missing_ok=True)


#: staging temp names must be unique per CALL, not just per process:
#: serialization runs outside the storage lock, so two concurrent scans
#: seeding the same cache would otherwise truncate/interleave one
#: shared temp file (itertools.count() is atomic under the GIL)
_stage_seq = __import__("itertools").count()


def stage(path: Path, cache: TrainCache) -> StagedWrite:
    """Serialize ``cache`` to a call-unique temp file next to ``path``
    → :class:`StagedWrite` (publish with commit(), discard with
    abort())."""
    hdr = json.dumps({
        "magic": _MAGIC, "version": _VERSION,
        "spec": cache.spec.to_json(),
        "n": len(cache.uidx),
        "n_users": len(cache.user_tab), "n_items": len(cache.item_tab),
        "ubytes": len(cache.user_tab.blob),
        "ibytes": len(cache.item_tab.blob),
        "raw_count": cache.raw_count, "dead_count": cache.dead_count,
    }).encode() + b"\n"
    tmp = path.with_suffix(
        path.suffix + f".tmp{os.getpid()}.{next(_stage_seq)}")
    try:
        with open(tmp, "wb") as f:
            f.write(hdr)
            np.ascontiguousarray(cache.uidx, np.int32).tofile(f)
            np.ascontiguousarray(cache.iidx, np.int32).tofile(f)
            np.ascontiguousarray(cache.vals, np.float32).tofile(f)
            np.ascontiguousarray(cache.times, np.int64).tofile(f)
            f.write(cache.user_tab.blob)
            np.ascontiguousarray(cache.user_tab.offsets, np.int64).tofile(f)
            f.write(cache.item_tab.blob)
            np.ascontiguousarray(cache.item_tab.offsets, np.int64).tofile(f)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    return StagedWrite(tmp, path)


def write(path: Path, cache: TrainCache) -> None:
    stage(path, cache).commit()


def invalidate(log_path: str | Path) -> None:
    path_for(log_path).unlink(missing_ok=True)
    plan_path_for(log_path).unlink(missing_ok=True)


# ---------------------------------------------------------------------------
# prep-plan sidecar: the per-side degree histograms, persisted alongside
# the projection and keyed on the SAME (raw_count, dead_count, spec)
# snapshot. A matching plan lets the next training prep skip the native
# degree/plan pass entirely (ops/sparse.build_padded_rows ``degrees``) and
# is maintained O(delta) at fold time (add the tail's bincount); any key
# mismatch just means "no plan" — prep recomputes, correctness never
# depends on it.
# ---------------------------------------------------------------------------

_PLAN_MAGIC = "pio-prepplan"
_PLAN_VERSION = 1


def plan_path_for(log_path: str | Path) -> Path:
    return Path(str(log_path) + ".prepplan")


def save_plan(path: Path, spec: Spec, raw_count: int, dead_count: int,
              user_degrees: np.ndarray, item_degrees: np.ndarray) -> None:
    """Atomically publish the degree histograms for one cache snapshot."""
    hdr = json.dumps({
        "magic": _PLAN_MAGIC, "version": _PLAN_VERSION,
        "spec": spec.to_json(),
        "raw_count": int(raw_count), "dead_count": int(dead_count),
        "n_users": int(len(user_degrees)),
        "n_items": int(len(item_degrees)),
    }).encode() + b"\n"
    tmp = path.with_suffix(
        path.suffix + f".tmp{os.getpid()}.{next(_stage_seq)}")
    try:
        with open(tmp, "wb") as f:
            f.write(hdr)
            np.ascontiguousarray(user_degrees, np.int64).tofile(f)
            np.ascontiguousarray(item_degrees, np.int64).tofile(f)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, path)


def load_plan(path: Path, spec: Spec, raw_count: int,
              dead_count: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """→ (user_degrees, item_degrees) when the plan matches the exact
    (spec, raw_count, dead_count) snapshot; None on any mismatch or a
    torn/corrupt file (which just reads as 'no plan')."""
    try:
        with open(path, "rb") as f:
            hdr = json.loads(f.readline(1 << 16))
            if (hdr.get("magic") != _PLAN_MAGIC
                    or hdr.get("version") != _PLAN_VERSION
                    or Spec.from_json(hdr["spec"]) != spec
                    or int(hdr["raw_count"]) != raw_count
                    or int(hdr["dead_count"]) != dead_count):
                return None
            nu, ni = int(hdr["n_users"]), int(hdr["n_items"])
            ud = np.fromfile(f, np.int64, nu)
            id_ = np.fromfile(f, np.int64, ni)
            if len(ud) != nu or len(id_) != ni:
                return None
        return ud, id_
    except (OSError, ValueError, KeyError, TypeError):
        return None


# ---------------------------------------------------------------------------
# id-table algebra (host-side numpy)
# ---------------------------------------------------------------------------

def table_bytes(tab: IdTable) -> list[bytes]:
    blob, offs = tab.blob, tab.offsets
    return [bytes(blob[offs[i]:offs[i + 1]]) for i in range(len(tab))]


def _build_table(ids: list[bytes]) -> IdTable:
    offs = np.zeros(len(ids) + 1, np.int64)
    if ids:
        np.cumsum([len(b) for b in ids], out=offs[1:])
    return IdTable(b"".join(ids), offs)


def merge_tables(base: IdTable, new: IdTable) -> Tuple[IdTable, np.ndarray]:
    """Append ``new``'s unseen ids to ``base`` → (merged, remap) where
    ``remap[j]`` is the merged index of ``new``'s id j."""
    base_ids = table_bytes(base)
    index = {b: i for i, b in enumerate(base_ids)}
    remap = np.empty(len(new), np.int32)
    added: list[bytes] = []
    for j, b in enumerate(table_bytes(new)):
        k = index.get(b)
        if k is None:
            k = len(base_ids) + len(added)
            index[b] = k
            added.append(b)
        remap[j] = k
    if not added:
        return base, remap
    offs = np.empty(len(base) + len(added) + 1, np.int64)
    offs[:len(base) + 1] = base.offsets
    np.cumsum([len(b) for b in added], out=offs[len(base) + 1:])
    offs[len(base) + 1:] += base.offsets[-1]
    return IdTable(bytes(base.blob) + b"".join(added), offs), remap


class TableMerger:
    """Incrementally merge per-shard id tables into one global table.

    The sharded scan (cpplog.py) interns ids per shard; merging the shard
    tables in shard order — appending each shard's unseen ids in its own
    first-seen order — reproduces exactly the table a sequential scan of
    the concatenated row sequence would intern. Unlike repeated
    :func:`merge_tables` calls, the lookup dict persists across shards,
    so an S-shard merge is O(total ids), not O(S × total ids)."""

    __slots__ = ("_index", "_ids")

    def __init__(self) -> None:
        self._index: dict = {}
        self._ids: list = []

    def add(self, tab: IdTable) -> np.ndarray:
        """Merge one shard table; returns ``remap`` with ``remap[j]`` the
        global index of the shard's id j."""
        remap = np.empty(len(tab), np.int32)
        index, ids = self._index, self._ids
        for j, b in enumerate(table_bytes(tab)):
            k = index.get(b)
            if k is None:
                k = len(ids)
                index[b] = k
                ids.append(b)
            remap[j] = k
        return remap

    def __len__(self) -> int:
        return len(self._ids)

    def table(self) -> IdTable:
        return _build_table(self._ids)


def first_seen_reindex(
    idx: np.ndarray, tab: IdTable
) -> Tuple[np.ndarray, IdTable]:
    """Re-intern ``idx`` in first-occurrence order, dropping unreferenced
    table entries — reproduces exactly the id table a fresh native scan
    of the same row sequence would build."""
    if len(idx) == 0:
        return idx.astype(np.int32), _build_table([])
    uniq, first = np.unique(idx, return_index=True)
    order = np.argsort(first, kind="stable")
    ids_in_order = uniq[order]
    remap = np.full(len(tab), -1, np.int32)
    remap[ids_in_order] = np.arange(len(ids_in_order), dtype=np.int32)
    all_ids = table_bytes(tab)
    return remap[idx], _build_table([all_ids[i] for i in ids_in_order])
