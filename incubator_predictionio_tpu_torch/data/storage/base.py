"""Storage SPI: metadata records and DAO contracts.

The port's own copy of incubator_predictionio_tpu/data/storage/base.py, its
imports rewritten to this package. One difference: the native batch-body
parse (:func:`uniform_interactions_from_body`) raises where the native
library cannot be built, where the JAX package's returns None and its
caller takes ``json.loads``.

Parity with the reference's storage traits:

- ``Events``            ⇄ ``LEvents`` (data/.../storage/LEvents.scala:40-492).
  The reference also has ``PEvents`` returning Spark RDDs
  (PEvents.scala:38-189); on TPU there is no executor fan-out to feed, so the
  parallel path is the same DAO streamed into device-sharded arrays by
  ``parallel.ingest`` — the L/P split collapses by design.
- ``Apps`` / ``AccessKeys`` / ``Channels`` / ``EngineInstances`` /
  ``EvaluationInstances`` / ``Models`` ⇄ the metadata DAO traits of the same
  names (data/.../storage/{Apps,AccessKeys,Channels,EngineInstances,
  EvaluationInstances,Models}.scala).

All DAOs are synchronous; the servers wrap them in thread executors (the
reference's ``future*`` methods serve the same purpose over JVM futures).
"""

from __future__ import annotations

import abc
import dataclasses
import logging
import re
import secrets
import threading
from datetime import datetime
from typing import Any, Dict, Iterator, Optional, Sequence

from incubator_predictionio_tpu_torch.data.datamap import DataMap, PropertyMap
from incubator_predictionio_tpu_torch.data.event import Event

logger = logging.getLogger(__name__)

#: Sentinel distinguishing "no filter" from "filter for absent" on target
#: entity queries (the reference encodes this as Option[Option[String]],
#: LEvents.scala:167-182).
UNSET: Any = type("_Unset", (), {"__repr__": lambda s: "UNSET"})()


class StorageError(Exception):
    """Storage.scala:55 StorageException. Lives here (not the package
    ``__init__``) so backend modules that import ``base`` can raise it —
    the package re-exports it for external callers."""


# ---------------------------------------------------------------------------
# Metadata records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class App:
    """Apps.scala:32 — an app has a unique integer ID and unique name."""
    id: int
    name: str
    description: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class AccessKey:
    """AccessKeys.scala:35 — ``events`` is the allowlist; empty = all."""
    key: str
    appid: int
    events: tuple[str, ...] = ()


CHANNEL_NAME_RE = re.compile(r"^[a-zA-Z0-9-]{1,16}$")
CHANNEL_NAME_CONSTRAINT = (
    "Only alphanumeric and - characters are allowed and max length is 16."
)


def is_valid_channel_name(name: str) -> bool:
    """Channels.scala:54-57."""
    return bool(CHANNEL_NAME_RE.match(name))


@dataclasses.dataclass(frozen=True)
class Channel:
    """Channels.scala:32 — name unique within an app."""
    id: int
    name: str
    appid: int

    def __post_init__(self) -> None:
        if not is_valid_channel_name(self.name):
            raise ValueError(
                f"Invalid channel name: {self.name}. {CHANNEL_NAME_CONSTRAINT}"
            )


@dataclasses.dataclass(frozen=True)
class EngineInstance:
    """EngineInstances.scala:46 — one training run of an engine.

    ``env``/``runtime_conf`` replace the reference's ``env``/``sparkConf``
    (there is no Spark; runtime_conf carries mesh/XLA settings instead).
    """
    id: str
    status: str
    start_time: datetime
    end_time: datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    runtime_conf: Dict[str, str] = dataclasses.field(default_factory=dict)
    data_source_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""


@dataclasses.dataclass(frozen=True)
class EvaluationInstance:
    """EvaluationInstances.scala:42 — one evaluation (tuning) run."""
    id: str
    status: str
    start_time: datetime
    end_time: datetime
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    runtime_conf: Dict[str, str] = dataclasses.field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


@dataclasses.dataclass(frozen=True)
class EngineManifest:
    """EngineManifests.scala:36-42 — discover engines by ID and version.

    The reference's ``files`` lists built JAR paths; here they are the
    engine's variant/module files (there is no build artifact to register,
    the factory path is importable directly).
    """
    id: str
    version: str
    name: str
    engine_factory: str
    description: Optional[str] = None
    files: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Model:
    """Models.scala:33 — a serialized model blob keyed by engine instance."""
    id: str
    models: bytes


# ---------------------------------------------------------------------------
# Event DAO
# ---------------------------------------------------------------------------

class IdTable:
    """Arrow-style string table: one utf-8 byte blob + int64 offsets.

    The zero-copy form of a distinct-id list: entry ``i`` is
    ``blob[offsets[i]:offsets[i+1]]`` decoded as utf-8. The native scan
    (eventlog.cc pio_scan_copy_ids) returns exactly this layout, and keeping
    it avoids materializing one Python string per entity on the training
    path — at the native log's ambitions (hundreds of millions of entities)
    per-id ``str`` objects would become the bottleneck. Strings materialize
    lazily at serving-translation time (indexing / iteration).

    Behaves as a read-only sequence of ``str`` so code written against the
    plain-``list`` form of :class:`Interactions` works unchanged.
    """

    __slots__ = ("blob", "offsets", "_lookup")

    def __init__(self, blob: bytes, offsets: "Any"):
        import numpy as np

        self.blob = blob
        self.offsets = np.asarray(offsets, np.int64)
        self._lookup: Optional[Dict[str, int]] = None

    def __len__(self) -> int:
        return max(len(self.offsets) - 1, 0)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self.blob[self.offsets[i]:self.offsets[i + 1]].decode("utf-8")

    def __iter__(self):
        offs = self.offsets
        blob = self.blob
        for i in range(len(self)):
            yield blob[offs[i]:offs[i + 1]].decode("utf-8")

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, (list, tuple, IdTable)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other))
        return NotImplemented

    def __repr__(self) -> str:
        return f"IdTable(n={len(self)}, bytes={len(self.blob)})"

    def index(self, value: str) -> int:
        """Id → dense index (builds a hash lookup on first use)."""
        if self._lookup is None:
            self._lookup = {s: i for i, s in enumerate(self)}
        return self._lookup[value]

    def __contains__(self, value: str) -> bool:
        if self._lookup is None:
            self._lookup = {s: i for i, s in enumerate(self)}
        return value in self._lookup

    def tolist(self) -> list:
        return list(self)

    @classmethod
    def from_list(cls, ids: Sequence[str]) -> "IdTable":
        import numpy as np

        parts = [s.encode("utf-8") for s in ids]
        offs = np.zeros(len(parts) + 1, np.int64)
        if parts:
            np.cumsum([len(p) for p in parts], out=offs[1:])
        return cls(b"".join(parts), offs)


@dataclasses.dataclass
class Interactions:
    """Columnar, pre-indexed (entity, target, value) triples — the training
    ingest format.

    This is the TPU-native replacement for the reference's parallel event
    read (``PEvents.find`` → ``RDD[Event]`` via ``newAPIHadoopRDD``,
    hbase/HBPEvents.scala:63-88): instead of materializing per-event
    objects, backends stream straight into dense int32 COO arrays plus the
    distinct-id tables, ready for ``jax.device_put`` after bucketing.
    ``user_ids[user_idx[k]]`` recovers the original entity id of triple k.

    The id tables are sequences of ``str`` in first-seen (event-time) order —
    either plain lists or zero-copy :class:`IdTable` views (the native
    backend returns the latter; both support len/indexing/iteration).
    """

    user_idx: "Any"     # np.ndarray int32 [nnz] — index into user_ids
    item_idx: "Any"     # np.ndarray int32 [nnz] — index into item_ids
    values: "Any"       # np.ndarray float32 [nnz]
    user_ids: "Any"     # distinct entity ids (list | IdTable), first-seen order
    item_ids: "Any"     # distinct target entity ids (list | IdTable)

    def __len__(self) -> int:
        return int(self.user_idx.shape[0])


def uniform_interactions(events: Sequence[Event]):
    """Events → ``(Interactions, etype, tetype, name, vprop, times_ms)``
    when the whole batch can take the columnar import with observable
    equivalence to per-event inserts, else ``None``.

    THE single fast-path gate — both the CLI bulk import
    (cli/commands.py) and the cpplog REST batch route call this, so the
    equivalence conditions can never drift apart again (a missing UTC
    screen in one copy once silently dropped timezones on read-back).

    Equivalence requires: no explicit event ids (both paths would
    generate them), no tags/prId, a target on every event, one shared
    numeric property key whose values are float32-exact (the columnar
    store is f32; 4.1 would read back 4.0999999), UTC event times
    (compact records store epoch millis and re-render as UTC strings),
    identical event/entity/target types throughout, and a non-reserved
    event name. Callers owe their own screens for anything invisible on
    a parsed Event (the CLI screens raw docs for explicit creationTime).

    Accepted batches are FULLY VALID per ``validate_event`` without the
    caller re-validating each event (the REST hot path depends on this —
    per-event re-validation was a third of insert_batch's cost): the
    uniformity requirement makes every name/type/property-key rule a
    batch-level check against ``first`` (validated once, below), and the
    per-event rules that remain — non-empty entity ids, a target on
    every event — are enforced inside the loop. Batches that fail any
    screen return None and take the generic per-event path, which
    validates in full."""
    import datetime as _dt

    import numpy as np

    from incubator_predictionio_tpu_torch.data.event import (
        BUILTIN_ENTITY_TYPES,
        BUILTIN_PROPERTIES,
        is_reserved_prefix,
    )
    from incubator_predictionio_tpu_torch.utils.times import to_millis

    if not events:
        return None
    first = events[0]
    name, etype, tetype = first.event, first.entity_type, \
        first.target_entity_type
    if not name or name.startswith("$") or not tetype or not etype:
        return None
    # batch-level validity (identical on every event by the uniformity
    # screen): reserved-prefix rules from validate_event — including
    # the event NAME ('pio_rate' is invalid, not merely non-special)
    if (is_reserved_prefix(name)
            or (is_reserved_prefix(etype)
                and etype not in BUILTIN_ENTITY_TYPES)
            or (is_reserved_prefix(tetype)
                and tetype not in BUILTIN_ENTITY_TYPES)):
        return None
    keys = list(first.properties)
    if len(keys) != 1:
        return None
    vprop = keys[0]
    if is_reserved_prefix(vprop) and vprop not in BUILTIN_PROPERTIES:
        return None
    n = len(events)
    users: list = []
    items: list = []
    uidx = np.empty(n, np.int32)
    iidx = np.empty(n, np.int32)
    vals = np.empty(n, np.float32)
    times = np.empty(n, np.int64)
    u_intern: dict = {}
    i_intern: dict = {}
    for k, e in enumerate(events):
        if (e.event != name or e.entity_type != etype
                or e.target_entity_type != tetype
                or not e.entity_id
                or not e.target_entity_id or e.event_id or e.tags
                or e.pr_id or list(e.properties) != keys):
            return None
        v = e.properties.opt(vprop)  # .get raises on an explicit null
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        if float(np.float32(v)) != float(v):
            return None  # not f32-exact: the columnar store would alter it
        if e.event_time.utcoffset() != _dt.timedelta(0):
            return None  # non-UTC offset: re-rendered strings would differ
        u = u_intern.setdefault(e.entity_id, len(u_intern))
        if u == len(users):
            users.append(e.entity_id)
        it = i_intern.setdefault(e.target_entity_id, len(i_intern))
        if it == len(items):
            items.append(e.target_entity_id)
        uidx[k], iidx[k], vals[k] = u, it, v
        times[k] = to_millis(e.event_time)
    inter = Interactions(
        user_idx=uidx, item_idx=iidx, values=vals,
        user_ids=IdTable.from_list(users),
        item_ids=IdTable.from_list(items))
    return inter, etype, tetype, name, vprop, times


def uniform_interactions_from_docs(docs):
    """RAW JSON docs → the same ``(Interactions, etype, tetype, name,
    vprop, times_ms)`` bundle as :func:`uniform_interactions`, or None.

    The REST batch hot path: for the uniform shape, constructing 50
    ``Event`` objects (+ full validation each) costs more than the
    storage write itself — this gate reads the dicts directly and
    guarantees the SAME acceptance set as parsing each doc into an Event
    and running the Event-level gate (pinned by a differential test in
    tests/test_event_server.py). Screens beyond the Event-level gate,
    because a raw doc can carry what a parsed Event cannot show:
    unknown keys reject the batch, and an explicit ``creationTime``
    rejects it (the columnar renderer would rewrite it).

    ``times_ms`` is None when every doc omits ``eventTime`` — the caller
    assigns server-receive time, matching the Event path's parse-time
    default."""
    import datetime as _dt

    import numpy as np

    from incubator_predictionio_tpu_torch.data.event import (
        BUILTIN_ENTITY_TYPES,
        BUILTIN_PROPERTIES,
        is_reserved_prefix,
    )
    from incubator_predictionio_tpu_torch.utils.times import (
        parse_iso8601,
        to_millis,
    )

    if not docs:
        return None
    first = docs[0]
    if not isinstance(first, dict):
        return None
    name = first.get("event")
    etype = first.get("entityType")
    tetype = first.get("targetEntityType")
    if (not name or not isinstance(name, str) or name.startswith("$")
            or not etype or not isinstance(etype, str)
            or not tetype or not isinstance(tetype, str)):
        return None
    if (is_reserved_prefix(name)
            or (is_reserved_prefix(etype)
                and etype not in BUILTIN_ENTITY_TYPES)
            or (is_reserved_prefix(tetype)
                and tetype not in BUILTIN_ENTITY_TYPES)):
        return None
    props = first.get("properties")
    if not isinstance(props, dict) or len(props) != 1:
        return None
    vprop = next(iter(props))
    if is_reserved_prefix(vprop) and vprop not in BUILTIN_PROPERTIES:
        return None
    allowed_keys = {"event", "entityType", "entityId", "targetEntityType",
                    "targetEntityId", "properties", "eventTime"}
    n = len(docs)
    utc = _dt.timezone.utc
    # bulk screens via comprehensions — each pass is ~2× a manual loop in
    # CPython, and the whole gate runs on the GIL-bound ingest hot path.
    # The acceptance set is IDENTICAL to the per-doc loop this replaces
    # (pinned by the differential test in tests/test_event_server.py).
    if not all(isinstance(d, dict) and allowed_keys.issuperset(d)
               and d.get("event") == name and d.get("entityType") == etype
               and d.get("targetEntityType") == tetype for d in docs):
        return None
    try:
        users_l = [d["entityId"] for d in docs]
        items_l = [d["targetEntityId"] for d in docs]
        raw_vals = [d["properties"][vprop] for d in docs]
    except (KeyError, TypeError, IndexError):
        return None
    if not all(isinstance(u, str) and u for u in users_l):
        return None
    if not all(isinstance(t, str) and t for t in items_l):
        return None
    if not all(isinstance(d["properties"], dict) and len(d["properties"]) == 1
               for d in docs):
        return None
    if not all(isinstance(v, (int, float)) and not isinstance(v, bool)
               for v in raw_vals):
        return None
    vals64 = np.asarray(raw_vals, np.float64)
    vals = vals64.astype(np.float32)
    if not np.array_equal(vals.astype(np.float64), vals64):
        return None  # a value is not exactly f32-representable
    times: Optional[Any] = None
    if any(d.get("eventTime") is not None for d in docs):
        # explicit times are the rare wire shape — keep the original
        # per-slot loop (with its backfill semantics) for just this case
        times = np.empty(n, np.int64)
        first_explicit = True
        for k, d in enumerate(docs):
            ts = d.get("eventTime")
            if ts is not None:
                if not isinstance(ts, str):
                    return None
                try:
                    t = parse_iso8601(ts)
                except ValueError:
                    return None
                if t.utcoffset() != _dt.timedelta(0):
                    return None
                if first_explicit:
                    first_explicit = False
                    if k:  # backfill earlier implicit slots
                        now0 = to_millis(_dt.datetime.now(utc))
                        times[:k] = now0 + np.arange(k)
                times[k] = to_millis(t)
            elif not first_explicit:
                times[k] = to_millis(_dt.datetime.now(utc))
    u_intern: dict = {}
    i_intern: dict = {}
    uidx_l = [u_intern.setdefault(u, len(u_intern)) for u in users_l]
    iidx_l = [i_intern.setdefault(t, len(i_intern)) for t in items_l]
    inter = Interactions(
        user_idx=np.array(uidx_l, np.int32),
        item_idx=np.array(iidx_l, np.int32), values=vals,
        user_ids=IdTable.from_list(list(u_intern)),
        item_ids=IdTable.from_list(list(i_intern)))
    return inter, etype, tetype, name, vprop, times


#: per-thread scratch buffers of the native body parser
_BODY_PARSE_TLS = threading.local()
#: jsonparse.cc ``kMaxField``: the longest id or name it accepts, in bytes
_BODY_MAX_FIELD = 200


def uniform_interactions_from_body(body: bytes, max_n: int):
    """RAW request bytes → the ``(Interactions, etype, tetype, name,
    vprop, times_ms)`` bundle through the NATIVE strict-subset parser
    (``native/src/jsonparse.cc``, run with the GIL released), or None when
    the parser declines the body (string escapes, ``eventTime``, reserved
    prefixes, oversized fields, more than ``max_n`` docs…). A declined
    body takes ``json.loads`` and :func:`uniform_interactions_from_docs`,
    which own the full semantics: the native acceptance set is a strict
    subset of theirs with identical output (pinned by the randomized
    differential in tests/test_torch_event_server.py). ``times_ms`` is
    always None here (an explicit ``eventTime`` is declined).

    Counterpart of the JAX package's function of the same name, except
    that a native library that cannot be built raises
    (``native.load``): it is never a silent ``json.loads`` route."""
    import ctypes

    import numpy as np

    from incubator_predictionio_tpu_torch import native

    lib = native.load()
    if max_n <= 0:
        return None
    cap = _BODY_MAX_FIELD
    # thread-local scratch (the parser runs on pool threads): ~100 KB of
    # buffers per call would otherwise dominate the wrapper's own cost
    tl = _BODY_PARSE_TLS
    bufs = getattr(tl, "bufs", None)
    if bufs is None or bufs[0] < max_n:
        bufs = (
            max_n,
            np.empty(max_n, np.int32), np.empty(max_n, np.int32),
            np.empty(max_n, np.float32),
            np.empty(max_n + 1, np.int64), np.empty(max_n + 1, np.int64),
            ctypes.create_string_buffer(max_n * cap),
            ctypes.create_string_buffer(max_n * cap),
            ctypes.create_string_buffer(4 * cap),
            (ctypes.c_int64 * 4)(),
        )
        tl.bufs = bufs
    (cap_n, uidx, iidx, vals, uoffs, ioffs, ublob, iblob, scalars,
     scalar_lens) = bufs
    n_users = ctypes.c_int64()
    n_items = ctypes.c_int64()
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = lib.pio_parse_uniform_batch(
        body, len(body), max_n,
        uidx.ctypes.data_as(i32p), iidx.ctypes.data_as(i32p),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ublob, cap_n * cap, uoffs.ctypes.data_as(i64p),
        ctypes.byref(n_users),
        iblob, cap_n * cap, ioffs.ctypes.data_as(i64p),
        ctypes.byref(n_items),
        scalars, 4 * cap, scalar_lens,
    )
    if n < 1:
        return None
    nu, ni = n_users.value, n_items.value
    # string_at copies only the used prefix (``.raw`` would copy the
    # whole preallocated buffer per call)
    inter = Interactions(
        user_idx=uidx[:n].copy(), item_idx=iidx[:n].copy(),
        values=vals[:n].copy(),
        user_ids=IdTable(ctypes.string_at(ublob, int(uoffs[nu])),
                         uoffs[:nu + 1].copy()),
        item_ids=IdTable(ctypes.string_at(iblob, int(ioffs[ni])),
                         ioffs[:ni + 1].copy()))
    a, b, c, d = (int(v) for v in scalar_lens)
    s = ctypes.string_at(scalars, a + b + c + d)
    etype = s[:a].decode("utf-8")
    name = s[a:a + b].decode("utf-8")
    tetype = s[a + b:a + b + c].decode("utf-8")
    vprop = s[a + b + c:a + b + c + d].decode("utf-8")
    return inter, etype, tetype, name, vprop, None


class VectorCursor(tuple):
    """Multi-writer tail cursor: one ``(generation << TAIL_GEN_SHIFT) |
    count`` component per writer shard.

    Speed-layer subscribers (speed/overlay.py, speed/cache.py) treat the
    cursor as an opaque monotonic token, but they DO compare it against
    plain ints (``cursor < 0`` enablement checks, ``-1`` sentinels) and
    format it with ``%d`` — so this tuple subclass answers the scalar
    protocol with the TOTAL entry count (generation bits masked off):
    progress comparisons against ints keep working unchanged, while
    cursor-vs-cursor comparisons are component-wise, which is the only
    ordering that is meaningful across shards:

    - ``a < b`` (both vectors, same length): some shard of ``a`` is
      behind ``b`` — the "went backwards" reset trigger.
    - ``a <= b``: every shard of ``a`` is at or behind ``b`` — the
      "dirty-mark covered by solve cursor" check.
    - different lengths (shard-count change) compare unequal and never
      ``<=``/``>=`` — subscribers fall into their reset path.
    """

    __slots__ = ()

    _COUNT_MASK = (1 << 48) - 1

    def __int__(self) -> int:
        return sum(int(c) & self._COUNT_MASK for c in self)

    __index__ = __int__

    def total(self) -> int:
        return int(self)

    def _cmp(self, other, op, scalar_op):
        if isinstance(other, VectorCursor) or (
                isinstance(other, tuple) and not isinstance(other, str)):
            if len(self) != len(other):
                return False
            return op(self, other)
        if isinstance(other, (int, float)):
            return scalar_op(int(self), other)
        return NotImplemented

    def __lt__(self, other):
        # "some shard is behind" — deliberately NOT a total order: both
        # a < b and b < a hold for cursors that diverged across shards,
        # and either direction means the subscriber must resync
        return self._cmp(other,
                         lambda a, b: any(x < y for x, y in zip(a, b)),
                         lambda a, b: a < b)

    def __le__(self, other):
        return self._cmp(other,
                         lambda a, b: all(x <= y for x, y in zip(a, b)),
                         lambda a, b: a <= b)

    def __gt__(self, other):
        return self._cmp(other,
                         lambda a, b: any(x > y for x, y in zip(a, b)),
                         lambda a, b: a > b)

    def __ge__(self, other):
        return self._cmp(other,
                         lambda a, b: all(x >= y for x, y in zip(a, b)),
                         lambda a, b: a >= b)

    def __eq__(self, other):
        if isinstance(other, tuple):
            return tuple(self) == tuple(other)
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __hash__(self):
        return tuple.__hash__(self)

    def __repr__(self) -> str:
        return f"VectorCursor({tuple(int(c) for c in self)})"


class Events(abc.ABC):
    """Event CRUD + query DAO (LEvents.scala:40-492)."""

    #: True for in-process backends whose inserts are sub-millisecond
    #: (memory index, native append-only log). The EventServer runs its
    #: ingest hot routes inline on the event loop for these — the
    #: thread-pool round trip costs more than the insert — and keeps the
    #: executor for networked/fsync-bound backends.
    FAST_LOCAL = False

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Initialize the backing table/namespace for an app/channel."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Drop all events of an app/channel."""

    @abc.abstractmethod
    def close(self) -> None:
        """Release client connections."""

    @abc.abstractmethod
    def insert(
        self, event: Event, app_id: int, channel_id: Optional[int] = None
    ) -> str:
        """Insert one event, returning its event ID (LEvents.futureInsert)."""

    def insert_batch(
        self, events: Sequence[Event], app_id: int,
        channel_id: Optional[int] = None,
    ) -> list:
        """Bulk insert (PEvents.write:184 / the import tool's path).
        Backends override with a single-write fast path.

        Retry-safe: a mid-batch failure rolls back the AUTO-ID events
        already inserted (best effort), so callers that retry per event
        after a failed bulk write — the EventServer's batch route — can
        never duplicate them. Explicit-id events are NOT rolled back: an
        upsert destroyed the pre-image (deleting would lose data that
        predates the batch), and a per-event retry of the same id is an
        idempotent upsert anyway. The native log is fully atomic instead
        (framed batch + truncate-on-failure)."""
        done: list = []
        try:
            for e in events:
                done.append((self.insert(e, app_id, channel_id),
                             bool(e.event_id)))
        except Exception:
            for eid, explicit in done:
                if explicit:
                    continue  # idempotent under retry; pre-image is gone
                try:
                    self.delete(eid, app_id, channel_id)
                except Exception:  # pragma: no cover - best effort
                    # a failed rollback-delete leaves the auto-id event in
                    # the store, so a caller's per-event retry CAN
                    # duplicate it — log loud enough for an operator to
                    # reconcile (the EventServer batch route documents the
                    # same window)
                    logger.warning(
                        "rollback delete of auto-id event %s failed after "
                        "a mid-batch error; a per-event retry may "
                        "duplicate it", eid, exc_info=True)
            raise
        return [eid for eid, _ in done]

    @abc.abstractmethod
    def get(
        self, event_id: str, app_id: int, channel_id: Optional[int] = None
    ) -> Optional[Event]:
        """Get an event by ID (LEvents.futureGet)."""

    @abc.abstractmethod
    def delete(
        self, event_id: str, app_id: int, channel_id: Optional[int] = None
    ) -> bool:
        """Delete an event by ID (LEvents.futureDelete)."""

    @abc.abstractmethod
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
        """Query events (LEvents.futureFind:167-182).

        Results are ordered by event time ascending (descending when
        ``reversed``); ``limit=None`` or ``-1`` means no limit;
        ``target_entity_type=None`` (explicitly) matches only events *without*
        a target entity, while leaving it ``UNSET`` applies no filter.
        ``start_time`` is inclusive, ``until_time`` exclusive.

        ORDER CONTRACT (cross-backend, pinned by
        tests/test_storage_differential.py): equal event times tie-break
        by insertion order, and an explicit-id upsert MOVES the event to
        the end of its timestamp group (an upsert is a new write — the
        append-only log's natural semantics; memory and sqlite implement
        the same). ``reversed`` returns the exact reverse of the forward
        sequence, ties included. Aggregation replays in this order, so
        same-timestamp ``$set`` conflicts resolve identically on every
        backend.
        """

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: Optional[int] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> Dict[str, PropertyMap]:
        """Aggregate special events into entity state
        (LEvents.futureAggregateProperties:194-230). ``required`` keeps only
        entities that have ALL the named *properties* defined
        (LEvents.scala:190,211-214)."""
        from incubator_predictionio_tpu_torch.data.aggregator import (
            AGGREGATOR_EVENT_NAMES,
            aggregate_properties,
        )

        events = self.find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=AGGREGATOR_EVENT_NAMES,
        )
        result = aggregate_properties(events)
        if required is not None:
            result = {
                k: v for k, v in result.items()
                if all(prop in v for prop in required)
            }
        return result

    def scan_interactions(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        entity_type: str = "user",
        target_entity_type: str = "item",
        event_names: Sequence[str] = ("rate",),
        value_prop: Optional[str] = None,
        event_values: Optional[Dict[str, float]] = None,
        default_value: float = 1.0,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
    ) -> Interactions:
        """Columnar training-ingest scan (see :class:`Interactions`).

        Value resolution per event, in order: a fixed per-event-name value
        from ``event_values``; else the numeric property ``value_prop``
        (events *missing* it are skipped — DataSource.scala:66-72 drops
        rate events without a rating); else ``default_value``. Events
        without a target entity are skipped. Backends override this with
        scans that never materialize :class:`Event` objects; this generic
        implementation defines the semantics they must match.
        """
        import numpy as np

        fixed = event_values or {}
        users: Dict[str, int] = {}
        items: Dict[str, int] = {}
        uidx: list = []
        iidx: list = []
        vals: list = []
        for e in self.find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            target_entity_type=target_entity_type,
            event_names=list(event_names),
        ):
            if e.target_entity_id is None:
                continue
            if e.event in fixed:
                v = fixed[e.event]
            elif value_prop is not None:
                raw = e.properties.to_jsonable().get(value_prop)
                if not isinstance(raw, (int, float)) or isinstance(raw, bool):
                    continue   # missing or non-numeric → skipped
                v = float(raw)
            else:
                v = default_value
            u = users.setdefault(e.entity_id, len(users))
            i = items.setdefault(e.target_entity_id, len(items))
            uidx.append(u)
            iidx.append(i)
            vals.append(v)
        return Interactions(
            user_idx=np.asarray(uidx, np.int32),
            item_idx=np.asarray(iidx, np.int32),
            values=np.asarray(vals, np.float32),
            user_ids=list(users),
            item_ids=list(items),
        )

    # -- speed-layer tail cursor -------------------------------------------
    #
    # The Lambda-architecture speed leg (incubator_predictionio_tpu_torch/speed/)
    # polls the write tail of the event log to keep a per-user "dirty" set
    # between retrains. ``tail_cursor`` is a MONOTONIC position in the
    # backend's write order (append-only: entry count; in-memory: insert
    # counter) and ``read_interactions_since`` scans only [cursor, now) —
    # O(delta), never O(log). Backends without a cheap tail return -1 and
    # the speed layer stays disabled on them.

    #: generation shift for tail cursors: the high bits carry a
    #: process-local LOG GENERATION (bumped on compaction/drop — any
    #: rewrite that renumbers entries), the low bits the write position.
    #: A bare count comparison cannot detect "compacted, then appended
    #: past the old count before the next poll"; the generation can.
    TAIL_GEN_SHIFT = 48

    def tail_cursor(self, app_id: int,
                    channel_id: Optional[int] = None) -> int:
        """Current monotonic write cursor (generation ``<<
        TAIL_GEN_SHIFT`` | position), or -1 when the backend has no
        cheap tail-read support. Within one generation a later cursor
        covers every event a previous one did; a generation change means
        everything derived from old cursors is invalid."""
        return -1

    def read_interactions_since(
        self,
        cursor: int,
        app_id: int,
        channel_id: Optional[int] = None,
        entity_type: str = "user",
        target_entity_type: str = "item",
        event_names: Sequence[str] = ("rate",),
        value_prop: Optional[str] = None,
        event_values: Optional[Dict[str, float]] = None,
        default_value: float = 1.0,
    ):
        """Columnar scan of ONLY the events written since ``cursor`` →
        ``(Interactions, times_ms, append_ms, new_cursor, reset)``.
        Value-resolution semantics are identical to
        :meth:`scan_interactions`; rows arrive in write order.

        ``append_ms`` (int64 [nnz]) is the wall-clock epoch-millisecond
        stamp of when each row's event was APPENDED to the log — the
        anchor of the end-to-end freshness trace (obs/freshness.py),
        distinct from the event's logical ``eventTime`` (a backfill can
        carry last year's event times but fresh append stamps). Backends
        stamp it as precisely as they can, and always CONSERVATIVELY —
        a stamp may be early (age overstated) but never late (freshness
        is never fabricated): the in-memory backend records exact
        per-slot walls; the native log bounds each batch by its newest
        count observation at/below the cursor (exact when this process
        wrote the events; within one poll interval when another process
        did, since every tail read records what it saw). ``-1`` means
        the backend cannot bound the append wall (e.g. entries written
        before the subscriber's first look at the log) and the row is
        excluded from freshness tracing.

        ``reset=True`` (a cursor from a previous log generation —
        compaction/drop renumbered the entries) carries an EMPTY tail
        and a fresh cursor: the caller must drop everything it derived
        and resynchronize."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support tail reads")

    def import_interactions(
        self,
        inter: Interactions,
        app_id: int,
        channel_id: Optional[int] = None,
        entity_type: str = "user",
        target_entity_type: str = "item",
        event_name: str = "rate",
        value_prop: str = "rating",
        times: Optional["Any"] = None,
        base_time: Optional[datetime] = None,
        chunk: int = 20_000,
    ) -> int:
        """Columnar bulk ingest — the inverse of :func:`scan_interactions`.

        Writes one ``event_name`` event per triple with the value stored
        under ``value_prop``; event times come from ``times`` (epoch ms,
        int64 [nnz]) or default to ``base_time + k`` milliseconds so the
        write order is the scan order. This is the bulk-import path the
        reference routes through ``PEvents.write`` (PEvents.scala:184) /
        ``pio import``; backends override it with writers that never
        materialize per-event objects (the native log renders records fully
        in C++).
        """
        from datetime import timedelta

        from incubator_predictionio_tpu_torch.utils.times import now_utc

        n = len(inter)
        t0 = base_time if base_time is not None else now_utc()
        if times is None:
            get_time = lambda k: t0 + timedelta(milliseconds=k)  # noqa: E731
        else:
            from incubator_predictionio_tpu_torch.utils.times import from_millis
            get_time = lambda k: from_millis(int(times[k]))  # noqa: E731
        user_ids = inter.user_ids
        item_ids = inter.item_ids
        for s in range(0, n, chunk):
            batch = [
                Event(
                    event=event_name,
                    entity_type=entity_type,
                    entity_id=user_ids[int(inter.user_idx[k])],
                    target_entity_type=target_entity_type,
                    target_entity_id=item_ids[int(inter.item_idx[k])],
                    properties=DataMap(
                        {value_prop: float(inter.values[k])}),
                    event_time=get_time(k),
                )
                for k in range(s, min(s + chunk, n))
            ]
            self.insert_batch(batch, app_id, channel_id)
        return n


# ---------------------------------------------------------------------------
# Metadata DAOs
# ---------------------------------------------------------------------------

class Apps(abc.ABC):
    """Apps.scala:44-76."""

    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]:
        """Insert; if ``app.id == 0`` an ID is generated. Returns the ID."""

    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...

    @abc.abstractmethod
    def get_all(self) -> list[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> bool: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> bool: ...


def generate_access_key() -> str:
    """Random URL-safe key (AccessKeys.scala:68 generates base64 of random
    bytes with ``+``/``/``/``=`` stripped; token_urlsafe is the same idea)."""
    return secrets.token_urlsafe(48).replace("-", "").replace("_", "")[:64]


class AccessKeys(abc.ABC):
    """AccessKeys.scala:47-76."""

    @abc.abstractmethod
    def insert(self, k: AccessKey) -> Optional[str]:
        """Insert; generates the key when ``k.key`` is empty. Returns key."""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...

    @abc.abstractmethod
    def get_all(self) -> list[AccessKey]: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> list[AccessKey]: ...

    @abc.abstractmethod
    def update(self, k: AccessKey) -> bool: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...


class Channels(abc.ABC):
    """Channels.scala:70-95."""

    @abc.abstractmethod
    def insert(self, channel: Channel) -> Optional[int]:
        """Insert; if ``channel.id == 0`` an ID is generated. Returns the ID."""

    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> list[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> bool: ...


class EngineInstances(abc.ABC):
    """EngineInstances.scala:75-115."""

    @abc.abstractmethod
    def insert(self, i: EngineInstance) -> str:
        """Insert; generates and returns an ID when ``i.id`` is empty."""

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]:
        """Latest COMPLETED instance by start time (EngineInstances.scala:82)."""

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def update(self, i: EngineInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class EvaluationInstances(abc.ABC):
    """EvaluationInstances.scala:70-100."""

    @abc.abstractmethod
    def insert(self, i: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> list[EvaluationInstance]:
        """EVALCOMPLETED instances, newest first (EvaluationInstances.scala:85)."""

    @abc.abstractmethod
    def update(self, i: EvaluationInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class EngineManifests(abc.ABC):
    """EngineManifests.scala:49-66 — engine registry DAO."""

    @abc.abstractmethod
    def insert(self, m: EngineManifest) -> None: ...

    @abc.abstractmethod
    def get(self, manifest_id: str, version: str) -> Optional[EngineManifest]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineManifest]: ...

    @abc.abstractmethod
    def update(self, m: EngineManifest, upsert: bool = False) -> bool: ...

    @abc.abstractmethod
    def delete(self, manifest_id: str, version: str) -> bool: ...


class Models(abc.ABC):
    """Models.scala:40-60 — model blob store."""

    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> None: ...


class BaseStorageClient(abc.ABC):
    """A connection to one storage source (Storage.scala:39-53)."""

    prefix: str = ""

    def __init__(self, config: "StorageClientConfig"):
        self.config = config

    @abc.abstractmethod
    def close(self) -> None: ...


@dataclasses.dataclass(frozen=True)
class StorageClientConfig:
    """Storage.scala:62-66 — parsed ``PIO_STORAGE_SOURCES_<NAME>_*`` env."""
    parallel: bool = False
    test: bool = False
    properties: Dict[str, str] = dataclasses.field(default_factory=dict)
