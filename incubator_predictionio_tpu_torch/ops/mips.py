"""Quantized two-stage MIPS serving: coarse bucket scan + exact rerank.

Port of incubator_predictionio_tpu/ops/mips.py (:1-1554 the knobs, the
index, the registry, the build, the O(delta) update, the exact tail, the
cold tier and the rebuild; :1556-1775 the staged device pair; :1839-2279
the serving wrappers, the host stage and the recall probe) on one device.
Exhaustive serving scores the whole item table per query (ops/topk.py, the
score+top-k kernel); this module is the approximate-MIPS route the top-k
entries take when an index is registered for the table:

1. **Coarse stage.** Spherical k-means centroid buckets are computed at
   train/retrain time. A query scans the centroid table (C×K f32),
   weighted by each bucket's max row norm and ball radius (an upper bound
   on the bucket's best inner product), probes the top ``nprobe`` buckets
   and scores their member rows with the int8 (symmetric per-row scale),
   bf16 or PQ view.
2. **Exact rerank.** The top ``candidates`` coarse survivors are
   re-scored against the exact f32 factor rows and ranked.

The build's heavy products (k-means, the assignment, PQ's codebook scoring)
and both serving stages are PyTorch ops on the table's device
(``torch.matmul`` / ``bmm``, ``topk``, ``argmax``, gathers), where the JAX
package runs numpy on the host and XLA: no Pallas kernel stands behind
this route. Every top-k here ranks descending with ties to the lowest
position (:func:`_topk_desc`, the rule of ``lax.top_k``) on the CPU and on
CUDA alike, and every gather by a member, candidate or ext id clamps its
index first, as XLA's gathers clamp.

Exhaustive stays the FALLBACK and the ORACLE: ``PIO_SERVE_MIPS=off``, an
unregistered table, a filtered query (``allowed_mask``), or a
small-catalogue ``auto`` route all take the exhaustive kernel unchanged.
Unlike the JAX package, which logs a failed build or recall probe and
serves on exhaustively, an error from a build, a rebuild's check query or
the two-stage route raises: nothing here catches it and serves
exhaustively in its place.

Speed-overlay seam: :func:`publish_rows` re-quantizes known rows and
records the fresh vector in an **exact tail** (scored in f32 on the host
and merged after the device stage). Continuation-retrain seam:
:func:`update_index` re-quantizes and re-assigns only the touched rows.
Catalogue-scale seams (ops/mips_daemon.py drives them): PQ residual codes
(``PIO_SERVE_MIPS_QUANT=pq``), :func:`rebuild_index` (re-cluster off the
serving path, fold the virtual-id tail into a dense **ext block**, swap
the registry entry atomically) and cold buckets tiered to host memory.
:func:`index_from_arrays` makes an index from another build's arrays.

Device arrays are never written in place once served: an update builds a
new tensor and rebinds the index's attribute (the JAX package's
``.at[].set``), so a query in flight keeps reading the tensors it started
with.

Left out here: the mesh-sharded index and its serving twin
(``_two_stage`` under ``shard_map``, ``_mips_sharded_jit``; ROADMAP.md
Queue 1 item 9: a sharded table raises). Its knobs are registered with
the knob controller (obs/knobs.py). Each serving entry books one
``serve_topk_mips`` / ``serve_topk_mips_batch`` dispatch with
``obs/profile`` under ``PIO_PROFILE=1``, at the JAX package's FLOP count.

Knobs (all read at call time): ``PIO_SERVE_MIPS`` (off|auto|on),
``PIO_SERVE_MIPS_NPROBE``, ``PIO_SERVE_MIPS_CANDIDATES``,
``PIO_SERVE_MIPS_MIN_ITEMS``, ``PIO_SERVE_MIPS_CENTROIDS``,
``PIO_SERVE_MIPS_QUANT`` (int8|bf16|pq), ``PIO_SERVE_MIPS_PQ_M``,
``PIO_SERVE_MIPS_PQ_CANDIDATES``, ``PIO_MIPS_TIER`` (off|auto|on).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
import weakref
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
from incubator_predictionio_tpu_torch.obs import profile as _profile
from incubator_predictionio_tpu_torch.ops.kernels import NEG_INF

logger = logging.getLogger(__name__)

#: serving-stage scan accounting: rows touched per stage — ``centroid``
#: (coarse centroid rows), ``coarse`` (quantized candidate slots in probed
#: buckets, padding included: a padded slot costs the same read),
#: ``rerank`` (exact f32 rows), ``exhaustive`` (full-table rows on the
#: fallback path)
_CAND_SCANNED = obs_metrics.REGISTRY.counter(
    "pio_serve_candidates_scanned_total",
    "item rows scanned by serving top-k, by stage", labels=("stage",))
_SCAN_CENTROID = _CAND_SCANNED.labels(stage="centroid")
_SCAN_COARSE = _CAND_SCANNED.labels(stage="coarse")
_SCAN_RERANK = _CAND_SCANNED.labels(stage="rerank")
_SCAN_EXHAUSTIVE = _CAND_SCANNED.labels(stage="exhaustive")
_RECALL = obs_metrics.REGISTRY.gauge(
    "pio_serve_mips_recall",
    "last planted-probe recall@k of the two-stage path vs the "
    "exhaustive oracle (recall_probe; sag below the 0.95 gate -> raise "
    "PIO_SERVE_MIPS_NPROBE)")
_INDEX_AGE = obs_metrics.REGISTRY.gauge(
    "pio_mips_index_age_seconds",
    "age of the OLDEST live MIPS index since its last build/update/"
    "publish/daemon-swap")
_TAIL_SIZE = obs_metrics.REGISTRY.gauge(
    "pio_mips_tail_size",
    "exact-tail entries awaiting fold-out, per serving engine",
    labels=("engine",))
_TIER_ROWS = obs_metrics.REGISTRY.gauge(
    "pio_mips_tier_rows",
    "catalogue rows by residence tier: device (quantized coarse views) "
    "vs host (cold buckets + exact tail served from host memory)",
    labels=("tier",))
_REBUILDS = obs_metrics.REGISTRY.counter(
    "pio_mips_rebuilds_total",
    "background index rebuild-and-swaps by trigger "
    "(tail|age|churn|promote|manual)", labels=("trigger",))


def _now() -> float:
    """THE clock for index freshness: every ``built_at`` stamp and the
    age collector read this seam, so a fake clock sees exactly the ages
    production would."""
    return time.time()


def _collect_index_age() -> None:
    ages = []
    tails: Dict[str, int] = {}
    dev_rows = host_rows = 0
    for e in list(_REGISTRY.values()):
        idx = e.index
        ages.append(_now() - idx.built_at)
        tail = idx.tail_size()
        tails[idx.engine] = tails.get(idx.engine, 0) + tail
        d, h = idx.tier_rows()
        dev_rows += d
        host_rows += h + tail
    if ages:
        _INDEX_AGE.set(max(ages))
    for engine, t in tails.items():
        _TAIL_SIZE.labels(engine=engine).set(t)
    _TIER_ROWS.labels(tier="device").set(dev_rows)
    _TIER_ROWS.labels(tier="host").set(host_rows)


obs_metrics.REGISTRY.register_collector("mips_index_age",
                                        _collect_index_age)


# ---------------------------------------------------------------------------
# knobs (call-time reads — serving routes can be flipped live)
# ---------------------------------------------------------------------------

def serving_mode() -> str:
    """off | auto | on (default auto: route when an index exists for
    the table — indexes are only built past the auto floor)."""
    mode = os.environ.get("PIO_SERVE_MIPS", "auto").strip().lower()
    return mode if mode in ("off", "auto", "on") else "auto"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


#: auto-mode catalogue floor, decided on the card by ``chip_smoke.py``'s
#: ``mips`` phase (PERF.md §6): on an NVIDIA H100 80GB HBM3 at 700.00 W the
#: two-stage route (int8, k 20) took 0.98 / 1.12 / 0.99 ms a query on the
#: host against the score+top-k kernel's 0.07 / 0.09 / 0.16 at 65,536 /
#: 262,144 / 1,048,576 items × rank 64 (B 1; at B 64 9.4 against 0.79 ms at
#: 1,048,576), so it won at no size measured. The floor is therefore 2**24,
#: the largest catalogue whose ids the packed f32 answer carries exactly:
#: ``auto`` keeps every such catalogue on the kernel, and
#: ``PIO_SERVE_MIPS=on`` (or a lower floor) routes on demand.
MIN_ITEMS_DEFAULT = 1 << 24


def min_items() -> int:
    """auto-mode catalogue floor: below it the exhaustive kernel wins and
    the index is neither built nor routed."""
    return _env_int("PIO_SERVE_MIPS_MIN_ITEMS", MIN_ITEMS_DEFAULT)


def build_enabled(n_items: int) -> bool:
    mode = serving_mode()
    if mode == "off":
        return False
    if mode == "on":
        return n_items >= 2
    return n_items >= min_items()


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def default_centroids(n_items: int) -> int:
    """C ≈ sqrt(I) rounded to pow2, clamped [16, 4096]."""
    c = _env_int("PIO_SERVE_MIPS_CENTROIDS", 0)
    if c > 0:
        return max(_next_pow2(c), 1)
    return min(max(_next_pow2(int(np.sqrt(max(n_items, 1)))), 16), 4096)


def _nprobe_for(index: "MIPSIndex") -> int:
    """Buckets probed per query: 1/16 of the buckets, with a
    ~2048-coarse-slot floor (``PIO_SERVE_MIPS_NPROBE`` overrides), read
    per call."""
    n = _env_int("PIO_SERVE_MIPS_NPROBE", 0)
    if n <= 0:
        n = max(index.c_total // 16, 2048 // max(index.cap, 1), 4)
    return min(max(n, 1), index.c_total)


def _candidates_for(index: "MIPSIndex", k: int) -> int:
    """Exact-rerank width (pow2): ``PIO_SERVE_MIPS_CANDIDATES`` (default
    1024), or for a PQ index ``PIO_SERVE_MIPS_PQ_CANDIDATES`` (default
    2048: the lossier coarse ranking needs a wider exact rerank)."""
    if index.quant == "pq":
        n = _env_int("PIO_SERVE_MIPS_PQ_CANDIDATES", 0)
        if n <= 0:
            n = 2048
    else:
        n = _env_int("PIO_SERVE_MIPS_CANDIDATES", 0)
        if n <= 0:
            n = 1024
    n = max(_next_pow2(n), _next_pow2(max(k, 1)))
    return min(n, _next_pow2(index.n_items))


def _quant_mode() -> str:
    q = os.environ.get("PIO_SERVE_MIPS_QUANT", "int8").strip().lower()
    return q if q in ("int8", "bf16", "pq") else "int8"


def _pq_m(rank: int) -> int:
    """Subquantizer count for PQ builds: ``PIO_SERVE_MIPS_PQ_M`` (default
    16) snapped DOWN to a divisor of the rank."""
    m = _env_int("PIO_SERVE_MIPS_PQ_M", 16)
    m = max(1, min(m, rank))
    while rank % m:
        m -= 1
    return m


# ---------------------------------------------------------------------------
# index structure + registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ColdTier:
    """Host-memory residence for cold buckets (a rebuild-daemon
    decision — see :func:`rebuild_index`). Demoted rows leave the
    device arrays entirely; they are clustered into their OWN host
    mini-index and served by an exact f32 numpy scan of the probed
    buckets, merged after the device stage like the tail. ``hits`` is
    the promotion signal."""

    centroids: np.ndarray       # [Cc, K] f32 unit centroids
    cmax: np.ndarray            # [Cc] f32 probe bound norms
    crad_cos: np.ndarray        # [Cc] f32 ball radius (cos)
    crad_sin: np.ndarray        # [Cc] f32 ball radius (sin)
    member_ids: List[np.ndarray]    # per-bucket global ids
    member_vecs: List[np.ndarray]   # per-bucket exact f32 rows
    rows: int                   # total demoted rows
    hits: np.ndarray            # [Cc] int64 probe-hit counters


@dataclasses.dataclass
class MIPSIndex:
    """Quantized views + coarse buckets over ONE item factor table.

    Device tensors live on the table's device. Host mirrors (``assign``,
    ``members_np``, ``centroids_np``, ``counts``) exist for the O(delta)
    update path. The exact tail (``_tail``) holds published-but-not-yet-
    rebuilt vectors, merged in f32 after the device stage."""

    codes: torch.Tensor       # [I_pad, K] int8 symmetric per-row quant
    scales: torch.Tensor      # [I_pad] f32 per-row scale (max|v|/127)
    bf16: torch.Tensor        # [I_pad, K] bfloat16 view
    centroids: torch.Tensor   # [C, K] f32 unit centroids
    cmax: torch.Tensor        # [C] f32 max member row norm (probe bound)
    crad_cos: torch.Tensor    # [C] f32 cos of the bucket's ball radius
    crad_sin: torch.Tensor    # [C] f32 sin of it
    members: torch.Tensor     # [C, cap] int32 GLOBAL row ids, -1 pad
    assign: np.ndarray        # [n_items] int32 host bucket of each row
    members_np: np.ndarray    # [C, cap] host mirror of members
    centroids_np: np.ndarray  # [C, K] host mirror
    counts: np.ndarray        # [C] live members per bucket
    n_items: int              # true (servable) row count
    n_shards: int             # 1: the sharded index is not ported
    c_local: int              # buckets (C)
    cap: int                  # member slots per bucket
    rank: int
    seed: int
    #: the quantized view this index materialized ("int8" | "bf16" |
    #: "pq"), chosen from PIO_SERVE_MIPS_QUANT at BUILD time; the
    #: unselected views are 1-row placeholders
    quant: str = "int8"
    built_at: float = 0.0     # wall ts of last build/update/publish
    rebuilds: int = 0         # full builds that produced this index
    delta_updates: int = 0    # O(delta) update_index applications
    #: PQ residual codes (quant == "pq"): bucket-major [C, cap, M]
    #: uint8 codes + [M, 256, rank/M] f32 codebooks, with host mirrors
    pq_codes: Optional[torch.Tensor] = None
    pq_books: Optional[torch.Tensor] = None
    pq_codes_np: Optional[np.ndarray] = None
    pq_books_np: Optional[np.ndarray] = None
    pq_m: int = 0
    #: daemon-rebuild ext block: folded virtual-id rows [E_pad, K] f32
    #: at ids [capacity, capacity + n_ext)
    ext: Optional[torch.Tensor] = None
    ext_np: Optional[np.ndarray] = None
    n_ext: int = 0
    #: true table capacity (padded row count)
    capacity_rows: int = 0
    #: host cold tier — None when every bucket is device-resident
    cold: Optional[ColdTier] = None
    #: serving-engine label for the pio_mips_tail_size gauge
    engine: str = "default"
    #: host mirrors of the probe-bound arrays (the host-side probe used
    #: by cold-tier serving and the probe-hit sampler)
    cmax_np: Optional[np.ndarray] = None
    crad_cos_np: Optional[np.ndarray] = None
    crad_sin_np: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        #: exact tail: global/virtual id -> fresh f32 vector (host)
        self._tail: "Dict[int, np.ndarray]" = {}
        self._tail_pack: Optional[Tuple[np.ndarray, np.ndarray]] = None
        #: publish sequence numbers per tail id: the rebuild snapshots a
        #: watermark and the swap carries newer entries into the
        #: successor's tail
        self._tail_seqs: Dict[int, int] = {}
        self._tail_seq = 0
        #: set under ``_lock`` at swap time: a publisher that raced the
        #: swap re-routes its entries to the successor index
        self._superseded: Optional["MIPSIndex"] = None
        self._next_virtual = self.capacity + self.n_ext
        self._table_ref: Optional[weakref.ref] = None
        #: per-bucket probe-hit counters (host, sampled)
        self.probe_hits = np.zeros(self.c_total, np.int64)
        self._probe_samples = 0
        self._dispatches = 0
        #: rows churned (published / delta-updated) since this build
        self.churn_rows = 0
        if not self.built_at:
            self.built_at = _now()

    @property
    def c_total(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def capacity(self) -> int:
        if self.capacity_rows:
            return self.capacity_rows
        view = self.bf16 if self.quant == "bf16" else self.codes
        return int(view.shape[0])

    def tier_rows(self) -> Tuple[int, int]:
        """(device rows, host cold rows)."""
        host = self.cold.rows if self.cold is not None else 0
        return (self.n_items + self.n_ext - host, host)

    def device_bytes(self) -> int:
        """Bytes of every device tensor this index holds."""
        ts = (self.codes, self.scales, self.bf16, self.centroids, self.cmax,
              self.crad_cos, self.crad_sin, self.members, self.pq_codes,
              self.pq_books, self.ext)
        return sum(int(t.numel()) * t.element_size() for t in ts
                   if t is not None)

    # -- exact tail ---------------------------------------------------------
    def tail_arrays(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(ids [T] int64, vecs [T, K] f32) or None when empty; packed
        lazily and cached until the next publish."""
        with self._lock:
            if not self._tail:
                return None
            if self._tail_pack is None:
                ids = np.fromiter(self._tail, np.int64,
                                  count=len(self._tail))
                vecs = np.stack([self._tail[int(i)] for i in ids])
                self._tail_pack = (ids, vecs.astype(np.float32))
            return self._tail_pack

    def tail_size(self) -> int:
        with self._lock:
            return len(self._tail)

    def tail_virtual_size(self) -> int:
        """Virtual-id tail entries (new keys not yet folded into the
        index) — the rebuild daemon's tail trigger input."""
        with self._lock:
            return sum(1 for g in self._tail if g >= self.capacity)

    def stats(self) -> Dict[str, Any]:
        dev, host = self.tier_rows()
        return {
            "items": self.n_items,
            "capacity": self.capacity,
            "centroids": self.c_total,
            "bucketCap": self.cap,
            "shards": self.n_shards,
            "tail": self.tail_size(),
            "tailVirtual": self.tail_virtual_size(),
            "ageSec": round(_now() - self.built_at, 1),
            "rebuilds": self.rebuilds,
            "deltaUpdates": self.delta_updates,
            "quant": self.quant,
            "pqM": self.pq_m,
            "ext": self.n_ext,
            "deviceRows": dev,
            "hostRows": host,
            "churnRows": self.churn_rows,
            "engine": self.engine,
        }


@dataclasses.dataclass
class _Entry:
    ref: weakref.ref
    index: MIPSIndex


#: id(table) -> entry; the weakref callback unregisters when the table
#: is collected, so a dropped model never pins its index. The key is the
#: tensor OBJECT: a copy, slice, ``.contiguous()`` or ``.to()`` that
#: makes a new tensor is another table and routes exhaustive.
_REGISTRY: Dict[int, _Entry] = {}


def register_index(table: Any, index: MIPSIndex) -> MIPSIndex:
    key = id(table)

    def _drop(_ref: Any, key: int = key) -> None:
        _REGISTRY.pop(key, None)

    index._table_ref = weakref.ref(table, _drop)
    _REGISTRY[key] = _Entry(ref=index._table_ref, index=index)
    return index


def unregister_index(table: Any) -> None:
    _REGISTRY.pop(id(table), None)


def index_for(table: Any) -> Optional[MIPSIndex]:
    entry = _REGISTRY.get(id(table))
    if entry is None:
        return None
    # id() reuse guard: the key survives only while THIS table does
    if entry.ref() is not table:
        _REGISTRY.pop(id(table), None)
        return None
    return entry.index


def registered_tables() -> List[Tuple[Any, MIPSIndex]]:
    """Live (table, index) pairs — the rebuild daemon's scan set.
    Holding the returned table reference pins it for the rebuild."""
    out = []
    for entry in list(_REGISTRY.values()):
        table = entry.ref()
        if table is not None:
            out.append((table, entry.index))
    return out


def adopt_index(prev_table: Any, new_table: Any) -> Optional[MIPSIndex]:
    """Move a registered index onto a VALUE-IDENTICAL replacement table
    (the deploy-time ``prepare_model`` put of factors that were just
    trained in this process), skipping the full rebuild the new object
    identity would otherwise force. The caller owns the equal-values
    contract; a shape mismatch refuses, and so does another device (the
    index's tensors live on the table's)."""
    index = index_for(prev_table)
    if index is None or prev_table is new_table:
        return index
    if tuple(new_table.shape) != (index.capacity, index.rank):
        return None
    if new_table.device != index.centroids.device:
        return None
    unregister_index(prev_table)
    register_index(new_table, index)
    # an adoption IS a swap: the age baseline resets
    index.built_at = _now()
    return index


def status_snapshot() -> List[Dict[str, Any]]:
    """One ``stats()`` dict per live registered index — the ``mips``
    block of the prediction server's ``GET /``."""
    out = []
    for e in list(_REGISTRY.values()):
        if e.ref() is None:
            continue
        try:
            out.append(e.index.stats())
        except Exception:     # a racing swap must never break the status
            logger.exception("mips status snapshot failed")
    return out


def route(table: Any, *, k: int,
          allowed_mask: Optional[Any] = None,
          exclude: Optional[Any] = None) -> Optional[MIPSIndex]:
    """THE auto-router predicate (ops/topk.py calls it on every serve
    entry): the registered index when the two-stage path should serve
    this query, else None → exhaustive. Filtered queries
    (``allowed_mask``) always fall back, and so does a query whose
    exclusion list rivals the candidate budget."""
    mode = serving_mode()
    if mode == "off" or allowed_mask is not None:
        return None
    index = index_for(table)
    if index is None or index.n_items < 2:
        return None
    if k >= index.n_items:
        return None  # top-"everything": the scan IS the answer
    if exclude is not None:
        width = int(getattr(exclude, "shape", (len(exclude),))[-1])
        if 2 * width >= _candidates_for(index, k):
            return None
    return index


def book_exhaustive(rows: int) -> None:
    """Scan accounting for the exhaustive fallback path (called by the
    ops/topk wrappers)."""
    _SCAN_EXHAUSTIVE.inc(rows)


# ---------------------------------------------------------------------------
# build / update / publish. The heavy products of a build (the k-means fit,
# the assignment and the balanced spill's preference pass, PQ's codebook
# scoring) run on the table's device with torch.matmul and argmax / topk,
# chunked as the JAX package chunks them; the seeded samples are the same
# numpy ``default_rng(seed)`` draws, so the same rows are drawn. The greedy
# fill rounds and the member packing stay on the host, in the JAX package's
# order of admission. Against the JAX package's numpy build: int8 codes and
# scales and the bf16 view equal; centroids within f32 rounding, bucket
# assignments equal except where two centroids score within rounding.
# ---------------------------------------------------------------------------

#: members whose norm is at least this fraction of their bucket's max
#: participate in the probe-bound ball radius (see build_index): only
#: near-max rows can win a query through the bound
_RADIUS_NORM_FRAC = 0.8

#: rows per chunk of a build's [rows, C] score block (~256 MB at C 1,024)
_BUILD_CHUNK = 65536


def _host(x: Any) -> np.ndarray:
    """f32 host copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _host_ids(x: Any) -> Optional[np.ndarray]:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def _to_dev(arr: Any, device: torch.device) -> torch.Tensor:
    """A host array (or a tensor) as a tensor on ``device``."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    return t.to(device)


def _f32(x: Any, device: torch.device) -> torch.Tensor:
    """Rows as a contiguous f32 tensor on ``device``."""
    return _to_dev(x, device).to(torch.float32).contiguous()


def _set_rows(t: torch.Tensor, rows: np.ndarray, vals: Any) -> torch.Tensor:
    """``t`` with ``t[rows] = vals`` as a NEW tensor (copy on write)."""
    out = t.clone()
    idx = torch.from_numpy(np.asarray(rows, np.int64)).to(t.device)
    v = vals if isinstance(vals, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(vals))
    out[idx] = v.to(device=t.device, dtype=t.dtype)
    return out


def _sync(device: torch.device) -> None:
    """Finish the device's queued work: a tensor handed to another thread
    must be fully written."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _check_unsharded(table: Any) -> None:
    """The port's index serves one device's table; a mesh-sharded one
    (a ``DTensor``) waits for ROADMAP.md Queue 1 item 9."""
    if type(table).__name__ == "DTensor":
        raise NotImplementedError(
            "a MIPS index over a mesh-sharded table is not ported "
            "(ROADMAP.md Queue 1 item 9)")


def _quantize_int8(vf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: (codes [n, K], scales [n]), the JAX
    package's numpy arithmetic elementwise (round half to even)."""
    scales = torch.clamp(vf.abs().amax(dim=1) / 127.0, min=1e-12)
    codes = torch.round(vf / scales[:, None]).to(torch.int8)
    return codes, scales


def _unit(rows: torch.Tensor) -> torch.Tensor:
    return rows / torch.clamp(torch.linalg.vector_norm(
        rows, dim=1, keepdim=True), min=1e-9)


def _argmax_chunked(x: torch.Tensor, w: torch.Tensor,
                    chunk: int = _BUILD_CHUNK) -> torch.Tensor:
    """argmax over the columns of ``x @ w.T`` (first of equal maxima), row
    chunks at a time: [n] int64 on ``x``'s device."""
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], chunk):
        out[s:s + chunk] = torch.argmax(x[s:s + chunk] @ w.T, dim=1)
    return out


def _lloyd_means(x: torch.Tensor, assign: torch.Tensor,
                 cent: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-bucket sums in f64, member counts) of ``x`` under ``assign``:
    one ``index_add_``, in place of a pass per bucket."""
    sums = torch.zeros(cent.shape, dtype=torch.float64, device=x.device)
    sums.index_add_(0, assign, x.to(torch.float64))
    counts = torch.bincount(assign, minlength=cent.shape[0])
    return sums, counts


#: PQ training budget: 256 codewords per subspace, Lloyd on a bounded
#: residual sample — build cost stays O(sample · 256 · K) however large the
#: catalogue is
_PQ_CODEBOOK = 256
_PQ_TRAIN_SAMPLE = 16384
_PQ_ITERS = 6


def _pq_train_books(res: torch.Tensor, m: int, seed: int) -> np.ndarray:
    """[M, 256, rank/M] euclidean Lloyd codebooks over the residual
    subspaces (row − assigned centroid), fitted on ``res``'s device."""
    n, rank = res.shape
    d = rank // m
    rng = np.random.default_rng(seed + 17)
    fit = (res if n <= _PQ_TRAIN_SAMPLE else res[torch.from_numpy(
        rng.choice(n, _PQ_TRAIN_SAMPLE, replace=False)).to(res.device)])
    books = np.zeros((m, _PQ_CODEBOOK, d), np.float32)
    if len(fit) == 0:
        return books
    for mi in range(m):
        sub = fit[:, mi * d:(mi + 1) * d].contiguous()
        c = sub[torch.from_numpy(rng.choice(
            len(sub), _PQ_CODEBOOK, replace=len(sub) < _PQ_CODEBOOK)).to(
                res.device)].clone()
        for _ in range(_PQ_ITERS):
            # nearest codeword via the argmax(2·x·c − |c|²) expansion
            sc = 2.0 * (sub @ c.T) - (c * c).sum(dim=1)[None, :]
            sums, cnt = _lloyd_means(sub, torch.argmax(sc, dim=1), c)
            nz = cnt > 0
            c[nz] = (sums[nz] / cnt[nz, None]).to(torch.float32)
        books[mi] = c.cpu().numpy()
    return books


def _pq_encode(res: torch.Tensor, books: np.ndarray,
               chunk: int = _BUILD_CHUNK) -> np.ndarray:
    """[n, M] uint8 nearest-codeword ids per subspace, scored on
    ``res``'s device."""
    n = len(res)
    m, _cb, d = books.shape
    bt = torch.from_numpy(books).to(res.device)
    codes = torch.empty((n, m), dtype=torch.uint8, device=res.device)
    for mi in range(m):
        pen = (bt[mi] * bt[mi]).sum(dim=1)[None, :]
        for s in range(0, n, chunk):
            sub = res[s:s + chunk, mi * d:(mi + 1) * d]
            codes[s:s + chunk, mi] = torch.argmax(
                2.0 * (sub @ bt[mi].T) - pen, dim=1).to(torch.uint8)
    return codes.cpu().numpy()


def _pq_pack(assign: np.ndarray, codes: np.ndarray, c: int,
             cap: int) -> np.ndarray:
    """Bucket-major [c, cap, M] uint8 code slots, in the same stable slot
    order as :func:`_pack_members`."""
    out = np.zeros((c, cap, codes.shape[1]), np.uint8)
    counts = np.bincount(assign, minlength=c)
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(order)) - starts[assign[order]]
    out[assign[order], pos] = codes[order]
    return out


def _spherical_kmeans(rows: torch.Tensor, c: int, seed: int,
                      iters: int = 8, sample_cap: int = 0) -> torch.Tensor:
    """[c, K] f32 unit centroids via seeded Lloyd on normalized rows, on
    ``rows``' device; fitted on a bounded sample (64 rows per centroid,
    the JAX package's numpy draws) so build cost stays O(C²·K·iters)."""
    dev = rows.device
    rng = np.random.default_rng(seed)
    unit = _unit(rows)
    cap = sample_cap or 64 * c
    fit = unit if len(unit) <= cap else unit[torch.from_numpy(
        rng.choice(len(unit), cap, replace=False)).to(dev)]
    if len(fit) == 0:
        return torch.zeros((c, rows.shape[1]), dtype=torch.float32,
                           device=dev)
    cent = fit[torch.from_numpy(rng.choice(
        len(fit), c, replace=len(fit) < c)).to(dev)].clone()
    for _ in range(iters):
        sums, counts = _lloyd_means(fit, _argmax_chunked(fit, cent), cent)
        nz = counts > 0
        mu = (sums[nz] / counts[nz, None]).to(torch.float32)
        cent[nz] = mu / torch.clamp(torch.linalg.vector_norm(
            mu, dim=1, keepdim=True), min=1e-9)
    return cent


#: bucket preferences kept per row for the balanced spill (a row
#: overflowing its 8 best buckets goes to the emptiest open one)
_BALANCE_PREFS = 8


def _balanced_assign(vf: torch.Tensor, cent: torch.Tensor, cap: int,
                     chunk: int = _BUILD_CHUNK) -> np.ndarray:
    """Capacity-bounded bucket assignment: best-centroid first, spill to
    the next-best OPEN bucket when full. The per-row top-8 preferences are
    scored on the device; the round-based greedy fill (rows contending for
    one bucket admitted best-score-first) runs on the host."""
    n, c = len(vf), len(cent)
    p = min(_BALANCE_PREFS, c)
    pref_t = torch.empty((n, p), dtype=torch.int64, device=vf.device)
    pscore_t = torch.empty((n, p), dtype=torch.float32, device=vf.device)
    for s in range(0, n, chunk):
        ts, top = torch.topk(vf[s:s + chunk] @ cent.T, p, dim=1)
        pref_t[s:s + chunk], pscore_t[s:s + chunk] = top, ts
    pref = pref_t.to(torch.int32).cpu().numpy()
    pscore = pscore_t.cpu().numpy()
    assign = np.full(n, -1, np.int32)
    fill = np.zeros(c, np.int64)
    for _round in range(p):
        un = np.nonzero(assign < 0)[0]
        if not len(un):
            break
        open_ = fill < cap
        ok = open_[pref[un]]                        # [U, p]
        first = np.argmax(ok, axis=1)
        has = np.take_along_axis(ok, first[:, None], 1)[:, 0]
        un = un[has]
        if not len(un):
            break
        first = first[has]
        target = pref[un, first]
        score = pscore[un, first]
        # admit best-score-first within each contended bucket
        order = np.lexsort((-score, target))
        tsorted = target[order]
        counts = np.bincount(tsorted, minlength=c)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(len(order)) - starts[tsorted]
        accept = pos < (cap - fill)[tsorted]
        rows = un[order][accept]
        assign[rows] = tsorted[accept]
        fill += np.bincount(tsorted[accept], minlength=c)
    left = np.nonzero(assign < 0)[0]
    for row in left:  # bounded leftovers: total capacity > n by build
        b = int(np.argmin(fill))
        assign[row] = b
        fill[b] += 1
    return assign


def _pack_members(assign: np.ndarray, row_ids: np.ndarray, c: int,
                  cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Bucket member lists [c, cap] (global ids, -1 padded) + counts."""
    members = np.full((c, cap), -1, np.int32)
    counts = np.bincount(assign, minlength=c)
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(order)) - starts[assign[order]]
    members[assign[order], pos] = row_ids[order].astype(np.int32)
    return members, counts.astype(np.int64)


def _probe_geometry(vf: torch.Tensor, assign: np.ndarray,
                    cent: torch.Tensor, c: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cmax, crad_cos, crad_sin) per bucket, host f32: the max member
    norm and the ball radius over the HIGH-NORM members (≥
    _RADIUS_NORM_FRAC·cmax). The probe ranks buckets by
    cmax·|q|·cos(θ_qc − r): only rows with a norm comparable to the bucket
    max can win a query, so only they widen the ball."""
    dev = vf.device
    a = torch.from_numpy(assign.astype(np.int64)).to(dev)
    norms = torch.linalg.vector_norm(vf, dim=1)
    cmax = torch.zeros(c, dtype=torch.float32, device=dev).scatter_reduce_(
        0, a, norms, "amax")
    row_cos = (_unit(vf) * cent[a]).sum(dim=1) if len(vf) else norms
    high = norms >= _RADIUS_NORM_FRAC * cmax[a]
    crad_cos = torch.ones(c, dtype=torch.float32, device=dev)
    crad_cos.scatter_reduce_(0, a[high], row_cos[high], "amin")
    crad_cos = torch.clamp(crad_cos, -1.0, 1.0)
    crad_sin = torch.sqrt(1.0 - crad_cos * crad_cos)
    return (cmax.cpu().numpy(), crad_cos.cpu().numpy(),
            crad_sin.cpu().numpy())


def _cap_for(n: int, c: int) -> int:
    """Balanced-bucket cap ≈ 1.25× the mean bucket size (8-aligned):
    every probed bucket's cap slots are gathered whether occupied or not,
    so padding headroom is wasted read."""
    mean_bucket = -(-max(n, 1) // c)
    return max(-(-int(mean_bucket * 1.25) // 8) * 8, 8)


def build_index(
    table: torch.Tensor,       # [I_pad, K] f32 item table on its device
    n_items: int,
    *,
    seed: int = 0,
    n_centroids: Optional[int] = None,
    host_factors: Optional[np.ndarray] = None,
    register: bool = True,
    probe_recall: bool = False,
    engine: str = "default",
) -> MIPSIndex:
    """Full build at train/retrain/deploy time: k-means, one balanced
    assignment pass and quantization, their products on the table's
    device (``host_factors`` only saves the recall probe a table fetch).
    An error raises; the recall probe's too."""
    _check_unsharded(table)
    t0 = time.perf_counter()
    dev = table.device
    i_pad, rank = int(table.shape[0]), int(table.shape[1])
    n_items = min(int(n_items), i_pad)
    vf = _f32(table[:n_items], dev)
    c_local = (max(_next_pow2(n_centroids), 1) if n_centroids
               else default_centroids(n_items))
    cap = _cap_for(n_items, c_local)
    assign = np.zeros(n_items, np.int32)
    cent = torch.zeros((c_local, rank), dtype=torch.float32, device=dev)
    if n_items > 0:
        cent = _spherical_kmeans(vf, c_local, seed)
        assign = _balanced_assign(vf, cent, cap)
    members_np, counts = _pack_members(
        assign, np.arange(n_items, dtype=np.int64), c_local, cap)
    cmax, crad_cos, crad_sin = _probe_geometry(vf, assign, cent, c_local)

    # materialize ONLY the selected quantized view; the others are
    # one-row placeholders
    quant = _quant_mode()
    pq_m = 0
    pq_codes_np = np.zeros((1, 1, 1), np.uint8)
    pq_books_np = np.zeros((1, _PQ_CODEBOOK, 1), np.float32)
    codes = torch.zeros((1, rank), dtype=torch.int8, device=dev)
    scales = torch.zeros(1, dtype=torch.float32, device=dev)
    bf16_view = torch.zeros((1, rank), dtype=torch.bfloat16, device=dev)
    if quant == "pq":
        # residuals vs the ASSIGNED centroid: the probe stage computes
        # q·c exactly for every bucket
        pq_m = _pq_m(rank)
        res = vf - cent[torch.from_numpy(assign.astype(np.int64)).to(dev)]
        pq_books_np = _pq_train_books(res, pq_m, int(seed))
        pq_codes_np = _pq_pack(assign, _pq_encode(res, pq_books_np),
                               c_local, cap)
        del res
    elif quant == "bf16":
        bf16_view = torch.zeros((i_pad, rank), dtype=torch.bfloat16,
                                device=dev)
        bf16_view[:n_items] = vf.to(torch.bfloat16)
    else:
        codes = torch.zeros((i_pad, rank), dtype=torch.int8, device=dev)
        scales = torch.zeros(i_pad, dtype=torch.float32, device=dev)
        codes[:n_items], scales[:n_items] = _quantize_int8(vf)
    cent_np = cent.cpu().numpy()
    del vf

    index = MIPSIndex(
        codes=codes, scales=scales, bf16=bf16_view, centroids=cent,
        cmax=_to_dev(cmax, dev), crad_cos=_to_dev(crad_cos, dev),
        crad_sin=_to_dev(crad_sin, dev), members=_to_dev(members_np, dev),
        assign=assign, members_np=members_np, centroids_np=cent_np,
        counts=counts, n_items=n_items, n_shards=1,
        c_local=c_local, cap=cap, rank=rank, seed=int(seed),
        quant=quant, rebuilds=1,
        pq_codes=_to_dev(pq_codes_np, dev),
        pq_books=_to_dev(pq_books_np, dev),
        pq_codes_np=pq_codes_np, pq_books_np=pq_books_np, pq_m=pq_m,
        capacity_rows=i_pad, engine=engine,
        cmax_np=cmax.copy(), crad_cos_np=crad_cos.copy(),
        crad_sin_np=crad_sin.copy(),
    )
    _sync(dev)
    if register:
        register_index(table, index)
    if probe_recall and register:
        recall_probe(table, index, host_factors=host_factors)
    logger.info(
        "mips index built: %d items, %d centroids (cap %d, %s) in %.2fs",
        n_items, c_local, cap, quant, time.perf_counter() - t0)
    return index


def index_from_arrays(arrays: Dict[str, Any], device: Any = None,
                      **fields: Any) -> MIPSIndex:
    """The port's index from another build's arrays, fetched as numpy:
    the fields of the JAX package's ``MIPSIndex`` by the same names
    (``codes``, ``scales``, ``bf16`` as f32 or bf16, ``centroids``,
    ``cmax``, ``crad_cos``, ``crad_sin``, ``members``, ``assign``,
    ``counts``, ``pq_codes``, ``pq_books``, ``ext`` — None without an ext
    block) and its scalars as keywords (``n_items``, ``c_local``, ``cap``,
    ``rank``, ``seed``, ``quant``, ``capacity_rows``, ``pq_m``, ``n_ext``,
    ``rebuilds``, ...). Device tensors go to ``device`` (the CUDA card
    unless ``device="cpu"``), host mirrors are copies, and a ``cold`` tier
    passes through as a keyword. Not registered: pair it with its table
    through :func:`register_index`."""
    from incubator_predictionio_tpu_torch import runtime

    dev = runtime.default_device(device)

    def arr(name, dtype=None):
        a = np.asarray(arrays[name])
        return a.astype(dtype) if dtype is not None else a

    bf = torch.from_numpy(np.ascontiguousarray(
        arr("bf16", np.float32))).to(torch.bfloat16)
    ext = arrays.get("ext")
    ext_np = None if ext is None else arr("ext", np.float32).copy()
    members_np = arr("members", np.int32).copy()
    cent_np = arr("centroids", np.float32).copy()
    cmax = arr("cmax", np.float32).copy()
    ccos = arr("crad_cos", np.float32).copy()
    csin = arr("crad_sin", np.float32).copy()
    pq_codes_np = arr("pq_codes", np.uint8).copy()
    pq_books_np = arr("pq_books", np.float32).copy()
    return MIPSIndex(
        codes=_to_dev(arr("codes", np.int8), dev),
        scales=_to_dev(arr("scales", np.float32), dev),
        bf16=bf.to(dev), centroids=_to_dev(cent_np, dev),
        cmax=_to_dev(cmax, dev), crad_cos=_to_dev(ccos, dev),
        crad_sin=_to_dev(csin, dev), members=_to_dev(members_np, dev),
        assign=arr("assign", np.int32).copy(), members_np=members_np,
        centroids_np=cent_np, counts=arr("counts", np.int64).copy(),
        n_shards=1, pq_codes=_to_dev(pq_codes_np, dev),
        pq_books=_to_dev(pq_books_np, dev), pq_codes_np=pq_codes_np,
        pq_books_np=pq_books_np,
        ext=None if ext_np is None else _to_dev(ext_np, dev), ext_np=ext_np,
        cmax_np=cmax.copy(), crad_cos_np=ccos.copy(),
        crad_sin_np=csin.copy(), **fields)


def update_index(
    prev_table: Any,
    new_table: torch.Tensor,
    n_items: int,
    touched_rows: Optional[np.ndarray],
) -> Optional[MIPSIndex]:
    """O(delta) continuation-retrain splice: re-quantize + re-assign
    ONLY the touched/new rows of the index registered for ``prev_table``
    and re-register it under ``new_table``. Returns None (caller
    rebuilds) when no index is registered, the geometry changed, the
    index carries an ext block or a cold tier, or the new ids outgrew
    the padded capacity."""
    _check_unsharded(new_table)
    index = index_for(prev_table)
    if index is None or touched_rows is None:
        return None
    i_pad, rank = int(new_table.shape[0]), int(new_table.shape[1])
    if (i_pad, rank) != (index.capacity, index.rank):
        return None
    if new_table.device != index.centroids.device:
        return None
    if index.n_ext or index.cold is not None:
        # a daemon-rebuilt index carries folded virtual rows (ext) or a
        # host cold tier the splice contract doesn't cover
        return None
    n_items = int(n_items)
    if n_items > index.capacity:
        return None
    touched = np.unique(np.concatenate([
        np.asarray(touched_rows, np.int64).ravel(),
        np.arange(index.n_items, n_items, dtype=np.int64),
    ]))
    touched = touched[(touched >= 0) & (touched < n_items)]
    if len(touched):
        vt = _host(new_table[torch.from_numpy(touched).to(
            new_table.device)])
        if index.quant == "pq":
            # PQ codes live bucket-major and encode residuals vs the
            # ASSIGNED centroid — re-home first, then encode
            _reassign_rows(index, touched, vt)
            _requantize_rows(index, touched, vt)
        else:
            _requantize_rows(index, touched, vt)
            _reassign_rows(index, touched, vt)
    index.n_items = n_items
    index.delta_updates += 1
    index.churn_rows += len(touched)
    index.built_at = _now()
    with index._lock:
        # republished rows supersede their tail overrides; genuinely
        # new virtual entries (ids past capacity) survive the splice
        for row in touched:
            index._tail.pop(int(row), None)
        index._tail_pack = None
    _sync(new_table.device)
    unregister_index(prev_table)
    register_index(new_table, index)
    return index


def _requantize_rows(index: MIPSIndex, rows: np.ndarray,
                     vecs: np.ndarray) -> None:
    """Splice fresh vectors into the MATERIALIZED quantized view. Under
    PQ each row re-encodes against its CURRENT bucket's centroid into its
    member slot (call after any re-assignment); rows in no device bucket
    are skipped — their exact tail entry serves them."""
    rows = np.asarray(rows, np.int64)
    if index.quant == "pq":
        changed: set = set()
        for pos, row in enumerate(rows):
            b = (int(index.assign[row])
                 if row < len(index.assign) else -1)
            if b < 0:
                continue
            slots = np.nonzero(index.members_np[b] == row)[0]
            if not len(slots):
                continue
            res = (vecs[pos].astype(np.float32)
                   - index.centroids_np[b])
            index.pq_codes_np[b, slots[0]] = _pq_encode(
                torch.from_numpy(res[None, :]), index.pq_books_np)[0]
            changed.add(b)
        if changed:
            bids = np.asarray(sorted(changed), np.int64)
            index.pq_codes = _set_rows(index.pq_codes, bids,
                                       index.pq_codes_np[bids])
        return
    if index.quant == "bf16":
        index.bf16 = _set_rows(index.bf16, rows,
                               np.asarray(vecs, np.float32))
        return
    codes_t, scales_t = _quantize_int8(torch.from_numpy(
        np.ascontiguousarray(vecs, np.float32)))
    index.codes = _set_rows(index.codes, rows, codes_t)
    index.scales = _set_rows(index.scales, rows, scales_t)


def _reassign_rows(index: MIPSIndex, rows: np.ndarray,
                   vecs: np.ndarray) -> None:
    """Move ``rows`` to their nearest bucket on the host mirrors, then
    splice ONLY the changed buckets to the device — O(delta · cap)."""
    grown = np.setdiff1d(rows, np.arange(len(index.assign)),
                         assume_unique=False)
    if len(grown):
        index.assign = np.concatenate([
            index.assign,
            np.full(int(rows.max()) + 1 - len(index.assign), -1,
                    np.int32)])
    changed_buckets = set()
    changed_cmax: Dict[int, float] = {}
    changed_crad: Dict[int, float] = {}
    norms = np.linalg.norm(vecs, axis=1)
    cmax_np = index.cmax.cpu().numpy().copy()

    def note_radius(bucket: int, pos: int) -> None:
        # widen the bucket's ball to cover the re-solved / re-homed
        # row's direction — only for rows heavy enough to win a query
        if norms[pos] < _RADIUS_NORM_FRAC * cmax_np[bucket]:
            return
        cos = float(vecs[pos] @ index.centroids_np[bucket]
                    / max(norms[pos], 1e-9))
        changed_crad[bucket] = min(changed_crad.get(bucket, 1.0), cos)

    for pos, row in enumerate(np.asarray(rows, np.int64)):
        cent_s = index.centroids_np[:index.c_local]
        new_b = int(np.argmax(cent_s @ vecs[pos]))
        old_b = int(index.assign[row]) if row < len(index.assign) else -1
        if norms[pos] > cmax_np[new_b]:
            cmax_np[new_b] = norms[pos]
            changed_cmax[new_b] = float(norms[pos])
        if old_b == new_b:
            note_radius(old_b, pos)
            continue
        if index.counts[new_b] >= index.cap:
            if old_b >= 0:
                # full target: keep the old membership (the fresh codes
                # still score there; widen the old ball accordingly)
                note_radius(old_b, pos)
                if norms[pos] > cmax_np[old_b]:
                    cmax_np[old_b] = norms[pos]
                    changed_cmax[old_b] = float(norms[pos])
                continue
            # a NEW row with a full best bucket spills to the emptiest
            # bucket, else serves exactly from the tail until a rebuild
            new_b = int(np.argmin(index.counts[:index.c_local]))
            if index.counts[new_b] >= index.cap:
                with index._lock:
                    index._tail[int(row)] = np.asarray(
                        vecs[pos], np.float32)
                    index._tail_seq += 1
                    index._tail_seqs[int(row)] = index._tail_seq
                    index._tail_pack = None
                continue
            if norms[pos] > cmax_np[new_b]:
                cmax_np[new_b] = norms[pos]
                changed_cmax[new_b] = float(norms[pos])
        if old_b >= 0:
            slots = index.members_np[old_b]
            hit = np.nonzero(slots == row)[0]
            if len(hit):
                last = int(index.counts[old_b]) - 1
                slots[hit[0]] = slots[last]
                slots[last] = -1
                if index.quant == "pq":
                    # the compaction moved the LAST member into the
                    # vacated slot — its PQ code moves with it
                    index.pq_codes_np[old_b, hit[0]] = (
                        index.pq_codes_np[old_b, last])
                index.counts[old_b] = last
                changed_buckets.add(old_b)
        index.members_np[new_b, int(index.counts[new_b])] = row
        index.counts[new_b] += 1
        index.assign[row] = new_b
        changed_buckets.add(new_b)
        note_radius(new_b, pos)
    if changed_buckets:
        buckets = np.asarray(sorted(changed_buckets), np.int64)
        index.members = _set_rows(index.members, buckets,
                                  index.members_np[buckets])
        if index.quant == "pq":
            index.pq_codes = _set_rows(index.pq_codes, buckets,
                                       index.pq_codes_np[buckets])
    if changed_cmax:
        bids = np.asarray(sorted(changed_cmax), np.int64)
        vals = np.asarray([changed_cmax[int(b)] for b in bids],
                          np.float32)
        index.cmax = _set_rows(index.cmax, bids, vals)
        if index.cmax_np is not None:
            index.cmax_np[bids] = vals
    if changed_crad:
        bids = np.asarray(sorted(changed_crad), np.int64)
        vals = np.asarray([changed_crad[int(b)] for b in bids], np.float32)
        dev = index.crad_cos.device
        bt = torch.from_numpy(bids).to(dev)
        cos = index.crad_cos.clone()
        cos[bt] = torch.minimum(cos[bt], torch.from_numpy(vals).to(dev))
        cos_b = cos[bt]
        sin = index.crad_sin.clone()
        sin[bt] = torch.sqrt(torch.clamp(1.0 - cos_b * cos_b, min=0.0))
        index.crad_cos, index.crad_sin = cos, sin
        if index.crad_cos_np is not None:
            index.crad_cos_np[bids] = np.minimum(
                index.crad_cos_np[bids], vals)
            index.crad_sin_np[bids] = np.sqrt(np.maximum(
                1.0 - index.crad_cos_np[bids] ** 2, 0.0))


def publish_rows(
    table: Any,
    vecs: np.ndarray,               # [T, K] fresh f32 vectors
    rows: Optional[Sequence[int]] = None,   # per-vec base row, -1 = new
) -> Optional[np.ndarray]:
    """Speed-overlay publish seam: fold-in vectors enter serving NOW.

    Known rows (``rows[i] >= 0``) are re-quantized and recorded in the
    exact tail (the published solve, not the stale base row, is what the
    merged result scores). New keys get virtual ids (``>= capacity``) in
    the tail only; the next rebuild folds them out. Returns the assigned
    global/virtual ids, or None when no index is registered for
    ``table``."""
    index = index_for(table)
    if index is None:
        return None
    vecs = _host(vecs)
    if vecs.ndim == 1:
        vecs = vecs[None, :]
    if rows is None:
        rows_arr = np.full(len(vecs), -1, np.int64)
    else:
        rows_arr = np.asarray(rows, np.int64).ravel()
    known = np.nonzero((rows_arr >= 0)
                       & (rows_arr < index.n_items))[0]
    if len(known):
        _requantize_rows(index, rows_arr[known], vecs[known])
    out_ids = np.empty(len(vecs), np.int64)
    known_set = set(known.tolist())
    while True:
        with index._lock:
            successor = index._superseded
            if successor is None:
                for pos in range(len(vecs)):
                    if pos in known_set:
                        gid = int(rows_arr[pos])
                    else:
                        gid = index._next_virtual
                        index._next_virtual += 1
                    index._tail[gid] = vecs[pos]
                    index._tail_seq += 1
                    index._tail_seqs[gid] = index._tail_seq
                    out_ids[pos] = gid
                index._tail_pack = None
                index.churn_rows += len(vecs)
        if successor is None:
            break
        # a daemon swap raced this publish: record the entries on the
        # successor (the swap's carry-over only covers entries that
        # existed under the OLD lock)
        index = successor
    index.built_at = _now()
    return out_ids


# ---------------------------------------------------------------------------
# background rebuild (ops/mips_daemon.py drives this off-path)
# ---------------------------------------------------------------------------

def _tier_mode() -> str:
    """off | auto | on: host-tiering of cold buckets at rebuild time.
    ``auto`` (default) demotes only with enough probe-hit samples;
    ``on`` trusts whatever counters exist."""
    m = os.environ.get("PIO_MIPS_TIER", "auto").strip().lower()
    return m if m in ("off", "auto", "on") else "auto"


def _tier_min_samples() -> int:
    return _env_int("PIO_MIPS_TIER_MIN_SAMPLES", 32)


def _tier_max_frac() -> float:
    try:
        return min(max(float(os.environ.get(
            "PIO_MIPS_TIER_MAX_FRAC", "") or 0.5), 0.0), 0.9)
    except ValueError:
        return 0.5


def _build_cold(vecs: np.ndarray, ids: np.ndarray, seed: int,
                device: torch.device) -> ColdTier:
    """Cluster the demoted rows into their own host mini-index (same
    probe-bound geometry as the device index; fitted on ``device``, kept
    as numpy arrays)."""
    n = len(ids)
    cc = min(max(_next_pow2(int(np.sqrt(max(n, 1)))), 16), 1024)
    vt = _f32(vecs, device)
    cent_t = _spherical_kmeans(vt, cc, seed + 31)
    assign = _argmax_chunked(vt, cent_t).to(torch.int32).cpu().numpy()
    cmax, crad_cos, crad_sin = _probe_geometry(vt, assign, cent_t, cc)
    cent = cent_t.cpu().numpy()
    del vt
    member_ids = []
    member_vecs = []
    for b in range(cc):
        sel = assign == b
        member_ids.append(ids[sel].astype(np.int64))
        member_vecs.append(vecs[sel].astype(np.float32))
    return ColdTier(
        centroids=cent, cmax=cmax, crad_cos=crad_cos, crad_sin=crad_sin,
        member_ids=member_ids, member_vecs=member_vecs, rows=n,
        hits=np.zeros(cc, np.int64))


def rebuild_index(table: Any, *, trigger: str = "manual",
                  probe_recall: bool = False) -> Optional[MIPSIndex]:
    """Background rebuild-and-swap (the rebuild daemon's workhorse).

    Off the serving path it: (1) snapshots the exact tail under a
    sequence watermark, (2) re-clusters the catalogue WITH the
    virtual-id tail folded into a dense **ext block** at its existing
    ids, (3) decides bucket tiering from the probe-hit window, then (4)
    atomically replaces the registry entry once the new tensors are
    written on the device. Entries published after the watermark are
    carried into the successor's tail under the OLD index's lock, and a
    publisher that raced the swap re-routes via ``_superseded``. The old
    index object keeps serving in-flight queries on its own tensors."""
    _check_unsharded(table)
    old = index_for(table)
    if old is None:
        return None
    t0 = time.perf_counter()
    dev = table.device
    rank = int(table.shape[1])
    n_items = old.n_items
    cap_rows = old.capacity
    with old._lock:
        watermark = old._tail_seq
        tail_snap = {g: np.asarray(v, np.float32)
                     for g, v in old._tail.items()}
        next_virtual = old._next_virtual

    # -- assemble the full servable row set -------------------------------
    vf = _host(table[:n_items]).copy()
    for gid, vec in tail_snap.items():
        if gid < n_items:
            # known-row override: cluster/encode the PUBLISHED solve
            vf[gid] = vec
    n_ext = max(int(next_virtual) - cap_rows, 0)
    ext_np = np.zeros((n_ext, rank), np.float32)
    have = np.zeros(n_ext, bool)
    if old.ext_np is not None and old.n_ext:
        ext_np[:old.n_ext] = old.ext_np[:old.n_ext]
        have[:old.n_ext] = True
    for gid, vec in tail_snap.items():
        j = gid - cap_rows
        if 0 <= j < n_ext:
            ext_np[j] = vec
            have[j] = True
    ext_ids = cap_rows + np.nonzero(have)[0].astype(np.int64)
    ids_all = np.concatenate(
        [np.arange(n_items, dtype=np.int64), ext_ids])
    rows_all = (np.concatenate([vf, ext_np[have]])
                if len(ext_ids) else vf)

    # -- tier decision from the probe-hit window --------------------------
    cold_mask = np.zeros(len(ids_all), bool)
    tier = _tier_mode()
    enough = (tier == "on"
              or old._probe_samples >= _tier_min_samples())
    if tier != "off" and enough and n_items > 2:
        bucket_cold = old.probe_hits <= 0
        # demotion: rows whose device bucket drew no probes over the
        # window; promotion: rows whose COLD bucket drew probes come back
        row_cold = np.zeros(len(ids_all), bool)
        real = ids_all < n_items
        a_old = np.full(len(ids_all), -1, np.int64)
        in_assign = ids_all[real] < len(old.assign)
        a_idx = ids_all[real][in_assign]
        a_old_real = np.full(int(real.sum()), -1, np.int64)
        a_old_real[in_assign] = old.assign[a_idx]
        a_old[real] = a_old_real
        valid = a_old >= 0
        row_cold[valid] = bucket_cold[a_old[valid]]
        if old.cold is not None:
            still_cold = set()
            for cb in np.nonzero(old.cold.hits <= 0)[0]:
                still_cold.update(
                    int(g) for g in old.cold.member_ids[int(cb)])
            if still_cold:
                row_cold |= np.isin(
                    ids_all, np.fromiter(still_cold, np.int64,
                                         len(still_cold)))
        # published overrides and ext rows are fresh by definition
        fresh = np.fromiter(tail_snap, np.int64, len(tail_snap))
        if len(fresh):
            row_cold &= ~np.isin(ids_all, fresh)
        max_cold = int(_tier_max_frac() * len(ids_all))
        if row_cold.sum() > max_cold:
            keep_hot = np.nonzero(row_cold)[0][max_cold:]
            row_cold[keep_hot] = False
        if row_cold.sum() >= 8:        # below that tiering is noise
            cold_mask = row_cold

    hot_ids = ids_all[~cold_mask]
    hot_vecs = np.ascontiguousarray(rows_all[~cold_mask])
    n_hot = len(hot_ids)

    # -- re-cluster the hot set on the table's device ---------------------
    seed = old.seed + old.rebuilds
    c_local = default_centroids(max(n_hot, 1))
    hot_t = _f32(hot_vecs, dev)
    cent_t = _spherical_kmeans(hot_t, c_local, seed)
    cap = _cap_for(n_hot, c_local)
    a_hot = _balanced_assign(hot_t, cent_t, cap)
    members_np, counts = _pack_members(a_hot, hot_ids, c_local, cap)
    cmax, crad_cos, crad_sin = _probe_geometry(hot_t, a_hot, cent_t,
                                               c_local)
    cent = cent_t.cpu().numpy()

    # assign is indexed by GLOBAL id (update/publish splices): sized over
    # the whole id space, -1 for pad/cold/tail-only rows
    e_pad = _next_pow2(max(n_ext, 8))
    assign = np.full(cap_rows + e_pad, -1, np.int32)
    assign[hot_ids] = a_hot

    # -- quantized views over the extended id space -----------------------
    quant = _quant_mode()
    pq_m = 0
    pq_codes_np = np.zeros((1, 1, 1), np.uint8)
    pq_books_np = np.zeros((1, _PQ_CODEBOOK, 1), np.float32)
    codes = torch.zeros((1, rank), dtype=torch.int8, device=dev)
    scales = torch.zeros(1, dtype=torch.float32, device=dev)
    bf16_view = torch.zeros((1, rank), dtype=torch.bfloat16, device=dev)
    hot_idx = torch.from_numpy(hot_ids).to(dev)
    if quant == "pq":
        pq_m = _pq_m(rank)
        res = hot_t - cent_t[torch.from_numpy(a_hot.astype(np.int64)).to(
            dev)]
        pq_books_np = _pq_train_books(res, pq_m, seed)
        pq_codes_np = _pq_pack(a_hot, _pq_encode(res, pq_books_np),
                               c_local, cap)
        del res
    elif quant == "bf16":
        bf16_view = torch.zeros((cap_rows + e_pad, rank),
                                dtype=torch.bfloat16, device=dev)
        bf16_view[hot_idx] = hot_t.to(torch.bfloat16)
    else:
        codes = torch.zeros((cap_rows + e_pad, rank), dtype=torch.int8,
                            device=dev)
        scales = torch.zeros(cap_rows + e_pad, dtype=torch.float32,
                             device=dev)
        codes[hot_idx], scales[hot_idx] = _quantize_int8(hot_t)
    del hot_t

    cold_tier = None
    if cold_mask.any():
        cold_tier = _build_cold(
            np.ascontiguousarray(rows_all[cold_mask]),
            ids_all[cold_mask], seed, dev)

    ext_dev = None
    ext_full = None
    if n_ext:
        ext_full = np.zeros((e_pad, rank), np.float32)
        ext_full[:n_ext] = ext_np
        ext_dev = _to_dev(ext_full, dev)

    new = MIPSIndex(
        codes=codes, scales=scales, bf16=bf16_view,
        centroids=_to_dev(cent, dev),
        cmax=_to_dev(cmax, dev), crad_cos=_to_dev(crad_cos, dev),
        crad_sin=_to_dev(crad_sin, dev), members=_to_dev(members_np, dev),
        assign=assign, members_np=members_np, centroids_np=cent,
        counts=counts, n_items=n_items, n_shards=1, c_local=c_local,
        cap=cap, rank=rank, seed=old.seed, quant=quant,
        rebuilds=old.rebuilds + 1, delta_updates=old.delta_updates,
        pq_codes=_to_dev(pq_codes_np, dev),
        pq_books=_to_dev(pq_books_np, dev),
        pq_codes_np=pq_codes_np, pq_books_np=pq_books_np, pq_m=pq_m,
        ext=ext_dev, ext_np=ext_full, n_ext=n_ext,
        capacity_rows=cap_rows, cold=cold_tier, engine=old.engine,
        cmax_np=cmax.copy(), crad_cos_np=crad_cos.copy(),
        crad_sin_np=crad_sin.copy(),
    )

    # one query through the new index BEFORE the swap: a fault raises
    # here, with the old index still serving, not on a served query
    if n_items > 1:
        mips_score_and_top_k(vf[0], table, new, min(10, n_items - 1))
    # every tensor of the successor written before another thread sees it
    _sync(dev)

    # -- the atomic swap --------------------------------------------------
    with old._lock:
        new._next_virtual = old._next_virtual
        for gid, vec in old._tail.items():
            if gid < n_items or old._tail_seqs.get(gid, 0) > watermark:
                # known-row overrides stay; virtual entries published
                # after the watermark carry over
                new._tail[gid] = np.asarray(vec, np.float32)
                new._tail_seq += 1
                new._tail_seqs[gid] = new._tail_seq
        new._tail_pack = None
        old._superseded = new
        register_index(table, new)
    _REBUILDS.labels(trigger=trigger).inc()
    if probe_recall:
        recall_probe(table, new, host_factors=vf)
    logger.info(
        "mips index rebuilt (%s): %d items + %d ext, %d centroids "
        "(cap %d), %d cold rows, folded %d tail entries in %.2fs",
        trigger, n_items, n_ext, c_local, cap,
        cold_tier.rows if cold_tier else 0,
        sum(1 for g in tail_snap if g >= cap_rows),
        time.perf_counter() - t0)
    return new


# ---------------------------------------------------------------------------
# the two-stage device stages (PyTorch tensor ops on the table's device)
# ---------------------------------------------------------------------------

_LOW32 = 0xFFFFFFFF


def _topk_desc(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """(values, positions) of the ``k`` largest entries of each row of
    ``x`` [B, n] f32, descending, ties to the LOWEST position — the rule
    of ``lax.top_k``, which ``torch.topk`` does not promise. Each entry
    becomes a unique int64 key (its order-preserving f32 bits above the
    complement of its position), so the top-k of the keys is fully
    determined, on the CPU and on CUDA alike."""
    n = x.shape[-1]
    k = min(int(k), n)
    bits = (x + 0.0).view(torch.int32)      # +0.0: -0.0 ranks as 0.0
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    low = _LOW32 - torch.arange(n, device=x.device, dtype=torch.int64)
    keys = ordered.to(torch.int64) * (1 << 32) + low
    top, _ = torch.topk(keys, k, dim=-1, sorted=True)
    pos = _LOW32 - (top & _LOW32)
    return x.gather(-1, pos), pos


def _rows_dot(rows: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """[B, n] f32: row ``n`` of query ``b``'s gathered block ``rows``
    [B, n, K] dotted with the query ``uv`` [B, K] — one batched matmul
    (the JAX package's ``einsum("bnk,bk->bn")``). int8 and bf16 rows are
    widened to f32 first."""
    return torch.bmm(rows.to(torch.float32), uv[:, :, None])[:, :, 0]


def _probe_bound(uv, centroids, cmax, crad_cos, crad_sin):
    """([B, C] upper bound, [B, C] raw centroid scores). The bound is
    cmax·|q|·cos(θ_qc − r) with r the bucket's ball radius — valid for
    every member, including spilled/off-centroid rows. The raw q·c scores
    ride along because the PQ path reuses them as the exact centroid part
    of its residual decomposition."""
    s = uv @ centroids.T
    qn2 = (uv * uv).sum(dim=1, keepdim=True)
    ortho = torch.sqrt(torch.clamp(qn2 - s * s, min=0.0))
    return (cmax[None, :] * (s * crad_cos[None, :]
                             + ortho * crad_sin[None, :]), s)


def _pq_coarse(uv, s, probe, pq_codes, pq_books):
    """[B, P, cap] asymmetric PQ scores for the probed buckets' member
    slots: q·v ≈ q·c_b (exact, from the probe stage's raw centroid
    scores) + Σ_m LUT[m, code_m] with LUT = q_sub·codebook."""
    B = uv.shape[0]
    m, cb, d = pq_books.shape
    base = s.gather(1, probe)                              # [B, P]
    # [M, B, d] × [M, d, 256] → [B, M·256]
    lut = torch.bmm(uv.reshape(B, m, d).transpose(0, 1),
                    pq_books.transpose(1, 2)).transpose(0, 1).reshape(
                        B, m * cb)
    codes_g = pq_codes[probe].to(torch.int64)              # [B,P,cap,M]
    # codes are < 256 by construction: the flat LUT index stays in range
    flat = codes_g + torch.arange(m, device=uv.device) * cb
    res = lut.gather(1, flat.reshape(B, -1)).reshape(codes_g.shape).sum(-1)
    return base[:, :, None] + res


def _coarse_cut(coarse, cand, n_cand):
    """Top-``n_cand`` coarse survivors (ids)."""
    n_cand = min(n_cand, cand.shape[1])
    _, pos = _topk_desc(coarse, n_cand)
    return cand.gather(1, pos)


def _exact_rerank(uv, rows_g, table, exclude, k, ext=None, ext_base=0):
    """Exact f32 rerank of the candidate slice → ([B, kk] scores,
    [B, kk] GLOBAL ids). ``ext`` (daemon-rebuilt indexes) holds the
    folded virtual-id rows at ids ``>= ext_base``; those never exist in
    ``table``, so the rerank gathers them from the ext block. Every
    gather index is clamped first (the -1 slots and the ext ids)."""
    rows = rows_g.to(torch.int64)
    last = table.shape[0] - 1
    if ext is not None:
        in_ext = rows >= ext_base
        tab_v = table[torch.where(in_ext, 0, rows.clamp(0, last))]
        ext_v = ext[(rows - ext_base).clamp(0, ext.shape[0] - 1)]
        vecs = torch.where(in_ext[:, :, None], ext_v, tab_v.float())
    else:
        vecs = table[rows.clamp(0, last)].float()
    exact = _rows_dot(vecs, uv)
    exact = exact.masked_fill(rows < 0, NEG_INF)
    if exclude is not None:
        hit = torch.isin(rows, exclude.to(device=rows.device,
                                          dtype=torch.int64))
        exact = exact.masked_fill(hit, NEG_INF)
    kk = min(k, rows.shape[1])
    top_s, pos2 = _topk_desc(exact, kk)
    return top_s, rows_g.gather(1, pos2)


#: bound on the coarse stage's transient per dispatch (the gathered
#: quantized rows, their f32 view and the gather indices): the query rows
#: of one dispatch are split into pow2 chunks that keep it under this
#: figure, in the spirit of the host build's ~256 MB score blocks. At
#: 1,048,576 items × rank 64 (C 1,024, cap 1,280, nprobe 64: 81,920
#: slots) a row's int8 transient is ~26 MB, so a chunk holds 8 rows.
COARSE_TRANSIENT_BYTES = 256 << 20

#: widest dispatch in rows, whatever the budget allows
MIPS_BATCH_CHUNK = 128


def _chunk_rows(index: MIPSIndex, nprobe: int) -> int:
    """Query rows per coarse dispatch: the largest power of two whose
    transient stays under :data:`COARSE_TRANSIENT_BYTES`."""
    slots = nprobe * index.cap
    if index.quant == "pq":
        # uint8 and int64 codes, the flat int64 index, the f32 LUT values
        per_row = slots * max(index.pq_m, 1) * (1 + 8 + 8 + 4)
    else:
        # int64 ids, the gathered int8/bf16 rows, their f32 product,
        # scales
        item = 1 if index.quant == "int8" else 2
        per_row = slots * (8 + index.rank * (item + 4) + 4)
    rows = max(COARSE_TRANSIENT_BYTES // max(per_row, 1), 1)
    return min(1 << (int(rows).bit_length() - 1), MIPS_BATCH_CHUNK)


#: distinct two-stage dispatch shapes run by this process: the
#: counterpart of the reference's count of compiled two-stage variants
_SHAPES: set = set()
_SHAPES_LOCK = threading.Lock()


def mips_compile_cache_size() -> int:
    """Distinct two-stage shapes dispatched — summed into
    ``ops.topk.serve_compile_cache_size``, so the scheduler's bounded-
    shape contract covers the MIPS path too."""
    with _SHAPES_LOCK:
        return len(_SHAPES)


class _Views(NamedTuple):
    """The device tensors of one index version, read once per dispatch."""
    quant: str
    centroids: torch.Tensor
    cmax: torch.Tensor
    crad_cos: torch.Tensor
    crad_sin: torch.Tensor
    members: torch.Tensor
    codes: torch.Tensor
    scales: torch.Tensor
    bf16: torch.Tensor
    pq_codes: torch.Tensor
    pq_books: torch.Tensor
    ext: Optional[torch.Tensor]
    ext_base: int


def _views(index: MIPSIndex) -> _Views:
    return _Views(index.quant, index.centroids, index.cmax, index.crad_cos,
                  index.crad_sin, index.members, index.codes, index.scales,
                  index.bf16, index.pq_codes, index.pq_books, index.ext,
                  index.capacity)


def _probe_stage(u: torch.Tensor, v: _Views, nprobe: int):
    """Stage 1: the centroid scan → (probed buckets [b, P], raw centroid
    scores [b, C], candidate GLOBAL ids [b, P·cap], -1 padded)."""
    bound, s = _probe_bound(u, v.centroids, v.cmax, v.crad_cos, v.crad_sin)
    _, probe = _topk_desc(bound, nprobe)
    return probe, s, v.members[probe].reshape(u.shape[0], -1)


def _coarse_stage(u: torch.Tensor, s: torch.Tensor, probe: torch.Tensor,
                  cand: torch.Tensor, v: _Views) -> torch.Tensor:
    """Stage 2: the quantized score of every candidate slot, [b, P·cap]
    (NEG_INF on padding)."""
    if v.quant == "pq":
        coarse = _pq_coarse(u, s, probe, v.pq_codes,
                            v.pq_books).reshape(u.shape[0], -1)
    else:
        view = v.bf16 if v.quant == "bf16" else v.codes
        safe = cand.to(torch.int64).clamp(0, view.shape[0] - 1)
        coarse = _rows_dot(view[safe], u)
        if v.quant != "bf16":
            coarse = coarse * v.scales[safe]
    return coarse.masked_fill(cand < 0, NEG_INF)


def _two_stage(uv: torch.Tensor, table: torch.Tensor, index: MIPSIndex,
               k: int, exclude: Optional[torch.Tensor], nprobe: int,
               n_cand: int) -> torch.Tensor:
    """[B, K] queries → packed [2, B, kk] (scores, ids as f32): the probe,
    the coarse score of the probed buckets' slots, the coarse cut and the
    exact rerank, in row chunks of :func:`_chunk_rows`. Reads the index's
    tensors once, so a concurrent swap or splice never mixes two
    versions within one dispatch."""
    v = _views(index)
    nprobe = min(nprobe, v.centroids.shape[0])
    B = uv.shape[0]
    step = _chunk_rows(index, nprobe)
    with _SHAPES_LOCK:
        _SHAPES.add((v.quant, min(step, B), int(k), nprobe, int(n_cand),
                     tuple(v.centroids.shape), tuple(v.members.shape),
                     tuple(table.shape),
                     None if v.ext is None else tuple(v.ext.shape),
                     None if exclude is None else int(exclude.shape[-1])))
    parts = []
    for lo in range(0, B, step):
        u = uv[lo:lo + step]
        probe, s, cand = _probe_stage(u, v, nprobe)
        coarse = _coarse_stage(u, s, probe, cand, v)
        rows_g = _coarse_cut(coarse, cand, n_cand)
        top_s, top_i = _exact_rerank(u, rows_g, table, exclude, k,
                                     ext=v.ext, ext_base=v.ext_base)
        parts.append(torch.stack([top_s, top_i.to(torch.float32)]))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# serving wrappers (the ops/topk auto-routers land here)
# ---------------------------------------------------------------------------

def _quotas(index: MIPSIndex, k: int) -> Tuple[int, int, int, int]:
    """THE quota rule: (nprobe, candidate count, coarse slots, rerank
    rows) for one query at the current knobs. The wrappers dispatch these
    AND book them as scan accounting, so the measured fraction can never
    drift from the dispatched shapes."""
    nprobe = min(_nprobe_for(index), index.c_local)
    n_cand = _candidates_for(index, k)
    return nprobe, n_cand, nprobe * index.cap, n_cand


def _book_scan(index: MIPSIndex, b: int, coarse: int,
               rerank: int) -> None:
    _SCAN_CENTROID.inc(b * index.c_total)
    _SCAN_COARSE.inc(b * coarse)
    _SCAN_RERANK.inc(b * rerank)


def scan_budget(index: MIPSIndex, k: int) -> Tuple[int, int, int]:
    """(nprobe, coarse slots scanned, rerank rows) per query at the
    current knobs, from the same quota rule the dispatch uses."""
    nprobe, _n_cand, coarse, rerank = _quotas(index, k)
    return nprobe, coarse, rerank


def _pad_k(packed: torch.Tensor, k: int) -> torch.Tensor:
    """[2, ..., kk] → [2, ..., k] (NEG_INF/-1 filled) so the two-stage
    result is shape-compatible with the exhaustive contract even when the
    candidate budget is under k."""
    kk = packed.shape[-1]
    if kk >= k:
        return packed
    pad = torch.empty(packed.shape[:-1] + (k - kk,), dtype=packed.dtype,
                      device=packed.device)
    pad[0] = NEG_INF
    pad[1] = -1.0
    return torch.cat([packed, pad], dim=-1)


def _pad_k_np(packed: np.ndarray, k: int) -> np.ndarray:
    kk = packed.shape[-1]
    if kk >= k:
        return packed
    pad = np.zeros(packed.shape[:-1] + (k - kk,), np.float32)
    pad[0] = NEG_INF
    pad[1] = -1.0
    return np.concatenate([packed, pad], axis=-1)


def _merge_tail(index: MIPSIndex, packed: np.ndarray, uv_host: np.ndarray,
                k: int, exclude) -> np.ndarray:
    """Exact f32 merge of the published tail into a host [2, k] (or
    [2, B, k]) result. Tail entries OVERRIDE device rows with the same id
    (the published solve is fresher than the base row)."""
    tail = index.tail_arrays()
    packed = np.asarray(packed)
    if tail is None:
        return packed
    tids, tvecs = tail
    ex = _host_ids(exclude)
    single = packed.ndim == 2
    if single:
        packed = packed[:, None, :]
        uv_host = np.asarray(uv_host, np.float32)[None, :]
    tscores = uv_host @ tvecs.T                      # [B, T]
    out = np.empty((2, packed.shape[1], k), np.float32)
    for b in range(packed.shape[1]):
        dev_s = packed[0, b]
        dev_i = packed[1, b].astype(np.int64)
        keep = ~np.isin(dev_i, tids)
        ts, ti = tscores[b], tids
        if ex is not None:
            tkeep = ~np.isin(ti, ex)
            ts, ti = ts[tkeep], ti[tkeep]
        all_s = np.concatenate([dev_s[keep], ts])
        all_i = np.concatenate([dev_i[keep], ti])
        order = np.argsort(-all_s, kind="stable")[:k]
        ns = len(order)
        out[0, b, :ns] = all_s[order]
        out[1, b, :ns] = all_i[order].astype(np.float32)
        if ns < k:
            out[0, b, ns:] = NEG_INF
            out[1, b, ns:] = -1.0
    return out[:, 0, :] if single else out


def merge_published_fallback(table: Any, packed: torch.Tensor, uv_host_fn,
                             k: int,
                             exclude: Optional[Any] = None) -> torch.Tensor:
    """Exhaustive-fallback parity seam (ops/topk.py): a query routed
    AROUND the two-stage path — oversized exclusion list, top-everything
    k, serving mode off — must still see overlay-published rows, which
    live only in the index's exact tail. No-op without a registered index
    or with an empty tail; ``uv_host_fn`` is only called when there is
    something to merge. Returns a tensor on ``packed``'s device."""
    index = index_for(table)
    if index is None or index.tail_size() == 0:
        return packed
    out = _merge_tail(index, packed.cpu().numpy(),
                      np.asarray(uv_host_fn(), np.float32), k, exclude)
    return torch.from_numpy(np.ascontiguousarray(out)).to(packed.device)


#: probe-hit sampling period: every Nth dispatch recomputes the probe
#: bound on the host to credit the probed buckets' hit counters (the
#: tiering daemon's demotion signal)
_PROBE_SAMPLE_EVERY = 8


def _host_probe_bound(uv: np.ndarray, centroids: np.ndarray,
                      cmax: np.ndarray, crad_cos: np.ndarray,
                      crad_sin: np.ndarray) -> np.ndarray:
    """numpy mirror of :func:`_probe_bound` → [B, C] bound."""
    s = uv @ centroids.T
    qn2 = np.sum(uv * uv, axis=1, keepdims=True)
    ortho = np.sqrt(np.maximum(qn2 - s * s, 0.0))
    return cmax[None, :] * (s * crad_cos[None, :]
                            + ortho * crad_sin[None, :])


def _top_buckets(bound: np.ndarray, nprobe: int) -> np.ndarray:
    """[B, P] host top-nprobe bucket ids per query."""
    nprobe = min(nprobe, bound.shape[1])
    if nprobe >= bound.shape[1]:
        return np.tile(np.arange(bound.shape[1]), (len(bound), 1))
    return np.argpartition(-bound, nprobe - 1, axis=1)[:, :nprobe]


def _stable_top(scores: np.ndarray, k: int) -> np.ndarray:
    """``np.argsort(-scores, kind="stable")[:k]``, the same positions in
    the same order, without sorting the whole row: the entries above the
    k-th largest score and the first-placed of those equal to it, ranked
    by score, ties by position. A cold-tier merge ranks tens of thousands
    of scores a query, where the full sort dominated the dispatch."""
    n = len(scores)
    if n <= k or np.isnan(scores).any():
        return np.argsort(-scores, kind="stable")[:k]
    kth = np.partition(scores, n - k)[n - k]
    above = np.flatnonzero(scores > kth)
    at = np.flatnonzero(scores == kth)[:k - len(above)]
    pick = np.concatenate([above, at])
    return pick[np.lexsort((pick, -scores[pick]))]


def _merge_cold(index: MIPSIndex, packed: np.ndarray,
                uv_host: np.ndarray, k: int, exclude,
                nprobe: int) -> np.ndarray:
    """Exact host-side serve of the probed COLD buckets, merged into the
    device result like the tail."""
    cold = index.cold
    single = packed.ndim == 2
    if single:
        packed = packed[:, None, :]
        uv_host = np.asarray(uv_host, np.float32)[None, :]
    ex = _host_ids(exclude)
    bound = _host_probe_bound(uv_host, cold.centroids, cold.cmax,
                              cold.crad_cos, cold.crad_sin)
    top = _top_buckets(bound, min(nprobe, len(cold.cmax)))
    np.add.at(cold.hits, top.ravel(), 1)
    out = np.empty((2, packed.shape[1], k), np.float32)
    for b in range(packed.shape[1]):
        ids_l: List[np.ndarray] = [packed[1, b].astype(np.int64)]
        sc_l: List[np.ndarray] = [packed[0, b].astype(np.float32)]
        for cb in top[b]:
            cids = cold.member_ids[int(cb)]
            if not len(cids):
                continue
            sc = cold.member_vecs[int(cb)] @ uv_host[b]
            if ex is not None:
                keep = ~np.isin(cids, ex)
                cids, sc = cids[keep], sc[keep]
            ids_l.append(cids)
            sc_l.append(sc.astype(np.float32))
        all_i = np.concatenate(ids_l)
        all_s = np.concatenate(sc_l)
        order = _stable_top(all_s, k)
        ns = len(order)
        out[0, b, :ns] = all_s[order]
        out[1, b, :ns] = all_i[order].astype(np.float32)
        if ns < k:
            out[0, b, ns:] = NEG_INF
            out[1, b, ns:] = -1.0
    return out[:, 0, :] if single else out


def _host_stage(index: MIPSIndex, packed: torch.Tensor, uv_host_fn, k: int,
                exclude, nprobe: int) -> torch.Tensor:
    """Post-device host work shared by the serving wrappers: probe-hit
    sampling (demotion signal), the cold-tier exact merge, then the
    exact-tail merge (tail last, so a republished id always serves its
    freshest vector). ``uv_host_fn`` defers the query fetch: the common
    no-tail/no-cold steady state pays nothing and the device result goes
    back as it is."""
    packed = _pad_k(packed, k)
    index._dispatches += 1
    cold = index.cold
    tail = index.tail_size()
    sample = (index._dispatches % _PROBE_SAMPLE_EVERY == 0
              and index.cmax_np is not None)
    uv_host = None
    if cold is not None or sample or tail:
        uv_host = np.asarray(uv_host_fn(), np.float32)
    if sample and uv_host is not None:
        uv2 = uv_host if uv_host.ndim == 2 else uv_host[None, :]
        bound = _host_probe_bound(uv2, index.centroids_np,
                                  index.cmax_np, index.crad_cos_np,
                                  index.crad_sin_np)
        np.add.at(index.probe_hits,
                  _top_buckets(bound, nprobe).ravel(), 1)
        index._probe_samples += 1
    if cold is None and not tail:
        return packed
    out = packed.cpu().numpy()
    if cold is not None:
        out = _merge_cold(index, out, uv_host, k, exclude, nprobe)
    if index.tail_size():
        out = _merge_tail(index, _pad_k_np(out, k), uv_host, k, exclude)
    out = np.ascontiguousarray(_pad_k_np(out, k), dtype=np.float32)
    return torch.from_numpy(out).to(packed.device)


def _queries(x: Any, table: torch.Tensor) -> torch.Tensor:
    """Query rows as f32 on the table's device."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x, np.float32))
    return t.to(device=table.device, dtype=torch.float32)


def mips_score_and_top_k(
    user_vector: Any,           # [K]
    table: torch.Tensor,        # [I_pad, K]
    index: MIPSIndex,
    k: int,
    exclude: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Two-stage twin of ``ops.topk.score_and_top_k`` → packed [2, k]
    on the table's device."""
    nprobe, n_cand, coarse, rerank = _quotas(index, k)
    _pt0 = _profile.t0()
    uv = _queries(user_vector, table).reshape(1, -1)
    packed = _two_stage(uv, table, index, k, exclude, nprobe,
                        n_cand)[:, 0, :]
    _profile.record(_pt0, "serve", "serve_topk_mips",
                    2.0 * (index.c_total + coarse + rerank) * index.rank,
                    packed)
    _book_scan(index, 1, coarse, rerank)
    return _host_stage(index, packed, lambda: _host(uv[0]), k, exclude,
                       nprobe)


def mips_score_user_and_top_k(
    user_factors: torch.Tensor,
    table: torch.Tensor,
    index: MIPSIndex,
    user_idx: int,
    k: int,
    exclude: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Two-stage twin of ``ops.topk.score_user_and_top_k`` → packed
    [2, k] on the table's device."""
    nprobe, n_cand, coarse, rerank = _quotas(index, k)
    _pt0 = _profile.t0()
    uv = _queries(user_factors[int(user_idx)], table).reshape(1, -1)
    packed = _two_stage(uv, table, index, k, exclude, nprobe,
                        n_cand)[:, 0, :]
    _profile.record(_pt0, "serve", "serve_topk_mips",
                    2.0 * (index.c_total + coarse + rerank) * index.rank,
                    packed)
    _book_scan(index, 1, coarse, rerank)
    return _host_stage(index, packed, lambda: _host(uv[0]), k, exclude,
                       nprobe)


def mips_batch_score_top_k(
    user_factors: torch.Tensor,
    table: torch.Tensor,
    index: MIPSIndex,
    rows: Any,                  # [B] int array (already pow2-padded)
    k: int,
) -> torch.Tensor:
    """Two-stage twin of ``ops.topk.batch_score_top_k`` → [2, B, k] on
    the table's device."""
    nprobe, n_cand, coarse, rerank = _quotas(index, k)
    rows_np = np.asarray(rows, np.int64).ravel()
    _pt0 = _profile.t0()
    idx = torch.from_numpy(rows_np).to(user_factors.device)
    uv = _queries(user_factors.index_select(0, idx), table)
    packed = _two_stage(uv, table, index, k, None, nprobe, n_cand)
    _profile.record(_pt0, "serve", "serve_topk_mips_batch",
                    2.0 * len(rows_np) * (index.c_total + coarse + rerank)
                    * index.rank, packed)
    _book_scan(index, len(rows_np), coarse, rerank)
    return _host_stage(index, packed, lambda: _host(uv), k, None, nprobe)


# ---------------------------------------------------------------------------
# the planted recall probe (the pio_serve_mips_recall gauge's source)
# ---------------------------------------------------------------------------

def recall_probe(
    table: Any,
    index: Optional[MIPSIndex] = None,
    *,
    host_factors: Optional[np.ndarray] = None,
    k: int = 20,
    n_queries: int = 8,
    seed: int = 0,
) -> Optional[float]:
    """Measure recall@k of the two-stage path against the exhaustive
    host oracle on mixture queries sampled from the catalogue itself,
    and publish it as ``pio_serve_mips_recall``."""
    from incubator_predictionio_tpu_torch.utils.planted import (
        exhaustive_top_k,
        planted_queries,
        recall_against_oracle,
    )

    index = index if index is not None else index_for(table)
    if index is None:
        return None
    k = min(k, max(index.n_items - 1, 1))
    vf = (np.asarray(host_factors[:index.n_items], np.float32)
          if host_factors is not None else _host(table[:index.n_items]))
    queries = planted_queries(vf, n_queries, seed=seed + 1)
    oracle = exhaustive_top_k(vf, queries, k)
    got = np.stack([
        mips_score_and_top_k(q, table, index, k)[1].cpu().numpy()
        .astype(np.int64) for q in queries
    ])
    recall, _worst = recall_against_oracle(got, oracle, k)
    _RECALL.set(recall)
    return recall
