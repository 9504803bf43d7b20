"""Continuation retrain, O(delta) steady-state training on one device: the
port of the single-device part of incubator_predictionio_tpu/ops/retrain.py.

1. **Factor continuation** (``ops/als.continue_state``): ids are interned
   in first-seen order, so the previous model's factor rows map onto the
   new index space as an exact prefix; the retrain seeds from them, with
   random rows for the new ids only.
2. **Convergence early stop** (``ops/als._als_run_converge``): a warm
   start turns into fewer sweeps only under an adaptive budget. After
   each sweep past the floor the relative factor delta is read on the
   host (one scalar) and the run stops below ``PIO_RETRAIN_TOL``; with
   ``PIO_RETRAIN_FUSED=0`` the sweeps run in chunks of
   ``PIO_RETRAIN_PROBE_EVERY`` and the delta is read once a chunk, so
   ``sweeps_used`` is the JAX package's under either setting.
3. **Prep/plan reuse** (:class:`PrepPlan`): the degree histograms and
   the padded bucket plan stay in the process, keyed on the caller's plan
   key and a digest of the COO prefix. When only a tail was appended,
   rows whose width class is unchanged get the new entries in their
   padding slots (host mirror and device trees, in place, with
   ``index_put_``), and only rows that changed class (or appeared) are
   rebuilt into small appended buckets.

Under ``PIO_PROFILE=1`` a retrain that ran sweeps books one dispatch
(obs/profile.py), as in the JAX package (retrain.py:1248-1320):
``als_fused`` on the kernel entries, ``als_retrain`` on the plain route,
at ``als.train_flops`` over the sweeps actually run.

Correctness never depends on the reuse: whatever the plan cannot prove
equivalent (a prefix digest mismatch, as when the preparator's
latest-wins dedup moved a re-rated pair; split rows; a row outgrowing
``max_width``; another device) falls back to the fresh build, which is
the buckets of a cold train.

What the JAX module has and this one has not: the mesh-sharded plans and
the ring layout (``_RingPlan``, ``_als_retrain_placed``; ROADMAP Queue 1
item 9); two parameters that no caller of the JAX package passes, so
there is nothing to port: ``verify_prefix=False`` (the digest skip) and
``prepare_with_reuse``'s ``user_degrees``/``item_degrees`` (the cpplog
scan's prep-plan sidecar degrees reach no training path there); and what
exists only to serve XLA dispatches: ``_pad_pow2`` (bounded jit shapes), the
deferred splice fused into the training dispatch
(``pending_splices``, ``commit_spliced_trees``) and its pins
``train_dispatches`` / ``one_dispatch``. Here the splice is applied to
the device trees before the sweeps, and an exception between the host
mirror's update and the device trees drops the plan.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from incubator_predictionio_tpu_torch.obs import profile as _profile
from incubator_predictionio_tpu_torch.ops import als
from incubator_predictionio_tpu_torch.ops.sparse import (
    PaddedRows,
    build_both_sides,
    build_padded_rows,
)
from incubator_predictionio_tpu_torch.runtime import default_device

logger = logging.getLogger(__name__)


def continue_enabled() -> bool:
    """``PIO_RETRAIN_CONTINUE`` (default on), read per call."""
    return os.environ.get("PIO_RETRAIN_CONTINUE", "1") not in (
        "0", "off", "false")


def retrain_tol() -> float:
    """``PIO_RETRAIN_TOL``: the early stop's relative factor delta per
    sweep (0: the fixed budget). The default 2e-2 is the JAX package's
    (retrain.py:69-81): a warm continuation's delta falls under it within
    a few sweeps, a fresh run's stays above it."""
    return float(os.environ.get("PIO_RETRAIN_TOL", "2e-2"))


def retrain_min_sweeps() -> int:
    return max(int(os.environ.get("PIO_RETRAIN_MIN_SWEEPS", "1")), 1)


def retrain_probe_every() -> int:
    return max(int(os.environ.get("PIO_RETRAIN_PROBE_EVERY", "2")), 1)


def _fused_early_stop() -> bool:
    """``PIO_RETRAIN_FUSED``: 1 (default) judges the delta after every
    sweep past the floor; 0 judges it once per chunk of
    ``PIO_RETRAIN_PROBE_EVERY`` sweeps."""
    return os.environ.get("PIO_RETRAIN_FUSED", "1") not in (
        "0", "off", "false")


def plan_reuse_enabled() -> bool:
    return os.environ.get("PIO_RETRAIN_PLAN", "1") not in (
        "0", "off", "false")


# -- prep/plan reuse -------------------------------------------------------------

def _coo_digest(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                upto: int) -> bytes:
    """Digest of the first ``upto`` COO triplets, the prefix-equality
    witness (as the JAX package's: int64 rows and cols, f32 values)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(rows[:upto], np.int64).tobytes())
    h.update(np.ascontiguousarray(cols[:upto], np.int64).tobytes())
    h.update(np.ascontiguousarray(vals[:upto], np.float32).tobytes())
    return h.digest()


def _width_classes(deg: np.ndarray, min_width: int) -> np.ndarray:
    """Power-of-two bucket ceiling per row (0 for absent rows): the width
    ``ops/sparse.build_padded_rows`` gives a row of that degree."""
    d = np.maximum(deg, 1).astype(np.float64)
    w = (1 << np.ceil(np.log2(d)).astype(np.int64)).astype(np.int64)
    w = np.maximum(w, min_width)
    return np.where(deg > 0, w, 0)


def _index(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)


@dataclasses.dataclass
class _SidePlan:
    """One training orientation's bucket plan: the host mirror (the
    mutable source of truth) and the device trees, bucket for bucket."""

    n_rows: int
    degrees: np.ndarray                  # int64[n_rows]
    buckets: List[PaddedRows]            # host mirror, spliced in place
    trees: List[Tuple[Any, Any, Any, Any]]  # (row_ids, cols, vals, mask)
    row_bucket: np.ndarray               # int32[n_rows], -1 = absent
    row_pos: np.ndarray                  # int32[n_rows]
    device: torch.device
    min_width: int = 8
    #: compaction bookkeeping: cleared (moved-away) slots never shrink a
    #: bucket and every retrain may append delta buckets; past these
    #: bounds apply_tail refuses and the caller rebuilds a compact plan
    dead_rows: int = 0
    init_buckets: int = 0

    def _tree_of(self, b: PaddedRows):
        return als._buckets_tree([b], self.device)[0]

    @staticmethod
    def build(buckets: List[PaddedRows], degrees: np.ndarray, n_rows: int,
              device, min_width: int = 8) -> "_SidePlan":
        row_bucket = np.full(n_rows, -1, np.int32)
        row_pos = np.full(n_rows, -1, np.int32)
        for bi, b in enumerate(buckets):
            ids = np.asarray(b.row_ids)
            live = np.flatnonzero(ids >= 0)
            row_bucket[ids[live]] = bi
            row_pos[ids[live]] = live.astype(np.int32)
        plan = _SidePlan(
            n_rows=n_rows, degrees=np.asarray(degrees, np.int64),
            buckets=list(buckets), trees=[], row_bucket=row_bucket,
            row_pos=row_pos, device=device, min_width=min_width,
            init_buckets=len(buckets))
        plan.trees = [plan._tree_of(b) for b in buckets]
        return plan

    def _grow_to(self, n_rows: int) -> None:
        if n_rows > self.n_rows:
            pad = n_rows - self.n_rows
            self.degrees = np.concatenate(
                [self.degrees, np.zeros(pad, np.int64)])
            self.row_bucket = np.concatenate(
                [self.row_bucket, np.full(pad, -1, np.int32)])
            self.row_pos = np.concatenate(
                [self.row_pos, np.full(pad, -1, np.int32)])
            self.n_rows = n_rows

    def apply_tail(self, tail_rows, tail_cols, tail_vals, full_rows,
                   full_cols, full_vals, n_rows: int, max_width: int,
                   row_multiple: int, stats: Dict[str, Any]) -> bool:
        """Splice a tail into the resident plan; False → the caller
        rebuilds. Touched rows whose width class is unchanged keep their
        padded slot, the new entries landing in its padding (host
        fancy-index writes and the same ``index_put_`` on the device
        trees); rows that moved class (new rows included) are cleared from
        their old bucket and rebuilt from the full COO into appended
        buckets. Untouched buckets are not touched at all."""
        self._grow_to(n_rows)
        dev = self.device
        tail_deg = np.bincount(tail_rows, minlength=n_rows).astype(np.int64)
        new_deg = self.degrees + tail_deg
        if len(tail_rows) and int(new_deg.max()) > max_width:
            return False  # a row outgrew the plan: split-row territory
        touched = np.flatnonzero(tail_deg)
        old_w = _width_classes(self.degrees[touched], self.min_width)
        new_w = _width_classes(new_deg[touched], self.min_width)
        stay = touched[(old_w == new_w) & (self.degrees[touched] > 0)]
        moved = touched[(old_w != new_w) | (self.degrees[touched] == 0)]

        # compaction bound: refuse (→ a compact fresh rebuild) once dead
        # slots or appended delta buckets would dominate
        live = int((self.row_bucket >= 0).sum())
        if (self.dead_rows + len(moved) > max(live, 1) // 4
                or len(self.buckets) > 2 * self.init_buckets + 16):
            return False

        # -- stay rows: the tail's entries into their existing slots ------
        if len(stay):
            stay_lut = np.zeros(n_rows, bool)
            stay_lut[stay] = True
            sel = stay_lut[tail_rows]
            rs, cs, vs = tail_rows[sel], tail_cols[sel], tail_vals[sel]
            order = np.argsort(rs, kind="stable")  # scan order per row
            rs, cs, vs = rs[order], cs[order], vs[order]
            _uniq, first, counts = np.unique(
                rs, return_index=True, return_counts=True)
            within = np.arange(len(rs)) - np.repeat(first, counts)
            slots = (self.degrees[rs] + within).astype(np.int32)
            b_arr = self.row_bucket[rs]
            p_arr = self.row_pos[rs]
            for bi in np.unique(b_arr):
                m = b_arr == bi
                b = self.buckets[bi]
                p, s = p_arr[m], slots[m]
                b.cols[p, s] = cs[m]
                b.vals[p, s] = vs[m]
                b.mask[p, s] = 1.0
                _rids, dcols, dvals, dmask = self.trees[bi]
                jp, js = _index(p, dev), _index(s, dev)
                dcols[jp, js] = torch.from_numpy(
                    np.ascontiguousarray(cs[m], np.int32)).to(dev)
                dvals[jp, js] = torch.from_numpy(
                    np.ascontiguousarray(vs[m], np.float32)).to(dev)
                dmask[jp, js] = 1.0
            stats["prep_spliced_entries"] = stats.get(
                "prep_spliced_entries", 0) + int(len(rs))

        # -- moved rows: clear the old slots, rebuild into delta buckets --
        moved_present = moved[self.row_bucket[moved] >= 0]
        if len(moved_present):
            b_arr = self.row_bucket[moved_present]
            p_arr = self.row_pos[moved_present]
            for bi in np.unique(b_arr):
                p = p_arr[b_arr == bi]
                b = self.buckets[bi]
                b.row_ids[p] = -1
                b.cols[p, :] = 0
                b.vals[p, :] = 0.0
                b.mask[p, :] = 0.0
                rids, dcols, dvals, dmask = self.trees[bi]
                jp = _index(p, dev)
                rids[jp] = -1
                dcols[jp] = 0
                dvals[jp] = 0.0
                dmask[jp] = 0.0
            self.row_bucket[moved_present] = -1
            self.row_pos[moved_present] = -1
            self.dead_rows += int(len(moved_present))
        if len(moved):
            lut = np.zeros(n_rows, bool)
            lut[moved] = True
            sel = lut[full_rows]
            delta = build_padded_rows(
                full_rows[sel], full_cols[sel], full_vals[sel], n_rows,
                min_width=self.min_width, max_width=max_width,
                row_multiple=row_multiple)
            for b in delta:
                bi = len(self.buckets)
                self.buckets.append(b)
                self.trees.append(self._tree_of(b))
                ids = np.asarray(b.row_ids)
                live = np.flatnonzero(ids >= 0)
                self.row_bucket[ids[live]] = bi
                self.row_pos[ids[live]] = live.astype(np.int32)
            stats["prep_rebuilt_rows"] = stats.get(
                "prep_rebuilt_rows", 0) + int(len(moved))

        self.degrees = new_deg
        return True


@dataclasses.dataclass
class PrepPlan:
    """Process-resident bucket plan of one (plan_key) training stream,
    keyed on the COO prefix digest (the append-only contract of
    first-seen interning)."""

    key: str
    nnz: int
    digest: bytes
    n_users: int
    n_items: int
    max_width: int
    row_multiple: int
    device: torch.device
    user: _SidePlan
    item: _SidePlan

    def trees(self):
        """→ (u_tree, i_tree) in the ops/als sweep format."""
        return tuple(self.user.trees), tuple(self.item.trees)


#: at most this many plans stay resident (each holds the padded host
#: mirror of its dataset and its device trees)
_PLAN_CACHE_CAP = 2
_PLAN_CACHE: Dict[str, PrepPlan] = {}


def drop_plans() -> None:
    """Tests / memory pressure: forget every resident plan."""
    _PLAN_CACHE.clear()


def prepare_with_reuse(users: np.ndarray, items: np.ndarray,
                       vals: np.ndarray, n_users: int, n_items: int,
                       max_width: int = 1 << 16, row_multiple: int = 8,
                       plan_key: Optional[str] = None,
                       stats: Optional[Dict[str, Any]] = None, device=None):
    """Degree-bucketed padded trees on ``device`` (CUDA by default),
    reusing a resident plan when only a tail was appended →
    (u_tree, i_tree, u_heavy, i_heavy).

    ``plan_key`` names the training stream; None disables reuse (the
    trees of ``als.prepare_trees``). A plan is reused only where a digest
    of the COO's first ``plan.nnz`` entries still matches.
    ``stats["prep_plan"]``: "off", "miss", "reused", "invalidated" (the
    prefix, shape or device changed) or "rebuilt" (a side refused the
    splice). A plan holds no split rows: with any, the trees are built
    fresh and no plan is kept. The trees of a reused plan are its
    residents, spliced in place by the next reuse."""
    stats = {} if stats is None else stats
    dev = default_device(device)
    users = np.asarray(users)
    items = np.asarray(items)
    vals = np.asarray(vals, np.float32)
    nnz = len(vals)
    use_plan = bool(plan_key) and plan_reuse_enabled()
    plan = _PLAN_CACHE.get(plan_key) if use_plan else None
    if plan is not None:
        ok = (nnz >= plan.nnz and n_users >= plan.n_users
              and n_items >= plan.n_items and plan.max_width == max_width
              and plan.row_multiple == row_multiple and plan.device == dev
              and _coo_digest(users, items, vals, plan.nnz) == plan.digest)
        if ok:
            tr, tc, tv = users[plan.nnz:], items[plan.nnz:], vals[plan.nnz:]
            try:
                u_ok = plan.user.apply_tail(
                    tr, tc, tv, users, items, vals, n_users, max_width,
                    row_multiple, stats)
                i_ok = u_ok and plan.item.apply_tail(
                    tc, tr, tv, items, users, vals, n_items, max_width,
                    row_multiple, stats)
            except BaseException:
                # the host mirror and the device trees may disagree now
                _PLAN_CACHE.pop(plan_key, None)
                raise
            if u_ok and i_ok:
                plan.nnz = nnz
                plan.n_users, plan.n_items = n_users, n_items
                plan.digest = _coo_digest(users, items, vals, nnz)
                stats["prep_plan"] = "reused"
                stats["prep_delta_rows"] = int(len(tr))
                # the item rows whose interactions the tail touched: the
                # MIPS index's O(delta) splice reads them (ops/mips.py
                # update_index, through the engine's _refresh_mips_index)
                stats["touched_item_rows"] = np.unique(
                    np.asarray(tc, np.int64))
                u_tree, i_tree = plan.trees()
                return u_tree, i_tree, None, None
            # a side bailed mid-splice: drop the half-updated plan
            _PLAN_CACHE.pop(plan_key, None)
            stats["prep_plan"] = "rebuilt"
        else:
            _PLAN_CACHE.pop(plan_key, None)
            stats["prep_plan"] = "invalidated"
    else:
        stats.setdefault("prep_plan", "miss" if use_plan else "off")

    (u_light, u_heavy), (i_light, i_heavy) = build_both_sides(
        users, items, vals, n_users, n_items, max_width=max_width,
        row_multiple=row_multiple)
    if use_plan and u_heavy is None and i_heavy is None:
        while len(_PLAN_CACHE) >= _PLAN_CACHE_CAP:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        new_plan = PrepPlan(
            key=plan_key, nnz=nnz,
            digest=_coo_digest(users, items, vals, nnz),
            n_users=n_users, n_items=n_items, max_width=max_width,
            row_multiple=row_multiple, device=dev,
            user=_SidePlan.build(
                u_light, np.bincount(users, minlength=n_users), n_users,
                dev),
            item=_SidePlan.build(
                i_light, np.bincount(items, minlength=n_items), n_items,
                dev))
        _PLAN_CACHE[plan_key] = new_plan
        u_tree, i_tree = new_plan.trees()
        return u_tree, i_tree, None, None
    return (als._buckets_tree(u_light, dev), als._buckets_tree(i_light, dev),
            als._heavy_tree(u_heavy, dev), als._heavy_tree(i_heavy, dev))


# -- the early-stopping retrain ---------------------------------------------------

def _converge_leg(state, u_tree, i_tree, l2: float, alpha: float, tol: float,
                  budget: int, floor: int, reg_nnz: bool, compute_dtype,
                  implicit: bool, u_hv, i_hv, cg_iters: int, route_kw: dict
                  ) -> Tuple[als.ALSState, int, float]:
    """One precision leg with the early stop (retrain.py:940-1004) →
    (state, sweeps, last delta). ``PIO_RETRAIN_FUSED=1``: the delta judged
    after every sweep past ``floor`` (JAX's ``while_loop``); 0: chunks of
    ``PIO_RETRAIN_PROBE_EVERY`` sweeps, one delta read a chunk, stopping
    once ``floor`` sweeps ran and the delta fell below a positive
    ``tol``."""
    common = dict(user_heavy=u_hv, item_heavy=i_hv, cg_iters=cg_iters,
                  implicit=implicit, alpha=alpha, last_delta=True,
                  **route_kw)
    if _fused_early_stop():
        state, n, d = als._als_run_converge(
            state, u_tree, i_tree, l2, tol, budget, floor, reg_nnz,
            compute_dtype, **common)
        return state, n, float(d)
    probe = retrain_probe_every()
    done, d = 0, float("inf")
    while done < budget:
        chunk = min(probe, budget - done)
        state, _n, dd = als._als_run_converge(
            state, u_tree, i_tree, l2, 0.0, chunk, chunk, reg_nnz,
            compute_dtype, **common)
        done += chunk
        d = float(dd)  # one host read a chunk: the probe boundary
        if done >= floor and tol > 0 and d < tol:
            break
    return state, done, d


def als_retrain(users: np.ndarray, items: np.ndarray, vals: np.ndarray,
                n_users: int, n_items: int, rank: int = 64,
                iterations: int = 10, l2: float = 0.1, alpha: float = 1.0,
                seed: int = 0, reg_nnz: bool = True, implicit: bool = False,
                bf16_sweeps: int = 0, compute_dtype: Any = torch.float32,
                max_width: int = 1 << 16,
                prev_state: Optional[als.ALSState] = None,
                tol: Optional[float] = None, min_sweeps: Optional[int] = None,
                plan_key: Optional[str] = None,
                stats: Optional[Dict[str, Any]] = None, device=None,
                use_kernel: bool = True) -> als.ALSState:
    """Continuation-aware training (retrain.py:1176): warm factors, the
    early stop and plan reuse, on ``device`` (CUDA by default). With
    ``prev_state=None``, ``tol=0`` and ``plan_key=None`` it runs the fixed
    schedule of ``als_train`` (``implicit``: ``als_train_implicit``), bit
    for bit. ``use_kernel`` as ``als_train``'s.

    Schedule: a bf16 leg of up to ``bf16_sweeps`` (floor
    ``min(floor, bf16_sweeps)``), then an f32 leg of the rest (floor
    ``max(floor - sweeps so far, 1)``), each judged by
    :func:`_converge_leg`; implicit runs all in f32.

    ``stats`` receives ``sweeps_used``, ``mode`` ("fresh" or
    "continue"), ``final_delta``, ``prep_wall_s`` and the prep-reuse keys
    of :func:`prepare_with_reuse`."""
    stats = {} if stats is None else stats
    dev = default_device(device)
    tol = retrain_tol() if tol is None else float(tol)
    floor = retrain_min_sweeps() if min_sweeps is None else max(
        int(min_sweeps), 1)
    t_prep = time.perf_counter()
    u_tree, i_tree, u_hv, i_hv = prepare_with_reuse(
        users, items, vals, n_users, n_items, max_width=max_width,
        plan_key=plan_key, stats=stats, device=dev)
    stats["prep_wall_s"] = time.perf_counter() - t_prep

    state = None
    if prev_state is not None:
        state = als.continue_state(
            prev_state.user_factors, prev_state.item_factors, n_users,
            n_items, seed=seed, device=dev)
        if state is not None and state.user_factors.shape[1] != rank:
            state = None  # the rank changed: the factors are unusable
    mode = "continue" if state is not None else "fresh"
    if state is None:
        state = als.als_init(torch.Generator().manual_seed(int(seed)),
                             n_users, n_items, rank, device=dev)

    _prof_t0 = _profile.t0()
    route_kw = als._route_kw(use_kernel, 0, None)
    lo = 0 if implicit else min(max(int(bf16_sweeps), 0), int(iterations))
    sweeps, delta, bf16_used = 0, float("inf"), 0
    if lo:
        state, n, delta = _converge_leg(
            state, u_tree, i_tree, l2, 0.0, tol, lo, min(floor, lo),
            reg_nnz, torch.bfloat16, False, u_hv, i_hv,
            min(als.CG_ITERS_BF16, als.CG_ITERS), route_kw)
        sweeps += n
        bf16_used = n
    if iterations - lo > 0:
        state, n, delta = _converge_leg(
            state, u_tree, i_tree, l2, alpha, tol, iterations - lo,
            max(floor - sweeps, 1), reg_nnz, compute_dtype, implicit, u_hv,
            i_hv, als.CG_ITERS, route_kw)
        sweeps += n
    if _prof_t0 is not None and sweeps:
        # over the sweeps actually run (the early stop makes the count
        # data-dependent; nnz is in hand, so no mask sums are needed)
        _profile.record(
            _prof_t0, "train",
            "als_fused" if route_kw["use_kernel"] else "als_retrain",
            als.train_flops(len(vals), n_users, n_items, rank, sweeps,
                            bf16_used), state)
    stats.update(sweeps_used=sweeps, mode=mode, final_delta=delta)
    _book_sweeps(mode, sweeps)
    return state


def _book_sweeps(mode: str, sweeps: int) -> None:
    """``pio_train_sweeps_total{mode}``: the sweeps training ran, by mode
    ("fresh" or "continue"), on the port's metrics registry."""
    try:
        from incubator_predictionio_tpu_torch.obs import metrics

        metrics.REGISTRY.counter(
            "pio_train_sweeps_total",
            "ALS sweeps actually run by training, by schedule mode",
            labels=("mode",),
        ).labels(mode=mode).inc(sweeps)
    except Exception:  # telemetry never fails a train
        logger.exception("sweep-counter export failed")
