#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the recommendation
template (serving, ALS training through ``Engine.train``, serving the
trained model), the sequence engine (SASRec served and trained through
the flash-attention kernel), both through the event store: events in
SQLite or the native log (cpplog) → ``CoreWorkflow.run_train`` → the
checkpoint → ``load_models`` → /queries.json, and the speed layer behind
/queries.json (new events folded in on the fused ALS kernel), with the
ecommerce template's implicit fold-in.

    python3 chip_smoke.py

Phases, each of which fails the run on any error or mismatch:

1. card    — requires CUDA; prints the card's name and power limit as
             ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
             gives them; turns TF32 off.
2. build   — compiles the port's CUDA sources (``runtime.build_kernels``)
             and its native host library (``native.load``: the event log,
             the bucket builder and the body parser, ``native/src/*.cc``,
             with ``g++``).
3. kernel  — the score+top-k kernel against its plain PyTorch version on
             the card: the reference's four kernel test cases, duplicate-row
             ties, the ML-20M width (26,744 items x rank 128; B 1, 64 and
             the scheduler's rungs 128, 256 and 512) and a
             1,048,576-item rank-64 catalogue, then the edges of its design
             (:func:`topk_edge_cases`: ties either side of a tile and of a
             block's item range, threshold ties in later tiles, catalogues
             no multiple of the tile, k 1 and 128, fewer or no allowed
             items, B 1 / 3 / 8 / 9 / 64, K 8 / 10 / 64 / 128 / 256, and
             257 / 300 / 512, above which the reference pads too). Ids
             must agree except among near-ties (plain scores within 1e-5
             relative; integer-factor cases slot for slot); scores to rtol
             1e-5 and atol 1e-5 * max|score|.
4. als-kernel — every ALS kernel entry against its plain version: the
             reference tests' cases, ML-20M bucket shapes at rank 128 (the
             narrow ones, d 8-32, the R-row form's) and ranks 129-300
             (the Gram in 128 x 128 tiles), f32 and bf16,
             cold and warm, R = 1 and 8, fused implicit with YtY;
             tolerances in :func:`als_tolerance`, and the f32 systems
             with fewer observations than the rank also against an f64
             solve; then both entries' split-D edges (:func:`als_edge_phase`:
             D 1, D no multiple of a slab, ranks 10-256, fractional mask
             weights, an empty row, one slice against many on the same
             rows); then training at rank 160 and 256 through the
             kernels against the plain route
             (:func:`rank_train_phase`, ``als-rank``).
5. flash-kernel — the flash-attention kernel against its plain version
             (the blockwise online softmax) on the card: the reference
             tests' cases (causal and not, ragged validity, fully masked
             rows exactly 0, the Sq = 1 decode row), Sq != Skv, head widths
             8 to 128, the engine's windows (B 1 and 8, H 2, D 32, S 8192,
             left-padded), the JAX bench's shapes (B 1, H 8, D 64, S
             4096 / 8192 / 32768, f32 and bf16) and, in both dtypes, the
             cases of :func:`skip_cases` (dead key tiles between live ones,
             one live key at a tile's edge, rows padded 0 to 8,192, dead
             query tiles, Sq != Skv with padding, D 8 / 24 / 80 / 128),
             heads of 160 / 200 / 256 and B x H 65,536;
             :func:`flash_tolerance`. The build's ``ptxas -v`` report of
             each flash instantiation is printed (``ptxas:`` lines).
6. path    — a planted ALSModel at ML-20M width (138,493 users x 26,744
             items x rank 128), served by the port's PredictionServer: 32
             HTTP queries to /queries.json and one 64-body batch through
             ``_handle_batch``, every answer checked against the plain
             version on the same factors, and the kernel's launch count read.
    serve-load — the same model under concurrent load
             (:func:`serve_load_phase`): closed-loop keep-alive clients
             in child processes at 1, 16, 64 and 256 for 4 s each through
             the scheduler (ladder cap 512) and again with
             ``micro_batch=0``, 64 with two dispatcher threads: queries/s,
             p50 / p99 on the client's clock, the fused width
             (``pio_serve_batch_size``), queue-wait p99, the server's CPU
             per answer by thread, score+top-k launches against answers
             (fewer at 64 clients, or it fails); the shed (the
             ``serve_p99`` objective at 2 ms, 256 clients: every non-200 a
             503 with ``Retry-After``, as many as
             ``pio_serve_shed_total{reason="overload"}``); two tenants
             (weights 3 and 1, 32 clients each: 401 for a wrong and a
             missing key, the dispatched shares, the weight-1 tenant at
             least 10%). Every answer of every leg against the plain
             top-k; a query after each leg's load answered.
7. train   — 20,000,000 planted ratings at ML-20M width trained through
             ``Engine.train`` (rank 128, 4 sweeps, 2 in bf16; the buckets
             from the native builder, the latest-wins dedup on the card),
             then from the same initial state on the plain route
             (``use_kernel=False``): the fused ALS entry (both half-sweeps)
             must launch, the fit RMSE must be within the
             reference's parity bound of the plain route's and the heldout
             RMSE below 0.8. Once per run both host routes are held equal
             bit for bit and their walls printed side by side
             (:func:`host_routes`): the preparator with the dedup on the
             card and by ``np.unique``, the buckets native and numpy, and
             the two dedups on the triples with 2,000,000 repeated pairs.
8. serve-trained — the trained model behind PredictionServer, each answer
             against the plain top-k on the trained factors.
9. seq-path — a SeqRecModel at the slice's width (d_model 64, 2 heads, 2
             layers, window 8192, 26,744 items; weights from numpy and a
             seed) behind PredictionServer: 17 HTTP queries with
             ``recentItems`` histories of 1 to 8,292 items, each answer
             against the same scoring of ``transformer_apply`` with the
             plain attention (ids equal except near-ties, scores rtol
             1e-4), and ``n_layers`` kernel launches per query.
    seq-wide — the sequence engine at d_model 512 in 2 heads of 256 (a
             width the JAX engine accepts; the flash kernel's wide form),
             window 8,192, weights from numpy and a seed: 4 HTTP queries
             (full windows and a half one), each against the plain
             attention's scoring, ``n_layers`` launches a query. No
             training at this width.
10. seq-train — 64 planted sessions of 8,193 items through ``Engine.train``
             (batch 8, 1 epoch: 8 steps), then from the same initial weights
             with ``attn_fn=flash_attention_plain``: ``n_layers`` launches a
             step, each step's loss within 1e-3 relative of the plain
             route's, a falling loss; the trained model served as in
             seq-path.
11. store-als — ALS through the event store at ML-20M width
             (:func:`store_als_phase`): an app as ``pio app new`` makes it,
             1,000,000 planted ratings over every one of the 138,493 users
             and 26,744 items through ``import_interactions`` plus the
             items' ``$set`` categories, ``CoreWorkflow.run_train`` (rank
             128, 4 sweeps, 2 bf16), the checkpoint, ``load_models``,
             ``PredictionServer``: the store's triples the planted ones,
             the decoded factors the trained ones bit for bit, 23 answers
             against the plain top-k, the fit within the parity bound of
             the plain route's and within 1e-3 of it, relative; the wall
             of each phase; every kernel entry the buckets route to
             launched (the fused entry, and R = 8 at the narrow buckets);
             the four sweeps again, warm, as routed and with the buckets
             narrower than 64 on the plain route, in turns.
12. store-seq — the seq-train sessions as 524,352 ``view`` events
             through ``run_train`` → checkpoint → ``load_models`` → HTTP
             (:func:`store_seq_phase`): one query with ``recentItems``, the
             same user without them twice (the history from the store,
             then from the TTL cache): identical answers, held to the plain
             attention's; the decoded weights the trained ones bit for bit;
             then the same views in a cpplog store and the query without
             them twice more through the engine (the history from the log,
             then the cache), the same answer, ``n_layers`` flash launches
             each.
13. quickstart — the README quickstart through the port's own CLI
             (:func:`quickstart_phase`): ``pio app new``; ``pio eventserver
             --batch-cap 500`` as a child process taking 250,000 planted
             ratings over every ML-20M user and item through its three batch
             legs (200,000 in bodies of 500 on the native body parse; 20,000
             each in bodies of 50 with ``eventTime`` on the doc-level gate
             and, carrying ``tags`` too, the generic per-event path) and
             2,000 single events, a 51-event body refused (400) at the
             reference's cap of 50, the child stopped (exit 0); 8,000
             through ``pio import``; ``pio export`` reads every rating back
             once with its value; ``pio build`` and ``pio train`` (rank
             128, 4 sweeps, 2 bf16): the fused ALS and R-row kernels
             launch, the fit within 1e-3 of the plain route's; ``pio
             deploy`` as a child: 32 queries and an unknown user over HTTP
             on ``cuda``, each against the plain top-k on the instance's
             decoded factors, the child's score+top-k launches from its
             ``GET /``; ``pio undeploy`` (exit 0). Prints each leg's
             events/s, the instance's ``phase.*_s`` walls, deploy to first
             answer and HTTP p50 / p99, then the card's line again.
14. retrain — the continuation retrain and implicit training. (a) On
             the quickstart's store, after its ``pio train``
             (:func:`retrain_cli_leg`): 2,500 ratings (2,000 new pairs, 250
             from 100 new users, 250 on 50 new items) through a new ``pio
             eventserver`` child on the native leg, in bodies of 500;
             ``pio train`` again, which continues (``mode=continue``, 2 to
             4 sweeps, ``phase.continue_seed_s``) and fits within 1.15 × a
             fresh train's RMSE + 0.02; ``pio deploy`` of the continued
             instance, 32 queries (one from a new user) against the plain
             top-k; ``pio undeploy``. (b) In process at ML-20M width on the
             train phase's ratings (:func:`retrain_loop_leg`):
             ``als_retrain`` from the trained state (plan ``miss``), again
             after a 1% tail of 200,000 new pairs (``reused``), the reused
             trees equal to a fresh build bit for bit and the same sweeps
             on both within ``als_tolerance``, a re-rate tail
             ``invalidated``. (c) ``als_train_implicit`` on the same COO
             (:func:`implicit_leg`; weights |r|, α 1, rank 128, 2 sweeps),
             kernel and plain route from one initial state: the implicit
             loss within 1e-6 relative, the fused entry launched and no
             two-stage form; the fused entry against its plain version on
             the heaviest chunk of every bucket width of both sides. The
             same again on store-als's 1M ratings, whose buckets start at
             d 8: no R-row launch there either.
15. cpplog — the quickstart's verbs with the events on the native log
             (:func:`cpplog_phase`; metadata on SQLite, models on localfs):
             ``pio import`` of store-als's 1,000,000 ratings on the native
             columnar path (which writes the training projection); ``pio
             train`` (store-als's params), its read the sharded scan, held
             to store-als's SQLite read as triples and its fit within 1e-3
             of store-als's; ``pio eventserver`` as a child on the log: the
             three batch legs at bodies of 50 and 500, 1,000 single events,
             ``GET /stats.json``'s group-commit counters, the retrain leg's
             2,500 ratings, which ``read_interactions_since`` returns
             exactly; the projection-served read (the projection plus a
             2,500-row tail) equal to the full scan byte for byte; ``pio
             train`` again (``mode=continue``); ``pio deploy``, 32 queries
             against the plain top-k, ``pio undeploy``; ``pio upgrade`` and
             the same read after it. Prints each figure beside the SQLite
             phases' and the card's line again.
    speed  — the speed layer on the cpplog phase's store, in this process
             (:func:`speed_phase`; run by that phase's ``then`` hook):
             ``FoldInSolver`` on the card against the same solver on CPU
             tensors at every ladder width × batch 1 / 8 / 64, explicit and
             implicit, at rank 128 (the served items) and 10 (planted), a
             700-observation history, empty rows (exactly 0), 65 rows (two
             launches) (:func:`foldin_kernel_cases`), and the fused entry's
             timing rows at fold-in shapes (:func:`foldin_timings`); then
             ``PredictionServer(config=...)`` with its overlay and an
             in-process ``EventServer``: 64 known users' new ratings and 5 s
             of 16 new users × 8 ratings every 50 ms, polled by hand, each
             folded vector held to the plain fold-in, 64 overlay users' and
             32 base users' answers over HTTP and one mixed 64-body batch
             against the plain top-k, an unknown user, a re-fold after a new
             event, ``GET /``'s ``speedOverlay`` and ``modelStalenessSec``,
             ``POST /reload`` while 16 clients query (the hot swap, every
             answer across it a 200: the adopted users re-solved), 4 s
             behind the server's own 1 s poller
             (``pio_freshness_seconds``), the launch counts; then the
             ecommerce template (:func:`ecommerce_leg`): 1,000,000 planted
             views (every 8th also a buy) trained by the example's
             engine.json (implicit, rank 10, 20 iterations) and held to the
             plain route's implicit loss, its narrow buckets to the f64
             rule, deployed with the implicit overlay, new users folded and
             served, a known, a recent-views, a popularity user and an
             ``unavailableItems`` constraint against the plain scoring.
             Prints the poll wall by part, fold-ins, hit rate, cursor lag,
             freshness p95, HTTP p50 of overlay and base users, and the
             card's line again.
16. report — kernel, plain-version and library times (CUDA events, median
             after warm-up) beside the bound, as one ``{"kernels": [...]}``
             line (flash: the engine's windows, also left-padded with 1 to
             4,096 live keys, and the bench's shapes; the repaired limits'
             shapes); ``cg:`` lines (the heaviest fused chunk at 0 and 16
             CG steps); the flash kernel, plain dense and plain blockwise
             at the engine's head for S = 1,024 to 8,192 (``crossover:``
             lines); then the last line,
             ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --flash`` runs only the build, the flash-kernel
phase and the flash timings; ``--topk`` the score+top-k cases and timings;
``--als`` the ALS cases, every ALS entry timed at the ML-20M bucket
shapes D 8 to 32,768, f32 and bf16, and the narrow-bucket cell behind
``ops/als.py``'s routing constants (:func:`narrow_timings`). Run one from the root and from a
directory holding ``chip_smoke.py`` and another version of the package,
in turns, to compare two versions of a kernel on one card. Timing rows
carry ``ms`` (one call, CUDA events) and ``graph_ms`` (the call replayed
from a CUDA graph: device time); ALS rows the Gram alone as
``library_ms``.

The bound is max(bytes / 3.35 TB/s, operations / peak): H100 SXM HBM3,
bf16 tensor-core products at 989 TFLOP/s and f32 products at 495/3
TFLOP/s, the TF32 rate over three (3xTF32, the fastest f32-accurate
products the card has), from NVIDIA's data sheet at 700 W
(``runtime.HBM_BYTES_PER_S``, ``BF16_FLOPS``, ``F32_3XTF32_FLOPS``);
bytes count each input read once and each output written once. Where the
products are f32, ``bound_fma_ms`` beside it is the same bound with them
on the FMA units (67 TFLOP/s, ``runtime.F32_FLOPS``), the yardstick of
the first designs. The ALS entries' bound is
``ops/als_kernels.bucket_bound``, the one the training profile uses; the
flash entry's is ``ops/attention_kernels.flash_bound``, 4·D FLOP per live
(query, key) pair and head of the run's inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import logging
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import torch

ML20M = dict(users=138_493, items=26_744, rank=128)
MIPS_CATALOGUE = dict(items=1_048_576, rank=64)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# -- comparison with the plain version ---------------------------------------

def check_topk(got_s, got_i, ref_s, ref_i, k: int, what: str,
               rtol: float = 1e-5) -> float:
    """Kernel (got, [B, k]) against the plain version (ref, [B, >= k]; one
    extra column shows a near-tie at the cut), scores to ``rtol`` with atol
    ``rtol`` * max|score|. Returns the largest score error over live
    slots."""
    got_s, got_i = np.asarray(got_s, np.float64), np.asarray(got_i)
    ref_s, ref_i = np.asarray(ref_s, np.float64), np.asarray(ref_i)
    live = ref_s[:, :k] > -1e37
    if not np.array_equal(got_s > -1e37, live):
        raise AssertionError(f"{what}: filler slots differ")
    if (got_i[~live] != -1).any():
        raise AssertionError(f"{what}: a filler slot carries an id")
    if not live.any():
        return 0.0
    atol = rtol * np.abs(ref_s[:, :k][live]).max()
    err = np.abs(got_s - ref_s[:, :k])[live]
    if (err > rtol * np.abs(ref_s[:, :k][live]) + atol).any():
        raise AssertionError(f"{what}: scores differ by up to {err.max()}")
    for b, p in zip(*np.nonzero((got_i != ref_i[:, :k]) & live)):
        near = [q for q in (p - 1, p + 1) if 0 <= q < ref_s.shape[1]
                and abs(ref_s[b, q] - ref_s[b, p])
                <= rtol * abs(ref_s[b, p]) + atol]
        if not near:
            raise AssertionError(
                f"{what}: row {b} slot {p}: id {got_i[b, p]} against "
                f"{ref_i[b, p]} with no near-tie")
    for b in range(got_i.shape[0]):
        ids = got_i[b][live[b]]
        if len(set(ids.tolist())) != len(ids):
            raise AssertionError(f"{what}: row {b} repeats an id")
    return float(err.max())


def _kernel_vs_plain(kernels, q, items, allowed, k, what,
                     exact: bool = False) -> float:
    """One kernel call against the plain version; ``exact`` (integer
    factors, whose scores are exact in any order of sums) demands the same
    scores and ids slot for slot, ties included."""
    got_s, got_i = kernels.score_topk(q, items, allowed, k)
    ref_s, ref_i = kernels.score_topk_plain(
        q, items, allowed, min(k + 1, items.shape[0]))
    torch.cuda.synchronize()
    if exact and not (torch.equal(got_s.cpu(), ref_s[:, :k].cpu())
                      and torch.equal(got_i.cpu(), ref_i[:, :k].cpu())):
        raise AssertionError(f"{what}: not slot for slot the plain version")
    return check_topk(got_s.cpu(), got_i.cpu(), ref_s.cpu(), ref_i.cpu(), k,
                      what)


def topk_edge_cases(small: bool = False) -> list:
    """(name, q, items, mask, k, exact) at the edges of the kernel's
    design: ties either side of a 256-item tile and of a block's item
    range (the best row planted there; integer factors, so ids must match
    exactly), scores equal to the running threshold in later tiles and
    blocks, catalogues that are no multiple of the tile, k 1 and 128,
    fewer allowed items than k, none allowed, B 1 / 3 / 8 / 9 / 64 (one
    row group of exactly B rows, and partial groups of 8) and K 8 / 10 /
    64 / 128 / 256, and above 256, where the query rows stream by chunk
    (257, 300, 512; a model of any rank is served, as by the
    reference)."""
    rng = np.random.default_rng(13)
    cases = []
    for n_items, b in ((26_744, 1), (5_000 if small else 1_048_576, 1),
                       (40_000 if small else 1_048_576, 64)):
        items = rng.integers(-2, 3, (n_items, 16)).astype(np.float32)
        # tile edges (256), a block's range at B 1 on 1M items (16 tiles)
        # and at B 64 (125 tiles), the last item
        ids = [i for i in (255, 256, 511, 512, 4095, 4096, 31_999, 32_000)
               if i < n_items] + [n_items - 1]
        items[ids] = 3.0
        q = rng.integers(1, 3, (b, 16)).astype(np.float32)
        for k in (1, 4, len(ids), 128):
            cases.append((f"tie_edges_i{n_items}_b{b}_k{k}", q, items, None,
                          k, True))
    items = rng.integers(-1, 2, (100_000, 8)).astype(np.float32)
    for b in (1, 3):
        q = rng.integers(-1, 2, (b, 8)).astype(np.float32)
        for k in (1, 128):
            cases.append((f"threshold_ties_b{b}_k{k}", q, items, None, k,
                          True))
    for n_items in (257, 1000, 2049):
        items = rng.standard_normal((n_items, 32), np.float32)
        for b, k in ((1, 1), (3, 128), (9, 128)):
            cases.append((f"odd_catalogue_i{n_items}_b{b}_k{k}",
                          rng.standard_normal((b, 32), np.float32), items,
                          None, k, False))
    items = rng.standard_normal((5000, 24), np.float32)
    few = np.zeros(5000, bool)
    few[rng.choice(5000, 50, replace=False)] = True
    for b in (1, 9):
        q = rng.standard_normal((b, 24), np.float32)
        cases.append((f"fewer_allowed_than_k_b{b}", q, items, few, 128,
                      False))
        for k in (1, 128):
            cases.append((f"none_allowed_b{b}_k{k}", q, items,
                          np.zeros(5000, bool), k, False))
    for rank in (8, 10, 64, 128, 256, 257, 300, 512):
        items = rng.standard_normal((3000, rank), np.float32)
        mask = rng.random(3000) > 0.1
        for b in (1, 3, 8, 9, 64):
            cases.append((f"b{b}_rank{rank}",
                          rng.standard_normal((b, rank), np.float32), items,
                          mask, 128, False))
    return cases


def kernel_phase(dev, kernels, planted, small: bool = False):
    """Every kernel-vs-plain case; returns (max error, #cases)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rng = np.random.default_rng(0)
    cases = []
    # tests/test_pallas_kernels.py:27-78, exclusions folded into the mask
    items = rng.standard_normal((500, 24), np.float32)
    cases.append(("matches_reference", rng.standard_normal((1, 24),
                                                           np.float32),
                  items, None, 7))
    items = rng.standard_normal((300, 16), np.float32)
    mask = np.ones(300, bool)
    mask[:250] = False
    cases.append(("exclusions", rng.standard_normal((1, 16), np.float32),
                  items, mask, 5))
    items = rng.standard_normal((260, 8), np.float32)
    mask = np.ones(260, bool)
    mask[::3] = False
    mask[[7, 11]] = False
    cases.append(("mask_and_exclude", rng.standard_normal((1, 8), np.float32),
                  items, mask, 4))
    items = rng.standard_normal((40, 8), np.float32)
    mask = np.zeros(40, bool)
    mask[:3] = True
    cases.append(("k_exceeding_allowed",
                  rng.standard_normal((1, 8), np.float32), items, mask, 6))
    base = rng.integers(-3, 4, (700, 16)).astype(np.float32)
    items = np.concatenate([base, base, base])[rng.permutation(2100)]
    cases.append(("duplicate_row_ties",
                  rng.integers(-3, 4, (3, 16)).astype(np.float32), items,
                  None, 20))
    # a rank that is no multiple of 4 takes the kernel's scalar loads
    cases.append(("odd_rank", rng.standard_normal((5, 10), np.float32),
                  rng.standard_normal((3000, 10), np.float32), None, 50))
    n_items, rank = ML20M["items"], ML20M["rank"]
    if small:
        n_items = 3000
    items = planted.planted_item_factors(n_items, rank, seed=11)
    for b in (1, 64):
        q = planted.planted_queries(items, b, seed=12 + b)
        for k in (10, 100, 128):
            cases.append((f"ml20m_b{b}_k{k}", q, items, None, k))
    # the scheduler's upper rungs: 16 to 64 row groups of 8
    for b in (128, 256, 512):
        q = planted.planted_queries(items, b, seed=12 + b)
        for k in (10, 128):
            cases.append((f"ml20m_b{b}_k{k}", q, items, None, k))
    mask = rng.random(n_items) > 0.3
    cases.append(("ml20m_b64_k128_masked",
                  planted.planted_queries(items, 64, seed=20), items, mask,
                  128))
    n_items, rank = MIPS_CATALOGUE["items"], MIPS_CATALOGUE["rank"]
    if small:
        n_items = 5000
    items = planted.planted_item_factors(n_items, rank, seed=21)
    for b in (1, 64):
        cases.append((f"mips1m_b{b}_k128",
                      planted.planted_queries(items, b, seed=22 + b), items,
                      None, 128))
    cases = [c + (False,) for c in cases] + topk_edge_cases(small)
    err = 0.0
    for what, q, items, mask, k, exact in cases:
        err = max(err, _kernel_vs_plain(
            kernels, t(q), t(items), None if mask is None else t(mask), k,
            what, exact))
    return err, len(cases)


# -- the main path -------------------------------------------------------------

def build_model(planted, convert, dev, users: int, n_items: int, rank: int,
                seen_users: int = 1000, seen_len: int = 70):
    items = planted.planted_item_factors(n_items, rank, seed=1)
    uf = planted.planted_queries(items, users, seed=2)
    rng = np.random.default_rng(3)
    seen = {int(u): np.sort(rng.choice(n_items, seen_len, replace=False))
            for u in rng.choice(users, seen_users, replace=False)}
    years = {f"i{i}": int(y)
             for i, y in enumerate(rng.integers(1950, 2016, n_items))}
    model = convert.als_model_from_numpy(
        uf, items, [f"u{i}" for i in range(users)],
        [f"i{i}" for i in range(n_items)], item_years=years, user_seen=seen,
        device=dev)
    return model, uf, items, seen


def path_queries(rng, users: int, n_items: int, seen) -> list:
    """The 32 query bodies of the path phase: (doc, allowed-or-None)."""
    docs = []
    pick = rng.choice(users, 24, replace=False)
    for u in pick[:8]:
        docs.append(({"user": f"u{u}", "num": 10}, None))
    for u in pick[8:14]:
        docs.append(({"user": f"u{u}", "num": 100}, None))
    for u in list(seen)[:6]:
        mask = np.ones(n_items, bool)
        mask[seen[u]] = False
        docs.append(({"user": f"u{u}", "num": 20, "excludeSeen": True},
                     mask))
    for u in pick[14:18]:
        black = rng.choice(n_items, 50, replace=False)
        mask = np.ones(n_items, bool)
        mask[black] = False
        docs.append(({"user": f"u{u}", "num": 10,
                      "blacklist": [f"i{i}" for i in black] + ["nosuch"]},
                     mask))
    for u in pick[18:22]:
        white = rng.choice(n_items, 200, replace=False)
        mask = np.zeros(n_items, bool)
        mask[white] = True
        docs.append(({"user": f"u{u}", "num": 10,
                      "whitelist": [f"i{i}" for i in white]}, mask))
    docs += [({"user": "nosuch-1", "num": 10}, None),
             ({"user": "nosuch-2", "num": 5}, None)]
    for u in pick[22:24]:
        docs.append(({"user": f"u{u}", "num": 0}, None))
    return docs


def check_answer(kernels, dev, uf_t, items_t, doc, mask, body, what,
                 model=None) -> float:
    """One served answer against the plain version on the same factors.
    Ids map to rows by their number (``u17`` is row 17), or through the
    BiMaps of ``model`` when one is given."""
    got = body["itemScores"]
    num = doc["num"]
    if doc["user"].startswith("nosuch") or num <= 0:
        if got:
            raise AssertionError(f"{what}: expected no items, got {len(got)}")
        return 0.0
    if model is None:
        row = int(doc["user"][1:])

        def item_index(name):
            return int(name[1:])
    else:
        row = model.user_bimap[doc["user"]]
        item_index = model.item_bimap.__getitem__
    allowed = None if mask is None else torch.from_numpy(mask).to(dev)
    n_live = num if mask is None else min(num, int(mask.sum()))
    ref_s, ref_i = kernels.score_topk_plain(
        uf_t[row:row + 1], items_t, allowed, min(num + 1, items_t.shape[0]))
    if len(got) != n_live:
        raise AssertionError(f"{what}: {len(got)} items, expected {n_live}")
    got_s = np.array([[x["score"] for x in got]])
    got_i = np.array([[item_index(x["item"]) for x in got]])
    return check_topk(got_s, got_i, ref_s.cpu()[:, :n_live + 1],
                      ref_i.cpu()[:, :n_live + 1], n_live, what)


def post(port: int, doc) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(doc).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status} for {doc}")
        return json.loads(resp.read())


def path_phase(dev, runtime, kernels, planted, convert, engine, params_mod,
               server_mod, users, n_items, rank, built=None):
    """Serve the main path (on ``built``, :func:`build_model`'s result,
    when given); returns (kernel launches, max error, stats)."""
    model, uf, items, seen = built or build_model(planted, convert, dev,
                                                  users, n_items, rank)
    uf_t = torch.from_numpy(uf).to(dev)
    items_t = torch.from_numpy(items).to(dev)
    srv = server_mod.PredictionServer(
        engine.RecommendationEngine().apply(),
        params_mod.EngineParams(algorithm_params_list=[
            ("als", engine.ALSAlgorithmParams(rank=rank))]),
        [model], device=dev)
    port = srv.start_background()
    try:
        rng = np.random.default_rng(4)
        docs = path_queries(rng, users, n_items, seen)
        batch_rows = rng.choice(users, 64, replace=False)
        batch_docs = [{"user": f"u{u}", "num": 10} for u in batch_rows]
        runtime.reset_launch_counts()
        walls, answers = [], []
        for doc, _mask in docs:
            t0 = time.perf_counter()
            answers.append(post(port, doc))
            walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        batch_out = srv._handle_batch(
            [json.dumps(d).encode() for d in batch_docs], "default",
            "default")
        batch_wall = time.perf_counter() - t0
        counts = runtime.launch_counts()
    finally:
        srv.stop()
    err = 0.0
    for i, ((doc, mask), body) in enumerate(zip(docs, answers)):
        err = max(err, check_answer(kernels, dev, uf_t, items_t, doc, mask,
                                    body, f"http query {i} {list(doc)}"))
    for i, (doc, res) in enumerate(zip(batch_docs, batch_out)):
        if not isinstance(res, (bytes, bytearray)):
            raise AssertionError(f"batch body {i} left the fast path: {res!r}")
        err = max(err, check_answer(kernels, dev, uf_t, items_t, doc, None,
                                    json.loads(res), f"batch body {i}"))
    device_queries = sum(1 for d, _m in docs
                         if not d["user"].startswith("nosuch") and d["num"] > 0)
    if counts["score_topk"] < device_queries + 1:
        raise AssertionError(
            f"score_topk launched {counts['score_topk']} times on the path; "
            f"{device_queries} device queries and one batch need at least "
            f"{device_queries + 1}")
    stats = {"http_queries": len(docs), "device_queries": device_queries,
             "http_p50_ms": 1e3 * statistics.median(walls),
             "http_max_ms": 1e3 * max(walls),
             "batch64_ms": 1e3 * batch_wall, "counts": counts}
    return counts["score_topk"], err, stats


# -- concurrent load through the serving scheduler -------------------------------

#: closed-loop keep-alive load generator, standard library only, run as
#: ``python -c LOAD_CLIENT <config JSON>``: ``threads`` clients, each on
#: one keep-alive connection, POST ``{"user": "u<row>", "num": num}`` for
#: random rows from ``start_at`` to ``stop_at`` (``time.monotonic``, which
#: every process of the host shares) and write one record per answer to
#: ``out``: [row, status, seconds, Retry-After, X-PIO-Queue-Depth, body of
#: a 200].
LOAD_CLIENT = r'''
import http.client, json, random, sys, threading, time
cfg = json.loads(sys.argv[1])
records, lock = [], threading.Lock()

def client(tid):
    rng = random.Random(cfg["seed"] * 100003 + tid)
    conn = http.client.HTTPConnection("127.0.0.1", cfg["port"], timeout=120)
    mine = []
    while time.monotonic() < cfg["start_at"]:
        time.sleep(0.001)
    while time.monotonic() < cfg["stop_at"]:
        row = rng.randrange(cfg["users"])
        body = json.dumps({"user": "u%d" % row, "num": cfg["num"]})
        t0 = time.perf_counter()
        conn.request("POST", cfg["path"], body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        rec = [row, resp.status, time.perf_counter() - t0,
               resp.getheader("Retry-After"),
               resp.getheader("X-PIO-Queue-Depth")]
        if resp.status == 200:
            rec.append(data.decode())
        mine.append(rec)
    conn.close()
    with lock:
        records.extend(mine)

threads = [threading.Thread(target=client, args=(t,))
           for t in range(cfg["threads"])]
for t in threads:
    t.start()
for t in threads:
    t.join()
with open(cfg["out"], "w") as f:
    json.dump(records, f)
'''

#: client counts of the serve-load legs, and the seconds each runs
LOAD_CLIENTS = (1, 16, 64, 256)
LOAD_SECONDS = 4.0
#: client processes a leg's clients are spread over (the host's cores
#: are shared with the server's process)
LOAD_PROCS = 4


def run_clients(port: int, users: int, clients: int, seconds: float,
                seed: int, work: str, path: str = "/queries.json",
                num: int = 10, procs: int = LOAD_PROCS) -> list:
    """Closed-loop clients (:data:`LOAD_CLIENT`) in ``min(procs,
    clients)`` processes; returns their records."""
    n_procs = min(procs, clients)
    start_at = time.monotonic() + 1.0 + 0.05 * n_procs
    children = []
    for p in range(n_procs):
        out = os.path.join(work, f"load-{seed}-{p}.json")
        cfg = dict(port=port, users=users, num=num, path=path,
                   threads=clients // n_procs + (p < clients % n_procs),
                   seed=seed * 64 + p, start_at=start_at,
                   stop_at=start_at + seconds, out=out)
        children.append((out, subprocess.Popen(
            [sys.executable, "-c", LOAD_CLIENT, json.dumps(cfg)])))
    records = []
    for out, proc in children:
        if proc.wait(seconds + 300) != 0:
            raise AssertionError(f"serve-load: a client process exited "
                                 f"{proc.returncode}")
        with open(out) as f:
            records += json.load(f)
        os.remove(out)
    return records


def check_load_answers(kernels, dev, uf_t, items_t, records, num: int,
                       what: str) -> float:
    """Every 200 of ``records`` against the plain top-k of its row, in
    batches of 2,048 rows; returns the largest score error."""
    ok = [r for r in records if r[1] == 200]
    err = 0.0
    for lo in range(0, len(ok), 2048):
        part = ok[lo:lo + 2048]
        rows = torch.tensor([r[0] for r in part], device=dev)
        ref_s, ref_i = kernels.score_topk_plain(uf_t[rows], items_t, None,
                                                num + 1)
        bodies = [json.loads(r[5])["itemScores"] for r in part]
        if any(len(b) != num for b in bodies):
            raise AssertionError(f"{what}: an answer without {num} items")
        got_s = np.array([[x["score"] for x in b] for b in bodies])
        got_i = np.array([[int(x["item"][1:]) for x in b] for b in bodies])
        err = max(err, check_topk(got_s, got_i, ref_s.cpu().numpy(),
                                  ref_i.cpu().numpy(), num, what))
    return err


def bucket_le(bounds, counts, q: float):
    """The upper bound of the histogram bucket that holds quantile ``q``
    of ``counts`` (None when empty)."""
    total, cum = sum(counts), 0
    for i, c in enumerate(counts):
        cum += c
        if total and cum >= q * total:
            return bounds[i] if i < len(bounds) else float("inf")
    return None


def thread_cpu() -> dict:
    """CPU seconds of each live thread of this process by role: the
    HTTP server's event loop (``loop``), the scheduler's dispatchers
    (``dispatch``), the HTTP layer's executor (``executor``), the rest
    (``other``); and the process's total (``process``)."""
    import threading

    out = {"loop": 0.0, "dispatch": 0.0, "executor": 0.0, "other": 0.0}
    for t in threading.enumerate():
        try:
            cpu = time.clock_gettime(time.pthread_getcpuclockid(t.ident))
        except (OSError, TypeError):
            continue  # the thread ended meanwhile
        role = ("dispatch" if t.name.startswith("pio-serve-sched")
                else "executor" if t.name.startswith("asyncio_")
                else "loop" if t.name.startswith("pio-http-")
                else "other")
        out[role] += cpu
    out["process"] = time.process_time()
    return out


def _hist_delta(fam, before):
    after = fam.snapshot()
    return [a - b for a, b in zip(after[0], before[0])]


SHED_REASONS = ("overload", "quota", "evicted", "shutdown")


def load_leg(runtime, kernels, dev, server_mod, engine, params_mod, built,
             clients: int, seconds: float, seed: int, work: str,
             micro_batch=None, workers: int = 1, env=None, tenants=None,
             probe=None) -> dict:
    """One leg of :func:`serve_load_phase`: a server on the planted model
    (``micro_batch`` None: the default ladder cap; 0: no scheduler;
    ``workers`` dispatcher threads; ``env`` set around it), ``clients``
    closed-loop clients for ``seconds`` (``tenants``: {access key:
    (tenant, clients)} instead), then one more query after the load, and
    ``probe(port)`` when given. Checks: every answer against the plain
    top-k; every non-200 a 503 with ``Retry-After``, as many as
    ``pio_serve_shed_total`` counted. Returns the leg's figures."""
    from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        ServerConfig,
    )

    model, uf, _items, _seen = built
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    srv = None
    reg = obs_metrics.REGISTRY
    sizes = reg.get("pio_serve_batch_size").labels()
    waits = reg.get("pio_serve_queue_wait_seconds").labels()
    shed = reg.get("pio_serve_shed_total")
    latency = reg.get("pio_query_latency_seconds")
    names = ["default"] + [t for t, _n in (tenants or {}).values()]
    try:
        config = ServerConfig(ip="127.0.0.1", port=0, serve_workers=workers)
        if micro_batch is not None:
            config.micro_batch = micro_batch
        srv = server_mod.PredictionServer(
            engine.RecommendationEngine().apply(),
            params_mod.EngineParams(algorithm_params_list=[
                ("als", engine.ALSAlgorithmParams(rank=uf.shape[1]))]),
            [model], device=dev, config=config)
        port = srv.start_background()
        size0, wait0 = sizes.snapshot(), waits.snapshot()
        shed0 = {(t, r): shed.labels(tenant=t, reason=r).value
                 for t in names for r in SHED_REASONS}
        served0 = {t: latency.labels(tenant=t).snapshot()[2] for t in names}
        srv.max_batch_served = 0
        runtime.reset_launch_counts()
        cpu0 = thread_cpu()
        if tenants:
            import concurrent.futures

            with concurrent.futures.ThreadPoolExecutor(len(tenants)) as ex:
                futs = {tenant: ex.submit(
                    run_clients, port, uf.shape[0], n, seconds, seed + i,
                    work, f"/queries.json?accessKey={key}", procs=2)
                    for i, (key, (tenant, n)) in enumerate(tenants.items())}
                by_tenant = {t: f.result() for t, f in futs.items()}
            records = [r for recs in by_tenant.values() for r in recs]
        else:
            by_tenant = None
            records = run_clients(port, uf.shape[0], clients, seconds, seed,
                                  work)
        launches = runtime.launch_counts()["score_topk"]
        cpu = {k: v - cpu0[k] for k, v in thread_cpu().items()}
        size_d, wait_d = _hist_delta(sizes, size0), _hist_delta(waits, wait0)
        sheds = {f"{t}/{r}": shed.labels(tenant=t, reason=r).value - v
                 for (t, r), v in shed0.items()}
        served = {t: latency.labels(tenant=t).snapshot()[2] - n
                  for t, n in served0.items()}
        status = srv.status()
        key = next(iter(tenants)) if tenants else None
        after = http_json("POST", f"http://127.0.0.1:{port}/queries.json"
                          + (f"?accessKey={key}" if key else ""),
                          {"user": "u1", "num": 10})
        probed = probe(port) if probe is not None else None
    finally:
        if srv is not None:
            srv.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    what = (f"serve-load {clients} clients, micro_batch "
            f"{micro_batch}, workers {workers}")
    ok = [r for r in records if r[1] == 200]
    statuses: dict = {}
    for r in records:
        statuses[str(r[1])] = statuses.get(str(r[1]), 0) + 1
    bad = [r[:5] for r in records
           if r[1] != 200 and (r[1] != 503 or not r[3] or int(r[3]) < 1
                               or r[4] is None)]
    if bad:
        raise AssertionError(f"{what}: answers neither 200 nor a 503 with "
                             f"Retry-After and X-PIO-Queue-Depth: {bad[:5]}")
    n_shed = sum(v for v in sheds.values())
    if statuses.get("503", 0) != n_shed:
        raise AssertionError(f"{what}: {statuses.get('503', 0)} answers "
                             f"were 503, pio_serve_shed_total counted "
                             f"{sheds}")
    if after[0] != 200 or len(after[1]["itemScores"]) != 10:
        raise AssertionError(f"{what}: the query after the load got "
                             f"{after}")
    walls = sorted(r[2] for r in ok)
    leg = {
        "clients": clients, "micro_batch": status["scheduler"]["cap"]
        if status["scheduler"] else 0, "workers": workers,
        "seconds": seconds, "answered": len(ok), "statuses": statuses,
        "qps": len(ok) / seconds,
        "p50_ms": 1e3 * walls[len(walls) // 2] if walls else None,
        "p99_ms": (1e3 * walls[min(len(walls) - 1, int(0.99 * len(walls)))]
                   if walls else None),
        # pow2 buckets: the median dispatch's width is at most this rung
        "batch_p50_le": bucket_le(sizes._bounds, size_d, 0.5),
        "batch_mean": (sum(served.values()) / sum(size_d)
                       if sum(size_d) else None),
        "batch_max": status["maxBatchServed"],
        "dispatches": sum(size_d),
        "queue_wait_p99_ms": (1e3 * hist_quantile(waits._bounds, wait_d,
                                                  0.99)
                              if sum(wait_d) else None),
        "launches": launches,
        "queries_per_launch": len(ok) / launches if launches else None,
        # the server's CPU per answer (the clients are other processes)
        "cpu_us_per_answer": {k: 1e6 * v / len(ok) if ok else None
                              for k, v in cpu.items()},
        "shed": {k: v for k, v in sheds.items() if v},
        "dispatched": {t: n for t, n in served.items() if n},
        "max_abs_err": check_load_answers(
            kernels, dev, model.user_factors, model.item_factors, records,
            10, what),
    }
    if by_tenant is not None:
        leg["answered_by_tenant"] = {
            t: sum(r[1] == 200 for r in recs) for t, recs in
            by_tenant.items()}
    if probed is not None:
        leg["probe"] = probed
    return leg


#: the tenancy leg's registry: two tenants, weights 3 and 1
LOAD_TENANTS = "heavy:heavy-key:weight=3;light:light-key:weight=1"


def serve_load_phase(dev, runtime, kernels, server_mod, engine, params_mod,
                     built, small: bool = False) -> tuple:
    """Concurrent ``/queries.json`` on the path phase's planted model
    (``built``), through the port's HTTP server in this process, from
    closed-loop keep-alive clients in child processes
    (:func:`run_clients`). (1) 1, 16, 64 and 256 clients for 4 s each,
    with the scheduler (ladder cap 512) and again with ``micro_batch=0``;
    64 clients with two dispatcher threads: queries/s, p50 / p99 on the
    client's clock, the fused width's p50 (``pio_serve_batch_size``) and
    max, queue-wait p99, score+top-k launches against answers; at 64
    clients the scheduler launches fewer times than it answers. (2) The
    shed: ``PIO_SLO_SERVE_P99_S`` 2 ms at 256 clients; some queries
    shed. (3) Tenancy: two tenants, weights 3 and 1, 32 clients each; a
    wrong and a missing key get 401; the dispatched shares; the weight-1
    tenant at least 10% of them. Every leg: every answer against the
    plain top-k, every non-200 a 503 with ``Retry-After`` counted by
    ``pio_serve_shed_total``, a query after the load answered.
    Returns (score+top-k launches, max score error, stats)."""
    seconds = 1.0 if small else LOAD_SECONDS
    counts = (1, 4) if small else LOAD_CLIENTS
    mid = 4 if small else 64
    work = tempfile.mkdtemp(prefix="pio-load-")
    t_phase = time.perf_counter()
    legs, seed = [], 100
    args = (runtime, kernels, dev, server_mod, engine, params_mod, built)
    try:
        for mb in (None, 0):
            for n in counts:
                seed += 1
                legs.append(load_leg(*args, clients=n, seconds=seconds,
                                     seed=seed, work=work, micro_batch=mb))
        legs.append(load_leg(*args, clients=mid, seconds=seconds,
                             seed=seed + 1, work=work, workers=2))
        sched = next(g for g in legs if g["clients"] == mid
                     and g["micro_batch"] and g["workers"] == 1)
        if dev.type == "cuda" and not sched["launches"] < sched["answered"]:
            raise AssertionError(
                f"serve-load: at {mid} clients the scheduler launched "
                f"score_topk {sched['launches']} times for "
                f"{sched['answered']} answers")
        shed = load_leg(*args, clients=counts[-1], seconds=seconds,
                        seed=seed + 2, work=work,
                        env={"PIO_SLO_SERVE_P99_S": "0.002"})
        if not shed["shed"].get("default/overload"):
            raise AssertionError(f"serve-load: the shed leg shed nothing: "
                                 f"{shed['statuses']}")

        def probe(port):
            url = f"http://127.0.0.1:{port}/queries.json"
            return {"missing": http_json("POST", url, {"user": "u1",
                                                        "num": 3})[0],
                    "wrong": http_json("POST", url + "?accessKey=nope",
                                       {"user": "u1", "num": 3})[0]}

        half = 2 if small else 32
        ten = load_leg(*args, clients=2 * half, seconds=seconds,
                       seed=seed + 3, work=work,
                       env={"PIO_TENANTS": LOAD_TENANTS},
                       tenants={"heavy-key": ("heavy", half),
                                "light-key": ("light", half)},
                       probe=probe)
        if ten["probe"] != {"missing": 401, "wrong": 401}:
            raise AssertionError(f"serve-load: tenancy keys {ten['probe']}")
        total = sum(ten["dispatched"].get(t, 0) for t in ("heavy", "light"))
        ten["dispatched_share"] = {
            t: ten["dispatched"].get(t, 0) / total for t in ("heavy",
                                                             "light")}
        if ten["dispatched_share"]["light"] < 0.10:
            raise AssertionError(f"serve-load: the weight-1 tenant got "
                                 f"{ten['dispatched_share']}")
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    launches = sum(g["launches"] for g in legs + [shed, ten])
    err = max(g["max_abs_err"] for g in legs + [shed, ten])
    stats = {"legs": legs, "shed": shed, "tenants": ten,
             "wall_s": time.perf_counter() - t_phase}
    return launches, err, stats


# -- timing --------------------------------------------------------------------

def median_ms(fn, reps: int = 30, warm: int = 5) -> float:
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, calls: int = 10, reps: int = 10) -> float:
    """Device ms of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, its replay timed as :func:`median_ms` times it, divided by
    ``calls``. What :func:`median_ms` adds to it is the host's share of a
    call (Python, the wrapper, the launches), which bounds a call whose
    device work is shorter."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # outside the capture: first-use allocations and attributes
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = median_ms(graph.replay, reps=reps, warm=2) / calls
    del graph
    return ms


def bound(b: int, n_items: int, rank: int, k: int, masked: bool,
          fma: bool = False):
    """(ms, "bytes" or "operations") of one score+top-k call: the products
    at the 3xTF32 rate, or on the FMA units with ``fma``."""
    from incubator_predictionio_tpu_torch import runtime

    nbytes = 4 * n_items * rank + 4 * b * rank + 8 * b * k \
        + (n_items if masked else 0)
    flops = 2.0 * b * n_items * rank
    t_bytes = nbytes / runtime.HBM_BYTES_PER_S
    t_ops = flops / (runtime.F32_FLOPS if fma else runtime.F32_3XTF32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_shape(kernels, planted, dev, b, n_items, rank, k) -> dict:
    items_np = planted.planted_item_factors(n_items, rank, seed=31)
    q = torch.from_numpy(planted.planted_queries(items_np, b, seed=32)).to(dev)
    items = torch.from_numpy(items_np).to(dev)
    bound_ms, bound_by = bound(b, n_items, rank, k, masked=False)

    def kernel():
        return kernels.score_topk(q, items, None, k)

    def library():
        return torch.topk(items @ q.T, k, dim=0)

    return {
        "B": b, "I": n_items, "K": rank, "k": k,
        "ms": median_ms(kernel),
        "graph_ms": graph_ms(kernel),
        "plain_ms": median_ms(
            lambda: kernels.score_topk_plain(q, items, None, k)),
        "library_ms": median_ms(library),
        "library_graph_ms": graph_ms(library),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_fma_ms": bound(b, n_items, rank, k, masked=False, fma=True)[0],
    }


#: the timed score+top-k shapes (B, I, K, k): the 64-body batch, one query
#: at k 10 and 128, B 64 at k 128 (ML-20M width), then 1,048,576 items,
#: ranks above 256, and B 128 / 256 / 512 (the scheduler's upper rungs)
TOPK_SHAPES = (
    (64, ML20M["items"], ML20M["rank"], 16),
    (1, ML20M["items"], ML20M["rank"], 10),
    (1, ML20M["items"], ML20M["rank"], 128),
    (64, ML20M["items"], ML20M["rank"], 128),
    (1, MIPS_CATALOGUE["items"], MIPS_CATALOGUE["rank"], 128),
    (64, MIPS_CATALOGUE["items"], MIPS_CATALOGUE["rank"], 128),
    # above rank 256 (the query rows streamed by chunk)
    (1, ML20M["items"], 300, 10),
    (64, ML20M["items"], 512, 128),
    # the serving scheduler's upper rungs
    (128, ML20M["items"], ML20M["rank"], 10),
    (256, ML20M["items"], ML20M["rank"], 10),
    (512, ML20M["items"], ML20M["rank"], 10),
    (128, ML20M["items"], ML20M["rank"], 128),
    (256, ML20M["items"], ML20M["rank"], 128),
    (512, ML20M["items"], ML20M["rank"], 128),
)


def topk_timings(kernels, planted, dev) -> list:
    return [time_shape(kernels, planted, dev, b, n, r, k)
            for b, n, r, k in TOPK_SHAPES]


# -- ALS kernels against their plain versions ------------------------------------

def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def als_problem(rng, m, k, b, d, density=None):
    """(table, cols, vals, mask, x0) as numpy. ``density`` None fills each
    row like a degree bucket, (d/2, d] observations from the left; a
    density draws a random mask (the reference tests' cases). Row 3 (or
    the last) is empty."""
    table = rng.normal(0, 0.3, (m, k)).astype(np.float32)
    cols = rng.integers(0, m, (b, d)).astype(np.int32)
    vals = rng.normal(3.5, 1.0, (b, d)).astype(np.float32)
    if density is None:
        lens = rng.integers(d // 2 + 1, d + 1, b)
        mask = (np.arange(d)[None, :] < lens[:, None]).astype(np.float32)
    else:
        mask = (rng.random((b, d)) < density).astype(np.float32)
    mask[min(3, b - 1)] = 0.0
    x0 = rng.normal(0, 0.3, (b, k)).astype(np.float32)
    return table, cols, vals, mask, x0


def two_stage_rows(d: int, k: int, chunk_elems: int) -> int:
    """Rows of one chunk of the two-stage route (ops/als.py sizing)."""
    return max(8, chunk_elems // (d * k))


def fused_rows(d: int, k: int, chunk_elems: int) -> int:
    """Rows of one chunk of the fused route (ops/als.py sizing)."""
    return max(8, chunk_elems // (3 * d + 3 * k))


def als_cases(chunk_elems: int, small: bool = False) -> list:
    """(name, m_two, m_fused, k, b_two, b_fused, d, l2, reg_nnz, iters,
    density, implicit_dtypes) of the ALS kernel phase."""
    cases = [
        # tests/test_pallas_kernels.py:156-212
        ("solve_bucket", 400, 400, 64, 24, 24, 48, 0.1, True, 16, 0.8,
         ("f32", "bf16")),
        ("multi_tile_d_b13", 600, 600, 32, 13, 13, 1024, 0.05, False, 16,
         0.8, ("f32", "bf16")),
        # tests/test_fused_gram.py:51-122: the fold-in ladder at rank 24
        *[(f"ladder_d{d}", 150, 150, 24, 9, 9, d, 0.05, True, 16, 0.8,
           ("f32", "bf16")) for d in (8, 32, 128, 512)],
        ("rank128_no_reg_nnz", 160, 160, 128, 8, 8, 32, 0.5, False, 32,
         0.8, ()),
    ]
    # ML-20M buckets at rank 128: the item half-sweep (two-stage) gathers
    # from the user table, the user half-sweep (fused) from the item table
    for d in (64, 128, 1024, 8192):
        m_two, m_fused = ML20M["users"], ML20M["items"]
        b_two = two_stage_rows(d, 128, chunk_elems)
        b_fused = fused_rows(d, 128, chunk_elems)
        if small:
            m_two, m_fused, b_two, b_fused = 3000, 2000, 16, 16
            d = min(d, 256)
        cases.append((f"ml20m_d{d}", m_two, m_fused, 128, b_two, b_fused, d,
                      0.03, True, 16, None, ("f32",)))
        if d < 128 and not small:
            # the two-stage entry at the fused chunk's rows too, so both
            # entries' D < K errors are read over as many rows
            cases.append((f"ml20m_d{d}_b{b_fused}", m_two, m_fused, 128,
                          b_fused, b_fused, d, 0.03, True, 16, None, ()))
    # above rank 128, where the reference trains too: the Gram in 128 x 128
    # tiles of the padded rank (one tile of 256 for K 129, 160 and 256, six
    # of 384 for 300; K 129 no multiple of 4 elements), D < K at 256, and
    # few wide rows (many slices of each)
    for k, b, d in ((129, 12, 400), (160, 24, 1000), (256, 16, 300),
                    (256, 6, 100), (300, 8, 500), (256, 4, 20_000)):
        d = min(d, 2000) if small else d
        cases.append((f"rank{k}_d{d}", 3000, 3000, k, b, b, d, 0.03, True,
                      16, None, ("f32", "bf16") if d <= 1000 else ()))
    # the narrow ML-20M buckets (the R-row form's widths), one chunk each
    for d in NARROW_WIDTHS:
        b_two, b_fused = two_stage_rows(d, 128, chunk_elems), fused_rows(
            d, 128, chunk_elems)
        if small:
            b_two = b_fused = 40
        cases.append((f"ml20m_d{d}", ML20M["users"], ML20M["items"], 128,
                      b_two, b_fused, d, 0.03, True, 16, None, ()))
    return cases


#: the narrow ML-20M bucket widths of :func:`als_cases`, d 8-32 at rank 128
NARROW_WIDTHS = (8, 16, 32)
#: ceiling of those cases' D < K systems past :func:`als_tolerance`, where
#: 16 CG steps on rows of 8-32 observations at rank 128 leave the plain
#: version itself up to 4.1e-2 from the f64 solve, so that its f64 rule
#: alone would pass a result ~0.12 from it: such a result must also be
#: within this of the plain version or of the f64 solve, relative. The
#: sound entries read at most 2.2e-2 from the nearer of the two (R = 1 and
#: fused from the plain version, R = 8, whose CG runs in f64, from the
#: f64 solve; PERF.md §6)
NARROW_CEILING = 3e-2


def _rel_err(got, ref):
    err = float((got - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def als_tolerance(dtype, d: int, k: int, trained: bool = False) -> float:
    """Bound on max|x − x_plain| / max|x_plain|: 1e-4 with an f32 table,
    1e-3 with a bf16 one; the arithmetic is the same and only the order of
    sums differs. Two kinds of system are held to 1e-3 in f32 as well,
    because 16 CG steps leave them unconverged and the unconverged iterate
    amplifies the order-of-sums difference:
    - a row with fewer observations than the rank (D < K): its Gram is
      singular and only the ridge conditions it;
    - a main-path chunk (``trained``): the table is the trained factors,
      rank 128 fitted to rank-16 ratings, whose Gram has a few large and
      many small eigenvalues.
    Both are also held to the f64 solve of the same system: a D < K kernel
    result beyond 1e-4 of the plain version (:func:`als_kernel_phase`) and
    every main-path chunk's first rows (:func:`time_als`) may be no more
    than 3x as far from it as the plain version, so the looser bound holds
    only where the plain version's own f32 sums are that far from exact.
    Beyond the bound only the rows of a D < K system may pass: every row
    beyond it, those rows together held to their f64 solve by the same
    3x. The narrow ML-20M cases of :func:`als_cases` pass past the bound
    by that rule and within ``NARROW_CEILING`` of the plain version or of
    the f64 solve; every other case of :func:`als_kernel_phase` fails past
    it."""
    if trained or d < k or dtype == torch.bfloat16:
        return 1e-3
    return 1e-4


def als_kernel_phase(dev, ak, chunk_elems: int, small: bool = False):
    """Every ALS kernel entry against its plain version: each case in f32
    and bf16, cold and warm, R = 1 and R = 8 and fused, plus the fused
    implicit variant with YᵀY, each held to :func:`als_tolerance`; a
    system with D < K is also compared with the f64 solve of the system
    the kernel solves (``vs f64`` and ``plain vs f64`` in the relative
    errors, always in f32), which binds beyond 1e-4 of the plain version
    in f32 (the rule of :func:`als_tolerance`: no more than 3x as far from
    it as the plain version); past the tolerance a case fails, but for the
    narrow buckets' D < K systems (d 8-32 at rank 128, whose unconverged
    CG leaves every entry up to ~3e-2 from the plain version), which pass
    past it, in f32 and bf16, by the f64 rule and within
    ``NARROW_CEILING`` of the plain version or of the f64 solve. The fused
    entry must give exactly 0 on
    an empty row. Returns ({entry: max abs error}, {entry dtype: max
    relative error}, #checks); raises after the last case with every
    failure."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rng = np.random.default_rng(5)
    errs = {"als_solve_cg": 0.0, "als_solve_cg_rows8": 0.0,
            "als_fused_solve_cg": 0.0}
    worst = {}
    failures = []
    checks = 0

    def check(entry, got, ref, tol, what, exact=None, ceiling=None):
        """``exact``: for a D < K system, a function giving its f64 solve
        (called where the rule below needs it); ``ceiling``: where such a
        system may pass past ``tol``, the most it may be from the nearer
        of the plain version and the f64 solve (None: it may not)."""
        nonlocal checks
        sync(dev)
        checks += 1
        if not bool(torch.isfinite(got).all()):
            failures.append(f"{what}: non-finite output")
            return
        err, rel = _rel_err(got, ref)
        errs[entry] = max(errs[entry], err)
        dname = what.split()[2]
        key = (f"{entry} {dname}{' implicit' if 'implicit' in what else ''}"
               f"{' D<K' if exact is not None else ''}")
        worst[key] = max(worst.get(key, 0.0), rel)
        if rel > tol and (exact is None or ceiling is None):
            failures.append(f"{what}: max error {err:.3e} is {rel:.3e} of "
                            f"max|x_plain|, above {tol}")
            return
        # past the dtype's bound (1e-4 f32, the tolerance in bf16) a D < K
        # system passes only as far as the plain version is itself as far
        # from exact arithmetic (als_tolerance's rule)
        bound = 1e-4 if dname == "f32" else tol
        if exact is None or (rel <= bound and dname != "f32"):
            return
        x64 = exact()
        k_f64 = _rel_err(got.double(), x64)[1]
        p_f64 = _rel_err(ref.double(), x64)[1]
        worst[f"{key} vs f64"] = max(worst.get(f"{key} vs f64", 0.0), k_f64)
        worst[f"{key} plain vs f64"] = max(
            worst.get(f"{key} plain vs f64", 0.0), p_f64)
        if rel > bound and k_f64 > 3 * p_f64 + 1e-6:
            failures.append(f"{what}: {k_f64:.3e} of max|x_f64| from the f64 "
                            f"solve, the plain version {p_f64:.3e} (max "
                            f"error {rel:.3e} of max|x_plain|)")
        elif rel > tol and min(rel, k_f64) > ceiling:
            failures.append(f"{what}: {rel:.3e} of max|x_plain| from the "
                            f"plain version and {k_f64:.3e} of max|x_f64| "
                            f"from the f64 solve, both above {ceiling}")

    for (name, m_two, m_fused, k, b_two, b_fused, d, l2, reg_nnz, iters,
         density, implicit_dtypes) in als_cases(chunk_elems, small):
        if k > 128 and not hasattr(ak, "solve_plan"):
            continue  # an older A/B copy, which stops at 128
        ceiling = (NARROW_CEILING if name in
                   {f"ml20m_d{w}" for w in NARROW_WIDTHS} else None)
        for side, m, b in (("two", m_two, b_two), ("fused", m_fused,
                                                   b_fused)):
            table, cols, vals, mask, x0 = als_problem(rng, m, k, b, d,
                                                      density)
            table_f32, cols, vals, mask, x0 = (t(table), t(cols), t(vals),
                                               t(mask), t(x0))
            empty = mask.sum(-1) == 0
            for dname, dtype in (("f32", torch.float32),
                                 ("bf16", torch.bfloat16)):
                tol = als_tolerance(dtype, d, k)
                table_dt = table_f32.to(dtype)
                # a D < K system is also held to its f64 solve: the system
                # the kernel solves, the table's and the rhs weights'
                # values rounded to the table's dtype
                tab64, vals64 = table_dt.float(), vals.to(dtype).float()
                for warm in (None, x0):
                    what = (f"{name} {side} {dname} "
                            f"{'warm' if warm is not None else 'cold'}")
                    if side == "two":
                        ref = ak.als_solve_cg_plain(
                            table_dt, cols, vals, mask, l2, reg_nnz, iters,
                            x0=warm)
                        exact = (functools.partial(
                            f64_solve, ak, tab64, cols, vals64, mask, l2,
                            reg_nnz, iters, warm, False) if d < k else None)
                        for rows, entry in ((1, "als_solve_cg"),
                                            (8, "als_solve_cg_rows8")):
                            got = ak.als_solve_cg(
                                table_dt, cols, vals, mask, l2, reg_nnz,
                                iters, rows_per_program=rows, x0=warm)
                            check(entry, got, ref, tol, f"{what} R={rows}",
                                  exact, ceiling)
                        continue
                    variants = [(False, None, iters)]
                    if dname in implicit_dtypes:
                        yty = table_dt.float().T @ table_dt.float()
                        variants.append((True, yty, 2 * iters))
                    for implicit, yty, n_it in variants:
                        kw = dict(implicit=implicit, alpha=2.0, yty=yty,
                                  x0=warm)
                        ref = ak.als_fused_solve_cg_plain(
                            table_dt, cols, vals, mask, l2, reg_nnz, n_it,
                            **kw)
                        got = ak.als_fused_solve_cg(
                            table_dt, cols, vals, mask, l2, reg_nnz, n_it,
                            **kw)
                        exact = (functools.partial(
                            f64_solve, ak, tab64, cols, vals64, mask, l2,
                            reg_nnz, n_it, warm, True, implicit, 2.0, yty)
                                 if d < k else None)
                        w = f"{what}{' implicit' if implicit else ''}"
                        check("als_fused_solve_cg", got, ref, tol, w, exact,
                              ceiling)
                        if bool((got[empty] != 0).any()):
                            failures.append(f"{w}: an empty row is not "
                                            "exactly 0")
    if failures:
        raise AssertionError(f"{len(failures)} of {checks} ALS kernel checks "
                             "failed:\n" + "\n".join(failures)
                             + f"\nworst relative errors: {worst}")
    return errs, worst, checks


def als_edge_phase(dev, ak):
    """Both ALS entries at the edges of their split-D design, f32 and bf16,
    cold and warm, each against its plain version at :func:`als_tolerance`:
    D = 1, D no multiple of a slab or of the slices, ranks 10 / 16 / 24 /
    32 / 64 / 128 and 160 / 256 (Gram tiles), masks with fractional
    weights (``_frac``: the plain versions weigh by them), a row with no
    observation (row 3 of every problem: exactly 0 from the fused entry),
    and the same rows under a one-slice plan and a many-slice plan
    (``n_sms`` 1 and 1,000 in ``solve_plan``), held to the plain version
    and to each other.
    A system with D < K beyond the tolerance (a singular Gram, which 16 CG
    steps iterate on past convergence, amplifying the order of sums) is
    held instead to the f64 solve of the same system: no more than 3x as
    far from it as the plain version, the rule of :func:`als_tolerance`.
    Returns (#checks, max relative error by case kind); raises with every
    failure."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rng = np.random.default_rng(9)
    cases = [("d1", 60, 32, 5, 1, None), ("d1_k128", 60, 128, 4, 1, None),
             ("d1000_k64", 400, 64, 5, 1000, None),
             ("d700_k24", 300, 24, 6, 700, 0.7),
             ("d333_k10", 200, 10, 6, 333, 0.8)]
    cases += [(f"d{d}_k{k}", 500, k, 6, d, None)
              for k in (16, 32, 64, 128) for d in (130, 2500)]
    # the plans run on the card only; an older A/B copy has no fused plan
    # and no tiles above 128
    split = dev.type == "cuda" and hasattr(ak, "_two_stage")
    tiled = hasattr(ak, "solve_plan")
    # masks of weights other than 0 and 1 (the buckets hold only those)
    cases += [("d300_k128_frac", 500, 128, 6, 300, None),
              ("d700_k64_frac", 400, 64, 6, 700, None)]
    if tiled:
        cases += [("d1_k160", 60, 160, 4, 1, None),
                  ("d3000_k160", 900, 160, 5, 3000, None),
                  ("d9000_k256", 900, 256, 3, 9000, None),
                  ("d500_k256_frac", 800, 256, 4, 500, None)]
    failures, checks, worst = [], 0, {}
    for name, m, k, b, d, density in cases:
        table, cols, vals, mask, x0 = (t(a) for a in als_problem(
            rng, m, k, b, d, density))
        if name.endswith("_frac"):
            mask = mask * t(rng.choice(np.float32([0.25, 0.5, 0.7, 1, 1.5]),
                                       (b, d)))
        empty = int(torch.nonzero(mask.sum(-1) == 0)[0, 0])
        for dtype in (torch.float32, torch.bfloat16):
            tol = als_tolerance(dtype, d, k)
            tab = table.to(dtype)
            for warm in (None, x0):
                for fused in ((False, True) if tiled else (False,)):
                    what = (f"{name} {'fused' if fused else 'two'} "
                            f"{str(dtype)[6:]} "
                            f"{'warm' if warm is not None else 'cold'}")
                    if fused:
                        ref = ak.als_fused_solve_cg_plain(
                            tab, cols, vals, mask, 0.05, x0=warm)
                        outs = {"plan": ak.als_fused_solve_cg(
                            tab, cols, vals, mask, 0.05, x0=warm)}
                    else:
                        ref = ak.als_solve_cg_plain(tab, cols, vals, mask,
                                                    0.05, x0=warm)
                        outs = {"plan": ak.als_solve_cg(
                            tab, cols, vals, mask, 0.05, x0=warm)}
                    if split:
                        for n_sms in (1, 1000):
                            args = (tab, cols, vals, mask, 0.05, True, 16)
                            outs[f"n_sms={n_sms}"] = (
                                ak._fused(*args, False, 1.0, None, warm,
                                          n_sms=n_sms) if fused else
                                ak._two_stage(*args, 1, warm, n_sms=n_sms))
                    # the system the kernel solves, in f64: the table's and
                    # the rhs weights' values rounded to the table's dtype
                    exact = (f64_solve(ak, tab.float(), cols,
                                       vals.to(dtype).float(), mask, 0.05,
                                       True, 16, warm, fused)
                             if d < k else None)
                    sync(dev)
                    for tag, got in outs.items():
                        checks += 1
                        err, rel = _rel_err(got, ref)
                        key = str(dtype)[6:]
                        worst[key] = max(worst.get(key, 0), rel)
                        if fused and bool((got[empty] != 0).any()):
                            failures.append(f"{what} {tag}: the empty row "
                                            "is not exactly 0")
                        row_err = float((got[empty] - ref[empty]).abs().max())
                        far = rel > tol or row_err > tol * max(
                            float(ref.abs().max()), 1e-30)
                        if far and exact is not None:
                            k_f64 = _rel_err(got.double(), exact)[1]
                            p_f64 = _rel_err(ref.double(), exact)[1]
                            for wk, v in ((f"{key} D<K vs f64", k_f64),
                                          (f"{key} D<K plain vs f64", p_f64)):
                                worst[wk] = max(worst.get(wk, 0.0), v)
                            if k_f64 > 3 * p_f64 + 1e-6:
                                failures.append(
                                    f"{what} {tag}: {k_f64:.3e} from the f64 "
                                    f"solve, the plain version {p_f64:.3e}")
                        elif not bool(torch.isfinite(got).all()) or rel > tol:
                            failures.append(f"{what} {tag}: {rel:.3e} of "
                                            f"max|x_plain|, above {tol}")
                        elif far:
                            failures.append(f"{what} {tag}: the empty row is "
                                            f"{row_err:.3e} from the plain "
                                            "one")
                    if split and exact is None:  # D < K: both held to f64
                        checks += 1
                        rel = _rel_err(outs["n_sms=1000"], outs["n_sms=1"])[1]
                        worst["slices"] = max(worst.get("slices", 0.0), rel)
                        if rel > tol:
                            failures.append(f"{what}: one slice and many "
                                            f"differ by {rel:.3e} of max|x|")
    if failures:
        raise AssertionError(f"{len(failures)} of {checks} ALS edge checks "
                             "failed:\n" + "\n".join(failures))
    return checks, worst


# -- ALS training: the second main path -----------------------------------------

def planted_training_data(planted, base, interactions_mod, engine, small):
    """The planted ratings as the template's columnar ``TrainingData``, and
    the in-memory data source the engine reads them from."""
    if small:
        users, items, ratings, heldout = planted.planted_ratings(
            n_users=400, n_items=300, nnz=20_000, n_holdout=2_000)
        n_users, n_items = 400, 300
    else:
        users, items, ratings, heldout = planted.planted_ratings()
        n_users, n_items = planted.ML20M_USERS, planted.ML20M_ITEMS
    td = engine.TrainingData(interactions=interactions_mod.Interactions(
        user_idx=users, item_idx=items, values=ratings,
        user_ids=[f"u{i}" for i in range(n_users)],
        item_ids=[f"i{i}" for i in range(n_items)]))

    class PlantedDataSource(base.DataSource):
        def read_training(self, ctx):
            return td

    return td, heldout, PlantedDataSource


#: the kernel entry of each route of ops/als._route
ROUTE_ENTRY = {"fused": "als_fused_solve_cg", "rows1": "als_solve_cg",
               "rows8": "als_solve_cg_rows8"}


def path_entries(als, trees, rank: int) -> list:
    """The ALS kernel entries a training run at ``rank`` on these (user,
    item) bucket trees launches, by ``als._route`` at its defaults (the
    kernels on for every bucket, both sides fused where the routing takes
    the fused entry)."""
    routes = {als._route(cols.shape[1], rank, True, 0, True)
              for tree in trees for _r, cols, _v, _m in tree}
    return sorted(ROUTE_ENTRY[r] for r in routes if r in ROUTE_ENTRY)


def route_chunk(als, tree, route: str, chunk_elems: int):
    """(cols, vals, mask, row_ids) of the chunk, as the sweep cuts a bucket
    into chunks, with the most observations among the buckets of one side
    that ``als._route`` sends to ``route``; None where none is."""
    best, best_nnz = None, -1.0
    for row_ids, cols, vals, mask in tree:
        d = cols.shape[1]
        if als._route(d, ML20M["rank"], True, 0, True) != route:
            continue
        n = (fused_rows if route == "fused" else two_stage_rows)(
            d, ML20M["rank"], chunk_elems)
        for s0 in range(0, cols.shape[0], n):
            nnz = float(mask[s0:s0 + n].sum())
            if nnz > best_nnz:
                sl = slice(s0, s0 + n)
                best_nnz = nnz
                best = (cols[sl], vals[sl], mask[sl], row_ids[sl])
    return best


def heaviest_chunks_by_width(tree, rank: int, chunk_elems: int) -> dict:
    """{D: (cols, vals, mask, row_ids)}: the fused route's chunk with the
    most observations at each bucket width of one side."""
    best = {}
    for row_ids, cols, vals, mask in tree:
        d = cols.shape[1]
        n = fused_rows(d, rank, chunk_elems)
        if d not in best or float(mask[:n].sum()) > float(best[d][2].sum()):
            best[d] = (cols[:n], vals[:n], mask[:n], row_ids[:n])
    return best


def heaviest_chunk(tree, rank: int, chunk_elems: int, fused: bool):
    """(cols, vals, mask, row_ids) of the chunk with the most observations
    on one side of the main path."""
    best, best_nnz = None, -1.0
    for row_ids, cols, vals, mask in tree:
        d = cols.shape[1]
        n = (fused_rows if fused else two_stage_rows)(d, rank, chunk_elems)
        nnz = float(mask[:n].sum())
        if nnz > best_nnz:
            best_nnz = nnz
            best = (cols[:n], vals[:n], mask[:n], row_ids[:n])
    return best


def train_phase(dev, runtime, als, engine, base, params_mod, context,
                interactions_mod, planted, small: bool = False,
                sweeps: int = 4, bf16_sweeps: int = 2, seed: int = 3):
    """Train the planted ratings through ``Engine.train`` (the kernels),
    then the same prepared data from the same initial state with
    ``use_kernel=False`` (the plain route). Returns (model, stats, pieces
    for the timing of the heaviest buckets)."""
    rank = 16 if small else ML20M["rank"]
    t0 = time.perf_counter()
    td, heldout, source = planted_training_data(planted, base,
                                                interactions_mod, engine,
                                                small)
    gen_s = time.perf_counter() - t0
    eng = base_engine(engine, source)
    algo_params = engine.ALSAlgorithmParams(
        rank=rank, num_iterations=sweeps, lambda_=0.03,
        bf16_sweeps=bf16_sweeps, seed=seed)
    ep = params_mod.EngineParams(algorithm_params_list=[("als",
                                                         algo_params)])
    ctx = context.RuntimeContext(device=dev)
    runtime.reset_launch_counts()
    [model] = eng.train(ctx, ep)
    counts = runtime.launch_counts()
    timings = dict(ctx.timings)

    pd = engine.RecommendationPreparator().prepare(ctx, td)
    t0 = time.perf_counter()
    u_tree, i_tree, u_hv, i_hv = als.prepare_trees(
        pd.users, pd.items, pd.ratings, len(pd.user_bimap),
        len(pd.item_bimap), device=dev)
    state0 = als.als_init(torch.Generator().manual_seed(seed),
                          len(pd.user_bimap), len(pd.item_bimap), rank,
                          device=dev)
    plain_prep_s = time.perf_counter() - t0
    routes = host_routes(dev, als, engine, ctx, td, pd,
                         (u_tree, i_tree, u_hv, i_hv))
    routes["engine_prepare_s"] = timings["prepare"]
    routes["engine_als_prep_s"] = timings["als.prep"]
    t0 = time.perf_counter()
    plain = als._mixed_run(state0, u_tree, i_tree, 0.03, sweeps,
                           bf16_sweeps, True, torch.float32, u_hv, i_hv,
                           use_kernel=False)
    sync(dev)
    plain_sweeps_s = time.perf_counter() - t0

    trained = als.ALSState(user_factors=model.user_factors,
                           item_factors=model.item_factors)
    for what, st in (("kernel route", trained), ("plain route", plain)):
        for f in (st.user_factors, st.item_factors):
            if not bool(torch.isfinite(f).all()):
                raise AssertionError(f"{what}: non-finite factors")
    fit = als.rmse(trained, pd.users, pd.items, pd.ratings)
    fit_plain = als.rmse(plain, pd.users, pd.items, pd.ratings)
    ho_u, ho_i, ho_r = heldout
    ho = als.rmse(trained, ho_u, ho_i, ho_r)
    ho_plain = als.rmse(plain, ho_u, ho_i, ho_r)
    stdev = float(np.std(pd.ratings))
    # every entry ops/als.py routes a bucket of these trees to must have
    # launched
    on_path = path_entries(als, (u_tree, i_tree), rank)
    if dev.type == "cuda" and any(counts[e] <= 0 for e in on_path):
        raise AssertionError(f"training launched {counts}; {on_path} must "
                             "run on the path")
    if not fit < max(1.15 * fit_plain, fit_plain + 0.02):
        raise AssertionError(f"fit RMSE {fit:.4f} against the plain route's "
                             f"{fit_plain:.4f}")
    if not small and not ho < 0.8:
        raise AssertionError(f"heldout RMSE {ho:.4f} is not below 0.8")
    if not small and i_hv is None:
        raise AssertionError("no item was split: the heavy path did not run")
    stats = {
        "users": len(pd.user_bimap), "items": len(pd.item_bimap),
        "nnz": int(len(pd.ratings)), "rank": rank, "sweeps": sweeps,
        "bf16_sweeps": bf16_sweeps, "generate_s": gen_s,
        "engine_timings_s": timings, "plain_prep_s": plain_prep_s,
        "plain_sweeps_s": plain_sweeps_s, "fit_rmse": fit,
        "fit_rmse_plain": fit_plain, "heldout_rmse": ho,
        "heldout_rmse_plain": ho_plain, "ratings_stdev": stdev,
        "host_routes": routes,
        "heavy_items": 0 if i_hv is None else int(i_hv[1].shape[0]),
        "heavy_users": 0 if u_hv is None else int(u_hv[1].shape[0]),
        "launches": {k: counts[k] for k in
                     ("als_fused_solve_cg", "als_solve_cg",
                      "als_solve_cg_rows8")},
        "on_path": on_path,
    }
    return model, pd, eng, ep, stats, (u_tree, i_tree, plain)


def same_trees(a, b, what: str) -> int:
    """Two ``prepare_trees`` results hold equal tensors, bit for bit;
    returns the number of tensors compared."""
    flat_a = [t for part in a if part is not None
              for t in torch.utils._pytree.tree_leaves(part)]
    flat_b = [t for part in b if part is not None
              for t in torch.utils._pytree.tree_leaves(part)]
    if len(flat_a) != len(flat_b):
        raise AssertionError(f"{what}: {len(flat_a)} tensors against "
                             f"{len(flat_b)}")
    for k, (x, y) in enumerate(zip(flat_a, flat_b)):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{what}: tensor {k} differs")
    return len(flat_a)


def same_rows(a, b, what: str) -> int:
    """Two sides' bucket trees (``(row_ids, cols, vals, mask)`` per
    bucket) hold the same rows: each live row at the same width, with the
    same cols, vals and mask, bit for bit, whatever the bucket layout (a
    reused plan keeps cleared slots and appends buckets). Returns the rows
    compared."""
    def by_width(tree):
        out: dict = {}
        for rids, cols, vals, mask in tree:
            live = rids >= 0
            out.setdefault(cols.shape[1], []).append(
                (rids[live], cols[live], vals[live], mask[live]))
        merged = {}
        for w, parts in out.items():
            rids, cols, vals, mask = (torch.cat(x) for x in zip(*parts))
            order = torch.argsort(rids)
            merged[w] = (rids[order], cols[order], vals[order], mask[order])
        return merged

    wa, wb = by_width(a), by_width(b)
    widths = sorted(set(wa) | set(wb))
    rows = 0
    for w in widths:
        xa = wa.get(w, (torch.empty(0),) * 4)
        xb = wb.get(w, (torch.empty(0),) * 4)
        if xa[0].numel() == xb[0].numel() == 0:
            continue
        for x, y in zip(xa, xb):
            if x.dtype != y.dtype or x.shape != y.shape or \
                    not torch.equal(x, y):
                raise AssertionError(f"{what}: the rows of width {w} differ")
        rows += int(xa[0].numel())
    return rows


def numpy_latest_wins(users, items, n_items: int) -> np.ndarray:
    """The plain version of ``ops/sparse.latest_wins``, the JAX
    preparator's route: one ``np.unique`` over the reversed packed keys,
    on the host."""
    keys = np.asarray(users, np.int64) * max(int(n_items), 1) \
        + np.asarray(items, np.int64)
    _, first_in_rev = np.unique(keys[::-1], return_index=True)
    return np.sort(len(keys) - 1 - first_in_rev)


def numpy_prepare(engine, td):
    """The recommendation preparator's columnar route with the dedup by
    :func:`numpy_latest_wins` on the host: the JAX package's
    ``_prepare_columnar``."""
    from incubator_predictionio_tpu_torch.data.bimap import BiMap

    inter = td.interactions
    user_bimap = BiMap({u: i for i, u in enumerate(inter.user_ids)})
    item_bimap = BiMap({t: i for i, t in enumerate(inter.item_ids)})
    keep = numpy_latest_wins(inter.user_idx, inter.item_idx,
                             len(inter.item_ids))
    return engine.PreparedData(
        users=inter.user_idx[keep], items=inter.item_idx[keep],
        ratings=inter.values[keep], user_bimap=user_bimap,
        item_bimap=item_bimap, item_years=td.item_years,
        item_categories=td.item_categories)


def host_routes(dev, als, engine, ctx, td, pd, trees, n_dups: int = 2_000_000,
                seed: int = 5) -> dict:
    """The host phases of ``Engine.train`` on both routes, held equal bit
    for bit: the preparator with its dedup on the device (the path's) and
    by ``np.unique`` on the host (the JAX package's route), the buckets
    from the native builder (the path's, ``trees``) and from numpy; then
    the two dedups again on the triples with ``n_dups`` repeated pairs
    appended (the planted pairs are distinct). Returns the walls."""
    from incubator_predictionio_tpu_torch.ops import sparse

    t0 = time.perf_counter()
    pd_dev = engine.RecommendationPreparator().prepare(ctx, td)
    device_prepare_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pd_np = numpy_prepare(engine, td)
    numpy_prepare_s = time.perf_counter() - t0
    for f in ("users", "items", "ratings"):
        for got in (pd_dev, pd_np):
            a, b = getattr(got, f), getattr(pd, f)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"prepare routes: {f} differ")
    inter = td.interactions
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(len(inter), min(n_dups, len(inter)),
                              replace=False))
    users = np.concatenate([inter.user_idx, inter.user_idx[pick]])
    items = np.concatenate([inter.item_idx, inter.item_idx[pick]])
    n_items = len(inter.item_ids)
    sync(dev)
    t0 = time.perf_counter()
    keep_dev = sparse.latest_wins(users, items, n_items, dev)
    dup_device_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    keep_np = numpy_latest_wins(users, items, n_items)
    dup_numpy_s = time.perf_counter() - t0
    if not np.array_equal(keep_dev, keep_np):
        raise AssertionError("dedup routes differ on repeated pairs")
    distinct = len(np.unique(users.astype(np.int64) * n_items + items))
    if len(keep_dev) != distinct:
        raise AssertionError(f"dedup kept {len(keep_dev)} of {distinct} "
                             "distinct pairs")
    t0 = time.perf_counter()
    native_trees = als.prepare_trees(
        pd.users, pd.items, pd.ratings, len(pd.user_bimap),
        len(pd.item_bimap), device=dev, impl="native")
    sync(dev)
    native_prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    numpy_trees = als.prepare_trees(
        pd.users, pd.items, pd.ratings, len(pd.user_bimap),
        len(pd.item_bimap), device=dev, impl="numpy")
    sync(dev)
    numpy_prep_s = time.perf_counter() - t0
    compared = same_trees(native_trees, trees, "native buckets, twice")
    same_trees(numpy_trees, trees, "numpy buckets against native")
    del native_trees, numpy_trees
    return {"prepare_device_s": device_prepare_s,
            "prepare_numpy_s": numpy_prepare_s,
            "als_prep_native_s": native_prep_s,
            "als_prep_numpy_s": numpy_prep_s,
            "bucket_tensors_equal": compared,
            "dedup_repeated_pairs": int(len(pick)),
            "dedup_repeated_device_s": dup_device_s,
            "dedup_repeated_numpy_s": dup_numpy_s}


def rank_train_phase(dev, runtime, als, planted, small: bool = False):
    """Training above rank 128 on the card (A1): planted ratings (4,000
    users x 2,000 items, 400,000 ratings) at rank 160 and 256 through the
    kernels, every bucket routed to them (the fused entry on the user side,
    the two-stage one on the item side), 3 sweeps (1 bf16), then the plain
    route from the same initial state: both entries must launch and the
    fit RMSE must be within the reference's parity bound of the plain
    route's; then ``als_train`` itself at each rank (its launches counted).
    Returns stats by rank."""
    n_u, n_i, nnz = (400, 300, 20_000) if small else (4000, 2000, 400_000)
    users, items, ratings, _ = planted.planted_ratings(
        n_users=n_u, n_items=n_i, nnz=nnz, n_holdout=1000, seed=9)
    trees = als.prepare_trees(users, items, ratings, n_u, n_i, device=dev)
    out = {}
    for rank in (160, 256):
        init = als.als_init(torch.Generator().manual_seed(rank), n_u, n_i,
                            rank, device=dev)
        fits, launches = [], {}
        for use_kernel in (True, False):
            runtime.reset_launch_counts()
            st = als._mixed_run(init, trees[0], trees[1], 0.03, 3, 1, True,
                                torch.float32, trees[2], trees[3],
                                use_kernel=use_kernel, use_fused=(True, False))
            sync(dev)
            counts = runtime.launch_counts()
            for f in (st.user_factors, st.item_factors):
                if not bool(torch.isfinite(f).all()):
                    raise AssertionError(f"rank {rank}: non-finite factors")
            if use_kernel:
                launches = {k: counts[k] for k in ("als_fused_solve_cg",
                                                   "als_solve_cg")}
            fits.append(als.rmse(st, users, items, ratings))
        if dev.type == "cuda" and min(launches.values()) <= 0:
            raise AssertionError(f"rank {rank}: kernel launches {launches}")
        if not fits[0] < max(1.15 * fits[1], fits[1] + 0.02):
            raise AssertionError(f"rank {rank}: fit RMSE {fits[0]:.4f} "
                                 f"against the plain route's {fits[1]:.4f}")
        runtime.reset_launch_counts()
        state, _ = als.als_train(users, items, ratings, n_u, n_i, rank=rank,
                                 iterations=2, l2=0.03, device=dev)
        sync(dev)
        counts = runtime.launch_counts()
        train_launches = {k: counts[k] for k in ("als_fused_solve_cg",
                                                  "als_solve_cg")}
        if dev.type == "cuda" and sum(train_launches.values()) <= 0:
            raise AssertionError(f"als_train at rank {rank} launched no ALS "
                                 "kernel")
        if tuple(state.user_factors.shape) != (n_u, rank) or not bool(
                torch.isfinite(state.user_factors).all()):
            raise AssertionError(f"als_train at rank {rank}: bad factors")
        out[rank] = {"fit_rmse": fits[0], "fit_rmse_plain": fits[1],
                     "launches": launches,
                     "als_train_launches": train_launches}
    return out


def base_engine(engine, source):
    """The template's engine with an in-memory data source in its slot."""
    from incubator_predictionio_tpu_torch.core.engine import Engine

    return Engine(source, engine.RecommendationPreparator,
                  {"als": engine.ALSAlgorithm}, engine.RecommendationServing)


def serve_trained_phase(dev, runtime, kernels, server_mod, model, pd, eng,
                        ep):
    """The trained model behind ``PredictionServer``: a few /queries.json
    answers, each against the plain top-k on the trained factors."""
    n_users, n_items = len(pd.user_bimap), len(pd.item_bimap)
    rng = np.random.default_rng(6)
    pick = rng.choice(n_users, 10, replace=False)
    docs = [({"user": f"u{u}", "num": 10}, None) for u in pick[:4]]
    docs += [({"user": f"u{u}", "num": 100}, None) for u in pick[4:6]]
    for u in pick[6:9]:
        mask = np.ones(n_items, bool)
        mask[model.user_seen[int(u)]] = False
        docs.append(({"user": f"u{u}", "num": 20, "excludeSeen": True}, mask))
    docs.append(({"user": "nosuch-1", "num": 10}, None))
    srv = server_mod.PredictionServer(eng, ep, [model], device=dev)
    port = srv.start_background()
    try:
        runtime.reset_launch_counts()
        answers = [post(port, doc) for doc, _m in docs]
        launches = runtime.launch_counts()["score_topk"]
    finally:
        srv.stop()
    err = 0.0
    for i, ((doc, mask), body) in enumerate(zip(docs, answers)):
        err = max(err, check_answer(kernels, dev, model.user_factors,
                                    model.item_factors, doc, mask, body,
                                    f"trained query {i} {list(doc)}"))
    device_queries = len(docs) - 1
    if dev.type == "cuda" and launches < device_queries:
        raise AssertionError(f"score_topk launched {launches} times for "
                             f"{device_queries} device queries")
    return launches, err, {"queries": len(docs), "launches": launches}


# -- the stored main path: event store → run_train → checkpoint → deploy -------

STORE_T0 = "2024-01-01T00:00:00Z"


@contextlib.contextmanager
def temp_store():
    """The port's Storage on the zero-config SQLite default under a fresh
    temporary ``PIO_HOME`` (no ``PIO_STORAGE_*`` variables), put back as
    it was afterwards."""
    from incubator_predictionio_tpu_torch.data.storage import Storage

    saved = {k: v for k, v in os.environ.items()
             if k == "PIO_HOME" or k.startswith("PIO_STORAGE_")}
    with tempfile.TemporaryDirectory(prefix="pio_home_") as home:
        for k in saved:
            del os.environ[k]
        os.environ["PIO_HOME"] = home
        Storage.reset()
        try:
            yield home
        finally:
            Storage.reset()
            os.environ.pop("PIO_HOME", None)
            os.environ.update(saved)


def new_app(name: str) -> int:
    """What ``pio app new`` does through the metadata DAOs: the app, its
    event store and an access key."""
    from incubator_predictionio_tpu_torch.data.storage import (
        AccessKey,
        App,
        Storage,
    )

    app_id = Storage.get_meta_data_apps().insert(App(0, name))
    Storage.get_events().init(app_id)
    if not Storage.get_meta_data_access_keys().insert(AccessKey("", app_id)):
        raise AssertionError("no access key was made")
    return app_id


def keep_trained(eng) -> list:
    """The models ``eng.train`` returns, kept for a check: ``run_train``
    returns only the instance id."""
    kept: list = []
    train = eng.train

    def keeping(*args, **kw):
        kept[:] = train(*args, **kw)
        return kept[:]

    eng.train = keeping
    return kept


def insert_events(events, app_id: int, chunk: int = 20_000) -> float:
    """Events into the store in batches; returns the wall."""
    from incubator_predictionio_tpu_torch.data.storage import Storage

    dao = Storage.get_events()
    t0 = time.perf_counter()
    for k in range(0, len(events), chunk):
        dao.insert_batch(events[k:k + chunk], app_id)
    return time.perf_counter() - t0


def store_als_ratings(planted, small: bool = False):
    """(users, items, ratings, n_users, n_items) of store-als: 1,000,000
    planted ratings over every ML-20M user and item (400 × 300 × 20,000
    when ``small``)."""
    if small:
        n_users, n_items, nnz = 400, 300, 20_000
    else:
        n_users, n_items, nnz = ML20M["users"], ML20M["items"], 1_000_000
    users, items, ratings, _ = planted.planted_ratings(
        n_users=n_users, n_items=n_items, nnz=nnz, n_holdout=1000,
        cover=True)
    return users, items, ratings, n_users, n_items


def store_als_phase(dev, runtime, kernels, als, engine, planted, params_mod,
                    context, server_mod, small: bool = False, seed: int = 3):
    """ALS through the event store at ML-20M width: an app made as ``pio
    app new`` makes it; 1,000,000 planted ratings (seed 7) over all
    138,493 users and 26,744 items, every one rated, imported through
    ``import_interactions``, and each item's ``$set`` categories; then
    ``CoreWorkflow.run_train`` with the quickstart's params (``appName``;
    rank 128, 4 sweeps, 2 in bf16, λ 0.03) → ``load_models`` →
    ``PredictionServer`` → POST /queries.json. Checks: the store's triples
    are the planted ones, the decoded factors the trained ones bit for bit,
    every answer the plain top-k on them, the fit RMSE within the parity
    bound of the plain route's from the same initial state and within 1e-3
    of it, relative (each factor table's distance from the plain route's
    is reported), and the fused
    ALS and score+top-k kernels launched on the path. Returns (launches by
    kernel, max score error, stats, the trees, trained and plain states of
    the ALS timings, and the SQLite reference of the cpplog phase: the
    read's (user, item, value) triples, the fit and the walls)."""
    from incubator_predictionio_tpu_torch.data.datamap import DataMap
    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.data.interactions import (
        Interactions,
    )
    from incubator_predictionio_tpu_torch.data.storage import Storage
    from incubator_predictionio_tpu_torch.utils.times import parse_iso8601
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    rank = 16 if small else ML20M["rank"]
    name = "store-als"
    with temp_store():
        app_id = new_app(name)
        t0 = time.perf_counter()
        users, items, ratings, n_users, n_items = store_als_ratings(
            planted, small)
        nnz = len(ratings)
        user_ids = [f"u{k}" for k in range(n_users)]
        item_ids = [f"i{k}" for k in range(n_items)]
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        Storage.get_events().import_interactions(
            Interactions(user_idx=users, item_idx=items, values=ratings,
                         user_ids=user_ids, item_ids=item_ids),
            app_id, base_time=parse_iso8601(STORE_T0))
        import_s = time.perf_counter() - t0
        cats = np.random.default_rng(8).integers(0, 20, n_items)
        set_s = insert_events(
            [Event(event="$set", entity_type="item", entity_id=item_ids[k],
                   properties=DataMap({"categories": [
                       f"c{cats[k]}", f"c{(cats[k] + 7) % 20}"]}))
             for k in range(n_items)], app_id)

        eng = engine.RecommendationEngine().apply()
        kept = keep_trained(eng)
        ep = params_mod.EngineParams(
            data_source_params=("", engine.DataSourceParams(app_name=name)),
            algorithm_params_list=[("als", engine.ALSAlgorithmParams(
                rank=rank, num_iterations=4, lambda_=0.03, bf16_sweeps=2,
                seed=seed))])
        ctx = context.RuntimeContext(device=dev)
        runtime.reset_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        iid = CoreWorkflow.run_train(eng, ep, ctx=ctx)
        train_s = time.perf_counter() - t0
        timings = dict(ctx.timings)
        blob_bytes = len(Storage.get_model_data_models().get(iid).models)
        t0 = time.perf_counter()
        models = CoreWorkflow.load_models(iid, eng, ep, ctx=ctx)
        sync(dev)
        load_s = time.perf_counter() - t0
        model, trained = models[0], kept[0]
        for f in ("user_factors", "item_factors"):
            a, b = getattr(model, f), getattr(trained, f)
            if a.device != b.device or not torch.equal(a, b):
                raise AssertionError(f"store-als: decoded {f} differ from "
                                     "the trained ones")

        rng = np.random.default_rng(9)
        pick = rng.choice(n_users, 24, replace=False)
        docs = [({"user": f"u{u}", "num": 10}, None) for u in pick[:10]]
        docs += [({"user": f"u{u}", "num": 100}, None) for u in pick[10:14]]
        for u in pick[14:18]:
            mask = np.ones(n_items, bool)
            mask[model.user_seen[model.user_bimap[f"u{u}"]]] = False
            docs.append(({"user": f"u{u}", "num": 20, "excludeSeen": True},
                         mask))
        for u, c in zip(pick[18:22], (1, 4, 9, 16)):
            mask = np.zeros(n_items, bool)
            for item, idx in model.item_bimap.items():
                if f"c{c}" in model.item_categories.get(item, ()):
                    mask[idx] = True
            docs.append(({"user": f"u{u}", "num": 10,
                          "categories": [f"c{c}"]}, mask))
        docs.append(({"user": "nosuch-1", "num": 10}, None))
        srv = server_mod.PredictionServer(eng, ep, models, device=dev)
        port = srv.start_background()
        try:
            walls, answers = [], []
            for doc, _mask in docs:
                t0 = time.perf_counter()
                answers.append(post(port, doc))
                walls.append(time.perf_counter() - t0)
        finally:
            srv.stop()
        counts = runtime.launch_counts()

        err = 0.0
        for i, ((doc, mask), body) in enumerate(zip(docs, answers)):
            err = max(err, check_answer(
                kernels, dev, model.user_factors, model.item_factors, doc,
                mask, body, f"store-als query {i} {list(doc)}", model=model))
        # a second read of the store: the triples are the planted ones
        t0 = time.perf_counter()
        td = engine.RecommendationDataSource(
            engine.DataSourceParams(app_name=name)).read_training(ctx)
        reread_s = time.perf_counter() - t0
        inter = td.interactions
        u_num = np.array([int(x[1:]) for x in inter.user_ids])[inter.user_idx]
        i_num = np.array([int(x[1:]) for x in inter.item_ids])[inter.item_idx]
        if not (np.array_equal(u_num, users) and np.array_equal(i_num, items)
                and np.array_equal(inter.values, ratings)):
            raise AssertionError("store-als: the store's triples are not "
                                 "the planted ones")
        if (len(inter.user_ids), len(inter.item_ids)) != (n_users, n_items):
            raise AssertionError("store-als: not every user and item read")
        pd = engine.RecommendationPreparator().prepare(ctx, td)
    trees = als.prepare_trees(pd.users, pd.items, pd.ratings, n_users,
                              n_items, device=dev)
    state0 = als.als_init(torch.Generator().manual_seed(seed), n_users,
                          n_items, rank, device=dev)
    plain = als._mixed_run(state0, trees[0], trees[1], 0.03, 4, 2, True,
                           torch.float32, trees[2], trees[3],
                           use_kernel=False)
    # the four sweeps again, warm, in turns: as routed, and with every
    # bucket narrower than 64 on the plain route (the routing before the
    # R-row form took the narrow buckets)
    sweeps_s = {}
    for min_d in (0, 64, 64, 0):
        sync(dev)
        t0 = time.perf_counter()
        als._mixed_run(state0, trees[0], trees[1], 0.03, 4, 2, True,
                       torch.float32, trees[2], trees[3],
                       kernel_min_d=min_d)
        sync(dev)
        sweeps_s.setdefault(f"min_d_{min_d}", []).append(
            time.perf_counter() - t0)
    fit = als.rmse(als.ALSState(user_factors=trained.user_factors,
                                item_factors=trained.item_factors),
                   pd.users, pd.items, pd.ratings)
    fit_plain = als.rmse(plain, pd.users, pd.items, pd.ratings)
    if not fit < max(1.15 * fit_plain, fit_plain + 0.02):
        raise AssertionError(f"store-als: fit RMSE {fit:.4f} against the "
                             f"plain route's {fit_plain:.4f}")
    # the same run from the same initial state: beside the parity bound,
    # the fit within 1e-3 of the plain route's, relative
    fit_rel = abs(fit - fit_plain) / fit_plain
    if not fit_rel <= 1e-3:
        raise AssertionError(f"store-als: fit RMSE {fit!r} is {fit_rel:.2e} "
                             f"from the plain route's {fit_plain!r}")
    factor_rel = {f: _rel_err(getattr(trained, f), getattr(plain, f))[1]
                  for f in ("user_factors", "item_factors")}
    on_path = path_entries(als, trees[:2], rank)
    launches = {k: counts[k] for k in (*ROUTE_ENTRY.values(), "score_topk")}
    device_queries = len(docs) - 1
    if dev.type == "cuda" and (any(launches[e] <= 0 for e in on_path)
                               or launches["score_topk"] < device_queries):
        raise AssertionError(f"store-als: launches {launches}, on the path "
                             f"{on_path}")
    sqlite_ref = {"triples": (u_num, i_num, np.asarray(inter.values)),
                  "fit": fit, "figures": {
                      "store_als_import_events_per_s": nnz / import_s,
                      "store_als_read_s": timings.get("read"),
                      "store_als_run_train_s": train_s}}
    stats = {"users": n_users, "items": n_items, "ratings": nnz,
             "rank": rank, "generate_s": gen_s, "import_s": import_s,
             "import_events_per_s": nnz / import_s, "set_events": n_items,
             "set_s": set_s, "run_train_s": train_s,
             "engine_timings_s": timings, "blob_bytes": blob_bytes,
             "load_models_s": load_s, "queries": len(docs),
             "http_p50_ms": 1e3 * statistics.median(walls),
             "http_max_ms": 1e3 * max(walls), "reread_s": reread_s,
             "fit_rmse": fit, "fit_rmse_plain": fit_plain,
             "fit_rel_err": fit_rel, "factor_rel_err": factor_rel,
             "launches": launches, "on_path": on_path,
             "warm_sweeps_s": sweeps_s}
    return (launches, err, stats, (trees[0], trees[1], trained, plain),
            sqlite_ref)


def store_seq_phase(dev, runtime, tr, fa, seq_engine, planted, params_mod,
                    context, server_mod, small: bool = False, seed: int = 3):
    """The sequence engine through the event store: the train phase's 64
    planted sessions of 8,193 items as ``view`` events (524,352) →
    ``CoreWorkflow.run_train`` (``SequenceDataSource.read_training``;
    window 8,192, 26,744 items, batch 8, 1 epoch) → ``load_models`` →
    ``PredictionServer``: one query with ``recentItems``, then the same
    user without them twice, the history read from the store through
    ``find_by_entity`` and the second time through the TTL cache; then the
    same views inserted into a cpplog store (:func:`cpplog_store`) and the
    query without them served twice again through the engine, the history
    read from the log. The five answers must be identical and agree with
    the plain attention's; the
    decoded weights are the trained ones bit for bit; the flash kernel
    launches ``n_layers`` times a training step and a query. Returns
    (flash launches, max score error, stats)."""
    from datetime import timedelta

    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.data.storage import Storage
    from incubator_predictionio_tpu_torch.utils.times import parse_iso8601
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    n_items = 500 if small else SEQ["n_items"]
    max_len = 701 if small else SEQ["max_len"]
    n_sessions, batch = 64, 8
    name = "store-seq"
    rows = planted.planted_sessions(n_items, n_sessions, max_len, seed=17)
    base = parse_iso8601(STORE_T0)
    with temp_store():
        app_id = new_app(name)
        t0 = time.perf_counter()
        stamps = [base + timedelta(milliseconds=j) for j in range(max_len)]
        events = [Event(event="view", entity_type="user", entity_id=f"s{s}",
                        target_entity_type="item",
                        target_entity_id=f"i{t - 1}", event_time=stamps[j])
                  for s, row in enumerate(rows.tolist())
                  for j, t in enumerate(row)]
        make_s = time.perf_counter() - t0
        import_s = insert_events(events, app_id)

        eng = seq_engine.SequenceEngine().apply()
        kept = keep_trained(eng)
        ep = params_mod.EngineParams(
            data_source_params=("", seq_engine.DataSourceParams(
                app_name=name)),
            preparator_params=("", seq_engine.PreparatorParams(
                max_len=max_len)),
            algorithm_params_list=[("sasrec", seq_engine.SeqRecAlgorithmParams(
                app_name=name, d_model=SEQ["d_model"],
                n_heads=SEQ["n_heads"], n_layers=SEQ["n_layers"], epochs=1,
                batch_size=batch, seed=seed))])
        ctx = context.RuntimeContext(device=dev)
        runtime.reset_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        iid = CoreWorkflow.run_train(eng, ep, ctx=ctx)
        train_s = time.perf_counter() - t0
        timings = dict(ctx.timings)
        train_launches = runtime.launch_counts()["flash_attention"]
        blob_bytes = len(Storage.get_model_data_models().get(iid).models)
        t0 = time.perf_counter()
        models = CoreWorkflow.load_models(iid, eng, ep, ctx=ctx)
        sync(dev)
        load_s = time.perf_counter() - t0
        model, trained = models[0], kept[0]
        for f in dataclasses.fields(model.weights):
            if not torch.equal(getattr(model.weights, f.name),
                               getattr(trained.weights, f.name)):
                raise AssertionError(f"store-seq: decoded {f.name} differs "
                                     "from the trained weights")
        if len(model.item_bimap) != n_items:
            raise AssertionError(f"store-seq: {len(model.item_bimap)} items "
                                 f"in the catalogue, expected {n_items}")
        user = "s5"
        history = [f"i{t - 1}" for t in rows[5].tolist()]
        given = {"user": user, "num": 50, "recentItems": history}
        stored = {"user": user, "num": 50}
        srv = server_mod.PredictionServer(eng, ep, models, device=dev)
        port = srv.start_background()
        try:
            walls = []
            answers = []
            for doc in (given, stored, stored):
                t0 = time.perf_counter()
                answers.append(post(port, doc))
                walls.append(time.perf_counter() - t0)
            cache = srv.algorithms[0]._history_cache
            cache_hits = cache.hits
        finally:
            srv.stop()
        launches = runtime.launch_counts()["flash_attention"]
    # the same views on the native log: the query without recentItems
    # served again through the engine, its history read from cpplog
    with cpplog_store():
        log_app = new_app(name)
        log_import_s = insert_events(events, log_app)
        del events
        srv = server_mod.PredictionServer(eng, ep, models, device=dev)
        port = srv.start_background()
        try:
            log_walls = []
            for doc in (stored, stored):
                t0 = time.perf_counter()
                answers.append(post(port, doc))
                log_walls.append(time.perf_counter() - t0)
            log_hits = srv.algorithms[0]._history_cache.hits
        finally:
            srv.stop()
        log_launches = runtime.launch_counts()["flash_attention"] - launches
    if not answers[0] == answers[1] == answers[2] == answers[3] == \
            answers[4]:
        raise AssertionError("store-seq: the answer from the store's history "
                             "differs from the one with recentItems")
    if log_hits < 1:
        raise AssertionError("store-seq: the second history read from the "
                             "log missed the TTL cache")
    if cache_hits < 1:
        raise AssertionError("store-seq: the second history read missed the "
                             "TTL cache")
    ref_s, ref_i, _ = seq_reference(tr, fa, model, given, max_len - 1)
    err = check_seq_answer(answers[0], ref_s, ref_i, given["num"],
                           model.item_bimap, "store-seq query")
    steps = -(-n_sessions // batch)
    n_layers = SEQ["n_layers"]
    # each server start runs one warm-up query before it binds
    if dev.type == "cuda" and (train_launches != n_layers * steps
                               or launches != train_launches
                               + (1 + 3) * n_layers
                               or log_launches != (1 + 2) * n_layers):
        raise AssertionError(f"store-seq: flash_attention launched "
                             f"{train_launches} times in training, "
                             f"{launches - train_launches} in 3 queries "
                             f"and {log_launches} in 2 from the log")
    stats = {"sessions": n_sessions, "length": max_len,
             "events": n_sessions * max_len, "make_events_s": make_s,
             "import_s": import_s,
             "import_events_per_s": n_sessions * max_len / import_s,
             "run_train_s": train_s, "engine_timings_s": timings,
             "blob_bytes": blob_bytes, "load_models_s": load_s,
             "http_ms": {"recent_items": 1e3 * walls[0],
                         "store_history": 1e3 * walls[1],
                         "cached_history": 1e3 * walls[2],
                         "cpplog_store_history": 1e3 * log_walls[0],
                         "cpplog_cached_history": 1e3 * log_walls[1]},
             "cpplog_import_s": log_import_s,
             "cpplog_import_events_per_s":
                 n_sessions * max_len / log_import_s,
             "cache_hits": cache_hits, "final_loss": model.final_loss,
             "launches": launches + log_launches}
    return launches + log_launches, err, stats


REPO = os.path.dirname(os.path.abspath(__file__))
#: the port's CLI, as a user runs it
CLI = [sys.executable, "-m", "incubator_predictionio_tpu_torch.cli.main"]
#: the quickstart's ingest legs, as shares of its ratings: the native body
#: parse (bodies of 500), the doc-level gate and the generic per-event path
#: (bodies of 50 with ``eventTime``; the generic leg's also carry ``tags``),
#: single POST /events.json, and the rest through ``pio import``
QS_LEGS = (("native", 0.8), ("doc", 0.08), ("generic", 0.08),
           ("single", 0.008))
#: the three batch legs timed again at one body size each, into an app of
#: their own: (events per leg and size, body sizes)
QS_LEG_EVENTS, QS_LEG_SIZES = 10_000, (50, 500)
#: warm queries to the deployed engine beyond the quickstart's 32, for
#: the latency percentiles
QS_WARM_QUERIES = 500


def cli(*argv) -> str:
    """One verb of the port's CLI in this process; returns its standard
    output, and fails on a non-zero exit code."""
    import io

    from incubator_predictionio_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main.main(list(argv))
    if rc != 0:
        raise AssertionError(f"pio {' '.join(argv)} exited {rc}: "
                             f"{out.getvalue()[-2000:]}")
    return out.getvalue()


class Child:
    """A CLI verb in a child process, its output in files under ``work``;
    :meth:`wait_line` waits for a line of its standard output."""

    def __init__(self, name: str, argv, work: str, env: dict,
                 cwd: str = REPO):
        self.name = name
        self.out_path = os.path.join(work, f"{name}.out")
        self.err_path = os.path.join(work, f"{name}.err")
        with open(self.out_path, "wb") as out, \
                open(self.err_path, "wb") as err:
            self.proc = subprocess.Popen([*CLI, *argv], stdout=out,
                                         stderr=err, env=env, cwd=cwd)

    def tail(self) -> str:
        with open(self.err_path, errors="replace") as f:
            return f.read()[-3000:]

    def wait_line(self, pattern: str, timeout: float) -> re.Match:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with open(self.out_path, errors="replace") as f:
                m = re.search(pattern, f.read())
            if m:
                return m
            if self.proc.poll() is not None:
                break
            time.sleep(0.1)
        raise AssertionError(f"quickstart: {self.name} printed no "
                             f"{pattern!r} (exit {self.proc.poll()}):\n"
                             f"{self.tail()}")

    def wait_exit(self, timeout: float = 120) -> None:
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"quickstart: {self.name} still running "
                                 f"{timeout:.0f} s after it was stopped")
        if rc != 0:
            raise AssertionError(f"quickstart: {self.name} exited {rc}:\n"
                                 f"{self.tail()}")

    def kill(self) -> bool:
        """Kill the child if it still runs; True when it did."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
            return True
        return False


def http_json(method: str, url: str, doc=None, timeout: float = 120):
    """(status, parsed body) of one request; an HTTP error's too. ``doc``
    is sent as JSON, or as it is when it is already ``bytes``."""
    data = (doc if doc is None or isinstance(doc, bytes)
            else json.dumps(doc).encode())
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def host_ms(fn, reps: int = 50) -> float:
    """Median host-clock ms of ``fn`` (host work only)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def rate_doc(u: int, i: int, r: float, when: str = None,
             tags: bool = False) -> dict:
    doc = {"event": "rate", "entityType": "user", "entityId": f"u{u}",
           "targetEntityType": "item", "targetEntityId": f"i{i}",
           "properties": {"rating": float(r)}}
    if when is not None:
        doc["eventTime"] = when
    if tags:
        doc["tags"] = []
    return doc


def leg_timings(url: str, app_out: str, users, items, ratings, base_t,
                n: int) -> dict:
    """The event server's three batch legs at each body size of
    ``QS_LEG_SIZES``, ``n`` events each, into the app whose ``pio app new``
    output is ``app_out``: the bodies are encoded before the clock starts,
    and each (leg, size) cell is posted in two halves, the cells taking
    turns, so that drift in the store's cost falls on all alike. Per leg,
    from the two sizes: the fixed cost of a request and the cost of an
    event in it (a least-squares line through the two per-request
    walls)."""
    from datetime import timedelta

    from incubator_predictionio_tpu_torch.utils.times import format_iso8601

    key = re.search(r"Access Key: (\S+)", app_out).group(1)
    target = f"{url}/batch/events.json?accessKey={key}"
    cells = {}
    for size in QS_LEG_SIZES:
        for leg in ("native", "doc", "generic"):
            docs = [rate_doc(users[k], items[k], ratings[k],
                             None if leg == "native" else format_iso8601(
                                 base_t + timedelta(milliseconds=k)),
                             tags=leg == "generic") for k in range(n)]
            cells[leg, size] = {
                "bodies": [json.dumps(docs[s:s + size]).encode()
                           for s in range(0, n, size)],
                "s": 0.0}
    for half in (0, 1):
        for (leg, size), cell in cells.items():
            bodies = cell["bodies"]
            part = bodies[:len(bodies) // 2] if half == 0 \
                else bodies[len(bodies) // 2:]
            t0 = time.perf_counter()
            for body in part:
                status, got = http_json("POST", target, body)
                if status != 200 or any(g.get("status") != 201
                                        for g in got):
                    raise AssertionError(f"quickstart: {leg} body of "
                                         f"{size}: {status} {got!r:.300}")
            cell["s"] += time.perf_counter() - t0
    out = {}
    for leg in ("native", "doc", "generic"):
        per_request = {}
        for size in QS_LEG_SIZES:
            cell = cells[leg, size]
            per_request[size] = 1e3 * cell["s"] / len(cell["bodies"])
            out[f"{leg}@{size}"] = {
                "events": n, "s": cell["s"], "events_per_s": n / cell["s"],
                "ms_per_request": per_request[size]}
        slope, fixed = np.polyfit(list(per_request),
                                  list(per_request.values()), 1)
        out[leg] = {"ms_per_request_fixed": float(fixed),
                    "ms_per_event": float(slope)}
    return out


def quickstart_phase(dev, runtime, kernels, als, planted,
                     small: bool = False, seed: int = 3, then=None):
    """The README quickstart through the port's own CLI, on a fresh SQLite
    store: ``pio app new QsApp``; ``pio eventserver --batch-cap 500`` as a
    child process taking 250,000 planted ratings (seed 7, every ML-20M user
    and item rated, rounded to ML-20M's half-star scale so each travels as
    a short JSON number) over its three batch legs and single events
    (``QS_LEGS``), then the three legs timed again at bodies of 50 and 500
    into an app of their own (:func:`leg_timings`), a 51-event body
    refused with 400 by an event server at
    the reference's cap of 50, the child stopped (exit 0); the rest through
    ``pio import``; ``pio build`` and ``pio train`` in this process (rank
    128, 4 sweeps, 2 in bf16, λ 0.03, as store-als); ``pio deploy`` as a
    child process, 32 queries and one for an unknown user over HTTP, then
    ``QS_WARM_QUERIES`` more for the warm latency percentiles (the first
    query, cold, is reported on its own), ``GET /``'s device; ``pio undeploy`` (the child exits 0). Checks: ``pio
    export`` reads back every rating once with its value; the store's
    triples are the planted ones; the fused ALS, R-row and score+top-k
    kernels launched; the fit within 1e-3 of the plain route's from the
    same initial state, relative; every answer the plain top-k on the
    instance's decoded factors. ``then(qs)``, where given, runs on the same
    store after ``pio undeploy``, ``qs`` a dict of what the quickstart made
    (its work directory, environment, engine directory, variant, app and
    access key, ratings, first instance and its walls, and the list of
    child processes to stop). Returns (launches by kernel, max score
    error, stats, what ``then`` returned)."""
    from datetime import timedelta

    from incubator_predictionio_tpu_torch.data.storage import base as sbase
    from incubator_predictionio_tpu_torch.models.recommendation import (
        engine,
    )
    from incubator_predictionio_tpu_torch.parallel.context import (
        RuntimeContext,
    )
    from incubator_predictionio_tpu_torch.servers.event_server import (
        EventServer,
        EventServerConfig,
    )
    from incubator_predictionio_tpu_torch.utils.times import (
        format_iso8601,
        parse_iso8601,
    )
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    if small:
        n_users, n_items, nnz, rank = 400, 300, 10_000, 16
    else:
        n_users, n_items = ML20M["users"], ML20M["items"]
        nnz, rank = 250_000, ML20M["rank"]
    name = "QsApp"
    t0 = time.perf_counter()
    users, items, ratings, _ = planted.planted_ratings(
        n_users=n_users, n_items=n_items, nnz=nnz, n_holdout=1000,
        cover=True)
    ratings = np.clip(np.round(ratings * 2) / 2, 0.5, 5.0).astype(np.float32)
    gen_s = time.perf_counter() - t0
    bounds, start = {}, 0
    for leg, share in QS_LEGS:
        bounds[leg] = (start, start + int(round(share * nnz)))
        start = bounds[leg][1]
    bounds["import"] = (start, nnz)
    base_t = parse_iso8601(STORE_T0)

    def docs_of(leg):
        lo, hi = bounds[leg]
        timed = leg in ("doc", "generic")
        return [rate_doc(users[k], items[k], ratings[k],
                         format_iso8601(base_t + timedelta(milliseconds=k))
                         if timed else None, tags=leg == "generic")
                for k in range(lo, hi)]

    env_saved = os.environ.get("PIO_DEVICE")
    if dev.type == "cpu":
        os.environ["PIO_DEVICE"] = "cpu"  # the CLI's CPU switch
    else:
        os.environ.pop("PIO_DEVICE", None)
    children = []
    stats: dict = {"users": n_users, "items": n_items, "ratings": nnz,
                   "rank": rank, "generate_s": gen_s}
    cwd = os.getcwd()
    try:
        with temp_store() as home, \
                tempfile.TemporaryDirectory(prefix="pio_qs_") as work:
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
            out = cli("app", "new", name)
            key = re.search(r"Access Key: (\S+)", out).group(1)

            # -- the event server, a child at --batch-cap 500 -------------
            es = Child("eventserver", ["eventserver", "--ip", "127.0.0.1",
                                       "--port", "0", "--batch-cap", "500"],
                       work, env)
            children.append(es)
            es_port = int(es.wait_line(r"running on http://[^:]+:(\d+)",
                                       300).group(1))
            url = f"http://127.0.0.1:{es_port}"
            legs = {}
            for leg, size in (("native", 500), ("doc", 50), ("generic", 50)):
                docs = docs_of(leg)
                body = json.dumps(docs[:size]).encode()
                # the leg each body takes, by the server's own gates
                native = sbase.uniform_interactions_from_body(body, 500)
                by_docs = sbase.uniform_interactions_from_docs(docs[:size])
                if (native is not None) != (leg == "native") or (
                        by_docs is not None) != (leg != "generic"):
                    raise AssertionError(f"quickstart: a {leg} body takes "
                                         "another leg")
                # the host cost of each gate on one body, in this process
                gate_ms = {
                    "native_parse_ms": host_ms(
                        lambda: sbase.uniform_interactions_from_body(
                            body, 500)),
                    "json_and_doc_gate_ms": host_ms(
                        lambda: sbase.uniform_interactions_from_docs(
                            json.loads(body)))}
                t0 = time.perf_counter()
                for s in range(0, len(docs), size):
                    status, got = http_json(
                        "POST", f"{url}/batch/events.json?accessKey={key}",
                        docs[s:s + size])
                    if status != 200 or any(g.get("status") != 201
                                            for g in got):
                        raise AssertionError(f"quickstart: {leg} batch at "
                                             f"{s}: {status} {got!r:.300}")
                wall = time.perf_counter() - t0
                legs[leg] = {"events": len(docs), "body": size,
                             "s": wall, "events_per_s": len(docs) / wall,
                             **gate_ms}
            docs = docs_of("single")
            t0 = time.perf_counter()
            for doc in docs:
                status, got = http_json(
                    "POST", f"{url}/events.json?accessKey={key}", doc)
                if status != 201:
                    raise AssertionError(f"quickstart: single event: "
                                         f"{status} {got}")
            wall = time.perf_counter() - t0
            legs["single"] = {"events": len(docs), "s": wall,
                              "events_per_s": len(docs) / wall}
            stats["ingest_by_body"] = leg_timings(
                url, cli("app", "new", "QsLegs"), users, items, ratings,
                base_t, 50 if small else QS_LEG_EVENTS)
            # the reference's cap: 51 events to a server at the default 50
            capped = EventServer(EventServerConfig(ip="127.0.0.1", port=0))
            cap_port = capped.start_background()
            try:
                status, got = http_json(
                    "POST", f"http://127.0.0.1:{cap_port}/batch/events.json"
                    f"?accessKey={key}", docs[:1] * 51)
            finally:
                capped.stop()
            if status != 400:
                raise AssertionError(f"quickstart: a 51-event body got "
                                     f"{status}, not 400")
            es.proc.send_signal(signal.SIGTERM)
            es.wait_exit()

            # -- pio import, then pio export ------------------------------
            path = os.path.join(work, "rest.jsonl")
            with open(path, "w") as f:
                for doc in docs_of("import"):
                    f.write(json.dumps(doc) + "\n")
            t0 = time.perf_counter()
            cli("import", "--appid-or-name", name, "--input", path)
            wall = time.perf_counter() - t0
            n_imp = bounds["import"][1] - bounds["import"][0]
            legs["import"] = {"events": n_imp, "s": wall,
                              "events_per_s": n_imp / wall}
            stats["ingest"] = legs
            path = os.path.join(work, "export.jsonl")
            t0 = time.perf_counter()
            cli("export", "--appid-or-name", name, "--output", path)
            stats["export_s"] = time.perf_counter() - t0
            seen = {}
            with open(path) as f:
                for line in f:
                    d = json.loads(line)
                    pair = (int(d["entityId"][1:]),
                            int(d["targetEntityId"][1:]))
                    if pair in seen:
                        raise AssertionError(f"quickstart: {pair} exported "
                                             "twice")
                    seen[pair] = d["properties"]["rating"]
            want = dict(zip(zip(users.tolist(), items.tolist()),
                            ratings.tolist()))
            if seen != want:
                raise AssertionError(
                    f"quickstart: export holds {len(seen)} ratings, "
                    f"{sum(seen.get(p) != r for p, r in want.items())} of "
                    f"the {len(want)} planted missing or changed")

            # -- pio build, pio train (this process: its launch counts) ----
            engine_dir = os.path.join(work, "engine")
            os.makedirs(engine_dir)
            variant = os.path.join(engine_dir, "engine.json")
            with open(variant, "w") as f:
                json.dump({
                    "id": "default",
                    "engineFactory": "incubator_predictionio_tpu_torch."
                                     "models.recommendation:"
                                     "RecommendationEngine",
                    "datasource": {"params": {"appName": name}},
                    "algorithms": [{"name": "als", "params": {
                        "rank": rank, "numIterations": 4, "lambda": 0.03,
                        "bf16Sweeps": 2, "seed": seed}}],
                }, f)
            os.chdir(engine_dir)
            cli("build")
            runtime.reset_launch_counts()
            sync(dev)
            t0 = time.perf_counter()
            out = cli("train")
            sync(dev)
            stats["train_s"] = time.perf_counter() - t0
            train_counts = runtime.launch_counts()
            os.chdir(cwd)
            iid = re.search(r"Engine instance ID: (\S+)", out).group(1)
            from incubator_predictionio_tpu_torch.data.storage import Storage

            conf = Storage.get_meta_data_engine_instances().get(
                iid).runtime_conf
            stats["phases_s"] = {k: float(v) for k, v in conf.items()
                                 if k.startswith("phase.")}
            model = CoreWorkflow.load_models(iid)[0]  # decoded, on the host
            ctx = RuntimeContext(device=dev)
            td = engine.RecommendationDataSource(
                engine.DataSourceParams(app_name=name)).read_training(ctx)
            inter = td.interactions
            u_num = np.array([int(x[1:]) for x in inter.user_ids])[
                inter.user_idx]
            i_num = np.array([int(x[1:]) for x in inter.item_ids])[
                inter.item_idx]
            got = sorted(zip(u_num.tolist(), i_num.tolist(),
                             inter.values.tolist()))
            if got != sorted(zip(users.tolist(), items.tolist(),
                                 ratings.tolist())):
                raise AssertionError("quickstart: the store's triples are "
                                     "not the planted ones")
            pd = engine.RecommendationPreparator().prepare(ctx, td)

            # -- pio deploy as a child; queries; pio undeploy --------------
            t_deploy = time.perf_counter()
            dep = Child("deploy", ["deploy", "--variant", variant, "--ip",
                                   "127.0.0.1", "--port", "0"],
                        work, env, cwd=engine_dir)
            children.append(dep)
            port = int(dep.wait_line(r"deployed on http://[^:]+:(\d+)",
                                     600).group(1))
            base = f"http://127.0.0.1:{port}"
            rng = np.random.default_rng(9)
            pick = rng.choice(n_users, 32, replace=False)
            queries = [{"user": f"u{u}", "num": 10} for u in pick[:24]]
            queries += [{"user": f"u{u}", "num": 100} for u in pick[24:]]
            queries.append({"user": "nosuch-1", "num": 10})
            queries += [{"user": f"u{u}", "num": 10} for u in rng.choice(
                n_users, 20 if small else QS_WARM_QUERIES)]
            walls, answers = [], []
            for doc in queries:
                t0 = time.perf_counter()
                status, body = http_json("POST", f"{base}/queries.json", doc)
                walls.append(time.perf_counter() - t0)
                if status != 200:
                    raise AssertionError(f"quickstart: query {doc}: {status}"
                                         f" {body}")
                answers.append(body)
                if len(walls) == 1:
                    stats["deploy_to_first_answer_s"] = (
                        time.perf_counter() - t_deploy)
            status, info = http_json("GET", f"{base}/")
            if status != 200 or info["device"] != dev.type \
                    or info["engineInstanceId"] != iid:
                raise AssertionError(f"quickstart: GET / {status} {info}")
            cli("undeploy", "--ip", "127.0.0.1", "--port", str(port))
            dep.wait_exit()
            after = None if then is None else then(dict(
                work=work, env=env, engine_dir=engine_dir, variant=variant,
                name=name, key=key, users=users, items=items,
                ratings=ratings, n_users=n_users, n_items=n_items,
                rank=rank, seed=seed, iid=iid, train_s=stats["train_s"],
                phases_s=stats["phases_s"], children=children, cwd=cwd))
    finally:
        os.chdir(cwd)
        for child in children:
            if child.kill():
                raise AssertionError(f"quickstart: {child.name} was left "
                                     "running")
        if env_saved is None:
            os.environ.pop("PIO_DEVICE", None)
        else:
            os.environ["PIO_DEVICE"] = env_saved

    uf_t = torch.from_numpy(np.asarray(model.user_factors)).to(dev)
    items_t = torch.from_numpy(np.asarray(model.item_factors)).to(dev)
    err = 0.0
    for i, (doc, body) in enumerate(zip(queries, answers)):
        err = max(err, check_answer(kernels, dev, uf_t, items_t, doc, None,
                                    body, f"quickstart query {i}",
                                    model=model))
    trees = als.prepare_trees(pd.users, pd.items, pd.ratings, n_users,
                              n_items, device=dev)
    state0 = als.als_init(torch.Generator().manual_seed(seed), n_users,
                          n_items, rank, device=dev)
    plain = als._mixed_run(state0, trees[0], trees[1], 0.03, 4, 2, True,
                           torch.float32, trees[2], trees[3],
                           use_kernel=False)
    fit = als.rmse(als.ALSState(user_factors=uf_t, item_factors=items_t),
                   pd.users, pd.items, pd.ratings)
    fit_plain = als.rmse(plain, pd.users, pd.items, pd.ratings)
    fit_rel = abs(fit - fit_plain) / fit_plain
    if not fit_rel <= 1e-3:
        raise AssertionError(f"quickstart: fit RMSE {fit!r} is "
                             f"{fit_rel:.2e} from the plain route's "
                             f"{fit_plain!r}")
    launches = {e: train_counts[e] for e in ROUTE_ENTRY.values()}
    launches["score_topk"] = info["kernelLaunches"].get("score_topk", 0)
    if dev.type == "cuda" and (
            launches["als_fused_solve_cg"] <= 0
            or launches["als_solve_cg_rows8"] <= 0
            or launches["score_topk"] < len(queries) - 1):
        raise AssertionError(f"quickstart: launches {launches}")
    warm = 1e3 * np.asarray(walls[1:])
    stats.update({
        "instance": iid, "queries": len(queries),
        "http_first_query_ms": 1e3 * walls[0],
        "http_warm_queries": len(warm),
        "http_warm_p50_ms": float(np.percentile(warm, 50)),
        "http_warm_p99_ms": float(np.percentile(warm, 99)),
        "fit_rmse": fit, "fit_rmse_plain": fit_plain, "fit_rel_err": fit_rel,
        "launches": launches, "on_path": path_entries(als, trees[:2], rank),
        "served_device": info["device"]})
    return launches, err, stats, after


# -- retrain: the continuation retrain and implicit training -------------------

#: the CLI leg's tail: new (user, item) pairs among existing ids, ratings
#: from new users (and how many users), ratings on new items (and how many)
RT_PAIRS, RT_NEW_USER_RATINGS, RT_NEW_USERS = 2_000, 250, 100
RT_NEW_ITEM_RATINGS, RT_NEW_ITEMS = 250, 50
#: the in-process leg: a 1% tail of new pairs on the train phase's
#: 20,000,000 ratings, and the pairs re-rated in its last step
RT_LOOP_TAIL, RT_RERATE = 200_000, 1_000
#: bucket width of the in-process leg: a plan holds no split rows (as in
#: the JAX package), and at 65,536 the most-rated planted item is split
RT_MAX_WIDTH = 1 << 17


def distinct_new_pairs(rng, users, items, n_users, n_items, n: int,
                       draw=None) -> tuple:
    """``n`` (user, item) pairs, none among (``users``, ``items``) nor
    repeated, in draw order; ``draw(m)`` gives m candidate pairs (default:
    uniform over ``n_users`` × ``n_items``)."""
    taken = np.unique(np.asarray(users, np.int64) * n_items
                      + np.asarray(items, np.int64))
    if draw is None:
        def draw(m):
            return rng.integers(0, n_users, m), rng.integers(0, n_items, m)
    got_u, got_i = np.empty(0, np.int64), np.empty(0, np.int64)
    while len(got_u) < n:
        u, i = draw(2 * (n - len(got_u)) + 64)
        got_u = np.concatenate([got_u, np.asarray(u, np.int64)])
        got_i = np.concatenate([got_i, np.asarray(i, np.int64)])
        keys = got_u * n_items + got_i
        _, first = np.unique(keys, return_index=True)
        keep = np.sort(first)
        at = np.minimum(np.searchsorted(taken, keys[keep]), len(taken) - 1)
        keep = keep[taken[at] != keys[keep]] if len(taken) else keep
        got_u, got_i = got_u[keep], got_i[keep]
    return got_u[:n], got_i[:n]


def cli_tail(rng, users, items, n_users: int, n_items: int):
    """The CLI leg's 2,500 ratings on half stars, shuffled: 2,000 new pairs
    among existing ids, 250 from 100 new users (each rates at least once)
    on existing items, 250 by existing users on 50 new items (each rated
    at least once)."""
    u, i = distinct_new_pairs(rng, users, items, n_users, n_items, RT_PAIRS)

    def new_ids(n_new, n_ratings, first, other):
        ids = np.r_[np.arange(n_new),
                    rng.integers(0, n_new, n_ratings - n_new)] + first
        picks = np.empty(0, np.int64)
        while True:   # distinct (new id, other) pairs
            picks = rng.integers(0, other, n_ratings)
            if len(np.unique(ids * other + picks)) == n_ratings:
                return ids, picks

    nu, nu_items = new_ids(RT_NEW_USERS, RT_NEW_USER_RATINGS, n_users,
                           n_items)
    ni, ni_users = new_ids(RT_NEW_ITEMS, RT_NEW_ITEM_RATINGS, n_items,
                           n_users)
    tu = np.r_[u, nu, ni_users]
    ti = np.r_[i, nu_items, ni]
    order = rng.permutation(len(tu))
    r = rng.integers(1, 11, len(tu)) / 2.0
    return tu[order], ti[order], r.astype(np.float32)


class LogLines(logging.Handler):
    """Keeps the messages of a logger (and writes them to stderr) while
    installed: ``with LogLines(name) as lines: ...``."""

    def __init__(self, name: str):
        super().__init__(logging.INFO)
        self.logger = logging.getLogger(name)
        self.lines: list = []

    def emit(self, record):
        msg = record.getMessage()
        self.lines.append(msg)
        print(f"{record.name}: {msg}", file=sys.stderr, flush=True)

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self.lines

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def retrain_cli_leg(qs, dev, runtime, kernels, als, small: bool = False):
    """Retrain leg (a), on the quickstart's store after its ``pio train``:
    2,500 ratings (:func:`cli_tail`) through a new ``pio eventserver``
    child on the native batch leg, in bodies of 500 (the leg declines an
    explicit ``eventTime``, so the server stamps each at its arrival,
    after every earlier event); ``pio train`` again with the same
    engine.json, which must continue (its log line: ``mode=continue``, 2
    to 4 sweeps) and record ``phase.continue_seed_s``; the fit over all
    252,500 ratings within 1.15 × a fresh fixed-budget ``als_train`` of
    the same prepared data + 0.02 (tests/test_retrain_continue.py:285);
    ``pio deploy`` of the continued instance: 32 queries, one from a new
    user, each against the plain top-k on its decoded factors; ``pio
    undeploy``. Returns (launches by kernel, max score error, stats)."""
    from incubator_predictionio_tpu_torch.data.storage import Storage
    from incubator_predictionio_tpu_torch.data.storage import base as sbase
    from incubator_predictionio_tpu_torch.models.recommendation import (
        engine,
    )
    from incubator_predictionio_tpu_torch.parallel.context import (
        RuntimeContext,
    )
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    t_leg = time.perf_counter()
    n_users, n_items, rank = qs["n_users"], qs["n_items"], qs["rank"]
    rng = np.random.default_rng(21)
    tu, ti, tr = cli_tail(rng, qs["users"], qs["items"], n_users, n_items)
    es = Child("eventserver-tail", ["eventserver", "--ip", "127.0.0.1",
                                    "--port", "0", "--batch-cap", "500"],
               qs["work"], qs["env"])
    qs["children"].append(es)
    url = "http://127.0.0.1:%d" % int(es.wait_line(
        r"running on http://[^:]+:(\d+)", 300).group(1))
    t0 = time.perf_counter()
    for s0 in range(0, len(tu), 500):
        body = json.dumps([rate_doc(u, i, r) for u, i, r in zip(
            tu[s0:s0 + 500], ti[s0:s0 + 500], tr[s0:s0 + 500])]).encode()
        if sbase.uniform_interactions_from_body(body, 500) is None:
            raise AssertionError("retrain: a tail body left the native leg")
        status, got = http_json(
            "POST", f"{url}/batch/events.json?accessKey={qs['key']}", body)
        if status != 200 or any(g.get("status") != 201 for g in got):
            raise AssertionError(f"retrain: tail body at {s0}: {status} "
                                 f"{got!r:.300}")
    tail_s = time.perf_counter() - t0
    es.proc.send_signal(signal.SIGTERM)
    es.wait_exit()

    os.chdir(qs["engine_dir"])
    try:
        with LogLines("incubator_predictionio_tpu_torch.models."
                      "recommendation.engine") as lines:
            runtime.reset_launch_counts()
            sync(dev)
            t0 = time.perf_counter()
            out = cli("train")
            sync(dev)
            train_s = time.perf_counter() - t0
            counts = runtime.launch_counts()
    finally:
        os.chdir(qs["cwd"])
    iid = re.search(r"Engine instance ID: (\S+)", out).group(1)
    said = [m for m in map(re.compile(
        r"ALS continuation retrain: .* (\d+) sweeps \(mode=(\w+), "
        r"delta=(\S+)\)").search, lines) if m]
    if len(said) != 1 or said[0].group(2) != "continue" \
            or not 2 <= int(said[0].group(1)) <= 4:
        raise AssertionError(f"retrain: the second pio train logged "
                             f"{lines}")
    conf = Storage.get_meta_data_engine_instances().get(iid).runtime_conf
    phases = {k: float(v) for k, v in conf.items() if k.startswith("phase.")}
    if "phase.continue_seed_s" not in phases:
        raise AssertionError(f"retrain: no continue_seed phase in {phases}")
    model = CoreWorkflow.load_models(iid)[0]
    ctx = RuntimeContext(device=dev)
    pd = engine.RecommendationPreparator().prepare(
        ctx, engine.RecommendationDataSource(engine.DataSourceParams(
            app_name=qs["name"])).read_training(ctx))
    n_total = len(qs["ratings"]) + len(tr)
    if len(pd.ratings) != n_total or len(pd.user_bimap) != \
            n_users + RT_NEW_USERS or len(pd.item_bimap) != \
            n_items + RT_NEW_ITEMS:
        raise AssertionError(
            f"retrain: {len(pd.ratings)} ratings over "
            f"{len(pd.user_bimap)} × {len(pd.item_bimap)}")
    uf_t = torch.from_numpy(np.asarray(model.user_factors)).to(dev)
    items_t = torch.from_numpy(np.asarray(model.item_factors)).to(dev)
    fit = als.rmse(als.ALSState(user_factors=uf_t, item_factors=items_t),
                   pd.users, pd.items, pd.ratings)
    fresh, _ = als.als_train(pd.users, pd.items, pd.ratings,
                             len(pd.user_bimap), len(pd.item_bimap),
                             rank=rank, iterations=4, l2=0.03,
                             seed=qs["seed"], bf16_sweeps=2, device=dev)
    fit_fresh = als.rmse(fresh, pd.users, pd.items, pd.ratings)
    if not fit <= 1.15 * fit_fresh + 0.02:
        raise AssertionError(f"retrain: continued fit {fit!r} against a "
                             f"fresh train's {fit_fresh!r}")

    dep = Child("deploy-continued", ["deploy", "--variant", qs["variant"],
                                     "--ip", "127.0.0.1", "--port", "0"],
                qs["work"], qs["env"], cwd=qs["engine_dir"])
    qs["children"].append(dep)
    port = int(dep.wait_line(r"deployed on http://[^:]+:(\d+)",
                             600).group(1))
    base = f"http://127.0.0.1:{port}"
    status, info = http_json("GET", f"{base}/")
    if status != 200 or info["engineInstanceId"] != iid:
        raise AssertionError(f"retrain: the deployed child serves {info}")
    queries = [{"user": f"u{n_users}", "num": 10}]
    queries += [{"user": f"u{u}", "num": 10}
                for u in rng.choice(np.unique(tu[tu < n_users]), 15)]
    queries += [{"user": f"u{u}", "num": 20}
                for u in rng.choice(n_users + RT_NEW_USERS, 16)]
    err = 0.0
    for k, doc in enumerate(queries):
        status, body = http_json("POST", f"{base}/queries.json", doc)
        if status != 200:
            raise AssertionError(f"retrain: query {doc}: {status} {body}")
        err = max(err, check_answer(kernels, dev, uf_t, items_t, doc, None,
                                    body, f"retrain query {k}", model=model))
    status, info = http_json("GET", f"{base}/")
    cli("undeploy", "--ip", "127.0.0.1", "--port", str(port))
    dep.wait_exit()
    launches = {e: counts[e] for e in ROUTE_ENTRY.values()}
    launches["score_topk"] = info["kernelLaunches"].get("score_topk", 0)
    if dev.type == "cuda" and (launches["als_fused_solve_cg"] <= 0
                               or launches["score_topk"] < len(queries)):
        raise AssertionError(f"retrain: launches {launches}")
    return launches, err, {
        "tail": len(tr), "tail_s": tail_s,
        "tail_events_per_s": len(tr) / tail_s, "ratings": n_total,
        "users": len(pd.user_bimap), "items": len(pd.item_bimap),
        "sweeps_used": int(said[0].group(1)),
        "final_delta": float(said[0].group(3)), "instance": iid,
        "first_train_s": qs["train_s"], "train_s": train_s,
        "first_phases_s": qs["phases_s"], "phases_s": phases,
        "fit_rmse": fit, "fit_rmse_fresh": fit_fresh,
        "queries": len(queries), "launches": launches,
        "wall_s": time.perf_counter() - t_leg}


# -- cpplog: the quickstart's verbs on the native event log ------------------

#: single POST /events.json events the cpplog phase times
LOG_SINGLE_EVENTS = 1_000


@contextlib.contextmanager
def cpplog_store():
    """The port's Storage with events in a cpplog log, metadata in SQLite
    and models on localfs, under a fresh temporary ``PIO_HOME``, set in the
    environment so child processes open the same stores; put back as it
    was afterwards."""
    from incubator_predictionio_tpu_torch.data.storage import Storage

    def ours(k):
        return k == "PIO_HOME" or k.startswith("PIO_STORAGE_")

    saved = {k: v for k, v in os.environ.items() if ours(k)}
    with tempfile.TemporaryDirectory(prefix="pio_home_") as home:
        for k in saved:
            del os.environ[k]
        os.environ.update({
            "PIO_HOME": home,
            "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": os.path.join(home, "pio.db"),
            "PIO_STORAGE_SOURCES_LOG_TYPE": "cpplog",
            "PIO_STORAGE_SOURCES_LOG_PATH": os.path.join(home, "cpplog"),
            "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
            "PIO_STORAGE_SOURCES_FS_PATH": os.path.join(home, "models"),
            "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "pio_meta",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "pio_event",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio_model",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
        })
        Storage.reset()
        try:
            yield home
        finally:
            Storage.reset()
            for k in [k for k in os.environ if ours(k)]:
                del os.environ[k]
            os.environ.update(saved)


class ScanStats:
    """The stats of every cpplog ``scan_interactions`` call made while
    installed (``with ScanStats() as calls:``): its ``scan_*`` numbers,
    rows and wall. Nothing else about the call changes."""

    def __enter__(self):
        from incubator_predictionio_tpu_torch.data.storage import cpplog

        self.cls = cpplog.CppLogEvents
        self.orig = orig = self.cls.scan_interactions
        calls = self.calls = []

        def scan(dao, *args, stats=None, **kw):
            stats = {} if stats is None else stats
            t0 = time.perf_counter()
            out = orig(dao, *args, stats=stats, **kw)
            calls.append({"wall_s": time.perf_counter() - t0,
                          "rows": len(out),
                          **{k: v for k, v in stats.items()
                             if k.startswith("scan_")}})
            return out

        self.cls.scan_interactions = scan
        return calls

    def __exit__(self, *exc):
        self.cls.scan_interactions = self.orig


def id_triples(inter) -> tuple:
    """(user number, item number, value) arrays of an ``Interactions``
    whose ids are ``u<k>`` and ``i<k>``, in its row order."""
    u_num = np.array([int(x[1:]) for x in inter.user_ids])[inter.user_idx]
    i_num = np.array([int(x[1:]) for x in inter.item_ids])[inter.item_idx]
    return u_num, i_num, np.asarray(inter.values)


def same_triple_sets(a: tuple, b: tuple) -> bool:
    """The two (user, item, value) triple lists hold the same triples."""
    def canon(t):
        order = np.lexsort((t[2], t[1], t[0]))
        return [np.asarray(x)[order] for x in t]

    if len(a[0]) != len(b[0]):
        return False
    return all(np.array_equal(x, y) for x, y in zip(canon(a), canon(b)))


def same_interactions(a, b) -> bool:
    """Byte-identical reads: rows, values and both id tables."""
    return (np.array_equal(a.user_idx, b.user_idx)
            and np.array_equal(a.item_idx, b.item_idx)
            and np.array_equal(a.values, b.values)
            and all(bytes(x.blob) == bytes(y.blob)
                    and np.array_equal(x.offsets, y.offsets)
                    for x, y in ((a.user_ids, b.user_ids),
                                 (a.item_ids, b.item_ids))))


def cpplog_phase(dev, runtime, kernels, als, planted, sqlite: dict,
                 small: bool = False, seed: int = 3, then=None):
    """The quickstart's verbs through the port's CLI with the events on
    the native log (``cpplog``; metadata on SQLite, models on localfs)
    under a fresh ``PIO_HOME``: ``pio app new``; ``pio import`` of
    store-als's 1,000,000 planted ratings (one ``eventTime`` each, 1 ms
    apart, the order store-als's SQLite import gives them), which must take
    the native columnar path and write the training projection; ``pio
    build`` and ``pio train`` (rank 128, 4 sweeps, 2 bf16, λ 0.03, seed 3:
    store-als's), whose read is the sharded scan of the log (the
    recommendation data source reads two event names, ``rate`` and
    ``buy`` at a fixed value, which the projection does not serve, as in
    the JAX package); the read held to store-als's SQLite read as sets of
    (user, item, value) triples and the fit within 1e-3 of store-als's,
    relative; ``pio eventserver`` as a child on the store: the three batch
    legs at bodies of 50 and 500 and ``LOG_SINGLE_EVENTS`` single events
    into an app of their own (:func:`leg_timings`), ``GET /stats.json``'s
    group-commit counters, then the retrain leg's 2,500 ratings
    (:func:`cli_tail`) on the native leg, which ``read_interactions_since``
    from a cursor taken before them must return exactly; the read the
    projection serves (``rate`` alone, its stored value), which must come
    from the projection plus a tail of exactly those rows and equal the
    full scan of the same query byte for byte; ``pio train`` again, which
    must continue from the first instance; ``pio deploy`` as a child, 32
    queries each held to the
    plain top-k on the instance's decoded factors, ``pio undeploy``; ``pio
    upgrade`` (the log's live-record rewrite) and a read equal byte for
    byte to the one before it. ``sqlite``: store-als's triples and fit.
    ``then(log)``, where given, runs last on the same store, ``log`` a dict
    of what the phase made (the app's name, id and access key, the
    continued instance, the ratings); its wall is not the phase's.
    Returns (launches by kernel, max score error, stats, what ``then``
    returned)."""
    from datetime import timedelta

    from incubator_predictionio_tpu_torch.data.storage import (
        Storage,
        traincache,
    )
    from incubator_predictionio_tpu_torch.data.storage import base as sbase
    from incubator_predictionio_tpu_torch.data.store import EventStore
    from incubator_predictionio_tpu_torch.models.recommendation import (
        engine,
    )
    from incubator_predictionio_tpu_torch.parallel.context import (
        RuntimeContext,
    )
    from incubator_predictionio_tpu_torch.utils.times import (
        format_iso8601,
        parse_iso8601,
    )
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    t_phase = time.perf_counter()
    rank = 16 if small else ML20M["rank"]
    users, items, ratings, n_users, n_items = store_als_ratings(planted,
                                                                small)
    nnz = len(ratings)
    name, legs_name = "LogApp", "LogLegs"
    base_t = parse_iso8601(STORE_T0)
    min_nnz = traincache.MIN_NNZ
    if small:  # the projection at the rehearsal's size too
        traincache.MIN_NNZ = min(min_nnz, nnz)
    env_saved = os.environ.get("PIO_DEVICE")
    if dev.type == "cpu":
        os.environ["PIO_DEVICE"] = "cpu"
    else:
        os.environ.pop("PIO_DEVICE", None)
    children = []
    stats: dict = {"users": n_users, "items": n_items, "ratings": nnz,
                   "rank": rank}
    cwd = os.getcwd()
    try:
        with cpplog_store(), \
                tempfile.TemporaryDirectory(prefix="pio_log_") as work:
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
            key = re.search(r"Access Key: (\S+)",
                            cli("app", "new", name)).group(1)
            legs_out = cli("app", "new", legs_name)
            app_id = Storage.get_meta_data_apps().get_by_name(name).id
            dao = Storage.get_events()
            log_path = dao.client._file(dao.ns, app_id, None)
            cpath = traincache.path_for(log_path)

            # -- pio import: the columnar path writes the projection ------
            path = os.path.join(work, "ratings.jsonl")
            t0 = time.perf_counter()
            with open(path, "w") as f:
                for k in range(nnz):
                    f.write(json.dumps(rate_doc(
                        users[k], items[k], ratings[k], format_iso8601(
                            base_t + timedelta(milliseconds=k)))) + "\n")
            stats["write_file_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = cli("import", "--appid-or-name", name, "--input", path)
            import_s = time.perf_counter() - t0
            if f"Imported {nnz} events (native columnar path)." not in out:
                raise AssertionError(f"cpplog: pio import said {out!r}")
            cache = traincache.load(cpath)
            if cache is None or (cache.raw_count, len(cache)) != (nnz, nnz):
                raise AssertionError("cpplog: the import wrote no "
                                     "projection of its ratings")
            stats["import"] = {"events": nnz, "s": import_s,
                               "events_per_s": nnz / import_s}

            # -- pio build, pio train: the sharded scan of the log --------
            engine_dir = os.path.join(work, "engine")
            os.makedirs(engine_dir)
            variant = os.path.join(engine_dir, "engine.json")
            with open(variant, "w") as f:
                json.dump({
                    "id": "default",
                    "engineFactory": "incubator_predictionio_tpu_torch."
                                     "models.recommendation:"
                                     "RecommendationEngine",
                    "datasource": {"params": {"appName": name}},
                    "algorithms": [{"name": "als", "params": {
                        "rank": rank, "numIterations": 4, "lambda": 0.03,
                        "bf16Sweeps": 2, "seed": seed}}],
                }, f)

            def train(what):
                os.chdir(engine_dir)
                try:
                    with LogLines("incubator_predictionio_tpu_torch.models."
                                  "recommendation.engine") as lines, \
                            ScanStats() as scans:
                        runtime.reset_launch_counts()
                        sync(dev)
                        t0 = time.perf_counter()
                        out = cli("train")
                        sync(dev)
                        wall = time.perf_counter() - t0
                        counts = runtime.launch_counts()
                finally:
                    os.chdir(cwd)
                if len(scans) != 1:
                    raise AssertionError(f"cpplog: the {what} pio train "
                                         f"scanned {len(scans)} times")
                iid = re.search(r"Engine instance ID: (\S+)", out).group(1)
                conf = Storage.get_meta_data_engine_instances().get(
                    iid).runtime_conf
                return {"instance": iid, "train_s": wall,
                        "phases_s": {k: float(v) for k, v in conf.items()
                                     if k.startswith("phase.")},
                        "scan": scans[0],
                        "launches": {e: counts[e]
                                     for e in ROUTE_ENTRY.values()}}, lines

            os.chdir(engine_dir)
            try:
                cli("build")
            finally:
                os.chdir(cwd)
            first, _ = train("first")
            if first["scan"].get("scan_source") != "scan":
                raise AssertionError(f"cpplog: the first train read "
                                     f"{first['scan']}")
            ctx = RuntimeContext(device=dev)
            td = engine.RecommendationDataSource(
                engine.DataSourceParams(app_name=name)).read_training(ctx)
            if not same_triple_sets(id_triples(td.interactions),
                                    sqlite["triples"]):
                raise AssertionError("cpplog: the log's ratings differ from "
                                     "the SQLite store's")
            pd = engine.RecommendationPreparator().prepare(ctx, td)
            model = CoreWorkflow.load_models(first["instance"])[0]
            fit = als.rmse(als.ALSState(
                user_factors=torch.as_tensor(model.user_factors).to(dev),
                item_factors=torch.as_tensor(model.item_factors).to(dev)),
                pd.users, pd.items, pd.ratings)
            fit_rel = abs(fit - sqlite["fit"]) / fit
            if not fit_rel <= 1e-3:
                raise AssertionError(f"cpplog: fit RMSE {fit!r} is "
                                     f"{fit_rel:.2e} from the SQLite "
                                     f"store's {sqlite['fit']!r}")
            first.update(fit_rmse=fit, fit_rmse_sqlite=sqlite["fit"],
                         fit_rel_err=fit_rel)
            stats["first"] = first

            # -- pio eventserver on the log: legs, stats, the tail --------
            cursor = Storage.get_events().tail_cursor(app_id)
            Storage.reset()  # the child owns the log while it runs
            es = Child("eventserver-log", [
                "eventserver", "--ip", "127.0.0.1", "--port", "0",
                "--batch-cap", "500", "--stats"], work, env)
            children.append(es)
            url = "http://127.0.0.1:%d" % int(es.wait_line(
                r"running on http://[^:]+:(\d+)", 300).group(1))
            stats["ingest_by_body"] = leg_timings(
                url, legs_out, users, items, ratings, base_t,
                50 if small else QS_LEG_EVENTS)
            legs_key = re.search(r"Access Key: (\S+)", legs_out).group(1)
            n_single = 50 if small else LOG_SINGLE_EVENTS
            t0 = time.perf_counter()
            for k in range(n_single):
                status, got = http_json(
                    "POST", f"{url}/events.json?accessKey={legs_key}",
                    rate_doc(users[k], items[k], ratings[k]))
                if status != 201:
                    raise AssertionError(f"cpplog: single event: {status} "
                                         f"{got}")
            wall = time.perf_counter() - t0
            stats["single"] = {"events": n_single, "s": wall,
                               "events_per_s": n_single / wall}
            tu, ti, tr = cli_tail(np.random.default_rng(21), users, items,
                                  n_users, n_items)
            # the child's first touch of the 1M-record log opens it (the
            # native index is rebuilt from the record headers)
            t0 = time.perf_counter()
            status, got = http_json(
                "GET", f"{url}/events.json?accessKey={key}&limit=1")
            if status != 200 or len(got) != 1:
                raise AssertionError(f"cpplog: GET /events.json {status}")
            child_open_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for s0 in range(0, len(tu), 500):
                body = json.dumps([rate_doc(u, i, r) for u, i, r in zip(
                    tu[s0:s0 + 500], ti[s0:s0 + 500],
                    tr[s0:s0 + 500])]).encode()
                if sbase.uniform_interactions_from_body(body, 500) is None:
                    raise AssertionError("cpplog: a tail body left the "
                                         "native leg")
                status, got = http_json(
                    "POST", f"{url}/batch/events.json?accessKey={key}",
                    body)
                if status != 200 or any(g.get("status") != 201
                                        for g in got):
                    raise AssertionError(f"cpplog: tail body at {s0}: "
                                         f"{status} {got!r:.300}")
            tail_s = time.perf_counter() - t0
            status, st = http_json("GET",
                                   f"{url}/stats.json?accessKey={key}")
            if status != 200 or "groupCommit" not in st:
                raise AssertionError(f"cpplog: GET /stats.json {status} "
                                     f"{st!r:.300}")
            stats["group_commit"] = st["groupCommit"]
            es.proc.send_signal(signal.SIGTERM)
            es.wait_exit()

            t0 = time.perf_counter()
            dao = Storage.get_events()
            dao.init(app_id)   # reopens the log
            reopen_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            tail, _times, _append, _cur, reset = \
                dao.read_interactions_since(cursor, app_id,
                                            value_prop="rating")
            tail_read_s = time.perf_counter() - t0
            got_t = id_triples(tail)
            # as a set: the server stamps each body from its arrival, and
            # a read restores time order where two bodies' stamps overlap
            if reset or not same_triple_sets(got_t, (tu, ti, tr)):
                raise AssertionError(f"cpplog: the tail read gave "
                                     f"{len(tail)} rows (reset {reset}), "
                                     f"not the {len(tr)} posted")
            stats["tail"] = {"events": len(tr), "s": tail_s,
                             "events_per_s": len(tr) / tail_s,
                             "child_open_s": child_open_s,
                             "reopen_s": reopen_s,
                             "read_interactions_since_s": tail_read_s}

            # -- the read the projection serves: one event name, its
            # stored value (the import's projection plus the tail), held
            # to the full scan of the same query
            reads = {}
            for how, kw in (("cache", {}), ("scan", dict(
                    use_cache=False, seed_cache=False))):
                st: dict = {}
                t0 = time.perf_counter()
                reads[how] = EventStore.interactions(
                    app_name=name, value_prop="rating", stats=st, **kw)
                st = {k: v for k, v in st.items() if k.startswith("scan_")}
                stats[f"{how}_read"] = dict(st, s=time.perf_counter() - t0)
            if (stats["cache_read"].get("scan_source") != "cache"
                    or stats["cache_read"].get("scan_tail_rows") != len(tr)
                    or not same_interactions(reads["cache"],
                                             reads["scan"])):
                raise AssertionError(f"cpplog: the projection's read "
                                     f"{stats['cache_read']} against the "
                                     f"scan's {stats['scan_read']}")

            # -- pio train again: the scan, continued from the first ------
            second, lines = train("second")
            if second["scan"].get("scan_source") != "scan":
                raise AssertionError(f"cpplog: the second train read "
                                     f"{second['scan']}")
            said = [m for m in map(re.compile(
                r"ALS continuation retrain: .* (\d+) sweeps \(mode=(\w+), "
                r"delta=(\S+)\)").search, lines) if m]
            if len(said) != 1 or said[0].group(2) != "continue":
                raise AssertionError(f"cpplog: the second pio train logged "
                                     f"{lines}")
            if "phase.continue_seed_s" not in second["phases_s"]:
                raise AssertionError("cpplog: no continue_seed phase")
            second["sweeps_used"] = int(said[0].group(1))
            stats["second"] = second
            model = CoreWorkflow.load_models(second["instance"])[0]
            if (len(model.user_bimap), len(model.item_bimap)) != (
                    n_users + RT_NEW_USERS, n_items + RT_NEW_ITEMS):
                raise AssertionError("cpplog: the continued model holds "
                                     f"{len(model.user_bimap)} × "
                                     f"{len(model.item_bimap)}")

            # -- pio deploy, queries, pio undeploy ------------------------
            t0 = time.perf_counter()
            dep = Child("deploy-log", ["deploy", "--variant", variant,
                                       "--ip", "127.0.0.1", "--port", "0"],
                        work, env, cwd=engine_dir)
            children.append(dep)
            port = int(dep.wait_line(r"deployed on http://[^:]+:(\d+)",
                                     600).group(1))
            base = f"http://127.0.0.1:{port}"
            rng = np.random.default_rng(23)
            queries = [{"user": f"u{u}", "num": 10}
                       for u in rng.choice(n_users, 16, replace=False)]
            queries += [{"user": f"u{u}", "num": 20} for u in rng.choice(
                np.unique(tu[tu >= n_users]), 16)]
            answers, walls = [], []
            for doc in queries:
                t1 = time.perf_counter()
                status, body = http_json("POST", f"{base}/queries.json", doc)
                walls.append(time.perf_counter() - t1)
                if status != 200:
                    raise AssertionError(f"cpplog: query {doc}: {status} "
                                         f"{body}")
                answers.append(body)
            status, info = http_json("GET", f"{base}/")
            if status != 200 or info["engineInstanceId"] != \
                    second["instance"]:
                raise AssertionError(f"cpplog: GET / {status} {info}")
            cli("undeploy", "--ip", "127.0.0.1", "--port", str(port))
            dep.wait_exit()
            stats["deploy"] = {"queries": len(queries),
                               "wall_s": time.perf_counter() - t0,
                               "http_p50_ms": 1e3 * statistics.median(walls)}

            # -- pio upgrade: the live-record rewrite; the same read ------
            before = reads["cache"]
            t0 = time.perf_counter()
            out = cli("upgrade")
            upgrade_s = time.perf_counter() - t0
            if "live events rewritten" not in out:
                raise AssertionError(f"cpplog: pio upgrade said {out!r}")
            t0 = time.perf_counter()
            after = EventStore.interactions(app_name=name,
                                            value_prop="rating")
            reread_s = time.perf_counter() - t0
            if not same_interactions(before, after) or \
                    len(after) != nnz + len(tr):
                raise AssertionError("cpplog: the read after pio upgrade "
                                     "differs from the one before")
            stats["upgrade"] = {"s": upgrade_s, "reread_s": reread_s,
                                "said": out.strip().splitlines()}
            t_then = time.perf_counter()
            after = None if then is None else then(dict(
                name=name, app_id=app_id, key=key,
                instance=second["instance"], users=users, items=items,
                n_users=n_users, n_items=n_items, rank=rank))
            then_s = time.perf_counter() - t_then
    finally:
        traincache.MIN_NNZ = min_nnz
        os.chdir(cwd)
        for child in children:
            if child.kill():
                raise AssertionError(f"cpplog: {child.name} was left "
                                     "running")
        if env_saved is None:
            os.environ.pop("PIO_DEVICE", None)
        else:
            os.environ["PIO_DEVICE"] = env_saved

    uf_t = torch.from_numpy(np.asarray(model.user_factors)).to(dev)
    items_t = torch.from_numpy(np.asarray(model.item_factors)).to(dev)
    err = 0.0
    for k, (doc, body) in enumerate(zip(queries, answers)):
        err = max(err, check_answer(kernels, dev, uf_t, items_t, doc, None,
                                    body, f"cpplog query {k}", model=model))
    launches = {e: first["launches"][e] + second["launches"][e]
                for e in ROUTE_ENTRY.values()}
    launches["score_topk"] = info["kernelLaunches"].get("score_topk", 0)
    if dev.type == "cuda" and (launches["als_fused_solve_cg"] <= 0
                               or launches["score_topk"] < len(queries)):
        raise AssertionError(f"cpplog: launches {launches}")
    stats.update(launches=launches, sqlite=sqlite["figures"],
                 wall_s=time.perf_counter() - t_phase - then_s)
    return launches, err, stats, after


# -- speed: the speed layer's fold-in, its overlay, the ecommerce template ----

#: the hand-polled leg's writer: batches of new users, each with this many
#: half-star ratings on random items, one batch every SPEED_WRITER_GAP_S
#: for SPEED_WRITER_S (the JAX bench's speed leg, bench.py:855-876, runs
#: 8 s; cut to 5 because the hot swap re-folds every user it wrote, each
#: through a history read of the whole log, and the script has a time
#: limit)
SPEED_USERS_PER_BATCH, SPEED_EVENTS_PER_USER = 16, 8
SPEED_WRITER_S, SPEED_WRITER_GAP_S = 5.0, 0.05
#: known users that rate new items before the leg (their history comes
#: from the log), and how many items each
SPEED_KNOWN_USERS, SPEED_KNOWN_EVENTS = 64, 4
#: the leg behind the server's own poller (``PIO_SPEED_POLL_S`` 1)
SPEED_POLLER_S = 4.0
#: the ecommerce leg: cold users and views each
ECOM_COLD_USERS, ECOM_COLD_VIEWS = 32, 6


def rating_doc(user: str, item: str, r: float) -> dict:
    return {"event": "rate", "entityType": "user", "entityId": user,
            "targetEntityType": "item", "targetEntityId": item,
            "properties": {"rating": float(r)}}


def foldin_dispatches(foldin, rows) -> int:
    """The fused-entry launches ``FoldInSolver.solve(rows)`` makes: one a
    (ladder width, up to ``max_batch`` rows) bucket."""
    widths = foldin._width_ladder()
    per_width: dict = {}
    for cols, _vals in rows:
        d = min(len(cols), widths[-1])
        if d:
            w = next(x for x in widths if d <= x)
            per_width[w] = per_width.get(w, 0) + 1
    mb = foldin.max_batch()
    return sum(-(-n // mb) for n in per_width.values())


def pack_rows(rows, dev):
    """(cols, vals, mask) [B, max degree] tensors on ``dev`` of (cols, vals)
    rows, padding under mask 0."""
    d = max(max((len(c) for c, _v in rows), default=1), 1)
    cols = np.zeros((len(rows), d), np.int32)
    vals = np.zeros((len(rows), d), np.float32)
    mask = np.zeros((len(rows), d), np.float32)
    for r, (c, v) in enumerate(rows):
        cols[r, :len(c)], vals[r, :len(v)], mask[r, :len(c)] = c, v, 1.0
    return tuple(torch.from_numpy(a).to(dev) for a in (cols, vals, mask))


def hold_foldin(ak, als, table, rows, got, ref, l2: float, implicit: bool,
                alpha: float, what: str, trained: bool = True) -> dict:
    """Fold-in vectors ``got`` (the kernel's) against ``ref`` (the plain
    version's) of the same rows (each at most the ladder's widest, as the
    solver keeps them) within :func:`als_tolerance` (the trained table's
    rule, or an f32 table's), relative to max|ref|. Rows beyond it must be
    no more than 3x as far from the f64 solve of their system as the
    plain version, and rows with fewer observations than the rank also
    within ``NARROW_CEILING`` of the plain version or of the f64 solve.
    Raises on a disagreement; returns the errors."""
    got_t, ref_t = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    k = table.shape[1]
    d_min = min((len(c) for c, _v in rows if len(c)), default=k)
    err, rel = _rel_err(got_t, ref_t)
    tol = als_tolerance(torch.float32, d_min, k, trained=trained)
    out = {"rows": len(rows), "max_abs_err": err, "max_rel_err": rel}
    if rel <= tol:
        return out
    scale = float(ref_t.abs().max())
    beyond = [r for r in range(len(rows))
              if float((got_t[r] - ref_t[r]).abs().max()) > tol * scale]
    sub = [rows[r] for r in beyond]
    cols, vals, mask = pack_rows(sub, table.device)
    yty = als._gram_all(table) if implicit else None
    iters = als.CG_ITERS * (2 if implicit else 1)
    ref64 = f64_solve(ak, table.float(), cols.long(), vals, mask, l2, True,
                      iters, None, True, implicit, alpha, yty).cpu()
    k64 = _rel_err(got_t[beyond], ref64)[1]
    p64 = _rel_err(ref_t[beyond], ref64)[1]
    narrow = all(len(c) < k for c, _v in sub)
    if k64 > 3 * p64 + 1e-6 or not narrow or min(rel, k64) > NARROW_CEILING:
        raise AssertionError(f"{what}: max error {err:.3e} is {rel:.3e} of "
                             f"max|x_plain|; its {len(beyond)} rows beyond "
                             f"{tol} are {k64} from the f64 solve, the "
                             f"plain version {p64}")
    out.update(rows_beyond=len(beyond), beyond_f64_rel_err=k64,
               beyond_plain_f64_rel_err=p64)
    return out


def dense_distance(foldin, table_np, rows, vecs, l2, implicit, alpha,
                   n: int = 4) -> float:
    """Largest relative distance of the first ``n`` fold-ins from the dense
    f64 least-squares solve of their rows (``dense_reference_solve``): the
    gap 16 (32) cold CG steps leave; printed, not held."""
    worst = 0.0
    for (cols, vals), vec in list(zip(rows, vecs))[:n]:
        if not len(cols):
            continue
        ref = foldin.dense_reference_solve(table_np, cols[-512:],
                                           vals[-512:], l2,
                                           implicit=implicit, alpha=alpha)
        worst = max(worst, float(np.abs(vec - ref).max()
                                 / max(np.abs(ref).max(), 1e-30)))
    return worst


def foldin_case_rows(rng, m: int, lo: int, hi: int, b: int,
                     implicit: bool):
    """``b`` rows of lo..hi observations on a table of ``m`` rows: half
    stars, or for implicit the weights 1 to 4."""
    out = []
    for d in rng.integers(lo, hi + 1, b):
        cols = rng.integers(0, m, d).astype(np.int32)
        vals = (rng.integers(1, 5, d) if implicit
                else rng.integers(1, 11, d) / 2.0).astype(np.float32)
        out.append((cols, vals))
    return out


def foldin_kernel_cases(dev, runtime, ak, als, foldin, planted, table,
                        l2: float, small: bool = False) -> list:
    """``FoldInSolver`` on the card against the same solver on CPU tensors
    (the fused entry's plain version), by :func:`hold_foldin`: every
    ladder width × padded batch 1 / 8 / 64, explicit (λ·nnz) and implicit
    (YᵀY, α 1) on ``table`` (the served model's items), implicit again at
    rank 10 (padded rank 16) on planted factors; one fused launch a case;
    then a 700-observation history (the newest 512 kept), a batch with
    empty histories (exactly 0) and 65 rows of one width (two launches).
    Each case's distance to the dense solve is printed, not held."""
    rng = np.random.default_rng(41)
    widths = foldin._width_ladder()
    batches = (1, 8) if small else (1, 8, 64)
    m = table.shape[0]
    rank10 = torch.from_numpy(planted.planted_item_factors(
        m, 10, seed=43)).to(table.device)
    cases = []
    for implicit, tab, trained in ((False, table, True), (True, table, True),
                                   (True, rank10, False)):
        kw = dict(l2=l2, implicit=implicit, alpha=1.0)
        card = foldin.FoldInSolver(tab, **kw)
        host = foldin.FoldInSolver(tab.cpu(), **kw)
        tab_np = tab.cpu().numpy()
        lo = 1
        for width in widths:
            for b in batches:
                rows = foldin_case_rows(rng, m, lo, width, b, implicit)
                before = runtime.launch_counts()["als_fused_solve_cg"]
                got = card.solve(rows)
                launches = (runtime.launch_counts()["als_fused_solve_cg"]
                            - before)
                if dev.type == "cuda" and launches != 1:
                    raise AssertionError(f"speed: width {width}, B {b}: "
                                         f"{launches} fused launches")
                ref = host.solve(rows)
                what = (f"speed fold-in {'implicit' if implicit else 'explicit'}"
                        f" K {tab.shape[1]} width {width} B {b}")
                cases.append(dict(
                    implicit=implicit, K=int(tab.shape[1]), width=width, B=b,
                    launches=launches, **hold_foldin(
                        ak, als, tab, rows, got, ref, l2, implicit, 1.0,
                        what, trained),
                    dense_rel_err=dense_distance(foldin, tab_np, rows, got,
                                                 l2, implicit, 1.0)))
            lo = width + 1
    card = foldin.FoldInSolver(table, l2=l2)
    host = foldin.FoldInSolver(table.cpu(), l2=l2)
    long = foldin_case_rows(rng, m, 700, 700, 1, False)
    got = card.solve(long)
    newest = [(c[-widths[-1]:], v[-widths[-1]:]) for c, v in long]
    if not np.array_equal(host.solve(long), host.solve(newest)):
        raise AssertionError("speed: a 700-observation history did not "
                             "keep its newest 512")
    cases.append(dict(case="history_700", **hold_foldin(
        ak, als, table, newest, got, host.solve(long), l2, False, 1.0,
        "speed fold-in of 700 observations")))
    rows = foldin_case_rows(rng, m, 1, 30, 5, False)
    for r in (0, 2, 4):
        rows[r] = (np.empty(0, np.int32), np.empty(0, np.float32))
    got = card.solve(rows)
    if (got[[0, 2, 4]] != 0).any():
        raise AssertionError("speed: an empty history did not fold to 0")
    cases.append(dict(case="empty_rows", **hold_foldin(
        ak, als, table, rows, got, host.solve(rows), l2, False, 1.0,
        "speed fold-in with empty rows")))
    rows = foldin_case_rows(rng, m, 9, 32, 65, False)
    before = runtime.launch_counts()["als_fused_solve_cg"]
    got = card.solve(rows)
    launches = runtime.launch_counts()["als_fused_solve_cg"] - before
    if dev.type == "cuda" and launches != 2:
        raise AssertionError(f"speed: 65 rows of width 32 took {launches} "
                             "launches")
    cases.append(dict(case="rows_65", launches=launches, **hold_foldin(
        ak, als, table, rows, got, host.solve(rows), l2, False, 1.0,
        "speed fold-in of 65 rows")))
    return cases


def foldin_timings(dev, ak, als, foldin, table, l2: float,
                   reps: int = 10) -> list:
    """The fused entry at fold-in shapes (B 1 / 64 at D 8 / 512, explicit
    and implicit, every row full, cold): ms of one call (CUDA events) and
    its device time (``graph_ms``), the plain version's on the same
    tensors, the library yardstick (the Gram alone, one ``torch.bmm``;
    implicit the weighted Gram plus YᵀY, one ``torch.baddbmm``), the
    bound (``ak.bucket_bound`` of this run's inputs, and on the FMA units
    beside it), and the wall of one ``FoldInSolver.solve`` of the same
    rows from numpy (``solve_ms``: the host's packing, copies and result
    fetch around the launch)."""
    from incubator_predictionio_tpu_torch import runtime

    rng = np.random.default_rng(45)
    m, k = table.shape
    out = []
    for implicit in (False, True):
        yty = als._gram_all(table) if implicit else None
        iters = als.CG_ITERS * (2 if implicit else 1)
        solver = foldin.FoldInSolver(table, l2=l2, implicit=implicit,
                                     alpha=1.0)
        for b in (1, 64):
            for d in (8, 512):
                rows = foldin_case_rows(rng, m, d, d, b, implicit)
                cols, vals, mask = pack_rows(rows, dev)
                kw = dict(iters=iters, implicit=implicit, alpha=1.0,
                          yty=yty)

                def fn():
                    return ak.als_fused_solve_cg(table, cols, vals, mask, l2,
                                                 **kw)

                def plain():
                    return ak.als_fused_solve_cg_plain(table, cols, vals,
                                                       mask, l2, **kw)

                g = table[cols] * mask[..., None]
                if implicit:
                    wg = g * vals[..., None]

                    def gram():
                        return torch.baddbmm(yty, wg.mT, g)
                else:
                    def gram():
                        return torch.bmm(g.mT, g)

                bound_ms, bound_by = ak.bucket_bound(
                    cols, mask, k, iters, False, table.dtype,
                    implicit=implicit)
                fma_ms, fma_by = ak.bucket_bound(
                    cols, mask, k, iters, False, table.dtype,
                    f32_flops=runtime.F32_FLOPS, implicit=implicit)
                err, _rel = _rel_err(fn(), plain())
                walls = []
                for _ in range(reps + 2):
                    t0 = time.perf_counter()
                    solver.solve(rows)
                    walls.append(1e3 * (time.perf_counter() - t0))
                out.append({
                    "shape": "foldin", "dtype": "float32", "B": b, "D": d,
                    "K": k, "nnz": b * d, "iters": iters, "cold": True,
                    **({"implicit": True, "alpha": 1.0} if implicit
                       else {}),
                    "ms": median_ms(fn, reps=reps, warm=2),
                    "graph_ms": graph_ms(fn, calls=10, reps=reps),
                    "plain_ms": median_ms(plain, reps=reps, warm=2),
                    "library_ms": median_ms(gram, reps=reps, warm=2),
                    "library_graph_ms": graph_ms(gram, calls=10, reps=reps),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_fma_ms": fma_ms, "bound_fma_by": fma_by,
                    "solve_ms": statistics.median(walls[2:]),
                    "max_abs_err": err})
    return out


def hist_quantile(bounds, counts, q: float):
    """A quantile of histogram bucket counts (the registry's
    interpolation), for the difference of two snapshots."""
    total = sum(counts)
    if not total:
        return None
    rank, cum = q * total, 0
    for i, c in enumerate(counts):
        if c and cum + c >= rank:
            if i >= len(bounds):
                return bounds[-1]
            lo = bounds[i - 1] if i else 0.0
            return lo + (bounds[i] - lo) * max(rank - cum, 0.0) / c
        cum += c
    return bounds[-1]


class FoldinDispatches:
    """Counts, while open, the fused-entry launches every
    ``FoldInSolver.solve`` on a card makes (:func:`foldin_dispatches`; a
    warm-up's too), whichever thread solves: what the launch counter must
    show."""

    def __init__(self, foldin):
        import threading

        self.cls, self.n = foldin.FoldInSolver, 0
        self.orig = self.cls.solve
        lock = threading.Lock()

        def solve(solver, rows):
            if solver.device.type != "cpu":   # the checks' plain solves
                with lock:
                    self.n += foldin_dispatches(foldin, rows)
            return self.orig(solver, rows)

        self.cls.solve = solve

    def close(self) -> int:
        self.cls.solve = self.orig
        return self.n


class PollSplit:
    """Times an overlay's polls by part while installed, whichever thread
    polls: the tail read (``read_interactions_since``), the history reads
    (``_history``), the solve (``solver.solve``, its result fetched) and
    the publish (the rest of ``_fold_in``); keeps each fold's published
    vectors (without a lookup, so the overlay's hit counts stay the
    traffic's)."""

    def __init__(self, overlay, store_cls):
        self.ov, self.store = overlay, store_cls
        self.polls: list = []
        self.vectors: dict = {}
        self._cur: dict = {}

    def _timed(self, part, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self._cur[part] = self._cur.get(part, 0.0) + (
                    time.perf_counter() - t0)
        return call

    def __enter__(self):
        ov = self.ov
        self.orig_read = self.store.__dict__["read_interactions_since"]
        self.store.read_interactions_since = staticmethod(
            self._timed("tail_s", self.orig_read.__func__))
        ov._history = self._timed("history_s", ov._history)
        ov.solver.solve = self._timed("solve_s", ov.solver.solve)
        fold = self._timed("fold_s", ov._fold_in)

        def fold_in(pending, cursor):
            n = fold(pending, cursor)
            with ov._lock:
                self.vectors.update({k: ov._vectors[k][0]
                                     for k, _c in pending
                                     if k in ov._vectors})
            return n

        ov._fold_in = fold_in
        self._poll = ov.poll
        ov.poll = self.poll   # the overlay's own poller thread too
        return self

    def poll(self, **kw) -> dict:
        self._cur = {}
        t0 = time.perf_counter()
        s = self._poll(**kw)
        wall = time.perf_counter() - t0
        part = dict(self._cur)
        part["publish_s"] = (part.get("fold_s", 0.0)
                             - part.get("history_s", 0.0)
                             - part.get("solve_s", 0.0))
        self.polls.append(dict(wall_s=wall, solved=s.get("solved", 0),
                               **part))
        return s

    def __exit__(self, *exc):
        self.store.read_interactions_since = self.orig_read
        for name in ("_history", "_fold_in", "poll"):
            self.ov.__dict__.pop(name, None)
        self.ov.solver.__dict__.pop("solve", None)

    def split(self, start: int = 0, end=None) -> dict:
        """p50 / p95 / max of each part over the polls ``start:end`` that
        folded keys in."""
        polls = self.polls[start:end]
        folded = [p for p in polls if p["solved"]]
        out = {"polls": len(polls), "folding_polls": len(folded)}
        for part in ("wall_s", "tail_s", "history_s", "solve_s",
                     "publish_s"):
            xs = [p.get(part, 0.0) for p in folded]
            if xs:
                out[part.replace("_s", "_ms")] = {
                    "p50": 1e3 * float(np.percentile(xs, 50)),
                    "p95": 1e3 * float(np.percentile(xs, 95)),
                    "max": 1e3 * float(max(xs))}
        return out


def check_vec_answer(kernels, dev, vec, items_t, allowed, doc, body,
                     what, model) -> float:
    """One served answer against the plain top-k of a query vector over
    the item table (``allowed`` a [I] bool mask or None); ids through the
    item BiMap of ``model``."""
    got = body["itemScores"]
    num = doc["num"]
    n_live = num if allowed is None else min(num, int(allowed.sum()))
    ref_s, ref_i = kernels.score_topk_plain(
        torch.as_tensor(vec).reshape(1, -1).to(dev), items_t,
        None if allowed is None else allowed.to(dev),
        min(num + 1, items_t.shape[0]))
    if len(got) != n_live:
        raise AssertionError(f"{what}: {len(got)} items, expected {n_live}")
    got_s = np.array([[x["score"] for x in got]])
    got_i = np.array([[model.item_bimap[x["item"]] for x in got]])
    return check_topk(got_s, got_i, ref_s.cpu()[:, :n_live + 1],
                      ref_i.cpu()[:, :n_live + 1], n_live, what)


def speed_phase(dev, runtime, kernels, als, ak, planted, log: dict,
                small: bool = False) -> tuple:
    """The speed layer on the cpplog phase's store (``log``: its app,
    access key and continued instance, rank 128 at ML-20M width), the
    writer, the event server and the prediction server in this process.
    (1) :func:`foldin_kernel_cases` and :func:`foldin_timings` on the
    served item table. (2) ``PredictionServer(config=...)`` with the
    overlay ``_build_speed_overlays`` made (``PIO_SPEED_POLL_S`` 3600: the
    phase polls by hand) and an ``EventServer``: 64 known users rate 4 new
    items each, then batches of 16 new users × 8 half-star ratings go to
    ``/batch/events.json`` every 50 ms for 5 s while the overlay polls,
    every ingested user looked up after each poll (:class:`PollSplit`
    times each poll by part). Checks: (a) every folded vector against
    the plain fold-in of its history (the posted ratings; a known user's
    read through ``EventStore.find``) by :func:`hold_foldin`; (b) 64 folded
    users' ``/queries.json`` answers (16 with ``excludeSeen``) against
    the plain top-k of the overlay's own vector; (c) one 64-body
    ``_handle_batch`` of overlay users (the object path) and base users
    (the fast path); (d) a user with no events gets no items; (e) a new
    event makes a folded user miss after ``poll(max_keys=0)`` and the
    next poll folds it again; (g) ``GET /``'s ``speedOverlay`` is the
    overlay's ``stats()`` and ``modelStalenessSec`` ≥ 0; (f) ``POST
    /reload`` (``load_models()`` again, the new models warmed first) while
    16 clients query base users, every answer a 200, some during the
    reload; it empties and stops the old overlay, the new one covers no
    one until it polls, then re-solves the adopted new users;
    its overlay then behind the server's own poller (``PIO_SPEED_POLL_S``
    1): the adopted users re-folded first, then 4 s of the same writer,
    each folded user queried once (``pio_freshness_seconds`` p95 of that
    leg); (h) over all of it, the fused entry launched exactly the
    polls' dispatches and the hot swap's warm-up, the two-stage and
    R-row forms never, score+top-k at least once an overlay user's
    query. (3) :func:`ecommerce_leg`.
    Returns (launches by kernel, max score error, stats)."""
    import threading

    from incubator_predictionio_tpu_torch.data.store import EventStore
    from incubator_predictionio_tpu_torch.models.recommendation import (
        engine,
    )
    from incubator_predictionio_tpu_torch.obs import freshness
    from incubator_predictionio_tpu_torch.servers.event_server import (
        EventServer,
        EventServerConfig,
    )
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        PredictionServer,
        ServerConfig,
    )
    from incubator_predictionio_tpu_torch.speed import foldin

    t_phase = time.perf_counter()
    writer_s = 2.0 if small else SPEED_WRITER_S
    poller_s = 2.5 if small else SPEED_POLLER_S
    saved_poll = os.environ.get("PIO_SPEED_POLL_S")
    os.environ["PIO_SPEED_POLL_S"] = "3600"
    stats: dict = {}
    server = es = counter = None
    stop = threading.Event()
    threads: list = []
    try:
        t0 = time.perf_counter()
        server = PredictionServer(
            engine.RecommendationEngine().apply(), device=dev,
            config=ServerConfig(ip="127.0.0.1", port=0,
                                engine_instance_id=log["instance"]))
        port = server.start_background()
        stats["deploy_s"] = time.perf_counter() - t0
        [ov] = server._speed_overlays
        if ov is None or not ov.enabled:
            raise AssertionError("speed: the server built no overlay")
        model = server.models[0]
        items_t, uf_t = model.item_factors, model.user_factors
        l2 = ov.config.l2
        if ov.solver.other_factors.data_ptr() != items_t.data_ptr():
            raise AssertionError("speed: the overlay copied the item table")
        es = EventServer(EventServerConfig(ip="127.0.0.1", port=0,
                                           max_batch=500))
        es_url = f"http://127.0.0.1:{es.start_background()}"
        base = f"http://127.0.0.1:{port}"

        # -- (1) the fused entry at fold-in shapes -------------------------
        t0 = time.perf_counter()
        stats["kernel_cases"] = foldin_kernel_cases(
            dev, runtime, ak, als, foldin, planted, items_t, l2, small)
        stats["kernel_cases_s"] = time.perf_counter() - t0
        timings = ([] if dev.type != "cuda" else
                   foldin_timings(dev, ak, als, foldin, items_t, l2))

        # -- (2) the served path, hand-polled ------------------------------
        rng = np.random.default_rng(47)
        n_items = len(model.item_bimap)
        inv_users = model.user_bimap.inverse
        inv_items = model.item_bimap.inverse
        posted: dict = {}       # new user -> (item rows, ratings)
        ingested: list = []

        def post(app_key, docs):
            status, got = http_json(
                "POST", f"{es_url}/batch/events.json?accessKey={app_key}",
                json.dumps(docs).encode())
            if status != 200 or any(g.get("status") != 201 for g in got):
                raise AssertionError(f"speed: a batch got {status} "
                                     f"{got!r:.300}")

        def writer(prefix, seconds, errors):
            j, t_end = 0, time.perf_counter() + seconds
            try:
                while time.perf_counter() < t_end and not stop.is_set():
                    docs, batch = [], []
                    for u in range(SPEED_USERS_PER_BATCH):
                        uid = f"{prefix}{j + u}"
                        its = rng.choice(n_items, SPEED_EVENTS_PER_USER,
                                         replace=False).astype(np.int32)
                        rs = (rng.integers(1, 11, len(its)) / 2.0).astype(
                            np.float32)
                        docs += [rating_doc(uid, inv_items[int(i)], r)
                                 for i, r in zip(its, rs)]
                        batch.append((uid, (its, rs)))
                    post(log["key"], docs)
                    posted.update(batch)
                    ingested.extend(uid for uid, _h in batch)
                    j += SPEED_USERS_PER_BATCH
                    stop.wait(SPEED_WRITER_GAP_S)
            except Exception as e:  # raised again by the main thread
                errors.append(e)

        def run_writer(prefix, seconds):
            errors: list = []
            t = threading.Thread(target=writer, args=(prefix, seconds,
                                                      errors), daemon=True)
            threads.append(t)
            t.start()
            return t, errors

        def join_writer(t, errors):
            t.join(60)
            if t.is_alive() or errors:
                raise AssertionError(f"speed: the writer {errors or 'hung'}")

        runtime.reset_launch_counts()
        counter = FoldinDispatches(foldin)
        known = [inv_users[int(r)] for r in rng.choice(
            len(model.user_bimap), SPEED_KNOWN_USERS, replace=False)]
        docs = []
        for u in known:
            for i in rng.choice(n_items, SPEED_KNOWN_EVENTS, replace=False):
                docs.append(rating_doc(u, inv_items[int(i)],
                                       rng.integers(1, 11) / 2.0))
        post(log["key"], docs)
        max_lag = 0
        with PollSplit(ov, EventStore) as split:
            wt = run_writer("s", writer_s)
            while wt[0].is_alive():
                s = split.poll()
                max_lag = max(max_lag, int(s.get("lag", 0)))
                for uid in list(ingested):
                    ov.lookup(uid)
            join_writer(*wt)
            for _ in range(100):
                s = split.poll()
                if not s.get("dirty"):
                    break
            for uid in list(ingested):
                ov.lookup(uid)
            st = ov.stats()
            looked = st["hits"] + st["misses"]
            stats["hand_polled"] = {
                "writer_s": writer_s, "new_users": len(ingested),
                "known_users": len(known), "foldins": st["foldins"],
                "hit_rate": st["hits"] / looked if looked else None,
                "worst_cursor_lag_events": max_lag,
                "poll_split": split.split()}
            if st["dirty"] or not set(ingested) <= set(split.vectors) \
                    or not set(known) <= set(split.vectors):
                raise AssertionError(f"speed: not every user folded in: "
                                     f"{st}")

            # (a) every folded vector against the plain fold-in
            def history(u):
                if u in posted:
                    return posted[u]
                cols, vals = [], []
                for e in EventStore.find(
                        app_name=log["name"], entity_type="user",
                        entity_id=u, target_entity_type="item",
                        event_names=["rate", "buy"], limit=512,
                        reversed=True):
                    col = model.item_bimap.get(e.target_entity_id)
                    if col is None:
                        continue
                    cols.append(col)
                    vals.append(4.0 if e.event == "buy" else float(
                        e.properties.to_jsonable()["rating"]))
                return (np.asarray(cols[::-1], np.int32),
                        np.asarray(vals[::-1], np.float32))

            host = foldin.FoldInSolver(items_t.cpu(), l2=l2)
            keys = sorted(split.vectors)
            rows = [history(u) for u in keys]
            got = np.stack([split.vectors[u] for u in keys])
            stats["hand_polled"]["vs_plain"] = hold_foldin(
                ak, als, items_t, rows, got, host.solve(rows), l2, False,
                1.0, "speed: the hand-polled fold-ins")
            stats["hand_polled"]["dense_rel_err"] = dense_distance(
                foldin, items_t.cpu().numpy(), rows, got, l2, False, 1.0)

            # (b) 64 folded users over HTTP, (d) one with no events
            err = 0.0
            cold = ingested[:48]
            ov_docs = [{"user": u, "num": 10} for u in cold] + [
                {"user": u, "num": 10, "excludeSeen": True}
                for u in known[:16]]
            ov_walls = []
            for doc in ov_docs:
                t1 = time.perf_counter()
                status, body = http_json("POST", f"{base}/queries.json", doc)
                ov_walls.append(time.perf_counter() - t1)
                if status != 200:
                    raise AssertionError(f"speed: {doc}: {status} {body}")
                allowed = None
                if doc.get("excludeSeen"):
                    allowed = torch.ones(n_items, dtype=torch.bool)
                    allowed[torch.from_numpy(np.asarray(
                        model.user_seen[model.user_bimap[doc["user"]]],
                        np.int64))] = False
                err = max(err, check_vec_answer(
                    kernels, dev, split.vectors[doc["user"]], items_t,
                    allowed, doc, body, f"speed query {doc}", model))
            base_users = [inv_users[int(r)] for r in rng.choice(
                len(model.user_bimap), 64, replace=False)
                if inv_users[int(r)] not in split.vectors]
            base_walls = []
            for u in base_users[:32]:
                doc = {"user": u, "num": 10}
                t1 = time.perf_counter()
                status, body = http_json("POST", f"{base}/queries.json", doc)
                base_walls.append(time.perf_counter() - t1)
                err = max(err, check_answer(kernels, dev, uf_t, items_t, doc,
                                            None, body, f"speed base {u}",
                                            model=model))
            status, body = http_json("POST", f"{base}/queries.json",
                                     {"user": "nosuch-speed", "num": 5})
            if status != 200 or body["itemScores"]:
                raise AssertionError(f"speed: an unknown user got {body}")

            # (c) one batch of overlay and base users
            mixed = [u for pair in zip(cold[:32], base_users[:32])
                     for u in pair]
            results = server._handle_batch([json.dumps(
                {"user": u, "num": 5}).encode() for u in mixed],
                "default", "default")
            for u, res in zip(mixed, results):
                doc = {"user": u, "num": 5}
                if u in split.vectors:
                    if not isinstance(res, dict):
                        raise AssertionError(f"speed: overlay user {u} in "
                                             f"the batch took {type(res)}")
                    err = max(err, check_vec_answer(
                        kernels, dev, split.vectors[u], items_t, None, doc,
                        res, f"speed batch {u}", model))
                else:
                    if not isinstance(res, (bytes, bytearray)):
                        raise AssertionError(f"speed: base user {u} in the "
                                             f"batch took {type(res)}")
                    err = max(err, check_answer(
                        kernels, dev, uf_t, items_t, doc, None,
                        json.loads(res), f"speed batch {u}", model=model))

            # (e) a new event: a miss after poll(max_keys=0), then a re-fold
            u = cold[0]
            extra = int(rng.integers(n_items))
            post(log["key"], [rating_doc(u, inv_items[extra], 5.0)])
            split.poll(max_keys=0)
            if ov.covers(u) or ov.lookup(u) is not None:
                raise AssertionError("speed: a dirtied user still hit")
            if split.poll().get("solved", 0) < 1 or not ov.covers(u):
                raise AssertionError("speed: the dirtied user was not "
                                     "folded again")
            cols, vals = posted[u]
            posted[u] = (np.r_[cols, np.int32(extra)].astype(np.int32),
                         np.r_[vals, np.float32(5.0)].astype(np.float32))
            hold_foldin(ak, als, items_t, [posted[u]],
                        split.vectors[u][None], host.solve([posted[u]]), l2,
                        False, 1.0, "speed: the re-folded user")

            # (g) GET /
            status, info = http_json("GET", f"{base}/")
            so, st = info["speedOverlay"], ov.stats()
            if status != 200 or so["overlays"] != 1 or any(
                    so[k] != st[k] for k in ("size", "hits", "misses",
                                             "foldins")) \
                    or not info["modelStalenessSec"] >= 0:
                raise AssertionError(f"speed: GET / {so} against {st}, "
                                     f"staleness "
                                     f"{info.get('modelStalenessSec')}")
            stats["status"] = {"speedOverlay": so,
                               "modelStalenessSec":
                                   info["modelStalenessSec"]}
        stats["http_overlay_p50_ms"] = 1e3 * statistics.median(ov_walls)
        stats["http_base_p50_ms"] = 1e3 * statistics.median(base_walls)

        # (f) the hot swap, POST /reload (load_models() again, the new
        # models warmed before the swap) while 16 clients query base
        # users; its overlay behind the server's own poller
        # (PIO_SPEED_POLL_S 1)
        os.environ["PIO_SPEED_POLL_S"] = "1"
        old = ov
        swap_stop, swap_answers = threading.Event(), []

        def swap_client(user):
            while not swap_stop.is_set():
                status, body = http_json("POST", f"{base}/queries.json",
                                         {"user": user, "num": 10})
                swap_answers.append(
                    (status, len(body["itemScores"]) if status == 200
                     else body))

        swap_clients = [threading.Thread(target=swap_client, args=(u,),
                                         daemon=True)
                        for u in base_users[:16]]
        threads += swap_clients
        for t in swap_clients:
            t.start()
        while len(swap_answers) < 16:
            time.sleep(0.01)
        before_swap = len(swap_answers)
        t0 = time.perf_counter()
        status, body = http_json("POST", f"{base}/reload", b"")
        stats["hot_swap_s"] = time.perf_counter() - t0
        during_swap = len(swap_answers) - before_swap
        swap_stop.set()
        for t in swap_clients:
            t.join(60)
        failed = [a for a in swap_answers if a != (200, 10)]
        stats["reload_under_load"] = {
            "clients": len(swap_clients), "answers": len(swap_answers),
            "answered_during_reload": during_swap,
            "reload_status": status, "failed": len(failed)}
        if status != 200 or failed or not during_swap:
            raise AssertionError(f"speed: POST /reload under load: "
                                 f"{status} {body}, {len(failed)} failed "
                                 f"answers {failed[:3]}, {during_swap} "
                                 "answered during the reload")
        [ov] = server._speed_overlays
        adopted = list(posted)
        # the poller's first poll comes a second after the swap
        st = ov.stats()
        if old.stats()["size"] or old._thread is not None or ov is old \
                or any(ov.covers(u) for u in adopted[:64]) \
                or st["dirty"] != len(adopted) or st["foldins"]:
            raise AssertionError(f"speed: after the swap, the old overlay "
                                 f"{old.stats()}, the new {st}")
        fam = freshness.FRESHNESS_SECONDS.labels(engine="recommendation")
        with PollSplit(ov, EventStore) as split3:
            # the poller first re-folds the adopted users, each through a
            # history read of the log (they are new to this overlay's
            # tail); the writer starts once they are done
            deadline = time.perf_counter() + 240
            while (ov.stats()["dirty"] or not split3.polls) \
                    and time.perf_counter() < deadline:
                time.sleep(0.05)
            if ov.stats()["dirty"]:
                raise AssertionError(f"speed: the poller left "
                                     f"{ov.stats()['dirty']} adopted users")
            adopted_s = time.perf_counter() - t0
            adopted_polls = len(split3.polls)
            if set(split3.vectors) != set(adopted):
                raise AssertionError("speed: the new overlay re-solved "
                                     f"{len(split3.vectors)} of "
                                     f"{len(adopted)} adopted users")
            host = foldin.FoldInSolver(server.models[0].item_factors.cpu(),
                                       l2=l2)
            rows = [posted[u] for u in adopted]
            stats["hot_swap"] = {
                "adopted": len(adopted), "refold_s": adopted_s,
                "vs_plain": hold_foldin(
                    ak, als, server.models[0].item_factors, rows,
                    np.stack([split3.vectors[u] for u in adopted]),
                    host.solve(rows), l2, False, 1.0,
                    "speed: the adopted users' fold-ins"),
                "poll_split": split3.split(0, adopted_polls)}
            before = fam.snapshot()
            n0 = len(ingested)
            wt = run_writer("p", poller_s)
            served: set = set()

            def serve_folded():
                for uid in ingested[n0:]:
                    if uid not in served and ov.covers(uid):
                        status, body = http_json(
                            "POST", f"{base}/queries.json",
                            {"user": uid, "num": 10})
                        if status != 200 or len(body["itemScores"]) != 10:
                            raise AssertionError(f"speed: {uid}: {status}")
                        served.add(uid)

            while wt[0].is_alive():
                serve_folded()
                time.sleep(0.05)
            join_writer(*wt)
            deadline = time.perf_counter() + 10
            while len(served) < len(ingested) - n0 \
                    and time.perf_counter() < deadline:
                serve_folded()
                time.sleep(0.05)
            ov.stop()   # no poll runs past the count below
        after = fam.snapshot()
        counts = [a - b for a, b in zip(after[0], before[0])]
        stats["poller"] = {
            "seconds": poller_s, "new_users": len(ingested) - n0,
            "served": len(served),
            "polls": len(split3.polls) - adopted_polls,
            "freshness_observations": after[2] - before[2],
            "freshness_p50_s": hist_quantile(fam._bounds, counts, 0.5),
            "freshness_p95_s": hist_quantile(fam._bounds, counts, 0.95),
            "poll_split": split3.split(adopted_polls)}
        if len(served) != len(ingested) - n0:
            raise AssertionError(f"speed: {len(served)} of "
                                 f"{len(ingested) - n0} users folded "
                                 "behind the poller")

        # (h) the launches of the whole path
        got = runtime.launch_counts()
        launches = {e: got[e] for e in ROUTE_ENTRY.values()}
        launches["score_topk"] = got["score_topk"]
        dispatches = counter.close()
        launches["expected_fused"] = dispatches
        n_ov_queries = len(ov_docs) + 32 + len(served)
        if dev.type == "cuda" and (
                got["als_fused_solve_cg"] != dispatches
                or got["als_solve_cg"] or got["als_solve_cg_rows8"]
                or got["score_topk"] < n_ov_queries):
            raise AssertionError(f"speed: launches {launches} (overlay "
                                 f"queries {n_ov_queries})")
        stats["launches"] = launches
        stats["recommendation_s"] = time.perf_counter() - t_phase

        # -- (3) the ecommerce template ------------------------------------
        os.environ["PIO_SPEED_POLL_S"] = "3600"
        server.stop()
        server = None
        t0 = time.perf_counter()
        ecom_launches, err_e, stats["ecommerce"] = ecommerce_leg(
            dev, runtime, als, ak, planted, es_url, post, small)
        stats["ecommerce"]["wall_s"] = time.perf_counter() - t0
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        if counter is not None:
            counter.close()
        if server is not None:
            server.stop()
        if es is not None:
            es.stop()
        if saved_poll is None:
            os.environ.pop("PIO_SPEED_POLL_S", None)
        else:
            os.environ["PIO_SPEED_POLL_S"] = saved_poll
    stats["wall_s"] = time.perf_counter() - t_phase
    return (launches, ecom_launches, timings), max(err, err_e), stats


def ecommerce_leg(dev, runtime, als, ak, planted, es_url: str, post,
                  small: bool = False) -> tuple:
    """The ecommerce template on the same store: a new app (``pio app
    new``) holding store-als's 1,000,000 planted (user, item) pairs as
    ``view`` events, every 8th also a ``buy``, and the items' ``$set``
    categories; ``CoreWorkflow.run_train`` with
    ``examples/ecommerce-quickstart/engine.json``'s algorithm (rank 10,
    20 iterations, λ 0.01, α 1, seed 3; the factory by its JAX name, as
    the CLI maps it): every bucket on the fused entry, the implicit loss
    within ``IMPLICIT_LOSS_TOL`` of the plain route's from the same
    initial state, and the fused entry against its plain version on the
    heaviest chunk of every bucket width of both sides
    (:func:`check_als_chunk`, the widths from 1). Then deployed in this
    process with its implicit overlay: 32 new users' views folded in at a
    poll (implicit, padded rank 16; held to the plain fold-in), 8 of them
    served over HTTP against the plain scoring (items · vector, the
    freshly read seen set masked, ``top_k_with_exclusions``); a known
    user; a user with recent views the overlay has not folded; a user
    with no events (popularity); and the known user again under an
    ``unavailableItems`` constraint. Returns (launches by kernel, max
    score error, stats)."""
    from incubator_predictionio_tpu_torch.cli import commands
    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.data.interactions import (
        Interactions,
    )
    from incubator_predictionio_tpu_torch.data.datamap import DataMap
    from incubator_predictionio_tpu_torch.data.storage import Storage
    from incubator_predictionio_tpu_torch.data.store import EventStore
    from incubator_predictionio_tpu_torch.models.ecommerce import (
        engine as ecom,
    )
    from incubator_predictionio_tpu_torch.ops.topk import (
        top_k_with_exclusions,
    )
    from incubator_predictionio_tpu_torch.parallel.context import (
        RuntimeContext,
    )
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        PredictionServer,
        ServerConfig,
    )
    from incubator_predictionio_tpu_torch.speed import foldin
    from incubator_predictionio_tpu_torch.utils.times import parse_iso8601
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    name = "EcomApp"
    stats: dict = {}
    key = re.search(r"Access Key: (\S+)", cli("app", "new", name)).group(1)
    app_id = Storage.get_meta_data_apps().get_by_name(name).id
    users, items, _r, n_users, n_items = store_als_ratings(planted, small)
    user_ids = [f"u{k}" for k in range(n_users)]
    item_ids = [f"i{k}" for k in range(n_items)]
    dao = Storage.get_events()
    t0 = time.perf_counter()
    buys = np.arange(0, len(users), 8)
    for ev, sel in (("view", slice(None)), ("buy", buys)):
        dao.import_interactions(Interactions(
            user_idx=users[sel], item_idx=items[sel],
            values=np.ones(len(users[sel]), np.float32), user_ids=user_ids,
            item_ids=item_ids), app_id, event_name=ev, value_prop="w",
            base_time=parse_iso8601(STORE_T0))
    dao.insert_batch([Event(
        event="$set", entity_type="item", entity_id=i,
        properties=DataMap({"categories": [f"c{k % 7}"]}))
        for k, i in enumerate(item_ids)], app_id)
    stats["import_s"] = time.perf_counter() - t0
    stats["events"] = len(users) + len(buys) + n_items
    variant = json.load(open(os.path.join(
        REPO, "examples", "ecommerce-quickstart", "engine.json")))
    variant["datasource"]["params"]["appName"] = name
    variant["algorithms"][0]["params"]["appName"] = name
    eng, ep = commands.engine_from_variant(variant)
    p = ep.algorithm_params_list[0][1]
    runtime.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    iid = CoreWorkflow.run_train(eng, ep, device=dev)
    sync(dev)
    stats["train_s"] = time.perf_counter() - t0
    counts = runtime.launch_counts()
    train_launches = {e: counts[e] for e in ROUTE_ENTRY.values()}
    if dev.type == "cuda" and (train_launches["als_fused_solve_cg"] <= 0
                               or train_launches["als_solve_cg"]
                               or train_launches["als_solve_cg_rows8"]):
        raise AssertionError(f"ecommerce: training launched "
                             f"{train_launches}")
    ctx = RuntimeContext(device=dev)
    pd = ecom.ECommercePreparator().prepare(ctx, ecom.ECommerceDataSource(
        ep.data_source_params[1]).read_training(ctx))
    [model] = CoreWorkflow.load_models(iid, eng, ep, device=dev)
    nu, ni = len(pd.user_bimap), len(pd.item_bimap)
    t0 = time.perf_counter()
    plain = als.als_train_implicit(
        pd.users, pd.items, pd.weights, nu, ni, rank=p.rank,
        iterations=p.num_iterations, l2=p.lambda_, alpha=p.alpha,
        seed=p.seed, device=dev, use_kernel=False)
    sync(dev)
    stats["plain_train_s"] = time.perf_counter() - t0
    st = als.ALSState(user_factors=model.user_factors,
                      item_factors=model.item_factors)
    loss = als.implicit_loss(st, pd.users, pd.items, pd.weights, p.alpha,
                             p.lambda_)
    loss_plain = als.implicit_loss(plain, pd.users, pd.items, pd.weights,
                                   p.alpha, p.lambda_)
    rel = abs(loss - loss_plain) / abs(loss_plain)
    stats.update(rank=p.rank, iterations=p.num_iterations, users=nu,
                 items=ni, nnz=len(pd.weights), loss=loss,
                 loss_plain=loss_plain, loss_rel_err=rel,
                 train_launches=train_launches)
    if not (np.isfinite(loss) and rel <= IMPLICIT_LOSS_TOL):
        raise AssertionError(f"ecommerce: implicit loss {loss!r} against "
                             f"the plain route's {loss_plain!r}")
    checks = []
    if dev.type == "cuda":
        u_tree, i_tree = als.prepare_trees(pd.users, pd.items, pd.weights,
                                           nu, ni, device=dev)[:2]
        for side, tree, table, prev in (
                ("user", u_tree, model.item_factors, plain.user_factors),
                ("item", i_tree, model.user_factors, plain.item_factors)):
            for d, chunk in sorted(heaviest_chunks_by_width(
                    tree, p.rank, als.CHUNK_ELEMS).items()):
                errs = check_als_chunk(ak, als, "als_fused_solve_cg", table,
                                       chunk, prev, implicit=True,
                                       alpha=p.alpha)
                checks.append({"side": side, "D": d,
                               "B": int(chunk[0].shape[0]), **errs})
        del u_tree, i_tree
    stats["width_checks"] = checks

    # -- served, with the implicit overlay --------------------------------
    server = PredictionServer(eng, device=dev, config=ServerConfig(
        ip="127.0.0.1", port=0, engine_instance_id=iid))
    try:
        base = f"http://127.0.0.1:{server.start_background()}"
        [ov] = server._speed_overlays
        if ov is None or not ov.config.implicit:
            raise AssertionError("ecommerce: no implicit overlay")
        model = server.models[0]
        items_t = model.item_factors
        rng = np.random.default_rng(49)
        runtime.reset_launch_counts()
        cold = {}
        docs = []
        for k in range(ECOM_COLD_USERS):
            its = rng.choice(n_items, ECOM_COLD_VIEWS, replace=False)
            cold[f"w{k}"] = its
            docs += [{"event": "view", "entityType": "user",
                      "entityId": f"w{k}", "targetEntityType": "item",
                      "targetEntityId": f"i{int(i)}"} for i in its]
        post(key, docs)
        s = ov.poll()
        if s.get("solved") != ECOM_COLD_USERS:
            raise AssertionError(f"ecommerce: the poll said {s}")
        rows = [(np.asarray([model.item_bimap[f"i{int(i)}"] for i in its],
                            np.int32), np.ones(len(its), np.float32))
                for its in cold.values()]
        with ov._lock:
            got = np.stack([ov._vectors[u][0] for u in cold])
        host = foldin.FoldInSolver(items_t.cpu(), l2=p.lambda_,
                                   implicit=True, alpha=p.alpha)
        stats["foldin_vs_plain"] = hold_foldin(
            ak, als, items_t, rows, got, host.solve(rows), p.lambda_, True,
            p.alpha, "ecommerce: the implicit fold-ins", trained=True)
        stats["foldin_dense_rel_err"] = dense_distance(
            foldin, items_t.cpu().numpy(), rows, got, p.lambda_, True,
            p.alpha)
        fold_dispatches = foldin_dispatches(foldin, rows)

        def expect(vec, seen=(), unavailable=(), num=5):
            mask = torch.ones(len(model.item_bimap), dtype=torch.bool)
            for idx in list(seen) + list(unavailable):
                mask[int(idx)] = False
            scores = (torch.as_tensor(model.item_popularity,
                                      device=items_t.device)
                      if vec is None else items_t @ vec)
            s_, i_ = top_k_with_exclusions(scores, num, allowed_mask=mask)
            inv = model.item_bimap.inverse
            return [(inv[int(i)], float(v)) for v, i in
                    zip(s_.cpu(), i_.cpu()) if v > -1e37]

        def check(doc, want, what):
            status, body = http_json("POST", f"{base}/queries.json", doc)
            got_ = [(x["item"], x["score"]) for x in body["itemScores"]]
            if status != 200 or len(got_) != len(want):
                raise AssertionError(f"ecommerce {what}: {status} {body}")
            np.testing.assert_allclose([g[1] for g in got_],
                                       [w[1] for w in want], rtol=1e-5,
                                       atol=1e-6, err_msg=what)
            ws = {w[0]: w[1] for w in want}
            for (gi, gs), (wi, wv) in zip(got_, want):
                if gi != wi and abs(ws.get(gi, np.inf) - wv) > 1e-5 * abs(
                        wv) + 1e-6:
                    raise AssertionError(f"ecommerce {what}: {got_} against "
                                         f"{want}")
            return body

        def seen_of(u):
            return {model.item_bimap[e.target_entity_id]
                    for e in EventStore.find_by_entity(
                        app_name=name, entity_type="user", entity_id=u,
                        event_names=list(p.seen_events))
                    if e.target_entity_id in model.item_bimap}

        walls = []
        for u in list(cold)[:8]:
            vec = torch.from_numpy(ov._vectors[u][0]).to(items_t.device)
            t1 = time.perf_counter()
            check({"user": u, "num": 5}, expect(vec, seen_of(u)),
                  f"cold {u}")
            walls.append(time.perf_counter() - t1)
        stats["http_overlay_p50_ms"] = 1e3 * statistics.median(walls)
        known = model.user_bimap.inverse[int(rng.integers(nu))]
        row = model.user_bimap[known]
        want = expect(model.user_factors[row], model.user_seen.get(row, ()))
        check({"user": known, "num": 5}, want, f"known {known}")
        post(key, [{"event": "view", "entityType": "user",
                    "entityId": "recent0", "targetEntityType": "item",
                    "targetEntityId": f"i{int(i)}"}
                   for i in rng.choice(n_items, 3, replace=False)])
        recent = [model.item_bimap[e.target_entity_id] for e in
                  EventStore.find_by_entity(
                      app_name=name, entity_type="user",
                      entity_id="recent0", event_names=["view"],
                      limit=p.num_recent_events, latest=True)]
        check({"user": "recent0", "num": 5},
              expect(items_t[torch.as_tensor(recent, device=items_t.device)]
                     .mean(0)), "recent views (not folded)")
        check({"user": "nobody-ecom", "num": 5}, expect(None),
              "popularity")
        first = want[0][0]
        post(key, [{"event": "$set", "entityType": "constraint",
                    "entityId": "unavailableItems",
                    "properties": {"items": [first]}}])
        body = check({"user": known, "num": 5}, expect(
            model.user_factors[row], model.user_seen.get(row, ()),
            [model.item_bimap[first]]), "known, unavailable")
        if first in {x["item"] for x in body["itemScores"]}:
            raise AssertionError("ecommerce: an unavailable item served")
        counts = runtime.launch_counts()
        launches = {"als_fused_solve_cg": counts["als_fused_solve_cg"],
                    "expected_fused": fold_dispatches,
                    "train": train_launches}
        if dev.type == "cuda" and (counts["als_fused_solve_cg"]
                                   != fold_dispatches
                                   or counts["als_solve_cg"]
                                   or counts["als_solve_cg_rows8"]):
            raise AssertionError(f"ecommerce: serving launched {counts}")
    finally:
        server.stop()
    stats["launches"] = launches
    return launches, 0.0, stats


def retrain_loop_leg(dev, runtime, als, planted, pd, trained, small=False,
                     rank: int = ML20M["rank"], seed: int = 3):
    """Retrain leg (b), in process at ML-20M width on the train phase's
    planted ratings (``pd``, the trained state ``trained``; rank 128, 4
    sweeps, 2 bf16, λ 0.03, buckets up to ``RT_MAX_WIDTH``): ``als_retrain``
    from the trained state (prep ``"miss"``), then again after a 1% tail
    of new pairs (prep ``"reused"``, ``prep_delta_rows`` 200,000). Then,
    outside the counted run: the reused trees against a fresh build of the
    same COO, row for row and bit for bit (:func:`same_rows`: the layout
    differs, cleared slots and appended buckets); the same sweeps from the same state on both,
    within ``als_tolerance``; a tail that re-rates pairs, through the
    preparator's latest-wins dedup, must invalidate the plan. Returns
    (launches by kernel, stats)."""
    from incubator_predictionio_tpu_torch.ops import retrain, sparse

    n_users, n_items = len(pd.user_bimap), len(pd.item_bimap)
    if small:
        rank = trained.user_factors.shape[1]
    n_tail = max(len(pd.ratings) // 100, 1) if small else RT_LOOP_TAIL
    rng = np.random.default_rng(31)
    t0 = time.perf_counter()
    tu, ti = distinct_new_pairs(
        rng, pd.users, pd.items, n_users, n_items, n_tail,
        draw=lambda m: planted._sample_pairs(rng, m, n_users, n_items))
    pred = (trained.user_factors[torch.from_numpy(tu).to(dev)]
            * trained.item_factors[torch.from_numpy(ti).to(dev)]).sum(-1)
    tr = (pred.cpu().numpy() + rng.normal(0, 0.35, len(tu))).astype(
        np.float32)
    u2 = np.concatenate([pd.users, tu.astype(pd.users.dtype)])
    i2 = np.concatenate([pd.items, ti.astype(pd.items.dtype)])
    r2 = np.concatenate([pd.ratings, tr])
    tail_gen_s = time.perf_counter() - t0
    kw = dict(rank=rank, iterations=4, l2=0.03, seed=seed, bf16_sweeps=2,
              max_width=RT_MAX_WIDTH, plan_key="ml20m", device=dev)
    retrain.drop_plans()
    runtime.reset_launch_counts()
    first, second = {}, {}
    sync(dev)
    t0 = time.perf_counter()
    st1 = retrain.als_retrain(pd.users, pd.items, pd.ratings, n_users,
                              n_items, prev_state=trained, stats=first, **kw)
    sync(dev)
    first["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st2 = retrain.als_retrain(u2, i2, r2, n_users, n_items, prev_state=st1,
                              stats=second, **kw)
    sync(dev)
    second["wall_s"] = time.perf_counter() - t0
    counts = runtime.launch_counts()
    for what, st in (("first", first), ("second", second)):
        st.pop("touched_item_rows", None)
        st["sweeps_wall_s"] = st["wall_s"] - st["prep_wall_s"]
    if first["prep_plan"] != "miss" or first["mode"] != "continue" \
            or second["prep_plan"] != "reused" or second["mode"] != \
            "continue" or second["prep_delta_rows"] != len(tr):
        raise AssertionError(f"retrain loop: {first} then {second}")
    if not all(bool(torch.isfinite(f).all())
               for f in (st2.user_factors, st2.item_factors)):
        raise AssertionError("retrain loop: non-finite factors")

    reused = retrain._PLAN_CACHE["ml20m"].trees() + (None, None)
    sync(dev)
    t0 = time.perf_counter()
    fresh = retrain.prepare_with_reuse(u2, i2, r2, n_users, n_items,
                                       max_width=RT_MAX_WIDTH, device=dev)
    sync(dev)
    fresh_prep_s = time.perf_counter() - t0
    if fresh[2] is not None or fresh[3] is not None:
        raise AssertionError("retrain loop: split rows at RT_MAX_WIDTH")
    n_rows = sum(same_rows(x, y, f"reused against fresh {side} trees")
                 for x, y, side in ((reused[0], fresh[0], "user"),
                                    (reused[1], fresh[1], "item")))
    outs = [als._mixed_run(st1, t[0], t[1], 0.03, 4, 2, True, torch.float32,
                           t[2], t[3]) for t in (reused, fresh)]
    factor_rel = {}
    for f in ("user_factors", "item_factors"):
        rel = _rel_err(getattr(outs[0], f), getattr(outs[1], f))[1]
        tol = als_tolerance(torch.bfloat16, 0, rank, trained=True)
        if not rel <= tol:
            raise AssertionError(f"retrain loop: {f} from the reused trees "
                                 f"{rel:.3e} from the fresh build's")
        factor_rel[f] = rel
    del outs, fresh

    # re-rated pairs: latest wins moves each to the tail, the prefix breaks
    pick = rng.choice(len(pd.ratings), RT_RERATE if not small else 10,
                      replace=False)
    u3 = np.concatenate([u2, pd.users[pick]])
    i3 = np.concatenate([i2, pd.items[pick]])
    r3 = np.concatenate([r2, np.full(len(pick), 5.0, np.float32)])
    keep = sparse.latest_wins(u3, i3, n_items, dev)
    third = {}
    retrain.prepare_with_reuse(u3[keep], i3[keep], r3[keep], n_users,
                               n_items, max_width=RT_MAX_WIDTH,
                               plan_key="ml20m", stats=third, device=dev)
    if third["prep_plan"] != "invalidated":
        raise AssertionError(f"retrain loop: a re-rate tail gave {third}")
    retrain.drop_plans()
    launches = {e: counts[e] for e in ROUTE_ENTRY.values()}
    if dev.type == "cuda" and launches["als_fused_solve_cg"] <= 0:
        raise AssertionError(f"retrain loop: launches {launches}")
    return launches, {
        "ratings": len(pd.ratings), "tail": len(tr),
        "tail_generate_s": tail_gen_s, "first": first, "second": second,
        "fresh_prep_s": fresh_prep_s, "same_rows": n_rows,
        "factor_rel_err": factor_rel, "rerate": int(len(pick)),
        "rerate_plan": third["prep_plan"], "launches": launches}


#: the implicit loss of the kernel route against the plain route's, from
#: one initial state, relative: the two routes do the same arithmetic in
#: another order, and at ML-20M width (2 sweeps, rank 128) they read 1.4e-9
#: apart (PERF.md §6), so a fault in a share of the rows shows above this
IMPLICIT_LOSS_TOL = 1e-6


def implicit_routes(dev, runtime, als, users, items, w, n_users: int,
                    n_items: int, rank: int, seed: int, alpha: float,
                    l2: float, what: str):
    """``als_train_implicit`` (2 sweeps) on the kernel route and on the
    plain route from the same initial state → (kernel state, plain state,
    stats). Fails unless the implicit loss agrees within
    ``IMPLICIT_LOSS_TOL`` relative and, on the card, the kernel route
    launched the fused entry and no two-stage form (which has no YᵀY
    term)."""
    runtime.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    st = als.als_train_implicit(users, items, w, n_users, n_items,
                                rank=rank, iterations=2, l2=l2, alpha=alpha,
                                seed=seed, device=dev)
    sync(dev)
    kernel_s = time.perf_counter() - t0
    counts = runtime.launch_counts()
    t0 = time.perf_counter()
    plain = als.als_train_implicit(users, items, w, n_users, n_items,
                                   rank=rank, iterations=2, l2=l2,
                                   alpha=alpha, seed=seed, device=dev,
                                   use_kernel=False)
    sync(dev)
    plain_s = time.perf_counter() - t0
    loss = als.implicit_loss(st, users, items, w, alpha, l2)
    loss_plain = als.implicit_loss(plain, users, items, w, alpha, l2)
    rel = abs(loss - loss_plain) / abs(loss_plain)
    if not (np.isfinite(loss) and rel <= IMPLICIT_LOSS_TOL):
        raise AssertionError(f"implicit ({what}): loss {loss!r} against the "
                             f"plain route's {loss_plain!r}")
    launches = {e: counts[e] for e in ROUTE_ENTRY.values()}
    if dev.type == "cuda" and (launches["als_fused_solve_cg"] <= 0
                               or launches["als_solve_cg_rows8"]
                               or launches["als_solve_cg"]):
        raise AssertionError(f"implicit ({what}): launches {launches}")
    factor_rel = max(
        _rel_err(st.user_factors, plain.user_factors)[1],
        _rel_err(st.item_factors, plain.item_factors)[1])
    return st, plain, {
        "nnz": int(len(w)), "kernel_s": kernel_s, "plain_s": plain_s,
        "loss": loss, "loss_plain": loss_plain, "loss_rel_err": rel,
        "factor_rel_err": factor_rel, "launches": launches}


def implicit_leg(dev, runtime, ak, als, pd, small: bool = False,
                 rank: int = ML20M["rank"], seed: int = 3,
                 alpha: float = 1.0, l2: float = 0.03, narrow_coo=None):
    """Retrain leg (c): :func:`implicit_routes` on the train phase's COO
    (weights |r|, α 1.0, rank 128, 2 sweeps). The ML-20M ratings have no
    bucket narrower than 128, so the same runs again on ``narrow_coo``
    ((users, items, ratings, n_users, n_items): store-als's 1M ratings,
    every width from 8, those of 8–32 the explicit path's R-row form),
    where no R-row launch shows that ``_route(implicit=True)`` keeps the
    narrow buckets on the fused entry. Then, on the card, the fused entry
    against its plain version (:func:`check_als_chunk`) on the heaviest
    chunk of every bucket width of both sides of each, the kernel route's
    factors as the table and the plain route's as the warm start
    (``width_checks``). Returns (fused launches of the ML-20M run, stats,
    the heaviest implicit fused chunk's timing row)."""
    if small:
        rank = 16
    runs = [("ml20m", pd.users, pd.items, pd.ratings, len(pd.user_bimap),
             len(pd.item_bimap))]
    if narrow_coo is not None:
        runs.append(("store-als", *narrow_coo))
    out, row, checks = {}, None, []
    for what, users, items, ratings, n_users, n_items in runs:
        w = np.abs(ratings).astype(np.float32)
        st, plain, out[what] = implicit_routes(
            dev, runtime, als, users, items, w, n_users, n_items, rank, seed,
            alpha, l2, what)
        if dev.type != "cuda":
            continue
        u_tree, i_tree = als.prepare_trees(users, items, w, n_users,
                                           n_items, device=dev)[:2]
        for side, tree, table, prev in (
                ("user", u_tree, st.item_factors, plain.user_factors),
                ("item", i_tree, st.user_factors, plain.item_factors)):
            for d, chunk in sorted(heaviest_chunks_by_width(
                    tree, rank, als.CHUNK_ELEMS).items()):
                errs = check_als_chunk(ak, als, "als_fused_solve_cg", table,
                                       chunk, prev, implicit=True,
                                       alpha=alpha)
                checks.append({"run": what, "side": side, "D": d,
                               "B": int(chunk[0].shape[0]),
                               "nnz": int(chunk[2].sum()), **errs})
        if what == "ml20m":
            chunk = heaviest_chunk(u_tree, rank, als.CHUNK_ELEMS, fused=True)
            row = dict(shape="implicit_path", **time_als(
                ak, als, "als_fused_solve_cg", st.item_factors, chunk,
                plain.user_factors, implicit=True, alpha=alpha))
        del u_tree, i_tree
    return out["ml20m"]["launches"]["als_fused_solve_cg"], {
        "rank": rank, "sweeps": 2, "alpha": alpha, "l2": l2, **out,
        "width_checks": checks}, row


def f64_solve(ak, table, cols, vals, mask, l2, reg_nnz, iters, x0,
              fused: bool, implicit: bool = False, alpha: float = 1.0,
              yty=None):
    """The bucket solve of an f32 table in f64 arithmetic: the same CG,
    with order-of-sums differences pushed below f32 rounding. Weights as
    the kernels take them: explicit, Gram weight the mask and rhs weight
    vals·mask; implicit, (α·vals, 1 + α·vals) on the mask, the shared YᵀY
    in the matvec and a plain λ."""
    maskd = mask.double()
    gw = alpha * vals.double() * maskd if implicit else maskd
    rw = maskd + gw if implicit else vals.double() * maskd
    t = table.double()[cols]
    gram = torch.einsum("bdk,bdl->bkl", t * gw[..., None], t)
    rhs = torch.einsum("bd,bdk->bk", rw, t)
    nnz = maskd.sum(-1)
    lam = l2 * (nnz.clamp(min=1.0) if reg_nnz and not implicit
                else torch.ones_like(nnz))
    x = ak.cg_plain(gram, rhs, lam, iters,
                    None if x0 is None else x0.double(),
                    yty.double() if implicit else None)
    return torch.where(nnz[:, None] > 0, x, torch.zeros_like(x)) if fused \
        else x


def als_calls(ak, als, entry, table, chunk, prev, implicit: bool = False,
              alpha: float = 1.0):
    """(kernel call, plain call, CG steps, YᵀY) of one ALS entry on a chunk,
    warm-started from ``prev``. ``implicit`` (the fused entry): the
    confidences α·vals, the table's YᵀY and twice the CG steps."""
    cols, vals, mask, row_ids = chunk
    x0 = als._gather_x0(prev, row_ids)
    iters = als.CG_ITERS if table.dtype == torch.float32 \
        else als.CG_ITERS_BF16
    yty = als._gram_all(table) if implicit else None
    if implicit:
        iters *= 2
    if entry == "als_fused_solve_cg":
        def fn():
            return ak.als_fused_solve_cg(table, cols, vals, mask, 0.03,
                                         iters=iters, implicit=implicit,
                                         alpha=alpha, yty=yty, x0=x0)

        def plain():
            return ak.als_fused_solve_cg_plain(table, cols, vals, mask,
                                               0.03, iters=iters,
                                               implicit=implicit,
                                               alpha=alpha, yty=yty, x0=x0)
    else:
        rows = 8 if entry == "als_solve_cg_rows8" else 1

        def fn():
            return ak.als_solve_cg(table, cols, vals, mask, 0.03,
                                   iters=iters, rows_per_program=rows,
                                   x0=x0)

        def plain():
            return ak.als_solve_cg_plain(table, cols, vals, mask, 0.03,
                                         iters=iters, x0=x0)
    return fn, plain, iters, yty


def check_als_chunk(ak, als, entry, table, chunk, prev, exact=True,
                    implicit: bool = False, alpha: float = 1.0) -> dict:
    """The kernel against its plain version on a chunk (warm start from
    ``prev``), within :func:`als_tolerance`; on a D < K chunk the rows
    beyond it may instead be no more than 3x as far from their f64 solve
    as the plain version (``rows_beyond``, ``beyond_f64_rel_err``,
    ``beyond_plain_f64_rel_err``). With an f32 table and ``exact``, also
    each one's distance from the f64 solve on the chunk's first 1,024 rows
    (``f64_rel_err``, ``plain_f64_rel_err``), held to the same 3x. Raises
    on a disagreement; returns the errors (``max_abs_err``,
    ``max_rel_err``, and those above)."""
    cols, vals, mask, row_ids = chunk
    fn, plain, iters, yty = als_calls(ak, als, entry, table, chunk, prev,
                                      implicit, alpha)
    x0 = als._gather_x0(prev, row_ids)
    got, ref = fn(), plain()
    err, rel = _rel_err(got, ref)
    f64 = {}
    tol = als_tolerance(table.dtype, cols.shape[1], table.shape[1],
                        trained=True)
    if rel > tol:
        # a D < K chunk beyond the tolerance: every row beyond it is held
        # to the f64 solve of the system it solves (the rule of
        # als_tolerance), those rows together against the plain version's
        beyond = torch.nonzero((got - ref).abs().amax(-1)
                               > tol * ref.abs().max())[:, 0]
        k64 = p64 = None
        if cols.shape[1] < table.shape[1]:
            ref64 = torch.cat([
                f64_solve(ak, table.float(), cols[r], vals[r].to(
                    table.dtype).float(), mask[r], 0.03, True, iters, x0[r],
                    entry == "als_fused_solve_cg", implicit, alpha, yty)
                for r in beyond.split(2048)])
            k64 = _rel_err(got[beyond].double(), ref64)[1]
            p64 = _rel_err(ref[beyond].double(), ref64)[1]
        if k64 is None or k64 > 3 * p64 + 1e-6:
            raise AssertionError(f"{entry} {table.dtype} on the chunk (B "
                                 f"{cols.shape[0]}, D {cols.shape[1]}"
                                 f"{', implicit' if implicit else ''}): max "
                                 f"error {err:.3e} is {rel:.3e} of "
                                 f"max|x_plain|; on its {len(beyond)} rows "
                                 f"beyond {tol}, {k64} from the f64 solve, "
                                 f"the plain version {p64}")
        f64 = {"rows_beyond": len(beyond), "beyond_f64_rel_err": k64,
               "beyond_plain_f64_rel_err": p64}
    if exact and table.dtype == torch.float32:
        n = 1024
        exact = f64_solve(ak, table, cols[:n], vals[:n], mask[:n], 0.03,
                          True, iters, x0[:n], entry == "als_fused_solve_cg",
                          implicit, alpha, yty)
        f64.update(f64_rel_err=_rel_err(got[:n].double(), exact)[1],
                   plain_f64_rel_err=_rel_err(ref[:n].double(), exact)[1])
        if f64["f64_rel_err"] > 3 * f64["plain_f64_rel_err"] + 1e-6:
            raise AssertionError(f"{entry} on the main path's chunk (B "
                                 f"{cols.shape[0]}, D {cols.shape[1]}"
                                 f"{', implicit' if implicit else ''}) is "
                                 f"further from the f64 solve than the "
                                 f"plain version: {f64}")
    return {"max_abs_err": err, "max_rel_err": rel, **f64}


def time_als(ak, als, entry, table, chunk, prev, reps=10, exact=True,
             implicit: bool = False, alpha: float = 1.0):
    """ms of one kernel call (and its device time, ``graph_ms``), of its
    plain version and of the Gram alone as one ``torch.bmm(g.mT, g)`` on
    the same gathered block (``library_ms``, TF32 off), on a chunk (warm
    start from ``prev``), with its bound (and, with an f32 table, the bound
    on the FMA units beside it), after :func:`check_als_chunk`.
    ``implicit`` (the fused entry): the confidences α·vals, the table's
    YᵀY and twice the CG steps, and the library call the weighted Gram
    plus YᵀY, one ``torch.baddbmm``."""
    from incubator_predictionio_tpu_torch import runtime

    cols, vals, mask, _ = chunk
    errs = check_als_chunk(ak, als, entry, table, chunk, prev, exact,
                           implicit, alpha)
    fn, plain, iters, yty = als_calls(ak, als, entry, table, chunk, prev,
                                      implicit, alpha)
    b, d = cols.shape
    k = table.shape[1]
    bound_ms, bound_by = ak.bucket_bound(cols, mask, k, iters, True,
                                         table.dtype, implicit=implicit)
    fma = {}
    if table.dtype == torch.float32:
        fma_ms, fma_by = ak.bucket_bound(cols, mask, k, iters, True,
                                         table.dtype,
                                         f32_flops=runtime.F32_FLOPS,
                                         implicit=implicit)
        fma = {"bound_fma_ms": fma_ms, "bound_fma_by": fma_by}
    # the library yardstick: the Gram alone, one bmm on the gathered block
    # (implicit: the confidence-weighted Gram plus YᵀY, one baddbmm)
    g = table[cols] * mask[..., None].to(table.dtype)
    if implicit:
        wg = g * (alpha * vals)[..., None]

        def gram():
            return torch.baddbmm(yty, wg.mT, g)
    else:
        def gram():
            return torch.bmm(g.mT, g)

    calls = max(1, min(10, int(2e8 // max(g.numel(), 1))))
    device_ms = graph_ms(fn, calls=calls, reps=reps)
    return {"dtype": str(table.dtype).replace("torch.", ""), "B": b, "D": d,
            "K": k, "nnz": int(mask.sum()), "iters": iters,
            **({"implicit": True, "alpha": alpha} if implicit else {}),
            "ms": median_ms(fn, reps=reps, warm=2),
            "graph_ms": device_ms, "us_per_row": 1e3 * device_ms / b,
            "plain_ms": median_ms(plain, reps=reps, warm=2),
            "library_ms": median_ms(gram, reps=reps, warm=2),
            "library_graph_ms": graph_ms(gram, calls=calls, reps=reps),
            "bound_ms": bound_ms, "bound_by": bound_by, **fma, **errs}


def als_timings(ak, als, paths, chunk_elems):
    """Each ALS entry timed, in f32 and bf16, first at the heaviest chunk
    the training paths route to it (``paths``: (u_tree, i_tree, trained
    factors, plain-route factors) of the train phase, then of store-als;
    ``route_chunk`` on each half-sweep: the fused entry's, R = 8's at the
    narrow buckets of the store-als path), then R = 1 and R = 8 at the
    train phase's heaviest item chunk of the two-stage sizing (the user
    table; D 32,768, where R = 8 takes the one-row plan)."""
    u_tree, i_tree, model, plain = paths[0]
    rank = model.item_factors.shape[1]
    sides = [side for u, i, m, p in paths
             for side in ((u, m.item_factors, p.user_factors),
                          (i, m.user_factors, p.item_factors))]
    item_chunk = heaviest_chunk(i_tree, rank, chunk_elems, fused=False)
    out = {"als_fused_solve_cg": [], "als_solve_cg": [],
           "als_solve_cg_rows8": []}
    for route, entry in ROUTE_ENTRY.items():
        best = None
        for tree, table, prev in sides:
            chunk = route_chunk(als, tree, route, chunk_elems)
            if chunk is not None and (best is None or float(chunk[2].sum())
                                      > float(best[1][2].sum())):
                best = (table, chunk, prev)
        if best is not None:
            out[entry] += [dict(shape="path", **time_als(
                ak, als, entry, best[0].to(dt), best[1], best[2]))
                for dt in (torch.float32, torch.bfloat16)]
    for entry in ("als_solve_cg", "als_solve_cg_rows8"):
        out[entry] += [dict(shape="item_chunk", **time_als(
            ak, als, entry, model.user_factors.to(dt), item_chunk,
            plain.item_factors)) for dt in (torch.float32, torch.bfloat16)]
    if not out["als_fused_solve_cg"]:
        raise AssertionError("no bucket routed to the fused entry")
    return out


def als_shape_timings(ak, als, dev, chunk_elems, ds=(64, 128, 1024, 8192),
                      dtypes=(torch.float32,)):
    """Each ALS entry timed at the ML-20M bucket shapes of the als-kernel
    phase (D = 64, 128, 1,024 and 8,192, rank 128, one chunk of rows,
    tables of ML-20M height), warm, in each of ``dtypes``: the fused entry
    on the user side (gathering the item table, 13.7 MB in f32) and on the
    item side (the user table, 70.9 MB), beside the two-stage entry on the
    item side (R = 1 and 8, its gather included); ``us_per_row`` compares
    entries whose chunks differ in rows."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rng = np.random.default_rng(8)
    out = {"als_fused_solve_cg": [], "als_solve_cg": [],
           "als_solve_cg_rows8": []}
    k = ML20M["rank"]
    for d in ds:
        for entry, side, m, b in (
                ("als_fused_solve_cg", "user", ML20M["items"],
                 fused_rows(d, k, chunk_elems)),
                ("als_fused_solve_cg", "item", ML20M["users"],
                 fused_rows(d, k, chunk_elems)),
                ("als_solve_cg", "item", ML20M["users"],
                 two_stage_rows(d, k, chunk_elems)),
                ("als_solve_cg_rows8", "item", ML20M["users"],
                 two_stage_rows(d, k, chunk_elems))):
            table, cols, vals, mask, prev = als_problem(rng, m, k, b, d)
            chunk = (t(cols), t(vals), t(mask),
                     torch.arange(b, device=dev))
            for dt in dtypes:
                row = time_als(ak, als, entry, t(table).to(dt), chunk,
                               t(prev), exact=False)
                out[entry].append(dict(shape=f"ml20m_d{d}", side=side, **row))
            del table, cols, vals, mask, prev, chunk
    return out


def heaviest_rows(mask, n: int) -> slice:
    """The ``n`` consecutive rows of a bucket with the most observations."""
    if mask.shape[0] <= n:
        return slice(0, mask.shape[0])
    sums = torch.cumsum(torch.nn.functional.pad(mask.sum(-1), (1, 0)), 0)
    start = int(torch.argmax(sums[n:] - sums[:-n]))
    return slice(start, start + n)


def narrow_timings(ak, als, cells, chunk_elems,
                   widths=(8, 16, 32, 64)) -> list:
    """The cell that decided ``als.KERNEL_ROWS``, ``ROWS_MAX_D`` and that
    every bucket goes to a kernel: on
    each half-sweep of each cell (``{name: (u_tree, i_tree, user table,
    item table)}``), the heaviest chunk of every bucket width in
    ``widths`` (the plain route's chunk, ``two_stage_rows`` rows, the same
    rows for every route) solved warm by each route of
    ``als._bucket_solver`` (R = 8, R = 1, fused, plain), in f32 (16 CG
    steps) and bf16 (3): ms of one call (CUDA events), and each kernel
    route's distance from the plain route's answer; then the whole bucket
    on each route as a sweep chunks it (``bucket_ms``)."""
    out = []
    routes = ("rows8", "rows1", "fused", "plain")
    for cell, (u_tree, i_tree, uf, vf) in cells.items():
        rank = uf.shape[1]
        for side, tree, table, prev in (("user", u_tree, vf, uf),
                                        ("item", i_tree, uf, vf)):
            for row_ids, cols, vals, mask in tree:
                d = cols.shape[1]
                if d not in widths:
                    continue
                sl = heaviest_rows(mask, two_stage_rows(d, rank,
                                                        chunk_elems))
                chunk = (cols[sl], vals[sl], mask[sl],
                         als._gather_x0(prev, row_ids[sl]))
                x0 = als._gather_x0(prev, row_ids)
                for dt in (torch.float32, torch.bfloat16):
                    gsrc = table.to(dt)
                    iters = als.CG_ITERS if dt == torch.float32 \
                        else als.CG_ITERS_BF16
                    row = {"cell": cell, "side": side, "D": d,
                           "B": chunk[0].shape[0],
                           "bucket_rows": int(cols.shape[0]),
                           "nnz": int(chunk[2].sum()),
                           "dtype": str(dt).replace("torch.", ""),
                           "iters": iters}
                    got = {}
                    for r in routes:
                        solver, row_elems = als._bucket_solver(
                            r, gsrc, 0.03, True, dt, iters, d)
                        got[r] = solver(chunk)
                        row[f"{r}_ms"] = median_ms(lambda: solver(chunk),
                                                   reps=10, warm=2)
                        row[f"{r}_bucket_ms"] = median_ms(
                            lambda: als._solve_bucket_chunked(
                                solver, cols, vals, mask, rank,
                                row_elems=row_elems, x0=x0), reps=3, warm=1)
                    for r in routes[:3]:
                        row[f"{r}_rel_err"] = _rel_err(got[r],
                                                       got["plain"])[1]
                    out.append(row)
    return out


def narrow_cells(als, planted, dev) -> dict:
    """The two cells of :func:`narrow_timings`, tables of ML-20M height
    from ``als_init`` (seed 3): ML-20M width (20,000,000 planted ratings,
    the train phase's) and the store-als phase's 1,000,000 over every
    user and item (~7 a user: most user buckets narrow)."""
    cells = {}
    for name, kw in (("ml20m", {}),
                     ("store_als_1m", dict(nnz=1_000_000, n_holdout=1000,
                                           cover=True))):
        users, items, ratings, _ = planted.planted_ratings(**kw)
        u_tree, i_tree, _uh, _ih = als.prepare_trees(
            users, items, ratings, ML20M["users"], ML20M["items"],
            device=dev)
        st = als.als_init(torch.Generator().manual_seed(3), ML20M["users"],
                          ML20M["items"], ML20M["rank"], device=dev)
        cells[name] = (u_tree, i_tree, st.user_factors, st.item_factors)
        del users, items, ratings
    return cells


def cg_share(ak, als, chunk, table, prev) -> list:
    """The CG's share of a fused chunk (f32, warm): device ms
    (``graph_ms``) at 0 and ``CG_ITERS`` CG steps."""
    cols, vals, mask, row_ids = chunk
    x0 = als._gather_x0(prev, row_ids)
    out = []
    for iters in (0, als.CG_ITERS):
        def fn(iters=iters):
            return ak.als_fused_solve_cg(table, cols, vals, mask, 0.03,
                                         iters=iters, x0=x0)
        out.append({"iters": iters, "graph_ms": graph_ms(fn, calls=5)})
    return out


def als_rank_timings(ak, als, dev, chunk_elems) -> dict:
    """Both ALS entries above rank 128 (K 256: three 128 x 128 Gram tiles)
    at an ML-20M user-bucket shape (fused, D 256, the chunk's rows capped
    at 2,048) and an item-bucket one (two-stage, D 8,192, one chunk), f32
    and bf16, warm: the times of the repaired fault."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rng = np.random.default_rng(15)
    k = 256
    out = {"als_fused_solve_cg": [], "als_solve_cg": []}
    for entry, m, b, d in (
            ("als_fused_solve_cg", ML20M["items"],
             min(2048, fused_rows(256, k, chunk_elems)), 256),
            ("als_solve_cg", ML20M["users"],
             two_stage_rows(8192, k, chunk_elems), 8192)):
        table, cols, vals, mask, prev = als_problem(rng, m, k, b, d)
        chunk = (t(cols), t(vals), t(mask), torch.arange(b, device=dev))
        for dt in (torch.float32, torch.bfloat16):
            row = time_als(ak, als, entry, t(table).to(dt), chunk, t(prev),
                           reps=5, exact=False)
            out[entry].append(dict(shape=f"rank{k}_d{d}", **row))
    return out


# -- flash attention against its plain version ----------------------------------

#: the sequence engine's attention at the slice's width (d_model 64, 2 heads,
#: window 8192: SeqRecAlgorithmParams defaults, max_len 8193) and the JAX
#: bench's attention shapes (bench.py:4502-4530)
SEQ = dict(n_items=26_744, d_model=64, n_heads=2, n_layers=2, max_len=8193)
#: a width the JAX engine accepts whose heads take the flash kernel's wide
#: form: SeqRecAlgorithmParams(d_model=512, n_heads=2), heads of 256
SEQ_WIDE = dict(d_model=512, n_heads=2, n_layers=2)
FLASH_BENCH = dict(b=1, h=8, d=64, seqs=(4096, 8192, 32768))


def left_padded(b: int, s: int, lengths) -> np.ndarray:
    """[b, s] bool: row r's last ``lengths[r]`` keys valid (a SASRec
    window, PAD on the left)."""
    valid = np.zeros((b, s), bool)
    for r, n in enumerate(lengths):
        if n:
            valid[r, s - n:] = True
    return valid


def holes(b: int, s: int) -> np.ndarray:
    """[b, s] bool with holes: of every three 64-key tiles only the first
    has valid keys (so live tiles are separated by two wholly dead ones),
    and within it every fifth key (from 1 + row) is invalid."""
    key = np.arange(s)[None, :]
    row = np.arange(b)[:, None]
    return ((key // 64) % 3 == 0) & ((key - 1 - row) % 5 != 0)


def one_key(b: int, s: int, keys) -> np.ndarray:
    """[b, s] bool: row r has the single valid key ``keys[r]``."""
    valid = np.zeros((b, s), bool)
    valid[np.arange(b), list(keys)] = True
    return valid


def skip_cases(small: bool = False) -> list:
    """The cases the tile skip and the tensor-core fragments can get wrong,
    in f32 and bf16: holes (live tiles between wholly dead ones), a single
    live key in a tile's first and last column, rows with different left
    padding, dead query tiles before live ones, Sq != Skv with padding,
    and head widths 8, 24, 80 and 128."""
    s = 700 if small else SEQ["max_len"] - 1
    dh = SEQ["d_model"] // SEQ["n_heads"]
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        n = str(dt)[6:]
        cases += [
            (f"holes_{n}", 2, 1024, 1024, 2, 32, dt, True, holes(2, 1024)),
            (f"holes_not_causal_{n}", 1, 640, 640, 2, 64, dt, False,
             holes(1, 640)),
            (f"one_key_{n}", 2, 512, 512, 2, 32, dt, True,
             one_key(2, 512, (192, 255))),
            (f"one_key_not_causal_{n}", 2, 512, 512, 2, 32, dt, False,
             one_key(2, 512, (192, 255))),
            (f"left_pads_{n}", 10, s, s, 2, dh, dt, True,
             left_padded(10, s, [0, 1, 63, 64, 65, s - 65, s - 64, s - 63,
                                 s - 1, s])),
            (f"dead_q_tiles_{n}", 1, 1000, 1000, 2, 32, dt, True,
             left_padded(1, 1000, [360])),
            (f"sq_lt_skv_pad_{n}", 2, 130, 700, 2, 32, dt, True,
             holes(2, 700)),
            (f"sq_gt_skv_pad_{n}", 2, 700, 130, 2, 32, dt, True,
             left_padded(2, 130, [100, 0])),
        ]
        for d in (8, 24, 80, 128):
            cases.append((f"d{d}_holes_{n}", 2, 333, 333, 2, d, dt, True,
                           holes(2, 333)))
    return cases


def flash_cases(small: bool = False) -> list:
    """(name, b, s_q, s_kv, h, d, dtype, causal, valid [b, s_kv] or None)."""
    cases = [
        # tests/test_pallas_kernels.py:79-150
        ("jax_causal", 2, 100, 100, 2, 32, torch.float32, True, None),
        ("jax_not_causal", 2, 100, 100, 2, 32, torch.float32, False, None),
        ("jax_ragged", 2, 40, 40, 2, 16, torch.float32, True,
         np.arange(40)[None, :] < np.array([[17], [33]])),
        ("jax_fully_masked", 1, 8, 8, 1, 16, torch.float32, True,
         np.zeros((1, 8), bool)),
        ("jax_decode", 1, 1, 64, 2, 32, torch.float32, False, None),
        # the decode row under the causal mask, Sq != Skv both ways, ragged
        # tiles, and head widths that pad to each of the kernel's widths
        ("decode_causal", 1, 1, 64, 2, 32, torch.float32, True, None),
        ("sq_lt_skv", 2, 100, 300, 2, 24, torch.float32, True,
         np.arange(300)[None, :] < np.array([[250], [77]])),
        ("sq_gt_skv", 2, 300, 100, 2, 8, torch.float32, True, None),
        ("d128_bf16", 2, 200, 200, 3, 128, torch.bfloat16, True,
         left_padded(2, 200, [150, 0])),
        ("d80_not_causal", 1, 130, 130, 2, 80, torch.float32, False,
         left_padded(1, 130, [65])),
        # heads wider than 128 (the D-tiled kernel: one, two and a partial
        # block of 128 output columns), as the reference takes any D
        ("wide_d160", 2, 500, 500, 2, 160, torch.float32, True,
         left_padded(2, 500, [300, 0])),
        ("wide_d160_bf16", 2, 500, 500, 2, 160, torch.bfloat16, True,
         left_padded(2, 500, [300, 0])),
        ("wide_d256", 1, 700, 700, 2, 256, torch.float32, True,
         holes(1, 700)),
        ("wide_d256_bf16_not_causal", 1, 300, 700, 2, 256, torch.bfloat16,
         False, holes(1, 700)),
        ("wide_d200", 1, 130, 130, 1, 200, torch.float32, True,
         left_padded(1, 130, [1])),
        ("wide_d200_bf16", 2, 130, 130, 1, 200, torch.bfloat16, True,
         left_padded(2, 130, [65, 0])),
        ("wide_d192", 2, 333, 333, 2, 192, torch.float32, False,
         holes(2, 333)),
        ("wide_d192_bf16", 2, 333, 333, 2, 192, torch.bfloat16, True,
         one_key(2, 333, (0, 332))),
        ("wide_d256_bf16_holes", 2, 640, 640, 2, 256, torch.bfloat16, True,
         holes(2, 640)),
        ("wide_d160_sq_lt_skv", 2, 130, 700, 2, 160, torch.float32, True,
         holes(2, 700)),
        ("wide_d256_left_pads", 6, 1024, 1024, 2, 256, torch.float32, True,
         left_padded(6, 1024, [0, 1, 63, 64, 65, 1024])),
        # above 256: the D-tiled kernel
        ("wide_d320", 1, 200, 200, 1, 320, torch.float32, True,
         left_padded(1, 200, [150])),
        # more than 65,535 batch x heads (grid x), at a small S
        ("bh65536_h1", 65_536, 16, 16, 1, 8, torch.float32, True,
         left_padded(65_536, 16, [16, 3] * 32_768)),
        ("bh65536_h256_bf16", 256, 24, 24, 256, 16, torch.bfloat16, True,
         None),
        ("bh65536_d160_bf16", 2 if small else 256, 20, 20, 256, 160,
         torch.bfloat16, True,
         left_padded(2 if small else 256, 20, [20, 3] * (1 if small
                                                          else 128))),
    ]
    s = 700 if small else SEQ["max_len"] - 1
    dh = SEQ["d_model"] // SEQ["n_heads"]
    # the engine's windows: histories of 1 to 8192 items, and a PAD-only row
    cases.append(("engine_b1", 1, s, s, SEQ["n_heads"], dh, torch.float32,
                  True, left_padded(1, s, [s // 3])))
    cases.append(("engine_b8", 8, s, s, SEQ["n_heads"], dh, torch.float32,
                  True, left_padded(8, s, [0, 1, 63, 64, 65, s // 2, s - 1,
                                           s])))
    for n in FLASH_BENCH["seqs"]:
        n = n // 64 if small else n
        for dt in (torch.float32, torch.bfloat16):
            cases.append((f"bench_s{n}_{str(dt)[6:]}", FLASH_BENCH["b"], n, n,
                          FLASH_BENCH["h"], FLASH_BENCH["d"], dt, True, None))
    return cases + skip_cases(small)


def flash_inputs(rng, b, s_q, s_kv, h, d, dtype, dev):
    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev).to(dtype)

    return t((b, s_q, h, d)), t((b, s_kv, h, d)), t((b, s_kv, h, d))


def flash_tolerance(dtype) -> float:
    """Bound on max|out − out_plain| / max|out_plain|. f32: 1e-4, since the
    two sum over up to 32,768 keys in different orders. bf16 inputs and
    output: 8e-3, one bf16 ulp of max|ref|, since both round the same f32
    value to bf16."""
    return 8e-3 if dtype == torch.bfloat16 else 1e-4


def check_flash(got, ref, valid_np, causal, s_q, dtype, what) -> float:
    """The kernel's output against the plain version's; a query with no
    live key must be exactly 0. Returns the largest absolute error."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} against "
                             f"{tuple(ref.shape)} {ref.dtype}")
    g, r = got.float(), ref.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = float((g - r).abs().max()) if g.numel() else 0.0
    top = float(r.abs().max()) if r.numel() else 0.0
    if err > flash_tolerance(dtype) * top:
        raise AssertionError(f"{what}: max error {err:.3e} is {err / top:.3e} "
                             f"of max|ref| {top:.3e}")
    if valid_np is not None:
        b, s_kv = valid_np.shape
        pos = np.arange(s_q)[:, None]
        keys = np.arange(s_kv)[None, :]
        live = valid_np[:, None, :] & ((pos >= keys)[None] if causal
                                       else True)
        dead = torch.from_numpy(~live.any(-1)).to(got.device)  # [b, s_q]
        if bool(dead.any()) and bool((g[dead] != 0).any()):
            raise AssertionError(f"{what}: a query with no live key is not "
                                 "exactly 0")
    return err


def flash_phase(dev, fa, small: bool = False):
    """The flash kernel against its plain version at every case of
    :func:`flash_cases`. Returns (max abs error, {case: relative error})."""
    rng = np.random.default_rng(9)
    err, rel = 0.0, {}
    for name, b, s_q, s_kv, h, d, dt, causal, valid in flash_cases(small):
        q, k, v = flash_inputs(rng, b, s_q, s_kv, h, d, dt, dev)
        kv_valid = None if valid is None else torch.from_numpy(valid).to(dev)
        got = fa.flash_attention(q, k, v, causal=causal, kv_valid=kv_valid)
        ref = fa.flash_attention_plain(q, k, v, causal=causal,
                                       kv_valid=kv_valid)
        sync(dev)
        e = check_flash(got, ref, valid, causal, s_q, dt, name)
        err = max(err, e)
        rel[name] = e / max(float(ref.float().abs().max()), 1e-30)
    return err, rel


# -- the sequence engine: serving and training ---------------------------------

def seq_docs(rng, n_items: int, window: int) -> list:
    """The query bodies of the sequence phases: ``recentItems`` histories
    of 1 to ``window`` items (and one past it, cut to the window), cyclic
    runs as the planted sessions have them and random picks, and one
    history of unknown items only (no device work)."""
    docs = []
    lengths = [1, 2, 7, 63, 64, 65, 500, 1000, 2047, 4096, 6000, 8000,
               window - 1, window, window, window + 100]
    for j, n in enumerate(lengths):
        if j % 2:
            start = int(rng.integers(0, n_items))
            items = (start + np.arange(n)) % n_items
        else:
            items = rng.integers(0, n_items, n)
        docs.append({"user": f"u{j}", "num": (10, 50, 100)[j % 3],
                     "recentItems": [f"i{i}" for i in items]})
    docs[3]["recentItems"] += ["nosuch-item"]
    docs.append({"user": "u-unknown", "num": 10,
                 "recentItems": ["nosuch-1", "nosuch-2"]})
    return docs


def seq_reference(tr, fa, model, doc, window: int):
    """(scores, token ids, whether the query reaches the device) of one
    query: the window scored through ``transformer_apply`` with the plain
    attention, the history and PAD set to -inf, a stable descending sort
    (``lax.top_k``'s ties), the first ``min(num, n_items)`` + 1 kept and
    non-finite or PAD slots dropped."""
    inv = model.item_bimap
    hist = [inv[n] + 1 for n in doc["recentItems"] if n in inv][-window:]
    k = min(doc["num"], len(inv))
    if not hist or k <= 0:
        return np.zeros(0), np.zeros(0, np.int64), False
    dev = model.weights.item_emb.device
    tokens = torch.zeros((1, window), dtype=torch.int32, device=dev)
    tokens[0, window - len(hist):] = torch.tensor(hist, device=dev)
    with torch.no_grad():
        h = tr.transformer_apply(model.weights, tokens, model.n_heads,
                                 attn_fn=fa.flash_attention_plain)
        scores = (h[:, -1] @ model.weights.item_emb.T)[0]
        scores[tokens[0].long()] = float("-inf")
        scores[tr.PAD] = float("-inf")
        top_s, top_i = torch.sort(scores, descending=True, stable=True)
    top_s, top_i = top_s[:k + 1].cpu().numpy(), top_i[:k + 1].cpu().numpy()
    keep = np.isfinite(top_s) & (top_i != tr.PAD)
    return top_s[keep], top_i[keep], True


def check_seq_answer(body, ref_s, ref_i, num, item_bimap, what) -> float:
    """A served answer against :func:`seq_reference` (which holds one slot
    past the cut, to show a near-tie there): ids equal except among
    near-ties, scores to rtol 1e-4 with atol 1e-4 * max|score|."""
    got = body["itemScores"]
    n = min(num, len(ref_s))
    if len(got) != n:
        raise AssertionError(f"{what}: {len(got)} items, expected {n}")
    if not n:
        return 0.0
    got_s = np.array([[x["score"] for x in got]])
    got_i = np.array([[item_bimap[x["item"]] + 1 for x in got]])
    return check_topk(got_s, got_i, ref_s[None, :], ref_i[None, :], n, what,
                      rtol=1e-4)


def serve_seq(dev, runtime, tr, fa, server_mod, eng, ep, model, docs,
              window: int, what: str):
    """``model`` behind ``PredictionServer``: every doc POSTed to
    /queries.json, each answer held to :func:`seq_reference`, and the flash
    launches of the served queries counted: ``n_layers`` per query with
    device work. Returns (launches, max score error, stats)."""
    n_layers = model.weights.wq.shape[0]
    srv = server_mod.PredictionServer(eng, ep, [model], device=dev)
    port = srv.start_background()
    try:
        runtime.reset_launch_counts()
        walls, answers = [], []
        for doc in docs:
            t0 = time.perf_counter()
            answers.append(post(port, doc))
            walls.append(time.perf_counter() - t0)
        launches = runtime.launch_counts()["flash_attention"]
    finally:
        srv.stop()
    served = srv.models[0]
    err, device_queries = 0.0, 0
    for i, (doc, body) in enumerate(zip(docs, answers)):
        ref_s, ref_i, on_device = seq_reference(tr, fa, served, doc, window)
        device_queries += on_device
        err = max(err, check_seq_answer(body, ref_s, ref_i, doc["num"],
                                        served.item_bimap,
                                        f"{what} query {i}"))
    if dev.type == "cuda" and launches != n_layers * device_queries:
        raise AssertionError(
            f"{what}: flash_attention launched {launches} times for "
            f"{device_queries} queries of {n_layers} layers")
    stats = {"queries": len(docs), "device_queries": device_queries,
             "launches": launches, "http_p50_ms": 1e3 * statistics.median(
                 walls), "http_max_ms": 1e3 * max(walls)}
    return launches, err, stats


def seq_params(seq_engine, params_mod, max_len: int, **algo):
    return params_mod.EngineParams(
        preparator_params=("", seq_engine.PreparatorParams(max_len=max_len)),
        algorithm_params_list=[("sasrec", seq_engine.SeqRecAlgorithmParams(
            app_name="chip_smoke", **algo))])


def seq_path_phase(dev, runtime, tr, fa, seq_engine, seq_convert, planted,
                   params_mod, server_mod, small: bool = False):
    """A ``SeqRecModel`` at the slice's width (d_model 64, 2 heads, 2
    layers, window 8,192, 26,744 items) with weights from numpy and a seed,
    served over HTTP."""
    n_items = 500 if small else SEQ["n_items"]
    max_len = 701 if small else SEQ["max_len"]
    fields = planted.random_transformer_fields(
        n_items, max_len, SEQ["d_model"], SEQ["n_layers"], seed=13)
    model = seq_convert.seqrec_model_from_numpy(
        fields, [f"i{i}" for i in range(n_items)], SEQ["n_heads"], max_len,
        device=dev)
    docs = seq_docs(np.random.default_rng(14), n_items, max_len - 1)
    launches, err, stats = serve_seq(
        dev, runtime, tr, fa, server_mod, seq_engine.SequenceEngine().apply(),
        seq_params(seq_engine, params_mod, max_len), model, docs,
        max_len - 1, "seq-path")
    if dev.type == "cuda":
        stats.update(seq_serving_split(tr, seq_engine, model, docs[-3]))
    return launches, err, stats


def seq_wide_phase(dev, runtime, tr, fa, seq_engine, seq_convert, planted,
                   params_mod, server_mod, small: bool = False):
    """A ``SeqRecModel`` at a width the JAX engine accepts whose heads take
    the flash kernel's wide form (``SEQ_WIDE``: d_model 512 in 2 heads of
    256, 2 layers; window 8,192, 26,744 items; weights from numpy and a
    seed), served over HTTP: full-window queries (and one half-window
    one), each answer against the same scoring with the plain attention,
    ``n_layers`` kernel launches per query. No training at this width."""
    n_items = 500 if small else SEQ["n_items"]
    max_len = 701 if small else SEQ["max_len"]
    window = max_len - 1
    fields = planted.random_transformer_fields(
        n_items, max_len, SEQ_WIDE["d_model"], SEQ_WIDE["n_layers"], seed=23)
    model = seq_convert.seqrec_model_from_numpy(
        fields, [f"i{i}" for i in range(n_items)], SEQ_WIDE["n_heads"],
        max_len, device=dev)
    rng = np.random.default_rng(24)
    docs = []
    for j, n in enumerate((window, window + 100, window, window // 2)):
        start = int(rng.integers(0, n_items))
        items = ((start + np.arange(n)) % n_items if j % 2
                 else rng.integers(0, n_items, n))
        docs.append({"user": f"w{j}", "num": (10, 50)[j % 2],
                     "recentItems": [f"i{i}" for i in items]})
    launches, err, stats = serve_seq(
        dev, runtime, tr, fa, server_mod, seq_engine.SequenceEngine().apply(),
        seq_params(seq_engine, params_mod, max_len, d_model=SEQ_WIDE[
            "d_model"], n_heads=SEQ_WIDE["n_heads"], n_layers=SEQ_WIDE[
            "n_layers"]), model, docs, window, "seq-wide")
    stats["head_dim"] = SEQ_WIDE["d_model"] // SEQ_WIDE["n_heads"]
    if dev.type == "cuda":
        stats.update(seq_serving_split(tr, seq_engine, model, docs[0]))
    return launches, err, stats


def seq_serving_split(tr, seq_engine, model, doc) -> dict:
    """Where a full-window query's time goes, past HTTP: the host wall of
    ``SeqRecAlgorithm.predict`` (JSON-free; it ends in a device-to-host
    copy) and the device time of its ``sasrec_topk`` (CUDA events), each
    a median of 10 after warm-up."""
    algo = seq_engine.SeqRecAlgorithm(
        seq_engine.SeqRecAlgorithmParams(app_name="chip_smoke"))
    query = seq_engine.Query(user=doc["user"], num=doc["num"],
                             recent_items=tuple(doc["recentItems"]))
    hist = [model.item_bimap[n] + 1 for n in doc["recentItems"]
            if n in model.item_bimap][-(model.max_len - 1):]
    tokens = torch.zeros((1, model.max_len - 1), dtype=torch.int32,
                         device=model.weights.item_emb.device)
    tokens[0, -len(hist):] = torch.tensor(hist, device=tokens.device)
    walls = []
    for i in range(13):
        t0 = time.perf_counter()
        algo.predict(model, query)
        if i >= 3:
            walls.append(time.perf_counter() - t0)
    return {"history": len(hist),
            "predict_ms": 1e3 * statistics.median(walls),
            "topk_device_ms": median_ms(
                lambda: tr.sasrec_topk(model.weights, tokens, model.n_heads,
                                       k=doc["num"]), reps=10, warm=3)}


def seq_train_phase(dev, runtime, tr, fa, seq_engine, base, params_mod,
                    context, planted, server_mod, small: bool = False,
                    seed: int = 3):
    """Planted sessions (64 of 8,193 items; item i followed by i + 1)
    through ``Engine.train`` → ``SequencePreparator`` →
    ``SeqRecAlgorithm.train`` (batch 8, 1 epoch: 8 steps), then the same
    prepared data from the same initial weights with
    ``attn_fn=flash_attention_plain``. The kernel must launch ``n_layers``
    times a step, each step's loss lie within 1e-3 relative of the plain
    route's and the last below the first; the trained model is then
    served and checked as in the seq-path phase."""
    n_items = 500 if small else SEQ["n_items"]
    max_len = 701 if small else SEQ["max_len"]
    n_sessions, batch = 64, 8
    t0 = time.perf_counter()
    rows = planted.planted_sessions(n_items, n_sessions, max_len, seed=17)
    td = seq_engine.TrainingData(
        sessions=[[f"i{t - 1}" for t in row] for row in rows.tolist()])
    gen_s = time.perf_counter() - t0

    class PlantedSessions(base.DataSource):
        def read_training(self, ctx):
            return td

    from incubator_predictionio_tpu_torch.core.engine import Engine

    eng = Engine(PlantedSessions, seq_engine.SequencePreparator,
                 {"sasrec": seq_engine.SeqRecAlgorithm}, base.FirstServing)
    algo = dict(d_model=SEQ["d_model"], n_heads=SEQ["n_heads"],
                n_layers=SEQ["n_layers"], epochs=1, batch_size=batch,
                seed=seed)
    ep = seq_params(seq_engine, params_mod, max_len, **algo)
    ctx = context.RuntimeContext(device=dev)
    runtime.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    [model] = eng.train(ctx, ep)
    sync(dev)
    train_s = time.perf_counter() - t0
    launches = runtime.launch_counts()["flash_attention"]
    timings = dict(ctx.timings)

    pd = seq_engine.SequencePreparator(
        seq_engine.PreparatorParams(max_len=max_len)).prepare(ctx, td)
    plain_stats: dict = {}
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    _w, _ = tr.sasrec_fit(pd.sequences, n_items=len(pd.item_bimap),
                          epochs=1, batch_size=batch, seed=seed,
                          d_model=SEQ["d_model"], n_heads=SEQ["n_heads"],
                          n_layers=SEQ["n_layers"],
                          attn_fn=fa.flash_attention_plain, device=dev,
                          stats=plain_stats)
    sync(dev)
    plain_s = time.perf_counter() - t0
    if runtime.launch_counts()["flash_attention"]:
        raise AssertionError("the plain route launched the flash kernel")
    # both routes again, warm and in turns, for the time of a step
    fit_s = {}
    for route, fn in (("kernel", None), ("plain", fa.flash_attention_plain),
                      ("plain", fa.flash_attention_plain), ("kernel", None)):
        sync(dev)
        t0 = time.perf_counter()
        tr.sasrec_fit(pd.sequences, n_items=len(pd.item_bimap), epochs=1,
                      batch_size=batch, seed=seed, d_model=SEQ["d_model"],
                      n_heads=SEQ["n_heads"], n_layers=SEQ["n_layers"],
                      attn_fn=fn, device=dev)
        sync(dev)
        fit_s.setdefault(route, []).append(time.perf_counter() - t0)
    got = np.asarray(model.step_losses, np.float64).ravel()
    ref = np.asarray(plain_stats["step_losses"], np.float64).ravel()
    steps = -(-n_sessions // batch)
    if got.shape != (steps,) or not np.isfinite(got).all():
        raise AssertionError(f"seq-train: step losses {got}")
    rel = np.abs(got - ref) / np.abs(ref)
    if (rel > 1e-3).any():
        raise AssertionError(f"seq-train: step losses {got.tolist()} against "
                             f"the plain route's {ref.tolist()}")
    if not got[-1] < got[0]:
        raise AssertionError(f"seq-train: the loss did not fall: {got}")
    if dev.type == "cuda" and launches != SEQ["n_layers"] * steps:
        raise AssertionError(f"seq-train: flash_attention launched {launches} "
                             f"times in {steps} steps of {SEQ['n_layers']} "
                             "layers")
    if len(model.item_bimap) != n_items:
        raise AssertionError(f"seq-train: {len(model.item_bimap)} items in "
                             f"the catalogue, expected {n_items}")
    docs = seq_docs(np.random.default_rng(18), n_items, max_len - 1)
    s_launches, err, serve_stats = serve_seq(
        dev, runtime, tr, fa, server_mod, eng, ep, model, docs, max_len - 1,
        "seq-train serving")
    stats = {"sessions": n_sessions, "length": max_len, "batch": batch,
             "steps": steps, "items": len(model.item_bimap),
             "generate_s": gen_s, "train_s": train_s,
             "engine_timings_s": timings, "plain_fit_s": plain_s,
             "warm_fit_s": fit_s,
             "step_losses": got.tolist(), "plain_step_losses": ref.tolist(),
             "max_step_rel_err": float(rel.max()), "launches": launches,
             "serve": serve_stats}
    return launches + s_launches, err, stats


def sdpa_call(q, k, v, kv_valid):
    """One ``F.scaled_dot_product_attention`` call on the same inputs, for
    its time only (the port never calls it): BHSD copies made outside the
    timed call; causal, and with a [B, 1, S, S] boolean mask where keys are
    invalid (it gives NaN, not 0, on a query with no live key)."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if kv_valid is None or bool(kv_valid.all()):
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
    s_q, s_kv = q.shape[1], k.shape[1]
    causal = torch.ones((s_q, s_kv), dtype=torch.bool,
                        device=q.device).tril()
    mask = (causal[None] & kv_valid.bool()[:, None, :])[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask)


def time_flash(fa, dev, rng, name, b, s, h, d, dtype, valid_np) -> dict:
    """ms of the kernel (one call, and its device time from a CUDA graph:
    :func:`graph_ms`), its plain version and the library call at one
    causal shape, with the bound of this input's live pairs."""
    q, k, v = flash_inputs(rng, b, s, s, h, d, dtype, dev)
    kv_valid = None if valid_np is None else torch.from_numpy(valid_np).to(
        dev)
    reps, warm = (10, 2) if s >= 8192 else (30, 5)
    pairs = fa.live_pairs(s, torch.ones((b, s)) if valid_np is None
                          else torch.from_numpy(valid_np), causal=True)
    bound_ms, bound_by = fa.flash_bound(b, h, s, s, d, dtype, pairs)
    def kernel():
        return fa.flash_attention(q, k, v, kv_valid=kv_valid)

    return {
        "shape": name, "B": b, "S": s, "H": h, "D": d,
        "dtype": str(dtype).replace("torch.", ""), "live_pairs": pairs,
        "ms": median_ms(kernel, reps=reps, warm=warm),
        "graph_ms": graph_ms(kernel, calls=10 if s <= 8192 else 2),
        "plain_ms": median_ms(lambda: fa.flash_attention_plain(
            q, k, v, kv_valid=kv_valid), reps=reps, warm=warm),
        "library_ms": median_ms(sdpa_call(q, k, v, kv_valid), reps=reps,
                                warm=warm),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


#: live keys of the timed left-padded engine windows (B 1, S 8192, f32)
WINDOW_LIVE = (1, 64, 512, 2048, 4096)


def flash_timings(fa, dev) -> list:
    """The kernel at the engine's shapes (first: one served query with a
    full window; the training step's B 8; a half-full window; then windows
    with :data:`WINDOW_LIVE` live keys) and the JAX bench's."""
    rng = np.random.default_rng(10)
    s, h = SEQ["max_len"] - 1, SEQ["n_heads"]
    dh = SEQ["d_model"] // h
    rows = [
        time_flash(fa, dev, rng, "engine_b1", 1, s, h, dh, torch.float32,
                   np.ones((1, s), bool)),
        time_flash(fa, dev, rng, "engine_b8", 8, s, h, dh, torch.float32,
                   np.ones((8, s), bool)),
        time_flash(fa, dev, rng, "engine_b1_half", 1, s, h, dh,
                   torch.float32, left_padded(1, s, [s // 2])),
    ]
    rows += [time_flash(fa, dev, rng, f"engine_b1_live{n}", 1, s, h, dh,
                        torch.float32, left_padded(1, s, [n]))
             for n in WINDOW_LIVE]
    for n in FLASH_BENCH["seqs"]:
        for dt in (torch.float32, torch.bfloat16):
            rows.append(time_flash(fa, dev, rng, f"bench_s{n}", FLASH_BENCH[
                "b"], n, FLASH_BENCH["h"], FLASH_BENCH["d"], dt, None))
    # heads wider than 128 (the D-tiled kernel) at the bench's S 4,096, and
    # 65,536 batch x heads at a short window
    for d in (160, 256):
        for dt in (torch.float32, torch.bfloat16):
            rows.append(time_flash(fa, dev, rng, f"wide_d{d}_s4096", 1, 4096,
                                   FLASH_BENCH["h"], d, dt, None))
    # the seq-wide engine's served window (d_model 512 in 2 heads of 256),
    # and one query of 32,768 keys at that head: whether one block per
    # (query tile, head) fills the card without cutting the key tiles
    rows.append(time_flash(fa, dev, rng, "seq_wide_query", 1, SEQ["max_len"]
                           - 1, SEQ_WIDE["n_heads"], SEQ_WIDE["d_model"]
                           // SEQ_WIDE["n_heads"], torch.float32,
                           np.ones((1, SEQ["max_len"] - 1), bool)))
    rows.append(time_flash(fa, dev, rng, "wide_d256_s32768", 1, 32768, 2,
                           256, torch.bfloat16, None))
    rows.append(time_flash(fa, dev, rng, "bh65536_s64", 65_536, 64, 1, 32,
                           torch.float32, None))
    return rows


def flash_crossover(fa, att, dev) -> list:
    """The kernel, the plain dense product and the plain blockwise scan at
    the engine's head (H 2, D 32, f32, every key valid) for S = 1,024 to
    8,192 at B 1 and 8: where the H100 would put ``FLASH_MIN_SEQ``."""
    rng = np.random.default_rng(11)
    h, dh = SEQ["n_heads"], SEQ["d_model"] // SEQ["n_heads"]
    out = []
    for b in (1, 8):
        for s in (1024, 2048, 4096, 8192):
            q, k, v = flash_inputs(rng, b, s, s, h, dh, torch.float32, dev)
            valid = torch.ones((b, s), dtype=torch.bool, device=dev)
            reps, warm = (10, 2) if s * b >= 8192 * 8 else (30, 5)
            row = {"B": b, "S": s}
            for name, fn in (
                    ("kernel_ms", fa.flash_attention),
                    ("dense_ms", att.dot_product_attention),
                    ("blockwise_ms", att.blockwise_attention)):
                row[name] = median_ms(
                    lambda fn=fn: fn(q, k, v, causal=True, kv_valid=valid),
                    reps=reps, warm=warm)
            out.append(row)
            del q, k, v
    return out


def flash_resources(runtime) -> list:
    """What ``ptxas -v`` reported for each instantiation of the flash
    kernel (registers, spills), with its dynamic shared memory."""
    if not hasattr(runtime, "kernel_resources"):
        return []  # a package from before the report (an A/B copy)
    lib = runtime.build_kernels()
    rows = []
    for r in runtime.kernel_resources("flash_attention"):
        m = re.search(r"flash_(fwd|wide)_kernelI(f|13__nv_bfloat16)Li(\d+)E"
                      r"|flash_dtiled_kernelI(f|13__nv_bfloat16)E",
                      str(r["function"]))
        if not m:
            continue
        bf16 = (m.group(2) or m.group(4)) != "f"
        # the D-tiled kernel takes every head above 256
        dp = int(m.group(3)) if m.group(3) else 257
        rows.append(dict(kernel=f"flash_{m.group(1) or 'dtiled'}_kernel",
                         dtype="bfloat16" if bf16 else "float32",
                         head_pad=dp,
                         dynamic_smem=lib.pio_flash_smem_bytes(dp, int(bf16)),
                         **{k: v for k, v in r.items() if k != "function"}))
    return rows


def kernel_resources(runtime, stem: str) -> list:
    """What ``ptxas -v`` reported for each kernel of ``csrc/<stem>.cu``
    (mangled name, registers, spills, static shared memory)."""
    if not hasattr(runtime, "kernel_resources"):
        return []  # a package from before the report (an A/B copy)
    runtime.build_kernels()
    return runtime.kernel_resources(stem)


def topk_only(dev, kernels, planted) -> int:
    """``--topk``: the score+top-k kernel alone (its cases, the edge cases,
    then its timings), for an A/B of two copies of the package."""
    t0 = time.perf_counter()
    err, n_cases = kernel_phase(dev, kernels, planted)
    print(f"kernel: {n_cases} cases agree with the plain version, max score "
          f"error {err:.3e} ({time.perf_counter() - t0:.1f} s)", flush=True)
    for row in topk_timings(kernels, planted, dev):
        print(f"time: {json.dumps(dict(name='score_topk', **row))}",
              flush=True)
    print(json.dumps({"topk_ok": True, "kind": torch.cuda.get_device_name(0)}))
    return 0


def als_only(dev, ak, als) -> int:
    """``--als``: the ALS kernels alone (the als-kernel and edge cases,
    then every entry timed at the ML-20M bucket shapes and at the width of
    the main path's heaviest item chunk, D 32,768, in f32 and bf16)."""
    t0 = time.perf_counter()
    errs, worst, checks = als_kernel_phase(dev, ak, als.CHUNK_ELEMS)
    edge_checks, edge_worst = als_edge_phase(dev, ak)
    print(f"als-kernel: {checks} + {edge_checks} checks agree with the plain "
          f"versions, max abs error {json.dumps(errs)}, max relative error "
          f"{json.dumps(worst)}, edges {json.dumps(edge_worst)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if hasattr(ak, "solve_plan"):  # an older A/B copy trains only <= 128
        from incubator_predictionio_tpu_torch import runtime
        from incubator_predictionio_tpu_torch.utils import planted

        print(f"als-rank: {json.dumps(rank_train_phase(dev, runtime, als, planted))}",
              flush=True)
    times = als_shape_timings(ak, als, dev, als.CHUNK_ELEMS,
                              ds=(8, 16, 32, 64, 128, 256, 1024, 8192,
                                  32768),
                              dtypes=(torch.float32, torch.bfloat16))
    if hasattr(ak, "solve_plan"):
        for entry, rows in als_rank_timings(ak, als, dev,
                                            als.CHUNK_ELEMS).items():
            times[entry] += rows
    for entry, rows in times.items():
        for row in rows:
            print(f"time: {json.dumps(dict(name=entry, **row))}", flush=True)
    # the CG's share at the main path's heaviest fused chunk's shape
    rng = np.random.default_rng(16)
    table, cols, vals, mask, prev = als_problem(rng, ML20M["items"], 128,
                                                14_563, 256)
    chunk = tuple(torch.from_numpy(a).to(dev) for a in (cols, vals, mask)) \
        + (torch.arange(14_563, device=dev),)
    for row in cg_share(ak, als, chunk, torch.from_numpy(table).to(dev),
                        torch.from_numpy(prev).to(dev)):
        print(f"cg: {json.dumps(row)}", flush=True)
    from incubator_predictionio_tpu_torch.utils import planted

    for row in narrow_timings(ak, als, narrow_cells(als, planted, dev),
                              als.CHUNK_ELEMS):
        print(f"narrow: {json.dumps(row)}", flush=True)
    print(json.dumps({"als_ok": True, "kind": torch.cuda.get_device_name(0)}))
    return 0


def flash_only(dev, runtime, fa) -> int:
    """``--flash``: the flash kernel alone (cases, then timings), for an A/B
    of two copies of the package on one card."""
    t0 = time.perf_counter()
    err_f, flash_rel = flash_phase(dev, fa)
    print(f"flash-kernel: {len(flash_rel)} cases agree with the plain "
          f"version, max abs error {err_f:.3e}, relative "
          f"{json.dumps(flash_rel)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    for row in flash_timings(fa, dev):
        print(f"time: {json.dumps(dict(name='flash_attention', **row))}",
              flush=True)
    print(json.dumps({"flash_ok": True,
                      "kind": torch.cuda.get_device_name(0)}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from incubator_predictionio_tpu_torch import runtime
    from incubator_predictionio_tpu_torch.core import base
    from incubator_predictionio_tpu_torch.core import params as params_mod
    from incubator_predictionio_tpu_torch.data import (
        interactions as interactions_mod,
    )
    from incubator_predictionio_tpu_torch.models.recommendation import (
        convert,
        engine,
    )
    from incubator_predictionio_tpu_torch.models.sequence import (
        convert as seq_convert,
    )
    from incubator_predictionio_tpu_torch.models.sequence import (
        engine as seq_engine,
    )
    from incubator_predictionio_tpu_torch.ops import als, kernels
    from incubator_predictionio_tpu_torch.ops import als_kernels as ak
    from incubator_predictionio_tpu_torch.ops import attention as att
    from incubator_predictionio_tpu_torch.ops import attention_kernels as fa
    from incubator_predictionio_tpu_torch.ops import transformer as tr
    from incubator_predictionio_tpu_torch.parallel import context
    from incubator_predictionio_tpu_torch.servers import (
        prediction_server as server_mod,
    )
    from incubator_predictionio_tpu_torch.utils import planted

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    runtime.build_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    from incubator_predictionio_tpu_torch import native

    t0 = time.perf_counter()
    native.load()
    print(f"build-native: {time.perf_counter() - t0:.1f} s", flush=True)
    mode = sys.argv[1:]
    if mode not in ([], ["--flash"], ["--topk"], ["--als"]):
        print(f"chip_smoke: unknown arguments {mode}", file=sys.stderr)
        return 2
    if mode in ([], ["--flash"]):
        for row in flash_resources(runtime):
            print(f"ptxas: {json.dumps(dict(name='flash_attention', **row))}",
                  flush=True)
    for stem, flag in (("score_topk", "--topk"), ("als_solve", "--als")):
        if mode in ([], [flag]):
            for row in kernel_resources(runtime, stem):
                print(f"ptxas: {json.dumps(dict(source=stem, **row))}",
                      flush=True)
    if mode == ["--flash"]:
        return flash_only(dev, runtime, fa)
    if mode == ["--topk"]:
        return topk_only(dev, kernels, planted)
    if mode == ["--als"]:
        return als_only(dev, ak, als)

    err_k, n_cases = kernel_phase(dev, kernels, planted)
    print(f"kernel: {n_cases} cases agree with the plain version, max score "
          f"error {err_k:.3e}", flush=True)

    t0 = time.perf_counter()
    als_errs, als_worst, als_checks = als_kernel_phase(dev, ak,
                                                       als.CHUNK_ELEMS)
    edge_checks, edge_worst = als_edge_phase(dev, ak)
    print(f"als-kernel: {als_checks} + {edge_checks} checks agree with the "
          f"plain versions, max abs error {json.dumps(als_errs)}, max "
          f"relative error {json.dumps(als_worst)}, edges "
          f"{json.dumps(edge_worst)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    rank_stats = rank_train_phase(dev, runtime, als, planted)
    print(f"als-rank: {json.dumps(rank_stats)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    err_f, flash_rel = flash_phase(dev, fa)
    print(f"flash-kernel: {len(flash_rel)} cases agree with the plain "
          f"version, max abs error {err_f:.3e}, relative "
          f"{json.dumps(flash_rel)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    built = build_model(planted, convert, dev, ML20M["users"],
                        ML20M["items"], ML20M["rank"])
    launches, err_p, stats = path_phase(
        dev, runtime, kernels, planted, convert, engine, params_mod,
        server_mod, ML20M["users"], ML20M["items"], ML20M["rank"], built)
    print(f"path: {json.dumps(stats)}", flush=True)

    load_launches, err_load, load_stats = serve_load_phase(
        dev, runtime, kernels, server_mod, engine, params_mod, built)
    for leg in load_stats["legs"]:
        print(f"serve-load: {json.dumps(leg)}", flush=True)
    print(f"serve-load-shed: {json.dumps(load_stats['shed'])}", flush=True)
    print(f"serve-load-tenants: {json.dumps(load_stats['tenants'])}",
          flush=True)
    print(f"serve-load-card: {card_line()} "
          f"({load_stats['wall_s']:.1f} s)", flush=True)
    del built

    model, pd, eng, ep, train_stats, (u_tree, i_tree, plain) = train_phase(
        dev, runtime, als, engine, base, params_mod, context,
        interactions_mod, planted)
    print(f"train: {json.dumps(train_stats)}", flush=True)

    trained_launches, err_t, serve_stats = serve_trained_phase(
        dev, runtime, kernels, server_mod, model, pd, eng, ep)
    print(f"serve-trained: {json.dumps(serve_stats)}", flush=True)

    t0 = time.perf_counter()
    seq_launches, err_sp, seq_stats = seq_path_phase(
        dev, runtime, tr, fa, seq_engine, seq_convert, planted, params_mod,
        server_mod)
    print(f"seq-path: {json.dumps(seq_stats)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    wide_launches, err_sw, wide_stats = seq_wide_phase(
        dev, runtime, tr, fa, seq_engine, seq_convert, planted, params_mod,
        server_mod)
    print(f"seq-wide: {json.dumps(wide_stats)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    seq_train_launches, err_st, seq_train_stats = seq_train_phase(
        dev, runtime, tr, fa, seq_engine, base, params_mod, context, planted,
        server_mod)
    print(f"seq-train: {json.dumps(seq_train_stats)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    store_launches, err_sa, store_stats, store_path, sqlite_ref = \
        store_als_phase(dev, runtime, kernels, als, engine, planted,
                        params_mod, context, server_mod)
    print(f"store-als: {json.dumps(store_stats)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    store_seq_launches, err_ss, store_seq_stats = store_seq_phase(
        dev, runtime, tr, fa, seq_engine, planted, params_mod, context,
        server_mod)
    print(f"store-seq: {json.dumps(store_seq_stats)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    qs_launches, err_qs, qs_stats, (rt_cli_launches, err_rt, rt_cli) = \
        quickstart_phase(dev, runtime, kernels, als, planted,
                         then=lambda qs: retrain_cli_leg(
                             qs, dev, runtime, kernels, als))
    print(f"quickstart: {json.dumps(qs_stats)} "
          f"({time.perf_counter() - t0 - rt_cli['wall_s']:.1f} s)",
          flush=True)
    print(f"quickstart-card: {card_line()}", flush=True)

    sqlite_ref["figures"].update(
        quickstart_import_events_per_s=qs_stats["ingest"]["import"][
            "events_per_s"],
        quickstart_read_s=qs_stats["phases_s"].get("phase.read_s"),
        quickstart_train_s=qs_stats["train_s"],
        retrain_read_s=rt_cli["phases_s"].get("phase.read_s"),
        retrain_train_s=rt_cli["train_s"])
    log_launches, err_log, log_stats, speed_out = cpplog_phase(
        dev, runtime, kernels, als, planted, sqlite_ref,
        then=lambda log: speed_phase(dev, runtime, kernels, als, ak, planted,
                                     log))
    print(f"cpplog: {json.dumps(log_stats)} ({log_stats['wall_s']:.1f} s)",
          flush=True)
    print(f"cpplog-card: {card_line()}", flush=True)
    (speed_launches, ecom_launches, foldin_rows), err_speed, speed_stats = \
        speed_out
    for row in foldin_rows:
        line = dict(name="als_fused_solve_cg_foldin", **row)
        print(f"time: {json.dumps(line)}", flush=True)
    print(f"speed: {json.dumps(speed_stats)} ({speed_stats['wall_s']:.1f} s)",
          flush=True)
    print(f"speed-card: {card_line()}", flush=True)

    t0 = time.perf_counter()
    rt_loop_launches, rt_loop = retrain_loop_leg(
        dev, runtime, als, planted, pd,
        als.ALSState(user_factors=model.user_factors,
                     item_factors=model.item_factors))
    imp_launches, imp_stats, imp_row = implicit_leg(
        dev, runtime, ak, als, pd, narrow_coo=store_als_ratings(planted))
    rt_stats = dict(cli=rt_cli, loop=rt_loop, implicit=imp_stats)
    print(f"retrain: {json.dumps(rt_stats)} "
          f"({rt_cli['wall_s'] + time.perf_counter() - t0:.1f} s)",
          flush=True)

    shapes = topk_timings(kernels, planted, dev)
    for s in shapes:
        print(f"time: {json.dumps(s)}", flush=True)
    als_times = als_timings(ak, als, [(u_tree, i_tree, model, plain),
                                      store_path], als.CHUNK_ELEMS)
    for extra in (als_shape_timings(ak, als, dev, als.CHUNK_ELEMS),
                  als_rank_timings(ak, als, dev, als.CHUNK_ELEMS)):
        for entry, rows in extra.items():
            als_times[entry] += rows
    for entry, rows in als_times.items():
        for row in rows:
            print(f"time: {json.dumps(dict(name=entry, **row))}", flush=True)
    user_chunk = heaviest_chunk(u_tree, ML20M["rank"], als.CHUNK_ELEMS,
                                fused=True)
    for row in cg_share(ak, als, user_chunk, model.item_factors,
                        plain.user_factors):
        print(f"cg: {json.dumps(row)}", flush=True)
    head = shapes[0]
    entries = [{
        "name": "score_topk",
        "route": "cuda",
        "source": "incubator_predictionio_tpu_torch/csrc/score_topk.cu",
        "replaces": kernels.REPLACES,
        "launches": launches + load_launches + trained_launches
        + store_launches["score_topk"] + qs_launches["score_topk"]
        + rt_cli_launches["score_topk"] + log_launches["score_topk"]
        + speed_launches["score_topk"],
        "max_abs_err": max(err_k, err_p, err_load, err_t, err_sa, err_qs,
                           err_rt, err_log, err_speed),
        "ms": head["ms"],
        "graph_ms": head["graph_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "bound_fma_ms": head["bound_fma_ms"],
        "library_ms": head["library_ms"],
        "shapes": shapes,
    }]
    for entry, rows in als_times.items():
        first = rows[0]  # f32, the polish sweeps' dtype
        entries.append({
            "name": entry,
            "route": "cuda",
            "source": "incubator_predictionio_tpu_torch/csrc/als_solve.cu",
            "replaces": ak.REPLACES[entry],
            "launches": train_stats["launches"][entry]
            + store_launches.get(entry, 0) + qs_launches.get(entry, 0)
            + rt_cli_launches.get(entry, 0) + rt_loop_launches.get(entry, 0)
            + log_launches.get(entry, 0),
            "max_abs_err": max([als_errs[entry]]
                               + [r["max_abs_err"] for r in rows]),
            "ms": first["ms"],
            "graph_ms": first["graph_ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "bound_fma_ms": first["bound_fma_ms"],
            "library_ms": first["library_ms"],
            "library_note": "the Gram alone: one torch.bmm(g.mT, g) on the "
                            "gathered block, TF32 off (no single PyTorch "
                            "call computes a Gram and its CG solve)",
            "shapes": rows,
        })
        if entry not in (train_stats["on_path"] + store_stats["on_path"]
                         + qs_stats["on_path"]):
            entries[-1]["path_note"] = (
                "off the main path (ops/als._route sends no bucket to it); "
                "launched and held to its plain version by the als-kernel "
                "and als-rank phases, timed here on the main path's "
                "heaviest item chunk")
    imp_line = dict(name="als_fused_solve_cg_implicit", **imp_row)
    print(f"time: {json.dumps(imp_line)}", flush=True)
    entries.append({
        "name": "als_fused_solve_cg_implicit",
        "route": "cuda",
        "source": "incubator_predictionio_tpu_torch/csrc/als_solve.cu",
        "replaces": ak.REPLACES["als_fused_solve_cg"],
        "launches": imp_launches
        + ecom_launches["train"]["als_fused_solve_cg"],
        "max_abs_err": imp_row["max_abs_err"],
        "ms": imp_row["ms"],
        "graph_ms": imp_row["graph_ms"],
        "plain_ms": imp_row["plain_ms"],
        "bound_ms": imp_row["bound_ms"],
        "bound_by": imp_row["bound_by"],
        "bound_fma_ms": imp_row["bound_fma_ms"],
        "library_ms": imp_row["library_ms"],
        "library_note": "the confidence-weighted Gram plus YtY: one "
                        "torch.baddbmm(yty, (alpha*r*g).mT, g) on the "
                        "gathered block, TF32 off",
        "path_note": "the fused entry's implicit variant (YtY in the "
                     "matvec), launched by als_train_implicit in the "
                     "retrain phase and by the ecommerce template's "
                     "training in the speed phase; timed on its heaviest "
                     "user chunk",
        "shapes": [imp_row],
    })
    fold_head = next(r for r in foldin_rows
                     if r["B"] == 64 and r["D"] == 512
                     and not r.get("implicit"))
    entries.append({
        "name": "als_fused_solve_cg_foldin",
        "route": "cuda",
        "source": "incubator_predictionio_tpu_torch/csrc/als_solve.cu",
        "replaces": ak.REPLACES["als_fused_solve_cg"],
        "launches": speed_launches["als_fused_solve_cg"]
        + ecom_launches["als_fused_solve_cg"],
        "max_abs_err": max(r["max_abs_err"] for r in foldin_rows),
        "ms": fold_head["ms"],
        "graph_ms": fold_head["graph_ms"],
        "plain_ms": fold_head["plain_ms"],
        "bound_ms": fold_head["bound_ms"],
        "bound_by": fold_head["bound_by"],
        "bound_fma_ms": fold_head["bound_fma_ms"],
        "library_ms": fold_head["library_ms"],
        "library_note": "the Gram alone: one torch.bmm(g.mT, g) on the "
                        "gathered block (implicit rows: torch.baddbmm with "
                        "YtY), TF32 off",
        "path_note": "the fused entry at the speed layer's fold-in shapes "
                     "(speed/foldin.py: ladder widths 8-512, pow2 batches "
                     "up to 64, cold CG), launched by the overlays' polls "
                     "in the speed phase (recommendation explicit, "
                     "ecommerce implicit)",
        "shapes": foldin_rows,
    })
    flash_rows = flash_timings(fa, dev)
    for row in flash_rows:
        print(f"time: {json.dumps(dict(name='flash_attention', **row))}",
              flush=True)
    for row in flash_crossover(fa, att, dev):
        print(f"crossover: {json.dumps(row)}", flush=True)
    head = flash_rows[0]  # one served query with a full 8,192 window
    entries.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "incubator_predictionio_tpu_torch/csrc/flash_attention.cu",
        "replaces": fa.REPLACES,
        "launches": seq_launches + wide_launches + seq_train_launches
        + store_seq_launches,
        "max_abs_err": err_f,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "max_score_err": max(err_sp, err_sw, err_st, err_ss),
        "shapes": flash_rows,
    })
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
