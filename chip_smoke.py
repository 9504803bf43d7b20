#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the recommendation
template (serving, ALS training through ``Engine.train``, serving the
trained model), the sequence engine (SASRec served and trained through
the flash-attention kernel), both through the event store: events in
SQLite or the native log (cpplog) → ``CoreWorkflow.run_train`` → the
checkpoint → ``load_models`` → /queries.json, and the speed layer behind
/queries.json (new events folded in on the fused ALS kernel), with the
ecommerce template's implicit fold-in, two-stage MIPS serving at
1,048,576 items, ``pio eval`` (evaluation and its metrics), the
similarproduct template (implicit ALS, its item-side overlay into the MIPS
index, DIMSUM and the recommended-user engine), the classification,
regression, friendrecommendation and stock templates, and the main path
across processes behind ``pio storageserver``.

    python3 chip_smoke.py

Every phase prints its wall as it ends (flushed, so a cut run still shows
how far it got), and the line before the report's JSON is ``walls:``, each
phase's seconds and the total. The host's distinct counts at 20M keys go
through a sort (:func:`n_distinct`), never numpy 2.3's hash ``np.unique``.
Depth cuts for the run's time limit, each
at full width and with its checks kept: store-als imports 250,000 planted
ratings (from 1,000,000; still every ML-20M user and item, and the same
ratings feed cpplog's ``pio import``, the speed phase's log and the
ecommerce template's views); store-seq takes 16 of seq-train's sessions
(131,088 views, from 524,352); retrain leg (b)'s in-process
``als_retrain`` runs 2 sweeps (from 4); eval plants 4,096 users (ML-20M
has 138,493; the items and the rank stay); the similar phase trains 4
sweeps (the example's engine.json says 20) on the first 160,000 of
store-als's pairs (from all 250,000; the first rate every user and item);
the templates phase plants 20,000 classification users (from 50,000) and
40,000 regression points (from 100,000), which every fold of their ``pio
eval`` queries one by one.

More cuts for the same limit: the serve-load legs run 2 s (from 4), the
quickstart posts 500 single events (from 2,000; the rest go through ``pio
import``) and the cpplog phase 500 (from 1,000).

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
             in child processes at 1, 16, 64 and 256 for 2 s each through
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
    mips   — two-stage MIPS serving (:func:`mips_phase`) on 1,048,576
             planted items × rank 64 (seed 11) with 32 planted queries
             (seed 5), k 20, the exhaustive score+top-k kernel the oracle:
             an int8, a bf16 and a PQ index built on the card, each with
             its build wall, recall@20 ≥ 0.95, every score the exact f32
             dot product (rtol 1e-5), the answers at B 1 and 64 those of the
             same index on the CPU except near-ties, the scanned fraction;
             a planted model of 138,493 users over the catalogue behind
             ``PredictionServer`` (scheduler on): 32 queries and 2 s of 16
             closed-loop clients, every answer held so, one filtered query
             on the exhaustive kernel (its launch read), ``GET /``'s
             ``mips`` block and ``/metrics``' scan counters; 256 published
             solves of existing items (the JAX bench's churn, scaled to
             dominate) each found first the moment it publishes;
             ``rebuild_index`` in a thread while one client queries (p50 /
             p99 before and during, every answer a 200, every key kept);
             the server stopped, the daemon released; the daemon's churn
             trigger through ``sweep_now``; the cold tier demoted, served
             from the host and promoted (``PIO_MIPS_TIER=on``); the route
             against the kernel at 65,536, 262,144 and 1,048,576 items, B 1
             and 64 (host ms, device ms; ``time:`` rows named
             ``mips_two_stage``), and the smallest size at which it wins at
             B 1 beside ``PIO_SERVE_MIPS_MIN_ITEMS``' default. Every wait has
             a deadline. Prints ``mips-card: <card line> (<wall> s)``.
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
             250,000 planted ratings over every one of the 138,493 users
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
12. store-seq — 16 of the seq-train sessions as 131,088 ``view`` events
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
             500 single events, a 51-event body refused (400) at the
             reference's cap of 50, the child stopped (exit 0); 9,500
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
             same again on store-als's 250,000 ratings, whose buckets start at
             d 8: no R-row launch there either.
15. cpplog — the quickstart's verbs with the events on the native log
             (:func:`cpplog_phase`; metadata on SQLite, models on localfs):
             ``pio import`` of store-als's 250,000 ratings on the native
             columnar path (which writes the training projection); ``pio
             train`` (store-als's params), its read the sharded scan, held
             to store-als's SQLite read as triples and its fit within 1e-3
             of store-als's; ``pio eventserver`` as a child on the log: the
             three batch legs at bodies of 50 and 500, 500 single events,
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
             ecommerce template (:func:`ecommerce_leg`): 250,000 planted
             views (every 8th also a buy) trained by the example's
             engine.json (implicit, rank 10, 20 iterations) and held to the
             plain route's implicit loss, its narrow buckets to the f64
             rule, deployed with the implicit overlay, new users folded and
             served, a known, a recent-views, a popularity user and an
             ``unavailableItems`` constraint against the plain scoring.
             Prints the poll wall by part, fold-ins, hit rate, cursor lag,
             freshness p95, HTTP p50 of overlay and base users, and the
             card's line again.
    remote — the main path across four processes on the same log, after
             ``speed`` (:func:`remote_phase`; that hook's second part):
             the recommendation read of the log in this process, the log
             closed; ``pio storageserver`` as a child (routed: metadata
             SQLite, events the log, models localfs), and from then on
             metadata and events only through it (``remote``); the same
             read through the wire, equal byte for byte; ``pio
             eventserver`` as a child; ``pio train`` over the wire, which
             continues and launches the fused and R-row kernels; ``pio
             deploy`` as a child with the speed layer: 32 known users
             against the plain top-k; 32 new users × 8 ratings through the
             event server child, each answered from its fold-in (held to
             the plain fold-in) within 30 s; ``pio_freshness_seconds`` p95
             and ``kernelLaunches`` from the deploy child; the feedback
             leg (:func:`feedback_leg`) on a second ``pio deploy`` child
             started with the first, ``--feedback`` to the event server
             child and ``--log-url`` to a collector here: 64 known users'
             answers against the plain top-k, their 64 ``pio_pr`` predict
             events read back within 30 s, a malformed body's one shipped
             error line, 0 dropped, and both children's HTTP p50/p99 on
             the same queries; every child exits 0. Prints ``remote:``
             with the walls.
16. eval  — ``pio eval`` through the port's CLI in this process
             (:func:`eval_phase`) on a fresh SQLite store: 4,096 users ×
             26,744 items × 32 preference-biased planted ratings (seed 7,
             131,072), the port's twin of the quickstart's
             ``evaluation.py``: two folds, ``PrecisionAtK(k=5)``, an
             untrained and a 4-sweep candidate at rank 128; the winner the
             trained one, ``best.json`` its params, the instance
             EVALCOMPLETED, the R-row, fused and score+top-k kernels
             launched, 64 sampled answers of each fold against the plain
             top-k of that fold's model. Prints the wall by read, train and
             queries, and queries/s.
17. similar — the similarproduct template (:func:`similar_phase`):
             the first 160,000 of store-als's pairs as views (every 16th a
             like)
             through SQLite, ``run_train`` at rank 128 on the fused
             implicit entry (its loss the plain route's within 1e-6), 64
             HTTP answers (half filtered) against the plain top-k; the
             instance deployed again on a memory store with
             ``PIO_SERVE_MIPS=on``: a brand-new item's views folded in by
             the overlay, published through ``index_sink`` under a
             virtual id and served by its key; DIMSUM at 16,384 items
             against ``scipy.sparse``'s exact cosine, the Gram's ms; the
             recommended-user engine on 250,000 planted follows over the
             138,493 users (a memory store), 32 HTTP answers against the
             plain top-k.
18. templates — the four remaining templates (:func:`templates_phase`),
             each leg through ``pio train`` in this process on a fresh
             memory store and served by ``PredictionServer``: (a)
             classification at the quickstart's width (3 attributes, 3
             plans) on 20,000 planted users, naive Bayes served and held
             to the f64 host argmax, logistic regression on the card held
             to its CPU fit, ``pio eval`` of ``AccuracyMetric`` over two
             naive Bayes candidates (:func:`classification_leg`); (b)
             regression on 40,000 planted points read from an
             lr_data.txt file, the linear weights held to
             ``numpy.linalg.lstsq`` in f64, SGD to its CPU fit, the
             ``AverageServing`` answers to the host mean, ``pio eval`` of
             ``MeanSquareError`` (:func:`regression_leg`); (c)
             friendrecommendation at SimRank's dense ceiling of 16,384
             nodes (65,536 follow edges), the f32 matrix held to the same
             iteration in f64 on the card, symmetric, its diagonal 1, the
             served answers S[a, b], the keyword and random answers
             recomputed on the host, the 1 GiB blob's bytes and
             ``dumps`` / ``loads`` walls on the memory model store (above
             SQLite's length limit) (:func:`friendrec_leg`); (d) stock at
             S&P-500 width (500 tickers and SPY, 300 days), the regression
             strategy's batched solve held to per-ticker f64 ridge solves,
             32 served days to the host product, ``pio eval`` of
             ``BacktestingEvaluator`` over days 270-298 (:func:`stock_leg`).
             No hand-written kernel is on these paths: their launch counts
             are read and printed, all 0.
19. report — kernel, plain-version and library times (CUDA events, median
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
``--mips`` the mips phase; ``--eval``, ``--similar``, ``--templates`` and
``--remote`` those phases (``--remote`` on a cpplog store of store-als's
ratings and one trained instance of its own, :func:`remote_alone`);
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
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

ML20M = dict(users=138_493, items=26_744, rank=128)
MIPS_CATALOGUE = dict(items=1_048_576, rank=64)


#: each phase's wall in seconds, as the ``walls:`` line prints them
WALLS: dict = {}


def note_wall(name: str, t0: float) -> float:
    """Record the wall of phase ``name`` (seconds since ``t0``)."""
    WALLS[name] = time.perf_counter() - t0
    return WALLS[name]


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

#: client counts of the serve-load legs, and the seconds each runs (cut
#: from 4 for the script's time limit: a leg still answers thousands)
LOAD_CLIENTS = (1, 16, 64, 256)
LOAD_SECONDS = 2.0
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
    (:func:`run_clients`). (1) 1, 16, 64 and 256 clients for 2 s each,
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


# -- the observation plane: profiler, recorder, incident bundle, trace --------

#: single queries of the obs phase with the profiler on (half on the
#: rendered-bytes fast path, half on the object path) and with it off
OBS_QUERIES = 200
OBS_OFF_QUERIES = 100
#: the score+top-k kernels' names in a profiler trace (csrc/score_topk.cu)
TOPK_KERNELS = ("tile_topk_kernel", "merge_topk_kernel")


def profiled(profile, op: str) -> tuple:
    """(dispatches, seconds, FLOPs) the profiler has booked under ``op``."""
    return (profile.DEVICE_DISPATCHES.labels(op=op).value,
            profile.DEVICE_SECONDS.labels(op=op).value,
            profile.DEVICE_FLOPS.labels(op=op).value)


def device_totals(profile) -> tuple:
    """Every ``pio_device_*`` series summed over its ops."""
    out = []
    for fam in (profile.DEVICE_DISPATCHES, profile.DEVICE_SECONDS,
                profile.DEVICE_FLOPS):
        with fam._lock:
            children = list(fam._children.values())
        out.append(sum(c.value for c in children))
    return tuple(out)


def kernel_busy(events, names) -> dict:
    """Kernel events of a Chrome trace: the count of each name in
    ``names`` (by substring) and the share of the window that no kernel
    covered (the window: first to last event of the trace)."""
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "ts" in e and "dur" in e]
    counts = {n: sum(n in e.get("name", "") for e in kernels) for n in names}
    stamps = [float(e["ts"]) for e in events if "ts" in e]
    window = (max(stamps) - min(stamps)) if stamps else 0.0
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                         for e in kernels):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return {"kernel_events": len(kernels), "counts": counts,
            "window_us": window, "busy_us": busy,
            "idle_share": (1.0 - busy / window) if window > 0 else None}


def obs_phase(dev, runtime, kernels, ak, als, server_mod, engine,
              params_mod, built, small: bool = False) -> tuple:
    """The observation plane on the path phase's planted model (``built``:
    ML-20M width), in-process, the recorder at 5 Hz:
    (1) the profiler off: ``OBS_OFF_QUERIES`` single queries move no
    ``pio_device_*`` series;
    (2) ``PIO_PROFILE=1``: ``OBS_QUERIES`` single queries over HTTP with
    ``micro_batch=0`` (half plain docs on the fast path, which books
    ``serve_topk_batch`` at B 1; half with ``excludeSeen``, the object
    path's ``serve_topk``), then one 64-body batch: each block's
    dispatches equal its score+top-k launches, every answer the plain
    top-k; ``pio_device_seconds`` above 0, ``pio_mfu{phase="serve"}`` in
    (0, 1];
    (3) two 1 s ``POST /profile`` captures (``torch.profiler``, on a bare
    router) under a client thread querying as a tenant of its own (its
    answers stay out of the default tenant's p99, which later phases shed
    against): the first trace names the score+top-k kernels, each as many
    times as at most the launches of its window, and gives the device's
    idle share; the second does the same or answers 500 naming the
    kernels the profiler lost, never 200 without them;
    (4) through the scheduler, 64 traced queries, then ``GET /recorder``
    holds at least 8 samples of ``pio_query_latency_seconds``, and
    ``IncidentCapture.capture_now`` freezes one bundle with the
    scheduler's block and exemplar trace ids, the latency histogram's
    among them;
    (5) one fold-in solve books ``foldin_solve`` dispatches equal to its
    fused launches, its vectors held to the plain version's, and
    ``pio_mfu{phase="foldin"}`` in (0, 1].
    Returns ({"score_topk", "foldin"} launches, max score error, stats)."""
    from incubator_predictionio_tpu_torch.obs import metrics as obs_metrics
    from incubator_predictionio_tpu_torch.obs import profile, recorder
    from incubator_predictionio_tpu_torch.obs.http import add_profile_route
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        ServerConfig,
    )
    from incubator_predictionio_tpu_torch.speed import foldin
    from incubator_predictionio_tpu_torch.utils.http import (
        HttpServer,
        Router,
    )

    t_phase = time.perf_counter()
    # the default tenant's p99, which every later scheduler sheds against
    p99_default = obs_metrics.REGISTRY.histogram(
        "pio_query_latency_seconds",
        "per-query serving wall (fused batch members share the batch "
        "wall)", labels=("tenant",)).labels(tenant="default")
    p99_before = p99_default.quantile(0.99)
    model, uf, _items, seen = built
    n_users = uf.shape[0]
    uf_t, items_t = model.user_factors, model.item_factors
    n_single = 20 if small else OBS_QUERIES
    work = tempfile.mkdtemp(prefix="pio-obs-")
    env = {"PIO_PROFILE": None, "PIO_RECORDER_HZ": "5",
           "PIO_PROFILE_DIR": os.path.join(work, "trace")}
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    recorder.reset_recorder()  # the process recorder re-reads its rate
    eng = engine.RecommendationEngine().apply()
    ep = params_mod.EngineParams(algorithm_params_list=[
        ("als", engine.ALSAlgorithmParams(rank=uf.shape[1]))])
    servers = []
    rng = np.random.default_rng(21)
    stats: dict = {}
    err = 0.0
    launches = {"score_topk": 0, "foldin": 0}

    def serve(srv):
        servers.append(srv)
        return srv.start_background()

    try:
        single = serve(server_mod.PredictionServer(
            eng, ep, [model], device=dev,
            config=ServerConfig(ip="127.0.0.1", port=0, micro_batch=0)))
        url = f"http://127.0.0.1:{single}/queries.json"

        def run_block(docs):
            walls, answers = [], []
            for doc in docs:
                t0 = time.perf_counter()
                answers.append(post(single, doc))
                walls.append(time.perf_counter() - t0)
            return walls, answers

        # (1) the profiler off
        off_docs = [{"user": f"u{u}", "num": 10}
                    for u in rng.choice(n_users, OBS_OFF_QUERIES // (
                        10 if small else 1), replace=False)]
        totals0 = device_totals(profile)
        walls_off, _ = run_block(off_docs)
        if device_totals(profile) != totals0:
            raise AssertionError("obs: a pio_device_* series moved with "
                                 "the profiler off")
        # (2) the profiler on, one block a route
        os.environ["PIO_PROFILE"] = "1"
        blocks = {}
        for op, extra in (("serve_topk_batch", {}),
                          ("serve_topk", {"excludeSeen": True})):
            docs = [dict({"user": f"u{u}", "num": 10}, **extra)
                    for u in rng.choice(n_users, n_single // 2,
                                        replace=False)]
            runtime.reset_launch_counts()
            before = profiled(profile, op)
            walls, answers = run_block(docs)
            n_launch = runtime.launch_counts()["score_topk"]
            booked = profiled(profile, op)
            d_disp = booked[0] - before[0]
            launches["score_topk"] += n_launch
            if dev.type == "cuda" and d_disp != n_launch:
                raise AssertionError(f"obs: {d_disp} {op} dispatches for "
                                     f"{n_launch} score_topk launches")
            if d_disp != len(docs):
                raise AssertionError(f"obs: {d_disp} {op} dispatches for "
                                     f"{len(docs)} queries")
            for i, (doc, body) in enumerate(zip(docs, answers)):
                row = int(doc["user"][1:])
                mask = None
                if doc.get("excludeSeen") and row in seen:
                    mask = np.ones(items_t.shape[0], bool)
                    mask[seen[row]] = False
                err = max(err, check_answer(kernels, dev, uf_t, items_t,
                                            doc, mask, body,
                                            f"obs {op} query {i}"))
            blocks[op] = {"queries": len(docs), "dispatches": d_disp,
                          "launches": n_launch,
                          "device_s": booked[1] - before[1],
                          "flops": booked[2] - before[2],
                          "http_p50_ms": 1e3 * statistics.median(walls)}
        batch_docs = [{"user": f"u{u}", "num": 10}
                      for u in rng.choice(n_users, 64, replace=False)]
        runtime.reset_launch_counts()
        before = profiled(profile, "serve_topk_batch")
        batch_out = servers[0]._handle_batch(
            [json.dumps(d).encode() for d in batch_docs], "default",
            "default")
        n_launch = runtime.launch_counts()["score_topk"]
        d_disp = profiled(profile, "serve_topk_batch")[0] - before[0]
        launches["score_topk"] += n_launch
        if d_disp != 1 or (dev.type == "cuda" and n_launch != 1):
            raise AssertionError(f"obs: the 64-body batch booked {d_disp} "
                                 f"dispatches, launched {n_launch}")
        for i, (doc, res) in enumerate(zip(batch_docs, batch_out)):
            err = max(err, check_answer(kernels, dev, uf_t, items_t, doc,
                                        None, json.loads(res),
                                        f"obs batch body {i}"))
        mfu_serve = profile.MFU.labels(phase="serve").value
        secs = profile.DEVICE_SECONDS.labels(op="serve_topk").value
        if not (secs > 0 and 0 < mfu_serve <= 1):
            raise AssertionError(f"obs: pio_device_seconds {secs}, "
                                 f"pio_mfu{{serve}} {mfu_serve}")
        stats.update(off={"queries": len(off_docs),
                          "http_p50_ms": 1e3 * statistics.median(walls_off)},
                     on=blocks, mfu_serve=mfu_serve,
                     batch64={"dispatches": d_disp, "launches": n_launch})

        # (3) two 1 s captures through POST /profile under a client
        # thread. The first must name the score+top-k kernels. A later
        # session can lose a launching thread's kernels for the rest of
        # the process (obs/profile.py; scripts/profiler_capture_probe.py),
        # and the route must then answer 500 naming the loss: the second
        # capture either names the kernels or answers so, never a 200
        # without them. The first session's setup and
        # post-processing take seconds, GIL-starving the client, and
        # its slow answers would land in the default tenant's
        # pio_query_latency_seconds, whose process-wide p99 every later
        # scheduler sheds against (F1): the client queries as a tenant of
        # its own. That keeps the slow answers out of the later phases'
        # shed; it does not fix the shed's reading of one slow window
        # (ROADMAP Queue 3).
        from incubator_predictionio_tpu_torch.serving import tenancy

        r = Router()
        add_profile_route(r)
        admin = HttpServer(r, "127.0.0.1", 0, name="admin")
        servers.append(admin)
        aport = admin.start_background()
        os.environ["PIO_TENANTS"] = "obs-trace:obs-key"
        tenancy.reset_registry()
        users = rng.choice(n_users, 100_000)
        stats["trace"] = []
        try:
            for n_cap in range(2):
                stop = threading.Event()
                sent = []

                def client():
                    while not stop.is_set():
                        status, _b = http_json(
                            "POST", url + "?accessKey=obs-key",
                            {"user": f"u{users[len(sent) % len(users)]}",
                             "num": 10})
                        sent.append(status)

                runtime.reset_launch_counts()
                t = threading.Thread(target=client, daemon=True)
                t.start()
                try:
                    t0 = time.perf_counter()
                    status, out = http_json(
                        "POST",
                        f"http://127.0.0.1:{aport}/profile?seconds=1", b"")
                    capture_s = time.perf_counter() - t0
                finally:
                    stop.set()
                    t.join(timeout=60)
                n_launch = runtime.launch_counts()["score_topk"]
                launches["score_topk"] += n_launch
                if n_cap and status == 500 and "without their kernel" in \
                        out.get("message", ""):
                    stats["trace"].append({"lost": out["message"],
                                           "answers": len(sent),
                                           "launches": n_launch})
                    continue
                if status != 200:
                    raise AssertionError(f"obs: POST /profile #{n_cap} "
                                         f"answered {status}: {out}")
                trace_path = os.path.join(out["traceDir"],
                                          profile.TRACE_FILE)
                trace_bytes = os.path.getsize(trace_path)
                with open(trace_path) as f:
                    events = json.load(f)["traceEvents"]
                busy = kernel_busy(events, TOPK_KERNELS)
                if any(s != 200 for s in sent):
                    raise AssertionError(f"obs: the client got "
                                         f"{sorted(set(sent))}")
                if dev.type == "cuda" and not all(
                        1 <= busy["counts"][n] <= n_launch
                        for n in TOPK_KERNELS):
                    raise AssertionError(
                        f"obs: capture #{n_cap}'s score+top-k kernels "
                        f"{busy['counts']} against {n_launch} launches in "
                        f"the window")
                stats["trace"].append(dict(
                    busy, answers=len(sent), launches=n_launch,
                    capture_s=capture_s, trace_bytes=trace_bytes))
        finally:
            os.environ.pop("PIO_TENANTS", None)
            tenancy.reset_registry()
        os.environ.pop("PIO_PROFILE", None)

        # (4) the recorder and one incident bundle, through the scheduler
        sport = serve(server_mod.PredictionServer(
            eng, ep, [model], device=dev,
            config=ServerConfig(ip="127.0.0.1", port=0)))
        traced = [f"obs-{i}" for i in range(8 if small else 64)]
        runtime.reset_launch_counts()
        for i, tid in enumerate(traced):
            req = urllib.request.Request(
                f"http://127.0.0.1:{sport}/queries.json",
                data=json.dumps({"user": f"u{i}", "num": 10}).encode(),
                headers={"Content-Type": "application/json",
                         "X-PIO-Trace-Id": tid})
            with urllib.request.urlopen(req, timeout=120) as resp:
                if resp.status != 200:
                    raise AssertionError(f"obs: traced query {resp.status}")
        launches["score_topk"] += runtime.launch_counts()["score_topk"]
        rec_url = (f"http://127.0.0.1:{sport}/recorder?"
                   "series=pio_query_latency_seconds&window=600")
        deadline = time.monotonic() + 30
        while True:
            status, win = http_json("GET", rec_url)
            if status == 200 and win["samples"] >= 8 and \
                    "pio_query_latency_seconds" in win["series"]:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"obs: GET /recorder {status}: "
                                     f"{win.get('samples')} samples")
            time.sleep(0.2)
        cap = recorder.IncidentCapture(
            directory=os.path.join(work, "incidents"),
            recorder=recorder.get_recorder(), targets_fn=lambda: [])
        made = cap.capture_now(cap.MANUAL_TRIGGER)
        with open(made["path"]) as f:
            bundle = json.load(f)
        local = bundle["recorder"]["instances"]["local"]
        ex_ids = bundle["exemplars"]["traceIds"]
        latency_ex = [e for e in local["exemplars"]
                      if e["metric"] == "pio_query_latency_seconds"]
        if "scheduler" not in local.get("state", {}) or not ex_ids \
                or not latency_ex:
            raise AssertionError(f"obs: the bundle's state "
                                 f"{sorted(local.get('state', {}))}, "
                                 f"exemplars {bundle['exemplars']}")
        # a bucket keeps one exemplar a minute, drawn among every traced
        # query of the phase: how many name a query of this step is shown
        stats["recorder"] = {
            "samples": win["samples"], "hz": win["hz"],
            "bundle_bytes": os.path.getsize(made["path"]),
            "bundle_series": len(local["series"]),
            "exemplar_trace_ids": len(ex_ids),
            "latency_exemplars": len(latency_ex),
            "of_the_traced_queries": len(set(ex_ids) & set(traced))}

        # (5) one fold-in solve with the profiler on
        os.environ["PIO_PROFILE"] = "1"
        l2 = 0.03
        solver = foldin.FoldInSolver(items_t, l2=l2, device=dev)
        rows = foldin_case_rows(rng, items_t.shape[0], 1, 600,
                                16 if small else 96, False)
        solver.solve(rows[:1])  # built and loaded before the count
        runtime.reset_launch_counts()
        before = profiled(profile, "foldin_solve")
        got = solver.solve(rows)
        n_launch = runtime.launch_counts()["als_fused_solve_cg"]
        booked = profiled(profile, "foldin_solve")
        d_disp = booked[0] - before[0]
        launches["foldin"] = n_launch
        want = foldin_dispatches(foldin, rows)
        if d_disp != want or (dev.type == "cuda" and n_launch != want):
            raise AssertionError(f"obs: fold-in booked {d_disp}, launched "
                                 f"{n_launch}, buckets {want}")
        ref = foldin.FoldInSolver(items_t.cpu(), l2=l2,
                                  device="cpu").solve(rows)
        kept = [(c[-512:], v[-512:]) for c, v in rows]
        held = hold_foldin(ak, als, items_t, kept, got, ref, l2, False, 1.0,
                           "obs fold-in", trained=False)
        mfu_fold = profile.MFU.labels(phase="foldin").value
        if not 0 < mfu_fold <= 1:
            raise AssertionError(f"obs: pio_mfu{{foldin}} {mfu_fold}")
        stats["foldin"] = dict(held, dispatches=d_disp, launches=n_launch,
                               device_s=booked[1] - before[1],
                               flops=booked[2] - before[2],
                               mfu=mfu_fold)
    finally:
        for srv in servers:
            srv.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        recorder.reset_recorder()
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    stats["p99_default_s"] = {"before": p99_before,
                              "after": p99_default.quantile(0.99)}
    stats["wall_s"] = time.perf_counter() - t_phase
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


def n_distinct(keys: np.ndarray) -> int:
    """How many distinct values ``keys`` holds, by a sort. Not
    ``len(np.unique(keys))``: numpy 2.3's ``np.unique`` without ``return_*``
    arguments takes a hash-table path that spent 33-49 s on 20M int64
    keys on the card's host (numpy 2.3.5), where ``np.sort`` took 0.34 s
    (PERF.md §6)."""
    k = np.sort(keys)
    return int(len(k) and 1 + np.count_nonzero(k[1:] != k[:-1]))


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
    distinct = n_distinct(users.astype(np.int64) * n_items + items)
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


#: store-als's planted ratings: cut from 1,000,000 for the run's time
#: limit; still enough to rate every ML-20M user and item
STORE_ALS_NNZ = 250_000
#: store-seq's planted sessions of 8,193 items (cut from seq-train's 64)
STORE_SEQ_SESSIONS = 16
#: sweeps of retrain leg (b)'s in-process ``als_retrain`` (cut from 4)
RT_LOOP_SWEEPS = 2


def store_als_ratings(planted, small: bool = False):
    """(users, items, ratings, n_users, n_items) of store-als:
    ``STORE_ALS_NNZ`` planted ratings over every ML-20M user and item (400
    × 300 × 20,000 when ``small``)."""
    if small:
        n_users, n_items, nnz = 400, 300, 20_000
    else:
        n_users, n_items, nnz = ML20M["users"], ML20M["items"], STORE_ALS_NNZ
    users, items, ratings, _ = planted.planted_ratings(
        n_users=n_users, n_items=n_items, nnz=nnz, n_holdout=1000,
        cover=True)
    return users, items, ratings, n_users, n_items


def store_als_phase(dev, runtime, kernels, als, engine, planted, params_mod,
                    context, server_mod, small: bool = False, seed: int = 3):
    """ALS through the event store at ML-20M width: an app made as ``pio
    app new`` makes it; 250,000 planted ratings (seed 7) over all
    138,493 users and 26,744 items, every one rated, imported through
    ``import_interactions``, and each item's ``$set`` categories; then
    ``CoreWorkflow.run_train`` with the quickstart's params (``appName``;
    rank 128, 4 sweeps, 2 in bf16, λ 0.03) → ``load_models`` →
    ``PredictionServer`` → POST /queries.json. Checks: the store's triples
    are the planted ones, the decoded factors the trained ones bit for bit,
    every answer the plain top-k on them, the fit RMSE within the parity
    bound of the plain route's from the same initial state and within 1e-3
    of it, relative (each factor table's distance from the plain route's
    is reported), the train booked by ``PIO_PROFILE=1`` as one
    ``als_fused`` dispatch at ``train_flops`` with ``pio_mfu{phase=
    "train"}`` in (0, 1], and the fused
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
    from incubator_predictionio_tpu_torch.obs import profile
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
        # the training run under the device profiler (obs/profile.py)
        booked0 = profiled(profile, "als_fused")
        os.environ["PIO_PROFILE"] = "1"
        t0 = time.perf_counter()
        try:
            iid = CoreWorkflow.run_train(eng, ep, ctx=ctx)
        finally:
            os.environ.pop("PIO_PROFILE", None)
        train_s = time.perf_counter() - t0
        booked1 = profiled(profile, "als_fused")
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
    # the profiler booked the run as one als_fused dispatch, at
    # train_flops over the trees' observations
    want_flops = als.train_flops(als.tree_nnz(trees[0], trees[2]), n_users,
                                 n_items, rank, 4, 2)
    mfu_train = profile.MFU.labels(phase="train").value
    train_profile = {"dispatches": booked1[0] - booked0[0],
                     "device_s": booked1[1] - booked0[1],
                     "flops": booked1[2] - booked0[2],
                     "train_flops": want_flops, "mfu": mfu_train}
    if (train_profile["dispatches"] != 1
            or train_profile["flops"] != want_flops
            or not 0 < mfu_train <= 1):
        raise AssertionError(f"store-als: the profiler booked "
                             f"{train_profile}")
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
             "warm_sweeps_s": sweeps_s, "profile": train_profile}
    return (launches, err, stats, (trees[0], trees[1], trained, plain),
            sqlite_ref)


def store_seq_phase(dev, runtime, tr, fa, seq_engine, planted, params_mod,
                    context, server_mod, small: bool = False, seed: int = 3):
    """The sequence engine through the event store: 16 of the train
    phase's planted sessions of 8,193 items as ``view`` events (131,088) →
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
    n_sessions, batch = STORE_SEQ_SESSIONS, 8
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
           ("single", 0.002))
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
    # sorted, for membership by searchsorted (a repeat is harmless); not
    # np.unique: see n_distinct
    taken = np.sort(np.asarray(users, np.int64) * n_items
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
LOG_SINGLE_EVENTS = 500


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
    store-als's 250,000 planted ratings (one ``eventTime`` each, 1 ms
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
    continued instance, the ratings, the work and engine directories, the
    engine.json, the first train's fit); its wall is not the phase's.
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
    # the projection at store-als's cut size and the rehearsal's too
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
            # the child's first touch of the store-als-sized log opens it (the
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
                n_users=n_users, n_items=n_items, rank=rank, work=work,
                engine_dir=engine_dir, variant=variant,
                first_fit=first["fit_rmse"]))
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
    new``) holding store-als's 250,000 planted (user, item) pairs as
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


# -- remote: the main path across processes through pio storageserver -------

#: new users the remote phase posts through the separate event server, and
#: half-star ratings each (one native-leg body)
REMOTE_NEW_USERS, REMOTE_EVENTS_PER_USER = 32, 8
#: known users' queries to the deploy child
REMOTE_QUERIES = 32
#: seconds a new user may take to be answered from their fold-in
REMOTE_FOLD_DEADLINE_S = 30.0
#: the feedback leg: known users' queries to the feedback child, and the
#: seconds their predict events may take to be read back
FEEDBACK_QUERIES, FEEDBACK_DEADLINE_S = 64, 30.0
#: the prefix the feedback child puts before each shipped error line
FEEDBACK_LOG_PREFIX = "PIOLOG "


def feedback_leg(dev, kernels, uf_t, items_t, model, iid: str, key: str,
                 plain_base: str, fb, es_url: str, shipped: list,
                 small: bool = False) -> tuple:
    """The feedback leg of the remote phase on its ``pio deploy
    --feedback`` child ``fb`` (started with ``--log-url`` to the
    collector whose received bodies are ``shipped``):

    - 64 known users' queries (``num`` 10), each to the plain deploy child
      at ``plain_base`` and to the feedback child; every feedback answer a
      200 equal to the plain top-k on the instance's factors, through the
      object path (feedback turns the fast path off);
    - one malformed body: a 400, and exactly one line behind
      :data:`FEEDBACK_LOG_PREFIX` with a stack trace and the instance at
      the collector;
    - the 64 ``predict`` events of entityType ``pio_pr`` read back through
      the event server (``GET /events.json?accessKey=...&event=predict``,
      newest first) within 30 s, each with the instance id, its query and
      the answer it was served;
    - the feedback child's ``GET /``: ``feedbackEventsDropped`` 0, and on
      the card a score+top-k launch for each answer (its count read before
      the queries and after them).

    Records, without a gate, the HTTP p50/p99 of both children on the same
    queries and the seconds until the last event was read back.

    Returns (max score error, stats)."""
    t_leg = time.perf_counter()
    fport = int(fb.wait_line(r"deployed on http://[^:]+:(\d+)",
                             600).group(1))
    fbase = f"http://127.0.0.1:{fport}"
    ready_s = time.perf_counter() - t_leg
    rng = np.random.default_rng(31)
    inv_users = model.user_bimap.inverse
    n = 8 if small else FEEDBACK_QUERIES
    queries = [{"user": inv_users[int(r)], "num": 10} for r in
               rng.choice(len(model.user_bimap), n, replace=False)]
    err, served = 0.0, {}
    walls = {"plain": [], "feedback": []}
    # the child's launches before the leg (its warm-up's), read again after
    status, info = http_json("GET", f"{fbase}/")
    warm = info["kernelLaunches"].get("score_topk", 0)
    for k, doc in enumerate(queries):
        for name, url in (("plain", plain_base), ("feedback", fbase)):
            t0 = time.perf_counter()
            status, body = http_json("POST", f"{url}/queries.json", doc)
            walls[name].append(time.perf_counter() - t0)
            if status != 200:
                raise AssertionError(f"feedback: {name} child, query {doc}: "
                                     f"{status} {body}")
        err = max(err, check_answer(kernels, dev, uf_t, items_t, doc, None,
                                    body, f"feedback query {k}",
                                    model=model))
        served[doc["user"]] = body
    t_posted = time.perf_counter()
    status, body = http_json("POST", f"{fbase}/queries.json", {"bogus": 1})
    if status != 400:
        raise AssertionError(f"feedback: a malformed body got {status} "
                             f"{body}")
    events = []
    deadline = t_posted + FEEDBACK_DEADLINE_S
    while time.perf_counter() < deadline:
        status, got = http_json(
            "GET", f"{es_url}/events.json?accessKey={key}&event=predict"
                   f"&entityType=pio_pr&limit={n + 1}&reversed=true")
        events = got if status == 200 else []
        if len(events) >= n and shipped:
            break
        time.sleep(0.1)
    read_back_s = time.perf_counter() - t_posted
    if len(events) != n:
        raise AssertionError(f"feedback: {len(events)} predict events read "
                             f"back for {n} answers")
    for ev in events:
        props = ev["properties"]
        user = props["query"].get("user")
        if (ev["event"], ev["entityType"]) != ("predict", "pio_pr") or \
                props["engineInstanceId"] != iid or \
                props["query"] != {"user": user, "num": 10} or \
                props["prediction"] != served.get(user):
            raise AssertionError(f"feedback: predict event {ev!r:.500}")
    if len({ev["properties"]["query"]["user"] for ev in events}) != n:
        raise AssertionError("feedback: the predict events repeat a query")
    lines = [b for b in shipped if b.startswith(FEEDBACK_LOG_PREFIX)]
    if len(lines) != 1 or len(shipped) != 1:
        raise AssertionError(f"feedback: {len(shipped)} shipped lines, "
                             f"{len(lines)} behind the prefix")
    doc = json.loads(lines[0][len(FEEDBACK_LOG_PREFIX):])
    if doc["engineInstance"]["id"] != iid or \
            "Stack Trace" not in doc["message"]:
        raise AssertionError(f"feedback: shipped line {lines[0]!r:.500}")
    status, info = http_json("GET", f"{fbase}/")
    launches = info["kernelLaunches"].get("score_topk", 0) - warm
    if status != 200 or info["feedbackEventsDropped"] != 0 or (
            dev.type == "cuda" and launches < n):
        raise AssertionError(
            f"feedback: GET / {status}, dropped "
            f"{info.get('feedbackEventsDropped')}, score_topk launches "
            f"{launches} for {n} answers")
    stats = {
        "queries": n, "events_read_back": len(events),
        "shipped_lines": len(shipped), "dropped": 0,
        "score_topk_launches": launches,
        "http_ms": {name: {"p50": 1e3 * statistics.median(w),
                           "p99": 1e3 * sorted(w)[min(int(0.99 * len(w)),
                                                      len(w) - 1)]}
                    for name, w in walls.items()},
        "walls_s": {"ready_after_remote_s": ready_s,
                    "read_back_s": read_back_s}}
    return fport, err, stats


def metrics_histogram(text: str, name: str, labels: str) -> tuple:
    """(bucket bounds, per-bucket counts with +Inf last) of one histogram
    series of a Prometheus text exposition; ``labels`` its label pairs
    before ``le``, as exposed."""
    pat = re.compile(re.escape(name) + r"_bucket\{" + re.escape(labels)
                     + r',le="([^"]+)"\} (\d+)')
    bounds, cum = [], []
    for m in pat.finditer(text):
        if m.group(1) != "+Inf":
            bounds.append(float(m.group(1)))
        cum.append(int(m.group(2)))
    counts = [c - p for c, p in zip(cum, [0] + cum[:-1])]
    return bounds, counts


def remote_phase(dev, runtime, kernels, als, ak, log: dict,
                 small: bool = False, control=None) -> tuple:
    """The README main path across four processes on the cpplog phase's
    store (``log``: its app, key, engine directory and continued
    instance), after the speed phase, whose servers are stopped:

    1. the recommendation data source's read (``rate`` + ``buy``) of the
       log in this process, then the log closed (``Storage.reset()``): a
       log is never open in two live processes;
    2. ``pio storageserver --ip 127.0.0.1 --port 0`` as a child in routed
       mode on the phase's stores (metadata SQLite, events the log, models
       localfs), its port from its announcement; ``GET /`` names the three
       sources;
    3. from here on this process and every other child reach metadata and
       events only through it (``PIO_STORAGE_SOURCES_SHARED_TYPE=remote``);
       models stay on the shared localfs directory, since a rank-128
       ML-20M model (~84.6 MB) is above the storage server's 64 MiB cap on
       a request body (``utils/http.MAX_BODY_BYTES``);
    4. the same read through the wire (``RemoteEvents.scan_interactions``),
       equal to the local one byte for byte;
    5. ``pio eventserver`` as a child over ``remote``;
    6. ``pio train`` in this process over ``remote``: it continues from
       the latest COMPLETED instance (``mode=continue``), the fused and
       R-row kernels launch, its model holds every user and item of the
       read, and its fit RMSE is within the retrain rule (1.15 × + 0.02)
       of the cpplog phase's first train;
    7. ``pio deploy`` as a child over ``remote`` with the speed layer on
       (``PIO_SPEED_POLL_S`` 1): 32 known users' answers against the plain
       top-k on the instance's decoded factors; a second ``pio deploy``
       child, started with it, runs the feedback loop (``--feedback`` to
       the event server child, ``--log-url`` to a collector in this
       process, the speed layer off);
    8. 32 new users × 8 half-star ratings in one body to the event server
       child's native batch leg; ``/queries.json`` polled until each is
       answered from its fold-in (30 s deadline); each answer against the
       top-k of the fused kernel's fold-in of the posted ratings computed
       here (scores rtol 1e-5), that fold-in held to the plain fold-in
       (:func:`hold_foldin`), and the answer to the plain top-k of the
       plain fold-in within its near-tie band (rtol 1e-3);
       ``pio_freshness_seconds`` p95 from the deploy child's ``/metrics``;
    9. the deploy child's ``GET /`` ``kernelLaunches``: the fused entry
       above 0 (the fold-ins), score+top-k at least once a query answered;
       then the feedback leg (:func:`feedback_leg`) on the feedback child,
       which is undeployed after it;
    10. ``pio undeploy``, SIGTERM to the event and storage servers: every
        child exits 0.

    ``control`` (the ``control`` phase, :func:`control_phase`) adds a
    second ``pio deploy`` child at step 7, started with the first, and is
    called before step 10 with the fleet (both deploys, the stores, the
    continued instance); what it returns is the stats' ``control``.

    Returns (launches by kernel, max score error, stats)."""
    from incubator_predictionio_tpu_torch.data.storage import (
        Storage,
        remote,
    )
    from incubator_predictionio_tpu_torch.data.storage import base as sbase
    from incubator_predictionio_tpu_torch.data.store import EventStore
    from incubator_predictionio_tpu_torch.models.recommendation import (
        engine,
    )
    from incubator_predictionio_tpu_torch.parallel.context import (
        RuntimeContext,
    )
    from incubator_predictionio_tpu_torch.speed import foldin
    from incubator_predictionio_tpu_torch.utils.http import (
        HttpServer,
        Request,
        Response,
        Router,
    )
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    t_phase = time.perf_counter()
    name, key, work = log["name"], log["key"], log["work"]
    dsp = engine.DataSourceParams(app_name=name)

    def read():
        t0 = time.perf_counter()
        got = EventStore.interactions(
            app_name=name, entity_type="user", target_entity_type="item",
            event_names=("rate", "buy"), value_prop="rating",
            event_values={"buy": dsp.buy_rating})
        return got, time.perf_counter() - t0

    stats: dict = {}
    walls: dict = {}
    children = []
    saved = {k: v for k, v in os.environ.items()
             if k.startswith("PIO_STORAGE_") or k == "PIO_SPEED_POLL_S"}
    cwd = os.getcwd()
    collector = None
    try:
        # -- 1. the local read, then the log closed ------------------------
        local, walls["local_read_s"] = read()
        Storage.reset()

        # -- 2. pio storageserver, routed ----------------------------------
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
        t0 = time.perf_counter()
        ss = Child("storageserver", ["storageserver", "--ip", "127.0.0.1",
                                     "--port", "0"], work, env)
        children.append(ss)
        store_url = "http://127.0.0.1:%d" % int(ss.wait_line(
            r"Storage Server running on http://[^:]+:(\d+)", 120).group(1))
        status, info = http_json("GET", f"{store_url}/")
        want = {"METADATA": "SQL", "EVENTDATA": "LOG", "MODELDATA": "FS"}
        if status != 200 or info.get("repositories") != want:
            raise AssertionError(f"remote: storage server GET / {status} "
                                 f"{info}")
        walls["server_up_s"] = time.perf_counter() - t0

        # -- 3. metadata and events through it from here on ---------------
        os.environ.update({
            "PIO_STORAGE_SOURCES_SHARED_TYPE": "remote",
            "PIO_STORAGE_SOURCES_SHARED_URL": store_url,
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SHARED",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SHARED"})
        Storage.reset()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
        env["PIO_SPEED_POLL_S"] = "1"
        es = Child("eventserver-remote", [
            "eventserver", "--ip", "127.0.0.1", "--port", "0",
            "--batch-cap", "500"], work, env)
        children.append(es)

        # -- 4. the read through the wire ----------------------------------
        if not isinstance(Storage.get_events(), remote.RemoteEvents):
            raise AssertionError("remote: events are not on the wire")
        wired, walls["wire_read_s"] = read()
        if not same_interactions(local, wired) or len(wired) != len(local):
            raise AssertionError(f"remote: the read through the wire "
                                 f"({len(wired)} rows) differs from the "
                                 f"local read ({len(local)} rows)")
        stats["read"] = {"rows": len(local), "users": len(local.user_ids),
                         "items": len(local.item_ids)}

        # -- 6. pio train over remote: it continues ------------------------
        os.chdir(log["engine_dir"])
        try:
            with LogLines("incubator_predictionio_tpu_torch.models."
                          "recommendation.engine") as lines:
                runtime.reset_launch_counts()
                sync(dev)
                t0 = time.perf_counter()
                out = cli("train")
                sync(dev)
                walls["train_s"] = time.perf_counter() - t0
                counts = runtime.launch_counts()
        finally:
            os.chdir(cwd)
        iid = re.search(r"Engine instance ID: (\S+)", out).group(1)
        said = [m for m in map(re.compile(
            r"ALS continuation retrain: .* (\d+) sweeps \(mode=(\w+), "
            r"delta=(\S+)\)").search, lines) if m]
        if len(said) != 1 or said[0].group(2) != "continue":
            raise AssertionError(f"remote: pio train logged {lines}")
        conf = Storage.get_meta_data_engine_instances().get(iid).runtime_conf
        phases = {k: float(v) for k, v in conf.items()
                  if k.startswith("phase.")}
        if "phase.continue_seed_s" not in phases:
            raise AssertionError("remote: no continue_seed phase")
        train_launches = {e: counts[e] for e in ROUTE_ENTRY.values()}
        if dev.type == "cuda" and (
                train_launches["als_fused_solve_cg"] <= 0
                or train_launches["als_solve_cg_rows8"] <= 0):
            raise AssertionError(f"remote: pio train launched "
                                 f"{train_launches}")
        model = CoreWorkflow.load_models(iid)[0]
        if (len(model.user_bimap), len(model.item_bimap)) != (
                len(local.user_ids), len(local.item_ids)):
            raise AssertionError(
                f"remote: the model holds {len(model.user_bimap)} × "
                f"{len(model.item_bimap)}, the read "
                f"{len(local.user_ids)} × {len(local.item_ids)}")
        ctx = RuntimeContext(device=dev)
        pd = engine.RecommendationPreparator().prepare(
            ctx, engine.TrainingData(interactions=wired))
        uf_t = torch.as_tensor(model.user_factors).to(dev)
        items_t = torch.as_tensor(model.item_factors).to(dev)
        # the read's rows to the model's (a continued model keeps the
        # previous instance's ids first)
        u_map, i_map = (np.array([bm[pm.inverse[k]] for k in range(len(pm))],
                                 np.int64)
                        for bm, pm in ((model.user_bimap, pd.user_bimap),
                                       (model.item_bimap, pd.item_bimap)))
        fit = als.rmse(als.ALSState(user_factors=uf_t, item_factors=items_t),
                       u_map[pd.users], i_map[pd.items], pd.ratings)
        bound = 1.15 * log["first_fit"] + 0.02
        if not fit <= bound:
            raise AssertionError(f"remote: fit RMSE {fit!r} above "
                                 f"{bound!r} (the first train's "
                                 f"{log['first_fit']!r})")
        stats["train"] = {"instance": iid, "phases_s": phases,
                          "sweeps_used": int(said[0].group(1)),
                          "launches": train_launches, "fit_rmse": fit,
                          "fit_bound": bound}

        # -- 7. pio deploy over remote, the speed layer on -----------------
        es_port = int(es.wait_line(r"running on http://[^:]+:(\d+)",
                                   120).group(1))
        es_url = f"http://127.0.0.1:{es_port}"
        shipped: list = []
        router = Router()

        @router.post("/collect")
        def collect(request: Request) -> Response:
            shipped.append(request.body.decode())
            return Response(200, {})

        collector = HttpServer(router, "127.0.0.1", 0)
        collector_port = collector.start_background()
        t_dep = time.perf_counter()
        dep = Child("deploy-remote", ["deploy", "--variant", log["variant"],
                                      "--ip", "127.0.0.1", "--port", "0"],
                    work, env, cwd=log["engine_dir"])
        children.append(dep)
        # the feedback leg's child, started with the first so that their
        # start-ups overlap; its speed layer is off, so the fold-ins of
        # step 8 stay the first child's alone
        fb = Child("deploy-feedback", [
            "deploy", "--variant", log["variant"], "--ip", "127.0.0.1",
            "--port", "0", "--feedback", "--event-server-ip", "127.0.0.1",
            "--event-server-port", str(es_port), "--accesskey", key,
            "--log-url", f"http://127.0.0.1:{collector_port}/collect",
            "--log-prefix", FEEDBACK_LOG_PREFIX],
            work, dict(env, PIO_SPEED_LAYER="0"), cwd=log["engine_dir"])
        children.append(fb)
        deps = [dep]
        if control is not None:
            # the control phase's second worker, started with the first
            deps.append(Child(
                "deploy-remote-2", ["deploy", "--variant", log["variant"],
                                    "--ip", "127.0.0.1", "--port", "0"],
                work, env, cwd=log["engine_dir"]))
            children.append(deps[-1])
        port = int(dep.wait_line(r"deployed on http://[^:]+:(\d+)",
                                 600).group(1))
        base = f"http://127.0.0.1:{port}"
        rng = np.random.default_rng(29)
        inv_users = model.user_bimap.inverse
        inv_items = model.item_bimap.inverse
        n_queries = 8 if small else REMOTE_QUERIES
        queries = [{"user": inv_users[int(r)], "num": 10} for r in
                   rng.choice(len(model.user_bimap), n_queries,
                              replace=False)]
        err, q_walls = 0.0, []
        for k, doc in enumerate(queries):
            t1 = time.perf_counter()
            status, body = http_json("POST", f"{base}/queries.json", doc)
            q_walls.append(time.perf_counter() - t1)
            if status != 200:
                raise AssertionError(f"remote: query {doc}: {status} {body}")
            if k == 0:
                walls["deploy_to_first_answer_s"] = (time.perf_counter()
                                                     - t_dep)
            err = max(err, check_answer(kernels, dev, uf_t, items_t, doc,
                                        None, body, f"remote query {k}",
                                        model=model))

        # -- 8. new users through the separate event server ----------------
        n_new = 4 if small else REMOTE_NEW_USERS
        n_items = len(model.item_bimap)
        posted, docs = {}, []
        for j in range(n_new):
            uid = f"remote-new-{j}"
            its = rng.choice(n_items, REMOTE_EVENTS_PER_USER,
                             replace=False).astype(np.int32)
            rs = (rng.integers(1, 11, len(its)) / 2.0).astype(np.float32)
            posted[uid] = (its, rs)
            docs += [rating_doc(uid, inv_items[int(i)], float(r))
                     for i, r in zip(its, rs)]
        body = json.dumps(docs).encode()
        if sbase.uniform_interactions_from_body(body, 500) is None:
            raise AssertionError("remote: the new users' body left the "
                                 "native leg")
        t_post = time.perf_counter()
        status, got = http_json(
            "POST", f"{es_url}/batch/events.json?accessKey={key}", body)
        if status != 200 or any(g.get("status") != 201 for g in got):
            raise AssertionError(f"remote: the new users' body got "
                                 f"{status} {got!r:.300}")
        answers: dict = {}
        deadline = t_post + REMOTE_FOLD_DEADLINE_S
        while len(answers) < n_new and time.perf_counter() < deadline:
            for uid in posted:
                if uid in answers:
                    continue
                doc = {"user": uid, "num": 10}
                status, body = http_json("POST", f"{base}/queries.json", doc)
                if status != 200:
                    raise AssertionError(f"remote: {uid}: {status} {body}")
                if body["itemScores"]:
                    answers[uid] = (doc, body)
            time.sleep(0.05)
        walls["all_folded_s"] = time.perf_counter() - t_post
        if len(answers) < n_new:
            raise AssertionError(f"remote: {n_new - len(answers)} of "
                                 f"{n_new} new users unanswered after "
                                 f"{REMOTE_FOLD_DEADLINE_S} s")
        keys = sorted(posted)
        rows = [posted[u] for u in keys]
        with open(log["variant"]) as f:
            l2 = float(json.load(f)["algorithms"][0]["params"]["lambda"])
        got_v = foldin.FoldInSolver(items_t, l2=l2).solve(rows)
        ref_v = foldin.FoldInSolver(items_t.cpu(), l2=l2).solve(rows)
        stats["foldin_vs_plain"] = hold_foldin(
            ak, als, items_t, rows, got_v, ref_v, l2, False, 1.0,
            "remote: the new users' fold-ins")
        items_cpu = items_t.cpu()
        for r, uid in enumerate(keys):
            doc, body = answers[uid]
            err = max(err, check_vec_answer(
                kernels, dev, got_v[r], items_t, None, doc, body,
                f"remote: {uid}'s answer", model))
            ref_s, ref_i = kernels.score_topk_plain(
                torch.from_numpy(ref_v[r:r + 1]), items_cpu, None,
                doc["num"] + 1)
            check_topk(np.array([[x["score"] for x in body["itemScores"]]]),
                       np.array([[model.item_bimap[x["item"]]
                                  for x in body["itemScores"]]]),
                       ref_s.numpy(), ref_i.numpy(), doc["num"],
                       f"remote: {uid}'s answer against the plain "
                       "fold-in", rtol=1e-3)
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as resp:
            text = resp.read().decode()
        bounds, hist = metrics_histogram(text, "pio_freshness_seconds",
                                         'engine="recommendation"')
        stats["freshness"] = {
            "observations": sum(hist),
            "p50_s": hist_quantile(bounds, hist, 0.5),
            "p95_s": hist_quantile(bounds, hist, 0.95)}
        if sum(hist) < n_new:
            raise AssertionError(f"remote: {sum(hist)} freshness "
                                 f"observations for {n_new} new users")

        # -- 9. the deploy child's launches --------------------------------
        status, info = http_json("GET", f"{base}/")
        served = info["kernelLaunches"]
        launches = dict(train_launches)
        launches["score_topk"] = served.get("score_topk", 0)
        launches["foldin"] = served.get("als_fused_solve_cg", 0)
        n_answered = len(queries) + len(answers)
        if status != 200 or info["engineInstanceId"] != iid or (
                dev.type == "cuda" and (launches["foldin"] <= 0 or
                                        launches["score_topk"]
                                        < n_answered)):
            raise AssertionError(f"remote: GET / {status}, launches "
                                 f"{served}, {n_answered} answers")
        stats["launches"] = launches

        # -- 9b. the feedback leg, its child stopped before control --------
        t_fb = time.perf_counter()
        fport, fb_err, stats["feedback"] = feedback_leg(
            dev, kernels, uf_t, items_t, model, iid, key, base, fb, es_url,
            shipped, small)
        err = max(err, fb_err)
        cli("undeploy", "--ip", "127.0.0.1", "--port", str(fport))
        fb.wait_exit()
        walls["feedback_leg_s"] = time.perf_counter() - t_fb

        if control is not None:
            ports = [port] + [int(d.wait_line(
                r"deployed on http://[^:]+:(\d+)", 600).group(1))
                for d in deps[1:]]
            stats["control"] = control(dict(
                log, ports=ports, instance=iid, model=model, read=read,
                env=env))

        # -- 10. every child stops with exit 0 -----------------------------
        for d, p in zip(deps, ports if control is not None else [port]):
            cli("undeploy", "--ip", "127.0.0.1", "--port", str(p))
            d.wait_exit()
        for child in (es, ss):
            child.proc.send_signal(signal.SIGTERM)
            child.wait_exit()
        stats["queries"] = {"known": len(queries), "new": len(answers),
                            "http_p50_ms": 1e3 * statistics.median(q_walls)}
    finally:
        os.chdir(cwd)
        for child in children:
            child.kill()
        if collector is not None:
            collector.stop()
        for k in [k for k in os.environ
                  if k.startswith("PIO_STORAGE_") or k == "PIO_SPEED_POLL_S"]:
            del os.environ[k]
        os.environ.update(saved)
        Storage.reset()
    walls["wall_s"] = time.perf_counter() - t_phase
    stats["walls_s"] = walls
    return launches, err, stats


#: closed-loop keep-alive client of the control phase, standard library
#: only, run as ``python -c CONTROL_CLIENT <config JSON>``: ``threads``
#: clients POST ``{"user": <id>, "num": num}`` for random ids of the
#: ``users`` file until the ``stop`` file exists, and write one record
#: per answer to ``out``: [time.monotonic() at the request, status,
#: seconds, user, body of a 200 or None].
CONTROL_CLIENT = r'''
import http.client, json, os, random, sys, threading, time
cfg = json.loads(sys.argv[1])
with open(cfg["users"]) as f:
    users = json.load(f)
records, lock = [], threading.Lock()

def client(tid):
    rng = random.Random(cfg["seed"] * 100003 + tid)
    conn = http.client.HTTPConnection("127.0.0.1", cfg["port"], timeout=120)
    mine = []
    while not os.path.exists(cfg["stop"]):
        user = rng.choice(users)
        body = json.dumps({"user": user, "num": cfg["num"]})
        t_at, t0 = time.monotonic(), time.perf_counter()
        try:
            conn.request("POST", "/queries.json", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            status = resp.status
        except (OSError, http.client.HTTPException):
            conn.close()
            conn = http.client.HTTPConnection("127.0.0.1", cfg["port"],
                                              timeout=120)
            status, data = -1, b""
        mine.append([t_at, status, time.perf_counter() - t0, user,
                     data.decode() if status == 200 else None])
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

#: the control phase's clients through the front door: the freshness leg
#: (across the rolling reload) and the knob leg, in that many processes
CONTROL_CLIENTS = (12, 32)
CONTROL_CLIENT_PROCS = (2, 4)
#: the controllers' cadence and gates on the card, through their own env
#: settings (obs/controller.py ControllerConfig, obs/knobs.py KnobConfig)
CONTROL_ENV = {
    "PIO_CONTROLLER_INTERVAL_S": "0.5",
    "PIO_CONTROLLER_HYSTERESIS": "2",
    "PIO_CONTROLLER_COOLDOWN_S": "600",
    "PIO_KNOBS_INTERVAL_S": "0.5",
    "PIO_KNOBS_HYSTERESIS": "2",
    "PIO_KNOBS_COOLDOWN_S": "30",
    "PIO_KNOBS_WINDOW_S": "2",
}
#: the knobs the phase's controller registers (obs/knobs.py names)
CONTROL_KNOBS = ("max_batch", "max_wait_ms", "shed", "foldin_budget")
#: the knob leg's planted serve objective (seconds), far below any answer
#: through the door: the controller steps the scheduler family down
CONTROL_SERVE_OBJECTIVE_S = 1e-4
#: the served instance's least age (seconds) before the staleness bound is
#: planted one second below it
CONTROL_MIN_AGE_S = 12.0
#: seconds the controllers get for each awaited event
CONTROL_DEADLINE_S = 180.0
#: answers through the door checked against the new instance's top-k
CONTROL_CHECKED = 16
#: fault 3's fold-in (ROADMAP Queue 3): rows of one width, one implicit
#: launch of the fused kernel (``PIO_SPEED_WIDTHS``/``PIO_SPEED_MAX_BATCH``)
STREAM_ROWS = 8192
STREAM_WIDTH = 2048
STREAM_TRIALS = 3
#: a dispatch beside that fold-in books below this share of its seconds
#: (on an H100, scripts/stream_isolation_ab.py: 0.23-0.29 of them with
#: every thread on the one default stream, 0.01-0.02 on streams of their
#: own)
STREAM_SHARE = 0.1


class ControlClients:
    """:data:`CONTROL_CLIENT` processes through ``port`` until
    :meth:`stop`; ``records`` then holds every answer."""

    def __init__(self, port: int, users: list, clients: int, procs: int,
                 work: str, seed: int, num: int = 10):
        self.stop_path = os.path.join(work, f"control-stop-{seed}")
        users_path = os.path.join(work, f"control-users-{seed}.json")
        with open(users_path, "w") as f:
            json.dump(users, f)
        self.children = []
        for p in range(procs):
            out = os.path.join(work, f"control-{seed}-{p}.json")
            cfg = dict(port=port, users=users_path, num=num,
                       threads=clients // procs + (p < clients % procs),
                       seed=seed * 64 + p, stop=self.stop_path, out=out)
            self.children.append((out, subprocess.Popen(
                [sys.executable, "-c", CONTROL_CLIENT, json.dumps(cfg)])))
        self.records: list = []

    def stop(self) -> list:
        with open(self.stop_path, "w"):
            pass
        for out, proc in self.children:
            if proc.wait(120) != 0:
                raise AssertionError(f"control: a client process exited "
                                     f"{proc.returncode}")
            with open(out) as f:
                self.records += json.load(f)
        self.children = []
        return self.records

    def kill(self) -> None:
        for _out, proc in self.children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def latency_ms(records: list, lo: float = -1e18, hi: float = 1e18) -> dict:
    """Answers, p50 and p99 (ms) of the records started in [lo, hi)."""
    walls = sorted(r[2] for r in records if lo <= r[0] < hi)
    if not walls:
        return {"answers": 0, "p50_ms": None, "p99_ms": None}
    return {"answers": len(walls),
            "p50_ms": 1e3 * walls[len(walls) // 2],
            "p99_ms": 1e3 * walls[min(int(0.99 * len(walls)),
                                      len(walls) - 1)]}


def gauge_value(text: str, name: str):
    """The first sample of an unlabeled gauge in an exposition (None)."""
    m = re.search(r"^" + re.escape(name) + r" (\S+)$", text, re.MULTILINE)
    return float(m.group(1)) if m else None


def plain_histogram(text: str, name: str) -> dict:
    """{upper bound: cumulative count} of an unlabeled histogram."""
    return {float(b.replace("+Inf", "inf")): int(c) for b, c in re.findall(
        re.escape(name) + r'_bucket\{le="([^"]+)"\} (\d+)', text)}


def batch_widths(before: dict, after: dict) -> dict:
    """The fused batches between two scrapes of ``pio_serve_batch_size``:
    how many, their mean bucket, and the largest bucket that grew."""
    bounds = sorted(after)
    counts, prev_a, prev_b = {}, 0, 0
    for ub in bounds:
        counts[ub] = (after[ub] - prev_a) - (before.get(ub, 0) - prev_b)
        prev_a, prev_b = after[ub], before.get(ub, 0)
    n = sum(counts.values())
    return {"batches": n,
            "max_le": max((ub for ub, c in counts.items() if c > 0),
                          default=None),
            "mean_le": (sum(ub * c for ub, c in counts.items()
                            if ub != float("inf")) / n if n else None)}


def worker_state(base: str) -> dict:
    """One worker's ``GET /`` and ``/metrics`` as the phase reads them."""
    status, info = http_json("GET", f"{base}/")
    if status != 200:
        raise AssertionError(f"control: {base} GET / answered {status}")
    with urllib.request.urlopen(f"{base}/metrics", timeout=60) as resp:
        text = resp.read().decode()
    return {"instance": info["engineInstanceId"],
            "cap": info["scheduler"]["cap"],
            "launches": info["kernelLaunches"],
            "staleness_s": gauge_value(text, "pio_model_staleness_seconds"),
            "batches": plain_histogram(text, "pio_serve_batch_size")}


def wait_for(what: str, fn, deadline_s: float = CONTROL_DEADLINE_S,
             period: float = 0.02):
    """Poll ``fn`` until it returns something true; raise after
    ``deadline_s``."""
    end = time.monotonic() + deadline_s
    while True:
        got = fn()
        if got:
            return got
        if time.monotonic() > end:
            raise AssertionError(f"control: no {what} within "
                                 f"{deadline_s:.0f} s")
        time.sleep(period)


def stream_isolation(dev, runtime, server_mod, engine, params_mod, convert,
                     uf: np.ndarray, items: np.ndarray,
                     rows: int = STREAM_ROWS, width: int = STREAM_WIDTH,
                     trials: int = STREAM_TRIALS) -> dict:
    """ROADMAP Queue 3 fault 3's pin: ``pio_device_seconds`` of a dispatch
    are its own. ``PIO_PROFILE=1``; an in-process server (the scheduler
    on, one dispatcher) over ``uf`` × ``items``; a long-lived fold-in
    thread, as the overlay's poller is, folds ``rows`` implicit rows of
    ``width`` in one launch of the fused kernel (the budget knob
    ``PIO_SPEED_MAX_BATCH`` at ``rows``). The moment that launch is
    counted, one query through the server:

    - ``excludeSeen`` of a user with no seen list: the object path,
      whose dispatch copies nothing to the card before its ``serve_topk``
      stamp. It must book below :data:`STREAM_SHARE` of the fold-in's
      ``foldin_solve`` seconds. On one stream shared by both threads its
      event waits behind the fold-in kernel and books most of it.
    - a plain query: the fast path, whose row ids cross to the card
      before its ``serve_topk_batch`` stamp. On a shared stream that copy
      waits behind the fold-in, so the wait lands in the query's wall,
      not in its booking. Reported, not checked.

    Returns each trial's seconds by query kind."""
    import concurrent.futures

    from incubator_predictionio_tpu_torch.obs import profile
    from incubator_predictionio_tpu_torch.speed import foldin

    n_users, n_items = uf.shape[0], items.shape[0]
    model = convert.als_model_from_numpy(
        uf, items, [f"u{i}" for i in range(n_users)],
        [f"i{i}" for i in range(n_items)], device=dev)
    eng = engine.RecommendationEngine().apply()
    ep = params_mod.EngineParams(algorithm_params_list=[
        ("als", engine.ALSAlgorithmParams(rank=uf.shape[1]))])
    env = {"PIO_PROFILE": "1", "PIO_SPEED_WIDTHS": str(width),
           "PIO_SPEED_MAX_BATCH": str(rows)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    rng = np.random.default_rng(37)
    cols = rng.integers(0, n_items, (rows, width)).astype(np.int32)
    vals = rng.random((rows, width), dtype=np.float32)
    fold_rows = [(cols[r], vals[r]) for r in range(rows)]
    srv = server_mod.PredictionServer(
        eng, ep, [model], device=dev,
        config=server_mod.ServerConfig(ip="127.0.0.1", port=0,
                                       micro_batch=64, serve_workers=1))
    poller = concurrent.futures.ThreadPoolExecutor(
        1, thread_name_prefix="pio-stream-check-foldin")
    kinds = {"object": ("serve_topk", {"excludeSeen": True}),
             "fast": ("serve_topk_batch", {})}
    out: dict = {kind: [] for kind in kinds}
    try:
        port = srv.start_background()
        solver = foldin.FoldInSolver(model.item_factors, l2=0.03,
                                     implicit=True, alpha=1.0)
        poller.submit(solver.solve, fold_rows).result()  # warm, untimed
        for _op, extra in kinds.values():
            post(port, {"user": "u3", "num": 10, **extra})
        seconds = profile.DEVICE_SECONDS
        for t in range(trials):
            for kind, (op, extra) in kinds.items():
                serve0 = seconds.labels(op=op).value
                fold0 = seconds.labels(op="foldin_solve").value
                n0 = runtime.launch_counts()["als_fused_solve_cg"]
                t0 = time.perf_counter()
                fut = poller.submit(solver.solve, fold_rows)
                while runtime.launch_counts()["als_fused_solve_cg"] == n0 \
                        and not fut.done():
                    time.sleep(0.0002)
                queued_s = time.perf_counter() - t0
                t_q = time.perf_counter()
                post(port, {"user": f"u{t}", "num": 10, **extra})
                query_s = time.perf_counter() - t_q
                fut.result()
                out[kind].append({
                    "serve_s": seconds.labels(op=op).value - serve0,
                    "foldin_s": seconds.labels(op="foldin_solve").value
                    - fold0,
                    "foldin_wall_s": time.perf_counter() - t0,
                    "launched_after_s": queued_s, "query_wall_s": query_s})
    finally:
        poller.shutdown()
        srv.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    bad = [r for r in out["object"]
           if not r["serve_s"] < STREAM_SHARE * r["foldin_s"]]
    if bad:
        raise AssertionError(
            f"fault 3: {len(bad)} of {trials} dispatches beside a fold-in "
            f"booked serve_topk seconds above {STREAM_SHARE} of the "
            f"fold-in's foldin_solve seconds, their wait covering the "
            f"fold-in's work: {json.dumps(out)}")
    return {"rows": rows, "width": width, "trials": out}


def control_phase(dev, runtime, kernels, als, server_mod, engine,
                  params_mod, convert, fleet: dict) -> tuple:
    """The control plane on the ``remote`` phase's fleet (``fleet``: two
    ``pio deploy`` children over the storage server, the continued
    instance, its engine directory): in this process a ``FrontDoor``
    over both workers and an ``AdminServer`` (port 0) hosting a
    ``FreshnessController`` (``workflow_retrain_fn``: the continuation
    retrain on the phase's store; ``http_reload_fn`` at the door's
    ``/reload``) and a ``KnobController`` (``http_knobs_fn`` at the
    door's ``/knobs``), ``PIO_FLEET_TARGETS`` naming both workers, the
    cadence and gates from :data:`CONTROL_ENV`.

    1. Freshness, mode ``act``, under :data:`CONTROL_CLIENTS` [0]
       clients through the door: ``PIO_SLO_STALENESS_S`` planted one
       second below the instance's age; at the hysteresis count one
       decision retrains (the fused and R-row kernels launch here, a new
       COMPLETED instance, its fit within 1.15 × + 0.02 of the first
       train's) and reloads (the door's rolling reload: both workers, no
       drop); every answer a 200; each worker then names the new
       instance, its staleness under the bound, and
       :data:`CONTROL_CHECKED` answers through the door equal the plain
       top-k of the new factors; an evaluation in the cooldown holds
       fire (``pio_controller_skips_total{reason="cooldown"}``); ``GET
       /controller`` and an incident bundle (``POST /incident``) show
       the decision with its outcome and trace id.
    2. Knobs, mode ``act`` (``POST /knobs``), under
       :data:`CONTROL_CLIENTS` [1] clients, the serve objective planted
       at :data:`CONTROL_SERVE_OBJECTIVE_S`: one step on the scheduler
       family fans out to both workers (each answers its applied vector
       and its scheduler's new values); the breach that the recorder's
       SLO evaluation raises inside the step's cooldown rolls the vector
       back (``pio_knob_rollbacks_total`` 1); between step and rollback
       no worker fuses a batch above the new cap and each one's
       score+top-k launches rise; a vector naming an unknown variable is
       refused by each worker (400) and applied by none.
    3. The kill switch: ``POST /controller {"mode": "off"}`` stops the
       evaluations, ``observe`` on both records decisions that act on
       nothing; a bad mode is a 400.
    4. On the card, fault 3's pin (:func:`stream_isolation`) on the new
       instance's factors.

    Returns ({"als_fused_solve_cg", "als_solve_cg_rows8"} of the retrain
    and the workers' {"score_topk", "foldin"} launches, max score error,
    stats)."""
    from incubator_predictionio_tpu_torch.cli import commands
    from incubator_predictionio_tpu_torch.core.params import WorkflowParams
    from incubator_predictionio_tpu_torch.data.storage import Storage
    from incubator_predictionio_tpu_torch.obs import (
        controller as obs_controller,
    )
    from incubator_predictionio_tpu_torch.obs import federate
    from incubator_predictionio_tpu_torch.obs import knobs as obs_knobs
    from incubator_predictionio_tpu_torch.obs import recorder
    from incubator_predictionio_tpu_torch.obs import slo as obs_slo
    from incubator_predictionio_tpu_torch.parallel.context import (
        RuntimeContext,
    )
    from incubator_predictionio_tpu_torch.servers.admin import AdminServer
    from incubator_predictionio_tpu_torch.serving.frontdoor import (
        FrontDoor,
        FrontDoorConfig,
    )
    from incubator_predictionio_tpu_torch.utils.times import (
        ensure_aware,
        now_utc,
    )
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    t_phase = time.perf_counter()
    work = fleet["work"]
    bases = [f"http://127.0.0.1:{p}" for p in fleet["ports"]]
    stats: dict = {}
    walls: dict = {}
    instances = Storage.get_meta_data_engine_instances()
    old_iid = fleet["instance"]
    age0 = (now_utc() - ensure_aware(instances.get(old_iid).end_time)
            ).total_seconds()
    if age0 < CONTROL_MIN_AGE_S:
        time.sleep(CONTROL_MIN_AGE_S - age0)
        age0 = CONTROL_MIN_AGE_S
    bound = round(age0 - 1.0, 3)
    incidents = tempfile.mkdtemp(prefix="pio-control-incidents-")
    env = dict(CONTROL_ENV,
               PIO_FLEET_TARGETS=",".join(
                   f"w{i}=127.0.0.1:{p}" for i, p in enumerate(
                       fleet["ports"])),
               PIO_SLO_STALENESS_S=str(bound),
               PIO_SLO_SERVE_P99_S=str(CONTROL_SERVE_OBJECTIVE_S),
               PIO_RECORDER_HZ="5", PIO_INCIDENT_DIR=incidents,
               PIO_CONTROLLER="act")
    saved = {k: os.environ.get(k) for k in (*env, "PIO_KNOBS")}
    os.environ.update(env)
    os.environ.pop("PIO_KNOBS", None)  # the knob loop starts off

    def reset_planes():
        federate.reset_fleet_engine()
        obs_slo.reset_engine()
        recorder.reset_recorder()
        obs_controller.reset_controller()
        obs_knobs.reset_knob_controller()

    reset_planes()
    with open(fleet["variant"]) as f:
        variant = json.load(f)
    eng, ep = commands.engine_from_variant(variant)
    retrain = obs_controller.workflow_retrain_fn(
        eng, ep,
        engine_id=commands.engine_id_for_variant_path(fleet["variant"],
                                                      variant),
        engine_version=variant.get("version", "NOT_VERSIONED"),
        engine_variant=variant.get("id", "default"),
        engine_factory=variant.get("engineFactory", ""),
        params=WorkflowParams(runtime_conf={"seed": "0"}), device=dev)
    old_model = fleet["model"]
    users = [old_model.user_bimap.inverse[int(r)] for r in
             np.random.default_rng(41).choice(
                 len(old_model.user_bimap),
                 min(4096, len(old_model.user_bimap)), replace=False)]
    start = {b: worker_state(b) for b in bases}
    door = admin = clients = None
    err = 0.0
    try:
        door = FrontDoor([("127.0.0.1", p) for p in fleet["ports"]],
                         FrontDoorConfig(probe_interval_s=0.25))
        door_url = "http://127.0.0.1:%d" % door.start_background()
        ctl = obs_controller.FreshnessController(
            retrain_fn=retrain,
            reload_fn=obs_controller.http_reload_fn(f"{door_url}/reload"))
        # the knobs this fleet serves with: the scheduler's, the shed's
        # and the fold-in budget (its catalogue is below the MIPS floor,
        # and this process's MIPS gauges are the mips phase's)
        knb = obs_knobs.KnobController(
            specs=tuple(s for s in obs_knobs.default_knobs()
                        if s.name in CONTROL_KNOBS),
            apply_fn=obs_knobs.http_knobs_fn(f"{door_url}/knobs"),
            apply_scope="fleet")
        admin = AdminServer("127.0.0.1", 0, controller=ctl, knobs=knb)

        # -- 1. freshness: retrain and a rolling reload under clients ------
        clients = ControlClients(int(door_url.rsplit(":", 1)[1]), users,
                                 CONTROL_CLIENTS[0],
                                 CONTROL_CLIENT_PROCS[0], work, 1)
        time.sleep(1.0)  # the clients' first answers: the "before" window
        with LogLines("incubator_predictionio_tpu_torch.models."
                      "recommendation.engine") as lines:
            runtime.reset_launch_counts()
            t_admin = time.monotonic()
            admin_url = "http://127.0.0.1:%d" % admin.start_background()
            acted = wait_for("freshness action", lambda: next(
                (d for d in ctl.decisions(limit=256)
                 if d.get("action") == "retrain+reload"
                 and not d["outcome"].get("inFlight")), None))
            t_done = time.monotonic()
            retrain_launches = {e: runtime.launch_counts()[e] for e in
                                ("als_fused_solve_cg", "als_solve_cg_rows8")}
        time.sleep(1.0)  # the "after" window
        records = clients.stop()
        clients = None
        outcome = acted["outcome"]
        reload = outcome.get("reload", {})
        result = reload.get("result") or {}
        walls["retrain_s"] = outcome.get("retrain", {}).get("wallS")
        walls["reload_s"] = reload.get("wallS")
        walls["action_s"] = outcome.get("wallS")
        earlier = [d for d in ctl.decisions(limit=256)
                   if d.get("kind") == "evaluation" and d["id"] < acted["id"]]
        if not (outcome.get("retrain", {}).get("ok") and reload.get("ok")):
            raise AssertionError(f"control: the freshness action failed: "
                                 f"{outcome}")
        if acted["reason"] not in ("staleness_projection", "staleness_burn") \
                or acted["streak"] != int(CONTROL_ENV[
                    "PIO_CONTROLLER_HYSTERESIS"]) \
                or [d["reason"] for d in earlier] != ["hysteresis"]:
            raise AssertionError(f"control: acted on {acted['reason']} at "
                                 f"streak {acted.get('streak')} after "
                                 f"{[d['reason'] for d in earlier]}")
        if result.get("reloaded") != len(bases) or result.get("dropped") \
                or result.get("failed"):
            raise AssertionError(f"control: the rolling reload {result}")
        new_iid = outcome["retrain"]["instance"]
        new = instances.get(new_iid)
        if new_iid == old_iid or new is None or new.status != "COMPLETED":
            raise AssertionError(f"control: the retrain's instance {new_iid}"
                                 f" ({getattr(new, 'status', None)})")
        said = [m for m in map(re.compile(
            r"ALS continuation retrain: .* (\d+) sweeps \(mode=(\w+)").search,
            lines) if m]
        if len(said) != 1 or said[0].group(2) != "continue":
            raise AssertionError(f"control: the retrain logged {lines}")
        if dev.type == "cuda" and min(retrain_launches.values()) <= 0:
            raise AssertionError(f"control: the retrain launched "
                                 f"{retrain_launches}")
        bad = [r for r in records if r[1] != 200]
        if bad or not records:
            raise AssertionError(f"control: {len(bad)} of {len(records)} "
                                 f"answers across the reload were not 200: "
                                 f"{[r[1] for r in bad][:20]}")
        model = CoreWorkflow.load_models(new_iid)[0]
        interactions, _wall = fleet["read"]()
        pd = engine.RecommendationPreparator().prepare(
            RuntimeContext(device=dev),
            engine.TrainingData(interactions=interactions))
        uf_t = torch.as_tensor(model.user_factors).to(dev)
        items_t = torch.as_tensor(model.item_factors).to(dev)
        u_map, i_map = (np.array([bm[pm.inverse[k]] for k in range(len(pm))],
                                 np.int64)
                        for bm, pm in ((model.user_bimap, pd.user_bimap),
                                       (model.item_bimap, pd.item_bimap)))
        fit = als.rmse(als.ALSState(user_factors=uf_t, item_factors=items_t),
                       u_map[pd.users], i_map[pd.items], pd.ratings)
        fit_bound = 1.15 * fleet["first_fit"] + 0.02
        if not fit <= fit_bound:
            raise AssertionError(f"control: the retrain's fit {fit!r} above "
                                 f"{fit_bound!r}")
        after = {b: worker_state(b) for b in bases}
        for b, st in after.items():
            if st["instance"] != new_iid or not st["staleness_s"] < bound:
                raise AssertionError(
                    f"control: {b} serves {st['instance']} (staleness "
                    f"{st['staleness_s']} s, bound {bound} s) after the "
                    f"reload to {new_iid}")
        rng = np.random.default_rng(43)
        for k, r in enumerate(rng.choice(len(model.user_bimap),
                                         CONTROL_CHECKED, replace=False)):
            doc = {"user": model.user_bimap.inverse[int(r)], "num": 10}
            status, body = http_json("POST", f"{door_url}/queries.json", doc)
            if status != 200:
                raise AssertionError(f"control: {doc} answered {status}")
            err = max(err, check_answer(kernels, dev, uf_t, items_t, doc,
                                        None, body, f"control answer {k}",
                                        model=model))
        wait_for("cooldown skip", lambda: any(
            d.get("reason") == "cooldown" for d in ctl.decisions(limit=8)))
        status, got = http_json("GET", f"{admin_url}/controller")
        shown = next((d for d in got.get("decisions", ())
                      if d.get("id") == acted["id"]), None)
        if status != 200 or shown is None or not shown.get("traceId", "") \
                .startswith("ctl-") or shown["outcome"] != outcome \
                or not got["recorder"]["armed"]:
            raise AssertionError(f"control: GET /controller {status}, "
                                 f"decision {shown}")
        with urllib.request.urlopen(f"{admin_url}/metrics",
                                    timeout=60) as resp:
            admin_text = resp.read().decode()
        cooldown_skips = float(re.search(
            r'pio_controller_skips_total\{reason="cooldown"\} (\S+)',
            admin_text).group(1))
        if cooldown_skips < 1:
            raise AssertionError("control: no cooldown skip counted")
        t_reload = t_done - (walls["reload_s"] or 0.0)
        t_retrain = t_reload - (walls["retrain_s"] or 0.0)
        stats["freshness"] = {
            "bound_s": bound, "age_s": age0,
            "decisions": [{k: d.get(k) for k in ("id", "action", "reason",
                                                  "streak", "traceId")}
                          for d in reversed(ctl.decisions(limit=256))
                          if d.get("kind") == "evaluation"][:8],
            "instance": new_iid, "fit_rmse": fit, "fit_bound": fit_bound,
            "phases_s": {k: float(v) for k, v in
                         new.runtime_conf.items() if k.startswith("phase.")},
            "sweeps_used": int(said[0].group(1)),
            "launches": retrain_launches,
            "reload": {k: result.get(k) for k in ("reloaded", "dropped",
                                                  "failed", "drainS")},
            "answers": len(records),
            "before": latency_ms(records, hi=t_retrain),
            "retrain": latency_ms(records, t_retrain, t_reload),
            "reload_window": latency_ms(records, t_reload, t_done),
            "after": latency_ms(records, lo=t_done),
            "staleness_after_s": [after[b]["staleness_s"] for b in bases],
            "cooldown_skips": cooldown_skips,
            "admin_start_to_done_s": t_done - t_admin}

        # -- 2. knobs: one step on the scheduler family, then a rollback ----
        clients = ControlClients(int(door_url.rsplit(":", 1)[1]), users,
                                 CONTROL_CLIENTS[1],
                                 CONTROL_CLIENT_PROCS[1], work, 2)
        time.sleep(1.0)
        vector0 = knb.values()
        status, got = http_json("POST", f"{admin_url}/knobs",
                                {"mode": "act"})
        if status != 200 or got.get("mode") != "act":
            raise AssertionError(f"control: POST /knobs act {status} {got}")
        step = wait_for("knob step", lambda: next(
            (d for d in knb.decisions(limit=64)
             if d.get("action") in ("step_up", "step_down")
             and not d["outcome"].get("inFlight")), None))
        at_step = {b: worker_state(b) for b in bases}
        vector1 = knb.values()
        rollback = wait_for("knob rollback", lambda: next(
            (d for d in knb.decisions(limit=64)
             if d.get("action") == "rollback"
             and not d["outcome"].get("inFlight")), None))
        at_rollback = {b: worker_state(b) for b in bases}
        vector2 = knb.values()
        fan = step["outcome"].get("apply", {}).get("result") or {}
        if step["knob"] not in ("max_batch", "max_wait_ms") \
                or not step["outcome"].get("actuated") \
                or fan.get("applied") != len(bases) or fan.get("failed"):
            raise AssertionError(f"control: the knob step {step}")
        env_var = next(s.env for s in knb.specs if s.name == step["knob"])
        for name, res in fan["results"].items():
            if res["applied"].get(env_var) != step["to"] or \
                    res["scheduler"] is None:
                raise AssertionError(f"control: {name} answered {res}")
        if step["knob"] == "max_batch" and any(
                res["scheduler"]["cap"] != step["to"]
                for res in fan["results"].values()):
            raise AssertionError(f"control: a scheduler's cap after the "
                                 f"step: {fan['results']}")
        if not rollback["outcome"].get("actuated") \
                or rollback["reason"] != "incident" \
                or rollback["toVector"] != vector0 or vector2 != vector0:
            raise AssertionError(f"control: the rollback {rollback}")
        widths = {}
        for b in bases:
            w = batch_widths(at_step[b]["batches"], at_rollback[b]["batches"])
            widths[b] = {"before": batch_widths(start[b]["batches"],
                                                at_step[b]["batches"]),
                         "after": w}
            cap = step["to"] if step["knob"] == "max_batch" else \
                vector1["PIO_SERVE_MAX_BATCH"]
            if w["max_le"] is not None and w["max_le"] > cap:
                raise AssertionError(f"control: {b} fused a batch of up to "
                                     f"{w['max_le']} above the cap {cap}")
            if dev.type == "cuda" and not \
                    at_rollback[b]["launches"]["score_topk"] > \
                    at_step[b]["launches"]["score_topk"]:
                raise AssertionError(f"control: {b}'s score+top-k launches "
                                     f"stopped after the step")
        with urllib.request.urlopen(f"{admin_url}/metrics",
                                    timeout=60) as resp:
            admin_text = resp.read().decode()
        rollbacks = gauge_value(admin_text, "pio_knob_rollbacks_total")
        if rollbacks != 1:
            raise AssertionError(f"control: pio_knob_rollbacks_total "
                                 f"{rollbacks}")
        bogus = {"values": {"PIO_SERVE_MAX_BATCH": 64,
                            "PIO_NO_SUCH_KNOB": 1}}
        status, got = http_json("POST", f"{door_url}/knobs", bogus)
        if status != 200 or got.get("applied") != 0 or \
                sorted(got.get("failed", ())) != sorted(
                    f"w{i}" for i in range(len(bases))):
            raise AssertionError(f"control: the door's fan-out of an "
                                 f"unknown knob: {status} {got}")
        for b in bases:
            status, got = http_json("POST", f"{b}/knobs", bogus)
            st = worker_state(b)
            if status != 400 or st["cap"] != at_rollback[b]["cap"]:
                raise AssertionError(f"control: {b} answered {status} "
                                     f"{got} to an unknown knob, cap "
                                     f"{st['cap']}")
        records = clients.stop()
        clients = None
        bad = [r for r in records if r[1] != 200]
        if bad or not records:
            raise AssertionError(f"control: {len(bad)} of {len(records)} "
                                 f"answers of the knob leg were not 200")
        stats["knobs"] = {
            "vector_before": vector0, "vector_at_step": vector1,
            "vector_after_rollback": vector2,
            "step": {k: step.get(k) for k in ("knob", "action", "from", "to",
                                               "reason", "traceId")},
            "fanout": {k: fan.get(k) for k in ("workers", "applied",
                                               "failed")},
            "schedulers": {n: r["scheduler"]
                           for n, r in fan["results"].items()},
            "rollback": {k: rollback.get(k) for k in ("reason", "incident",
                                                      "traceId")},
            "rollbacks_total": rollbacks,
            "fused_widths": {f"w{i}": widths[b]
                             for i, b in enumerate(bases)},
            "answers": len(records), "latency": latency_ms(records)}

        # -- 3. the kill switch --------------------------------------------
        status, _got = http_json("POST", f"{admin_url}/knobs",
                                 {"mode": "sideways"})
        if status != 400:
            raise AssertionError(f"control: a bad mode answered {status}")
        k0, c0 = (knb.stats()["decisionsRecorded"],
                  ctl.stats()["decisionsRecorded"])
        a0, r0, n0 = (knb.stats()["adjustments"], knb.stats()["rollbacks"],
                      ctl.stats()["actions"])
        for route in ("controller", "knobs"):
            status, got = http_json("POST", f"{admin_url}/{route}",
                                    {"mode": "observe"})
            if status != 200 or got.get("mode") != "observe":
                raise AssertionError(f"control: POST /{route} observe: "
                                     f"{status} {got}")
        pause = 4 * float(CONTROL_ENV["PIO_KNOBS_INTERVAL_S"])
        time.sleep(pause)
        observed = {
            name: [d for d in c.decisions(limit=64)
                   if d["id"] > first and d.get("kind") == "evaluation"]
            for name, c, first in (("controller", ctl, c0),
                                   ("knobs", knb, k0))}
        status, got = http_json("POST", f"{admin_url}/controller",
                                {"mode": "off"})
        if status != 200 or got.get("mode") != "off":
            raise AssertionError(f"control: POST /controller off: {status}")
        n_off = ctl.stats()["decisionsRecorded"]
        time.sleep(pause)
        latest = instances.get_latest_completed(
            commands.engine_id_for_variant_path(fleet["variant"], variant),
            variant.get("version", "NOT_VERSIONED"),
            variant.get("id", "default"))
        acted_on = [d for ds in observed.values() for d in ds
                    if (d.get("outcome") or {}).get("actuated")]
        if not all(observed.values()) or acted_on or \
                ctl.stats()["decisionsRecorded"] != n_off or \
                knb.stats()["adjustments"] != a0 or \
                knb.stats()["rollbacks"] != r0 or \
                ctl.stats()["actions"] != n0 or latest.id != new_iid:
            raise AssertionError(
                f"control: after the kill switch: {ctl.stats()} "
                f"{knb.stats()}, observed "
                f"{ {k: len(v) for k, v in observed.items()} }, acted "
                f"{acted_on}, latest {latest.id}")
        stats["kill_switch"] = {
            "observed": {k: [d.get("reason") for d in v]
                         for k, v in observed.items()},
            "off_decisions": ctl.stats()["decisionsRecorded"] - n_off}
        status, bundle = http_json("POST", f"{admin_url}/incident",
                                   {"reason": "control-phase"})
        if status != 200:
            raise AssertionError(f"control: POST /incident {status}")
        with open(bundle["path"]) as f:
            frozen = json.load(f)
        if not any(d.get("id") == acted["id"] and d.get("traceId") ==
                   acted["traceId"] for d in frozen.get("decisions", ())) \
                or not any(d.get("action") == "rollback"
                           for d in frozen.get("knobs", ())):
            raise AssertionError("control: the incident bundle lacks the "
                                 "controllers' decisions")

        # -- 4. fault 3: a dispatch books its own device seconds -----------
        if dev.type == "cuda":
            stats["own_streams"] = stream_isolation(
                dev, runtime, server_mod, engine, params_mod, convert,
                uf_t.cpu().numpy(), items_t.cpu().numpy())
        end = {b: worker_state(b) for b in bases}
        launches = dict(retrain_launches)
        launches["score_topk"] = sum(
            end[b]["launches"].get("score_topk", 0)
            - start[b]["launches"].get("score_topk", 0) for b in bases)
        launches["foldin"] = sum(
            end[b]["launches"].get("als_fused_solve_cg", 0)
            - start[b]["launches"].get("als_fused_solve_cg", 0)
            for b in bases)
    finally:
        if clients is not None:
            clients.kill()
        if admin is not None:
            admin.stop()
        if door is not None:
            door.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset_planes()
    walls["wall_s"] = time.perf_counter() - t_phase
    stats["walls_s"] = walls
    stats["launches"] = launches
    return launches, err, stats


def remote_alone(dev, runtime, kernels, als, ak, planted,
                 small: bool = False, control=None) -> tuple:
    """:func:`remote_phase` alone (``--remote``): a cpplog store
    (:func:`cpplog_store`) holding store-als's ratings (one ``eventTime``
    each, 1 ms apart, as the cpplog phase imports them) under ``pio app
    new``'s app, one ``pio train`` of the cpplog phase's engine.json, its
    fit RMSE, then the phase (with ``control``, :func:`remote_phase`'s
    hook). Returns what the phase returns."""
    from datetime import timedelta

    from incubator_predictionio_tpu_torch.data.interactions import (
        Interactions,
    )
    from incubator_predictionio_tpu_torch.data.storage import Storage
    from incubator_predictionio_tpu_torch.utils.times import parse_iso8601
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    users, items, ratings, n_users, n_items = store_als_ratings(planted,
                                                                small)
    rank = 16 if small else ML20M["rank"]
    base_ms = parse_iso8601(STORE_T0).timestamp() * 1e3
    saved = os.environ.get("PIO_DEVICE")
    if dev.type == "cpu":
        os.environ["PIO_DEVICE"] = "cpu"
    cwd = os.getcwd()
    try:
        with cpplog_store(), \
                tempfile.TemporaryDirectory(prefix="pio_remote_") as work:
            key = re.search(r"Access Key: (\S+)",
                            cli("app", "new", "LogApp")).group(1)
            app_id = Storage.get_meta_data_apps().get_by_name("LogApp").id
            Storage.get_events().import_interactions(Interactions(
                user_idx=np.asarray(users, np.int32),
                item_idx=np.asarray(items, np.int32),
                values=np.asarray(ratings, np.float32),
                user_ids=[f"u{k}" for k in range(n_users)],
                item_ids=[f"i{k}" for k in range(n_items)]), app_id,
                times=np.int64(base_ms) + np.arange(len(users)))
            engine_dir = os.path.join(work, "engine")
            os.makedirs(engine_dir)
            variant = os.path.join(engine_dir, "engine.json")
            with open(variant, "w") as f:
                json.dump({
                    "id": "default",
                    "engineFactory": "incubator_predictionio_tpu_torch."
                                     "models.recommendation:"
                                     "RecommendationEngine",
                    "datasource": {"params": {"appName": "LogApp"}},
                    "algorithms": [{"name": "als", "params": {
                        "rank": rank, "numIterations": 4, "lambda": 0.03,
                        "bf16Sweeps": 2, "seed": 3}}],
                }, f)
            os.chdir(engine_dir)
            try:
                out = cli("train")
            finally:
                os.chdir(cwd)
            iid = re.search(r"Engine instance ID: (\S+)", out).group(1)
            model = CoreWorkflow.load_models(iid)[0]
            u_row = np.array([model.user_bimap[f"u{k}"] for k in users])
            i_row = np.array([model.item_bimap[f"i{k}"] for k in items])
            fit = als.rmse(als.ALSState(
                user_factors=torch.as_tensor(model.user_factors).to(dev),
                item_factors=torch.as_tensor(model.item_factors).to(dev)),
                u_row, i_row, ratings)
            return remote_phase(dev, runtime, kernels, als, ak, dict(
                name="LogApp", app_id=app_id, key=key, instance=iid,
                work=work, engine_dir=engine_dir, variant=variant,
                first_fit=fit), small, control)
    finally:
        if saved is None:
            os.environ.pop("PIO_DEVICE", None)
        else:
            os.environ["PIO_DEVICE"] = saved


def retrain_loop_leg(dev, runtime, als, planted, pd, trained, small=False,
                     rank: int = ML20M["rank"], seed: int = 3):
    """Retrain leg (b), in process at ML-20M width on the train phase's
    planted ratings (``pd``, the trained state ``trained``; rank 128,
    ``RT_LOOP_SWEEPS`` sweeps, the first bf16, λ 0.03, buckets up to
    ``RT_MAX_WIDTH``): ``als_retrain``
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
    tail_pairs_s = time.perf_counter() - t0
    pred = (trained.user_factors[torch.from_numpy(tu).to(dev)]
            * trained.item_factors[torch.from_numpy(ti).to(dev)]).sum(-1)
    tr = (pred.cpu().numpy() + rng.normal(0, 0.35, len(tu))).astype(
        np.float32)
    u2 = np.concatenate([pd.users, tu.astype(pd.users.dtype)])
    i2 = np.concatenate([pd.items, ti.astype(pd.items.dtype)])
    r2 = np.concatenate([pd.ratings, tr])
    tail_gen_s = time.perf_counter() - t0
    kw = dict(rank=rank, iterations=RT_LOOP_SWEEPS, l2=0.03, seed=seed,
              bf16_sweeps=1, max_width=RT_MAX_WIDTH, plan_key="ml20m",
              device=dev)
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
    outs = [als._mixed_run(st1, t[0], t[1], 0.03, RT_LOOP_SWEEPS, 1, True,
                           torch.float32, t[2], t[3])
            for t in (reused, fresh)]
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
        "tail_generate_s": tail_gen_s, "tail_pairs_s": tail_pairs_s,
        "first": first, "second": second,
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
    ((users, items, ratings, n_users, n_items): store-als's ratings,
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


# -- two-stage MIPS serving ----------------------------------------------------

#: the mips phase's shape: MIPS_CATALOGUE's planted items (seed 11, the JAX
#: bench's, bench.py:1198-1243), 32 planted queries (seed 5), k 20, and the
#: recall gate of tests/test_mips.py:67
MIPS_K = 20
MIPS_QUERIES = 32
MIPS_RECALL_GATE = 0.95
#: the served model's users (ML-20M's), closed-loop clients and seconds
MIPS_USERS = ML20M["users"]
MIPS_CLIENTS = 16
MIPS_LEG_S = 2.0
#: the exact tail: the JAX bench's churn (bench.py:1393), published as new
#: solves of existing items, each scaled to twice the catalogue's largest
#: row norm, so that each is its own query's best match
MIPS_CHURN = 256


def dominating(vecs: np.ndarray, vf: np.ndarray) -> np.ndarray:
    """``vecs`` along their own directions at twice ``vf``'s largest row
    norm: a published row then outscores every catalogue row for a query
    along it (the construction of tests/test_mips_lifecycle.py)."""
    top = float(np.linalg.norm(vf, axis=1).max())
    return (vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
            * 2.0 * top).astype(np.float32)
#: the floor's catalogue sizes (the JAX bench's) and batch widths
MIPS_FLOOR_SIZES = (65_536, 262_144, MIPS_CATALOGUE["items"])
MIPS_FLOOR_BATCHES = (1, 64)
#: every wait of the phase ends by this deadline or fails it
MIPS_DEADLINE_S = 120.0


@contextlib.contextmanager
def env_set(**values):
    """Environment variables set (None: unset) around a block, put back as
    they were afterwards."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def exact_dots(queries: np.ndarray, rows: np.ndarray, ids) -> np.ndarray:
    """[B, k] f64 dot products of each query with the rows of ``ids``."""
    ids = np.asarray(ids, np.int64)
    return np.einsum("bk,bnk->bn", queries.astype(np.float64),
                     rows[ids].astype(np.float64))


def check_exact(got_s, got_i, queries, rows, what: str) -> float:
    """Every (id, score) returned is the exact f32 dot product (rtol 1e-5,
    atol 1e-5·max|score|); returns the largest error."""
    ref = exact_dots(queries, rows, got_i)
    got_s = np.asarray(got_s, np.float64)
    err = float(np.abs(got_s - ref).max())
    if not np.allclose(got_s, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max()):
        raise AssertionError(f"{what}: a returned score is not its exact dot "
                             f"product (max error {err:.3e})")
    return err


def same_but_near_ties(a_i, b_i, queries, rows, what: str) -> int:
    """Two [B, k] id answers equal except among near-ties: their exact
    scores, position by position, within 1e-5 relative. Returns the
    positions whose ids differ."""
    sa = exact_dots(queries, rows, a_i)
    sb = exact_dots(queries, rows, b_i)
    if not np.allclose(sa, sb, rtol=1e-5, atol=1e-5 * np.abs(sb).max()):
        raise AssertionError(f"{what}: ids differ beyond near-ties")
    return int((np.asarray(a_i) != np.asarray(b_i)).sum())


def cpu_twin(index):
    """The same index with its tensors on the CPU (host mirrors shared)."""
    return dataclasses.replace(index, **{
        f.name: getattr(index, f.name).cpu()
        for f in dataclasses.fields(index)
        if isinstance(getattr(index, f.name), torch.Tensor)})


def scanned(mips) -> dict:
    """``pio_serve_candidates_scanned_total`` by stage."""
    fam = mips._CAND_SCANNED
    return {s: fam.labels(stage=s).value
            for s in ("centroid", "coarse", "rerank", "exhaustive")}


def quantile_ms(walls, q: float):
    if not walls:
        return None
    walls = sorted(walls)
    return 1e3 * walls[min(len(walls) - 1, int(q * len(walls)))]


def oracle_ids(kernels, dev, queries: np.ndarray, table, k: int = MIPS_K,
               step: int = 512) -> np.ndarray:
    """[B, k] exhaustive top-k ids through the score+top-k kernel."""
    out = []
    for s in range(0, len(queries), step):
        q = torch.from_numpy(np.ascontiguousarray(queries[s:s + step])).to(
            dev)
        out.append(kernels.score_topk(q, table, None, k)[1].cpu().numpy())
    return np.concatenate(out).astype(np.int64)


def host_wall_ms(fn, reps: int = 40, warm: int = 5) -> float:
    """Median host ms of ``fn`` (which fetches its answer)."""
    for _ in range(warm):
        fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(walls)


def mips_builds(dev, kernels, mips, topk, planted, table, vf, queries,
                oracle) -> tuple:
    """Step 1: an int8, a bf16 and a PQ index built on the table's device,
    each registered in turn: recall@20 of ``topk.score_and_top_k`` (which
    must route every query two-stage, by the scan counters) against the
    exhaustive kernel, every score exact, and the answers at B 1 and B 64
    those of the same index computed on the CPU except near-ties. Returns
    (the rows, the int8 index, the largest score error)."""
    n = len(vf)
    q_t = torch.from_numpy(queries).to(dev)
    rows64 = np.arange(64) % len(queries)
    cpu_table = torch.from_numpy(vf)
    out, keep, err = [], None, 0.0
    for quant in ("int8", "bf16", "pq"):
        what = f"mips {quant}"
        with env_set(PIO_SERVE_MIPS="on", PIO_SERVE_MIPS_QUANT=quant):
            sync(dev)
            t0 = time.perf_counter()
            index = mips.build_index(table, n, seed=11)
            sync(dev)
            build_s = time.perf_counter() - t0
            nprobe, n_cand, slots, rerank = mips._quotas(index, MIPS_K)
            before = scanned(mips)
            got = np.stack([topk.score_and_top_k(q_t[j], table, k=MIPS_K)
                            .cpu().numpy() for j in range(len(queries))],
                           axis=1)
            moved = {s: v - before[s] for s, v in scanned(mips).items()}
            got64 = mips.mips_batch_score_top_k(q_t, table, index, rows64,
                                                MIPS_K).cpu().numpy()
        if (moved["coarse"] != len(queries) * slots
                or moved["rerank"] != len(queries) * rerank
                or moved["exhaustive"] != 0):
            raise AssertionError(f"{what}: not every query took the "
                                 f"two-stage route: {moved}")
        got_i = got[1].astype(np.int64)
        err = max(err, check_exact(got[0], got_i, queries, vf, what),
                  check_exact(got64[0], got64[1].astype(np.int64),
                              queries[rows64], vf, f"{what} B 64"))
        recall, worst = planted.recall_against_oracle(got_i, oracle, MIPS_K)
        if not recall >= MIPS_RECALL_GATE:
            raise AssertionError(f"{what}: recall@{MIPS_K} {recall:.4f} < "
                                 f"{MIPS_RECALL_GATE}")
        twin = cpu_twin(index)
        cpu1 = np.stack([mips.mips_score_and_top_k(
            queries[j], cpu_table, twin, MIPS_K).numpy()
            for j in range(len(queries))], axis=1)
        cpu64 = mips.mips_batch_score_top_k(
            torch.from_numpy(queries), cpu_table, twin, rows64,
            MIPS_K).numpy()
        diff1 = same_but_near_ties(got_i, cpu1[1].astype(np.int64), queries,
                                   vf, f"{what} B 1 card against the CPU")
        diff64 = same_but_near_ties(
            got64[1].astype(np.int64), cpu64[1].astype(np.int64),
            queries[rows64], vf, f"{what} B 64 card against the CPU")
        row = {"quant": quant, "items": n, "rank": index.rank,
               "build_s": build_s, "recall": recall, "worst_recall": worst,
               "centroids": index.c_total, "cap": index.cap,
               "nprobe": nprobe, "candidates": n_cand,
               "scanned_fraction": (slots + rerank) / n,
               "device_bytes_per_item": index.device_bytes() / n,
               "cpu_near_tie_ids": [diff1, diff64]}
        print(f"mips-build: {json.dumps(row)}", flush=True)
        out.append(row)
        if quant == "int8":
            keep = index
    mips.register_index(table, keep)
    return out, keep, err


def http_leg_check(planted, records, uf, rows_eff, oracle, what: str):
    """Every answer a 200 with ``MIPS_K`` items, every (id, score) the exact
    dot product with ``rows_eff``, recall@20 against ``oracle`` (ids by
    user row) at the gate. Returns (largest score error, recall)."""
    bad = [r[:3] for r in records if r[1] != 200]
    if bad or not records:
        raise AssertionError(f"{what}: {len(bad)} answers not 200 of "
                             f"{len(records)}: {bad[:3]}")
    users = np.array([r[0] for r in records])
    bodies = [json.loads(r[5])["itemScores"] for r in records]
    if any(len(b) != MIPS_K for b in bodies):
        raise AssertionError(f"{what}: an answer without {MIPS_K} items")
    got_s = np.array([[x["score"] for x in b] for b in bodies])
    got_i = np.array([[int(x["item"][1:]) for x in b] for b in bodies])
    err = check_exact(got_s, got_i, uf[users], rows_eff, what)
    recall, _ = planted.recall_against_oracle(got_i, oracle[users], MIPS_K)
    if not recall >= MIPS_RECALL_GATE:
        raise AssertionError(f"{what}: recall@{MIPS_K} {recall:.4f}")
    return err, recall


def one_client(port: int, users: int, until, seed: int) -> list:
    """One closed-loop client on this thread until ``until(records)`` is
    true (or the phase's deadline passes, which fails it): records as
    :func:`run_clients` gives them."""
    rng = np.random.default_rng(seed)
    deadline = time.monotonic() + MIPS_DEADLINE_S
    records: list = []
    while not until(records):
        if time.monotonic() > deadline:
            raise AssertionError("mips: a client outlived the deadline")
        u = int(rng.integers(users))
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/queries.json",
            data=json.dumps({"user": f"u{u}", "num": MIPS_K}).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                records.append([u, resp.status, time.perf_counter() - t0,
                                None, None, resp.read().decode()])
        except urllib.error.HTTPError as e:
            records.append([u, e.code, time.perf_counter() - t0, None, None,
                            None])
    return records


def published_found(mips, topk, dev, table, vecs, rows, rows_eff,
                    kernels, what: str) -> dict:
    """Each published row queried by its own vector: every published row
    the exhaustive kernel puts in the top-20 over the published catalogue
    (``rows_eff``) is in the two-stage answer (recall 1.0 on the published
    keys), at its exact score, and each query's own row first."""
    eff_t = torch.from_numpy(rows_eff).to(dev)
    oracle = oracle_ids(kernels, dev, vecs, eff_t)
    del eff_t
    q_t = torch.from_numpy(vecs).to(dev)
    got = np.stack([topk.score_and_top_k(q_t[j], table, k=MIPS_K)
                    .cpu().numpy() for j in range(len(vecs))], axis=1)
    got_i = got[1].astype(np.int64)
    check_exact(got[0], got_i, vecs, rows_eff, what)
    pub = set(int(r) for r in rows)
    want = found = 0
    for j in range(len(vecs)):
        keys = pub.intersection(oracle[j].tolist())
        want += len(keys)
        found += len(keys.intersection(got_i[j].tolist()))
    own = sum(int(got_i[j][0]) == int(rows[j]) for j in range(len(vecs)))
    if found != want or own != len(vecs):
        raise AssertionError(f"{what}: {found} of {want} published keys "
                             f"found, {own} of {len(vecs)} first")
    return {"published_in_oracle": want, "found": found,
            "own_key_in_answer": own}


def mips_served(dev, runtime, kernels, mips, mips_daemon, topk, planted,
                server_mod, engine, params_mod, convert, table, vf, index,
                small: bool) -> tuple:
    """Steps 2-4: a planted ALSModel of ``MIPS_USERS`` users over the
    catalogue (its table the one ``index`` serves) behind
    ``PredictionServer`` with the scheduler; 32 queries then
    ``MIPS_LEG_S`` s of ``MIPS_CLIENTS`` closed-loop clients, every answer
    exact and at the recall gate; one filtered query on the exhaustive
    kernel; ``GET /``'s ``mips`` block and ``/metrics``' scan counters; the
    exact tail (``MIPS_CHURN`` new solves of existing items); a rebuild in
    a thread while one client queries; the server stopped, the daemon
    released; then the daemon's churn trigger through ``sweep_now``.
    Returns (stats, score+top-k launches of the filtered query, largest
    score error)."""
    n, rank = vf.shape
    users = 2000 if small else MIPS_USERS
    uf = planted.planted_queries(vf, users, seed=6)
    model = convert.als_model_from_numpy(
        uf, vf, [f"u{i}" for i in range(users)],
        [f"i{i}" for i in range(n)], device=dev)
    # the model serves the phase's table, and its index: the deploy's
    # prepare_model adopts it
    model = dataclasses.replace(model, item_factors=table)
    srv = server_mod.PredictionServer(
        engine.RecommendationEngine().apply(),
        params_mod.EngineParams(algorithm_params_list=[
            ("als", engine.ALSAlgorithmParams(rank=rank, seed=11))]),
        [model], device=dev)
    if mips.index_for(srv.models[0].item_factors) is not index:
        raise AssertionError("mips: the deploy did not adopt the index")
    uf_t = torch.from_numpy(uf).to(dev)
    t0 = time.perf_counter()
    oracle = oracle_ids(kernels, dev, uf, table)
    stats = {"users": users, "oracle_s": time.perf_counter() - t0}
    work = tempfile.mkdtemp(prefix="mips_load_")
    rng = np.random.default_rng(12)
    err = 0.0
    t0 = time.perf_counter()
    port = srv.start_background()
    stats["start_s"] = time.perf_counter() - t0
    try:
        # 32 queries, then the closed-loop clients
        picks = rng.choice(users, MIPS_QUERIES, replace=False)
        before = scanned(mips)
        runtime.reset_launch_counts()
        records = []
        for u in picks:
            t0 = time.perf_counter()
            body = post(port, {"user": f"u{u}", "num": MIPS_K})
            records.append([int(u), 200, time.perf_counter() - t0, None,
                            None, json.dumps(body)])
        e, recall = http_leg_check(planted, records, uf, vf, oracle,
                                   "mips http queries")
        err = max(err, e)
        stats["queries"] = {"n": len(records), "recall": recall,
                            "p50_ms": quantile_ms([r[2] for r in records],
                                                  0.5)}
        records = run_clients(port, users, 4 if small else MIPS_CLIENTS,
                              1.0 if small else MIPS_LEG_S, seed=970,
                              work=work, num=MIPS_K)
        moved = {s: v - before[s] for s, v in scanned(mips).items()}
        launches = runtime.launch_counts()["score_topk"]
        e, recall = http_leg_check(planted, records, uf, vf, oracle,
                                   "mips http clients")
        err = max(err, e)
        walls = [r[2] for r in records]
        nprobe, n_cand, slots, rerank = mips._quotas(index, MIPS_K)
        answered = MIPS_QUERIES + len(records)
        if (moved["exhaustive"] != 0 or moved["coarse"] < answered * slots
                or launches != 0):
            raise AssertionError(f"mips http: not every answer took the "
                                 f"two-stage route: {moved}, score+top-k "
                                 f"launched {launches} times")
        stats["clients"] = {"clients": 4 if small else MIPS_CLIENTS,
                            "answers": len(records),
                            "qps": len(records) / (1.0 if small
                                                   else MIPS_LEG_S),
                            "p50_ms": quantile_ms(walls, 0.5),
                            "p99_ms": quantile_ms(walls, 0.99),
                            "recall": recall, "scanned": moved}
        # a filtered query takes the exhaustive kernel
        u = int(picks[0])
        runtime.reset_launch_counts()
        body = post(port, {"user": f"u{u}", "num": MIPS_K,
                           "blacklist": ["i0", "i1"]})
        filt_launches = runtime.launch_counts()["score_topk"]
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        mask[:2] = False
        ref_s, ref_i = kernels.score_topk(uf_t[u:u + 1], table, mask, MIPS_K)
        got_i = np.array([[int(x["item"][1:]) for x in body["itemScores"]]])
        err = max(err, check_exact(
            np.array([[x["score"] for x in body["itemScores"]]]), got_i,
            uf[u:u + 1], vf, "mips filtered query"))
        same_but_near_ties(got_i, ref_i.cpu().numpy(), uf[u:u + 1], vf,
                           "mips filtered query")
        if dev.type == "cuda" and filt_launches < 1:
            raise AssertionError("mips: the filtered query did not launch "
                                 "the score+top-k kernel")
        code, status = http_json("GET", f"http://127.0.0.1:{port}/")
        block = status.get("mips") if code == 200 else None
        if (not block or block["indexes"][0]["items"] != n
                or not block["daemon"]["running"]):
            raise AssertionError(f"mips: GET / mips block {block}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=60) as resp:
            metrics = resp.read().decode()
        if 'pio_serve_candidates_scanned_total{stage="coarse"}' not in \
                metrics:
            raise AssertionError("mips: /metrics has no scan counters")
        stats["filtered"] = {"launches": filt_launches}
        stats["status_mips"] = block["indexes"][0]

        # step 3: the exact tail
        churn = dominating(planted.planted_queries(vf, MIPS_CHURN, seed=9),
                           vf)
        churn_rows = rng.choice(n, MIPS_CHURN, replace=False)
        ids = mips.publish_rows(table, churn, rows=churn_rows)
        if ids is None or not np.array_equal(ids, churn_rows):
            raise AssertionError(f"mips: publish gave {ids}")
        rows_eff = vf.copy()
        rows_eff[churn_rows] = churn
        stats["tail"] = published_found(mips, topk, dev, table, churn,
                                        churn_rows, rows_eff, kernels,
                                        "mips tail")
        eff_oracle = oracle_ids(kernels, dev, uf,
                                torch.from_numpy(rows_eff).to(dev))

        # step 4: a rebuild in a thread while one client queries
        quiet = one_client(port, users, lambda r: len(r) >= 40, seed=971)
        errors = []

        def rebuild():
            try:
                mips.rebuild_index(table, trigger="tail")
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        old = mips.index_for(table)
        thread = threading.Thread(target=rebuild, daemon=True)
        t0 = time.perf_counter()
        thread.start()
        during = one_client(port, users, lambda _r: not thread.is_alive(),
                            seed=972)
        thread.join(MIPS_DEADLINE_S)
        swap_s = time.perf_counter() - t0
        if errors or thread.is_alive():
            raise AssertionError(f"mips rebuild: {errors or 'no end'}")
        new = mips.index_for(table)
        if new is old or new.tail_size() != MIPS_CHURN:
            raise AssertionError(f"mips rebuild: {new.stats()}")
        after = one_client(port, users, lambda r: len(r) >= 40, seed=973)
        for what, recs in (("quiet", quiet), ("during", during),
                           ("after", after)):
            e, _r = http_leg_check(planted, recs, uf, rows_eff, eff_oracle,
                                   f"mips rebuild {what}")
            err = max(err, e)
        stats["rebuild"] = {
            "swap_s": swap_s, "answers_during": len(during),
            "p50_ms_before": quantile_ms([r[2] for r in quiet], 0.5),
            "p99_ms_before": quantile_ms([r[2] for r in quiet], 0.99),
            "p50_ms_during": quantile_ms([r[2] for r in during], 0.5),
            "p99_ms_during": quantile_ms([r[2] for r in during], 0.99),
            "found_after": published_found(mips, topk, dev, table, churn,
                                           churn_rows, rows_eff, kernels,
                                           "mips after the rebuild")}
    finally:
        srv.stop()
    daemon = mips_daemon.stats()
    if daemon["running"] or mips_daemon._DAEMON._refs:
        raise AssertionError(f"mips: the daemon outlived the server: "
                             f"{daemon}")
    # the daemon's trigger, swept on this thread
    with env_set(PIO_MIPS_REBUILD_CHURN=MIPS_CHURN):
        more = dominating(planted.planted_queries(vf, MIPS_CHURN, seed=10),
                          vf)
        more_rows = rng.choice(np.setdiff1d(np.arange(n), churn_rows),
                               MIPS_CHURN, replace=False)
        mips.publish_rows(table, more, rows=more_rows)
        old = mips.index_for(table)
        trigger = mips_daemon.check_trigger(old)
        swept = mips_daemon.sweep_now()
        new = mips.index_for(table)
    if trigger != "churn" or swept < 1 or new is old:
        raise AssertionError(f"mips daemon: trigger {trigger}, {swept} "
                             "rebuilds")
    rows_eff[more_rows] = more
    stats["daemon"] = {"trigger": trigger, "rebuilds": swept,
                       "last": mips_daemon.stats()["last"][-1],
                       "found": published_found(
                           mips, topk, dev, table, more, more_rows,
                           rows_eff, kernels, "mips daemon swap")}
    return stats, filt_launches, err, rows_eff


def mips_cold(dev, kernels, mips, mips_daemon, topk, table, vf,
              published) -> dict:
    """Step 5: the published rows first republished at their catalogue
    values (the dominating solves would take every query's top-20), then
    with ``PIO_MIPS_TIER=on`` a rebuild demotes the buckets a planted
    probe-hit profile says were never probed; a cold row in its own
    query's exact top-20 is found through the host scan, the answer the
    exhaustive kernel's except near-ties, its bucket's hits booked;
    pressure past the promote trigger sends it back to the device, where it
    is found again."""
    mips.publish_rows(table, vf[published], rows=published)
    rows_eff, skip = vf, set(int(r) for r in published)
    with env_set(PIO_MIPS_TIER="on"):
        index = mips.index_for(table)
        index.probe_hits[:] = 1
        index.probe_hits[: index.c_total // 4] = 0
        index._probe_samples = 10_000
        t0 = time.perf_counter()
        new = mips.rebuild_index(table, trigger="manual")
        demote_s = time.perf_counter() - t0
        if new is None or new.cold is None or not new.cold.rows:
            raise AssertionError("mips cold: no bucket was demoted")
        dev_rows, host_rows = new.tier_rows()
        eff_t = torch.from_numpy(rows_eff).to(dev)
        cold_ids = np.concatenate([ids for ids in new.cold.member_ids
                                   if len(ids)])
        cands = [int(c) for c in cold_ids[:512] if int(c) not in skip]
        orc = oracle_ids(kernels, dev, rows_eff[cands], eff_t)
        cold_id = next((c for c, o in zip(cands, orc) if c in o), None)
        if cold_id is None:
            raise AssertionError("mips cold: no cold row in its own top-20")
        q = rows_eff[cold_id:cold_id + 1]
        want = orc[cands.index(cold_id)][None]
        got = topk.score_and_top_k(eff_t[cold_id], table, k=MIPS_K).cpu()
        got_i = got[1].numpy().astype(np.int64)[None]
        if cold_id not in got_i[0] or int(new.cold.hits.sum()) <= 0:
            raise AssertionError(f"mips cold: row {cold_id} not served from "
                                 "the cold tier")
        same_but_near_ties(got_i, want, q, rows_eff, "mips cold query")
        new.cold.hits[:] = 100
        trigger = mips_daemon.check_trigger(new)
        t0 = time.perf_counter()
        promoted = mips.rebuild_index(table, trigger="promote")
        promote_s = time.perf_counter() - t0
        still = (np.concatenate([ids for ids in promoted.cold.member_ids
                                 if len(ids)])
                 if promoted.cold is not None else np.empty(0, np.int64))
        got2 = topk.score_and_top_k(eff_t[cold_id], table, k=MIPS_K).cpu()
    if trigger != "promote" or cold_id in still.tolist() \
            or cold_id not in got2[1].numpy().astype(np.int64):
        raise AssertionError(f"mips cold: promotion ({trigger}) did not "
                             f"bring row {cold_id} back")
    return {"cold_rows": host_rows, "device_rows": dev_rows,
            "demote_s": demote_s, "promote_s": promote_s,
            "cold_after_promote": int(len(still)), "cold_id": cold_id}


def mips_floor(dev, kernels, mips, planted, vf_big, small: bool) -> tuple:
    """Step 6: the two-stage route (int8, k 20; a fresh build) against the
    score+top-k kernel at the JAX bench's sizes, B 1 and 64: host ms of a
    call and its fetch, and device ms (CUDA events; ``graph_ms`` a CUDA
    graph replay of the route's device stages). Returns (rows, the
    smallest size at which two-stage wins at B 1, or None)."""
    sizes = (8_192, 16_384, len(vf_big)) if small else MIPS_FLOOR_SIZES
    rows, wins = [], []
    for n in sizes:
        vf = vf_big if n == len(vf_big) else planted.planted_item_factors(
            n, vf_big.shape[1], seed=11)
        table = torch.from_numpy(vf).to(dev)
        qs = planted.planted_queries(vf, 64, seed=5)
        with env_set(PIO_SERVE_MIPS="on", PIO_SERVE_MIPS_QUANT="int8"):
            index = mips.build_index(table, n, seed=11, register=False)
        nprobe, n_cand, _slots, _rr = mips._quotas(index, MIPS_K)
        for b in MIPS_FLOOR_BATCHES:
            q_t = torch.from_numpy(qs[:b]).to(dev)
            brows = np.arange(b)

            def two():
                return mips._two_stage(q_t, table, index, MIPS_K, None,
                                       nprobe, n_cand)

            def ex():
                return kernels.score_topk(q_t, table, None, MIPS_K)

            if b == 1:
                two_host = host_wall_ms(lambda: mips.mips_score_and_top_k(
                    q_t[0], table, index, MIPS_K).cpu())
            else:
                two_host = host_wall_ms(lambda: mips.mips_batch_score_top_k(
                    q_t, table, index, brows, MIPS_K).cpu())
            ex_host = host_wall_ms(lambda: torch.stack(
                [t.to(torch.float32) for t in ex()]).cpu())
            row = {"name": "mips_two_stage", "quant": "int8", "items": n,
                   "B": b, "k": MIPS_K, "host_ms": two_host,
                   "exhaustive_host_ms": ex_host}
            if dev.type == "cuda":
                row.update(ms=median_ms(two), graph_ms=graph_ms(two),
                           exhaustive_ms=median_ms(ex),
                           exhaustive_graph_ms=graph_ms(ex))
            rows.append(row)
            print(f"time: {json.dumps(row)}", flush=True)
            if b == 1 and two_host < ex_host:
                wins.append(n)
        del index, table
    return rows, (min(wins) if wins else None)


def mips_phase(dev, runtime, kernels, planted, convert, engine, params_mod,
               server_mod, small: bool = False):
    """The two-stage MIPS phase (steps 1-7 of :func:`mips_builds`,
    :func:`mips_served`, :func:`mips_cold`, :func:`mips_floor`) on
    ``MIPS_CATALOGUE``'s planted catalogue (65,536 × 64 when ``small``).
    Returns (score+top-k launches, largest score error, stats)."""
    from incubator_predictionio_tpu_torch.ops import mips, mips_daemon, topk

    t_phase = time.perf_counter()
    n = 65_536 if small else MIPS_CATALOGUE["items"]
    vf = planted.planted_item_factors(n, MIPS_CATALOGUE["rank"], seed=11)
    queries = planted.planted_queries(vf, MIPS_QUERIES, seed=5)
    table = torch.from_numpy(vf).to(dev)
    oracle = oracle_ids(kernels, dev, queries, table)
    # the kernel's oracle is the host's except among near-ties
    same_but_near_ties(oracle, planted.exhaustive_top_k(vf, queries, MIPS_K),
                       queries, vf, "mips oracle")
    builds, index, err = mips_builds(dev, kernels, mips, topk, planted,
                                     table, vf, queries, oracle)
    with env_set(PIO_SERVE_MIPS="on", PIO_SERVE_MIPS_QUANT="int8"):
        served, launches, e, rows_eff = mips_served(
            dev, runtime, kernels, mips, mips_daemon, topk, planted,
            server_mod, engine, params_mod, convert, table, vf, index,
            small)
        err = max(err, e)
        cold = mips_cold(dev, kernels, mips, mips_daemon, topk, table, vf,
                         np.flatnonzero((rows_eff != vf).any(1)))
    mips.unregister_index(table)
    del table
    floor_rows, smallest = mips_floor(dev, kernels, mips, planted, vf, small)
    floor = {"smallest_winning_size_b1": smallest,
             "default_min_items": mips.MIN_ITEMS_DEFAULT}
    return launches, err, {"builds": builds, "served": served, "cold": cold,
                           "floor": floor, "floor_rows": floor_rows,
                           "wall_s": time.perf_counter() - t_phase}


# -- evaluation and the similarproduct template -----------------------------

#: the eval phase's planted ratings: 4,096 users (a depth cut for the
#: script's time limit, from 8,192, whose phase took 52.8 s; the catalogue
#: and the rank stay at ML-20M width) × 32 ratings each, drawn with the
#: preference bias of tests/test_quality_planted.py's fixture
EVAL_USERS = 4_096
EVAL_PER_USER = 32
EVAL_APP = "eval-app"
#: the trained candidate's Precision@5 over the untrained one's, at least:
#: the first run of these ratings on an H100 80GB HBM3 (700.00 W) read
#: 0.00708 against 0.00039 (chance, 16 held-out items among ~26,600, is
#: 0.0006), so 0.004 keeps about 60% of that gap
EVAL_MARGIN = 0.004
#: eval queries held to the plain top-k, per fold of each candidate
EVAL_CHECKED = 64
#: the port's twin of examples/recommendation-quickstart/evaluation.py
#: (the same objects, the port's imports): two candidates at the phase's
#: rank, λ 0.05, seed 3, one untrained (0 sweeps) and one of 4 sweeps
EVAL_MODULE = '''"""The quickstart's evaluation objects, importing the port.

Run with:
    pio eval evaluation:evaluation evaluation:engine_params_generator
"""

from incubator_predictionio_tpu_torch.core.evaluation import Evaluation
from incubator_predictionio_tpu_torch.core.params import (
    EngineParams,
    EngineParamsGenerator,
)
from incubator_predictionio_tpu_torch.models.recommendation import (
    ALSAlgorithmParams,
    DataSourceParams,
    PrecisionAtK,
    RecommendationEngine,
)

evaluation = Evaluation()
evaluation.engine_metric = (RecommendationEngine().apply(), PrecisionAtK(k=5))


class _Generator(EngineParamsGenerator):
    engine_params_list = [
        EngineParams(
            data_source_params=("", DataSourceParams(app_name={app!r},
                                                     eval_k=2)),
            algorithm_params_list=[
                ("als", ALSAlgorithmParams(rank={rank}, num_iterations=iters,
                                           lambda_=0.05, seed=3))
            ],
        )
        for iters in (0, 4)
    ]


engine_params_generator = _Generator()
'''


def eval_ratings(n_users: int, n_items: int, per_user: int, dev,
                 plant_rank: int = 16, sigma: float = 0.35, seed: int = 7):
    """(users, items, ratings): ratings 3.5 + U·Vᵀ + N(0, σ) at plant
    rank 16, each user's ``per_user`` distinct items drawn with
    probability ∝ exp(2·(true score − max)), as tests/test_quality_
    planted.py's fixture draws them: without replacement, here in bulk
    on ``dev`` as the ``per_user`` smallest E_i / w_i over E_i ~ Exp(1)
    (the exponential race, the same law as successive draws).
    ``utils/planted.planted_ratings`` draws by popularity, where held-out
    precision cannot tell a trained model from chance (the fixture's
    docstring)."""
    rng = np.random.default_rng(seed)
    u_true = rng.normal(0, 1 / np.sqrt(plant_rank),
                        (n_users, plant_rank)).astype(np.float32)
    v_true = rng.normal(0, 1.0, (n_items, plant_rank)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    v_dev = torch.from_numpy(v_true).to(dev)
    picks = []
    for lo in range(0, n_users, 2048):
        u_dev = torch.from_numpy(u_true[lo:lo + 2048]).to(dev)
        keys = 2.0 * (u_dev @ v_dev.T)
        race = torch.empty_like(keys).exponential_(generator=gen)
        picks.append(torch.topk(keys - torch.log(race), per_user,
                                dim=1).indices.cpu())
    users = np.repeat(np.arange(n_users), per_user)
    items = torch.cat(picks).numpy().ravel()
    ratings = (3.5 + np.einsum("nk,nk->n", u_true[users], v_true[items])
               + rng.normal(0, sigma, len(users)))
    return (users.astype(np.int32), items.astype(np.int32),
            ratings.astype(np.float32))


@contextlib.contextmanager
def patched(obj, name: str, wrap):
    """``obj.name`` replaced by ``wrap(original)`` around a block."""
    real = getattr(obj, name)
    setattr(obj, name, wrap(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def hold_top(kernels, dev, qvec, table, mask, got, num: int, what: str,
             positive: bool = False) -> float:
    """One served answer (``got``: [(row, score)]) against the plain
    version of the score+top-k kernel on the same query vector and table,
    ``mask`` (numpy bool, or None) the items it may return: ids equal
    except near-ties, scores rtol 1e-5 (:func:`check_topk`). With
    ``positive`` the answer keeps only scores above 0, as the
    recommended-user template does."""
    allowed = None if mask is None else torch.from_numpy(mask).to(dev)
    n_live = num if mask is None else min(num, int(mask.sum()))
    ref_s, ref_i = kernels.score_topk_plain(
        qvec.reshape(1, -1).to(table.dtype), table, allowed,
        min(num + 1, table.shape[0]))
    ref_s, ref_i = ref_s.cpu(), ref_i.cpu()
    if positive:
        n_live = int((ref_s[0, :n_live] > 0).sum())
    if len(got) != n_live:
        raise AssertionError(f"{what}: {len(got)} items, expected {n_live}")
    got_s = np.array([[s for _r, s in got]], np.float64).reshape(1, -1)
    got_i = np.array([[r for r, _s in got]], np.int64).reshape(1, -1)
    return check_topk(got_s, got_i, ref_s[:, :n_live + 1],
                      ref_i[:, :n_live + 1], n_live, what)


def eval_phase(dev, runtime, kernels, small: bool = False) -> tuple:
    """``pio eval`` through the port's CLI, in this process
    (``cli.main.main``), on a fresh SQLite store at ML-20M width: an app,
    ``EVAL_USERS`` × 26,744 items × ``EVAL_PER_USER`` planted ratings
    (:func:`eval_ratings`, seed 7; 131,072 in all) through
    ``import_interactions``, the port's twin of the quickstart's
    ``evaluation.py`` (``EVAL_MODULE``) written into a work directory, and
    ``pio eval evaluation:evaluation evaluation:engine_params_generator
    --output-best``: two folds (``eval_k`` 2) per candidate, each trained
    on the card (the R-row and fused ALS entries) and its ~4,096 queries
    (``exclude_seen``, so one ``predict`` each, JAX engine.py:733)
    answered by the score+top-k kernel, then ``PrecisionAtK(k=5)``.
    Checks: exit 0; the one-liner and the instance id printed; the
    EvaluationInstance EVALCOMPLETED; the winner the trained candidate,
    its Precision@5 above the untrained one's by ``EVAL_MARGIN``;
    ``best.json`` the winner's ``to_jsonable()``; the fused, R-row and
    score+top-k kernels launched; ``EVAL_CHECKED`` sampled answers of
    each fold of each candidate equal to the plain top-k of that fold's
    model with the user's training items excluded. (300 users × 500
    items × rank 16 when ``small``, the rehearsal on the CPU.) Returns
    (launches by kernel, max score error, stats)."""
    from incubator_predictionio_tpu_torch.cli import main as cli_main
    from incubator_predictionio_tpu_torch.data.interactions import (
        Interactions,
    )
    from incubator_predictionio_tpu_torch.data.storage import Storage
    from incubator_predictionio_tpu_torch.models.recommendation import (
        engine as rec,
    )
    from incubator_predictionio_tpu_torch.utils.times import parse_iso8601

    n_users = 300 if small else EVAL_USERS
    n_items = 500 if small else ML20M["items"]
    rank = 16 if small else ML20M["rank"]
    t_phase = time.perf_counter()
    stats: dict = {"users": n_users, "items": n_items, "rank": rank}
    with temp_store() as home:
        app_id = new_app(EVAL_APP)
        t0 = time.perf_counter()
        users, items, ratings = eval_ratings(n_users, n_items,
                                             EVAL_PER_USER, dev)
        stats["ratings"] = int(len(ratings))
        stats["gen_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        Storage.get_events().import_interactions(
            Interactions(user_idx=users, item_idx=items, values=ratings,
                         user_ids=[f"u{k}" for k in range(n_users)],
                         item_ids=[f"i{k}" for k in range(n_items)]),
            app_id, base_time=parse_iso8601(STORE_T0))
        stats["import_s"] = time.perf_counter() - t0
        work = os.path.join(home, "eval-work")
        os.makedirs(work)
        with open(os.path.join(work, "evaluation.py"), "w") as f:
            f.write(EVAL_MODULE.format(app=EVAL_APP, rank=rank))
        best_path = os.path.join(work, "best.json")

        walls = {"read": 0.0, "train": 0.0, "queries": 0.0}
        n_queries = [0]
        folds: dict = {}    # id(model) → [candidate, fold, model, answers]
        trained = {0: 0, 1: 0}

        def timed(part, fn):
            def run(*a, **kw):
                sync(dev)
                t = time.perf_counter()
                out = fn(*a, **kw)
                sync(dev)
                walls[part] += time.perf_counter() - t
                return out
            return run

        def train_wrap(real):
            def train(self, ctx, pd):
                model = timed("train", real)(self, ctx, pd)
                cand = 0 if self.params.num_iterations == 0 else 1
                folds[id(model)] = [cand, trained[cand], model, []]
                trained[cand] += 1
                return model
            return train

        def predict_wrap(real):
            def batch_predict(self, model, queries):
                out = timed("queries", real)(self, model, queries)
                n_queries[0] += len(queries)
                by_qx = dict(queries)
                folds[id(model)][3] += [(by_qx[qx], p) for qx, p in out]
                return out
            return batch_predict

        captured = []
        saved_term = signal.getsignal(signal.SIGTERM)
        cwd = os.getcwd()
        runtime.reset_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        try:
            os.chdir(work)
            with patched(rec.RecommendationDataSource, "read_eval",
                         lambda real: timed("read", real)), \
                    patched(rec.ALSAlgorithm, "train", train_wrap), \
                    patched(rec.ALSAlgorithm, "batch_predict",
                            predict_wrap), \
                    contextlib.redirect_stdout(LineSink(captured)), \
                    env_set(PIO_DEVICE="cpu" if dev.type == "cpu"
                            else None):
                rc = cli_main.main([
                    "eval", "evaluation:evaluation",
                    "evaluation:engine_params_generator",
                    "--output-best", best_path])
        finally:
            os.chdir(cwd)
            signal.signal(signal.SIGTERM, saved_term)
        sync(dev)
        stats["pio_eval_s"] = time.perf_counter() - t0
        launches = runtime.launch_counts()
        module = sys.modules.pop("evaluation", None)
        lines = "".join(captured).strip().splitlines()
        if rc != 0 or len(lines) < 2 or not lines[-2].startswith("[") \
                or not lines[-1].startswith(
                    "Evaluation completed. Instance ID: "):
            raise AssertionError(f"eval: pio eval exited {rc}: {lines}")
        iid = lines[-1].rsplit(" ", 1)[1]
        inst = Storage.get_meta_data_evaluation_instances().get(iid)
        if inst is None or inst.status != "EVALCOMPLETED":
            raise AssertionError(f"eval: instance {iid} is "
                                 f"{inst and inst.status}")
        result = json.loads(inst.evaluator_results_json)
        scores = [s["score"]["score"] for s in result["engineParamsScores"]]
        stats.update(one_liner=lines[-2], best_idx=result["bestIdx"],
                     precision_at_5=scores)
        if result["bestIdx"] != 1 or not scores[1] > scores[0] + EVAL_MARGIN:
            raise AssertionError(f"eval: winner {result['bestIdx']}, "
                                 f"Precision@5 {scores}")
        winner = module.engine_params_generator.engine_params_list[1]
        with open(best_path) as f:
            best = json.load(f)
        if best != winner.to_jsonable() \
                or result["bestEngineParams"] != best:
            raise AssertionError(f"eval: best.json {best}")
        on_path = {e: launches.get(e, 0) for e in
                   ("score_topk", "als_solve_cg_rows8", "als_fused_solve_cg",
                    "als_solve_cg")}
        if dev.type == "cuda" and not (
                on_path["score_topk"] >= n_queries[0]
                and on_path["als_solve_cg_rows8"] > 0
                and on_path["als_fused_solve_cg"] > 0):
            raise AssertionError(f"eval: launches {on_path}")

        # sampled answers of each fold against the plain top-k
        t0 = time.perf_counter()
        err, rng = 0.0, np.random.default_rng(17)
        if sorted((c, f) for c, f, _m, _a in folds.values()) != \
                [(0, 0), (0, 1), (1, 0), (1, 1)]:
            raise AssertionError(f"eval: folds {list(folds.values())}")
        for cand, fold, model, answers in folds.values():
            for j in rng.choice(len(answers), min(EVAL_CHECKED,
                                                  len(answers)),
                                replace=False):
                q, p = answers[j]
                row = model.user_bimap[q.user]
                mask = np.ones(len(model.item_bimap), bool)
                mask[model.user_seen[row]] = False
                got = [(model.item_bimap[s.item], s.score)
                       for s in p.item_scores]
                err = max(err, hold_top(
                    kernels, dev, model.user_factors[row],
                    model.item_factors, mask, got, q.num,
                    f"eval candidate {cand} fold {fold} {q.user}"))
        stats["checked"] = 4 * EVAL_CHECKED
        stats["check_s"] = time.perf_counter() - t0
    stats.update({f"{k}_s": v for k, v in walls.items()},
                 queries=n_queries[0],
                 queries_per_s=n_queries[0] / max(walls["queries"], 1e-9),
                 launches=on_path, wall_s=time.perf_counter() - t_phase)
    return on_path, err, stats


class LineSink:
    """A ``sys.stdout`` stand-in that keeps what is written (for the
    CLI's output) and echoes it to the real stdout."""

    def __init__(self, out: list):
        self.out = out
        self.real = sys.stdout

    def write(self, s: str) -> int:
        self.out.append(s)
        return self.real.write(s)

    def flush(self) -> None:
        self.real.flush()


@contextlib.contextmanager
def memory_store():
    """The port's Storage on the memory backend for a block (a store with
    a tail read, and imports and reads far cheaper than SQLite's), put
    back to the environment's configuration afterwards."""
    from incubator_predictionio_tpu_torch.data.storage import Storage

    Storage.configure({
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        **{f"PIO_STORAGE_REPOSITORIES_{r}_{k}": v
           for r in ("METADATA", "EVENTDATA", "MODELDATA")
           for k, v in (("NAME", f"pio_{r.lower()}"), ("SOURCE", "MEM"))}})
    try:
        yield
    finally:
        Storage.reset()


SIMILAR_APP = "similar-app"
#: the similar phase's sweeps: the example's engine.json trains 20
#: (examples/similarproduct-quickstart/engine.json); 4 is a depth cut
SIMILAR_SWEEPS = 4
#: the similar phase's views: the first of store-als's planted pairs, a
#: depth cut from all 250,000 (its SQLite import took 24.6 s); the pairs
#: are in draw order, whose first ~140,000 rate every user and item
SIMILAR_VIEWS = 160_000
#: queries of the similar phase's legs
SIMILAR_QUERIES = 64
FOLLOW_QUERIES = 32
#: DIMSUM's item ceiling (ops/dimsum.MAX_ITEMS) and the tolerance of
#: tests/test_other_templates.py::test_dimsum_matches_numpy_cosine
DIMSUM_TOL = 2e-3
DIMSUM_CHECKED = 64


def similar_views(planted, small: bool = False):
    """store-als's planted pairs (:func:`store_als_ratings`) as the
    similarproduct template's events: every 16th a ``like``, the rest
    ``view``s; the first ``SIMILAR_VIEWS`` of them unless ``small``.
    Returns (users, items, is_like, n_users, n_items)."""
    users, items, _r, n_users, n_items = store_als_ratings(planted, small)
    if not small:
        users, items = users[:SIMILAR_VIEWS], items[:SIMILAR_VIEWS]
    is_like = np.arange(len(users)) % 16 == 0
    return users, items, is_like, n_users, n_items


def import_pairs(app_id: int, users, items, names, user_ids, item_ids,
                 target: str = "item") -> float:
    """(user, target) pairs into the store through ``import_interactions``,
    one call per event name (``names``: a name per pair); the wall."""
    from incubator_predictionio_tpu_torch.data.interactions import (
        Interactions,
    )
    from incubator_predictionio_tpu_torch.data.storage import Storage
    from incubator_predictionio_tpu_torch.utils.times import parse_iso8601

    t0 = time.perf_counter()
    for name in sorted(set(names.tolist())):
        m = names == name
        Storage.get_events().import_interactions(
            Interactions(user_idx=users[m], item_idx=items[m],
                         values=np.ones(int(m.sum()), np.float32),
                         user_ids=user_ids, item_ids=item_ids),
            app_id, target_entity_type=target, event_name=str(name),
            value_prop="weight", base_time=parse_iso8601(STORE_T0))
    return time.perf_counter() - t0


def unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v), min=1e-9)


def similar_phase(dev, runtime, kernels, als, planted, params_mod, context,
                  server_mod, small: bool = False) -> tuple:
    """The similarproduct template (``models/similarproduct/``) at ML-20M
    width, in this process. (a) On a fresh SQLite store: the first
    ``SIMILAR_VIEWS`` (160,000) of store-als's planted pairs as ``view``
    events, every 16th a ``like``
    (:func:`similar_views`), the items' ``$set`` categories ``c<id mod
    4>``; ``CoreWorkflow.run_train`` of ``SimilarProductEngine`` at rank
    128, λ 0.01, α 1 (examples/similarproduct-quickstart/engine.json),
    ``SIMILAR_SWEEPS`` sweeps; the fused implicit entry launched and no
    two-stage form; the implicit loss within ``IMPLICIT_LOSS_TOL`` of the
    plain route's from the same initial state; ``load_models``' tables the
    trained ones bit for bit; ``PredictionServer`` with the model: 64
    ``/queries.json`` answers of ``{"items": [...], "num": 10}``, half with
    ``categories`` or ``blackList``, each the plain top-k of the
    normalized mean of the query items' unit rows with the same mask. (b)
    The instance copied to a memory store (SQLite has no tail read) and
    deployed with ``PIO_SERVE_MIPS=on``: the server's overlay (item-side,
    ``index_sink`` into the MIPS index built at deploy) polled by hand
    after the views of a brand-new item, the viewers of the most-viewed
    item X, arrive; the new item folded in (the fused entry), published
    under a virtual id, named by a query that answers (its scores the
    exact dots) and returned under its key by a query for X, at its exact
    score; every answer a 200. (c) ``DIMSUMAlgorithm`` at its ceiling of
    16,384 items on the views of items below 16,384: 64 sampled items'
    top-100 against the exact cosine from ``scipy.sparse`` within
    ``DIMSUM_TOL``; the Gram's ms on the card. (d) The recommended-user
    engine on 250,000 planted ``follow`` pairs among the 138,493 users
    (seed 13) through a memory store (SQLite's import and read of them
    took 17.8 + 6.0 s), rank 128, 4 sweeps: 32 queries through
    the server, each the plain top-k over the 138,493-row unit feature
    table (positive scores only), some with ``whiteList`` /
    ``blackList``. Returns (launches by kernel: the training and query
    legs', and the fold-in's under "foldin", max score error, stats)."""
    import scipy.sparse as sps

    from incubator_predictionio_tpu_torch.data.datamap import DataMap
    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.data.interactions import (
        Interactions,
    )
    from incubator_predictionio_tpu_torch.data.storage import Model, Storage
    from incubator_predictionio_tpu_torch.models.similarproduct import (
        engine as sp,
    )
    from incubator_predictionio_tpu_torch.models.similarproduct import (
        recommended_user as ru,
    )
    from incubator_predictionio_tpu_torch.ops import dimsum, mips
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    rank = 16 if small else ML20M["rank"]
    t_phase = time.perf_counter()
    stats: dict = {"rank": rank}
    #: launches of the phase's legs: the score+top-k kernel's, the fused
    #: entry's in implicit training ((a) and (d)) and in the fold-in ((b))
    launches = {"score_topk": 0, "implicit": 0, "foldin": 0}
    err = 0.0
    users, items, is_like, n_users, n_items = similar_views(planted, small)
    names = np.where(is_like, "like", "view")
    user_ids = [f"u{k}" for k in range(n_users)]
    item_ids = [f"i{k}" for k in range(n_items)]
    eng = sp.SimilarProductEngine().apply()
    ep = params_mod.EngineParams(
        data_source_params=("", sp.DataSourceParams(app_name=SIMILAR_APP)),
        algorithm_params_list=[("als", sp.ALSAlgorithmParams(
            rank=rank, num_iterations=SIMILAR_SWEEPS, lambda_=0.01,
            alpha=1.0, seed=3))])

    def counts(*entries) -> dict:
        got = runtime.launch_counts()
        return {e: got.get(e, 0) for e in entries}

    # -- (a) train, deploy, 64 answers on SQLite ----------------------------
    with temp_store():
        app_id = new_app(SIMILAR_APP)
        stats["import_s"] = import_pairs(app_id, users, items, names,
                                         user_ids, item_ids)
        insert_events(
            [Event(event="$set", entity_type="item", entity_id=item_ids[k],
                   properties=DataMap({"categories": [f"c{k % 4}"]}))
             for k in range(n_items)], app_id)
        kept, states, pds = keep_trained(eng), [], []
        ctx = context.RuntimeContext(device=dev)
        runtime.reset_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        with patched(als, "als_train_implicit",
                     lambda real: lambda *a, **kw: states.append(
                         real(*a, **kw)) or states[-1]), \
                patched(sp.SimilarProductPreparator, "prepare",
                        lambda real: lambda self, c, td: pds.append(
                            real(self, c, td)) or pds[-1]):
            iid = CoreWorkflow.run_train(eng, ep, ctx=ctx)
        sync(dev)
        stats["train_s"] = time.perf_counter() - t0
        stats["phases_s"] = dict(ctx.timings)
        trained = counts("als_fused_solve_cg", "als_solve_cg_rows8",
                         "als_solve_cg")
        launches["implicit"] += trained["als_fused_solve_cg"]
        stats["train_launches"] = trained
        if dev.type == "cuda" and (trained["als_fused_solve_cg"] <= 0
                                   or trained["als_solve_cg_rows8"]
                                   or trained["als_solve_cg"]):
            raise AssertionError(f"similar: training launches {trained}")
        [state], [pd] = states, pds
        t0 = time.perf_counter()
        plain = als.als_train_implicit(
            pd.users, pd.items, pd.weights, len(pd.user_bimap),
            len(pd.item_bimap), rank=rank, iterations=SIMILAR_SWEEPS,
            l2=0.01, alpha=1.0, seed=3, device=dev, use_kernel=False)
        sync(dev)
        stats["plain_train_s"] = time.perf_counter() - t0
        loss = als.implicit_loss(state, pd.users, pd.items, pd.weights,
                                 1.0, 0.01)
        loss_plain = als.implicit_loss(plain, pd.users, pd.items,
                                       pd.weights, 1.0, 0.01)
        rel = abs(loss - loss_plain) / abs(loss_plain)
        stats.update(loss=loss, loss_plain=loss_plain, loss_rel_err=rel)
        if not (np.isfinite(loss) and rel <= IMPLICIT_LOSS_TOL):
            raise AssertionError(f"similar: implicit loss {loss!r} against "
                                 f"the plain route's {loss_plain!r}")
        del plain
        instance = Storage.get_meta_data_engine_instances().get(iid)
        blob = Storage.get_model_data_models().get(iid).models
        [model] = CoreWorkflow.load_models(iid, eng, ep, ctx=ctx)
        table = model.item_factors_norm
        if not (torch.equal(table, kept[0].item_factors_norm)
                and torch.equal(table, sp._unit_rows(state.item_factors))
                and torch.equal(model.user_factors, state.user_factors)):
            raise AssertionError("similar: decoded tables differ from the "
                                 "trained ones")
        rng = np.random.default_rng(21)
        docs = []
        for j in range(SIMILAR_QUERIES):
            q_items = rng.choice(n_items, 1 + j % 3, replace=False)
            doc = {"items": [item_ids[i] for i in q_items], "num": 10}
            if j % 4 == 1:
                doc["categories"] = [f"c{j % 4}", f"c{(j + 1) % 4}"]
            elif j % 4 == 3:
                doc["blackList"] = [item_ids[i] for i in
                                    rng.choice(n_items, 50, replace=False)]
            docs.append(doc)
        srv = server_mod.PredictionServer(eng, ep, [model], device=dev)
        port = srv.start_background()
        try:
            runtime.reset_launch_counts()
            walls, answers = [], []
            for doc in docs:
                t0 = time.perf_counter()
                answers.append(post(port, doc))
                walls.append(time.perf_counter() - t0)
            served = counts("score_topk")["score_topk"]
            launches["score_topk"] += served
        finally:
            srv.stop()
        if dev.type == "cuda" and served < len(docs):
            raise AssertionError(f"similar: score+top-k launched {served}")
        row_cat = np.empty(n_items, np.int64)  # c<k mod 4> of item i<k>
        for name, row in model.item_bimap.items():
            row_cat[row] = int(name[1:]) % 4
        for doc, body in zip(docs, answers):
            rows = [model.item_bimap[i] for i in doc["items"]]
            mask = np.ones(n_items, bool)
            if "categories" in doc:
                mask &= np.isin(row_cat,
                                [int(c[1:]) for c in doc["categories"]])
            for i in doc.get("blackList", ()):
                mask[model.item_bimap[i]] = False
            mask[rows] = False
            qv = unit(table[torch.as_tensor(rows, device=table.device)]
                      .sum(0) / len(rows))
            got = [(model.item_bimap[x["item"]], x["score"])
                   for x in body["itemScores"]]
            err = max(err, hold_top(kernels, dev, qv, table, mask, got, 10,
                                    f"similar {doc['items']}"))
        stats["http_p50_ms"] = 1e3 * statistics.median(walls)
        del srv, model, kept[:], state
    stats["a_s"] = time.perf_counter() - t_phase
    print(f"similar-a: {stats['a_s']:.1f} s", flush=True)

    # -- (b) the item-side overlay and the MIPS index -----------------------
    x_rank = np.bincount(items, minlength=n_items)
    x = int(np.argmax(x_rank))
    new_item = "brand-new-item"
    t0 = time.perf_counter()
    srv = table = None
    with env_set(PIO_SERVE_MIPS="on", PIO_SPEED_POLL_S="3600"), \
            memory_store():
        try:
            app_id = new_app(SIMILAR_APP)
            Storage.get_meta_data_engine_instances().insert(instance)
            Storage.get_model_data_models().insert(Model(iid, blob))
            runtime.reset_launch_counts()
            srv = server_mod.PredictionServer(
                eng, device=dev, config=server_mod.ServerConfig(
                    ip="127.0.0.1", port=0, engine_instance_id=iid))
            port = srv.start_background()
            [ov] = srv._speed_overlays
            algo, model = srv.algorithms[0], srv.models[0]
            table = model.item_factors_norm
            index = mips.index_for(table)
            if ov is None or not ov.enabled or index is None \
                    or ov.index_sink is None:
                raise AssertionError("similar: no overlay or MIPS index")
            viewers = np.nonzero(items == x)[0]
            Storage.get_events().insert_batch([
                Event(event=str(names[k]), entity_type="user",
                      entity_id=user_ids[users[k]],
                      target_entity_type="item", target_entity_id=new_item)
                for k in viewers], app_id)
            polled = ov.poll()
            vec = ov.lookup(new_item)
            gid = getattr(algo, "_mips_virtual_by_key", {}).get(new_item)
            if vec is None or gid is None or gid < len(model.item_bimap) \
                    or index.tail_size() < 1:
                raise AssertionError(f"similar: {new_item} not published "
                                     f"({polled}, gid {gid})")
            vec_t = torch.from_numpy(np.asarray(vec, np.float32)).to(dev)
            x_row = table[model.item_bimap[item_ids[x]]]
            by_x = post(port, {"items": [item_ids[x]], "num": 10})
            by_new = post(port, {"items": [new_item], "num": 10})
            named = {e["item"]: e["score"] for e in by_x["itemScores"]}
            if new_item not in named or not by_new["itemScores"] \
                    or new_item in {e["item"] for e in by_new["itemScores"]}:
                raise AssertionError(f"similar: overlay answers {by_x} "
                                     f"{by_new}")
            for body, qv in ((by_x, x_row), (by_new, unit(vec_t))):
                for e in body["itemScores"]:
                    row = (vec_t if e["item"] == new_item
                           else table[model.item_bimap[e["item"]]])
                    exact = float(qv @ row)
                    if abs(e["score"] - exact) > 1e-5 * max(abs(exact), 1):
                        raise AssertionError(
                            f"similar: {e} against the exact {exact}")
            stats["overlay"] = {
                "x": item_ids[x], "viewers": int(len(viewers)),
                "poll": {k: polled[k] for k in ("solved", "tail_rows")
                         if k in polled},
                "virtual_id": int(gid), "tail": index.tail_size(),
                "new_item_score": named[new_item],
                "new_item_rank": list(named).index(new_item)}
            got = counts("als_fused_solve_cg", "score_topk")
            launches["foldin"] += got["als_fused_solve_cg"]
            launches["score_topk"] += got["score_topk"]
            if dev.type == "cuda" and got["als_fused_solve_cg"] <= 0:
                raise AssertionError("similar: the fold-in launched nothing")
        finally:
            if srv is not None:
                srv.stop()
            if table is not None:
                mips.unregister_index(table)
    stats["overlay_s"] = time.perf_counter() - t0
    print(f"similar-b: {stats['overlay_s']:.1f} s", flush=True)

    # -- (c) DIMSUM at its ceiling ----------------------------------------
    t0 = time.perf_counter()
    n_dim = min(dimsum.MAX_ITEMS, n_items)
    m = items < n_dim
    weights = np.where(is_like, 3.0, 1.0).astype(np.float32)
    pd_d = sp.SimilarProductPreparator().prepare(
        context.RuntimeContext(device=dev), sp.TrainingData(
            interactions=Interactions(
                user_idx=users[m], item_idx=items[m], values=weights[m],
                user_ids=user_ids, item_ids=item_ids[:n_dim])))
    ctx = context.RuntimeContext(device=dev)
    dim = sp.DIMSUMAlgorithm(sp.DIMSUMAlgorithmParams(threshold=0.1,
                                                      top_n=100))
    gram_ms = []

    def timed_gram(real):
        def run(*a, **kw):
            sync(dev)
            t = time.perf_counter()
            out = real(*a, **kw)
            sync(dev)
            gram_ms.append(1e3 * (time.perf_counter() - t))
            return out
        return run

    with patched(dimsum, "gram", timed_gram):
        dmodel = dim.train(ctx, pd_d)
    stats["dimsum_train_s"] = time.perf_counter() - t0
    stats["dimsum_gram_ms"] = gram_ms[0]
    x_sp = sps.csr_matrix((pd_d.weights.astype(np.float64),
                           (pd_d.users, pd_d.items)),
                          shape=(len(pd_d.user_bimap), n_dim))
    gram = (x_sp.T @ x_sp).tocsr()
    norms = np.sqrt(np.maximum(gram.diagonal(), 1e-12))
    worst, rng = 0.0, np.random.default_rng(23)
    rated = np.nonzero(np.diff(gram.indptr) > 1)[0]
    for i in rng.choice(rated, min(DIMSUM_CHECKED, len(rated)),
                        replace=False):
        ref = gram.getrow(i).toarray().ravel() / (norms[i] * norms)
        ref[i] = 0.0
        ref[ref < 0.1] = 0.0
        got = np.zeros(n_dim)
        got[dmodel.sim_indices[i]] = dmodel.sim_scores[i]
        top_ref = np.sort(ref)[::-1][:100]
        worst = max(worst, float(np.abs(np.sort(dmodel.sim_scores[i])[::-1]
                                        - top_ref).max()))
        live = dmodel.sim_scores[i] > 0
        worst = max(worst, float(np.abs(
            dmodel.sim_scores[i][live]
            - ref[dmodel.sim_indices[i][live]]).max(initial=0.0)))
        if worst > DIMSUM_TOL:
            raise AssertionError(f"dimsum: item {i} off the exact cosine by "
                                 f"{worst}")
    top = int(np.argmax(dmodel.sim_scores[:, 0]))
    r = dim.predict(dmodel, sp.Query(items=(pd_d.item_bimap.inverse[top],),
                                     num=10))
    if not r.item_scores:
        raise AssertionError(f"dimsum: item {top} has no neighbours served")
    stats["dimsum"] = {"items": n_dim, "pairs": int(len(pd_d.users)),
                       "max_err": worst, "answer": len(r.item_scores),
                       "with_neighbours": int((dmodel.sim_scores[:, 0] > 0)
                                              .sum()),
                       "padded_rows": int((dmodel.sim_scores == 0)
                                          .any(axis=1).sum())}
    stats["dimsum_s"] = time.perf_counter() - t0
    print(f"similar-c: {stats['dimsum_s']:.1f} s", flush=True)
    del dmodel, gram, x_sp

    # -- (d) recommended-user over the whole user table ---------------------
    t0 = time.perf_counter()
    fu, fv, _r, _h = planted.planted_ratings(
        n_users=n_users, n_items=n_users, nnz=20_000 if small else 250_000,
        seed=13, n_holdout=1, cover=True)
    with memory_store():
        app_id = new_app("follow-app")
        stats["follow_import_s"] = import_pairs(
            app_id, fu, fv, np.full(len(fu), "follow"), user_ids, user_ids,
            target="user")
        ru_eng = ru.RecommendedUserEngine().apply()
        ru_ep = params_mod.EngineParams(
            data_source_params=("", ru.DataSourceParams(app_name="follow-app")),
            algorithm_params_list=[("als", ru.ALSAlgorithmParams(
                rank=rank, num_iterations=4, lambda_=0.01, seed=3))])
        kept = keep_trained(ru_eng)
        ctx = context.RuntimeContext(device=dev)
        runtime.reset_launch_counts()
        ru_iid = CoreWorkflow.run_train(ru_eng, ru_ep, ctx=ctx)
        sync(dev)
        stats["follow_phases_s"] = dict(ctx.timings)
        trained = counts("als_fused_solve_cg", "als_solve_cg_rows8",
                         "als_solve_cg")
        launches["implicit"] += trained["als_fused_solve_cg"]
        if dev.type == "cuda" and (trained["als_fused_solve_cg"] <= 0
                                   or trained["als_solve_cg_rows8"]
                                   or trained["als_solve_cg"]):
            raise AssertionError(f"recommended-user: launches {trained}")
        [rmodel] = CoreWorkflow.load_models(ru_iid, ru_eng, ru_ep, ctx=ctx)
        feats = rmodel.user_features
        if not torch.equal(feats, kept[0].user_features):
            raise AssertionError("recommended-user: decoded table differs")
        rng = np.random.default_rng(29)
        docs = []
        inv = rmodel.user_bimap.inverse
        for j in range(FOLLOW_QUERIES):
            q_rows = rng.choice(len(rmodel.user_bimap), 1 + j % 2,
                                replace=False)
            doc = {"users": [inv[int(r)] for r in q_rows], "num": 10}
            if j % 4 in (1, 3):
                n_known = len(rmodel.user_bimap)
                picked = [inv[int(r)] for r in rng.choice(
                    n_known, min(500, n_known // 2) if j % 4 == 1 else 50,
                    replace=False)]
                doc["whiteList" if j % 4 == 1 else "blackList"] = picked
            docs.append(doc)
        srv = server_mod.PredictionServer(ru_eng, ru_ep, [rmodel], device=dev)
        port = srv.start_background()
        try:
            runtime.reset_launch_counts()
            answers = [post(port, doc) for doc in docs]
            served = counts("score_topk")["score_topk"]
            launches["score_topk"] += served
        finally:
            srv.stop()
        if dev.type == "cuda" and served < len(docs):
            raise AssertionError(f"recommended-user: score+top-k {served}")
        for doc, body in zip(docs, answers):
            rows = [rmodel.user_bimap[u] for u in doc["users"]]
            mask = np.ones(len(rmodel.user_bimap), bool)
            if "whiteList" in doc:
                mask[:] = False
                mask[[rmodel.user_bimap[u] for u in doc["whiteList"]]] = True
            for u in doc.get("blackList", ()):
                mask[rmodel.user_bimap[u]] = False
            mask[rows] = False
            qv = feats[torch.as_tensor(rows, device=feats.device)].sum(0)
            got = [(rmodel.user_bimap[x["user"]], x["score"])
                   for x in body["similarUserScores"]]
            err = max(err, hold_top(kernels, dev, qv, feats, mask, got, 10,
                                    f"recommended-user {doc['users']}",
                                    positive=True))
        stats["follow"] = {"users": len(rmodel.user_bimap),
                           "pairs": int(len(fu)),
                           "answers": sum(len(b["similarUserScores"])
                                          for b in answers)}
    stats["follow_s"] = time.perf_counter() - t0
    stats["launches"] = dict(launches)
    stats["wall_s"] = time.perf_counter() - t_phase
    return launches, err, stats


# -- classification, regression, friendrecommendation, stock ---------------

#: (a) the classification quickstart's users, drawn by its
#: import_events.py's law (which plants 200): a depth cut from 50,000 for
#: the run's time limit (T1: the phase took 58.4 s, of it 11.1 s the
#: 100,000 one-by-one eval queries of 50,000 users)
CLF_USERS = 20_000
#: (b) the regression quickstart's points (import_points.py's law), written
#: in the reference examples' lr_data.txt format: a depth cut from 100,000
#: (T1: 17.4 s of eval, two predicts for each of 100,000 queries)
REG_POINTS = 40_000
#: (c) SimRank at its dense ceiling (ops/simrank.MAX_NODES): 8,192 users
#: and 8,192 items, 65,536 follow edges, the quickstart's keyword maps on
#: 2,048 users and 2,048 items
FR_USERS = 8_192
FR_EDGES = 65_536
FR_KEYWORDED = 2_048
#: (d) S&P-500 width: 500 tickers and SPY over 300 trading days, the
#: backtest over days 270-298
STOCK_TICKERS = 500
STOCK_DAYS = 300
STOCK_EVAL_FROM = 270
STOCK_EVAL_DAYS = 29
TEMPLATE_QUERIES = 64
TEMPLATE_SIDE_QUERIES = 32
#: the bounds the phase holds, each set after the first run of the phase
#: (T1: 50,000 users and 100,000 points, the other legs as now) on an H100
#: 80GB HBM3 at 700.00 W; what T1 measured is in each comment. The best
#: accuracy above chance (1/3): T1 read 0.638 for both candidates
CLF_ACCURACY_MARGIN = 0.2
#: |w − w_cpu| of logistic regression (T1: 1.2e-6, max |w| 0.84)
LOGREG_CARD_TOL = 1e-5
#: |w − lstsq| of the linear fit (T1: 3.0e-7 on weights of magnitude 2)
LINREG_LSTSQ_TOL = 1e-5
#: |w − w_cpu| of SGD (T1: 0, the same f32 steps)
SGD_CARD_TOL = 1e-6
#: SimRank's f32 matrix against the f64 iteration, and S − Sᵀ (T1: 4.7e-8
#: and 3.0e-8)
SIMRANK_F64_TOL = 1e-6
#: the stock weights against the f64 solves, over max |w| (T1: 1.5e-4;
#: f32 normal equations of near-collinear shift returns)
STOCK_F64_TOL = 2e-3

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples")


def quickstart_variant(name: str, datasource: dict, algorithms=None) -> dict:
    """The ``engine.json`` of ``examples/<name>-quickstart``, its data
    source's params updated by ``datasource`` and its algorithms replaced
    by ``algorithms`` when given. Its ``engineFactory`` names the JAX
    package's module, which the port's CLI maps to its own."""
    with open(os.path.join(EXAMPLES, f"{name}-quickstart",
                           "engine.json")) as f:
        variant = json.load(f)
    variant["datasource"]["params"].update(datasource)
    if algorithms is not None:
        variant["algorithms"] = algorithms
    return variant


def pio_in_process(work: str, dev, *argv) -> list:
    """:func:`cli` run from ``work``, on the card unless ``dev`` is the
    CPU; its standard output's lines."""
    saved_term = signal.getsignal(signal.SIGTERM)
    cwd = os.getcwd()
    try:
        os.chdir(work)
        with env_set(PIO_DEVICE="cpu" if dev.type == "cpu" else None):
            out = cli(*argv)
    finally:
        os.chdir(cwd)
        signal.signal(signal.SIGTERM, saved_term)
    return out.strip().splitlines()


def pio_train(work: str, dev, variant: dict, stats: dict) -> str:
    """``pio train`` of ``variant`` (written as ``work``/engine.json); the
    instance id it prints. The instance's phase walls go into
    ``stats["phases_s"]``."""
    from incubator_predictionio_tpu_torch.data.storage import Storage

    with open(os.path.join(work, "engine.json"), "w") as f:
        json.dump(variant, f)
    lines = pio_in_process(work, dev, "train")
    if not lines or not lines[-1].startswith(
            "Training completed. Engine instance ID: "):
        raise AssertionError(f"pio train: {lines}")
    iid = lines[-1].rsplit(" ", 1)[1]
    conf = Storage.get_meta_data_engine_instances().get(iid).runtime_conf
    stats["phases_s"] = {k: float(v) for k, v in conf.items()
                         if k.startswith("phase.")}
    return iid


def pio_eval(work: str, dev, name: str, source: str) -> tuple:
    """``pio eval <name>:evaluation <name>:engine_params_generator`` with
    ``source`` written as ``work``/<name>.py (a module importing the
    port); checks that the instance is EVALCOMPLETED and stored the
    one-liner the CLI printed. Returns (one-liner, the stored JSON
    result)."""
    from incubator_predictionio_tpu_torch.data.storage import Storage

    with open(os.path.join(work, f"{name}.py"), "w") as f:
        f.write(source)
    try:
        lines = pio_in_process(work, dev, "eval", f"{name}:evaluation",
                               f"{name}:engine_params_generator")
    finally:
        sys.modules.pop(name, None)
    if len(lines) < 2 or not lines[-1].startswith(
            "Evaluation completed. Instance ID: "):
        raise AssertionError(f"pio eval {name}: {lines}")
    inst = Storage.get_meta_data_evaluation_instances().get(
        lines[-1].rsplit(" ", 1)[1])
    if inst is None or inst.status != "EVALCOMPLETED" \
            or inst.evaluator_results != lines[-2]:
        raise AssertionError(f"pio eval {name}: instance "
                             f"{inst and inst.status}, {lines[-2:]}")
    return lines[-2], json.loads(inst.evaluator_results_json)


def serve_docs(dev, server_mod, eng, ep, models, docs) -> tuple:
    """``docs`` through ``/queries.json`` of an in-process
    ``PredictionServer`` on ``models``: (answers, host ms of each)."""
    srv = server_mod.PredictionServer(eng, ep, models, device=dev)
    port = srv.start_background()
    answers, walls = [], []
    try:
        for doc in docs:
            t0 = time.perf_counter()
            answers.append(post(port, doc))
            walls.append(1e3 * (time.perf_counter() - t0))
    finally:
        srv.stop()
    return answers, walls


def captured_calls(obj, name: str, calls: list):
    """``patched`` so that each call of ``obj.name`` appends (args,
    kwargs, result, host seconds) to ``calls``."""
    def wrap(real):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = real(*a, **kw)
            calls.append((a, kw, out, time.perf_counter() - t0))
            return out
        return run
    return patched(obj, name, wrap)


CLF_EVAL_MODULE = '''"""Classification evaluation objects, importing the port: the exact-label
accuracy of naive Bayes at lambda 1.0 and 10.0 over three folds.

Run with:
    pio eval clf_evaluation:evaluation clf_evaluation:engine_params_generator
"""

from incubator_predictionio_tpu_torch.core.evaluation import Evaluation
from incubator_predictionio_tpu_torch.core.params import (
    EngineParams,
    EngineParamsGenerator,
)
from incubator_predictionio_tpu_torch.models.classification import (
    ClassificationEngine,
    DataSourceParams,
    NaiveBayesAlgorithmParams,
)
from incubator_predictionio_tpu_torch.models.classification.engine import (
    AccuracyMetric,
)

evaluation = Evaluation()
evaluation.engine_metric = (ClassificationEngine().apply(), AccuracyMetric())


class _Generator(EngineParamsGenerator):
    engine_params_list = [
        EngineParams(
            data_source_params=("", DataSourceParams(app_name={app!r},
                                                     eval_k=3)),
            algorithm_params_list=[
                ("naive", NaiveBayesAlgorithmParams(lambda_=lam))],
        )
        for lam in (1.0, 10.0)
    ]


engine_params_generator = _Generator()
'''


def clf_users(n: int, seed: int = 3) -> tuple:
    """(plan [n], attrs [n, 3]) by the law of examples/
    classification-quickstart/import_events.py: plan uniform on {0, 1, 2},
    attr0 = 10·plan + U{0..9}, attr1 = U{0..5} + plan, attr2 = U{0..3}
    (numpy's generator in place of ``random``)."""
    rng = np.random.default_rng(seed)
    plan = rng.integers(0, 3, n)
    attrs = np.stack([10 * plan + rng.integers(0, 10, n),
                      rng.integers(0, 6, n) + plan,
                      rng.integers(0, 4, n)], axis=1)
    return plan, attrs


def classification_leg(dev, server_mod, small: bool = False
                       ) -> tuple:
    """(a) The classification template at the quickstart's width (3
    attributes, 3 plans): ``CLF_USERS`` users' ``$set`` events
    (:func:`clf_users`, seed 3) on a fresh memory store; ``pio train`` of
    the quickstart's engine.json (naive Bayes at λ 1.0; logistic
    regression, 300 Adam steps at lr 0.1, l2 1e-4) on the card; 64
    ``/queries.json`` answers of the deployed models (naive Bayes serves,
    ``FirstServing``), each the argmax of the model's log-scores computed
    in f64 on the host, except near-ties; the card's logistic-regression
    weights against the port's fit on CPU tensors of the same prepared
    data, within ``LOGREG_CARD_TOL``; ``pio eval`` of
    ``AccuracyMetric`` over naive Bayes at λ 1.0 and 10.0 in three folds
    (``CLF_EVAL_MODULE``), EVALCOMPLETED, the best accuracy above 1/3 by
    ``CLF_ACCURACY_MARGIN``. Returns (max error, stats)."""
    from incubator_predictionio_tpu_torch.cli import commands
    from incubator_predictionio_tpu_torch.data.datamap import DataMap
    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.models.classification import (
        engine as clf,
    )
    from incubator_predictionio_tpu_torch.ops import logreg
    from incubator_predictionio_tpu_torch.parallel.context import (
        RuntimeContext,
    )
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    n = 900 if small else CLF_USERS
    app = "clf-app"
    walls: dict = {}
    stats: dict = {"users": n, "walls_s": walls}
    with memory_store(), tempfile.TemporaryDirectory(
            prefix="pio_clf_") as work:
        t0 = time.perf_counter()
        app_id = new_app(app)
        plan, attrs = clf_users(n)
        insert_events([
            Event(event="$set", entity_type="user", entity_id=f"u{k}",
                  properties=DataMap({"attr0": int(a[0]), "attr1": int(a[1]),
                                      "attr2": int(a[2]), "plan": int(p)}))
            for k, (p, a) in enumerate(zip(plan, attrs))], app_id)
        walls["import"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        variant = quickstart_variant("classification", {"appName": app})
        pds: list = []
        with captured_calls(clf.ClassificationPreparator, "prepare", pds):
            iid = pio_train(work, dev, variant, stats)
        sync(dev)
        walls["train"] = time.perf_counter() - t0
        pd = pds[0][2]

        t0 = time.perf_counter()
        eng, ep = commands.engine_from_variant(variant)
        models = CoreWorkflow.load_models(iid, eng, ep,
                                          ctx=RuntimeContext(device=dev))
        nbm, lrm = models
        _p, q_attrs = clf_users(TEMPLATE_QUERIES, seed=4)
        docs = [{"features": [float(v) for v in row]} for row in q_attrs]
        answers, http_ms = serve_docs(dev, server_mod, eng, ep,
                                      models, docs)
        walls["serve"] = time.perf_counter() - t0
        theta = nbm.nb.theta.double().cpu().numpy()
        pi = nbm.nb.pi.double().cpu().numpy()
        near_ties = 0
        for doc, body in zip(docs, answers):
            s = np.asarray(doc["features"]) @ theta.T + pi
            top = np.argsort(-s, kind="stable")
            if body["label"] != nbm.label_values[top[0]]:
                if s[top[0]] - s[top[1]] > 1e-5 * abs(s[top[0]]):
                    raise AssertionError(f"classification: {doc} answered "
                                         f"{body}, host scores {s}")
                near_ties += 1

        t0 = time.perf_counter()
        cpu = logreg.logreg_fit(
            torch.from_numpy(pd.features), torch.from_numpy(pd.labels),
            n_classes=len(pd.label_values), steps=300, learning_rate=0.1,
            l2=1e-4)
        err = max(float((lrm.lr.weights.cpu() - cpu.weights).abs().max()),
                  float((lrm.lr.bias.cpu() - cpu.bias).abs().max()))
        if not err <= LOGREG_CARD_TOL:
            raise AssertionError(f"classification: logreg on {dev} off the "
                                 f"CPU fit by {err}")
        walls["check"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        _one_liner, result = pio_eval(work, dev, "clf_evaluation",
                                      CLF_EVAL_MODULE.format(app=app))
        walls["eval"] = time.perf_counter() - t0
        scores = [s["score"]["score"] for s in result["engineParamsScores"]]
        if not max(scores) > 1 / 3 + CLF_ACCURACY_MARGIN:
            raise AssertionError(f"classification: accuracy {scores}")
    stats.update(logreg_card_vs_cpu=err, near_ties=near_ties,
                 accuracy=scores,
                 logreg_max_abs_w=float(lrm.lr.weights.abs().max()),
                 http_p50_ms=statistics.median(http_ms))
    return err, stats


REG_EVAL_MODULE = '''"""Regression evaluation objects, importing the port: the mean square
error of the linear and SGD models under AverageServing over three folds of
an lr_data.txt file.

Run with:
    pio eval reg_evaluation:evaluation reg_evaluation:engine_params_generator
"""

from incubator_predictionio_tpu_torch.core.evaluation import Evaluation
from incubator_predictionio_tpu_torch.core.params import (
    EngineParams,
    EngineParamsGenerator,
)
from incubator_predictionio_tpu_torch.models.regression import (
    DataSourceParams,
    LinearAlgorithmParams,
    MeanSquareError,
    RegressionEngine,
    SGDAlgorithmParams,
)

evaluation = Evaluation()
evaluation.engine_metric = (RegressionEngine().apply(), MeanSquareError())


class _Generator(EngineParamsGenerator):
    engine_params_list = [
        EngineParams(
            data_source_params=("", DataSourceParams(filepath={path!r},
                                                     eval_k=3)),
            algorithm_params_list=[
                ("linear", LinearAlgorithmParams(l2=0.0)),
                ("sgd", SGDAlgorithmParams(num_iterations=200,
                                           step_size=0.1))],
        )
    ]


engine_params_generator = _Generator()
'''


def reg_points(n: int, seed: int = 5) -> tuple:
    """(x [n, 3], y [n]) by the law of examples/regression-quickstart/
    import_points.py: x ~ N(0, 1), y = x·(2, −1, 0.5) + 0.7 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    y = x @ np.array([2.0, -1.0, 0.5]) + 0.7 + rng.normal(0, 0.1, n)
    return x, y


def regression_leg(dev, server_mod, small: bool = False) -> tuple:
    """(b) The regression template at the quickstart's width (3 features):
    ``REG_POINTS`` planted points (:func:`reg_points`, seed 5) written as
    ``label f0 f1 f2`` rows (the reference examples' lr_data.txt) and read
    through the data source's ``filepath``; ``pio train`` of the
    quickstart's engine.json (``linear`` at l2 0, ``sgd`` at 200 steps of
    0.1, under ``AverageServing``) on the card; the linear weights within
    ``LINREG_LSTSQ_TOL`` of ``numpy.linalg.lstsq`` in f64 on the same
    (f32) points; the SGD weights within ``SGD_CARD_TOL`` of the port's
    fit on CPU tensors; 64 ``/queries.json`` answers, each the mean of the
    two models' predictions computed in f64 on the host (rtol 1e-5);
    ``pio eval`` of ``MeanSquareError`` over three folds
    (``REG_EVAL_MODULE``), EVALCOMPLETED, the MSE within 10% of the noise's
    variance 0.01. Returns (max error, stats)."""
    from incubator_predictionio_tpu_torch.cli import commands
    from incubator_predictionio_tpu_torch.models.regression import (
        engine as reg,
    )
    from incubator_predictionio_tpu_torch.ops import linreg
    from incubator_predictionio_tpu_torch.parallel.context import (
        RuntimeContext,
    )
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    n = 3_000 if small else REG_POINTS
    walls: dict = {}
    stats: dict = {"points": n, "walls_s": walls}
    with memory_store(), tempfile.TemporaryDirectory(
            prefix="pio_reg_") as work:
        t0 = time.perf_counter()
        x, y = reg_points(n)
        path = os.path.join(work, "lr_data.txt")
        np.savetxt(path, np.column_stack([y, x]), fmt="%.17g")
        walls["import"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        variant = quickstart_variant("regression", {"filepath": path})
        pds: list = []
        with captured_calls(reg.RegressionPreparator, "prepare", pds):
            iid = pio_train(work, dev, variant, stats)
        sync(dev)
        walls["train"] = time.perf_counter() - t0
        pd = pds[0][2]

        t0 = time.perf_counter()
        eng, ep = commands.engine_from_variant(variant)
        models = CoreWorkflow.load_models(iid, eng, ep,
                                          ctx=RuntimeContext(device=dev))
        w_lin, w_sgd = (m.weights.cpu().numpy().astype(np.float64)
                        for m in models)
        q, _ = reg_points(TEMPLATE_QUERIES, seed=6)
        docs = [{"features": [float(v) for v in row]} for row in q]
        answers, http_ms = serve_docs(dev, server_mod, eng, ep,
                                      models, docs)
        walls["serve"] = time.perf_counter() - t0
        qa = np.column_stack([q.astype(np.float32).astype(np.float64),
                              np.ones(len(q))])
        want = (qa @ w_lin + qa @ w_sgd) / 2
        got = np.asarray(answers, np.float64)
        serve_err = float(np.abs(got - want).max())
        if not np.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"regression: served {got} against {want}")

        t0 = time.perf_counter()
        xa = np.column_stack([pd.features.astype(np.float64),
                              np.ones(len(pd.labels))])
        ref = np.linalg.lstsq(xa, pd.labels.astype(np.float64),
                              rcond=None)[0]
        lin_err = float(np.abs(w_lin - ref).max())
        cpu = linreg.linreg_fit_sgd(torch.from_numpy(pd.features),
                                    torch.from_numpy(pd.labels), steps=200,
                                    step_size=0.1).numpy()
        sgd_err = float(np.abs(w_sgd - cpu).max())
        if not (lin_err <= LINREG_LSTSQ_TOL and sgd_err <= SGD_CARD_TOL):
            raise AssertionError(f"regression: linear {lin_err} off lstsq, "
                                 f"sgd {sgd_err} off the CPU fit")
        walls["check"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        _one_liner, result = pio_eval(work, dev, "reg_evaluation",
                                      REG_EVAL_MODULE.format(path=path))
        walls["eval"] = time.perf_counter() - t0
        mse = result["engineParamsScores"][0]["score"]["score"]
        if not abs(mse - 0.01) <= 0.1 * 0.01:
            raise AssertionError(f"regression: MSE {mse}")
    stats.update(linear_vs_lstsq=lin_err, sgd_card_vs_cpu=sgd_err,
                 served_err=serve_err, weights=ref.tolist(), mse=mse,
                 http_p50_ms=statistics.median(http_ms))
    return max(lin_err, sgd_err, serve_err), stats


def fr_graph(n_users: int, n_edges: int, seed: int = 11) -> tuple:
    """(src user ids [E], dst node ids [E], dst is an item [E]): ``follow``
    edges from users to users or items, over ``n_users`` users and as many
    items. The first ``2 · n_users`` edges go to every node once, from every
    user twice, so every node is an endpoint; the rest are uniform."""
    rng = np.random.default_rng(seed)
    n_nodes = 2 * n_users
    dst = np.concatenate([rng.permutation(n_nodes),
                          rng.integers(0, n_nodes, n_edges - n_nodes)])
    src = np.concatenate([np.arange(n_nodes) % n_users,
                          rng.integers(0, n_users, n_edges - n_nodes)])
    return src, dst % n_users, dst >= n_users


def fr_keywords(rng, n: int) -> list:
    """``n`` keyword maps by examples/friendrecommendation-quickstart/
    import_events.py's law: 6 of 40 keywords, each weighted by a uniform
    draw rounded to 3 places."""
    vocab = [f"kw{k}" for k in range(40)]
    return [{vocab[k]: round(float(w), 3)
             for k, w in zip(rng.choice(40, 6, replace=False),
                             rng.random(6))}
            for _ in range(n)]


def friendrec_leg(dev, server_mod, small: bool = False) -> tuple:
    """(c) The friend-recommendation template at SimRank's dense ceiling of
    16,384 nodes: ``FR_EDGES`` planted ``follow`` edges (:func:`fr_graph`,
    seed 11) among 8,192 users and 8,192 items, every node an endpoint,
    and keyword ``$set``s (:func:`fr_keywords`) on 2,048 users and 2,048
    items, on a fresh memory store; ``pio train`` of the quickstart's
    engine.json with SimRank first (the template's defaults: decay 0.8,
    7 iterations), then the keyword and random algorithms. The model's
    matrix is 16,384² f32, 1 GiB: the blob is above SQLite's length limit
    (``SQLITE_LIMIT_LENGTH``, read from the library and printed), so this
    leg keeps models on the memory store, as the JAX package would have
    to. Checks: the same iteration in f64 on the card from the same W
    within ``SIMRANK_F64_TOL`` of the f32 matrix; the matrix symmetric to
    the same bound and its diagonal exactly 1; the decoded matrix the
    trained one bit for bit; 64 ``/queries.json`` answers (half naming a
    user in the item slot, the template's fallback) each S[a, b]; the
    keyword and random algorithms 32 answers each, equal to a plain host
    recomputation. Prints the iteration's device ms, the blob's bytes and
    the ``dumps`` / ``loads`` walls. Returns (max error, stats)."""
    import sqlite3
    import zlib

    from incubator_predictionio_tpu_torch.cli import commands
    from incubator_predictionio_tpu_torch.data.datamap import DataMap
    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.data.storage import Storage
    from incubator_predictionio_tpu_torch.models.friendrecommendation import (
        engine as fr,
    )
    from incubator_predictionio_tpu_torch.ops import simrank as simrank_mod
    from incubator_predictionio_tpu_torch.parallel.context import (
        RuntimeContext,
    )
    from incubator_predictionio_tpu_torch.workflow import checkpoint
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    n_users = 256 if small else FR_USERS
    n_edges = 2_048 if small else FR_EDGES
    n_kw = 64 if small else FR_KEYWORDED
    walls: dict = {}
    stats: dict = {"nodes": 2 * n_users, "edges": n_edges,
                   "model_store": "memory", "walls_s": walls}
    with memory_store(), tempfile.TemporaryDirectory(
            prefix="pio_fr_") as work:
        t0 = time.perf_counter()
        app_id = new_app("fr-app")
        src, dst, to_item = fr_graph(n_users, n_edges)
        rng = np.random.default_rng(12)
        kw_users, kw_items = fr_keywords(rng, n_kw), fr_keywords(rng, n_kw)
        events = [Event(event="follow", entity_type="user",
                        entity_id=f"u{s}",
                        target_entity_type="item" if it else "user",
                        target_entity_id=f"i{d}" if it else f"u{d}")
                  for s, d, it in zip(src, dst, to_item)]
        events += [Event(event="$set", entity_type=etype,
                         entity_id=f"{etype[0]}{k}",
                         properties=DataMap({"keywords": kw}))
                   for etype, maps in (("user", kw_users),
                                       ("item", kw_items))
                   for k, kw in enumerate(maps)]
        insert_events(events, app_id)
        del events
        walls["import"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        variant = quickstart_variant("friendrecommendation",
                                     {"appName": "fr-app"}, [
            {"name": "simrank", "params": {}},
            {"name": "keyword", "params": {}},
            {"name": "random", "params": {}}])
        graphs, iterations, dumps, loads = [], [], [], []

        def device_timed(real):
            def run(w_norm, decay, iters):
                if w_norm.is_cuda:
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
                    start.record()
                    s = real(w_norm, decay, iters)
                    end.record()
                    end.synchronize()
                    iterations.append(start.elapsed_time(end))
                else:
                    t = time.perf_counter()
                    s = real(w_norm, decay, iters)
                    iterations.append(1e3 * (time.perf_counter() - t))
                return s
            return run

        with captured_calls(fr, "simrank", graphs), \
                captured_calls(checkpoint, "dumps", dumps), \
                patched(simrank_mod, "simrank_iterate", device_timed):
            iid = pio_train(work, dev, variant, stats)
        walls["train"] = time.perf_counter() - t0
        blob_bytes = len(Storage.get_model_data_models().get(iid).models)

        t0 = time.perf_counter()
        eng, ep = commands.engine_from_variant(variant)
        with captured_calls(checkpoint, "loads", loads):
            models = CoreWorkflow.load_models(iid, eng, ep,
                                              ctx=RuntimeContext(device=dev))
        walls["load"] = time.perf_counter() - t0
        sm, km, rm = models
        trained = graphs[0][2]
        if not np.array_equal(sm.similarities, trained):
            raise AssertionError("friendrec: the decoded matrix differs")

        t0 = time.perf_counter()
        (g_src, g_dst, n_nodes), g_kw = graphs[0][0], graphs[0][1]
        w64 = simrank_mod.normalized_adjacency(g_src, g_dst, n_nodes, dev,
                                               dtype=torch.float64)
        s64 = simrank_mod.simrank_iterate(w64, g_kw["decay"],
                                          g_kw["iterations"])
        del w64
        s32 = torch.from_numpy(sm.similarities).to(dev)
        f64_err = float((s32.double() - s64).abs().max())
        del s64
        asym = float((s32 - s32.T).abs().max())
        diag_ok = bool((torch.diagonal(s32) == 1).all())
        nonzero = float((s32 != 0).double().mean())
        del s32
        if not (f64_err <= SIMRANK_F64_TOL and asym <= SIMRANK_F64_TOL
                and diag_ok):
            raise AssertionError(f"friendrec: f64 {f64_err}, asymmetry "
                                 f"{asym}, diagonal ones {diag_ok}")
        walls["check"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        rng = np.random.default_rng(14)
        docs = []
        for j in range(TEMPLATE_QUERIES):
            a, b = rng.integers(0, n_users, 2)
            docs.append({"user": f"u{a}",
                         "item": f"i{b}" if j % 2 else f"u{b}"})
        answers, http_ms = serve_docs(dev, server_mod, eng, ep,
                                      models, docs)
        walls["serve"] = time.perf_counter() - t0
        for doc, body in zip(docs, answers):
            a = sm.node_index[f"user:{doc['user']}"]
            b = sm.node_index.get(f"item:{doc['item']}",
                                  sm.node_index.get(f"user:{doc['item']}"))
            want = float(sm.similarities[a, b])
            if body != {"confidence": want,
                        "acceptance": want >= sm.threshold}:
                raise AssertionError(f"friendrec: {doc} answered {body}, "
                                     f"S[a, b] {want}")

        (_sim, keyword, random_algo), _serving = eng.components(ep)
        kw_of = {("user", f"u{k}"): kw for k, kw in enumerate(kw_users)}
        kw_of.update({("item", f"i{k}"): kw for k, kw in enumerate(kw_items)})
        kw_err = 0.0
        for j in range(TEMPLATE_SIDE_QUERIES):
            # half the pairs both keyworded, the rest one side or neither
            u = rng.integers(0, n_kw if j % 4 else n_users)
            i = rng.integers(0, n_kw if j % 4 != 3 else n_users)
            query = fr.Query(user=f"u{u}", item=f"i{i}")
            pu = kw_of.get(("user", query.user), {})
            pi = kw_of.get(("item", query.item), {})
            want = sum(w * pi.get(t, 0.0) for t, w in pu.items())
            got = keyword.predict(km, query)
            kw_err = max(kw_err, abs(got.confidence - want))
            if kw_err > 1e-12 or got.acceptance != (
                    got.confidence * km.sim_weight >= km.sim_threshold):
                raise AssertionError(f"friendrec keyword: {query} {got}, "
                                     f"host {want}")
            key = f"{rm.seed}\x00{query.user}\x00{query.item}".encode()
            want_r = float(np.random.default_rng(zlib.crc32(key)).random())
            got_r = random_algo.predict(rm, query)
            if got_r.confidence != want_r \
                    or got_r.acceptance != (want_r >= rm.threshold):
                raise AssertionError(f"friendrec random: {query} {got_r}, "
                                     f"host {want_r}")
    stats.update(
        simrank_device_ms=iterations[0], f64_err=f64_err, asymmetry=asym,
        nonzero_share=nonzero, blob_bytes=blob_bytes,
        sqlite_limit_length=sqlite3.connect(":memory:").getlimit(
            sqlite3.SQLITE_LIMIT_LENGTH),
        dumps_s=dumps[0][3], loads_s=loads[0][3],
        train_wall_s=graphs[0][3], keyword_err=kw_err,
        http_p50_ms=statistics.median(http_ms))
    if stats["blob_bytes"] <= stats["sqlite_limit_length"] and not small:
        raise AssertionError(f"friendrec: a {blob_bytes}-byte blob fits "
                             "SQLite's limit; the leg's premise is wrong")
    return max(f64_err, asym, kw_err), stats


STOCK_EVAL_MODULE = '''"""Stock evaluation objects, importing the port: the momentum and
regression strategies backtested over days {lo} to {hi}.

Run with:
    pio eval stock_evaluation:evaluation stock_evaluation:engine_params_generator
"""

from incubator_predictionio_tpu_torch.core.evaluation import Evaluation
from incubator_predictionio_tpu_torch.core.params import (
    EngineParams,
    EngineParamsGenerator,
)
from incubator_predictionio_tpu_torch.models.stock import (
    BacktestingEvaluator,
    BacktestingParams,
    DataSourceParams,
    MomentumStrategyParams,
    RegressionStrategyParams,
    StockEngine,
)

evaluation = Evaluation()
evaluation.engine_evaluator = (
    StockEngine().apply(),
    BacktestingEvaluator(BacktestingParams(
        enter_threshold=0.001, exit_threshold=-0.001, max_positions=10)))


class _Generator(EngineParamsGenerator):
    engine_params_list = [
        EngineParams(
            data_source_params=("", DataSourceParams(
                app_name={app!r}, eval_from_idx={lo}, eval_days={days})),
            algorithm_params_list=[algo],
        )
        for algo in (("momentum", MomentumStrategyParams(window=5)),
                     ("regression", RegressionStrategyParams()))
    ]


engine_params_generator = _Generator()
'''


def stock_panel(n_tickers: int, n_days: int, seed: int = 13) -> tuple:
    """(tickers, prices [days, tickers + 1], first listed day [tickers +
    1]): each ticker compounds a drift of U(−1%, 1%) a day with noise of
    U(0.2%, 2%) (tests/test_stock_template.py's fixture plants ±1% and
    0.2%), SPY last with 0.05% noise; every 50th ticker lists mid-panel,
    on a day of 50-199 (test_gappy_ticker_is_masked_not_poisoned lists one
    on day 50)."""
    rng = np.random.default_rng(seed)
    drift = rng.uniform(-0.01, 0.01, n_tickers)
    noise = rng.uniform(0.002, 0.02, n_tickers)
    steps = 1 + drift + noise * rng.standard_normal((n_days, n_tickers))
    spy = 1 + 0.0005 * rng.standard_normal((n_days, 1))
    prices = 100.0 * np.cumprod(np.concatenate([steps, spy], axis=1), axis=0)
    listed = np.zeros(n_tickers + 1, np.int64)
    listed[:n_tickers:50] = rng.integers(50, 200, len(listed[:n_tickers:50]))
    tickers = [f"T{k:03d}" for k in range(n_tickers)] + ["SPY"]
    return tickers, prices, listed


def stock_leg(dev, server_mod, small: bool = False) -> tuple:
    """(d) The stock template at S&P-500 width: ``STOCK_TICKERS`` tickers
    and SPY, ``STOCK_DAYS`` trading days of planted prices
    (:func:`stock_panel`, seed 13; at most 150,300 ``price`` events) on a
    fresh memory store; ``pio train`` of the quickstart's engine.json
    with the regression strategy (periods 1, 5 and 22 over a 250-day
    window, l2 1e-4) first and momentum (window 5) second; the regression
    weights, one batched solve on the card, within ``STOCK_F64_TOL`` ·
    max|w| of per-ticker f64 numpy ridge solves of the same (f32) inputs;
    32 day queries through ``/queries.json``, each ticker's score the f64
    host product of its features and weights (rtol 1e-12) and the tickers
    scored those with every indicator defined; ``pio eval`` with
    ``BacktestingEvaluator`` over days 270-298 (``evalFromIdx`` 270,
    ``evalDays`` 29) for both strategies (``STOCK_EVAL_MODULE``),
    EVALCOMPLETED, its one-liner stored and printed, 29 daily rows dated.
    Returns (max error, stats)."""
    from datetime import datetime, timedelta, timezone

    from incubator_predictionio_tpu_torch.cli import commands
    from incubator_predictionio_tpu_torch.data.datamap import DataMap
    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.models.stock import engine as stock
    from incubator_predictionio_tpu_torch.parallel.context import (
        RuntimeContext,
    )
    from incubator_predictionio_tpu_torch.workflow.workflow import (
        CoreWorkflow,
    )

    n_tickers = 20 if small else STOCK_TICKERS
    app = "stock-app"
    walls: dict = {}
    stats: dict = {"tickers": n_tickers + 1, "days": STOCK_DAYS,
                   "walls_s": walls}
    with memory_store(), tempfile.TemporaryDirectory(
            prefix="pio_stock_") as work:
        t0 = time.perf_counter()
        app_id = new_app(app)
        tickers, prices, listed = stock_panel(n_tickers, STOCK_DAYS)
        day0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
        events = [Event(event="price", entity_type="ticker",
                        entity_id=tickers[j],
                        properties=DataMap({"price": float(prices[d, j])}),
                        event_time=day0 + timedelta(days=d))
                  for d in range(STOCK_DAYS) for j in range(len(tickers))
                  if d >= listed[j]]
        stats["events"] = len(events)
        insert_events(events, app_id)
        del events
        walls["import"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        variant = quickstart_variant("stock", {"appName": app}, [
            {"name": "regression", "params": {}},
            {"name": "momentum", "params": {"window": 5}}])
        fits: list = []
        with captured_calls(stock, "linreg_fit", fits):
            iid = pio_train(work, dev, variant, stats)
        sync(dev)
        walls["train"] = time.perf_counter() - t0

        (x, y), kw, w_dev, _s = fits[0]
        xa = np.concatenate([x.double().cpu().numpy(),
                             np.ones(x.shape[:2] + (1,))], axis=2)
        gram = np.einsum("nsk,nsl->nkl", xa, xa) \
            + kw["l2"] * np.eye(xa.shape[2])
        rhs = np.einsum("nsk,ns->nk", xa, y.double().cpu().numpy())
        ref = np.linalg.solve(gram, rhs[..., None])[..., 0]
        w_err = float(np.abs(w_dev.cpu().numpy() - ref).max()
                      / np.abs(ref).max())
        if not w_err <= STOCK_F64_TOL:
            raise AssertionError(f"stock: regression weights off the f64 "
                                 f"solves by {w_err} of max|w|")

        t0 = time.perf_counter()
        eng, ep = commands.engine_from_variant(variant)
        models = CoreWorkflow.load_models(iid, eng, ep,
                                          ctx=RuntimeContext(device=dev))
        model = models[0]
        td = model.td
        if td.tickers != tuple(sorted(tickers)) or len(td.times) \
                != STOCK_DAYS:
            raise AssertionError(f"stock: panel {len(td.tickers)} × "
                                 f"{len(td.times)}")
        w64 = model.weights.double().cpu().numpy()
        rng = np.random.default_rng(15)
        days = sorted(rng.choice(np.arange(30, STOCK_DAYS),
                                 TEMPLATE_SIDE_QUERIES, replace=False))
        docs = [{"idx": int(d)} for d in days]
        answers, http_ms = serve_docs(dev, server_mod, eng, ep,
                                      models, docs)
        walls["serve"] = time.perf_counter() - t0
        score_err = 0.0
        for doc, body in zip(docs, answers):
            feats, ok = stock._row_log_returns(td.prices, td.active,
                                               doc["idx"], (1, 5, 22))
            aug = np.concatenate([feats, np.ones((len(ok), 1))], axis=1)
            want = (aug * w64).sum(axis=1)
            want = {t: float(want[j]) for j, t in enumerate(td.tickers)
                    if ok[j]}
            got = body["scores"]
            if set(got) != set(want):
                raise AssertionError(f"stock: day {doc['idx']} scored "
                                     f"{len(got)} tickers, want {len(want)}")
            for t, v in want.items():
                score_err = max(score_err, abs(got[t] - v))
                if abs(got[t] - v) > 1e-12 * max(abs(v), 1e-3):
                    raise AssertionError(f"stock: {t} on day {doc['idx']}: "
                                         f"{got[t]} against {v}")

        t0 = time.perf_counter()
        one_liner, result = pio_eval(
            work, dev, "stock_evaluation", STOCK_EVAL_MODULE.format(
                app=app, lo=STOCK_EVAL_FROM, days=STOCK_EVAL_DAYS,
                hi=STOCK_EVAL_FROM + STOCK_EVAL_DAYS - 1))
        walls["eval"] = time.perf_counter() - t0
        daily = result["daily"]
        if len(daily) != STOCK_EVAL_DAYS or daily[0]["time"] != str(
                td.times[STOCK_EVAL_FROM]) or not one_liner.startswith(
                    "ret="):
            raise AssertionError(f"stock: backtest {one_liner}, "
                                 f"{len(daily)} days from {daily[:1]}")
    stats.update(weights_vs_f64=w_err, max_abs_w=float(np.abs(ref).max()),
                 score_err=score_err, eval=one_liner,
                 overall=result["overall"],
                 http_p50_ms=statistics.median(http_ms))
    return max(score_err, w_err), stats


def templates_phase(dev, runtime, server_mod, small: bool = False) -> tuple:
    """The classification, regression, friendrecommendation and stock
    templates (:func:`classification_leg`, :func:`regression_leg`,
    :func:`friendrec_leg`, :func:`stock_leg`), each on a fresh memory
    store, each leg's wall printed as it ends (``templates-a:`` to
    ``templates-d:``). None of them runs a hand-written kernel (their
    device work is PyTorch products, solves and Adam steps, as it is XLA
    work in the JAX package): the launch counts are read and returned, all
    0. Returns (launches by kernel, max error, stats)."""
    t_phase = time.perf_counter()
    runtime.reset_launch_counts()
    stats: dict = {}
    err = 0.0
    for tag, name, leg in (("a", "classification", classification_leg),
                           ("b", "regression", regression_leg),
                           ("c", "friendrec", friendrec_leg),
                           ("d", "stock", stock_leg)):
        t0 = time.perf_counter()
        leg_err, stats[name] = leg(dev, server_mod, small)
        stats[name]["wall_s"] = time.perf_counter() - t0
        err = max(err, leg_err)
        print(f"templates-{tag}: {name} {stats[name]['wall_s']:.1f} s",
              flush=True)
    launches = runtime.launch_counts()
    stats["launches"] = launches
    stats["wall_s"] = time.perf_counter() - t_phase
    return launches, err, stats


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
    print(f"build: {note_wall('build', t0):.1f} s", flush=True)
    from incubator_predictionio_tpu_torch import native

    t0 = time.perf_counter()
    native.load()
    print(f"build-native: {note_wall('build-native', t0):.1f} s", flush=True)
    mode = sys.argv[1:]
    if mode not in ([], ["--flash"], ["--topk"], ["--als"], ["--mips"],
                    ["--eval"], ["--similar"], ["--templates"],
                    ["--remote"], ["--obs"], ["--control"]):
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
    if mode == ["--mips"]:
        t0 = time.perf_counter()
        _l, err, mips_stats = mips_phase(dev, runtime, kernels, planted,
                                         convert, engine, params_mod,
                                         server_mod)
        print(f"mips: {json.dumps(mips_stats)}", flush=True)
        print(f"mips-card: {card_line()} ({note_wall('mips', t0):.1f} s)",
              flush=True)
        print(json.dumps({"mips_ok": True, "max_score_err": err,
                          "kind": torch.cuda.get_device_name(0)}))
        return 0
    if mode == ["--control"]:
        t0 = time.perf_counter()
        _l, err, remote_stats = remote_alone(
            dev, runtime, kernels, als, ak, planted,
            control=lambda fleet: control_phase(
                dev, runtime, kernels, als, server_mod, engine, params_mod,
                convert, fleet))
        _cl, err_c, control_stats = remote_stats.pop("control")
        print(f"remote: {json.dumps(remote_stats)}", flush=True)
        print(f"control: {json.dumps(control_stats)} "
              f"({control_stats['walls_s']['wall_s']:.1f} s)", flush=True)
        print(f"control-card: {card_line()} "
              f"({note_wall('remote+control', t0):.1f} s)", flush=True)
        print(json.dumps({"control_ok": True,
                          "max_score_err": max(err, err_c),
                          "kind": torch.cuda.get_device_name(0)}))
        return 0
    if mode in (["--eval"], ["--similar"], ["--templates"], ["--remote"],
                ["--obs"]):
        t0 = time.perf_counter()
        if mode == ["--obs"]:
            built = build_model(planted, convert, dev, ML20M["users"],
                                ML20M["items"], ML20M["rank"])
            _l, err, one_stats = obs_phase(dev, runtime, kernels, ak, als,
                                           server_mod, engine, params_mod,
                                           built)
        elif mode == ["--remote"]:
            _l, err, one_stats = remote_alone(dev, runtime, kernels, als, ak,
                                              planted)
        elif mode == ["--eval"]:
            _l, err, one_stats = eval_phase(dev, runtime, kernels)
        elif mode == ["--templates"]:
            _l, err, one_stats = templates_phase(dev, runtime, server_mod)
        else:
            _l, err, one_stats = similar_phase(
                dev, runtime, kernels, als, planted, params_mod, context,
                server_mod)
        name = mode[0][2:]
        print(f"{name}: {json.dumps(one_stats)} "
              f"({note_wall(name, t0):.1f} s)", flush=True)
        print(f"{name}-card: {card_line()}", flush=True)
        print(json.dumps({f"{name}_ok": True, "max_score_err": err,
                          "kind": torch.cuda.get_device_name(0)}))
        return 0

    t0 = time.perf_counter()
    err_k, n_cases = kernel_phase(dev, kernels, planted)
    print(f"kernel: {n_cases} cases agree with the plain version, max score "
          f"error {err_k:.3e} ({note_wall('kernel', t0):.1f} s)", flush=True)

    t0 = time.perf_counter()
    als_errs, als_worst, als_checks = als_kernel_phase(dev, ak,
                                                       als.CHUNK_ELEMS)
    edge_checks, edge_worst = als_edge_phase(dev, ak)
    print(f"als-kernel: {als_checks} + {edge_checks} checks agree with the "
          f"plain versions, max abs error {json.dumps(als_errs)}, max "
          f"relative error {json.dumps(als_worst)}, edges "
          f"{json.dumps(edge_worst)} ({note_wall('als-kernel', t0):.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    rank_stats = rank_train_phase(dev, runtime, als, planted)
    print(f"als-rank: {json.dumps(rank_stats)} "
          f"({note_wall('als-rank', t0):.1f} s)", flush=True)

    t0 = time.perf_counter()
    err_f, flash_rel = flash_phase(dev, fa)
    print(f"flash-kernel: {len(flash_rel)} cases agree with the plain "
          f"version, max abs error {err_f:.3e}, relative "
          f"{json.dumps(flash_rel)} ({note_wall('flash-kernel', t0):.1f} s)",
          flush=True)

    t0 = time.perf_counter()
    built = build_model(planted, convert, dev, ML20M["users"],
                        ML20M["items"], ML20M["rank"])
    launches, err_p, stats = path_phase(
        dev, runtime, kernels, planted, convert, engine, params_mod,
        server_mod, ML20M["users"], ML20M["items"], ML20M["rank"], built)
    print(f"path: {json.dumps(stats)} ({note_wall('path', t0):.1f} s)",
          flush=True)

    t0 = time.perf_counter()
    load_launches, err_load, load_stats = serve_load_phase(
        dev, runtime, kernels, server_mod, engine, params_mod, built)
    for leg in load_stats["legs"]:
        print(f"serve-load: {json.dumps(leg)}", flush=True)
    print(f"serve-load-shed: {json.dumps(load_stats['shed'])}", flush=True)
    print(f"serve-load-tenants: {json.dumps(load_stats['tenants'])}",
          flush=True)
    note_wall("serve-load", t0)
    print(f"serve-load-card: {card_line()} "
          f"({load_stats['wall_s']:.1f} s)", flush=True)

    t0 = time.perf_counter()
    obs_launches, err_obs, obs_stats = obs_phase(
        dev, runtime, kernels, ak, als, server_mod, engine, params_mod, built)
    print(f"obs: {json.dumps(obs_stats)} ({note_wall('obs', t0):.1f} s)",
          flush=True)
    print(f"obs-card: {card_line()}", flush=True)
    del built

    t0 = time.perf_counter()
    mips_launches, err_mips, mips_stats = mips_phase(
        dev, runtime, kernels, planted, convert, engine, params_mod,
        server_mod)
    print(f"mips: {json.dumps(mips_stats)}", flush=True)
    print(f"mips-card: {card_line()} ({note_wall('mips', t0):.1f} s)",
          flush=True)

    t0 = time.perf_counter()
    model, pd, eng, ep, train_stats, (u_tree, i_tree, plain) = train_phase(
        dev, runtime, als, engine, base, params_mod, context,
        interactions_mod, planted)
    print(f"train: {json.dumps(train_stats)} ({note_wall('train', t0):.1f} s)",
          flush=True)

    t0 = time.perf_counter()
    trained_launches, err_t, serve_stats = serve_trained_phase(
        dev, runtime, kernels, server_mod, model, pd, eng, ep)
    print(f"serve-trained: {json.dumps(serve_stats)} "
          f"({note_wall('serve-trained', t0):.1f} s)", flush=True)

    t0 = time.perf_counter()
    seq_launches, err_sp, seq_stats = seq_path_phase(
        dev, runtime, tr, fa, seq_engine, seq_convert, planted, params_mod,
        server_mod)
    print(f"seq-path: {json.dumps(seq_stats)} "
          f"({note_wall('seq-path', t0):.1f} s)", flush=True)

    t0 = time.perf_counter()
    wide_launches, err_sw, wide_stats = seq_wide_phase(
        dev, runtime, tr, fa, seq_engine, seq_convert, planted, params_mod,
        server_mod)
    print(f"seq-wide: {json.dumps(wide_stats)} "
          f"({note_wall('seq-wide', t0):.1f} s)", flush=True)

    t0 = time.perf_counter()
    seq_train_launches, err_st, seq_train_stats = seq_train_phase(
        dev, runtime, tr, fa, seq_engine, base, params_mod, context, planted,
        server_mod)
    print(f"seq-train: {json.dumps(seq_train_stats)} "
          f"({note_wall('seq-train', t0):.1f} s)", flush=True)

    t0 = time.perf_counter()
    store_launches, err_sa, store_stats, store_path, sqlite_ref = \
        store_als_phase(dev, runtime, kernels, als, engine, planted,
                        params_mod, context, server_mod)
    print(f"store-als: {json.dumps(store_stats)} "
          f"({note_wall('store-als', t0):.1f} s)", flush=True)

    t0 = time.perf_counter()
    store_seq_launches, err_ss, store_seq_stats = store_seq_phase(
        dev, runtime, tr, fa, seq_engine, planted, params_mod, context,
        server_mod)
    print(f"store-seq: {json.dumps(store_seq_stats)} "
          f"({note_wall('store-seq', t0):.1f} s)", flush=True)

    t0 = time.perf_counter()
    qs_launches, err_qs, qs_stats, (rt_cli_launches, err_rt, rt_cli) = \
        quickstart_phase(dev, runtime, kernels, als, planted,
                         then=lambda qs: retrain_cli_leg(
                             qs, dev, runtime, kernels, als))
    note_wall("quickstart+retrain-cli", t0)
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
    t0 = time.perf_counter()
    log_launches, err_log, log_stats, (speed_out, remote_out) = cpplog_phase(
        dev, runtime, kernels, als, planted, sqlite_ref,
        then=lambda log: (
            speed_phase(dev, runtime, kernels, als, ak, planted, log),
            remote_phase(dev, runtime, kernels, als, ak, log,
                         control=lambda fleet: control_phase(
                             dev, runtime, kernels, als, server_mod, engine,
                             params_mod, convert, fleet))))
    remote_launches, err_remote, remote_stats = remote_out
    control_launches, err_control, control_stats = remote_stats.pop(
        "control")
    WALLS["control"] = control_stats["walls_s"]["wall_s"]
    WALLS["remote"] = remote_stats["walls_s"]["wall_s"] - WALLS["control"]
    note_wall("cpplog+speed", t0)
    WALLS["cpplog+speed"] -= WALLS["remote"] + WALLS["control"]
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
    print(f"remote: {json.dumps(remote_stats)} ({WALLS['remote']:.1f} s)",
          flush=True)
    print(f"remote-card: {card_line()}", flush=True)
    print(f"control: {json.dumps(control_stats)} "
          f"({WALLS['control']:.1f} s)", flush=True)
    print(f"control-card: {card_line()}", flush=True)

    t0 = time.perf_counter()
    rt_loop_launches, rt_loop = retrain_loop_leg(
        dev, runtime, als, planted, pd,
        als.ALSState(user_factors=model.user_factors,
                     item_factors=model.item_factors))
    imp_launches, imp_stats, imp_row = implicit_leg(
        dev, runtime, ak, als, pd, narrow_coo=store_als_ratings(planted))
    rt_stats = dict(cli=rt_cli, loop=rt_loop, implicit=imp_stats)
    note_wall("retrain-loop+implicit", t0)
    print(f"retrain: {json.dumps(rt_stats)} "
          f"({rt_cli['wall_s'] + time.perf_counter() - t0:.1f} s)",
          flush=True)

    t0 = time.perf_counter()
    eval_launches, err_eval, eval_stats = eval_phase(dev, runtime, kernels)
    print(f"eval: {json.dumps(eval_stats)} ({note_wall('eval', t0):.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    sim_launches, err_sim, sim_stats = similar_phase(
        dev, runtime, kernels, als, planted, params_mod, context, server_mod)
    print(f"similar: {json.dumps(sim_stats)} "
          f"({note_wall('similar', t0):.1f} s)", flush=True)
    print(f"similar-card: {card_line()}", flush=True)
    t0 = time.perf_counter()
    tmpl_launches, _err, tmpl_stats = templates_phase(dev, runtime,
                                                      server_mod)
    print(f"templates: {json.dumps(tmpl_stats)} "
          f"({note_wall('templates', t0):.1f} s)", flush=True)
    print(f"templates-card: {card_line()}", flush=True)

    t0 = time.perf_counter()
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
        "launches": launches + load_launches + obs_launches["score_topk"]
        + mips_launches + trained_launches
        + store_launches["score_topk"] + qs_launches["score_topk"]
        + rt_cli_launches["score_topk"] + log_launches["score_topk"]
        + speed_launches["score_topk"] + remote_launches["score_topk"]
        + control_launches["score_topk"] + eval_launches["score_topk"]
        + sim_launches["score_topk"] + tmpl_launches.get("score_topk", 0),
        "max_abs_err": max(err_k, err_p, err_load, err_obs, err_mips, err_t,
                           err_sa, err_qs, err_rt, err_log, err_speed,
                           err_remote, err_control, err_eval, err_sim),
        "ms": head["ms"],
        "graph_ms": head["graph_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "bound_fma_ms": head["bound_fma_ms"],
        "library_ms": head["library_ms"],
        "shapes": shapes,
        # the two-stage route beside the kernel (no Pallas kernel stands
        # behind it, so no bound): the floor's rows of the mips phase
        "mips_two_stage": mips_stats["floor_rows"],
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
            + log_launches.get(entry, 0) + remote_launches.get(entry, 0)
            + control_launches.get(entry, 0)
            + eval_launches.get(entry, 0) + tmpl_launches.get(entry, 0),
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
        + ecom_launches["train"]["als_fused_solve_cg"]
        + sim_launches["implicit"],
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
                     "retrain phase, by the ecommerce template's "
                     "training in the speed phase and by the "
                     "similarproduct and recommended-user trainings in "
                     "the similar phase; timed on its heaviest user chunk",
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
        + ecom_launches["als_fused_solve_cg"] + remote_launches["foldin"]
        + control_launches["foldin"]
        + sim_launches["foldin"] + obs_launches["foldin"],
        "max_abs_err": max([r["max_abs_err"] for r in foldin_rows]
                           + [obs_stats["foldin"]["max_abs_err"]]),
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
                     "ecommerce implicit), by the pio deploy child's "
                     "overlay in the remote phase (recommendation "
                     "explicit, over the storage server), in the "
                     "similar phase (similarproduct's item side, "
                     "implicit) and by the obs phase's profiled solve "
                     "(explicit, ML-20M's item table)",
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
        + store_seq_launches + tmpl_launches.get("flash_attention", 0),
        "max_abs_err": err_f,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "max_score_err": max(err_sp, err_sw, err_st, err_ss),
        "shapes": flash_rows,
    })
    print(f"report: ({note_wall('report', t0):.1f} s)", flush=True)
    total = time.perf_counter() - t_start
    print(f"total: {total:.1f} s", flush=True)
    print(f"walls: {json.dumps(dict(WALLS, total=total))}", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
