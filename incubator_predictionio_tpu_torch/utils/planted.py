"""Seeded planted-factor catalogue generator and its exhaustive host
oracle: the port's own copy of incubator_predictionio_tpu/utils/planted.py,
used by the tests and ``chip_smoke.py``.

The table has the geometry trained factor tables have: cluster structure
(genres), bounded relative within-cluster noise, and a log-normal
popularity (norm) profile, at any item count. Everything is a pure
function of the seed.
"""

from __future__ import annotations

import numpy as np


def planted_item_factors(
    n_items: int,
    rank: int,
    seed: int = 0,
    n_genres: int = 64,
    noise: float = 0.6,
    pop_sigma: float = 0.35,
) -> np.ndarray:
    """[n_items, rank] f32 planted item factor table.

    item = (unit genre center + relative-noise) × log-normal popularity.
    ``noise`` is the within-cluster radius relative to the unit center
    (per-dim sigma = noise/sqrt(rank)); ``pop_sigma`` the log-normal
    sigma of the row norms (the MIPS-relevant norm spread — top-k by
    inner product is popularity-weighted, so the coarse stage must
    survive it)."""
    rng = np.random.default_rng(seed)
    genres = rng.normal(0.0, 1.0, (n_genres, rank))
    genres /= np.maximum(
        np.linalg.norm(genres, axis=1, keepdims=True), 1e-9)
    which = rng.integers(0, n_genres, n_items)
    v = genres[which] + rng.normal(
        0.0, noise / np.sqrt(rank), (n_items, rank))
    v *= rng.lognormal(0.0, pop_sigma, n_items)[:, None]
    return np.ascontiguousarray(v, dtype=np.float32)


def planted_queries(
    item_factors: np.ndarray,
    n_queries: int,
    seed: int = 1,
    mix: int = 3,
) -> np.ndarray:
    """[n_queries, rank] f32 user-like query vectors: each the mean of
    ``mix`` random item rows — the blended-interest shape ALS user
    vectors converge to, and the harder case for a bucketed coarse
    stage than single-item queries."""
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, item_factors.shape[0], (n_queries, mix))
    return np.ascontiguousarray(
        item_factors[picks].mean(axis=1), dtype=np.float32)


def exhaustive_top_k(
    item_factors: np.ndarray,
    queries: np.ndarray,
    k: int,
) -> np.ndarray:
    """[n_queries, k] exact oracle ids (descending score) — the recall
    gate's ground truth, computed on the host so it cannot share a bug
    with the device path under test."""
    scores = queries @ item_factors.T
    part = np.argpartition(scores, -k, axis=1)[:, -k:]
    ps = np.take_along_axis(scores, part, axis=1)
    order = np.argsort(-ps, axis=1, kind="stable")
    return np.take_along_axis(part, order, axis=1)
