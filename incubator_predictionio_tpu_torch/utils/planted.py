"""Seeded planted-factor catalogue generator and its exhaustive host
oracle: the port's own copy of incubator_predictionio_tpu/utils/planted.py,
used by the tests and ``chip_smoke.py``; the planted ratings of the JAX
bench (bench.py:206-249), the training workload at ML-20M shape; and, for
the sequence engine, cyclic sessions and seeded transformer weights.

The table has the geometry trained factor tables have: cluster structure
(genres), bounded relative within-cluster noise, and a log-normal
popularity (norm) profile, at any item count. Everything is a pure
function of the seed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

#: ML-20M's shape (ratings.csv: 138,493 users, 26,744 movies, 20,000,263
#: ratings), the JAX bench's training workload (bench.py:59-65)
ML20M_USERS = 138_493
ML20M_ITEMS = 26_744
ML20M_NNZ = 20_000_000


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


def recall_against_oracle(
    approx_ids: np.ndarray,   # [Q, >=k] approximate ids (any order)
    oracle_ids: np.ndarray,   # [Q, k] exact ids
    k: int,
) -> Tuple[float, float]:
    """(mean recall@k, min per-query recall@k)."""
    recalls = []
    for row in range(oracle_ids.shape[0]):
        got = set(int(i) for i in approx_ids[row] if i >= 0)
        want = set(int(i) for i in oracle_ids[row][:k])
        recalls.append(len(got & want) / max(len(want), 1))
    return float(np.mean(recalls)), float(np.min(recalls))


def _sample_pairs(rng, n: int, n_users: int, n_items: int):
    """Power-law marginals as in bench.py:217-228: items i^-0.55 (the top
    item gets ≈92k of 20M draws), users i^-0.3."""
    iw = (np.arange(n_items) + 1.0) ** -0.55
    items = rng.choice(n_items, n, p=iw / iw.sum()).astype(np.int32)
    uw = (np.arange(n_users) + 1.0) ** -0.3
    users = rng.choice(n_users, n, p=uw / uw.sum()).astype(np.int32)
    return users, items


def _distinct_pairs(rng, nnz: int, n_users: int, n_items: int,
                    cover: bool = False):
    """The first ``nnz`` distinct (user, item) pairs of a stream of draws
    with the marginals of :func:`_sample_pairs`, in draw order. With
    ``cover`` the stream starts with one pair for every user (its item
    drawn by the item marginal) and one for every item left out of those
    (its user drawn by the user marginal), so every user and item is
    rated."""
    users = np.empty(0, np.int32)
    items = np.empty(0, np.int32)
    if cover:
        _, items = _sample_pairs(rng, n_users, n_users, n_items)
        users = np.arange(n_users, dtype=np.int32)
        missing = np.setdiff1d(np.arange(n_items, dtype=np.int32), items)
        more_u, _ = _sample_pairs(rng, len(missing), n_users, n_items)
        users = np.concatenate([users, more_u])
        items = np.concatenate([items, missing])
        if len(users) > nnz:
            raise ValueError(f"{nnz} ratings cannot cover {n_users} users "
                             f"and {n_items} items")
    while True:
        need = nnz - len(users)
        more_u, more_i = _sample_pairs(rng, need + need // 20 + 1024,
                                       n_users, n_items)
        users = np.concatenate([users, more_u])
        items = np.concatenate([items, more_i])
        keys = users.astype(np.int64) * n_items + items
        _, first = np.unique(keys, return_index=True)
        keep = np.sort(first)
        users, items = users[keep], items[keep]
        if len(users) >= nnz:
            return users[:nnz], items[:nnz]


def planted_ratings(
    n_users: int = ML20M_USERS,
    n_items: int = ML20M_ITEMS,
    nnz: int = ML20M_NNZ,
    seed: int = 7,
    plant_rank: int = 16,
    noise_sigma: float = 0.35,
    n_holdout: int = 200_000,
    cover: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
           Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """→ (users, items, ratings, heldout (u, i, r)): ratings = 3.5 + U·Vᵀ
    + N(0, ``noise_sigma``) with a rank-``plant_rank`` U, V (bench.py:
    231-249). The heldout pairs are fresh draws from the same ground
    truth. Unlike the bench's, the training pairs are distinct: the draws
    go on until ``nnz`` distinct pairs are in hand, as ML-20M holds one
    rating per (user, item) and a template trains on the latest rating of
    each pair. So the most popular item keeps more than 65,536 raters
    (the bench comment's ≈67k for ML-20M's most-rated movie): at seed 7
    and ML-20M shape it holds 65,764, and its row is split in two. With
    ``cover`` every user and item is rated at least once
    (:func:`_distinct_pairs`)."""
    rng = np.random.default_rng(seed)
    u_true = rng.normal(0, 1.0 / np.sqrt(plant_rank),
                        (n_users, plant_rank)).astype(np.float32)
    v_true = rng.normal(0, 1.0, (n_items, plant_rank)).astype(np.float32)

    def rate(users, items):
        signal = np.einsum("nk,nk->n", u_true[users], v_true[items])
        return (3.5 + signal
                + rng.normal(0, noise_sigma, len(users))).astype(np.float32)

    users, items = _distinct_pairs(rng, nnz, n_users, n_items, cover)
    ho_u, ho_i = _sample_pairs(rng, n_holdout, n_users, n_items)
    return users, items, rate(users, items), (ho_u, ho_i, rate(ho_u, ho_i))


def planted_sessions(n_items: int, n_sessions: int, length: int,
                     seed: int = 0) -> np.ndarray:
    """[n_sessions, length] int32 cyclic sessions of item ids 1..n_items:
    item i is always followed by i + 1 (mod n_items), each session from a
    seeded random start (tests/test_sequence_template.py:13-20)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(1, n_items + 1, n_sessions)
    rows = (starts[:, None] - 1 + np.arange(length)[None, :]) % n_items + 1
    return rows.astype(np.int32)


def random_transformer_fields(n_items: int, max_len: int, d_model: int = 64,
                              n_layers: int = 2, seed: int = 0
                              ) -> Dict[str, np.ndarray]:
    """The fields of a sequence model's ``TransformerWeights`` as f32 numpy
    arrays, drawn from ``seed`` with the scales of ``transformer_init``
    (normal × d^-0.5, positions × 0.02, unit norm scales)."""
    rng = np.random.default_rng(seed)
    v, d, h = n_items + 1, d_model, 4 * d_model

    def init(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "item_emb": init((v, d), d ** -0.5),
        "pos_emb": init((max_len, d), 0.02),
        "ln1_scale": np.ones((n_layers, d), np.float32),
        "ln2_scale": np.ones((n_layers, d), np.float32),
        "wq": init((n_layers, d, d), d ** -0.5),
        "wk": init((n_layers, d, d), d ** -0.5),
        "wv": init((n_layers, d, d), d ** -0.5),
        "wo": init((n_layers, d, d), d ** -0.5),
        "w_up": init((n_layers, d, h), d ** -0.5),
        "w_down": init((n_layers, h, d), h ** -0.5),
        "lnf_scale": np.ones((d,), np.float32),
    }
