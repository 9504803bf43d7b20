#!/usr/bin/env python3
"""Time numpy's ``np.unique`` against ``np.sort`` on the host, at the size
``chip_smoke.py`` meets them: 20,000,000 int64 (user, item) keys, random
and those of the planted ML-20M ratings (``utils/planted.py``, seed 7), and
retrain leg (b)'s tail generation (``chip_smoke.distinct_new_pairs``, a 1%
tail of new pairs) on those ratings.

    python3 scripts/host_unique_timing.py

Prints one JSON object a line: the numpy version, then each timing in
seconds. Host CPU only; it needs no GPU and runs in about a minute where
``np.unique`` sorts (numpy before 2.3).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from incubator_predictionio_tpu_torch.utils import planted  # noqa: E402


def timed(name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(json.dumps({"step": name, "s": time.perf_counter() - t0}),
          flush=True)
    return out


def main() -> int:
    print(json.dumps({"numpy": np.__version__}), flush=True)
    n_users, n_items = planted.ML20M_USERS, planted.ML20M_ITEMS
    rng = np.random.default_rng(0)
    keys = rng.integers(0, n_users * n_items, 20_000_000)
    timed("sort random 20M int64", np.sort, keys)
    timed("unique random 20M int64", np.unique, keys)
    timed("unique return_index 400k int64", np.unique,
          keys[:400_000], return_index=True)
    users, items, _r, _h = timed("planted ratings", planted.planted_ratings)
    keys = np.asarray(users, np.int64) * n_items + items
    timed("sort planted keys", np.sort, keys)
    timed("unique planted keys", np.unique, keys)
    timed("n_distinct planted keys", chip_smoke.n_distinct, keys)
    rng = np.random.default_rng(31)
    timed("distinct_new_pairs 200k", chip_smoke.distinct_new_pairs, rng,
          users, items, n_users, n_items, 200_000,
          draw=lambda m: planted._sample_pairs(rng, m, n_users, n_items))
    return 0


if __name__ == "__main__":
    sys.exit(main())
