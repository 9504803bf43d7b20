#!/usr/bin/env python3
"""ROADMAP Queue 3 fault 3's check against one checkout's package.

    python3 scripts/stream_isolation_ab.py [ROOT]

Runs ``chip_smoke.stream_isolation`` (this checkout's check) with
``incubator_predictionio_tpu_torch`` imported from ROOT (default: this
checkout) on a seeded table at ML-20M width (138,493 users × 26,744 items
× rank 128): with ``PIO_PROFILE=1``, a query dispatched the moment a long
fold-in is queued on a thread of its own must book ``serve_topk``
seconds below a tenth of the fold-in's ``foldin_solve`` seconds (a
plain query's booking and wall are reported beside it).
Prints one JSON line: the root, the card, whether the check held, and
each trial's booked seconds. For an A/B of two commits in one call,
unpack the other commit's package into a directory ``.gitignore`` lists
(``git archive <commit> incubator_predictionio_tpu_torch | tar -x -C
_ab/<name>``) and run the script on both. Needs a CUDA card.
"""

import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path.insert(0, root)
    sys.path.append(HERE)
    import numpy as np
    import torch

    import chip_smoke
    from incubator_predictionio_tpu_torch import runtime
    from incubator_predictionio_tpu_torch.core import params as params_mod
    from incubator_predictionio_tpu_torch.models.recommendation import (
        convert,
        engine,
    )
    from incubator_predictionio_tpu_torch.servers import (
        prediction_server as server_mod,
    )

    if not runtime.__file__.startswith(root):
        raise SystemExit(f"imported {runtime.__file__}, not from {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    runtime.build_kernels()
    rng = np.random.default_rng(5)
    users, items, rank = (chip_smoke.ML20M[k] for k in
                          ("users", "items", "rank"))
    uf = (0.1 * rng.standard_normal((users, rank))).astype(np.float32)
    vf = (0.1 * rng.standard_normal((items, rank))).astype(np.float32)
    out = {"root": root, "card": card, "torch": torch.__version__}
    try:
        got = chip_smoke.stream_isolation(
            torch.device("cuda"), runtime, server_mod, engine, params_mod,
            convert, uf, vf)
        out.update(held=True, trials=got["trials"])
    except AssertionError as e:
        m = re.search(r"(\{.*\})$", str(e))
        out.update(held=False, trials=json.loads(m.group(1)) if m else None,
                   error=str(e)[:300])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
