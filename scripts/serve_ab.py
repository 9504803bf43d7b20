#!/usr/bin/env python3
"""The path and serve-load phases of ``chip_smoke.py`` alone, from the
checkout at ROOT (default: this one), on one card.

    python3 scripts/serve_ab.py [ROOT]

Builds ROOT's kernels, plants ROOT's ML-20M-width model and runs ROOT's
``chip_smoke.path_phase`` and ``serve_load_phase`` with their own checks.
Prints the card's name and power limit, then ``path: {...}`` and one
``serve-load: {...}`` line a leg. To hold two commits' serving figures
against each other, unpack the other commit (``git archive``) into a
directory that ``.gitignore`` lists and run, in one call on one card,
ROOT = that directory, this checkout, this checkout, that directory.
"""

import json
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from incubator_predictionio_tpu_torch import runtime  # noqa: E402
from incubator_predictionio_tpu_torch.core import (  # noqa: E402
    params as params_mod,
)
from incubator_predictionio_tpu_torch.models.recommendation import (  # noqa: E402,E501
    convert,
    engine,
)
from incubator_predictionio_tpu_torch.ops import kernels  # noqa: E402
from incubator_predictionio_tpu_torch.servers import (  # noqa: E402
    prediction_server as server_mod,
)
from incubator_predictionio_tpu_torch.utils import planted  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"root: {ROOT}", flush=True)
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    runtime.build_kernels()
    ml = cs.ML20M
    built = cs.build_model(planted, convert, dev, ml["users"], ml["items"],
                           ml["rank"])
    _l, _e, stats = cs.path_phase(dev, runtime, kernels, planted, convert,
                                  engine, params_mod, server_mod,
                                  ml["users"], ml["items"], ml["rank"],
                                  built)
    print(f"path: {json.dumps(stats)}", flush=True)
    _l, _e, load = cs.serve_load_phase(dev, runtime, kernels, server_mod,
                                       engine, params_mod, built)
    for leg in load["legs"]:
        print(f"serve-load: {json.dumps(leg)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
