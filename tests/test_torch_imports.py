"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to pick the CPU on their own."""

import subprocess
import sys
import textwrap

import pytest
import torch

from incubator_predictionio_tpu_torch import runtime
from incubator_predictionio_tpu_torch.models.recommendation.convert import (
    als_model_from_numpy,
)
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext

_ISOLATED = textwrap.dedent('''
    import importlib, importlib.abc, json, pkgutil, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if (name == "incubator_predictionio_tpu"
                    or name.startswith("incubator_predictionio_tpu.")):
                raise ImportError("the port imported " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    import incubator_predictionio_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import numpy as np
    import urllib.request
    from incubator_predictionio_tpu_torch.core.params import EngineParams
    from incubator_predictionio_tpu_torch.models.recommendation import engine
    from incubator_predictionio_tpu_torch.models.recommendation.convert import (
        als_model_from_numpy)
    from incubator_predictionio_tpu_torch.servers.prediction_server import (
        PredictionServer)
    rng = np.random.default_rng(0)
    model = als_model_from_numpy(
        rng.standard_normal((5, 4)), rng.standard_normal((9, 4)),
        [f"u{i}" for i in range(5)], [f"i{i}" for i in range(9)],
        device="cpu")
    srv = PredictionServer(engine.RecommendationEngine().apply(),
                           EngineParams(), [model], device="cpu")
    port = srv.start_background()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/queries.json",
            data=b'{"user": "u2", "num": 3}', method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = json.loads(resp.read())
    finally:
        srv.stop()
    leaked = sorted(m for m in sys.modules
                    if m == "incubator_predictionio_tpu"
                    or m.startswith("incubator_predictionio_tpu."))
    print(json.dumps({"modules": len(names), "items": len(body["itemScores"]),
                      "leaked": leaked}))
''')


def test_port_imports_and_serves_without_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _ISOLATED],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["modules"] >= 15
    assert out["items"] == 3
    assert out["leaked"] == []


def test_default_device_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.default_device()
    with pytest.raises(RuntimeError):
        RuntimeContext()
    with pytest.raises(RuntimeError):
        als_model_from_numpy([[1.0]], [[1.0]], ["u"], ["i"])
    assert runtime.default_device("cpu") == torch.device("cpu")


def test_cuda_tensor_never_takes_the_plain_version():
    """A kernel wrapper given a non-CPU tensor launches or raises; here
    (no card) the meta device stands in for one it cannot launch on."""
    from incubator_predictionio_tpu_torch.ops import kernels

    runtime.reset_launch_counts()
    q = torch.empty((1, 8), device="meta")
    items = torch.empty((100, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.score_topk(q, items, None, 5)
    assert kernels.SCORE_TOPK_LAUNCHES.value == 0
