"""Speed layer — fold-in serving between retrains.

The port of incubator_predictionio_tpu/speed/: PredictionIO's Lambda
architecture has a batch leg (train, continuation retrain), a serving
leg and this speed leg, which keeps a deployed model fresh without a
retrain:

- :mod:`.foldin` — batched regularized least-squares row solves against
  the frozen other-side factors on the fused ALS kernel, padded to a
  fixed bucket ladder;
- :mod:`.overlay` — the log-tail subscriber that marks keys dirty, folds
  them in batches and caches the vectors with a TTL;
- :mod:`.cache` — the bounded TTL micro-cache in front of serving-time
  EventStore reads.

The prediction server builds one overlay per algorithm that offers one
(``core/base.py`` ``Algorithm.make_speed_overlay``); the engines consult
it before the base model.
"""

__all__ = [
    "FoldInSolver",
    "SpeedOverlay",
    "SpeedOverlayConfig",
    "TTLCache",
    "foldin_compile_cache_size",
]

#: lazy re-exports (PEP 562): an engine that imports ``speed.cache``
#: does not import the fold-in and the overlay with it
_EXPORTS = {
    "TTLCache": ("incubator_predictionio_tpu_torch.speed.cache", "TTLCache"),
    "FoldInSolver": (
        "incubator_predictionio_tpu_torch.speed.foldin", "FoldInSolver"),
    "foldin_compile_cache_size": (
        "incubator_predictionio_tpu_torch.speed.foldin",
        "foldin_compile_cache_size"),
    "SpeedOverlay": (
        "incubator_predictionio_tpu_torch.speed.overlay", "SpeedOverlay"),
    "SpeedOverlayConfig": (
        "incubator_predictionio_tpu_torch.speed.overlay",
        "SpeedOverlayConfig"),
}


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(module), attr)
