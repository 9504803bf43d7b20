"""Columnar training triples: ``Interactions`` and its zero-copy id table
``IdTable``, defined with the storage layer (``data/storage/base.py``, the
port's copy of incubator_predictionio_tpu/data/storage/base.py) and named
here for the engines and tests that build triples by hand.
"""

from incubator_predictionio_tpu_torch.data.storage.base import (
    IdTable,
    Interactions,
)

__all__ = ["IdTable", "Interactions"]
