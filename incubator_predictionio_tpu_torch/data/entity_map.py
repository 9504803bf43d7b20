"""EntityMap — entity-id-keyed data with a dense index (Experimental).

The port's own copy of incubator_predictionio_tpu/data/entity_map.py, its
imports rewritten to this package.

Parity: data/.../storage/EntityMap.scala:27-99. ``EntityIdIxMap`` wraps a
:class:`~incubator_predictionio_tpu_torch.data.bimap.BiMap` with symmetric
id↔index lookups; ``EntityMap`` adds the per-entity payload (the
aggregated ``PropertyMap`` in the reference's
``PEvents.extractEntityMap``, PEvents.scala:136-160). Templates use it to
carry entity properties alongside the dense row index their factors live
at on device.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterable, Optional, TypeVar

from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.utils.annotations import experimental

A = TypeVar("A")


@experimental
class EntityIdIxMap:
    """String entity id ↔ dense int index (EntityMap.scala:27-56)."""

    def __init__(self, id_to_ix: BiMap):
        self.id_to_ix = id_to_ix
        self.ix_to_id = id_to_ix.inverse

    @classmethod
    def from_keys(cls, keys: Iterable[str]) -> "EntityIdIxMap":
        return cls(BiMap.string_long(keys))

    def __call__(self, key):
        """id → index for a str key, index → id for an int key (the
        reference's overloaded apply)."""
        if isinstance(key, str):
            return self.id_to_ix[key]
        return self.ix_to_id[key]

    def __contains__(self, key) -> bool:
        if isinstance(key, str):
            return key in self.id_to_ix
        return key in self.ix_to_id

    def get(self, key, default=None):
        if isinstance(key, str):
            return self.id_to_ix.get(key, default)
        return self.ix_to_id.get(key, default)

    get_or_else = get

    def to_dict(self) -> Dict[str, int]:
        return self.id_to_ix.to_dict()

    def __len__(self) -> int:
        return len(self.id_to_ix)

    def take(self, n: int) -> "EntityIdIxMap":
        return EntityIdIxMap(self.id_to_ix.take(n))

    def __repr__(self) -> str:
        return f"EntityIdIxMap({self.id_to_ix!r})"


@experimental
class EntityMap(EntityIdIxMap, Generic[A]):
    """Entity payloads + the dense index (EntityMap.scala:58-99)."""

    def __init__(self, id_to_data: Dict[str, A],
                 id_to_ix: Optional[BiMap] = None):
        super().__init__(
            id_to_ix if id_to_ix is not None
            else BiMap.string_long(id_to_data.keys()))
        self.id_to_data = dict(id_to_data)

    def data(self, key) -> A:
        """Payload by id (str) or dense index (int)."""
        if isinstance(key, str):
            return self.id_to_data[key]
        return self.id_to_data[self.ix_to_id[key]]

    def get_data(self, key, default: Optional[A] = None) -> Optional[A]:
        try:
            return self.data(key)
        except KeyError:
            return default

    def get_or_else_data(self, key, default: Callable[[], A] | A) -> A:
        got = self.get_data(key)
        if got is not None:
            return got
        return default() if callable(default) else default

    def take(self, n: int) -> "EntityMap[A]":
        new_ix = self.id_to_ix.take(n)
        return EntityMap(
            {k: v for k, v in self.id_to_data.items() if k in new_ix},
            new_ix)

    def __repr__(self) -> str:
        return (f"EntityMap(data={len(self.id_to_data)} entities, "
                f"{self.id_to_ix!r})")
