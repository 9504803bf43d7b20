"""BiMap — immutable bidirectional map for ID re-indexing.

Every recommendation template re-indexes string entity IDs to dense integer
indices before matrix work (reference: data/.../storage/BiMap.scala,
``BiMap.stringInt``/``stringLong``; used in
examples/scala-parallel-recommendation/custom-query/src/main/scala/ALSModel.scala).
The dense-index property is what lets factors live in contiguous
device tensors, so this is the boundary between host-side string IDs and
device-side rows.
"""

from __future__ import annotations

from typing import Dict, Generic, Hashable, Iterable, Iterator, Optional, Tuple, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V", bound=Hashable)


class BiMap(Generic[K, V]):
    """Immutable one-to-one mapping with O(1) lookup in both directions."""

    __slots__ = ("_fwd", "_rev")

    def __init__(self, forward: Dict[K, V]):
        self._fwd: Dict[K, V] = dict(forward)
        self._rev: Dict[V, K] = {v: k for k, v in self._fwd.items()}
        if len(self._rev) != len(self._fwd):
            raise ValueError("BiMap values must be unique")

    # -- constructors (BiMap.scala:140-196) --------------------------------
    @classmethod
    def string_int(cls, keys: Iterable[str]) -> "BiMap[str, int]":
        """Dense 0..n-1 indexing of distinct string keys (BiMap.stringInt)."""
        distinct = dict.fromkeys(keys)  # preserves first-seen order
        return BiMap({k: i for i, k in enumerate(distinct)})

    # stringLong / stringDouble are the same in Python's single int/float types
    string_long = string_int

    # -- lookups -----------------------------------------------------------
    def __call__(self, key: K) -> V:
        return self._fwd[key]

    def __getitem__(self, key: K) -> V:
        return self._fwd[key]

    def get(self, key: K, default: Optional[V] = None) -> Optional[V]:
        return self._fwd.get(key, default)

    def get_or_else(self, key: K, default: V) -> V:
        return self._fwd.get(key, default)

    def __contains__(self, key: K) -> bool:
        return key in self._fwd

    @property
    def inverse(self) -> "BiMap[V, K]":
        """O(1) — shares the two underlying dicts."""
        inv: BiMap[V, K] = BiMap.__new__(BiMap)
        inv._fwd = self._rev
        inv._rev = self._fwd
        return inv

    # -- collection views --------------------------------------------------
    def __len__(self) -> int:
        return len(self._fwd)

    def __iter__(self) -> Iterator[K]:
        return iter(self._fwd)

    def items(self) -> Iterable[Tuple[K, V]]:
        return self._fwd.items()

    def keys(self) -> Iterable[K]:
        return self._fwd.keys()

    def values(self) -> Iterable[V]:
        return self._fwd.values()

    def to_dict(self) -> Dict[K, V]:
        return dict(self._fwd)

    def take(self, n: int) -> "BiMap[K, V]":
        out: Dict[K, V] = {}
        for i, (k, v) in enumerate(self._fwd.items()):
            if i >= n:
                break
            out[k] = v
        return BiMap(out)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BiMap) and self._fwd == other._fwd

    def __hash__(self) -> int:
        return hash(frozenset(self._fwd.items()))

    def __repr__(self) -> str:
        return f"BiMap({self._fwd!r})"
