"""DataMap / PropertyMap — typed JSON property bags.

The port's own copy of incubator_predictionio_tpu/data/datamap.py, its
imports rewritten to this package.

Behavior parity with the reference's json4s-backed property bag
(reference: data/.../storage/DataMap.scala:40-244, PropertyMap.scala:36-110):
``get`` raises on missing keys, ``opt`` returns None, ``++`` merges with
right-bias, ``--`` removes keys, and ``extract`` converts the whole bag into
a typed dataclass through the canonical JSON codec. PropertyMap adds the
``first_updated`` / ``last_updated`` aggregation timestamps.
"""

from __future__ import annotations

import typing
from datetime import datetime
from typing import Any, Iterator, Mapping, Optional, Type, TypeVar

from incubator_predictionio_tpu_torch.utils import json_codec

T = TypeVar("T")


class DataMapError(KeyError):
    """Raised when a required property is missing or has the wrong type."""


class DataMap(Mapping[str, Any]):
    """An immutable mapping of property names to parsed-JSON values."""

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any]] = None):
        object.__setattr__(self, "_fields", dict(fields or {}))

    # -- Mapping interface -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:  # stable enough for dedup in tests
        return hash(tuple(sorted((k, repr(v)) for k, v in self._fields.items())))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    # -- reference API parity ----------------------------------------------
    @property
    def fields(self) -> dict[str, Any]:
        return dict(self._fields)

    def require(self, name: str) -> None:
        """DataMap.require (DataMap.scala:52): raise if field absent."""
        if name not in self._fields:
            raise DataMapError(f"The field {name} is required.")

    def get(self, name: str, as_: Optional[Type[T]] = None) -> Any:
        """Mandatory typed get (DataMap.scala:77). Raises if missing.

        Unlike ``dict.get``, a missing key is an *error* — this matches the
        reference, where ``get[T]`` throws ``DataMapException``. Generic
        ``Mapping`` consumers needing default semantics should use
        :meth:`get_or_else` / :meth:`opt`, or index ``dm.fields``.

        The second argument is a *type*, never a default value; passing a
        non-type raises immediately rather than being silently treated as a
        missing-key fallback.
        """
        if as_ is not None and not isinstance(as_, type) and not typing.get_origin(as_):
            raise TypeError(
                f"DataMap.get second argument must be a type, got {as_!r}; "
                "use get_or_else(name, default) for default-value semantics"
            )
        self.require(name)
        value = self._fields[name]
        if value is None:
            raise DataMapError(f"The required field {name} cannot be null.")
        if as_ is not None:
            return json_codec.extract(as_, value)
        return value

    def opt(self, name: str, as_: Optional[Type[T]] = None) -> Optional[Any]:
        """Optional typed get (DataMap.scala:96 ``getOpt``)."""
        value = self._fields.get(name)
        if value is None:
            return None
        if as_ is not None:
            return json_codec.extract(as_, value)
        return value

    def get_or_else(self, name: str, default: T, as_: Optional[Type[T]] = None) -> T:
        """DataMap.getOrElse (DataMap.scala:116)."""
        got = self.opt(name, as_)
        return default if got is None else got

    def extract(self, cls: Type[T]) -> T:
        """Convert the whole map into a typed dataclass (DataMap.scala:191)."""
        return json_codec.extract(cls, self._fields)

    def __add__(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        """``++`` merge, right-biased (DataMap.scala:137)."""
        merged = dict(self._fields)
        merged.update(dict(other))
        return DataMap(merged)

    def merge(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        return self + other

    def __sub__(self, keys: Any) -> "DataMap":
        """``--`` key removal (DataMap.scala:145)."""
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    def without(self, keys: Any) -> "DataMap":
        return self - keys

    @property
    def is_empty(self) -> bool:
        return not self._fields

    @property
    def key_set(self) -> frozenset[str]:
        return frozenset(self._fields)

    def to_jsonable(self) -> dict[str, Any]:
        return dict(self._fields)

    @classmethod
    def from_jsonable(cls, obj: Any) -> "DataMap":
        if isinstance(obj, DataMap):
            return obj
        if obj is None:
            return cls()
        if not isinstance(obj, Mapping):
            raise ValueError(f"DataMap requires a JSON object, got {obj!r}")
        return cls(obj)


class PropertyMap(DataMap):
    """Aggregated entity state with first/last update times
    (reference: data/.../storage/PropertyMap.scala:36-75)."""

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Optional[Mapping[str, Any]] = None,
        *,
        first_updated: datetime,
        last_updated: datetime,
    ):
        super().__init__(fields)
        object.__setattr__(self, "first_updated", first_updated)
        object.__setattr__(self, "last_updated", last_updated)

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self.fields!r}, firstUpdated={self.first_updated}, "
            f"lastUpdated={self.last_updated})"
        )

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            return (
                self.fields == other.fields
                and self.first_updated == other.first_updated
                and self.last_updated == other.last_updated
            )
        return super().__eq__(other)

    __hash__ = DataMap.__hash__
