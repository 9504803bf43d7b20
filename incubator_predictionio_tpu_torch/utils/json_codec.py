"""JSON ⇄ typed dataclass codec: the port's own copy of ``extract``,
``to_jsonable`` and ``snake_to_camel`` from
incubator_predictionio_tpu/utils/json_codec.py.

Dataclasses that set ``__camel_case__ = True`` speak the reference's
camelCase wire format (``itemScores``, ``creationYear``, ``excludeSeen``)
while staying snake_case in Python. Supported targets of :func:`extract`:
dataclasses, ``int``/``float``/``bool``/``str`` (with the lenient numeric
coercion of the reference), ``list``/``tuple``/``set``/``dict``,
``Optional`` and ``Union``, ``Any`` and ``enum.Enum``. Datetimes are not
carried: nothing on the serving slice reads one.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import json
import types
import typing
from typing import Any, Type, TypeVar, Union, get_args, get_origin

T = TypeVar("T")

_MISSING = dataclasses.MISSING


class ExtractionError(ValueError):
    """Raised when a JSON value cannot be converted to the requested type."""


def extract(cls: Type[T], obj: Any, *, lenient: bool = True) -> T:
    """Convert a parsed-JSON value ``obj`` into an instance of ``cls``.

    ``lenient`` accepts ``"3"`` for an int, ``3`` for a float and so on;
    ``lenient=False`` is strict (except int→float widening)."""
    return _extract(cls, obj, lenient)


def _extract(cls: Any, obj: Any, lenient: bool) -> Any:
    if cls is Any or cls is None or cls is type(None):
        if cls is type(None) and obj is not None:
            raise ExtractionError(f"Expected null, got {obj!r}")
        return obj

    origin = get_origin(cls)

    if origin is Union or origin is types.UnionType:
        return _extract_union(cls, obj, lenient)

    if dataclasses.is_dataclass(cls) and isinstance(cls, type):
        return _extract_dataclass(cls, obj, lenient)

    if isinstance(cls, type) and issubclass(cls, enum.Enum):
        return _extract_enum(cls, obj)

    if cls is bool:
        if isinstance(obj, bool):
            return obj
        if lenient and isinstance(obj, str) and obj.lower() in ("true", "false"):
            return obj.lower() == "true"
        raise ExtractionError(f"Cannot convert {obj!r} to bool")

    if cls is int:
        if isinstance(obj, bool):
            raise ExtractionError(f"Cannot convert bool {obj!r} to int")
        if isinstance(obj, int):
            return obj
        if isinstance(obj, float) and obj.is_integer():
            return int(obj)
        if lenient and isinstance(obj, str):
            try:
                return int(obj)
            except ValueError:
                pass
        raise ExtractionError(f"Cannot convert {obj!r} to int")

    if cls is float:
        if isinstance(obj, bool):
            raise ExtractionError(f"Cannot convert bool {obj!r} to float")
        if isinstance(obj, (int, float)):
            return float(obj)
        if lenient and isinstance(obj, str):
            try:
                return float(obj)
            except ValueError:
                pass
        raise ExtractionError(f"Cannot convert {obj!r} to float")

    if cls is str:
        if isinstance(obj, str):
            return obj
        if lenient and isinstance(obj, (int, float, bool)):
            return json.dumps(obj)
        raise ExtractionError(f"Cannot convert {obj!r} to str")

    if origin in (list, typing.List):
        (item_t,) = get_args(cls) or (Any,)
        if not isinstance(obj, list):
            raise ExtractionError(f"Expected JSON array for {cls}, got {obj!r}")
        return [_extract(item_t, v, lenient) for v in obj]

    if origin in (set, frozenset):
        (item_t,) = get_args(cls) or (Any,)
        if not isinstance(obj, list):
            raise ExtractionError(f"Expected JSON array for {cls}, got {obj!r}")
        out = {_extract(item_t, v, lenient) for v in obj}
        return frozenset(out) if origin is frozenset else out

    if origin is tuple:
        args = get_args(cls)
        if not isinstance(obj, list):
            raise ExtractionError(f"Expected JSON array for {cls}, got {obj!r}")
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_extract(args[0], v, lenient) for v in obj)
        if len(args) != len(obj):
            raise ExtractionError(f"Expected {len(args)} elements for {cls}, got {len(obj)}")
        return tuple(_extract(t, v, lenient) for t, v in zip(args, obj))

    if origin in (dict, typing.Dict):
        key_t, val_t = get_args(cls) or (Any, Any)
        if not isinstance(obj, dict):
            raise ExtractionError(f"Expected JSON object for {cls}, got {obj!r}")
        return {
            _extract(key_t, k, lenient): _extract(val_t, v, lenient)
            for k, v in obj.items()
        }

    if cls in (dict, list, object):
        return obj

    try:
        if isinstance(obj, cls):
            return obj
    except TypeError:
        pass  # non-class target (e.g. subscripted generic) — fall through
    raise ExtractionError(f"Unsupported extraction target {cls!r} for {obj!r}")


def _extract_union(cls: Any, obj: Any, lenient: bool) -> Any:
    args = get_args(cls)
    # Optional[T]: null maps to None.
    if obj is None and type(None) in args:
        return None
    errors = []
    for arg in args:
        if arg is type(None):
            continue
        try:
            return _extract(arg, obj, lenient)
        except ExtractionError as e:
            errors.append(str(e))
    raise ExtractionError(f"No member of {cls} matched {obj!r}: {errors}")


def _extract_enum(cls: Type[enum.Enum], obj: Any) -> enum.Enum:
    try:
        return cls(obj)
    except ValueError:
        pass
    if isinstance(obj, str):
        try:
            return cls[obj]
        except KeyError:
            pass
    raise ExtractionError(f"Cannot convert {obj!r} to {cls.__name__}")


@functools.lru_cache(maxsize=4096)
def snake_to_camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(part.title() for part in rest)


@functools.lru_cache(maxsize=None)
def _type_hints(cls: type) -> dict:
    """Cached ``get_type_hints``: string annotations are evaluated once
    per class instead of on every query."""
    return typing.get_type_hints(cls)


@functools.lru_cache(maxsize=None)
def _wire_fields(cls: type):
    """Cached (field, wire_name) pairs for dataclass serialization."""
    camel = getattr(cls, "__camel_case__", False)
    return tuple(
        (f, snake_to_camel(f.name) if camel else f.name)
        for f in dataclasses.fields(cls)
    )


def _extract_dataclass(cls: type, obj: Any, lenient: bool) -> Any:
    if isinstance(obj, cls):
        return obj
    if not isinstance(obj, dict):
        raise ExtractionError(f"Expected JSON object for {cls.__name__}, got {obj!r}")
    hints = _type_hints(cls)
    kwargs = {}
    for f, wire in _wire_fields(cls):
        if not f.init:
            continue
        key = f.name
        if key not in obj and wire != key and wire in obj:
            key = wire
        if key in obj:
            kwargs[f.name] = _extract(hints.get(f.name, Any), obj[key], lenient)
        elif f.default is not _MISSING or f.default_factory is not _MISSING:  # type: ignore[misc]
            continue  # use the dataclass default
        else:
            raise ExtractionError(
                f"Missing required field {f.name!r} for {cls.__name__} in {obj!r}"
            )
    return cls(**kwargs)


def to_jsonable(obj: Any) -> Any:
    """Convert a value into plain JSON-serializable Python structures
    (the inverse of :func:`extract`)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            wire: to_jsonable(getattr(obj, f.name))
            for f, wire in _wire_fields(type(obj))
        }
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [to_jsonable(v) for v in obj]
    raise TypeError(f"Cannot convert {type(obj).__name__} to JSON: {obj!r}")
