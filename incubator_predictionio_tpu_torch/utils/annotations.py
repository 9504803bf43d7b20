"""API-stability markers — @developer_api and @experimental.

The port's own copy of incubator_predictionio_tpu/utils/annotations.py, its
imports rewritten to this package.

The reference tags JVM classes with ``@DeveloperApi`` / ``@Experimental``
(common/.../annotation/{DeveloperApi,Experimental}.java) so users know
which surfaces are low-level or may change without deprecation. Python has
no annotation retention, so these decorators do the equivalent two things:
stamp the object (``__pio_api__``) for programmatic discovery, and prepend
the marker to the docstring so it shows in ``help()`` and rendered docs.
"""

from __future__ import annotations

from typing import Any, TypeVar

T = TypeVar("T")

DEVELOPER_API = "DeveloperApi"
EXPERIMENTAL = "Experimental"


def _mark(obj: T, kind: str, note: str) -> T:
    try:
        obj.__pio_api__ = kind  # type: ignore[attr-defined]
    except (AttributeError, TypeError):  # pragma: no cover - builtins
        pass
    doc = obj.__doc__ or ""
    try:
        obj.__doc__ = f":: {kind} ::\n{note}\n\n{doc}" if doc \
            else f":: {kind} ::\n{note}"
    except (AttributeError, TypeError):  # pragma: no cover
        pass
    return obj


def developer_api(obj: T) -> T:
    """A lower-level, unstable API intended for framework developers
    (DeveloperApi.java:25-33)."""
    return _mark(
        obj, DEVELOPER_API,
        "Intended for framework developers; may change across minor "
        "releases.")


def experimental(obj: T) -> T:
    """An experimental API that may change or be removed without
    deprecation (Experimental.java:25-33)."""
    return _mark(
        obj, EXPERIMENTAL,
        "Experimental; may change or be removed in minor releases.")


def api_stability(obj: Any) -> str:
    """The marker applied to ``obj`` (``\"DeveloperApi\"`` /
    ``\"Experimental\"``), or ``\"stable\"``."""
    return getattr(obj, "__pio_api__", "stable")
