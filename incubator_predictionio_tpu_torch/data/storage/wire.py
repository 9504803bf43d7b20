"""Wire codec for the remote storage protocol — msgpack + typed tags.

The reference's deployment story runs every server against shared network
services (PostgreSQL/HBase/Elasticsearch — data/.../storage/jdbc/
StorageClient.scala:35-60); their client libraries speak those services' own wire
protocols. This framework's network backend speaks its own compact
protocol instead: msgpack framing over the shared structural codec
(utils/structcodec.py) with explicit tags for the storage record types.
The decoder constructs ONLY the fixed record types in ``_RECORDS`` plus
the structural tags — there is no class-name resolution and no code
execution on decode.

Numpy arrays (and the columnar :class:`Interactions` / :class:`IdTable`
forms) travel as raw dtype+shape+bytes, so a training-scale scan crosses
the network as a few contiguous buffers, not millions of objects.

The port's copy of incubator_predictionio_tpu/data/storage/wire.py: the
same tags and field names, so a record packs to the same bytes in both
packages and either package's client talks to either package's server.
It decodes only the port's own record classes.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from typing import Any, Dict

from incubator_predictionio_tpu_torch.data.datamap import DataMap, PropertyMap
from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.data.storage import base
from incubator_predictionio_tpu_torch.data.storage.base import UNSET
from incubator_predictionio_tpu_torch.utils.structcodec import StructCodec

_TAG = "~t~"

#: record dataclasses allowed on the wire (name → class). Decoding builds
#: these through their constructors; nothing else is ever instantiated.
_RECORDS: Dict[str, type] = {
    "App": base.App,
    "AccessKey": base.AccessKey,
    "Channel": base.Channel,
    "EngineInstance": base.EngineInstance,
    "EvaluationInstance": base.EvaluationInstance,
    "EngineManifest": base.EngineManifest,
    "Model": base.Model,
}
_RECORD_NAMES = {cls: name for name, cls in _RECORDS.items()}


class WireError(ValueError):
    """Malformed wire payload."""


def _encode_ext(obj: Any, codec: StructCodec) -> Any:
    if obj is UNSET:
        return {_TAG: "unset"}
    if isinstance(obj, Event):
        return {_TAG: "event", "v": obj.to_jsonable()}
    if isinstance(obj, PropertyMap):  # before the structural DataMap rule
        return {_TAG: "pmap", "v": obj.to_jsonable(),
                "a": obj.first_updated.isoformat(),
                "z": obj.last_updated.isoformat()}
    if isinstance(obj, base.IdTable):
        return {_TAG: "idt", "b": obj.blob, "o": codec.encode(obj.offsets)}
    if isinstance(obj, base.Interactions):
        return {_TAG: "inter", "u": codec.encode(obj.user_idx),
                "i": codec.encode(obj.item_idx),
                "v": codec.encode(obj.values),
                "uids": codec.encode(obj.user_ids),
                "iids": codec.encode(obj.item_ids)}
    cls_name = _RECORD_NAMES.get(type(obj))
    if cls_name is not None:
        fields = {
            f.name: codec.encode(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
        return {_TAG: "rec", "c": cls_name, "f": fields}
    return NotImplemented


def _decode_ext(tag: str, obj: dict, codec: StructCodec) -> Any:
    if tag == "unset":
        return UNSET
    if tag == "event":
        return Event.from_jsonable(obj["v"])
    if tag == "pmap":
        return PropertyMap(
            obj["v"],
            first_updated=datetime.fromisoformat(obj["a"]),
            last_updated=datetime.fromisoformat(obj["z"]))
    if tag == "idt":
        return base.IdTable(obj["b"], codec.decode(obj["o"]))
    if tag == "inter":
        return base.Interactions(
            user_idx=codec.decode(obj["u"]), item_idx=codec.decode(obj["i"]),
            values=codec.decode(obj["v"]), user_ids=codec.decode(obj["uids"]),
            item_ids=codec.decode(obj["iids"]))
    if tag == "rec":
        cls = _RECORDS.get(obj["c"])
        if cls is None:
            raise WireError(f"unknown record type {obj['c']!r}")
        return cls(**{k: codec.decode(v) for k, v in obj["f"].items()})
    return NotImplemented


_CODEC = StructCodec(_TAG, WireError, _encode_ext, _decode_ext)


def encode(obj: Any) -> Any:
    return _CODEC.encode(obj)


def decode(obj: Any) -> Any:
    return _CODEC.decode(obj)


def pack(obj: Any) -> bytes:
    import msgpack

    return msgpack.packb(encode(obj), use_bin_type=True)


def unpack(data: bytes) -> Any:
    import msgpack

    return decode(msgpack.unpackb(data, raw=False, strict_map_key=False))
