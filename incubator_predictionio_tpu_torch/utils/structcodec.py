"""Shared structural value codec — one tagged encoding: the port's own copy
of incubator_predictionio_tpu/utils/structcodec.py. A ``torch.Tensor`` is
encoded as the same ``nd`` tag as a numpy array (dtype, shape, bytes, by
way of ``.cpu().numpy()``), so a blob of either package decodes in the
other; ``nd`` decodes to numpy.

It encodes numpy arrays and tensors as (dtype, shape, bytes), datetimes,
tuples, sets, non-string-keyed maps, DataMap and BiMap under a reserved
tag key. Its consumer here is the model checkpoint (workflow/checkpoint.py,
tag ``~pio~``), which adds an open-but-guarded dataclass tag resolved only
from imported modules; the JAX package's remote-storage wire protocol is
its other consumer there. Decoding constructs only fixed structural types
here; anything type-resolving lives in the consumers' extension hooks.
"""

from __future__ import annotations

from datetime import date, datetime
from typing import Any, Callable, Optional

#: extension hook signatures — return NotImplemented to fall through
EncodeExt = Callable[[Any, "StructCodec"], Any]
DecodeExt = Callable[[str, dict, "StructCodec"], Any]


class StructCodec:
    """Structural encoder/decoder parameterized by tag key + extensions.

    ``encode_ext`` runs before the structural rules (so a consumer can
    claim its own types — e.g. PropertyMap before the DataMap rule);
    ``decode_ext`` runs for any tag the structural rules don't own.
    """

    def __init__(
        self,
        tag_key: str,
        error_cls: type = ValueError,
        encode_ext: Optional[EncodeExt] = None,
        decode_ext: Optional[DecodeExt] = None,
    ):
        self.tag = tag_key
        self.error_cls = error_cls
        self.encode_ext = encode_ext
        self.decode_ext = decode_ext

    # -- encode ------------------------------------------------------------
    def encode(self, obj: Any) -> Any:
        import numpy as np

        if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
            return obj
        if self.encode_ext is not None:
            out = self.encode_ext(obj, self)
            if out is not NotImplemented:
                return out
        tag = self.tag
        import torch

        if isinstance(obj, torch.Tensor):
            obj = obj.detach().cpu().numpy()
        if isinstance(obj, np.ndarray):
            a = np.ascontiguousarray(obj)
            return {tag: "nd", "d": a.dtype.str, "s": list(a.shape),
                    "b": a.tobytes()}
        if isinstance(obj, np.generic):  # numpy scalar
            return {tag: "npv", "d": obj.dtype.str, "b": obj.tobytes()}
        if isinstance(obj, tuple):
            return {tag: "tu", "v": [self.encode(x) for x in obj]}
        if isinstance(obj, list):
            return [self.encode(x) for x in obj]
        if isinstance(obj, (set, frozenset)):
            return {tag: "set", "f": isinstance(obj, frozenset),
                    "v": [self.encode(x) for x in obj]}
        if isinstance(obj, datetime):
            return {tag: "dt", "v": obj.isoformat()}
        if isinstance(obj, date):  # AFTER datetime: datetime is a date
            return {tag: "date", "v": obj.isoformat()}
        if isinstance(obj, dict):
            if all(isinstance(k, str) for k in obj) and tag not in obj:
                return {k: self.encode(v) for k, v in obj.items()}
            # non-string (or reserved) keys: encode as a pair list
            return {tag: "map",
                    "v": [[self.encode(k), self.encode(v)]
                          for k, v in obj.items()]}
        from incubator_predictionio_tpu_torch.data.bimap import BiMap

        if isinstance(obj, BiMap):
            return {tag: "bimap", "v": self.encode(dict(obj.items()))}
        from incubator_predictionio_tpu_torch.data.datamap import DataMap

        if isinstance(obj, DataMap) and type(obj) is DataMap:
            return {tag: "dmap", "v": self.encode(obj.to_jsonable())}
        raise self.error_cls(
            f"cannot encode {type(obj).__module__}.{type(obj).__qualname__}"
        )

    # -- decode ------------------------------------------------------------
    def decode(self, obj: Any) -> Any:
        import numpy as np

        if isinstance(obj, list):
            return [self.decode(x) for x in obj]
        if not isinstance(obj, dict):
            return obj
        tag = obj.get(self.tag)
        if tag is None:
            return {k: self.decode(v) for k, v in obj.items()}
        if tag == "nd":
            arr = np.frombuffer(obj["b"], dtype=np.dtype(obj["d"]))
            return arr.reshape(obj["s"]).copy()  # writable, owned
        if tag == "npv":
            return np.frombuffer(obj["b"], dtype=np.dtype(obj["d"]))[0]
        if tag == "tu":
            return tuple(self.decode(x) for x in obj["v"])
        if tag == "set":
            vals = (self.decode(x) for x in obj["v"])
            return frozenset(vals) if obj["f"] else set(vals)
        if tag == "dt":
            return datetime.fromisoformat(obj["v"])
        if tag == "date":
            return date.fromisoformat(obj["v"])
        if tag == "map":
            return {self.decode(k): self.decode(v) for k, v in obj["v"]}
        if tag == "bimap":
            from incubator_predictionio_tpu_torch.data.bimap import BiMap

            return BiMap(self.decode(obj["v"]))
        if tag == "dmap":
            from incubator_predictionio_tpu_torch.data.datamap import DataMap

            return DataMap(self.decode(obj["v"]))
        if self.decode_ext is not None:
            out = self.decode_ext(tag, obj, self)
            if out is not NotImplemented:
                return out
        raise self.error_cls(f"unknown structural tag {tag!r}")
