"""The port's model checkpoint (``workflow/checkpoint.py``, format v2)
against the JAX package's, on seeded models.

A blob written by either package decodes in the other into the same model
dataclass with equal arrays; for the same model both packages write the
same bytes (the port names its model classes by the JAX package's module
paths and leaves out the fields the JAX models lack). The decoder still
constructs only dataclasses of modules already imported, reads a
PersistentModel manifest's class the same way, and refuses a blob without
the version-2 header.
"""

import dataclasses
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from incubator_predictionio_tpu.data.bimap import BiMap as JBiMap
from incubator_predictionio_tpu.models.recommendation import engine as jeng
from incubator_predictionio_tpu.models.sequence import engine as jseq
from incubator_predictionio_tpu.ops import transformer as jtr
from incubator_predictionio_tpu.parallel.context import (
    RuntimeContext as JContext,
)
from incubator_predictionio_tpu.workflow import checkpoint as jckpt
from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.data.datamap import DataMap
from incubator_predictionio_tpu_torch.models.recommendation import (
    engine as teng,
)
from incubator_predictionio_tpu_torch.models.recommendation.convert import (
    als_model_from_numpy,
)
from incubator_predictionio_tpu_torch.models.sequence import convert
from incubator_predictionio_tpu_torch.models.sequence import engine as tseq
from incubator_predictionio_tpu_torch.ops import transformer as ttr
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.utils.planted import (
    random_transformer_fields,
)
from incubator_predictionio_tpu_torch.workflow import checkpoint as tckpt

CPU = "cpu"


def _als_numpy(seed=0, n_users=30, n_items=20, rank=6):
    rng = np.random.default_rng(seed)
    uf = rng.standard_normal((n_users, rank)).astype(np.float32)
    vf = rng.standard_normal((n_items, rank)).astype(np.float32)
    users = [f"u{k}" for k in range(n_users)]
    items = [f"ïtem-{k}" for k in range(n_items)]
    years = {items[k]: 1990 + k for k in range(0, n_items, 3)}
    cats = {items[k]: ("c1", f"c{k}") for k in range(0, n_items, 4)}
    seen = {int(u): np.sort(rng.choice(n_items, 4, replace=False)
                            ).astype(np.int32)
            for u in rng.choice(n_users, 5, replace=False)}
    return uf, vf, users, items, years, cats, seen


def _jax_als(uf, vf, users, items, years, cats, seen):
    return jeng.ALSModel(
        user_factors=uf.copy(), item_factors=vf.copy(),
        user_bimap=JBiMap({u: i for i, u in enumerate(users)}),
        item_bimap=JBiMap({t: i for i, t in enumerate(items)}),
        item_years=dict(years), item_categories=dict(cats),
        user_seen={u: s.copy() for u, s in seen.items()})


def _port_als(uf, vf, users, items, years, cats, seen):
    return als_model_from_numpy(uf, vf, users, items, item_years=years,
                                item_categories=cats, user_seen=seen,
                                device=CPU)


def _same_als(a, b):
    """Two ALS models (either package) hold the same values."""
    for f in ("user_factors", "item_factors"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)
    assert dict(a.user_bimap.items()) == dict(b.user_bimap.items())
    assert dict(a.item_bimap.items()) == dict(b.item_bimap.items())
    assert a.item_years == b.item_years
    assert a.item_categories == b.item_categories
    assert sorted(a.user_seen) == sorted(b.user_seen)
    for u in a.user_seen:
        np.testing.assert_array_equal(np.asarray(a.user_seen[u]),
                                      np.asarray(b.user_seen[u]))


SEQ = dict(n_items=12, max_len=9, d_model=8, n_layers=2)


def _seq_fields(seed=0):
    return random_transformer_fields(SEQ["n_items"], SEQ["max_len"],
                                     SEQ["d_model"], SEQ["n_layers"],
                                     seed=seed)


def _items():
    return [f"i{k}" for k in range(SEQ["n_items"])]


def _jax_seq(fields):
    return jseq.SeqRecModel(
        weights=jtr.TransformerWeights(**{f: a.copy()
                                          for f, a in fields.items()}),
        item_bimap=JBiMap({t: i for i, t in enumerate(_items())}),
        n_heads=2, max_len=SEQ["max_len"], final_loss=1.25)


def _port_seq(fields, step_losses=None):
    model = convert.seqrec_model_from_numpy(fields, _items(), 2,
                                            SEQ["max_len"], device=CPU)
    return dataclasses.replace(model, final_loss=1.25,
                               step_losses=step_losses)


def _same_seq(a, b):
    for f in convert.FIELDS:
        x = getattr(a.weights, f)
        y = getattr(b.weights, f)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype == np.float32, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert dict(a.item_bimap.items()) == dict(b.item_bimap.items())
    assert (a.n_heads, a.max_len, a.final_loss) == (
        b.n_heads, b.max_len, b.final_loss)


@pytest.mark.parametrize("seed", [0, 1])
def test_jax_als_blob_decodes_into_the_port(seed):
    parts = _als_numpy(seed)
    blob = jckpt.serialize_models([_jax_als(*parts)], "inst", JContext())
    [got] = tckpt.deserialize_models(blob)
    assert type(got) is teng.ALSModel
    assert isinstance(got.user_bimap, BiMap)
    _same_als(got, _jax_als(*parts))
    served = teng.ALSAlgorithm().prepare_model(RuntimeContext(device=CPU),
                                               got)
    assert served.user_factors.dtype == torch.float32
    np.testing.assert_array_equal(served.user_factors.numpy(), parts[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_port_als_blob_decodes_in_jax_and_is_the_same_bytes(seed):
    parts = _als_numpy(seed)
    blob = tckpt.serialize_models([_port_als(*parts)], "inst",
                                  RuntimeContext(device=CPU))
    [got] = jckpt.deserialize_models(blob)
    assert type(got) is jeng.ALSModel
    assert isinstance(got.user_bimap, JBiMap)
    _same_als(got, _jax_als(*parts))
    assert blob == jckpt.serialize_models([_jax_als(*parts)], "inst",
                                          JContext())


def test_jax_seq_blob_decodes_into_the_port():
    fields = _seq_fields(3)
    blob = jckpt.dumps([_jax_seq(fields)])
    [got] = tckpt.deserialize_models(blob)
    assert type(got) is tseq.SeqRecModel
    assert type(got.weights) is ttr.TransformerWeights
    assert got.step_losses is None
    _same_seq(got, _jax_seq(fields))
    served = tseq.SeqRecAlgorithm(tseq.SeqRecAlgorithmParams(
        app_name="a")).prepare_model(RuntimeContext(device=CPU), got)
    assert served.weights.wq.dtype == torch.float32


def test_port_seq_blob_decodes_in_jax_and_is_the_same_bytes():
    """The port's ``step_losses`` (which the JAX model lacks) is not
    written: the JAX decoder's ``cls(**fields)`` takes the blob."""
    fields = _seq_fields(4)
    model = _port_seq(fields, step_losses=np.ones((2, 3), np.float32))
    blob = tckpt.dumps([model])
    [got] = jckpt.deserialize_models(blob)
    assert type(got) is jseq.SeqRecModel
    assert type(got.weights) is jtr.TransformerWeights
    _same_seq(got, _jax_seq(fields))
    assert blob == jckpt.dumps([_jax_seq(fields)])
    [back] = tckpt.deserialize_models(blob)
    assert back.step_losses is None


def test_tensors_on_any_device_are_written_as_host_arrays():
    parts = _als_numpy(2)
    model = _port_als(*parts)
    assert tckpt.dumps([model]) == tckpt.dumps(
        [tckpt.host_materialize(model)])
    host = tckpt.host_materialize(model)
    assert isinstance(host.user_factors, np.ndarray)
    assert isinstance(model.user_factors, torch.Tensor)   # not changed
    back = teng.ALSAlgorithm().prepare_model(RuntimeContext(device=CPU),
                                             tckpt.loads(tckpt.dumps(host)))
    assert torch.equal(back.user_factors, model.user_factors)
    assert back.item_years == model.item_years
    assert isinstance(back.user_bimap, BiMap)


def test_structural_values_round_trip_across_packages():
    from incubator_predictionio_tpu.data.datamap import DataMap as JDataMap

    value = {"t": (1, "a", 2.5), "s": {3, 4}, "m": {1: "x", (2, 3): "y"},
             "np": np.arange(6, dtype=np.int16).reshape(2, 3),
             "scalar": np.float32(1.5), "dm": DataMap({"k": [1, 2]}),
             "bm": BiMap({"a": 0, "b": 1}),
             "tensor": torch.arange(4, dtype=torch.float32)}
    blob = tckpt.dumps(value)
    got = jckpt.loads(blob)
    assert got["t"] == (1, "a", 2.5) and got["s"] == {3, 4}
    assert got["m"] == {1: "x", (2, 3): "y"}
    np.testing.assert_array_equal(got["np"], value["np"])
    assert got["scalar"] == np.float32(1.5)
    assert isinstance(got["dm"], JDataMap) and got["dm"].get("k") == [1, 2]
    assert dict(got["bm"].items()) == {"a": 0, "b": 1}
    np.testing.assert_array_equal(got["tensor"], np.arange(4, dtype=np.float32))
    back = tckpt.loads(jckpt.dumps(got))
    assert isinstance(back["dm"], DataMap) and isinstance(back["bm"], BiMap)


@dataclasses.dataclass
class _Foreign:
    x: int


def _blob_naming(path):
    import msgpack

    root = [{"~pio~": "dc", "c": path, "f": {"x": 1}}]
    return b"PIOCKPT2" + msgpack.packb({"version": 2, "root": root},
                                       use_bin_type=True)


@pytest.mark.parametrize("path", [
    "incubator_predictionio_tpu.models.classification.engine:Model",
    "incubator_predictionio_tpu_torch.no_such_module:Model",
    "some_plugin.models:Model",
])
def test_a_blob_naming_a_module_not_imported_is_refused(path):
    assert path.partition(":")[0] not in sys.modules
    with pytest.raises(tckpt.CheckpointError, match="not imported"):
        tckpt.loads(_blob_naming(path))
    assert path.partition(":")[0] not in sys.modules


def test_only_dataclasses_are_constructed():
    with pytest.raises(tckpt.CheckpointError, match="not a dataclass"):
        tckpt.loads(_blob_naming(
            "incubator_predictionio_tpu.data.bimap:BiMap"))
    # a dataclass of an imported module outside both packages decodes
    [obj] = tckpt.loads(_blob_naming(f"{__name__}:_Foreign"))
    assert obj == _Foreign(1)


_MANIFEST_CLS = ("incubator_predictionio_tpu.core.persistent_model."
                 "LocalFileSystemPersistentModel")

_BLOCKED_MANIFEST = textwrap.dedent('''
    import importlib.abc, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if (name == "incubator_predictionio_tpu"
                    or name.startswith("incubator_predictionio_tpu.")):
                raise ImportError("the port imported " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    from incubator_predictionio_tpu_torch.core import persistent_model as pm
    from incubator_predictionio_tpu_torch.parallel.context import (
        RuntimeContext)
    from incubator_predictionio_tpu_torch.workflow import checkpoint
    # the stored model itself, as the port's own class would have saved it
    pm.LocalFileSystemPersistentModel().save("inst", None, None)
    with open(sys.argv[1], "rb") as f:
        [manifest] = checkpoint.deserialize_models(f.read())
    assert type(manifest) is pm.PersistentModelManifest, type(manifest)
    assert manifest.class_path == sys.argv[2], manifest.class_path
    got = manifest.load(None, RuntimeContext(device="cpu"))
    assert type(got) is pm.LocalFileSystemPersistentModel, type(got)
    leaked = [m for m in sys.modules if m == "jax" and sys.modules[m]
              or m.startswith("incubator_predictionio_tpu.")]
    assert not leaked, leaked
    print("OK")
''')


def test_a_jax_path_never_imports_the_jax_package(tmp_path, monkeypatch):
    """A JAX blob holding a PersistentModel manifest decodes and loads in
    the port with JAX and the JAX package blocked: the manifest's class
    path under the JAX package names the port's class, read by name."""
    from incubator_predictionio_tpu.core import persistent_model as jpm

    monkeypatch.setenv("PIO_HOME", str(tmp_path))
    blob = jckpt.serialize_models([jpm.LocalFileSystemPersistentModel()],
                                  "inst", JContext())
    [manifest] = jckpt.deserialize_models(blob)
    assert manifest.class_path == _MANIFEST_CLS
    path = tmp_path / "blob"
    path.write_bytes(blob)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_MANIFEST, str(path), _MANIFEST_CLS],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_port_manifest_blob_is_the_jax_packages_bytes(tmp_path, monkeypatch):
    """The port writes a PersistentModel's manifest under the JAX
    package's module path, so the JAX package loads it as its own class."""
    from incubator_predictionio_tpu.core import persistent_model as jpm
    from incubator_predictionio_tpu_torch.core import persistent_model as tpm

    monkeypatch.setenv("PIO_HOME", str(tmp_path))
    blob = tckpt.serialize_models([tpm.LocalFileSystemPersistentModel()],
                                  "inst", RuntimeContext(device=CPU))
    assert blob == jckpt.serialize_models(
        [jpm.LocalFileSystemPersistentModel()], "inst", JContext())
    [manifest] = jckpt.deserialize_models(blob)
    assert manifest.class_path == _MANIFEST_CLS
    got = manifest.load(None, JContext())
    assert type(got) is jpm.LocalFileSystemPersistentModel


@pytest.mark.parametrize("class_path, match", [
    ("incubator_predictionio_tpu.no_such_module.Model", "not imported"),
    ("some_plugin.models.Model", "not imported"),
    ("incubator_predictionio_tpu.data.bimap.BiMap", "not a PersistentModel"),
    (f"{__name__}._Foreign", "not a PersistentModel"),
])
def test_a_manifest_loads_only_persistent_models_already_imported(
        class_path, match):
    from incubator_predictionio_tpu_torch.core import persistent_model as tpm

    mod = class_path.rpartition(".")[0]
    imported = mod in sys.modules
    with pytest.raises(tckpt.CheckpointError, match=match):
        tpm.PersistentModelManifest(class_path=class_path,
                                    instance_id="i").load(
            None, RuntimeContext(device=CPU))
    assert (mod in sys.modules) == imported


_REDUCED = []


def _record_reduce():
    _REDUCED.append(1)


class _Payload:
    def __reduce__(self):
        return (_record_reduce, ())


@pytest.mark.parametrize("blob", [
    pickle.dumps((1, _Payload())),
    pickle.dumps((1, [np.zeros(3, np.float32)])),
    b"",
    b"PIOCKPT1" + b"\0" * 8,
])
def test_a_blob_without_the_v2_header_is_refused_unread(blob):
    """The port never wrote the version-1 pickle format: such a blob is
    refused before any of it is unpickled."""
    with pytest.raises(tckpt.CheckpointError, match="version-2"):
        tckpt.loads(blob)
    with pytest.raises(tckpt.CheckpointError, match="version-2"):
        tckpt.deserialize_models(blob)
    assert not _REDUCED
