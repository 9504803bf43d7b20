"""Local-filesystem model blob store.

The port's own copy of incubator_predictionio_tpu/data/storage/localfs.py,
its imports rewritten to this package.

Parity: data/.../storage/localfs/LocalFSModels.scala (and the HDFS twin,
hdfs/HDFSModels.scala — a GCS/remote-fs driver would slot in the same way).
Only the ``Models`` interface is provided, exactly like the reference.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from incubator_predictionio_tpu_torch.data.storage import base


class StorageClient(base.BaseStorageClient):
    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        path = config.properties.get("PATH", "~/.pio_tpu/models")
        self.base_path = Path(path).expanduser()
        self.base_path.mkdir(parents=True, exist_ok=True)

    def close(self) -> None:
        pass


class LocalFSModels(base.Models):
    def __init__(self, client: StorageClient, config: base.StorageClientConfig,
                 prefix: str = ""):
        self.path = client.base_path
        self.prefix = prefix

    def _file(self, model_id: str) -> Path:
        return self.path / f"{self.prefix}{model_id}"

    def insert(self, model: base.Model) -> None:
        self._file(model.id).write_bytes(model.models)

    def get(self, model_id: str) -> Optional[base.Model]:
        f = self._file(model_id)
        if not f.exists():
            return None
        return base.Model(model_id, f.read_bytes())

    def delete(self, model_id: str) -> None:
        f = self._file(model_id)
        if f.exists():
            f.unlink()


DATA_OBJECTS = {"Models": LocalFSModels}
