"""Multi-level discrete-code store (numpy only).

The port's copy of the writer and reader of ``vqvae3d_tpu/data/code_store.py``
(the prior-training dataset classes are not ported yet). One sub-store per
hierarchy level (0 = finest grid), samples keyed by integer index, root
metadata ``num_dbs`` / ``length`` / ``num_embeddings``. Backends:

  * ``lmdb`` — sub-DBs named "0".."n-1" holding pickled numpy arrays, when
    the ``lmdb`` package is present;
  * ``file`` — a directory with ``metadata.json`` + ``level_{i}/{index}.npy``.

Either package reads what the other writes.
"""
from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Sequence

import numpy as np

try:
    import lmdb

    HAS_LMDB = True
except ImportError:
    HAS_LMDB = False


def _resolve_backend(backend: str) -> str:
    if backend == "auto":
        return "lmdb" if HAS_LMDB else "file"
    if backend == "lmdb" and not HAS_LMDB:
        raise RuntimeError("lmdb backend requested but lmdb is not installed")
    return backend


class CodeStoreWriter:
    def __init__(self, path: str, num_levels: int, num_embeddings: Sequence[int],
                 backend: str = "auto", map_size: int = int(1e12)):
        self.path = Path(path)
        self.num_levels = num_levels
        self.num_embeddings = list(num_embeddings)
        self.backend = _resolve_backend(backend)
        self.length = 0
        if self.backend == "lmdb":
            self._env = lmdb.open(str(self.path), map_size=map_size, max_dbs=num_levels)
            self._sub_dbs = [self._env.open_db(str(i).encode()) for i in range(num_levels)]
        else:
            self.path.mkdir(parents=True, exist_ok=True)
            for i in range(num_levels):
                (self.path / f"level_{i}").mkdir(exist_ok=True)

    def write_sample(self, index: int, encodings: Sequence[np.ndarray]) -> None:
        """encodings: per-level int code grids, fine -> coarse."""
        if len(encodings) != self.num_levels:
            raise ValueError(f"{len(encodings)} grids for {self.num_levels} levels")
        if self.backend == "lmdb":
            with self._env.begin(write=True) as txn:
                for sub_db, enc in zip(self._sub_dbs, encodings):
                    txn.put(str(index).encode(), pickle.dumps(np.asarray(enc)), db=sub_db)
        else:
            for i, enc in enumerate(encodings):
                np.save(self.path / f"level_{i}" / f"{index}.npy", np.asarray(enc))
        self.length = max(self.length, index + 1)

    def close(self) -> None:
        if self.backend == "lmdb":
            with self._env.begin(write=True) as txn:
                txn.put(b"num_dbs", str(self.num_levels).encode())
                txn.put(b"length", str(self.length).encode())
                txn.put(b"num_embeddings", pickle.dumps(np.asarray(self.num_embeddings)))
            self._env.close()
        else:
            meta = {"num_dbs": self.num_levels, "length": self.length,
                    "num_embeddings": self.num_embeddings}
            (self.path / "metadata.json").write_text(json.dumps(meta))


class CodeStore:
    """Reader over either backend."""

    def __init__(self, path: str, backend: str = "auto"):
        self.path = Path(path)
        if backend == "auto":
            backend = "file" if (self.path / "metadata.json").exists() else "lmdb"
        self.backend = _resolve_backend(backend)
        if self.backend == "lmdb":
            env = lmdb.open(str(self.path), readonly=True, lock=False, max_dbs=64)
            with env.begin() as txn:
                self.length = int(txn.get(b"length"))
                self.num_levels = int(txn.get(b"num_dbs"))
                self.num_embeddings = [int(v) for v in pickle.loads(txn.get(b"num_embeddings"))]
            env.close()
            self._env = lmdb.open(str(self.path), readonly=True, max_dbs=self.num_levels,
                                  lock=False, meminit=False)
            self._sub_dbs = [self._env.open_db(str(i).encode()) for i in range(self.num_levels)]
        else:
            meta = json.loads((self.path / "metadata.json").read_text())
            self.length = meta["length"]
            self.num_levels = meta["num_dbs"]
            self.num_embeddings = meta["num_embeddings"]

    def get(self, index: int, level: int) -> np.ndarray:
        if self.backend == "lmdb":
            with self._env.begin() as txn:
                return pickle.loads(txn.get(str(index).encode(), db=self._sub_dbs[level]))
        return np.load(self.path / f"level_{level}" / f"{index}.npy")
