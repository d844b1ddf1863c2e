"""Multi-level discrete-code store (numpy only).

The port's copy of ``vqvae3d_tpu/data/code_store.py``: the writer, the
reader, and the prior-training dataset and data module (the same split, the
same shuffle keyed on (seed, epoch), so both packages draw the same batches
from one store). One sub-store per
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
from typing import List, Sequence

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


class CodeDataset:
    """Level-i training pairs [data, condition (the next-coarser level)]
    (reference load_lmdb_dataset.py:54-109)."""

    def __init__(self, root: str, embedding_id: int = -1, backend: str = "auto"):
        self.store = CodeStore(root, backend=backend)
        n_enc = self.store.num_levels
        if embedding_id >= n_enc:
            raise ValueError(f"level {embedding_id} of a {n_enc}-level store")
        self.embedding_id = embedding_id
        self._idx = range(n_enc) if embedding_id == -1 else range(embedding_id, n_enc)[:2]
        self.num_embeddings = [self.store.num_embeddings[i] for i in self._idx]
        if len(self.num_embeddings) == 1:
            self.num_embeddings.append(0)

    @property
    def n_enc(self) -> int:
        return self.store.num_levels

    def __len__(self) -> int:
        return self.store.length

    def __getitem__(self, index: int) -> List[np.ndarray]:
        return [self.store.get(index, i) for i in self._idx]


def _degrid(arr) -> np.ndarray:
    """Stored grids may carry the extraction's batch-1 dim (the reference
    stores (1, d, h, w) and squeezes it in training)."""
    arr = np.asarray(arr)
    return arr[0] if arr.ndim == 4 and arr.shape[0] == 1 else arr


class CodeDataModule:
    """Split and batch iteration over code grids for prior training
    (reference LMDBDataModule, load_lmdb_dataset.py:12-50): a
    ``train_frac`` split of a seeded permutation, the train batches shuffled
    by a generator keyed on (seed, epoch), whole batches only."""

    def __init__(self, path: str, embedding_id: int, batch_size: int = 16,
                 train_frac: float = 0.95, seed: int = 42, backend: str = "auto"):
        self.dataset = CodeDataset(path, embedding_id, backend=backend)
        self.batch_size = batch_size
        self.num_embeddings = self.dataset.num_embeddings
        self.n_enc = self.dataset.n_enc
        n = len(self.dataset)
        perm = np.random.default_rng(seed).permutation(n)
        train_len = int(n * train_frac)
        self.train_indices = perm[:train_len]
        self.val_indices = perm[train_len:]
        self.seed = seed

    def _iter(self, indices, shuffle: bool, epoch: int = 0, process_index: int = 0,
              process_count: int = 1):
        """Iterate global batches; under ``process_count`` processes each
        reads its contiguous slice of every global batch (the shuffle keyed
        on (seed, epoch) alone, as ``CTDataModule._iter``; JAX
        code_store.py:205-222)."""
        idx = np.array(indices)
        if shuffle:
            idx = np.random.default_rng(self.seed + 1 + epoch).permutation(idx)
        if self.batch_size % process_count:
            raise ValueError(f"batch size {self.batch_size} does not divide over "
                             f"{process_count} processes")
        bs = self.batch_size // process_count
        lo = process_index * bs
        for b in range(len(idx) // self.batch_size):
            start = b * self.batch_size + lo
            items = [self.dataset[int(i)] for i in idx[start:start + bs]]
            batch = {"data": np.stack([_degrid(it[0]) for it in items]).astype(np.int32)}
            if len(items[0]) > 1:
                batch["condition"] = np.stack([_degrid(it[1]) for it in items]).astype(np.int32)
            yield batch

    def train_dataloader(self, epoch: int = 0, process_index: int = 0, process_count: int = 1):
        return self._iter(self.train_indices, True, epoch, process_index, process_count)

    def val_dataloader(self, process_index: int = 0, process_count: int = 1):
        return self._iter(self.val_indices, False, 0, process_index, process_count)
