"""Sample database of code grids (uuid-linked, safe under concurrent writers).

The port's copy of the parts of ``vqvae3d_tpu/data/sample_db.py`` it calls: a
per-level dict of {uuid: {'data': code grid, 'condition': uuid of the coarser
sample}}, pickled, guarded by a FileLock with merge-on-save. Either package
reads what the other writes.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Optional
from uuid import uuid4

import numpy as np
from filelock import FileLock


def _get_db_lock(db_path) -> FileLock:
    return FileLock(str(db_path) + ".lock")


def create_or_load_db(db_path: Path, level: int) -> Dict:
    db_path = Path(db_path)
    with _get_db_lock(db_path):
        if not db_path.exists():
            db_path.parent.mkdir(parents=True, exist_ok=True)
            db_path.write_bytes(pickle.dumps({}))
        db = pickle.loads(db_path.read_bytes())
    db.setdefault(level, {})
    return db


def save_db(db: Dict, db_path: Path, level: int) -> None:
    """Merge-on-save: re-read under the lock and union the level dict."""
    db_path = Path(db_path)
    with _get_db_lock(db_path):
        if db_path.exists():
            other = pickle.loads(db_path.read_bytes())
            if level in other:
                db[level].update(other[level])
        db_path.write_bytes(pickle.dumps(db))


def add_samples(db: Dict, level: int, samples: np.ndarray,
                condition_uuids: Optional[List]) -> List:
    """Store a batch of grids; returns their new uuids."""
    if condition_uuids is None:
        condition_uuids = [None] * len(samples)
    new = []
    for grid, cond in zip(samples, condition_uuids):
        u = uuid4()
        db[level][u] = {"data": np.asarray(grid), "condition": cond}
        new.append(u)
    return new
