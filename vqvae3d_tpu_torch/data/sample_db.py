"""Sample database of code grids (uuid-linked, safe under concurrent writers).

The port's copy of the parts of ``vqvae3d_tpu/data/sample_db.py`` it calls: a
per-level dict of {uuid: {'data': code grid, 'condition': uuid of the coarser
sample}}, pickled, guarded by a FileLock with merge-on-save. Either package
reads what the other writes.
"""
from __future__ import annotations

import pickle
import random
from itertools import chain
from math import ceil
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


def get_condition_uuids(db: Dict, level: int, num_conditions: int) -> List:
    """Pick condition uuids from the next-coarser level at random, repeating
    the pool when it is smaller than the request."""
    if level + 1 not in db or not db[level + 1]:
        raise KeyError(f"the sample DB holds no level-{level + 1} grids to condition on")
    options = list(db[level + 1].keys())
    if len(options) < num_conditions:
        options = list(chain.from_iterable(
            options for _ in range(ceil(num_conditions / len(options)))))
    return random.sample(options, k=num_conditions)


def get_conditions(db: Dict, level: int, uuids) -> np.ndarray:
    """The level-(level+1) grids of ``uuids``, stacked: (N, *grid)."""
    return np.stack([np.asarray(db[level + 1][u]["data"]) for u in uuids])


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
