"""The port's own data modules against the JAX package's, on the same files.

  * NRRD (raw and gzip): each package reads what the other writes, arrays and
    headers equal.
  * Code store (file backend) and sample DB: each package reads what the
    other writes.
  * ``CTDataModule``: the same scans give the same split and bit-identical
    train and val batches (with and without the area rescale, and through
    the decode-once cache); the transforms are equal.
  * ``device_prefetch`` on the CPU yields the batches as tensors, in order.
  * Import guard: in a subprocess where ``import vqvae3d_tpu`` fails, every
    module of ``vqvae3d_tpu_torch`` and ``chip_smoke.py`` imports.
"""
import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from vqvae3d_tpu.data import code_store as jcs
from vqvae3d_tpu.data import ct_dataset as jct
from vqvae3d_tpu.data import nrrd_io as jnrrd
from vqvae3d_tpu.data import sample_db as jdb
from vqvae3d_tpu.data import transforms as jtf
import vqvae3d_tpu_torch
from vqvae3d_tpu_torch.data import code_store as tcs
from vqvae3d_tpu_torch.data import ct_dataset as tct
from vqvae3d_tpu_torch.data import nrrd_io as tnrrd
from vqvae3d_tpu_torch.data import sample_db as tdb
from vqvae3d_tpu_torch.data import transforms as ttf
from vqvae3d_tpu_torch.data.device_feed import device_prefetch

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("encoding", ["raw", "gzip"])
@pytest.mark.parametrize("writer,reader", [(tnrrd, jnrrd), (jnrrd, tnrrd)])
def test_nrrd_both_directions(tmp_path, writer, reader, encoding):
    vol = np.random.default_rng(0).integers(-1000, 2000, size=(7, 5, 3)).astype(np.int16)
    header = {"spacings": (0.976, 0.976, 3.0), "space origin": np.array([1.0, -2.0, 0.5])}
    writer.write(tmp_path / "v.nrrd", vol, header=header, encoding=encoding)
    data, got = reader.read(tmp_path / "v.nrrd")
    np.testing.assert_array_equal(data, vol)
    np.testing.assert_allclose(got["spacings"], header["spacings"])
    np.testing.assert_allclose(got["space origin"], header["space origin"])
    assert got["sizes"].tolist() == [7, 5, 3]


@pytest.mark.parametrize("writer,reader", [(tcs, jcs), (jcs, tcs)])
def test_code_store_both_directions(tmp_path, writer, reader):
    rng = np.random.default_rng(1)
    grids = [[rng.integers(0, 16, size=(4, 4, 2)).astype(np.int32),
              rng.integers(0, 32, size=(2, 2, 1)).astype(np.int32)] for _ in range(3)]
    w = writer.CodeStoreWriter(str(tmp_path / "codes"), 2, [16, 32], backend="file")
    for i, g in enumerate(grids):
        w.write_sample(i, g)
    w.close()
    store = reader.CodeStore(str(tmp_path / "codes"))
    assert (store.length, store.num_levels, list(store.num_embeddings)) == (3, 2, [16, 32])
    for i, g in enumerate(grids):
        for lvl in range(2):
            np.testing.assert_array_equal(store.get(i, lvl), g[lvl])


@pytest.mark.parametrize("writer,reader", [(tdb, jdb), (jdb, tdb)])
def test_sample_db_both_directions(tmp_path, writer, reader):
    path = tmp_path / "samples.db"
    db = writer.create_or_load_db(path, level=1)
    (coarse,) = writer.add_samples(db, 1, np.ones((1, 2, 2, 1), np.int32), None)
    db.setdefault(0, {})
    (fine,) = writer.add_samples(db, 0, np.zeros((1, 4, 4, 2), np.int32), [coarse])
    writer.save_db(db, path, 1)
    writer.save_db(db, path, 0)
    back = reader.create_or_load_db(path, level=0)
    assert back[0][fine]["condition"] == coarse and back[1][coarse]["condition"] is None
    np.testing.assert_array_equal(back[1][coarse]["data"], np.ones((2, 2, 1)))


def _scans(root, rng, n=4):
    root.mkdir()
    for i in range(n):
        vol = rng.integers(-1200, 2500, size=(16, 16, int(rng.integers(5, 12)))).astype(np.int16)
        jnrrd.write(root / f"scan{i}.nrrd", vol, header={"spacings": (0.976, 0.976, 3)})
    # filtered out: wrong size, wrong spacing
    jnrrd.write(root / "small.nrrd", np.zeros((8, 16, 6), np.int16),
                header={"spacings": (0.976, 0.976, 3)})
    jnrrd.write(root / "coarse.nrrd", np.zeros((16, 16, 6), np.int16),
                header={"spacings": (2.0, 2.0, 3)})


@pytest.mark.parametrize("rescale", [None, (8, 8, 4)])
def test_ct_data_module_matches_jax(tmp_path, rescale):
    _scans(tmp_path / "ct", np.random.default_rng(2))
    kw = dict(batch_size=2, train_frac=0.5, num_workers=2, rescale_input=rescale,
              size=(16, 16, None), output_depth=8)
    cache = None if rescale else str(tmp_path / "cache")
    jdm = jct.CTDataModule(str(tmp_path / "ct"), **kw)
    tdm = tct.CTDataModule(str(tmp_path / "ct"), **kw, cache_dir=cache)
    assert tdm.train_len == jdm.train_len == 2 and tdm.val_len == jdm.val_len == 2
    for _ in range(2):  # the second pass reads the port's cache
        for epoch in (0, 1):
            for tb, jb in zip(tdm.train_dataloader(epoch=epoch), jdm.train_dataloader(epoch=epoch),
                              strict=True):
                for k in ("volume", "num_valid_slices"):
                    np.testing.assert_array_equal(tb[k], jb[k])
        for tb, jb in zip(tdm.val_dataloader(), jdm.val_dataloader(), strict=True):
            np.testing.assert_array_equal(tb["volume"], jb["volume"])


def test_transforms_match_jax():
    hu = np.random.default_rng(3).integers(-3000, 4000, size=(6, 6, 5)).astype(np.int16)
    np.testing.assert_array_equal(ttf.hu_window_normalize(hu), jtf.hu_window_normalize(hu))
    v = ttf.hu_window_normalize(hu)
    np.testing.assert_array_equal(ttf.hu_unnormalize(v), jtf.hu_unnormalize(v))
    for depth in (3, 9):
        a, na = ttf.depth_pad_and_crop(v, depth)
        b, nb = jtf.depth_pad_and_crop(v, depth)
        np.testing.assert_array_equal(a, b)
        assert na == nb
    np.testing.assert_array_equal(ttf.create_cylinder_xy_mask((12, 10)),
                                  jtf.create_cylinder_xy_mask((12, 10)))


def test_device_prefetch_on_cpu():
    batches = [{"volume": np.full((1, 2, 2, 2, 1), i, np.float32),
                "num_valid_slices": np.array([i], np.int32)} for i in range(5)]
    out = list(device_prefetch(iter(batches), "cpu", size=2))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["volume"], torch.Tensor) and int(b["num_valid_slices"]) == i
        assert float(b["volume"].mean()) == i


def test_port_imports_nothing_of_the_jax_package():
    modules = [m.name for m in pkgutil.walk_packages(vqvae3d_tpu_torch.__path__,
                                                     "vqvae3d_tpu_torch.")]
    script = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["vqvae3d_tpu"] = None  # any import of the JAX package now raises
        for name in {modules!r} + ["chip_smoke"]:
            importlib.import_module(name)
        print("GUARD_OK", len({modules!r}) + 1)
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0 and "GUARD_OK" in proc.stdout, proc.stderr[-3000:]
    assert len(modules) >= 25
