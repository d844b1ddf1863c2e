"""The port's remaining CLIs and readers against the JAX package's, on the CPU.

  * ``convert_checkpoint`` for ``vqvae``, ``pixelcnn`` and ``pixelsnail``: a
    Lightning ``.ckpt`` written from ``convert.jax_*_to_state_dict`` of
    seeded JAX variables (the reference's keys: the bridges are the exact
    inverses of the JAX converters). The port CLI's checkpoint, read back by
    ``checkpoint.load_model`` / ``load_prior``, and the JAX converter's
    conversion of the same ``.ckpt`` (``convert_reference_*_state_dict``,
    the tree its CLI saves with Orbax) give the same fp32 forward on one
    input, within 1e-5 of max|ref| (one JAX compile a kind). A missing key,
    an extra key and a space-to-depth stem raise; ``--from-hparams`` reads
    the reference's argparse names.
  * ``data_marginal``: the ``.npz`` equals the JAX CLI's, bit for bit.
  * ``CTSliceDataset`` items and the four ``SliceSampler`` orders equal
    JAX's (as ``tests/test_aux_components.py`` builds them);
    ``HDF5VolumeDataset`` equals JAX's on a written ``.h5``; the DICOM
    reader raises ``RuntimeError`` without ``pydicom``.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae3d_tpu_torch import checkpoint, convert
from vqvae3d_tpu_torch.cli import convert_checkpoint, data_marginal
from vqvae3d_tpu_torch.data import dicom_dataset, hdf5_dataset, nrrd_io
from vqvae3d_tpu_torch.data.slice_dataset import CTSliceDataset, SliceSampler
from vqvae3d_tpu_torch.models.prior_utils import idx_to_one_hot


def _flags(fields: dict) -> list:
    """Config fields -> the CLI's --kebab-case flags."""
    out = []
    for k, v in fields.items():
        out.append("--" + k.replace("_", "-"))
        out += [str(x) for x in v] if isinstance(v, (tuple, list)) else [str(v)]
    return out


def _ckpt(path, sd, hparams=None):
    torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in sd.items()},
                "hyper_parameters": hparams or {}}, path)
    return path


def _convert(tmp_path, kind, ckpt, fields, name="out"):
    out = tmp_path / name
    convert_checkpoint.main(convert_checkpoint.parse_arguments(
        [kind, str(ckpt), str(out), *_flags(fields), "--device", "cpu"]))
    return out


def _rel(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, f"max|d|={err:.3g} > {rel} x max|ref| {scale:.3g}"


def _refuses(tmp_path, kind, sd, fields):
    """A missing key and an extra key raise: nothing is dropped quietly."""
    key = sorted(sd)[0]
    missing = _ckpt(tmp_path / "missing.ckpt", {k: v for k, v in sd.items() if k != key})
    with pytest.raises(RuntimeError, match="Missing key"):
        _convert(tmp_path, kind, missing, fields, "missing")
    extra = _ckpt(tmp_path / "extra.ckpt", {**sd, "unexpected.weight": np.zeros(1, np.float32)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        _convert(tmp_path, kind, extra, fields, "extra")


def test_convert_vqvae_matches_jax(tmp_path, monkeypatch):
    import test_torch_train as ttt
    from vqvae3d_tpu.models.vqvae import VQVAE as JVQVAE
    from vqvae3d_tpu.train.checkpoint import convert_reference_vqvae_state_dict

    monkeypatch.setenv("VQVAE3D_BLOCK_REWRITE", "0")
    blocks = dict(ttt.BLOCKS, n_post_upscale_blocks=0, n_post_downscale_blocks=0)
    jcfg, tcfg = ttt._configs(1, "wrap", blocks)
    jmodel = JVQVAE(jcfg)
    rng = np.random.default_rng(31)
    variables = ttt._variables(jmodel, rng, initialized=True)
    sd = {k: v.numpy() for k, v in convert.jax_variables_to_state_dict(variables, tcfg).items()}
    fields = dict(blocks, n_bottleneck_blocks=2, num_embeddings=(16, 32),
                  base_network_channels=4, pad_mode="wrap")
    out = _convert(tmp_path, "vqvae", _ckpt(tmp_path / "ref.ckpt", sd), fields)

    model, cfg = checkpoint.load_model(out, device="cpu")
    assert cfg == dataclasses.replace(tcfg, dtype=torch.bfloat16, base_lr=cfg.base_lr)
    fp32 = type(model)(dataclasses.replace(cfg, dtype=torch.float32))
    fp32.load_state_dict(model.state_dict())
    x = rng.uniform(-0.5, 4.0, (1, *ttt.SHAPE, 1)).astype(np.float32)
    with torch.no_grad():
        decoded, (_, _, indices) = fp32(torch.from_numpy(x).movedim(-1, 1))
    jvars = convert_reference_vqvae_state_dict(sd, jcfg)
    jdecoded, (_, _, jindices) = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jvars, jnp.asarray(x))
    _rel(decoded.movedim(1, -1).numpy(), jdecoded)
    for a, b in zip(indices, jindices):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    _refuses(tmp_path, "vqvae", sd, fields)
    with pytest.raises(ValueError, match="space-to-depth"):
        _convert(tmp_path, "vqvae", tmp_path / "ref.ckpt",
                 dict(fields, stem_space_to_depth=2, base_network_channels=8), "stem2")
    # --from-hparams: the reference's argparse names (n_downscales_per_bottleneck)
    hp = argparse.Namespace(input_channels=1, base_network_channels=4, n_bottleneck_blocks=2,
                            n_downscales_per_bottleneck=2, num_embeddings=[16, 32],
                            **{k: 1 for k in ("n_pre_quantization_blocks",
                                              "n_post_quantization_blocks")},
                            n_post_upscale_blocks=0, n_post_downscale_blocks=0)
    hp_ckpt = _ckpt(tmp_path / "hp.ckpt", sd, {"args": hp})
    convert_checkpoint.main(convert_checkpoint.parse_arguments(
        ["vqvae", str(hp_ckpt), str(tmp_path / "hp"), "--from-hparams", "--device", "cpu"]))
    assert checkpoint.load_config(tmp_path / "hp") == dataclasses.replace(
        cfg, pad_mode="wrap", base_lr=convert_checkpoint.VQVAEConfig.base_lr)


def _prior_forward(model_cfg_pair, batch, input_dim, cond_dim):
    model, cfg = model_cfg_pair
    fp32 = type(model)(dataclasses.replace(cfg, dtype=torch.float32))
    fp32.load_state_dict(model.state_dict())
    c = batch.get("condition")
    with torch.inference_mode():
        out = fp32.eval()(idx_to_one_hot(torch.from_numpy(batch["data"]), input_dim),
                          None if c is None else idx_to_one_hot(torch.from_numpy(c), cond_dim))
    return out.movedim(1, -1).numpy()


@pytest.mark.parametrize("kind", ["pixelcnn", "pixelsnail"])
def test_convert_prior_matches_jax(kind, tmp_path):
    from vqvae3d_tpu.train import checkpoint as jckpt

    if kind == "pixelcnn":
        import test_torch_prior_train as tp

        fields = tp._fields(True)
        jmodel, params, _, tcfg = tp._models(True, seed=41)
        sd = convert.jax_pixelcnn_params_to_state_dict(params, tcfg)
        jconvert = jckpt.convert_reference_pixelcnn_state_dict
    else:
        import test_torch_pixelsnail as tp

        fields = tp._fields(True)
        jmodel, params, _, tcfg = tp._models(fields, seed=42)
        sd = convert.jax_pixelsnail_params_to_state_dict(params, tcfg)
        jconvert = jckpt.convert_reference_pixelsnail_state_dict
    sd = {k: v.numpy() for k, v in sd.items()}
    out = _convert(tmp_path, kind, _ckpt(tmp_path / "ref.ckpt", sd), fields)
    batch = tp._batch(np.random.default_rng(43), True)
    got = _prior_forward(checkpoint.load_prior(out, device="cpu"), batch, 5, 4)
    jparams = jconvert(sd, jmodel.config)["params"]
    want = jax.jit(lambda p, x, c: jmodel.apply({"params": p}, x, c, train=False))(
        jparams, jax.nn.one_hot(batch["data"], 5), jax.nn.one_hot(batch["condition"], 4))
    _rel(got, want)
    _refuses(tmp_path, kind, sd, fields)
    if kind == "pixelcnn":
        with pytest.raises(ValueError, match="pre-activation"):
            _convert(tmp_path, kind, tmp_path / "ref.ckpt",
                     dict(fields, use_pre_activation=False), "fixup")


def _scans(root, depths, size=16, seed=0):
    rng = np.random.default_rng(seed)
    root.mkdir(exist_ok=True)
    for i, d in enumerate(depths):
        vol = rng.integers(-1000, 1500, size=(size, size, d)).astype(np.int16)
        nrrd_io.write(root / f"s{i}.nrrd", vol, header={"spacings": (0.976, 0.976, 3)})
    return root


def test_data_marginal_matches_jax(tmp_path):
    from vqvae3d_tpu.cli import data_marginal as jdata_marginal

    ct = _scans(tmp_path / "ct", [8, 6, 9], seed=1)
    outs = {}
    for name, cli in (("jax", jdata_marginal), ("port", data_marginal)):
        outs[name] = tmp_path / f"{name}.npz"
        argv = [str(ct), "--out", str(outs[name]), "--bins", "64", "--scan-size", "16", "16"]
        cli.main(cli.parse_arguments(argv + (["--device", "cpu"] if name == "port" else [])))
    with np.load(outs["jax"]) as want, np.load(outs["port"]) as got:
        assert set(got.files) == set(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert want["counts"].sum() > 0


def test_slice_dataset_and_sampler_match_jax(tmp_path):
    from vqvae3d_tpu.data import slice_dataset as jslice

    ct = _scans(tmp_path / "ct", [5, 7, 4])
    ds, jds = CTSliceDataset(str(ct), size=(16, 16, None)), jslice.CTSliceDataset(
        str(ct), size=(16, 16, None))
    assert len(ds) == len(jds) == 16
    np.testing.assert_array_equal(ds.cumsum, jds.cumsum)
    np.testing.assert_array_equal(ds.idx, jds.idx)
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i], jds[i])
    raw = CTSliceDataset(str(ct), size=(16, 16, None), normalize=False)
    np.testing.assert_array_equal(raw[3], jslice.CTSliceDataset(
        str(ct), size=(16, 16, None), normalize=False)[3])
    for mode in ("none", "inter", "intra", "both"):
        sampler, jsampler = SliceSampler(ds, mode=mode, seed=1), jslice.SliceSampler(
            jds, mode=mode, seed=1)
        for _ in range(2):  # two epochs: default_rng(seed + epoch)
            order = list(sampler)
            assert order == list(jsampler) and sorted(order) == list(range(16))
    assert list(SliceSampler(ds, mode="none")) == list(range(16))
    with pytest.raises(ValueError):
        SliceSampler(ds, mode="bogus")


def test_hdf5_and_dicom_readers_match_jax(tmp_path, monkeypatch):
    import h5py
    from vqvae3d_tpu.data import hdf5_dataset as jhdf5

    rng = np.random.default_rng(2)
    (tmp_path / "h5" / "sub").mkdir(parents=True)
    for name, shape in (("a.h5", (3, 8, 6)), ("sub/b.h5", (8, 6))):
        with h5py.File(tmp_path / "h5" / name, "w") as f:
            f["reconstruction_rss"] = rng.standard_normal(shape)
    ds = hdf5_dataset.HDF5VolumeDataset(str(tmp_path / "h5"), transform=lambda v: v * 2)
    jds = jhdf5.HDF5VolumeDataset(str(tmp_path / "h5"), transform=lambda v: v * 2)
    assert len(ds) == len(jds) == 2
    for i in range(2):
        assert ds[i].dtype == np.float32
        np.testing.assert_array_equal(ds[i], jds[i])
    assert ds[0].shape == (8, 6, 3)

    monkeypatch.setattr(hdf5_dataset, "HAS_H5PY", False)
    with pytest.raises(RuntimeError, match="h5py"):
        hdf5_dataset.HDF5VolumeDataset(str(tmp_path))
    assert not dicom_dataset.HAS_PYDICOM  # neither machine has pydicom
    with pytest.raises(RuntimeError, match="pydicom"):
        dicom_dataset.DICOMSliceDataset(str(tmp_path))
