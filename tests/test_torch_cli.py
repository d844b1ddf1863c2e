"""The port's stage-1 serving CLIs on tiny synthetic CT scans, on the CPU.

  * ``extract_embeddings`` writes the same code store as the JAX CLI's
    ``main`` on the same weights (a random JAX variable tree, converted for
    the port): every code grid equal.
  * ``code_store_to_sample_db`` + ``decode_embeddings`` write one int32 NRRD
    per scan; the decoded volumes agree with the JAX ``decode_samples`` on
    the same DB within 2e-3 (tests/test_checkpoint.py's decoded tolerance).
  * In a subprocess where ``import jax`` fails, every module of the port
    imports and both CLIs run: the port never needs jax.
"""
import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae3d_tpu.cli import decode_embeddings as jdecode
from vqvae3d_tpu.cli import extract_embeddings as jextract
from vqvae3d_tpu.data import nrrd_io
from vqvae3d_tpu.data.code_store import CodeStore
from vqvae3d_tpu.data.sample_db import create_or_load_db
from vqvae3d_tpu.models.vqvae import VQVAE as JVQVAE, VQVAEConfig as JConfig
import vqvae3d_tpu_torch
from vqvae3d_tpu_torch.checkpoint import load_model, save_checkpoint
from vqvae3d_tpu_torch.cli import decode_embeddings, extract_embeddings
from vqvae3d_tpu_torch.convert import jax_variables_to_state_dict
from vqvae3d_tpu_torch.models.vqvae import VQVAEConfig

REPO = Path(__file__).resolve().parent.parent
H = W = 32
DEPTH = 16
CFG = dict(n_bottleneck_blocks=2, num_embeddings=(8, 16), n_pre_quantization_blocks=1,
           n_post_quantization_blocks=1, n_post_upscale_blocks=1, n_post_downscale_blocks=1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(0)
    ct = work / "ct"
    ct.mkdir()
    for i in range(3):
        vol = rng.integers(-1000, 1500, size=(H, W, int(rng.integers(10, 17)))).astype(np.int16)
        nrrd_io.write(ct / f"scan{i}.nrrd", vol, header={"spacings": (0.976, 0.976, 3)})
    jcfg = JConfig(**CFG, dtype=jnp.float32, remat=False, argmin_method="ref")
    tcfg = VQVAEConfig(**CFG, dtype=torch.float32)
    jmodel = JVQVAE(jcfg)
    shapes = jax.eval_shape(lambda k, x: jmodel.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, H, W, DEPTH, 1)))
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32), shapes["params"]
    )
    quantizer = {"encoder": {}}
    for name, q in shapes["quantizer"]["encoder"].items():
        embed = rng.standard_normal(q["embed"].shape).astype(np.float32)
        quantizer["encoder"][name] = dict(
            embed=embed, embed_avg=embed.copy(), initialized=np.ones((), bool),
            cluster_size=np.zeros(q["cluster_size"].shape, np.float32),
        )
    variables = {"params": params, "quantizer": quantizer}
    ckpt = work / "ckpt"
    save_checkpoint(ckpt, jax_variables_to_state_dict(variables, tcfg), tcfg)
    return SimpleNamespace(work=work, ct=ct, ckpt=ckpt, jcfg=jcfg, jmodel=jmodel,
                           variables=variables)


def _extract_args(s, name):
    return ["--checkpoint-path", str(s.ckpt), "--dataset-path", str(s.ct),
            "--output-path", str(s.work), "--output-name", name, "--rescale-input", "0",
            "--scan-size", str(H), str(W), "--backend", "file",
            "--output-depth", str(DEPTH)]


def test_extract_matches_the_jax_cli(setup, monkeypatch):
    s = setup
    extract_embeddings.main(extract_embeddings.parse_arguments(
        _extract_args(s, "codes_torch") + ["--device", "cpu"]))

    # the JAX CLI's main on the same weights (its loader swapped for them)
    monkeypatch.setenv("VQVAE3D_COMPILE_CACHE", "0")
    monkeypatch.setattr(jextract, "load_vqvae", lambda path, shape: (
        s.jmodel, SimpleNamespace(**s.variables), s.jcfg))
    jextract.main(jextract.parse_arguments(_extract_args(s, "codes_jax")))

    got, want = CodeStore(str(s.work / "codes_torch")), CodeStore(str(s.work / "codes_jax"))
    assert got.length == want.length == 3 and got.num_embeddings == [8, 16]
    for i in range(3):
        for lvl in range(2):
            assert got.get(i, lvl).shape == (H // 4 ** (lvl + 1), W // 4 ** (lvl + 1),
                                              DEPTH // 4 ** (lvl + 1))
            np.testing.assert_array_equal(got.get(i, lvl), want.get(i, lvl))


def test_decode_writes_volumes_matching_jax(setup, monkeypatch):
    s = setup
    if not (s.work / "codes_torch").exists():
        extract_embeddings.main(extract_embeddings.parse_arguments(
            _extract_args(s, "codes_torch") + ["--device", "cpu"]))
    db_path = s.work / "samples.db"
    assert decode_embeddings.code_store_to_sample_db(s.work / "codes_torch", db_path) == 3
    out = s.work / "decoded" / "synth"
    n = decode_embeddings.main(decode_embeddings.parse_arguments(
        [str(db_path), str(s.ckpt), str(out), "--device", "cpu"]))
    files = sorted(out.parent.glob("*.nrrd"))
    assert n == 3 and len(files) == 3
    vol, header = nrrd_io.read(files[0])
    assert vol.shape == (H, W, DEPTH) and vol.dtype == np.int32
    np.testing.assert_allclose(header["spacings"], [0.976, 0.976, 3])

    db = create_or_load_db(db_path, level=0)
    model, _ = load_model(s.ckpt)
    with torch.inference_mode():
        got = dict(decode_embeddings.decode_samples(model, db, torch.device("cpu")))
    # unfolded JAX decode with its block-space rewrites off: the same math as
    # its folded serving path, compiled in seconds instead of a minute
    monkeypatch.setenv("VQVAE3D_BLOCK_REWRITE", "0")
    want = dict(jdecode.decode_samples(s.jmodel, s.variables, db, folded=False))
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], atol=2e-3, rtol=0)


def test_port_runs_with_jax_blocked(setup):
    s = setup
    modules = [m.name for m in pkgutil.walk_packages(vqvae3d_tpu_torch.__path__,
                                                     "vqvae3d_tpu_torch.")]
    script = textwrap.dedent(f"""
        import importlib, sys
        for name in ("jax", "jaxlib", "flax", "orbax"):
            sys.modules[name] = None  # any import of them now raises
        for name in {modules!r}:
            importlib.import_module(name)
        from vqvae3d_tpu_torch.cli import decode_embeddings as D, extract_embeddings as E
        E.main(E.parse_arguments({_extract_args(s, "codes_nojax") + ["--device", "cpu"]!r}))
        D.code_store_to_sample_db({str(s.work / "codes_nojax")!r}, {str(s.work / "nojax.db")!r})
        assert D.main(D.parse_arguments([{str(s.work / "nojax.db")!r}, {str(s.ckpt)!r},
                                         {str(s.work / "nojax" / "v")!r}, "--device", "cpu"])) == 3
        print("NOJAX_OK")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0 and "NOJAX_OK" in proc.stdout, proc.stderr[-3000:]
