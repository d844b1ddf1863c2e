"""The port's checkpoint directory: ``latest.txt``, ``step_N_config.json``,
``step_N.pt`` (a state_dict under the reference keys: parameters and
quantizer buffers) and, for a train state, ``step_N_train.pt`` (the step and
the optimizer state).

``save_train_state`` / ``restore_train_state`` keep the semantics of
``vqvae3d_tpu/train/checkpoint.py:46-107``: ``latest.txt`` names the newest
step and is written last, ``max_to_keep`` prunes all but the newest N steps
after a save (the CLI keeps the last checkpoint in its directory and the
best one under ``best/``). ``load_model`` reads the model of either kind of
checkpoint, so a training run's directory serves ``extract_embeddings``.

The config JSON has the format of ``vqvae3d_tpu/train/checkpoint.py::
_config_to_json`` (``dataclasses.asdict`` with the dtype by name), so either
package reads the other's config: the JAX config's TPU layout fields
(``models.vqvae.JAX_LAYOUT_FIELDS``: ``remat*``, ``argmin_method``,
``packed_stacks``, ``scan_stacks``) are dropped on load, and the JAX package
fills them with its defaults when it reads the port's. Orbax checkpoints of
the JAX package are not read here: turning one into a state_dict needs jax
(``convert.jax_variables_to_state_dict`` on ``jax.device_get(variables)``).

Prior checkpoints use the same directory format, for either prior:
``save_prior`` writes a PixelCNN's or a PixelSNAIL's state_dict and config,
``save_prior_train_state`` adds the step and the optimizer state as a train
state does, and ``load_prior`` rebuilds the model from either (so a
``train_prior`` run's directory serves ``sample_embeddings``). The prior's
config JSON is the JAX ``PixelCNNConfig``'s or ``PixelSNAILConfig``'s, with
no extra key, so the JAX package reads it; its fields name the model class
(``prior_class``: a PixelSNAIL config has ``num_blocks``, a PixelCNN config
``num_resblocks``). The PixelCNN's TPU layout switches (``scan_stacks``,
``remat_scan``) are accepted and dropped on load.

``load_model`` and ``load_prior`` put the model on the card unless the
caller names another device.

Under a process group (``parallel/multihost.py``) every rank holds the same
train state, so ``save_train_state`` writes on the primary rank only and
every rank waits at a barrier until the files are there; on ``--resume``
every rank restores from the same files.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import torch

from vqvae3d_tpu_torch.models.pixelcnn import PixelCNN, PixelCNNConfig
from vqvae3d_tpu_torch.models.pixelsnail import PixelSNAIL, PixelSNAILConfig
from vqvae3d_tpu_torch.models.vqvae import JAX_LAYOUT_FIELDS, VQVAE, VQVAEConfig
from vqvae3d_tpu_torch.parallel.multihost import barrier, is_primary

PRIOR_LAYOUT_FIELDS = ("scan_stacks", "remat_scan")  # JAX-only, dropped on load


def config_to_json(config) -> str:
    d = dataclasses.asdict(config)
    if d.get("dtype") is not None:
        d["dtype"] = str(d["dtype"]).removeprefix("torch.")
    return json.dumps(d)


def config_from_json(text: str, cls=VQVAEConfig, drop=JAX_LAYOUT_FIELDS):
    d = json.loads(text)
    for k in drop:
        d.pop(k, None)
    if d.get("dtype") is not None:
        dt = getattr(torch, d["dtype"], None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {d['dtype']!r}")
        d["dtype"] = dt
    if isinstance(d.get("num_embeddings"), list):
        d["num_embeddings"] = tuple(d["num_embeddings"])
    return cls(**d)


def latest_step(path) -> Optional[int]:
    f = Path(path) / "latest.txt"
    return int(f.read_text()) if f.exists() else None


def _step(path, step):
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path} (no latest.txt)")
    return step


def save_checkpoint(path, state_dict: Dict[str, torch.Tensor], config, step: int = 0) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    cpu = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save(cpu, path / f"step_{step}.pt")
    (path / f"step_{step}_config.json").write_text(config_to_json(config))
    (path / "latest.txt").write_text(str(step))


def load_config(path, step: Optional[int] = None) -> VQVAEConfig:
    path = Path(path)
    return config_from_json((path / f"step_{_step(path, step)}_config.json").read_text())


def load_model(path, device="cuda", step: Optional[int] = None) -> Tuple[VQVAE, VQVAEConfig]:
    """Rebuild the model from its config and load its state_dict (strict)."""
    path = Path(path)
    step = _step(path, step)
    config = load_config(path, step)
    model = VQVAE(config)
    state = torch.load(path / f"step_{step}.pt", map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    return model.to(device).eval(), config


def save_train_state(path, model, optimizer, config, step: int,
                     max_to_keep: Optional[int] = None) -> None:
    """Save params + quantizer buffers, the optimizer state and the step;
    then keep only the newest ``max_to_keep`` steps. Under a process group
    the primary rank writes and every rank returns once it has."""
    if is_primary():
        _write_train_state(Path(path), model, optimizer, config, step, max_to_keep)
    barrier()


def _write_train_state(path: Path, model, optimizer, config, step: int,
                       max_to_keep: Optional[int]) -> None:
    path.mkdir(parents=True, exist_ok=True)
    opt = {k: v.detach().cpu() if torch.is_tensor(v) else v
           for k, v in optimizer.state_dict().items()}
    torch.save({"step": int(step), "optimizer": opt}, path / f"step_{step}_train.pt")
    save_checkpoint(path, model.state_dict(), config, step)  # writes latest.txt last
    if max_to_keep is not None:
        steps = sorted(int(f.name[len("step_"):-len(".pt")]) for f in path.glob("step_*.pt")
                       if f.name[len("step_"):-len(".pt")].isdigit())
        for old in steps[: max(0, len(steps) - max_to_keep)]:
            for suffix in (".pt", "_config.json", "_train.pt"):
                (path / f"step_{old}{suffix}").unlink(missing_ok=True)


def restore_train_state(path, model, optimizer, step: Optional[int] = None) -> int:
    """Load a train state saved by ``save_train_state`` into ``model`` and
    ``optimizer`` (in place); returns its step."""
    path = Path(path)
    step = _step(path, step)
    state = torch.load(path / f"step_{step}.pt", map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    train = torch.load(path / f"step_{step}_train.pt", map_location="cpu", weights_only=True)
    optimizer.load_state_dict(train["optimizer"])
    return int(train["step"])


Prior = Union[PixelCNN, PixelSNAIL]


def prior_class(fields) -> Tuple[type, type]:
    """(model class, config class) of a prior config's field names."""
    if "num_blocks" in fields:
        return PixelSNAIL, PixelSNAILConfig
    if "num_resblocks" in fields:
        return PixelCNN, PixelCNNConfig
    raise ValueError(f"not a prior config: fields {sorted(fields)}")


def save_prior(path, model: Prior, step: int = 0) -> None:
    """Write a prior's state_dict and config as step ``step``."""
    save_checkpoint(path, model.state_dict(), model.config, step)


def save_prior_train_state(path, model: Prior, optimizer, step: int,
                           max_to_keep: Optional[int] = None) -> None:
    """``save_train_state`` for a prior: its state_dict and config (what
    ``save_prior`` writes), the step and the optimizer state."""
    save_train_state(path, model, optimizer, model.config, step, max_to_keep)


def restore_prior_train_state(path, model: Prior, optimizer,
                              step: Optional[int] = None) -> int:
    """Load a prior's train state into ``model`` and ``optimizer`` (in
    place); returns its step."""
    return restore_train_state(path, model, optimizer, step)


def load_prior(path, device="cuda", step: Optional[int] = None):
    """Rebuild a prior (PixelCNN or PixelSNAIL, by its config's fields) from
    its config and load its state_dict (strict): (model, config)."""
    path = Path(path)
    step = _step(path, step)
    text = (path / f"step_{step}_config.json").read_text()
    model_cls, config_cls = prior_class(json.loads(text))
    config = config_from_json(text, config_cls, drop=PRIOR_LAYOUT_FIELDS)
    model = model_cls(config)
    model.load_state_dict(torch.load(path / f"step_{step}.pt", map_location="cpu",
                                     weights_only=True))
    return model.to(device).eval(), config
