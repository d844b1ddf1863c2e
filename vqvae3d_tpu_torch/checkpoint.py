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
package reads the other's config. Orbax checkpoints of the JAX package are
not read here: turning one into a state_dict needs jax
(``convert.jax_variables_to_state_dict`` on ``jax.device_get(variables)``).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from vqvae3d_tpu_torch.models.vqvae import VQVAE, VQVAEConfig


def config_to_json(config: VQVAEConfig) -> str:
    d = dataclasses.asdict(config)
    if d.get("dtype") is not None:
        d["dtype"] = str(d["dtype"]).removeprefix("torch.")
    return json.dumps(d)


def config_from_json(text: str) -> VQVAEConfig:
    d = json.loads(text)
    if d.get("dtype") is not None:
        dt = getattr(torch, d["dtype"], None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {d['dtype']!r}")
        d["dtype"] = dt
    if isinstance(d.get("num_embeddings"), list):
        d["num_embeddings"] = tuple(d["num_embeddings"])
    return VQVAEConfig(**d)


def latest_step(path) -> Optional[int]:
    f = Path(path) / "latest.txt"
    return int(f.read_text()) if f.exists() else None


def _step(path, step):
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path} (no latest.txt)")
    return step


def save_checkpoint(path, state_dict: Dict[str, torch.Tensor], config: VQVAEConfig,
                    step: int = 0) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    cpu = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save(cpu, path / f"step_{step}.pt")
    (path / f"step_{step}_config.json").write_text(config_to_json(config))
    (path / "latest.txt").write_text(str(step))


def load_config(path, step: Optional[int] = None) -> VQVAEConfig:
    path = Path(path)
    return config_from_json((path / f"step_{_step(path, step)}_config.json").read_text())


def load_model(path, device="cpu", step: Optional[int] = None) -> Tuple[VQVAE, VQVAEConfig]:
    """Rebuild the model from its config and load its state_dict (strict)."""
    path = Path(path)
    step = _step(path, step)
    config = load_config(path, step)
    model = VQVAE(config)
    state = torch.load(path / f"step_{step}.pt", map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    return model.to(device).eval(), config


def save_train_state(path, model: VQVAE, optimizer, config: VQVAEConfig, step: int,
                     max_to_keep: Optional[int] = None) -> None:
    """Save params + quantizer buffers, the optimizer state and the step;
    then keep only the newest ``max_to_keep`` steps."""
    path = Path(path)
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


def restore_train_state(path, model: VQVAE, optimizer, step: Optional[int] = None) -> int:
    """Load a train state saved by ``save_train_state`` into ``model`` and
    ``optimizer`` (in place); returns its step."""
    path = Path(path)
    step = _step(path, step)
    state = torch.load(path / f"step_{step}.pt", map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    train = torch.load(path / f"step_{step}_train.pt", map_location="cpu", weights_only=True)
    optimizer.load_state_dict(train["optimizer"])
    return int(train["step"])
