"""Shared CLI plumbing: metric logging and config <-> argparse bridging.

Counterpart of ``vqvae3d_tpu/cli/common.py:72-134``: metrics stream to
stdout and to a JSONL file per run (``<logdir>/metrics.jsonl``), and a
config dataclass's fields become ``--kebab-case`` flags.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Optional


def booltype(v: str) -> bool:
    """Strict 'True'/'False' CLI boolean."""
    if v in ("True", "true", "1"):
        return True
    if v in ("False", "false", "0"):
        return False
    raise ValueError(f"expected True/False, got {v!r}")


class MetricLogger:
    def __init__(self, logdir: Optional[str] = None, name: str = "metrics"):
        self.path = None
        if logdir is not None:
            Path(logdir).mkdir(parents=True, exist_ok=True)
            self.path = Path(logdir) / f"{name}.jsonl"
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict, prefix: str = "") -> Dict[str, float]:
        flat = {(f"{prefix}_{k}" if prefix else k): float(v) for k, v in metrics.items()}
        rec = {"step": int(step), "time": round(time.time() - self._t0, 2), **flat}
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return flat

    def print(self, step: int, flat: Dict[str, float], every: int = 1):
        if step % every == 0:
            msg = " ".join(f"{k}={flat[k]:.5g}" for k in sorted(flat)[:8])
            print(f"[step {step}] {msg}", flush=True)


def add_dataclass_args(parser, cls, skip=("dtype",)):
    """Expose a config dataclass's fields as --kebab-case CLI args."""
    for f in dataclasses.fields(cls):
        if f.name in skip:
            continue
        arg = "--" + f.name.replace("_", "-")
        default = f.default
        if isinstance(default, bool):
            parser.add_argument(arg, type=booltype, default=default)
        elif isinstance(default, int):
            parser.add_argument(arg, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(arg, type=float, default=default)
        elif isinstance(default, tuple):
            parser.add_argument(arg, type=int, nargs="+", default=list(default))
        elif isinstance(default, str):
            parser.add_argument(arg, type=str, default=default)
    return parser


def dataclass_from_args(cls, args, overrides=None, skip=("dtype",)):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in skip or not hasattr(args, f.name):
            continue
        v = getattr(args, f.name)
        if isinstance(f.default, tuple) and isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    kwargs.update(overrides or {})
    return cls(**kwargs)
