"""Convert a reference (PyTorch Lightning) checkpoint into a port checkpoint.

Counterpart of ``vqvae3d_tpu/cli/convert_checkpoint.py``, with the same
``kind`` (``vqvae | pixelcnn | pixelsnail``), config flags and
``--from-hparams`` (a VQ-VAE's hyperparameters read from the checkpoint),
plus ``--device`` (default ``cuda``; no fallback to the CPU when CUDA is
absent: the model the weights load into is put there once they have
loaded). It reads the ``.ckpt`` (``torch.load``: a dict with
``state_dict`` and ``hyper_parameters``) and writes a checkpoint that
``checkpoint.load_model`` / ``load_prior`` read, so every port CLI serves
the reference's published weights.

The port's models keep the reference's module tree, so their state_dict
keys are the reference checkpoint's (``convert.py``, whose bridges are the
exact inverses of the JAX package's ``convert_reference_*``): the
conversion is a strict ``load_state_dict`` into the model the config
builds, where a missing or extra key, or a shape that differs, raises, and
nothing is dropped quietly. Like the JAX converter it refuses a
space-to-depth stem (reference checkpoints have none), and it converts the
trees the JAX converters read: pre-activation VQ-VAE blocks and
pre-activation causal blocks.

    python -m vqvae3d_tpu_torch.cli.convert_checkpoint vqvae ref.ckpt out_dir \\
        --num-embeddings 128 256 512 --n-pre-quantization-blocks 50 ...
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from vqvae3d_tpu_torch.checkpoint import save_checkpoint, save_prior
from vqvae3d_tpu_torch.cli.common import add_dataclass_args, dataclass_from_args
from vqvae3d_tpu_torch.cli.extract_embeddings import resolve_device
from vqvae3d_tpu_torch.models.pixelcnn import PixelCNN, PixelCNNConfig
from vqvae3d_tpu_torch.models.pixelsnail import PixelSNAIL, PixelSNAILConfig
from vqvae3d_tpu_torch.models.vqvae import VQVAE, VQVAEConfig

KINDS = {"vqvae": (VQVAE, VQVAEConfig), "pixelcnn": (PixelCNN, PixelCNNConfig),
         "pixelsnail": (PixelSNAIL, PixelSNAILConfig)}


def parse_arguments(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("kind", choices=list(KINDS))
    known, _ = pre.parse_known_args(argv)

    parser = argparse.ArgumentParser(description=__doc__, parents=[pre])
    parser = add_dataclass_args(parser, KINDS[known.kind][1])
    parser.add_argument("ckpt_path", type=Path)
    parser.add_argument("out_dir", type=Path)
    parser.add_argument("--from-hparams", action="store_true",
                        help="read model hyperparameters from the Lightning "
                             "checkpoint instead of CLI flags (best effort)")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def load_reference_state_dict(ckpt_path):
    """(state_dict, hyper_parameters) of a Lightning checkpoint (or a bare
    state_dict). Its hyperparameters may hold an ``argparse.Namespace``, so
    it is unpickled in full: read only checkpoints you trust."""
    ckpt = torch.load(str(ckpt_path), map_location="cpu", weights_only=False)
    return ckpt.get("state_dict", ckpt), ckpt.get("hyper_parameters", {})


def vqvae_config_from_hparams(hparams) -> VQVAEConfig:
    """The reference's argparse names -> ``VQVAEConfig`` (JAX
    ``_vqvae_config_from_hparams``)."""
    args = hparams.get("args", hparams)

    def get(k, d):
        return args.get(k, d) if isinstance(args, dict) else getattr(args, k, None)

    ne = get("num_embeddings", [256])
    if isinstance(ne, int):
        ne = [ne]
    return VQVAEConfig(
        input_channels=get("input_channels", 1) or 1,
        base_network_channels=get("base_network_channels", 4) or 4,
        n_bottleneck_blocks=get("n_bottleneck_blocks", 3) or 3,
        n_blocks_per_bottleneck=get("n_downscales_per_bottleneck", 2) or 2,
        n_pre_quantization_blocks=get("n_pre_quantization_blocks", 0) or 0,
        n_post_quantization_blocks=get("n_post_quantization_blocks", 0) or 0,
        n_post_upscale_blocks=get("n_post_upscale_blocks", 0) or 0,
        n_post_downscale_blocks=get("n_post_downscale_blocks", 0) or 0,
        num_embeddings=tuple(ne),
    )


def check_convertible(kind: str, config) -> None:
    """Refuse what the JAX converters refuse or do not read."""
    if kind == "vqvae":
        if config.stem_space_to_depth != 1:
            raise ValueError("reference checkpoints have no space-to-depth stem")
        if config.block_type != "pre-activation":
            raise ValueError(f"the reference converter reads pre-activation blocks, not "
                             f"{config.block_type!r}")
    elif kind == "pixelcnn" and (not config.use_pre_activation or config.use_concat_activation):
        raise ValueError("the reference converter reads the default pre-activation "
                         "PixelCNN blocks only")


def main(args):
    device = resolve_device(args.device)
    sd, hparams = load_reference_state_dict(args.ckpt_path)
    model_cls, config_cls = KINDS[args.kind]
    config = (vqvae_config_from_hparams(hparams) if args.kind == "vqvae" and args.from_hparams
              else dataclass_from_args(config_cls, args))
    check_convertible(args.kind, config)
    model = model_cls(config)
    model.load_state_dict(sd)  # strict: a missing or extra key raises
    model.to(device)
    if args.kind == "vqvae":
        save_checkpoint(args.out_dir, model.state_dict(), config)
    else:
        save_prior(args.out_dir, model)
    print(f"converted {args.kind} checkpoint -> {args.out_dir}")
    return model


if __name__ == "__main__":
    main(parse_arguments())
