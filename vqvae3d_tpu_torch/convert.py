"""Weight bridge: a JAX VQVAE variable tree -> the port's state_dict.

``jax_variables_to_state_dict`` is the exact inverse of
``vqvae3d_tpu/train/checkpoint.py::convert_reference_vqvae_state_dict``
(reference torch keys and (O, I, kH, kW, kD) conv weights), and also covers
the space-to-depth stem (``stem_space_to_depth=2``), which that converter
refuses. It takes the tree ``{'params', 'quantizer'}`` as nested dicts of
numpy arrays (``jax.device_get(variables)`` on the JAX side) and imports no
jax. The quantizer's ``initialized`` flag becomes ``first_pass = not
initialized``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _j2t_conv(w) -> np.ndarray:
    """(kH, kW, kD, I, O) -> (O, I, kH, kW, kD)."""
    return np.transpose(np.asarray(w), (4, 3, 0, 1, 2))


def jax_variables_to_state_dict(variables: Dict[str, Any], config) -> Dict[str, torch.Tensor]:
    n_enc = config.n_bottleneck_blocks
    n_down = config.n_blocks_per_bottleneck
    sd: Dict[str, np.ndarray] = {}

    def get(tree, dotted):
        node = tree
        for p in dotted.split("/"):
            node = node[p]
        return node

    def has(tree, dotted):
        try:
            get(tree, dotted)
        except KeyError:
            return False
        return True

    def conv_entry(tree, src, dst, bias=True):
        sd[dst + ".weight"] = _j2t_conv(get(tree, src + "/kernel"))
        if bias and has(tree, src + "/bias"):
            sd[dst + ".bias"] = np.asarray(get(tree, src + "/bias"))

    def fixup_block(tree, src, dst, mode):
        for name in ("1a", "1b", "2a", "2b", "3a", "3b", "4"):
            sd[f"{dst}.bias{name}"] = np.asarray(get(tree, f"{src}/bias{name}"))
        sd[f"{dst}.scale"] = np.asarray(get(tree, f"{src}/scale"))
        for i in (1, 3):
            conv_entry(tree, f"{src}/branch_conv{i}", f"{dst}.branch_conv{i}", bias=False)
        b2 = f"{src}/branch_conv2" + ("/conv" if mode == "up" else "")
        conv_entry(tree, b2, f"{dst}.branch_conv2", bias=False)
        if has(tree, f"{src}/skip_conv"):
            sd[f"{dst}.bias1c"] = np.asarray(get(tree, f"{src}/bias1c"))
            sd[f"{dst}.bias1d"] = np.asarray(get(tree, f"{src}/bias1d"))
            skip = f"{src}/skip_conv" + ("/conv" if mode == "up" else "")
            conv_entry(tree, skip, f"{dst}.skip_conv", bias=False)

    def upblock(tree, src, dst, n_up, n_post):
        seq = 0
        for i in range(n_up - 1, -1, -1):
            fixup_block(tree, f"{src}/up_{i}", f"{dst}.layers.{seq}", "up")
            seq += 1
            for j in range(n_post):
                fixup_block(tree, f"{src}/up_{i}_post_{j}", f"{dst}.layers.{seq}", "same")
                seq += 1

    enc = variables["params"]["encoder"]
    conv_entry(enc, "parse_input", "encoder.parse_input")
    for lvl in range(n_enc):
        seq = 0
        for i in range(config.level_n_down(lvl)):
            fixup_block(enc, f"down_{lvl}/down_{i}", f"encoder.down.{lvl}.layers.{seq}", "down")
            seq += 1
            for j in range(config.n_post_downscale_blocks):
                fixup_block(enc, f"down_{lvl}/down_{i}_post_{j}",
                            f"encoder.down.{lvl}.layers.{seq}", "same")
                seq += 1
        pqc_src, pqc_dst = f"pre_quantize_cond_{lvl}", f"encoder.pre_quantize_cond.{lvl}"
        if has(enc, f"{pqc_src}/proj"):
            conv_entry(enc, f"{pqc_src}/proj", f"{pqc_dst}.proj")
            upblock(enc, f"{pqc_src}/upsample", f"{pqc_dst}.upsample", n_down,
                    config.n_post_upscale_blocks)
        fixup_block(enc, f"{pqc_src}/pre_q", f"{pqc_dst}.pre_q", "same")
        for j in range(config.n_pre_quantization_blocks):
            fixup_block(enc, f"pre_quantize_{lvl}_{j}", f"encoder.pre_quantize.{lvl}.{j}", "same")
        q = variables["quantizer"]["encoder"][f"quantize_{lvl}"]
        dst = f"encoder.quantize.{lvl}"
        sd[f"{dst}.embed"] = np.asarray(q["embed"])
        sd[f"{dst}.embed_avg"] = np.asarray(q["embed_avg"])
        sd[f"{dst}.cluster_size"] = np.asarray(q["cluster_size"])
        sd[f"{dst}.first_pass"] = np.asarray(~np.asarray(q["initialized"], bool))

    dec = variables["params"]["decoder"]
    for lvl in range(n_enc):
        if lvl != n_enc - 1:
            conv_entry(dec, f"proj_{lvl}", f"decoder.proj.{lvl}")
        for j in range(config.n_post_quantization_blocks):
            fixup_block(dec, f"post_quantize_{lvl}_{j}", f"decoder.up.{lvl}.{j}", "same")
        upblock(dec, f"up_{lvl}", f"decoder.up.{lvl}.{config.n_post_quantization_blocks}",
                config.level_n_down(lvl), config.n_post_upscale_blocks)
    conv_entry(dec, "out", "decoder.out")
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
