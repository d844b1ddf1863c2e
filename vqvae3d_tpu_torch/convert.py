"""Weight bridge: JAX variable trees -> the port's state_dicts.

``jax_variables_to_state_dict`` is the exact inverse of
``vqvae3d_tpu/train/checkpoint.py::convert_reference_vqvae_state_dict``
(reference torch keys and (O, I, kH, kW, kD) conv weights), and also covers
the space-to-depth stem (``stem_space_to_depth=2``), which that converter
refuses. It takes the tree ``{'params', 'quantizer'}`` as nested dicts of
numpy arrays (``jax.device_get(variables)`` on the JAX side) and imports no
jax. The quantizer's ``initialized`` flag becomes ``first_pass = not
initialized``. It covers every block type and both encoder variants: the
'regular' (``FixupResBlock``) and 'evonorm' (``EvonormResBlock``) blocks keep
their JAX parameter names as the port's keys (``bias1a`` … ``scale``,
``evonorm_{1,2,3}.{v,gamma,beta}``, ``branch_conv{1,2,3}`` and
``skip_conv`` with their biases; a ResizeConv3D's ``/conv`` level dropped).
No reference-checkpoint converter exists for those two block types: the JAX
package's (``convert_reference_vqvae_state_dict``) converts pre-activation
trees only.

``jax_pixelcnn_params_to_state_dict`` and ``jax_pixelsnail_params_to_state_dict``
do the same for the priors: each is the exact inverse of
``vqvae3d_tpu/train/checkpoint.py::convert_reference_pixelcnn_state_dict``
(``convert_reference_pixelsnail_state_dict``) and takes the ``params`` tree.
The PixelCNN bridge also covers the concat-activation tree (grouped
kernels, (k…, I/groups, O) -> (O, I/groups, k…), the same transpose) and the
``FixupCausalResBlock`` tree (no ``branch_conv3``, ``expand_rf`` or
``bias3a/3b/4``), which that converter does not read.
``jax_gated_block_params_to_state_dict`` bridges a ``GatedResBlock``.
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

    def block(tree, src, dst, mode):
        {"pre-activation": preact_block, "regular": fixup_block,
         "evonorm": evonorm_block}[config.block_type](tree, src, dst, mode)

    def resize_conv(tree, src, dst, mode, bias):
        conv_entry(tree, src + ("/conv" if mode == "up" else ""), dst, bias=bias)

    def fixup_block(tree, src, dst, mode):
        for name in ("1a", "1b", "2a", "2b"):
            sd[f"{dst}.bias{name}"] = np.asarray(get(tree, f"{src}/bias{name}"))
        sd[f"{dst}.scale"] = np.asarray(get(tree, f"{src}/scale"))
        resize_conv(tree, f"{src}/branch_conv1", f"{dst}.branch_conv1", mode, bias=False)
        conv_entry(tree, f"{src}/branch_conv2", f"{dst}.branch_conv2", bias=False)
        resize_conv(tree, f"{src}/skip_conv", f"{dst}.skip_conv", mode, bias=True)

    def evonorm_block(tree, src, dst, mode):
        for i in (1, 2, 3):
            for name in ("v", "gamma", "beta"):
                sd[f"{dst}.evonorm_{i}.{name}"] = np.asarray(
                    get(tree, f"{src}/evonorm_{i}/{name}"))
        conv_entry(tree, f"{src}/branch_conv1", f"{dst}.branch_conv1")
        resize_conv(tree, f"{src}/branch_conv2", f"{dst}.branch_conv2", mode, bias=True)
        conv_entry(tree, f"{src}/branch_conv3", f"{dst}.branch_conv3")
        if has(tree, f"{src}/skip_conv"):
            resize_conv(tree, f"{src}/skip_conv", f"{dst}.skip_conv", mode, bias=True)

    def preact_block(tree, src, dst, mode):
        for name in ("1a", "1b", "2a", "2b", "3a", "3b", "4"):
            sd[f"{dst}.bias{name}"] = np.asarray(get(tree, f"{src}/bias{name}"))
        sd[f"{dst}.scale"] = np.asarray(get(tree, f"{src}/scale"))
        for i in (1, 3):
            conv_entry(tree, f"{src}/branch_conv{i}", f"{dst}.branch_conv{i}", bias=False)
        resize_conv(tree, f"{src}/branch_conv2", f"{dst}.branch_conv2", mode, bias=False)
        if has(tree, f"{src}/skip_conv"):
            sd[f"{dst}.bias1c"] = np.asarray(get(tree, f"{src}/bias1c"))
            sd[f"{dst}.bias1d"] = np.asarray(get(tree, f"{src}/bias1d"))
            resize_conv(tree, f"{src}/skip_conv", f"{dst}.skip_conv", mode, bias=False)

    def upblock(tree, src, dst, n_up, n_post):
        seq = 0
        for i in range(n_up - 1, -1, -1):
            block(tree, f"{src}/up_{i}", f"{dst}.layers.{seq}", "up")
            seq += 1
            for j in range(n_post):
                block(tree, f"{src}/up_{i}_post_{j}", f"{dst}.layers.{seq}", "same")
                seq += 1

    enc = variables["params"]["encoder"]
    conv_entry(enc, "parse_input", "encoder.parse_input")
    for lvl in range(n_enc):
        seq = 0
        for i in range(config.level_n_down(lvl)):
            block(enc, f"down_{lvl}/down_{i}", f"encoder.down.{lvl}.layers.{seq}", "down")
            seq += 1
            for j in range(config.n_post_downscale_blocks):
                block(enc, f"down_{lvl}/down_{i}_post_{j}", f"encoder.down.{lvl}.layers.{seq}",
                      "same")
                seq += 1
        pqc_src, pqc_dst = f"pre_quantize_cond_{lvl}", f"encoder.pre_quantize_cond.{lvl}"
        if has(enc, f"{pqc_src}/proj"):
            conv_entry(enc, f"{pqc_src}/proj", f"{pqc_dst}.proj")
            upblock(enc, f"{pqc_src}/upsample", f"{pqc_dst}.upsample", n_down,
                    config.n_post_upscale_blocks)
        block(enc, f"{pqc_src}/pre_q", f"{pqc_dst}.pre_q", "same")
        for j in range(config.n_pre_quantization_blocks):
            block(enc, f"pre_quantize_{lvl}_{j}", f"encoder.pre_quantize.{lvl}.{j}", "same")
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
            block(dec, f"post_quantize_{lvl}_{j}", f"decoder.up.{lvl}.{j}", "same")
        upblock(dec, f"up_{lvl}", f"decoder.up.{lvl}.{config.n_post_quantization_blocks}",
                config.level_n_down(lvl), config.n_post_upscale_blocks)
    conv_entry(dec, "out", "decoder.out")
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _causal_block(tree, dst: str, sd: Dict[str, np.ndarray]) -> None:
    """One PreActFixupCausalResBlock, its skip and aux convs included
    (``_convert_causal_block``'s inverse)."""
    for name in ("1a", "1b", "2a", "2b", "3a", "3b", "4"):
        sd[f"{dst}.bias{name}"] = np.asarray(tree[f"bias{name}"])
    sd[f"{dst}.scale"] = np.asarray(tree["scale"])
    streams = ("depth_conv", "height_conv", "width_conv")
    for conv in ("branch_conv1", "branch_conv2", "branch_conv3"):
        for stream in streams:
            sd[f"{dst}.{conv}.{stream}.weight"] = _j2t_conv(tree[conv][stream]["kernel"])
    for stream in ("depth_conv", "height_conv"):
        sd[f"{dst}.expand_rf.{stream}.weight"] = _j2t_conv(tree["expand_rf"][stream]["kernel"])
        sd[f"{dst}.expand_rf.{stream}.bias"] = np.asarray(tree["expand_rf"][stream]["bias"])
    if "condition" in tree:
        sd[f"{dst}.condition.weight"] = _j2t_conv(tree["condition"]["kernel"])
        sd[f"{dst}.condition.bias"] = np.asarray(tree["condition"]["bias"])
    for conv in ("skip_conv", "aux"):
        _biased_streams(tree, conv, f"{dst}.{conv}", sd)


def _fixup_causal_block(tree, dst: str, sd: Dict[str, np.ndarray]) -> None:
    """One FixupCausalResBlock: four scalar biases, the scale, two bias-less
    k-sized causal convs and the optional skip conv."""
    for name in ("1a", "1b", "2a", "2b"):
        sd[f"{dst}.bias{name}"] = np.asarray(tree[f"bias{name}"])
    sd[f"{dst}.scale"] = np.asarray(tree["scale"])
    for conv in ("branch_conv1", "branch_conv2"):
        for stream in ("depth_conv", "height_conv", "width_conv"):
            sd[f"{dst}.{conv}.{stream}.weight"] = _j2t_conv(tree[conv][stream]["kernel"])
    _biased_streams(tree, "skip_conv", f"{dst}.skip_conv", sd)


def jax_gated_block_params_to_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``GatedResBlock`` ``params`` tree -> the port block's state_dict."""
    sd: Dict[str, np.ndarray] = {}
    _biased_streams(tree, "causal_conv", "causal_conv", sd)
    _biased_streams(tree, "skip_conv", "skip_conv", sd)
    convs = ["depth_conv", "height_conv"] + [f"{n}_{i}" for n in ("condition_conv", "res_conv")
                                             for i in range(3)]
    for name in convs:
        if name in tree:
            sd[f"{name}.weight"] = _j2t_conv(tree[name]["kernel"])
            sd[f"{name}.bias"] = np.asarray(tree[name]["bias"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def _biased_streams(tree, conv: str, dst: str, sd: Dict[str, np.ndarray]) -> None:
    """A CausalConv3dAdd with bias, when ``tree`` has it."""
    if conv in tree:
        for stream in ("depth_conv", "height_conv", "width_conv"):
            sd[f"{dst}.{stream}.weight"] = _j2t_conv(tree[conv][stream]["kernel"])
            sd[f"{dst}.{stream}.bias"] = np.asarray(tree[conv][stream]["bias"])


def jax_pixelcnn_params_to_state_dict(params: Dict[str, Any], config) -> Dict[str, torch.Tensor]:
    """A JAX PixelCNN ``params`` tree (nested dicts of numpy arrays) -> the
    port's state_dict, under the reference torch keys."""
    sd: Dict[str, np.ndarray] = {}
    for name in ("parse_input", "parse_output") + (
            ("embed_condition",) if config.use_conditioning else ()):
        sd[f"{name}.weight"] = _j2t_conv(params[name]["kernel"])
        sd[f"{name}.bias"] = np.asarray(params[name]["bias"])
    block = _causal_block if config.use_pre_activation else _fixup_causal_block
    for i in range(config.num_resblocks + 1):
        block(params[f"layer_{i}"], f"layers.{i}", sd)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def jax_pixelsnail_params_to_state_dict(params: Dict[str, Any],
                                        config) -> Dict[str, torch.Tensor]:
    """A JAX PixelSNAIL ``params`` tree (nested dicts of numpy arrays) -> the
    port's state_dict under the reference torch keys: the exact inverse of
    ``vqvae3d_tpu/train/checkpoint.py::convert_reference_pixelsnail_state_dict``
    (``block_i/causal_j`` -> ``layers.i.causal_layers.j``)."""
    sd: Dict[str, np.ndarray] = {}
    for name in ("parse_input", "parse_output") + (
            ("embed_condition",) if config.use_conditioning else ()):
        sd[f"{name}.weight"] = _j2t_conv(params[name]["kernel"])
        sd[f"{name}.bias"] = np.asarray(params[name]["bias"])
    _causal_block(params["to_causal"], "to_causal", sd)
    for i in range(config.num_blocks):
        blk, dst = params[f"block_{i}"], f"layers.{i}"
        for j in range(config.num_layers_per_block):
            _causal_block(blk[f"causal_{j}"], f"{dst}.causal_layers.{j}", sd)
        for proj in ("key_value_proj", "query_proj"):
            _biased_streams(blk, proj, f"{dst}.{proj}", sd)
        _causal_block(blk["out_proj"], f"{dst}.out_proj", sd)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
