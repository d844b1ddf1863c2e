#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (vqvae3d_tpu_torch) on one card.

    python3 chip_smoke.py [--seed 0] [--phases 4,9]

(``--phases``: a probe of the listed phases alone; it prints no kernels
line and no result line.)

Builds the CUDA kernels from csrc/ (nvcc, sm_90a), then:

  1. kernels vs plain (serving): K1a (codebook lookup) at the three (N, K, D)
     lookups of a 512x512x128 volume, on random inputs and on inputs with
     exact ties planted across the work split (to the lowest code, as the
     plain version), its split (``lookup_plan``), one launch a lookup, no
     512-code lookup on one CTA, its device time by kernel (torch.profiler)
     beside the event time of 20 back-to-back calls; K3 (the 'same'-block stack forward) at
     every distinct (C, spatial) of the published full config, both pad
     modes, fp32 and bf16, one block and a 50-block stack. Times with CUDA
     events: bf16 per block on its route (``conv3d.stack_fwd_route``: the
     fused tensor-core or CUDA-core brick, or the three kernels) beside the
     parent's three kernels and, at the stem-2 shapes, cuDNN's 3x3x3 Cb ->
     Cb conv of the block (a yardstick of the conv part), in turns; their
     sums a stem-1 and a stem-2 volume.
  2. the serving main path through the entry points: two synthetic int16 CT
     volumes (512x512x128, from --seed) written as NRRD, a port checkpoint at
     the published full config (literal stem, seeded weights perturbed so
     that no Fixup branch is zero), ``extract_embeddings`` then
     ``decode_embeddings`` on the codes it wrote; code-grid shapes, finite
     outputs and the K1a/K3 launch counts the config implies are checked.
  3. the full-config forward in fp32, kernels vs plain: indices
     equal except at genuine ties, decoded volume within tolerance; then bf16
     per-volume latency of the kernel path, the kernel path with K3's
     forward on the parent's three kernels and the plain path, stems 1 and
     2, with peak device memory, and K3's forward device time a volume on
     both routes.
  4. train kernels vs plain: K1b (lookup + EMA statistics) at the three
     lookups, checked and timed as K1a (counts exact, sums within 1e-5, a
     second call bit-identical, its two kernels once a call); the K3 backward at every (C, spatial) of the stem-2 stacks,
     both pad modes, fp32 and bf16, one block and the stack's full depth,
     against the autograd of the plain stack (bf16: its weight contractions
     on the tensor cores, fp32 on the CUDA cores), a second call
     bit-identical; K7 (small-channel conv dW) at every qualifying conv of
     the stem-2 train step against the plain dW; each timed beside its plain
     version (K7 also beside cuDNN's wgrad, the two in turns, and the seven
     convs summed); K3's backward per shape and per step at both routes,
     with its device split by torch.profiler (the dW2 contraction, the
     other contractions, their reduce, the elementwise kernels by name) and
     the dW2 contraction beside its bytes bound and cuDNN's wgrad of the same
     conv (in turns); the bf16 backward on its route (the two brick kernels
     at 5 <= Cb <= 128) and on the parent's five elementwise kernels in
     turns, beside cuDNN's data gradient of the block's 3x3x3 conv (a
     yardstick of the transposed conv).
  5. the stem-2 full-config train step at 512x512x128: one fp32 step on the
     kernel path against the plain path (loss, every gradient, the new EMA
     state); bf16 ms/step of both paths with peak memory (the plain path's
     step once, after the kernel paths' turns); the launches per
     step against what the config implies; two identical steps from one
     state give bit-identical parameters and EMA state; bf16 ms/step also
     with K3's backward on the parent's five elementwise kernels and with
     K3's forward on the parent's three kernels; the quantizer layer's
     device time alone (three levels' train forward and backward, after and
     on the first pass) and K1b's in the step; a profiler breakdown
     (device busy; K3 forward; K3 backward's dW2 contraction, other
     contractions, reduce and elementwise kernels by name; the rest of the
     step), which fails on any index_put / indexing_backward (the codebook
     takes no gradient).
  6. the train main path through the entry points: three synthetic scans,
     ``train_vqvae`` for 3 steps (validating at step 3), then ``--resume``
     for one more, then ``extract_embeddings`` on the checkpoint it wrote.
  7. sampling kernel vs plain: K6 (one row of cached PixelCNN sampling)
     against ``row_decode_plain`` at the top prior's row (51 layers, C=16,
     br=4, K=128, s2=32, B=1, conditioned), at B=2 unconditioned and at
     C=12/br=3: teacher-forced logits and caches within tolerance, free-running
     indices equal except at counted near ties; per-row times and the bound,
     and the voxel chain's clock64() cycles per layer-step.
  8. the sampling main path through the entry point: a seeded port checkpoint
     of the published top prior (PixelCNN 50x16, 128 codes, conditioned on
     256), a sample DB with two level-1 grids 32x32x8, then
     ``sample_embeddings --level 0 --size 128 128 32 --tau 0.1``: the grid's
     shape, range and condition, and exactly 16,384 K6 launches; then the
     cached sampler teacher-forced over the whole grid against the one-shot
     ``PixelCNN.forward`` (every logit); then four slices under the profiler.
  9. prior train kernels vs plain: K4 (PixelCNN's mask-'B' segment on the
     union stream) forward, no-save and saving, and backward, against
     ``causal_stack_plain`` and its autograd, at the top prior's segment
     (B=1, 128x128x32, 50 blocks, conditioned), at B=2 unconditioned and for
     one block with a p = 0.5 keep mask, fp32 and bf16: outputs, dx, the
     condition's gradient and every union-weight gradient; the causality of
     the kernel (impulses forward, gradients backward) against
     ``causal_reach``, in fp32 and in bf16 (the tensor-core forward and
     backward); times beside the plain versions and the bounds; the bf16
     forward and backward each on its tensor-core route and on the
     parent's CUDA-core kernels, in turns, with each one's device time by
     kernel; cuDNN's bf16 conv with the (2, 3, 3) union kernel (a yardstick
     of the forward's conv part).
 10. the top prior's train step at full width (PixelCNN 50x16, 128 codes,
     conditioned on 256, 128x128x32, batch 1): one fp32 step on the kernel
     path against the plain path (loss, every gradient); bf16 ms/step of both
     paths and of the kernel path with K4's forward or its backward on the
     parent's CUDA-core kernels, with peak memory; the launches per step
     against what 50 blocks imply; two identical steps from one state give
     bit-identical parameters; a profiler breakdown (K4's forward by kernel).
 11. the prior train main path through the entry points: a synthetic code
     store (level 0 128x128x32 over 128 codes, level 1 32x32x8 over 256),
     ``train_prior ... --model-dim 16 --num-resblocks 50
     --bottleneck-divisor 4 --dropout-prob 0 --batch-size 1`` for 3 steps
     (validating at step 3), then ``--resume`` for one more, then
     ``load_prior`` and one forward through K4, then ``sample_embeddings``
     of a 32x32x8 grid from the trained checkpoint.
 12. attention kernel vs plain: K8 (causal flash attention) forward and
     backward against the dense ``flash_causal_attention_plain`` and
     ``flash_attention_bwd_plain`` (on the kernel's o), fp32 and bf16 (the
     bf16 backward on the tensor cores), at the bottom PixelSNAIL's call (N = 144,
     S = 128, D = 16; every row) and the mid one's (N = 24, S = 8192, D = 8;
     the plain version on the first stream's 8 heads: its (S, S) logits are
     2 GiB each); a second call bit-identical; the causality of the kernel
     on the card (the gradients of a row reach no later key or value, later
     keys and values never move it); bf16 times beside the plain version,
     SDPA (the library call, timed only; the forward and SDPA in turns) and
     the bound with its terms (bytes, tensor-core products, exps at the
     special-function rate); the fp32 backward's time and the two-pass
     backward's own floor (each exp twice) beside them.
 13. the two published PixelSNAIL train steps (jobs/train_pixelsnail_
     bottom.sh: 3x5x512d, 8x8x2, batch 6, causal dropout 0.5, mixup 0.4;
     jobs/train_pixelsnail_mid_downscaled.sh: 8x5x256d, 32x32x8, batch 1,
     causal dropout 0.2, mixup 0.2; both unconditioned, attention dropout
     0): for each, one fp32 step on the kernel path against the plain path
     (the dense attention checkpointed per block; the same dropout masks
     and mixup), loss and every gradient; bf16 ms/step of both paths with
     peak memory (the plain path's step once, after the kernel path's
     turns); K8 launches per step; two identical bf16 steps
     bit-identical; a profiler breakdown.
 14. the PixelSNAIL train main path: ``train_prior --use-model pixelsnail``
     at both configs on a seeded code store, 3 steps (validating at step 3)
     and ``--resume`` for one more, K8 launches against what the steps and
     validations imply, then ``load_prior``.
 15. wide sampling kernel vs plain: the latency of an exchange between the
     cluster's CTAs (a cluster barrier, and the kernel's st.async exchange;
     a probe kernel of the kernel's cluster size); the wide K6 against
     ``row_decode_plain`` at the published mid (46 layers, C=256, br=64,
     K=256, conditioned, s2=8, B=10) and bottom (51 layers, C=512, br=128,
     K=512, s2=2, B=20) PixelCNN rows, at mid B=32 and bottom B=24 (run as
     sub-batches that fit a CTA's shared memory) and at C=40 / br=10
     (conditioned, s2=8, padded to multiples of 4): teacher-forced logits
     and caches, free-running indices, a second call bit-identical, a NaN
     logit giving -1; per-row times beside the plain row, the bound and the
     design's exchange floor.
 16. the wide sampling main path: seeded checkpoints of the published mid
     and bottom PixelCNNs, ``sample_embeddings`` of a full 32x32x8 grid at
     batch 10 (conditioned on 8x8x2 grids) and full 8x8x2 grids at batch
     20 and 24 (two sub-batches a row), tau 0.1, with the wide K6's launches
     and its share of the device's busy time and of the wall; then the
     cached sampler teacher-forced over the whole grids against the
     one-shot forward.
 17. dropout attention kernel vs plain: K5 (causal flash attention with the
     reference's pre-mask logit dropout, p = 0.5) forward and backward
     against ``flash_causal_dropout_attention_plain`` and its autograd, fp32
     (CUDA cores) and bf16 (tensor cores), at the mid PixelSNAIL's call
     (N = 24, S = 8192, D = 8; the plain version on the first stream's 8
     heads) and a ragged one (N = 6, S = 333, D = 16); a second call
     bit-identical; at p = 0 equal to K8 within K8's tolerance; both routes'
     collected keep masks and the bf16 backward's packed tiles equal to the
     plain Philox mask at every logit; bf16 times beside the parent's
     CUDA-core kernels in turns (split by kernel), the route at p = 0, K8's,
     the plain version's and the bound (no library call computes this
     function).
 18. the conditioned mid PixelSNAIL train step (bench_prior.py:150-166:
     8x5x256d over 256 codes, 32x32x8, conditioned on 8x8x2 of 512, causal
     and attention dropout 0.5, batch 1): as phase 13, with K5 in place of
     K8 (8 forward and 8 backward launches a step), and the parent's K5 in
     turns, the plain path's step run once after the turns (~5.5 s a step:
     cut from two timed turns for the time limit); each profiled step split
     by K5 kernel, with its kernels launched a step and its ten costliest
     host operations.
 19. its train main path: ``train_prior --use-model pixelsnail`` at that
     config on a seeded code store, 3 steps (validating at step 3, where K8
     serves the eval forward), ``--resume`` for one more, and an
     uninterrupted 4-step run whose parameters equal the resumed run's bit
     for bit (cuDNN deterministic).
 20. PixelSNAIL sampling vs the one-shot forward: the cached sampler
     (``sample/cached_snail.py``, plain PyTorch) at the published mid
     widths (256d, 256 codes, 32x32x8, batch 10; 1 of its 8 blocks, see
     ``SNAIL_SAMPLING``) and bottom (3x5x512d, 512
     codes, 8x8x2, batch 20), unconditioned, fp32 random weights: its
     teacher-forced logits against the one-shot ``PixelSNAIL.forward`` (K8)
     over the mid grid's first 8 slices and the whole bottom grid, within
     1e-4 of max|ref|; the bottom grid against the naive sampler's under one
     Gumbel table (equal but at genuine near ties, counted); a conditioned
     8x8x2 grid on 2x2x1 of 512 codes at the conditioned mid widths, forced;
     the forced time, and one bottom grid and a mid grid's first slice alone
     and under torch.profiler (device busy and idle, kernels a voxel, the
     costliest host operations by self time).
 21. the PixelSNAIL sampling main path: seeded checkpoints of both priors,
     ``sample_embeddings --use-model pixelsnail --tau 0.1`` of a full mid
     grid at batch 10 (level 1) then a full bottom grid at batch 20 (level 2)
     into one DB with the cached sampler (no kernel launch), and a bottom
     grid with ``--sampler naive`` (one K8 an attention block a voxel: 384),
     each in a process of its own; the grids' count, shape, dtype and codes,
     and the seconds a batch.
 22. stage-1 block types and published configs (bf16, batch 1, weights from
     the seed perturbed off every zero init): (a) serving at the full config
     with 'regular' and 'evonorm' blocks, stems 2 and 1: the codes against
     the same forward with the plain lookups (equal but at genuine ties), ms
     a volume and peak memory; (b) one counted warm-up train step, then ms a
     step (the mean of 2) and peak memory, at the full config, stem 2, with
     'regular' blocks, 'evonorm' blocks, the legacy encoder and the
     mixture-NLL head: K7, K3 and K1b launches a step against what the
     model implies (K7: a forward hook on every small-channel conv), the
     host time of K7's wrapper in the step, finite losses, and after every
     timing one profiled 'regular' and one 'evonorm' step (device busy
     against the wall, K7's device time, kernels a step); (c) the same for
     the published steps not run before: the literal stem (stem 1, base 4)
     of jobs/train_vqvae_full.sh and jobs/train_vqvae_downscaled.sh (2
     levels, 150 + 150 blocks, 256x256x128); (d) K7 against
     ``dw_conv3d_plain`` at every distinct shape those steps launched, K3
     forward and backward against the plain stack at the legacy encoder's
     C 64 (32x32x8; one block and 50) and on the downscaled config's deepest
     stack (150 blocks), fp32 and bf16; (e) ``train_vqvae --block-type
     evonorm`` at the full config for 2 steps on the train CLI phase's
     scans, then ``calc_ssim_from_checkpoint`` and ``plot_from_checkpoint``
     on its checkpoint, with their launches (in this process since phase 26
     came: each had a process of its own).
 23. the PixelCNN remainder (bf16 unless stated): (a) K4 at p = 0.5 over the
     top prior's 50-block segment (B = 1, 128x128x32, conditioned, one keep
     mask a block as data), fp32 and bf16, output, dx, the condition's
     gradient and every union-weight gradient against ``causal_stack_plain``
     and its autograd; the top prior's train step at dropout 0.5
     (bench_prior.py:130-136) beside dropout 0, in turns, with its launches
     and peak memory; (b) the published mid (jobs/train_pixelcnn_mid.sh: 45
     x 256d, level 1 conditioned on level 2, dropout 0.5, batch 2) and bottom
     (jobs/train_pixelcnn_bottom.sh: 50 x 512d, level 2, unconditioned,
     batch 6) PixelCNN jobs through ``train_prior`` for 3 steps on a
     synthetic three-level code store: step ms, losses, peak memory, no K4
     and no K7; (c) the Fixup (``--use-pre-activation False``),
     concat-activation and k = 5 PixelCNNs at the top width: one fp32 step
     on the kernel path against the plain path (loss, every gradient), a
     counted bf16 step (K7 a step, no K4) and its ms, ``train_prior`` for 2
     steps and one ``--resume``; K7 against ``dw_conv3d_plain`` at every
     shape those steps launched; (d) the cached sampler at k = 5 (its own
     row steps, no kernel) on a top-width model, teacher-forced logits
     against the one-shot forward over 8 slices of a 32x32x8 grid, one
     free-running 32x32x8 grid timed, and
     ``sample_embeddings --sampler naive`` of an 8x8x2 grid from the Fixup
     checkpoint that (c) wrote.
 24. data-parallel training (``vqvae3d_tpu_torch/parallel``): (a)
     ``train_vqvae --multihost --coordinator`` over NCCL at world size 1 and
     the same command without it, side by side in processes of their own at
     the full config, stem 2, bf16, 2 steps and a validation (cuDNN
     deterministic): their checkpoints bit-identical; then, in this process
     at world size 1 over NCCL, the bf16 step with and without its gradient
     all-reduce in turns, and the all-reduce alone; (b) two ranks sharing
     the card over gloo (``DP_RANK``, a process each) against the
     one-process step on the same global batch of 2 (a volume or a grid a
     rank), fp32, two steps from a first pass, for the stage-1 step at the
     full config, stem 2 (K1b, K3, K7) and the top prior at dropout 0 (K4,
     K7): the loss, the log, every gradient, the launches a rank a step, the
     parameters within the AMSGrad bound, the EMA state (cluster_size exact)
     on the codes no tie-flipped row touched, the ranks' states bit for bit;
     then a bf16 step of each, timed on both ranks at once (not a scaling
     figure: two processes share one card); (c) ``--mesh-shape 2 2``
     without ``--multihost`` raises ``ValueError``.
 25. spatial sharding (``--mesh-shape d s``, ``parallel/halo.py``) and the
     remainder's CLIs: (a) two gloo ranks sharing the card at
     ``--mesh-shape 1 2`` (``SP_RANK``, a process each), each an H slab of
     one volume, against the one-process steps on the same volume and
     weights, fp32, the full config, stem 2: the eval step's log (SSIM over
     the gathered slices) within rel 1e-5 and its launches (K1a, K3); one
     train step from a first pass: the loss and the log within rel 1e-5,
     every gradient within phase 24's scale, K1b / K3 fwd and bwd / K7
     launches a rank, cluster_size exact on the codes no genuine tie
     touched (the ties printed), the ranks' states bit for bit; each rank's
     peak memory (fp32 and bf16 step) beside the one process's, and a bf16
     step timed on both ranks at once (not a scaling figure); (b)
     ``convert_checkpoint vqvae`` of a Lightning ``.ckpt`` of phase 3's
     fp32 stem-1 model, the converted checkpoint serving phase 3's volume
     through K3 and K1a bit for bit as phase 3's model does, and
     ``data_marginal`` on the card against ``np.histogram``; (c)
     ``train_vqvae --multihost --mesh-shape 1 2`` through the CLI for 2
     steps and a validation at 10 + 10 blocks a level (full widths), beside
     (a)'s one-process reference; (d) (a)'s checks on a volume of 64 x 512
     x 128 (``SP_WHOLE_VOLUME``: code grids of H 16 / 4 / 1, so the
     coarsest level runs whole on both ranks, ``models/vqvae.py``) in the
     same rank processes, with each rank's launches, its peak memory and a
     bf16 step timed on both ranks at once.
 26. the convergence tools (``vqvae3d_tpu_torch/tools/``), cuDNN
     deterministic: (a) ``convergence_smoke`` (the downscaled config at stem
     2, 150 + 150 blocks a level, bf16, batch 1) on 2 scans it generates at
     256x256x110: 3 steps in a process of its own, then 2 resumed in
     another; every logged value finite, the resumed leg starting at step
     3 with the parameters, EMA buffers and AMSGrad state the first leg
     saved (SHA-256 of every tensor), K1b, K3 forward and backward and K7
     launches a leg against the config (K7: ``k7_expected``'s hooks in the
     tool's process); (b) ``prior_convergence_smoke`` (the top prior, bf16):
     4 steps here, 2 resumed in a process of its own, against 6
     uninterrupted steps here: the parameters and AMSGrad state bit for
     bit, the logs of steps 5-6 equal, K4 and K7 launches a run; (c) (a)'s
     checkpoint through ``extract_embeddings``, ``decode_embeddings`` and
     ``calc_ssim_from_checkpoint``: code-grid shapes and ranges, finite
     volumes, SSIM in [-1, 1], K1a and K3 launches.

Cuts made for the 1200 s limit (widths, grids and batches stay the
published ones): phases 20-21's mid PixelSNAIL at 1 of its 8 blocks (2
until phase 26 came); phase 22's SSIM and plot CLIs in this process;
phase 22 serves at stem 2 only; phase 23's k = 5 forced check covers 8 of 32
slices; phases 5, 13 and 18 run the plain path's step once instead of in two
timed turns; phase 25's CLI run at 10 of the 50 pre- and post-quantization
blocks a level.

TF32 is off for the whole run (fp32 comparisons need true fp32; bf16 runs
do not use it). Every number is printed beside the card's name and power
limit. The line before the last is {"kernels": [...]} (thirteen kernels;
K6's times and bound per 128x128x32 grid, 16,384 rows; K4's per train step
of the top prior, 50 blocks; K8's and K5's per call at the mid PixelSNAIL's
shape; the wide K6's per row of the mid PixelCNN's grid); the last is
{"ok": true, "device": {...}}. Exits non-zero, with no result, when CUDA is
absent, when the package is missing, or when any phase fails.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

FULL = dict(
    num_embeddings=(128, 256, 512),
    n_pre_quantization_blocks=50,
    n_post_quantization_blocks=50,
    n_post_downscale_blocks=2,
    n_post_upscale_blocks=3,
    pad_mode="wrap",
)  # bench.py:117-128, jobs/train_vqvae_full.sh
VOLUME = (512, 512, 128)
N_VOLUMES = 2  # synthetic CT volumes through extract -> decode
# max|kernel - plain| <= tol * max|plain|. Kernel and plain round at the same
# points; only the order of the fp32 sums differs. In fp32 that moves the last
# bits (measured on an NVIDIA H100 80GB HBM3 at 700 W: 2.4e-7 for one block,
# 1.7e-6 for 50). In bf16 it can flip a rounding, one ulp (2^-8..2^-7 of the
# value), and the flips of
# successive blocks add up like a random walk: 2^-7 for one block, 2^-4
# (about sqrt(50) ulps at the top of a binade) for a 50-block stack
# (measured: 3.6e-3 and 3.1e-2).
K3_TOL = {
    ("float32", 1): 1e-4,
    ("float32", 50): 1e-4,
    ("bfloat16", 1): 2**-7,
    ("bfloat16", 50): 2**-4,
}
DECODED_TOL = 1e-3  # fp32 full forward, relative to max|plain decoded|
STEM2 = dict(base_network_channels=8, stem_space_to_depth=2)  # bench_train.py:55-67
# K3 backward vs the autograd of the plain stack, per gradient tensor:
# max|kernel - plain| <= tol * max|plain|. fp32: both sum in fp32 in another
# order. bf16: the plain reference rounds every gradient and cuDNN's dW to
# bf16 where the kernel sums dW and the scalar grads in fp32, and rounding
# flips carry through the blocks of a deep stack.
# Measured on an NVIDIA H100 80GB HBM3 at 700 W (worst over every stem-2
# shape and both pad modes):
# fp32 1.7e-5 (one block) and 9.2e-6 (full depth); bf16 5.8e-3 and 3.1e-2.
K3_BWD_TOL = {
    ("float32", "one"): 1e-4,
    ("float32", "full"): 1e-4,
    ("bfloat16", "one"): 2**-6,
    ("bfloat16", "full"): 2**-4,
}
K7_TOL = 1e-5  # fp32 sums in another order; bf16 products are exact in fp32
# the fp32 train step, kernel path vs plain path (see phase_train_step)
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_EMA_TOL = 1e-4, 1e-2, 1e-4
# the published top prior and grid (bench_sample.py:82-100,
# slurm-jobs/sample_embeddings_top.job): PixelCNN 50 blocks x 16 channels over
# 128 codes, conditioned on the 32x32x8 mid grid of 256 codes, tau 0.1
TOP_PRIOR = dict(input_dim=128, condition_dim=256, model_dim=16, num_resblocks=50,
                 dropout_prob=0.0)
TOP_GRID, TOP_COND, TOP_TAU = (128, 128, 32), (32, 32, 8), 0.1
# K6 vs row_decode_plain, teacher-forced: logits and caches within
# tol x max|ref|. Both compute in fp32; the kernel's ELU is exp(x) - 1 (as
# the TPU kernel's) where the plain one is expm1, and its sums run in another
# order; over 51 layers that moves the last bits (3.3e-7 measured on an NVIDIA
# H100 80GB HBM3 at 700 W).
K6_TOL = 1e-5
# the cached sampler teacher-forced over the whole grid vs the one-shot
# forward (cuDNN convs, true fp32): a different decomposition of the same sums
FORWARD_TOL = 1e-4
# K4 vs the plain segment, per output or gradient tensor: max|d| <= tol x
# max|ref|, as K3's (both round at the same points; the fp32 sums run in
# another order, which in bf16 can flip a rounding that then carries through
# the blocks; in the backward the plain reference also rounds its weight and
# scalar gradients to bf16 where the kernel sums them in fp32)
K4_TOL = {
    ("float32", "one"): 1e-4,
    ("float32", "full"): 1e-4,
    ("bfloat16", "one"): 2**-6,
    ("bfloat16", "full"): 2**-4,
}
# the top prior's training (reference slurm-jobs/train_pixelcnn_top.job:76-90,
# jobs/train_pixelcnn_top.sh): lr 5e-5 per 4-GPU node, so 1.25e-5 at batch 1
TOP_LR = 1.25e-5
# published peaks of one H100 SXM (NVIDIA data sheet): the bounds' rates
HBM_BPS, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12
# the two published PixelSNAIL jobs (jobs/train_pixelsnail_bottom.sh,
# jobs/train_pixelsnail_mid_downscaled.sh) on one card: batch 6 and 1 per
# device, lr scaled as the jobs scale it, unconditioned, attention dropout 0
SNAIL = {
    "bottom": dict(fields=dict(input_dim=512, model_dim=512, num_blocks=3, num_layers_per_block=5,
                               causal_dropout_prob=0.5, attention_dropout_prob=0.0,
                               mixup_alpha=0.4),
                   level=1, grid=(8, 8, 2), batch=6, lr=1e-4 * 6 / 24),
    "mid": dict(fields=dict(input_dim=256, model_dim=256, num_blocks=8, num_layers_per_block=5,
                            causal_dropout_prob=0.2, attention_dropout_prob=0.0, mixup_alpha=0.2),
                level=0, grid=(32, 32, 8), batch=1, lr=5e-5 / 4),
}
# K8's calls on those paths, (N = 3 streams x batch x 8 heads, S, dh)
K8_SHAPES = {"bottom": (3 * 6 * 8, 128, 16), "mid": (3 * 1 * 8, 8192, 8)}
# K8 vs its plain version, per output and gradient: max|d| <= tol x max|ref|.
# fp32: the same fp32 math summed in another order (online softmax, tiles).
# bf16: both widen the inputs, compute in fp32, round P to bf16 for P.V (the
# kernel at each key tile's running max, the plain version at the row's max),
# in the backward P for dv and ds for dk and dq, and round o and each
# gradient to bf16 once; a flip of a rounding is 2^-8 of the value.
K8_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the conditioned mid PixelSNAIL of bench_prior.py:150-166 ("mid_pixelsnail",
# jobs/train_pixelsnail_mid): 8x5x256d over 256 codes, conditioned on the
# 8x8x2 grid of 512 codes, causal and attention dropout 0.5 (the config's
# defaults), no mixup, batch 1; its attention dropout at S = 8192 runs K5
SNAIL_DROPOUT = dict(fields=dict(input_dim=256, condition_dim=512, model_dim=256, num_blocks=8,
                                 num_layers_per_block=5, causal_dropout_prob=0.5,
                                 attention_dropout_prob=0.5, mixup_alpha=0.0),
                     grid=(32, 32, 8), cond=(8, 8, 2), batch=1, lr=1e-5)
# K5's calls: the mid PixelSNAIL's (N = 3 streams x batch 1 x 8 heads, S, dh)
# and a ragged small S
K5_SHAPES = {"mid": (3 * 1 * 8, 8192, 8), "ragged": (6, 333, 16)}
K5_P = 0.5
# K5 vs its plain version, (output, gradients): max|d| <= tol x max|ref|.
# fp32: the same fp32 math (and the same mask bits) summed in another order.
# bf16: both widen the inputs and round o and each gradient to bf16 once, but
# the kernel's delta = rowsum(do o) reads the rounded o where the plain
# autograd differentiates the fp32 softmax, and each ds = P (dP - delta) is a
# difference of two nearly equal sums (this phase measured up to 6.8e-3 of
# max|ref| on an NVIDIA H100 80GB HBM3 at 700 W).
K5_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 2e-2)}
# its fp32 train step, kernel path vs plain path, (loss, gradients) relative:
# the same masks, fp32 sums in another order (the PixelSNAIL steps of phase 13
# measured losses equal to 7 digits and gradients within 2.9e-5 on an NVIDIA
# H100 80GB HBM3 at 700 W)
DROPOUT_STEP_TOL = (1e-5, 1e-4)
# the int32 operations an H100 SXM can retire: per SM and clock, 64 INT32
# lanes plus the 64 FMA lanes that also take IMAD, at 1.98 GHz (the clock of
# the fp32 peak; Hopper architecture white paper)
INT32_OPS = 132 * 128 * 1.98e9
# the exps an H100 SXM can retire: per SM and clock, 16 results of its
# special-function units (MUFU.EX2), at the same 1.98 GHz (Hopper
# architecture white paper)
SFU_OPS = 132 * 16 * 1.98e9
# the published wide PixelCNNs and their sampling jobs (jobs/train_pixelcnn_mid.sh,
# jobs/train_pixelcnn_bottom.sh, jobs/sample_mid.sh, jobs/sample_bottom.sh):
# mid 45 x 256 over 256 codes conditioned on the bottom's 512, 32x32x8 at
# batch 10; bottom 50 x 512 over 512 codes, 8x8x2 at batch 20; tau 0.1
WIDE = {
    "mid": dict(fields=dict(input_dim=256, condition_dim=512, model_dim=256, num_resblocks=45,
                            dropout_prob=0.0), level=1, grid=(32, 32, 8), cond=(8, 8, 2),
                batch=10),
    "bottom": dict(fields=dict(input_dim=512, condition_dim=0, model_dim=512, num_resblocks=50,
                               dropout_prob=0.0), level=2, grid=(8, 8, 2), cond=None, batch=20),
}


# phase 22: the options beside the default at the full config (the flags of
# jobs/train_vqvae_full.sh with --block-type, --encoder-variant or --metric)
VARIANTS = {"regular": dict(block_type="regular"), "evonorm": dict(block_type="evonorm"),
            "legacy encoder": dict(encoder_variant="encoder"),
            "mixture-nll": dict(metric="mixture-nll")}
# the downscaled published config (jobs/train_vqvae_downscaled.sh,
# slurm-jobs/train_vqvae_3d_downscaled.job:74-88): 2 levels, codebooks 128/256,
# 150 + 150 'same' blocks a level, 5 + 5 post-resize blocks, the literal stem
# (base 4), volumes rescaled to 256x256x128; lr 1e-4 per 4 cards
DOWNSCALED = dict(n_bottleneck_blocks=2, num_embeddings=(128, 256), n_pre_quantization_blocks=150,
                  n_post_quantization_blocks=150, n_post_downscale_blocks=5,
                  n_post_upscale_blocks=5, pad_mode="wrap")
DOWNSCALED_VOLUME = (256, 256, 128)
STAGE1_LR = 1e-4 / 4  # both published jobs: 1e-4 per 4 cards, batch 1 a card
# K3 over a 150-block stack: fp32 as K3_TOL; bf16 about twice the worst
# reading on an H100 (5.07e-2 of max|ref|, dx; the 50-block check reads
# 2.68e-2 against its 2^-4)
K3_DEEP_TOL = {"float32": 1e-4, "bfloat16": 0.1}


# phase 15's wide rows: the published batches (one call a row, their own
# instantiations), batches that the wrapper splits into sub-batches, and a
# width that it pads to multiples of 4 (model_dim 40, br 10; depth cut to 10)
WIDE_ROWS = [("mid", WIDE["mid"]["fields"], 10, 8), ("bottom", WIDE["bottom"]["fields"], 20, 2),
             ("mid B=32", WIDE["mid"]["fields"], 32, 8),
             ("bottom B=24", WIDE["bottom"]["fields"], 24, 2),
             ("C=40 br=10", dict(input_dim=256, condition_dim=512, model_dim=40,
                                 num_resblocks=10, dropout_prob=0.0), 10, 8)]
# phase 16's sampling runs: the published jobs, and the bottom grid at a
# batch that the wide kernel runs as two sub-batches a row
WIDE_SAMPLING = [("mid", WIDE["mid"], 10), ("bottom", WIDE["bottom"], 20),
                 ("bottom --batch-size 24", WIDE["bottom"], 24)]


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type, in ms;
    and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k3_block_cost(c: int, spatial, itemsize: int):
    """(bytes, flops) of one K3 forward block: x read and y written once,
    the weights read once; 2 (C Cb + 27 Cb² + Cb C) flops per voxel."""
    cb = max(c // 2, 1)
    nvox = int(np.prod(spatial))
    weights = (2 * c * cb + 27 * cb * cb) * itemsize + 8 * 4
    return 2 * nvox * c * itemsize + weights, 2 * nvox * (2 * c * cb + 27 * cb * cb)


def write_scan(path: Path, vol: np.ndarray) -> None:
    """A synthetic CT scan as raw NRRD with the loader's spacing (0.976, 0.976, 3)."""
    from vqvae3d_tpu_torch.data import nrrd_io

    nrrd_io.write(path, vol, header={"spacings": (0.976, 0.976, 3.0)}, encoding="raw")


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_events(fn, calls: int):
    """torch.profiler's rows of CUDA kernels over ``calls`` calls of fn,
    after one call outside the profile."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_events(prof) -> list:
    """(name, ms) of every CUDA activity of a finished torch.profiler run,
    from its raw events: ``key_averages`` would first build an event object
    for each of the ~16k rows of a sampled grid and the kernels around them
    (tens of seconds)."""
    import torch

    return [(e.name(), e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def device_ms_by_name(fn, calls: int = 1) -> dict:
    """Device milliseconds per call of fn by CUDA kernel name, from
    torch.profiler (rows whose device type is CUDA)."""
    return {e.key: e.self_device_time_total / 1e3 / calls for e in cuda_events(fn, calls)}


def kernel_name(key: str) -> str:
    """The bare name of a profiler row's CUDA kernel (``ns::name<...>(...)`` ->
    ``name``)."""
    m = re.search(r"(\w+)(<|\()", key)
    return m.group(1) if m else key


K1_CALLS = 20  # back-to-back lookups a K1 timing


def k1_lookups(stem: int):
    """The (N, K, D) of the three codebook lookups of one 512x512x128 volume
    (the same at both stems)."""
    from vqvae3d_tpu_torch.models.vqvae import VQVAEConfig

    cfg = VQVAEConfig(**FULL, base_network_channels=4 * stem, stem_space_to_depth=stem)
    return [(int(np.prod(g)), k, d) for g, k, d in
            zip(cfg.code_grid_shapes(VOLUME), cfg.num_embeddings, cfg.embedding_dims)]


def k1_cost(n: int, k: int, d: int, stats: bool):
    """(bytes, flops) of one lookup: x and the codebook read once, the indices
    (and the counts and sums) written once; 2 N K D flops of FMAs plus one
    compare a distance (and N D adds of the sums), at the fp32 rate."""
    nbytes = 4 * (n * d + k * d) + 8 * n + (4 * k * (d + 1) if stats else 0)
    return nbytes, 2 * n * k * d + n * k + (n * d if stats else 0)


def kernels_of(fn, calls: int = K1_CALLS) -> dict:
    """fn's CUDA kernels by bare name: (device µs a launch, launches a call),
    from torch.profiler over ``calls`` calls (a launch whose record the
    profiler drops, as it sometimes does, lowers the second number only)."""
    total = {}
    for e in cuda_events(fn, calls):
        us, n = total.get(kernel_name(e.key), (0.0, 0))
        total[kernel_name(e.key)] = (us + e.self_device_time_total, n + e.count)
    return {name: (us / n, n / calls) for name, (us, n) in total.items()}


def kernels_text(by: dict) -> str:
    """Each kernel's µs a launch and launches a call, and their sum at one
    launch each."""
    return ", ".join(f"{name} {us:.2f} us x{n:g}" for name, (us, n) in by.items()) + (
        f"; device {sum(us for us, _ in by.values()):.2f} us a call")


def k1_planted(n: int, k: int, d: int, gen, device):
    """Random rows and codes with exact ties planted across the split: codes
    0 and 2 set to +6 and -6 in every column and copied to k - 1 and 3, and
    every third of the first 64 rows next to one of them: (flat, embed, tie
    rows, the lowest code of each)."""
    import torch

    flat = torch.randn(n, d, generator=gen)
    embed = torch.randn(k, d, generator=gen)
    pairs = [(a, b) for a, b in ((0, k - 1), (2, 3)) if a < b < k]
    for (a, b), v in zip(pairs, (6.0, -6.0)):
        embed[a] = v
        embed[b] = v
    rows = torch.arange(0, min(n, 64), 3)
    codes = torch.tensor([pairs[i % len(pairs)][0] for i in range(len(rows))], dtype=torch.long)
    flat[rows] = embed[codes] + 1e-3 * torch.randn(len(rows), d, generator=gen)
    return flat.to(device), embed.to(device), rows.to(device), codes.to(device)


def quantizer_layer(seed: int, device, first_pass: bool):
    """A stem-2 step's quantizer layer alone, as a callable: the three
    levels' train forward (the first-pass init, K1b, the EMA update, the
    gathers) and the backward of their losses and outputs, on seeded bf16
    inputs at the step's code-grid shapes, ``first_pass`` set before each."""
    import torch
    from vqvae3d_tpu_torch.models.quantizer import Quantizer
    from vqvae3d_tpu_torch.models.vqvae import VQVAEConfig

    cfg = VQVAEConfig(**FULL, **STEM2)
    gen = torch.Generator().manual_seed(seed)
    levels = []
    for grid, k, d in zip(cfg.code_grid_shapes(VOLUME), cfg.num_embeddings, cfg.embedding_dims):
        q = Quantizer(k, d)
        q.reset_parameters(gen)
        x = torch.randn(1, d, *grid, generator=gen).to(device, torch.bfloat16)
        levels.append((q.to(device), x.requires_grad_()))

    def run():
        total = 0.0
        for q, x in levels:
            q.first_pass.fill_(first_pass)
            loss, quantized, _ = q(x, train=True)
            total = total + loss + 1e-6 * quantized.float().sum()
        total.backward()
    return run


# K3 backward's elementwise kernels: the five of the CUDA-core design and the
# two brick kernels of the bf16 tensor-core route (brick names first: "bwd_mid"
# is in "brick_bwd_mid")
K3_BWD_ELEMENTWISE = ("brick_bwd_mid", "brick_bwd_dgrad", "bwd_pre", "bwd_mid", "bwd_post",
                      "bwd_dgrad", "bwd_dx")


def k3_bwd_split(by_name: dict) -> dict:
    """K3 backward's device time by part: the dW2 contraction (its first
    pass: the 27-tap contract_tc or contract_partial), the other
    contractions (dW1, dW3, the scalar sums), their second pass
    (contract_reduce) and the brick route's scalar reduce (brick_scalars),
    the elementwise kernels (``K3_BWD_ELEMENTWISE``, in total and each by
    name), and the rest."""
    split = dict.fromkeys(("dW2", "other contractions", "reduce", "elementwise", "rest"), 0.0)
    for name, ms in by_name.items():
        kernel = next((k for k in K3_BWD_ELEMENTWISE if k in name), None)
        if "contract_reduce" in name or "brick_scalars" in name:
            split["reduce"] += ms
        elif "contract_" in name and ", 27>" in name:
            split["dW2"] += ms
        elif "contract_" in name or "scalars_kernel" in name:
            split["other contractions"] += ms
        elif kernel is not None:
            split["elementwise"] += ms
            split[kernel] = split.get(kernel, 0.0) + ms
        else:
            split["rest"] += ms
    return split


K3_FWD_KERNELS = ("fused_tc", "fused_cc", "pre_kernel", "conv_kernel", "post_kernel")
K4_BWD_KERNELS = ("bwd_", "dwu_partial", "contract_", "scalars_kernel", "tc_pre", "tc_mid",
                  "tc_dgrad", "reduce_segs")


@contextlib.contextmanager
def parent_routes(k3_fwd: bool = False, k4_bwd: bool = False, k3_bwd: bool = False,
                  k4_fwd: bool = False, k5: bool = False):
    """Run the parent's bf16 routes to time them beside the redesigned ones in
    one run (each is a kernel of the port; the route functions choose the
    redesigned ones): K3's forward on its three kernels, K4's backward on its
    CUDA-core kernels, K3's backward on its five elementwise kernels (the
    contractions still on the tensor cores), K4's forward on its three
    CUDA-core kernels, K5's forward and backward on their CUDA-core kernels."""
    from vqvae3d_tpu_torch.ops import causal_kernel, stack_kernel
    from vqvae3d_tpu_torch.ops import flash_dropout_attention as fd

    saved = (stack_kernel.stack_fwd_route, causal_kernel.causal_bwd_tensor_core_route,
             stack_kernel.stack_bwd_brick_route, causal_kernel.causal_fwd_tensor_core_route,
             fd.dropout_tensor_core_route)
    if k3_fwd:
        stack_kernel.stack_fwd_route = lambda dtype, cb: "three_kernels"
    if k4_bwd:
        causal_kernel.causal_bwd_tensor_core_route = lambda dtype, cu, cb, cc: False
    if k3_bwd:
        stack_kernel.stack_bwd_brick_route = lambda dtype, cb: False
    if k4_fwd:
        causal_kernel.causal_fwd_tensor_core_route = lambda dtype, cu, cb, cc: False
    if k5:
        fd.dropout_tensor_core_route = lambda dtype, d: False
    try:
        yield
    finally:
        (stack_kernel.stack_fwd_route, causal_kernel.causal_bwd_tensor_core_route,
         stack_kernel.stack_bwd_brick_route, causal_kernel.causal_fwd_tensor_core_route,
         fd.dropout_tensor_core_route) = saved


K4_FWD_KERNELS = ("fwd_pre", "fwd_conv", "fwd_post", "tc_fwd_pre", "tc_fwd_brick")


def k4_fwd_split(by_name: dict) -> dict:
    """K4 forward's device time by kernel: the three CUDA-core kernels
    (fwd_pre, fwd_conv, fwd_post) or the tensor-core route's tc_fwd_pre and
    tc_fwd_brick."""
    split = {}
    for name, ms in by_name.items():
        key = next((k for k in reversed(K4_FWD_KERNELS) if k in name), "rest")
        split[key] = split.get(key, 0.0) + ms
    return split


def k4_bwd_split(by_name: dict) -> dict:
    """K4 backward's device time by kernel: the parent's six elementwise
    kernels, its contractions (contract_partial, dwu_partial), their reduce
    and the scalar kernel; the tensor-core route's tc_pre, tc_mid, tc_dgrad
    and reduce_segs."""
    split = {}
    for name, ms in by_name.items():
        for key in ("bwd_pre", "bwd_mid", "bwd_post", "bwd_gcond", "bwd_dgrad", "bwd_dx",
                    "contract_partial", "dwu_partial", "contract_reduce", "scalars_kernel",
                    "tc_pre", "tc_mid", "tc_dgrad", "reduce_segs"):
            if key in name:
                split[key] = split.get(key, 0.0) + ms
                break
        else:
            split["rest"] = split.get("rest", 0.0) + ms
    return split


@contextlib.contextmanager
def plain_path():
    """Route the model's kernel call sites to the plain versions (the
    reference on the card): the stacks to the plain block loop (autograd
    through it in training), the lookups to the plain argmin and statistics,
    the small-channel conv dW to the plain contraction, PixelSNAIL's
    attention to the dense plain attention and its dropout attention to K5's
    plain version. The wrappers themselves never fall back."""
    from torch.utils.checkpoint import checkpoint
    from vqvae3d_tpu_torch.models import blocks, causal_blocks, pixelcnn, quantizer
    from vqvae3d_tpu_torch.ops import (causal_kernel, conv3d, flash_attention,
                                       flash_dropout_attention, quantizer_ops, stack_kernel)

    saved = (blocks.preact_stack_fused, quantizer.l2_argmin, quantizer.l2_argmin_stats,
             conv3d.dw_conv3d, pixelcnn.causal_stack_fused, causal_blocks.flash_causal_attention,
             causal_blocks.flash_causal_dropout_attention)
    blocks.preact_stack_fused = lambda x, w1s, w2s, w3s, sc8, pad_mode: (
        stack_kernel.preact_stack_plain(x, w1s, w2s, w3s, sc8, pad_mode=pad_mode))
    quantizer.l2_argmin = quantizer_ops.l2_argmin_plain
    quantizer.l2_argmin_stats = quantizer_ops.l2_argmin_stats_plain
    conv3d.dw_conv3d = conv3d.dw_conv3d_plain
    # the causal segment: the plain block loop, each block checkpointed (the
    # JAX remat_scan), else its autograd keeps every intermediate of 50 blocks
    pixelcnn.causal_stack_fused = lambda x, cond, keep, p, w: (
        causal_kernel.causal_stack_plain(x, cond, keep, p, w, remat=True))
    # the attention: the dense plain version, checkpointed (recomputed in the
    # backward), else 8 blocks keep their (S, S) logits at S = 8192
    causal_blocks.flash_causal_attention = lambda q, k, v, sm_scale: checkpoint(
        flash_attention.flash_causal_attention_plain, q, k, v, sm_scale, use_reentrant=False)
    # the dropout attention: K5's plain version, which checkpoints its own
    # chunks of query rows; the same seed, so the same mask
    causal_blocks.flash_causal_dropout_attention = (
        flash_dropout_attention.flash_causal_dropout_attention_plain)
    try:
        yield
    finally:
        (blocks.preact_stack_fused, quantizer.l2_argmin, quantizer.l2_argmin_stats,
         conv3d.dw_conv3d, pixelcnn.causal_stack_fused, causal_blocks.flash_causal_attention,
         causal_blocks.flash_causal_dropout_attention) = saved


def launch_counts():
    from vqvae3d_tpu_torch.ops import (causal_kernel, conv3d, decode_row, flash_attention,
                                       flash_dropout_attention, quantizer_ops, stack_kernel)

    return dict(l2_argmin=quantizer_ops.l2_argmin.launches,
                l2_argmin_stats=quantizer_ops.l2_argmin_stats.launches,
                preact_stack_fwd=stack_kernel.preact_stack_fused.launches,
                preact_stack_bwd=stack_kernel.preact_stack_bwd.launches,
                dw_conv3d=conv3d.dw_conv3d.launches,
                row_decode=decode_row.row_decode.launches,
                causal_stack_fwd=causal_kernel.causal_stack_fused.launches,
                causal_stack_bwd=causal_kernel.causal_stack_bwd.launches,
                flash_attention_fwd=flash_attention.flash_causal_attention.launches,
                flash_attention_bwd=flash_attention.flash_attention_bwd.launches,
                row_decode_wide=decode_row.row_decode.wide_launches,
                flash_dropout_attention_fwd=(
                    flash_dropout_attention.flash_causal_dropout_attention.launches),
                flash_dropout_attention_bwd=(
                    flash_dropout_attention.flash_dropout_attention_bwd.launches))


def reset_counts():
    from vqvae3d_tpu_torch.ops import (causal_kernel, conv3d, decode_row, flash_attention,
                                       flash_dropout_attention, quantizer_ops, stack_kernel)

    for fn in (quantizer_ops.l2_argmin, quantizer_ops.l2_argmin_stats,
               stack_kernel.preact_stack_fused, stack_kernel.preact_stack_bwd, conv3d.dw_conv3d,
               decode_row.row_decode, causal_kernel.causal_stack_fused,
               causal_kernel.causal_stack_bwd, flash_attention.flash_causal_attention,
               flash_attention.flash_attention_bwd,
               flash_dropout_attention.flash_causal_dropout_attention,
               flash_dropout_attention.flash_dropout_attention_bwd):
        fn.launches = 0
    decode_row.row_decode.wide_launches = 0


def make_model(stem: int, seed: int, dtype, device, **fields):
    """A model of the full config (``fields`` override it) with seeded
    weights; every zero init perturbed so that each branch counts: the Fixup
    branch's last conv, scalar biases and scale, and EvoNorm's v, gamma and
    beta."""
    import torch
    from vqvae3d_tpu_torch.models.blocks import (FIXUP_SCALARS, SCALARS, EvoNorm3DS0,
                                                 FixupResBlock, PreActFixupResBlock)
    from vqvae3d_tpu_torch.models.vqvae import VQVAE, VQVAEConfig

    cfg = VQVAEConfig(**{**FULL, **fields}, base_network_channels=4 * stem,
                      stem_space_to_depth=stem, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    model = VQVAE(cfg, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, PreActFixupResBlock):
                w3 = m.branch_conv3.weight
                w3.copy_(torch.randn(w3.shape, generator=gen) * w3.shape[1] ** -0.5)
                for n in SCALARS:
                    getattr(m, f"bias{n}").copy_(torch.randn(1, generator=gen) * 0.05)
                m.scale.copy_(1.0 + torch.randn(1, generator=gen) * 0.05)
            elif isinstance(m, FixupResBlock):
                w2 = m.branch_conv2.weight
                w2.copy_(torch.randn(w2.shape, generator=gen) * (27 * w2.shape[1]) ** -0.5)
                for n in FIXUP_SCALARS:
                    getattr(m, f"bias{n}").copy_(torch.randn(1, generator=gen) * 0.05)
                m.scale.copy_(1.0 + torch.randn(1, generator=gen) * 0.05)
            elif isinstance(m, EvoNorm3DS0):
                for p, mean, std in ((m.v, 1.0, 0.1), (m.gamma, 1.0, 0.1), (m.beta, 0.0, 0.05)):
                    p.copy_(mean + torch.randn(p.shape, generator=gen) * std)
    return model.to(device).eval(), cfg


def k3_weights(c: int, nb: int, gen, device):
    """Random stack weights at a Fixup-like scale (stable over 50 blocks)."""
    import torch

    cb = max(c // 2, 1)
    sc8 = torch.randn(nb, 8, generator=gen) * 0.1
    sc8[:, 7] = 0.3 + 0.05 * torch.randn(nb, generator=gen)
    return tuple(t.to(device) for t in (
        torch.randn(nb, cb, c, 1, 1, 1, generator=gen) * c ** -0.5,
        torch.randn(nb, cb, cb, 3, 3, 3, generator=gen) * (27 * cb) ** -0.5,
        torch.randn(nb, c, cb, 1, 1, 1, generator=gen) * cb ** -0.5,
        sc8,
    ))


def phase_kernels(ident, results, seed):
    import torch
    import torch.nn.functional as F
    from vqvae3d_tpu_torch.models.vqvae import VQVAEConfig
    from vqvae3d_tpu_torch.ops import conv3d, quantizer_ops, stack_kernel

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    # --- K1a at the three lookups of one volume
    k1 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None)
    device_us = 0.0
    for n, k, d in k1_lookups(1):
        flat = torch.randn(n, d, generator=gen).to(dev)
        embed = torch.randn(k, d, generator=gen).to(dev)
        got = quantizer_ops.l2_argmin(flat, embed)
        want = quantizer_ops.l2_argmin_plain(flat, embed)
        ties, real = quantizer_ops.genuine_ties(flat, embed, got, want)
        dist = lambda idx: ((flat.double() - embed.double()[idx]) ** 2).sum(-1)  # noqa: E731
        err = float((dist(got) - dist(want)).abs().max())
        tflat, tembed, rows, codes = k1_planted(n, k, d, gen, dev)
        t_got = quantizer_ops.l2_argmin(tflat, tembed)
        t_want = quantizer_ops.l2_argmin_plain(tflat, tembed)
        planted_ok = torch.equal(t_got[rows], codes) and torch.equal(t_want[rows], codes)
        _, t_real = quantizer_ops.genuine_ties(tflat, tembed, t_got, t_want)
        plan = quantizer_ops.lookup_plan(n, k, d)
        by = kernels_of(lambda: quantizer_ops.l2_argmin(flat, embed))
        ms = [cuda_ms(lambda: quantizer_ops.l2_argmin(flat, embed), K1_CALLS) for _ in range(2)]
        pms = cuda_ms(lambda: quantizer_ops.l2_argmin_plain(flat, embed), 5)
        print(f"K1 l2_argmin N={n} K={k} D={d} ({plan.tiles} CTAs, {plan.rows} rows a thread, "
              f"{plan.lanes} lanes a row group): mismatches={int((got != want).sum())} "
              f"genuine_ties={ties.numel()} beyond_tie={real.numel()} "
              f"max|d_kernel-d_plain|={err:.3g}; planted ties to the lowest code: {planted_ok} "
              f"(beyond tie {t_real.numel()}); device {kernels_text(by)}; event "
              f"{ms[0]:.4f}, {ms[1]:.4f} ms a call ({K1_CALLS} back to back) plain {pms:.4f} ms "
              f"[{ident}]")
        if real.numel() or t_real.numel() or not planted_ok:
            raise AssertionError("K1 disagrees beyond ties or on the planted ties")
        # one launch a lookup, its norms computed inside; no 512-code lookup on one CTA
        if set(by) != {"argmin_kernel"} or by["argmin_kernel"][1] > 1:
            raise AssertionError(f"K1a launches {by}, not one argmin_kernel a lookup")
        if k >= 512 and plan.tiles < 2:
            raise AssertionError(f"K1a runs the K={k} lookup on one CTA")
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        k1["ms"] += min(ms)
        bms, k1["bound_by"] = bound_ms(*k1_cost(n, k, d, False), FP32_FLOPS)
        k1["bound_ms"] += bms
        k1["plain_ms"] += pms
        device_us += by["argmin_kernel"][0]
    print(f"K1a a volume: device {device_us:.2f} us, event {k1['ms']:.4f} ms, bound "
          f"{k1['bound_ms'] * 1e3:.2f} us ({k1['bound_by']}) [{ident}]")
    results["l2_argmin"] = k1

    # --- K3 at every distinct (C, spatial) of the full config, both stems
    shapes, stem2 = {}, {}
    for stem in (1, 2):
        c2 = VQVAEConfig(**FULL, base_network_channels=4 * stem, stem_space_to_depth=stem)
        for _, c, spatial, n in c2.same_stacks(VOLUME):
            shapes.setdefault((c, spatial), 0)
            if stem == 1:
                shapes[(c, spatial)] += n  # blocks per literal-stem volume
            else:
                stem2[(c, spatial)] = stem2.get((c, spatial), 0) + n
    k3 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None)
    per_volume_ms = {"stem 1": [0.0, 0.0], "stem 2": [0.0, 0.0]}  # [redesign, parent]
    worst = {}
    for (c, spatial), per_volume in sorted(shapes.items(), key=lambda kv: -np.prod(kv[0][1])):
        x32 = torch.randn(1, c, *spatial, generator=gen).to(dev)
        for pad_mode in ("wrap", "zeros"):
            w = k3_weights(c, 50, gen, dev)
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                for nb in (1, 50):
                    ws = tuple(t[:nb] for t in w)
                    with torch.inference_mode():
                        got = stack_kernel.preact_stack_fused(x, *ws, pad_mode)
                        want = stack_kernel.preact_stack_plain(x, *ws, pad_mode=pad_mode)
                    err = float((got.float() - want.float()).abs().max())
                    scale = float(want.float().abs().max())
                    key = (str(dtype).removeprefix("torch."), nb)
                    worst[key] = max(worst.get(key, 0.0), err / scale)
                    if not err <= K3_TOL[key] * scale or not torch.isfinite(got).all():
                        raise AssertionError(
                            f"K3 C={c} {spatial} {pad_mode} {key}: max|d|={err:.3g} "
                            f"> {K3_TOL[key]} x {scale:.3g}")
                    if dtype == torch.float32 and nb == 50:
                        k3["max_abs_err"] = max(k3["max_abs_err"], err)
                    print(f"K3 C={c} {spatial} {pad_mode} {key[0]} blocks={nb}: "
                          f"max|d|={err:.3g} max|ref|={scale:.3g}")
            if pad_mode == "wrap":  # the config's pad mode, serving dtype bf16
                xb, ws = x32.to(torch.bfloat16), tuple(t[:10] for t in w)
                cb = max(c // 2, 1)
                route = conv3d.stack_fwd_route(torch.bfloat16, cb)
                # in turns: the route's kernel, the parent's three kernels, cuDNN's
                # 3x3x3 Cb -> Cb conv of the block (zeros padding; a yardstick of
                # the conv part at the stem-2 shapes, not a port of it)
                a2 = torch.randn(1, cb, *spatial, generator=gen).to(dev, torch.bfloat16)
                w2 = w[1][0].to(torch.bfloat16)
                turns = {"kernel": [], "parent": [], "cudnn": []}
                with torch.inference_mode():
                    for _ in range(2):
                        turns["kernel"].append(cuda_ms(
                            lambda: stack_kernel.preact_stack_fused(xb, *ws, "wrap"), 3) / 10)
                        with parent_routes(k3_fwd=True):
                            turns["parent"].append(cuda_ms(
                                lambda: stack_kernel.preact_stack_fused(xb, *ws, "wrap"), 3) / 10)
                        if (c, spatial) in stem2:
                            turns["cudnn"].append(cuda_ms(
                                lambda: F.conv3d(a2, w2, padding=1), 10, warmup=2))
                    pms = cuda_ms(lambda: stack_kernel.preact_stack_plain(
                        xb, *ws, pad_mode="wrap"), 1) / 10
                ms, parent = min(turns["kernel"]), min(turns["parent"])
                cudnn = (" cuDNN conv " + ", ".join(f"{v:.4f}" for v in turns["cudnn"])
                         if turns["cudnn"] else "")
                print(f"K3 C={c} {spatial} bf16 per block, route {route}: kernel "
                      + ", ".join(f"{v:.4f}" for v in turns["kernel"]) + " ms, parent's three "
                      f"kernels " + ", ".join(f"{v:.4f}" for v in turns["parent"])
                      + f" ms ({ms / parent:.2f}x),{cudnn} plain {pms:.4f} ms; blocks a volume: "
                      f"stem 1 {per_volume}, stem 2 {stem2.get((c, spatial), 0)} [{ident}]")
                per_volume_ms["stem 1"][0] += ms * per_volume
                per_volume_ms["stem 1"][1] += parent * per_volume
                per_volume_ms["stem 2"][0] += ms * stem2.get((c, spatial), 0)
                per_volume_ms["stem 2"][1] += parent * stem2.get((c, spatial), 0)
                k3["ms"] += ms * per_volume
                bms, k3["bound_by"] = bound_ms(*k3_block_cost(c, spatial, 2), BF16_FLOPS)
                k3["bound_ms"] += bms * per_volume
                k3["plain_ms"] += pms * per_volume
    print(f"K3 worst max|d|/max|ref| by (dtype, blocks): "
          + ", ".join(f"{k[0]} {k[1]}: {v:.3g}" for k, v in sorted(worst.items())))
    print("K3 bf16 forward a volume (sum over its shapes of blocks x the best turn): "
          + ", ".join(f"{k} {v[0]:.2f} ms (the parent's three kernels {v[1]:.2f})"
                      for k, v in per_volume_ms.items()) + f" [{ident}]")
    results["preact_stack_fwd"] = k3


def phase_main_path(ident, counts, seed, n_volumes, work: Path):
    import torch
    from vqvae3d_tpu_torch.checkpoint import save_checkpoint
    from vqvae3d_tpu_torch.cli import decode_embeddings, extract_embeddings
    from vqvae3d_tpu_torch.data import nrrd_io

    rng = np.random.default_rng(seed)
    ct = work / "ct"
    ct.mkdir()
    t0 = time.perf_counter()
    for i in range(n_volumes):
        write_scan(ct / f"scan{i}.nrrd", rng.integers(-1000, 1500, size=VOLUME, dtype=np.int16))
    model, cfg = make_model(1, seed, torch.bfloat16, "cpu")
    save_checkpoint(work / "ckpt", model.state_dict(), cfg)
    del model
    print(f"main path set-up: {n_volumes} volumes {VOLUME} + full-config checkpoint "
          f"in {time.perf_counter() - t0:.1f} s")
    stacks = cfg.same_stacks(VOLUME)
    want_k3 = {p: sum(n for q, _, _, n in stacks if q == p) for p in ("encode", "decode")}

    reset_counts()
    t0 = time.perf_counter()
    extract_embeddings.main(extract_embeddings.parse_arguments([
        "--checkpoint-path", str(work / "ckpt"), "--dataset-path", str(ct),
        "--output-path", str(work), "--output-name", "codes", "--rescale-input", "0",
        "--scan-size", *map(str, VOLUME[:2]), "--output-depth", str(VOLUME[2]), "--backend", "file",
        "--device", "cuda",
    ]))
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    got = launch_counts()
    want = dict(dict.fromkeys(got, 0), l2_argmin=cfg.n_enc * n_volumes,
                preact_stack_fwd=want_k3["encode"] * n_volumes)
    print(f"extract_embeddings: {n_volumes} volumes in {t_extract:.2f} s (host clock, "
          f"first call included); launches {got}, config implies {want} [{ident}]")
    if got != want:
        raise AssertionError(f"extract launches {got} != {want}")
    counts.update(got)
    codes = extract_embeddings.read_codes(work / "codes")
    if len(codes) != n_volumes:
        raise AssertionError(f"{len(codes)} code samples, expected {n_volumes}")
    for i, grids in enumerate(codes):
        for lvl, (g, shape) in enumerate(zip(grids, cfg.code_grid_shapes(VOLUME), strict=True)):
            if g.shape != shape or g.min() < 0 or g.max() >= cfg.num_embeddings[lvl]:
                raise AssertionError(f"code grid {i}/{lvl}: {g.shape} range {g.min()}..{g.max()}")
    print(f"code grids: {[g.shape for g in codes[0]]}, "
          f"distinct codes used {[len(np.unique(g)) for g in codes[0]]}")

    decode_embeddings.code_store_to_sample_db(work / "codes", work / "samples.db")
    reset_counts()
    t0 = time.perf_counter()
    n = decode_embeddings.main(decode_embeddings.parse_arguments(
        [str(work / "samples.db"), str(work / "ckpt"), str(work / "decoded" / "synth"),
         "--volume-shape", *map(str, VOLUME), "--device", "cuda"]))
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    got = launch_counts()
    want = dict(dict.fromkeys(got, 0), preact_stack_fwd=want_k3["decode"] * n_volumes)
    print(f"decode_embeddings: {n} volumes in {t_decode:.2f} s (host clock, NRRD writes "
          f"included); launches {got}, config implies {want} [{ident}]")
    if got != want or n != n_volumes:
        raise AssertionError(f"decode launches {got} != {want} or {n} volumes")
    for k in counts:
        counts[k] += got[k]
    for f in sorted((work / "decoded").glob("*.nrrd")):
        vol, _ = nrrd_io.read(f)
        # elu output >= -1 -> HU >= -2000; a NaN would land at INT_MIN
        if vol.shape != VOLUME or vol.min() < -2000:
            raise AssertionError(f"{f.name}: shape {vol.shape} min {vol.min()}")
    print(f"decoded NRRDs: {n} x {VOLUME} int32, HU in range")


def phase_forward(ident, seed):
    import torch
    from vqvae3d_tpu_torch.data.transforms import hu_window_normalize
    from vqvae3d_tpu_torch.ops import quantizer_ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 1)
    vol = hu_window_normalize(rng.integers(-1000, 1500, size=VOLUME, dtype=np.int16))
    x = torch.from_numpy(vol)[None, None].to(dev)

    # --- fp32: kernels vs plain, same weights
    model, cfg = make_model(1, seed, torch.float32, dev)
    inputs = {}
    hooks = [q.register_forward_hook(lambda m, a, o, i=i: inputs.__setitem__(i, a[0].float()))
             for i, q in enumerate(model.encoder.quantize)]
    with torch.inference_mode():
        res_k = model.encode(x)
        quants = [q for _, q, _ in res_k]
        dec_k = model.decode(quants)
        with plain_path():
            res_p = model.encode(x)
            dec_p = model.decode(quants)  # the same codes: a decoder-only comparison
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    tie_above = None
    for lvl in reversed(range(cfg.n_enc)):  # coarse first: a tie there changes finer inputs
        a, b = res_k[lvl][2].flatten(), res_p[lvl][2].flatten()
        embed = model.encoder.quantize[lvl].embed
        flat = inputs[lvl].movedim(1, -1).reshape(-1, embed.shape[1])
        ties, real = quantizer_ops.genuine_ties(flat, embed, a, b)
        frac = float((a != b).float().mean())
        print(f"fp32 level {lvl}: index mismatch fraction {frac:.3g} "
              f"(genuine ties {ties.numel()}, beyond tie {real.numel()})")
        if real.numel() and tie_above is None:
            raise AssertionError(f"level {lvl}: {real.numel()} index mismatches beyond ties")
        if (a != b).any() and tie_above is None:
            tie_above = lvl
    err = float((dec_k - dec_p).abs().max())
    scale = float(dec_p.abs().max())
    finite = bool(torch.isfinite(dec_k).all())
    print(f"fp32 decoded: shape {tuple(dec_k.shape)} finite={finite} max|d|={err:.3g} "
          f"max|ref|={scale:.3g} (tolerance {DECODED_TOL} x max|ref|) [{ident}]")
    if not finite or tuple(dec_k.shape) != (1, 1, *VOLUME) or err > DECODED_TOL * scale:
        raise AssertionError("fp32 decoded volume disagrees with the plain path")
    del model, res_k, res_p, dec_k, dec_p, quants, inputs

    # --- bf16 per-volume latency, kernels vs plain, both stems
    latency = {}
    for stem in (1, 2):
        model, _ = make_model(stem, seed, torch.bfloat16, dev)
        # K3's device time a volume on its routes and on the parent's three kernels
        k3_dev = {}
        for path in ("kernel", "parent K3", "kernel", "parent K3"):
            ctx = parent_routes(k3_fwd=True) if path == "parent K3" else contextlib.nullcontext()
            with ctx, torch.inference_mode():
                by = device_ms_by_name(lambda: model(x))
            k3_dev.setdefault(path, []).append(sum(v for k, v in by.items() if any(
                n in k for n in K3_FWD_KERNELS)))
        print(f"bf16 stem={stem}: K3 forward device time a volume (profiler): "
              + ", ".join(f"{k} " + ", ".join(f"{v:.2f}" for v in vs) + " ms"
                          for k, vs in k3_dev.items()) + f" [{ident}]")
        latency[(stem, "k3_device")] = k3_dev
        for path in ("kernel", "parent K3", "plain", "kernel", "parent K3", "plain"):
            ctx = (plain_path() if path == "plain" else parent_routes(k3_fwd=True)
                   if path == "parent K3" else contextlib.nullcontext())
            with ctx, torch.inference_mode():
                torch.cuda.reset_peak_memory_stats()
                run = lambda: model(x)  # noqa: E731
                ms = cuda_ms(run, iters=2 if path == "plain" else 3)
                peak = torch.cuda.max_memory_allocated() / 2**30
                out, _ = model(x)
                if not torch.isfinite(out).all():
                    raise AssertionError(f"stem {stem} {path}: non-finite output")
            latency.setdefault((stem, path), []).append(ms)
            print(f"bf16 stem={stem} {path} path: {ms:.2f} ms/volume (encode+decode, "
                  f"batch 1, {VOLUME}) peak {peak:.2f} GiB [{ident}]")
        del model
        torch.cuda.empty_cache()
    return latency


def smallc_convs(model, x):
    """The stride-1 k>1 convs of one forward that take the small-channel
    backward (K7): [(channels, output spatial)], from a no-grad forward with
    hooks on the resize/same-with-skip blocks' 3x3x3 convs."""
    import torch
    from vqvae3d_tpu_torch.models.blocks import PreActFixupResBlock
    from vqvae3d_tpu_torch.ops.conv3d import SMALLC_MAX

    seen, hooks = [], []
    for m in model.modules():
        if isinstance(m, PreActFixupResBlock) and m.needs_skip and m.mode != "down":
            conv = m.branch_conv2
            if max(conv.weight.shape[:2]) <= SMALLC_MAX:
                f = 2 if m.mode == "up" else 1
                hooks.append(conv.register_forward_pre_hook(
                    lambda mod, a, f=f: seen.append(
                        (mod.weight.shape[0], tuple(f * s for s in a[0].shape[2:])))))
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return seen


def prior_smallc_convs(seed, device):
    """The causal convs of one top-prior train step that take the small-channel
    backward (K7; csrc/dw_conv3d.cu's kernels smaller than 3x3x3):
    [(Cin, Cout, kernel, padded input spatial)], from a no-grad bf16 forward of
    the published top prior cut to one block, with hooks on the mask-'A'
    block's causal convs (``prior_step_launches`` counts the same convs)."""
    import torch
    from vqvae3d_tpu_torch.models.causal_blocks import CausalConv
    from vqvae3d_tpu_torch.ops.conv3d import SMALLC_MAX
    from vqvae3d_tpu_torch.train import prior_train

    model = make_prior(dict(TOP_PRIOR, num_resblocks=1), seed, device, dtype=torch.bfloat16)
    seen, hooks = [], []
    for m in model.layers[0].modules():
        if (isinstance(m, CausalConv) and tuple(m.weight.shape[2:]) != (1, 1, 1)
                and max(m.weight.shape[:2]) <= SMALLC_MAX):
            hooks.append(m.register_forward_pre_hook(lambda mod, a: seen.append((
                mod.weight.shape[1], mod.weight.shape[0], tuple(mod.weight.shape[2:]),
                tuple(s + f + b for s, (f, b) in zip(a[0].shape[2:], mod.pads))))))
    with torch.no_grad():
        prior_train.prior_loss_fn(model, code_batch(seed, device), train=False)
    for h in hooks:
        h.remove()
    return seen


def phase_train_kernels(ident, results, seed):
    import torch
    import torch.nn.functional as F
    from vqvae3d_tpu_torch.models.vqvae import VQVAEConfig
    from vqvae3d_tpu_torch.ops import conv3d, quantizer_ops, stack_kernel

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 7)
    cfg = VQVAEConfig(**FULL, **STEM2)
    # --- K1b at the three lookups of one train step
    k1b = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None)
    device_us = 0.0
    for n, k, d in k1_lookups(2):
        flat = torch.randn(n, d, generator=gen).to(dev)
        embed = torch.randn(k, d, generator=gen).to(dev)
        idx, counts, dw = quantizer_ops.l2_argmin_stats(flat, embed)
        again = quantizer_ops.l2_argmin_stats(flat, embed)
        p_idx = quantizer_ops.l2_argmin_plain(flat, embed)
        ties, real = quantizer_ops.genuine_ties(flat, embed, idx, p_idx)
        # the statistics of the kernel's own indices, by the plain means
        want_counts = torch.bincount(idx, minlength=k).float()
        want_dw = torch.zeros(k, d, device=dev).index_add_(0, idx, flat)
        err = float((dw - want_dw).abs().max())
        scale = float(want_dw.abs().max())
        tflat, tembed, rows, codes = k1_planted(n, k, d, gen, dev)
        t_idx, t_counts, _ = quantizer_ops.l2_argmin_stats(tflat, tembed)
        t_want = quantizer_ops.l2_argmin_plain(tflat, tembed)
        planted_ok = (torch.equal(t_idx[rows], codes) and torch.equal(t_want[rows], codes)
                      and torch.equal(t_counts, torch.bincount(t_idx, minlength=k).float()))
        _, t_real = quantizer_ops.genuine_ties(tflat, tembed, t_idx, t_want)
        plan = quantizer_ops.stats_plan(n, k, d)
        by = kernels_of(lambda: quantizer_ops.l2_argmin_stats(flat, embed))
        ms = [cuda_ms(lambda: quantizer_ops.l2_argmin_stats(flat, embed), K1_CALLS)
              for _ in range(2)]
        pms = cuda_ms(lambda: quantizer_ops.l2_argmin_stats_plain(flat, embed), 5)
        print(f"K1b l2_argmin_stats N={n} K={k} D={d} ({plan.ctas} CTAs over "
              f"{plan.lookup.tiles} tiles, {plan.lookup.rows} rows a thread, "
              f"{plan.lookup.lanes} lanes a row group, {plan.slabs} slabs a CTA): index "
              f"mismatches {int((idx != p_idx).sum())} (genuine ties {ties.numel()}, beyond tie "
              f"{real.numel()}); counts exact: {torch.equal(counts, want_counts)}; "
              f"max|dw - ref|={err:.3g} max|ref|={scale:.3g}; planted ties to the lowest code: "
              f"{planted_ok} (beyond tie {t_real.numel()}); device {kernels_text(by)}; event "
              f"{ms[0]:.4f}, {ms[1]:.4f} ms a call ({K1_CALLS} back to back) plain {pms:.4f} ms "
              f"[{ident}]")
        if (real.numel() or t_real.numel() or not planted_ok
                or not torch.equal(counts, want_counts) or err > 1e-5 * scale):
            raise AssertionError("K1b disagrees with its plain version")
        if not all(torch.equal(a, b) for a, b in zip((idx, counts, dw), again)):
            raise AssertionError("K1b: two identical calls differ")
        if set(by) != {"stats_partial", "stats_reduce"} or any(c > 1 for _, c in by.values()):
            raise AssertionError(f"K1b launches {by}, not stats_partial and stats_reduce once")
        if k >= 512 and plan.ctas < 2:
            raise AssertionError(f"K1b runs the K={k} lookup on one CTA")
        k1b["max_abs_err"] = max(k1b["max_abs_err"], err)
        k1b["ms"] += min(ms)
        k1b["plain_ms"] += pms
        bms, k1b["bound_by"] = bound_ms(*k1_cost(n, k, d, True), FP32_FLOPS)
        k1b["bound_ms"] += bms
        device_us += sum(us for us, _ in by.values())
    print(f"K1b a step: device {device_us:.2f} us, event {k1b['ms']:.4f} ms, bound "
          f"{k1b['bound_ms'] * 1e3:.2f} us ({k1b['bound_by']}) [{ident}]")
    results["l2_argmin_stats"] = k1b

    # --- the K3 backward at every (C, spatial) of the stem-2 stacks
    shapes = {}
    for _, c, spatial, n in cfg.same_stacks(VOLUME):
        per_step, deepest = shapes.get((c, spatial), (0, 0))
        shapes[(c, spatial)] = (per_step + n, max(deepest, n))
    bwd = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None)
    worst = {}
    for (c, spatial), (per_step, deepest) in sorted(shapes.items(),
                                                    key=lambda kv: -np.prod(kv[0][1])):
        x32 = torch.randn(1, c, *spatial, generator=gen).to(dev)
        g32 = torch.randn(1, c, *spatial, generator=gen).to(dev)
        for pad_mode in ("wrap", "zeros"):
            w = k3_weights(c, deepest, gen, dev)
            for dtype in (torch.float32, torch.bfloat16):
                x, gy = x32.to(dtype), g32.to(dtype)
                for depth, nb in (("one", 1), ("full", deepest)):
                    ws = [t[:nb] for t in w]
                    xg = x.clone().requires_grad_()
                    wg = [t.clone().requires_grad_() for t in ws]
                    y = stack_kernel.preact_stack_fused(xg, *wg, pad_mode)
                    got = torch.autograd.grad(y, [xg, *wg], gy)
                    if depth == "one":  # a second call: bit-identical (both routes)
                        y2 = stack_kernel.preact_stack_fused(xg, *wg, pad_mode)
                        again = torch.autograd.grad(y2, [xg, *wg], gy)
                        if not all(torch.equal(a, b) for a, b in zip(got, again)):
                            raise AssertionError(f"K3 bwd C={c} {spatial} {pad_mode} {dtype}: "
                                                 "two identical calls differ")
                        del y2, again
                    with plain_path():
                        xr = x.clone().requires_grad_()
                        wr = [t.clone().requires_grad_() for t in ws]
                        yr = stack_kernel.preact_stack_plain(xr, *wr, pad_mode=pad_mode)
                        want = torch.autograd.grad(yr, [xr, *wr], gy)
                    key = (str(dtype).removeprefix("torch."), depth)
                    errs = []
                    for name, a, b in zip(("dx", "dw1", "dw2", "dw3", "dsc"), got, want):
                        err = float((a.float() - b.float()).abs().max())
                        scale = float(b.float().abs().max())
                        errs.append(f"{name} {err / scale:.2e}")
                        worst[key] = max(worst.get(key, 0.0), err / scale)
                        if not err <= K3_BWD_TOL[key] * scale:
                            raise AssertionError(
                                f"K3 bwd C={c} {spatial} {pad_mode} {key} {name}: "
                                f"max|d|={err:.3g} > {K3_BWD_TOL[key]} x {scale:.3g}")
                        if key == ("float32", "full"):
                            bwd["max_abs_err"] = max(bwd["max_abs_err"], err)
                    print(f"K3 bwd C={c} {spatial} {pad_mode} {key[0]} blocks={nb}: "
                          f"max|d|/max|ref| " + ", ".join(errs))
                    del y, got, yr, want
            if pad_mode == "wrap":  # the config's pad mode, training dtype bf16
                nb = min(deepest, 10)
                ws = [t[:nb] for t in w]
                routes = {}
                # fp32 (CUDA cores), bf16 on its route and on the parent's five
                # elementwise kernels, the two bf16 routes in turns
                for route in ("fp32", "bf16", "bf16 parent", "bf16 parent", "bf16"):
                    dtype = torch.float32 if route == "fp32" else torch.bfloat16
                    xd, gd = x32.to(dtype), g32.to(dtype)
                    saves = torch.empty((nb, 1, *spatial, c), dtype=dtype, device=dev)
                    stack_kernel._forward_cuda(xd, *ws, "wrap", saves=saves)
                    bwd_fn = functools.partial(stack_kernel.preact_stack_bwd, saves, gd, *ws,
                                               "wrap")
                    with parent_routes(k3_bwd=route == "bf16 parent"):
                        routes.setdefault(route, []).append(
                            (cuda_ms(bwd_fn, 3) / nb, k3_bwd_split(device_ms_by_name(bwd_fn, 2))))
                with plain_path():  # bf16, the last saves
                    pms = cuda_ms(lambda: stack_kernel.preact_stack_bwd_plain(
                        saves, gd, *ws, "wrap"), 1) / nb
                cb = max(c // 2, 1)
                brick = conv3d.stack_bwd_brick_route(torch.bfloat16, cb)
                ms = min(t for t, _ in routes["bf16"])
                ms_parent = min(t for t, _ in routes["bf16 parent"])
                split, split_parent = routes["bf16"][-1][1], routes["bf16 parent"][-1][1]
                ms32, split32 = routes["fp32"][0]
                # cuDNN's data gradient of the block's 3x3x3 Cb -> Cb conv (the
                # pre-padded input's), a yardstick of the transposed conv part
                wd = torch.randn(cb, cb, 3, 3, 3, generator=gen).to(dev, torch.bfloat16)
                gd3 = torch.randn(1, cb, *spatial, generator=gen).to(dev, torch.bfloat16)
                dgrad_ms = cuda_ms(lambda: torch.nn.grad.conv3d_input(
                    (1, cb, *(n + 2 for n in spatial)), wd, gd3), 5, warmup=2)
                nvox = int(np.prod(spatial))
                # x and g read, dx written (bf16), fp32 dW and scalars written; 3x the
                # forward's flops (recompute, data gradient, weight gradient)
                nbytes = 3 * nvox * c * 2 + (2 * c * cb + 27 * cb * cb) * (2 + 4) + 64
                bms, bwd["bound_by"] = bound_ms(nbytes, 3 * k3_block_cost(c, spatial, 2)[1],
                                                BF16_FLOPS)
                # the dW2 contraction alone: gt3 and a2 read once (bf16), dW2 written
                # (fp32); beside it cuDNN's weight gradient of the same 3x3x3 conv (a2
                # circularly pre-padded), in turns with the backward's profile, both
                # sides the device time of their kernels by torch.profiler (the
                # contraction's first pass; its share of contract_reduce is "reduce")
                d2bms, _ = bound_ms(2 * nvox * cb * 2 + 27 * cb * cb * 4,
                                    2 * 27 * cb * cb * nvox, BF16_FLOPS)
                a2p = conv3d.pad3d(torch.randn(1, cb, *spatial, generator=gen).to(dev)
                                   .to(torch.bfloat16), 1, "wrap")
                gt3 = torch.randn(1, cb, *spatial, generator=gen).to(dev).to(torch.bfloat16)
                turns = [(k3_bwd_split(device_ms_by_name(bwd_fn, 2))["dW2"] / nb,
                          sum(device_ms_by_name(lambda: torch.nn.grad.conv3d_weight(
                              a2p, (cb, cb, 3, 3, 3), gt3), 5).values())) for _ in range(2)]
                d2 = sum(t[0] for t in turns) / len(turns)
                lms = sum(t[1] for t in turns) / len(turns)
                print(f"K3 bwd C={c} {spatial} per block: bf16 "
                      f"({'brick kernels' if brick else 'five elementwise kernels'}, tensor-core "
                      f"contractions) {ms:.4f} ms (turns "
                      + ", ".join(f"{t:.4f}" for t, _ in routes["bf16"])
                      + f"), the parent's bf16 route (five elementwise kernels) {ms_parent:.4f} "
                      f"ms (turns " + ", ".join(f"{t:.4f}" for t, _ in routes["bf16 parent"])
                      + f"), fp32 (CUDA-core contractions) {ms32:.4f} ms, plain bf16 "
                      f"{pms:.4f} ms, bound {bms:.4f} ms; cuDNN's dgrad of the 3x3x3 conv "
                      f"{dgrad_ms:.4f} ms; x{per_step} blocks/step [{ident}]")
                print(f"  device split per block, bf16: "
                      + ", ".join(f"{k} {v / nb:.4f}" for k, v in split.items())
                      + "; the parent's bf16: "
                      + ", ".join(f"{k} {v / nb:.4f}" for k, v in split_parent.items())
                      + "; fp32: " + ", ".join(f"{k} {v / nb:.4f}" for k, v in split32.items())
                      + f" ms; dW2 contraction bf16 {d2:.4f} ms (bound {d2bms:.4f} ms, bytes), "
                      f"cuDNN wgrad of the same conv {lms:.4f} ms ({d2 / lms:.2f}x; both device "
                      f"time by torch.profiler; in turns "
                      + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in turns) + f") [{ident}]")
                del saves, routes, bwd_fn
                bwd["ms"] += ms * per_step
                bwd["plain_ms"] += pms * per_step
                bwd["bound_ms"] += bms * per_step
                for key, val in (("fp32_ms", ms32), ("parent_ms", ms_parent), ("dw2_ms", d2),
                                 ("dw2_fp32_ms", split32["dW2"] / nb), ("dw2_bound_ms", d2bms),
                                 ("wgrad_ms", lms), ("dgrad_ms", dgrad_ms)):
                    bwd[key] = bwd.get(key, 0.0) + val * per_step
                for name, sp in (("split", split), ("parent_split", split_parent)):
                    bwd.setdefault(name, {})
                    for k, v in sp.items():
                        bwd[name][k] = bwd[name].get(k, 0.0) + v / nb * per_step
            torch.cuda.empty_cache()
    print("K3 bwd worst max|d|/max|ref| by (dtype, depth): "
          + ", ".join(f"{k[0]} {k[1]}: {v:.3g}" for k, v in sorted(worst.items())))
    print(f"K3 bwd per stem-2 step: bf16 {bwd['ms']:.2f} ms (brick kernels at 5 <= Cb <= 128, "
          f"tensor-core contractions), the parent's bf16 route {bwd['parent_ms']:.2f} ms, fp32 "
          f"{bwd['fp32_ms']:.2f} ms (CUDA-core contractions), plain bf16 {bwd['plain_ms']:.2f} ms, "
          f"bound {bwd['bound_ms']:.3f} ms, cuDNN's dgrad of the 3x3x3 convs (a yardstick of the "
          f"transposed conv) {bwd['dgrad_ms']:.2f} ms; bf16 device split "
          + ", ".join(f"{k} {v:.2f}" for k, v in bwd["split"].items())
          + "; the parent's " + ", ".join(f"{k} {v:.2f}" for k, v in bwd["parent_split"].items())
          + f" ms; dW2 contraction bf16 {bwd['dw2_ms']:.2f} ms (fp32 route "
          f"{bwd['dw2_fp32_ms']:.2f}), bound {bwd['dw2_bound_ms']:.3f} ms, cuDNN wgrad of the "
          f"same convs {bwd['wgrad_ms']:.2f} ms (both device time by torch.profiler) [{ident}]")
    results["preact_stack_bwd"] = bwd

    # --- K7 at every qualifying conv of the stem-2 train step
    model, _ = make_model(2, seed, torch.bfloat16, dev)
    vol = torch.zeros(1, 1, *VOLUME, device=dev)
    convs = smallc_convs(model, vol)
    del model
    results["smallc_convs"] = convs
    k7 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for cb, spatial in convs:
        padded = tuple(s + 2 for s in spatial)
        xp32 = torch.randn(1, cb, *padded, generator=gen).to(dev)
        g32 = torch.randn(1, cb, *spatial, generator=gen).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            xp, g = xp32.to(dtype), g32.to(dtype)
            got = conv3d.dw_conv3d(xp, g, (3, 3, 3))
            again = conv3d.dw_conv3d(xp, g, (3, 3, 3))
            want = conv3d.dw_conv3d_plain(xp, g, (3, 3, 3))
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            # and against the autograd of F.conv3d: cuDNN's wgrad, whose order of
            # summation is its own (fp32: 6e-6 measured on the CPU at 64x64x32)
            # and whose dW is in the activation dtype (bf16: rounded to 2^-9 of
            # the value, its internal accumulation not documented)
            w = torch.zeros(cb, cb, 3, 3, 3, dtype=dtype, device=dev, requires_grad=True)
            (auto,) = torch.autograd.grad(F.conv3d(xp, w), w, g)
            auto_err = float((got - auto.float()).abs().max())
            auto_tol = 1e-4 if dtype == torch.float32 else 2**-6
            if not torch.equal(got, again) or err > K7_TOL * scale or auto_err > auto_tol * scale:
                raise AssertionError(f"K7 C={cb} {spatial} {dtype}: max|d| plain {err:.3g}, "
                                     f"autograd {auto_err:.3g} (max|ref| {scale:.3g}) or not "
                                     f"deterministic")
            print(f"K7 C={cb} {spatial} {str(dtype).removeprefix('torch.')}: max|d|/max|ref| "
                  f"vs plain {err / scale:.2e} (tol {K7_TOL}), vs autograd of F.conv3d "
                  f"{auto_err / scale:.2e} (tol {auto_tol:.3g})")
            k7["max_abs_err"] = max(k7["max_abs_err"], err)
        xp, g = xp32.to(torch.bfloat16), g32.to(torch.bfloat16)
        # the kernel and cuDNN's wgrad in turns, twice (warmed up at this shape)
        turns = [(cuda_ms(lambda: conv3d.dw_conv3d(xp, g, (3, 3, 3)), 5, warmup=2),
                  cuda_ms(lambda: torch.nn.grad.conv3d_weight(xp, (cb, cb, 3, 3, 3), g), 5,
                          warmup=2)) for _ in range(2)]
        ms = sum(t[0] for t in turns) / len(turns)
        lms = sum(t[1] for t in turns) / len(turns)
        pms = cuda_ms(lambda: conv3d.dw_conv3d_plain(xp, g, (3, 3, 3)), 2)
        nvox = int(np.prod(spatial))
        bms, k7["bound_by"] = bound_ms(2 * cb * (int(np.prod(padded)) + nvox) + 4 * 27 * cb * cb,
                                       2 * 27 * cb * cb * nvox, BF16_FLOPS)
        print(f"K7 dw_conv3d C={cb}->{cb} 3x3x3 over {spatial}: bf16 kernel {ms:.4f} ms "
              f"plain {pms:.4f} ms cuDNN wgrad {lms:.4f} ms ({ms / lms:.2f}x; in turns "
              + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in turns)
              + f") bound {bms:.4f} ms [{ident}]")
        k7["ms"] += ms
        k7["plain_ms"] += pms
        k7["library_ms"] += lms
        k7["bound_ms"] += bms
    print(f"K7 the {len(convs)} convs of a stem-2 step, bf16: kernel {k7['ms']:.4f} ms, cuDNN "
          f"wgrad {k7['library_ms']:.4f} ms ({k7['ms'] / k7['library_ms']:.2f}x), plain "
          f"{k7['plain_ms']:.4f} ms, bound {k7['bound_ms']:.4f} ms [{ident}]")

    # --- K7 at the top-prior step's causal convs: kernels (2,3,3), (1,2,3),
    # (1,1,2), whose bf16 route skips taps and warps a 3x3x3 kernel uses
    pconvs = prior_smallc_convs(seed + 51, dev)
    results["prior_smallc_convs"] = pconvs
    if sorted(ks for _, _, ks, _ in pconvs) != [(1, 1, 2), (1, 2, 3), (2, 3, 3)]:
        raise AssertionError(f"top-prior K7 convs {pconvs}: expected kernels (2,3,3), "
                             "(1,2,3) and (1,1,2)")
    for cin, cout, ks, padded in pconvs:
        out = tuple(p - k + 1 for p, k in zip(padded, ks))
        xp32 = torch.randn(1, cin, *padded, generator=gen).to(dev)
        g32 = torch.randn(1, cout, *out, generator=gen).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            xp, g = xp32.to(dtype), g32.to(dtype)
            got = conv3d.dw_conv3d(xp, g, ks)
            again = conv3d.dw_conv3d(xp, g, ks)
            want = conv3d.dw_conv3d_plain(xp, g, ks)
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            if not torch.equal(got, again) or not err <= K7_TOL * scale:
                raise AssertionError(f"K7 top prior C={cin}->{cout} {ks} {dtype}: max|d| "
                                     f"{err:.3g} > {K7_TOL} x {scale:.3g} or not deterministic")
            k7["max_abs_err"] = max(k7["max_abs_err"], err)
            key = str(dtype).removeprefix("torch.")
            if dtype == torch.bfloat16:
                ms = cuda_ms(lambda: conv3d.dw_conv3d(xp, g, ks), 5, warmup=2)
                lms = cuda_ms(lambda: torch.nn.grad.conv3d_weight(xp, (cout, cin, *ks), g), 5,
                              warmup=2)
                timing = f"; kernel {ms:.4f} ms, cuDNN wgrad {lms:.4f} ms [{ident}]"
            else:
                timing = ""
            print(f"K7 top prior C={cin}->{cout} {ks} over {out} {key}: max|d|/max|ref| vs plain "
                  f"{err / scale:.2e} (tol {K7_TOL}), a second call bit-identical{timing}")
    results["dw_conv3d"] = k7


def synthetic_batch(seed, device, volume=None):
    """One loader batch: a random CT volume (``VOLUME`` unless ``volume``) in
    the loader's HU window, (1, H, W, D, 1), all depth slices valid."""
    import torch
    from vqvae3d_tpu_torch.data.transforms import hu_window_normalize

    volume = volume or VOLUME
    rng = np.random.default_rng(seed)
    vol = hu_window_normalize(rng.integers(-1000, 1500, size=volume, dtype=np.int16))
    return {"volume": torch.from_numpy(vol)[None, ..., None].to(device),
            "num_valid_slices": torch.tensor([volume[2]], device=device)}


def phase_train_step(ident, seed, results):
    import torch
    from vqvae3d_tpu_torch.models.quantizer import QuantizerState, ema_first_pass_init
    from vqvae3d_tpu_torch.ops import quantizer_ops
    from vqvae3d_tpu_torch.train import vqvae_train
    from vqvae3d_tpu_torch.train.state import AMSGrad

    dev = torch.device("cuda")
    batch = synthetic_batch(seed + 2, dev)

    # --- fp32: one step's loss, gradients and EMA state, kernels vs plain
    model, cfg = make_model(2, seed, torch.float32, dev)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}

    def loss_and_grads():
        """One step's loss, gradients and new EMA state, and per level the
        quantizer's input and indices."""
        model.zero_grad(set_to_none=True)
        seen = {}
        hooks = [q.register_forward_hook(lambda m, a, o, i=i: seen.__setitem__(
                     i, (a[0].detach().float(), o[2].flatten())))
                 for i, q in enumerate(model.encoder.quantize)]
        loss, _, _ = vqvae_train.vqvae_loss_fn(model, batch, train=True)
        for h in hooks:
            h.remove()
        loss.backward()
        return (float(loss.detach()), {n: p.grad for n, p in model.named_parameters()},
                {k: v.clone() for k, v in model.state_dict().items() if ".quantize." in k}, seen)

    loss_k, grads_k, ema_k, seen_k = loss_and_grads()
    model.load_state_dict(state0)
    with plain_path():
        loss_p, grads_p, ema_p, seen_p = loss_and_grads()
    torch.cuda.synchronize()
    # indices equal except at genuine ties; a tie at a coarser level changes the
    # finer levels' inputs, so below one any mismatch is accepted. The EMA state
    # is compared on the codes no mismatched row touched.
    touched, tie_above, mism = {}, None, []
    for lvl in reversed(range(cfg.n_enc)):
        x, a = seen_k[lvl]
        b = seen_p[lvl][1]
        q0 = QuantizerState(*(state0[f"encoder.quantize.{lvl}.{k}"] for k in
                              ("embed", "embed_avg", "cluster_size", "first_pass")))
        flat = x.movedim(1, -1).reshape(-1, q0.embed.shape[1])
        embed = ema_first_pass_init(q0, flat).embed  # the codebook of the lookup
        ties, real = quantizer_ops.genuine_ties(flat, embed, a, b)
        mism.append(f"level {lvl}: {int((a != b).sum())} (ties {ties.numel()})")
        if real.numel() and tie_above is None:
            raise AssertionError(f"fp32 train step, level {lvl}: {real.numel()} index "
                                 f"mismatches beyond ties")
        diff = torch.nonzero(a != b).flatten()
        touched[lvl] = torch.unique(torch.cat([a[diff], b[diff]]))
        if diff.numel() and tie_above is None:
            tie_above = lvl
    gmax = max(float(g.abs().max()) for g in grads_p.values())
    grad_err = {n: float((grads_k[n] - grads_p[n]).abs().max())
                / max(float(grads_p[n].abs().max()), 1e-3 * gmax) for n in grads_p}
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:3]
    ema_err = 0.0
    for k in ema_p:
        keep = torch.ones(ema_p[k].shape[:1], dtype=torch.bool, device=dev)
        if ema_p[k].ndim:
            keep[touched[int(k.split(".")[2])]] = False
        d = (ema_k[k].float() - ema_p[k].float())[keep]
        if d.numel():
            ema_err = max(ema_err, float(d.abs().max()) / max(float(ema_p[k].float().abs().max()), 1.0))
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    print(f"fp32 train step (stem 2, {VOLUME}): index mismatches {', '.join(mism)}; loss "
          f"kernel {loss_k:.7g} plain {loss_p:.7g} (rel {loss_err:.2e}); gradients of "
          f"{len(grads_p)} tensors, worst max|d| over max(max|ref|, 1e-3 max grad): "
          + ", ".join(f"{n} {e:.2e}" for n, e in worst)
          + f"; EMA state rel {ema_err:.2e} on the codes no mismatch touched "
          f"({sum(t.numel() for t in touched.values())} touched) [{ident}]")
    if (loss_err > STEP_LOSS_TOL or worst[0][1] > STEP_GRAD_TOL or ema_err > STEP_EMA_TOL
            or not np.isfinite(loss_k)):
        raise AssertionError("fp32 train step: kernel path disagrees with the plain path")
    results["step_fp32"] = dict(loss_rel=loss_err, grad_worst=worst[0][1], ema_rel=ema_err)
    del model, state0, grads_k, grads_p
    torch.cuda.empty_cache()

    # --- bf16 train steps: launches per step, ms/step and peak memory per path
    model, cfg = make_model(2, seed, torch.bfloat16, dev)
    convs = results["smallc_convs"]
    opt = AMSGrad(model.parameters(), lr=1e-4)
    step = vqvae_train.make_train_step(model, opt)
    reset_counts()
    log = step(batch)
    torch.cuda.synchronize()
    got = launch_counts()
    blocks = sum(n for *_, n in cfg.same_stacks(VOLUME))
    want = dict(dict.fromkeys(got, 0), l2_argmin_stats=cfg.n_enc, preact_stack_fwd=blocks,
                preact_stack_bwd=blocks, dw_conv3d=len(convs))
    print(f"bf16 train step launches {got}, config implies {want} "
          f"(loss {float(log['loss']):.5g}) [{ident}]")
    if got != want or not np.isfinite(float(log["loss"])):
        raise AssertionError(f"train step launches {got} != {want} or non-finite loss")
    timing = {}
    paths = ("kernel", "parent K3 bwd", "parent K3 fwd")
    for path in paths + paths + ("plain",):  # the plain path's step once, after the turns
        ctx = (plain_path() if path == "plain" else parent_routes(k3_fwd=True)
               if path == "parent K3 fwd" else parent_routes(k3_bwd=True)
               if path == "parent K3 bwd" else contextlib.nullcontext())
        once = path == "plain"
        with ctx:
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step(batch), iters=1 if once else 3, warmup=0 if once else 1)
            peak = torch.cuda.max_memory_allocated() / 2**30
        timing.setdefault(path, []).append((ms, peak))
        print(f"bf16 train step (stem 2, batch 1, {VOLUME}) {path} path: {ms:.2f} ms/step ("
              + ("one step, no warm-up" if once else "mean of 3 after 1 warm-up")
              + f") peak {peak:.2f} GiB [{ident}]")
    results["step_bf16"] = timing

    # --- two identical steps from one state: bit-identical params and EMA state
    torch.backends.cudnn.deterministic = True
    snap = ({k: v.clone() for k, v in model.state_dict().items()},
            {k: v.clone() if torch.is_tensor(v) else v for k, v in opt.state_dict().items()})
    outs = []
    for _ in range(2):
        model.load_state_dict(snap[0])
        opt.load_state_dict(snap[1])
        step(batch)
        outs.append({k: v.clone() for k, v in model.state_dict().items()})
    torch.backends.cudnn.deterministic = False
    differ = [k for k in outs[0] if not torch.equal(outs[0][k], outs[1][k])]
    print(f"two identical bf16 steps from one state: {len(outs[0]) - len(differ)} of "
          f"{len(outs[0])} params and buffers bit-identical (cuDNN deterministic) [{ident}]")
    if differ:
        raise AssertionError(f"not bit-identical: {differ[:5]}")

    # --- where the time goes: one kernel-path step under the profiler
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=act) as prof:
        step(batch)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    table = events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=70)
    by_name = {e.key: e.self_device_time_total / 1e3 for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA}
    split = k3_bwd_split(by_name)
    k3_fwd = sum(v for k, v in by_name.items() if any(n in k for n in K3_FWD_KERNELS))
    parts = ", ".join(f"{k} {split[k]:.1f}" for k in K3_BWD_ELEMENTWISE if k in split)
    k1b_ms = sum(v for k, v in by_name.items() if "stats_partial" in k or "stats_reduce" in k)
    scatter = [e.key for e in events if "index_put" in e.key or "indexing_backward" in e.key]
    layer = {}
    for first in (False, True):
        run = quantizer_layer(seed + 5, dev, first)
        layer[first] = (sum(us * n for us, n in kernels_of(run, 5).values()) / 1e3,
                        cuda_ms(run, 10, warmup=2))
    print(f"the quantizer layer of a stem-2 step alone (3 levels, train forward + backward, "
          f"random inputs): device {layer[False][0]:.4f} ms, event {layer[False][1]:.4f} ms "
          f"after the first pass; on the initialising pass {layer[True][0]:.4f} / "
          f"{layer[True][1]:.4f} ms; K1b in the step's profile {k1b_ms:.4f} ms; index_put or "
          f"indexing_backward in the step's profile: {scatter or 'none'} [{ident}]")
    if scatter:
        raise AssertionError(f"the train step scatters into the codebook: {scatter}")
    print(f"profile of one bf16 kernel-path train step: device busy {busy:.1f} ms of "
          f"{wall:.1f} ms wall under the profiler; K3 forward {k3_fwd:.1f} ms; K3 backward: dW2 "
          f"contraction {split['dW2']:.1f} ms, other contractions "
          f"{split['other contractions']:.1f}, reduce {split['reduce']:.1f}, elementwise "
          f"{split['elementwise']:.1f} ({parts}); the rest of the step "
          f"{split['rest'] - k3_fwd:.1f} ms [{ident}]\n{table}")
    del model, opt
    torch.cuda.empty_cache()


def phase_train_cli(ident, counts, results, seed, work: Path):
    import torch
    from vqvae3d_tpu_torch.cli import extract_embeddings, train_vqvae
    from vqvae3d_tpu_torch.models.vqvae import VQVAEConfig

    rng = np.random.default_rng(seed + 3)
    ct = work / "ct_train"
    ct.mkdir()
    for i in range(3):
        write_scan(ct / f"scan{i}.nrrd", rng.integers(-1000, 1500, size=VOLUME, dtype=np.int16))
    ckpt = work / "train_ckpt"
    flags = [str(ct), "--ckpt-dir", str(ckpt), "--batch-size", "1",
             "--num-embeddings", *map(str, FULL["num_embeddings"]),
             "--n-pre-quantization-blocks", "50", "--n-post-quantization-blocks", "50",
             "--n-post-downscale-blocks", "2", "--n-post-upscale-blocks", "3",
             "--stem-space-to-depth", "2", "--base-network-channels", "8",
             "--pad-mode", "wrap", "--scan-size", *map(str, VOLUME[:2]),
             "--output-depth", str(VOLUME[2]), "--val-every-steps", "3",
             "--log-every-n-steps", "1", "--num-workers", "2", "--device", "cuda"]
    cfg = VQVAEConfig(**FULL, **STEM2)
    blocks = sum(n for *_, n in cfg.same_stacks(VOLUME))
    per_step = dict(dict.fromkeys(launch_counts(), 0), l2_argmin_stats=cfg.n_enc,
                    preact_stack_fwd=blocks, preact_stack_bwd=blocks,
                    dw_conv3d=len(results["smallc_convs"]))
    runs = [("train", ["--max-steps", "3"], 3), ("resume", ["--max-steps", "4", "--resume"], 1)]
    total = {k: 0 for k in launch_counts()}
    for name, extra, steps in runs:
        reset_counts()
        t0 = time.perf_counter()
        _, opt, step = train_vqvae.main(train_vqvae.parse_arguments(flags + extra))
        torch.cuda.synchronize()
        got = launch_counts()
        # each run validates once (the 1 val scan, an eval forward)
        want = {k: v * steps for k, v in per_step.items()}
        want["l2_argmin"] += cfg.n_enc
        want["preact_stack_fwd"] += blocks
        print(f"train_vqvae {name}: {steps} step(s) to step {step} in "
              f"{time.perf_counter() - t0:.1f} s (host clock, data and checkpoints "
              f"included); launches {got}; the config implies {want} [{ident}]")
        if step != {"train": 3, "resume": 4}[name] or opt.count != step:
            raise AssertionError(f"{name}: step {step}, optimizer count {opt.count}")
        if got != want:
            raise AssertionError(f"{name}: launches {got} != {want}")
        if name == "train":
            saved = torch.load(ckpt / "step_3_train.pt", weights_only=True)["optimizer"]
            if not all(torch.equal(saved[k], getattr(opt, k).cpu()) for k in ("mu", "nu", "nu_max")):
                raise AssertionError("the saved optimizer state is not the trained one")
        for k in total:
            total[k] += got[k]
    logs = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss"] for r in logs if "train_loss" in r]
    val = [r["val_recon_loss_mean"] for r in logs if "val_recon_loss_mean" in r]
    print(f"train losses by step {losses}; val recon loss {val}; best/ holds "
          f"{sorted(f.name for f in (ckpt / 'best').glob('step_*'))}")
    if len(losses) != 4 or not np.all(np.isfinite(losses + val)) or len(val) != 2:
        raise AssertionError("train CLI: losses missing or not finite")

    # the serving slice reads the training slice's checkpoint
    reset_counts()
    extract_embeddings.main(extract_embeddings.parse_arguments([
        "--checkpoint-path", str(ckpt), "--dataset-path", str(ct),
        "--output-path", str(work), "--output-name", "train_codes", "--rescale-input", "0",
        "--scan-size", *map(str, VOLUME[:2]), "--output-depth", str(VOLUME[2]),
        "--backend", "file", "--device", "cuda"]))
    torch.cuda.synchronize()
    got = launch_counts()
    codes = extract_embeddings.read_codes(work / "train_codes")
    print(f"extract_embeddings on the trained checkpoint: {len(codes)} samples, grids "
          f"{[g.shape for g in codes[0]]}, launches {got} [{ident}]")
    if len(codes) != 3 or [g.shape for g in codes[0]] != cfg.code_grid_shapes(VOLUME):
        raise AssertionError("extract on the trained checkpoint wrote the wrong grids")
    for k in total:
        total[k] += got[k]
    for k, v in total.items():
        counts[k] = counts.get(k, 0) + v


def make_prior(fields, seed, device, dtype=None):
    """A seeded PixelCNN (fp32 unless ``dtype``); every Fixup zero init
    (branch_conv3, the scalar biases, the scale) and every conv bias
    perturbed, so each branch counts."""
    import torch
    from vqvae3d_tpu_torch.models.causal_blocks import (
        FIXUP_SCALARS,
        SCALARS,
        FixupCausalResBlock,
        PreActFixupCausalResBlock,
    )
    from vqvae3d_tpu_torch.models.pixelcnn import PixelCNN, PixelCNNConfig

    gen = torch.Generator().manual_seed(seed)
    model = PixelCNN(PixelCNNConfig(**fields, dtype=dtype or torch.float32), generator=gen)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.endswith(".bias"):
                prm.copy_(torch.randn(prm.shape, generator=gen) * 0.05)
        for m in model.modules():
            fixup = isinstance(m, FixupCausalResBlock)
            if fixup or isinstance(m, PreActFixupCausalResBlock):
                last = m.branch_conv2 if fixup else m.branch_conv3
                for stream in ("depth_conv", "height_conv", "width_conv"):
                    w = getattr(last, stream).weight
                    fan_in = w[0].numel()
                    w.copy_(torch.randn(w.shape, generator=gen) * 0.3 * fan_in ** -0.5)
                for n in FIXUP_SCALARS if fixup else SCALARS:
                    getattr(m, f"bias{n}").copy_(torch.randn(1, generator=gen) * 0.05)
                m.scale.copy_(1.0 + torch.randn(1, generator=gen) * 0.05)
    return model.to(device).eval()


def k6_cost(st, b, s2, k, cond):
    """(weight bytes, row bytes, flops of a row). The weights are the stacked
    tensors, each of which the kernel reads (layer 0's skip conv the only
    skip); a row reads its injections, caches, embeddings and Gumbel table
    once and writes its caches and indices once; the flops are the products
    of both phases, layer 0's skip conv and the logits."""
    L, c, br = st["w1"].shape
    weights = sum(v.numel() * v.element_size() for v in st.values())
    rows = (4 if cond else 3) * L * b * s2 * br * 4  # d2h, d2w, (cnd,) vhc read
    row_bytes = rows + 2 * b * s2 * c * 4 + s2 * b * k * 4 + L * b * s2 * br * 4 + b * s2 * 4
    skip = 2 * 2 * c * c if "skw" in st else 0  # both streams
    per_layer = 2 * (2 * c * br + br * br + 6 * br * br) + 2 * (2 * c * br + 2 * br * br)
    flops = b * s2 * (L * per_layer + skip + 2 * c * k)
    return weights, row_bytes, flops


def phase_sample_kernels(ident, results, seed):
    import torch
    from vqvae3d_tpu_torch.ops import decode_row
    from vqvae3d_tpu_torch.sample.ar_sample import draw_gumbel
    from vqvae3d_tpu_torch.sample.cached_sample import _extract_layers

    dev = torch.device("cuda")
    s2 = TOP_GRID[2]
    cases = [("top config, conditioned", TOP_PRIOR, 1, True),
             ("B=2, unconditioned", dict(TOP_PRIOR, condition_dim=0), 2, False),
             ("C=12 br=3, conditioned", dict(TOP_PRIOR, model_dim=12), 1, True)]
    for i, (name, fields, b, cond) in enumerate(cases):
        model = make_prior(fields, seed + 10 + i, dev)
        st = decode_row.stack_row_weights(_extract_layers(model), model.parse_input.weight,
                                          model.parse_input.bias, model.parse_output.weight,
                                          model.parse_output.bias)
        L, c, br = st["w1"].shape
        k = fields["input_dim"]
        gen = torch.Generator(dev).manual_seed(seed + 20 + i)
        d2h, d2w, cnd, vhc0 = (torch.randn(L, b, s2, br, device=dev, generator=gen) * 0.5
                               for _ in range(4))
        cnd = cnd if cond else None
        dfin, sprev = (torch.randn(b, s2, c, device=dev, generator=gen) * 0.5 for _ in range(2))
        gum = draw_gumbel((s2, b, k), gen, dev)
        forced = torch.randint(0, k, (b, s2), device=dev, generator=gen)
        args = (st, d2h, d2w, cnd, dfin, sprev)
        vk, vp = vhc0.clone(), vhc0.clone()
        _, _, lk = decode_row.row_decode(*args, vk, gum, 5, TOP_TAU, forced_idx=forced)
        _, _, lp = decode_row.row_decode_plain(*args, vp, gum, 5, TOP_TAU, forced_idx=forced)
        errs = {}
        for what, got, want in (("logits", lk, lp), ("caches", vk, vp)):
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            errs[what] = err
            if not err <= K6_TOL * scale or not torch.isfinite(got).all():
                raise AssertionError(f"K6 {name}, teacher-forced {what}: max|d|={err:.3g} > "
                                     f"{K6_TOL} x {scale:.3g}")
        free, _ = decode_row.row_decode(*args, vhc0.clone(), gum, 5, TOP_TAU)
        _, _, lpath = decode_row.row_decode_plain(*args, vhc0.clone(), gum, 5, TOP_TAU,
                                                  forced_idx=free)
        ties, beyond = decode_row.sampling_disagreements(lpath, gum, TOP_TAU, free)
        if beyond:
            raise AssertionError(f"K6 {name}: {beyond} sampled indices disagree beyond a tie")
        vk = vhc0.clone()
        ms = cuda_ms(lambda: decode_row.row_decode(*args, vk, gum, 5, TOP_TAU), 20, warmup=2)
        pms = cuda_ms(lambda: decode_row.row_decode_plain(*args, vk, gum, 5, TOP_TAU), 3)
        # the voxel chain's own clock: clock64() around its layer loops
        cycles = torch.zeros(b, 4, dtype=torch.int64, device=dev)
        decode_row.row_decode(*args, vk, gum, 5, TOP_TAU, cycles=cycles)
        per_step = decode_row.chain_cycles_per_layer_step(cycles, L, s2)
        cyc = cycles[0].tolist()
        weights, row_bytes, flops = k6_cost(st, b, s2, k, cond)
        bms, by = bound_ms(weights + row_bytes, flops, FP32_FLOPS)
        print(f"K6 row_decode {name} (L={L} C={c} br={br} K={k} s2={s2} B={b}): "
              f"teacher-forced max|d| logits {errs['logits']:.3g} (max|ref| "
              f"{float(lp.abs().max()):.3g}), caches {errs['caches']:.3g}; free-running "
              f"near ties {ties}, beyond {beyond}; per row (random inputs): kernel {ms:.4f} ms "
              f"(mean of 20), plain {pms:.2f} ms (mean of 3), bound {bms:.6f} ms ({by}: "
              f"{weights} B of weights, {row_bytes} B of the row, {flops} flops); voxel chain "
              f"{per_step:.1f} cycles per layer-step (clock64, batch element 0: layer loops "
              f"{cyc[1]}, chain {cyc[0]}, staging and height-row step {cyc[2]}, staging "
              f"{cyc[3]}) [{ident}]")
        if i == 0:  # the JSON line, per top grid: ms from the main path's own run
            rows = TOP_GRID[0] * TOP_GRID[1]
            gbms, gby = bound_ms(weights + rows * row_bytes, rows * flops, FP32_FLOPS)
            print(f"K6 per top grid ({rows} rows): bound {gbms:.4f} ms ({gby}; the weights "
                  f"read once, each row's data once); the plain time in the JSON line is the "
                  f"plain row's mean x {rows} (scaled, not run over a grid) [{ident}]")
            results["row_decode"] = dict(max_abs_err=errs["logits"], plain_ms=pms * rows,
                                         bound_ms=gbms, bound_by=gby, library_ms=None)
        del model, st


def phase_sample_main_path(ident, counts, results, seed, work: Path):
    import torch
    from vqvae3d_tpu_torch.checkpoint import save_prior
    from vqvae3d_tpu_torch.cli import sample_embeddings
    from vqvae3d_tpu_torch.data.sample_db import add_samples, create_or_load_db, save_db
    from vqvae3d_tpu_torch.models.prior_utils import idx_to_one_hot
    from vqvae3d_tpu_torch.sample.cached_sample import cached_ancestral_sample

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = make_prior(TOP_PRIOR, seed + 30, "cpu")
    save_prior(work / "prior_top", model)
    db_path = work / "samples_top.db"
    db = create_or_load_db(db_path, 1)
    rng = np.random.default_rng(seed + 31)
    level1 = add_samples(db, 1, rng.integers(0, TOP_PRIOR["condition_dim"], (2, *TOP_COND))
                         .astype(np.int32), None)
    save_db(db, db_path, 1)
    print(f"sampling set-up: prior checkpoint (PixelCNN {TOP_PRIOR}) and a DB with two "
          f"level-1 grids {TOP_COND} in {time.perf_counter() - t0:.1f} s")

    # the main path under a device-only profiler: K6's device time over its
    # own 16,384 launches (the host loop stays ahead of the card, so the
    # profiler's small per-launch cost should not reach the wall)
    reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        start.record()
        new = sample_embeddings.main(sample_embeddings.parse_arguments([
            "--model-checkpoint", str(work / "prior_top"), "--db-path", str(db_path),
            "--level", "0", "--size", *map(str, TOP_GRID), "--num-samples", "1",
            "--batch-size", "1", "--tau", str(TOP_TAU), "--sampler", "cached",
            "--seed", str(seed), "--device", "cuda"]))
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0  # the profiler's teardown left out
    got = launch_counts()
    k6_rows = [ms for name, ms in device_events(prof) if "row_decode" in name]
    k6_ms, k6_n = sum(k6_rows), len(k6_rows)
    rows = TOP_GRID[0] * TOP_GRID[1]
    want = dict(dict.fromkeys(got, 0), row_decode=rows)
    db = create_or_load_db(db_path, 0)
    grid = np.asarray(db[0][new[0]]["data"])
    print(f"sample_embeddings --level 0 --size {TOP_GRID} --tau {TOP_TAU}: {wall:.2f} s wall "
          f"(host clock, checkpoint load and DB write included, under the device-only "
          f"profiler, its teardown left out), {start.elapsed_time(end) / 1e3:.2f} s between "
          f"CUDA events on the stream; K6 device time {k6_ms:.1f} ms over {k6_n} kernels ({k6_ms / max(k6_n, 1):.4f} ms "
          f"a row); launches {got}, the grid implies {want}; "
          f"grid {grid.shape} {grid.dtype} codes {grid.min()}..{grid.max()}, "
          f"{len(np.unique(grid))} distinct [{ident}]")
    if got != want or k6_n != rows:
        raise AssertionError(f"sampling launches {got} != {want} (K6 kernels profiled: {k6_n})")
    if (len(new) != 1 or grid.shape != TOP_GRID or not np.issubdtype(grid.dtype, np.integer)
            or grid.min() < 0 or grid.max() >= TOP_PRIOR["input_dim"]
            or db[0][new[0]]["condition"] not in level1):
        raise AssertionError("the sampled grid or its condition is wrong")
    for k, v in got.items():
        counts[k] = counts.get(k, 0) + v
    results["sample_s"] = wall
    results["row_decode"]["ms"] = k6_ms

    # exactness at full width: teacher-forced cached logits vs the one-shot forward
    model = model.to(dev)
    gen = torch.Generator(dev).manual_seed(seed + 32)
    forced = torch.randint(0, TOP_PRIOR["input_dim"], (1, *TOP_GRID), device=dev, generator=gen)
    cond = torch.from_numpy(np.stack([np.asarray(db[1][level1[0]]["data"])]).astype(np.int64))
    t0 = time.perf_counter()
    _, logits = cached_ancestral_sample(model, TOP_GRID, 1, cond, TOP_TAU, forced=forced)
    torch.cuda.synchronize()
    t_forced = time.perf_counter() - t0
    with torch.inference_mode():
        ref = model(idx_to_one_hot(forced, TOP_PRIOR["input_dim"]),
                    idx_to_one_hot(cond.to(dev), TOP_PRIOR["condition_dim"]))
    err, scale = float((logits - ref).abs().max()), float(ref.abs().max())
    agree = float((logits.argmax(1) == ref.argmax(1)).float().mean())
    print(f"exactness, full grid {TOP_GRID}: teacher-forced cached sampler (K6 per row, "
          f"{t_forced:.2f} s) vs one-shot PixelCNN.forward: max|d| logits {err:.3g}, max|ref| "
          f"{scale:.3g} (tolerance {FORWARD_TOL} x max|ref|); argmax agreement {agree:.6f} "
          f"[{ident}]")
    if not err <= FORWARD_TOL * scale or not torch.isfinite(logits).all():
        raise AssertionError("cached logits disagree with the one-shot forward")
    results["sample_exact"] = (err, scale)
    del logits, ref
    torch.cuda.empty_cache()

    # where the time goes: four slices under the profiler (the condition cut
    # to its first slice, upsampled to the four)
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    dims = (4, *TOP_GRID[1:])
    cond = cond[:, :1]
    cached_ancestral_sample(model, (1, *TOP_GRID[1:]), 1, cond, TOP_TAU, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=act) as prof:
        cached_ancestral_sample(model, dims, 1, cond, TOP_TAU, generator=gen)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    cuda_rows = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in cuda_rows) / 1e3
    k6 = sum(e.self_device_time_total for e in cuda_rows if "row_decode" in e.key) / 1e3
    table = events.table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=60)
    print(f"profile of {dims[0]} slices ({dims[0] * dims[1]} rows): wall {wall:.1f} ms under the "
          f"profiler, device busy {busy:.1f} ms (K6 {k6:.1f} ms, the rest {busy - k6:.1f} ms: "
          f"depth tower, condition, embeddings, Gumbel draws), idle {wall - busy:.1f} ms "
          f"[{ident}]\n{table}")
    del model


def k4_cost(nvox, cu, cb, cc, itemsize):
    """(bytes, flops) of one K4 forward block and one K4 backward block. The
    forward reads x and the condition and writes y once, the weights once; the
    backward reads the saved x, the output's cotangent and the condition,
    reads and writes the condition's gradient, writes dx, reads the weights
    and writes the fp32 weight gradients. Flops: 2 (Cu Cb + 18 Cb² + Cc Cb +
    Cb Cu) a voxel forward (the union conv dense, as the kernel computes
    it), three times that backward (recompute, data and weight gradients)."""
    nw = cu * cb + 18 * cb * cb + cb * cu + cc * cb + 2 * cb
    weights = nw * itemsize + 8 * 4
    flops = 2 * nvox * (cu * cb + 18 * cb * cb + cc * cb + cb * cu)
    fwd = (nvox * (2 * cu + cc) * itemsize + weights, flops)
    bwd = (nvox * (3 * cu + 3 * cc) * itemsize + weights + 4 * (nw + 8), 3 * flops)
    return fwd, bwd


def top_union_weights(fields, seed, device):
    """The stacked union weights of a seeded top prior's mask-'B' segment."""
    import torch
    from vqvae3d_tpu_torch.ops import causal_kernel as ck

    model = make_prior(fields, seed, "cpu")
    with torch.no_grad():
        w = ck.pack_causal_union(model.layers[1:])
    return ck.UnionWeights(*(None if t is None else t.to(device) for t in w))


def phase_prior_kernels(ident, results, seed):
    import torch
    from vqvae3d_tpu_torch.ops import causal_kernel as ck

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 40)
    w_top = top_union_weights(TOP_PRIOR, seed + 41, dev)
    w_nc = top_union_weights(dict(TOP_PRIOR, condition_dim=0), seed + 42, dev)
    nb, cu, cb = w_top.w1e.shape
    cc = w_top.wc.shape[1]
    one = ck.UnionWeights(*(None if t is None else t[:1] for t in w_top))
    cases = [("top segment, conditioned", w_top, 1, 0.0, "full"),
             ("B=2, unconditioned", w_nc, 2, 0.0, "full"),
             ("one block, p=0.5 keep mask", one, 1, 0.5, "one")]
    errs = {"fwd": 0.0, "bwd": 0.0}
    worst = {}
    for name, w, b, p, depth in cases:
        n = w.sc.shape[0]
        x32 = torch.randn(b, *TOP_GRID, cu, generator=gen).to(dev)
        g32 = torch.randn(b, *TOP_GRID, cu, generator=gen).to(dev)
        c32 = torch.randn(b, *TOP_GRID, cc, generator=gen).to(dev) if w.wc is not None else None
        keep = (torch.rand(n, b, cb, generator=gen) < 0.5).float().to(dev) if p else None
        for dtype in (torch.float32, torch.bfloat16):
            key = (str(dtype).removeprefix("torch."), depth)
            x, gy = x32.to(dtype), g32.to(dtype)
            cond = None if c32 is None else c32.to(dtype)
            with torch.inference_mode():
                got = ck.causal_stack_fused(x, cond, keep, p, w)
                want = ck.causal_stack_plain(x, cond, keep, p, w)
            err, scale = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
            worst[("fwd", *key)] = max(worst.get(("fwd", *key), 0.0), err / scale)
            if not err <= K4_TOL[key] * scale or not torch.isfinite(got).all():
                raise AssertionError(f"K4 {name} {key} no-save forward: max|d|={err:.3g} > "
                                     f"{K4_TOL[key]} x {scale:.3g}")
            del got, want

            def grads(fn, **kw):
                xg = x.clone().requires_grad_()
                cg = None if cond is None else cond.clone().requires_grad_()
                wg = ck.UnionWeights(*(None if t is None else t.clone().requires_grad_()
                                       for t in w))
                y = fn(xg, cg, keep, p, wg, **kw)
                ins = [xg] + ([cg] if cg is not None else []) + [t for t in wg if t is not None]
                return (y.detach(), *torch.autograd.grad(y, ins, gy))

            got = grads(ck.causal_stack_fused)
            want = grads(ck.causal_stack_plain, remat=True)
            names = (["y", "dx"] + (["dcond"] if cond is not None else [])
                     + [f for f, t in zip(ck.UnionWeights._fields, w) if t is not None])
            rel = []
            for tname, a, r in zip(names, got, want):
                err, scale = float((a.float() - r.float()).abs().max()), float(r.float().abs().max())
                rel.append(f"{tname} {err / scale:.2e}")
                worst[("bwd", *key)] = max(worst.get(("bwd", *key), 0.0), err / scale)
                if not err <= K4_TOL[key] * scale or not torch.isfinite(a).all():
                    raise AssertionError(f"K4 {name} {key} {tname}: max|d|={err:.3g} > "
                                         f"{K4_TOL[key]} x {scale:.3g}")
                if key == ("float32", "full"):
                    errs["fwd" if tname == "y" else "bwd"] = max(
                        errs["fwd" if tname == "y" else "bwd"], err)
            print(f"K4 {name} ({n} blocks, B={b}, {TOP_GRID}, Cu={cu} Cb={cb}) {key[0]}: "
                  f"max|d|/max|ref| saving forward + backward " + ", ".join(rel))
            del got, want
            torch.cuda.empty_cache()
    print("K4 worst max|d|/max|ref| by (pass, dtype, depth): "
          + ", ".join(f"{k}: {v:.3g}" for k, v in sorted(worst.items())))

    # causality of the kernel at the top segment, fp32 (the CUDA-core kernels)
    # and bf16 (the tensor-core route): impulses through the no-save forward,
    # gradients through the backward
    checked, c = 0, cu // 3
    s0, s1, s2 = TOP_GRID
    x32 = torch.randn(1, *TOP_GRID, cu, generator=gen).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        with torch.inference_mode():
            base = ck.causal_stack_fused(x, None, None, 0.0, w_nc)
        for v in [(0, 0, 0), (s0 // 2, 3 * s1 // 4, s2 // 2), (s0 - 1, s1 - 1, s2 - 1),
                  (5, s1 - 1, 0)]:
            allowed = ck.causal_influence(TOP_GRID, v).to(dev)
            for si in range(3):
                x2 = x.clone()
                x2[0, v[0], v[1], v[2], si * c:(si + 1) * c] += 1.0
                with torch.inference_mode():
                    diff = (ck.causal_stack_fused(x2, None, None, 0.0, w_nc) - base).abs()
                moved = diff[0].reshape(*TOP_GRID, 3, c).sum(-1).permute(3, 0, 1, 2) > 0
                if (moved & ~allowed[si]).any() or not moved[si][v]:
                    raise AssertionError(f"K4 forward {dtype}: input stream {si} at {v} moved "
                                         f"outputs outside its raster future")
                checked += 1
        xg = x.clone().requires_grad_()
        y = ck.causal_stack_fused(xg, None, None, 0.0, w_nc)
        for pos in [(0, 0, 0), (s0 // 2, 3 * s1 // 4, s2 // 2), (s0 - 1, s1 - 1, s2 - 1)]:
            reach = ck.causal_reach(TOP_GRID, pos).to(dev)
            for so in range(3):
                (gx,) = torch.autograd.grad(y[0, pos[0], pos[1], pos[2], so * c:(so + 1) * c].sum(),
                                            xg, retain_graph=True)
                dep = gx[0].float().abs().reshape(*TOP_GRID, 3, c).sum(-1).permute(3, 0, 1, 2) > 0
                if (dep & ~reach[:, so]).any():
                    raise AssertionError(f"K4 backward {dtype}: output {pos} stream {so} depends "
                                         f"on inputs outside its raster past")
                checked += 1
        del x, xg, y, base
    print(f"K4 causality at the top segment ({nb} blocks, {TOP_GRID}), fp32 and bf16 (the "
          f"tensor-core forward and backward): {checked} impulse and gradient checks, no "
          f"dependence outside causal_reach")

    # times at the train path's shapes, bf16: one step's 50 blocks
    x = torch.randn(1, *TOP_GRID, cu, generator=gen).to(dev, torch.bfloat16)
    gy = torch.randn(1, *TOP_GRID, cu, generator=gen).to(dev, torch.bfloat16)
    cond = torch.randn(1, *TOP_GRID, cc, generator=gen).to(dev, torch.bfloat16)
    saves = torch.empty((nb, *x.shape), dtype=x.dtype, device=dev)
    with torch.no_grad():  # the plain backward enables autograd for itself
        # the forward on its route (bf16: the tensor cores) and on the parent's
        # CUDA-core kernels, in turns, and each one's device time by kernel
        fturns, fsplits = {True: [], False: []}, {}
        for tc in (True, False, False, True):
            with parent_routes(k4_fwd=not tc):
                fturns[tc].append(cuda_ms(lambda: ck._forward_cuda(
                    x, cond, None, 0.0, w_top, saves=saves), 3))
                fsplits[tc] = k4_fwd_split(device_ms_by_name(
                    lambda: ck._forward_cuda(x, cond, None, 0.0, w_top, saves=saves)))
        ms_f = min(fturns[True])
        ms_ns = cuda_ms(lambda: ck.causal_stack_fused(x, cond, None, 0.0, w_top), 3)
        pms_f = cuda_ms(lambda: ck.causal_stack_plain(x, cond, None, 0.0, w_top), 1)
        # cuDNN's bf16 conv with the union's (2, 3, 3) kernel over the grid (a2
        # pre-padded (1, 0), (1, 1), (1, 1)), 50 blocks: a yardstick of the conv part
        a2p = torch.randn(1, cb, s0 + 1, s1 + 2, s2 + 2, generator=gen).to(dev, torch.bfloat16)
        wcv = torch.randn(cb, cb, 2, 3, 3, generator=gen).to(dev, torch.bfloat16)
        conv_ms = nb * cuda_ms(lambda: torch.nn.functional.conv3d(a2p, wcv), 5, warmup=2)
        # the backward on its route (bf16: the tensor cores) and on the parent's
        # CUDA-core kernels, in turns, and each one's device time by kernel
        turns, splits = {True: [], False: []}, {}
        for tc in (True, False, False, True):
            with parent_routes(k4_bwd=not tc):
                turns[tc].append(cuda_ms(lambda: ck.causal_stack_bwd(
                    saves, gy, cond, None, 0.0, w_top), 3))
                splits[tc] = k4_bwd_split(device_ms_by_name(lambda: ck.causal_stack_bwd(
                    saves, gy, cond, None, 0.0, w_top)))
        ms_b = min(turns[True])
        pms_b = cuda_ms(lambda: ck.causal_stack_bwd_plain(saves, gy, cond, None, 0.0, w_top), 1)
    for tc, name in ((True, "tensor-core route"), (False, "the parent's CUDA-core kernels")):
        print(f"K4 backward bf16, {nb} blocks (one train step), {name}: "
              + ", ".join(f"{v:.3f}" for v in turns[tc]) + " ms; device split "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(splits[tc].items(),
                                                            key=lambda kv: -kv[1]))
              + f" ms [{ident}]")
    nvox = int(np.prod(TOP_GRID))
    (fb, ff), (bb, bf) = k4_cost(nvox, cu, cb, cc, 2)
    bms_f, by_f = bound_ms(nb * fb, nb * ff, BF16_FLOPS)
    bms_b, by_b = bound_ms(nb * bb, nb * bf, BF16_FLOPS)
    for tc, name in ((True, "tensor-core route"), (False, "the parent's CUDA-core kernels")):
        print(f"K4 forward bf16 (saving), {nb} blocks (one train step), {name}: "
              + ", ".join(f"{v:.3f}" for v in fturns[tc]) + " ms; device split "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(fsplits[tc].items(),
                                                            key=lambda kv: -kv[1]))
              + f" ms [{ident}]")
    print(f"K4 forward, {nb} blocks bf16 (one train step): saving {ms_f:.3f} ms, no-save "
          f"{ms_ns:.3f} ms, the parent's kernels (saving) {min(fturns[False]):.3f} ms, plain "
          f"{pms_f:.3f} ms, bound {bms_f:.4f} ms ({by_f}: {fb} B and {ff} flop a block); cuDNN's "
          f"bf16 conv with the (2, 3, 3) union kernel, {nb} blocks, {conv_ms:.3f} ms (a "
          f"yardstick of the conv part) [{ident}]")
    print(f"K4 backward, {nb} blocks bf16 (one train step): kernel {ms_b:.3f} ms, plain "
          f"{pms_b:.3f} ms, bound {bms_b:.4f} ms ({by_b}: {bb} B and {bf} flop a block) [{ident}]")
    results["causal_stack_fwd"] = dict(max_abs_err=errs["fwd"], ms=ms_f, plain_ms=pms_f,
                                       bound_ms=bms_f, bound_by=by_f, library_ms=None,
                                       parent_ms=min(fturns[False]), conv_yardstick_ms=conv_ms)
    results["causal_stack_bwd"] = dict(max_abs_err=errs["bwd"], ms=ms_b, plain_ms=pms_b,
                                       bound_ms=bms_b, bound_by=by_b, library_ms=None)
    del saves


def code_batch(seed, device):
    """One loader batch of the top prior: a level-0 grid of 128 codes and
    its 32x32x8 level-1 condition of 256 codes, int32."""
    import torch

    rng = np.random.default_rng(seed)
    return {"data": torch.from_numpy(rng.integers(0, TOP_PRIOR["input_dim"], (1, *TOP_GRID),
                                                  dtype=np.int32)).to(device),
            "condition": torch.from_numpy(rng.integers(0, TOP_PRIOR["condition_dim"],
                                                       (1, *TOP_COND), dtype=np.int32)).to(device)}


def prior_step_launches(model):
    """K4 and K7 launches of one train step of a PixelCNN. On the union path:
    one K4 forward and one K4 backward per mask-'B' block, K7 for the mask-'A'
    block's small-channel causal convs (kernel larger than 1x1x1, ungrouped);
    without it (wide, Fixup, concat-activation or k != 3 models): no K4, K7
    for every block's such convs."""
    from vqvae3d_tpu_torch.models.causal_blocks import CausalConv
    from vqvae3d_tpu_torch.ops.conv3d import SMALLC_MAX

    union = model.uses_union_stack
    layers = model.layers[:1] if union else model.layers
    k7 = sum(1 for m in layers.modules() if isinstance(m, CausalConv) and m.groups == 1
             and tuple(m.weight.shape[2:]) != (1, 1, 1) and max(m.weight.shape[:2]) <= SMALLC_MAX)
    nb = model.config.num_resblocks if union else 0
    return dict(causal_stack_fwd=nb, causal_stack_bwd=nb, dw_conv3d=k7)


def phase_prior_step(ident, seed, results):
    import torch
    from vqvae3d_tpu_torch.train import prior_train
    from vqvae3d_tpu_torch.train.state import AMSGrad

    dev = torch.device("cuda")
    batch = code_batch(seed + 50, dev)

    # --- fp32: one step's loss and gradients, kernel path vs plain path
    model = make_prior(TOP_PRIOR, seed + 51, dev)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss, _ = prior_train.prior_loss_fn(model, batch, train=True)
        loss.backward()
        return float(loss.detach()), {n: q.grad.clone() for n, q in model.named_parameters()}

    loss_k, grads_k = loss_and_grads()
    with plain_path():
        loss_p, grads_p = loss_and_grads()
    torch.cuda.synchronize()
    gmax = max(float(g.abs().max()) for g in grads_p.values())
    grad_err = {n: float((grads_k[n] - grads_p[n]).abs().max())
                / max(float(grads_p[n].abs().max()), 1e-3 * gmax) for n in grads_p}
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:3]
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    print(f"fp32 top-prior train step ({TOP_GRID}): loss kernel {loss_k:.7g} plain "
          f"{loss_p:.7g} (rel {loss_err:.2e}); gradients of {len(grads_p)} tensors, worst "
          f"max|d| over max(max|ref|, 1e-3 max grad): "
          + ", ".join(f"{n} {e:.2e}" for n, e in worst) + f" [{ident}]")
    if loss_err > STEP_LOSS_TOL or worst[0][1] > STEP_GRAD_TOL or not np.isfinite(loss_k):
        raise AssertionError("fp32 prior train step: kernel path disagrees with the plain path")
    results["prior_step_fp32"] = dict(loss_rel=loss_err, grad_worst=worst[0][1])
    del model, grads_k, grads_p
    torch.cuda.empty_cache()

    # --- bf16: launches per step, ms/step and peak memory per path
    model = make_prior(TOP_PRIOR, seed + 51, dev, dtype=torch.bfloat16)
    opt = AMSGrad(model.parameters(), lr=TOP_LR)
    step = prior_train.make_prior_train_step(model, opt, seed=seed + 52)
    reset_counts()
    log = step(batch)
    torch.cuda.synchronize()
    got = launch_counts()
    want = dict(dict.fromkeys(got, 0), **prior_step_launches(model))
    print(f"bf16 top-prior train step launches {got}, 50 blocks imply {want} "
          f"(loss {float(log['loss_mean']):.5g}) [{ident}]")
    if got != want or not np.isfinite(float(log["loss_mean"])):
        raise AssertionError(f"prior train step launches {got} != {want} or non-finite loss")
    timing = {}
    paths = ("kernel", "parent K4 fwd", "parent K4 bwd", "plain")
    for path in paths + paths:
        ctx = (plain_path() if path == "plain" else parent_routes(k4_fwd=True)
               if path == "parent K4 fwd" else parent_routes(k4_bwd=True)
               if path == "parent K4 bwd" else contextlib.nullcontext())
        with ctx:
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step(batch), iters=3, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2**30
        timing.setdefault(path, []).append((ms, peak))
        print(f"bf16 top-prior train step (batch 1, {TOP_GRID}) {path} path: {ms:.2f} ms/step "
              f"(mean of 3 after 1 warm-up) peak {peak:.2f} GiB [{ident}]")
    results["prior_step_bf16"] = timing

    # --- two identical steps from one state: bit-identical parameters
    torch.backends.cudnn.deterministic = True
    snap = ({k: v.clone() for k, v in model.state_dict().items()},
            {k: v.clone() if torch.is_tensor(v) else v for k, v in opt.state_dict().items()})
    outs = []
    for _ in range(2):
        model.load_state_dict(snap[0])
        opt.load_state_dict(snap[1])
        step(batch)
        outs.append({k: v.clone() for k, v in model.state_dict().items()})
    torch.backends.cudnn.deterministic = False
    differ = [k for k in outs[0] if not torch.equal(outs[0][k], outs[1][k])]
    print(f"two identical bf16 top-prior steps from one state: {len(outs[0]) - len(differ)} of "
          f"{len(outs[0])} parameters bit-identical (cuDNN deterministic) [{ident}]")
    if differ:
        raise AssertionError(f"not bit-identical: {differ[:5]}")

    # --- where the time goes: one kernel-path step under the profiler
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=act) as prof:
        step(batch)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    cuda_rows = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in cuda_rows) / 1e3
    k4 = {what: sum(e.self_device_time_total for e in cuda_rows if any(
        k in e.key for k in keys)) / 1e3 for what, keys in (
        ("K4 forward", K4_FWD_KERNELS),
        ("K4 backward", K4_BWD_KERNELS))}
    table = events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=70)
    print(f"profile of one bf16 kernel-path top-prior step: device busy {busy:.1f} ms of "
          f"{wall:.1f} ms wall under the profiler; "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in k4.items())
          + " (" + ", ".join(f"{k} {v:.1f}" for k, v in k4_fwd_split(
              {e.key: e.self_device_time_total / 1e3 for e in cuda_rows}).items() if k != "rest")
          + f"), the rest {busy - sum(k4.values()):.1f} ms [{ident}]\n{table}")
    del model, opt


def phase_prior_cli(ident, counts, seed, work: Path):
    import torch
    from vqvae3d_tpu_torch.checkpoint import load_prior
    from vqvae3d_tpu_torch.cli import sample_embeddings, train_prior
    from vqvae3d_tpu_torch.data.code_store import CodeStoreWriter
    from vqvae3d_tpu_torch.data.sample_db import add_samples, create_or_load_db, save_db
    from vqvae3d_tpu_torch.models.prior_utils import idx_to_one_hot

    rng = np.random.default_rng(seed + 60)
    t0 = time.perf_counter()
    store = work / "prior_codes"
    w = CodeStoreWriter(str(store), 2, [TOP_PRIOR["input_dim"], TOP_PRIOR["condition_dim"]],
                        backend="file")
    for i in range(4):  # 3 train grids, 1 validation grid
        w.write_sample(i, [rng.integers(0, TOP_PRIOR["input_dim"], TOP_GRID, dtype=np.int32),
                           rng.integers(0, TOP_PRIOR["condition_dim"], TOP_COND, dtype=np.int32)])
    w.close()
    print(f"prior CLI set-up: a code store of 4 samples {TOP_GRID} / {TOP_COND} in "
          f"{time.perf_counter() - t0:.1f} s")
    ckpt = work / "prior_ckpt"
    flags = [str(store), "0", "--use-model", "pixelcnn", "--model-dim", "16",
             "--num-resblocks", "50", "--bottleneck-divisor", "4", "--dropout-prob", "0",
             "--batch-size", "1", "--val-every-steps", "3", "--log-every-n-steps", "1",
             "--lr", str(TOP_LR), "--ckpt-dir", str(ckpt), "--device", "cuda",
             "--seed", str(seed)]
    total = {k: 0 for k in launch_counts()}
    for name, extra, steps in [("train", ["--max-steps", "3"], 3),
                               ("resume", ["--max-steps", "4", "--resume"], 1)]:
        reset_counts()
        t0 = time.perf_counter()
        model, opt, step = train_prior.main(train_prior.parse_arguments(flags + extra))
        torch.cuda.synchronize()
        got = launch_counts()
        per_step = prior_step_launches(model)
        want = dict(dict.fromkeys(got, 0), **{k: v * steps for k, v in per_step.items()})
        want["causal_stack_fwd"] += per_step["causal_stack_fwd"]  # one validation forward
        print(f"train_prior {name}: {steps} step(s) to step {step} in "
              f"{time.perf_counter() - t0:.1f} s (host clock, data and checkpoints included); "
              f"launches {got}; 50 blocks imply {want} [{ident}]")
        if step != {"train": 3, "resume": 4}[name] or opt.count != step or got != want:
            raise AssertionError(f"{name}: step {step}, optimizer count {opt.count}, "
                                 f"launches {got} != {want}")
        for k in total:
            total[k] += got[k]
        del model, opt
    logs = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss_mean"] for r in logs if "train_loss_mean" in r]
    val = [r["val_loss_mean"] for r in logs if "val_loss_mean" in r]
    print(f"train losses by step {losses}; val losses {val}; best/ holds "
          f"{sorted(f.name for f in (ckpt / 'best').glob('step_*'))}")
    if len(losses) != 4 or not np.all(np.isfinite(losses + val)) or len(val) != 2:
        raise AssertionError("prior train CLI: losses missing or not finite")

    # the trained checkpoint serves the one-shot forward and the sampler
    reset_counts()
    model, cfg = load_prior(ckpt, "cuda")
    batch = code_batch(seed + 61, "cuda")
    with torch.inference_mode():
        logits = model(idx_to_one_hot(batch["data"], cfg.input_dim),
                       idx_to_one_hot(batch["condition"], cfg.condition_dim))
    torch.cuda.synchronize()
    db_path = work / "prior_samples.db"
    db = create_or_load_db(db_path, 1)
    level1 = add_samples(db, 1, rng.integers(0, TOP_PRIOR["condition_dim"], (1, *TOP_COND))
                         .astype(np.int32), None)
    save_db(db, db_path, 1)
    t0 = time.perf_counter()
    new = sample_embeddings.main(sample_embeddings.parse_arguments([
        "--model-checkpoint", str(ckpt), "--db-path", str(db_path), "--level", "0",
        "--size", *map(str, TOP_COND), "--num-samples", "1", "--batch-size", "1",
        "--tau", str(TOP_TAU), "--sampler", "cached", "--seed", str(seed), "--device", "cuda"]))
    torch.cuda.synchronize()
    got = launch_counts()
    want = dict(dict.fromkeys(got, 0), causal_stack_fwd=cfg.num_resblocks,
                row_decode=TOP_COND[0] * TOP_COND[1])
    grid = np.asarray(create_or_load_db(db_path, 0)[0][new[0]]["data"])
    print(f"load_prior (step 4, {cfg.dtype}) + one forward: logits {tuple(logits.shape)} "
          f"finite={bool(torch.isfinite(logits).all())}; sample_embeddings --size {TOP_COND} "
          f"from the trained checkpoint in {time.perf_counter() - t0:.1f} s: grid {grid.shape} "
          f"codes {grid.min()}..{grid.max()}; launches {got}, implied {want} [{ident}]")
    if (tuple(logits.shape) != (1, cfg.input_dim, *TOP_GRID) or not torch.isfinite(logits).all()
            or got != want or grid.shape != TOP_COND or grid.min() < 0
            or grid.max() >= cfg.input_dim):
        raise AssertionError("the trained checkpoint does not serve the forward or the sampler")
    for k in total:
        counts[k] = counts.get(k, 0) + total[k] + got[k]


def attention_terms(nbytes, flops, itemsize, exps, ints=0):
    """The least time (ms) of each term of an attention call: the bytes at
    the memory rate, the products at the tensor-core rate of the dtype (fp32:
    the CUDA-core rate), the exps at the special-function rate and the int32
    operations (K5's mask) at the int32 rate."""
    peak = BF16_FLOPS if itemsize == 2 else FP32_FLOPS
    return {"bytes": 1e3 * nbytes / HBM_BPS, "products": 1e3 * flops / peak,
            "exps": 1e3 * exps / SFU_OPS, "int32": 1e3 * ints / INT32_OPS}


def bound_of(terms):
    """(ms, "bytes" or "operations", the term that bounds) of attention_terms."""
    top = max(terms, key=terms.get)
    return terms[top], "bytes" if top == "bytes" else "operations", top


def terms_text(terms):
    return ", ".join(f"{k} {v:.4f} ms" for k, v in terms.items() if v)


def k8_bound(n, s, d, itemsize, backward: bool):
    """(ms, what bounds it, bytes, flops, exps, the terms' times) of one K8
    call on (N, S, D): q, k, v read once and o and the fp32 log-sum-exp
    written once (backward: q, k, v, o, do and the log-sum-exp read, dq, dk,
    dv written); per causal logit (N S (S + 1) / 2 of them) 4 D flops and one
    exp forward (q.k, p.v), 10 D flops and one exp backward (q.k, do.v, dv,
    dk, dq); the largest of the terms' times (``attention_terms``)."""
    logits = n * s * (s + 1) // 2
    nbytes = (8 if backward else 4) * n * s * d * itemsize + 4 * n * s
    flops = (10 if backward else 4) * d * logits
    terms = attention_terms(nbytes, flops, itemsize, logits)
    ms, by, _ = bound_of(terms)
    return ms, by, nbytes, flops, logits, terms


def phase_attention_kernels(ident, results, seed):
    import torch
    import torch.nn.functional as F
    from vqvae3d_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 70)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, (n, s, d) in K8_SHAPES.items():
        scale = d ** -0.5
        q32, k32, v32, g32 = (torch.randn(n, s, d, generator=gen).to(dev) for _ in range(4))
        # the plain reference densely: the whole N at the bottom shape, the
        # first stream's 8 heads at the mid one ((S, S) logits, 2 GiB each)
        rows = n if s <= 2048 else 8
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).removeprefix("torch.")
            q, k, v, g = (t.to(dtype) for t in (q32, k32, v32, g32))

            def run(fn, nr):
                qq, kk, vv = (t[:nr].clone().requires_grad_() for t in (q, k, v))
                o = fn(qq, kk, vv, scale)
                return (o.detach(), *torch.autograd.grad(o, (qq, kk, vv), g[:nr]))

            got = run(fa.flash_causal_attention, n)
            again = run(fa.flash_causal_attention, n)
            # o against the plain forward; dq, dk, dv against the plain backward
            # on the kernel's o (which its backward read) and the plain lse
            want = (fa.flash_causal_attention_plain(q[:rows], k[:rows], v[:rows], scale),
                    *fa.flash_attention_bwd_plain(q[:rows], k[:rows], v[:rows], got[0][:rows],
                                                  fa.causal_lse_plain(q[:rows], k[:rows], scale),
                                                  g[:rows], scale))
            rel = []
            for tname, a, b, r in zip(("o", "dq", "dk", "dv"), got, again, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"K8 {name} {key} {tname}: a second call differs")
                err = float((a[:rows].float() - r.float()).abs().max())
                scale_ = float(r.float().abs().max())
                rel.append(f"{tname} {err:.3g} (max|ref| {scale_:.3g})")
                if not err <= K8_TOL[key] * scale_ or not torch.isfinite(a).all():
                    raise AssertionError(f"K8 {name} {key} {tname}: max|d|={err:.3g} > "
                                         f"{K8_TOL[key]} x {scale_:.3g}")
                if key == "bfloat16":  # the dtype of the times in the JSON line
                    w = "fwd" if tname == "o" else "bwd"
                    worst[w] = max(worst[w], err)
            print(f"K8 {name} (N={n} S={s} D={d}) {key}, plain on {rows} of {n} rows: max|d| "
                  + ", ".join(rel) + f"; a second call bit-identical [{ident}]")
            del got, again, want
            torch.cuda.empty_cache()

        # causality on the card, at both dtypes (bf16: the tensor-core forward):
        # the gradient of query row i is exactly zero on every key and value row
        # after i; keys and values after i never move o[i]
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).removeprefix("torch.")
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            o = fa.flash_causal_attention(qq, kk, vv, scale)
            for i in sorted({0, 63, 64, s // 2, s - 2, s - 1}):
                dq, dk, dv = torch.autograd.grad(o[:, i].sum(), (qq, kk, vv), retain_graph=True)
                if (dk[:, i + 1:].any() or dv[:, i + 1:].any() or dq[:, :i].any()
                        or dq[:, i + 1:].any()):
                    raise AssertionError(f"K8 {name} {key}: the gradient of row {i} reaches "
                                         "other rows than its past")
                if not dv[:, i].any():
                    raise AssertionError(f"K8 {name} {key}: row {i} does not see itself")
            cut = s // 2
            k2, v2 = k.clone(), v.clone()
            k2[:, cut + 1:] += 1.0
            v2[:, cut + 1:] -= 1.0
            with torch.no_grad():
                moved = fa.flash_causal_attention(q, k2, v2, scale)
                if not torch.equal(moved[:, :cut + 1], o.detach()[:, :cut + 1]):
                    raise AssertionError(f"K8 {name} {key}: a key or value after row {cut} "
                                         "moved it")
            print(f"K8 {name} {key}: causality on the card clean (gradients of 6 rows, a "
                  "forward impulse)")
            del qq, kk, vv, o, dq, dk, dv, moved

        # times at the train path's dtype (bf16), the whole N
        q, k, v, g = (t.to(torch.bfloat16) for t in (q32, k32, v32, g32))
        with torch.no_grad():
            # the forward and SDPA in turns, twice (warmed up at this shape)
            turns = [(cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, scale), 10, warmup=2),
                      cuda_ms(lambda: F.scaled_dot_product_attention(
                          q[:, None], k[:, None], v[:, None], is_causal=True, scale=scale),
                          10, warmup=2)) for _ in range(2)]
            ms_f = sum(t[0] for t in turns) / len(turns)
            lib_f = sum(t[1] for t in turns) / len(turns)
            o, lse = fa.flash_attention_fwd(q, k, v, scale)
            ms_b = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, g, scale), 10, warmup=2)
            pms_f = cuda_ms(lambda: fa.flash_causal_attention_plain(q, k, v, scale), 3)
            # the plain backward the kernel is held against, on the same o and
            # the plain lse (computed once, outside the timing)
            plse = fa.causal_lse_plain(q, k, scale)
            pms_b = cuda_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, plse, g, scale), 3)
            del plse
            # the fp32 route (CUDA cores) at the same shape
            o32, lse32 = fa.flash_attention_fwd(q32, k32, v32, scale)
            ms_b32 = cuda_ms(lambda: fa.flash_attention_bwd(q32, k32, v32, o32, lse32, g32, scale),
                             3, warmup=1)
            del o32, lse32

        def bwd_only(fn):  # the backward alone, on a graph built once
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            out = fn(qq, kk, vv)
            ms = cuda_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), g.view_as(out),
                                                     retain_graph=True), 3, warmup=1)
            del out
            return ms

        torch.cuda.empty_cache()
        lib_b = bwd_only(lambda a, b, c: F.scaled_dot_product_attention(
            a[:, None], b[:, None], c[:, None], is_causal=True, scale=scale))
        bf, byf, nbf, flf, nexp, tf = k8_bound(n, s, d, 2, False)
        bb, byb, nbb, flb, _, tb = k8_bound(n, s, d, 2, True)
        print(f"K8 {name} (N={n} S={s} D={d}) bf16, per call: forward {ms_f:.4f} ms (in turns "
              f"with SDPA: " + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in turns) + f"), plain "
              f"{pms_f:.3f} ms, SDPA {lib_f:.4f} ms ({ms_f / lib_f:.2f}x), bound {bf:.4f} ms "
              f"({byf}, {bound_of(tf)[2]}: {nbf} B, {flf} flop, {nexp} exp; {terms_text(tf)}); "
              f"backward {ms_b:.4f} ms (fp32 route {ms_b32:.4f} ms), plain "
              f"(flash_attention_bwd_plain) {pms_b:.3f} ms, SDPA {lib_b:.4f} ms "
              f"({ms_b / lib_b:.2f}x), bound {bb:.4f} ms ({byb}, "
              f"{bound_of(tb)[2]}: {nbb} B, {flb} flop, {nexp} exp; {terms_text(tb)}), the "
              f"two-pass design's own floor {2 * tb['exps']:.4f} ms (each exp twice) "
              f"[{ident}]")
        if name == "mid":  # the JSON line: per call at the mid PixelSNAIL's shape
            results["flash_attention_fwd"] = dict(max_abs_err=worst["fwd"], ms=ms_f,
                                                  plain_ms=pms_f, bound_ms=bf, bound_by=byf,
                                                  library_ms=lib_f)
            results["flash_attention_bwd"] = dict(max_abs_err=worst["bwd"], ms=ms_b,
                                                  plain_ms=pms_b, bound_ms=bb, bound_by=byb,
                                                  library_ms=lib_b)
        del q, k, v, g, o, lse, q32, k32, v32, g32
        torch.cuda.empty_cache()


def make_snail(fields, seed, device, dtype=None):
    """A seeded PixelSNAIL (fp32 unless ``dtype``), every Fixup zero init and
    every conv bias perturbed, as ``make_prior``."""
    import torch
    from vqvae3d_tpu_torch.models.causal_blocks import SCALARS, PreActFixupCausalResBlock
    from vqvae3d_tpu_torch.models.pixelsnail import PixelSNAIL, PixelSNAILConfig

    gen = torch.Generator().manual_seed(seed)
    model = PixelSNAIL(PixelSNAILConfig(**fields, dtype=dtype or torch.float32), generator=gen)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.endswith(".bias"):
                prm.copy_(torch.randn(prm.shape, generator=gen) * 0.05)
        for m in model.modules():
            if isinstance(m, PreActFixupCausalResBlock):
                for stream in ("depth_conv", "height_conv", "width_conv"):
                    w = getattr(m.branch_conv3, stream).weight
                    w.copy_(torch.randn(w.shape, generator=gen) * 0.3 * w.shape[1] ** -0.5)
                for n in SCALARS:
                    getattr(m, f"bias{n}").copy_(torch.randn(1, generator=gen) * 0.05)
                m.scale.copy_(1.0 + torch.randn(1, generator=gen) * 0.05)
    return model.to(device)


def snail_batch(cfg, seed, device):
    import torch

    rng = np.random.default_rng(seed)
    return {"data": torch.from_numpy(rng.integers(0, cfg["fields"]["input_dim"],
                                                  (cfg["batch"], *cfg["grid"]),
                                                  dtype=np.int32)).to(device)}


def snail_step_checks(ident, seed, results, name, cfg, batch, launches, kernels,
                      tols=(STEP_LOSS_TOL, STEP_GRAD_TOL), parent=None, plain_once=False):
    """One PixelSNAIL train step at ``cfg`` on ``batch``: fp32 loss and
    gradients, kernel path vs plain path (one generator state for both, so
    the same dropout masks, attention seeds and mixup); the bf16 step's
    launches (``launches``: kernel -> count, every other kernel 0), ms/step
    and peak memory of both paths; two identical bf16 steps bit-identical;
    one profiled step, its device time split by ``kernels`` (label -> CUDA
    kernel name parts), and the host's idle share. ``tols``: the fp32
    step's (loss, gradient) tolerances, relative. With ``parent`` (a context
    that runs the parent's kernels of the step): those kernels' ms/step in
    turns with the kernel path's, a second profiled step on them, and each
    profile's ``kernels`` split by kernel name and its host side (the ten
    costliest host operations, the kernel launches a step). ``plain_once``:
    the plain path's step is run once after the turns, not timed in them."""
    import torch
    from vqvae3d_tpu_torch.train import prior_train
    from vqvae3d_tpu_torch.train.state import AMSGrad

    dev = torch.device("cuda")
    f = cfg["fields"]
    desc = (f"PixelSNAIL {name} ({f['num_blocks']}x{f['num_layers_per_block']}x"
            f"{f['model_dim']}d, {cfg['grid']}, batch {cfg['batch']}"
            + (f", conditioned on {cfg['cond']} of {f['condition_dim']}"
               if f.get("condition_dim") else "")
            + f", attention dropout {f['attention_dropout_prob']})")

    # --- fp32: one step's loss and gradients, kernel path vs plain path
    model = make_snail(f, seed + 81, dev)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        gen = prior_train.step_generator(seed, 0, dev)
        loss, _ = prior_train.prior_loss_fn(model, batch, train=True, generator=gen)
        loss.backward()
        return float(loss.detach()), {n: q.grad.clone() for n, q in model.named_parameters()}

    reset_counts()
    loss_k, grads_k = loss_and_grads()
    got = launch_counts()
    with plain_path():
        loss_p, grads_p = loss_and_grads()
    torch.cuda.synchronize()
    if any(got[k] != v for k, v in launches.items()):
        raise AssertionError(f"{desc}: launches {got}, expected {launches}")
    gmax = max(float(g.abs().max()) for g in grads_p.values())
    grad_err = {n: float((grads_k[n] - grads_p[n]).abs().max())
                / max(float(grads_p[n].abs().max()), 1e-3 * gmax) for n in grads_p}
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:3]
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    print(f"fp32 {desc} train step: loss kernel {loss_k:.7g} plain {loss_p:.7g} (rel "
          f"{loss_err:.2e}); gradients of {len(grads_p)} tensors, worst max|d| over "
          f"max(max|ref|, 1e-3 max grad): " + ", ".join(f"{n} {e:.2e}" for n, e in worst)
          + f" [{ident}]")
    if loss_err > tols[0] or worst[0][1] > tols[1] or not np.isfinite(loss_k):
        raise AssertionError(f"fp32 {desc}: the kernel path disagrees with the plain path")
    results[f"snail_{name}_fp32"] = dict(loss_rel=loss_err, grad_worst=worst[0][1])
    del model, grads_k, grads_p
    torch.cuda.empty_cache()

    # --- bf16: launches per step, ms/step and peak memory per path
    model = make_snail(f, seed + 81, dev, dtype=torch.bfloat16)
    opt = AMSGrad(model.parameters(), lr=cfg["lr"])
    step = prior_train.make_prior_train_step(model, opt, seed=seed)
    reset_counts()
    log = step(batch)
    torch.cuda.synchronize()
    got = launch_counts()
    want = dict(dict.fromkeys(got, 0), **launches)
    print(f"bf16 {desc} train step launches {got}, {f['num_blocks']} attention blocks imply "
          f"{want} (loss {float(log['loss_mean']):.5g}) [{ident}]")
    if got != want or not np.isfinite(float(log["loss_mean"])):
        raise AssertionError(f"{desc}: launches {got} != {want} or a non-finite loss")
    timing = {}
    paths = ("kernel", "plain", "kernel", "plain")
    if parent is not None:
        paths = ("kernel", "parent", "plain", "parent", "kernel", "plain")
    if plain_once:  # the plain path's one step, after the timed turns
        paths = tuple(p for p in paths if p != "plain") + ("plain",)
    for path in paths:
        ctx = {"plain": plain_path, "parent": parent}.get(path, contextlib.nullcontext)()
        once = plain_once and path == "plain"
        with ctx:
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step(batch), iters=1 if once else 3, warmup=0 if once else 1)
            peak = torch.cuda.max_memory_allocated() / 2**30
        timing.setdefault(path, []).append((ms, peak))
        print(f"bf16 {desc} train step, {path} path: {ms:.2f} ms/step ("
              + ("one step, no warm-up" if once else "mean of 3 after 1 warm-up")
              + f") peak {peak:.2f} GiB [{ident}]")
    results[f"snail_{name}_bf16"] = timing

    # --- two identical steps from one state: bit-identical parameters
    torch.backends.cudnn.deterministic = True
    snap = ({k: v.clone() for k, v in model.state_dict().items()},
            {k: v.clone() if torch.is_tensor(v) else v for k, v in opt.state_dict().items()})
    outs = []
    for _ in range(2):
        model.load_state_dict(snap[0])
        opt.load_state_dict(snap[1])
        step(batch)
        outs.append({k: v.clone() for k, v in model.state_dict().items()})
    torch.backends.cudnn.deterministic = False
    differ = [k for k in outs[0] if not torch.equal(outs[0][k], outs[1][k])]
    print(f"two identical bf16 {desc} steps from one state: {len(outs[0]) - len(differ)} of "
          f"{len(outs[0])} parameters bit-identical (cuDNN deterministic) [{ident}]")
    if differ:
        raise AssertionError(f"not bit-identical: {differ[:5]}")
    del outs, snap

    # --- where the time goes: one kernel-path step under the profiler (and
    # one on the parent's kernels)
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for path in ("kernel",) + (("parent",) if parent is not None else ()):
        with (parent() if path == "parent" else contextlib.nullcontext()):
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=act) as prof:
                step(batch)
                torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        events = prof.key_averages()
        cuda_rows = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in cuda_rows) / 1e3
        split = {what: sum(e.self_device_time_total for e in cuda_rows if any(
            k in e.key for k in keys)) / 1e3 for what, keys in kernels.items()}
        print(f"profile of one bf16 {path}-path {desc} step: device busy {busy:.1f} ms of "
              f"{wall:.1f} ms wall under the profiler (device idle "
              f"{100 * (1 - busy / wall):.1f} %); " + ", ".join(
                  f"{k} {v:.2f} ms" for k, v in split.items())
              + f" ({100 * sum(split.values()) / busy:.1f} % of busy), the rest "
              f"{busy - sum(split.values()):.1f} ms [{ident}]")
        if parent is None:
            print(events.table(sort_by="self_device_time_total", row_limit=20,
                               max_name_column_width=70))
        else:
            by_kernel = {kernel_name(e.key): e.self_device_time_total / 1e3 for e in cuda_rows
                         if any(k in e.key for keys in kernels.values() for k in keys)}
            host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                          key=lambda e: -e.self_cpu_time_total)[:10]
            launched = sum(e.count for e in cuda_rows if not e.key.startswith(("Memcpy", "Memset")))
            print(f"  {path} path by kernel (ms a step): " + ", ".join(
                f"{k} {v:.3f}" for k, v in by_kernel.items()) + f"; {launched} kernels a step; "
                "the ten costliest host operations (self CPU ms, calls): " + ", ".join(
                    f"{e.key} {e.self_cpu_time_total / 1e3:.2f} ({e.count})" for e in host))
        results[f"snail_{name}_profile" + ("_parent" if path == "parent" else "")] = dict(
            busy_ms=busy, wall_ms=wall, **split)
    del model, opt
    torch.cuda.empty_cache()


def phase_snail_steps(ident, seed, results):
    import torch

    dev = torch.device("cuda")
    for name, cfg in SNAIL.items():
        nb = cfg["fields"]["num_blocks"]
        snail_step_checks(
            ident, seed, results, name, cfg, snail_batch(cfg, seed + 80, dev),
            dict(flash_attention_fwd=nb, flash_attention_bwd=nb),
            {"K8 forward": ("flash_fwd",), "K8 backward": ("bwd_delta", "bwd_dkdv", "bwd_dq")},
            plain_once=True)


def phase_snail_cli(ident, counts, seed, work: Path):
    import torch
    from vqvae3d_tpu_torch.checkpoint import load_prior
    from vqvae3d_tpu_torch.cli import train_prior
    from vqvae3d_tpu_torch.data.code_store import CodeStoreWriter
    from vqvae3d_tpu_torch.models.pixelsnail import PixelSNAIL

    rng = np.random.default_rng(seed + 90)
    t0 = time.perf_counter()
    store = work / "snail_codes"
    mid, bottom = SNAIL["mid"], SNAIL["bottom"]
    w = CodeStoreWriter(str(store), 2, [mid["fields"]["input_dim"],
                                        bottom["fields"]["input_dim"]], backend="file")
    n = 128  # the 95 % split leaves 7 validation grids: a whole batch of 6
    for i in range(n):
        w.write_sample(i, [rng.integers(0, mid["fields"]["input_dim"], mid["grid"], dtype=np.int32),
                           rng.integers(0, bottom["fields"]["input_dim"], bottom["grid"],
                                        dtype=np.int32)])
    w.close()
    print(f"PixelSNAIL CLI set-up: a code store of {n} samples {mid['grid']} / {bottom['grid']} "
          f"in {time.perf_counter() - t0:.1f} s")
    total = {}
    for name, cfg in (("bottom", bottom), ("mid", mid)):
        f = cfg["fields"]
        ckpt = work / f"snail_{name}"
        flags = [str(store), str(cfg["level"]), "--use-model", "pixelsnail",
                 "--model-dim", str(f["model_dim"]), "--num-blocks", str(f["num_blocks"]),
                 "--num-layers-per-block", str(f["num_layers_per_block"]),
                 "--causal-dropout-prob", str(f["causal_dropout_prob"]),
                 "--attention-dropout-prob", "0.0", "--mixup-alpha", str(f["mixup_alpha"]),
                 "--use-conditioning", "False", "--batch-size", str(cfg["batch"]),
                 "--lr", str(cfg["lr"]), "--val-every-steps", "3", "--log-every-n-steps", "1",
                 "--ckpt-dir", str(ckpt), "--device", "cuda", "--seed", str(seed)]
        val_batches = (n - int(n * 0.95)) // cfg["batch"]
        nb = f["num_blocks"]
        for run, extra, steps in [("train", ["--max-steps", "3"], 3),
                                  ("resume", ["--max-steps", "4", "--resume"], 1)]:
            reset_counts()
            t0 = time.perf_counter()
            model, opt, step = train_prior.main(train_prior.parse_arguments(flags + extra))
            torch.cuda.synchronize()
            got = launch_counts()
            # every train step, and one validation pass, at the end
            want = dict(dict.fromkeys(got, 0), flash_attention_fwd=nb * (steps + val_batches),
                        flash_attention_bwd=nb * steps)
            print(f"train_prior --use-model pixelsnail ({name}) {run}: {steps} step(s) to step "
                  f"{step} in {time.perf_counter() - t0:.1f} s (host clock, data and checkpoints "
                  f"included); launches {got}; implied {want} [{ident}]")
            if (step != {"train": 3, "resume": 4}[run] or opt.count != step or got != want
                    or not isinstance(model, PixelSNAIL)):
                raise AssertionError(f"{name} {run}: step {step}, optimizer count {opt.count}, "
                                     f"launches {got} != {want}")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
            del model, opt
        logs = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
        losses = [r["train_loss_mean"] for r in logs if "train_loss_mean" in r]
        val = [r["val_loss_mean"] for r in logs if "val_loss_mean" in r]
        loaded, lcfg = load_prior(ckpt)
        print(f"{name}: train losses by step {losses}; val losses {val}; load_prior gives a "
              f"{type(loaded).__name__} ({lcfg.num_blocks} blocks, {lcfg.dtype})")
        if (len(losses) != 4 or len(val) != 2 or not np.all(np.isfinite(losses + val))
                or not isinstance(loaded, PixelSNAIL)):
            raise AssertionError(f"PixelSNAIL {name} CLI: losses missing or not finite")
        del loaded
        torch.cuda.empty_cache()
    for k, v in total.items():
        counts[k] = counts.get(k, 0) + v


def phase_wide_k6_kernels(ident, results, seed):
    import torch
    from vqvae3d_tpu_torch.ops import _build, decode_row
    from vqvae3d_tpu_torch.sample.ar_sample import draw_gumbel
    from vqvae3d_tpu_torch.sample.cached_sample import _extract_layers

    dev = torch.device("cuda")
    # the latency of an exchange between the CTAs: a cluster of the kernel's
    # size passing cluster barriers, or the kernel's st.async exchanges (a
    # float from every CTA into every CTA, waited on an mbarrier), and nothing
    # else (the difference of two counts: no launch cost)
    lib, stream = _build.library(), _build.stream_ptr(dev)
    n = decode_row.WIDE_CLUSTER
    exchange_ms = {}
    for kind, mode in (("barrier", 0), ("st.async", 1)):
        t1, t2 = (cuda_ms(lambda: _build.check(
            lib.vq_cluster_exchange_probe(mode, it, stream), "cluster_exchange_probe"), 5,
            warmup=2) for it in (2000, 4000))
        exchange_ms[kind] = (t2 - t1) / 2000
    print(f"exchange latency at a cluster of {n} CTAs: " + ", ".join(
        f"{kind} {1e3 * v:.3f} us" for kind, v in exchange_ms.items()) + f" [{ident}]")
    for i, (name, f, b, s2) in enumerate(WIDE_ROWS):
        model = make_prior(f, seed + 100 + i, dev)
        st = decode_row.stack_row_weights(_extract_layers(model), model.parse_input.weight,
                                          model.parse_input.bias, model.parse_output.weight,
                                          model.parse_output.bias)
        L, c, br = st["w1"].shape
        k = f["input_dim"]
        cond = f["condition_dim"] > 0
        assert decode_row.uses_wide_kernel(c, br, k, s2)
        gen = torch.Generator(dev).manual_seed(seed + 110 + i)
        d2h, d2w, cnd, vhc0 = (torch.randn(L, b, s2, br, device=dev, generator=gen) * 0.5
                               for _ in range(4))
        cnd = cnd if cond else None
        dfin, sprev = (torch.randn(b, s2, c, device=dev, generator=gen) * 0.5 for _ in range(2))
        gum = draw_gumbel((s2, b, k), gen, dev)
        forced = torch.randint(0, k, (b, s2), device=dev, generator=gen)
        args = (st, d2h, d2w, cnd, dfin, sprev)
        vk, vp = vhc0.clone(), vhc0.clone()
        before = decode_row.row_decode.wide_launches
        _, _, lk = decode_row.row_decode(*args, vk, gum, 5, TOP_TAU, forced_idx=forced)
        calls = decode_row.row_decode.wide_launches - before
        _, _, lp = decode_row.row_decode_plain(*args, vp, gum, 5, TOP_TAU, forced_idx=forced)
        errs = {}
        for what, got, want in (("logits", lk, lp), ("caches", vk, vp)):
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            errs[what] = err
            if not err <= K6_TOL * scale or not torch.isfinite(got).all():
                raise AssertionError(f"wide K6 {name}, teacher-forced {what}: max|d|={err:.3g} "
                                     f"> {K6_TOL} x {scale:.3g}")
        free, v1 = decode_row.row_decode(*args, vhc0.clone(), gum, 5, TOP_TAU)
        again, v2 = decode_row.row_decode(*args, vhc0.clone(), gum, 5, TOP_TAU)
        if not (torch.equal(free, again) and torch.equal(v1, v2)):
            raise AssertionError(f"wide K6 {name}: two identical calls differ")
        _, _, lpath = decode_row.row_decode_plain(*args, vhc0.clone(), gum, 5, TOP_TAU,
                                                  forced_idx=free)
        ties, beyond = decode_row.sampling_disagreements(lpath, gum, TOP_TAU, free)
        if beyond:
            raise AssertionError(f"wide K6 {name}: {beyond} sampled indices disagree beyond a tie")
        bad = dict(st, b_out=st["b_out"].clone())
        bad["b_out"][k - 1] = float("nan")  # the last CTA's columns
        nan_idx, _ = decode_row.row_decode(bad, *args[1:], vhc0.clone(), gum, 5, TOP_TAU)
        if not bool((nan_idx == -1).all()):
            raise AssertionError(f"wide K6 {name}: a non-finite logit did not give -1")
        vk = vhc0.clone()
        ms = cuda_ms(lambda: decode_row.row_decode(*args, vk, gum, 5, TOP_TAU), 10, warmup=2)
        pms = cuda_ms(lambda: decode_row.row_decode_plain(*args, vk, gum, 5, TOP_TAU), 2)
        weights, row_bytes, flops = k6_cost(st, b, s2, k, cond)
        rows = {8: 32 * 32, 2: 8 * 8}[s2]  # the rows of the level's grid (mid, bottom)
        bms, by = bound_ms(weights + row_bytes, flops, FP32_FLOPS)
        gbms, gby = bound_ms(weights + rows * row_bytes, rows * flops, FP32_FLOPS)
        # the design's own floor: its exchanges in sequence, three a layer-step of
        # the voxel chain (the height-row step has none)
        floor = s2 * L * 3 * exchange_ms["st.async"]
        print(f"wide K6 row_decode {name} (L={L} C={c} br={br} K={k} s2={s2} B={b}, "
              f"{'conditioned' if cond else 'unconditioned'}; {calls} kernel call(s) a row: "
              f"sub-batches {decode_row.wide_row_batches(L, b, s2, -(-c // 4) * 4, -(-br // 4) * 4, k)}"
              f"): teacher-forced max|d| logits "
              f"{errs['logits']:.3g} (max|ref| {float(lp.abs().max()):.3g}), caches "
              f"{errs['caches']:.3g}; free-running near ties {ties}, beyond {beyond}; a second "
              f"call bit-identical; a NaN logit gives -1; per row at a cluster of {n} CTAs: "
              f"kernel {ms:.4f} ms (mean of 10), plain {pms:.2f} ms (mean of 2), bound "
              f"{bms:.5f} ms ({by}: {weights} B of weights, {row_bytes} B of the row, {flops} "
              f"flops), exchange floor {floor:.4f} ms ({s2} x {L} layer-steps x 3 exchanges x "
              f"{1e3 * exchange_ms['st.async']:.3f} us); per grid of {rows} rows: bound "
              f"{gbms:.4f} ms ({gby}) [{ident}]")
        if name == "mid":  # the JSON line, per row of the mid grid
            results["row_decode_wide"] = dict(max_abs_err=errs["logits"], plain_ms=pms,
                                              bound_ms=bms, bound_by=by, library_ms=None)
        del model, st
        torch.cuda.empty_cache()


def phase_wide_sample_main_path(ident, counts, results, seed, work: Path):
    import torch
    from vqvae3d_tpu_torch.checkpoint import save_prior
    from vqvae3d_tpu_torch.cli import sample_embeddings
    from vqvae3d_tpu_torch.data.sample_db import add_samples, create_or_load_db, save_db
    from vqvae3d_tpu_torch.models.prior_utils import idx_to_one_hot
    from vqvae3d_tpu_torch.ops import decode_row
    from vqvae3d_tpu_torch.sample.cached_sample import _extract_layers, cached_ancestral_sample

    dev = torch.device("cuda")
    for i, (name, cfg, b) in enumerate(WIDE_SAMPLING):
        f, grid, level = cfg["fields"], cfg["grid"], cfg["level"]
        model = make_prior(f, seed + 120 + i, "cpu")
        st = decode_row.stack_row_weights(_extract_layers(model), model.parse_input.weight,
                                          model.parse_input.bias, model.parse_output.weight,
                                          model.parse_output.bias)
        (L, c, br), k = st["w1"].shape, f["input_dim"]
        calls = len(decode_row.wide_row_batches(L, b, grid[2], c, br, k))
        slug = name.replace(" --batch-size ", "_b")
        del st
        save_prior(work / f"prior_{slug}", model)
        db_path = work / f"samples_{slug}.db"
        pool = None
        if cfg["cond"] is not None:  # two grids of the next-coarser level to condition on
            db = create_or_load_db(db_path, level + 1)
            rng = np.random.default_rng(seed + 121 + i)
            pool = add_samples(db, level + 1, rng.integers(0, f["condition_dim"],
                                                           (2, *cfg["cond"])).astype(np.int32),
                               None)
            save_db(db, db_path, level + 1)
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            start.record()
            new = sample_embeddings.main(sample_embeddings.parse_arguments([
                "--model-checkpoint", str(work / f"prior_{slug}"), "--db-path", str(db_path),
                "--level", str(level), "--size", *map(str, grid), "--num-samples", str(b),
                "--batch-size", str(b), "--tau", str(TOP_TAU), "--sampler", "cached",
                "--seed", str(seed), "--device", "cuda"]))
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = launch_counts()
        events = device_events(prof)
        k6_rows = [ms for name, ms in events if "row_decode_wide" in name]
        k6_ms, k6_n = sum(k6_rows), len(k6_rows)
        busy = sum(ms for _, ms in events)
        rows = grid[0] * grid[1]
        want = dict(dict.fromkeys(got, 0), row_decode_wide=rows * calls)
        db = create_or_load_db(db_path, level)
        grids = np.stack([np.asarray(db[level][u]["data"]) for u in new])
        print(f"sample_embeddings {slug} --level {level} --size {grid} --num-samples {b} "
              f"--batch-size {b} --tau {TOP_TAU}: {wall:.2f} s wall (host clock, under the "
              f"device-only profiler), {start.elapsed_time(end) / 1e3:.2f} s between CUDA events; "
              f"wide K6 device time {k6_ms:.1f} ms over {k6_n} kernels "
              f"({k6_ms / max(k6_n, 1):.4f} ms a kernel, {calls} a row: "
              f"{k6_ms * calls / max(k6_n, 1):.4f} ms a row), {100 * k6_ms / busy:.1f} % of the device's "
              f"busy {busy:.1f} ms and {100 * k6_ms / (1e3 * wall):.1f} % of the wall; launches "
              f"{got}, the grid implies {want}; "
              f"grids {grids.shape} codes {grids.min()}..{grids.max()}, "
              f"{len(np.unique(grids))} distinct [{ident}]")
        # the wrappers' counts are the launch check; the profiler only times
        # (it may miss a record: 1023 of 1024 on one run)
        if got != want or not k6_n:
            raise AssertionError(f"{name} sampling launches {got} != {want} (kernels "
                                 f"profiled: {k6_n})")
        if (len(new) != b or grids.shape != (b, *grid) or grids.min() < 0
                or grids.max() >= f["input_dim"]
                or (pool is not None and any(db[level][u]["condition"] not in pool
                                             for u in new))):
            raise AssertionError(f"{name}: the sampled grids or their conditions are wrong")
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        if name == "mid":  # the JSON line: per row, the main path's mean
            results["row_decode_wide"]["ms"] = k6_ms / k6_n
        results[f"wide_sample_{slug}_s"] = wall

        # exactness at full width: teacher-forced cached logits vs the one-shot forward
        model = model.to(dev)
        gen = torch.Generator(dev).manual_seed(seed + 122 + i)
        forced = torch.randint(0, f["input_dim"], (b, *grid), device=dev, generator=gen)
        cond = None
        if cfg["cond"] is not None:
            cond = torch.from_numpy(np.stack([np.asarray(db[level + 1][pool[j % 2]]["data"])
                                              for j in range(b)]).astype(np.int64))
        t0 = time.perf_counter()
        _, logits = cached_ancestral_sample(model, grid, b, cond, TOP_TAU, forced=forced)
        torch.cuda.synchronize()
        t_forced = time.perf_counter() - t0
        with torch.inference_mode():
            ref = model(idx_to_one_hot(forced, f["input_dim"]),
                        None if cond is None else idx_to_one_hot(cond.to(dev), f["condition_dim"]))
        err, scale = float((logits - ref).abs().max()), float(ref.abs().max())
        print(f"exactness {name}, {b} full grids {grid}: teacher-forced cached sampler (wide K6 "
              f"per row, {t_forced:.2f} s) vs one-shot PixelCNN.forward: max|d| logits {err:.3g}, "
              f"max|ref| {scale:.3g} (tolerance {FORWARD_TOL} x max|ref|) [{ident}]")
        if not err <= FORWARD_TOL * scale or not torch.isfinite(logits).all():
            raise AssertionError(f"{name}: cached logits disagree with the one-shot forward")
        del model, logits, ref
        torch.cuda.empty_cache()


def k5_bound(n, s, d, itemsize, backward: bool):
    """(ms, what bounds it, bytes, flops, exps, integer ops, the terms'
    times) of one K5 call on (N, S, D) at p > 0: K8's bytes, products and
    exps (``k8_bound``), and the mask once a causal logit: a Philox-10 per
    row and group of 4 keys (10 rounds of two 32x32 products and two 3-way
    xors, 40 integer operations) and a compare a logit, at the int32 rate;
    the largest of the four times."""
    _, _, nbytes, flops, logits, _ = k8_bound(n, s, d, itemsize, backward)
    ints = 40 * n * sum(i // 4 + 1 for i in range(s)) + logits
    terms = attention_terms(nbytes, flops, itemsize, logits, ints)
    ms, by, _ = bound_of(terms)
    return ms, by, nbytes, flops, logits, ints, terms


def phase_dropout_attention_kernels(ident, results, seed):
    import torch
    from vqvae3d_tpu_torch.ops import flash_attention as fa
    from vqvae3d_tpu_torch.ops import flash_dropout_attention as fd

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 100)
    kseed = fd.draw_seed(torch.Generator(dev).manual_seed(seed + 101))
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, (n, s, d) in K5_SHAPES.items():
        scale = d ** -0.5
        q32, k32, v32, g32 = (torch.randn(n, s, d, generator=gen).to(dev) for _ in range(4))
        # the plain version on the whole N at the ragged shape, on the first
        # stream's 8 heads at the mid one (every row of each)
        rows = n if s <= 2048 else 8
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).removeprefix("torch.")
            q, k, v, g = (t.to(dtype) for t in (q32, k32, v32, g32))

            def run(fn, nr, p=K5_P):
                qq, kk, vv = (t[:nr].clone().requires_grad_() for t in (q, k, v))
                o = fn(qq, kk, vv, scale, p, kseed)
                return (o.detach(), *torch.autograd.grad(o, (qq, kk, vv), g[:nr]))

            got = run(fd.flash_causal_dropout_attention, n)
            again = run(fd.flash_causal_dropout_attention, n)
            want = run(fd.flash_causal_dropout_attention_plain, rows)
            rel = []
            for tname, a, b, r in zip(("o", "dq", "dk", "dv"), got, again, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"K5 {name} {key} {tname}: a second call differs")
                err = float((a[:rows].float() - r.float()).abs().max())
                scale_ = float(r.float().abs().max())
                tol = K5_TOL[key][0 if tname == "o" else 1]
                rel.append(f"{tname} {err:.3g} (max|ref| {scale_:.3g})")
                if not err <= tol * scale_ or not torch.isfinite(a).all():
                    raise AssertionError(f"K5 {name} {key} {tname}: max|d|={err:.3g} > "
                                         f"{tol} x {scale_:.3g}")
                if key == "bfloat16":  # the dtype of the times in the JSON line
                    w = "fwd" if tname == "o" else "bwd"
                    worst[w] = max(worst[w], err)
            # p = 0: K8's function (K5 multiplies by 1 / (1 - p) = 1 where K8's
            # compiler may fuse the scaling into the exponent's FMA, so the
            # two round apart; K8's tolerance)
            zero = run(lambda a, b, c, sc, p, _: fd.flash_causal_dropout_attention(a, b, c, sc, p),
                       n, 0.0)
            k8 = run(lambda a, b, c, sc, p, _: fa.flash_causal_attention(a, b, c, sc), n, 0.0)
            vs_k8 = [float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())
                     for a, b in zip(zero, k8)]
            if max(vs_k8) > K8_TOL[key]:
                raise AssertionError(f"K5 {name} {key}: at p = 0 it differs from K8: {vs_k8}")
            print(f"K5 {name} (N={n} S={s} D={d}, p={K5_P}) {key}, plain on {rows} of {n} "
                  f"rows: max|d| " + ", ".join(rel) + "; a second call bit-identical; at "
                  f"p = 0 vs K8 max|d| / max|K8| (o, dq, dk, dv) "
                  + ", ".join(f"{e:.2e}" for e in vs_k8) + f" [{ident}]")
            del got, again, want, zero, k8
            torch.cuda.empty_cache()

        # each route's own mask against the plain Philox mask, bit for bit: the
        # forward's collected mask on both routes (1 past the row), and the
        # packed bits that the bf16 backward's query-major pass writes and its
        # key-major pass reads (the causal logits)
        def forward_mask(dtype):
            with torch.no_grad():
                return fd.flash_causal_dropout_attention(
                    *(t.to(dtype) for t in (q32, k32, v32)), scale, K5_P, kseed,
                    collect_mask=True)[1]

        def backward_bits():
            qb, kb, vb, gb = (t.to(torch.bfloat16) for t in (q32, k32, v32, g32))
            with torch.no_grad():
                o, lse = fd.flash_dropout_attention_fwd(qb, kb, vb, kseed, scale, K5_P)
                bits = fd.flash_dropout_attention_bwd(qb, kb, vb, o, lse, gb, kseed, scale,
                                                      K5_P, keep_bits=True)[3]
                return fd.unpack_tile_bits(bits, s)

        for label, make, causal_only in (
                ("fp32 forward (CUDA cores)", lambda: forward_mask(torch.float32), False),
                ("bf16 forward (tensor cores)", lambda: forward_mask(torch.bfloat16), False),
                ("bf16 backward's packed tiles", backward_bits, True)):
            mask = make()
            bad = kept = 0
            for i0 in range(0, s, 512):
                r = torch.arange(i0, min(i0 + 512, s), device=dev)
                future = torch.arange(s, device=dev)[None] > r[:, None]
                m = mask[:, i0:i0 + len(r)].bool()
                differ = m != (fd.keep_mask(kseed, n, r, s, K5_P) | future)
                bad += int((differ & ~future).sum() if causal_only else differ.sum())
                kept += int((m & ~future).sum())
            frac = kept / (n * s * (s + 1) / 2)
            print(f"K5 {name}: the {label} mask (N={n}, S={s}) differs from the plain Philox "
                  f"mask at {bad} logits; kept fraction of the causal logits {frac:.6f} "
                  f"(p = {K5_P})")
            if bad or abs(frac - (1 - K5_P)) > 0.01:
                raise AssertionError(f"K5 {name}: the {label} mask is not the plain mask")
            del mask
            torch.cuda.empty_cache()

        # times at the train path's dtype (bf16), the whole N: the tensor-core
        # route and the parent's CUDA-core kernels in turns, each split by kernel
        q, k, v, g = (t.to(torch.bfloat16) for t in (q32, k32, v32, g32))
        turns, split = [], {}
        for parent in (False, True, True, False):
            with parent_routes(k5=parent), torch.no_grad():
                fwd = lambda: fd.flash_dropout_attention_fwd(q, k, v, kseed, scale, K5_P)
                t_f = cuda_ms(fwd, 10, warmup=3)
                o, lse = fwd()
                bwd = lambda: fd.flash_dropout_attention_bwd(q, k, v, o, lse, g, kseed, scale,
                                                             K5_P)
                turns.append((t_f, cuda_ms(bwd, 10, warmup=3)))
                if parent not in split:  # a kernel's largest of three profiles: the
                    # profiler has been seen to drop some launches' records
                    runs = [{**device_ms_by_name(fwd, 5), **device_ms_by_name(bwd, 5)}
                            for _ in range(3)]
                    split[parent] = {key: max(r.get(key, 0.0) for r in runs)
                                     for key in sorted(set().union(*runs))}
        ms_f, ms_b = (turns[0][0] + turns[3][0]) / 2, (turns[0][1] + turns[3][1]) / 2
        with torch.no_grad():  # the new route without the mask: what the mask adds
            z_f = cuda_ms(lambda: fd.flash_dropout_attention_fwd(q, k, v, kseed, scale, 0.0), 10,
                          warmup=3)
            z_o, z_lse = fd.flash_dropout_attention_fwd(q, k, v, kseed, scale, 0.0)
            z_b = cuda_ms(lambda: fd.flash_dropout_attention_bwd(q, k, v, z_o, z_lse, g, kseed,
                                                                 scale, 0.0), 10, warmup=3)
            del z_o, z_lse
            k8_f = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, scale), 10, warmup=3)
            o8, lse8 = fa.flash_attention_fwd(q, k, v, scale)
            k8_b = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o8, lse8, g, scale), 10,
                           warmup=3)
            pms_f = cuda_ms(lambda: fd.flash_causal_dropout_attention_plain(
                q, k, v, scale, K5_P, kseed), 3)
        for parent, label, own in ((False, "tensor cores", (turns[0], turns[3])),
                                   (True, "the parent's CUDA-core kernels", turns[1:3])):
            print(f"K5 {name} bf16 on {label}, per call in turns (new, parent, parent, new): "
                  f"forward {', '.join(f'{t[0]:.4f}' for t in own)} ms, backward "
                  f"{', '.join(f'{t[1]:.4f}' for t in own)} ms; device ms a call by kernel: "
                  + ", ".join(f"{kernel_name(key)} {t:.4f}" for key, t in split[parent].items())
                  + f" [{ident}]")
        print(f"K5 {name} bf16 on tensor cores at p = 0 (no Philox call): forward {z_f:.4f} ms, "
              f"backward {z_b:.4f} ms; the mask adds {ms_f - z_f:.4f} / {ms_b - z_b:.4f} ms "
              f"[{ident}]")
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out = fd.flash_causal_dropout_attention_plain(qq, kk, vv, scale, K5_P, kseed)
        pms_b = cuda_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), g, retain_graph=True), 3)
        del out, qq, kk, vv
        bf, byf, nbf, flf, nexp, intf, tf = k5_bound(n, s, d, 2, False)
        bb, byb, nbb, flb, _, intb, tb = k5_bound(n, s, d, 2, True)
        print(f"K5 {name} (N={n} S={s} D={d}, p={K5_P}) bf16, per call: forward {ms_f:.4f} ms "
              f"(K8 {k8_f:.4f}), plain {pms_f:.3f} ms, bound {bf:.4f} ms ({byf}, "
              f"{bound_of(tf)[2]}: {nbf} B, {flf} flop, {nexp} exp, {intf} int32 op; "
              f"{terms_text(tf)}); backward {ms_b:.4f} ms (K8 {k8_b:.4f}), plain {pms_b:.3f} "
              f"ms, bound {bb:.4f} ms ({byb}, {bound_of(tb)[2]}: {nbb} B, {flb} flop, {nexp} "
              f"exp, {intb} int32 op; {terms_text(tb)}); library: none (SDPA's dropout_p "
              f"drops softmax weights after the softmax, another function) [{ident}]")
        if name == "mid":  # the JSON line: per call at the mid PixelSNAIL's shape
            results["flash_dropout_attention_fwd"] = dict(
                max_abs_err=worst["fwd"], ms=ms_f, plain_ms=pms_f, bound_ms=bf, bound_by=byf,
                library_ms=None)
            results["flash_dropout_attention_bwd"] = dict(
                max_abs_err=worst["bwd"], ms=ms_b, plain_ms=pms_b, bound_ms=bb, bound_by=byb,
                library_ms=None)
        del q, k, v, g, o, lse, o8, lse8, q32, k32, v32, g32
        torch.cuda.empty_cache()


def dropout_snail_batch(seed, device):
    import torch

    cfg, rng = SNAIL_DROPOUT, np.random.default_rng(seed)
    f = cfg["fields"]
    return {"data": torch.from_numpy(rng.integers(0, f["input_dim"], (cfg["batch"], *cfg["grid"]),
                                                  dtype=np.int32)).to(device),
            "condition": torch.from_numpy(rng.integers(
                0, f["condition_dim"], (cfg["batch"], *cfg["cond"]), dtype=np.int32)).to(device)}


def phase_dropout_snail_step(ident, seed, results):
    import torch

    nb = SNAIL_DROPOUT["fields"]["num_blocks"]
    snail_step_checks(
        ident, seed, results, "mid_dropout", SNAIL_DROPOUT,
        dropout_snail_batch(seed + 110, torch.device("cuda")),
        dict(flash_dropout_attention_fwd=nb, flash_dropout_attention_bwd=nb),
        {"K5 forward": ("flash_dropout_fwd",),
         "K5 backward": ("drop_delta", "drop_dkdv", "drop_dq")}, tols=DROPOUT_STEP_TOL,
        parent=functools.partial(parent_routes, k5=True), plain_once=True)


def phase_dropout_snail_cli(ident, counts, seed, work: Path):
    """``train_prior`` at the conditioned mid PixelSNAIL with attention
    dropout: 3 steps (validating at step 3) and ``--resume`` for one more,
    then an uninterrupted 4-step run, bit-identical to the resumed one."""
    import torch
    from vqvae3d_tpu_torch.checkpoint import load_prior
    from vqvae3d_tpu_torch.cli import train_prior
    from vqvae3d_tpu_torch.data.code_store import CodeStoreWriter
    from vqvae3d_tpu_torch.models.pixelsnail import PixelSNAIL

    cfg = SNAIL_DROPOUT
    f = cfg["fields"]
    rng = np.random.default_rng(seed + 120)
    store = work / "snail_dropout_codes"
    w = CodeStoreWriter(str(store), 2, [f["input_dim"], f["condition_dim"]], backend="file")
    n = 40  # the 95 % split leaves 2 validation grids
    for i in range(n):
        w.write_sample(i, [rng.integers(0, f["input_dim"], cfg["grid"], dtype=np.int32),
                           rng.integers(0, f["condition_dim"], cfg["cond"], dtype=np.int32)])
    w.close()
    nb, val_batches = f["num_blocks"], (n - int(n * 0.95)) // cfg["batch"]
    flags = [str(store), "0", "--use-model", "pixelsnail", "--model-dim", str(f["model_dim"]),
             "--num-blocks", str(nb), "--num-layers-per-block", str(f["num_layers_per_block"]),
             "--batch-size", str(cfg["batch"]), "--val-every-steps", "3",
             "--log-every-n-steps", "1", "--device", "cuda", "--seed", str(seed)]
    total, final = {}, {}
    torch.backends.cudnn.deterministic = True  # the resumed and the whole run compared bitwise
    try:
        for run, extra, steps, vals in [
                ("train", ["--max-steps", "3", "--ckpt-dir", str(work / "sd_parts")], 3, 1),
                ("resume", ["--max-steps", "4", "--resume", "--ckpt-dir", str(work / "sd_parts")],
                 1, 1),
                ("whole", ["--max-steps", "4", "--ckpt-dir", str(work / "sd_whole")], 4, 2)]:
            reset_counts()
            t0 = time.perf_counter()
            model, opt, step = train_prior.main(train_prior.parse_arguments(flags + extra))
            torch.cuda.synchronize()
            got = launch_counts()
            # K5 forward and backward each train step; K8 in each validation
            # (eval: no attention dropout)
            want = dict(dict.fromkeys(got, 0), flash_dropout_attention_fwd=nb * steps,
                        flash_dropout_attention_bwd=nb * steps,
                        flash_attention_fwd=nb * vals * val_batches)
            print(f"train_prior --use-model pixelsnail (conditioned mid, attention dropout "
                  f"{model.config.attention_dropout_prob}) {run}: {steps} step(s) to step {step} "
                  f"in {time.perf_counter() - t0:.1f} s (host clock, data and checkpoints "
                  f"included); launches {got}; implied {want} [{ident}]")
            if (step != {"train": 3, "resume": 4, "whole": 4}[run] or opt.count != step
                    or got != want or not isinstance(model, PixelSNAIL)
                    or model.config.condition_dim != f["condition_dim"]
                    or model.config.attention_dropout_prob != f["attention_dropout_prob"]):
                raise AssertionError(f"{run}: step {step}, optimizer count {opt.count}, "
                                     f"launches {got} != {want}, config {model.config}")
            if run != "whole":
                for k, v in got.items():
                    total[k] = total.get(k, 0) + v
            final[run] = {k: v.clone() for k, v in model.state_dict().items()}
            del model, opt
    finally:
        torch.backends.cudnn.deterministic = False
    differ = [k for k in final["whole"] if not torch.equal(final["whole"][k], final["resume"][k])]
    logs = [json.loads(line)
            for line in (work / "sd_parts" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss_mean"] for r in logs if "train_loss_mean" in r]
    val = [r["val_loss_mean"] for r in logs if "val_loss_mean" in r]
    loaded, lcfg = load_prior(work / "sd_parts")
    print(f"3 + 1 resumed steps vs 4 uninterrupted: {len(final['whole']) - len(differ)} of "
          f"{len(final['whole'])} parameters bit-identical; train losses by step {losses}; val "
          f"losses {val}; load_prior gives a {type(loaded).__name__} ({lcfg.num_blocks} blocks, "
          f"condition_dim {lcfg.condition_dim}, {lcfg.dtype})")
    if (differ or len(losses) != 4 or len(val) != 2 or not np.all(np.isfinite(losses + val))
            or not isinstance(loaded, PixelSNAIL)):
        raise AssertionError(f"the resumed run does not replay the whole one ({differ[:5]}) or "
                             "its losses are missing or not finite")
    for k, v in total.items():
        counts[k] = counts.get(k, 0) + v


# phases 20-21: the published PixelSNAIL priors' sampling (bench_sample.py:8-13,
# :104-146; jobs/sample_mid.sh, jobs/sample_bottom.sh: tau 0.1), unconditioned
# as the published PixelSNAIL jobs train them, fp32 random weights. Phase 20
# teacher-forces the mid grid's first 8 of 32 slices (2,048 voxels: a whole
# mid grid takes ~90-160 s of launch-bound host time on an H100, PERF.md), the
# other grids whole; phase 21 samples every grid whole.
# the mid prior's depth cut from the published 8 blocks to 2 (its sampling
# is host-bound: a quarter of the blocks, about a quarter of the time) so the
# script stays inside its time limit; widths, grid and batch are the
# published ones
SNAIL_SAMPLING = {
    "mid": dict(fields=dict(SNAIL["mid"]["fields"], num_blocks=1), level=1, grid=(32, 32, 8),
                batch=10, forced_slices=8),
    "bottom": dict(fields=SNAIL["bottom"]["fields"], level=2, grid=(8, 8, 2), batch=20,
                   forced_slices=8),
}
# phase 20's conditioned check: the conditioned mid PixelSNAIL's widths (dropout
# off) over an 8x8x2 grid conditioned on a 2x2x1 grid of 512 codes, batch 2
SNAIL_SAMPLING_COND = dict(fields=dict(SNAIL_DROPOUT["fields"], causal_dropout_prob=0.0,
                                       attention_dropout_prob=0.0),
                           grid=(8, 8, 2), cond=(2, 2, 1), batch=2, forced_slices=8)


def host_self_ms(events) -> dict:
    """Self CPU ms and calls by name from torch.profiler's raw events: each
    CPU event's duration less its children's on its thread (what
    ``key_averages`` reports as self CPU time, without building its event
    objects: at ~1M events a sampling profile would spend minutes there)."""
    import torch

    threads, totals = {}, {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            threads.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.end_ns(), e.name()))
    for evs in threads.values():
        evs.sort()
        stack = []  # [end, start, name, children's ns]

        def close():
            end, start, name, child = stack.pop()
            t = totals.setdefault(name, [0.0, 0])
            t[0] += (end - start - child) / 1e6
            t[1] += 1
            if stack:
                stack[-1][3] += end - start

        for start, neg_end, name in evs:
            while stack and stack[-1][0] <= start:
                close()
            stack.append([-neg_end, start, name, 0])
        while stack:
            close()
    return totals


def snail_sampling_profile(fn, voxels: int):
    """fn (one sampling run) timed alone, then under torch.profiler with CPU
    and CUDA activity: (wall ms alone, wall ms under the profiler, device busy
    ms, kernels launched a voxel, the eight costliest host operations by self
    CPU time as text)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    alone = 1e3 * (time.perf_counter() - t0)
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.profiler.kineto_results.events()
    cuda = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in cuda) / 1e6
    launched = sum(not e.name().startswith(("Memcpy", "Memset")) for e in cuda)
    host = sorted(host_self_ms(events).items(), key=lambda kv: -kv[1][0])[:8]
    return alone, wall, busy, launched / voxels, ", ".join(
        f"{name} {ms:.1f} ({n})" for name, (ms, n) in host)


def phase_snail_sampling(ident, results, seed):
    """The cached PixelSNAIL sampler against the one-shot forward (K8) and the
    naive sampler, at the published mid and bottom and a conditioned mid
    width; its time and a profiler split."""
    import torch
    from vqvae3d_tpu_torch.models.prior_utils import idx_to_one_hot
    from vqvae3d_tpu_torch.ops.decode_row import sampling_disagreements
    from vqvae3d_tpu_torch.sample.ar_sample import ancestral_sample, draw_gumbel
    from vqvae3d_tpu_torch.sample.cached_snail import cached_snail_sample

    dev = torch.device("cuda")
    cases = [(name, cfg, None) for name, cfg in SNAIL_SAMPLING.items()]
    cases.append(("conditioned mid widths", SNAIL_SAMPLING_COND, SNAIL_SAMPLING_COND["cond"]))
    for i, (name, cfg, cond_grid) in enumerate(cases):
        f, grid, b, n = cfg["fields"], cfg["grid"], cfg["batch"], cfg["forced_slices"]
        model = make_snail(f, seed + 140 + i, dev)
        gen = torch.Generator(dev).manual_seed(seed + 141 + i)
        forced = torch.randint(0, f["input_dim"], (b, *grid), device=dev, generator=gen)
        cond = (None if cond_grid is None else
                torch.randint(0, f["condition_dim"], (b, *cond_grid), device=dev, generator=gen))
        # (a, c) teacher-forced logits at every voxel of the first n slices against
        # the one-shot forward
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, logits = cached_snail_sample(model, grid, b, cond, TOP_TAU, forced=forced[:, :n])
        torch.cuda.synchronize()
        t_forced = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.inference_mode():
            ref = model(idx_to_one_hot(forced, f["input_dim"]),
                        None if cond is None else idx_to_one_hot(cond, f["condition_dim"]))
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
        ref = ref[:, :, :n]
        err, scale = float((logits - ref).abs().max()), float(ref.abs().max())
        on = "" if cond is None else f" on {cond_grid} of {f['condition_dim']} codes"
        print(f"exactness {name} ({f['num_blocks']} x {f['num_layers_per_block']} x "
              f"{f['model_dim']}d, {f['input_dim']} codes, {b} grids {grid}{on}): "
              f"teacher-forced cached sampler over {n} of {grid[0]} slices {t_forced:.2f} s "
              f"(host clock, synchronised) vs the one-shot PixelSNAIL.forward (K8; "
              f"{t_ref:.2f} s): max|d| logits {err:.3g}, max|ref| {scale:.3g} (tolerance "
              f"{FORWARD_TOL} x max|ref|) [{ident}]")
        if not err <= FORWARD_TOL * scale or not torch.isfinite(logits).all():
            raise AssertionError(f"{name}: cached logits disagree with the one-shot forward")
        results[f"snail_forced_{name.split()[0]}_s"] = t_forced
        results[f"snail_forced_{name.split()[0]}_rel_err"] = err / scale
        del logits, ref
        if name == "bottom":
            # (b) the cached grid against the naive sampler's under one Gumbel table;
            # a voxel where naive's code is not the cached logits' choice (forced along
            # naive's grid) must be a genuine near tie
            table = draw_gumbel((*grid, b, f["input_dim"]), gen, dev)
            t0 = time.perf_counter()
            naive = ancestral_sample(model, grid, b, None, TOP_TAU, gumbel=table)
            torch.cuda.synchronize()
            t_naive = time.perf_counter() - t0
            cached = cached_snail_sample(model, grid, b, None, TOP_TAU, gumbel=table)
            _, along = cached_snail_sample(model, grid, b, None, TOP_TAU, forced=naive)
            nv = int(np.prod(grid))
            ties, beyond = sampling_disagreements(
                along.flatten(2).transpose(1, 2), table.reshape(nv, b, -1), TOP_TAU,
                naive.flatten(1))
            differ = int((cached != naive).sum())
            print(f"cached vs naive sampler, bottom, one Gumbel table, tau {TOP_TAU}: "
                  f"{differ} of {naive.numel()} codes differ; naive's codes not the cached "
                  f"logits' choice: {ties} near ties, {beyond} beyond; the naive sampler "
                  f"{t_naive:.2f} s ({nv} one-shot forwards) [{ident}]")
            if beyond or (differ and not ties):
                raise AssertionError("the cached PixelSNAIL sampler disagrees with the naive one")
            # (d) one bottom grid alone and under the profiler
            alone, wall, busy, per_voxel, host = snail_sampling_profile(
                lambda: cached_snail_sample(model, grid, b, None, TOP_TAU, generator=gen), nv)
            print(f"one bottom grid {grid} at batch {b}: {alone:.1f} ms (host clock, "
                  f"synchronised); under the profiler {wall:.1f} ms, device busy {busy:.1f} ms "
                  f"(idle {100 * (1 - busy / alone):.1f} % of the run alone, "
                  f"{100 * (1 - busy / wall):.1f} % under the profiler), {per_voxel:.1f} "
                  f"kernels a voxel; costliest host operations (self CPU ms, calls): {host} "
                  f"[{ident}]")
            results["snail_profile_bottom"] = dict(alone_ms=alone, wall_ms=wall, busy_ms=busy,
                                                   kernels_a_voxel=per_voxel)
        if name == "mid":
            # (d) the first slice of a mid grid: a (1, 32, 8) grid is the same work
            first = (1, *grid[1:])
            alone, wall, busy, per_voxel, host = snail_sampling_profile(
                lambda: cached_snail_sample(model, first, b, None, TOP_TAU, generator=gen),
                int(np.prod(first)))
            print(f"a mid grid's first slice {first} at batch {b}: {alone:.1f} ms (host clock, "
                  f"synchronised); under the profiler {wall:.1f} ms, device busy {busy:.1f} ms "
                  f"(idle {100 * (1 - busy / alone):.1f} % of the run alone, "
                  f"{100 * (1 - busy / wall):.1f} % under the profiler), {per_voxel:.1f} "
                  f"kernels a voxel; costliest host operations (self CPU ms, calls): {host} "
                  f"[{ident}]")
            results["snail_profile_mid_slice"] = dict(alone_ms=alone, wall_ms=wall, busy_ms=busy,
                                                      kernels_a_voxel=per_voxel)
        del model
        torch.cuda.empty_cache()


# one ``sample_embeddings`` run in a process of its own (python -c), as a user
# runs it: a process that has run torch.profiler launches slower after it (a
# launch-bound sampler ran ~1.7x slower). It prints the run's seconds (host
# clock, synchronised), the new uuids and the wrappers' launch counts.
# a port CLI in a process of its own: argv is the repo, the CLI's module name
# and its flags; the last line printed holds its seconds, result and launches
FRESH_CLI = """
import importlib, json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke
torch.backends.cudnn.deterministic = os.environ.get("CHIP_SMOKE_DETERMINISTIC") == "1"
cli = importlib.import_module("vqvae3d_tpu_torch.cli." + sys.argv[2])
if os.environ.get("CHIP_SMOKE_BACKEND"):  # e.g. gloo: ranks that share one card
    import functools
    cli.initialize_multihost = functools.partial(cli.initialize_multihost,
                                                 backend=os.environ["CHIP_SMOKE_BACKEND"])
chip_smoke.reset_counts()
t0 = time.perf_counter()
result = cli.main(cli.parse_arguments(sys.argv[3:]))
torch.cuda.synchronize()
print(json.dumps(dict(seconds=time.perf_counter() - t0, result=result,
                      launches=chip_smoke.launch_counts()), default=str))
"""


def fresh_cli(module: str, argv, timeout: int = 900):
    """Run ``vqvae3d_tpu_torch.cli.<module>`` with ``argv`` in a process of its
    own (``FRESH_CLI``); print its output and return (its last line's
    record, the process's seconds)."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", FRESH_CLI, str(Path(__file__).parent), module,
                          *argv], capture_output=True, text=True, timeout=timeout)
    process_s = time.perf_counter() - t0
    if run.returncode:
        raise AssertionError(f"{module}: exit {run.returncode}\n{run.stderr[-4000:]}")
    lines = run.stdout.strip().splitlines()
    print("\n".join(lines[:-1]))
    return json.loads(lines[-1]), process_s


def this_process_cli(module: str, argv) -> dict:
    """Run ``vqvae3d_tpu_torch.cli.<module>`` with ``argv`` here: the record
    ``FRESH_CLI`` prints (its seconds, result and launches), without the
    ~10 s of a process of its own, for a CLI whose time is not a measurement."""
    import importlib

    import torch

    cli = importlib.import_module("vqvae3d_tpu_torch.cli." + module)
    reset_counts()
    t0 = time.perf_counter()
    result = cli.main(cli.parse_arguments(argv))
    torch.cuda.synchronize()
    return dict(seconds=time.perf_counter() - t0, result=result, launches=launch_counts())


def phase_snail_sample_main_path(ident, counts, results, seed, work: Path):
    """``sample_embeddings --use-model pixelsnail`` of the published mid and
    bottom grids into one DB (the cached sampler: no kernel launch), then the
    bottom grid with ``--sampler naive`` (K8 once an attention block a voxel),
    each in a process of its own (``FRESH_CLI``)."""
    from vqvae3d_tpu_torch.checkpoint import save_prior
    from vqvae3d_tpu_torch.data.sample_db import create_or_load_db

    # mid (level 1) first: an unconditioned prior refuses a DB that holds the
    # next-coarser level, so the bottom (level 2) comes after it
    runs = [("mid", "cached", "snail_samples.db"), ("bottom", "cached", "snail_samples.db"),
            ("bottom", "naive", "snail_naive.db")]
    for i, (name, sampler, db_name) in enumerate(runs):
        cfg = SNAIL_SAMPLING[name]
        f, grid, b, level = cfg["fields"], cfg["grid"], cfg["batch"], cfg["level"]
        ckpt = work / f"snail_prior_{name}"
        if not ckpt.exists():
            save_prior(ckpt, make_snail(f, seed + 150 + i, "cpu"))
        db_path = work / db_name
        argv = ["--model-checkpoint", str(ckpt), "--db-path", str(db_path), "--level",
                str(level), "--size", *map(str, grid), "--num-samples", str(b), "--batch-size",
                str(b), "--use-model", "pixelsnail", "--sampler", sampler, "--tau", str(TOP_TAU),
                "--seed", str(seed), "--device", "cuda"]
        out, process_s = fresh_cli("sample_embeddings", argv)
        got, new = out["launches"], out["result"]
        # the cached sampler launches no kernel; the naive one K8 per attention
        # block and voxel
        want = dict.fromkeys(got, 0)
        if sampler == "naive":
            want["flash_attention_fwd"] = int(np.prod(grid)) * f["num_blocks"]
        db = create_or_load_db(db_path, level)
        new = [u for u in db[level] if str(u) in set(new)]
        grids = np.stack([np.asarray(db[level][u]["data"]) for u in new])
        print(f"sample_embeddings --use-model pixelsnail --sampler {sampler} {name} --level "
              f"{level} --size {grid} --num-samples {b} --batch-size {b} --tau {TOP_TAU}: "
              f"{out['seconds']:.2f} s a batch (host clock, synchronised; checkpoint load and "
              f"DB included; {process_s:.1f} s the process); launches "
              f"{({k: v for k, v in got.items() if v} or 'none')}, the grid implies "
              f"{({k: v for k, v in want.items() if v} or 'none')}; grids {grids.shape} "
              f"{grids.dtype}, codes {grids.min()}..{grids.max()}, "
              f"{len(np.unique(grids))} distinct [{ident}]")
        if got != want:
            raise AssertionError(f"{name} {sampler}: launches {got} != {want}")
        if (len(new) != b or grids.shape != (b, *grid) or grids.dtype != np.int32
                or grids.min() < 0 or grids.max() >= f["input_dim"]
                or any(db[level][u]["condition"] is not None for u in new)):
            raise AssertionError(f"{name} {sampler}: the sampled grids are wrong")
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        results[f"snail_sample_{name}_{sampler}_s"] = out["seconds"]
    db = create_or_load_db(work / "snail_samples.db", 1)
    if sorted(k for k, v in db.items() if v) != [1, 2]:
        raise AssertionError(f"the DB holds levels {sorted(db)}, not 1 and 2")


def k7_expected(model, calls: list):
    """Forward pre-hooks on every conv of ``model`` that takes the
    small-channel backward (stride 1, a kernel larger than 1x1x1, at most
    ``SMALLC_MAX`` channels each way): each forward with autograd on appends
    the conv to ``calls``, for the one K7 launch its backward will make. A
    count of the launches independent of K7's wrapper (``k7_record`` records
    their shapes). Returns the hooks."""
    import torch
    from vqvae3d_tpu_torch.ops.conv3d import SMALLC_MAX, Conv3D

    def hook(mod, args):
        if torch.is_grad_enabled():
            calls.append(mod)

    return [m.register_forward_pre_hook(hook) for m in model.modules()
            if isinstance(m, Conv3D) and m.stride == 1 and max(m.weight.shape[:2]) <= SMALLC_MAX
            and tuple(m.weight.shape[2:]) != (1, 1, 1)]


@contextlib.contextmanager
def k7_record(shapes: list, host: list):
    """Wrap K7's wrapper: each call appends the (Cin, Cout, kernel, padded
    input spatial) it launches K7 at to ``shapes`` and adds its host seconds
    (its checks, its two allocations and the launch) to ``host[0]``; the
    wrapper's launch count carries over."""
    from vqvae3d_tpu_torch.ops import conv3d

    kernel = conv3d.dw_conv3d

    def recorded(xp, g, ksize):
        shapes.append((xp.shape[1], g.shape[1], tuple(ksize), tuple(xp.shape[2:])))
        t0 = time.perf_counter()
        try:
            return kernel(xp, g, ksize)
        finally:
            host[0] += time.perf_counter() - t0

    recorded.launches = kernel.launches  # the wrapper counts on the name it is called by
    conv3d.dw_conv3d = recorded
    try:
        yield
    finally:
        kernel.launches = recorded.launches
        conv3d.dw_conv3d = kernel


def check_launches(got: dict, want: dict, what: str) -> None:
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want}")


def stage1_step(ident, name, model, cfg, batch, volume, shapes: list):
    """One counted warm-up step, then ms a step (CUDA events, the mean of 2),
    peak memory and the host time of K7's wrapper in those steps: the
    launches against what the config implies, the distinct K7 shapes added
    to ``shapes``."""
    import torch
    from vqvae3d_tpu_torch.train import vqvae_train
    from vqvae3d_tpu_torch.train.state import AMSGrad

    opt = AMSGrad(model.parameters(), lr=STAGE1_LR)
    step = vqvae_train.make_train_step(model, opt)
    calls, seen, host = [], [], [0.0]
    hooks = k7_expected(model, calls)
    reset_counts()
    with k7_record(seen, [0.0]):
        first = float(step(batch)["loss"])
        torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    got = launch_counts()
    k3 = (sum(n for *_, n in cfg.same_stacks(volume)) if cfg.block_type == "pre-activation"
          else 0)
    want = dict(dict.fromkeys(got, 0), l2_argmin_stats=cfg.n_enc, preact_stack_fwd=k3,
                preact_stack_bwd=k3, dw_conv3d=len(calls))
    check_launches(got, want, f"{name} train step")
    torch.cuda.reset_peak_memory_stats()
    logs = []
    with k7_record([], host):
        ms = cuda_ms(lambda: logs.append(step(batch)), iters=2, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    last = float(logs[-1]["loss"])
    k7_host = 1e3 * host[0] / 2
    print(f"bf16 train step {name} (batch 1, {volume}): {ms:.2f} ms/step (mean of 2 after the "
          f"warm-up) peak {peak:.2f} GiB; launches a step K7 {got['dw_conv3d']}, K3 forward "
          f"{got['preact_stack_fwd']} backward {got['preact_stack_bwd']}, K1b "
          f"{got['l2_argmin_stats']}; K7's wrapper {k7_host:.1f} ms of host a step (host "
          f"clock); losses {first:.6g} -> {last:.6g} [{ident}]")
    if not (np.isfinite(first) and np.isfinite(last)):
        raise AssertionError(f"{name}: a non-finite loss")
    shapes.extend(s for s in dict.fromkeys(seen) if s not in shapes)
    return dict(ms=ms, peak_gib=peak, launches=got, k7_host_ms=k7_host)


K7_KERNELS = ("dw_tc", "dw_partial", "dw_reduce")


def stage1_profile(ident, name, model, batch):
    """One train step under torch.profiler, after a warm-up: device busy
    against the wall, K7's device time, kernels launched, the host's
    cudaLaunchKernel time, the costliest kernels (from the raw events: at
    ~65k events a step ``key_averages`` would take a minute)."""
    import torch
    from vqvae3d_tpu_torch.train import vqvae_train
    from vqvae3d_tpu_torch.train.state import AMSGrad

    step = vqvae_train.make_train_step(model, AMSGrad(model.parameters(), lr=STAGE1_LR))
    step(batch)
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_kernel, launch, n = {}, 0.0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.name().startswith(("Memcpy", "Memset")):
                key = kernel_name(e.name())
                by_kernel[key] = by_kernel.get(key, 0.0) + e.duration_ns() / 1e6
                n += 1
        elif e.name() == "cudaLaunchKernel":
            launch += e.duration_ns() / 1e6
    busy = sum(by_kernel.values())
    k7 = sum(by_kernel.get(k, 0.0) for k in K7_KERNELS)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    print(f"profile of one bf16 {name} stem-2 train step: device busy {busy:.1f} ms of "
          f"{wall:.1f} ms wall under the profiler ({n} kernels; cudaLaunchKernel {launch:.1f} ms "
          f"of host); K7 {k7:.1f} ms; costliest: "
          + ", ".join(f"{k} {ms:.1f}" for k, ms in top) + f" [{ident}]")
    return dict(busy_ms=busy, wall_ms=wall, k7_ms=k7)


def stage1_serving(ident, seed, x):
    """Encode -> quantize -> decode at the full config with the 'regular' and
    'evonorm' blocks, at stem 2 (the phase keeps inside its time share): the
    codes against the same forward with the plain lookups (equal but at
    genuine fp32 ties), ms a volume."""
    import torch
    from vqvae3d_tpu_torch.ops import quantizer_ops

    out = {}
    for kind, stem in (("regular", 2), ("evonorm", 2)):
        model, cfg = make_model(stem, seed + 60, torch.bfloat16, "cuda", block_type=kind)
        inputs = {}
        hooks = [q.register_forward_hook(lambda m, a, o, i=i: inputs.__setitem__(i, a[0]))
                 for i, q in enumerate(model.encoder.quantize)]
        reset_counts()
        with torch.inference_mode():
            res_k = model.encode(x)
            dec = model.decode([q for _, q, _ in res_k])
            got = launch_counts()
            flats = dict(inputs)
            with plain_path():  # the plain lookups; no other kernel serves these blocks
                res_p = model.encode(x)
        for h in hooks:
            h.remove()
        check_launches(got, dict(dict.fromkeys(got, 0), l2_argmin=cfg.n_enc),
                       f"{kind} stem {stem} forward")
        mism, tie_above = [], None
        for lvl in reversed(range(cfg.n_enc)):  # coarse first: a tie changes finer inputs
            a, b = res_k[lvl][2].flatten(), res_p[lvl][2].flatten()
            embed = model.encoder.quantize[lvl].embed
            flat = flats[lvl].float().movedim(1, -1).reshape(-1, embed.shape[1])
            ties, real = quantizer_ops.genuine_ties(flat, embed, a, b)
            mism.append(f"level {lvl} {int((a != b).sum())} (ties {ties.numel()})")
            if real.numel() and tie_above is None:
                raise AssertionError(f"{kind} stem {stem} level {lvl}: {real.numel()} codes "
                                     "differ from the plain lookup's beyond ties")
            if (a != b).any() and tie_above is None:
                tie_above = lvl
        if not torch.isfinite(dec).all() or tuple(dec.shape) != (1, 1, *VOLUME):
            raise AssertionError(f"{kind} stem {stem}: decoded {tuple(dec.shape)} not finite")
        del res_k, res_p, dec, flats, inputs
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            ms = [cuda_ms(lambda: model(x), iters=2, warmup=1) for _ in range(2)]
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"bf16 serving {kind} stem {stem} ({VOLUME}, batch 1): "
              f"{', '.join(f'{t:.2f}' for t in ms)} ms/volume (encode + decode, mean of 2 "
              f"after a warm-up, twice) peak {peak:.2f} GiB; codes vs the plain lookup: "
              f"{', '.join(mism)} [{ident}]")
        out[(kind, stem)] = min(ms)
        del model
        torch.cuda.empty_cache()
    return out


def stage1_k3_checks(ident, seed, checks):
    """K3 forward and backward against the autograd of the plain stack
    (``preact_stack_plain``: ``preact_fixup_same`` block by block) at
    ``checks``' (C, spatial, blocks, dtypes): the largest error of each
    output and gradient against its tolerance."""
    import torch
    from vqvae3d_tpu_torch.ops import stack_kernel

    gen = torch.Generator().manual_seed(seed + 70)
    for c, spatial, nb, dtypes in checks:
        x32 = torch.randn(1, c, *spatial, generator=gen).to("cuda")
        g32 = torch.randn(1, c, *spatial, generator=gen).to("cuda")
        w = k3_weights(c, nb, gen, "cuda")
        for dtype in dtypes:
            key = str(dtype).removeprefix("torch.")
            tol = (K3_DEEP_TOL[key] if nb > 50 else
                   K3_BWD_TOL[(key, "one" if nb == 1 else "full")])
            x, gy = x32.to(dtype), g32.to(dtype)
            xg = x.clone().requires_grad_()
            wg = [t.clone().requires_grad_() for t in w]
            y = stack_kernel.preact_stack_fused(xg, *wg, "wrap")
            got = (y, *torch.autograd.grad(y, [xg, *wg], gy))
            with plain_path():
                xr = x.clone().requires_grad_()
                wr = [t.clone().requires_grad_() for t in w]
                yr = stack_kernel.preact_stack_plain(xr, *wr, pad_mode="wrap")
                want = (yr, *torch.autograd.grad(yr, [xr, *wr], gy))
            errs = {}
            for name, a, b in zip(("y", "dx", "dw1", "dw2", "dw3", "dsc"), got, want):
                a, b = a.detach().float(), b.detach().float()
                errs[name] = float((a - b).abs().max()) / float(b.abs().max())
            print(f"K3 forward and backward C={c} {spatial} {nb} blocks wrap {key}: "
                  f"max|d|/max|ref| " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f" (tolerance {tol:.3g}) [{ident}]")
            if max(errs.values()) > tol:
                raise AssertionError(f"K3 C={c} {spatial} {nb} blocks {key} disagrees with "
                                     f"the plain stack: {errs}")
            del y, got, yr, want, xg, wg, xr, wr


def stage1_k7_checks(ident, seed, shapes):
    """K7 against ``dw_conv3d_plain`` at each distinct bf16 shape the steps
    launched (random inputs): the largest error against ``K7_TOL``."""
    import torch
    from vqvae3d_tpu_torch.ops import conv3d

    gen = torch.Generator().manual_seed(seed + 71)
    worst = 0.0
    for cin, cout, ks, padded in shapes:
        out = tuple(p - k + 1 for p, k in zip(padded, ks))
        xp = torch.randn(1, cin, *padded, generator=gen).to("cuda", torch.bfloat16)
        g = torch.randn(1, cout, *out, generator=gen).to("cuda", torch.bfloat16)
        got = conv3d.dw_conv3d(xp, g, ks)
        want = conv3d.dw_conv3d_plain(xp, g, ks)
        err = float((got - want).abs().max()) / float(want.abs().max())
        worst = max(worst, err)
        if not err <= K7_TOL:
            raise AssertionError(f"K7 Cin={cin} Cout={cout} {ks} over {out}: max|d|/max|ref| "
                                 f"{err:.3g} > {K7_TOL}")
    print(f"K7 at the {len(shapes)} distinct shapes of the phase's train steps (Cin, Cout, "
          f"kernel, grid): " + ", ".join(f"{a}->{b} {ks} {tuple(p - k + 1 for p, k in zip(pp, ks))}"
                                         for a, b, ks, pp in shapes)
          + f"; bf16 against dw_conv3d_plain, worst max|d|/max|ref| {worst:.2e} (tolerance "
          f"{K7_TOL}) [{ident}]")


def stage1_scans(work: Path, seed) -> Path:
    """The train CLI phase's three synthetic scans, written here when that
    phase did not run."""
    ct = work / "ct_train"
    if not ct.exists():
        ct = work / "ct_stage1"
        ct.mkdir(exist_ok=True)
        rng = np.random.default_rng(seed + 3)
        for i in range(3):
            write_scan(ct / f"scan{i}.nrrd",
                       rng.integers(-1000, 1500, size=VOLUME, dtype=np.int16))
    return ct


def stage1_clis(ident, counts, seed, work: Path, k7_per_step: int):
    """``train_vqvae --block-type evonorm`` at the full config (stem 2) for 2
    steps (validating at step 2), then ``calc_ssim_from_checkpoint`` and
    ``plot_from_checkpoint`` on its checkpoint (``this_process_cli``); the
    launches against what the runs imply."""
    import torch
    from vqvae3d_tpu_torch.cli import train_vqvae
    from vqvae3d_tpu_torch.data import nrrd_io

    ct = stage1_scans(work, seed)
    ckpt = work / "evonorm_ckpt"
    size = ["--scan-size", *map(str, VOLUME[:2]), "--output-depth", str(VOLUME[2])]
    reset_counts()
    t0 = time.perf_counter()
    _, _, step = train_vqvae.main(train_vqvae.parse_arguments([
        str(ct), "--ckpt-dir", str(ckpt), "--block-type", "evonorm", "--batch-size", "1",
        "--num-embeddings", *map(str, FULL["num_embeddings"]),
        *(f for k in ("n_pre_quantization_blocks", "n_post_quantization_blocks",
                      "n_post_downscale_blocks", "n_post_upscale_blocks", "pad_mode")
          for f in ("--" + k.replace("_", "-"), str(FULL[k]))),
        "--stem-space-to-depth", "2", "--base-network-channels", "8", "--base-lr", str(STAGE1_LR), "--max-steps", "2", "--val-every-steps", "2",
        "--log-every-n-steps", "1", "--num-workers", "2", "--device", "cuda", *size]))
    torch.cuda.synchronize()
    got = launch_counts()
    # two steps and one validation forward (the one val scan)
    want = dict(dict.fromkeys(got, 0), l2_argmin_stats=3 * 2, l2_argmin=3,
                dw_conv3d=2 * k7_per_step)
    print(f"train_vqvae --block-type evonorm: 2 steps in {time.perf_counter() - t0:.1f} s "
          f"(host clock, data, validation and checkpoints included); launches "
          f"{({k: v for k, v in got.items() if v})} [{ident}]")
    check_launches(got, want, "train_vqvae --block-type evonorm")
    if step != 2:
        raise AssertionError(f"train_vqvae stopped at step {step}")
    total = dict(got)

    out = this_process_cli("calc_ssim_from_checkpoint",
                           [str(ckpt), str(ct), *size, "--device", "cuda"])
    ssim, got = out["result"], out["launches"]
    n = sum(v["n"] for v in ssim.values())
    print(f"calc_ssim_from_checkpoint: {ssim} in {out['seconds']:.2f} s; launches "
          f"{({k: v for k, v in got.items() if v})} [{ident}]")
    check_launches(got, dict(dict.fromkeys(got, 0), l2_argmin=3 * n), "calc_ssim_from_checkpoint")
    if (sorted(ssim) != ["train", "val"] or n != 3
            or not all(np.isfinite(v["ssim_mean"]) and -1 <= v["ssim_mean"] <= 1
                       for v in ssim.values())):
        raise AssertionError(f"calc_ssim_from_checkpoint: {ssim}")
    for k in total:
        total[k] += got[k]

    prefix = work / "plot" / "evonorm"
    prefix.parent.mkdir(exist_ok=True)
    out = this_process_cli("plot_from_checkpoint", [str(ckpt), str(ct), str(prefix), *size,
                                                     "--device", "cuda"])
    got = out["launches"]
    check_launches(got, dict(dict.fromkeys(got, 0), l2_argmin=3), "plot_from_checkpoint")
    vols = [nrrd_io.read(f)[0] for f in out["result"]]
    print(f"plot_from_checkpoint: {[str(f) for f in out['result']]} in {out['seconds']:.2f} s: "
          f"{[(v.shape, str(v.dtype), int(v.min()), int(v.max())) for v in vols]} [{ident}]")
    # the ELU's floor is -1: HU -2000
    if len(vols) != 2 or any(v.shape != VOLUME or v.min() < -2000 for v in vols):
        raise AssertionError("plot_from_checkpoint wrote the wrong volumes")
    for k in total:
        total[k] += got[k]
        counts[k] = counts.get(k, 0) + total[k]


def phase_stage1_variants(ident, counts, results, seed, work: Path):
    """Phase 22: the stage-1 block types and options, and the published
    configs that had not run on the card."""
    import torch
    from vqvae3d_tpu_torch.data.transforms import hu_window_normalize
    from vqvae3d_tpu_torch.models.vqvae import VQVAEConfig

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 61)
    x = torch.from_numpy(hu_window_normalize(
        rng.integers(-1000, 1500, size=VOLUME, dtype=np.int16)))[None, None].to(dev)
    t0 = time.perf_counter()
    stage1_serving(ident, seed, x)
    t_a = time.perf_counter() - t0
    del x

    batch = synthetic_batch(seed + 62, dev)
    shapes, steps = [], {}
    for name, fields in VARIANTS.items():
        model, cfg = make_model(2, seed + 63, torch.bfloat16, dev, **fields)
        steps[name] = stage1_step(ident, f"{name} stem 2", model, cfg, batch, VOLUME, shapes)
        del model
        torch.cuda.empty_cache()
    t_b = time.perf_counter() - t0 - t_a

    model, cfg = make_model(1, seed + 64, torch.bfloat16, dev)
    steps["stem 1"] = stage1_step(ident, "pre-activation stem 1", model, cfg, batch, VOLUME,
                                  shapes)
    del model
    torch.cuda.empty_cache()
    # the literal stem's EvoNorm step: its post-upscale blocks at C 4 over the
    # full volume, fp32 inside, no per-block checkpoint
    model, cfg = make_model(1, seed + 67, torch.bfloat16, dev, **VARIANTS["evonorm"])
    steps["evonorm stem 1"] = stage1_step(ident, "evonorm stem 1", model, cfg, batch, VOLUME,
                                          shapes)
    del model
    torch.cuda.empty_cache()
    model, cfg = make_model(1, seed + 65, torch.bfloat16, dev, **DOWNSCALED)
    steps["downscaled"] = stage1_step(ident, "downscaled", model, cfg,
                                      synthetic_batch(seed + 66, dev, DOWNSCALED_VOLUME),
                                      DOWNSCALED_VOLUME, shapes)
    # its deepest stack, the largest of them
    deep = max(cfg.same_stacks(DOWNSCALED_VOLUME), key=lambda s: (s[3], s[1] * np.prod(s[2])))
    del model
    torch.cuda.empty_cache()
    # after every timing: a process that ran the profiler launches slower
    for name in ("regular", "evonorm"):
        model, _ = make_model(2, seed + 63, torch.bfloat16, dev, **VARIANTS[name])
        steps[name].update(stage1_profile(ident, name, model, batch))
        del model
        torch.cuda.empty_cache()
    del batch
    t_c = time.perf_counter() - t0 - t_a - t_b

    stage1_k7_checks(ident, seed, shapes)
    legacy = VQVAEConfig(**FULL, **STEM2, encoder_variant="encoder")
    # the legacy encoder's pre-quantization stack at C 64 (32x32x8)
    c64 = next(s for s in legacy.same_stacks(VOLUME)
               if s[:2] == ("encode", 64) and s[3] == legacy.n_pre_quantization_blocks)
    stage1_k3_checks(ident, seed, [
        (c64[1], c64[2], 1, (torch.float32, torch.bfloat16)),
        (c64[1], c64[2], c64[3], (torch.float32, torch.bfloat16)),
        (deep[1], deep[2], deep[3], (torch.float32, torch.bfloat16)),
    ])
    t_d = time.perf_counter() - t0 - t_a - t_b - t_c

    stage1_clis(ident, counts, seed, work, steps["evonorm"]["launches"]["dw_conv3d"])
    t_e = time.perf_counter() - t0 - t_a - t_b - t_c - t_d
    print(f"phase 22 parts: serving {t_a:.1f} s, option steps {t_b:.1f} s, published steps "
          f"and profiles {t_c:.1f} s, kernel checks {t_d:.1f} s, CLIs {t_e:.1f} s")
    results["stage1_steps"] = steps


# phase 23: the PixelCNN remainder. The published wide PixelCNN jobs on one
# card (jobs/train_pixelcnn_mid.sh, jobs/train_pixelcnn_bottom.sh): batch 2 and
# 6 a device, the lr as the jobs scale it (1e-4 x batch / 8, 1e-5 x batch / 24)
PIXELCNN_JOBS = {
    "mid": dict(level=1, flags=["--model-dim", "256", "--num-resblocks", "45",
                                "--dropout-prob", "0.5", "--bottleneck-divisor", "4",
                                "--use-conditioning", "True", "--batch-size", "2",
                                "--lr", "2.5e-5"]),
    "bottom": dict(level=2, flags=["--model-dim", "512", "--num-resblocks", "50",
                                   "--dropout-prob", "0.5", "--bottleneck-divisor", "4",
                                   "--use-conditioning", "False",
                                   "--use-concat-activation", "False", "--batch-size", "6",
                                   "--lr", "2.5e-6"]),
}
# the code store of the published hierarchy: (grid, codes) of levels 0, 1, 2
STORE_LEVELS = [(TOP_GRID, 128), (TOP_COND, 256), ((8, 8, 2), 512)]
# the PixelCNN options beside the default, at the top prior's width: their
# train_prior flags and config fields
PRIOR_OPTIONS = {
    "fixup": (["--use-pre-activation", "False"], dict(use_pre_activation=False)),
    "concat": (["--use-concat-activation", "True"], dict(use_concat_activation=True)),
    "k5": (["--kernel-size", "5"], dict(kernel_size=5)),
}
# the k = 5 cached sampler's grid (a mid-sized grid at the top width) and its
# condition; its teacher-forced check on the grid's first 8 slices (8 s0-
# slices, conditioned at the same 4x ratio: the 1200 s limit); the naive
# sampler's grid from the Fixup checkpoint
K5_GRID, K5_COND = (32, 32, 8), (8, 8, 2)
K5_FORCED, K5_FORCED_COND, NAIVE_GRID = (8, 32, 8), (2, 8, 2), (8, 8, 2)


def variant_k4_dropout(ident, seed, results):
    """(a) K4 at p = 0.5 over the top prior's 50-block segment, keep masks as
    data, fp32 and bf16, against the plain segment and its autograd; then the
    top prior's train step at dropout 0.5 beside dropout 0, in turns."""
    import torch
    from vqvae3d_tpu_torch.ops import causal_kernel as ck
    from vqvae3d_tpu_torch.train import prior_train
    from vqvae3d_tpu_torch.train.state import AMSGrad

    dev = torch.device("cuda")
    w = top_union_weights(TOP_PRIOR, seed + 81, dev)
    nb, cu, cb = w.w1e.shape
    cc = w.wc.shape[1]
    gen = torch.Generator().manual_seed(seed + 82)
    x32, g32 = (torch.randn(1, *TOP_GRID, cu, generator=gen).to(dev) for _ in range(2))
    c32 = torch.randn(1, *TOP_GRID, cc, generator=gen).to(dev)
    keep = (torch.rand(nb, 1, cb, generator=gen) < 0.5).float().to(dev)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = (str(dtype).removeprefix("torch."), "full")
        x, gy, cond = x32.to(dtype), g32.to(dtype), c32.to(dtype)

        def grads(fn, **kw):
            xg, cg = x.clone().requires_grad_(), cond.clone().requires_grad_()
            wg = ck.UnionWeights(*(None if t is None else t.clone().requires_grad_() for t in w))
            y = fn(xg, cg, keep, 0.5, wg, **kw)
            return (y.detach(), *torch.autograd.grad(
                y, [xg, cg] + [t for t in wg if t is not None], gy))

        before = (ck.causal_stack_fused.launches, ck.causal_stack_bwd.launches)
        got = grads(ck.causal_stack_fused)
        torch.cuda.synchronize()
        launched = (ck.causal_stack_fused.launches - before[0],
                    ck.causal_stack_bwd.launches - before[1])
        want = grads(ck.causal_stack_plain, remat=True)
        names = ["y", "dx", "dcond"] + [f for f, t in zip(ck.UnionWeights._fields, w)
                                         if t is not None]
        rel = []
        for tname, a, r in zip(names, got, want):
            err, scale = float((a.float() - r.float()).abs().max()), float(r.float().abs().max())
            rel.append(f"{tname} {err / scale:.2e}")
            worst[key] = max(worst.get(key, 0.0), err / scale)
            if not err <= K4_TOL[key] * scale or not torch.isfinite(a).all():
                raise AssertionError(f"K4 p=0.5 {key} {tname}: max|d|={err:.3g} > "
                                     f"{K4_TOL[key]} x {scale:.3g}")
        print(f"K4 at p = 0.5 over the top segment ({nb} blocks, B=1, {TOP_GRID}, conditioned, "
              f"one keep mask a block as data) {key[0]}: launches forward {launched[0]} "
              f"backward {launched[1]}; max|d|/max|ref| (tolerance {K4_TOL[key]}) "
              + ", ".join(rel) + f" [{ident}]")
        if launched != (nb, nb):
            raise AssertionError(f"K4 launches {launched} != ({nb}, {nb})")
        del got, want
        torch.cuda.empty_cache()

    batch = code_batch(seed + 83, dev)
    steps, times = {}, {}
    for p in (0.5, 0.0):
        model = make_prior(dict(TOP_PRIOR, dropout_prob=p), seed + 84, dev, dtype=torch.bfloat16)
        steps[p] = prior_train.make_prior_train_step(
            model, AMSGrad(model.parameters(), lr=TOP_LR), seed=seed + 85)
    reset_counts()
    log = steps[0.5](batch)
    torch.cuda.synchronize()
    got = launch_counts()
    want = dict(dict.fromkeys(got, 0), **prior_step_launches(model))
    check_launches(got, want, "top prior step at dropout 0.5")
    for p in (0.5, 0.0, 0.0, 0.5):
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: steps[p](batch), iters=3, warmup=1)
        times.setdefault(p, []).append((ms, torch.cuda.max_memory_allocated() / 2**30))
    print(f"bf16 top-prior train step (bench_prior.py:130-136: 50 x 16d, 128 codes, conditioned, "
          f"{TOP_GRID}, batch 1) in turns, ms/step (mean of 3 after 1 warm-up) and peak GiB: "
          + "; ".join(f"dropout {p}: " + ", ".join(f"{ms:.2f} ms {pk:.2f} GiB" for ms, pk in v)
                      for p, v in times.items())
          + f"; launches a step at 0.5 {({k: v for k, v in got.items() if v})}, loss "
          f"{float(log['loss_mean']):.5g} [{ident}]")
    if not np.isfinite(float(log["loss_mean"])):
        raise AssertionError("a non-finite loss at dropout 0.5")
    results["top_dropout_step"] = dict(k4_worst=worst, times=times)


def variant_store(work: Path, seed) -> Path:
    """A code store of 8 samples of the published three-level hierarchy
    (``STORE_LEVELS``): 7 train grids and 1 validation grid a level."""
    from vqvae3d_tpu_torch.data.code_store import CodeStoreWriter

    rng = np.random.default_rng(seed + 90)
    store = work / "variant_codes"
    w = CodeStoreWriter(str(store), 3, [k for _, k in STORE_LEVELS], backend="file")
    for i in range(8):
        w.write_sample(i, [rng.integers(0, k, grid, dtype=np.int32) for grid, k in STORE_LEVELS])
    w.close()
    return store


@contextlib.contextmanager
def step_times(times: list):
    """Record each ``train_prior`` step's ms (its ``StepTimer``, CUDA events)
    in ``times``."""
    from vqvae3d_tpu_torch.cli import train_prior

    base = train_prior.StepTimer

    class Recorded(base):
        def __exit__(self, *exc):
            super().__exit__(*exc)
            times.append(self.last_ms)

    train_prior.StepTimer = Recorded
    try:
        yield
    finally:
        train_prior.StepTimer = base


def run_train_prior(argv, steps_ms: list):
    """``train_prior.main`` on ``argv``, counted from 0 and with its step
    times recorded: (model, optimizer, step, launches, seconds, peak GiB)."""
    import torch
    from vqvae3d_tpu_torch.cli import train_prior

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with step_times(steps_ms):
        model, opt, step = train_prior.main(train_prior.parse_arguments(argv))
    torch.cuda.synchronize()
    return (model, opt, step, launch_counts(), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**30)


def add_counts(counts, got):
    for k, v in got.items():
        counts[k] = counts.get(k, 0) + v


def published_pixelcnn_jobs(ident, counts, seed, store: Path, work: Path, results):
    """(b) The published mid and bottom PixelCNN jobs through ``train_prior``
    at full width and depth, 3 steps each: step ms, finite losses, peak
    memory; no K4 and no K7 at these widths (as in JAX)."""
    for name, job in PIXELCNN_JOBS.items():
        ckpt = work / f"pixelcnn_{name}"
        times = []
        model, opt, step, got, secs, peak = run_train_prior(
            [str(store), str(job["level"]), "--use-model", "pixelcnn", *job["flags"],
             "--max-steps", "3", "--val-every-steps", "3", "--log-every-n-steps", "1",
             "--ckpt-dir", str(ckpt), "--device", "cuda", "--seed", str(seed)], times)
        cfg = model.config
        logs = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
        losses = [r["train_loss_mean"] for r in logs if "train_loss_mean" in r]
        print(f"train_prior, the published {name} PixelCNN ({cfg.num_resblocks} x "
              f"{cfg.model_dim}d over {cfg.input_dim} codes, condition {cfg.condition_dim}, "
              f"dropout {cfg.dropout_prob}, {STORE_LEVELS[job['level']][0]}): 3 steps in "
              f"{secs:.1f} s (host clock, model, data, checkpoint); step ms "
              + ", ".join(f"{t:.2f}" for t in times) + f" (step_ms, the mean after the first, "
              f"{np.mean(times[1:]):.2f}); peak {peak:.2f} GiB; losses {losses}; launches "
              f"{({k: v for k, v in got.items() if v})} [{ident}]")
        check_launches(got, dict.fromkeys(got, 0), f"the {name} PixelCNN job")
        if step != 3 or len(losses) != 3 or not np.all(np.isfinite(losses)):
            raise AssertionError(f"the {name} PixelCNN job: step {step}, losses {losses}")
        results[f"pixelcnn_{name}_job"] = dict(step_ms=float(np.mean(times[1:])), peak_gib=peak,
                                               first_ms=times[0])
        add_counts(counts, got)
        del model, opt


def option_fp32_step(ident, name, fields, seed, batch):
    """One fp32 step of an option's top-width model on the kernel path (K7
    for its small-channel causal convs) against the plain path: the loss and
    every gradient."""
    import torch
    from vqvae3d_tpu_torch.train import prior_train

    model = make_prior(fields, seed, "cuda")

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss, _ = prior_train.prior_loss_fn(model, batch, train=True)
        loss.backward()
        return float(loss.detach()), {n: (torch.zeros_like(q) if q.grad is None else q.grad.clone())
                                      for n, q in model.named_parameters()}

    loss_k, grads_k = loss_and_grads()
    with plain_path():
        loss_p, grads_p = loss_and_grads()
    torch.cuda.synchronize()
    gmax = max(float(g.abs().max()) for g in grads_p.values())
    grad_err = {n: float((grads_k[n] - grads_p[n]).abs().max())
                / max(float(grads_p[n].abs().max()), 1e-3 * gmax) for n in grads_p}
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:3]
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    print(f"fp32 {name} top-width train step ({TOP_GRID}): loss kernel {loss_k:.7g} plain "
          f"{loss_p:.7g} (rel {loss_err:.2e}); gradients of {len(grads_p)} tensors, worst "
          f"max|d| over max(max|ref|, 1e-3 max grad): "
          + ", ".join(f"{n} {e:.2e}" for n, e in worst) + f" [{ident}]")
    if loss_err > STEP_LOSS_TOL or worst[0][1] > STEP_GRAD_TOL or not np.isfinite(loss_k):
        raise AssertionError(f"fp32 {name} step: the kernel path disagrees with the plain path")
    return loss_err, worst[0][1]


def prior_option_steps(ident, counts, seed, store: Path, work: Path, shapes: list, results):
    """(c) Each PixelCNN option at the top width (50 x 16d, 128 codes,
    conditioned, 128x128x32, batch 1): one fp32 step, kernel path against
    plain path; a counted bf16 step (K7's launches and shapes, no K4) and the
    ms a step; then ``train_prior`` for 2 steps and one ``--resume``."""
    import torch
    from vqvae3d_tpu_torch.train import prior_train
    from vqvae3d_tpu_torch.train.state import AMSGrad

    batch = code_batch(seed + 86, "cuda")
    out = {}
    for name, (flags, extra) in PRIOR_OPTIONS.items():
        fields = dict(TOP_PRIOR, **extra)
        fp32 = option_fp32_step(ident, name, fields, seed + 87, batch)
        torch.cuda.empty_cache()
        model = make_prior(fields, seed + 87, "cuda", dtype=torch.bfloat16)
        step = prior_train.make_prior_train_step(model, AMSGrad(model.parameters(), lr=TOP_LR),
                                                 seed=seed + 88)
        reset_counts()
        seen = []
        with k7_record(seen, [0.0]):
            log = step(batch)
            torch.cuda.synchronize()
        got = launch_counts()
        check_launches(got, dict(dict.fromkeys(got, 0), **prior_step_launches(model)),
                       f"{name} top-width step")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(batch), iters=3, warmup=0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        shapes.extend(sh for sh in dict.fromkeys(seen) if sh not in shapes)
        print(f"bf16 {name} top-width train step ({TOP_GRID}, batch 1): {ms:.2f} ms/step (mean "
              f"of 3 after the counted step) peak {peak:.2f} GiB; launches a step K7 "
              f"{got['dw_conv3d']} at {len(set(seen))} shapes, K4 {got['causal_stack_fwd']}; "
              f"loss {float(log['loss_mean']):.5g} [{ident}]")
        if not np.isfinite(float(log["loss_mean"])):
            raise AssertionError(f"{name}: a non-finite loss")
        out[name] = dict(fp32=fp32, ms=ms, peak_gib=peak, k7_per_step=got["dw_conv3d"])
        del model, step
        torch.cuda.empty_cache()
        ckpt = work / f"pixelcnn_{name}"
        argv = [str(store), "0", "--use-model", "pixelcnn",
                "--model-dim", str(TOP_PRIOR["model_dim"]),
                "--num-resblocks", str(TOP_PRIOR["num_resblocks"]),
                "--bottleneck-divisor", "4", "--dropout-prob", "0",
                "--batch-size", "1", "--val-every-steps", "2", "--log-every-n-steps", "1",
                "--lr", str(TOP_LR), "--ckpt-dir", str(ckpt), "--device", "cuda",
                "--seed", str(seed), *flags]
        per_step = out[name]["k7_per_step"]
        for run, extra, n in (("train", ["--max-steps", "2"], 2),
                              ("resume", ["--max-steps", "3", "--resume"], 1)):
            model, opt, step_n, got, secs, _ = run_train_prior(argv + extra, [])
            print(f"train_prior {' '.join(flags)} {run}: {n} step(s) to step {step_n} in "
                  f"{secs:.1f} s (host clock); launches {({k: v for k, v in got.items() if v})} "
                  f"[{ident}]")
            check_launches(got, dict(dict.fromkeys(got, 0), dw_conv3d=n * per_step),
                           f"train_prior {name} {run}")
            if step_n != {"train": 2, "resume": 3}[run] or opt.count != step_n:
                raise AssertionError(f"train_prior {name} {run} stopped at step {step_n}")
            add_counts(counts, got)
            del model, opt
    results["prior_options"] = out


def prior_option_sampling(ident, counts, seed, work: Path, results):
    """(d) The cached sampler at k = 5 (its own row steps, no kernel) on a
    top-width model: teacher-forced logits against the one-shot forward on
    the 32x32x8 grid's first 8 slices, then one free-running 32x32x8 grid
    conditioned on 8x8x2, timed;
    ``sample_embeddings --sampler naive`` of an 8x8x2 grid from the Fixup
    checkpoint that (c) wrote."""
    import torch
    from vqvae3d_tpu_torch.cli import sample_embeddings
    from vqvae3d_tpu_torch.data.sample_db import add_samples, create_or_load_db, save_db
    from vqvae3d_tpu_torch.models.prior_utils import idx_to_one_hot
    from vqvae3d_tpu_torch.sample.cached_sample import cached_ancestral_sample

    dev = torch.device("cuda")
    model = make_prior(dict(TOP_PRIOR, kernel_size=5), seed + 91, dev)
    gen = torch.Generator(dev).manual_seed(seed + 92)
    k, kc = TOP_PRIOR["input_dim"], TOP_PRIOR["condition_dim"]
    cond = torch.randint(0, kc, (1, *K5_FORCED_COND), device=dev, generator=gen)
    forced = torch.randint(0, k, (1, *K5_FORCED), device=dev, generator=gen)
    reset_counts()
    t0 = time.perf_counter()
    _, logits = cached_ancestral_sample(model, K5_FORCED, 1, cond, TOP_TAU, forced=forced)
    torch.cuda.synchronize()
    t_forced = time.perf_counter() - t0
    with torch.inference_mode():
        ref = model(idx_to_one_hot(forced, k), idx_to_one_hot(cond, kc))
    err, scale = float((logits - ref).abs().max()), float(ref.abs().max())
    cond = torch.randint(0, kc, (1, *K5_COND), device=dev, generator=gen)
    t0 = time.perf_counter()
    grid = cached_ancestral_sample(model, K5_GRID, 1, cond, TOP_TAU, generator=gen)
    torch.cuda.synchronize()
    t_free = time.perf_counter() - t0
    got = launch_counts()
    voxels = int(np.prod(K5_GRID))
    print(f"cached sampler at kernel size 5 (top width, batch 1, fp32, its own row steps "
          f"replayed as CUDA graphs): teacher-forced over {K5_FORCED} on {K5_FORCED_COND} "
          f"{t_forced:.2f} s, logits max|d| {err:.3g} against the one-shot forward, max|ref| "
          f"{scale:.3g} (tolerance {FORWARD_TOL} x max|ref|); one free-running grid {K5_GRID} "
          f"on {K5_COND} {t_free:.2f} s ({1e3 * t_free / voxels:.3f} ms a voxel, host "
          f"clock), codes {int(grid.min())}..{int(grid.max())}; launches "
          f"{({k_: v for k_, v in got.items() if v})} [{ident}]")
    check_launches(got, dict.fromkeys(got, 0), "the k = 5 cached sampler")
    if (not err <= FORWARD_TOL * scale or not torch.isfinite(logits).all()
            or tuple(grid.shape) != (1, *K5_GRID) or int(grid.min()) < 0 or int(grid.max()) >= k):
        raise AssertionError("the k = 5 cached sampler disagrees or sampled a wrong grid")
    del model, logits, ref

    ckpt = work / "pixelcnn_fixup"
    db_path = work / "samples_fixup.db"
    db = create_or_load_db(db_path, 1)
    rng = np.random.default_rng(seed + 93)
    level1 = add_samples(db, 1, rng.integers(0, kc, (2, 2, 2, 1)).astype(np.int32), None)
    save_db(db, db_path, 1)
    reset_counts()
    t0 = time.perf_counter()
    new = sample_embeddings.main(sample_embeddings.parse_arguments([
        "--model-checkpoint", str(ckpt), "--db-path", str(db_path), "--level", "0",
        "--size", *map(str, NAIVE_GRID), "--num-samples", "1", "--batch-size", "1",
        "--tau", str(TOP_TAU), "--sampler", "naive", "--seed", str(seed), "--device", "cuda"]))
    torch.cuda.synchronize()
    t_naive = time.perf_counter() - t0
    got = launch_counts()
    out = np.asarray(create_or_load_db(db_path, 0)[0][new[0]]["data"])
    print(f"sample_embeddings --sampler naive --size {NAIVE_GRID} from the Fixup checkpoint: "
          f"{t_naive:.2f} s (host clock, one forward a voxel), grid {out.shape} codes "
          f"{out.min()}..{out.max()}; launches {({k_: v for k_, v in got.items() if v})} "
          f"[{ident}]")
    check_launches(got, dict.fromkeys(got, 0), "naive sampling of the Fixup checkpoint")
    if out.shape != NAIVE_GRID or out.min() < 0 or out.max() >= k:
        raise AssertionError("the naive sampler wrote a wrong grid")
    add_counts(counts, got)
    results["k5_sampling"] = dict(forced_s=t_forced, free_s=t_free, err=err / scale,
                                  naive_s=t_naive)


def phase_prior_variants(ident, counts, results, seed, work: Path):
    """Phase 23: the PixelCNN remainder (K4 at dropout 0.5 over 50 blocks,
    the published mid and bottom PixelCNN jobs, the Fixup, concat-activation
    and k = 5 options at the top width, and their sampling)."""
    t0 = time.perf_counter()
    variant_k4_dropout(ident, seed, results)
    t_a = time.perf_counter() - t0
    store = variant_store(work, seed)
    published_pixelcnn_jobs(ident, counts, seed, store, work, results)
    t_b = time.perf_counter() - t0 - t_a
    shapes = []
    prior_option_steps(ident, counts, seed, store, work, shapes, results)
    stage1_k7_checks(ident, seed, shapes)
    t_c = time.perf_counter() - t0 - t_a - t_b
    prior_option_sampling(ident, counts, seed, work, results)
    t_d = time.perf_counter() - t0 - t_a - t_b - t_c
    print(f"phase 23 parts: K4 at dropout 0.5 and the top steps {t_a:.1f} s, the mid and "
          f"bottom jobs {t_b:.1f} s, the options at the top width {t_c:.1f} s, sampling "
          f"{t_d:.1f} s")


# phase 24: data-parallel training (``vqvae3d_tpu_torch/parallel``). One card is
# reachable, so NCCL runs at world size 1 only, and two ranks share the card
# over gloo (which carries CUDA tensors through its all-reduces): the
# distributed step, kernels and all, against the one-process step on the same
# global batch of 2 (a volume or a code grid a rank)
DP_WORLD = 2
DP_TIMEOUT = 420  # seconds a subprocess of the phase may take
# the log of the two ranks against one process, each value within this of
# max(|ref|, 1): the global statistics summed in another order, and a row that
# a genuine tie sends to the other code moves the voxels it decodes (the
# loss and the gradients keep phase 5's tolerances)
DP_LOG_TOL = 1e-3
# a rank's place in the process group, set for every process the phase
# starts (the card's machine may carry a launcher's own values)
DP_ENV = ("SLURM_PROCID", "SLURM_NTASKS", "LOCAL_RANK")
DP_RANK = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.dp_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_processes(commands):
    """Start every (argv, env) at once, each in a process of its own."""
    return [subprocess.Popen(argv, env={**os.environ, **env}, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for argv, env in commands]


def wait_processes(procs, timeout: int = DP_TIMEOUT):
    """Wait for every process (killing any left at the end) and return their
    standard outputs; fail on a non-zero exit."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode:
                raise AssertionError(f"{p.args[3:6]}: exit {p.returncode}\n{err[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def dp_stage1_batch(seed, device, ranks):
    """The two-rank checks' stage-1 batch over ``ranks``: a synthetic volume a
    rank, rank 1's with 3/4 of its slices valid (the rest zero, as the loader
    pads)."""
    import torch

    parts = []
    valid = VOLUME[2] * 3 // 4
    for r in ranks:
        batch = synthetic_batch(seed + r, device)
        if r == 1:
            batch["volume"][:, :, :, valid:] = 0.0
            batch["num_valid_slices"].fill_(valid)
        parts.append(batch)
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def dp_prior_batch(seed, device, ranks):
    """The two-rank checks' top-prior batch over ``ranks``: a grid a rank."""
    import torch

    parts = [code_batch(seed + r, device) for r in ranks]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def dp_steps(model, opt, step, batch, stage1: bool, steps: int = 2):
    """``steps`` train steps, counted: per step the log, the launches, the
    gradient the optimizer took (``taken_gradient``) and, for stage 1, the
    K7 launches the model implies (``k7_expected``), the EMA state before
    the step and each level's rows and indices; then the final state_dict
    (host copies)."""
    import torch

    out, mu = [], torch.zeros_like(opt.mu, dtype=torch.float64).cpu()
    for _ in range(steps):
        rec, seen, calls, hooks = {}, {}, [], []
        if stage1:
            rec["before"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                             if ".quantize." in k}
            hooks = [q.register_forward_hook(lambda m, a, o, i=i: seen.__setitem__(i, (
                a[0].detach().float().movedim(1, -1).reshape(-1, a[0].shape[1]).cpu(),
                o[2].flatten().cpu()))) for i, q in enumerate(model.encoder.quantize)]
            hooks += k7_expected(model, calls)
        reset_counts()
        log = step(batch)
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        grads, mu = taken_gradient(model, opt, mu)
        rec.update(log={k: float(v) for k, v in log.items()}, launches=launch_counts(),
                   k7_expected=len(calls), seen=seen, grads=grads)
        out.append(rec)
    return out, {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def taken_gradient(model, opt, mu_prev):
    """(the gradient AMSGrad's last step took, by parameter on the host, and
    its first moment): under a process group the mean over ranks, which no
    parameter's ``.grad`` holds, read back from the first moment as g_n =
    (mu_n - b1 mu_n-1) / (1 - b1)."""
    mu = opt.mu.double().cpu()
    flat = ((mu - opt.b1 * mu_prev) / (1 - opt.b1)).float()
    named = list(model.named_parameters())
    return {n: g.view_as(p) for (n, p), g in
            zip(named, flat.split([p.numel() for _, p in named]))}, mu


def dp_models(seed, device, dtype):
    """((stage-1 model at the full config, stem 2, its AMSGrad, its train
    step), (the top prior, its AMSGrad, its train step)), seeded as phases 5
    and 10 seed them."""
    import torch
    from vqvae3d_tpu_torch.train import prior_train, vqvae_train
    from vqvae3d_tpu_torch.train.state import AMSGrad

    model, _ = make_model(2, seed, dtype, device)
    opt = AMSGrad(model.parameters(), lr=STAGE1_LR)
    prior = make_prior(TOP_PRIOR, seed + 51, device, dtype=dtype)
    popt = AMSGrad(prior.parameters(), lr=TOP_LR)
    return ((model, opt, vqvae_train.make_train_step(model, opt)),
            (prior, popt, prior_train.make_prior_train_step(prior, popt, seed=seed + 52)))


def dp_rank(work: str, port: int, seed: int) -> None:
    """One rank of phase 24 (b), run as ``DP_RANK`` with ``SLURM_PROCID`` and
    ``SLURM_NTASKS`` set: joins the gloo group on card 0, takes two fp32 steps
    of stage 1 and of the top prior on its slice of the global batch (saved
    to ``work``/dp_rank<r>.pt), then times a bf16 step of each while the other
    rank steps beside it on the same card."""
    import torch
    from vqvae3d_tpu_torch.parallel.multihost import barrier, initialize_multihost, rank, shutdown

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = initialize_multihost(f"127.0.0.1:{port}", backend="gloo", device="cuda")
    r = rank()
    stage1, prior = dp_models(seed, dev, torch.float32)
    saved = {"stage1": dp_steps(*stage1, dp_stage1_batch(seed + 2, dev, [r]), True),
             "prior": dp_steps(*prior, dp_prior_batch(seed + 50, dev, [r]), False)}
    torch.save(saved, Path(work) / f"dp_rank{r}.pt")
    del stage1, prior, saved
    torch.cuda.empty_cache()
    stage1, prior = dp_models(seed, dev, torch.bfloat16)
    ms = {}
    for name, (_, _, fn), batch in (("stage 1", stage1, dp_stage1_batch(seed + 2, dev, [r])),
                                    ("top prior", prior, dp_prior_batch(seed + 50, dev, [r]))):
        barrier()
        ms[name] = cuda_ms(lambda: fn(batch), iters=3, warmup=1)
    print(json.dumps({"rank": r, "bf16_ms": ms}))
    shutdown()


@contextlib.contextmanager
def no_gradient_average():
    """The train steps without their gradient all-reduce (the one-process
    step, with a process group present)."""
    from vqvae3d_tpu_torch.parallel import mesh

    kept = mesh.average_gradient
    mesh.average_gradient = lambda flat: None
    try:
        yield
    finally:
        mesh.average_gradient = kept


def dp_rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1.0)


def dp_grads(got: dict, want: dict):
    """Per tensor max|d| over max(max|ref|, 1e-3 of the largest gradient), as
    phase 5; returns ({name: error}, {name: absolute tolerance at
    STEP_GRAD_TOL})."""
    gmax = max(float(g.abs().max()) for g in want.values())
    scale = {n: max(float(g.abs().max()), 1e-3 * gmax) for n, g in want.items()}
    return ({n: float((got[n] - g).abs().max()) / scale[n] for n, g in want.items()},
            {n: STEP_GRAD_TOL * s for n, s in scale.items()})


def dp_check_params(state: dict, ref_state: dict, grads: dict, tols: dict, lr: float) -> float:
    """Parameters after two AMSGrad steps within its bound (a gradient within
    ``tol`` moves Adam's ratio of moments by at most ~2 tol / |g|, taken 4x
    for the mix of two steps, capped at two sign flips): the worst
    error over its bound."""
    worst = 0.0
    for n, g in grads.items():
        bound = lr * np.minimum(4.0, 4 * tols[n] / np.maximum(g.abs().numpy(), 1e-30)) + 1e-3 * lr
        worst = max(worst, float(((state[n] - ref_state[n]).abs().numpy() / bound).max()))
    return worst


def dp_compare(ident, name, ref, ranks, lr, stage1: bool, launches: dict,
               label: str = "two ranks (gloo, one card) vs one process on the global batch of 2",
               log_tol: float = DP_LOG_TOL, loss_tol: float = STEP_LOSS_TOL):
    """The two ranks against the one-process steps: the ranks' states bit for
    bit; per step the loss, the log, the gradients, the launches a rank, and
    for stage 1 each level's indices (equal but at genuine ties, judged on
    the reference's rows and lookup codebook); after two steps the
    parameters within the AMSGrad bound and, for stage 1, the EMA state on
    the codes no mismatched row touched (cluster_size exact there)."""
    import torch
    from vqvae3d_tpu_torch.models.quantizer import QuantizerState, ema_first_pass_init
    from vqvae3d_tpu_torch.ops import quantizer_ops

    (ref_steps, ref_state), (steps, state) = ref, ranks[0]
    differ = [k for k in state if not torch.equal(state[k], ranks[1][1][k])]
    if differ or [r["log"] for r in ranks[0][0]] != [r["log"] for r in ranks[1][0]]:
        raise AssertionError(f"{name}: the two ranks' states differ: {differ[:5]}")
    touched, worst_grad, tols = {}, 0.0, {}
    for n, (want, got) in enumerate(zip(ref_steps, steps), 1):
        loss_err = dp_rel(got["log"].get("loss", got["log"].get("loss_mean")),
                          want["log"].get("loss", want["log"].get("loss_mean")))
        log_key, log_err = max(((k, dp_rel(got["log"][k], v)) for k, v in want["log"].items()),
                               key=lambda kv: kv[1])
        err, tol = dp_grads(got["grads"], want["grads"])
        worst = sorted(err.items(), key=lambda kv: -kv[1])[:2]
        worst_grad = max(worst_grad, worst[0][1])
        tols = {k: max(tol[k], tols.get(k, 0.0)) for k in tol}
        for r, (rank_steps, _) in enumerate(ranks):
            check_launches(rank_steps[n - 1]["launches"], launches, f"{name} rank {r} step {n}")
        mism = []
        for lvl in sorted(want["seen"]):
            flat, b = want["seen"][lvl]
            q0 = QuantizerState(*(want["before"][f"encoder.quantize.{lvl}.{k}"] for k in
                                  ("embed", "embed_avg", "cluster_size", "first_pass")))
            embed = ema_first_pass_init(q0, flat).embed
            parts = [rank_steps[n - 1]["seen"][lvl][1] for rank_steps, _ in ranks]
            # a level that runs whole on a space group holds every row on each rank
            whole = parts[0].numel() == b.numel()
            if whole and not all(torch.equal(p, parts[0]) for p in parts):
                raise AssertionError(f"{name} step {n} level {lvl}: the ranks' whole level "
                                     f"differs")
            a = parts[0] if whole else torch.cat(parts)
            ties, real = quantizer_ops.genuine_ties(flat, embed, a, b)
            if real.numel():
                raise AssertionError(f"{name} step {n} level {lvl}: {real.numel()} index "
                                     f"mismatches beyond ties")
            diff = torch.nonzero(a != b).flatten()
            touched[lvl] = torch.unique(torch.cat([touched.get(lvl, diff[:0]), a[diff], b[diff]]))
            mism.append(f"level {lvl} {diff.numel()} (ties {ties.numel()})")
        print(f"fp32 {name} step {n}, {label}: "
              f"loss {got['log'].get('loss', got['log'].get('loss_mean')):.7g} "
              f"(rel {loss_err:.2e}); log worst rel {log_err:.2e} ({log_key}); gradients worst "
              + ", ".join(f"{k} {e:.2e}" for k, e in worst)
              + (f"; index mismatches {', '.join(mism)}" if mism else "")
              + f"; launches a rank {({k: v for k, v in rank_steps[n - 1]['launches'].items() if v})}"
              f" [{ident}]")
        if (loss_err > loss_tol or log_err > log_tol or worst[0][1] > STEP_GRAD_TOL
                or not np.isfinite(loss_err)):
            raise AssertionError(f"{name} step {n}: the two ranks disagree with one process")
    params = dict(ref_steps[-1]["grads"])
    param_err = dp_check_params(state, ref_state, params, tols, lr)
    ema_err, cs_exact = 0.0, True
    for k in (k for k in ref_state if ".quantize." in k and not k.endswith("first_pass")):
        keep = torch.ones(ref_state[k].shape[:1], dtype=torch.bool)
        keep[touched[int(k.split(".")[2])]] = False
        d = (state[k] - ref_state[k])[keep]
        if k.endswith("cluster_size"):
            cs_exact &= bool((d == 0).all())
        else:
            ema_err = max(ema_err, float(d.abs().max()) / max(float(ref_state[k].abs().max()), 1.0))
    ntouch = sum(t.numel() for t in touched.values())
    print(f"{name} after {len(steps)} step(s): parameters worst {param_err:.3f} of the AMSGrad "
          "bound"
          + (f"; EMA state rel {ema_err:.2e} and cluster_size "
             f"{'exact' if cs_exact else 'NOT exact'} on the codes no mismatched row touched "
             f"({ntouch} touched)" if stage1 else "") + f" [{ident}]")
    if param_err > 1.0 or ema_err > STEP_EMA_TOL or not cs_exact:
        raise AssertionError(f"{name}: the two ranks' state disagrees with one process")
    return dict(grad_worst=worst_grad, param_bound=param_err, ema_rel=ema_err,
                touched=ntouch)


def phase_data_parallel(ident, counts, results, seed, work: Path):
    import torch
    from vqvae3d_tpu_torch.cli import train_vqvae
    from vqvae3d_tpu_torch.parallel import mesh
    from vqvae3d_tpu_torch.parallel.multihost import initialize_multihost, shutdown

    here = str(Path(__file__).resolve().parent)
    # --- (c) a space axis needs a process group (phase 25 runs one)
    try:
        train_vqvae.main(train_vqvae.parse_arguments([str(work), "--mesh-shape", "2", "2",
                                                      "--device", "cuda"]))
    except ValueError as e:
        if "--multihost" not in str(e):
            raise
        print(f"--mesh-shape 2 2 without --multihost raises ValueError: {e}")
    else:
        raise AssertionError("--mesh-shape 2 2 did not raise")

    # --- (a) train_vqvae --multihost over NCCL at world size 1 against the same
    # command without it, side by side (cuDNN deterministic in both), started
    # now and compared after (b)'s one-process reference (not timed) has run
    # beside them
    ct = stage1_scans(work, seed)
    flags = [str(ct), "--batch-size", "1", "--num-embeddings", *map(str, FULL["num_embeddings"]),
             "--n-pre-quantization-blocks", "50", "--n-post-quantization-blocks", "50",
             "--n-post-downscale-blocks", "2", "--n-post-upscale-blocks", "3",
             "--stem-space-to-depth", "2", "--base-network-channels", "8",
             "--pad-mode", "wrap", "--scan-size", *map(str, VOLUME[:2]),
             "--output-depth", str(VOLUME[2]), "--val-every-steps", "2", "--max-steps", "2",
             "--log-every-n-steps", "1", "--num-workers", "2", "--device", "cuda"]
    env = {"CHIP_SMOKE_DETERMINISTIC": "1"}
    runs = {"multihost": [*flags, "--ckpt-dir", str(work / "dp_nccl"), "--multihost",
                          "--coordinator", f"127.0.0.1:{free_port()}", "--mesh-shape", "1"],
            "one process": [*flags, "--ckpt-dir", str(work / "dp_one")]}
    t0 = time.perf_counter()
    clis = start_processes([([sys.executable, "-c", FRESH_CLI, here, "train_vqvae", *argv],
                             {**env, **dict(zip(DP_ENV, ("0", "1", "0")))}
                             if name == "multihost" else env)
                            for name, argv in runs.items()])
    try:
        # --- (b) the one-process reference: fp32 steps on the global batch of 2
        dev = torch.device("cuda")
        stage1, prior = dp_models(seed, dev, torch.float32)
        cfg = stage1[0].config
        ref = {"stage1": dp_steps(*stage1, dp_stage1_batch(seed + 2, dev, range(DP_WORLD)), True),
               "prior": dp_steps(*prior, dp_prior_batch(seed + 50, dev, range(DP_WORLD)), False)}
        prior_launches = prior_step_launches(prior[0])
        k7_per_step = ref["stage1"][0][0]["k7_expected"]
        del stage1, prior
        torch.cuda.empty_cache()
    finally:
        outs = wait_processes(clis)
    cli_s = time.perf_counter() - t0
    for name, out in zip(runs, outs):
        lines = out.strip().splitlines()
        rec = json.loads(lines[-1])
        add_counts(counts, rec["launches"])
        print(f"train_vqvae {name}: {rec['seconds']:.1f} s in its process, launches "
              f"{({k: v for k, v in rec['launches'].items() if v})} [{ident}]\n"
              + "\n".join(lines[:-1]))
    differ = []
    for sub in ("", "best"):
        for suffix in (".pt", "_train.pt"):
            a, b = (torch.load(work / d / sub / f"step_2{suffix}", weights_only=True)
                    for d in ("dp_nccl", "dp_one"))
            a, b = (a["optimizer"], b["optimizer"]) if suffix == "_train.pt" else (a, b)
            differ += [f"{sub}/{k}" for k in a if not (
                torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k])]
    print(f"train_vqvae --multihost (NCCL, world size 1) and without it, side by side in "
          f"{cli_s:.1f} s (beside the fp32 reference below): checkpoints (parameters, EMA "
          f"state, optimizer moments, last and best) "
          f"{'bit-identical' if not differ else f'differ in {differ[:5]}'} [{ident}]")
    if differ:
        raise AssertionError(f"--multihost at world size 1 differs from one process: {differ[:5]}")

    # --- (b) two ranks on the one card over gloo against the reference above,
    # fp32, two steps from a first pass
    port = free_port()
    t0 = time.perf_counter()
    outs = wait_processes(start_processes(
        [([sys.executable, "-c", DP_RANK, here, str(work), str(port), str(seed)],
          dict(zip(DP_ENV, (str(r), str(DP_WORLD), "0")))) for r in range(DP_WORLD)]))
    ranks_s = time.perf_counter() - t0
    got = [torch.load(work / f"dp_rank{r}.pt", weights_only=False) for r in range(DP_WORLD)]
    blocks = sum(n for *_, n in cfg.same_stacks(VOLUME))
    want = dict(dict.fromkeys(launch_counts(), 0), l2_argmin_stats=cfg.n_enc,
                preact_stack_fwd=blocks, preact_stack_bwd=blocks, dw_conv3d=k7_per_step)
    pwant = dict(dict.fromkeys(launch_counts(), 0), **prior_launches)
    out = {"stage1": dp_compare(ident, "stage-1 (stem 2)", ref["stage1"],
                                [g["stage1"] for g in got], STAGE1_LR, True, want),
           "prior": dp_compare(ident, "top-prior", ref["prior"], [g["prior"] for g in got],
                               TOP_LR, False, pwant)}
    for g in got:
        for part in ("stage1", "prior"):
            for rec in g[part][0]:
                add_counts(counts, rec["launches"])
    timing = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    print(f"two ranks over gloo on one card: {ranks_s:.1f} s for both processes; bf16 ms a "
          "step (mean of 3 after 1 warm-up), each rank batch 1, the other rank stepping "
          "beside it on the same card (not a scaling figure: two processes share one card, "
          "and gloo stages every all-reduce through the host): "
          + "; ".join(f"rank {t['rank']} " + ", ".join(f"{k} {v:.2f}" for k, v in
                                                       t["bf16_ms"].items()) for t in timing)
          + f" [{ident}]")

    # --- (a) the data-parallel path's cost on one card: a bf16 step with and
    # without its gradient all-reduce (NCCL, world size 1), in turns
    kept_env = {k: os.environ.get(k) for k in DP_ENV}
    os.environ.update(zip(DP_ENV, ("0", "1", "0")))
    try:
        dev = initialize_multihost(f"127.0.0.1:{free_port()}", device="cuda")
        (model, opt, step), _ = dp_models(seed, dev, torch.bfloat16)
        batch = synthetic_batch(seed + 2, dev)
        step(batch)
        ms = {}
        for path in ("data-parallel", "no all-reduce") * 2:
            with no_gradient_average() if path == "no all-reduce" else contextlib.nullcontext():
                ms.setdefault(path, []).append(cuda_ms(lambda: step(batch), iters=3, warmup=1))
        flat = torch.zeros_like(opt.mu)
        ar_ms = cuda_ms(lambda: mesh.average_gradient(flat), iters=10, warmup=2)
        nbytes = flat.numel() * flat.element_size()
        print(f"bf16 stem-2 train step at world size 1 over NCCL (batch 1, {VOLUME}), in turns: "
              + "; ".join(f"{k} {', '.join(f'{v:.2f}' for v in vs)} ms" for k, vs in ms.items())
              + f"; the gradient all-reduce alone {ar_ms:.3f} ms a step ({nbytes} bytes: "
              f"{nbytes // 4} fp32 parameters) [{ident}]")
        del model, opt, step
    finally:
        shutdown()
        for k, v in kept_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    results["dp"] = dict(out, nccl_ms=ms, allreduce_ms=ar_ms, allreduce_bytes=nbytes,
                         gloo_bf16_ms=timing)


# phase 25: spatial sharding (``--mesh-shape d s``, ``parallel/halo.py``). Two
# gloo ranks share the card (NCCL refuses two ranks on one device) at
# ``--mesh-shape 1 2``: each holds one H slab of the volume, and the step
# against the one-process step on the same volume and weights
SP_SPACE = 2
SP_LOG_TOL = 1e-5  # the sharded log against one process, each value rel max(|ref|, 1)
# (d): a volume whose code grids have H 16 / 4 / 1 at stem 2, so at s = 2 the
# coarsest level runs whole on both ranks of the space group
SP_WHOLE_VOLUME = (64, 512, 128)
SP_CLI_DEPTH = 10  # the CLI run's pre- and post-quantization blocks a level (of 50)
SP_RANK = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.sp_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
"""


def sp_model(seed, device, dtype):
    """(model, AMSGrad, train step, eval step) at the full config, stem 2,
    seeded as phase 5 seeds it."""
    from vqvae3d_tpu_torch.train import vqvae_train
    from vqvae3d_tpu_torch.train.state import AMSGrad

    model, _ = make_model(2, seed, dtype, device)
    opt = AMSGrad(model.parameters(), lr=STAGE1_LR)
    return (model, opt, vqvae_train.make_train_step(model, opt),
            vqvae_train.make_eval_step(model))


def sp_slab(batch):
    """This rank's H slab of a batch (the whole batch without a space axis)."""
    from vqvae3d_tpu_torch.parallel import mesh

    s, i = mesh.space_size(), mesh.space_index()
    h = batch["volume"].shape[1] // s
    return {"volume": batch["volume"][:, i * h:(i + 1) * h].contiguous(),
            "num_valid_slices": batch["num_valid_slices"]}


def sp_eval(eval_step, batch):
    """One counted eval step: (its log, its launches)."""
    import torch

    reset_counts()
    log = eval_step(batch)
    torch.cuda.synchronize()
    return {k: float(v) for k, v in log.items()}, launch_counts()


def sp_whole_batch(seed, device):
    """(d)'s batch: one ``SP_WHOLE_VOLUME`` volume, its last quarter of
    slices zero (as the loader pads)."""
    batch = synthetic_batch(seed + 3, device, SP_WHOLE_VOLUME)
    valid = SP_WHOLE_VOLUME[2] * 3 // 4
    batch["volume"][:, :, :, valid:] = 0.0
    batch["num_valid_slices"].fill_(valid)
    return batch


def sp_whole_steps(seed, device):
    """(d) on this process's H slab of the ``SP_WHOLE_VOLUME`` batch (the
    whole volume without a space axis): the fp32 eval step and one fp32
    train step from a first pass with their peak memory, then a bf16 step's
    ms (mean of 3 after 1 warm-up, every rank at once) and peak memory."""
    import torch
    from vqvae3d_tpu_torch.parallel.multihost import barrier

    batch = sp_slab(sp_whole_batch(seed, device))
    model, opt, step, eval_step = sp_model(seed, device, torch.float32)
    torch.cuda.reset_peak_memory_stats()
    ev = sp_eval(eval_step, batch)
    steps, state = dp_steps(model, opt, step, batch, True, steps=1)
    out = {"eval": ev, "steps": steps, "state": state,
           "peak_fp32": torch.cuda.max_memory_allocated() / 2**30}
    del model, opt, step, eval_step
    torch.cuda.empty_cache()
    _, _, step, _ = sp_model(seed, device, torch.bfloat16)
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    barrier()
    out["bf16_ms"] = cuda_ms(lambda: step(batch), iters=3, warmup=1)
    out["peak_bf16"] = torch.cuda.max_memory_allocated() / 2**30
    del step
    torch.cuda.empty_cache()
    return out


def sp_rank(work: str, port: int, seed: int) -> None:
    """One rank of phase 25, run as ``SP_RANK`` with ``SLURM_PROCID`` and
    ``SLURM_NTASKS`` set: joins the gloo group on card 0 laid out as 1 x
    ``SP_SPACE``, takes the fp32 eval step and one fp32 train step from a
    first pass on its H slab of phase 24's rank-1 volume (saved to
    ``work``/sp_rank<r>.pt with its peak memory), then times a bf16 step
    while the other rank steps beside it on the same card."""
    import torch
    from vqvae3d_tpu_torch.parallel import mesh
    from vqvae3d_tpu_torch.parallel.multihost import barrier, initialize_multihost, rank, shutdown

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = initialize_multihost(f"127.0.0.1:{port}", backend="gloo", device="cuda")
    mesh.init_mesh(SP_SPACE)
    r = rank()
    batch = sp_slab(dp_stage1_batch(seed + 2, dev, [1]))
    model, opt, step, eval_step = sp_model(seed, dev, torch.float32)
    torch.cuda.reset_peak_memory_stats()
    ev = sp_eval(eval_step, batch)
    steps, state = dp_steps(model, opt, step, batch, True, steps=1)
    saved = {"eval": ev, "steps": steps, "state": state,
             "peak_fp32": torch.cuda.max_memory_allocated() / 2**30}
    del model, opt, step, eval_step
    torch.cuda.empty_cache()
    _, _, step, _ = sp_model(seed, dev, torch.bfloat16)
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    barrier()
    saved["bf16_ms"] = cuda_ms(lambda: step(batch), iters=3, warmup=1)
    saved["peak_bf16"] = torch.cuda.max_memory_allocated() / 2**30
    del step
    torch.cuda.empty_cache()
    saved["whole"] = sp_whole_steps(seed, dev)
    torch.save(saved, Path(work) / f"sp_rank{r}.pt")
    mesh.reset_mesh()
    shutdown()


def sp_reference(seed):
    """The one-process side: the fp32 eval step and train step on the whole
    volume, and the peak memory of the fp32 and of a bf16 step."""
    import torch

    dev = torch.device("cuda")
    batch = dp_stage1_batch(seed + 2, dev, [1])
    model, opt, step, eval_step = sp_model(seed, dev, torch.float32)
    torch.cuda.reset_peak_memory_stats()
    ev = sp_eval(eval_step, batch)
    steps, state = dp_steps(model, opt, step, batch, True, steps=1)
    out = {"eval": ev, "steps": steps, "state": state,
           "peak_fp32": torch.cuda.max_memory_allocated() / 2**30}
    del model, opt, step, eval_step
    torch.cuda.empty_cache()
    _, _, step, _ = sp_model(seed, dev, torch.bfloat16)
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(batch)
    torch.cuda.synchronize()
    out["peak_bf16"] = torch.cuda.max_memory_allocated() / 2**30
    del step
    torch.cuda.empty_cache()
    out["whole"] = sp_whole_steps(seed, dev)
    return out


def sp_compare(ident, name, ref, got, launches, eval_launches, **tols):
    """The two ranks' eval step and train step (``sp_rank``) against one
    process's (``sp_reference``): the eval logs equal across ranks and
    within ``SP_LOG_TOL`` of one process's, the launches a rank, then
    ``dp_compare`` (the step's log within ``SP_LOG_TOL`` unless ``tols``
    says otherwise). Returns ``dp_compare``'s figures and the eval error."""
    for r, g in enumerate(got):
        check_launches(g["eval"][1], eval_launches, f"{name}: the eval step, rank {r}")
    eval_err = max(dp_rel(got[0]["eval"][0][k], v) for k, v in ref["eval"][0].items())
    if got[0]["eval"][0] != got[1]["eval"][0] or set(got[0]["eval"][0]) != set(ref["eval"][0]):
        raise AssertionError(f"{name}: the two ranks' eval logs differ")
    print(f"fp32 eval step, {name}, {SP_SPACE} H slabs of one volume (gloo, one card) vs one "
          f"process: log worst rel {eval_err:.2e} (ssim {got[0]['eval'][0]['ssim']:.7g} over "
          f"the gathered slices); launches a rank "
          + "; ".join(f"rank {r} {({k: v for k, v in g['eval'][1].items() if v})}"
                      for r, g in enumerate(got)) + f" [{ident}]")
    if not eval_err <= SP_LOG_TOL:
        raise AssertionError(f"{name}: the sharded eval step disagrees with one process")
    out = dp_compare(ident, name, (ref["steps"], ref["state"]),
                     [(g["steps"], g["state"]) for g in got], STAGE1_LR, True, launches,
                     label=f"{SP_SPACE} H slabs of one volume (gloo, one card) vs one process",
                     **{"log_tol": SP_LOG_TOL, **tols})
    return dict(out, eval_rel=eval_err)


def sp_convert_and_serve(ident, counts, seed, work: Path):
    """The remainder's CLIs on the card: phase 3's fp32 stem-1 model (the
    same seed) written as a Lightning ``.ckpt``, converted by
    ``convert_checkpoint vqvae``, and one volume served from the converted
    checkpoint through K3 and K1a against phase 3's forward of it, bit for
    bit; then ``data_marginal`` over the stage-1 scans against
    ``np.histogram`` on the host."""
    import dataclasses

    import torch
    from vqvae3d_tpu_torch.checkpoint import load_model
    from vqvae3d_tpu_torch.cli import convert_checkpoint, data_marginal
    from vqvae3d_tpu_torch.data.ct_dataset import CTDataModule
    from vqvae3d_tpu_torch.data.transforms import create_cylinder_xy_mask, hu_window_normalize

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 1)  # phase 3's volume
    x = torch.from_numpy(hu_window_normalize(
        rng.integers(-1000, 1500, size=VOLUME, dtype=np.int16)))[None, None].to(dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model, cfg = make_model(1, seed, torch.float32, dev)
        with torch.inference_mode():
            want = model(x)[0]
        torch.save({"state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
                    "hyper_parameters": {}}, work / "reference.ckpt")
        del model
        flags = ["--num-embeddings", *map(str, FULL["num_embeddings"])]
        for k in ("n_pre_quantization_blocks", "n_post_quantization_blocks",
                  "n_post_downscale_blocks", "n_post_upscale_blocks", "pad_mode"):
            flags += ["--" + k.replace("_", "-"), str(FULL[k])]
        t0 = time.perf_counter()
        convert_checkpoint.main(convert_checkpoint.parse_arguments(
            ["vqvae", str(work / "reference.ckpt"), str(work / "converted"), *flags,
             "--device", "cuda"]))
        convert_s = time.perf_counter() - t0
        served, scfg = load_model(work / "converted", device=dev)
        if dataclasses.replace(scfg, dtype=cfg.dtype, base_lr=cfg.base_lr) != cfg:
            raise AssertionError(f"converted config {scfg} is not {cfg}")
        fp32 = type(served)(dataclasses.replace(scfg, dtype=torch.float32)).to(dev).eval()
        fp32.load_state_dict(served.state_dict())
        reset_counts()
        with torch.inference_mode():
            got = fp32(x)[0]
        torch.cuda.synchronize()
        launches = launch_counts()
        add_counts(counts, launches)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    blocks = sum(n for *_, n in cfg.same_stacks(VOLUME))
    check_launches(launches, dict(dict.fromkeys(launch_counts(), 0), l2_argmin=cfg.n_enc,
                                  preact_stack_fwd=blocks), "the converted checkpoint's forward")
    same = torch.equal(got, want)
    print(f"convert_checkpoint vqvae (a Lightning .ckpt of phase 3's fp32 stem-1 model, "
          f"{cfg.n_enc} levels, {cfg.n_pre_quantization_blocks} + "
          f"{cfg.n_post_quantization_blocks} blocks) in {convert_s:.1f} s; the converted "
          f"checkpoint's fp32 forward of phase 3's volume "
          f"{'bit-identical to' if same else 'DIFFERS from'} phase 3's "
          f"(max|d| {float((got - want).abs().max()):.3g}); launches "
          f"{({k: v for k, v in launches.items() if v})} [{ident}]")
    if not same:
        raise AssertionError("the converted checkpoint serves another volume")
    del served, fp32, got, want
    torch.cuda.empty_cache()

    ct = stage1_scans(work, seed)
    out = work / "marginal.npz"
    t0 = time.perf_counter()
    data_marginal.main(data_marginal.parse_arguments(
        [str(ct), "--out", str(out), "--scan-size", *map(str, VOLUME[:2]), "--device", "cuda"]))
    marginal_s = time.perf_counter() - t0
    edges = np.linspace(-0.5, 4.0, 513)
    host, n = np.zeros(512, np.int64), 0
    for batch in CTDataModule(str(ct), batch_size=1, train_frac=1.0,
                              size=(*VOLUME[:2], None)).train_dataloader(epoch=0):
        vol = batch["volume"][0, ..., 0]
        host += np.histogram(vol[create_cylinder_xy_mask(vol.shape[:2])], bins=edges)[0]
        n += 1
    with np.load(out) as z:
        same = np.array_equal(z["counts"], host) and int(z["num_scans"]) == n
        total = int(z["counts"].sum())
    print(f"data_marginal over {n} synthetic {VOLUME} scans on the card in {marginal_s:.1f} s: "
          f"{total} voxels binned, counts {'equal to' if same else 'DIFFER from'} "
          f"np.histogram on the host [{ident}]")
    if not same:
        raise AssertionError("data_marginal's counts differ from np.histogram")


def phase_spatial(ident, counts, results, seed, work: Path):
    import torch
    from vqvae3d_tpu_torch.models.vqvae import VQVAEConfig

    here = str(Path(__file__).resolve().parent)
    # --- (c) train_vqvae --multihost --mesh-shape 1 2 through the CLI: two gloo
    # ranks on the card, 2 steps and a validation, at SP_CLI_DEPTH blocks a stack,
    # started now and read after the one-process reference has run beside it
    ct = stage1_scans(work, seed)
    depth = str(SP_CLI_DEPTH)
    flags = [str(ct), "--batch-size", "1", "--num-embeddings", *map(str, FULL["num_embeddings"]),
             "--n-pre-quantization-blocks", depth, "--n-post-quantization-blocks", depth,
             "--n-post-downscale-blocks", "2", "--n-post-upscale-blocks", "3",
             "--stem-space-to-depth", "2", "--base-network-channels", "8",
             "--pad-mode", "wrap", "--scan-size", *map(str, VOLUME[:2]),
             "--output-depth", str(VOLUME[2]), "--val-every-steps", "2", "--max-steps", "2",
             "--log-every-n-steps", "1", "--num-workers", "2", "--device", "cuda",
             "--ckpt-dir", str(work / "sp_cli"), "--multihost", "--coordinator",
             f"127.0.0.1:{free_port()}", "--mesh-shape", "1", str(SP_SPACE)]
    t0 = time.perf_counter()
    clis = start_processes([([sys.executable, "-c", FRESH_CLI, here, "train_vqvae", *flags],
                             {"CHIP_SMOKE_BACKEND": "gloo",
                              **dict(zip(DP_ENV, (str(r), str(SP_SPACE), "0")))})
                            for r in range(SP_SPACE)])
    try:
        ref = sp_reference(seed)
    finally:
        outs = wait_processes(clis)
    cli_s = time.perf_counter() - t0
    cfg = VQVAEConfig(**dict(FULL, n_pre_quantization_blocks=SP_CLI_DEPTH,
                             n_post_quantization_blocks=SP_CLI_DEPTH), **STEM2)
    blocks = sum(n for *_, n in cfg.same_stacks(VOLUME))
    # 2 steps (K3 fwd and bwd, K1b, K7) and a validation of the one val scan (K3 fwd, K1a)
    cli_want = dict(dict.fromkeys(launch_counts(), 0), preact_stack_fwd=3 * blocks,
                    preact_stack_bwd=2 * blocks, l2_argmin_stats=2 * cfg.n_enc,
                    l2_argmin=cfg.n_enc, dw_conv3d=2 * ref["steps"][0]["k7_expected"])
    for r, out in enumerate(outs):
        lines = out.strip().splitlines()
        rec = json.loads(lines[-1])
        add_counts(counts, rec["launches"])
        got = rec["launches"]
        check_launches(got, cli_want, f"train_vqvae --mesh-shape 1 {SP_SPACE} rank {r}")
        print(f"train_vqvae --multihost --mesh-shape 1 {SP_SPACE} rank {r} (gloo, one card; "
              f"{SP_CLI_DEPTH} + {SP_CLI_DEPTH} blocks a level, full widths): "
              f"{rec['seconds']:.1f} s in its process, launches "
              f"{({k: v for k, v in got.items() if v})} [{ident}]"
              + ("\n" + "\n".join(lines[:-1]) if r == 0 else ""))
    if not (work / "sp_cli" / "latest.txt").exists():
        raise AssertionError("train_vqvae --mesh-shape 1 2 wrote no checkpoint")
    print(f"the CLI's two ranks and the one-process reference beside them: {cli_s:.1f} s")

    # --- (a) the two ranks' fp32 eval step and train step against one process
    port = free_port()
    t0 = time.perf_counter()
    wait_processes(start_processes(
        [([sys.executable, "-c", SP_RANK, here, str(work), str(port), str(seed)],
          dict(zip(DP_ENV, (str(r), str(SP_SPACE), "0")))) for r in range(SP_SPACE)]))
    ranks_s = time.perf_counter() - t0
    got = [torch.load(work / f"sp_rank{r}.pt", weights_only=False) for r in range(SP_SPACE)]
    full = VQVAEConfig(**FULL, **STEM2)
    blocks = sum(n for *_, n in full.same_stacks(VOLUME))
    k7_per_step = ref["steps"][0]["k7_expected"]
    want = dict(dict.fromkeys(launch_counts(), 0), l2_argmin_stats=full.n_enc,
                preact_stack_fwd=blocks, preact_stack_bwd=blocks, dw_conv3d=k7_per_step)
    eval_want = dict(dict.fromkeys(launch_counts(), 0), l2_argmin=full.n_enc,
                     preact_stack_fwd=blocks)
    for g in got:
        for part in (g, g["whole"]):
            add_counts(counts, part["eval"][1])
            for rec in part["steps"]:
                add_counts(counts, rec["launches"])
    out = sp_compare(ident, f"stage-1 (stem 2, {VOLUME})", ref, got, want, eval_want)
    print(f"peak device memory a rank (two ranks on one card; {ranks_s:.1f} s for both "
          f"processes): fp32 step "
          + ", ".join(f"{g['peak_fp32']:.2f}" for g in got)
          + f" GiB against one process's {ref['peak_fp32']:.2f}; bf16 step "
          + ", ".join(f"{g['peak_bf16']:.2f}" for g in got)
          + f" GiB against {ref['peak_bf16']:.2f}. bf16 ms a step a rank (mean of 3 after 1 "
          "warm-up; two ranks on one card, not a scaling figure: both step at once and gloo "
          "stages every exchange through the host): "
          + ", ".join(f"rank {r} {g['bf16_ms']:.2f}" for r, g in enumerate(got))
          + f" [{ident}]")

    # --- (d) a volume whose coarsest level runs whole on both ranks
    volume = SP_WHOLE_VOLUME
    whole_from = full.first_whole_level(volume[0], SP_SPACE)
    if whole_from != full.n_enc - 1:
        raise AssertionError(f"{volume} at s = {SP_SPACE}: level {whole_from} is the first "
                             f"whole one, not the coarsest")
    wref, wgot = ref["whole"], [g["whole"] for g in got]
    k7_whole = wref["steps"][0]["k7_expected"]
    wwant = dict(want, dw_conv3d=k7_whole)
    # the loss within SP_LOG_TOL; the rest of the step's log within phase 24's
    # DP_LOG_TOL: a genuine tie at level 0 moves a count of 1 in 65,536 rows,
    # ~1e-5 of the codebook's perplexity
    wout = sp_compare(ident, f"stage-1 (stem 2, {volume}, level {whole_from} whole)", wref,
                      wgot, wwant, eval_want, loss_tol=SP_LOG_TOL, log_tol=DP_LOG_TOL)
    print(f"{volume} (code grids H {[h for h, *_ in full.code_grid_shapes(volume)]}; level "
          f"{whole_from} whole on both ranks): launches a train step "
          + "; ".join(f"rank {r} K1b {g['steps'][0]['launches']['l2_argmin_stats']} K3 "
                      f"{g['steps'][0]['launches']['preact_stack_fwd']} fwd "
                      f"{g['steps'][0]['launches']['preact_stack_bwd']} bwd K7 "
                      f"{g['steps'][0]['launches']['dw_conv3d']}"
                      for r, g in enumerate(wgot))
          + "; peak device memory a rank: fp32 step "
          + ", ".join(f"{g['peak_fp32']:.2f}" for g in wgot)
          + f" GiB against one process's {wref['peak_fp32']:.2f}; bf16 step "
          + ", ".join(f"{g['peak_bf16']:.2f}" for g in wgot)
          + f" GiB against {wref['peak_bf16']:.2f}. bf16 ms a step (mean of 3 after 1 warm-up; "
          "both ranks on one card at once): "
          + ", ".join(f"rank {r} {g['bf16_ms']:.2f}" for r, g in enumerate(wgot))
          + f", one process alone {wref['bf16_ms']:.2f} [{ident}]")

    # --- (b) the remainder's CLIs on the card
    sp_convert_and_serve(ident, counts, seed, work)
    results["spatial"] = dict(out, peak_fp32=[g["peak_fp32"] for g in got],
                              peak_bf16=[g["peak_bf16"] for g in got],
                              ref_peak_fp32=ref["peak_fp32"], ref_peak_bf16=ref["peak_bf16"],
                              bf16_ms=[g["bf16_ms"] for g in got],
                              whole=dict(wout, peak_fp32=[g["peak_fp32"] for g in wgot],
                                         peak_bf16=[g["peak_bf16"] for g in wgot],
                                         bf16_ms=[g["bf16_ms"] for g in wgot],
                                         ref_bf16_ms=wref["bf16_ms"]))


# phase 26: the convergence tools (vqvae3d_tpu_torch/tools/) for a few steps,
# each leg that resumes in a fresh process, and the serving CLIs on what they train
CONV_SCANS = 2  # generated scans (the tool's default is 12)
CONV_RES, CONV_BLOCKS = 256, 150  # the tool's defaults: the downscaled config's
CONV_LEGS = (3, 2)  # the stage-1 tool: steps, then resumed steps
PRIOR_LEGS = (4, 2)  # the prior tool, against the same number uninterrupted
PRIOR_EVAL_EVERY = 2
FRESH_TOOL = """
import importlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke
torch.backends.cudnn.deterministic = True
tool = importlib.import_module("vqvae3d_tpu_torch.tools." + sys.argv[2])
k7_calls, restored = [], {}
if hasattr(tool, "VQVAE"):  # K7's launches counted apart from its wrapper
    model_class = tool.VQVAE
    def built(*args, **kwargs):
        model = model_class(*args, **kwargs)
        chip_smoke.k7_expected(model, k7_calls)
        return model
    tool.VQVAE = built
restore_name = next(n for n in ("restore_train_state", "restore_prior_train_state")
                    if hasattr(tool, n))
restore = getattr(tool, restore_name)
def recorded(path, model, optimizer):
    step = restore(path, model, optimizer)
    restored.update(step=step, digest=chip_smoke.state_digest(model, optimizer))
    return step
setattr(tool, restore_name, recorded)
chip_smoke.reset_counts()
t0 = time.perf_counter()
model, optimizer, step = tool.main(tool.parse_arguments(sys.argv[3:]))
torch.cuda.synchronize()
print(json.dumps(dict(seconds=time.perf_counter() - t0, step=step, restored=restored,
                      digest=chip_smoke.state_digest(model, optimizer), k7_calls=len(k7_calls),
                      launches=chip_smoke.launch_counts())))
"""


def state_digest(model, optimizer) -> dict:
    """SHA-256 of every tensor of the model's state_dict (parameters and the
    EMA codebook buffers) and of the optimizer's state, bytes as they are;
    the optimizer's count as it is."""
    import hashlib

    import torch

    out = {}
    for prefix, state in (("model.", model.state_dict()), ("optimizer.", optimizer.state_dict())):
        for k, v in state.items():
            out[prefix + k] = (hashlib.sha256(v.detach().reshape(-1).view(torch.uint8).cpu()
                                              .numpy().tobytes()).hexdigest()
                               if torch.is_tensor(v) else v)
    return out


def start_tool(name: str, argv):
    """Start ``vqvae3d_tpu_torch.tools.<name>`` with ``argv`` in a process of
    its own (``FRESH_TOOL``)."""
    return start_processes([([sys.executable, "-c", FRESH_TOOL,
                              str(Path(__file__).resolve().parent), name, *argv], {})])


def tool_result(procs) -> dict:
    """Print a ``start_tool`` process's output and return its last line's record."""
    lines = wait_processes(procs)[0].strip().splitlines()
    print("\n".join(lines[:-1]))
    return json.loads(lines[-1])


def tool_records(out: Path) -> list:
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def untimed(records: list, steps) -> list:
    """The records of ``steps`` without their clock readings."""
    return [{k: v for k, v in r.items() if k not in ("time", "wall_step_ms", "cuda_step_ms")}
            for r in records if r["step"] in steps]


def check_resume(name: str, first: dict, second: dict, at: int):
    """The resumed leg restored step ``at`` and, bit for bit, the state the
    first leg saved (its parameters, EMA buffers and optimizer state)."""
    if second["restored"].get("step") != at:
        raise AssertionError(f"{name}: the resumed leg started at {second['restored']}")
    differ = [k for k, v in first.items() if second["restored"]["digest"].get(k) != v]
    if differ or len(first) != len(second["restored"]["digest"]):
        raise AssertionError(f"{name}: the restored state differs from the saved one in {differ}")


def conv_stage1_leg(cfg, out: dict, steps: int, volume) -> dict:
    """The launches of a stage-1 tool leg of ``steps`` steps: K1b a level,
    K3 forward and backward a block a step, K7 as its hooks counted."""
    blocks = sum(n for *_, n in cfg.same_stacks(volume))
    return dict(dict.fromkeys(out["launches"], 0), l2_argmin_stats=cfg.n_enc * steps,
                preact_stack_fwd=blocks * steps, preact_stack_bwd=blocks * steps,
                dw_conv3d=out["k7_calls"])


def conv_prior_launches(per_step: dict, steps: int, evals: int, launches: dict) -> dict:
    return dict(dict.fromkeys(launches, 0), causal_stack_fwd=per_step["causal_stack_fwd"]
                * (steps + evals), causal_stack_bwd=per_step["causal_stack_bwd"] * steps,
                dw_conv3d=per_step["dw_conv3d"] * steps)


def conv_times(records: list) -> str:
    """The logged steps' mean times after step 1; (a) and (b) share the card,
    so these are not the tools' speeds (the full runs' logs have those)."""
    wall = [r["wall_step_ms"] for r in records if "wall_step_ms" in r and r["step"] > 1]
    cuda = [r["cuda_step_ms"] for r in records if "cuda_step_ms" in r and r["step"] > 1]
    return (f"ms a step after the first, the card shared by (a) and (b): wall "
            f"{np.mean(wall):.2f}, CUDA events {np.mean(cuda):.2f}")


def phase_convergence_tools(ident, counts, work: Path):
    """(a) the stage-1 tool, (b) the prior tool, (c) the serving CLIs on (a)'s
    checkpoint; (a)'s legs and (b)'s resumed leg in processes of their own,
    (a)'s beside (b)'s work."""
    import torch
    from vqvae3d_tpu_torch.cli import calc_ssim_from_checkpoint, decode_embeddings, \
        extract_embeddings
    from vqvae3d_tpu_torch.data import nrrd_io
    from vqvae3d_tpu_torch.tools import convergence_smoke as conv
    from vqvae3d_tpu_torch.tools import prior_convergence_smoke as prior

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as in FRESH_TOOL: bit-identical steps
    started = []  # every tool process, stopped on the way out if a check failed first

    def start(name, argv):
        started.extend(start_tool(name, argv))
        return started[-1:]

    try:
        # --- (a) leg 1 of the stage-1 tool runs while (b) starts here
        ct, run = work / "conv_ct", work / "conv_run"
        volume = (CONV_RES, CONV_RES, 128)  # depth 110 padded to 128
        flags = ["--data", str(ct), "--out", str(run), "--n-vols", str(CONV_SCANS),
                 "--res", str(CONV_RES), "--blocks", str(CONV_BLOCKS), "--log-every", "1",
                 "--workers", "2", "--device", "cuda"]
        cfg = conv.downscaled_config(CONV_BLOCKS)
        t0 = time.perf_counter()
        leg1 = start("convergence_smoke", flags + ["--steps", str(CONV_LEGS[0])])

        # --- (b) the prior tool: the first leg and the uninterrupted run here,
        # the resumed leg in a process of its own
        n = sum(PRIOR_LEGS)
        pcfg = prior.top_prior_config()
        samples = [prior.synth_codes(1000 + i, prior.DIMS, pcfg.input_dim, prior.COND_DIMS,
                                     pcfg.condition_dim) for i in range(n)]
        heldout = prior.synth_codes(prior.HELDOUT_SEED, prior.DIMS, pcfg.input_dim,
                                    prior.COND_DIMS, pcfg.condition_dim)
        pflags = dict(log_every=1, eval_every=PRIOR_EVAL_EVERY, device="cuda")
        legs, whole = work / "prior_legs", work / "prior_whole"
        evals = [len({s for s in range(a + 1, b + 1) if s % PRIOR_EVAL_EVERY == 0} | {b})
                 for a, b in ((0, PRIOR_LEGS[0]), (PRIOR_LEGS[0], n), (0, n))]
        runs = {}
        for name, out, steps, ev in (("leg 1", legs, PRIOR_LEGS[0], evals[0]),
                                     ("uninterrupted", whole, n, evals[2])):
            reset_counts()
            model, opt, step = prior.run(pcfg, samples, heldout, out, steps=steps,
                                         resume_steps=0, **pflags)
            torch.cuda.synchronize()
            per_step = prior_step_launches(model)
            check_launches(launch_counts(), conv_prior_launches(per_step, steps, ev,
                                                                launch_counts()),
                           f"prior tool {name}")
            runs[name] = dict(step=step, digest=state_digest(model, opt),
                              launches=launch_counts())
            del model, opt
        leg2 = start("prior_convergence_smoke", [
            "--out", str(legs), "--resume-steps", str(PRIOR_LEGS[1]), "--n-samples", str(n),
            "--log-every", "1", "--eval-every", str(PRIOR_EVAL_EVERY), "--device", "cuda"])
        out1 = tool_result(leg1)
        # (a)'s resumed leg in a fresh process, beside (b)'s
        leg2a = start("convergence_smoke", flags + ["--resume-steps", str(CONV_LEGS[1])])
        out2 = tool_result(leg2)

        # (b)'s checks
        check_resume("prior tool", runs["leg 1"]["digest"], out2, PRIOR_LEGS[0])
        check_launches(out2["launches"], conv_prior_launches(per_step, PRIOR_LEGS[1], evals[1],
                                                             out2["launches"]),
                       "prior tool, resumed leg")
        if out2["step"] != n or out2["digest"] != runs["uninterrupted"]["digest"]:
            raise AssertionError(f"prior tool: {PRIOR_LEGS[0]} + {PRIOR_LEGS[1]} resumed steps "
                                 f"(to step {out2['step']}) differ from {n} uninterrupted ones")
        tail = range(PRIOR_LEGS[0] + 1, n + 1)
        if untimed(tool_records(legs), tail) != untimed(tool_records(whole), tail):
            raise AssertionError(f"prior tool: the logs of steps {list(tail)} differ")
        precs = tool_records(legs)
        print(f"prior tool (top prior, bf16): {PRIOR_LEGS[0]} steps here + {PRIOR_LEGS[1]} "
              f"resumed in a fresh process ({out2['seconds']:.1f} s) bit-identical to {n} "
              f"uninterrupted steps (parameters, AMSGrad state, the logs of steps "
              f"{list(tail)}); train bits/dim "
              f"{[round(r['train_bits_per_dim'], 4) for r in precs if 'train_bits_per_dim' in r]}"
              f", val {[round(r['val_bits_per_dim'], 4) for r in precs if 'val_bits_per_dim' in r]}"
              f"; {conv_times(precs)}; launches the resumed leg "
              f"{({k: v for k, v in out2['launches'].items() if v})} [{ident}]")

        # --- (a)'s checks
        out2a = tool_result(leg2a)
        check_resume("stage-1 tool", out1["digest"], out2a, CONV_LEGS[0])
        for name, out, steps in (("leg 1", out1, CONV_LEGS[0]), ("resumed leg", out2a,
                                                                  CONV_LEGS[1])):
            check_launches(out["launches"], conv_stage1_leg(cfg, out, steps, volume),
                           f"stage-1 tool {name}")
        records = tool_records(run)
        if ([r["step"] for r in records] != list(range(1, sum(CONV_LEGS) + 1))
                or out2a["step"] != sum(CONV_LEGS)
                or not all(np.isfinite(v) for r in records for v in r.values())):
            raise AssertionError(f"stage-1 tool: steps {[r['step'] for r in records]}, "
                                 f"or a value not finite")
        print(f"stage-1 tool (downscaled config, stem 2, {CONV_BLOCKS} + {CONV_BLOCKS} blocks a "
              f"level, bf16, {CONV_SCANS} generated scans {volume}): {CONV_LEGS[0]} steps "
              f"({out1['seconds']:.1f} s, scans generated included) + {CONV_LEGS[1]} resumed in "
              f"a fresh process ({out2a['seconds']:.1f} s), the restored parameters, EMA and "
              f"AMSGrad state bit-identical to the saved; losses "
              f"{[round(r['train_loss'], 4) for r in records]}, perplexity "
              f"{[round(r['train_codebook_perplexity_0'], 2) for r in records]} / "
              f"{[round(r['train_codebook_perplexity_1'], 2) for r in records]}; "
              f"{conv_times(records)}; launches a leg "
              f"{[{k: v for k, v in o['launches'].items() if v} for o in (out1, out2a)]} "
              f"[{ident}]")

        # --- (c) the serving CLIs on (a)'s checkpoint
        size = ["--scan-size", *map(str, volume[:2]), "--output-depth", str(volume[2])]
        stacks = cfg.same_stacks(volume)
        k3 = {p: sum(n for q, _, _, n in stacks if q == p) for p in ("encode", "decode")}
        total = {k: out1["launches"][k] + out2a["launches"][k] + out2["launches"][k]
                 + runs["leg 1"]["launches"][k] + runs["uninterrupted"]["launches"][k]
                 for k in out1["launches"]}
        reset_counts()
        extract_embeddings.main(extract_embeddings.parse_arguments([
            "--checkpoint-path", str(run), "--dataset-path", str(ct), "--output-path", str(work),
            "--output-name", "conv_codes", "--rescale-input", "0", "--backend", "file",
            "--device", "cuda", *size]))
        torch.cuda.synchronize()
        got = launch_counts()
        check_launches(got, dict(dict.fromkeys(got, 0), l2_argmin=cfg.n_enc * CONV_SCANS,
                                 preact_stack_fwd=k3["encode"] * CONV_SCANS), "extract_embeddings")
        codes = extract_embeddings.read_codes(work / "conv_codes")
        if (len(codes) != CONV_SCANS
                or any([g.shape for g in grids] != cfg.code_grid_shapes(volume) for grids in codes)
                or any(g.min() < 0 or g.max() >= k for grids in codes
                       for g, k in zip(grids, cfg.num_embeddings, strict=True))):
            raise AssertionError("extract_embeddings on the tool's checkpoint: wrong grids")
        for k in total:
            total[k] += got[k]
        decode_embeddings.code_store_to_sample_db(work / "conv_codes", work / "conv.db")
        reset_counts()
        decoded = work / "conv_decoded"
        n_dec = decode_embeddings.main(decode_embeddings.parse_arguments([
            str(work / "conv.db"), str(run), str(decoded / "v"), "--volume-shape",
            *map(str, volume), "--device", "cuda"]))
        torch.cuda.synchronize()
        got = launch_counts()
        check_launches(got, dict(dict.fromkeys(got, 0), preact_stack_fwd=k3["decode"] * n_dec),
                       "decode_embeddings")
        vols = [nrrd_io.read(f)[0] for f in sorted(decoded.glob("*.nrrd"))]
        # the ELU's floor is -1: HU -2000; a NaN would land at INT_MIN
        if n_dec != CONV_SCANS or any(v.shape != volume or v.min() < -2000 for v in vols):
            raise AssertionError("decode_embeddings on the tool's checkpoint: wrong volumes")
        for k in total:
            total[k] += got[k]
        reset_counts()
        ssim = calc_ssim_from_checkpoint.main(calc_ssim_from_checkpoint.parse_arguments(
            [str(run), str(ct), "--device", "cuda", *size]))
        torch.cuda.synchronize()
        got = launch_counts()
        n_ssim = sum(v["n"] for v in ssim.values())
        check_launches(got, dict(dict.fromkeys(got, 0), l2_argmin=cfg.n_enc * n_ssim,
                                 preact_stack_fwd=(k3["encode"] + k3["decode"]) * n_ssim),
                       "calc_ssim_from_checkpoint")
        if n_ssim != CONV_SCANS or not all(np.isfinite(v["ssim_mean"])
                                           and -1 <= v["ssim_mean"] <= 1 for v in ssim.values()):
            raise AssertionError(f"calc_ssim_from_checkpoint on the tool's checkpoint: {ssim}")
        for k in total:
            total[k] += got[k]
            counts[k] = counts.get(k, 0) + total[k]
        print(f"serving the stage-1 tool's step-{sum(CONV_LEGS)} checkpoint: extract_embeddings "
              f"grids {[g.shape for g in codes[0]]}, decode_embeddings {n_dec} volumes {volume} "
              f"(HU {min(int(v.min()) for v in vols)}..{max(int(v.max()) for v in vols)}), "
              f"calc_ssim_from_checkpoint {ssim}; the phase's launches "
              f"{({k: v for k, v in total.items() if v})}; phase wall "
              f"{time.perf_counter() - t0:.1f} s [{ident}]")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for p in started:
            if p.poll() is None:
                p.kill()
                p.wait()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phases", default="",
                        help="comma-separated phase numbers to run (a probe: no kernels line "
                             "and no result line); default all")
    args = parser.parse_args()
    only = {int(n) for n in args.phases.split(",") if n}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to check", file=sys.stderr)
        return 2
    try:
        import vqvae3d_tpu_torch  # noqa: F401
        from vqvae3d_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 3

    # fp32 comparisons need true fp32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ident = card_identity()
    print(ident)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"built {lib.name} from {[s.name for s in _build.sources()]} in "
          f"{time.perf_counter() - t0:.1f} s")

    failed, results, counts = [], {}, {}
    with tempfile.TemporaryDirectory(prefix="vqvae3d_smoke_") as tmp:
        phases = [
            ("kernels vs plain", lambda: phase_kernels(ident, results, args.seed)),
            ("main path", lambda: phase_main_path(
                ident, counts, args.seed, N_VOLUMES, Path(tmp))),
            ("full forward", lambda: phase_forward(ident, args.seed)),
            ("train kernels vs plain", lambda: phase_train_kernels(ident, results, args.seed)),
            ("train step", lambda: phase_train_step(ident, args.seed, results)),
            ("train CLI", lambda: phase_train_cli(ident, counts, results, args.seed, Path(tmp))),
            ("sampling kernels vs plain", lambda: phase_sample_kernels(ident, results, args.seed)),
            ("sampling main path", lambda: phase_sample_main_path(
                ident, counts, results, args.seed, Path(tmp))),
            ("prior train kernels vs plain", lambda: phase_prior_kernels(
                ident, results, args.seed)),
            ("prior train step", lambda: phase_prior_step(ident, args.seed, results)),
            ("prior train CLI", lambda: phase_prior_cli(ident, counts, args.seed, Path(tmp))),
            ("attention kernels vs plain", lambda: phase_attention_kernels(
                ident, results, args.seed)),
            ("PixelSNAIL train steps", lambda: phase_snail_steps(ident, args.seed, results)),
            ("PixelSNAIL train CLI", lambda: phase_snail_cli(ident, counts, args.seed, Path(tmp))),
            ("wide sampling kernel vs plain", lambda: phase_wide_k6_kernels(
                ident, results, args.seed)),
            ("wide sampling main path", lambda: phase_wide_sample_main_path(
                ident, counts, results, args.seed, Path(tmp))),
            ("dropout attention kernel vs plain", lambda: phase_dropout_attention_kernels(
                ident, results, args.seed)),
            ("PixelSNAIL train step with attention dropout", lambda: phase_dropout_snail_step(
                ident, args.seed, results)),
            ("PixelSNAIL train CLI with attention dropout", lambda: phase_dropout_snail_cli(
                ident, counts, args.seed, Path(tmp))),
            ("PixelSNAIL sampling vs the one-shot forward", lambda: phase_snail_sampling(
                ident, results, args.seed)),
            ("PixelSNAIL sampling main path", lambda: phase_snail_sample_main_path(
                ident, counts, results, args.seed, Path(tmp))),
            ("stage-1 block types and published configs", lambda: phase_stage1_variants(
                ident, counts, results, args.seed, Path(tmp))),
            ("the PixelCNN remainder", lambda: phase_prior_variants(
                ident, counts, results, args.seed, Path(tmp))),
            ("data-parallel training", lambda: phase_data_parallel(
                ident, counts, results, args.seed, Path(tmp))),
            ("spatial sharding and the remainder's CLIs", lambda: phase_spatial(
                ident, counts, results, args.seed, Path(tmp))),
            ("the convergence tools", lambda: phase_convergence_tools(
                ident, counts, Path(tmp))),
        ]
        for number, (name, fn) in enumerate(phases, 1):
            if only and number not in only:
                continue
            t0 = time.perf_counter()
            print(f"=== phase: {name}", flush=True)
            try:
                fn()
                print(f"=== phase {name}: ok in {time.perf_counter() - t0:.1f} s", flush=True)
            except Exception:  # report every phase, then fail the run
                traceback.print_exc()
                print(f"=== phase {name}: FAILED", flush=True)
                failed.append(name)
            torch.cuda.empty_cache()
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if only:
        print(f"chip_smoke: phases {sorted(only)} ok (a probe: no result)")
        return 0
    meta = {
        "l2_argmin": ("vqvae3d_tpu_torch/csrc/l2_argmin.cu", "vqvae3d_tpu/ops/quantizer_ops.py:106"),
        "l2_argmin_stats": ("vqvae3d_tpu_torch/csrc/l2_argmin_stats.cu",
                            "vqvae3d_tpu/ops/quantizer_ops.py:197"),
        "preact_stack_fwd": ("vqvae3d_tpu_torch/csrc/preact_stack.cu",
                             "vqvae3d_tpu/ops/stack_kernel.py:968"),
        "preact_stack_bwd": ("vqvae3d_tpu_torch/csrc/preact_stack_bwd.cu",
                             "vqvae3d_tpu/ops/stack_kernel.py:1112"),
        "dw_conv3d": ("vqvae3d_tpu_torch/csrc/dw_conv3d.cu", "vqvae3d_tpu/ops/pallas_conv.py:151"),
        "row_decode": ("vqvae3d_tpu_torch/csrc/row_decode.cu", "vqvae3d_tpu/ops/decode_row.py:290"),
        "causal_stack_fwd": ("vqvae3d_tpu_torch/csrc/causal_stack.cu",
                             "vqvae3d_tpu/ops/causal_kernel.py:532"),
        "causal_stack_bwd": ("vqvae3d_tpu_torch/csrc/causal_stack_bwd.cu",
                             "vqvae3d_tpu/ops/causal_kernel.py:612"),
        "flash_attention_fwd": ("vqvae3d_tpu_torch/csrc/flash_attention.cu",
                                "vqvae3d_tpu/models/causal_blocks.py:675"),
        "flash_attention_bwd": ("vqvae3d_tpu_torch/csrc/flash_attention_bwd.cu",
                                "vqvae3d_tpu/models/causal_blocks.py:675"),
        "row_decode_wide": ("vqvae3d_tpu_torch/csrc/row_decode_wide.cu",
                            "vqvae3d_tpu/ops/decode_row.py:290"),
        "flash_dropout_attention_fwd": ("vqvae3d_tpu_torch/csrc/flash_dropout_attention.cu",
                                        "vqvae3d_tpu/ops/flash_dropout_attention.py:365"),
        "flash_dropout_attention_bwd": ("vqvae3d_tpu_torch/csrc/flash_dropout_attention_bwd.cu",
                                        "vqvae3d_tpu/ops/flash_dropout_attention.py:365"),
    }
    missing = [name for name in meta if not counts.get(name)]
    if missing:
        print(f"chip_smoke: no launch on the main paths of {missing}", file=sys.stderr)
        return 1
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **{k: results[name][k] for k in keys}}
        for name, (src, rep) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
