"""vqvae3d_tpu_torch — the PyTorch/CUDA port of ``vqvae3d_tpu`` for NVIDIA Hopper.

The JAX package ``vqvae3d_tpu`` is the reference; this package mirrors its
subpackage and module names (``ops/``, ``models/``, ``train/``, ``data/``,
``metrics/``, ``sample/``, ``cli/``, ``parallel/``) so each module's counterpart is easy to find. It
imports ``torch`` and never ``jax``, and nothing of ``vqvae3d_tpu``: the
numpy-only data modules it needs are its own copies under ``data/``, whose
on-disk formats (NRRD, code store, sample DB) stay interchangeable with the
JAX package's.

Scope so far: stage-1 serving (encode → quantize → decode), the stage-1
train step with its CLI (``cli/train_vqvae.py``), sampling of code grids
from a PixelCNN prior of any width (``sample/``, ``cli/sample_embeddings.py``),
and training of the PixelCNN and PixelSNAIL priors (``cli/train_prior.py``),
either train CLI data parallel over several cards (``parallel/``,
``--multihost``).

  * Activations use the reference torch layout (B, C, H, W, D); weights use
    the reference torch state_dict keys and shapes (O, I, kH, kW, kD).
  * The TPU kernels on these paths are hand-written CUDA C++ for ``sm_90a``
    under ``csrc/``, built at first use by ``ops/_build.py``: K1a/K1b
    (codebook lookup, lookup + EMA statistics, ``ops/quantizer_ops.py``),
    K3 (the 'same'-block stack forward and backward, ``ops/stack_kernel.py``),
    K7 (small-channel conv weight gradient, ``ops/conv3d.py``), K6 (one
    row of cached PixelCNN sampling, narrow and wide, ``ops/decode_row.py``),
    K4 (PixelCNN's causal segment, ``ops/causal_kernel.py``) and K8 (causal
    flash attention, ``ops/flash_attention.py``). Each
    wrapper runs its plain PyTorch version on a CPU tensor and launches its
    kernel (or raises) on a CUDA tensor.
  * The TPU layout devices of the JAX package (folded I/O and folded loss,
    packed stacks, block-space s2d convs, stack folds) are not ported: they
    are exact re-expressions of the same math for TPU VMEM and 128-lane
    padding.
"""

__version__ = "0.3.0"
