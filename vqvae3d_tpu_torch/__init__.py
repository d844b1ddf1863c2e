"""vqvae3d_tpu_torch — the PyTorch/CUDA port of ``vqvae3d_tpu`` for NVIDIA Hopper.

The JAX package ``vqvae3d_tpu`` is the reference; this package mirrors its
subpackage and module names (``ops/``, ``models/``, ``cli/``) so each module's
counterpart is easy to find. It imports ``torch`` and never ``jax``: the only
modules it shares with the reference are the numpy-only data modules
(``vqvae3d_tpu.data.{nrrd_io,ct_dataset,transforms,code_store,sample_db}``).

Scope so far: stage-1 serving (encode → quantize → decode), inference only.

  * Activations use the reference torch layout (B, C, H, W, D); weights use
    the reference torch state_dict keys and shapes (O, I, kH, kW, kD).
  * The TPU kernels on this path are hand-written CUDA C++ for ``sm_90a``
    under ``csrc/``, built at first use by ``ops/_build.py``:
    K1 (codebook lookup, ``ops/quantizer_ops.py``) and K3 (the 'same'-block
    stack forward, ``ops/stack_kernel.py``). Each wrapper runs its plain
    PyTorch version on a CPU tensor and launches its kernel (or raises) on a
    CUDA tensor.
  * The TPU layout devices of the JAX package (folded I/O, packed stacks,
    block-space s2d convs, stack folds) are not ported: they are exact
    re-expressions of the same math for TPU VMEM and 128-lane padding.
"""

__version__ = "0.1.0"
