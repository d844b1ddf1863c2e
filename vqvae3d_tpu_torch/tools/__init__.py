"""Run tools of the port: long training runs that check convergence and a
fresh-process resume (``python -m vqvae3d_tpu_torch.tools.<name>``).

  * ``convergence_smoke``: the stage-1 VQ-VAE, the downscaled 2-level config,
    on synthetic CT-like volumes;
  * ``prior_convergence_smoke``: the published top prior (PixelCNN 50 x 16d)
    on structured synthetic code grids.

Counterparts of the JAX package's ``tools/convergence_smoke.py`` and
``tools/prior_convergence_smoke.py``, with the same configs, synthetic data
and loops.
"""
