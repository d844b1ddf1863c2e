"""Reconstruction metrics of the port."""
from vqvae3d_tpu_torch.metrics.evaluate import nmse, psnr, ssim2d, ssim3d_slices
from vqvae3d_tpu_torch.metrics.distribution import (
    logistic_log_prob,
    mixture_nll_loss,
    sample_mixture,
    generic_nll_loss,
)
from vqvae3d_tpu_torch.metrics.baur import baur_loss_3d
