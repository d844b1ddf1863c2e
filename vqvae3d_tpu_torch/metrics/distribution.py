"""Logistic-mixture likelihoods: the discretized-logistic head's loss and
sampling.

Counterpart of ``vqvae3d_tpu/metrics/distribution.py`` (reference
metrics/distribution.py): ``logistic_log_prob``, ``logistic_sample``,
``mixture_nll_loss``, ``sample_mixture`` and ``generic_nll_loss``. The
mixture components lie on the last axis. Randomness comes from an explicit
``torch.Generator``; ``logistic_sample`` and ``sample_mixture`` also take
the uniforms as data (``u``), so that a caller can feed the draws of
another generator.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

U_EPS = 1e-6  # the uniforms are drawn in [U_EPS, 1 - U_EPS), as the JAX package draws them


def logistic_log_prob(x: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """log pdf of Logistic(loc, scale) at x (elementwise)."""
    z = (x - loc) / scale
    return -z - 2.0 * F.softplus(-z) - torch.log(scale)


def uniforms(shape, *, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> torch.Tensor:
    """Uniform draws in [U_EPS, 1 - U_EPS)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return U_EPS + (1.0 - 2 * U_EPS) * u


def logistic_sample(loc: torch.Tensor, scale: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A draw of Logistic(loc, scale) by the inverse sigmoid of a uniform:
    ``u`` if given, else drawn from ``generator``."""
    if u is None:
        u = uniforms(loc.shape, generator=generator, dtype=loc.dtype, device=loc.device)
    return loc + scale * (torch.log(u) - torch.log1p(-u))


def mixture_nll_loss(x: torch.Tensor, mixture_comp_logits: torch.Tensor, loc: torch.Tensor,
                     scale: torch.Tensor, reduce_sum: bool = True) -> torch.Tensor:
    """NLL of x (...,) under a logistic mixture whose logits, locs and scales
    are (..., n_mix)."""
    log_pi = F.log_softmax(mixture_comp_logits, dim=-1)
    log_prob = logistic_log_prob(x[..., None], loc, scale)
    nll = -torch.logsumexp(log_pi + log_prob, dim=-1)
    return torch.sum(nll) if reduce_sum else nll


def sample_mixture(mixture_comp_logits: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor,
                   greedy: bool = True, *, generator: Optional[torch.Generator] = None,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A draw of the mixture: the argmax component when ``greedy`` (the
    lowest index at a tie), else a categorical draw by the Gumbel-max trick;
    then the logistic draw of that component (``u`` as in
    ``logistic_sample``)."""
    if greedy:
        comp = torch.argmax(mixture_comp_logits, dim=-1)
    else:
        g = uniforms(mixture_comp_logits.shape, generator=generator,
                     dtype=mixture_comp_logits.dtype, device=mixture_comp_logits.device)
        comp = torch.argmax(mixture_comp_logits - torch.log(-torch.log(g)), dim=-1)
    loc_sel = torch.gather(loc, -1, comp[..., None])[..., 0]
    scale_sel = torch.gather(scale, -1, comp[..., None])[..., 0]
    return logistic_sample(loc_sel, scale_sel, generator=generator, u=u)


def generic_nll_loss(x: torch.Tensor, log_prob_fn, reduce_sum: bool = True,
                     **dist_kwargs) -> torch.Tensor:
    """-log p(x) under any log-prob function."""
    nll = -log_prob_fn(x, **dist_kwargs)
    return torch.sum(nll) if reduce_sum else nll
