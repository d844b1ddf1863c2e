"""The optimizer of stage-1 training: AMSGrad as optax computes it.

Counterpart of ``vqvae3d_tpu/train/state.py``: the JAX train state uses
``optax.flatten(optax.amsgrad(lr, 0.9, 0.999, 1e-8))`` (reference: Adam with
``amsgrad=True``, torch defaults). optax's ``scale_by_amsgrad`` keeps the
running maximum of the **bias-corrected** second moment,

    mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g²
    nu_max = max(nu_max, nu / (1 - b2^t));  p -= lr (mu / (1 - b1^t)) / (sqrt(nu_max) + eps)

while ``torch.optim.Adam(amsgrad=True)`` takes the maximum of the raw second
moment and divides by the current bias correction; the two differ from the
second step on. The port follows optax. As ``optax.flatten`` does, the state
is one flat fp32 vector over all parameters (one fused update per step
instead of one per tensor); the bias corrections are computed in fp32, as
optax does.
"""
from __future__ import annotations

from typing import Iterable

import torch

from vqvae3d_tpu_torch.parallel import mesh


def amsgrad_update(grad: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                   nu_max: torch.Tensor, count: int, lr: float, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8) -> torch.Tensor:
    """One AMSGrad step on flat tensors: updates mu, nu and nu_max in place
    for step ``count`` (1 on the first call) and returns the parameter update
    (to be added to the parameters)."""
    mu.mul_(b1).add_(grad, alpha=1 - b1)
    nu.mul_(b2).add_(grad * grad, alpha=1 - b2)
    f32 = dict(dtype=torch.float32, device=grad.device)
    bc1 = 1 - torch.tensor(b1, **f32) ** count
    bc2 = 1 - torch.tensor(b2, **f32) ** count
    torch.maximum(nu_max, nu / bc2, out=nu_max)
    return (mu / bc1) / (torch.sqrt(nu_max) + eps) * (-lr)


class AMSGrad:
    """AMSGrad over a list of parameters, the state flat (``optax.flatten``).
    A parameter without a gradient counts as a zero gradient, as in JAX.
    Under a process group the flat gradient is summed over the space axis
    and averaged over the data axis before the update
    (``parallel.mesh.average_gradient``: one all-reduce, and the parameters'
    own ``.grad`` stay the rank's), so every rank takes the global batch's
    step and holds the same parameters, bit for bit."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        n = sum(p.numel() for p in self.params)
        dev = self.params[0].device
        self.mu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.nu = torch.zeros_like(self.mu)
        self.nu_max = torch.zeros_like(self.mu)
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        grad = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in self.params]).float()
        mesh.average_gradient(grad)
        update = amsgrad_update(grad, self.mu, self.nu, self.nu_max, self.count,
                                self.lr, self.b1, self.b2, self.eps)
        parts = update.split([p.numel() for p in self.params])
        torch._foreach_add_(self.params, [u.view_as(p) for u, p in zip(parts, self.params)])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "nu_max": self.nu_max, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        for name in ("mu", "nu", "nu_max"):
            getattr(self, name).copy_(state[name])
        self.count = int(state["count"])
