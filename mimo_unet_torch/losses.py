"""Probabilistic regression losses: Gaussian and Laplace NLL, and the
evidential (Normal-Inverse-Gamma) loss.

Counterpart of ``mimo_unet_tpu/losses.py`` (reference mimo/losses.py:39-271).
The reference clamps the exponentiated parameter in place under
``torch.no_grad()``: the forward sees the clamped value, the backward the
unclamped ``exp``.  ``_clamp_no_grad`` is that straight-through composition.
``EvidentialLoss`` reads the four NIG parameters channels-last, ``[..., 4]``,
as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


class _ClampNoGrad(torch.autograd.Function):
    """Forward: clamp(x, lo, hi).  Backward: identity (straight-through).
    Not ``x + (clamp(x) - x).detach()``, the JAX package's composition: at
    an ``exp`` that overflowed (x = inf) that is inf - inf = NaN, where the
    reference's in-place clamp gives ``hi`` (ROADMAP C.6)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _clamp_no_grad(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Forward: clamp(x, lo, hi).  Backward: identity (straight-through)."""
    return _ClampNoGrad.apply(x, lo, hi)


class UncertaintyLoss:
    """Interface of the reference losses (losses.py:4-36)."""

    @classmethod
    def from_name(cls, name: str) -> "UncertaintyLoss":
        if name == "gaussian_nll":
            return GaussianNLL()
        if name == "laplace_nll":
            return LaplaceNLL()
        raise ValueError(f"Unknown loss function: {name}")

    @property
    def name(self) -> str:
        raise NotImplementedError

    def __call__(self, y_hat, log_param, y, *, mask=None, reduce_mean=True):
        raise NotImplementedError

    def std(self, mu, log_param):
        raise NotImplementedError

    def mode(self, mu, log_param):
        return mu

    def calculate_dist_param(self, std, *, log: bool = False):
        raise NotImplementedError


class GaussianNLL(UncertaintyLoss):
    """NLL of N(y_hat, var) up to constants: log(var) + diff^2/var."""

    def __init__(self, eps_min: float = 1e-5, eps_max: float = 1e3):
        self.eps_min = eps_min
        self.eps_max = eps_max

    @property
    def name(self) -> str:
        return "gaussian_nll"

    def __call__(self, y_hat: torch.Tensor, log_variance: torch.Tensor,
                 y: torch.Tensor, *, mask: Optional[torch.Tensor] = None,
                 reduce_mean: bool = True) -> torch.Tensor:
        variance = _clamp_no_grad(torch.exp(log_variance), self.eps_min,
                                  self.eps_max)
        loss = torch.log(variance) + torch.square(y_hat - y) / variance
        if mask is not None:
            loss = loss * mask
        return loss.mean() if reduce_mean else loss

    def std(self, mu, log_variance):
        return torch.exp(log_variance) ** 0.5

    def calculate_dist_param(self, std, *, log: bool = False):
        param = _clamp_no_grad(torch.square(std), self.eps_min, self.eps_max)
        return torch.log(param) if log else param


class LaplaceNLL(UncertaintyLoss):
    """NLL of Laplace(y_hat, b) up to constants: log(b) + |diff|/b."""

    def __init__(self, eps_min: float = 1e-5, eps_max: float = 1e3):
        self.eps_min = eps_min
        self.eps_max = eps_max

    @property
    def name(self) -> str:
        return "laplace_nll"

    def __call__(self, y_hat: torch.Tensor, log_scale: torch.Tensor,
                 y: torch.Tensor, *, mask: Optional[torch.Tensor] = None,
                 reduce_mean: bool = True) -> torch.Tensor:
        scale = _clamp_no_grad(torch.exp(log_scale), self.eps_min, self.eps_max)
        loss = torch.log(scale) + torch.abs(y_hat - y) / scale
        if mask is not None:
            loss = loss * mask
        return loss.mean() if reduce_mean else loss

    def std(self, mu, log_scale):
        # std of Laplace(b) = b * sqrt(2)
        return torch.exp(log_scale) * math.sqrt(2.0)

    def calculate_dist_param(self, std, *, log: bool = False):
        param = _clamp_no_grad(std / math.sqrt(2.0), self.eps_min, self.eps_max)
        return torch.log(param) if log else param


def evidential_nig_loss(mu: torch.Tensor, v: torch.Tensor, alpha: torch.Tensor,
                        beta: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Deep evidential regression sum-of-squares loss + regulariser,
    elementwise (reference losses.py:203-238, ``mimo_unet_tpu/losses.py``
    ``evidential_nig_loss``): the gamma ratio is ``exp(lgamma)`` over
    ``exp(lgamma)``, as there, overflow included."""
    def gamma_fn(x):
        return torch.exp(torch.lgamma(x))

    coeff = gamma_fn(alpha - 0.5) / (4.0 * gamma_fn(alpha) * v * torch.sqrt(beta))
    second_term = 2.0 * beta * (1.0 + v) + (2.0 * alpha - 1.0) * v * torch.square(
        targets - mu)
    l_sos = coeff * second_term
    l_reg = torch.square(targets - mu) * (2.0 * alpha + v)
    return l_sos + l_reg


class EvidentialLoss:
    """Normal-Inverse-Gamma evidential loss (reference losses.py:195-271).
    ``evidential_output`` packs (gamma, v, alpha, beta) on the last axis,
    ``[B, H, W, 4]``; ``y_true`` is ``[B, H, W, 1]``."""

    num_distribution_params = 4

    def __init__(self, coeff: float = 1.0):
        self.coeff = coeff

    @property
    def name(self) -> str:
        return "evidential"

    def __call__(self, evidential_output: torch.Tensor, y_true: torch.Tensor, *,
                 mask: Optional[torch.Tensor] = None,
                 reduce_mean: bool = False) -> torch.Tensor:
        gamma, v, alpha, beta = evidential_output.unbind(-1)
        loss = evidential_nig_loss(gamma, v, alpha, beta, y_true.squeeze(-1))
        if mask is not None:
            loss = loss * mask
        return loss.mean() if reduce_mean else loss

    @staticmethod
    def mode(evidential_output):
        return evidential_output[..., 0]

    @staticmethod
    def aleatoric_var(evidential_output):
        alpha, beta = evidential_output[..., 2], evidential_output[..., 3]
        return beta / (alpha - 1.0)

    @staticmethod
    def epistemic_var(evidential_output):
        v, alpha, beta = (evidential_output[..., 1], evidential_output[..., 2],
                          evidential_output[..., 3])
        return beta / (v * (alpha - 1.0))
