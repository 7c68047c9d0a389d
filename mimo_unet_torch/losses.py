"""Probabilistic regression losses: Gaussian and Laplace NLL.

Counterpart of ``mimo_unet_tpu/losses.py`` (reference mimo/losses.py:39-192).
The reference clamps the exponentiated parameter in place under
``torch.no_grad()``: the forward sees the clamped value, the backward the
unclamped ``exp``.  ``_clamp_no_grad`` is that straight-through composition.
The evidential loss is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _clamp_no_grad(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Forward: clamp(x, lo, hi).  Backward: identity (straight-through)."""
    return x + (torch.clamp(x, lo, hi) - x).detach()


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
