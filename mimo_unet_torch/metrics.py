"""Regression metrics (r2/mae/mse/rmse/mape).

Counterpart of ``mimo_unet_tpu/metrics.py`` (reference mimo/metrics.py:7-34):
same names and formulas, on flattened tensors, optionally weighted (0/1
weights keep padded rows out of the statistics).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

_EPS = 1.17e-06  # torchmetrics MAPE epsilon


def _wmean(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    if w is None:
        return x.mean()
    return (x * w).sum() / w.sum()


def mean_absolute_error(y_hat, y, weights=None):
    return _wmean(torch.abs(y_hat - y), weights)


def mean_squared_error(y_hat, y, weights=None):
    return _wmean(torch.square(y_hat - y), weights)


def root_mean_squared_error(y_hat, y, weights=None):
    return torch.sqrt(mean_squared_error(y_hat, y, weights))


def r2_score(y_hat, y, weights=None):
    if weights is None:
        ss_res = torch.square(y - y_hat).sum()
        ss_tot = torch.square(y - y.mean()).sum()
    else:
        ss_res = (weights * torch.square(y - y_hat)).sum()
        ss_tot = (weights * torch.square(y - _wmean(y, weights))).sum()
    return 1.0 - ss_res / ss_tot


def mean_absolute_percentage_error(y_hat, y, weights=None):
    return _wmean(torch.abs(y_hat - y) / torch.clamp(torch.abs(y), min=_EPS),
                  weights)


_METRICS = {
    "mae": mean_absolute_error,
    "mse": mean_squared_error,
    "rmse": root_mean_squared_error,
    "r2": r2_score,
    "mape": mean_absolute_percentage_error,
}


def get_metric(metric: str):
    try:
        return _METRICS[metric]
    except KeyError:
        raise ValueError(f"Unknown metric: {metric}") from None


def compute_regression_metrics(y_hat: torch.Tensor, y: torch.Tensor,
                               metrics: Optional[List[str]] = None,
                               weights: Optional[torch.Tensor] = None
                               ) -> Dict[str, torch.Tensor]:
    """Flattened-tensor regression metrics, default ['r2','mae','mse','rmse'];
    ``weights`` broadcast to ``y``."""
    if metrics is None:
        metrics = ["r2", "mae", "mse", "rmse"]
    if weights is not None:
        weights = torch.broadcast_to(weights, y.shape).reshape(-1)
    y_hat = y_hat.detach().reshape(-1)
    y = y.detach().reshape(-1)
    return {m: get_metric(m)(y_hat, y, weights) for m in metrics}
