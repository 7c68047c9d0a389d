"""Regression metrics (r2/mae/mse/rmse/mape).

Counterpart of ``mimo_unet_tpu/metrics.py`` (reference mimo/metrics.py:7-34):
the same five functions of ``(y_hat, y, weights=None)`` and the same
``get_metric``, on flattened tensors, optionally weighted (0/1 weights keep
padded rows out of the statistics).

``compute_regression_metrics`` makes every metric from weighted sums
(``_sums``, ``_FROM_SUMS``), which ``reduce`` (a sum over the ranks of a
mesh) may combine first: they are then the metrics of every rank's rows
together, as a data-parallel or spatially split step needs them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

_EPS = 1.17e-06  # torchmetrics MAPE epsilon


def _wmean(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of ``x``, weighted by ``w`` (same shape) when given: with 0/1
    weights, the mean over the selected elements."""
    if w is None:
        return x.mean()
    return (x * w).sum() / w.sum()


def mean_absolute_error(y_hat, y, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _wmean((y_hat - y).abs(), weights)


def mean_squared_error(y_hat, y, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _wmean(torch.square(y_hat - y), weights)


def root_mean_squared_error(y_hat, y, weights: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    return torch.sqrt(mean_squared_error(y_hat, y, weights))


def r2_score(y_hat, y, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    if weights is None:
        ss_res = torch.square(y - y_hat).sum()
        ss_tot = torch.square(y - y.mean()).sum()
    else:
        ss_res = (weights * torch.square(y - y_hat)).sum()
        ss_tot = (weights * torch.square(y - _wmean(y, weights))).sum()
    return 1.0 - ss_res / ss_tot


def mean_absolute_percentage_error(y_hat, y, weights: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    return _wmean((y_hat - y).abs() / torch.clamp(y.abs(), min=_EPS), weights)


_METRICS = {
    "mae": mean_absolute_error,
    "mse": mean_squared_error,
    "rmse": root_mean_squared_error,
    "r2": r2_score,
    "mape": mean_absolute_percentage_error,
}


def get_metric(metric: str):
    """The metric ``metric``, a function of ``(y_hat, y, weights=None)``."""
    try:
        return _METRICS[metric]
    except KeyError:
        raise ValueError(f"Unknown metric: {metric}") from None


# each metric from the weighted sums of ``_sums``: n (the weight), sae, sse
# and sape (absolute, squared and absolute-percentage errors), ss_tot (the
# spread of y about its mean)
_FROM_SUMS = {
    "mae": lambda t: t["sae"] / t["n"],
    "mse": lambda t: t["sse"] / t["n"],
    "rmse": lambda t: torch.sqrt(t["sse"] / t["n"]),
    "r2": lambda t: 1.0 - t["sse"] / t["ss_tot"],
    "mape": lambda t: t["sape"] / t["n"],
}


def _from_sums(metric: str):
    """The metric ``metric`` as a function of ``_sums``' dict."""
    try:
        return _FROM_SUMS[metric]
    except KeyError:
        raise ValueError(f"Unknown metric: {metric}") from None


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _sums(y_hat, y, w, reduce, with_spread: bool) -> Dict[str, torch.Tensor]:
    """The weighted sums the metrics are made of, each passed through
    ``reduce``: one call for the sums, a second for r2's spread about the
    (reduced) mean."""
    def wsum(x):
        return x.sum() if w is None else (w * x).sum()

    err = y_hat - y
    n = torch.tensor(float(y.numel()), device=y.device) if w is None else w.sum()
    n, sy, sae, sse, sape = reduce(torch.stack([
        n, wsum(y), wsum(err.abs()), wsum(err.square()),
        wsum(err.abs() / torch.clamp(y.abs(), min=_EPS))]))
    out = {"n": n, "sae": sae, "sse": sse, "sape": sape}
    if with_spread:
        out["ss_tot"] = reduce(wsum(torch.square(y - sy / n))[None])[0]
    return out


def compute_regression_metrics(y_hat: torch.Tensor, y: torch.Tensor,
                               metrics: Optional[List[str]] = None,
                               weights: Optional[torch.Tensor] = None,
                               reduce: Callable[[torch.Tensor], torch.Tensor] = _identity
                               ) -> Dict[str, torch.Tensor]:
    """Flattened-tensor regression metrics, default ['r2','mae','mse','rmse'];
    ``weights`` broadcast to ``y``.  ``reduce`` sums a 1-D tensor over
    the ranks of a mesh: the metrics are then those of all ranks' rows."""
    if metrics is None:
        metrics = ["r2", "mae", "mse", "rmse"]
    fns = {m: _from_sums(m) for m in metrics}
    if weights is not None:
        weights = torch.broadcast_to(weights, y.shape).reshape(-1).float()
    sums = _sums(y_hat.detach().float().reshape(-1), y.detach().float().reshape(-1),
                 weights, reduce, "r2" in metrics)
    return {m: fn(sums) for m, fn in fns.items()}

