"""MIMO batch transforms and the uncertainty decomposition.

Counterpart of ``mimo_unet_tpu/transforms.py`` (reference
mimo/models/utils.py:51-101).  The MIMO axis sits at position 1:
``[B, S, ...]``.  The train-time input transform comes with the train step.
"""

from __future__ import annotations

from typing import Tuple

import torch


def repeat_subnetworks(x: torch.Tensor, num_subnetworks: int) -> torch.Tensor:
    """[B, ...] -> [B, S, ...] by tiling (eval-time input sharing)."""
    return x.unsqueeze(1).expand(x.shape[0], num_subnetworks,
                                 *x.shape[1:]).contiguous()


def flatten_subnetwork_dimension(x: torch.Tensor) -> torch.Tensor:
    """[B, S, ...] -> [B*S, ...]."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def compute_uncertainties(criterion, y_preds: torch.Tensor,
                          log_params: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, aleatoric_var, epistemic_var), each [B, ...], from [B, S, ...]
    predictions: aleatoric = E_S[std_s^2], epistemic = unbiased Var_S[mu_s]
    (zero when S == 1)."""
    s = y_preds.shape[1]
    mean = criterion.mode(y_preds, log_params).mean(dim=1)
    aleatoric = torch.square(criterion.std(y_preds, log_params)).mean(dim=1)
    if s > 1:
        mu_bar = y_preds.mean(dim=1, keepdim=True)
        epistemic = torch.square(y_preds - mu_bar).sum(dim=1) / (s - 1)
    else:
        epistemic = torch.zeros_like(aleatoric)
    return mean, aleatoric, epistemic
