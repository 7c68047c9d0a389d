"""MIMO batch transforms and the uncertainty decomposition.

Counterpart of ``mimo_unet_tpu/transforms.py`` (reference
mimo/models/utils.py:51-101).  The MIMO axis sits at position 1:
``[B, S, ...]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def apply_input_transform(generator: torch.Generator, image: torch.Tensor,
                          label: torch.Tensor, mask: Optional[torch.Tensor],
                          num_subnetworks: int,
                          input_repetition_probability: float = 0.0,
                          batch_repetitions: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]]:
    """Per-subnetwork shuffled batches [B*reps, S, ...] from [B, ...]
    (``mimo_unet_tpu/transforms.py:26-63``, reference
    mimo/models/utils.py:27-35): a main permutation of the batch, tiled
    ``batch_repetitions`` times; its first ``(1 - p)`` fraction is
    re-shuffled independently per subnetwork, the tail is shared.  The
    permutations are drawn on the CPU from ``generator`` (torch's numbers,
    not JAX's) and the gather runs on the data's device."""
    b = image.shape[0]
    main = torch.randperm(b, generator=generator).repeat(batch_repetitions)
    to_shuffle = int(main.shape[0] * (1.0 - input_repetition_probability))
    indices = torch.stack([
        torch.cat([main[:to_shuffle][torch.randperm(to_shuffle,
                                                    generator=generator)],
                   main[to_shuffle:]])
        for _ in range(num_subnetworks)])  # [S, B*reps]

    def gather(x):
        # [B, ...] -> [B*reps, S, ...]
        return x[indices.to(x.device)].transpose(0, 1)

    return (gather(image), gather(label),
            gather(mask) if mask is not None else None)


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
