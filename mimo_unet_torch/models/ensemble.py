"""Inference-time ensembling over MIMO U-Net members.

Counterpart of ``mimo_unet_tpu/models/ensemble.py`` (reference
mimo/models/ensemble.py:35-115) for in-memory members: every member
``(task, model)`` predicts, all predictions concatenate on the subnetwork
axis, and the result is the raw (p1, p2) or the uncertainty decomposition.
``predict`` serves any number of images in fixed-size batches, padding the
last one.  Loading members from checkpoint paths, MC dropout and the
stacked-member program are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mimo_unet_torch.transforms import compute_uncertainties, repeat_subnetworks


class Ensemble:
    """Callable ensemble of ``(task, model)`` members."""

    def __init__(self, members: Sequence[Tuple[object, torch.nn.Module]],
                 return_raw_predictions: bool = False):
        if not members:
            raise ValueError("need at least one member")
        self.members = list(members)
        names = {task.loss_fn.name for task, _ in self.members}
        if len(names) > 1:
            raise ValueError(f"ensemble members disagree on loss: {names}")
        self.loss_fn = self.members[0][0].loss_fn
        self.return_raw_predictions = return_raw_predictions

    @torch.no_grad()
    def raw_forward(self, image: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B,H,W,C] -> (p1, p2) each [B, S_total, H, W, C_out/2]."""
        p1s, p2s = [], []
        for task, model in self.members:
            x = repeat_subnetworks(image, task.num_subnetworks)
            p1, p2 = task.forward(model, x)
            p1s.append(p1)
            p2s.append(p2)
        return torch.cat(p1s, dim=1), torch.cat(p2s, dim=1)

    def __call__(self, image: torch.Tensor):
        p1, p2 = self.raw_forward(image)
        if self.return_raw_predictions:
            return p1, p2
        return compute_uncertainties(self.loss_fn, p1, p2)

    def predict(self, images, batch_size: int = 32,
                device: Optional[torch.device] = None):
        """Run any number of images [N,H,W,C] through the ensemble in
        ``batch_size`` batches (the last one padded with copies of its last
        image, then trimmed).  Returns numpy (mean, aleatoric_var,
        epistemic_var) over all inputs."""
        if device is None:
            device = next(self.members[0][1].parameters()).device
        images = torch.as_tensor(np.asarray(images))
        outs = []
        for start in range(0, images.shape[0], batch_size):
            chunk = images[start:start + batch_size]
            real = chunk.shape[0]
            if real < batch_size:
                pad = chunk[-1:].expand(batch_size - real, *chunk.shape[1:])
                chunk = torch.cat([chunk, pad])
            p1, p2 = self.raw_forward(chunk.to(device))
            mean, ale, epi = compute_uncertainties(self.loss_fn, p1, p2)
            outs.append(tuple(t[:real].cpu().numpy() for t in (mean, ale, epi)))
        return tuple(np.concatenate(parts, axis=0) for parts in zip(*outs))
