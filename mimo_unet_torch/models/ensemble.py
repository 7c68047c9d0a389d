"""Inference-time ensembling over MIMO U-Net members, with MC dropout.

Counterpart of ``mimo_unet_tpu/models/ensemble.py`` (reference
mimo/models/ensemble.py:35-115) for in-memory members: every member
``(task, model)`` runs ``max(1, monte_carlo_steps)`` passes, all
predictions concatenate on the subnetwork axis, and the result is the raw
(p1, p2) or the uncertainty decomposition.  With ``monte_carlo_steps`` > 0
the dropout sites are live at eval (BatchNorm stays in eval mode) and the
passes fold into the batch of one forward, whose masks are drawn per image:
the prediction axis is mc-major per member (JAX ensemble.py:112-136).
``predict`` serves any number of images in fixed-size batches, padding the
last one.  Loading members from checkpoint paths and the stacked-member
program are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mimo_unet_torch.ops.dropout import DropoutSource
from mimo_unet_torch.transforms import compute_uncertainties, repeat_subnetworks


class Ensemble:
    """Callable ensemble of ``(task, model)`` members.  ``generator``
    draws the MC-dropout masks, on the members' device; the default is
    seeded 0, as the JAX package's default ``key(0)``."""

    def __init__(self, members: Sequence[Tuple[object, torch.nn.Module]],
                 return_raw_predictions: bool = False,
                 monte_carlo_steps: int = 0,
                 generator: Optional[torch.Generator] = None):
        if not members:
            raise ValueError("need at least one member")
        self.members = list(members)
        names = {task.loss_fn.name for task, _ in self.members}
        if len(names) > 1:
            raise ValueError(f"ensemble members disagree on loss: {names}")
        self.loss_fn = self.members[0][0].loss_fn
        self.return_raw_predictions = return_raw_predictions
        self.monte_carlo_steps = monte_carlo_steps
        if generator is None and monte_carlo_steps > 0:
            dev = next(self.members[0][1].parameters()).device
            generator = torch.Generator(dev).manual_seed(0)
        self.generator = generator

    @property
    def output_width(self) -> int:
        """Predictions per image: the members' subnetworks times the MC
        passes."""
        return (sum(task.num_subnetworks for task, _ in self.members)
                * max(1, self.monte_carlo_steps))

    @torch.no_grad()
    def raw_forward(self, image: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B,H,W,C] -> (p1, p2) each [B, output_width, H, W, C_out/2]."""
        mc = max(1, self.monte_carlo_steps)
        live = self.monte_carlo_steps > 0
        source = DropoutSource(generator=self.generator) if live else None
        b = image.shape[0]
        p1s, p2s = [], []
        for task, model in self.members:
            x = repeat_subnetworks(image, task.num_subnetworks)
            if mc > 1:
                x = x.repeat(mc, 1, 1, 1, 1)  # pass-major batch
            p1, p2 = task.forward(model, x, mc_dropout=live, dropout=source)
            if mc > 1:
                # [mc*B, S, ...] -> [B, mc*S, ...]: column j*S + s is pass j
                # of subnetwork s
                p1, p2 = (p.reshape(mc, b, *p.shape[1:]).transpose(0, 1)
                          .reshape(b, -1, *p.shape[2:]) for p in (p1, p2))
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
