"""Plain PyTorch training and serving semantics of the MIMO U-Net task.

The reference of what the cells drive (antonbaumann/MIMO-Unet,
mimo/models/mimo_unet.py, mimo/losses.py, mimo/models/utils.py,
mimo/models/mimo_components/loss_buffer.py, mimo/models/ensemble.py):

* the MIMO input transform: per step one permutation of the batch, then
  for each subnetwork a permutation of that (``input_repetition_probability``
  0, ``batch_repetitions`` 1), drawn from a CPU ``torch.Generator``
  seeded with the task seed + 1 (the documented convention of the port's
  ``TrainState.generator``);
* uint8 image and depth divided by 255;
* the Laplace NLL, log(b) + |y_hat - y| / b with b = exp(log_b) clamped to
  [1e-5, 1e3] in the forward only, its mean per subnetwork;
* the loss buffer: a ring of the last ``size`` loss vectors, weights
  softmax(mean / T) * S;
* Adam (L2 in the gradient, bias-corrected) with a StepLR factor that is
  1 over the steps compared here;
* serving: mean, aleatoric variance E_S[2 b^2] and epistemic variance (the
  unbiased variance of the subnetworks' means).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from benchmark.reference import model as ref_model

EPS_MIN, EPS_MAX = 1e-5, 1e3


def laplace_nll(mu: torch.Tensor, log_b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per element; the clamp acts in the forward, the gradient is exp's."""
    b = torch.exp(log_b)
    b = b + (b.clamp(EPS_MIN, EPS_MAX) - b).detach()
    return torch.log(b) + torch.abs(mu - y) / b


def uncertainties(mu: torch.Tensor, log_b: torch.Tensor):
    """[B, S, ...] -> (mean, aleatoric var, epistemic var), each [B, ...]."""
    s = mu.shape[1]
    mean = mu.mean(dim=1)
    aleatoric = (torch.exp(log_b) * math.sqrt(2.0)).square().mean(dim=1)
    if s > 1:
        epistemic = (mu - mu.mean(dim=1, keepdim=True)).square().sum(dim=1) / (s - 1)
    else:
        epistemic = torch.zeros_like(aleatoric)
    return mean, aleatoric, epistemic


def transform_indices(generator: torch.Generator, b: int, s: int) -> torch.Tensor:
    """[S, B]: row s holds the batch rows subnetwork s sees."""
    main = torch.randperm(b, generator=generator)
    return torch.stack([main[torch.randperm(b, generator=generator)]
                        for _ in range(s)])


def serve(p, images: torch.Tensor, cfg: dict, quant=ref_model.identity):
    """float32 frames [B, H, W, C] -> (mean, aleatoric, epistemic) [B, H, W, C_out/2]."""
    s = cfg["num_subnetworks"]
    x = images.unsqueeze(1).expand(-1, s, -1, -1, -1)
    out = ref_model.forward(p, x, cfg, train=False, quant=quant)
    c = cfg["out_channels"] // 2
    return uncertainties(out[..., :c], out[..., c:])


def train_steps(params: Dict[str, torch.Tensor], batches: Sequence[Dict[str, torch.Tensor]],
                cfg: dict, task_seed: int, quant=ref_model.identity
                ) -> Dict[str, object]:
    """Run ``len(batches)`` training steps from ``params`` (a state dict;
    not modified).  Returns the loss vector [S] of every step and the mean
    of its per-pixel losses' magnitudes (the scale a loss gap is read
    against: the two terms of the NLL can cancel), the norm of each
    parameter's first gradient, and the norm of each parameter's change
    after the last step."""
    s, c = cfg["num_subnetworks"], cfg["out_channels"] // 2
    hp = cfg["task"]
    lr, wd = hp["learning_rate"], hp["weight_decay"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    size, temp = hp["loss_buffer_size"], hp["loss_buffer_temperature"]
    keys = ref_model.parameter_keys(cfg)
    p = {k: v.detach().float().clone() for k, v in params.items()}
    leaves = [p[k].requires_grad_(True) for k in keys]
    start = [t.detach().clone() for t in leaves]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    device = leaves[0].device
    buffer = torch.zeros(max(size, 1), s, device=device)
    gen = torch.Generator().manual_seed(task_seed + 1)
    losses, abs_losses, grad_norms = [], [], None
    for t, batch in enumerate(batches, start=1):
        idx = transform_indices(gen, batch["image"].shape[0], s).to(device)
        image = batch["image"][idx].transpose(0, 1).float() / 255.0
        label = batch["label"][idx].transpose(0, 1).float() / 255.0
        out = ref_model.forward(p, image, cfg, train=True, quant=quant, remat=True)
        per_px = laplace_nll(out[..., :c], out[..., c:], label)
        loss_vec = per_px.mean(dim=(0, 2, 3, 4))
        abs_losses.append(per_px.detach().abs().mean(dim=(0, 2, 3, 4)).cpu())
        del per_px
        weights = (torch.softmax(buffer.mean(dim=0) / temp, dim=-1) * s
                   if size > 0 else torch.ones(s, device=device))
        grads = torch.autograd.grad((loss_vec * weights).mean(), leaves)
        del out
        if grad_norms is None:
            grad_norms = [float(g.norm()) for g in grads]
        with torch.no_grad():
            for leaf, g, mt, vt in zip(leaves, grads, m, v):
                g = g + wd * leaf if wd else g
                mt.mul_(b1).add_(g, alpha=1 - b1)
                vt.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (vt.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                leaf.addcdiv_(mt, denom, value=-lr / (1 - b1 ** t))
        del grads
        losses.append(loss_vec.detach().cpu())
        if size > 0:
            buffer[(t - 1) % size] = loss_vec.detach()
    change = [float((leaf.detach() - s0).norm()) for leaf, s0 in zip(leaves, start)]
    return {"keys": keys, "losses": torch.stack(losses),
            "abs_losses": torch.stack(abs_losses), "grad_norms": grad_norms,
            "change_norms": change}
