"""FGSM adversarial perturbation for robustness evaluation.

Counterpart of ``mimo_unet_tpu/eval/fgsm.py`` (reference
scripts/test/test_nyuv2_depth.py:16-24, 41-61): ``x' = clip(x + eps *
sign(d loss / d x), 0, 1)``, the loss the ensemble NLL against labels
repeated across the prediction axis.  The input gradient runs through the
members' plain modules (a grad-enabled eval forward routes plain,
``models/mimo_unet.py``: the eval kernels carry no gradient, as the JAX
package traces it under ``ct_disabled``); the prediction on the perturbed
input runs on the eval kernels where the configuration takes them.
"""

from __future__ import annotations

import torch

from mimo_unet_torch.transforms import repeat_subnetworks


def fgsm_attack(image: torch.Tensor, epsilon: float,
                data_grad: torch.Tensor) -> torch.Tensor:
    """Perturb by epsilon along the gradient sign, clipped to [0, 1]."""
    return torch.clamp(image + epsilon * torch.sign(data_grad), 0.0, 1.0)


def input_gradient(nll, image: torch.Tensor) -> torch.Tensor:
    """d nll(x) / d x at ``image`` (float32), with grad enabled whatever
    the caller's mode."""
    x = image.detach().float().requires_grad_(True)
    with torch.enable_grad():
        grad, = torch.autograd.grad(nll(x), x)
    return grad


def make_fgsm_fn(ensemble, epsilon: float):
    """fn(image [B,H,W,C] float in [0, 1], label [B,H,W,C_out], seed=0) ->
    (perturbed image, p1, p2), the predictions on the perturbed input.
    With MC passes, the gradient and the prediction draw the same dropout
    masks, both from ``seed``, as the JAX function's two forwards share one
    key (an ensemble with its own generator is set back between them)."""
    loss_fn = ensemble.loss_fn
    width = ensemble.output_width

    def attack_and_predict(image: torch.Tensor, label: torch.Tensor,
                           seed: int = 0):
        gen = ensemble.generator
        kept = gen.get_state() if gen is not None else None
        if epsilon > 0.0:
            label_rep = repeat_subnetworks(label, width)

            def nll(x):
                return loss_fn(*ensemble.raw_forward_grad(x, seed), label_rep)

            image = fgsm_attack(image, epsilon, input_gradient(nll, image))
            if kept is not None:
                gen.set_state(kept)
        p1, p2 = ensemble.raw_forward(image, seed)
        return image, p1, p2

    return attack_and_predict
