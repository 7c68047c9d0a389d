"""MIMO U-Net task: hyperparameters, model construction, forward and the
validation step.

Counterpart of ``mimo_unet_tpu/tasks/mimo.py`` (reference
mimo/models/mimo_unet.py:15-314): the same fields (the reference CLI flags),
``forward`` splitting the output channels into p1 (means) and p2
(log-params), and ``val_step`` with the ``valid`` row weighting.  The train
step comes with the train path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from mimo_unet_torch.losses import UncertaintyLoss
from mimo_unet_torch.metrics import compute_regression_metrics
from mimo_unet_torch.models.mimo_unet import MimoUNet, MimoUNetConfig
from mimo_unet_torch.transforms import compute_uncertainties, repeat_subnetworks

_NO_RESCALE_KEYS = ("mask", "valid")


def device_normalize(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """uint8 entries -> float32 in [0, 1] on their device; mask-like keys
    ("mask", "valid") convert dtype only; float entries pass unchanged
    (``mimo_unet_tpu/data/core.py`` ``device_normalize``)."""
    def norm(k, v):
        if v is None or v.dtype != torch.uint8:
            return v
        v = v.float()
        return v if k in _NO_RESCALE_KEYS else v / 255.0

    return {k: norm(k, v) for k, v in batch.items()}


@dataclasses.dataclass(frozen=True)
class MimoUnetTask:
    in_channels: int
    out_channels: int
    num_subnetworks: int
    filter_base_count: int
    center_dropout_rate: float = 0.0
    final_dropout_rate: float = 0.0
    encoder_dropout_rate: float = 0.0
    core_dropout_rate: float = 0.0
    decoder_dropout_rate: float = 0.0
    loss: str = "laplace_nll"
    weight_decay: float = 0.0
    learning_rate: float = 1e-3
    seed: int = 42
    loss_buffer_size: int = 10
    loss_buffer_temperature: float = 1.0
    input_repetition_probability: float = 0.0
    batch_repetitions: int = 1
    scheduler_step_size: int = 20
    scheduler_gamma: float = 0.5
    compute_dtype: Optional[str] = None
    ct_kernels: str = "auto"  # kernel eval path (models/fast_path.py)
    remat: str = "none"

    @property
    def model_config(self) -> MimoUNetConfig:
        return MimoUNetConfig(
            in_channels=self.in_channels,
            out_channels=self.out_channels,
            num_subnetworks=self.num_subnetworks,
            filter_base_count=self.filter_base_count,
            center_dropout_rate=self.center_dropout_rate,
            final_dropout_rate=self.final_dropout_rate,
            encoder_dropout_rate=self.encoder_dropout_rate,
            core_dropout_rate=self.core_dropout_rate,
            decoder_dropout_rate=self.decoder_dropout_rate,
            bilinear=True,
            use_pooling_indices=False,
            compute_dtype=self.compute_dtype,
            ct_kernels=self.ct_kernels,
            remat=self.remat,
        )

    @property
    def loss_fn(self) -> UncertaintyLoss:
        return UncertaintyLoss.from_name(self.loss)

    def build_model(self, device=None,
                    generator: Optional[torch.Generator] = None) -> MimoUNet:
        """A ``MimoUNet`` in eval mode on ``device``; weights drawn from
        ``generator`` (a CPU generator; seeded from ``seed`` when None)."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        return MimoUNet(self.model_config, device=device,
                        generator=generator).eval()

    def forward(self, model: MimoUNet, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B,S,H,W,C_in] -> (p1, p2) each [B,S,H,W,C_out/2]."""
        out = model(x)
        c = self.out_channels // 2
        return out[..., :c], out[..., c:]

    @torch.no_grad()
    def val_step(self, model: MimoUNet, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Validation step.  ``batch``: image/label [B,H,W,C], optional mask
        [B,H,W,1] and ``valid`` [B] (0/1): padded rows get weight 0 in every
        logged statistic.  Returns (logs, outputs)."""
        loss_fn = self.loss_fn
        batch = device_normalize(batch)
        s = self.num_subnetworks
        image = repeat_subnetworks(batch["image"], s)
        label = repeat_subnetworks(batch["label"], s)
        mask = batch.get("mask")
        mask_t = repeat_subnetworks(mask, s) if mask is not None else None
        valid = batch.get("valid")

        def wmean(x):
            if valid is None:
                return x.mean()
            w = valid.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
            return (x * w).sum() / (valid.sum() * (x.numel() // x.shape[0]))

        p1, p2 = self.forward(model, image)
        per_px = loss_fn(p1, p2, label, mask=mask_t, reduce_mean=False)
        if valid is None:
            val_loss = per_px.mean(dim=(0, 2, 3, 4))
        else:
            w = valid.to(per_px.dtype)[:, None, None, None, None]
            n_elem = per_px.shape[2] * per_px.shape[3] * per_px.shape[4]
            val_loss = (per_px * w).sum(dim=(0, 2, 3, 4)) / (valid.sum() * n_elem)

        y_pred_mean, aleatoric_var, epistemic_var = compute_uncertainties(
            loss_fn, p1, p2)
        y_mean = label.mean(dim=1)
        combined_std = torch.sqrt(aleatoric_var + epistemic_var)
        aleatoric_std = torch.sqrt(aleatoric_var)
        epistemic_std = torch.sqrt(epistemic_var)
        combined_log_param = loss_fn.calculate_dist_param(std=combined_std,
                                                          log=True)
        val_loss_combined = wmean(loss_fn(p1.mean(dim=1), combined_log_param,
                                          y_mean, mask=mask, reduce_mean=False))

        row_w = None if valid is None else valid.reshape(
            (-1,) + (1,) * (y_mean.ndim - 1))
        logs = {
            "val_loss": val_loss.mean(),
            "val_loss_combined": val_loss_combined,
            "metric_val/aleatoric_std_mean": wmean(torch.clamp(aleatoric_std, 0, 5)),
            "metric_val/epistemic_std_mean": wmean(torch.clamp(epistemic_std, 0, 5)),
        }
        for i in range(s):
            logs[f"val_loss_{i}"] = val_loss[i]
        for name, value in compute_regression_metrics(
                y_pred_mean, y_mean, weights=row_w).items():
            logs[f"metric_val/{name}"] = value
        outputs = {
            "label": y_mean,
            "preds": y_pred_mean,
            "aleatoric_std_map": aleatoric_std,
            "epistemic_std_map": epistemic_std,
            "err_map": y_pred_mean - y_mean,
            "mask": mask,
        }
        return logs, outputs
