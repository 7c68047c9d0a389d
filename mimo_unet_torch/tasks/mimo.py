"""MIMO U-Net task: hyperparameters, model construction, forward, the train
step and the validation step.

Counterpart of ``mimo_unet_tpu/tasks/mimo.py`` (reference
mimo/models/mimo_unet.py:15-314): the same fields (the reference CLI flags),
``forward`` splitting the output channels into p1 (means) and p2
(log-params), ``train_step`` (input transform, per-subnetwork loss,
loss-buffer weighting, Adam + StepLR) and ``val_step`` with the ``valid``
row weighting.

Where the JAX package threads a ``TrainState`` pytree through a pure step,
the port's ``TrainState`` holds the model (parameters and BatchNorm
statistics), the optimizer and its schedule, and the loss buffer, and
``train_step`` updates them in place.  Dropout masks come from the
state's generator on the model's device (the JAX step's ``k_dropout``,
mimo_unet_tpu/tasks/mimo.py:189), or from masks the caller passes.  Entry
points build on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from mimo_unet_torch.loss_buffer import (
    LossBufferState,
    loss_buffer_add,
    loss_buffer_init,
    loss_buffer_weights,
)
from mimo_unet_torch.losses import UncertaintyLoss
from mimo_unet_torch.metrics import compute_regression_metrics
from mimo_unet_torch.models.mimo_unet import MimoUNet, MimoUNetConfig
from mimo_unet_torch.ops.dropout import DropoutSource
from mimo_unet_torch.train.optim import adam_with_steplr
from mimo_unet_torch.transforms import (
    apply_input_transform,
    compute_uncertainties,
    flatten_subnetwork_dimension,
    repeat_subnetworks,
)

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


@dataclasses.dataclass
class TrainState:
    """Everything a train step carries (``mimo_unet_tpu/tasks/mimo.py:55-66``);
    ``train_step`` updates it in place."""

    step: int
    model: MimoUNet  # parameters and BatchNorm running statistics
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR
    loss_buffer: LossBufferState
    generator: torch.Generator  # CPU: the input transform's permutations
    # on the model's device: the dropout masks (needed with a dropout rate)
    dropout_generator: Optional[torch.Generator] = None


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
    ct_kernels: str = "auto"  # kernel paths (models/fast_path.py)
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
        """A ``MimoUNet`` in eval mode on ``device`` (the card when None;
        raises without one); weights drawn from ``generator`` (a CPU
        generator; seeded from ``seed`` when None)."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        return MimoUNet(self.model_config, device=device,
                        generator=generator).eval()

    def make_optimizer(self, model: MimoUNet, steps_per_epoch: int):
        """(Adam, per-step StepLR schedule) over the model's parameters."""
        return adam_with_steplr(model.parameters(), self.learning_rate,
                                self.weight_decay, self.scheduler_step_size,
                                self.scheduler_gamma, steps_per_epoch)

    def init_state(self, steps_per_epoch: int, device=None,
                   generator: Optional[torch.Generator] = None) -> TrainState:
        """A fresh ``TrainState`` on ``device`` (the card when None): weights
        from ``generator`` (seeded from ``seed`` when None), the model in
        train mode, Adam moments at zero, an empty loss buffer, and the
        input-transform and dropout generators seeded from ``seed``."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        model = self.build_model(device, generator).train()
        opt, sched = self.make_optimizer(model, steps_per_epoch)
        dev = next(model.parameters()).device
        return TrainState(
            step=0, model=model, optimizer=opt, scheduler=sched,
            loss_buffer=loss_buffer_init(self.num_subnetworks,
                                         self.loss_buffer_size, dev),
            generator=torch.Generator().manual_seed(self.seed + 1),
            dropout_generator=torch.Generator(dev).manual_seed(self.seed + 2))

    def forward(self, model: MimoUNet, x: torch.Tensor, *,
                mc_dropout: bool = False,
                dropout: Optional[DropoutSource] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B,S,H,W,C_in] -> (p1, p2) each [B,S,H,W,C_out/2];
        ``mc_dropout`` and ``dropout`` as in ``MimoUNet.forward``."""
        out = model(x, mc_dropout=mc_dropout, dropout=dropout)
        c = self.out_channels // 2
        return out[..., :c], out[..., c:]

    def objective(self, model: MimoUNet, image_t: torch.Tensor,
                  label_t: torch.Tensor, mask_t: Optional[torch.Tensor],
                  loss_buffer: LossBufferState,
                  dropout: Optional[DropoutSource] = None):
        """The train loss of transformed inputs [B, S, ...]: the
        per-subnetwork NLL mean over (batch, H, W, channel), weighted by the
        loss buffer.  Returns (loss, loss_vec [S], weights [S], p1, p2)."""
        p1, p2 = self.forward(model, image_t, dropout=dropout)
        per_px = self.loss_fn(p1, p2, label_t, mask=mask_t, reduce_mean=False)
        loss_vec = per_px.mean(dim=(0, 2, 3, 4))
        weights = loss_buffer_weights(loss_buffer, self.loss_buffer_temperature,
                                      self.loss_buffer_size)
        return (loss_vec * weights).mean(), loss_vec, weights, p1, p2

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   with_outputs: bool = False,
                   dropout: Optional[DropoutSource] = None):
        """One optimization step, in place.  ``batch``: image/label
        [B,H,W,C], optional mask [B,H,W,1], on any device (moved to the
        model's).  Dropout masks come from ``dropout`` when given, else
        from ``state.dropout_generator``.  Returns (state, logs,
        outputs-or-None)."""
        model = state.model.train()
        if dropout is None and state.dropout_generator is not None:
            dropout = DropoutSource(generator=state.dropout_generator)
        dev = next(model.parameters()).device
        batch = device_normalize({k: v.to(dev) for k, v in batch.items()})
        image_t, label_t, mask_t = apply_input_transform(
            state.generator, batch["image"], batch["label"], batch.get("mask"),
            num_subnetworks=self.num_subnetworks,
            input_repetition_probability=self.input_repetition_probability,
            batch_repetitions=self.batch_repetitions)

        state.optimizer.zero_grad(set_to_none=True)
        loss, loss_vec, weights, p1, p2 = self.objective(
            model, image_t, label_t, mask_t, state.loss_buffer, dropout)
        loss.backward()
        # a parameter outside the graph (a conv bias that train-mode
        # BatchNorm cancels) has a zero gradient, as in the JAX package, so
        # Adam still applies weight decay to it
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.optimizer.step()
        state.scheduler.step()
        loss_buffer_add(state.loss_buffer, loss_vec, self.loss_buffer_size)
        state.step += 1

        with torch.no_grad():
            loss_vec = loss_vec.detach()
            p1, p2 = p1.detach(), p2.detach()
            y_pred = self.loss_fn.mode(p1, p2)
            logs = {"train_loss": loss_vec.mean()}
            for i in range(self.num_subnetworks):
                logs[f"train_loss_{i}"] = loss_vec[i]
                logs[f"train_weight_{i}"] = weights[i]
            for name, value in compute_regression_metrics(y_pred, label_t).items():
                logs[f"metric_train/{name}"] = value
            outputs = None
            if with_outputs:
                outputs = {
                    "label": flatten_subnetwork_dimension(label_t),
                    "preds": flatten_subnetwork_dimension(y_pred),
                    "aleatoric_std_map": flatten_subnetwork_dimension(
                        self.loss_fn.std(p1, p2)),
                    "err_map": flatten_subnetwork_dimension(y_pred - label_t),
                    "mask": (flatten_subnetwork_dimension(mask_t)
                             if mask_t is not None else None),
                }
        return state, logs, outputs

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
