"""Evidential (Normal-Inverse-Gamma) U-Net task.

Counterpart of ``mimo_unet_tpu/tasks/evidential.py`` (reference
mimo/models/evidential_unet.py:13-209): a one-subnetwork MimoUNet with 4
output channels; the forward applies ``v = softplus(logv)``, ``alpha =
softplus(logalpha) + 1``, ``beta = softplus(logbeta)`` (:90-94) and
training minimizes the NIG sum-of-squares loss, with closed-form aleatoric
and epistemic variances.

The model routes as any ``MimoUNet`` does (``models/mimo_unet.py``): at
S = 1 with bf16 compute the eval forward and the train step run on the
kernels of ``models/fast_path.py``, every grouped kernel with one group.
The ``TrainState`` is the MIMO task's, with an unused loss buffer, so the
trainer, checkpoints and the capacity ladder take both tasks alike.
Entry points build on the card unless the caller passes ``device="cpu"``.

Under a mesh of several ranks a step is the global batch's, as the MIMO
task's (``tasks/mimo.py``), with no input transform to gather rows for:
each rank trains on its own rows, every BatchNorm normalizes with the
global batch's statistics, the gradients are averaged over the ranks and
the logs are the global batch's.  On a data x spatial mesh each rank holds
its batch rows and height rows, as in the MIMO task's step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mimo_unet_torch.loss_buffer import loss_buffer_init
from mimo_unet_torch.losses import EvidentialLoss
from mimo_unet_torch.metrics import compute_regression_metrics
from mimo_unet_torch.models.mimo_unet import MimoUNet, MimoUNetConfig, eval_mode
from mimo_unet_torch.ops.dropout import DropoutSource
from mimo_unet_torch.parallel.collectives import all_reduce, sync_gradients
from mimo_unet_torch.parallel.mesh import (
    current_ct_mesh,
    data_index,
    rank_count,
    spans_ranks,
)
from mimo_unet_torch.tasks.mimo import (
    TrainState,
    device_normalize,
    mesh_reducer,
    rank_dropout_source,
    valid_means,
    valid_part,
)
from mimo_unet_torch.train.optim import adam_with_steplr
from mimo_unet_torch.utils import count_parameters


@dataclasses.dataclass(frozen=True)
class EvidentialUnetTask:
    in_channels: int
    out_channels: int = 4
    filter_base_count: int = 32
    center_dropout_rate: float = 0.0
    final_dropout_rate: float = 0.0
    encoder_dropout_rate: float = 0.0
    core_dropout_rate: float = 0.0
    decoder_dropout_rate: float = 0.0
    weight_decay: float = 0.0
    learning_rate: float = 1e-3
    seed: int = 42
    scheduler_step_size: int = 20
    scheduler_gamma: float = 0.5
    compute_dtype: Optional[str] = None
    ct_kernels: str = "auto"  # kernel paths (models/fast_path.py)
    remat: str = "none"

    num_subnetworks = 1  # a class constant, not a field

    @property
    def model_config(self) -> MimoUNetConfig:
        return MimoUNetConfig(
            in_channels=self.in_channels,
            out_channels=self.out_channels,
            num_subnetworks=1,
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
    def loss_fn(self) -> EvidentialLoss:
        return EvidentialLoss(coeff=1.0)

    def hparams(self) -> dict:
        """JSON-serializable hyperparameters, the JAX task's key for key
        (mimo_unet_tpu/tasks/evidential.py:74)."""
        return dataclasses.asdict(self) | {"task": "evidential_unet",
                                           "loss": "evidential"}

    def trainable_params(self, state: TrainState) -> int:
        return count_parameters(state.model)

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
        """A fresh ``TrainState`` on ``device`` (the card when None), as the
        MIMO task's: the loss buffer is unused (one subnetwork, size 0) and
        kept so that the state stays uniform; the dropout generator is
        seeded from ``seed``."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        model = self.build_model(device, generator).train()
        opt, sched = self.make_optimizer(model, steps_per_epoch)
        dev = next(model.parameters()).device
        return TrainState(
            step=0, model=model, optimizer=opt, scheduler=sched,
            loss_buffer=loss_buffer_init(1, 0, dev),
            generator=torch.Generator().manual_seed(self.seed + 1),
            dropout_generator=torch.Generator(dev).manual_seed(self.seed + 2))

    def forward(self, model: MimoUNet, x: torch.Tensor, *,
                mc_dropout: bool = False,
                dropout: Optional[DropoutSource] = None) -> torch.Tensor:
        """x [B,H,W,C_in] -> evidential output [B,H,W,4] = (mu, v, alpha,
        beta), float32; softplus links per reference
        evidential_unet.py:90-94."""
        out = model(x[:, None], mc_dropout=mc_dropout, dropout=dropout)[:, 0]
        mu, logv, logalpha, logbeta = out.unbind(-1)
        return torch.stack([mu, F.softplus(logv), F.softplus(logalpha) + 1.0,
                            F.softplus(logbeta)], dim=-1)

    def objective(self, model: MimoUNet, image: torch.Tensor,
                  label: torch.Tensor, mask: Optional[torch.Tensor],
                  dropout: Optional[DropoutSource] = None):
        """The train loss of normalized inputs: the masked NIG loss's mean
        over (batch, H, W).  Returns (loss, out)."""
        out = self.forward(model, image, dropout=dropout)
        mask_sq = mask.squeeze(-1) if mask is not None else None
        return self.loss_fn(out, label, mask=mask_sq, reduce_mean=True), out

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   with_outputs: bool = False,
                   dropout: Optional[DropoutSource] = None):
        """One optimization step, in place.  ``batch``: image/label
        [B,H,W,C], optional mask [B,H,W,1], on any device (moved to the
        model's).  Dropout masks come from ``dropout`` when given, else
        from ``state.dropout_generator``.  Returns (state, logs,
        outputs-or-None)."""
        model = state.model.train()
        mesh = current_ct_mesh()
        dev = next(model.parameters()).device
        if dropout is None and spans_ranks(mesh):
            dropout = rank_dropout_source(self.seed + 2, state.step, data_index(mesh), dev)
        elif dropout is None and state.dropout_generator is not None:
            dropout = DropoutSource(generator=state.dropout_generator)
        batch = device_normalize({k: v.to(dev) for k, v in batch.items()})
        image, label, mask = batch["image"], batch["label"], batch.get("mask")

        state.optimizer.zero_grad(set_to_none=True)
        loss, out = self.objective(model, image, label, mask, dropout)
        loss.backward()
        # a parameter outside the graph gets a zero gradient, as in the JAX
        # package, so Adam still applies weight decay to it
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sync_gradients(model.parameters(), mesh)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1

        with torch.no_grad():
            out = out.detach()
            y_pred = self.loss_fn.mode(out)[..., None]
            # equal rows a rank: the global mean is the ranks' mean
            loss = all_reduce(loss.detach()[None], mesh, "logs")[0] / rank_count(mesh)
            logs = {"train_loss": loss}
            for name, value in compute_regression_metrics(
                    y_pred, label, reduce=mesh_reducer(mesh, "logs")).items():
                logs[f"metric_train/{name}"] = value
            outputs = None
            if with_outputs:
                outputs = {
                    "label": label,
                    "preds": y_pred,
                    "aleatoric_std_map": torch.sqrt(
                        self.loss_fn.aleatoric_var(out))[..., None],
                    "err_map": y_pred - label,
                    "mask": mask,
                }
        return state, logs, outputs

    @torch.no_grad()
    def val_step(self, model: MimoUNet, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Validation step.  ``batch``: image/label [B,H,W,C], optional mask
        [B,H,W,1] and ``valid`` [B] (0/1), on any device (moved to the
        model's): padded rows get weight 0 in every logged statistic.  The
        model runs in eval mode, whatever mode it is in (restored after).
        Under a mesh of several ranks ``batch`` is this rank's rows and the
        logs are the global batch's.  Returns (logs, outputs)."""
        loss_fn = self.loss_fn
        dev = next(model.parameters()).device
        batch = device_normalize({k: None if v is None else v.to(dev)
                                  for k, v in batch.items()})
        image, label, mask = batch["image"], batch["label"], batch.get("mask")
        mask_sq = mask.squeeze(-1) if mask is not None else None
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(image.shape[0], device=dev)
        mesh = current_ct_mesh()

        with eval_mode(model):
            out = self.forward(model, image)
        loss = loss_fn(out, label, mask=mask_sq, reduce_mean=False)
        y_pred = loss_fn.mode(out)[..., None]
        aleatoric_std = torch.sqrt(loss_fn.aleatoric_var(out))[..., None]
        epistemic_std = torch.sqrt(loss_fn.epistemic_var(out))[..., None]

        logs = valid_means({
            "val_loss": valid_part(loss, valid),
            "metric_val/aleatoric_std_mean": valid_part(
                torch.clamp(aleatoric_std, 0, 5), valid),
            "metric_val/epistemic_std_mean": valid_part(
                torch.clamp(epistemic_std, 0, 5), valid),
        }, valid, mesh)
        row_w = valid.reshape((-1,) + (1,) * (label.ndim - 1))
        for name, value in compute_regression_metrics(
                y_pred, label, weights=row_w,
                reduce=mesh_reducer(mesh, "val")).items():
            logs[f"metric_val/{name}"] = value
        outputs = {
            "label": label,
            "preds": y_pred,
            "aleatoric_std_map": aleatoric_std,
            "epistemic_std_map": epistemic_std,
            "err_map": y_pred - label,
            "mask": mask,
        }
        return logs, outputs
