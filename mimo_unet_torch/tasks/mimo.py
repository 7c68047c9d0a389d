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

Under a mesh of several ranks (``parallel/mesh.py`` ``ct_mesh_scope``) a
step computes what one device computes on the global batch: ``batch`` is
this rank's rows; the rows of every rank are gathered, the input
transform permutes the global batch with the (shared) generator and each
rank keeps its slice of the result; every BatchNorm normalizes with the
global batch's statistics; each rank backpropagates its own loss and the
gradients are averaged over the ranks before the optimizer step; the
per-subnetwork losses are averaged over the ranks before the loss buffer
and the logs, and the metrics are those of the global batch.  Dropout
masks are drawn per data index (``rank_dropout_source``).  ``val_step``
takes this rank's rows of a validation batch and logs the global batch's
values.

On a data x spatial mesh (``parallel/mesh.py`` ``make_mesh_2d``) ``batch``
is this rank's batch rows and height rows (``shard_image``): the input
transform gathers over the data axis only, each rank's loss is the mean
over its pixels (with equal shards the ranks' mean is the global mean),
and the gradients, BatchNorm statistics, loss buffer, logs and metrics
are reduced over the whole mesh.  Spatial peers draw the same dropout
masks.  ``Trainer`` and the CLIs keep the 1-D mesh.
"""

from __future__ import annotations

import dataclasses
import math
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
from mimo_unet_torch.models.ensemble import fold_in
from mimo_unet_torch.models.mimo_unet import MimoUNet, MimoUNetConfig, eval_mode
from mimo_unet_torch.ops.dropout import DropoutSource
from mimo_unet_torch.parallel.collectives import (
    all_gather_rows,
    all_reduce,
    sync_gradients,
)
from mimo_unet_torch.parallel.mesh import (
    current_ct_mesh,
    data_index,
    data_mesh,
    local_slice,
    rank_count,
    spans_ranks,
)
from mimo_unet_torch.train.optim import adam_with_steplr
from mimo_unet_torch.train.profiling import span
from mimo_unet_torch.transforms import (
    apply_input_transform,
    compute_uncertainties,
    flatten_subnetwork_dimension,
    repeat_subnetworks,
)
from mimo_unet_torch.utils import count_parameters

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


def rank_dropout_source(seed: int, step: int, rank: int, device) -> DropoutSource:
    """Where the ranks of data index ``rank`` of a mesh draw step
    ``step``'s dropout masks: a generator on ``device`` seeded
    ``fold_in(fold_in(seed, step), rank)``, as the JAX kernel path folds
    the data axis index into its step's key
    (mimo_unet_tpu/models/fast_path.py:376, :1117).  A function of the
    step, so a resumed run draws what a straight one draws; one of the
    data index, so spatial peers draw the same masks."""
    gen = torch.Generator(device).manual_seed(fold_in(fold_in(seed, step), rank))
    return DropoutSource(generator=gen)


def mesh_reducer(mesh, kind: str):
    """A sum over the mesh's ranks for ``compute_regression_metrics``."""
    return lambda t: all_reduce(t, mesh, kind)


def valid_part(x: torch.Tensor, valid: torch.Tensor, dims=None):
    """A part of ``valid_means``: (the sum over ``dims``, all when None, of
    ``x`` [B, ...] with row b weighted by ``valid[b]`` (0/1), the elements
    of a row that each sum takes)."""
    dims = tuple(range(x.ndim)) if dims is None else dims
    w = valid.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    return (x * w).sum(dim=dims), math.prod(x.shape[d] for d in dims if d != 0)


def valid_means(parts: Dict[str, Tuple[torch.Tensor, int]], valid: torch.Tensor,
                mesh) -> Dict[str, torch.Tensor]:
    """Means over the valid rows of every rank of ``mesh``: ``parts`` maps
    a name to (the valid rows' sum, the elements of a row).  One
    all-reduce of the sums and of the valid rows' count (none without a
    mesh)."""
    sums = [v.float().reshape(-1) for v, _ in parts.values()]
    total = all_reduce(torch.cat(sums + [valid.float().sum()[None]]), mesh, "val")
    out, i = {}, 0
    for (k, (v, per_row)), flat in zip(parts.items(), sums):
        out[k] = (total[i:i + flat.numel()] / (total[-1] * per_row)).reshape(v.shape)
        i += flat.numel()
    return out


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

    def hparams(self) -> dict:
        """JSON-serializable hyperparameters, the JAX task's key for key
        (mimo_unet_tpu/tasks/mimo.py:121): what a checkpoint carries to
        rebuild its task (``train/checkpoint.py``)."""
        return dataclasses.asdict(self) | {"task": "mimo_unet"}

    def trainable_params(self, state: TrainState) -> int:
        """The number of parameters the optimizer updates."""
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
        with span("mimo.train.input"):
            model = state.model.train()
            mesh = current_ct_mesh()
            dev = next(model.parameters()).device
            if dropout is None and spans_ranks(mesh):
                dropout = rank_dropout_source(self.seed + 2, state.step, data_index(mesh), dev)
            elif dropout is None and state.dropout_generator is not None:
                dropout = DropoutSource(generator=state.dropout_generator)
            # the global batch, rank-major over the data axis, on every rank (its
            # height rows under a spatial mesh); the transform gathers only this
            # rank's rows of its result, and normalizes those (elementwise), so
            # no rank holds more than its share past here
            batch = {k: all_gather_rows(v.to(dev), data_mesh(mesh)) for k, v in batch.items()}
            rows = local_slice(mesh, len(batch["image"]) * self.batch_repetitions)
            image_t, label_t, mask_t = apply_input_transform(
                state.generator, batch["image"], batch["label"], batch.get("mask"),
                num_subnetworks=self.num_subnetworks,
                input_repetition_probability=self.input_repetition_probability,
                batch_repetitions=self.batch_repetitions, rows=rows)
            del batch
            norm = device_normalize({"image": image_t, "label": label_t, "mask": mask_t})
            image_t, label_t, mask_t = norm["image"], norm["label"], norm["mask"]
            del norm
        with span("mimo.train.forward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss, loss_vec, weights, p1, p2 = self.objective(
                model, image_t, label_t, mask_t, state.loss_buffer, dropout)
        with span("mimo.train.backward"):
            loss.backward()
        with span("mimo.train.update"):
            # a parameter outside the graph (a conv bias that train-mode
            # BatchNorm cancels) has a zero gradient, as in the JAX package, so
            # Adam still applies weight decay to it
            for p in model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            sync_gradients(model.parameters(), mesh)
            state.optimizer.step()
            state.scheduler.step()
            # equal rows a rank: the global mean is the ranks' mean
            loss_vec = all_reduce(loss_vec.detach(), mesh, "logs") / rank_count(mesh)
            loss_buffer_add(state.loss_buffer, loss_vec, self.loss_buffer_size)
            state.step += 1

            with torch.no_grad():
                p1, p2 = p1.detach(), p2.detach()
                y_pred = self.loss_fn.mode(p1, p2)
                logs = {"train_loss": loss_vec.mean()}
                for i in range(self.num_subnetworks):
                    logs[f"train_loss_{i}"] = loss_vec[i]
                    logs[f"train_weight_{i}"] = weights[i]
                for name, value in compute_regression_metrics(
                        y_pred, label_t, reduce=mesh_reducer(mesh, "logs")).items():
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
        [B,H,W,1] and ``valid`` [B] (0/1), on any device (moved to the
        model's): padded rows get weight 0 in every logged statistic.  The
        model runs in eval mode, whatever mode it is in (restored after).
        Under a mesh of several ranks ``batch`` is this rank's rows and the
        logs are the global batch's (one reduction of the weighted sums,
        two for the metrics).  Returns (logs, outputs)."""
        loss_fn = self.loss_fn
        dev = next(model.parameters()).device
        batch = device_normalize({k: None if v is None else v.to(dev)
                                  for k, v in batch.items()})
        s = self.num_subnetworks
        image = repeat_subnetworks(batch["image"], s)
        label = repeat_subnetworks(batch["label"], s)
        mask = batch.get("mask")
        mask_t = repeat_subnetworks(mask, s) if mask is not None else None
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(image.shape[0], device=dev)
        mesh = current_ct_mesh()

        with eval_mode(model):
            p1, p2 = self.forward(model, image)
        per_px = loss_fn(p1, p2, label, mask=mask_t, reduce_mean=False)

        y_pred_mean, aleatoric_var, epistemic_var = compute_uncertainties(
            loss_fn, p1, p2)
        y_mean = label.mean(dim=1)
        combined_std = torch.sqrt(aleatoric_var + epistemic_var)
        aleatoric_std = torch.sqrt(aleatoric_var)
        epistemic_std = torch.sqrt(epistemic_var)
        combined_log_param = loss_fn.calculate_dist_param(std=combined_std,
                                                          log=True)
        means = valid_means({
            "val_loss": valid_part(per_px, valid, dims=(0, 2, 3, 4)),
            "val_loss_combined": valid_part(
                loss_fn(p1.mean(dim=1), combined_log_param, y_mean, mask=mask,
                        reduce_mean=False), valid),
            "metric_val/aleatoric_std_mean": valid_part(
                torch.clamp(aleatoric_std, 0, 5), valid),
            "metric_val/epistemic_std_mean": valid_part(
                torch.clamp(epistemic_std, 0, 5), valid),
        }, valid, mesh)
        val_loss = means.pop("val_loss")

        logs = {"val_loss": val_loss.mean(), **means}
        for i in range(s):
            logs[f"val_loss_{i}"] = val_loss[i]
        row_w = valid.reshape((-1,) + (1,) * (y_mean.ndim - 1))
        for name, value in compute_regression_metrics(
                y_pred_mean, y_mean, weights=row_w,
                reduce=mesh_reducer(mesh, "val")).items():
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
