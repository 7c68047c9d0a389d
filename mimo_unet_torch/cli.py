"""Shared CLI plumbing for the train and test scripts.

Counterpart of ``mimo_unet_tpu/cli.py`` (:15-186).  The reference exposes
four near-identical train CLIs (reference
scripts/train/train_{nyuv2_depth,ndvi}[_evidential].py) whose flags are the
public API (Readme.md:33-115); the scripts in ``mimo_unet_torch/scripts``
keep those flags, name for name, type for type and default for default.
This module holds the shared argument groups and the train-run assembly.

``--num_devices N`` trains over N ranks, one process a card
(``parallel/``): under ``torchrun`` the environment gives the ranks;
without a launcher, N > 1 starts N ranks on this host
(``parallel.launch.spawn``: a card each where there are N cards, else
sharing one over gloo; ``--device cpu``: CPU ranks over gloo).  A flag kept
that the port does not take: ``--host_chunk`` other than 1 (a TPU transfer
workaround, not ported), which ``Trainer`` refuses.  One flag is new:
``--device``, the torch device the run trains on (the card by default;
``cpu`` for a test).
"""

from __future__ import annotations

import os
from argparse import ArgumentParser, Namespace
from typing import Optional


def add_mimo_model_args(parser: ArgumentParser) -> ArgumentParser:
    """MIMO task flags (reference mimo/models/mimo_unet.py:293-314)."""
    group = parser.add_argument_group(title="MIMO UNet Model")
    group.add_argument("--num_subnetworks", type=int, default=3)
    group.add_argument("--filter_base_count", type=int, default=32)
    group.add_argument("--center_dropout_rate", type=float, default=0.0)
    group.add_argument("--final_dropout_rate", type=float, default=0.0)
    group.add_argument("--encoder_dropout_rate", type=float, default=0.0)
    group.add_argument("--core_dropout_rate", type=float, default=0.0)
    group.add_argument("--decoder_dropout_rate", type=float, default=0.0)
    group.add_argument("--input_repetition_probability", type=float, default=0.0)
    group.add_argument("--batch_repetitions", type=int, default=1)
    group.add_argument("--loss", type=str, default="laplace_nll")
    group.add_argument("--learning_rate", type=float, default=1e-3)
    group.add_argument("--weight_decay", type=float, default=0.0)
    group.add_argument("--loss_buffer_size", type=int, default=10)
    group.add_argument("--loss_buffer_temperature", type=float, default=1.0)
    group.add_argument("--scheduler_step_size", type=int, default=20)
    group.add_argument("--scheduler_gamma", type=float, default=0.5)
    return parser


def add_evidential_model_args(parser: ArgumentParser) -> ArgumentParser:
    """Evidential task flags (reference mimo/models/evidential_unet.py:194-209)."""
    group = parser.add_argument_group(title="MIMO UNet Model")
    group.add_argument("--filter_base_count", type=int, default=32)
    group.add_argument("--center_dropout_rate", type=float, default=0.0)
    group.add_argument("--final_dropout_rate", type=float, default=0.0)
    group.add_argument("--encoder_dropout_rate", type=float, default=0.0)
    group.add_argument("--core_dropout_rate", type=float, default=0.0)
    group.add_argument("--decoder_dropout_rate", type=float, default=0.0)
    group.add_argument("--learning_rate", type=float, default=1e-3)
    group.add_argument("--weight_decay", type=float, default=0.0)
    group.add_argument("--scheduler_step_size", type=int, default=20)
    group.add_argument("--scheduler_gamma", type=float, default=0.5)
    return parser


def add_trainer_args(parser: ArgumentParser, project: str, max_epochs: int = 100) -> ArgumentParser:
    """Run-level flags shared by every train script (reference
    train_nyuv2_depth.py:90-118), the JAX package's extensions, and
    ``--device``."""
    from mimo_unet_torch.utils import dir_path

    parser.add_argument("--project", type=str, default=project,
                        help="Specify the name of the project for wandb.")
    parser.add_argument("--checkpoint_path", type=dir_path, required=True,
                        help="Path where logs and checkpoints are saved.")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--max_epochs", type=int, default=max_epochs)
    parser.add_argument("--num_loss_function_params", type=int, default=2,
                        help="Number of parameters of the loss function.")
    parser.add_argument("--precision", type=str, default="bf16",
                        choices=["bf16", "f32"],
                        help="Compute precision (bf16 ~ reference 16-mixed).")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Cards (data-parallel ranks) to train on; "
                             "without torchrun, N > 1 starts N ranks on "
                             "this host.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the last checkpoint if present.")
    parser.add_argument("--use_wandb", action="store_true",
                        help="Log to wandb in addition to TSV (if installed).")
    parser.add_argument("--use_tensorboard", action="store_true",
                        help="Also write TensorBoard event files (the "
                             "reference OutputMonitor's other sink).")
    parser.add_argument("--log_every_n_steps", type=int, default=200)
    parser.add_argument("--device_cache", action="store_true",
                        help="Pin the train split in the card's memory and "
                             "gather each batch there (data/core.py "
                             "DeviceDataset; past the budget the rows that "
                             "fit, the rest host-fed).")
    parser.add_argument("--host_chunk", type=int, default=1,
                        help="Batches per host-to-device transfer; only 1 "
                             "is ported, any other value raises.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="The torch device to train on (cuda, cuda:N "
                             "or cpu).")
    return parser


def compute_dtype_from_args(args: Namespace) -> Optional[str]:
    return "bfloat16" if args.precision == "bf16" else None


def build_mimo_task(args: Namespace, in_channels: int, out_channels: int):
    from mimo_unet_torch.tasks import MimoUnetTask

    return MimoUnetTask(
        in_channels=in_channels,
        out_channels=out_channels,
        num_subnetworks=args.num_subnetworks,
        filter_base_count=args.filter_base_count,
        center_dropout_rate=args.center_dropout_rate,
        final_dropout_rate=args.final_dropout_rate,
        encoder_dropout_rate=args.encoder_dropout_rate,
        core_dropout_rate=args.core_dropout_rate,
        decoder_dropout_rate=args.decoder_dropout_rate,
        loss=args.loss,
        weight_decay=args.weight_decay,
        learning_rate=args.learning_rate,
        seed=args.seed,
        loss_buffer_size=args.loss_buffer_size,
        loss_buffer_temperature=args.loss_buffer_temperature,
        input_repetition_probability=args.input_repetition_probability,
        batch_repetitions=args.batch_repetitions,
        scheduler_step_size=args.scheduler_step_size,
        scheduler_gamma=args.scheduler_gamma,
        compute_dtype=compute_dtype_from_args(args),
    )


def build_evidential_task(args: Namespace, in_channels: int, out_channels: int = 4):
    from mimo_unet_torch.tasks import EvidentialUnetTask

    return EvidentialUnetTask(
        in_channels=in_channels,
        out_channels=out_channels,
        filter_base_count=args.filter_base_count,
        center_dropout_rate=args.center_dropout_rate,
        final_dropout_rate=args.final_dropout_rate,
        encoder_dropout_rate=args.encoder_dropout_rate,
        core_dropout_rate=args.core_dropout_rate,
        decoder_dropout_rate=args.decoder_dropout_rate,
        weight_decay=args.weight_decay,
        learning_rate=args.learning_rate,
        seed=args.seed,
        scheduler_step_size=args.scheduler_step_size,
        scheduler_gamma=args.scheduler_gamma,
        compute_dtype=compute_dtype_from_args(args),
    )


def run_training(
    args: Namespace,
    task,
    datamodule,
    monitor_mode: str = "depth",
    monitor_targets=None,
):
    """Assemble logger + trainer and fit (the pl.Trainer(...)/fit spine,
    reference train_nyuv2_depth.py:65-82) on ``args.device``.  Returns
    (trainer, final state).  Under torchrun the process group starts from
    its environment; with ``--num_devices`` N > 1 and no launcher, N ranks
    are started here (their datamodule, not yet set up, pickled to each),
    train in their own processes, and (None, None) is returned: the run's
    logs and checkpoints are in ``--checkpoint_path``."""
    import torch.distributed as dist

    from mimo_unet_torch.parallel import launch
    from mimo_unet_torch.parallel.multihost import initialize_multihost

    n = args.num_devices or 1
    if n > 1 and not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        launch.spawn(_rank_training, n, (args, task, datamodule, monitor_mode,
                                         monitor_targets),
                     device=getattr(args, "device", None))
        return None, None
    initialize_multihost(backend=launch.backend_for(
        getattr(args, "device", None),
        int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))))
    return _train(args, task, datamodule, monitor_mode, monitor_targets)


def _rank_training(args, task, datamodule, monitor_mode, monitor_targets) -> None:
    """One rank of ``run_training``'s own launch."""
    _train(args, task, datamodule, monitor_mode, monitor_targets)


def _train(args, task, datamodule, monitor_mode, monitor_targets):
    import numpy as np
    import torch.distributed as dist

    from mimo_unet_torch.train.logging import NullLogger, make_logger
    from mimo_unet_torch.train.trainer import Trainer

    np.random.seed(args.seed)
    if dist.is_initialized() and dist.get_rank() != 0:
        logger = NullLogger()  # rank 0 logs the run
    else:
        logger = make_logger(
            args.checkpoint_path,
            project=args.project,
            use_wandb=args.use_wandb,
            use_tensorboard=getattr(args, "use_tensorboard", False),
            config=vars(args),
        )
    try:
        trainer = Trainer(
            task,
            datamodule,
            max_epochs=args.max_epochs,
            checkpoint_path=args.checkpoint_path,
            logger=logger,
            log_every_n_steps=args.log_every_n_steps,
            monitor_mode=monitor_mode,
            monitor_targets=monitor_targets,
            num_devices=args.num_devices,
            seed=args.seed,
            device_cache=getattr(args, "device_cache", False),
            host_chunk=getattr(args, "host_chunk", 1),
            device=getattr(args, "device", None),
        )
        state = trainer.fit(resume=args.resume)
    finally:
        logger.finish()
    return trainer, state
