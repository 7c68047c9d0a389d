"""Train the MIMO U-Net on SEN12TP (e.g. VV/VH -> NDVI).

Counterpart of ``scripts/train/train_ndvi.py`` (reference
scripts/train/train_ndvi.py:86-118; usage in its Readme.md:33-56), with the
same flags and ``--device``, e.g.:

    python -m mimo_unet_torch.scripts.train.train_ndvi \
        --checkpoint_path ~/ckpts --dataset_dir ~/data/sen12tp \
        --seed 1 -i VV_sigma0 -i VH_sigma0 -t NDVI \
        --num_subnetworks 2 --filter_base_count 30 --batch_size 32

The model takes one input channel per ``-i`` band and predicts
``num_loss_function_params`` channels per ``-t`` target.
"""

import os
import sys
from argparse import ArgumentParser

if __package__ in (None, ""):  # run by its path: make the package importable
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..")))

from mimo_unet_torch.cli import (
    add_mimo_model_args,
    add_trainer_args,
    build_mimo_task,
    run_training,
)
from mimo_unet_torch.data.sen12tp import add_datamodule_args, get_datamodule


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser = add_trainer_args(parser, project="MIMO Sen12TP", max_epochs=40)
    parser = add_datamodule_args(parser)
    return add_mimo_model_args(parser)


def main(args):
    """Train; returns (trainer, final state)."""
    dm = get_datamodule(args)
    task = build_mimo_task(
        args,
        in_channels=len(dm.model_inputs),
        out_channels=len(dm.model_targets) * args.num_loss_function_params,
    )
    return run_training(
        args, task, dm, monitor_mode="sen12tp", monitor_targets=dm.model_targets
    )


if __name__ == "__main__":
    main(build_parser().parse_args())
