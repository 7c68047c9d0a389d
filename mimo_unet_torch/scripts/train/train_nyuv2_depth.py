"""Train the MIMO U-Net on NYUv2 depth.

Counterpart of ``scripts/train/train_nyuv2_depth.py`` (reference
scripts/train/train_nyuv2_depth.py:88-123; usage in its Readme.md:61-79),
with the same flags and ``--device``, e.g.:

    python -m mimo_unet_torch.scripts.train.train_nyuv2_depth \
        --checkpoint_path ~/ckpts --dataset_dir ~/data/depth \
        --seed 1 --num_subnetworks 2 --filter_base_count 21 \
        --batch_size 64 --loss laplace_nll --learning_rate 0.001

``--dataset_dir`` holds ``depth_train.h5`` (and ``depth_test.h5``), read
with h5py.
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
from mimo_unet_torch.data.nyuv2 import NYUv2DepthDataModule


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser = add_trainer_args(parser, project="MIMO NYUv2Depth", max_epochs=100)
    parser = NYUv2DepthDataModule.add_model_specific_args(parser)
    return add_mimo_model_args(parser)


def main(args):
    """Train; returns (trainer, final state)."""
    dm = NYUv2DepthDataModule.from_args(args)
    task = build_mimo_task(args, in_channels=3, out_channels=args.num_loss_function_params)
    return run_training(args, task, dm, monitor_mode="depth")


if __name__ == "__main__":
    main(build_parser().parse_args())
