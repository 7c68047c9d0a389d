"""Train the evidential (NIG) U-Net on NYUv2 depth.

Counterpart of ``scripts/train/train_nyuv2_depth_evidential.py``
(reference scripts/train/train_nyuv2_depth_evidential.py:36-109: fixed
out_channels=4, no MIMO flags), with ``--device``:

    python -m mimo_unet_torch.scripts.train.train_nyuv2_depth_evidential \
        --checkpoint_path ~/ckpts --dataset_dir ~/data/depth --seed 1
"""

import os
import sys
from argparse import ArgumentParser

if __package__ in (None, ""):  # run by its path: make the package importable
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..")))

from mimo_unet_torch.cli import (
    add_evidential_model_args,
    add_trainer_args,
    build_evidential_task,
    run_training,
)
from mimo_unet_torch.data.nyuv2 import NYUv2DepthDataModule


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser = add_trainer_args(parser, project="MIMO NYUv2Depth", max_epochs=100)
    parser = NYUv2DepthDataModule.add_model_specific_args(parser)
    return add_evidential_model_args(parser)


def main(args):
    """Train; returns (trainer, final state)."""
    dm = NYUv2DepthDataModule.from_args(args)
    task = build_evidential_task(args, in_channels=3, out_channels=4)
    return run_training(args, task, dm, monitor_mode="depth")


if __name__ == "__main__":
    main(build_parser().parse_args())
