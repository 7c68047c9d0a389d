"""Minimal raw-API training loop (the reference notebook's final cell).

Counterpart of ``examples/nyuv2_minimal.py``.  The reference ships a
Colab notebook (reference MIMO_U_Net_NYUv2_depth.ipynb) whose final cell
uses the library without Lightning: input transform -> forward -> split
p1/p2 -> per-subnetwork loss -> loss-buffer weights -> weighted mean ->
optimizer step.  Here the same loop runs through the port's
``MimoUnetTask.train_step``, on synthetic data (no downloads) or on
``--dataset_dir``'s ``depth_train.h5`` (read with h5py):

    python -m mimo_unet_torch.examples.nyuv2_minimal [--steps 50] \
        [--dataset_dir DIR] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

if __package__ in (None, ""):  # run by its path: make the package importable
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..")))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--dataset_dir", type=str, default=None,
                        help="optional real NYUv2 dir with depth_train.h5")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the torch device to train on (cuda or cpu)")
    return parser


def main(args):
    """Train ``--steps`` steps, then one validation-style batch; returns
    the train loss of every step."""
    from mimo_unet_torch.data.core import ArrayDataset, iterate_batches
    from mimo_unet_torch.tasks import MimoUnetTask

    # -- data: real h5 if given, synthetic otherwise --------------------------
    if args.dataset_dir:
        from mimo_unet_torch.data.nyuv2 import load_nyuv2_depth

        ds = load_nyuv2_depth(os.path.join(args.dataset_dir, "depth_train.h5"))
    else:
        rng = np.random.default_rng(0)
        image = rng.uniform(size=(64, 64, 64, 3)).astype(np.float32)
        ds = ArrayDataset({"image": image, "label": image.mean(-1, keepdims=True)})

    # -- model/task (notebook config: S=2, fbc=21, laplace, buffer 10) --------
    task = MimoUnetTask(
        in_channels=3, out_channels=2, num_subnetworks=2,
        filter_base_count=21, loss="laplace_nll",
        loss_buffer_size=10, loss_buffer_temperature=0.3,
        input_repetition_probability=0.0, batch_repetitions=2,
        learning_rate=1e-3, seed=42,
    )
    steps_per_epoch = max(len(ds) // args.batch_size, 1)
    state = task.init_state(steps_per_epoch, args.device)
    print(f"trainable params: {task.trainable_params(state):,}")

    losses = []  # device scalars, read at the end: no wait on every step
    step = 0
    while step < args.steps:
        for batch in iterate_batches(ds, args.batch_size, shuffle=True,
                                     drop_last=True, seed=1, epoch=step):
            batch = {k: torch.from_numpy(v) for k, v in batch.items()}
            state, logs, _ = task.train_step(state, batch)
            losses.append(logs["train_loss"].detach())
            if step % 10 == 0:
                print(
                    f"step {step:4d}  loss={float(logs['train_loss']):.4f}  "
                    + "  ".join(
                        f"w{i}={float(logs[f'train_weight_{i}']):.3f}"
                        for i in range(task.num_subnetworks)
                    )
                )
            step += 1
            if step >= args.steps:
                break

    # validation-style uncertainty decomposition on one batch
    batch = {k: torch.from_numpy(v) for k, v in ds[np.arange(args.batch_size)].items()}
    logs, _ = task.val_step(state.model, batch)
    print(
        f"final: val_loss={float(logs['val_loss']):.4f} "
        f"r2={float(logs['metric_val/r2']):.4f} "
        f"aleatoric_std={float(logs['metric_val/aleatoric_std_mean']):.4f} "
        f"epistemic_std={float(logs['metric_val/epistemic_std_mean']):.4f}"
    )
    return [float(v) for v in losses]


if __name__ == "__main__":
    main(build_parser().parse_args())
