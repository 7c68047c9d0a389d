"""Evaluate an evidential U-Net on NYUv2 depth with FGSM sweeps.

Counterpart of ``scripts/test/test_nyuv2_depth_evidential.py`` (reference
scripts/test/test_nyuv2_depth_evidential.py:150-230): one checkpoint,
closed-form NIG aleatoric and epistemic variances, the same artifact set
per (dataset, epsilon in {0.00, 0.02, 0.04}):

    python -m mimo_unet_torch.scripts.test.test_nyuv2_depth_evidential \
        --model_checkpoint_path ~/ckpts/ev/last --result_dir ~/results \
        --dataset_dir ~/data/depth

``--device`` is the torch device the model runs on; ``--processes`` is
accepted for compatibility and unused.
"""

import os
import sys
from argparse import ArgumentParser
from pathlib import Path

if __package__ in (None, ""):  # run by its path: make the package importable
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..")))

from mimo_unet_torch.data.nyuv2 import load_nyuv2_depth
from mimo_unet_torch.eval.artifacts import make_predictions_evidential, write_artifacts
from mimo_unet_torch.train.checkpoint import load_checkpoint

NOISE_LEVELS = [0.00, 0.02, 0.04]


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--model_checkpoint_path", type=str, required=True)
    parser.add_argument("--result_dir", type=str, required=True)
    parser.add_argument("--dataset_dir", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=5)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--processes", type=int, default=None)  # compat, unused
    return parser


def main(args):
    result_dir = Path(args.result_dir)
    result_dir.mkdir(parents=True, exist_ok=False)

    task, state = load_checkpoint(args.model_checkpoint_path, device=args.device)

    datasets = [("test", os.path.join(args.dataset_dir, "depth_test.h5"))]
    for dataset_name, dataset_path in datasets:
        dataset = load_nyuv2_depth(dataset_path, normalize=True)
        for noise_level in NOISE_LEVELS:
            print(f"Making predictions on {dataset_name} (eps={noise_level})...")
            preds = make_predictions_evidential(
                task, state.model, dataset,
                batch_size=args.batch_size, epsilon=noise_level,
            )
            write_artifacts(str(result_dir), dataset_name, noise_level, preds)
            print(f"Finished dataset `{dataset_name}` eps={noise_level}!")


if __name__ == "__main__":
    main(build_parser().parse_args())
