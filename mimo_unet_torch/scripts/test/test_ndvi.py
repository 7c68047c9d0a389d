"""Evaluate a MIMO U-Net ensemble on SEN12TP NDVI.

Counterpart of ``scripts/test/test_ndvi.py`` (reference
scripts/test/test_ndvi.py:131-224): the raw SEN12TP tiles of
``--dataset_dir`` with VV/VH inputs and the NDVI target, patch/stride
windows and the clipping transform; writes inputs/y_preds/y_trues/
aleatoric_vars/epistemic_vars .npy, df_pixels.pkl, precision_recall.csv
and calibration.csv (calibration on a 50 % pixel subsample,
test_ndvi.py:195) into ``--result_dir``, which must not exist yet:

    python -m mimo_unet_torch.scripts.test.test_ndvi \
        --model_checkpoint_paths ~/ckpts/a/last --result_dir ~/results \
        --dataset_dir ~/data/sen12tp/test

``--device`` is the torch device the ensemble runs on; ``--processes`` is
accepted for compatibility and unused.  Writes the frames with pandas.
"""

import os
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

if __package__ in (None, ""):  # run by its path: make the package importable
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..")))

from mimo_unet_torch.data.sen12tp import (
    Patchsize,
    Sen12tpDataset,
    default_clipping_transform,
    min_max_transform,
)
from mimo_unet_torch.eval.artifacts import (
    convert_to_dataframe,
    create_calibration,
    create_precision_recall,
    make_predictions,
)
from mimo_unet_torch.models.ensemble import Ensemble


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--model_checkpoint_paths", nargs="+", type=str, required=True)
    parser.add_argument("--result_dir", type=str, required=True)
    parser.add_argument("--dataset_dir", type=str, required=True)
    parser.add_argument("--monte_carlo_steps", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--processes", type=int, default=2)  # compat, unused
    parser.add_argument("--batch_size", type=int, default=5)
    parser.add_argument("--patch_size", type=int, default=256)
    parser.add_argument("--stride", type=int, default=249)
    return parser


def load_dataset(args) -> Sen12tpDataset:
    """The evaluation windows: VV/VH -> NDVI, clipped and min-max scaled."""
    return Sen12tpDataset(
        path=args.dataset_dir,
        patch_size=Patchsize(args.patch_size, args.patch_size),
        stride=args.stride,
        model_inputs=["VV_sigma0", "VH_sigma0"],
        model_targets=["NDVI"],
        transform=min_max_transform,
        clip_transform=default_clipping_transform,
    )


def main(args):
    result_dir = Path(args.result_dir)
    result_dir.mkdir(parents=True, exist_ok=False)

    model = Ensemble.from_checkpoints(
        args.model_checkpoint_paths,
        monte_carlo_steps=args.monte_carlo_steps,
        return_raw_predictions=True,
        device=args.device,
    )
    dataset = load_dataset(args)

    print("Making predictions ...")
    preds = make_predictions(model, dataset, batch_size=args.batch_size)
    inputs, y_preds, y_trues, aleatoric_vars, epistemic_vars, combined_vars = preds

    print("Saving predictions ...")
    np.save(result_dir / "inputs.npy", inputs)
    np.save(result_dir / "y_preds.npy", y_preds)
    np.save(result_dir / "y_trues.npy", y_trues)
    np.save(result_dir / "aleatoric_vars.npy", aleatoric_vars)
    np.save(result_dir / "epistemic_vars.npy", epistemic_vars)

    print("Computing metrics ...")
    df = convert_to_dataframe(
        y_preds, y_trues, aleatoric_vars, epistemic_vars, combined_vars
    )
    df.to_pickle(result_dir / "df_pixels.pkl")

    print("Creating data for precision-recall plot ...")
    create_precision_recall(df).to_csv(result_dir / "precision_recall.csv", index=False)

    print("Creating data for calibration plot ...")
    create_calibration(df, subsample=0.5).to_csv(
        result_dir / "calibration.csv", index=False
    )
    print("Finished processing dataset!")


if __name__ == "__main__":
    main(build_parser().parse_args())
