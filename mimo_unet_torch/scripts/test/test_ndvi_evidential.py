"""Evaluate an evidential U-Net on SEN12TP NDVI.

Counterpart of ``scripts/test/test_ndvi_evidential.py`` (reference
scripts/test/test_ndvi_evidential.py:150-209): one checkpoint, NIG
uncertainties, SEN12TP patch windows, calibration on a 50 % pixel
subsample:

    python -m mimo_unet_torch.scripts.test.test_ndvi_evidential \
        --model_checkpoint_path ~/ckpts/ev/last --result_dir ~/results \
        --dataset_dir ~/data/sen12tp/test

``--device`` is the torch device the model runs on; ``--processes`` is
accepted for compatibility and unused.  Writes the frames with pandas.
"""

import os
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

if __package__ in (None, ""):  # run by its path: make the package importable
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..")))

from mimo_unet_torch.eval.artifacts import (
    convert_to_dataframe,
    create_calibration,
    create_precision_recall,
    make_predictions_evidential,
)
from mimo_unet_torch.scripts.test.test_ndvi import load_dataset
from mimo_unet_torch.train.checkpoint import load_checkpoint


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--model_checkpoint_path", type=str, required=True)
    parser.add_argument("--result_dir", type=str, required=True)
    parser.add_argument("--dataset_dir", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--processes", type=int, default=2)  # compat, unused
    parser.add_argument("--batch_size", type=int, default=5)
    parser.add_argument("--patch_size", type=int, default=256)
    parser.add_argument("--stride", type=int, default=249)
    return parser


def main(args):
    result_dir = Path(args.result_dir)
    result_dir.mkdir(parents=True, exist_ok=False)

    task, state = load_checkpoint(args.model_checkpoint_path, device=args.device)
    dataset = load_dataset(args)

    print("Making predictions ...")
    preds = make_predictions_evidential(
        task, state.model, dataset, batch_size=args.batch_size
    )
    inputs, y_preds, y_trues, aleatoric_vars, epistemic_vars, combined_vars = preds

    print("Saving predictions ...")
    np.save(result_dir / "inputs.npy", inputs)
    np.save(result_dir / "y_preds.npy", y_preds)
    np.save(result_dir / "y_trues.npy", y_trues)
    np.save(result_dir / "aleatoric_vars.npy", aleatoric_vars)
    np.save(result_dir / "epistemic_vars.npy", epistemic_vars)

    df = convert_to_dataframe(
        y_preds, y_trues, aleatoric_vars, epistemic_vars, combined_vars
    )
    df.to_pickle(result_dir / "df_pixels.pkl")
    create_precision_recall(df).to_csv(result_dir / "precision_recall.csv", index=False)
    create_calibration(df, subsample=0.5).to_csv(
        result_dir / "calibration.csv", index=False
    )
    print("Finished processing dataset!")


if __name__ == "__main__":
    main(build_parser().parse_args())
