"""Offline evaluation (PyTorch): FGSM, predictions, uncertainty artifacts."""

from mimo_unet_torch.eval.artifacts import (
    convert_to_dataframe,
    create_calibration,
    create_precision_recall,
    make_predictions,
    make_predictions_evidential,
    write_artifacts,
)
from mimo_unet_torch.eval.fgsm import fgsm_attack, make_fgsm_fn

__all__ = [
    "fgsm_attack",
    "make_fgsm_fn",
    "make_predictions",
    "make_predictions_evidential",
    "convert_to_dataframe",
    "create_precision_recall",
    "create_calibration",
    "write_artifacts",
]
