"""MUAD dataset (urban scenes; depth from disparity, segmentation labels).

Counterpart of ``mimo_unet_tpu/data/muad.py``, copied (cv2 and imageio are
imported where they are used).  Semantics from reference mimo/datasets/muad.py:19-176: images live in
``leftImg8bit/``, labels pair by numeric filename id from ``leftDepth/``
(depth) or ``leftLabel/`` (segmentation); depth = 1 - disparity read at
native bit depth; non-finite depth pixels are filled with 1 and masked out;
optional nearest resize; image / 255 when normalizing.

Reference bugs fixed here (SURVEY.md §7 quirks list):
  * ``Path.isdir()`` does not exist (muad.py:71,75,79 — AttributeError on
    every run); uses ``os.path.isdir``.
  * ``mask`` was unbound when the label dtype was not float32
    (muad.py:116-126); the mask is now always defined (all-valid for
    integer segmentation labels).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from mimo_unet_torch.data.core import ArrayDataset, DataModule


def load_scaled_depth(path: str) -> np.ndarray:
    """Disparity file -> scaled depth (near 0, far 1): depth = 1 - disparity."""
    import cv2

    disparity = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    return 1.0 - np.asarray(disparity, dtype=np.float32)


def fix_scaled_depth_map(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Fill non-finite pixels with 1 (far), return (fixed, finite-mask)."""
    img = img.copy()
    mask = np.isfinite(img)
    img[~mask] = 1.0
    return img, mask


def get_filename_id(file_name: str) -> int:
    return int(file_name.split("_")[0])


def create_path_dict(dir_path: str) -> Dict[int, str]:
    out = {}
    for f in os.listdir(dir_path):
        if f.endswith((".png", ".exr")):
            out[get_filename_id(f)] = os.path.join(dir_path, f)
    return out


def depth_to_meters(depth_map: np.ndarray) -> np.ndarray:
    """reference muad.py:174-176."""
    return depth_map * 400.0


def _load_muad(
    dataset_path: str,
    label_dir: str,
    load_label,
    dsize: Optional[tuple],
    normalize: bool,
    shuffle_on_load: bool,
    seed: Optional[int],
) -> ArrayDataset:
    import cv2
    import imageio.v3 as iio

    if not os.path.isdir(dataset_path):
        raise ValueError(f"dataset path '{dataset_path}' is not a directory")
    image_dir = os.path.join(dataset_path, "leftImg8bit")
    if not os.path.isdir(image_dir):
        raise ValueError(f"Image directory '{image_dir}' does not exist")
    label_path = os.path.join(dataset_path, label_dir) if label_dir else None
    has_labels = label_path is not None and os.path.isdir(label_path)

    image_paths = create_path_dict(image_dir)
    label_paths = create_path_dict(label_path) if has_labels else None
    if has_labels and image_paths.keys() != label_paths.keys():
        raise ValueError("image and label path ids do not match")

    ids = np.array(sorted(image_paths))
    if shuffle_on_load:
        ids = np.random.default_rng(seed).permutation(ids)

    def maybe_resize(a):
        if dsize is None:
            return a
        return cv2.resize(a, dsize=tuple(dsize), interpolation=cv2.INTER_NEAREST)

    images, labels, masks = [], [], []
    for i in ids:
        img = maybe_resize(np.asarray(iio.imread(image_paths[i])))
        images.append(img)
        if not has_labels:
            continue
        lbl = maybe_resize(load_label(label_paths[i]))
        if lbl.dtype == np.float32:
            lbl, mask = fix_scaled_depth_map(lbl)
        else:
            mask = np.ones_like(lbl, dtype=bool)
        labels.append(lbl)
        masks.append(mask)

    images = np.asarray(images, dtype=np.float32)
    if normalize:
        images /= 255.0
    data = {"image": images}
    if has_labels:
        data["label"] = np.asarray(labels, dtype=np.float32)[..., None]
        data["mask"] = np.asarray(masks, dtype=np.float32)[..., None]
    return ArrayDataset(data)


def load_muad_depth(
    dataset_path: str,
    dsize: Optional[tuple] = None,
    normalize: bool = True,
    shuffle_on_load: bool = False,
    seed: Optional[int] = None,
) -> ArrayDataset:
    return _load_muad(
        dataset_path, "leftDepth", load_scaled_depth, dsize, normalize,
        shuffle_on_load, seed,
    )


def load_muad_segmentation(
    dataset_path: str,
    dsize: Optional[tuple] = None,
    normalize: bool = True,
    shuffle_on_load: bool = False,
    seed: Optional[int] = None,
) -> ArrayDataset:
    import imageio.v3 as iio

    return _load_muad(
        dataset_path, "leftLabel", lambda p: np.asarray(iio.imread(p)), dsize,
        normalize, shuffle_on_load, seed,
    )


class MUADDepthDataModule(DataModule):
    """reference mimo/tasks/depth/muad_datamodule.py:10-129 surface."""

    def __init__(
        self,
        dataset_dir: str,
        batch_size: int,
        dsize: Optional[tuple] = None,
        normalize: bool = True,
        seed: Optional[int] = None,
    ):
        self.dataset_dir = dataset_dir
        self.batch_size = batch_size
        self.dsize = dsize
        self.normalize = normalize
        self.seed = seed
        self._train = self._val = self._test = None

    def setup(self) -> None:
        def make(split, shuffle):
            path = os.path.join(self.dataset_dir, split)
            if not os.path.isdir(path):
                return None
            return load_muad_depth(
                path, dsize=self.dsize, normalize=self.normalize,
                shuffle_on_load=shuffle, seed=self.seed,
            )

        self._train = make("train", False)
        self._val = make("val", True) or make("train", True)
        self._test = make("test", True)

    def train_dataset(self):
        return self._train

    def val_dataset(self):
        return self._val

    def test_dataset(self):
        return self._test

    @staticmethod
    def add_datamodule_args(parent_parser):
        parser = parent_parser.add_argument_group(title="MUADDepthDataModule")
        parser.add_argument("--dataset_dir", type=str, required=True)
        parser.add_argument("--batch_size", type=int, default=32)
        parser.add_argument("--num_workers", type=int, default=32)
        parser.add_argument("--pin_memory", type=bool, default=True)
        parser.add_argument("--dsize", type=int, nargs=2, default=None)
        parser.add_argument("--normalize", type=bool, default=True)
        return parent_parser
