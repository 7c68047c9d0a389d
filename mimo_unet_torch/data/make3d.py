"""Make3D depth dataset (jpg images + .mat Position3DGrid depth).

Counterpart of ``mimo_unet_tpu/data/make3d.py``, copied (cv2 and scipy are
imported where they are used).  Semantics from reference mimo/datasets/make3d.py:12-104: images loaded via
cv2 (BGR->RGB) and nearest-resized to 345x460; depth = Position3DGrid[:,:,3]
cubic-zoomed to the same size; mask = depth <= 70 meters; normalize divides
image by 255 and depth by 120.

Deviation (documented): the reference computes the mask but comments out
returning it (make3d.py:100) — here it IS returned, since the loss/task
layer supports masks end-to-end; pass ``with_mask=False`` for bitwise-
matching batch dicts.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from mimo_unet_torch.data.core import ArrayDataset, DataModule

DSIZE = (345, 460)  # (width, height), reference make3d.py:25


def _load_images(base: str, names, dsize=DSIZE) -> np.ndarray:
    import cv2

    out = []
    for name in names:
        img = cv2.imread(os.path.join(base, name))
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        out.append(cv2.resize(img, dsize=dsize, interpolation=cv2.INTER_NEAREST))
    return np.asarray(out)


def _load_depths(base: str, names, dsize=DSIZE) -> np.ndarray:
    import scipy.io
    import scipy.ndimage

    out = []
    for name in names:
        grid = scipy.io.loadmat(os.path.join(base, name))["Position3DGrid"]
        depth = grid[:, :, 3]
        zoom = (dsize[1] / depth.shape[0], dsize[0] / depth.shape[1])
        out.append(scipy.ndimage.zoom(depth, zoom, order=3))
    return np.asarray(out)[..., None]


def load_make3d_depth(
    dataset_path: str,
    normalize: bool = True,
    shuffle_on_load: bool = False,
    use_fraction: float = 1.0,
    with_mask: bool = True,
    seed: Optional[int] = None,
) -> ArrayDataset:
    image_names = sorted(
        f for f in os.listdir(os.path.join(dataset_path, "images")) if f.endswith(".jpg")
    )
    label_names = sorted(
        f for f in os.listdir(os.path.join(dataset_path, "labels")) if f.endswith(".mat")
    )
    images = _load_images(os.path.join(dataset_path, "images"), image_names)
    labels = _load_depths(os.path.join(dataset_path, "labels"), label_names)
    if len(images) != len(labels):
        raise ValueError(
            f"Number of images and labels must be equal. Got {len(images)} "
            f"images and {len(labels)} labels."
        )
    masks = (labels <= 70).astype(np.float32)

    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(images)) if shuffle_on_load else np.arange(len(images))
    if use_fraction < 1.0:
        perm = rng.choice(perm, size=int(len(images) * use_fraction), replace=False)
    images, labels, masks = images[perm], labels[perm], masks[perm]

    images = images.astype(np.float32)
    labels = labels.astype(np.float32)
    if normalize:
        images /= 255.0
        labels /= 120.0

    data = {"image": images, "label": labels}
    if with_mask:
        data["mask"] = masks
    return ArrayDataset(data)


class Make3dDepthDataModule(DataModule):
    """train/ and test/ subdirectories each holding images/ + labels/
    (reference mimo/tasks/depth/make3d_datamodule.py:12-132)."""

    def __init__(
        self,
        dataset_dir: str,
        batch_size: int,
        normalize: bool = True,
        train_dataset_fraction: float = 1.0,
        with_mask: bool = True,
        seed: Optional[int] = None,
    ):
        self.dataset_dir = dataset_dir
        self.batch_size = batch_size
        self.normalize = normalize
        self.train_dataset_fraction = train_dataset_fraction
        self.with_mask = with_mask
        self.seed = seed
        self._train = self._val = self._test = None

    def setup(self) -> None:
        train_dir = os.path.join(self.dataset_dir, "train")
        test_dir = os.path.join(self.dataset_dir, "test")
        self._train = load_make3d_depth(
            train_dir, normalize=self.normalize,
            use_fraction=self.train_dataset_fraction,
            with_mask=self.with_mask, seed=self.seed,
        )
        self._val = load_make3d_depth(
            train_dir, normalize=self.normalize, shuffle_on_load=True,
            with_mask=self.with_mask, seed=self.seed,
        )
        if os.path.isdir(test_dir):
            self._test = load_make3d_depth(
                test_dir, normalize=self.normalize, shuffle_on_load=True,
                with_mask=self.with_mask, seed=self.seed,
            )

    def train_dataset(self):
        return self._train

    def val_dataset(self):
        return self._val

    def test_dataset(self):
        return self._test

    @staticmethod
    def add_model_specific_args(parent_parser):
        parser = parent_parser.add_argument_group(title="Make3dDepthDataModule")
        parser.add_argument("--dataset_dir", type=str, required=True)
        parser.add_argument("--batch_size", type=int, default=32)
        parser.add_argument("--num_workers", type=int, default=32)
        parser.add_argument("--pin_memory", type=bool, default=True)
        parser.add_argument("--train_dataset_fraction", type=float, default=1.0)
        return parent_parser
