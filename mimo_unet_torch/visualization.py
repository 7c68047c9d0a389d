"""Colormap visualization of prediction/uncertainty maps (numpy;
matplotlib imported when a map is colorized).

Copied from ``mimo_unet_tpu/visualization.py`` (the port imports nothing of
the JAX package).  Rebuilt from reference mimo/visualization.py:9-49
(``colorize``) and the grid assembly in the OutputMonitor callbacks
(mimo/tasks/depth/callbacks.py:18-144): grayscale maps -> matplotlib
colormap RGB uint8 with vmin/vmax normalization, tiled into image grids.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def colorize(
    value: np.ndarray,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    cmap: str = "turbo",
) -> np.ndarray:
    """[H, W] or [H, W, 1] float map -> [H, W, 3] uint8 RGB."""
    import matplotlib

    value = np.asarray(value, dtype=np.float32)
    if value.ndim == 3:
        value = value[..., 0]
    vmin = float(np.nanmin(value)) if vmin is None else vmin
    vmax = float(np.nanmax(value)) if vmax is None else vmax
    if vmax - vmin > 1e-12:
        value = (value - vmin) / (vmax - vmin)
    else:
        value = value * 0.0
    value = np.clip(value, 0.0, 1.0)
    rgba = matplotlib.colormaps[cmap](value, bytes=True)
    return rgba[..., :3]


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2) -> np.ndarray:
    """Tile [N, H, W, 3] uint8 images into one grid image (torchvision-style)."""
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros(
        (nrows * (h + padding) + padding, ncol * (w + padding) + padding, c),
        dtype=images.dtype,
    )
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = r * (h + padding) + padding
        x0 = col * (w + padding) + padding
        grid[y0 : y0 + h, x0 : x0 + w] = images[i]
    return grid


def colorize_grid(
    maps: np.ndarray,
    vmin: Optional[float],
    vmax: Optional[float],
    cmap: str,
    max_items: int = 8,
) -> np.ndarray:
    """[N, H, W, 1] float maps -> one colorized grid image [H', W', 3]."""
    maps = np.asarray(maps)[:max_items]
    colored = np.stack([colorize(m, vmin, vmax, cmap) for m in maps])
    return make_grid(colored)


def output_monitor_images(
    outputs: dict,
    mode: str = "depth",
    max_items: int = 8,
    target_names=None,
) -> dict:
    """Build the reference OutputMonitor image set from a step's outputs.

    Depth flavor (depth/callbacks.py:59-87): pred/true in "turbo" [0,1],
    |error| in "Reds" [0,2], aleatoric/epistemic std in "Reds" [0,1].
    SEN12TP flavor (sen12tp/callbacks.py:32-71): one image set *per target
    channel*, names templated on the vegetation index ("{veg_index}_predicted"
    etc.), pred/true "Greens", error "seismic" symmetric [-2, 2].  Pass
    ``target_names`` (the datamodule's model_targets) for multi-target runs;
    unnamed channels fall back to "target{i}".
    """
    import numpy as np

    def np_(x):
        return np.asarray(x)

    mask = outputs.get("mask")
    preds = np_(outputs["preds"])
    label = np_(outputs["label"])
    err = np_(outputs["err_map"])
    if mask is not None:
        m = np_(mask)
        preds, label, err = preds * m, label * m, err * m
    ale = outputs.get("aleatoric_std_map")
    epi = outputs.get("epistemic_std_map")

    images = {}
    if mode == "sen12tp":
        # per-target loop, reference sen12tp/callbacks.py:32-48
        n_targets = preds.shape[-1]
        if target_names is None:
            target_names = (
                [""] if n_targets == 1 else [f"target{i}" for i in range(n_targets)]
            )
        if len(target_names) != n_targets:
            raise ValueError(
                f"target_names has {len(target_names)} entries but outputs "
                f"carry {n_targets} channels"
            )
        for idx, veg_index in enumerate(target_names):
            prefix = f"{veg_index}_" if veg_index else ""
            sl = slice(idx, idx + 1)
            images[f"{prefix}predicted"] = colorize_grid(
                preds[..., sl], 0, 1, "Greens", max_items
            )
            images[f"{prefix}true"] = colorize_grid(
                label[..., sl], 0, 1, "Greens", max_items
            )
            images[f"{prefix}error"] = colorize_grid(
                err[..., sl], -2, 2, "seismic", max_items
            )
            if ale is not None:
                images[f"{prefix}aleatoric_std"] = colorize_grid(
                    np_(ale)[..., sl], 0, 1, "Reds", max_items
                )
            if epi is not None:
                images[f"{prefix}epistemic_std"] = colorize_grid(
                    np_(epi)[..., sl], 0, 1, "Reds", max_items
                )
        return images

    images["pred"] = colorize_grid(preds, 0, 1, "turbo", max_items)
    images["true"] = colorize_grid(label, 0, 1, "turbo", max_items)
    images["error"] = colorize_grid(np.abs(err), 0, 2, "Reds", max_items)
    if ale is not None:
        images["aleatoric_std"] = colorize_grid(np_(ale), 0, 1, "Reds", max_items)
    if epi is not None:
        images["epistemic_std"] = colorize_grid(np_(epi), 0, 1, "Reds", max_items)
    return images
