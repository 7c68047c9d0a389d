"""Dropout with torch semantics (inverted scaling by 1/keep) and explicit
randomness.

Counterpart of ``mimo_unet_tpu/ops/dropout.py``.  The reference has
``nn.Dropout2d`` at the end of every DoubleConv (reference
mimo/models/mimo_components/components.py:29: whole channels per image)
and elementwise ``nn.Dropout`` at the center and final sites (model.py:210,
:281).  MC-dropout eval re-enables them at inference (ensemble.py:54-66).

Masks are boolean keep masks, one per live site of a forward, named after
the JAX package's key tree (``models/mimo_unet.py`` ``dropout_sites``): a
Dropout2d mask is ``[B, C]`` (the JAX package's ``(b, 1, 1, c)`` draw), an
elementwise mask has the activation's channels-last shape ``[B, H, W, C]``.
Every mask of a forward is drawn before the forward routes, in site order,
so one generator state gives the same masks on the plain and the kernel
paths.

``DropoutSource.draw`` runs inside the span ``mimo.dropout.draw`` and
counts what it draws (``draw_counts``: masks and their elements, since the
last ``reset_draw_counts``).

Rounding: ``dropout`` is ``where(mask, x / keep, 0)`` with ``keep`` in x's
dtype, as the JAX package's ``x / keep`` with a weakly typed ``keep`` (bf16
activations divide by bf16(keep)).  The kernel paths instead multiply by
``keep_scale`` (0 or 1/keep in f32) and round once, as the JAX package's
CT paths do (mimo_unet_tpu/models/fast_path.py:328-335): within one ulp.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from mimo_unet_torch.train.profiling import span

# one live site: (keep mask, keep probability); a forward's live sites by name
Drop = Tuple[torch.Tensor, float]
Drops = Mapping[str, Drop]
NO_DROPOUT: Drops = {}


class DropoutSource:
    """Where one forward's dropout masks come from: a ``torch.Generator``
    on the activations' device, or a dict of keep masks keyed by site name
    (masks replayed from another run or drawn by another package)."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 masks: Optional[Mapping[str, torch.Tensor]] = None):
        if (generator is None) == (masks is None):
            raise ValueError("give exactly one of generator and masks")
        self.generator = generator
        self.masks = masks

    def draw(self, sites: Mapping[str, Tuple[Sequence[int], float]],
             device: torch.device) -> Dict[str, Drop]:
        """Keep masks of ``sites`` (name -> (mask shape, rate)), in order:
        name -> (bool mask on ``device``, keep)."""
        out = {}
        with span("mimo.dropout.draw"):
            for name, (shape, rate) in sites.items():
                keep = 1.0 - rate
                shape = tuple(shape)
                if self.masks is None:
                    mask = torch.rand(shape, generator=self.generator,
                                      device=device) < keep
                else:
                    if name not in self.masks:
                        raise KeyError(f"no dropout mask for site {name!r}")
                    mask = self.masks[name]
                    if tuple(mask.shape) != shape:
                        raise ValueError(f"mask {name!r} must be {shape}, got "
                                         f"{tuple(mask.shape)}")
                    mask = mask.to(device=device, dtype=torch.bool)
                out[name] = (mask, keep)
                _DRAWS["masks"] += 1
                _DRAWS["mask_elements"] += mask.numel()
        return out


_DRAWS = {"masks": 0, "mask_elements": 0}


def reset_draw_counts() -> None:
    for k in _DRAWS:
        _DRAWS[k] = 0


def draw_counts() -> dict:
    """Keep masks handed out by ``DropoutSource.draw`` (drawn or replayed),
    ``"masks"``, and their elements, ``"mask_elements"``, since the last
    ``reset_draw_counts``."""
    return dict(_DRAWS)


def shard_rows(drops: Drops, index: int, count: int) -> Dict[str, Drop]:
    """The live sites of a forward whose input is shard ``index`` of
    ``count`` of the height (a spatial mesh): each elementwise mask
    [B, H, W, C], drawn at the global height, cut to the shard's rows;
    Dropout2d masks [B, C] as they are."""
    out = {}
    for name, (mask, keep) in drops.items():
        if mask.ndim == 4:
            per = mask.shape[1] // count
            mask = mask[:, index * per:(index + 1) * per]
        out[name] = (mask, keep)
    return out


def dropout(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """Inverted dropout with a keep mask broadcastable to ``x``."""
    return torch.where(mask, x / torch.tensor(keep, dtype=x.dtype, device=x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout2d(x: torch.Tensor, drop: Optional[Drop]) -> torch.Tensor:
    """Channel dropout of NCHW ``x`` with a ``[B, C]`` keep mask; ``None``
    means the site is not live."""
    if drop is None:
        return x
    mask, keep = drop
    return dropout(x, mask[:, :, None, None], keep)


def keep_scale(masks: Sequence[torch.Tensor], keep: float, dim: int = 0
               ) -> torch.Tensor:
    """Keep masks joined on ``dim`` as f32 scales: 0 or 1/keep."""
    return torch.cat(list(masks), dim=dim).float() / keep


def scale_channels(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Channels-last ``x`` [N, ..., C] times per-(image, channel) f32
    scales [N, C], rounded once to x's dtype."""
    view = (scale.shape[0],) + (1,) * (x.ndim - 2) + (scale.shape[1],)
    return (x.float() * scale.view(view)).to(x.dtype)
