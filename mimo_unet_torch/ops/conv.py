"""2D convolutions (NCHW activations, OIHW weights).

Counterpart of ``mimo_unet_tpu/ops/conv.py`` for the reference blocks
(mimo/models/mimo_components/components.py:23-28, :97-99): 3x3 convs with
torch's ``padding_mode="reflect"``, 1x1 output convs and the transpose
decoder's 2x2 stride-2 transposed conv.

The activation dtype is the compute dtype: weights are cast to it and the
output stays in it (the bf16 recipe of the JAX package).  The bias is added
after the convolution, in the activation dtype, as the JAX package does, so
bf16 outputs round at the same two places.

Under a spatial mesh (``parallel/mesh.py`` ``Mesh2D``, the active
``ct_mesh_scope``) each rank holds its rows of the height: the 3x3 conv
takes the rows past its shard's edges from its neighbours
(``parallel/halo.py``) and reflects only at the global top and bottom.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mimo_unet_torch.parallel.halo import halo_rows
from mimo_unet_torch.parallel.mesh import current_ct_mesh, spans_ranks, spatial_mesh


def _pad_reflect1(x: torch.Tensor) -> torch.Tensor:
    """1-pixel reflect padding of [N, C, H, W]; under a spatial mesh the
    rows past an inner shard edge are the neighbours' (``halo_rows``).
    The global top row's reflect partner is global row 1: row 2 of the
    haloed shard, which is the bottom halo where a shard holds one row;
    likewise at the global bottom."""
    mesh = spatial_mesh(current_ct_mesh())
    if not spans_ranks(mesh):
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    xp = halo_rows(x, mesh)
    if mesh.rank == 0:
        xp = torch.cat([xp[..., 2:3, :], xp[..., 1:, :]], dim=-2)
    elif mesh.rank == mesh.size - 1:
        xp = torch.cat([xp[..., :-1, :], xp[..., -3:-2, :]], dim=-2)
    return F.pad(xp, (1, 1, 0, 0), mode="reflect")


def conv3x3_reflect(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor], *, groups: int = 1
                    ) -> torch.Tensor:
    """3x3 conv with 1-pixel reflect padding: [N, C, H, W] -> [N, O, H, W].
    ``bias=None`` skips the bias add (train mode: the BatchNorm that
    follows cancels it, mimo_unet_tpu/models/blocks.py:86-91)."""
    y = F.conv2d(_pad_reflect1(x), weight.to(x.dtype), None, groups=groups)
    if bias is None:
        return y
    return y + bias.to(y.dtype).view(1, -1, 1, 1)


def conv1x1(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor, *, groups: int = 1) -> torch.Tensor:
    """1x1 conv: [N, C, H, W] -> [N, O, H, W]."""
    y = F.conv2d(x, weight.to(x.dtype), None, groups=groups)
    return y + bias.to(y.dtype).view(1, -1, 1, 1)


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, *, stride: int = 2) -> torch.Tensor:
    """Transposed conv (the transpose ``Up``'s 2x2 stride-2 upsample,
    reference components.py:97-99): [N, C, H, W] -> [N, O, 2H, 2W] for a
    ``[C, O, 2, 2]`` weight, rounding where ``conv_transpose2d`` of
    mimo_unet_tpu/ops/conv.py:300-329 rounds."""
    y = F.conv_transpose2d(x, weight.to(x.dtype), None, stride=stride)
    return y + bias.to(y.dtype).view(1, -1, 1, 1)
