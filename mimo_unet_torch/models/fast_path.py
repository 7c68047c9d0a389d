"""Kernel path of the MimoUNet eval forward.

Counterpart of ``mimo_unet_tpu/models/fast_path.py``'s
``ct_fast_path_supported`` / ``mimo_unet_apply_ct`` (:745-859), fully fused
branch (``up3_ct and emit_ph``, :785-834).  The per-subnetwork encoders and
decoders, where channels are few and resolution high, run the hand-written
kernels of ``mimo_unet_torch/kernels``; the shared core between them
(``_core_mid_eval``, :709-742) runs as the plain modules (cuDNN):

  in_conv   fused_double_conv9 (c_in <= 8) or fused_double_conv, which also
            emits the H half of down1's pool          [S*B, H, W, F]
  down1     pool_w, then fused_double_conv writing the subnetwork channel
            concat the core reads (group_rows_out) and the H half of the
            core's down2 pool                          [B, H/2, W/2, 2FS]
  core      pool_w, then down2 .. up2 (plain)          [B, H/4, W/4, 2FS]
  up3       upsample_w2x, then fused_double_conv with the skip and the
            in-kernel H lerp (x2_half_h)               [B, H/2, W/2, FS]
  decoder   upsample_w2x, then fused_double_conv per subnetwork with the
            shared upsampled input (x2 period B), H lerp in-kernel and the
            1x1 out-conv fused                        [S*B, H, W, C_out]

Subnetworks fold S-major into the image axis (n = s*B + b), as in the JAX
package, so image n uses group n // B.  BatchNorm and bias fold into the
kernels' (scale, shift); dropout is inactive (eval).

Not ported, being TPU-only: the NHWC down1 fallback for ``w/2 % 128``, the
non-up3 decoder, the tile ladders and VMEM estimators, the compile probe,
``w_img`` and ``group_minor``.  MC dropout is not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from mimo_unet_torch.kernels import (
    fused_double_conv,
    fused_double_conv9,
    pool_w,
    upsample_w2x,
)
from mimo_unet_torch.models.blocks import DoubleConv
from mimo_unet_torch.models.mimo_unet import MimoUNetConfig


def fast_path_supported(cfg: MimoUNetConfig, x_shape: Tuple[int, ...],
                        device: torch.device, *, training: bool,
                        mc_dropout: bool = False) -> bool:
    """True when the kernel path applies.  Routes on configuration as
    ``ct_fast_path_supported`` does: "off" never, "auto" for CUDA inputs,
    "force" on any device (on the CPU every kernel wrapper runs its plain
    version).  Gates on what the kernels need: eval, bf16, bilinear, no MC
    dropout, and H, W multiples of 16 (four pool levels, no pad-to-match).
    Nothing here catches a kernel failure: a CUDA launch that fails raises.
    """
    if cfg.ct_kernels == "off":
        return False
    if cfg.ct_kernels == "auto" and torch.device(device).type != "cuda":
        return False
    if training or mc_dropout:
        return False
    if cfg.compute_dtype != "bfloat16" or cfg.mode != "bilinear":
        return False
    if len(x_shape) != 5:
        return False
    h, w = x_shape[2], x_shape[3]
    return h >= 16 and w >= 16 and h % 16 == 0 and w % 16 == 0


def fold_bn_eval(conv_bias: torch.Tensor, bn: torch.nn.BatchNorm2d
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold conv bias + eval BatchNorm into f32 (scale, shift)
    (``ct_conv.py:614-628``):
      y = ((conv + b) - mean) * gamma / sqrt(var + eps) + beta
        = conv * scale + shift."""
    scale = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    shift = bn.bias.float() + (conv_bias.float() - bn.running_mean.float()) * scale
    return scale, shift


def _hwio(conv: torch.nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)


def double_conv_args(dcs: Sequence[DoubleConv]):
    """Grouped kernel arguments of one DoubleConv per group:
    (w1 [G,3,3,C,M], s1, sh1 [G,M], w2 [G,3,3,M,O], s2, sh2 [G,O])."""
    w1, s1, sh1, w2, s2, sh2 = [], [], [], [], [], []
    for dc in dcs:
        c1, bn1, _, c2, bn2, _ = dc.double_conv
        a, b = fold_bn_eval(c1.bias, bn1)
        c, d = fold_bn_eval(c2.bias, bn2)
        w1.append(_hwio(c1))
        w2.append(_hwio(c2))
        s1.append(a)
        sh1.append(b)
        s2.append(c)
        sh2.append(d)
    return tuple(torch.stack(t) for t in (w1, s1, sh1, w2, s2, sh2))


@torch.no_grad()
def mimo_unet_apply_fast(model, x: torch.Tensor) -> torch.Tensor:
    """Eval forward through the kernels: [B, S, H, W, C_in] ->
    [B, S, H, W, C_out] float32 (``mimo_unet_apply_ct``)."""
    b, s, h, w, cin = x.shape
    n = s * b
    enc, core, dec = model.encoder, model.core, model.decoder
    bf16 = torch.bfloat16

    # ---- encoder in_conv: S-major fold, emits the H half of down1's pool
    xin = x.to(bf16).transpose(0, 1).reshape(n, h, w, cin).contiguous()
    conv_in = fused_double_conv9 if cin <= 8 else fused_double_conv
    x1s, hp1 = conv_in(xin, *double_conv_args(enc.in_convs), emit_hpool=True)

    # ---- down1: writes the subnetwork channel concat [B, H/2, W/2, 2FS]
    # and the H half of the core's down2 pool
    x2cat, hp2 = fused_double_conv(
        pool_w(hp1), *double_conv_args([d.conv for d in enc.down1s]),
        emit_hpool=True, group_rows_out=True)

    # ---- shared core, down2 .. up2 (plain modules on an NCHW view of the
    # channels-last tensor)
    xu2 = core.mid(pool_w(hp2).permute(0, 3, 1, 2))
    xu2 = xu2.permute(0, 2, 3, 1).contiguous()

    # ---- up3: skip x2cat + upsampled up2 output (W half here, H in-kernel)
    xup = fused_double_conv(
        x2cat, *double_conv_args([core.up3.conv]),
        x2=upsample_w2x(xu2), x2_half_h=True)

    # ---- decoder up4 + out-conv per subnetwork; the upsampled core output
    # (period B) is shared by the S subnetworks
    wo = torch.stack([oc.conv.weight[:, :, 0, 0].t() for oc in dec.outcs])
    bo = torch.stack([oc.conv.bias for oc in dec.outcs])
    logits = fused_double_conv(
        x1s, *double_conv_args([u.conv for u in dec.up4s]),
        x2=upsample_w2x(xup), x2_half_h=True, wo=wo, bo=bo)
    # [S*B, H, W, C] -> [B, S, H, W, C] float32 at the loss boundary
    return logits.view(s, b, h, w, -1).transpose(0, 1).float().contiguous()
