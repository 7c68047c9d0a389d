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

Not ported for eval, being TPU-only: the NHWC down1 fallback for
``w/2 % 128``, the non-up3 decoder, the tile ladders and VMEM estimators, the compile probe,
``w_img`` and ``group_minor``.  MC dropout is not ported yet.

The train half (``train_path_supported`` / ``mimo_unet_apply_train``) is
the counterpart of ``ct_train_path_supported`` / ``mimo_unet_apply_ct_train``
(:866-1510) on the route where the half width is not a multiple of 128
(640x480 NYUv2 frames): no pool or x2-upsample kernel runs there.

  in_conv   conv3x3_fwd 3->F, then conv3x3_fwd F->F with bn1's affine as
            its prologue; BN affines from the kernels' sums; affine_relu
            gives x1s, the skip and down1's input        [S*B, H, W, F]
  down1     the plain Down module per subnetwork (cuDNN, train BN)
  core      the plain modules, train mode               [B, H/2, W/2, FS]
  decoder   plain x2 upsample (bf16 interpolation matrices) to channels-
            last, conv3x3_fwd over [x1s, up] (x2 period B), conv3x3_fwd
            with bn1's prologue, conv1x1_prelu: bn2 + ReLU + out-conv
                                                        [S*B, H, W, C_out]

Every conv is a ``Conv3x3Train`` (forward K5; backward g_eff K9, dx K6 in
plain or fold form, dw K7).  BatchNorm running statistics update in place.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from mimo_unet_torch.kernels import (
    AffineRelu,
    Conv1x1Prelu,
    Conv3x3Train,
    fused_double_conv,
    fused_double_conv9,
    pool_w,
    upsample_w2x,
)
from mimo_unet_torch.models.blocks import DoubleConv
from mimo_unet_torch.models.mimo_unet import MimoUNetConfig
from mimo_unet_torch.ops import upsample_x2_nchw_to_nhwc
from mimo_unet_torch.ops.norm import update_running_stats

# what the train kernels take (csrc/conv3x3_train.cu KMAX, train_elem.cu
# CMAX and OCMAX)
_TRAIN_MAX_CIN, _TRAIN_MAX_C, _TRAIN_MAX_OC = 128, 64, 8


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


# ===========================================================================
# train half


def train_path_supported(cfg: MimoUNetConfig, x_shape: Tuple[int, ...],
                         device: torch.device, *, training: bool,
                         mc_dropout: bool = False) -> bool:
    """True when the train kernel path applies (``ct_train_path_supported``,
    mimo_unet_tpu/models/fast_path.py:866-961, on what these kernels need):
    train mode, no MC dropout, bf16, bilinear, "auto" only for CUDA inputs,
    H and W multiples of 16, channel counts the kernels take, every
    dropout rate 0 and ``remat == "none"`` (not ported yet), and a half
    width that is not a multiple of 128: the 640x480 route, on which the
    JAX package runs neither its pool nor its x2-upsample kernel.  Other
    shapes (256x256 among them) take the plain modules."""
    if cfg.ct_kernels == "off" or not training or mc_dropout:
        return False
    if cfg.ct_kernels == "auto" and torch.device(device).type != "cuda":
        return False
    if cfg.compute_dtype != "bfloat16" or cfg.mode != "bilinear":
        return False
    if any(r > 0 for r in (cfg.center_dropout_rate, cfg.final_dropout_rate,
                           cfg.encoder_dropout_rate, cfg.core_dropout_rate,
                           cfg.decoder_dropout_rate)) or cfg.remat != "none":
        return False
    f = cfg.filter_base_count
    c_up = 2 * f * cfg.num_subnetworks // cfg.factor
    if (f > _TRAIN_MAX_C or f + c_up > _TRAIN_MAX_CIN
            or max(cfg.in_channels, (f + c_up) // 2) > _TRAIN_MAX_C
            or cfg.out_channels > _TRAIN_MAX_OC):
        return False
    if len(x_shape) != 5:
        return False
    h, w = x_shape[2], x_shape[3]
    if not (h >= 16 and w >= 16 and h % 16 == 0 and w % 16 == 0):
        return False
    return (w // 2) % 128 != 0


def _bn_affine_from_stats(s: torch.Tensor, q: torch.Tensor, count: int,
                          convs: Sequence[torch.nn.Conv2d],
                          bns: Sequence[torch.nn.BatchNorm2d]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm affine per group from the kernels' sums of the
    bias-free conv output (``_bn_affine_from_stats``, fast_path.py:968-990):
    the biased batch variance normalizes, the running statistics (updated
    in place here) take the unbiased one and the conv bias on the mean.
    Returns (scale, shift) [G, O] f32, differentiable in s, q and the BN
    affine."""
    mean_raw = s / count
    var = q / count - mean_raw * mean_raw
    gamma = torch.stack([bn.weight for bn in bns]).float()
    beta = torch.stack([bn.bias for bn in bns]).float()
    scale = gamma * torch.rsqrt(var + bns[0].eps)
    shift = beta - mean_raw * scale
    with torch.no_grad():
        for g, (conv, bn) in enumerate(zip(convs, bns)):
            update_running_stats(bn.running_mean, bn.running_var,
                                 mean_raw[g] + conv.bias.float(), var[g],
                                 count, bn.momentum)
            bn.num_batches_tracked.add_(1)
    return scale, shift


def _w_train(convs: Sequence[torch.nn.Conv2d]) -> torch.Tensor:
    """Per-group HWIO weights [G, 3, 3, C, O] in bf16: the kernels' dw
    rounds to bf16 on its way back, as the JAX package's does."""
    return torch.stack([_hwio(c) for c in convs]).to(torch.bfloat16)


def _conv_bn(x1, dcs, idx, count, *, x2=None, prologue=None):
    """One train conv (position ``idx`` = 0 or 1 of each group's
    DoubleConv) and its BatchNorm: returns (y_raw, scale, shift)."""
    convs = [dc.double_conv[3 * idx] for dc in dcs]
    bns = [dc.double_conv[3 * idx + 1] for dc in dcs]
    sc, sh = prologue if prologue is not None else (None, None)
    y, s, q = Conv3x3Train.apply(x1, x2, _w_train(convs), sc, sh)
    scale, shift = _bn_affine_from_stats(s, q, count, convs, bns)
    return y, scale, shift


def mimo_unet_apply_train(model, x: torch.Tensor) -> torch.Tensor:
    """Train forward through the kernels (``mimo_unet_apply_ct_train``):
    [B, S, H, W, C_in] -> [B, S, H, W, C_out] float32 logits; every
    BatchNorm's running statistics update in place."""
    b, s, h, w, cin = x.shape
    n = s * b
    enc, core, dec = model.encoder, model.core, model.decoder
    cnt_full = b * h * w  # per group: the whole batch normalizes each group

    # ---- encoder in_conv (kernels), S-major fold
    xin = x.to(torch.bfloat16).transpose(0, 1).reshape(n, h, w, cin).contiguous()
    y1, sc1, sh1 = _conv_bn(xin, enc.in_convs, 0, cnt_full)
    y2, sc2, sh2 = _conv_bn(y1, enc.in_convs, 1, cnt_full, prologue=(sc1, sh1))
    x1s = AffineRelu.apply(y2, sc2, sh2)  # [n, h, w, F]: skip and down1 input

    # ---- down1 (plain NHWC Down per subnetwork, fast_path.py:1215-1240)
    x1n = x1s.permute(0, 3, 1, 2)
    x2s = [d1(x1n[i * b:(i + 1) * b]) for i, d1 in enumerate(enc.down1s)]

    # ---- shared core (plain modules, train mode)
    x_up = core(torch.cat(x2s, dim=1))

    # ---- decoder: plain x2 upsample to channels-last (period B: image n
    # reads upsampled image n % B), two kernel convs, fused out-conv
    up = upsample_x2_nchw_to_nhwc(x_up)
    up4 = [u.conv for u in dec.up4s]
    y5, sc5, sh5 = _conv_bn(x1s, up4, 0, cnt_full, x2=up)
    y6, sc6, sh6 = _conv_bn(y5, up4, 1, cnt_full, prologue=(sc5, sh5))
    wo = torch.stack([oc.conv.weight[:, :, 0, 0].t() for oc in dec.outcs])
    bo = torch.stack([oc.conv.bias for oc in dec.outcs])
    logits = Conv1x1Prelu.apply(y6, sc6, sh6, wo, bo)
    return logits.view(s, b, h, w, -1).transpose(0, 1).float()
