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
kernels' (scale, shift).

MC dropout (the reference sites live at eval, BatchNorm in eval mode):
each Dropout2d site is a per-(image, channel) scale 0 or 1/keep on the
kernel output, applied as plain tensor ops where the JAX package uses XLA
(``_apply_mc_scale``, fast_path.py:328-335).  The scale is nonnegative and
per channel, so it commutes with the max of the H half-pool the kernels
emit: in_conv scales x1s and its H half, down1 the subnetwork concat
(channel block g with subnetwork g's mask) and its H half, the core runs
its sites in the plain modules, up3 scales the up3 kernel's output.  A
live up4 Dropout2d or final dropout sits between the decoder's DoubleConv
and its out-conv: the decoder kernel runs without the fused 1x1, the site
applies, and the grouped 1x1 kernel (K11) follows (:645-679).

Not ported for eval, being TPU-only: the NHWC down1 fallback for
``w/2 % 128``, the non-up3 decoder, the tile ladders and VMEM estimators, the compile probe,
``w_img`` and ``group_minor``.

The train half (``train_path_supported`` / ``mimo_unet_apply_train``) is
the counterpart of ``ct_train_path_supported`` / ``mimo_unet_apply_ct_train``
(:866-1510) on its aligned route (``_ct_train_down1_aligned``, the
``bpool`` encoder and the ``upsample2x_ct`` decoder), the port's one train
route: the TPU's lane conditions are not ported, so 256x256 patches and
640x480 NYUv2 frames take the same kernels.

  in_conv   conv3x3_fwd 3->F, then conv3x3_fwd F->F with bn1's affine as
            its prologue; BN affines from the kernels' sums; affine_relu
            gives x1s; MaxPool2x2Skip (K10) pools it for down1, and the
            decoder reads its identity output, so the skip's cotangent
            joins the pool's backward (:1162-1179)     [S*B, H, W, F]
  down1     conv3x3_fwd F->2F, conv3x3_fwd 2F->2F with bn1's prologue,
            BN counts B*(H/2)*(W/2), affine_relu; MaxPool2x2Skip pools the
            core boundary (:1180-1214)                 [S*B, H/2, W/2, 2F]
  core      the plain modules, train mode, on the subnetwork channel
            concat of the identity (up3's skip) and of the pooled tensor
            (down2's input, ``Core.forward(x2_pooled=)``)
                                                        [B, H/2, W/2, FS]
  decoder   Upsample2x (K13) to channels-last, conv3x3_fwd over [x1s, up]
            (x2 period B), conv3x3_fwd with bn1's prologue, conv1x1_prelu:
            bn2 + ReLU + out-conv                     [S*B, H, W, C_out]
            With MIMO_CT_TRAIN_X2_HALF set to anything but "0" (opt-in, as
            in the JAX package, :1276-1300) the x2-half decoder instead:
            UpsampleW2x (K4, backward K4b) at half height, and conv1 with
            ``x2_half_h`` (its forward and dw kernels lerp the rows as they
            stage them, its backward takes the x2 cotangent to half height
            with K14), so the full-res upsampled tensor never exists; the
            step is bit for bit the default one

Every conv is a ``Conv3x3Train`` (forward K5; backward g_eff K9, dx K6 in
plain or fold form, dw K7).  BatchNorm running statistics update in place,
from the raw conv output before any dropout site.

Dropout (``_enc_train_local`` / ``_dec_train_local``, :1082-1380): the
in_conv, down1 and up4 Dropout2d sites fold into a per-image BN affine,
``relu(y*sc + sh)*m == relu(y*(sc*m) + sh*m)`` for m >= 0, so affine_relu
(K8) and conv1x1_prelu (K12, with wo and bo broadcast per image) run with
one parameter row per image; the core runs its sites in the plain
modules; the elementwise final dropout takes affine_relu, the dropout,
then the grouped 1x1 (K11) forward and backward.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch

from mimo_unet_torch.kernels import conv3x3_train
from mimo_unet_torch.kernels.fused_double_conv import plan_of
from mimo_unet_torch.kernels import (
    AffineRelu,
    Conv1x1,
    Conv1x1Prelu,
    Conv3x3Train,
    MaxPool2x2Skip,
    Upsample2x,
    UpsampleW2x,
    conv1x1,
    fused_double_conv,
    fused_double_conv9,
    pool_w,
    upsample_w2x,
)
from mimo_unet_torch.models.blocks import DoubleConv
from mimo_unet_torch.models.mimo_unet import MimoUNetConfig
from mimo_unet_torch.ops.dropout import (
    NO_DROPOUT,
    Drops,
    dropout,
    keep_scale,
    scale_channels,
)
from mimo_unet_torch.ops.norm import update_running_stats

# what the train kernels take: a 3x3 conv's input and output channels
# (conv3x3_train.MAX_C), the 1x1 out-conv's input and output channels
# (train_elem.cu CMAX, OCMAX)
_TRAIN_MAX_CONV_C, _TRAIN_MAX_C, _TRAIN_MAX_OC = conv3x3_train.MAX_C, 128, 8


def check_channels(cfg: MimoUNetConfig, *, convs: bool = True) -> None:
    """Raise, naming the limit, where a channel count of ``cfg`` is beyond
    what the train kernels take (``convs``: the 3x3 train convs too; else
    only the 1x1 out-conv, K11, as MC-dropout serving runs it): a
    configuration that routes to the kernels runs on them or fails, it
    never falls back to the plain model."""
    f = cfg.filter_base_count
    c_up = 2 * f * cfg.num_subnetworks // cfg.factor
    # in_conv C_in -> F -> F, down1 F -> 2F -> 2F, up4 (F + C_up) -> mid -> F
    widest = max(cfg.in_channels, 2 * f, f + c_up)
    if convs and widest > _TRAIN_MAX_CONV_C:
        raise ValueError(f"the train conv kernels take at most "
                         f"{_TRAIN_MAX_CONV_C} channels, this configuration "
                         f"needs {widest} (filter_base_count {f}, "
                         f"{cfg.num_subnetworks} subnetworks)")
    if f > _TRAIN_MAX_C or cfg.out_channels > _TRAIN_MAX_OC:
        raise ValueError(f"the 1x1 out-conv kernels take at most {_TRAIN_MAX_C} "
                         f"input and {_TRAIN_MAX_OC} output channels, this "
                         f"configuration needs {f} and {cfg.out_channels}")


def check_eval_plans(cfg: MimoUNetConfig) -> None:
    """Plan the fused DoubleConv kernel (K1/K2) at each site of the eval
    route: in_conv C_in -> F -> F, down1 F -> 2F -> 2F, up3 (2FS + 2FS) ->
    2FS -> 2FS/2 and the decoder (F + C_up) -> mid -> F.  Raises, naming
    the shared-memory limit, where a site's channel counts fit no plan (a
    configuration that routes to the kernels runs on them or fails, it
    never falls back); BASELINE 5a and 5b fit."""
    f, fs = cfg.filter_base_count, cfg.filter_base_count * cfg.num_subnetworks
    c_up = 2 * fs // cfg.factor
    for c1, c2, m, o in ((cfg.in_channels, 0, f, f), (f, 0, 2 * f, 2 * f),
                         (2 * fs, 2 * fs, 2 * fs, 2 * fs // cfg.factor),
                         (f, c_up, (f + c_up) // 2, f)):
        plan_of(c1, c2, m, o)


def x2_half_route() -> bool:
    """Whether the train decoder takes the x2-half route: the environment
    variable MIMO_CT_TRAIN_X2_HALF set to anything but "0", read per call
    (the JAX package reads it as it traces, fast_path.py:1282).  Off by
    default, as there."""
    return os.environ.get("MIMO_CT_TRAIN_X2_HALF", "0") != "0"


def fast_path_supported(cfg: MimoUNetConfig, x_shape: Tuple[int, ...],
                        device: torch.device, *, training: bool,
                        mc_dropout: bool = False) -> bool:
    """True when the kernel path applies.  Routes on configuration as
    ``ct_fast_path_supported`` does: "off" never, "auto" for CUDA inputs,
    "force" on any device (on the CPU every kernel wrapper runs its plain
    version).  Gates on what the kernels need: eval, bf16, bilinear, and
    H, W multiples of 16 (four pool levels, no pad-to-match).  Every
    MC-dropout site is supported; at the up4 or final site a channel count
    beyond the grouped 1x1 kernel raises (``check_channels``), and so does
    a site whose channels fit no plan of the fused DoubleConv kernel
    (``check_eval_plans``).  Nothing here catches a kernel failure: a CUDA
    launch that fails raises.
    """
    if cfg.ct_kernels == "off":
        return False
    if cfg.ct_kernels == "auto" and torch.device(device).type != "cuda":
        return False
    if training:
        return False
    if cfg.compute_dtype != "bfloat16" or cfg.mode != "bilinear":
        return False
    if len(x_shape) != 5:
        return False
    h, w = x_shape[2], x_shape[3]
    if not (h >= 16 and w >= 16 and h % 16 == 0 and w % 16 == 0):
        return False
    if mc_dropout and (cfg.decoder_dropout_rate > 0 or cfg.final_dropout_rate > 0):
        check_channels(cfg, convs=False)
    check_eval_plans(cfg)
    return True


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


def _site_scale(drops: Drops, names: Sequence[str], dim: int = 0):
    """The Dropout2d masks of ``names`` joined on ``dim`` (0: the S-major
    image fold; 1: the subnetwork channel blocks) as f32 scales, or None
    where the sites are not live."""
    if names[0] not in drops:
        return None
    return keep_scale([drops[k][0] for k in names], drops[names[0]][1], dim)


@torch.no_grad()
def mimo_unet_apply_fast(model, x: torch.Tensor,
                         drops: Drops = NO_DROPOUT) -> torch.Tensor:
    """Eval forward through the kernels: [B, S, H, W, C_in] ->
    [B, S, H, W, C_out] float32 (``mimo_unet_apply_ct``), with the live
    MC-dropout sites of ``drops``."""
    b, s, h, w, cin = x.shape
    n = s * b
    enc, core, dec = model.encoder, model.core, model.decoder
    bf16 = torch.bfloat16

    # ---- encoder in_conv: S-major fold, emits the H half of down1's pool
    xin = x.to(bf16).transpose(0, 1).reshape(n, h, w, cin).contiguous()
    conv_in = fused_double_conv9 if cin <= 8 else fused_double_conv
    x1s, hp1 = conv_in(xin, *double_conv_args(enc.in_convs), emit_hpool=True)
    sc = _site_scale(drops, [f"encoder.{i}.in_conv" for i in range(s)])
    if sc is not None:
        x1s, hp1 = scale_channels(x1s, sc), scale_channels(hp1, sc)

    # ---- down1: writes the subnetwork channel concat [B, H/2, W/2, 2FS]
    # and the H half of the core's down2 pool
    x2cat, hp2 = fused_double_conv(
        pool_w(hp1), *double_conv_args([d.conv for d in enc.down1s]),
        emit_hpool=True, group_rows_out=True)
    sc = _site_scale(drops, [f"encoder.{i}.down1" for i in range(s)], dim=1)
    if sc is not None:
        x2cat, hp2 = scale_channels(x2cat, sc), scale_channels(hp2, sc)

    # ---- shared core, down2 .. up2 (plain modules on an NCHW view of the
    # channels-last tensor)
    xu2 = core.mid(pool_w(hp2).permute(0, 3, 1, 2), drops)
    xu2 = xu2.permute(0, 2, 3, 1).contiguous()

    # ---- up3: skip x2cat + upsampled up2 output (W half here, H in-kernel)
    xup = fused_double_conv(
        x2cat, *double_conv_args([core.up3.conv]),
        x2=upsample_w2x(xu2), x2_half_h=True)
    sc = _site_scale(drops, ["core.up3"])
    if sc is not None:
        xup = scale_channels(xup, sc)

    # ---- decoder up4 + out-conv per subnetwork; the upsampled core output
    # (period B) is shared by the S subnetworks
    wo = torch.stack([oc.conv.weight[:, :, 0, 0].t() for oc in dec.outcs])
    bo = torch.stack([oc.conv.bias for oc in dec.outcs])
    up4_args = double_conv_args([u.conv for u in dec.up4s])
    xupw = upsample_w2x(xup)
    sc = _site_scale(drops, [f"decoder.{i}.up4" for i in range(s)])
    finals = [f"decoder.{i}.final" for i in range(s)]
    if sc is None and finals[0] not in drops:
        logits = fused_double_conv(x1s, *up4_args, x2=xupw, x2_half_h=True,
                                   wo=wo, bo=bo)
    else:
        y = fused_double_conv(x1s, *up4_args, x2=xupw, x2_half_h=True)
        if sc is not None:
            y = scale_channels(y, sc)
        else:
            y = dropout(y, torch.cat([drops[k][0] for k in finals]),
                        drops[finals[0]][1])
        logits = conv1x1(y, wo, bo)
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
    H and W multiples of 16, and ``remat == "none"`` (not ported yet).
    Every dropout site is supported.  The TPU's lane conditions are not:
    256x256 patches, 640x480 frames and any other such shape take the same
    route (the kernels tile any pixel count), and on it a kernel that
    cannot take its shape raises; so does a configuration whose channel
    counts the kernels cannot take (``check_channels``)."""
    if cfg.ct_kernels == "off" or not training or mc_dropout:
        return False
    if cfg.ct_kernels == "auto" and torch.device(device).type != "cuda":
        return False
    if cfg.compute_dtype != "bfloat16" or cfg.mode != "bilinear":
        return False
    if cfg.remat != "none":
        return False
    if len(x_shape) != 5:
        return False
    h, w = x_shape[2], x_shape[3]
    if not (h >= 16 and w >= 16 and h % 16 == 0 and w % 16 == 0):
        return False
    check_channels(cfg)
    return True


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


def _conv_bn(x1, dcs, idx, count, *, x2=None, prologue=None, x2_half_h=False):
    """One train conv (position ``idx`` = 0 or 1 of each group's
    DoubleConv) and its BatchNorm: returns (y_raw, scale, shift)."""
    convs = [dc.double_conv[3 * idx] for dc in dcs]
    bns = [dc.double_conv[3 * idx + 1] for dc in dcs]
    sc, sh = prologue if prologue is not None else (None, None)
    y, s, q = Conv3x3Train.apply(x1, x2, _w_train(convs), sc, sh, x2_half_h)
    scale, shift = _bn_affine_from_stats(s, q, count, convs, bns)
    return y, scale, shift


def _per_image_affine(sc: torch.Tensor, sh: torch.Tensor, m: torch.Tensor):
    """Fold Dropout2d scales m [S*B, C] (0 or 1/keep) into the per-group
    BN affine sc/sh [S, C] (``_per_image_affine``, fast_path.py:1069-1079):
    with m >= 0, ``relu(y*sc + sh) * m == relu(y*(sc*m) + sh*m)``.  Returns
    per-image [S*B, C]; the gradients of sc and sh sum over the images."""
    return _expand_groups(sc, m.shape[0]) * m, _expand_groups(sh, m.shape[0]) * m


def _expand_groups(t: torch.Tensor, n: int) -> torch.Tensor:
    """[G, ...] per-group values -> [N, ...], image n taking group
    n // (N / G), differentiable (an expand, so gradients sum over each
    group's images)."""
    g = t.shape[0]
    return t[:, None].expand(g, n // g, *t.shape[1:]).reshape(n, *t.shape[1:])


def _group_concat(t: torch.Tensor, s: int) -> torch.Tensor:
    """[S*B, H, W, C] S-major -> the subnetwork channel concat [B, S*C, H,
    W] as an NCHW view of a channels-last tensor."""
    n, h, w, c = t.shape
    t = t.view(s, n // s, h, w, c).permute(1, 2, 3, 0, 4)
    return t.reshape(n // s, h, w, s * c).permute(0, 3, 1, 2)


def encoder_train(enc, xin: torch.Tensor, b: int, drops: Drops = NO_DROPOUT):
    """in_conv and down1 on the kernels (``_enc_train_local(bpool=True)``,
    mimo_unet_tpu/models/fast_path.py:1082-1214) for the S-major image
    fold ``xin`` [S*B, H, W, C_in] bf16 of a batch of B: returns x1s
    [S*B, H, W, F] (the decoder's skip) and down1's output pooled and
    whole, x2p [S*B, H/4, W/4, 2F] and x2s [S*B, H/2, W/2, 2F]."""
    n, h, w, _ = xin.shape
    s = n // b
    # per group: the whole batch normalizes each group
    cnt_full, cnt_half = b * h * w, b * (h // 2) * (w // 2)
    y1, sc1, sh1 = _conv_bn(xin, enc.in_convs, 0, cnt_full)
    y2, sc2, sh2 = _conv_bn(y1, enc.in_convs, 1, cnt_full, prologue=(sc1, sh1))
    m = _site_scale(drops, [f"encoder.{i}.in_conv" for i in range(s)])
    if m is not None:
        sc2, sh2 = _per_image_affine(sc2, sh2, m)
    x1s = AffineRelu.apply(y2, sc2, sh2)
    # the decoder reads the pool's identity output: the skip's cotangent
    # joins the pool's in one backward pass
    pooled, x1s = MaxPool2x2Skip.apply(x1s)  # [n, h/2, w/2, F]; [n, h, w, F]

    # down1, BatchNorm over each group's half-res pixels
    d1 = [d.conv for d in enc.down1s]
    y3, sc3, sh3 = _conv_bn(pooled, d1, 0, cnt_half)
    y4, sc4, sh4 = _conv_bn(y3, d1, 1, cnt_half, prologue=(sc3, sh3))
    m = _site_scale(drops, [f"encoder.{i}.down1" for i in range(s)])
    if m is not None:
        sc4, sh4 = _per_image_affine(sc4, sh4, m)
    x2p, x2s = MaxPool2x2Skip.apply(AffineRelu.apply(y4, sc4, sh4))
    return x1s, x2p, x2s


def mimo_unet_apply_train(model, x: torch.Tensor,
                          drops: Drops = NO_DROPOUT) -> torch.Tensor:
    """Train forward through the kernels (``mimo_unet_apply_ct_train``):
    [B, S, H, W, C_in] -> [B, S, H, W, C_out] float32 logits, with the
    live dropout sites of ``drops``; every BatchNorm's running statistics
    update in place."""
    b, s, h, w, cin = x.shape
    n = s * b
    enc, core, dec = model.encoder, model.core, model.decoder
    cnt_full = b * h * w  # per group: the whole batch normalizes each group

    # ---- encoder (kernels), S-major fold
    xin = x.to(torch.bfloat16).transpose(0, 1).reshape(n, h, w, cin).contiguous()
    x1s, x2p, x2s = encoder_train(enc, xin, b, drops)

    # ---- shared core (plain modules, train mode) on the subnetwork
    # channel concat, channels-last under an NCHW view: the identity is
    # up3's skip, the pooled tensor down2's input
    x_up = core(_group_concat(x2s, s), drops, x2_pooled=_group_concat(x2p, s))

    # ---- decoder: x2 upsample to channels-last (period B: image n reads
    # upsampled image n % B), two kernel convs, the out-conv.  The x2-half
    # route upsamples only W here, at half height; conv1's kernels lerp
    # the rows
    x_up = x_up.permute(0, 2, 3, 1).contiguous()
    half = x2_half_route()
    up = UpsampleW2x.apply(x_up) if half else Upsample2x.apply(x_up)
    up4 = [u.conv for u in dec.up4s]
    y5, sc5, sh5 = _conv_bn(x1s, up4, 0, cnt_full, x2=up, x2_half_h=half)
    y6, sc6, sh6 = _conv_bn(y5, up4, 1, cnt_full, prologue=(sc5, sh5))
    wo = torch.stack([oc.conv.weight[:, :, 0, 0].t() for oc in dec.outcs])
    bo = torch.stack([oc.conv.bias for oc in dec.outcs])
    m = _site_scale(drops, [f"decoder.{i}.up4" for i in range(s)])
    finals = [f"decoder.{i}.final" for i in range(s)]
    if m is not None:
        # up4's Dropout2d folds into per-image bn2 parameters; the out-conv
        # runs with groups = N on per-image copies of wo and bo
        sc6, sh6 = _per_image_affine(sc6, sh6, m)
        logits = Conv1x1Prelu.apply(y6, sc6, sh6, _expand_groups(wo, n),
                                    _expand_groups(bo, n))
    elif finals[0] in drops:
        # the elementwise final dropout sits between the ReLU and the 1x1
        z6 = AffineRelu.apply(y6, sc6, sh6)
        z6 = dropout(z6, torch.cat([drops[k][0] for k in finals]),
                     drops[finals[0]][1])
        logits = Conv1x1.apply(z6, wo, bo)
    else:
        logits = Conv1x1Prelu.apply(y6, sc6, sh6, wo, bo)
    return logits.view(s, b, h, w, -1).transpose(0, 1).float()
