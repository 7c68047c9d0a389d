"""MIMO U-Net: per-subnetwork encoders and decoders around a shared core.

Counterpart of ``mimo_unet_tpu/models/mimo_unet.py`` (reference:
mimo/models/mimo_components/model.py:26-297).  Where the JAX package stacks
the per-subnetwork parameters on a leading ``[S]`` axis under ``jax.vmap``,
this module keeps the reference's ``nn.ModuleList``s, so its state-dict keys
are the reference's (``encoder.in_convs.{i}``, ``encoder.down1s.{i}.conv``,
``core.down2.conv``, ``core.up1``, ``decoder.up4s.{i}``,
``decoder.outcs.{i}.conv``) and ``mimo_unet_tpu/interop.py`` reads them.

Input and output are channels-last with the MIMO axis at position 1, as in
``mimo_unet_apply``: x [B, S, H, W, C_in] -> out [B, S, H, W, C_out] f32.

``MimoUNet.forward`` routes on configuration the way ``mimo_unet_apply``
does: eligible inputs take a kernel path of ``models/fast_path.py`` (the
eval one, or in train mode the train one), everything else the plain
modules below.  In train mode BatchNorm normalizes with batch statistics
and updates its running statistics in place (the JAX package returns them
as new state).  Dropout and ``remat`` are not ported yet: a train forward
that would need them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from mimo_unet_torch.models.blocks import DoubleConv, Down, OutConv, Up
from mimo_unet_torch.ops import max_pool_2x2_skip

CT_KERNEL_MODES = ("auto", "off", "force")


def up_mode(bilinear: bool, use_pooling_indices: bool) -> str:
    if bilinear and use_pooling_indices:
        raise ValueError(
            "Do not specify use_pooling_indices and bilinear together!")
    if bilinear:
        return "bilinear"
    return "unpool" if use_pooling_indices else "transpose"


@dataclasses.dataclass(frozen=True)
class MimoUNetConfig:
    in_channels: int
    out_channels: int
    num_subnetworks: int
    filter_base_count: int = 30
    center_dropout_rate: float = 0.0
    final_dropout_rate: float = 0.0
    encoder_dropout_rate: float = 0.0
    core_dropout_rate: float = 0.0
    decoder_dropout_rate: float = 0.0
    bilinear: bool = True
    use_pooling_indices: bool = False
    # None -> float32 compute; "bfloat16" -> bf16 activations, f32 master
    # weights and f32 accumulation
    compute_dtype: Optional[str] = None
    # kernel path (models/fast_path.py): "auto" takes it for eligible CUDA
    # inputs, "off" never, "force" also on the CPU with each kernel's plain
    # PyTorch version (tests)
    ct_kernels: str = "auto"
    # train-time rematerialization ladder of the JAX package; kept so the
    # two configs carry the same fields (only "none" is ported)
    remat: str = "none"

    def __post_init__(self):
        spatial = (self.encoder_dropout_rate > 0.0
                   or self.core_dropout_rate > 0.0
                   or self.decoder_dropout_rate > 0.0)
        legacy = self.center_dropout_rate > 0.0 or self.final_dropout_rate > 0.0
        if spatial and legacy:
            raise ValueError(
                "Do not specify spatial_dropout together with "
                "center_dropout_rate or final_dropout_rate!")
        if self.ct_kernels not in CT_KERNEL_MODES:
            raise ValueError(f"ct_kernels must be one of {CT_KERNEL_MODES}, "
                             f"got {self.ct_kernels!r}")

    @property
    def factor(self) -> int:
        return 2 if (self.bilinear or self.use_pooling_indices) else 1

    @property
    def mode(self) -> str:
        return up_mode(self.bilinear, self.use_pooling_indices)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    def check_train_ported(self) -> None:
        """Raise for what the train forward does not port yet."""
        rates = {k: getattr(self, k) for k in (
            "center_dropout_rate", "final_dropout_rate",
            "encoder_dropout_rate", "core_dropout_rate",
            "decoder_dropout_rate")}
        live = [k for k, v in rates.items() if v > 0]
        if live:
            raise NotImplementedError(
                f"train-mode dropout is not ported yet: {live}")
        if self.remat != "none":
            raise NotImplementedError(
                f"remat={self.remat!r} is not ported yet (only 'none')")


def resolve_device(device) -> torch.device:
    """``None`` means the card: the port's entry points run on CUDA unless
    the caller asks for the CPU, and raise where there is no card."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


class Encoder(nn.Module):
    def __init__(self, cfg: MimoUNetConfig):
        super().__init__()
        f, s = cfg.filter_base_count, cfg.num_subnetworks
        self.in_convs = nn.ModuleList(
            DoubleConv(cfg.in_channels, f) for _ in range(s))
        self.down1s = nn.ModuleList(Down(f, 2 * f) for _ in range(s))


class Core(nn.Module):
    """Shared core, down2 .. up3 (reference model.py:178-243)."""

    def __init__(self, cfg: MimoUNetConfig):
        super().__init__()
        fs, factor = cfg.filter_base_count * cfg.num_subnetworks, cfg.factor
        self.down2 = Down(2 * fs, 4 * fs)
        self.down3 = Down(4 * fs, 8 * fs)
        self.down4 = Down(8 * fs, 16 * fs // factor)
        self.up1 = Up(16 * fs, 8 * fs // factor)
        self.up2 = Up(8 * fs, 4 * fs // factor)
        self.up3 = Up(4 * fs, 2 * fs // factor)

    def mid(self, pooled: torch.Tensor) -> torch.Tensor:
        """down2 (its pool already applied to ``pooled``) .. up2.  Each
        Down input that also feeds an Up skip is pooled through
        ``max_pool_2x2_skip`` and the skip reads its identity output, as
        ``core_apply`` routes them (mimo_unet_tpu/models/mimo_unet.py:
        293-373): the two cotangents meet inside the pool backward."""
        x3 = self.down2.conv(pooled)
        p3, x3 = max_pool_2x2_skip(x3)
        x4 = self.down3(p3, pre_pooled=True)
        p4, x4 = max_pool_2x2_skip(x4)
        x5 = self.down4(p4, pre_pooled=True)
        return self.up2(self.up1(x5, x4), x3)

    def forward(self, x2_concat: torch.Tensor) -> torch.Tensor:
        pooled, x2_concat = max_pool_2x2_skip(x2_concat)
        return self.up3(self.mid(pooled), x2_concat)


class Decoder(nn.Module):
    def __init__(self, cfg: MimoUNetConfig):
        super().__init__()
        f, s = cfg.filter_base_count, cfg.num_subnetworks
        c_up = 2 * f * s // cfg.factor
        self.up4s = nn.ModuleList(Up(c_up + f, f) for _ in range(s))
        self.outcs = nn.ModuleList(OutConv(f, cfg.out_channels)
                                   for _ in range(s))


class MimoUNet(nn.Module):
    """The plain PyTorch model.

    Weights are drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``; the global generator when None), so a seed gives
    the same weights on every device, then moved to ``device``: the card
    when None (``resolve_device``).  BatchNorm starts at torch's defaults
    (running mean 0, var 1).
    """

    def __init__(self, cfg: MimoUNetConfig, *,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if cfg.mode != "bilinear":
            raise NotImplementedError(
                f"up mode {cfg.mode!r} is not ported yet (bilinear only)")
        self.config = cfg
        with torch.device("meta"):
            self.encoder = Encoder(cfg)
            self.core = Core(cfg)
            self.decoder = Decoder(cfg)
        self.to_empty(device="cpu")
        for module in self.modules():  # registration order: deterministic
            if isinstance(module, (DoubleConv, OutConv)):
                module.reset_parameters(generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, H, W, C_in] -> [B, S, H, W, C_out] float32."""
        from mimo_unet_torch.models.fast_path import (
            fast_path_supported, mimo_unet_apply_fast,
            mimo_unet_apply_train, train_path_supported)

        cfg = self.config
        if x.ndim != 5 or x.shape[1] != cfg.num_subnetworks:
            raise ValueError("expected [B, S, H, W, C] with S == "
                             f"{cfg.num_subnetworks}, got {tuple(x.shape)}")
        if x.shape[-1] != cfg.in_channels:
            raise ValueError(f"channel dim must be {cfg.in_channels}")
        if self.training:
            cfg.check_train_ported()
            if train_path_supported(cfg, x.shape, x.device, training=True):
                return mimo_unet_apply_train(self, x)
        elif fast_path_supported(cfg, x.shape, x.device, training=False):
            return mimo_unet_apply_fast(self, x)
        return self.forward_plain(x)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain modules, one subnetwork at a time (reference
        model.py:167-173, :292-295), in the modules' mode: in train mode
        each subnetwork's BatchNorms see that subnetwork's batch."""
        x = x.to(self.config.torch_dtype)
        x1s, x2s = [], []
        for i, (in_conv, down1) in enumerate(
                zip(self.encoder.in_convs, self.encoder.down1s)):
            x1 = in_conv(x[:, i].permute(0, 3, 1, 2))
            x1s.append(x1)
            x2s.append(down1(x1))
        # subnetwork-major channel concat (reference model.py:113)
        x_up = self.core(torch.cat(x2s, dim=1))
        logits = [outc(up4(x_up, x1)) for up4, outc, x1 in
                  zip(self.decoder.up4s, self.decoder.outcs, x1s)]
        # [B, S, C, H, W] -> [B, S, H, W, C]; the loss boundary is float32
        return torch.stack(logits, dim=1).permute(0, 1, 3, 4, 2).float()

