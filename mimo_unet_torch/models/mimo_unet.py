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
modules below; an eval forward that autograd must see through (grad
enabled, and the input or a parameter requiring it) runs the plain
modules, the eval kernels carrying no gradient.  In train mode BatchNorm normalizes with batch statistics
and updates its running statistics in place (the JAX package returns them
as new state).  Dropout is live in train mode and under ``mc_dropout``
(BatchNorm then stays in eval mode); its masks come from an explicit
``DropoutSource`` (``ops/dropout.py``), drawn for every live site of
``dropout_sites`` before the forward routes.

``remat`` ("none", "enc", "all"; train mode only) recomputes sections of
the forward in the backward instead of keeping what they save, as the JAX
package's ``jax.checkpoint`` wrapping does (mimo_unet_tpu/models/
mimo_unet.py:237, :255, :281): "enc" the encoder, "all" also the core and
the decoder, on both train routes (``run_section``).  The sections draw no
randomness (the dropout masks enter as inputs), so the recompute replays
the forward bit for bit, and it leaves the BatchNorm running statistics
as the forward left them: they move once a step at every rung.

The up mode (``bilinear``, ``use_pooling_indices``) picks the decoder:
bilinear (the tasks' and the kernel routes'), transpose
(``bilinear=False``: ConvTranspose2d upsampling, ``factor`` 1 widens
down4 and up1-up3) or unpool (``use_pooling_indices``: every Down keeps
its pool's indices and the Up of its level unpools with them).  The
non-bilinear modes run the plain modules, with the JAX package's
corrected decoder channel math (mimo_unet_tpu/models/mimo_unet.py:88-106;
the reference's own wiring crashes, docs/MIGRATION.md:62-76).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mimo_unet_torch.models.blocks import DoubleConv, Down, OutConv, Up, init_conv_
from mimo_unet_torch.ops import max_pool_2x2_skip
from mimo_unet_torch.ops.dropout import (
    NO_DROPOUT,
    DropoutSource,
    Drops,
    dropout as apply_dropout,
    shard_rows,
)
from mimo_unet_torch.parallel.mesh import (
    check_spatial_height,
    current_ct_mesh,
    spatial_count,
    spatial_mesh,
)

CT_KERNEL_MODES = ("auto", "off", "force")
REMAT_MODES = ("none", "enc", "all")


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
    # train-time rematerialization: "enc" recomputes the encoder in the
    # backward, "all" also the core and the decoder (train/capacity.py)
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
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, "
                             f"got {self.remat!r}")
        up_mode(self.bilinear, self.use_pooling_indices)  # raises if both

    @property
    def factor(self) -> int:
        return 2 if (self.bilinear or self.use_pooling_indices) else 1

    @property
    def mode(self) -> str:
        return up_mode(self.bilinear, self.use_pooling_indices)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


@contextlib.contextmanager
def _buffers_kept(modules: Sequence[nn.Module]):
    """Inside the block the modules' buffers may change; on leaving it they
    hold again, bit for bit, what they held on entering it."""
    kept = [(b, b.clone()) for m in modules for b in m.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in kept:
                b.copy_(v)


def run_section(fn: Callable, modules: Sequence[nn.Module], *args,
                remat: bool):
    """``fn(*args)``; with ``remat`` under ``torch.utils.checkpoint``
    (non-reentrant): the backward recomputes ``fn`` instead of keeping the
    tensors it saves.  ``fn`` draws nothing random (the RNG state is not
    kept), and its recompute leaves the buffers of ``modules`` (the
    BatchNorm running statistics and ``num_batches_tracked`` the forward
    updated) as the forward left them."""
    if not remat:
        return fn(*args)
    return checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _buffers_kept(modules)))


def dropout_sites(cfg: MimoUNetConfig, b: int, h: int, w: int
                  ) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Every dropout site with a nonzero rate in one forward of a
    [b, S, h, w, C] input: name -> (keep-mask shape, rate), in the order of
    the JAX package's key tree (mimo_unet_tpu/models/mimo_unet.py:218,
    ``split(rng, 3)`` into encoder, core and decoder keys).  Per
    subnetwork i the encoder splits into (in_conv, down1) (:222-241) and
    the decoder into (up4, final) (:260-277); the core's seven keys
    (:314) go to down2, down3, down4, center, up1, up2, up3.  Dropout2d
    masks are [b, C]; the elementwise center and final masks are
    channels-last [b, H, W, C]."""
    f, s, fac = cfg.filter_base_count, cfg.num_subnetworks, cfg.factor
    fs = f * s
    sites = {}

    def add(name, shape, rate):
        if rate > 0:
            sites[name] = (shape, rate)

    for i in range(s):
        add(f"encoder.{i}.in_conv", (b, f), cfg.encoder_dropout_rate)
        add(f"encoder.{i}.down1", (b, 2 * f), cfg.encoder_dropout_rate)
    rate = cfg.core_dropout_rate
    add("core.down2", (b, 4 * fs), rate)
    add("core.down3", (b, 8 * fs), rate)
    add("core.down4", (b, 16 * fs // fac), rate)
    add("core.center", (b, h // 16, w // 16, 16 * fs // fac),
        cfg.center_dropout_rate)
    add("core.up1", (b, 8 * fs // fac), rate)
    add("core.up2", (b, 4 * fs // fac), rate)
    add("core.up3", (b, 2 * fs // fac), rate)
    for i in range(s):
        add(f"decoder.{i}.up4", (b, f), cfg.decoder_dropout_rate)
        add(f"decoder.{i}.final", (b, h, w, f), cfg.final_dropout_rate)
    return sites


@contextlib.contextmanager
def eval_mode(model: nn.Module):
    """``model`` in eval mode inside the block, then back in the mode it
    was in.  Validation and serving run so whatever mode the caller left
    the model in: BatchNorm normalizes by the running statistics and
    leaves them unchanged, and dropout is live only through
    ``mc_dropout`` (the JAX package passes ``train=False`` there)."""
    was = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was)


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
        self.down1s = nn.ModuleList(Down(f, 2 * f, cfg.use_pooling_indices)
                                    for _ in range(s))


class Core(nn.Module):
    """Shared core, down2 .. up3 (reference model.py:178-243)."""

    def __init__(self, cfg: MimoUNetConfig):
        super().__init__()
        fs, factor = cfg.filter_base_count * cfg.num_subnetworks, cfg.factor
        mode, ind = cfg.mode, cfg.use_pooling_indices
        self.down2 = Down(2 * fs, 4 * fs, ind)
        self.down3 = Down(4 * fs, 8 * fs, ind)
        self.down4 = Down(8 * fs, 16 * fs // factor, ind)
        self.up1 = Up(16 * fs, 8 * fs // factor, mode)
        self.up2 = Up(8 * fs, 4 * fs // factor, mode)
        self.up3 = Up(4 * fs, 2 * fs // factor, mode)
        self.use_pooling_indices = ind

    def mid(self, pooled: torch.Tensor, drops: Drops = NO_DROPOUT
            ) -> torch.Tensor:
        """down2 (its pool already applied to ``pooled``) .. up2, with the
        live dropout sites of ``drops``.  Each Down input that also feeds
        an Up skip is pooled through ``max_pool_2x2_skip`` and the skip
        reads its identity output, as ``core_apply`` routes them
        (mimo_unet_tpu/models/mimo_unet.py:293-373): the two cotangents
        meet inside the pool backward.  (Not in the unpool mode, whose
        Downs pool with indices.)"""
        x3 = self.down2.conv(pooled, drops.get("core.down2"))
        p3, x3 = max_pool_2x2_skip(x3)
        x4 = self.down3(p3, pre_pooled=True, drop=drops.get("core.down3"))
        p4, x4 = max_pool_2x2_skip(x4)
        x5 = self.down4(p4, pre_pooled=True, drop=drops.get("core.down4"))
        x5 = _center_dropout(x5, drops)
        x_up = self.up1(x5, x4, drops.get("core.up1"))
        return self.up2(x_up, x3, drops.get("core.up2"))

    def forward(self, x2_concat: torch.Tensor, drops: Drops = NO_DROPOUT,
                x2_pooled: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x2_pooled``: down2's input already pooled by the caller (the
        train kernel route pools the core boundary with K10, the up3 skip
        cotangent fused into its backward); ``x2_concat`` is then only
        up3's skip (``core_apply(x2_pooled=)``,
        mimo_unet_tpu/models/mimo_unet.py:292-325)."""
        if self.use_pooling_indices:
            return self._forward_unpool(x2_concat, drops)
        if x2_pooled is None:
            x2_pooled, x2_concat = max_pool_2x2_skip(x2_concat)
        return self.up3(self.mid(x2_pooled, drops), x2_concat,
                        drops.get("core.up3"))

    def _forward_unpool(self, x2: torch.Tensor, drops: Drops) -> torch.Tensor:
        """The unpool core: each Down pools with indices and the Up at its
        level unpools with them (``core_apply`` with ``fuse_skip`` off,
        mimo_unet_tpu/models/mimo_unet.py:321-373)."""
        x3, ind3 = self.down2(x2, drop=drops.get("core.down2"))
        x4, ind4 = self.down3(x3, drop=drops.get("core.down3"))
        x5, ind5 = self.down4(x4, drop=drops.get("core.down4"))
        x5 = _center_dropout(x5, drops)
        x_up = self.up1(x5, x4, drops.get("core.up1"), ind5)
        x_up = self.up2(x_up, x3, drops.get("core.up2"), ind4)
        return self.up3(x_up, x2, drops.get("core.up3"), ind3)


def _center_dropout(x5: torch.Tensor, drops: Drops) -> torch.Tensor:
    """The elementwise center site (reference model.py:210), if live."""
    if "core.center" not in drops:
        return x5
    mask, keep = drops["core.center"]
    return apply_dropout(x5, mask.permute(0, 3, 1, 2), keep)


class Decoder(nn.Module):
    def __init__(self, cfg: MimoUNetConfig):
        super().__init__()
        f, s = cfg.filter_base_count, cfg.num_subnetworks
        fs = f * s
        if cfg.mode == "transpose":
            # corrected math: the transpose halves the core's 2FS output
            # to FS before the skip concat (mimo_unet_tpu/models/
            # mimo_unet.py:150-158; docs/MIGRATION.md:62-76)
            ups = (Up(fs + f, f, "transpose", x1_channels=2 * fs)
                   for _ in range(s))
        else:
            ups = (Up(2 * fs // cfg.factor + f, f, cfg.mode) for _ in range(s))
        self.up4s = nn.ModuleList(ups)
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
        self.config = cfg
        with torch.device("meta"):
            self.encoder = Encoder(cfg)
            self.core = Core(cfg)
            self.decoder = Decoder(cfg)
        self.to_empty(device="cpu")
        for module in self.modules():  # registration order: deterministic
            if isinstance(module, (DoubleConv, OutConv)):
                module.reset_parameters(generator)
            elif isinstance(module, nn.ConvTranspose2d):
                init_conv_(module, generator)
        self.to(device)

    def forward(self, x: torch.Tensor, *, mc_dropout: bool = False,
                dropout: Optional[DropoutSource] = None) -> torch.Tensor:
        """[B, S, H, W, C_in] -> [B, S, H, W, C_out] float32.

        Dropout is live in train mode and, in eval mode, with
        ``mc_dropout`` (BatchNorm stays in eval mode, as in the
        reference's MC dropout); ``dropout`` then gives the masks and is
        required when a site has a nonzero rate (``mimo_unet_apply``,
        mimo_unet_tpu/models/mimo_unet.py:201).

        Under a spatial mesh (the active ``ct_mesh_scope`` a ``Mesh2D``)
        ``x`` holds this rank's batch rows and height rows, and so does
        the output: the plain modules exchange halo rows with the spatial
        peers and the kernel routes stand aside (``fast_path``); the
        global height (the local one times ``spatial``) must be a
        multiple of 16 x ``spatial``; the dropout sites are drawn at the
        global height and each elementwise mask cut to this rank's rows,
        so spatial peers apply the same masks."""
        from mimo_unet_torch.models.fast_path import (
            fast_path_supported, mimo_unet_apply_fast,
            mimo_unet_apply_train, train_path_supported)

        cfg = self.config
        if x.ndim != 5 or x.shape[1] != cfg.num_subnetworks:
            raise ValueError("expected [B, S, H, W, C] with S == "
                             f"{cfg.num_subnetworks}, got {tuple(x.shape)}")
        if x.shape[-1] != cfg.in_channels:
            raise ValueError(f"channel dim must be {cfg.in_channels}")
        mesh = current_ct_mesh()
        split = spatial_mesh(mesh)
        h = x.shape[2] * spatial_count(mesh)  # the global height
        check_spatial_height(h, mesh)
        drops = NO_DROPOUT
        if self.training or mc_dropout:
            sites = dropout_sites(cfg, x.shape[0], h, x.shape[3])
            if sites and dropout is None:
                raise ValueError("a DropoutSource is required when dropout "
                                 "is live")
            if sites:
                drops = dropout.draw(sites, x.device)
                if split is not None:
                    drops = shard_rows(drops, split.rank, split.size)
        if self.training:
            if train_path_supported(cfg, x.shape, x.device, training=True):
                return mimo_unet_apply_train(self, x, drops)
        elif (fast_path_supported(cfg, x.shape, x.device, training=False,
                                  mc_dropout=mc_dropout)
              and not self._needs_input_or_param_grad(x)):
            return mimo_unet_apply_fast(self, x, drops)
        return self.forward_plain(x, drops)

    def _needs_input_or_param_grad(self, x: torch.Tensor) -> bool:
        """An eval forward that autograd must see through: the eval
        kernels carry no gradient, so such a forward (an input gradient
        for FGSM, say) runs the plain modules, as the JAX package traces
        it outside its kernels (``ct_disabled``,
        mimo_unet_tpu/models/fast_path.py:55-75).  ``predict`` and
        ``val_step`` run under ``torch.no_grad`` and keep the kernels."""
        return torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))

    def forward_plain(self, x: torch.Tensor, drops: Drops = NO_DROPOUT
                      ) -> torch.Tensor:
        """The plain modules, one subnetwork at a time (reference
        model.py:167-173, :292-295), in the modules' mode, with the live
        dropout sites of ``drops``: in train mode each subnetwork's
        BatchNorms see that subnetwork's batch.  In train mode ``remat``
        recomputes each subnetwork's in_conv + down1 ("enc", "all"), the
        core and each subnetwork's up4 + out-conv ("all") in the backward
        (``encoder_one``, ``core_fn`` and ``decoder_one`` of
        mimo_unet_tpu/models/mimo_unet.py:222-281)."""
        remat = self.config.remat if self.training else "none"
        enc_remat, all_remat = remat in ("enc", "all"), remat == "all"
        x = x.to(self.config.torch_dtype)
        x1s, x2s, ind2s = [], [], []
        for i, (in_conv, down1) in enumerate(
                zip(self.encoder.in_convs, self.encoder.down1s)):
            def encoder_one(xi, i=i, in_conv=in_conv, down1=down1):
                x1 = in_conv(xi.permute(0, 3, 1, 2),
                             drops.get(f"encoder.{i}.in_conv"))
                x2 = down1(x1, drop=drops.get(f"encoder.{i}.down1"))
                # the unpool mode's Down also returns its indices
                return (x1, *x2) if down1.use_pooling_indices else (x1, x2, None)

            x1, x2, ind2 = run_section(encoder_one, (in_conv, down1), x[:, i],
                                       remat=enc_remat)
            x1s.append(x1)
            x2s.append(x2)
            ind2s.append(ind2)
        # subnetwork-major channel concat (reference model.py:113)
        x_up = run_section(lambda xc: self.core(xc, drops), (self.core,),
                           torch.cat(x2s, dim=1), remat=all_remat)
        logits = []
        for i, (up4, outc, x1, ind2) in enumerate(
                zip(self.decoder.up4s, self.decoder.outcs, x1s, ind2s)):
            if ind2 is not None:
                # corrected math: this subnetwork's down1 indices (F
                # channels) unpool every S-group of the core's FS-channel
                # output (jnp.tile, mimo_unet_tpu/models/mimo_unet.py:258-266)
                ind2 = ind2.repeat(1, x_up.shape[1] // ind2.shape[1], 1, 1)

            def decoder_one(xu, x1, ind2, i=i, up4=up4, outc=outc):
                y = up4(xu, x1, drops.get(f"decoder.{i}.up4"), ind2)
                if f"decoder.{i}.final" in drops:
                    mask, keep = drops[f"decoder.{i}.final"]
                    y = apply_dropout(y, mask.permute(0, 3, 1, 2), keep)
                return outc(y)

            logits.append(run_section(decoder_one, (up4, outc), x_up, x1,
                                      ind2, remat=all_remat))
        # [B, S, C, H, W] -> [B, S, H, W, C]; the loss boundary is float32
        return torch.stack(logits, dim=1).permute(0, 1, 3, 4, 2).float()

