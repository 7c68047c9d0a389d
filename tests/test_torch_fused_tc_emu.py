"""The tensor-core fused DoubleConv kernel (K1, and K2's im2col form) of
``mimo_unet_torch/csrc/fused_double_conv.cu``, compiled with g++ against a
CPU stand-in of the CUDA runtime (``tests/cuda_emu``: a fiber per
CUDA thread, ldmatrix and mma.sync by their fragment layouts, shared-memory
range checks), launched with the arguments the wrapper builds
(``kernel_args``: the host plan and the packed weights) and held against
the plain version at small shapes: K2 at C_in = 3 with hpool, down1's
grouped hpool and group_rows_out, up3's x2_half_h with a C_in wider than
one slice, the decoder with and without its out-conv, edge tiles at
H, W in {4, 6, 20}, and a block at BASELINE 5a's up3 widths.  What the
card alone can show (timing, asynchrony, the compiler) is
``chip_smoke.py``'s.

Tolerance: outputs within two bf16 ulps of the larger magnitude, plus
4e-3 of the largest output.  The kernel and the plain version sum conv1
in f32 in different orders, so a mid value may round to the neighbouring
bf16: one mid ulp (2^-8 relative) times its conv2 weight moves an output
by at most |w2| * |mid| * 2^-8, and with the weights of these tests (|w2|
<= 0.3, at most a few mids differing a pixel) that stays under 4e-3 of the
largest output; the output's own rounding adds one ulp and the two
orders of conv2's sum another.  The out-conv's logits carry the same
bound through |wo| <= 0.3.  x2_half_h is held bitwise against the
kernel's own full-res form (both stage the same bf16 slab).
"""

import pytest
import torch

from mimo_unet_torch.kernels.fused_double_conv import (
    SMEM_TWO,
    fused_double_conv_plain,
    kernel_args,
    lerp_h2x_plain,
    plan_of,
    plans,
)

from test_torch_conv_tc_emu import emu_library

BF = torch.bfloat16


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return emu_library(tmp_path_factory, "fused_double_conv.cu", ("mimo_fused_double_conv",))


def _bf(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(BF)


def _dc(gen, g, cin, m, o):
    """Weights [G, 3, 3, C, M], [G, 3, 3, M, O] (|w| <= 0.3) and affines."""
    w1 = (torch.rand((g, 3, 3, cin, m), generator=gen) * 2 - 1) * min(0.3, 2 / (9 * cin) ** 0.5)
    w2 = (torch.rand((g, 3, 3, m, o), generator=gen) * 2 - 1) * min(0.3, 2 / (9 * m) ** 0.5)
    s1 = torch.rand((g, m), generator=gen) + 0.5
    s2 = torch.rand((g, o), generator=gen) + 0.5
    sh1 = torch.randn((g, m), generator=gen) * 0.1
    sh2 = torch.randn((g, o), generator=gen) * 0.1
    return w1, s1, sh1, w2, s2, sh2


def _run(lib, x1, dc, *, x2=None, x2h=False, wo=None, bo=None, hpool=False, gro=False,
         plan=None):
    """The kernel through the emulation, as the wrapper launches it (with
    ``plan`` where given)."""
    plan, args, (out, hp), _ = kernel_args(x1, *dc, x2, x2h, wo, bo, hpool, gro, plan)
    out.fill_(float("nan"))
    if hp is not None:
        hp.fill_(float("nan"))
    rc = lib.mimo_fused_double_conv(*args, None)
    assert rc == 0, (rc, lib.emu_fault_text().decode())
    assert lib.emu_smem_bytes() == plan.smem
    return (out, hp) if hpool else out


def _close(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        a, b = g.float(), w.float()
        assert bool(torch.isfinite(a).all()), "an output was not written"
        tol = torch.maximum(a.abs(), b.abs()) * 2.0 ** -6 + 4e-3 * float(b.abs().max())
        assert bool(((a - b).abs() <= tol).all()), float((a - b).abs().max())


# (h, w): edge tiles (4, 6: one partial tile; 20: a full and a partial tile
# each way)
EDGES = [(4, 20), (6, 4), (20, 6), (20, 20)]


@pytest.mark.parametrize("hw", EDGES)
def test_k2_im2col_hpool_emulated(lib, hw):
    """K2: C_in = 3 folded into K = 27 -> 32, two groups, the row-pair max."""
    h, w = hw
    gen = torch.Generator().manual_seed(h * 10 + w)
    x = _bf(gen, 4, h, w, 3)
    dc = _dc(gen, 2, 3, 21, 21)
    assert plan_of(3, 0, 21, 21).im2col
    _close(_run(lib, x, dc, hpool=True), fused_double_conv_plain(x, *dc, emit_hpool=True))


@pytest.mark.parametrize("hw", [(6, 20), (20, 6)])
def test_k2_two_channels_emulated(lib, hw):
    """K2 at SEN12TP's C_in = 2 (VV, VH): K = 18 -> 32, three groups of 32
    filters (S=3, fbc 32), the row-pair max."""
    h, w = hw
    gen = torch.Generator().manual_seed(200 + h * 10 + w)
    x = _bf(gen, 3, h, w, 2)
    dc = _dc(gen, 3, 2, 32, 32)
    assert plan_of(2, 0, 32, 32).im2col
    _close(_run(lib, x, dc, hpool=True), fused_double_conv_plain(x, *dc, emit_hpool=True))


@pytest.mark.parametrize("hw", EDGES)
def test_decoder_out_conv_emulated(lib, hw):
    """The decoder: x1 (5) + x2 at half height (10, period 2), the concat
    boundary inside an 8-channel group, the mid 7 -> 16, the 1x1 out-conv."""
    h, w = hw
    gen = torch.Generator().manual_seed(100 + h * 10 + w)
    x1, x2 = _bf(gen, 4, h, w, 5), _bf(gen, 2, h // 2, w, 10)
    dc = _dc(gen, 2, 15, 7, 5)
    wo = (torch.rand((2, 5, 2), generator=gen) * 2 - 1) * 0.3
    bo = torch.randn((2, 2), generator=gen) * 0.1
    _close(_run(lib, x1, dc, x2=x2, x2h=True, wo=wo, bo=bo),
           fused_double_conv_plain(x1, *dc, x2=x2, x2_half_h=True, wo=wo, bo=bo))


def test_decoder_without_out_conv_emulated(lib):
    """MC serving's decoder: no fused out-conv (flagship widths 21 + 42 ->
    31 -> 21, x2 at half height, period 2)."""
    gen = torch.Generator().manual_seed(7)
    x1, x2 = _bf(gen, 4, 6, 20, 21), _bf(gen, 2, 3, 20, 42)
    dc = _dc(gen, 2, 63, 31, 21)
    _close(_run(lib, x1, dc, x2=x2, x2h=True),
           fused_double_conv_plain(x1, *dc, x2=x2, x2_half_h=True))


def test_down1_grouped_hpool_rows_out_emulated(lib):
    """down1: two groups writing their channel blocks of [N/G, H, W, G*O],
    and the row-pair max in the same layout (flagship widths 21 -> 42)."""
    gen = torch.Generator().manual_seed(8)
    x = _bf(gen, 4, 6, 20, 21)
    dc = _dc(gen, 2, 21, 42, 42)
    _close(_run(lib, x, dc, hpool=True, gro=True),
           fused_double_conv_plain(x, *dc, emit_hpool=True, group_rows_out=True))


def test_up3_x2_half_sliced_emulated(lib):
    """up3: x1 40 + x2 40 at half height (C_in 80: two slices of conv1's
    input restaged in turn, the boundary inside a slice), mid 40 -> 20;
    bitwise its full-res form fed the lerped x2."""
    gen = torch.Generator().manual_seed(9)
    x1, x2 = _bf(gen, 2, 20, 6, 40), _bf(gen, 2, 10, 6, 40)
    dc = _dc(gen, 1, 80, 40, 20)
    assert plan_of(40, 40, 40, 20).ncs >= 2
    got = _run(lib, x1, dc, x2=x2, x2h=True)
    _close(got, fused_double_conv_plain(x1, *dc, x2=x2, x2_half_h=True))
    full = _run(lib, x1, dc, x2=lerp_h2x_plain(x2).contiguous())
    assert torch.equal(got, full)


def test_two_passes_and_mid_slices_emulated(lib):
    """A mid wider than an eight-warp grid's N (passes over conv1's K)
    and the sixteen-warp plan that takes it in one, mid slices, x2 with
    period 1 (full height)."""
    gen = torch.Generator().manual_seed(10)
    x1, x2 = _bf(gen, 2, 4, 6, 30), _bf(gen, 1, 4, 6, 50)
    dc = _dc(gen, 1, 80, 120, 100)
    two = next(p for p in plans(30, 50, 120, 100) if p.warps == 8)
    one = next(p for p in plans(30, 50, 120, 100) if p.warps == 16)
    assert two.np1 >= 2 and two.ncs2 >= 2 and one.np1 == 1
    want = fused_double_conv_plain(x1, *dc, x2=x2)
    for plan in (two, one):
        _close(_run(lib, x1, dc, x2=x2, plan=plan), want)


def test_baseline_5a_up3_block_emulated(lib):
    """One image at BASELINE 5a's up3 widths (S=3, fbc 30: 180 + 180 ->
    180 -> 90, x2 at half height), which the CUDA-core kernel refused for
    its shared memory: channel slices, two passes over conv1, mid slices."""
    gen = torch.Generator().manual_seed(11)
    x1, x2 = _bf(gen, 1, 4, 4, 180), _bf(gen, 1, 2, 4, 180)
    dc = _dc(gen, 1, 360, 180, 90)
    _close(_run(lib, x1, dc, x2=x2, x2h=True),
           fused_double_conv_plain(x1, *dc, x2=x2, x2_half_h=True))


@pytest.mark.parametrize("site", ["decoder", "down1"])
def test_every_plan_emulated(lib, site):
    """Each plan the wrapper could choose for a site (``plans``: tiles 8x16,
    16x16, 8x32, the widest slices for two blocks a multiprocessor and for
    one), the decoder's x2_half_h and out-conv and down1's grouped stores
    among them."""
    gen = torch.Generator().manual_seed(14)
    if site == "decoder":
        x1, kw = _bf(gen, 4, 6, 20, 21), dict(x2=_bf(gen, 2, 3, 20, 42), x2h=True)
        dc = _dc(gen, 2, 63, 31, 21)
        kw.update(wo=(torch.rand((2, 21, 2), generator=gen) * 2 - 1) * 0.3,
                  bo=torch.randn((2, 2), generator=gen) * 0.1)
        want = fused_double_conv_plain(x1, *dc, x2=kw["x2"], x2_half_h=True, wo=kw["wo"],
                                       bo=kw["bo"])
    else:
        x1, kw = _bf(gen, 4, 6, 20, 21), dict(hpool=True, gro=True)
        dc = _dc(gen, 2, 21, 42, 42)
        want = fused_double_conv_plain(x1, *dc, emit_hpool=True, group_rows_out=True)
    firsts = {}
    for plan in plans(21, 42 if site == "decoder" else 0, dc[0].shape[4], dc[3].shape[4]):
        firsts.setdefault((plan.smem <= SMEM_TWO, plan.th, plan.tw, plan.warps), plan)
    assert len(firsts) >= 5
    for plan in firsts.values():
        _close(_run(lib, x1, dc, plan=plan, **kw), want)


def test_launch_to_launch_bitwise_emulated(lib):
    """No atomics, fixed-order sums: a second launch gives the same bits."""
    gen = torch.Generator().manual_seed(12)
    x1, x2 = _bf(gen, 2, 6, 20, 5), _bf(gen, 1, 3, 20, 10)
    dc = _dc(gen, 2, 15, 7, 5)
    a = _run(lib, x1, dc, x2=x2, x2h=True)
    assert torch.equal(a, _run(lib, x1, dc, x2=x2, x2h=True))


def test_entry_refuses_what_the_plan_does_not_hold(lib):
    """The entry's own checks: a warp grid that cannot hold the tile's
    m-tiles, or a shared memory past the card's, is refused with an error,
    nothing launched."""
    gen = torch.Generator().manual_seed(13)
    x = _bf(gen, 1, 4, 4, 8)
    dc = _dc(gen, 1, 8, 8, 8)
    _, args, _, keep = kernel_args(x, *dc, None, False, None, None, False, False)
    base = list(args)
    i_th = 14 + 12  # n, h, w, c1, c2, n2, x2_half_h, m, o, oc, groups, rows_out, th
    assert lib.mimo_fused_double_conv(*base, None) == 0
    wide = list(base)
    wide[i_th], wide[i_th + 1] = 32, 32  # 34 x 34 mid pixels: 73 m-tiles
    assert lib.mimo_fused_double_conv(*wide, None) != 0
    big = list(base)
    big[i_th + 3] = big[i_th + 6] = 256  # cb, cb2 256: slab, mid, weights > 232448 bytes
    assert lib.mimo_fused_double_conv(*big, None) != 0
