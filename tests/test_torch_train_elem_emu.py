"""K9 (``g_eff``) and K12's backward (``conv1x1_prelu_bwd``) of
``mimo_unet_torch/csrc/train_elem.cu``, compiled with g++ against a CPU
stand-in of the CUDA runtime (``tests/cuda_emu``: a host thread per CUDA
thread, cp.async as a plain copy with its alignment and range checks),
launched as their wrappers launch them and held against their plain
versions at small shapes: K9's 16-byte chunks and its scalar path (a
ragged total, groups whose size is not a multiple of 8, groups past the
block's table, unaligned pointers), K12's staged tiles (partial last
tiles, groups that start inside a 16-byte unit, several tiles and blocks
a group, per-image groups).  What the card alone can show (timing,
asynchrony, the compiler) is ``chip_smoke.py``'s.

Tolerances: K9 bitwise (one rounding of the same f32 expression).  K12's
dy within one bf16 ulp of the larger magnitude (dz's f32 sum over the
out-conv channels runs in another order than the plain version's bmm, and
may round to the neighbouring bf16); its f32 sums within 1e-5 of the
largest value (they are summed in another order).
"""

import pytest
import torch

from mimo_unet_torch.kernels import train_elem as TE

from test_torch_conv_tc_emu import _f32_close, _ulp_close, emu_library

BF = torch.bfloat16


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return emu_library(tmp_path_factory, "train_elem.cu",
                       ("mimo_g_eff", "mimo_conv1x1_prelu_bwd", "mimo_reduce_groups"))


def _bf(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(BF)


def _shifted(t):
    """t's values in a tensor whose data starts 2 bytes past a 16-byte
    boundary (an unaligned pointer)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _g_eff(lib, dy, y, ds, dq, out=None):
    n, h, w, o = y.shape
    out = torch.full_like(y, float("nan")) if out is None else out
    rc = lib.mimo_g_eff(dy.data_ptr(), y.data_ptr(), ds.data_ptr(), dq.data_ptr(),
                        out.data_ptr(), n, h * w, o, ds.shape[0], None)
    assert rc == 0, (rc, lib.emu_fault_text().decode())
    return out


# (o, groups, images per group, h, w): the flagship's widths (21, 31, 42),
# o < 8 (a chunk holds more than one pixel), per-image groups, a total
# that is not a multiple of 8 (3*5*7*3), group sizes not a multiple of 8
# (chunks cut by a group boundary), groups shorter than a block's span
# (past the block's table of four groups), spans of several blocks
G_EFF_SHAPES = [(3, 2, 2, 8, 16), (3, 3, 1, 5, 7), (21, 2, 2, 9, 12), (21, 8, 1, 5, 7),
                (31, 2, 1, 7, 13), (31, 4, 1, 6, 10), (42, 2, 3, 8, 8), (42, 6, 1, 3, 5)]


@pytest.mark.parametrize("shape", G_EFF_SHAPES)
def test_g_eff_emulated_bitwise(lib, shape):
    o, groups, per, h, w = shape
    gen = torch.Generator().manual_seed(o * 100 + groups * 10 + per)
    n = groups * per
    dy, y = _bf(gen, n, h, w, o, scale=0.01), _bf(gen, n, h, w, o, scale=3.0)
    ds = torch.randn((groups, o), generator=gen) * 1e-3
    dq = torch.randn((groups, o), generator=gen) * 1e-4
    want = TE.g_eff_plain(dy, y, ds, dq)
    assert torch.equal(_g_eff(lib, dy, y, ds, dq), want)


def test_g_eff_emulated_unaligned_and_wide(lib):
    """Unaligned dy, y and out take the scalar path throughout; o past the
    table's 256 channels reads its parameters from global memory; both
    bitwise."""
    gen = torch.Generator().manual_seed(11)
    groups, n, h, w, o = 2, 4, 5, 9, 21
    dy, y = _bf(gen, n, h, w, o, scale=0.01), _bf(gen, n, h, w, o)
    ds = torch.randn((groups, o), generator=gen) * 1e-3
    dq = torch.randn((groups, o), generator=gen) * 1e-4
    want = TE.g_eff_plain(dy, y, ds, dq)
    out = _shifted(torch.full_like(y, float("nan")))
    assert torch.equal(_g_eff(lib, _shifted(dy), _shifted(y), ds, dq, out), want)
    o = 260
    dy, y = _bf(gen, 2, 3, 4, o, scale=0.01), _bf(gen, 2, 3, 4, o)
    ds = torch.randn((groups, o), generator=gen) * 1e-3
    dq = torch.randn((groups, o), generator=gen) * 1e-4
    assert torch.equal(_g_eff(lib, dy, y, ds, dq), TE.g_eff_plain(dy, y, ds, dq))


def _prelu_bwd(lib, g, y, sc, sh, wo):
    """K12's backward through the emulation, as the wrapper launches it;
    the partial rows (one sentinel row past them must stay unwritten)
    summed per group by the kernel's own ``reduce_groups``."""
    n, h, w, c = y.shape
    groups, oc = wo.shape[0], wo.shape[2]
    rows = TE.prelu_bwd_blocks(n, h * w, c, oc, groups)
    dy = torch.full_like(y, float("nan"))
    part = torch.full((rows + 1, c * oc + oc + 2 * c), float("nan"))
    wob = wo.to(BF).contiguous()
    rc = lib.mimo_conv1x1_prelu_bwd(g.data_ptr(), y.data_ptr(), sc.data_ptr(),
                                    sh.data_ptr(), wob.data_ptr(), dy.data_ptr(),
                                    part.data_ptr(), n, h * w, c, oc, groups, None)
    assert rc == 0, (rc, lib.emu_fault_text().decode())
    assert bool(torch.isfinite(part[:rows]).all()), "a partial row was not written"
    assert bool(torch.isnan(part[rows]).all()), "a row past the partials was written"
    red = torch.empty((groups, part.shape[1]))
    rc = lib.mimo_reduce_groups(part.data_ptr(), red.data_ptr(), groups,
                                rows // groups, part.shape[1], None)
    assert rc == 0
    co = c * oc
    return (dy, red[:, co + oc:co + oc + c], red[:, co + oc + c:],
            red[:, :co].reshape(groups, c, oc), red[:, co:co + oc])


def _prelu_case(gen, c, oc, groups, per, h, w):
    n = groups * per
    y = _bf(gen, n, h, w, c, scale=3.0)
    g = _bf(gen, n, h, w, oc, scale=0.01)
    sc = torch.rand((groups, c), generator=gen) + 0.5
    sh = torch.randn((groups, c), generator=gen) * 0.1
    wo = (torch.rand((groups, c, oc), generator=gen) * 2 - 1) / c ** 0.5
    return g, y, sc, sh, wo


def _prelu_close(got, want):
    assert bool(torch.isfinite(got[0].float()).all()), "a dy value was not written"
    _ulp_close(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        _f32_close(a, b)


# (c, groups, images per group, h, w): c = 6, the flagship's 21, 40 and the
# 128-channel limit; per-image groups (groups = N); groups whose pixels do
# not fill their last tile, groups of several tiles and blocks, groups
# starting inside a 16-byte unit (pixels a group not a multiple of 8)
PRELU_SHAPES = [(6, 2, 1, 5, 7), (6, 3, 1, 31, 47), (21, 2, 2, 15, 17), (21, 4, 1, 7, 9),
                (40, 2, 1, 15, 21), (40, 3, 1, 5, 6), (128, 2, 1, 11, 26), (128, 4, 1, 3, 5)]


@pytest.mark.parametrize("oc", [1, 2])
@pytest.mark.parametrize("shape", PRELU_SHAPES)
def test_conv1x1_prelu_bwd_emulated(lib, shape, oc):
    c, groups, per, h, w = shape
    gen = torch.Generator().manual_seed(c * 100 + groups * 10 + oc)
    args = _prelu_case(gen, c, oc, groups, per, h, w)
    _prelu_close(_prelu_bwd(lib, *args), TE.conv1x1_prelu_bwd_plain(*args))


def test_conv1x1_prelu_bwd_emulated_blocks_and_widths(lib):
    """Blocks of several tiles with the next tile staged while one is
    computed (c = 128: 56-pixel tiles, 8 a group, 2 blocks of 4), every
    out-conv width the kernel is instantiated for, unaligned pointers
    (every unit copied and stored element by element), and the same bits
    from two launches."""
    gen = torch.Generator().manual_seed(3)
    args = _prelu_case(gen, 128, 2, 2, 1, 16, 25)
    assert TE.prelu_bwd_blocks(2, 400, 128, 2, 2) == 2 * 2
    got = _prelu_bwd(lib, *args)
    _prelu_close(got, TE.conv1x1_prelu_bwd_plain(*args))
    for a, b in zip(got, _prelu_bwd(lib, *args)):
        assert torch.equal(a, b)
    for oc in range(3, 9):
        args = _prelu_case(gen, 13, oc, 2, 1, 6, 7)
        _prelu_close(_prelu_bwd(lib, *args), TE.conv1x1_prelu_bwd_plain(*args))
    g, y, sc, sh, wo = _prelu_case(gen, 21, 2, 2, 1, 8, 9)
    _prelu_close(_prelu_bwd(lib, _shifted(g), _shifted(y), sc, sh, wo),
                 TE.conv1x1_prelu_bwd_plain(g, y, sc, sh, wo))


def test_conv1x1_prelu_bwd_entry_refuses_past_its_limits(lib):
    """More than 128 channels or 8 out-conv channels is refused with an
    error, nothing launched."""
    y = torch.zeros((2, 2, 2, 129), dtype=BF)
    g = torch.zeros((2, 2, 2, 9), dtype=BF)
    p = torch.zeros(4096)
    for c, oc in ((129, 2), (21, 9)):
        assert lib.mimo_conv1x1_prelu_bwd(g.data_ptr(), y.data_ptr(), p.data_ptr(),
                                          p.data_ptr(), y.data_ptr(), y.data_ptr(),
                                          p.data_ptr(), 2, 4, c, oc, 1, None) != 0
