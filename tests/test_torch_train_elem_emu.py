"""K9 (``g_eff``), K8 (``affine_relu`` and its backward), K12
(``conv1x1_prelu`` and its backward) and K11 (``conv1x1`` and its
backward) of ``mimo_unet_torch/csrc/train_elem.cu``,
compiled with g++ against a CPU stand-in of the CUDA runtime
(``tests/cuda_emu``: a fiber per CUDA thread, cp.async as a plain
copy with its alignment and range checks), launched as their wrappers
launch them and held against their plain versions at small shapes: the
16-byte chunks of K9 and K8's forward and their scalar path (a ragged
total, groups whose size is not a multiple of 8, groups past the block's
table, unaligned pointers), the staged tiles of K8's and K12's backward
and of the 1x1 forwards (partial last tiles, groups that start inside a
16-byte unit, several tiles and blocks a group, per-image groups,
unaligned pointers, the entries' refusals).  What the card alone can
show (timing, asynchrony, the compiler) is ``chip_smoke.py``'s.

Tolerances: K9 and K8's forward bitwise (one rounding of the same f32
expression); K8's dy bitwise too (one rounding of da * scale).  The 1x1
forwards' logits within one bf16 ulp of the larger magnitude (their f32
sums run in channel order, the plain version's bmm in another), and
bitwise launch to launch.  K12's dy within one bf16 ulp of the larger magnitude (dz's f32 sum over the
out-conv channels runs in another order than the plain version's bmm, and
may round to the neighbouring bf16).  K11's dz bitwise the FMA chain
over the out-conv channels in order (``_fma_chain_dz``).  The f32 sums of
the backward kernels within 1e-5 of the largest value (they are summed in
another order).
"""

import pytest
import torch

from mimo_unet_torch.kernels import train_elem as TE

from test_torch_conv_tc_emu import _f32_close, _ulp_close, emu_library

BF = torch.bfloat16


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return emu_library(tmp_path_factory, "train_elem.cu",
                       ("mimo_g_eff", "mimo_affine_relu", "mimo_affine_relu_bwd",
                        "mimo_conv1x1_prelu_bwd", "mimo_reduce_groups",
                        "mimo_conv1x1_prelu", "mimo_conv1x1", "mimo_conv1x1_bwd"))


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


def _same_bits(a, b):
    """bf16 tensors equal bit for bit (torch.equal takes -0 for +0)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int16), b.view(torch.int16))


def _affine(gen, groups, c):
    return (torch.rand((groups, c), generator=gen) + 0.5,
            torch.randn((groups, c), generator=gen) * 0.5)


def _affine_relu(lib, y, sc, sh, z=None):
    n, h, w, c = y.shape
    z = torch.full_like(y, float("nan")) if z is None else z
    rc = lib.mimo_affine_relu(y.data_ptr(), sc.data_ptr(), sh.data_ptr(), z.data_ptr(),
                              n, h * w, c, sc.shape[0], None)
    assert rc == 0, (rc, lib.emu_fault_text().decode())
    return z


# (c, groups, images per group, h, w): the flagship's 21 and 42, c < 8 (a
# chunk holds more than one pixel), per-image groups, a ragged total
# (3*5*7*3), group sizes not a multiple of 8, group counts not a multiple
# of 8, groups past the block's table of four groups
AFFINE_SHAPES = [(3, 2, 2, 8, 16), (3, 3, 1, 5, 7), (21, 2, 2, 9, 12), (21, 8, 1, 5, 7),
                 (42, 2, 3, 8, 8), (42, 6, 1, 3, 5), (42, 3, 1, 9, 11)]


@pytest.mark.parametrize("shape", AFFINE_SHAPES)
def test_affine_relu_emulated_bitwise(lib, shape):
    c, groups, per, h, w = shape
    gen = torch.Generator().manual_seed(c * 100 + groups * 10 + per + 1)
    y = _bf(gen, groups * per, h, w, c, scale=3.0)
    sc, sh = _affine(gen, groups, c)
    assert _same_bits(_affine_relu(lib, y, sc, sh), TE.affine_relu_plain(y, sc, sh))


def test_affine_relu_emulated_unaligned(lib):
    """Unaligned y and z take the scalar path throughout, bitwise."""
    gen = torch.Generator().manual_seed(12)
    y = _bf(gen, 4, 5, 9, 21, scale=3.0)
    sc, sh = _affine(gen, 2, 21)
    z = _shifted(torch.full_like(y, float("nan")))
    assert _same_bits(_affine_relu(lib, _shifted(y), sc, sh, z),
                      TE.affine_relu_plain(y, sc, sh))


def _affine_relu_bwd(lib, dz, y, sc, sh, dy=None):
    """K8's backward through the emulation, as the wrapper launches it:
    (dy, dscale, dshift), the partial rows (one sentinel row past each
    must stay unwritten) summed per group by ``reduce_groups``."""
    n, h, w, c = y.shape
    groups = sc.shape[0]
    rows = TE.affine_relu_bwd_blocks(n, h * w, c, groups)
    dy = torch.full_like(y, float("nan")) if dy is None else dy
    pdsc = torch.full((rows + 1, c), float("nan"))
    pdsh = torch.full((rows + 1, c), float("nan"))
    rc = lib.mimo_affine_relu_bwd(dz.data_ptr(), y.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                                  dy.data_ptr(), pdsc.data_ptr(), pdsh.data_ptr(),
                                  n, h * w, c, groups, None)
    assert rc == 0, (rc, lib.emu_fault_text().decode())
    out = [dy]
    for part in (pdsc, pdsh):
        assert bool(torch.isfinite(part[:rows]).all()), "a partial row was not written"
        assert bool(torch.isnan(part[rows]).all()), "a row past the partials was written"
        red = torch.empty((groups, c))
        assert lib.mimo_reduce_groups(part.data_ptr(), red.data_ptr(), groups,
                                      rows // groups, c, None) == 0
        out.append(red)
    return tuple(out)


def _affine_bwd_close(got, want):
    assert _same_bits(got[0], want[0]), float((got[0].float() - want[0].float()).abs().max())
    for a, b in zip(got[1:], want[1:]):
        _f32_close(a, b)


# (c, groups, images per group, h, w): as AFFINE_SHAPES, and groups of
# several tiles and several blocks (c = 21: 192-pixel tiles, 960 pixels a
# group = 5 tiles, 2 blocks; c = 42: 96-pixel tiles, 10 tiles, 3 blocks;
# c = 3: 1360-pixel tiles, 2 tiles)
AFFINE_BWD_SHAPES = AFFINE_SHAPES + [(21, 2, 2, 20, 24), (42, 2, 1, 30, 32),
                                     (3, 2, 1, 40, 40), (128, 2, 1, 9, 13)]


@pytest.mark.parametrize("shape", AFFINE_BWD_SHAPES)
def test_affine_relu_bwd_emulated(lib, shape):
    c, groups, per, h, w = shape
    gen = torch.Generator().manual_seed(c * 100 + groups * 10 + per + 2)
    n = groups * per
    y, dz = _bf(gen, n, h, w, c, scale=3.0), _bf(gen, n, h, w, c, scale=0.01)
    sc, sh = _affine(gen, groups, c)
    _affine_bwd_close(_affine_relu_bwd(lib, dz, y, sc, sh),
                      TE.affine_relu_bwd_plain(dz, y, sc, sh))


def test_affine_relu_bwd_emulated_unaligned_and_repeated(lib):
    """Unaligned dz, y and dy (every unit copied and stored element by
    element), the blocks' count as the wrapper mirrors it, and the same
    bits from two launches."""
    gen = torch.Generator().manual_seed(13)
    y, dz = _bf(gen, 2, 20, 24, 21, scale=3.0), _bf(gen, 2, 20, 24, 21, scale=0.01)
    sc, sh = _affine(gen, 2, 21)
    assert TE.affine_relu_bwd_blocks(2, 480, 21, 2) == 2 * 1
    assert TE.affine_relu_bwd_blocks(4, 480, 21, 2) == 2 * 2
    want = TE.affine_relu_bwd_plain(dz, y, sc, sh)
    dy = _shifted(torch.full_like(y, float("nan")))
    _affine_bwd_close(_affine_relu_bwd(lib, _shifted(dz), _shifted(y), sc, sh, dy), want)
    first = _affine_relu_bwd(lib, dz, y, sc, sh)
    for a, b in zip(first, _affine_relu_bwd(lib, dz, y, sc, sh)):
        assert torch.equal(a, b)


def test_affine_relu_bwd_entry_refuses_past_256_channels(lib):
    """More than 256 channels (a thread a channel) is refused with an
    error, nothing launched."""
    y = torch.zeros((2, 2, 2, 257), dtype=BF)
    p = torch.zeros(4096)
    assert lib.mimo_affine_relu_bwd(y.data_ptr(), y.data_ptr(), p.data_ptr(), p.data_ptr(),
                                    y.data_ptr(), p.data_ptr(), p.data_ptr(),
                                    2, 4, 257, 1, None) != 0


def _conv1x1(lib, y, sc, sh, wo, bo, out=None):
    """K12's forward (sc and sh given) or K11's (both None) through the
    emulation, as the wrappers launch them."""
    n, h, w, c = y.shape
    groups, oc = wo.shape[0], wo.shape[2]
    out = torch.full((n, h, w, oc), float("nan"), dtype=BF) if out is None else out
    wob = wo.to(BF).contiguous()
    if sc is None:
        rc = lib.mimo_conv1x1(y.data_ptr(), wob.data_ptr(), bo.data_ptr(), out.data_ptr(),
                              n, h * w, c, oc, groups, None)
    else:
        rc = lib.mimo_conv1x1_prelu(y.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                                    wob.data_ptr(), bo.data_ptr(), out.data_ptr(),
                                    n, h * w, c, oc, groups, None)
    assert rc == 0, (rc, lib.emu_fault_text().decode())
    return out


def _conv1x1_case(gen, c, oc, groups, per, h, w, prologue):
    _, y, sc, sh, wo = _prelu_case(gen, c, oc, groups, per, h, w)
    bo = torch.randn((groups, oc), generator=gen) * 0.1
    return (y, sc, sh, wo, bo) if prologue else (y, None, None, wo, bo)


def _conv1x1_plain(y, sc, sh, wo, bo):
    if sc is None:
        return TE.conv1x1_plain(y, wo, bo)
    return TE.conv1x1_prelu_plain(y, sc, sh, wo, bo)


# (c, oc, groups, images per group, h, w): C = 1, 21 and the 128-channel
# limit at OC = 1, 2 and 8; groups starting inside a 16-byte unit (C = 21:
# 510 pixels a group); per-image groups (groups = N); several tiles and
# blocks a group (C = 21: 512-pixel tiles, 3072 pixels a group, 2 blocks
# of 3 tiles; C = 128: 88-pixel tiles, 5 a group, 2 blocks) and partial
# last tiles; C = 32 and 64 at OC = 4 (a multiple of 8 channels: the
# pixels read as 16-byte units; the evidential decoder's 32 -> 4)
CONV1X1_SHAPES = [(1, 1, 2, 1, 5, 7), (1, 8, 2, 2, 4, 4), (21, 2, 2, 2, 15, 17),
                  (21, 1, 4, 1, 7, 9), (21, 8, 3, 1, 9, 11), (21, 2, 1, 1, 64, 48),
                  (128, 2, 2, 1, 16, 25), (128, 8, 2, 1, 5, 6), (32, 4, 1, 2, 17, 19),
                  (64, 4, 2, 1, 9, 13)]


@pytest.mark.parametrize("prologue", [True, False], ids=["conv1x1_prelu", "conv1x1"])
@pytest.mark.parametrize("shape", CONV1X1_SHAPES)
def test_conv1x1_fwd_emulated(lib, shape, prologue):
    c, oc, groups, per, h, w = shape
    gen = torch.Generator().manual_seed(c * 100 + oc * 10 + groups + prologue)
    args = _conv1x1_case(gen, c, oc, groups, per, h, w, prologue)
    got = _conv1x1(lib, *args)
    assert bool(torch.isfinite(got.float()).all()), "a logit was not written"
    _ulp_close(got, _conv1x1_plain(*args))
    assert _same_bits(got, _conv1x1(lib, *args))


def test_conv1x1_fwd_emulated_unaligned(lib):
    """Unaligned y and logits (every unit copied and stored element by
    element), both entries, at C = 21 and at C = 32 (read as 16-byte
    units), the same bits as from aligned tensors."""
    gen = torch.Generator().manual_seed(14)
    for prologue in (True, False):
        for c, oc in ((21, 2), (32, 4)):
            y, sc, sh, wo, bo = _conv1x1_case(gen, c, oc, 2, 1, 8, 9, prologue)
            out = _shifted(torch.full((2, 8, 9, oc), float("nan"), dtype=BF))
            got = _conv1x1(lib, _shifted(y), sc, sh, wo, bo, out)
            assert _same_bits(got, _conv1x1(lib, y, sc, sh, wo, bo))
            _ulp_close(got, _conv1x1_plain(y, sc, sh, wo, bo))


def test_conv1x1_fwd_entries_refuse_past_their_limits(lib):
    """More than 128 channels or 8 out-conv channels is refused by both
    forward entries with an error, nothing launched."""
    y = torch.zeros((2, 2, 2, 129), dtype=BF)
    p = torch.zeros(4096)
    for c, oc in ((129, 2), (21, 9)):
        assert lib.mimo_conv1x1_prelu(y.data_ptr(), p.data_ptr(), p.data_ptr(), y.data_ptr(),
                                      p.data_ptr(), y.data_ptr(), 2, 4, c, oc, 1, None) != 0
        assert lib.mimo_conv1x1(y.data_ptr(), y.data_ptr(), p.data_ptr(), y.data_ptr(),
                                2, 4, c, oc, 1, None) != 0


def _conv1x1_bwd(lib, g, z, wo, dz=None):
    """K11's backward through the emulation, as the wrapper launches it:
    (dz, dwo, dbo), the partial rows (one sentinel row past them must stay
    unwritten) summed per group by the kernel's own ``reduce_groups``."""
    n, h, w, c = z.shape
    groups, oc = wo.shape[0], wo.shape[2]
    rows = TE.conv1x1_bwd_blocks(n, h * w, c, oc, groups)
    dz = torch.full_like(z, float("nan")) if dz is None else dz
    part = torch.full((rows + 1, c * oc + oc), float("nan"))
    wob = wo.to(BF).contiguous()
    rc = lib.mimo_conv1x1_bwd(g.data_ptr(), z.data_ptr(), wob.data_ptr(), dz.data_ptr(),
                              part.data_ptr(), n, h * w, c, oc, groups, None)
    assert rc == 0, (rc, lib.emu_fault_text().decode())
    assert bool(torch.isfinite(part[:rows]).all()), "a partial row was not written"
    assert bool(torch.isnan(part[rows]).all()), "a row past the partials was written"
    red = torch.empty((groups, part.shape[1]))
    assert lib.mimo_reduce_groups(part.data_ptr(), red.data_ptr(), groups, rows // groups,
                                  part.shape[1], None) == 0
    return dz, red[:, :c * oc].reshape(groups, c, oc), red[:, c * oc:]


def _fma_chain_dz(g, wo):
    """K11's dz: fma(wo[c, j], g[j], .) over j in order from +0 in f32,
    rounded once to bf16.  Each f32 FMA is the f64 sum of the exact
    product of two bf16 values (itself an f32 value) and the f32 partial,
    rounded to f32: a sum of two f32 values taken in f64 rounds to the
    f32 sum's bits."""
    n, h, w, oc = g.shape
    groups, c = wo.shape[:2]
    wf = wo.to(BF).double().repeat_interleave(n // groups, dim=0)  # [N, C, OC]
    gf = g.double().reshape(n, h * w, oc)
    d = torch.zeros((n, h * w, c))
    for j in range(oc):
        d = (gf[:, :, j, None] * wf[:, None, :, j] + d.double()).float()
    return d.reshape(n, h, w, c).to(BF)


def _conv1x1_bwd_case(gen, c, oc, groups, per, h, w):
    g, z, _, _, wo = _prelu_case(gen, c, oc, groups, per, h, w)
    return g, z, wo


def _conv1x1_bwd_close(got, g, z, wo):
    assert _same_bits(got[0], _fma_chain_dz(g, wo)), "dz is not the FMA chain's"
    _, dwo, dbo = TE.conv1x1_bwd_plain(g, z, wo)
    _f32_close(got[1], dwo)
    _f32_close(got[2], dbo)


# (c, oc, groups, images per group, h, w): C = 21, 40 and the 128-channel
# limit at OC = 1, 2 and 7; several tiles and blocks a group with a
# partial last tile (C = 21, OC = 2: 352-pixel tiles, 3072 pixels a group,
# 3 blocks of 3 tiles; C = 128: 56-pixel tiles, 400 pixels a group, 2
# blocks); per-image groups (groups = N); groups starting inside a 16-byte
# unit (63 and 99 pixels a group)
CONV1X1_BWD_SHAPES = [(21, 2, 2, 1, 48, 64), (21, 1, 4, 1, 7, 9), (21, 7, 2, 2, 9, 11),
                      (40, 2, 4, 1, 15, 21), (40, 7, 2, 1, 16, 20), (128, 1, 2, 1, 16, 25),
                      (128, 2, 2, 1, 11, 26), (128, 7, 3, 1, 5, 6)]


@pytest.mark.parametrize("shape", CONV1X1_BWD_SHAPES)
def test_conv1x1_bwd_emulated(lib, shape):
    c, oc, groups, per, h, w = shape
    args = _conv1x1_bwd_case(torch.Generator().manual_seed(c * 100 + oc * 10 + groups),
                             c, oc, groups, per, h, w)
    _conv1x1_bwd_close(_conv1x1_bwd(lib, *args), *args)


def test_conv1x1_bwd_emulated_unaligned_and_repeated(lib):
    """Unaligned g, z and dz (every unit copied and stored element by
    element), the blocks' count as the wrapper mirrors it, and the same
    bits from two launches."""
    gen = torch.Generator().manual_seed(15)
    g, z, wo = _conv1x1_bwd_case(gen, 21, 2, 2, 1, 48, 64)
    assert TE.conv1x1_bwd_blocks(2, 3072, 21, 2, 2) == 2 * 3
    dz = _shifted(torch.full_like(z, float("nan")))
    _conv1x1_bwd_close(_conv1x1_bwd(lib, _shifted(g), _shifted(z), wo, dz), g, z, wo)
    first = _conv1x1_bwd(lib, g, z, wo)
    for a, b in zip(first, _conv1x1_bwd(lib, g, z, wo)):
        assert torch.equal(a, b)


def test_conv1x1_bwd_entry_refuses_past_its_limits(lib):
    """More than 128 channels or 8 out-conv channels is refused with an
    error, nothing launched."""
    y = torch.zeros((2, 2, 2, 129), dtype=BF)
    p = torch.zeros(4096)
    for c, oc in ((129, 2), (21, 9)):
        assert lib.mimo_conv1x1_bwd(y.data_ptr(), y.data_ptr(), y.data_ptr(), y.data_ptr(),
                                    p.data_ptr(), 2, 4, c, oc, 1, None) != 0
