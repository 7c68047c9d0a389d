"""The tensor-core train conv kernels K5 (fwd), K6 (dx) and K7 (dw) of
``mimo_unet_torch/csrc/conv3x3_train.cu``, compiled with g++ against a CPU
stand-in of the CUDA runtime (``tests/cuda_emu``: a fiber per CUDA
thread, ldmatrix and mma.sync by their fragment layouts), held against
their plain versions at small shapes: the halo staging, the reflect at
the edges, the fold steps, the prologue and x2_half_h, the channel and
output slices and blocks of several tiles.  What the card alone can show
(timing, asynchrony, the compiler) is ``chip_smoke.py``'s.

Tolerances: bf16 outputs within one bf16 ulp of the larger magnitude (the
f32 sums run in another order and may round to the neighbouring bf16),
f32 outputs within 1e-5 of the largest value.  K5's statistics are held
against the same sums of its own y: they are defined on the rounded y,
and one y rounded to the neighbouring bf16 moves a sum by more than
1e-5 of the largest.
"""

import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from mimo_unet_torch.kernels import _build
from mimo_unet_torch.kernels import conv3x3_train as CT
from mimo_unet_torch.kernels.fused_double_conv import lerp_h2x_plain
from mimo_unet_torch.kernels.train_elem import group_sum
from mimo_unet_torch.kernels.upsample2x import _h_tables

BF = torch.bfloat16
EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")


def _host_source(src: str) -> str:
    """The kernel source as host C++: the PTX header (``csrc/ptx.cuh``),
    where included, replaced by ``ptx.h``, shared memory made block-wide,
    launches (on one line or several) made calls."""
    src = src.replace('#include "ptx.cuh"', '#include "ptx.h"')
    src = re.sub(r"extern __shared__ (?:__align__\(16\) )?(\w+) (\w+)\[\];",
                 r"\1* \2 = (\1*)emu_dyn_smem();", src)
    src = src.replace("__shared__", "static")
    return re.sub(r"(\w+(?:<[^;<>()]*>)?)<<<(.*?)>>>\((.*?)\);",
                  r"emu_launch(\1, \2, \3);", src, flags=re.S)


def emu_library(tmp_path_factory, source: str, names):
    """``csrc/<source>`` compiled with g++ against ``tests/cuda_emu`` and
    loaded, with the C signatures of its entries ``names``."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the CPU emulation of the kernels")
    out = tmp_path_factory.mktemp("cuda_emu")
    src = out / (source.rsplit(".", 1)[0] + ".cpp")
    src.write_text(_host_source((_build.CSRC_DIR / source).read_text()))
    so = out / "libemu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-ffp-contract=off",
                    "-pthread", "-I", EMU, "-I", str(_build.CSRC_DIR), str(src),
                    os.path.join(EMU, "main.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(so))
    for name in names:
        fn = getattr(dll, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    dll.emu_fault_text.restype = ctypes.c_char_p
    dll.emu_smem_bytes.restype = ctypes.c_size_t
    return dll


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return emu_library(tmp_path_factory, "conv3x3_train.cu",
                       ("mimo_conv3x3_fwd", "mimo_conv3x3_dx", "mimo_conv3x3_dw"))


def _call(lib, name, plan, *args):
    """Launch ``name``; the shared memory it asked for is the plan's (the
    plan picks its tile rows by that figure)."""
    rc = getattr(lib, name)(*args, None)
    assert rc == 0, (name, rc, lib.emu_fault_text().decode())
    assert lib.emu_smem_bytes() == plan.smem


def _p(t):
    return None if t is None else t.data_ptr()


def _bf(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(BF)


def _ulp_close(got, want):
    a, b = got.float(), want.float()
    ulp = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7 + 1e-30
    assert bool(((a - b).abs() <= ulp).all()), float((a - b).abs().max())


def _f32_close(got, want):
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= 1e-5 * scale


def _fwd(lib, x1, w, *, x2=None, sc=None, sh=None, x2h=False):
    """K5 through the emulation, as the wrapper launches it: (y, sum,
    sumsq), the per-block statistics summed per group."""
    n, h, wd, c1 = x1.shape
    groups, o = w.shape[0], w.shape[-1]
    c2 = 0 if x2 is None else x2.shape[-1]
    plan = CT.fwd_plan(n, h, wd, c1, c2, o)
    wpk = CT.pack_fwd_weights(w, plan)
    lo = fa = fb = None
    if x2h:
        lo, fa, fb = _h_tables(h // 2, torch.device("cpu"))[:3]
    y = torch.full((n, h, wd, o), float("nan"), dtype=BF)
    ps = torch.full((n * plan.chunks, o), float("nan"))
    pq = torch.full_like(ps, float("nan"))
    _call(lib, "mimo_conv3x3_fwd", plan, _p(x1), _p(x2), _p(wpk), _p(sc), _p(sh), _p(lo),
          _p(fa), _p(fb), _p(y), _p(ps), _p(pq), n, h, wd, c1, c2,
          0 if x2 is None else x2.shape[0], o, groups, int(sc is not None), int(x2h),
          plan.th, plan.cb, plan.nb, plan.span, int(plan.im2col))
    assert bool(torch.isfinite(ps).all() and torch.isfinite(pq).all()), \
        "a statistics row was not written"
    return y, ps.view(groups, -1, o).sum(1), pq.view(groups, -1, o).sum(1)


def _fwd_close(got, want, groups):
    """y within one ulp of the plain y; the statistics within 1e-5 of the
    plain version's sums of the kernel's own y."""
    y = got[0]
    assert bool(torch.isfinite(y.float()).all()), "a y value was not written"
    _ulp_close(y, want[0])
    _f32_close(got[1], group_sum(y.float(), groups))
    _f32_close(got[2], group_sum(y.float() * y.float(), groups))


def _dx(lib, g, w, *, x1=None, sc=None, sh=None, c1=None, n2=None):
    """K6 through the emulation, as the wrappers launch it."""
    n, h, wd, o = g.shape
    groups, cin = w.shape[0], w.shape[3]
    plan = CT.dx_plan(h, wd, o, cin)
    wpk = CT.pack_dx_weights(w, plan)
    frow, fcol = CT.fold_table(h), CT.fold_table(wd)
    if c1 is not None:
        dx1 = torch.empty((n, h, wd, c1), dtype=BF)
        dx2 = torch.empty((n2, h, wd, cin - c1), dtype=BF)
        _call(lib, "mimo_conv3x3_dx", plan, _p(g), _p(wpk), _p(frow), _p(fcol), None, None,
              None, _p(dx1), _p(dx2), None, None, n, h, wd, o, c1, cin - c1, n2,
              groups, 0, plan.th, plan.cb, plan.span)
        return dx1, dx2
    dx = torch.empty((n, h, wd, cin), dtype=BF)
    pd = ps = None
    if sc is not None:
        pd = torch.empty((n * plan.chunks, cin))
        ps = torch.empty_like(pd)
    _call(lib, "mimo_conv3x3_dx", plan, _p(g), _p(wpk), _p(frow), _p(fcol),
          _p(x1 if sc is not None else None), _p(sc), _p(sh), _p(dx), None, _p(pd),
          _p(ps), n, h, wd, o, cin, 0, 0, groups, int(sc is not None), plan.th,
          plan.cb, plan.span)
    if sc is None:
        return dx
    return dx, pd.view(groups, -1, cin).sum(1), ps.view(groups, -1, cin).sum(1)


def _dw(lib, g, x1, groups, *, x2=None, sc=None, sh=None, x2h=False):
    """K7 through the emulation; the partials summed per group."""
    n, h, wd, o = g.shape
    c1, c2 = x1.shape[-1], 0 if x2 is None else x2.shape[-1]
    cin = c1 + c2
    plan = CT.dw_plan(n, h, wd, c1, c2, o, groups)
    lo = fa = fb = None
    if x2h:
        lo, fa, fb = _h_tables(h // 2, torch.device("cpu"))[:3]
    part = torch.full((groups * plan.chunks, 9 * cin * o), float("nan"))
    _call(lib, "mimo_conv3x3_dw", plan, _p(x1), _p(x2), _p(g), _p(sc), _p(sh), _p(lo),
          _p(fa), _p(fb), _p(part), n, h, wd, c1, c2, 0 if x2 is None else x2.shape[0],
          o, groups, int(sc is not None), int(x2h), plan.th, plan.cb, plan.nb,
          plan.span, int(plan.im2col))
    assert bool(torch.isfinite(part).all()), "a partial row was not written"
    return part.view(groups, plan.chunks, -1).sum(1).view(groups, 3, 3, cin, o)


# (h, w, c1, c2, o, groups, images per group, prologue, x2_half_h): the
# im2col form (C_in = 3; C_in = 2, SEN12TP's VV/VH, at S=3 fbc 32), the
# prologue, x2 with period N2 < N and its half-height form, several
# n-tiles (42, odd: 63), two output slices (80),
# two channel slices (70; fbc 40's decoder conv1, 40 + 80 -> 60), partial
# tiles (W = 17, 19, 20; H = 9: a second tile row of one row), H, W = 3
FWD_SHAPES = [(3, 3, 3, 0, 5, 2, 1, False, False), (5, 20, 3, 0, 21, 1, 2, False, False),
              (6, 19, 21, 0, 21, 2, 1, True, False), (3, 3, 4, 6, 7, 2, 2, False, False),
              (4, 17, 5, 9, 31, 2, 2, False, False), (6, 18, 5, 9, 11, 2, 1, False, True),
              (4, 5, 3, 6, 7, 1, 2, False, True), (9, 16, 42, 0, 42, 1, 2, False, False),
              (5, 7, 21, 0, 63, 2, 1, True, False), (4, 6, 40, 0, 80, 2, 1, False, False),
              (5, 5, 70, 0, 40, 1, 1, True, False), (4, 4, 40, 80, 60, 2, 1, False, True),
              (5, 20, 2, 0, 32, 3, 1, False, False)]


@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_fwd_kernel_emulated(lib, shape):
    h, w, c1, c2, o, groups, per, pro, x2h = shape
    gen = torch.Generator().manual_seed(h * 100 + w * 10 + c1 + o)
    n = groups * per
    x1 = _bf(gen, n, h, w, c1)
    x2 = _bf(gen, per, h // 2 if x2h else h, w, c2) if c2 else None
    wt = _bf(gen, groups, 3, 3, c1 + c2, o, scale=0.3).float()
    sc = sh = None
    if pro:
        sc = torch.rand((groups, c1), generator=gen) + 0.5
        sh = torch.randn((groups, c1), generator=gen) * 0.1
    got = _fwd(lib, x1, wt, x2=x2, sc=sc, sh=sh, x2h=x2h)
    _fwd_close(got, CT.conv3x3_fwd_plain(x1, wt, x2=x2, scale=sc, shift=sh,
                                         x2_half_h=x2h), groups)
    if x2h:  # bit for bit the full-res form fed the upsampled x2
        for a, b in zip(got, _fwd(lib, x1, wt, x2=lerp_h2x_plain(x2).contiguous())):
            assert torch.equal(a, b)


# (h, w, o, cin, groups, images per group): H, W = 3 (the folds of both
# edges on pixel 1), 4, 5, a partial last tile column (19, 17), two tile
# rows (9), several n-tiles and o-chunks (42), two channel slices (70)
DX_SHAPES = [(3, 3, 6, 5, 2, 1), (4, 5, 5, 6, 1, 2), (5, 4, 21, 21, 2, 1),
             (5, 19, 8, 24, 1, 1), (9, 17, 42, 42, 2, 1), (3, 20, 17, 70, 1, 1)]


@pytest.mark.parametrize("form", ["plain", "prologue", "fold"])
@pytest.mark.parametrize("shape", DX_SHAPES)
def test_dx_kernel_emulated(lib, shape, form):
    h, w, o, cin, groups, per = shape
    gen = torch.Generator().manual_seed(h * 100 + w * 10 + o)
    n = groups * per
    g = _bf(gen, n, h, w, o, scale=0.1)
    wt = _bf(gen, groups, 3, 3, cin, o).float()
    if form == "plain":
        _ulp_close(_dx(lib, g, wt), CT.conv3x3_dx_plain(g, wt))
    elif form == "prologue":
        x1 = _bf(gen, n, h, w, cin)
        sc = torch.rand((groups, cin), generator=gen) + 0.5
        sh = torch.randn((groups, cin), generator=gen) * 0.1
        got = _dx(lib, g, wt, x1=x1, sc=sc, sh=sh)
        want = CT.conv3x3_dx_plain(g, wt, x1=x1, scale=sc, shift=sh)
        _ulp_close(got[0], want[0])
        _f32_close(got[1], want[1])
        _f32_close(got[2], want[2])
    else:
        c1 = max(1, cin // 3)
        for a, b in zip(_dx(lib, g, wt, c1=c1, n2=per),
                        CT.conv3x3_dx_fold_plain(g, wt, c1, per)):
            _ulp_close(a, b)


# (h, w, c1, c2, o, groups, images per group, prologue, x2_half_h): the
# im2col form (C_in = 3; C_in = 2 at S=3 fbc 32), the prologue, x2 (shared
# by the groups) and its half-height form, two output slices (42), two
# channel slices (70)
DW_SHAPES = [(3, 3, 3, 0, 5, 2, 1, False, False), (4, 5, 3, 0, 21, 1, 2, False, False),
             (5, 4, 6, 0, 9, 2, 1, True, False), (6, 19, 21, 0, 21, 2, 1, True, False),
             (4, 17, 5, 9, 31, 2, 2, False, False), (6, 18, 5, 9, 11, 2, 1, False, True),
             (9, 16, 42, 0, 42, 1, 2, False, False), (5, 5, 70, 0, 40, 1, 1, False, False),
             (4, 17, 2, 0, 32, 3, 1, False, False)]


@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dw_kernel_emulated(lib, shape):
    h, w, c1, c2, o, groups, per, pro, x2h = shape
    gen = torch.Generator().manual_seed(h * 100 + w * 10 + c1 + o)
    n = groups * per
    x1 = _bf(gen, n, h, w, c1)
    x2 = _bf(gen, per, h // 2 if x2h else h, w, c2) if c2 else None
    g = _bf(gen, n, h, w, o, scale=0.1)
    sc = sh = None
    if pro:
        sc = torch.rand((groups, c1), generator=gen) + 0.5
        sh = torch.randn((groups, c1), generator=gen) * 0.1
    _f32_close(_dw(lib, g, x1, groups, x2=x2, sc=sc, sh=sh, x2h=x2h),
               CT.conv3x3_dw_plain(g, x1, groups, x2=x2, scale=sc, shift=sh,
                                   x2_half_h=x2h))


def test_kernels_emulated_with_blocks_of_several_tiles(lib, monkeypatch):
    """One K7 chunk per group, three K6 tiles a block and K5's longest
    blocks: the next tile's copies started while this one multiplies, the
    fold form's S images a block in turn, the prologue partials and K5's
    statistics over several tiles, K5's channel slices restaged per tile."""
    monkeypatch.setattr(CT, "DW_BLOCKS", 1)
    monkeypatch.setattr(CT, "DX_SPAN", 3)
    monkeypatch.setattr(CT, "FWD_BLOCKS", 1)
    gen = torch.Generator().manual_seed(5)
    groups, per, h, w = 2, 2, 20, 35
    n = groups * per
    x1, x2 = _bf(gen, n, h, w, 7), _bf(gen, per, h // 2, w, 10)
    g = _bf(gen, n, h, w, 13, scale=0.1)
    assert CT.dw_plan(n, h, w, 7, 10, 13, groups).span > 1
    _f32_close(_dw(lib, g, x1, groups, x2=x2, x2h=True),
               CT.conv3x3_dw_plain(g, x1, groups, x2=x2, x2_half_h=True))
    assert CT.fwd_plan(n, h, w, 7, 10, 13).span == CT.FWD_SPAN
    wf = _bf(gen, groups, 3, 3, 17, 13, scale=0.3).float()
    _fwd_close(_fwd(lib, x1, wf, x2=x2, x2h=True),
               CT.conv3x3_fwd_plain(x1, wf, x2=x2, x2_half_h=True), groups)
    x70 = _bf(gen, n, h, w, 70)
    w70 = _bf(gen, groups, 3, 3, 70, 13, scale=0.2).float()
    sc70 = torch.rand((groups, 70), generator=gen) + 0.5
    sh70 = torch.randn((groups, 70), generator=gen) * 0.1
    assert CT.fwd_plan(n, h, w, 70, 0, 13).ncs == 2
    _fwd_close(_fwd(lib, x70, w70, sc=sc70, sh=sh70),
               CT.conv3x3_fwd_plain(x70, w70, scale=sc70, shift=sh70), groups)
    wt = _bf(gen, groups, 3, 3, 17, 13).float()
    for a, b in zip(_dx(lib, g, wt, c1=7, n2=per), CT.conv3x3_dx_fold_plain(g, wt, 7, per)):
        _ulp_close(a, b)
    wp = _bf(gen, groups, 3, 3, 7, 13).float()
    sc = torch.rand((groups, 7), generator=gen) + 0.5
    sh = torch.randn((groups, 7), generator=gen) * 0.1
    got = _dx(lib, g, wp, x1=x1, sc=sc, sh=sh)
    want = CT.conv3x3_dx_plain(g, wp, x1=x1, scale=sc, shift=sh)
    _ulp_close(got[0], want[0])
    _f32_close(got[1], want[1])
    _f32_close(got[2], want[2])


def test_entries_refuse_past_the_channel_limit(lib):
    """The kernels' own checks: more than 256 outputs (dx's K) or input
    channels (dw's M, fwd's K) is refused with an error, nothing
    launched."""
    g = torch.zeros((2, 4, 4, 8), dtype=BF)
    x = torch.zeros((2, 4, 4, 257), dtype=BF)
    frow, fcol = CT.fold_table(4), CT.fold_table(4)
    wpk = torch.zeros(16, dtype=BF)
    assert lib.mimo_conv3x3_dx(_p(g), _p(wpk), _p(frow), _p(fcol), None, None, None,
                               _p(x), None, None, None, 2, 4, 4, 257, 8, 0, 0, 1, 0,
                               8, 8, 4, None) != 0
    part = torch.zeros(16)
    assert lib.mimo_conv3x3_dw(_p(x), None, _p(g), None, None, None, None, None,
                               _p(part), 2, 4, 4, 257, 0, 0, 8, 1, 0, 0, 8, 64, 8, 1,
                               0, None) != 0
    y = torch.zeros((2, 4, 4, 8), dtype=BF)
    assert lib.mimo_conv3x3_fwd(_p(x), None, _p(wpk), None, None, None, None, None,
                                _p(y), _p(part), _p(part), 2, 4, 4, 257, 0, 0, 8, 1, 0,
                                0, 8, 64, 8, 1, 0, None) != 0
