"""K13 (``upsample2x`` and ``upsample2x_bwd``) and K14
(``lerp_h2x_transpose``) of ``mimo_unet_torch/csrc/upsample2x.cu``,
compiled with g++ against a CPU stand-in of the CUDA runtime
(``tests/cuda_emu``: a host thread per CUDA thread, cp.async as a plain
copy with its alignment and range checks), launched as their wrappers
launch them (the same tables) and held against their plain versions at
small shapes: bands of rows and row tiles that do not divide the image, a
row of more than one tile (cut inside a pixel), H2 or W2 = 2, odd C (rows
that do not start on 16 bytes: scalar stores), N > 1 and unaligned
pointers.  What the card alone can show (timing, asynchrony, the
compiler) is ``chip_smoke.py``'s.

Tolerance: bitwise, all three (bit patterns, so a zero's sign counts).  Each output element is the same f32
expression, in the same order, as its plain version's (the backward's
H-transposed value rounded to bf16 before the W transpose in both; a tap
outside the image adds a zero product in the plain version and nothing in
the kernels, which leaves a sum that starts at +0 unchanged).
"""

import pytest
import torch

from mimo_unet_torch.kernels.upsample2x import (
    _h_tables,
    lerp_h2x_transpose_plain,
    upsample2x_bwd_plain,
    upsample2x_plain,
)
from mimo_unet_torch.kernels.upsample_w2x import _tables as w_tables, _w_bwd_weights

from test_torch_conv_tc_emu import emu_library
from test_torch_train_elem_emu import _same_bits, _shifted

BF = torch.bfloat16
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return emu_library(tmp_path_factory, "upsample2x.cu",
                       ("mimo_upsample2x", "mimo_upsample2x_bwd", "mimo_lerp_h2x_transpose"))


def _bf(gen, *shape):
    return torch.randn(shape, generator=gen).to(BF)


def _ok(lib, rc):
    assert rc == 0, (rc, lib.emu_fault_text().decode())


def _up(lib, x, y=None):
    n, h2, w2, c = x.shape
    lo_w, w0, w1 = w_tables(w2, CPU)
    lo_h, fa, fb, _ = _h_tables(h2, CPU)
    y = torch.full((n, 2 * h2, 2 * w2, c), float("nan"), dtype=BF) if y is None else y
    _ok(lib, lib.mimo_upsample2x(x.data_ptr(), lo_w.data_ptr(), w0.data_ptr(), w1.data_ptr(),
                                 lo_h.data_ptr(), fa.data_ptr(), fb.data_ptr(), y.data_ptr(),
                                 n, h2, w2, c, None))
    return y


def _up_bwd(lib, g, dx=None):
    n, h, w, c = g.shape
    wh, ww = _h_tables(h // 2, CPU)[3], _w_bwd_weights(w // 2, CPU)
    dx = torch.full((n, h // 2, w // 2, c), float("nan"), dtype=BF) if dx is None else dx
    _ok(lib, lib.mimo_upsample2x_bwd(g.data_ptr(), wh.data_ptr(), ww.data_ptr(),
                                     dx.data_ptr(), n, h // 2, w // 2, c, None))
    return dx


def _lerp_t(lib, g):
    n, h, w, c = g.shape
    wh = _h_tables(h // 2, CPU)[3]
    dx = torch.full((n, h // 2, w, c), float("nan"), dtype=BF)
    _ok(lib, lib.mimo_lerp_h2x_transpose(g.data_ptr(), wh.data_ptr(), dx.data_ptr(),
                                         n, h // 2, w, c, None))
    return dx


# (n, h2, w2, c): H2 = W2 = 2; the flagship's 42 channels with a band of
# 16 rows and a row tile that divide neither image (20 output rows; rows
# of 64 * 42 = 2688 elements, two tiles, cut inside a pixel) and 18 half
# rows (two backward bands); odd C (21, 3: rows not on 16 bytes, the
# scalar stores); a row longer than one tile with a pixel larger than a
# chunk (300 channels); N > 1
SHAPES = [(1, 2, 2, 42), (2, 10, 32, 42), (1, 18, 5, 42), (1, 9, 7, 21), (2, 3, 5, 3),
          (1, 5, 4, 300), (3, 4, 6, 42), (1, 2, 3, 1)]


@pytest.mark.parametrize("shape", SHAPES)
def test_upsample2x_emulated_bitwise(lib, shape):
    x = _bf(torch.Generator().manual_seed(sum(shape)), *shape)
    assert _same_bits(_up(lib, x), upsample2x_plain(x))


@pytest.mark.parametrize("shape", SHAPES)
def test_upsample2x_bwd_emulated_bitwise(lib, shape):
    n, h2, w2, c = shape
    g = _bf(torch.Generator().manual_seed(sum(shape) + 1), n, 2 * h2, 2 * w2, c)
    assert _same_bits(_up_bwd(lib, g), upsample2x_bwd_plain(g))


@pytest.mark.parametrize("shape", SHAPES[:4])
def test_lerp_h2x_transpose_emulated_bitwise(lib, shape):
    """K14 shares the source (and its H-tap loop) with K13's old backward."""
    n, h2, w2, c = shape
    g = _bf(torch.Generator().manual_seed(sum(shape) + 2), n, 2 * h2, w2, c)
    assert _same_bits(_lerp_t(lib, g), lerp_h2x_transpose_plain(g))


def test_upsample2x_emulated_unaligned_and_repeated(lib):
    """Unaligned input and output (every unit staged and every element
    stored one by one), both ways, bitwise; and the same bits from two
    launches."""
    gen = torch.Generator().manual_seed(5)
    x = _bf(gen, 2, 10, 32, 42)
    y = _shifted(torch.full((2, 20, 64, 42), float("nan"), dtype=BF))
    assert _same_bits(_up(lib, _shifted(x), y), upsample2x_plain(x))
    g = _bf(gen, 2, 20, 64, 42)
    dx = _shifted(torch.full((2, 10, 32, 42), float("nan"), dtype=BF))
    assert _same_bits(_up_bwd(lib, _shifted(g), dx), upsample2x_bwd_plain(g))
    assert _same_bits(_up(lib, x), _up(lib, x))
    assert _same_bits(_up_bwd(lib, g), _up_bwd(lib, g))


def test_upsample2x_entries_refuse_what_they_cannot_take(lib):
    """H2 or W2 below 2, and channels past what a block's shared memory
    holds (a backward tile of 8 half-row elements and its 7-pixel halo in
    each of 9 staged rows), are refused with an error, nothing launched."""
    x = torch.zeros(64, dtype=BF)
    t = torch.zeros(64)
    for h2, w2, c in ((1, 4, 8), (4, 1, 8)):
        assert lib.mimo_upsample2x(x.data_ptr(), t.data_ptr(), t.data_ptr(), t.data_ptr(),
                                   t.data_ptr(), t.data_ptr(), t.data_ptr(), x.data_ptr(),
                                   1, h2, w2, c, None) != 0
        assert lib.mimo_upsample2x_bwd(x.data_ptr(), t.data_ptr(), t.data_ptr(), x.data_ptr(),
                                       1, h2, w2, c, None) != 0
    assert lib.mimo_upsample2x_bwd(x.data_ptr(), t.data_ptr(), t.data_ptr(), x.data_ptr(),
                                   1, 2, 2, 4096, None) != 0
