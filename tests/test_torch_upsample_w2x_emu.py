"""K4 (``upsample_w2x``) and K4b (``upsample_w2x_bwd``) of
``mimo_unet_torch/csrc/upsample_w2x.cu``, compiled with g++ against a CPU
stand-in of the CUDA runtime (``tests/cuda_emu``: a fiber per CUDA
thread, cp.async as a plain copy with its alignment and range checks),
launched as their wrappers launch them (the same tables) and held against
their plain versions at small shapes: rows cut into several tiles, tile
edges inside a 16-byte unit (rows that do not start on 16 bytes), blocks
of several staged stages with a partial last stage, W2 = 2, a ragged last
unit, odd C (the element-wise path) and even C (channel pairs), unaligned
pointers, and the entries' refusals.  What the card alone can show
(timing, asynchrony, the compiler) is ``chip_smoke.py``'s.

Tolerance: bitwise (bit patterns, so a zero's sign counts).  Each output
element is the same f32 expression, in the same order, as its plain
version's: two exact products of bf16 values, summed and rounded once
(K4); the cotangent's five taps in order, rounded once (K4b).
"""

import pytest
import torch

from mimo_unet_torch.kernels.upsample_w2x import (
    _tables,
    _w_bwd_weights,
    upsample_w2x_bwd_plain,
    upsample_w2x_plain,
)

from test_torch_conv_tc_emu import emu_library
from test_torch_train_elem_emu import _same_bits, _shifted

BF = torch.bfloat16
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return emu_library(tmp_path_factory, "upsample_w2x.cu",
                       ("mimo_upsample_w2x", "mimo_upsample_w2x_bwd"))


def _bf(gen, *shape):
    return torch.randn(shape, generator=gen).to(BF)


def _ok(lib, rc):
    assert rc == 0, (rc, lib.emu_fault_text().decode())


def _up(lib, x, out=None):
    n, h, w2, c = x.shape
    lo, w0, w1 = _tables(w2, CPU)
    out = torch.full((n, h, 2 * w2, c), float("nan"), dtype=BF) if out is None else out
    _ok(lib, lib.mimo_upsample_w2x(x.data_ptr(), lo.data_ptr(), w0.data_ptr(), w1.data_ptr(),
                                   out.data_ptr(), n * h, w2, c, None))
    return out


# (n, h, w2, c), rows n * h.  C = 3: the element path, rows of 30 elements
# (a ragged last unit; rows that start inside a 16-byte unit); C = 21: a
# row of 2100 elements, two tiles of the element path, their edges inside
# 16-byte units on every odd row; C = 42: a row of 5376 elements, two
# tiles of channel pairs; 26 rows of 1344 (stages of 8 rows, two blocks of
# two stages, the last stage 2 rows); C = 84 over two tiles; W2 = 2
SHAPES = [(1, 3, 5, 3), (2, 3, 50, 21), (1, 3, 64, 42), (2, 13, 16, 42), (1, 2, 32, 84),
          (1, 4, 2, 42), (2, 3, 2, 3), (1, 5, 2, 21)]


@pytest.mark.parametrize("shape", SHAPES)
def test_upsample_w2x_emulated_bitwise(lib, shape):
    x = _bf(torch.Generator().manual_seed(sum(shape)), *shape)
    assert _same_bits(_up(lib, x), upsample_w2x_plain(x))


def test_upsample_w2x_emulated_unaligned_and_repeated(lib):
    """Unaligned input and output (every unit staged and every element
    stored one by one), at even and odd C, bitwise; and the same bits from
    two launches."""
    gen = torch.Generator().manual_seed(4)
    for shape in ((2, 3, 20, 42), (1, 3, 11, 21)):
        x = _bf(gen, *shape)
        n, h, w2, c = shape
        out = _shifted(torch.full((n, h, 2 * w2, c), float("nan"), dtype=BF))
        assert _same_bits(_up(lib, _shifted(x), out), upsample_w2x_plain(x))
        assert _same_bits(_up(lib, x), _up(lib, x))


def _up_bwd(lib, g, dx=None):
    n, h, w, c = g.shape
    ww = _w_bwd_weights(w // 2, CPU)
    dx = torch.full((n, h, w // 2, c), float("nan"), dtype=BF) if dx is None else dx
    _ok(lib, lib.mimo_upsample_w2x_bwd(g.data_ptr(), ww.data_ptr(), dx.data_ptr(),
                                       n * h, w // 2, c, None))
    return dx


def test_upsample_w2x_bwd_emulated_bitwise(lib):
    """K4b (staged rows, channel pairs) at one shape."""
    g = _bf(torch.Generator().manual_seed(6), 2, 3, 12, 42)
    assert _same_bits(_up_bwd(lib, g), upsample_w2x_bwd_plain(g))


# (n, h, w, c) of the cotangent, rows n * h of w2 = w / 2 half columns.
# C = 42: a half row of 2688 elements, two tiles; 25 rows of 672 (stages
# of 7 rows, blocks of two stages, the last stage 4 rows); W2 = 2 at even
# and odd C; C = 3 and 6 at W2 = 5: a ragged last unit, rows that start
# inside a 16-byte unit; C = 21: a half row of 2100 elements, two tiles of
# the element path, their edges inside 16-byte units on the odd row;
# C = 84 over two tiles
BWD_SHAPES = [(1, 3, 128, 42), (1, 25, 32, 42), (1, 4, 4, 42), (2, 3, 4, 3), (2, 3, 10, 3),
              (1, 3, 10, 6), (1, 2, 200, 21), (1, 2, 64, 84)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_upsample_w2x_bwd_emulated_shapes(lib, shape):
    g = _bf(torch.Generator().manual_seed(sum(shape) + 1), *shape)
    assert _same_bits(_up_bwd(lib, g), upsample_w2x_bwd_plain(g))


@pytest.mark.parametrize("shape", [(2, 3, 40, 42), (1, 3, 22, 21)], ids=["even C", "odd C"])
def test_upsample_w2x_bwd_emulated_unaligned_and_repeated(lib, shape):
    """Unaligned cotangent and dx (every unit staged and every element
    stored one by one), bitwise; and the same bits from two launches."""
    g = _bf(torch.Generator().manual_seed(7), *shape)
    n, h, w, c = shape
    dx = _shifted(torch.full((n, h, w // 2, c), float("nan"), dtype=BF))
    assert _same_bits(_up_bwd(lib, _shifted(g), dx), upsample_w2x_bwd_plain(g))
    assert _same_bits(_up_bwd(lib, g), _up_bwd(lib, g))


def test_upsample_w2x_entry_refuses_what_it_cannot_take(lib):
    """W2 below 2, and a row whose staged input columns do not fit a
    block's shared memory (a tile's columns and their halo at 20000
    channels), are refused by both entries with an error, nothing
    launched."""
    x = torch.zeros(64, dtype=BF)
    t = torch.zeros(64)
    for w2, c in ((1, 8), (2, 20000)):
        assert lib.mimo_upsample_w2x(x.data_ptr(), t.data_ptr(), t.data_ptr(), t.data_ptr(),
                                     x.data_ptr(), 1, w2, c, None) != 0
        assert lib.mimo_upsample_w2x_bwd(x.data_ptr(), t.data_ptr(), x.data_ptr(), 1, w2, c,
                                         None) != 0
