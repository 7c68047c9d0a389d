"""The port's kernel plain versions held against the JAX package's Pallas
kernels (interpret mode, CPU).

Each port kernel's plain PyTorch version defines what its CUDA kernel
computes (``chip_smoke.py`` compares the two on the card).  Here the plain
versions meet the TPU kernels they replace, at the option sets the flagship
eval path uses.  Layout bridge: the port's channels-last [N, H, W, C] is the
TPU kernels' CT layout [C, N*H*W] after a transpose.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mimo_unet_tpu.ops.pallas.ct_conv import (
    align8,
    fused_double_conv9_ct,
    fused_double_conv_ct,
    pack_w3x3,
)
from mimo_unet_tpu.ops.pallas.ct_elem import max_pool_w_ct
from mimo_unet_tpu.ops.pallas.ct_resize import upsample_w2x_ct

from mimo_unet_torch.kernels import (
    fused_double_conv,
    fused_double_conv9,
    fused_double_conv_plain,
    pool_w,
    pool_w_plain,
    upsample_w2x,
    upsample_w2x_plain,
)


def _bf16(rng, shape, scale=1.0):
    """Seeded bf16 values as float32 numpy (exactly representable)."""
    x = rng.normal(0.0, scale, shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _ct(x):
    """[N, H, W, C] -> CT [C, N*H*W] bf16 (jax)."""
    return jnp.asarray(np.moveaxis(x, -1, 0).reshape(x.shape[-1], -1),
                       jnp.bfloat16)


def _nhwc(ct, c, n, h, w):
    """CT [>=c, n*h*w] -> [n, h, w, c] float32 numpy (real channels)."""
    a = np.asarray(ct[:c].astype(jnp.float32))
    return np.moveaxis(a.reshape(c, n, h, w), 0, -1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)


@pytest.mark.parametrize("n,h,w,c", [(2, 4, 256, 5), (1, 2, 512, 84)])
def test_pool_w_plain_bitwise(n, h, w, c):
    x = _bf16(np.random.default_rng(0), (n, h, w, c))
    want = _nhwc(max_pool_w_ct(_ct(x), n * h, w, interpret=True), c, n, h, w // 2)
    got = pool_w_plain(_t(x)).float().numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(pool_w(_t(x)).float().numpy(), want)


@pytest.mark.parametrize("n,h,w2,c", [(2, 3, 128, 6), (1, 2, 256, 21)])
def test_upsample_w2x_plain_bitwise(n, h, w2, c):
    """Bitwise: the products of bf16 values with the bf16-rounded weights
    are exact in f32, so the two-term sum rounds once in both."""
    x = _bf16(np.random.default_rng(1), (n, h, w2, c))
    want = _nhwc(upsample_w2x_ct(_ct(x), n * h, w2, interpret=True),
                 c, n, h, 2 * w2)
    got = upsample_w2x_plain(_t(x)).float().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(upsample_w2x(_t(x)).float().numpy(), want)


def _affine(rng, g, c):
    return (rng.uniform(0.5, 1.5, (g, c)).astype(np.float32),
            rng.normal(0.0, 0.1, (g, c)).astype(np.float32))


def _close(got, want):
    """max abs <= 1e-2 * max|ref|, mean abs <= 1e-3 * max|ref|: the f32 sum
    order differs, so a mid bf16 rounding can flip by one ulp."""
    scale = float(np.max(np.abs(want))) or 1.0
    err = np.abs(got - want)
    assert got.shape == want.shape
    assert err.max() <= 1e-2 * scale, (err.max(), scale)
    assert err.mean() <= 1e-3 * scale, (err.mean(), scale)


def _weights(rng, g, cin, m, o):
    w1 = rng.uniform(-1, 1, (g, 3, 3, cin, m)).astype(np.float32) / np.sqrt(9 * cin)
    w2 = rng.uniform(-1, 1, (g, 3, 3, m, o)).astype(np.float32) / np.sqrt(9 * m)
    return w1, w2


def test_fused_double_conv_single_input_hpool_group_rows():
    """down1's option set: grouped weights, emit_hpool, group_rows_out."""
    rng = np.random.default_rng(2)
    g, per, h, w, c, m, o = 2, 2, 16, 256, 6, 12, 12
    n = g * per
    x = _bf16(rng, (n, h, w, c))
    w1, w2 = _weights(rng, g, c, m, o)
    (s1, sh1), (s2, sh2) = _affine(rng, g, m), _affine(rng, g, o)
    w1p = jnp.stack([pack_w3x3([jnp.asarray(w1[i])]) for i in range(g)])
    w2p = jnp.stack([pack_w3x3([jnp.asarray(w2[i])]) for i in range(g)])
    out, hp = fused_double_conv_ct(
        _ct(x), w1p, s1, sh1, w2p, s2, sh2, h=h, w=w, th=8, c1=c, m=m, o=o,
        emit_hpool=True, group_rows_out=True, interpret=True)
    oa = align8(o)

    def grouped(ct, hh):  # [G*oa, per*hh*w] -> [per, hh, w, G*o]
        return np.concatenate([_nhwc(ct[i * oa:(i + 1) * oa], o, per, hh, w)
                               for i in range(g)], axis=-1)

    args = [torch.from_numpy(a) for a in (w1, s1, sh1, w2, s2, sh2)]
    got, got_hp = fused_double_conv(_t(x), *args, emit_hpool=True,
                                    group_rows_out=True)
    _close(got.float().numpy(), grouped(out, h))
    _close(got_hp.float().numpy(), grouped(hp, h // 2))


@pytest.mark.parametrize("fused_out", [False, True])
def test_fused_double_conv_two_inputs_half_h(fused_out):
    """up3's option set (two inputs, x2 at half height, in-kernel H lerp)
    and the decoder's (the same with S=2 groups sharing x2 with period B,
    plus the fused 1x1 out-conv)."""
    rng = np.random.default_rng(3 + fused_out)
    g, b = (2, 2) if fused_out else (1, 2)
    n, h, w = g * b, 16, 256
    c1, c2, m, o, oc = (6, 5, 7, 6, 2) if fused_out else (8, 8, 8, 6, 0)
    x1 = _bf16(rng, (n, h, w, c1))
    x2 = _bf16(rng, (b, h // 2, w, c2))
    w1, w2 = _weights(rng, g, c1 + c2, m, o)
    (s1, sh1), (s2, sh2) = _affine(rng, g, m), _affine(rng, g, o)
    w1p = jnp.stack([pack_w3x3([jnp.asarray(w1[i, :, :, :c1]),
                                jnp.asarray(w1[i, :, :, c1:])])
                     for i in range(g)])
    w2p = jnp.stack([pack_w3x3([jnp.asarray(w2[i])]) for i in range(g)])
    kw = dict(h=h, w=w, th=8, c1=c1, m=m, o=o, x2=_ct(x2), c2=c2,
              n2_images=b, x2_half_h=True, interpret=True)
    targs = [torch.from_numpy(a) for a in (w1, s1, sh1, w2, s2, sh2)]
    if fused_out:
        wo = rng.uniform(-1, 1, (g, o, oc)).astype(np.float32) / np.sqrt(o)
        bo = rng.normal(0.0, 0.1, (g, oc)).astype(np.float32)
        oca = align8(oc)
        wop = jnp.zeros((g, o, oca)).at[:, :, :oc].set(wo)
        bop = jnp.zeros((g, oca)).at[:, :oc].set(bo)
        out = fused_double_conv_ct(_ct(x1), w1p, s1, sh1, w2p, s2, sh2,
                                   wo=wop, bo=bop, **kw)
        want = _nhwc(out, oc, n, h, w)
        got = fused_double_conv(_t(x1), *targs, x2=_t(x2), x2_half_h=True,
                                wo=torch.from_numpy(wo),
                                bo=torch.from_numpy(bo))
    else:
        out = fused_double_conv_ct(_ct(x1), w1p, s1, sh1, w2p, s2, sh2, **kw)
        want = _nhwc(out, o, n, h, w)
        got = fused_double_conv(_t(x1), *targs, x2=_t(x2), x2_half_h=True)
    _close(got.float().numpy(), want)


def test_fused_double_conv9_hpool():
    """in_conv's option set: c_in = 3 (the nine-tap kernel), emit_hpool."""
    rng = np.random.default_rng(5)
    g, per, h, w, c, m, o = 2, 2, 16, 256, 3, 6, 6
    n = g * per
    x = _bf16(rng, (n, h, w, c))
    w1, w2 = _weights(rng, g, c, m, o)
    (s1, sh1), (s2, sh2) = _affine(rng, g, m), _affine(rng, g, o)
    w2p = jnp.stack([pack_w3x3([jnp.asarray(w2[i])]) for i in range(g)])
    out, hp = fused_double_conv9_ct(
        _ct(x), jnp.asarray(w1), s1, sh1, w2p, s2, sh2, h=h, w=w, th=8, c1=c,
        m=m, o=o, emit_hpool=True, interpret=True)
    args = [torch.from_numpy(a) for a in (w1, s1, sh1, w2, s2, sh2)]
    got, got_hp = fused_double_conv9(_t(x), *args, emit_hpool=True)
    _close(got.float().numpy(), _nhwc(out, o, n, h, w))
    _close(got_hp.float().numpy(), _nhwc(hp, o, n, h // 2, w))


def test_fused_double_conv_rejects_bad_shapes():
    x = torch.zeros(2, 8, 16, 4, dtype=torch.bfloat16)
    w1 = torch.zeros(1, 3, 3, 4, 5)
    w2 = torch.zeros(1, 3, 3, 5, 6)
    s1, s2 = torch.ones(1, 5), torch.ones(1, 6)
    with pytest.raises(ValueError):
        fused_double_conv_plain(x, w1[:, :, :, :3], s1, s1, w2, s2, s2)
    with pytest.raises(ValueError):  # x2 at half height needs x2_half_h
        fused_double_conv_plain(x, torch.zeros(1, 3, 3, 6, 5), s1, s1, w2,
                                s2, s2, x2=torch.zeros(2, 4, 16, 2))
    with pytest.raises(ValueError):
        fused_double_conv_plain(x, w1, s1, s1, w2, s2, s2,
                                wo=torch.zeros(1, 6, 2), bo=torch.zeros(1, 2),
                                emit_hpool=True)


@pytest.mark.parametrize("which", ["pool_w", "upsample_w2x", "fused_double_conv9"])
def test_wrappers_raise_off_cpu_without_cuda(which):
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises (here: a meta tensor, no fallback)."""
    x = torch.empty((2, 4, 32, 3), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        if which == "pool_w":
            pool_w(x)
        elif which == "upsample_w2x":
            upsample_w2x(x)
        else:
            g, m = 2, 4
            z = dict(device="meta")
            fused_double_conv9(x, torch.zeros(g, 3, 3, 3, m, **z),
                               torch.ones(g, m, **z), torch.zeros(g, m, **z),
                               torch.zeros(g, 3, 3, m, m, **z),
                               torch.ones(g, m, **z), torch.zeros(g, m, **z))
