"""The PyTorch port's eval slice held against the JAX package (CPU).

Same weights in both packages: the JAX package's (params, state) pytree,
seeded numpy values throughout, BatchNorm running statistics and affine
included (so the BN fold is exercised), transplanted into the port with
``jax_pytree_to_state_dict``.
Inputs come from ``np.random.default_rng``.

Shape: fbc=6, S=2, B=2, 32x256.  32 rows, not the 16 of the JAX package's
own CT test: at 16 rows the core's bottleneck is one row high, where
torch's reflect padding (and the reference's) refuses, while the JAX conv
returns zero rows.
"""

import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu.interop import torch_state_dict_to_pytree
from mimo_unet_tpu.models.fast_path import mimo_unet_apply_ct
from mimo_unet_tpu.models.mimo_unet import (
    MimoUNetConfig as JaxConfig,
    mimo_unet_apply,
    mimo_unet_init,
)

from mimo_unet_torch.interop import jax_pytree_to_state_dict
from mimo_unet_torch.models.mimo_unet import MimoUNet, MimoUNetConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 2, 32, 256, 3)  # B, S, H, W, C
BASE = dict(in_channels=3, out_channels=2, num_subnetworks=2,
            filter_base_count=6)


def _leaf_values(path, shape, rng):
    """Seeded value of one leaf of the JAX package's (params, state)."""
    name = path[-1].key
    if name == "w":  # HWIO: torch's U(-1/sqrt(fan_in), +)
        bound = 1.0 / np.sqrt(np.prod(shape[-4:-1]))
        return rng.uniform(-bound, bound, shape)
    if name in ("b", "bias"):
        return rng.normal(0.0, 0.1, shape)
    if name in ("scale", "var"):  # BN gamma and running variance
        return rng.uniform(0.5, 1.5, shape)
    if name == "mean":
        return rng.normal(0.0, 0.1, shape)
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def jax_weights(num_subnetworks=2, compute_dtype=None, seed=0):
    """(jax cfg, params, state): the pytree structure of ``mimo_unet_init``
    (by ``jax.eval_shape``) filled with seeded numpy values, BN statistics
    and affine included so the BN fold is exercised.  (Running the init
    itself costs 12-30 s of XLA compiles on the CPU per process.)"""
    cfg = JaxConfig(**dict(BASE, num_subnetworks=num_subnetworks,
                           compute_dtype=compute_dtype))
    shapes = jax.eval_shape(lambda k: mimo_unet_init(k, cfg),
                            jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params, state = jax.tree_util.tree_map_with_path(
        lambda path, sd: jnp.asarray(_leaf_values(path, sd.shape, rng),
                                     sd.dtype), shapes)
    return cfg, params, state


def torch_model(cfg_kwargs, params, state, device="cpu"):
    """The port's MimoUNet (eval) holding the JAX package's weights."""
    cfg = MimoUNetConfig(**cfg_kwargs)
    model = MimoUNet(cfg, device=device)
    model.load_state_dict(jax_pytree_to_state_dict(params, state, cfg))
    return model.eval()


def _inputs(seed=1):
    return np.random.default_rng(seed).uniform(0, 1, SHAPE).astype(np.float32)


@pytest.mark.parametrize("s", [1, 3])
def test_transplant_round_trip_exact(s):
    """torch_state_dict_to_pytree(jax_pytree_to_state_dict(p, s)) == (p, s)."""
    kw = dict(BASE, num_subnetworks=s)
    cfg, params, state = jax_weights(s, seed=s)
    sd = jax_pytree_to_state_dict(params, state, MimoUNetConfig(**kw))
    # the state dict is exactly the module's: strict load succeeds
    MimoUNet(MimoUNetConfig(**kw), device="cpu").load_state_dict(sd)
    p2, s2 = torch_state_dict_to_pytree(sd, cfg)
    for a, b in ((params, p2), (state, s2)):
        la, ta = jax.tree.flatten(a)
        lb, tb = jax.tree.flatten(b)
        assert ta == tb
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_plain_model_f32_matches_jax():
    """Plain MimoUNet f32 eval vs mimo_unet_apply(train=False) f32 (XLA),
    2e-4 abs (docs/PARITY.md:35)."""
    cfg, params, state = jax_weights()
    x = _inputs()
    want, _ = jax.jit(functools.partial(mimo_unet_apply, cfg=cfg, train=False))(
        params, state, jnp.asarray(x))
    model = torch_model(BASE, params, state)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE[:4] + (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_fast_path_slice_bf16_matches_jax_ct_kernels():
    """The whole kernel path (ct_kernels="force": on the CPU every kernel
    wrapper runs its plain version) vs mimo_unet_apply_ct with the Pallas
    kernels in interpret mode, bf16: <= 1e-2 * max|ref| (tighter than the
    3e-2 * scale the JAX package holds its CT path to)."""
    kw = dict(BASE, compute_dtype="bfloat16", ct_kernels="force")
    cfg, params, state = jax_weights(compute_dtype="bfloat16")
    x = _inputs()
    want, _ = mimo_unet_apply_ct(params, state, jnp.asarray(x), cfg,
                                 interpret=True)
    want = np.asarray(want)
    from mimo_unet_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    model = torch_model(kw, params, state)
    with torch.no_grad():  # as predict runs it: with grad, the plain modules
        got = model(torch.from_numpy(x)).numpy()
    # CPU tensors never reach a kernel launch
    assert set(launch_counts().values()) == {0}
    scale = float(np.max(np.abs(want)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-2 * scale, rtol=0)
    # the plain bf16 model (ct_kernels="off") agrees too
    plain = torch_model(dict(kw, ct_kernels="off"), params, state)
    with torch.no_grad():
        got_plain = plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_plain, want, atol=3e-2 * scale, rtol=0)


@pytest.mark.parametrize("ct_kernels,training,dtype,shape,want", [
    ("auto", False, "bfloat16", SHAPE, False),   # CPU: auto never takes it
    ("force", False, "bfloat16", SHAPE, True),
    ("off", False, "bfloat16", SHAPE, False),
    ("force", True, "bfloat16", SHAPE, False),   # eval only
    ("force", False, None, SHAPE, False),        # bf16 only
    ("force", False, "bfloat16", (2, 2, 40, 256, 3), False),  # H % 16
])
def test_fast_path_routing(ct_kernels, training, dtype, shape, want):
    from mimo_unet_torch.models.fast_path import fast_path_supported

    cfg = MimoUNetConfig(**BASE, compute_dtype=dtype, ct_kernels=ct_kernels)
    assert fast_path_supported(cfg, shape, torch.device("cpu"),
                               training=training) is want


PORT_MODULES = [
    "mimo_unet_torch",
    "mimo_unet_torch.ops",
    "mimo_unet_torch.ops.conv",
    "mimo_unet_torch.ops.dropout",
    "mimo_unet_torch.ops.norm",
    "mimo_unet_torch.ops.pooling",
    "mimo_unet_torch.ops.resize",
    "mimo_unet_torch.models.blocks",
    "mimo_unet_torch.models.mimo_unet",
    "mimo_unet_torch.models.fast_path",
    "mimo_unet_torch.models.ensemble",
    "mimo_unet_torch.kernels",
    "mimo_unet_torch.kernels._build",
    "mimo_unet_torch.kernels.fused_double_conv",
    "mimo_unet_torch.kernels.pool_w",
    "mimo_unet_torch.kernels.pool2x2",
    "mimo_unet_torch.kernels.upsample2x",
    "mimo_unet_torch.kernels.upsample_w2x",
    "mimo_unet_torch.kernels.conv3x3_train",
    "mimo_unet_torch.kernels.train_elem",
    "mimo_unet_torch.interop",
    "mimo_unet_torch.losses",
    "mimo_unet_torch.loss_buffer",
    "mimo_unet_torch.transforms",
    "mimo_unet_torch.metrics",
    "mimo_unet_torch.train",
    "mimo_unet_torch.train.optim",
    "mimo_unet_torch.tasks.mimo",
]


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax (and the JAX package)
    out of sys.modules, and no source line imports them."""
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mimo_unet_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|mimo_unet_tpu)\b", re.M)
    pkg = os.path.join(REPO, "mimo_unet_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pat.search(fh.read()), f
