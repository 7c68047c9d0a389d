"""The port's spatial (H) split (``parallel/mesh.py`` ``make_mesh_2d``,
``parallel/halo.py``) on the CPU, held against the JAX 2-D mesh.

One spawn of 4 gloo CPU ranks (``parallel.launch.spawn``, joined within
180 s) builds the 1x2, 2x2 and 1x4 meshes in turn over its first ranks and
runs ``tests/torch_spatial_ranks.py``; this process builds the references
meanwhile.  Sizes are the JAX package's spatial test's
(tests/test_parallel.py:66-104): S=2, fbc 4, 64x64, here B=4; on 1x4 the
bottleneck's 4 rows are one a shard, whose reflect partner at the global
edge is a halo row.  Weights: ``mimo_unet_init``'s structure filled with
seeded values (``test_torch_slice._leaf_values``), transplanted.

* The JAX tests' expectations: the rank-5 and rank-4 specs and the
  "rank" error (:184-212), ``make_mesh_2d`` over more ranks than exist
  raises naming "devices" (:87-94), the kernel gates refuse a spatial
  mesh (tests/test_ct_mesh.py:186-195): no kernel launches, one warning a
  route.
* H-sharded eval forwards, gathered on every rank, against the port's
  unsharded forward at 1e-6 of the largest output (1x2, 2x2, 1x4; the
  transpose and unpool decoders on 1x2), and on 1x2 against the JAX
  package's H-sharded forward under ``make_mesh_2d(1, 2)`` of the 8
  virtual CPU devices at docs/PARITY.md's 2e-4.
* f32 train steps on 1x2 (center and final dropout, JAX masks injected at
  the global height) and 2x2 (the Dropout2d sites, masks each rank draws
  from its data index) against the one-process step on the same global
  batch: loss rel <= 1e-5, every gradient leaf within ``REORDER_TOL`` of
  its largest magnitude (tests/test_torch_parallel.py: f32 gradients at
  B > 1 move that far under a mere reordering of the sums), running
  statistics at 1e-5 relative; the evidential task's step on 1x2 alike;
  ``val_step`` on 2x2 with a padded row.
* ``halo_rows``' values and its adjoint, <halo(x), g> = <x, halo^T(g)>
  summed over the ranks in f64; the upsample's shard matrices at every
  shard edge; the height rule; ``Trainer`` refuses a spatial mesh.

Torch runs on one thread here and in the ranks.
"""

import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu.models.mimo_unet import MimoUNetConfig as JaxConfig, mimo_unet_init
from mimo_unet_tpu.parallel import mesh as jax_mesh
from mimo_unet_tpu.tasks.mimo import MimoUnetTask as JaxTask

from mimo_unet_torch.interop import jax_pytree_to_state_dict
from mimo_unet_torch.models.mimo_unet import MimoUNetConfig
from mimo_unet_torch.ops import max_pool_2x2
from mimo_unet_torch.ops.dropout import DropoutSource
from mimo_unet_torch.ops.resize import _interp_matrix, shard_interp_matrix
from mimo_unet_torch.parallel import launch
from mimo_unet_torch.parallel.mesh import (
    Mesh,
    Mesh2D,
    ct_mesh_scope,
    image_sharding,
    make_mesh_2d,
    shard_image,
)
from mimo_unet_torch.tasks.evidential import EvidentialUnetTask
from mimo_unet_torch.tasks.mimo import MimoUnetTask
from mimo_unet_torch.train.trainer import Trainer

import torch_spatial_ranks as R
from test_torch_dropout import jax_masks
from test_torch_slice import _leaf_values
from test_torch_up_modes import mode_weights

JOIN_S = 180
WORLD = 4
REORDER_TOL = 5e-3  # tests/test_torch_parallel.py's, a leaf's scale
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def bilinear_weights():
    """(jax params, jax state, port state dict) of ``R.MODEL``."""
    cfg = JaxConfig(**R.MODEL)
    shapes = jax.eval_shape(lambda k: mimo_unet_init(k, cfg), jax.random.key(0))
    rng = np.random.default_rng(0)
    params, state = jax.tree_util.tree_map_with_path(
        lambda path, sd: jnp.asarray(_leaf_values(path, sd.shape, rng), sd.dtype), shapes)
    return params, state, jax_pytree_to_state_dict(params, state, MimoUNetConfig(**R.MODEL))


def _state_dicts():
    out = {"bilinear": bilinear_weights()[2]}
    for mode, kw in R.UP_MODES.items():
        _, _, params, state = mode_weights(mode, R.S)
        out[mode] = jax_pytree_to_state_dict(params, state,
                                             MimoUNetConfig(**dict(R.MODEL, **kw)))
    return out


def _injected_masks():
    """The JAX key tree's masks of the 1x2 task's sites at the global shape."""
    task = MimoUnetTask(**R.TRAIN_HP[(1, 2)])
    return jax_masks(task.model_config, jax.random.key(7), R.B, R.H, R.W)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results (by rank) and the references, built while the
    ranks run."""
    out = str(tmp_path_factory.mktemp("spatial"))
    inputs = {"sd": _state_dicts(), "x": R.image(), "batch": R.train_batch(3),
              "masks": _injected_masks(),
              "valid": np.array([1, 1, 1, 0], np.float32)}
    failure = []

    def run():
        try:
            launch.spawn(R.run_ranks, WORLD, (out, inputs), device="cpu", timeout=JOIN_S)
        except BaseException as e:  # noqa: BLE001 (raised in the tests)
            failure.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    refs = {"forward": _unsharded_forwards(inputs), "jax": _jax_sharded_forward(inputs),
            "train": {shape: _one_process_step(shape, inputs) for shape in R.TRAIN_HP},
            "evidential": _one_process_evidential(inputs),
            "val": _one_process_val(inputs)}
    thread.join()
    if failure:
        raise failure[0]
    got = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]
    return got, refs, inputs


# ------------------------------------------------------------ references

def _unsharded_forwards(inputs):
    x = torch.from_numpy(inputs["x"])
    out = {}
    for mode, sd in inputs["sd"].items():
        with torch.no_grad():
            out[mode] = R.port_model(sd, **R.UP_MODES.get(mode, {}))(x)
    return out


def _jax_sharded_forward(inputs):
    """The JAX task's forward with its input placed by ``image_sharding``
    on ``make_mesh_2d(1, 2)``, as tests/test_parallel.py:66-85 runs it."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    params, state, _ = bilinear_weights()
    task = JaxTask(**R.MODEL, loss="laplace_nll")
    mesh = jax_mesh.make_mesh_2d(1, 2)
    repl, xspec = NamedSharding(mesh, P()), jax_mesh.image_sharding(mesh)
    fwd = jax.jit(lambda p, s, xx: task.forward(p, s, xx, train=False)[0],
                  in_shardings=(repl, repl, xspec))
    p1, p2 = fwd(jax.device_put(params, repl), jax.device_put(state, repl),
                 jax.device_put(jnp.asarray(inputs["x"]), xspec))
    return np.concatenate([np.asarray(p1), np.asarray(p2)], axis=-1)


def _one_process_step(shape, inputs):
    task = MimoUnetTask(**R.TRAIN_HP[shape])
    state = R.fresh_state(task, inputs["sd"]["bilinear"])
    masks = inputs["masks"] if shape == (1, 2) else R.data_masks(task, shape[0])
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    state, logs, _ = task.train_step(state, batch, dropout=DropoutSource(masks=masks))
    return R.step_record(state, logs)


def _one_process_evidential(inputs):
    task = EvidentialUnetTask(**R.EV_HP)
    state = task.init_state(1, "cpu")
    state, logs, _ = task.train_step(state, {k: torch.from_numpy(v)
                                             for k, v in inputs["batch"].items()})
    return R.step_record(state, logs)


def _one_process_val(inputs):
    task = MimoUnetTask(**R.TRAIN_HP[(2, 2)])
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    batch["valid"] = torch.from_numpy(inputs["valid"])
    logs, _ = task.val_step(R.port_model(inputs["sd"]["bilinear"]), batch)
    return {k: float(v) for k, v in logs.items()}


def _mesh_ranks(got, shape):
    return [r[shape] for r in got[:shape[0] * shape[1]]]


def _near(got, want, scale_tol, what):
    want = np.asarray(want, np.float64)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= scale_tol * scale, f"{what}: max abs {err:.3e}, scale {scale:.3e}"


# ------------------------------------------------ the JAX tests' expectations

def _mesh2d(data, spatial, rank=0):
    """A data x spatial mesh view without a process group: what needs no
    collective (specs, placement, the height rule, the gates' answers)."""
    return Mesh2D(None, rank, data, spatial, CPU, None, None)


def test_rank5_shards_h_axis2():
    assert image_sharding(_mesh2d(2, 4), rank=5).spec == ("data", None, "spatial")
    assert image_sharding(_mesh2d(2, 4)).h_axis == 2


def test_rank4_shards_h_axis1():
    """[B, H, W, C] shards H (axis 1), not W."""
    mesh = _mesh2d(2, 4)
    assert image_sharding(mesh, rank=4).spec == ("data", "spatial")
    x = np.random.default_rng(0).uniform(size=(2, 8, 8, 3)).astype(np.float32)
    part = shard_image(x, mesh, rank=4)
    assert tuple(part.shape) == (1, 2, 8, 3)  # H split by 4, W intact
    np.testing.assert_array_equal(part.numpy(), x[:1, :2])
    with pytest.raises(ValueError, match="rank"):
        image_sharding(mesh, rank=3)


def test_spec_without_a_spatial_axis():
    assert image_sharding(Mesh(None, 0, 1, CPU), rank=5).spec == ("data",)
    assert image_sharding(Mesh(None, 0, 1, CPU), rank=4).h_axis is None


def test_make_mesh_2d_without_a_process_group():
    with pytest.raises(ValueError, match="devices"):
        make_mesh_2d(1, 2, device="cpu")
    one = make_mesh_2d(1, 1, device="cpu")
    assert (one.size, one.shape, one.rows(4)) == (1, {"data": 1, "spatial": 1}, (0, 4))


def test_make_mesh_2d_over_more_ranks_raises(ranks):
    got, _, _ = ranks
    for r in got:
        assert "needs 16 devices" in r["too_big"] and "have 4" in r["too_big"]


def test_mesh_layout_is_data_major(ranks):
    got, _, _ = ranks
    for shape in R.MESHES:
        d, s = shape
        for rank, r in enumerate(_mesh_ranks(got, shape)):
            di, si = rank // s, rank % s
            per_b, per_h = R.B // d, R.H // s
            assert (r["data_index"], r["spatial_index"]) == (di, si)
            assert r["rows"] == (di * per_b, (di + 1) * per_b)
            assert r["h_rows"] == (si * per_h, (si + 1) * per_h)
            assert r["forward"]["shard"] == (per_b, R.S, per_h, R.W, 3)
    for r in got[2:]:
        assert "outside the 1x2 mesh" in r[(1, 2)]["refused"]


def test_kernel_gates_refuse_a_spatial_mesh(ranks):
    got, _, _ = ranks
    for r in _mesh_ranks(got, (1, 2)):
        g = r["gates"]
        assert g["answers"] == [False] * 4
        assert not any(g["launches"].values()), g["launches"]
        assert len(g["warnings"]) == 2  # one a route, over several calls
        assert all("spatial" in w for w in g["warnings"])


def test_gates_take_the_kernels_without_the_split():
    from mimo_unet_torch.models.fast_path import fast_path_supported, train_path_supported

    cfg = MimoUNetConfig(**R.MODEL, compute_dtype="bfloat16", ct_kernels="force")
    shape = (R.B, R.S, 32, R.W, 3)
    with ct_mesh_scope(_mesh2d(2, 1)):
        assert fast_path_supported(cfg, shape, CPU, training=False)
        assert train_path_supported(cfg, shape, CPU, training=True)


# ------------------------------------------------------------ the forwards

@pytest.mark.parametrize("shape", R.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_forward_matches_unsharded(ranks, shape):
    got, refs, inputs = ranks
    want = refs["forward"]["bilinear"].numpy()
    for r in _mesh_ranks(got, shape):
        np.testing.assert_array_equal(r["forward"]["x_back"], inputs["x"])
        _near(r["forward"]["bilinear"], want, 1e-6, f"{shape} rank forward")


@pytest.mark.parametrize("mode", list(R.UP_MODES))
def test_decoder_modes_sharded_match_unsharded(ranks, mode):
    got, refs, _ = ranks
    for r in _mesh_ranks(got, (1, 2)):
        _near(r["forward"][mode], refs["forward"][mode].numpy(), 1e-6, f"1x2 {mode}")


def test_sharded_forward_matches_jax_sharded(ranks):
    got, refs, _ = ranks
    assert refs["jax"].shape == (R.B, R.S, R.H, R.W, 2)
    for r in _mesh_ranks(got, (1, 2)):
        np.testing.assert_allclose(r["forward"]["bilinear"].numpy(), refs["jax"], atol=2e-4)


# ------------------------------------------------------------ the train step

@pytest.mark.parametrize("shape", list(R.TRAIN_HP), ids=lambda s: f"{s[0]}x{s[1]}")
def test_train_step_matches_one_process(ranks, shape):
    got, refs, _ = ranks
    want = refs["train"][shape]
    for r in _mesh_ranks(got, shape):
        step = r["train"]
        for k, v in want["logs"].items():
            assert abs(step["logs"][k] - v) <= 1e-5 * abs(v) + 1e-7, (k, step["logs"][k], v)
        for k, g in want["grads"].items():
            _near(step["grads"][k], g, REORDER_TOL, f"{shape} gradient {k}")
        for k, b in want["buffers"].items():
            np.testing.assert_allclose(step["buffers"][k], b, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{shape} {k}")
        np.testing.assert_allclose(step["loss_buffer"], want["loss_buffer"], rtol=1e-5)
        calls = {k: c for k, (c, _) in step["counts"].items()}
        # every halo but those of the S in_convs' first conv, whose input
        # needs no gradient, sends its cotangents back
        assert calls["halo"] > 0 and calls["halo_grad"] == calls["halo"] - R.S, calls
    # every rank of the mesh ends with the same gradients
    first = _mesh_ranks(got, shape)
    for r in first[1:]:
        for k in want["grads"]:
            assert torch.equal(r["train"]["grads"][k], first[0]["train"]["grads"][k]), k


def test_evidential_step_matches_one_process(ranks):
    got, refs, _ = ranks
    want = refs["evidential"]
    for r in _mesh_ranks(got, (1, 2)):
        step = r["evidential"]
        for k, v in want["logs"].items():
            assert abs(step["logs"][k] - v) <= 1e-5 * abs(v) + 1e-7, (k, step["logs"][k], v)
        for k, g in want["grads"].items():
            _near(step["grads"][k], g, REORDER_TOL, f"evidential gradient {k}")
        for k, b in want["buffers"].items():
            np.testing.assert_allclose(step["buffers"][k], b, rtol=1e-5, atol=1e-7, err_msg=k)


def test_val_step_matches_one_process(ranks):
    got, refs, _ = ranks
    for r in _mesh_ranks(got, (2, 2)):
        for k, v in refs["val"].items():
            assert abs(r["val"][k] - v) <= 1e-5 * abs(v) + 1e-7, (k, r["val"][k], v)


# ------------------------------------------------------------ the halo

@pytest.mark.parametrize("shape", R.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_halo_rows_and_their_adjoint(ranks, shape):
    got, _, _ = ranks
    parts = _mesh_ranks(got, shape)
    d, s = shape
    for di in range(d):
        group = [parts[di * s + si]["halo"] for si in range(s)]
        xs = torch.cat([h["x"] for h in group], dim=-2)  # the spatial group's height
        padded = torch.nn.functional.pad(xs, (0, 0, 1, 1))
        h = group[0]["x"].shape[-2]
        for si, part in enumerate(group):
            assert torch.equal(part["y"], padded[..., si * h:si * h + h + 2, :])
        lhs, rhs = sum(p["lhs"] for p in group), sum(p["rhs"] for p in group)
        assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0), (lhs, rhs)


@pytest.mark.parametrize("h_global,count", [(4, 2), (4, 4), (8, 2), (64, 4), (30, 2)])
def test_upsample_shard_matrix_holds_the_global_rows(h_global, count):
    """Each shard's rows of the global align-corners matrix have all their
    weight inside the shard's input rows and one halo row each side."""
    full = _interp_matrix(h_global, 2 * h_global)
    h = h_global // count
    for i in range(count):
        part = shard_interp_matrix(h, i, count)
        rows = full[2 * h * i:2 * h * (i + 1)]
        lo, hi = max(h * i - 1, 0), min(h * (i + 1) + 1, h_global)
        np.testing.assert_array_equal(rows[:, lo:hi].sum(1), rows.sum(1))
        np.testing.assert_array_equal(part.sum(1), rows.sum(1))
        np.testing.assert_array_equal(part[:, 1 + lo - h * i:1 + hi - h * i], rows[:, lo:hi])


# ------------------------------------------------------------ the limits

def test_height_rule_raises():
    model = R.port_model(bilinear_weights()[2])
    x = torch.zeros((1, R.S, 24, 32, 3))  # global H 48: not a multiple of 2 * 16
    with ct_mesh_scope(_mesh2d(1, 2)):
        with pytest.raises(ValueError, match="multiple of spatial \\* 16 = 32"):
            model(x)
        with pytest.raises(ValueError, match="multiple of spatial \\* 2 = 4"):
            max_pool_2x2(torch.zeros((1, 1, 3, 4)))


def test_trainer_refuses_a_spatial_mesh():
    with pytest.raises(ValueError, match="ct_mesh_scope"):
        Trainer(MimoUnetTask(**R.MODEL), None, max_epochs=1, checkpoint_path="unused",
                mesh=_mesh2d(1, 2))
