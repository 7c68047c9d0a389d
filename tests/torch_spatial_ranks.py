"""What each rank runs for tests/test_torch_spatial.py (CPU, gloo).

``run_ranks(out_dir, inputs)`` is the function ``parallel.launch.spawn``
runs in each of four ranks; it imports torch and the port only.  One
process group serves the three meshes, built in turn over its first ranks
(``make_mesh_2d``): 1x2, 2x2 and 1x4.  The ranks outside the 1x2 mesh
check that it refuses them.  Each rank saves what the test holds against
its references to ``out_dir/rank<r>.pt``.  Shared sizes and data makers
live here too, so the test builds its references from the same numbers.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

# the JAX package's spatial test (tests/test_parallel.py:75-85): S=2,
# fbc 4, 64x64; on the 1x4 mesh the bottleneck's 4 rows are one a shard
B, S, H, W = 4, 2, 64, 64
MODEL = dict(in_channels=3, out_channels=2, num_subnetworks=S, filter_base_count=4)
MESHES = ((1, 2), (2, 2), (1, 4))
UP_MODES = {"transpose": dict(bilinear=False),
            "unpool": dict(bilinear=False, use_pooling_indices=True)}
# the train steps: the elementwise sites (masks drawn at the global height
# and cut to a shard's rows) on 1x2, injected; the Dropout2d sites on 2x2,
# drawn by each rank from its data index
TRAIN_HP = {(1, 2): dict(MODEL, ct_kernels="off", center_dropout_rate=0.2,
                         final_dropout_rate=0.2, input_repetition_probability=0.5),
            (2, 2): dict(MODEL, ct_kernels="off", encoder_dropout_rate=0.2,
                         core_dropout_rate=0.2, decoder_dropout_rate=0.2,
                         input_repetition_probability=0.5)}
GEN_SEED = 5  # the input transform's generator
EV_HP = dict(in_channels=3, filter_base_count=4, ct_kernels="off")  # the evidential U-Net


def image(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (B, S, H, W, 3)).astype(np.float32)


def train_batch(seed: int) -> dict:
    """A global uint8 batch with a mask; the data halves and the image
    halves (top, bottom) from different distributions, so a BatchNorm or
    loss left local to a rank shows."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    img[B // 2:] = img[B // 2:] // 3 + 150
    img[:, H // 2:] = img[:, H // 2:] // 2
    label = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    label[:, H // 2:] *= 0.3
    mask = (rng.uniform(0, 1, (B, H, W, 1)) > 0.2).astype(np.uint8)
    return {"image": img, "label": label, "mask": mask}


def port_model(state_dict, **over):
    """The port's eval model of ``MODEL`` (with ``over``) on the CPU."""
    from mimo_unet_torch.models.mimo_unet import MimoUNet, MimoUNetConfig

    model = MimoUNet(MimoUNetConfig(**dict(MODEL, **over)), device="cpu")
    model.load_state_dict(state_dict)
    return model.eval()


def fresh_state(task, state_dict):
    """A CPU TrainState of ``task`` holding ``state_dict``, the input
    transform's generator seeded ``GEN_SEED``."""
    state = task.init_state(1, "cpu")
    state.model.load_state_dict(state_dict)
    state.generator = torch.Generator().manual_seed(GEN_SEED)
    return state


def step_record(state, logs):
    model = state.model
    return {"logs": {k: float(v) for k, v in logs.items()},
            "grads": {k: p.grad.detach().clone() for k, p in model.named_parameters()},
            "buffers": {k: v.clone() for k, v in model.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))},
            "loss_buffer": state.loss_buffer.buffer.clone()}


def data_masks(task, data: int, device="cpu") -> dict:
    """The masks the ranks of each of ``data`` data indices draw at step 0
    (``rank_dropout_source``), joined over the batch: what a one-process
    step must be given to match them."""
    from mimo_unet_torch.models.mimo_unet import dropout_sites
    from mimo_unet_torch.tasks.mimo import rank_dropout_source

    sites = dropout_sites(task.model_config, B // data, H, W)
    drawn = [rank_dropout_source(task.seed + 2, 0, d, device).draw(sites, device)
             for d in range(data)]
    return {k: torch.cat([dr[k][0] for dr in drawn]) for k in sites}


# ------------------------------------------------------------------ scenarios

def forwards(mesh, inputs, modes):
    """The eval forward of each mode's model on this rank's rows of the
    global input, gathered; and the shard the rank held."""
    from mimo_unet_torch.parallel import collectives
    from mimo_unet_torch.parallel.mesh import ct_mesh_scope, shard_image

    x = shard_image(inputs["x"], mesh)
    out = {"shard": tuple(x.shape), "x_back": collectives.gather_image(x, mesh)}
    for mode in modes:
        model = port_model(inputs["sd"][mode], **UP_MODES.get(mode, {}))
        with ct_mesh_scope(mesh), torch.no_grad():
            y = model(x)
        out[mode] = collectives.gather_image(y, mesh)
    return out


def train_step(mesh, inputs):
    """One f32 step of this mesh's task on this rank's rows of the global
    batch; under 1x2 the masks are injected at the global height."""
    from mimo_unet_torch.ops.dropout import DropoutSource
    from mimo_unet_torch.parallel import collectives
    from mimo_unet_torch.parallel.mesh import ct_mesh_scope, shard_image
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    key = (mesh.data, mesh.spatial)
    task = MimoUnetTask(**TRAIN_HP[key])
    state = fresh_state(task, inputs["sd"]["bilinear"])
    batch = {k: shard_image(v, mesh, rank=4) for k, v in inputs["batch"].items()}
    dropout = DropoutSource(masks=inputs["masks"]) if key == (1, 2) else None
    collectives.reset_counts()
    with ct_mesh_scope(mesh):
        state, logs, _ = task.train_step(state, batch, dropout=dropout)
    return dict(step_record(state, logs), counts=collectives.counts())


def evidential_step(mesh, inputs):
    """One f32 step of the evidential task (S=1, no input transform) on
    this rank's rows of the global batch."""
    from mimo_unet_torch.parallel.mesh import ct_mesh_scope, shard_image
    from mimo_unet_torch.tasks.evidential import EvidentialUnetTask

    task = EvidentialUnetTask(**EV_HP)
    state = task.init_state(1, "cpu")
    batch = {k: shard_image(v, mesh, rank=4) for k, v in inputs["batch"].items()}
    with ct_mesh_scope(mesh):
        state, logs, _ = task.train_step(state, batch)
    return step_record(state, logs)


def val_step(mesh, inputs):
    """``val_step`` of the 2x2 task's model on this rank's rows, the last
    row of the global batch marked invalid."""
    from mimo_unet_torch.parallel.mesh import ct_mesh_scope, shard_image
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    task = MimoUnetTask(**TRAIN_HP[(2, 2)])
    model = port_model(inputs["sd"]["bilinear"])
    batch = {k: shard_image(v, mesh, rank=4) for k, v in inputs["batch"].items()}
    batch["valid"] = torch.tensor(inputs["valid"][slice(*mesh.rows(B))])
    with ct_mesh_scope(mesh):
        logs, _ = task.val_step(model, batch)
    return {k: float(v) for k, v in logs.items()}


def gates(mesh, inputs):
    """The kernel routes under the mesh at ``ct_kernels="force"`` (each
    kernel's plain version here): what the gates answer, the warnings they
    give over two calls each, and the kernel launches of an eval and a
    train forward."""
    from mimo_unet_torch.kernels import launch_counts, reset_launch_counts
    from mimo_unet_torch.models.fast_path import fast_path_supported, train_path_supported
    from mimo_unet_torch.parallel.mesh import ct_mesh_scope, shard_image

    model = port_model(inputs["sd"]["bilinear"], compute_dtype="bfloat16", ct_kernels="force")
    cfg = model.config
    x = shard_image(inputs["x"], mesh)
    reset_launch_counts()
    with ct_mesh_scope(mesh), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        answers = [f(cfg, x.shape, x.device, training=t)
                   for _ in range(2)
                   for f, t in ((fast_path_supported, False), (train_path_supported, True))]
        with torch.no_grad():
            model(x)
            model.train()(x)
    return {"answers": answers, "launches": dict(launch_counts()),
            "warnings": [str(w.message) for w in caught]}


def halo_adjoint(mesh):
    """<halo(x), g> and <x, halo-backward(g)> on this rank, in f64; and x."""
    from mimo_unet_torch.parallel.halo import halo_rows

    gen = torch.Generator().manual_seed(100 + mesh.rank)
    h = 3
    x = torch.randn((2, 3, h, 5), generator=gen, dtype=torch.float64, requires_grad=True)
    g = torch.randn((2, 3, h + 2, 5), generator=gen, dtype=torch.float64)
    y = halo_rows(x, mesh.spatial_mesh)
    y.backward(g)
    return {"x": x.detach(), "y": y.detach(), "lhs": float((y * g).sum()),
            "rhs": float((x.detach() * x.grad).sum())}


def run_ranks(out_dir: str, inputs: dict) -> None:
    torch.set_num_threads(1)
    from mimo_unet_torch.parallel.mesh import make_mesh_2d

    import torch.distributed as dist

    rank = dist.get_rank()
    results = {"rank": rank}
    try:
        make_mesh_2d(4, 4, device="cpu")
    except ValueError as e:
        results["too_big"] = str(e)
    for shape in MESHES:
        try:
            mesh = make_mesh_2d(*shape, device="cpu")
        except ValueError as e:
            results[shape] = {"refused": str(e)}
            continue
        out = {"data_index": mesh.data_index, "spatial_index": mesh.spatial_index,
               "rows": mesh.rows(B), "h_rows": mesh.h_rows(H)}
        out["forward"] = forwards(mesh, inputs, ("bilinear", *UP_MODES)
                                  if shape == (1, 2) else ("bilinear",))
        out["halo"] = halo_adjoint(mesh)
        if shape in TRAIN_HP:
            out["train"] = train_step(mesh, inputs)
        if shape == (1, 2):
            out["gates"] = gates(mesh, inputs)
            out["evidential"] = evidential_step(mesh, inputs)
        if shape == (2, 2):
            out["val"] = val_step(mesh, inputs)
        results[shape] = out
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
