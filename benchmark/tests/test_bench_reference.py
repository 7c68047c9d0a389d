"""The yardstick's arithmetic and the plain reference, on the CPU: the
reference against hand computations, and against the program's float32
route (the plain modules on the CPU) at a small size."""

import math

import numpy as np
import pytest
import torch

from benchmark import inputs, yardstick
from benchmark.drivers.common import make_task
from benchmark.reference import model as ref_model, train as ref_train
from benchmark.tests.tiny import tiny_config


def test_laplace_nll_against_a_hand_computation():
    mu = torch.tensor([0.5, -1.0, 2.0])
    log_b = torch.tensor([0.0, math.log(2.0), math.log(1e-7)])
    y = torch.tensor([1.0, 1.0, 2.5])
    # b = 1, 2 and the clamp's 1e-5
    want = [0.0 + 0.5, math.log(2.0) + 2.0 / 2.0, math.log(1e-5) + 0.5 / 1e-5]
    got = ref_train.laplace_nll(mu, log_b, y)
    assert torch.allclose(got, torch.tensor(want), rtol=1e-6)
    # the clamp acts in the forward only: d/d(log_b) is exp's, not 0
    lb = log_b.clone().requires_grad_(True)
    ref_train.laplace_nll(mu, lb, y).sum().backward()
    b = torch.exp(log_b)
    assert torch.allclose(lb.grad[:2], (1 - (mu - y).abs() / b)[:2], rtol=1e-6)
    assert lb.grad[2] != 0


def test_uncertainty_decomposition_against_a_hand_computation():
    # B=1, S=3, one pixel
    mu = torch.tensor([1.0, 2.0, 6.0]).view(1, 3, 1)
    log_b = torch.log(torch.tensor([1.0, 2.0, 3.0])).view(1, 3, 1)
    mean, ale, epi = ref_train.uncertainties(mu, log_b)
    assert mean.item() == pytest.approx(3.0)
    assert ale.item() == pytest.approx(2 * (1 + 4 + 9) / 3)  # std^2 = 2 b^2
    assert epi.item() == pytest.approx(((1 - 3) ** 2 + (2 - 3) ** 2 + (6 - 3) ** 2) / 2)


def test_flop_count_is_linear_in_pixels():
    cfg = tiny_config()
    for kind in ("train", "serve"):
        a = yardstick.model_flops(cfg, kind, 480, 640, small=(32, 48))
        b = yardstick.model_flops(cfg, kind, 480, 640, small=(64, 96))
        assert a == pytest.approx(b, rel=1e-12)
    # the count is the convs': forward 2 * 9 * in * out a pixel per 3x3 conv
    one = yardstick.model_flops(cfg, "serve", 32, 32, small=(32, 32))
    want = 0.0
    px = {"encoder.in": 1, "encoder.down1s": 1 / 4, "core.down2": 1 / 16,
          "core.down3": 1 / 64, "core.down4": 1 / 256, "core.up1": 1 / 64,
          "core.up2": 1 / 16, "core.up3": 1 / 4, "decoder": 1}
    for pre, cin, mid, cout in ref_model.double_convs(cfg):
        share = next(v for k, v in px.items() if pre.startswith(k))
        want += 2 * 9 * (cin * mid + mid * cout) * 1024 * share
    s, f = cfg["num_subnetworks"], cfg["filter_base_count"]
    want += s * 2 * f * cfg["out_channels"] * 1024
    assert one == pytest.approx(want, rel=1e-12)


def test_site_tables_hold_the_train_and_eval_convs():
    cfg = tiny_config()
    train = yardstick.train_conv_sites(cfg, 4, 32, 48)
    assert [x["kernel"] for x in train].count("K5") == 6
    assert [x["kernel"] for x in train].count("K6") == 5  # in.c1 needs no dx
    eval_ = yardstick.eval_conv_sites(cfg, 4, 32, 48)
    assert [x["site"] for x in eval_] == ["in_conv", "down1", "up3", "decoder"]
    # the sites' FLOPs are the model's conv FLOPs outside the core's plain modules
    fwd = sum(x["flops"] for x in train if x["kernel"] == "K5")
    assert 0 < fwd < 4 * yardstick.model_flops(cfg, "serve", 32, 48)


def test_reference_serves_what_the_programs_float32_route_serves():
    from mimo_unet_torch.models.ensemble import Ensemble

    cfg = tiny_config()
    task = make_task(cfg | {"compute_dtype": None}, 0)
    model = task.build_model(device="cpu")
    w = inputs.serving_weights(cfg, 2**31 + 5, "cpu", 32, 48)
    model.load_state_dict(w)
    img = inputs.frames(7, 6, 32, 48, "cpu")["image"].float() / 255
    got = Ensemble([(task, model)]).predict(img.numpy(), batch_size=4)
    want = ref_train.serve(w, img, cfg)
    # float32 against float32: the two sum in other orders, and the aleatoric
    # variance exponentiates the log-scale output
    for a, b in zip(got, want):
        assert np.linalg.norm(a - b.numpy()) <= 1e-4 * np.linalg.norm(b.numpy())


def test_reference_trains_as_the_programs_float32_route_trains():
    cfg, seed = tiny_config(), 2**31 + 12345
    task = make_task(cfg | {"compute_dtype": None}, seed)
    state = task.init_state(steps_per_epoch=4, device="cpu")
    w = inputs.weights(cfg, seed, "cpu", serving=False)
    state.model.load_state_dict(w)
    fr = inputs.frames(seed, 8, 32, 48, "cpu")
    batches = [{k: v[i * 4:(i + 1) * 4] for k, v in fr.items()} for i in range(2)]
    named = dict(state.model.named_parameters())
    keys = ref_model.parameter_keys(cfg)
    losses = []
    for i, b in enumerate(batches):
        _, logs, _ = task.train_step(state, b)
        losses.append([float(logs[f"train_loss_{j}"]) for j in range(2)])
        if i == 0:
            g = [float(state.optimizer.state[named[k]]["exp_avg"].norm() / 0.1) for k in keys]
    ref = ref_train.train_steps(w, batches, cfg, seed)
    assert np.allclose(losses[0], ref["losses"][0].numpy(), rtol=1e-5)
    # the same step-2 batch rows (the transform draws), so step 2 agrees up
    # to Adam's sign flips of round-off-sized first gradients
    assert np.allclose(losses[1], ref["losses"][1].numpy(), rtol=1e-2)
    # the worst leaf of float32 against float32 reads 3e-3 here (BatchNorm's
    # batch sums in another order); the median leaf 1e-4
    rg = np.array(ref["grad_norms"])
    gaps = np.abs(np.array(g) - rg) / np.maximum(rg, np.median(rg))
    assert gaps.max() < 1e-2 and np.median(gaps) < 1e-3


def test_weights_and_frames_are_functions_of_the_seed():
    cfg = tiny_config()
    a = inputs.weights(cfg, 2**33 + 1, "cpu", serving=True)
    b = inputs.weights(cfg, 2**33 + 1, "cpu", serving=True)
    c = inputs.weights(cfg, 2**33 + 2, "cpu", serving=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["core.up1.conv.double_conv.0.weight"],
                           c["core.up1.conv.double_conv.0.weight"])
    # serving sets the running statistics from seeded calibration frames
    p = inputs.serving_weights(cfg, 2**33 + 1, "cpu", 32, 48)
    v = p["core.up1.conv.double_conv.1.running_var"]
    assert float(v.min()) > 0 and not torch.equal(v, a["core.up1.conv.double_conv.1.running_var"])
    f1, f2 = inputs.frames(9, 3, 16, 32, "cpu"), inputs.frames(9, 3, 16, 32, "cpu")
    assert torch.equal(f1["image"], f2["image"]) and f1["label"].shape == (3, 16, 32, 1)
