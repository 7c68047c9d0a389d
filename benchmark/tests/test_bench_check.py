"""The check that decides ``correct`` fails what it must fail.

On the CPU at a size a test holds (``tiny.py``), through the harness's own
``run_cell`` with the timed path broken underneath, once per fault a cell
can have: a train step that returns its state unchanged, a train step
that leaves out half its batch (the mean over the rest), a served answer
altered where ``predict`` produces it, and a served aleatoric variance
that lost its factor of 2.  The fp8 control (the
reference in the program's place, a precision below the configurations'
bf16) fails too.  The ``card`` tests repeat the control at the cells' own
sizes on the H100.
"""

import contextlib
import copy

import pytest
import torch

from benchmark import calibrate, cells, inputs
from benchmark.reference.quant import fp8
from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_cell

SEED = 2**32 + 977


@contextlib.contextmanager
def state_unchanged():
    from mimo_unet_torch.tasks.mimo import MimoUnetTask

    orig = MimoUnetTask.train_step

    def step(self, state, batch, **kw):
        _, logs, out = orig(self, copy.deepcopy(state), batch, **kw)
        return state, logs, out

    MimoUnetTask.train_step = step
    try:
        yield
    finally:
        MimoUnetTask.train_step = orig


@contextlib.contextmanager
def answer_altered():
    from mimo_unet_torch.models.ensemble import Ensemble

    orig = Ensemble.predict

    def predict(self, images, **kw):
        mean, ale, epi = orig(self, images, **kw)
        mean = mean.copy()
        mean[0] = mean[1]  # frame 0 answered with frame 1's depth
        return mean, ale, epi

    Ensemble.predict = predict
    try:
        yield
    finally:
        Ensemble.predict = orig


@contextlib.contextmanager
def aleatoric_halved():
    from mimo_unet_torch.models.ensemble import Ensemble

    orig = Ensemble.predict

    def predict(self, images, **kw):
        mean, ale, epi = orig(self, images, **kw)
        return mean, ale / 2, epi  # E_S[b^2] for E_S[2 b^2]

    Ensemble.predict = predict
    try:
        yield
    finally:
        Ensemble.predict = orig


def run(kind):
    torch.manual_seed(0)
    return run_cell(tiny_cell(kind), SEED, 0.3, False, "cpu")


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_a_sound_run_is_correct(kind):
    res = run(kind)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("kind,fault", [("train", state_unchanged),
                                        ("train", calibrate.half_batch),
                                        ("serve", answer_altered),
                                        ("serve", aleatoric_halved)],
                         ids=["state_unchanged", "half_batch", "answer_altered",
                              "aleatoric_halved"])
def test_a_broken_timed_path_is_not_correct(kind, fault):
    with fault():
        res = run(kind)
    assert not res["correct"], res["check"]


def control_readings(cell, seed, device):
    """The fp8 control's readings against the float32 reference, on the
    rows a run would check."""
    tr = cell.traffic
    drv = cells.driver_class(tr)(cell.config, tr, seed, device)
    if drv.kind == "train":
        split = inputs.frames(seed, tr["split_frames"], tr["height"], tr["width"], device)
        drv.host = {k: v.cpu().numpy() for k, v in split.items()}
        b = tr["batch"]
        drv.checked_rows = [list(range(i * b, (i + 1) * b)) for i in range(tr["checked_steps"])]
        return drv.compare(drv.reference(quant=fp8), drv.reference())
    drv.params = inputs.serving_weights(cell.config, seed, device, tr["height"], tr["width"])
    b = tr["request_frames"]
    frames = (inputs.frames(seed, b, tr["height"], tr["width"], device)["image"].float()
              / 255).cpu().numpy()
    return drv.judge(drv.reference(frames, quant=fp8), frames)


def fails(cell, readings):
    return any(readings[k] > lim for k, lim in cell.limits.items())


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_the_fp8_control_is_not_correct(kind):
    cell = tiny_cell(kind)
    assert fails(cell, control_readings(cell, SEED, "cpu"))


@pytest.mark.card
@pytest.mark.parametrize("name", ["nyuv2_train_b64", "cli_train_b32", "nyuv2_predict_b32",
                                  "cli_predict_b8"])
def test_the_fp8_control_is_not_correct_at_the_cells_size(card, name):
    cell = cells.load_cell(name)
    assert fails(cell, control_readings(cell, SEED, card))


@pytest.mark.card
@pytest.mark.parametrize("name,fault", [("nyuv2_train_b64", state_unchanged),
                                        ("nyuv2_train_b64", calibrate.half_batch),
                                        ("cli_train_b32", state_unchanged),
                                        ("cli_train_b32", calibrate.half_batch),
                                        ("nyuv2_predict_b32", answer_altered),
                                        ("cli_predict_b8", answer_altered),
                                        ("nyuv2_predict_b32", aleatoric_halved)],
                         ids=["recipe-state_unchanged", "recipe-half_batch",
                              "cli-state_unchanged", "cli-half_batch",
                              "recipe-answer_altered", "cli-answer_altered",
                              "recipe-aleatoric_halved"])
def test_a_broken_timed_path_is_not_correct_at_the_cells_size(card, name, fault):
    with fault():
        res = run_cell(cells.load_cell(name), SEED, 2.0, False, card)
    assert not res["correct"], res["check"]
