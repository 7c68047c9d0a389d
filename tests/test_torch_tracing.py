"""The port's spans (``train/profiling.py`` ``span``, ``SPANS``): free with no
profiler, present and nested under one, and without effect on what the
port computes.

The CPU tests run a tiny model on the kernel route's structure
(``ct_kernels="force"``: each kernel's plain version), so the conv sites'
spans are there too; the ``card`` test runs the kernels themselves, where
the backward's spans are opened on autograd's device thread.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from mimo_unet_torch.data.core import ArrayDataset, DeviceDataset
from mimo_unet_torch.models.ensemble import Ensemble
from mimo_unet_torch.tasks.mimo import MimoUnetTask
from mimo_unet_torch.train import profiling
from mimo_unet_torch.train.profiling import (EVAL_CONV_SITES, MC_SPANS, SPANS,
                                             TRAIN_CONV_SITES)

PREDICT_STAGES = ("mimo.predict.in", "mimo.predict.forward", "mimo.predict.fetch",
                  "mimo.predict.assemble")
TRAIN_STAGES = ("mimo.train.input", "mimo.train.forward", "mimo.train.backward",
                "mimo.train.update")
STAGE_SPANS = ("mimo.predict", *PREDICT_STAGES, "mimo.data.gather", *TRAIN_STAGES)
TRAIN_CONV = tuple(f"mimo.train_conv.{s}" for s in TRAIN_CONV_SITES)
TRAIN_CONV_BWD = tuple(f"mimo.train_conv_bwd.{s}" for s in TRAIN_CONV_SITES)
EVAL_CONV = tuple(f"mimo.eval_conv.{s}" for s in EVAL_CONV_SITES)
H = W = 32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _task(**kw):
    return MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=2,
                        filter_base_count=4, compute_dtype="bfloat16", seed=7, **kw)


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8),
            "label": rng.integers(1, 256, (n, H, W, 1), dtype=np.uint8)}


def _spans(prof):
    """Host spans of the port, by name: [(start_us, end_us)]."""
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name.startswith("mimo."):
            out.setdefault(ev.name, []).append((ev.time_range.start, ev.time_range.end))
    return out


def _inside(child, parents):
    return any(a <= child[0] and child[1] <= b for a, b in parents)


def _disjoint(intervals):
    intervals = sorted(intervals)
    return all(e <= s for (_, e), (s, _) in zip(intervals, intervals[1:]))


def _run(device, profile: bool, steps: int = 1):
    """One ``predict`` of 3 frames in batches of 2 and ``steps`` train
    steps fed by ``DeviceDataset.gather``, on the kernel route; returns
    (answers, state, spans or None)."""
    kw = {} if device.type == "cuda" else {"ct_kernels": "force"}
    task = _task(**kw)
    model = task.build_model(device=device)
    data = DeviceDataset(ArrayDataset(_frames(4)), device=device)
    state = task.init_state(steps_per_epoch=2, device=device)
    images = np.random.default_rng(1).random((3, H, W, 3), dtype=np.float32)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts) if profile else None
    if prof is not None:
        prof.start()
    answers = Ensemble([(task, model)]).predict(images, batch_size=2)
    for _ in range(steps):
        task.train_step(state, data.gather(np.array([2, 0])))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if prof is None:
        return answers, state, None
    prof.stop()
    return answers, state, _spans(prof)


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first, second = profiling.span("mimo.predict"), profiling.span("mimo.train.update")
    assert first is second
    with first, first:
        pass


def test_span_under_a_profiler_is_a_record_function():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("mimo.predict"):
            torch.ones(2).sum()
    assert [ev.name for ev in prof.events()].count("mimo.predict") == 1


def test_spans_are_named_once():
    assert len(SPANS) == len(set(SPANS)) == (10 + 2 * len(TRAIN_CONV_SITES) + len(EVAL_CONV_SITES)
                                             + len(MC_SPANS))
    assert set(STAGE_SPANS + TRAIN_CONV + TRAIN_CONV_BWD + EVAL_CONV + MC_SPANS) == set(SPANS)


@pytest.fixture(scope="module")
def cpu_runs():
    torch.manual_seed(0)
    off = _run(torch.device("cpu"), profile=False)
    on = _run(torch.device("cpu"), profile=True)
    return off, on


def test_every_stage_and_site_span_is_opened_and_documented(cpu_runs):
    _, (_, _, spans) = cpu_runs
    assert set(spans) <= set(SPANS), set(spans) - set(SPANS)
    # no dropout is live here: the MC route's spans are tests/test_torch_mc_tracing.py's
    assert set(spans) == set(SPANS) - set(MC_SPANS)
    # two chunks of the request (a forward each), one train step
    assert len(spans["mimo.predict"]) == 1 and len(spans["mimo.predict.forward"]) == 2
    assert len(spans["mimo.predict.in"]) == 3 and len(spans["mimo.predict.fetch"]) == 2
    assert all(len(spans[n]) == 1 for n in TRAIN_STAGES + TRAIN_CONV + TRAIN_CONV_BWD)
    assert all(len(spans[n]) == 2 for n in EVAL_CONV)


def test_stages_nest_in_their_parent_and_partition_it(cpu_runs):
    _, (_, _, spans) = cpu_runs
    call = spans["mimo.predict"]
    stages = [iv for n in PREDICT_STAGES for iv in spans[n]]
    assert all(_inside(iv, call) for iv in stages)
    assert _disjoint(stages)
    for n in EVAL_CONV:
        assert all(_inside(iv, spans["mimo.predict.forward"]) for iv in spans[n]), n
    train = [iv for n in TRAIN_STAGES for iv in spans[n]]
    assert _disjoint(train + spans["mimo.data.gather"])
    for names, parent in ((TRAIN_CONV, "mimo.train.forward"),
                          (TRAIN_CONV_BWD, "mimo.train.backward")):
        for n in names:
            assert all(_inside(iv, spans[parent]) for iv in spans[n]), n


def test_answers_and_train_state_are_bitwise_with_the_profiler_on(cpu_runs):
    (ans_off, st_off, _), (ans_on, st_on, _) = cpu_runs
    for a, b in zip(ans_off, ans_on):
        np.testing.assert_array_equal(a, b)
    assert st_off.step == st_on.step == 1
    for (k, a), b in zip(st_off.model.state_dict().items(), st_on.model.state_dict().values()):
        assert torch.equal(a, b), k
    opt_off, opt_on = st_off.optimizer.state_dict(), st_on.optimizer.state_dict()
    for i, s in opt_off["state"].items():
        for k, v in s.items():
            assert torch.equal(v, opt_on["state"][i][k]), (i, k)
    assert torch.equal(st_off.loss_buffer.buffer, st_on.loss_buffer.buffer)
    assert torch.equal(st_off.generator.get_state(), st_on.generator.get_state())
    assert st_off.scheduler.state_dict() == st_on.scheduler.state_dict()


@pytest.mark.card
def test_the_kernel_route_opens_every_site_span_on_the_card(card):
    _, _, spans = _run(card, profile=True, steps=2)
    for n in TRAIN_CONV + TRAIN_CONV_BWD:
        assert len(spans.get(n, ())) == 2, n
    for n in EVAL_CONV:
        assert len(spans.get(n, ())) == 2, n
    assert set(STAGE_SPANS) <= set(spans)
