"""MC-dropout serving held against the benchmark's plain reference,
``benchmark/reference/mc.py`` (CPU, seeded random weights, a small size:
S=2, filter_base_count 8, 32x48 frames, B=2, T=3 passes).

* The reference's masks, drawn by the program's documented contract, are
  bitwise the ones ``Ensemble.predict`` hands its forward.
* The port's plain route (``ct_kernels="off"``, float32) and its kernel
  route (``"force"``: the kernels' plain twins on the CPU, bf16) serve
  what the reference serves with those masks.
* A program whose masks keep every channel, or are folded from another
  seed, does not.
* The reference imports neither package, nor JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import mc as ref_mc
from benchmark.reference.quant import bf16
from mimo_unet_torch.kernels import conv1x1 as port_conv1x1
from mimo_unet_torch.models import fast_path
from mimo_unet_torch.models.ensemble import Ensemble, fold_in
from mimo_unet_torch.ops import dropout as port_dropout
from mimo_unet_torch.tasks.mimo import MimoUnetTask

ROOT = Path(__file__).resolve().parents[1]
S, F, H, W, B, T = 2, 8, 32, 48, 2, 3
SEED = 2**33 + 17  # weights and frames
MASK_SEED = 2**32 + 5  # the predict call's seed
RATES = dict(encoder_dropout_rate=0.1, core_dropout_rate=0.1, decoder_dropout_rate=0.1)
CFG = {"in_channels": 3, "out_channels": 2, "num_subnetworks": S, "filter_base_count": F,
       "task": {"center_dropout_rate": 0.0, "final_dropout_rate": 0.0, **RATES}}


@pytest.fixture(scope="module")
def served():
    """Weights with BatchNorm statistics from seeded frames, and B frames."""
    torch.manual_seed(0)
    params = inputs.serving_weights(CFG, SEED, "cpu", H, W)
    frames = inputs.frames(SEED, B, H, W, "cpu")["image"].float() / 255.0
    return params, frames


def _ensemble(params, **kw):
    task = MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=S, filter_base_count=F,
                        seed=1, **RATES, **kw)
    model = task.build_model(device="cpu")
    model.load_state_dict(params)
    return Ensemble([(task, model)], monte_carlo_steps=T)


def _predict(params, frames, seed=MASK_SEED, **kw):
    return _ensemble(params, **kw).predict(frames.numpy(), batch_size=B, seed=seed)


def _reference(params, frames, masks=None, quant=ref_mc.ref_model.identity):
    if masks is None:
        masks = _masks()
    with torch.no_grad():
        return [t.numpy() for t in ref_mc.serve(params, frames, CFG, masks, T, B, range(B),
                                                quant=quant)]


def _masks(seed=MASK_SEED):
    # a predict call's one batch (start 0) of its one member (index 0)
    return ref_mc.draw_masks(CFG, T * B, fold_in(fold_in(seed, 0), 0), "cpu")


def _gap(got, want):
    """The relative RMS gap of each answer (mean, aleatoric, epistemic)."""
    return [float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in zip(got, want)]


def test_the_references_masks_are_the_ones_predict_draws(served, monkeypatch):
    params, frames = served
    drawn = []
    orig = port_dropout.DropoutSource.draw

    def draw(self, sites, device):
        out = orig(self, sites, device)
        drawn.append(out)
        return out

    monkeypatch.setattr(port_dropout.DropoutSource, "draw", draw)
    _predict(params, frames)
    assert len(drawn) == 1
    want = _masks()
    assert list(drawn[0]) == list(want)  # the same sites in the same order
    for name, (mask, keep) in want.items():
        assert drawn[0][name][0].dtype == mask.dtype == torch.bool
        assert torch.equal(drawn[0][name][0], mask), name
        assert drawn[0][name][1] == keep == pytest.approx(0.9)
    # every site drops something at this size: the masks are live
    assert all(not bool(m.all()) for m, _ in want.values())


def test_the_plain_route_serves_what_the_reference_serves(served):
    params, frames = served
    got = _predict(params, frames, ct_kernels="off")
    # float32 against float32: the two sum in other orders, and the
    # aleatoric variance exponentiates the log-scale output (1-2e-6 here)
    assert max(_gap(got, _reference(params, frames))) < 1e-4


def test_the_kernel_route_serves_what_the_reference_serves(served, monkeypatch):
    params, frames = served
    outc = []
    monkeypatch.setattr(fast_path, "conv1x1",
                        lambda *a: outc.append(1) or port_conv1x1(*a))
    got = _predict(params, frames, ct_kernels="force", compute_dtype="bfloat16")
    assert outc == [1]  # the MC route: the out-conv (K11) apart from the decoder
    want = _reference(params, frames)
    # bf16 against float32: held, as the benchmark holds it, in units of the
    # gap the reference rounded to bf16 gives; the kernel route rounds at
    # other points (fused BatchNorm, the dropout scale rounded once), which
    # reads 0.3-1.6 units on three mask seeds here
    unit = _gap(_reference(params, frames, quant=bf16), want)
    assert all(0 < u < 0.05 for u in unit), unit
    assert all(g < 3 * u for g, u in zip(_gap(got, want), unit)), (_gap(got, want), unit)


@pytest.mark.parametrize("fault", ["dead_masks", "wrong_seed"])
def test_a_faulted_program_does_not_serve_what_the_reference_serves(served, fault,
                                                                    monkeypatch):
    params, frames = served
    want = _reference(params, frames)
    if fault == "dead_masks":
        orig = port_dropout.DropoutSource.draw
        monkeypatch.setattr(port_dropout.DropoutSource, "draw",
                            lambda self, sites, device: ref_mc.dead_masks(
                                orig(self, sites, device)))
        got = _predict(params, frames, ct_kernels="off")
        # the reference's own dead-mask answers are what the fault served
        assert max(_gap(got, _reference(params, frames, ref_mc.dead_masks(_masks())))) < 1e-4
    else:
        got = _predict(params, frames, seed=MASK_SEED + 1, ct_kernels="off")
    # sound float32 reads 1e-6 (above); a fault moves every answer by 15 % or
    # more on three mask seeds, ten times the gap of the bf16 kernel route
    assert min(_gap(got, want)) > 1e-2, _gap(got, want)


def test_the_reference_imports_neither_package_nor_jax():
    code = ("import json, sys; import benchmark.reference.mc; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, cwd=ROOT)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in mods
    assert not mods & {"mimo_unet_torch", "mimo_unet_tpu", "jax", "jaxlib", "flax"}
