"""The MC-dropout route's spans and counters (``train/profiling.py``
``MC_SPANS``; ``models/ensemble.py`` ``mc_counts``): ``mimo.dropout.draw``
and ``mimo.eval_conv.outc`` open on the MC route under a profiler, inside
the forward stage, and the counters count the passes and masks served.

A tiny model on the kernel route's structure (``ct_kernels="force"``: each
kernel's plain version on the CPU); ``tests/test_torch_tracing.py`` holds
the spans every route opens.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from mimo_unet_torch.models.ensemble import Ensemble, mc_counts, reset_mc_counts
from mimo_unet_torch.models.mimo_unet import dropout_sites
from mimo_unet_torch.tasks.mimo import MimoUnetTask
from mimo_unet_torch.train.profiling import MC_SPANS, SPANS

H = W = 32
T = 3
RATES = dict(encoder_dropout_rate=0.1, core_dropout_rate=0.1, decoder_dropout_rate=0.1)


def _ensemble(mc=T):
    task = MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=2, filter_base_count=4,
                        compute_dtype="bfloat16", seed=7, ct_kernels="force", **RATES)
    return Ensemble([(task, task.build_model(device="cpu"))], monte_carlo_steps=mc)


def _images(n):
    return np.random.default_rng(1).random((n, H, W, 3), dtype=np.float32)


def _spans(prof):
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name.startswith("mimo."):
            out.setdefault(ev.name, []).append((ev.time_range.start, ev.time_range.end))
    return out


def test_the_mc_spans_are_listed():
    assert set(MC_SPANS) == {"mimo.dropout.draw", "mimo.eval_conv.outc"}
    assert set(MC_SPANS) <= set(SPANS)


def test_the_mc_route_opens_its_spans_inside_the_forward_stage():
    ens = _ensemble()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ens.predict(_images(3), batch_size=2)  # two chunks, a forward each
    spans = _spans(prof)
    for name in MC_SPANS:
        assert len(spans.get(name, ())) == 2, name
        assert all(any(a <= s and e <= b for a, b in spans["mimo.predict.forward"])
                   for s, e in spans[name]), name
    # the draw comes before the first conv site of its forward
    assert spans["mimo.dropout.draw"][0][1] <= spans["mimo.eval_conv.in_conv"][0][0]


def test_a_forward_without_live_dropout_opens_neither():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _ensemble(mc=0).predict(_images(2), batch_size=2)
    assert not set(_spans(prof)) & set(MC_SPANS)


@pytest.mark.parametrize("n,batch", [(4, 2), (3, 2)], ids=["whole", "padded"])
def test_mc_counts_count_the_passes_and_masks_served(n, batch):
    ens = _ensemble()
    ens.predict(_images(2), batch_size=2)
    reset_mc_counts()
    assert mc_counts() == {"forwards": 0, "passes": 0, "masks": 0, "mask_elements": 0}
    ens.predict(_images(n), batch_size=batch)
    chunks = -(-n // batch)
    sites = dropout_sites(ens.members[0][1].config, batch * T, H, W)
    got = mc_counts()
    # a padded chunk serves its padding too
    assert got["passes"] == chunks * batch * T
    assert got["forwards"] == chunks
    assert got["masks"] == chunks * len(sites) == chunks * 12
    assert got["mask_elements"] == chunks * sum(int(np.prod(s)) for s, _ in sites.values())
    reset_mc_counts()
    assert mc_counts() == {"forwards": 0, "passes": 0, "masks": 0, "mask_elements": 0}
